"""The fused transformer layers (counterpart of
``paddle_tpu/incubate/nn/layer/fused_transformer.py``).

Each layer is the plain composition the JAX one is: ``Linear`` products,
``layer_norm`` through ``call_op`` (the LayerNorm kernels K2/K3 on the
card) and ``F.scaled_dot_product_attention`` (the flash kernels K4-K7
when there is no mask and no attention dropout, else the op's plain
body, where the JAX override refuses too); the bias, dropout and
residual epilogues are torch's.

The CacheKV attention of :class:`FusedMultiHeadAttention` (the layout
of the reference's ``fused_multi_transformer_op.cu``: one cache ``[2, B,
H, max_len, Dh]`` a layer) is functional, as in the JAX package: the
updated cache is a new tensor, returned; the cache passed in is never
written. A scalar ``time_step`` writes the chunk at ``[t, t + S)``; a
``[B]`` vector writes row ``b`` at ``[t_b, t_b + S)``, the queries of row
``b`` seeing the slots up to their own. Both check the capacity on the
host, as the JAX layer does for a concrete ``time_step``: a tensor
``time_step`` is read once a call (:class:`FusedMultiTransformer` reads
it before its layers run).
"""
from __future__ import annotations

import numpy as np
import torch

from .... import nn
from ....framework.dispatch import call_op
from ....nn import functional as F
from ....nn.layer.layers import Layer
from ....ops.registry import not_ported

__all__ = ["FusedMultiHeadAttention", "FusedFeedForward",
           "FusedTransformerEncoderLayer"]

#: the additive fill of a masked cache slot under a float ``attn_mask``
_MASKED = -1e30


def _host_time_step(time_step):
    """``time_step`` with a tensor read on the host once: a Python int
    for a scalar, a CPU int64 tensor for a ``[B]`` vector, as is
    otherwise."""
    if torch.is_tensor(time_step):
        if time_step.dim() == 0:
            return int(time_step)
        return time_step.detach().to("cpu", torch.int64)
    if isinstance(time_step, np.ndarray) and time_step.ndim == 1:
        return torch.from_numpy(time_step.astype(np.int64))
    return time_step


def _mask_check(m, max_len, hint):
    if m.shape[-1] not in (1, max_len):
        raise ValueError(
            f"attn_mask last dim {m.shape[-1]} must equal the cache "
            f"capacity max_len={max_len} (or be 1 for a per-query "
            f"broadcast){hint}")


def _with_mask(valid, attn_mask):
    """The cache's ``valid`` slots, intersected with a bool mask or
    applied to an additive one (masked slots at -1e30)."""
    if attn_mask is None:
        return valid
    m = torch.as_tensor(attn_mask, device=valid.device)
    if m.dtype == torch.bool:
        return valid & m
    return torch.where(valid, m.float(), _MASKED)


class FusedMultiHeadAttention(Layer):
    """Attention, residual and a pre or post LayerNorm in one layer:
    ``qkv_proj`` ``[D, 3D]``, ``out_proj``, ``norm``. With ``cache`` it
    runs the CacheKV attention and returns ``(out, new_cache)``."""

    def __init__(self, embed_dim, num_heads, dropout_rate=0.5,
                 attn_dropout_rate=0.5, normalize_before=False,
                 need_weights=False, qkv_weight_attr=None,
                 qkv_bias_attr=None, linear_weight_attr=None,
                 linear_bias_attr=None, pre_ln_scale_attr=None,
                 pre_ln_bias_attr=None, ln_scale_attr=None,
                 ln_bias_attr=None, epsilon=1e-5, name=None):
        super().__init__()
        if embed_dim % num_heads:
            raise ValueError("num_heads must divide embed_dim")
        if need_weights:
            raise NotImplementedError(
                "need_weights=True is unsupported (the reference fused op "
                "asserts the same); use nn.MultiHeadAttention to inspect "
                "attention weights")
        attrs = [qkv_weight_attr, qkv_bias_attr, linear_weight_attr,
                 linear_bias_attr, pre_ln_scale_attr, pre_ln_bias_attr,
                 ln_scale_attr, ln_bias_attr]
        if any(a is not None for a in attrs):
            raise NotImplementedError(
                "ParamAttr-based initializers are not wired for the fused "
                "layers; initialize via state_dict/set_state_dict instead "
                "of silently ignoring the attrs")
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.head_dim = embed_dim // num_heads
        self.normalize_before = normalize_before
        self.dropout_rate = dropout_rate
        self.attn_dropout_rate = attn_dropout_rate
        self.qkv_proj = nn.Linear(embed_dim, 3 * embed_dim)
        self.out_proj = nn.Linear(embed_dim, embed_dim)
        self.norm = nn.LayerNorm(embed_dim, epsilon=epsilon)

    def forward(self, x, attn_mask=None, cache=None, time_step=None):
        b, s, d = x.shape
        residual = x
        if self.normalize_before:
            x = self.norm(x)
        qkv = call_op("reshape", self.qkv_proj(x),
                      shape=(b, s, 3, self.num_heads, self.head_dim))
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]   # [B, S, H, Dh]
        if cache is None:
            out = F.scaled_dot_product_attention(
                q, k, v, attn_mask=attn_mask,
                dropout_p=self.attn_dropout_rate if self.training else 0.0)
            new_cache = None
        else:
            out, new_cache = self._cached_attention(q, k, v, cache,
                                                    time_step, attn_mask)
        out = self.out_proj(call_op("reshape", out, shape=(b, s, d)))
        if self.dropout_rate and self.training:
            out = F.dropout(out, p=self.dropout_rate, training=True)
        out = residual + out
        if not self.normalize_before:
            out = self.norm(out)
        return out if cache is None else (out, new_cache)

    def _cached_attention(self, q, k, v, cache, time_step, attn_mask):
        """The CacheKV attention: ``time_step`` None is the context stage
        (the prompt's K/V land at slots ``[0, S)``), a scalar writes the
        chunk at ``[t, t + S)``, a ``[B]`` vector goes to
        :meth:`_slot_indexed_attention`. A query at slot ``t + i`` sees
        the slots up to ``t + i``, intersected with ``attn_mask``.
        Returns the output and the new cache (a new tensor; ``cache`` is
        left as it was)."""
        ckv = torch.as_tensor(cache)
        max_len = ckv.shape[3]
        s, b = q.shape[1], q.shape[0]
        # [B, S, H, Dh] -> the cache's [2, B, H, S, Dh]
        kv = torch.stack([k.transpose(1, 2), v.transpose(1, 2)]).to(
            ckv.dtype)
        start = _host_time_step(0 if time_step is None else time_step)
        if getattr(start, "ndim", 0) == 1:            # slot-indexed [B]
            return self._slot_indexed_attention(q, kv, ckv, start,
                                                attn_mask, max_len, s, b)
        pos = int(start)
        if pos + s > max_len:
            raise ValueError(
                f"time_step {pos} + chunk {s} exceeds the cache capacity "
                f"{max_len} — dynamic_update_slice would silently clamp "
                f"and corrupt slot {max_len - 1}")
        slots = torch.arange(max_len, device=ckv.device)
        rows = pos + torch.arange(s, device=ckv.device)
        valid = (slots[None, :] <= rows[:, None])[None, None]   # [1,1,S,L]
        if attn_mask is not None:
            _mask_check(attn_mask, max_len,
                        ": cached attention scores span every cache slot, "
                        "so a prompt-length mask cannot broadcast against "
                        "them — pad the mask to max_len (False / -inf for "
                        "empty slots)")
        mask = _with_mask(valid, attn_mask)
        ckv = torch.slice_scatter(ckv, kv, dim=3, start=pos, end=pos + s)
        return self._attend(q, ckv, mask), ckv.detach()

    def _slot_indexed_attention(self, q, kv, ckv, starts, attn_mask,
                                max_len, s, b):
        """A ``[B]`` ``time_step`` (``starts``, on the host): row ``b``'s
        chunk goes to slots ``[starts[b], starts[b] + S)`` and its query
        ``i`` sees the slots up to ``starts[b] + i``."""
        starts = torch.as_tensor(starts, dtype=torch.int64).reshape(-1)
        if starts.shape[0] != b:
            raise ValueError(
                f"vector time_step has {starts.shape[0]} entries for "
                f"batch {b}")
        hi = int(starts.max())
        if hi + s > max_len:
            raise ValueError(
                f"time_step max {hi} + chunk {s} exceeds the cache "
                f"capacity {max_len}")
        dev = ckv.device
        tidx = (starts[:, None] + torch.arange(s)[None, :]).to(dev)  # [B, S]
        # row b's rows land at [:, b, :, tidx[b, i]]: the advanced indices
        # (dims 1 and 3, split by a slice) move to the front, so the value
        # is [B, S, 2, H, Dh]
        ckv = ckv.clone()
        ckv[:, torch.arange(b, device=dev)[:, None], :, tidx] = \
            kv.permute(1, 3, 0, 2, 4)
        valid = (torch.arange(max_len, device=dev)[None, None, :]
                 <= tidx[:, :, None])[:, None]                  # [B,1,S,L]
        if attn_mask is not None:
            _mask_check(attn_mask, max_len, "")
        mask = _with_mask(valid, attn_mask)
        return self._attend(q, ckv, mask), ckv.detach()

    @staticmethod
    def _attend(q, ckv, mask):
        return F.scaled_dot_product_attention(
            q, ckv[0].transpose(1, 2), ckv[1].transpose(1, 2),
            attn_mask=mask)


class FusedFeedForward(Layer):
    """FFN, residual and a pre or post LayerNorm: ``linear1``,
    ``linear2``, ``norm``; the activation is ``nn.functional``'s function
    of that name."""

    def __init__(self, d_model, dim_feedforward, dropout_rate=0.1,
                 epsilon=1e-5, activation="relu", act_dropout_rate=None,
                 normalize_before=False, linear1_weight_attr=None,
                 linear1_bias_attr=None, linear2_weight_attr=None,
                 linear2_bias_attr=None, ln1_scale_attr=None,
                 ln1_bias_attr=None, ln2_scale_attr=None,
                 ln2_bias_attr=None, name=None):
        super().__init__()
        self.normalize_before = normalize_before
        self.dropout_rate = dropout_rate
        self.act_dropout_rate = dropout_rate if act_dropout_rate is None \
            else act_dropout_rate
        if not hasattr(F, activation):
            raise ValueError(
                f"unknown activation {activation!r} (no "
                f"paddle_tpu.nn.functional.{activation})")
        self.activation = activation
        self.linear1 = nn.Linear(d_model, dim_feedforward)
        self.linear2 = nn.Linear(dim_feedforward, d_model)
        self.norm = nn.LayerNorm(d_model, epsilon=epsilon)

    def forward(self, src, cache=None):
        residual = src
        x = self.norm(src) if self.normalize_before else src
        x = getattr(F, self.activation)(self.linear1(x))
        if self.act_dropout_rate and self.training:
            x = F.dropout(x, p=self.act_dropout_rate, training=True)
        x = self.linear2(x)
        if self.dropout_rate and self.training:
            x = F.dropout(x, p=self.dropout_rate, training=True)
        out = residual + x
        if not self.normalize_before:
            out = self.norm(out)
        return out


class FusedTransformerEncoderLayer(Layer):
    """:class:`FusedMultiHeadAttention` (``fused_attn``) then
    :class:`FusedFeedForward` (``ffn``)."""

    def __init__(self, d_model, nhead, dim_feedforward,
                 dropout_rate=0.1, activation="relu", attn_dropout_rate=None,
                 act_dropout_rate=None, normalize_before=False):
        super().__init__()
        self.fused_attn = FusedMultiHeadAttention(
            d_model, nhead, dropout_rate=dropout_rate,
            attn_dropout_rate=(dropout_rate if attn_dropout_rate is None
                               else attn_dropout_rate),
            normalize_before=normalize_before)
        self.ffn = FusedFeedForward(
            d_model, dim_feedforward, dropout_rate=dropout_rate,
            activation=activation, act_dropout_rate=act_dropout_rate,
            normalize_before=normalize_before)

    def forward(self, src, src_mask=None, cache=None, time_step=None):
        if cache is None:
            return self.ffn(self.fused_attn(src, attn_mask=src_mask))
        out, new_cache = self.fused_attn(src, attn_mask=src_mask,
                                         cache=cache, time_step=time_step)
        return self.ffn(out), new_cache


class FusedLinear(Layer):
    """``x @ weight + bias`` with the weight in the Paddle ``[in, out]``
    shape (``[out, in]`` with ``transpose_weight``), as
    ``create_parameter`` makes it: not an ``nn.Linear``, so its weight
    keeps that shape in the port too and ``convert`` carries it as is."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 bias_attr=None, transpose_weight=False, name=None):
        super().__init__()
        self._transpose_weight = transpose_weight
        shape = [out_features, in_features] if transpose_weight else \
            [in_features, out_features]
        self.weight = self.create_parameter(shape, attr=weight_attr)
        self.bias = None if bias_attr is False else \
            self.create_parameter([out_features], attr=bias_attr,
                                  is_bias=True)

    def forward(self, x):
        w = self.weight.t() if self._transpose_weight else self.weight
        return F.linear(x, w, self.bias)


class FusedBiasDropoutResidualLayerNorm(Layer):
    """``layer_norm(residual + dropout(x + linear_bias))`` with
    ``ln_scale``/``ln_bias``."""

    def __init__(self, embed_dim, dropout_rate=0.5, weight_attr=None,
                 bias_attr=None, epsilon=1e-5, name=None):
        super().__init__()
        from ....nn.initializer import Constant
        self._dropout_rate = dropout_rate
        self._epsilon = epsilon
        self.linear_bias = self.create_parameter(
            [embed_dim], attr=bias_attr, is_bias=True)
        self.ln_scale = self.create_parameter(
            [embed_dim], attr=weight_attr,
            default_initializer=Constant(1.0))
        self.ln_bias = self.create_parameter([embed_dim], is_bias=True)

    def forward(self, x, residual):
        y = x + self.linear_bias
        if self._dropout_rate:
            y = F.dropout(y, p=self._dropout_rate, training=self.training)
        return F.layer_norm(residual + y, y.shape[-1:],
                            weight=self.ln_scale, bias=self.ln_bias,
                            epsilon=self._epsilon)


class FusedMultiTransformer(Layer):
    """The fused GPT decoder stack: ``num_layers`` pre-LN
    :class:`FusedTransformerEncoderLayer` s, causal when no mask is
    given. With ``caches`` (``gen_cache``) it runs the CacheKV stages and
    returns ``(out, new_caches)``. ``nranks``/``ring_id`` are the
    reference's tensor-parallel knobs (the JAX layer ignores them): a
    value other than the default raises naming ROADMAP Queue 1 item 4;
    ``ln_scale_attrs`` is taken and unused, as in the JAX layer."""

    def __init__(self, embed_dim, num_heads, dim_feedforward,
                 dropout_rate=0.0, activation="gelu",
                 normalize_before=True, ln_scale_attrs=None,
                 num_layers=-1, nranks=1, ring_id=-1, name=None):
        super().__init__()
        if num_layers < 1:
            raise ValueError("num_layers must be >= 1")
        if not normalize_before:
            raise NotImplementedError(
                "FusedMultiTransformer is pre-LN by definition in the "
                "reference kernel; normalize_before=False is not a "
                "supported configuration there either")
        if nranks != 1 or ring_id != -1:
            raise not_ported(f"FusedMultiTransformer(nranks={nranks}, "
                             f"ring_id={ring_id})", 4)
        self.layers = nn.LayerList([
            FusedTransformerEncoderLayer(
                embed_dim, num_heads, dim_feedforward,
                dropout_rate=dropout_rate, activation=activation,
                normalize_before=True)
            for _ in range(num_layers)])

    def gen_cache(self, batch, max_len, dtype="float32"):
        """One zero CacheKV tensor ``[2, batch, num_heads, max_len,
        head_dim]`` a layer, on the layers' device."""
        from ....framework.dtypes import convert_dtype
        a = self.layers[0].fused_attn
        shape = (2, batch, a.num_heads, max_len, a.head_dim)
        device = a.qkv_proj.weight.device
        return [torch.zeros(shape, dtype=convert_dtype(dtype), device=device)
                for _ in self.layers]

    def forward(self, src, attn_mask=None, caches=None, time_step=None):
        if time_step is not None and caches is None:
            raise ValueError(
                "time_step requires caches (decode steps read/write the "
                "CacheKV tensors); pass caches=gen_cache(...)")
        if caches is not None:
            if len(caches) != len(self.layers):
                raise ValueError(
                    f"got {len(caches)} cache tensors for "
                    f"{len(self.layers)} layers")
            time_step = _host_time_step(time_step)
            out, new_caches = src, []
            for layer, c in zip(self.layers, caches):
                out, nc = layer(out, src_mask=attn_mask, cache=c,
                                time_step=time_step)
                new_caches.append(nc)
            return out, new_caches
        if attn_mask is None:
            # the reference kernel is a causal decoder by construction
            s = src.shape[1]
            keep = torch.ones(s, s, dtype=torch.bool,
                              device=src.device).tril()
            attn_mask = torch.where(keep, 0.0, -1e9).reshape(1, 1, s, s)
        out = src
        for layer in self.layers:
            out = layer(out, src_mask=attn_mask)
        return out
