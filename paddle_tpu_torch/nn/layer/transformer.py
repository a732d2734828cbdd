"""Transformer layers (counterpart of ``paddle_tpu/nn/layer/transformer.py``):
``MultiHeadAttention``, ``TransformerEncoderLayer``/``Encoder``,
``TransformerDecoderLayer``/``Decoder`` and ``Transformer``.

Attention runs through one op, ``scaled_dot_product_attention``
(``nn.functional``), over heads in the JAX layout ``[B, L, H, D]``: an
unmasked call without attention dropout goes to the flash kernels (K4,
and K6 as its gradient) wherever the JAX override's predicate holds; a
mask (``generate_square_subsequent_mask``, a padding mask) or attention
dropout runs the op's plain body, where the JAX override refuses too.
Masks are additive float or boolean (True keeps), broadcast to ``[B, H,
Lq, Lk]``; :func:`_convert_attn_mask` turns a boolean one additive, as the
JAX layer does. The projections are the port's ``Linear`` (weights
``[out, in]``; ``convert.layer_from_jax`` transposes the JAX ``[in, out]``
weights when it carries them across). LayerNorms are post-norm unless
``normalize_before``: two a encoder layer and three a decoder layer, each
the fused LayerNorm kernels on the card.
"""
from __future__ import annotations

import copy

import torch

from ...framework.dispatch import call_op
from .. import functional as F
from .common import Dropout, Linear
from .container import LayerList
from .layers import Layer
from .norm import LayerNorm

__all__ = ["MultiHeadAttention", "TransformerEncoderLayer",
           "TransformerEncoder", "TransformerDecoderLayer",
           "TransformerDecoder", "Transformer"]


def _convert_attn_mask(mask, dtype):
    """A boolean mask (True keeps) as an additive one in ``dtype``
    (-1e9 where it drops; -6e4 for float16); any other mask as is."""
    if mask is None or mask.dtype != torch.bool:
        return mask
    neg = -6e4 if dtype == torch.float16 else -1e9
    return torch.where(mask, torch.zeros((), dtype=dtype, device=mask.device),
                       torch.full((), neg, dtype=dtype, device=mask.device))


class MultiHeadAttention(Layer):
    """Self- and cross-attention with q/k/v/out projections (k from
    ``kdim``, v from ``vdim`` features; ``weight_attr``/``bias_attr`` on
    every projection), an incremental decode ``Cache`` and a
    ``StaticCache`` of precomputed keys and values. ``need_weights=True``
    returns the attention probabilities ``[B, H, Lq, Lk]`` beside the
    output, computed by the op's plain composition."""

    class Cache:
        """Keys and values of the steps so far (seq axis 1)."""

        def __init__(self, k, v):
            self.k, self.v = k, v

    class StaticCache:
        """Keys and values computed once (cross-attention's memory)."""

        def __init__(self, k, v):
            self.k, self.v = k, v

    def __init__(self, embed_dim, num_heads, dropout=0.0, kdim=None,
                 vdim=None, need_weights=False, weight_attr=None,
                 bias_attr=None, *, device=None, dtype=None):
        super().__init__()
        if embed_dim % num_heads != 0:
            raise ValueError("embed_dim must be divisible by num_heads")
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.head_dim = embed_dim // num_heads
        self.kdim = kdim or embed_dim
        self.vdim = vdim or embed_dim
        self.dropout = dropout
        self.need_weights = need_weights
        kw = {"device": device, "dtype": dtype}
        self.q_proj = Linear(embed_dim, embed_dim, weight_attr, bias_attr,
                             **kw)
        self.k_proj = Linear(self.kdim, embed_dim, weight_attr, bias_attr,
                             **kw)
        self.v_proj = Linear(self.vdim, embed_dim, weight_attr, bias_attr,
                             **kw)
        self.out_proj = Linear(embed_dim, embed_dim, weight_attr, bias_attr,
                               **kw)

    # the batch is -1 (inferred) wherever it can be: a static program
    # records the shape at its build batch and replays it at any other
    def _split_heads(self, x):
        # [B, L, E] -> [B, L, H, D]
        b, l = x.shape[0], x.shape[1]
        return call_op("reshape", x, shape=(-1 if x.numel() else b, l,
                                            self.num_heads, self.head_dim))

    def _merge_heads(self, x):
        b, l, h, d = x.shape
        return call_op("reshape", x,
                       shape=(-1 if x.numel() else b, l, h * d))

    def gen_cache(self, key, value=None, type=None):
        if type == MultiHeadAttention.StaticCache:
            k = self._split_heads(self.k_proj(key))
            v = self._split_heads(self.v_proj(value if value is not None
                                              else key))
            return MultiHeadAttention.StaticCache(k, v)
        # an incremental cache seeded empty: [B, 0, H, D]
        empty = torch.zeros((key.shape[0], 0, self.num_heads, self.head_dim),
                            dtype=key.dtype, device=key.device)
        return MultiHeadAttention.Cache(empty, empty.clone())

    def _weights(self, q, k, mask):
        """The attention probabilities ``[B, H, Lq, Lk]`` (f32 scores,
        scaled, masked, softmaxed)."""
        logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) \
            / self.head_dim ** 0.5
        if mask is not None:
            logits = logits + mask.float()
        return torch.softmax(logits, dim=-1)

    def forward(self, query, key=None, value=None, attn_mask=None,
                cache=None):
        key = query if key is None else key
        value = key if value is None else value
        q = self._split_heads(self.q_proj(query))
        if isinstance(cache, MultiHeadAttention.StaticCache):
            k, v = cache.k, cache.v
        else:
            k = self._split_heads(self.k_proj(key))
            v = self._split_heads(self.v_proj(value))
            if isinstance(cache, MultiHeadAttention.Cache):
                k = call_op("concat", [cache.k, k], axis=1)
                v = call_op("concat", [cache.v, v], axis=1)
                cache = MultiHeadAttention.Cache(k, v)
        mask = _convert_attn_mask(attn_mask, q.dtype)
        out = F.scaled_dot_product_attention(
            q, k, v, attn_mask=mask,
            dropout_p=self.dropout if self.training else 0.0,
            training=self.training)
        out = self.out_proj(self._merge_heads(out))
        outs = [out]
        if self.need_weights:
            outs.append(self._weights(q, k, mask))
        if cache is not None and not isinstance(
                cache, MultiHeadAttention.StaticCache):
            outs.append(cache)
        return outs[0] if len(outs) == 1 else tuple(outs)


def _ffn(layer, x):
    return layer.linear2(layer.dropout(
        call_op(layer.activation, layer.linear1(x))))


class TransformerEncoderLayer(Layer):
    def __init__(self, d_model, nhead, dim_feedforward, dropout=0.1,
                 activation="relu", attn_dropout=None, act_dropout=None,
                 normalize_before=False, weight_attr=None, bias_attr=None):
        super().__init__()
        attn_dropout = dropout if attn_dropout is None else attn_dropout
        act_dropout = dropout if act_dropout is None else act_dropout
        self.normalize_before = normalize_before
        self.self_attn = MultiHeadAttention(d_model, nhead, attn_dropout,
                                            weight_attr=weight_attr,
                                            bias_attr=bias_attr)
        self.linear1 = Linear(d_model, dim_feedforward, weight_attr,
                              bias_attr)
        self.dropout = Dropout(act_dropout)
        self.linear2 = Linear(dim_feedforward, d_model, weight_attr,
                              bias_attr)
        self.norm1 = LayerNorm(d_model)
        self.norm2 = LayerNorm(d_model)
        self.dropout1 = Dropout(dropout)
        self.dropout2 = Dropout(dropout)
        self.activation = activation

    def forward(self, src, src_mask=None, cache=None):
        residual = src
        if self.normalize_before:
            src = self.norm1(src)
        if cache is None:
            src = self.self_attn(src, src, src, src_mask)
        else:
            src, cache = self.self_attn(src, src, src, src_mask, cache)
        src = residual + self.dropout1(src)
        if not self.normalize_before:
            src = self.norm1(src)
        residual = src
        if self.normalize_before:
            src = self.norm2(src)
        src = residual + self.dropout2(_ffn(self, src))
        if not self.normalize_before:
            src = self.norm2(src)
        return src if cache is None else (src, cache)

    def gen_cache(self, src):
        return self.self_attn.gen_cache(src)


class TransformerEncoder(Layer):
    def __init__(self, encoder_layer, num_layers, norm=None):
        super().__init__()
        self.layers = LayerList(
            [encoder_layer if i == 0 else copy.deepcopy(encoder_layer)
             for i in range(num_layers)])
        self.num_layers = num_layers
        self.norm = norm

    def forward(self, src, src_mask=None, cache=None):
        output = src
        new_caches = []
        for i, layer in enumerate(self.layers):
            if cache is None:
                output = layer(output, src_mask)
            else:
                output, c = layer(output, src_mask, cache[i])
                new_caches.append(c)
        if self.norm is not None:
            output = self.norm(output)
        return output if cache is None else (output, new_caches)

    def gen_cache(self, src):
        return [layer.gen_cache(src) for layer in self.layers]


class TransformerDecoderLayer(Layer):
    def __init__(self, d_model, nhead, dim_feedforward, dropout=0.1,
                 activation="relu", attn_dropout=None, act_dropout=None,
                 normalize_before=False, weight_attr=None, bias_attr=None):
        super().__init__()
        attn_dropout = dropout if attn_dropout is None else attn_dropout
        act_dropout = dropout if act_dropout is None else act_dropout
        self.normalize_before = normalize_before
        self.self_attn = MultiHeadAttention(d_model, nhead, attn_dropout,
                                            weight_attr=weight_attr,
                                            bias_attr=bias_attr)
        self.cross_attn = MultiHeadAttention(d_model, nhead, attn_dropout,
                                             weight_attr=weight_attr,
                                             bias_attr=bias_attr)
        self.linear1 = Linear(d_model, dim_feedforward, weight_attr,
                              bias_attr)
        self.dropout = Dropout(act_dropout)
        self.linear2 = Linear(dim_feedforward, d_model, weight_attr,
                              bias_attr)
        self.norm1 = LayerNorm(d_model)
        self.norm2 = LayerNorm(d_model)
        self.norm3 = LayerNorm(d_model)
        self.dropout1 = Dropout(dropout)
        self.dropout2 = Dropout(dropout)
        self.dropout3 = Dropout(dropout)
        self.activation = activation

    def forward(self, tgt, memory, tgt_mask=None, memory_mask=None,
                cache=None):
        residual = tgt
        if self.normalize_before:
            tgt = self.norm1(tgt)
        if cache is None:
            tgt = self.self_attn(tgt, tgt, tgt, tgt_mask)
        else:
            tgt, new_inc = self.self_attn(tgt, tgt, tgt, tgt_mask, cache[0])
        tgt = residual + self.dropout1(tgt)
        if not self.normalize_before:
            tgt = self.norm1(tgt)
        residual = tgt
        if self.normalize_before:
            tgt = self.norm2(tgt)
        static = cache[1] if cache is not None else None
        tgt = self.cross_attn(tgt, memory, memory, memory_mask, static)
        tgt = residual + self.dropout2(tgt)
        if not self.normalize_before:
            tgt = self.norm2(tgt)
        residual = tgt
        if self.normalize_before:
            tgt = self.norm3(tgt)
        tgt = residual + self.dropout3(_ffn(self, tgt))
        if not self.normalize_before:
            tgt = self.norm3(tgt)
        return tgt if cache is None else (tgt, (new_inc, static))

    def gen_cache(self, memory):
        inc = self.self_attn.gen_cache(memory)
        static = self.cross_attn.gen_cache(
            memory, memory, type=MultiHeadAttention.StaticCache)
        return inc, static


class TransformerDecoder(Layer):
    def __init__(self, decoder_layer, num_layers, norm=None):
        super().__init__()
        self.layers = LayerList(
            [decoder_layer if i == 0 else copy.deepcopy(decoder_layer)
             for i in range(num_layers)])
        self.num_layers = num_layers
        self.norm = norm

    def forward(self, tgt, memory, tgt_mask=None, memory_mask=None,
                cache=None):
        output = tgt
        new_caches = []
        for i, layer in enumerate(self.layers):
            if cache is None:
                output = layer(output, memory, tgt_mask, memory_mask)
            else:
                output, c = layer(output, memory, tgt_mask, memory_mask,
                                  cache[i])
                new_caches.append(c)
        if self.norm is not None:
            output = self.norm(output)
        return output if cache is None else (output, new_caches)

    def gen_cache(self, memory, do_zip=False):
        caches = [layer.gen_cache(memory) for layer in self.layers]
        return list(zip(*caches)) if do_zip else caches


class Transformer(Layer):
    """The encoder-decoder transformer (the reference's ``Transformer``):
    ``forward(src, tgt, src_mask, tgt_mask, memory_mask)`` over embedded
    ``[B, L, d_model]`` inputs."""

    def __init__(self, d_model=512, nhead=8, num_encoder_layers=6,
                 num_decoder_layers=6, dim_feedforward=2048, dropout=0.1,
                 activation="relu", attn_dropout=None, act_dropout=None,
                 normalize_before=False, weight_attr=None, bias_attr=None,
                 custom_encoder=None, custom_decoder=None):
        super().__init__()
        if custom_encoder is not None:
            self.encoder = custom_encoder
        else:
            enc_layer = TransformerEncoderLayer(
                d_model, nhead, dim_feedforward, dropout, activation,
                attn_dropout, act_dropout, normalize_before, weight_attr,
                bias_attr)
            enc_norm = LayerNorm(d_model) if normalize_before else None
            self.encoder = TransformerEncoder(enc_layer, num_encoder_layers,
                                              enc_norm)
        if custom_decoder is not None:
            self.decoder = custom_decoder
        else:
            dec_layer = TransformerDecoderLayer(
                d_model, nhead, dim_feedforward, dropout, activation,
                attn_dropout, act_dropout, normalize_before, weight_attr,
                bias_attr)
            dec_norm = LayerNorm(d_model) if normalize_before else None
            self.decoder = TransformerDecoder(dec_layer, num_decoder_layers,
                                              dec_norm)
        self.d_model = d_model
        self.nhead = nhead

    def forward(self, src, tgt, src_mask=None, tgt_mask=None,
                memory_mask=None):
        memory = self.encoder(src, src_mask)
        return self.decoder(tgt, memory, tgt_mask, memory_mask)

    @staticmethod
    def generate_square_subsequent_mask(length, *, device=None):
        """The additive causal mask ``[length, length]``: 0 on and below
        the diagonal, -1e9 above (float32, on ``device``: the card unless
        ``set_device("cpu")``)."""
        from ...framework.place import to_torch_device
        keep = torch.ones((length, length), dtype=torch.bool,
                          device=to_torch_device(device)).tril()
        return torch.where(keep, 0.0, -1e9).to(torch.float32)
