"""Neural-network ops of the GPT path (counterpart of
``paddle_tpu/ops/nn_ops.py``): each op's plain body. The hand-written
kernels shadow two of them as overrides: ``layer_norm`` (K2/K3,
registered in ``nn/layer/norm.py``) and ``scaled_dot_product_attention``
(K4-K7, registered in ``nn/functional.py``)."""
from __future__ import annotations

import math

import torch
from torch.nn import functional as TF

from ..framework.random import get_generator
from .registry import register_op

__all__ = ["dropout", "sdpa_reference"]

_NEG_INF = -1e30


def dropout(x, p=0.5, axis=None, training=True, mode="upscale_in_train",
            name=None):
    """Dropout as the JAX package's ``dropout``/``dropout_raw``: keep each
    element with probability ``1 - p``; ``mode="upscale_in_train"``
    scales the kept ones by ``1 / (1 - p)`` in training, and
    ``"downscale_in_infer"`` keeps them as they are and scales by ``1 -
    p`` in eval. With ``axis`` (an int or a list) the mask is drawn over
    those axes and broadcast over the rest. Draws from the port's
    generator of ``x``'s device."""
    if mode not in ("upscale_in_train", "downscale_in_infer"):
        raise ValueError(f"dropout mode must be 'upscale_in_train' or "
                         f"'downscale_in_infer', got {mode!r}")
    if not training or p == 0.0:
        if not training and mode == "downscale_in_infer" and p > 0.0:
            return x * (1.0 - float(p))
        return x
    if p == 1.0:
        return torch.zeros_like(x)
    shape = x.shape
    if axis is not None:
        axes = {a % x.dim() for a in ((axis,) if isinstance(axis, int)
                                      else axis)}
        shape = tuple(d if i in axes else 1 for i, d in enumerate(x.shape))
    keep = torch.rand(shape, generator=get_generator(x.device),
                      device=x.device) < 1.0 - p
    kept = x / (1.0 - p) if mode == "upscale_in_train" else x
    return torch.where(keep, kept, torch.zeros_like(x))


@register_op("embedding")
def _embedding(ids, weight, padding_idx=None):
    out = TF.embedding(ids, weight)
    if padding_idx is not None:
        if padding_idx < 0:           # counts back from the vocab size
            padding_idx += weight.shape[0]
        out = torch.where((ids == padding_idx)[..., None], 0.0,
                          out).to(weight.dtype)
    return out


@register_op("linear")
def _linear(x, w, b=None):
    """``x @ w + b`` with ``w`` ``[in, out]``, the JAX package's layout."""
    return TF.linear(x, w.t(), b)


@register_op("gelu")
def _gelu(x, approximate=False):
    return TF.gelu(x, approximate="tanh" if approximate else "none")


@register_op("softmax")
def _softmax(x, axis=-1):
    return torch.softmax(x, dim=int(axis))


@register_op("layer_norm")
def _layer_norm(x, weight=None, bias=None, epsilon=1e-5,
                begin_norm_axis=None):
    """Normalize in f32 over the axes from ``begin_norm_axis`` (the last
    by default), cast back to x's dtype, then scale and shift."""
    dims = tuple(range(x.dim() - 1 if begin_norm_axis is None
                       else begin_norm_axis, x.dim()))
    xf = x.float()
    mean = xf.mean(dim=dims, keepdim=True)
    xc = xf - mean
    var = (xc * xc).mean(dim=dims, keepdim=True)
    out = (xc * torch.rsqrt(var + epsilon)).to(x.dtype)
    if weight is not None:
        out = out * weight
    if bias is not None:
        out = out + bias
    return out


@register_op("scaled_dot_product_attention")
def sdpa_reference(q, k, v, mask=None, dropout_p=0.0, is_causal=False,
                   scale=None):
    """Softmax attention over ``[B, S, H, D]`` as a plain composition
    (``_sdpa``): f32 scores scaled by ``scale`` (``1 / sqrt(D)`` by
    default), a causal mask aligned bottom-right (``tril(k=Sk-Sq)``), a
    bool mask (keep where True) or an additive one, dropout on the
    probabilities, P in V's dtype against V."""
    s = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * s
    if is_causal:
        ql, kl = logits.shape[-2], logits.shape[-1]
        keep = torch.ones(ql, kl, dtype=torch.bool,
                          device=q.device).tril(diagonal=kl - ql)
        logits = logits.masked_fill(~keep, _NEG_INF)
    if mask is not None:
        if mask.dtype == torch.bool:
            logits = logits.masked_fill(~mask, _NEG_INF)
        else:
            logits = logits + mask.float()
    probs = torch.softmax(logits, dim=-1)
    if dropout_p > 0.0:
        probs = dropout(probs, dropout_p)
    out = torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype).float(),
                       v.float())
    return out.to(q.dtype)
