"""Functional ops of the GPT path (counterpart of
``paddle_tpu/nn/functional``): attention, dropout, cross-entropy.

:func:`scaled_dot_product_attention` routes as the JAX package's
dispatcher does: the flash attention kernels take every shape the
structural half of ``_fa_supported`` accepts (no mask, no dropout,
causal only with ``Sq == Sk``, ``D <= 256``) whatever the dtypes, so
on the card a dtype the kernels do not take raises there; the rest runs
:func:`sdpa_reference`, the plain composition of ``ops/nn_ops.py``
``_sdpa``. The TPU's length threshold
(``FLASH_MIN_SEQ``, measured on v5e) and its autotune cache are not
carried over: on the card every supported shape goes to the kernel.
"""
from __future__ import annotations

import math

import torch

from .. import amp
from ..framework.random import get_generator
from ..ops.flash_attention import MAX_HEAD_DIM, flash_attention

__all__ = ["scaled_dot_product_attention", "sdpa_reference", "dropout",
           "cross_entropy", "flash_supported"]

_NEG_INF = -1e30


def dropout(x, p=0.5, training=True):
    """``upscale_in_train`` dropout: keep each element with probability
    ``1 - p`` and scale it by ``1 / (1 - p)``. Draws from the port's
    generator of ``x``'s device."""
    if not training or p == 0.0:
        return x
    if p == 1.0:
        return torch.zeros_like(x)
    keep = torch.rand(x.shape, generator=get_generator(x.device),
                      device=x.device) < 1.0 - p
    return torch.where(keep, x / (1.0 - p), torch.zeros_like(x))


def sdpa_reference(q, k, v, mask=None, dropout_p=0.0, is_causal=False):
    """Softmax attention over ``[B, S, H, D]`` as a plain composition
    (``_sdpa``): f32 scores scaled by ``1 / sqrt(D)``, a causal mask
    aligned bottom-right (``tril(k=Sk-Sq)``), a bool mask (keep where
    True) or an additive one, dropout on the probabilities, P in V's
    dtype against V."""
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(),
                          k.float()) * (1.0 / math.sqrt(q.shape[-1]))
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
        probs = dropout(probs, dropout_p, True)
    out = torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype).float(),
                       v.float())
    return out.to(q.dtype)


def flash_supported(q, k, mask, dropout_p, is_causal) -> bool:
    """The structural half of ``_fa_supported``."""
    if q.dim() != 4 or mask is not None or dropout_p > 0.0:
        return False
    if is_causal and q.shape[1] != k.shape[1]:
        return False
    return q.shape[-1] <= MAX_HEAD_DIM


def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p=0.0, is_causal=False,
                                 training=True):
    """Attention over ``[batch, seq, num_heads, head_dim]`` inputs."""
    query, key, value = amp.cast_inputs("scaled_dot_product_attention",
                                        query, key, value)
    p = float(dropout_p) if training else 0.0
    if flash_supported(query, key, attn_mask, p, is_causal):
        return flash_attention(query, key, value, is_causal=is_causal)
    return sdpa_reference(query, key, value, attn_mask, p, is_causal)


def cross_entropy(input, label, ignore_index=-100):
    """Hard-label softmax cross-entropy over the last axis in f32 (the
    ``cross_entropy`` op, ``reduction="mean"``): labels equal to
    ``ignore_index`` count nothing, and the mean is over the valid
    labels."""
    (input,) = amp.cast_inputs("cross_entropy", input)
    logp = torch.log_softmax(input.float(), dim=-1)
    valid = label != ignore_index
    safe = torch.where(valid, label, torch.zeros_like(label)).long()
    nll = -logp.gather(-1, safe[..., None])[..., 0]
    loss = torch.where(valid, nll, torch.zeros_like(nll))
    return (loss.sum() / valid.sum().float().clamp_min(1.0)).to(input.dtype)
