"""Functional ops of the GPT path (counterpart of
``paddle_tpu/nn/functional``): attention, dropout, cross-entropy.

:func:`scaled_dot_product_attention` runs the ``scaled_dot_product_attention``
op through ``call_op``. Its plain body is the composition of
``ops/nn_ops.py`` (:func:`sdpa_reference`); the override registered here
sends it to the flash attention kernels (K4-K7) whenever
:func:`flash_supported`, the structural half of ``_fa_supported``, holds
(no mask, no dropout, causal only with ``Sq == Sk``, ``D <= 256``),
whatever the dtypes and the device: on the card a dtype the kernels do
not take raises there; on the CPU the kernel wrapper runs its plain
version. The TPU's length threshold (``FLASH_MIN_SEQ``, measured on v5e)
and its autotune cache are not carried over: on the card every supported
shape goes to the kernel.
"""
from __future__ import annotations

import torch

from .. import amp
from ..framework.dispatch import call_op
from ..ops.flash_attention import MAX_HEAD_DIM, flash_attention
from ..ops.nn_ops import dropout, sdpa_reference
from ..ops.registry import register_override

__all__ = ["scaled_dot_product_attention", "sdpa_reference", "dropout",
           "cross_entropy", "flash_supported"]


def flash_supported(q, k, mask, dropout_p, is_causal) -> bool:
    """The structural half of ``_fa_supported``."""
    if q.dim() != 4 or mask is not None or dropout_p > 0.0:
        return False
    if is_causal and q.shape[1] != k.shape[1]:
        return False
    return q.shape[-1] <= MAX_HEAD_DIM


def _sdpa_flash(q, k, v, mask=None, dropout_p=0.0, is_causal=False,
                scale=None):
    return flash_attention(q, k, v, is_causal=is_causal, scale=scale)


register_override(
    "scaled_dot_product_attention",
    lambda args, attrs: flash_supported(
        args[0], args[1], args[3] if len(args) > 3 else attrs.get("mask"),
        attrs.get("dropout_p", 0.0), attrs.get("is_causal", False)),
)(_sdpa_flash)


def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p=0.0, is_causal=False,
                                 training=True):
    """Attention over ``[batch, seq, num_heads, head_dim]`` inputs."""
    p = float(dropout_p) if training else 0.0
    return call_op("scaled_dot_product_attention", query, key, value,
                   mask=attn_mask, dropout_p=p, is_causal=is_causal)


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
