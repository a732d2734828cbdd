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
                                 training=True, name=None):
    """Attention over ``[batch, seq, num_heads, head_dim]`` inputs."""
    p = float(dropout_p) if training else 0.0
    return call_op("scaled_dot_product_attention", query, key, value,
                   mask=attn_mask, dropout_p=p, is_causal=is_causal)


def cross_entropy(input, label, weight=None, ignore_index=-100,
                  reduction="mean", soft_label=False, axis=-1,
                  use_softmax=True, label_smoothing=0.0, name=None):
    """Softmax cross-entropy over ``axis`` in f32, the JAX package's
    ``cross_entropy`` op: hard labels (an int per row, or a size-1
    ``axis``) or ``soft_label`` distributions; ``use_softmax=False``
    takes ``input`` as probabilities; ``label_smoothing`` mixes in the
    uniform distribution; ``weight [classes]`` weighs each row by its
    label's class. Hard labels equal to ``ignore_index`` count nothing.
    ``reduction="mean"`` divides by the valid rows, or by the summed
    weights when there are weights; ``"sum"``; ``"none"`` keeps a loss a
    row."""
    if reduction not in ("mean", "sum", "none"):
        raise ValueError(f"reduction must be 'mean', 'sum' or 'none', got "
                         f"{reduction!r}")
    (input,) = amp.cast_inputs("cross_entropy", input)
    axis = axis % input.dim()
    lf = input.float()
    logp = torch.log_softmax(lf, dim=axis) if use_softmax \
        else torch.log(lf.clamp_min(1e-30))
    n_cls = input.shape[axis]
    w = None
    if soft_label:
        sl = label.float()
        if label_smoothing > 0:
            sl = sl * (1 - label_smoothing) + label_smoothing / n_cls
        loss = -(sl * logp).sum(dim=axis)
        valid = torch.ones_like(loss, dtype=torch.bool)
        if weight is not None:
            w = (sl * weight.float().reshape((1,) * axis + (-1,))).sum(
                dim=axis)
    else:
        lbl = label
        if lbl.dim() == input.dim() and lbl.shape[axis] == 1:
            lbl = lbl.squeeze(axis)
        valid = lbl != ignore_index
        safe = torch.where(valid, lbl, torch.zeros_like(lbl)).long()
        nll = -logp.gather(axis, safe.unsqueeze(axis)).squeeze(axis)
        if label_smoothing > 0:
            nll = (1 - label_smoothing) * nll \
                + label_smoothing * -logp.mean(dim=axis)
        loss = torch.where(valid, nll, torch.zeros_like(nll))
        if weight is not None:
            w = torch.where(valid, weight.float()[safe],
                            torch.zeros_like(nll))
    if w is not None:
        loss = loss * w
    if reduction == "mean":
        denom = w.sum().clamp_min(1e-12) if w is not None \
            else valid.sum().float().clamp_min(1.0)
        return (loss.sum() / denom).to(input.dtype)
    if reduction == "sum":
        return loss.sum().to(input.dtype)
    return loss.to(input.dtype)
