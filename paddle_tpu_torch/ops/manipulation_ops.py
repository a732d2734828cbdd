"""Shape ops (counterpart of ``paddle_tpu/ops/manipulation_ops.py``)."""
from __future__ import annotations

import torch

from .registry import register_op


@register_op("reshape")
def _reshape(x, shape):
    # a 0 in the target copies the input's dim at that position
    shape = tuple(x.shape[i] if d == 0 and i < x.dim() else d
                  for i, d in enumerate(shape))
    return torch.reshape(x, shape)


@register_op("transpose")
def _transpose(x, perm):
    return x.permute(tuple(perm))


@register_op("concat")
def _concat(xs, axis=0):
    return torch.cat(list(xs), dim=int(axis))


@register_op("slice")
def _slice(x, axes, starts, ends):
    idx = [slice(None)] * x.dim()
    for a, s, e in zip(axes, starts, ends):
        idx[a] = slice(s, e)
    return x[tuple(idx)]
