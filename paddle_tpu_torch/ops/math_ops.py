"""Elementwise and matrix ops (counterparts of ``paddle_tpu/ops/
math_ops.py`` and ``linalg_ops.py``)."""
from __future__ import annotations

import torch

from .registry import register_op

register_op("add")(torch.add)
register_op("multiply")(torch.mul)
register_op("maximum")(torch.maximum)


@register_op("matmul")
def _matmul(x, y, transpose_x=False, transpose_y=False):
    if transpose_x and x.dim() > 1:
        x = x.transpose(-1, -2)
    if transpose_y and y.dim() > 1:
        y = y.transpose(-1, -2)
    return torch.matmul(x, y)


@register_op("cumsum")
def _cumsum(x, axis=None):
    # in x's dtype: torch would widen an integer sum to int64
    if axis is None:
        return torch.cumsum(x.reshape(-1), 0, dtype=x.dtype)
    return torch.cumsum(x, int(axis), dtype=x.dtype)
