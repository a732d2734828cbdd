"""Creation ops (counterpart of ``paddle_tpu/ops/creation_ops.py``).
``device=None`` is the current place: the card, unless
``set_device("cpu")``; the model code passes its parameters' device."""
from __future__ import annotations

import torch

from ..framework.dtypes import convert_dtype
from ..framework.place import to_torch_device
from .registry import register_op


def _dtype(dtype):
    return None if dtype is None else convert_dtype(dtype)


@register_op("full")
def _full(shape=(), fill_value=0.0, dtype=None, device=None):
    return torch.full(tuple(shape), fill_value, dtype=_dtype(dtype),
                      device=to_torch_device(device))


@register_op("zeros")
def _zeros(shape=(), dtype=None, device=None):
    return torch.zeros(tuple(shape), dtype=convert_dtype(dtype),
                       device=to_torch_device(device))


@register_op("arange")
def _arange(start=0, end=None, step=1, dtype=None, device=None):
    if end is None:
        start, end = 0, start
    return torch.arange(start, end, step, dtype=_dtype(dtype),
                        device=to_torch_device(device))
