"""``fluid.layers``: the 1.x op namespace (counterpart of
``paddle_tpu/fluid/layers.py``). Resolution order: the ``static.nn``
builders (fc/conv2d/batch_norm/sequence_*...), then the top-level
functional API (mean/concat/reshape/...), then ``nn.functional``.
"""
from __future__ import annotations

from ..static.nn import *  # noqa: F401,F403
from ..static.nn import fc  # noqa: F401
from ..static.nn import cond, while_loop, case, switch_case  # noqa: F401


def __getattr__(name):
    if name.startswith("__"):       # a module attribute (__all__, ...)
        raise AttributeError(name)
    import importlib
    top = importlib.import_module(__name__.rsplit(".", 2)[0])
    from ..nn import functional as _F
    for src in (top, _F):
        try:
            return getattr(src, name)
        except AttributeError:
            continue
    raise AttributeError(
        f"fluid.layers.{name} is not mapped; use the paddle 2.x API "
        f"(paddle.{name} / paddle.nn.functional.{name} / "
        f"paddle.static.nn.{name})")


def data(name, shape, dtype="float32", append_batch_size=True,
         lod_level=0):
    """1.x fluid.layers.data: ``shape`` is PER SAMPLE and a batch dim is
    prepended (``append_batch_size=True`` by default), unlike 2.x
    ``static.data``, whose shape is the whole tensor's."""
    from ..static import data as _data
    shape = list(shape)
    if append_batch_size:
        shape = [-1] + shape
    return _data(name, shape, dtype)


def cross_entropy(input, label, soft_label=False, ignore_index=-100):
    """1.x cross_entropy takes PROBABILITIES (after the softmax). Any
    leading dims (``[N, ..., C]`` with label ``[N, ..., 1]``) and
    ``ignore_index`` masking; the loss is shaped like ``label``."""
    from .. import (cast, clip, log, reshape, squeeze, sum as _sum,
                    take_along_axis)
    logp = log(clip(input, 1e-8, 1.0))
    if soft_label:
        return -(_sum(label * logp, axis=-1, keepdim=True))
    c = input.shape[-1]
    flat_logp = reshape(logp, [-1, c])
    flat_label = reshape(label, [-1])
    safe = clip(flat_label, 0, c - 1)
    picked = -squeeze(
        take_along_axis(flat_logp, reshape(safe, [-1, 1]), axis=1), axis=1)
    mask = cast(flat_label != ignore_index, picked.dtype)
    return reshape(picked * mask, label.shape)


def softmax_with_cross_entropy(logits, label, soft_label=False, axis=-1):
    from ..nn import functional as _F
    return _F.softmax_with_cross_entropy(logits, label,
                                         soft_label=soft_label, axis=axis)
