"""InferMeta (counterpart of ``paddle_tpu/framework/infermeta.py``):
shape and dtype inference and the checks ``call_op`` runs before an op.

Two tiers, as in the JAX package:

1. ``infer_meta(op, *specs, **attrs)``: the output shapes and dtypes of
   any registered op without computing it, by running its plain body on
   ``meta`` tensors (the counterpart of ``jax.eval_shape``). A spec is a
   tensor, a numpy array or any object with ``shape`` and ``dtype``;
   the result is a meta tensor (or a tree of them). An op whose output
   shape depends on the data (``nonzero``, ``unique``) cannot be
   inferred, as under ``jax.eval_shape``.
2. The curated checks of the most-called ops, raising :class:`ShapeError`
   with both operands' shapes in the message at the call site.

``call_op`` runs :func:`maybe_check` under ``FLAGS_check_shapes`` (on by
default, as in the JAX package). A check reads shapes, dtypes and the
op's Python attributes only, never a tensor's value, so it adds no
device sync; with the flag off the hook costs one flag read.
"""
from __future__ import annotations

import math
from typing import Callable, Dict

import numpy as np
import torch

__all__ = ["infer_meta", "register_infermeta", "maybe_check", "ShapeError"]


class ShapeError(ValueError):
    """An op's operands do not fit its shape rule (the reference's
    ``phi::errors::InvalidArgument`` from InferMeta)."""


_VALIDATORS: Dict[str, Callable] = {}


def register_infermeta(name):
    def deco(fn):
        _VALIDATORS[name] = fn
        return fn

    return deco


def _shape(x):
    s = getattr(x, "shape", None)
    return tuple(s) if s is not None else ()


def maybe_check(name, args, attrs):
    """Run op ``name``'s check on ``args``/``attrs``, if it has one."""
    v = _VALIDATORS.get(name)
    if v is not None:
        v(*args, **attrs)


def _to_meta(x):
    from .dtypes import convert_dtype
    if isinstance(x, torch.Tensor):
        return torch.empty(tuple(x.shape), dtype=x.dtype, device="meta")
    if isinstance(x, (list, tuple)):
        return type(x)(_to_meta(v) for v in x)
    if hasattr(x, "shape") and hasattr(x, "dtype"):
        return torch.empty(tuple(x.shape), dtype=convert_dtype(x.dtype),
                           device="meta")
    return x


def infer_meta(op_name, *specs, **attrs):
    """The outputs of op ``op_name`` on ``specs`` as meta tensors (their
    ``shape`` and ``dtype``), without computing anything."""
    from ..ops.registry import get_op
    return get_op(op_name).fn(*[_to_meta(s) for s in specs], **attrs)


# ---------------------------------------------------------------------------
# curated validators (reference: phi/infermeta/binary.cc MatmulInferMeta,
# multiary.cc ConcatInferMeta, ConvInferMeta, EmbeddingInferMeta, ...)
# ---------------------------------------------------------------------------

@register_infermeta("matmul")
def _matmul_meta(x, y, transpose_x=False, transpose_y=False, **_):
    xs, ys = _shape(x), _shape(y)
    if not xs or not ys:
        return
    if len(xs) == 1 and len(ys) == 1:
        if xs[0] != ys[0]:
            raise ShapeError(
                f"matmul: 1-D operands must agree, got {xs} vs {ys}")
        return
    kx = xs[-2] if (transpose_x and len(xs) > 1) else xs[-1]
    ky = ys[-1] if (transpose_y and len(ys) > 1) else \
        (ys[-2] if len(ys) > 1 else ys[0])
    if kx != ky:
        raise ShapeError(
            f"matmul: contracted dims must agree, got X{list(xs)} "
            f"(transpose_x={transpose_x}) vs Y{list(ys)} "
            f"(transpose_y={transpose_y}): {kx} != {ky}")


@register_infermeta("concat")
def _concat_meta(xs, axis=0, **_):
    if not isinstance(xs, (list, tuple)) or len(xs) < 1:
        raise ShapeError("concat: expects a non-empty list of tensors")
    shapes = [_shape(x) for x in xs]
    r = len(shapes[0])
    if r and not -r <= axis < r:
        raise ShapeError(f"concat: axis {axis} out of range for rank {r}")
    ax = axis % r if r else 0
    for s in shapes[1:]:
        if len(s) != r:
            raise ShapeError(
                f"concat: ranks differ, got {[list(s) for s in shapes]}")
        for d in range(r):
            if d != ax and s[d] != shapes[0][d]:
                raise ShapeError(
                    f"concat: non-axis dims must agree along axis {axis}, "
                    f"got {[list(s) for s in shapes]}")


@register_infermeta("conv2d")
def _conv2d_meta(x, w, bias=None, groups=1, data_format="NCHW", **_):
    xs, ws = _shape(x), _shape(w)
    if len(xs) != 4 or len(ws) != 4:
        raise ShapeError(
            f"conv2d: input/filter must be 4-D, got x{list(xs)} w{list(ws)}")
    cin = xs[1] if data_format.startswith("NC") else xs[-1]
    if cin != ws[1] * groups:
        raise ShapeError(
            f"conv2d: input channels {cin} != filter in-channels "
            f"{ws[1]} * groups {groups} (x{list(xs)}, w{list(ws)})")
    if ws[0] % groups != 0:
        raise ShapeError(
            f"conv2d: out channels {ws[0]} not divisible by groups {groups}")


@register_infermeta("embedding")
def _embedding_meta(ids, weight, **_):
    ws = _shape(weight)
    if len(ws) != 2:
        raise ShapeError(
            f"embedding: weight must be 2-D [vocab, dim], got {list(ws)}")


@register_infermeta("linear")
def _linear_meta(x, w, bias=None, **_):
    xs, ws = _shape(x), _shape(w)
    if len(ws) != 2:
        raise ShapeError(f"linear: weight must be 2-D, got {list(ws)}")
    if xs and xs[-1] != ws[0]:
        raise ShapeError(
            f"linear: input feature dim {xs[-1]} != weight rows {ws[0]} "
            f"(x{list(xs)}, w{list(ws)})")
    if bias is not None:
        bs = _shape(bias)
        if bs and bs[-1] != ws[1]:
            raise ShapeError(
                f"linear: bias dim {bs[-1]} != out features {ws[1]}")


@register_infermeta("cross_entropy")
def _ce_meta(logits, label, weight=None, soft_label=False, axis=-1, **_):
    ls, ys = _shape(logits), _shape(label)
    if soft_label:
        if ls != ys:
            raise ShapeError(
                f"cross_entropy(soft_label): logits {list(ls)} and label "
                f"{list(ys)} must match")
        return
    if ls and ys and len(ys) not in (len(ls) - 1, len(ls)):
        raise ShapeError(
            f"cross_entropy: label rank {len(ys)} incompatible with logits "
            f"rank {len(ls)} (logits {list(ls)}, label {list(ys)})")


@register_infermeta("batch_norm")
def _bn_meta(x, mean, var, weight=None, bias=None, data_format="NCHW", **_):
    xs = _shape(x)
    if len(xs) < 2:
        raise ShapeError(f"batch_norm: input must be ≥2-D, got {list(xs)}")
    c = xs[1] if data_format.startswith("NC") else xs[-1]
    for nm, t in (("mean", mean), ("variance", var), ("weight", weight),
                  ("bias", bias)):
        if t is None:
            continue
        ts = _shape(t)
        if ts and ts[0] != c:
            raise ShapeError(
                f"batch_norm: {nm} has {ts[0]} channels, input has {c} "
                f"(x{list(xs)})")


@register_infermeta("reshape")
def _reshape_meta(x, shape=None, **_):
    if shape is None:
        return
    xs = _shape(x)
    total = math.prod(xs)
    tgt = list(shape)
    n_minus = sum(1 for d in tgt if d == -1)
    if n_minus > 1:
        raise ShapeError(f"reshape: at most one -1 allowed, got {tgt}")
    if not all(isinstance(d, (int, np.integer)) for d in tgt):
        return  # symbolic dims: leave to the tracer
    known = 1
    for i, d in enumerate(tgt):
        if d == 0:  # reference: 0 copies the input dim at that position
            known *= xs[i] if i < len(xs) else 1
        elif d > 0:
            known *= d
    if n_minus == 0 and known != total:
        raise ShapeError(
            f"reshape: cannot reshape {list(xs)} ({total} elements) into "
            f"{tgt} ({known} elements)")
    if n_minus == 1 and (known == 0 or total % known != 0):
        raise ShapeError(
            f"reshape: cannot infer -1 for {list(xs)} -> {tgt}: {total} "
            f"not divisible by {known}")


@register_infermeta("split")
def _split_meta(x, num_or_sections=None, axis=0, **_):
    xs = _shape(x)
    if not xs or num_or_sections is None:
        return
    if not -len(xs) <= axis < len(xs):
        raise ShapeError(
            f"split: axis {axis} out of range for rank {len(xs)}")
    ax = axis % len(xs)
    size = xs[ax]
    if isinstance(num_or_sections, int):
        if size % num_or_sections != 0:
            raise ShapeError(
                f"split: dim {ax} of size {size} not divisible into "
                f"{num_or_sections} parts (x{list(xs)})")
    else:
        secs = [s for s in num_or_sections]
        if -1 not in secs and sum(secs) != size:
            raise ShapeError(
                f"split: sections {secs} must sum to dim {ax} size {size}")


@register_infermeta("one_hot")
def _one_hot_meta(x, num_classes=None, **_):
    if num_classes is not None and int(num_classes) < 1:
        raise ShapeError(f"one_hot: num_classes must be ≥1, got "
                         f"{num_classes}")


@register_infermeta("transpose")
def _transpose_meta(x, perm=None, **_):
    if perm is None:
        return
    xs = _shape(x)
    if len(perm) != len(xs):
        raise ShapeError(
            f"transpose: perm {list(perm)} length must equal input rank "
            f"{len(xs)} (x{list(xs)})")
    if sorted(perm) != list(range(len(xs))):
        raise ShapeError(f"transpose: perm {list(perm)} is not a "
                         f"permutation of 0..{len(xs) - 1}")


@register_infermeta("expand")
def _expand_meta(x, shape=None, **_):
    if shape is None:
        return
    xs = _shape(x)
    if len(shape) < len(xs):
        raise ShapeError(
            f"expand: target rank {len(shape)} < input rank {len(xs)}")
    for xd, td in zip(xs[::-1], list(shape)[::-1]):
        if td != -1 and xd not in (1, td):
            raise ShapeError(
                f"expand: cannot expand {list(xs)} to {list(shape)}: dim "
                f"{xd} vs {td}")


@register_infermeta("gather")
def _gather_meta(x, index, axis=0, **_):
    xs = _shape(x)
    if xs and not -len(xs) <= axis < len(xs):
        raise ShapeError(
            f"gather: axis {axis} out of range for rank {len(xs)}")


@register_infermeta("layer_norm")
def _ln_meta(x, weight=None, bias=None, begin_norm_axis=None, **_):
    xs = _shape(x)
    if begin_norm_axis is None or not xs:
        return
    norm_shape = xs[begin_norm_axis:]
    n = math.prod(norm_shape)
    for nm, t in (("weight", weight), ("bias", bias)):
        if t is None:
            continue
        ts = _shape(t)
        if ts and math.prod(ts) != n:
            raise ShapeError(
                f"layer_norm: {nm} shape {list(ts)} must cover normalized "
                f"shape {list(norm_shape)} of x{list(xs)}")
