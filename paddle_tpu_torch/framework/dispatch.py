"""``call_op``: run a registered op (counterpart of
``paddle_tpu/framework/dispatch.py`` :328 and ``_call_op_impl`` :363).

The steps, in order: look the op up; bump ``op_count/<name>``; under
``FLAGS_check_shapes`` run the op's shape check (``framework/
infermeta.py``, shapes and attributes only); cast the inputs through
``amp.cast_inputs``; pick the override whose predicate holds (a kernel),
else the plain body; run; sweep the outputs for NaN/Inf under
``FLAGS_check_nan_inf``; while a ``static.Program`` is current, record
the op into it (``framework/static_capture.py``), with the dtypes the
casts gave its operands. There is no tape and no per-op jit cache: torch
autograd records the ops, and an eager torch op needs no compile.
"""
from __future__ import annotations

import time

import torch

from .. import amp
from ..ops.registry import get_op
from . import static_capture as _capture
from .flags import flag_value
from .infermeta import maybe_check as _infermeta_check
from .monitor import stat_add, stat_observe

__all__ = ["call_op"]


def call_op(name: str, *args, **attrs):
    """Run op ``name`` on ``args`` (tensors, lists of tensors, Python
    values) and keyword ``attrs``."""
    if _capture.current is not None and not _capture.in_op():
        with _capture.op_scope():
            return _call_op(name, args, attrs, record=True)
    return _call_op(name, args, attrs)


def _call_op(name, args, attrs, record=False):
    opdef = get_op(name)
    stat_add(f"op_count/{name}")
    if flag_value("FLAGS_check_shapes"):
        _infermeta_check(name, args, attrs)
    given, given_attrs = args, attrs
    if amp.is_auto_cast_enabled():
        args = tuple(_cast(name, a) for a in args)
        attrs = {k: _cast(name, v) for k, v in attrs.items()}
    fn = opdef.select(args, attrs)
    if flag_value("FLAGS_benchmark"):
        out = _timed(name, fn, args, attrs)
    else:
        out = fn(*args, **attrs)
    if flag_value("FLAGS_check_nan_inf"):
        _check_nan_inf(name, out)
    if record:
        # static-graph mode: append this dispatch to the active Program
        # (framework/static_capture.py)
        _capture.record(name, fn, (given, given_attrs), out,
                        ran=(args, attrs))
    return out


def _cast(name, a):
    if isinstance(a, torch.Tensor):
        return amp.cast_inputs(name, a)[0]
    if isinstance(a, (list, tuple)) and a and all(
            isinstance(t, torch.Tensor) for t in a):
        return type(a)(amp.cast_inputs(name, *a))
    return a


def _outputs(out):
    return out if isinstance(out, (list, tuple)) else (out,)


def _timed(name, fn, args, attrs):
    """``FLAGS_benchmark``: the op's time to its end, in ms, one sample of
    the ``op_time_ms/<name>`` distribution (count, sum, p50/p95/p99, as
    the JAX package keeps it). Waits for the card after each op."""
    t0 = time.perf_counter()
    out = fn(*args, **attrs)
    if any(isinstance(t, torch.Tensor) and t.is_cuda for t in _outputs(out)):
        torch.cuda.synchronize()
    stat_observe(f"op_time_ms/{name}", (time.perf_counter() - t0) * 1e3)
    return out


def _check_nan_inf(name, out):
    for t in _outputs(out):
        if (isinstance(t, torch.Tensor) and t.is_floating_point()
                and not bool(torch.isfinite(t).all())):
            raise FloatingPointError(
                f"Operator {name} output contains NaN/Inf (shape "
                f"{tuple(t.shape)})")
