"""Static-graph op capture, the recording half of ``static`` (counterpart
of ``paddle_tpu/framework/static_capture.py``).

While a ``static.Program`` is current, ``call_op`` (``framework/
dispatch.py``) appends every op it runs here, after the AMP casts, so
that what is recorded is what ran: the op's selected function (a kernel
override or the plain body), where each tensor operand came from, and
the dtype the AMP policy cast it to. The port's tensor is
``torch.Tensor``, whose operators (``x + 1``, ``w.t()``, ``x[:, 0]``) do
not pass through ``call_op`` as the JAX Tensor's do: a
``TorchFunctionMode``, pushed while a program is current, records each
torch function called outside an op the same way. The Program replays
the node list as a function of its feeds and its live parameters
(``static/__init__.py``).

It also holds the export switch: inside :func:`exporting` (``jit.save``
and ``to_static`` capture through ``torch.export`` there) the kernel
overrides are chosen on any device, so the captured graph calls the
kernels' custom ops and an artifact made on the CPU launches them on the
card.

This module lives in ``framework`` (not ``static``) so that dispatch.py
imports it without a package cycle. It holds only the "current program"
pointer, the export depth and the node type.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Any, List, Optional, Tuple

import torch
from torch.overrides import TorchFunctionMode
from torch.utils import _pytree as pytree

__all__ = ["OpNode", "current", "set_current", "record", "in_op", "op_scope",
           "paused", "exporting", "export_scope"]

# the active recording target (a paddle_tpu_torch.static.Program) or None
current: Optional[Any] = None

_export = threading.local()
_ops = threading.local()        # depth of call_op frames being recorded


#: the operators that write their left operand (``x += y``, ``x[i] = v``);
#: any other dunder (``__get__`` of ``.shape``, ``__add__``) writes nothing
_INPLACE_DUNDERS = frozenset((
    "__setitem__", "__iadd__", "__isub__", "__imul__", "__itruediv__",
    "__ifloordiv__", "__imod__", "__ipow__", "__imatmul__", "__iand__",
    "__ior__", "__ixor__", "__ilshift__", "__irshift__"))


#: tensor attributes whose read is no op: an alias outside the graph
#: (``p.data``, as the store ``p.data = ...`` is not one either)
_NOT_OPS = frozenset(("data", "grad"))


class _Recorder(TorchFunctionMode):
    """Records the torch functions called outside ``call_op`` while a
    program is current that read a feed, a parameter or a recorded
    result (the rest, a layer's initialisation among them, are build-time
    constants): those with a tensor result, and the in-place ones
    (``add_``, ``__setitem__``, ``+=``) except on a parameter. Attribute
    stores (``t.data = ...``) and the reads of ``.data``/``.grad`` are
    not ops and are not recorded."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        prog = current
        if prog is None or getattr(_ops, "depth", 0) > 0:
            return out
        name = getattr(func, "__name__", str(func))
        if name == "__get__" and getattr(getattr(func, "__self__", None),
                                         "__name__", None) in _NOT_OPS:
            return out
        dunder = name.startswith("__") and name.endswith("__")
        inplace = name in _INPLACE_DUNDERS if dunder else name.endswith("_")
        target = args[0] if args else next(iter(kwargs.values()), None)
        if inplace and isinstance(target, torch.nn.Parameter):
            return out
        if inplace or any(isinstance(t, torch.Tensor)
                          for t in pytree.tree_leaves(out)):
            record(name, func, (args, kwargs), out, torch_function=True)
        return out


_recorder: Optional[_Recorder] = None


class OpNode:
    """One recorded dispatch: the function that ran and its operands.

    ``inputs`` holds one entry per leaf of ``(args, attrs)``:
    ``(tensor_id, value, cast_dtype)`` for a tensor (replay takes the
    env value for ``tensor_id`` when an earlier node or a feed produced
    it, else ``value`` itself: a parameter, read live, or a build-time
    constant; then casts to ``cast_dtype`` when the AMP policy did), or
    ``(None, value, None)`` for anything else. ``spec`` rebuilds
    ``(args, attrs)`` from the leaves. ``torch_function``: the recorder
    took it (``op`` is the torch function's name, which may be an op's
    too: ``add``), else ``call_op`` or a host node did."""

    __slots__ = ("op", "fn", "inputs", "out_ids", "attrs", "spec",
                 "torch_function")

    def __init__(self, op: str, fn, inputs: List[Tuple[Any, Any, Any]],
                 out_ids: List[int], attrs: Optional[dict] = None,
                 spec=None, torch_function=False):
        self.op = op
        self.fn = fn
        self.inputs = inputs
        self.out_ids = out_ids
        self.attrs = attrs or {}
        self.spec = spec
        self.torch_function = torch_function


def set_current(program) -> None:
    """Make ``program`` the recording target (``None``: stop recording),
    pushing the torch-function recorder on the first and popping it on
    the last."""
    global current, _recorder
    current = program
    if program is not None and _recorder is None:
        _recorder = _Recorder()
        _recorder.__enter__()
    elif program is None and _recorder is not None:
        rec, _recorder = _recorder, None
        rec.__exit__(None, None, None)


def in_op() -> bool:
    """Whether a recorded ``call_op`` frame is running on this thread."""
    return getattr(_ops, "depth", 0) > 0


@contextlib.contextmanager
def op_scope():
    """``call_op``'s frame while it records: the torch functions its
    body runs are part of the op, not nodes of their own."""
    _ops.depth = getattr(_ops, "depth", 0) + 1
    try:
        yield
    finally:
        _ops.depth -= 1


@contextlib.contextmanager
def paused():
    """Record nothing inside (an executor's replay, a data loader)."""
    prev = current
    set_current(None)
    try:
        yield
    finally:
        set_current(prev)


def record(op_name: str, fn, in_tensors, out_tensors,
           attrs: Optional[dict] = None, ran=None,
           torch_function=False) -> None:
    """Called from ``call_op`` for every op while capture is active (and
    from the recorder for the torch functions outside ops).
    ``in_tensors`` is the operands as the caller passed them, an
    ``(args, kwargs)`` pair; ``ran`` the same after the AMP casts (what
    ``fn`` ran on; ``None``: as given); ``out_tensors`` the result;
    ``attrs`` kept on the node as given. A call that reads no feed,
    parameter or recorded result is a build-time constant (a layer's
    initialisation, a data loader's batch) and is not recorded."""
    prog = current
    if prog is None:
        return
    args, kwargs = in_tensors
    leaves, spec = pytree.tree_flatten((tuple(args), dict(kwargs)))
    if not any(prog._tracks(t) for t in leaves
               if isinstance(t, torch.Tensor)):
        return
    used = leaves if ran is None else pytree.tree_leaves(
        (tuple(ran[0]), dict(ran[1])))
    inputs = []
    for orig, u in zip(leaves, used):
        if isinstance(orig, torch.Tensor):
            cast = u.dtype if u.dtype != orig.dtype else None
            inputs.append((id(orig), orig, cast))
        else:
            inputs.append((None, orig, None))
    outs = [t for t in pytree.tree_leaves(out_tensors)
            if isinstance(t, torch.Tensor)]
    prog._record_op(op_name, fn, inputs, spec, outs, attrs or {},
                    torch_function)


def exporting() -> bool:
    """Whether a ``torch.export`` capture of the port is running on this
    thread (:func:`export_scope`)."""
    return getattr(_export, "depth", 0) > 0


@contextlib.contextmanager
def export_scope():
    """Mark a ``torch.export`` capture: the kernel overrides hold on any
    device inside it."""
    _export.depth = getattr(_export, "depth", 0) + 1
    try:
        yield
    finally:
        _export.depth -= 1
