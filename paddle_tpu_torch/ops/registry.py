"""Op registry (counterpart of ``paddle_tpu/ops/registry.py``): one plain
PyTorch body per op name, and overrides — the hand-written kernels — each
tried when its predicate holds, newest first.

One deliberate difference: the JAX ``OpDef.select`` swallows an exception
that a predicate raises and falls through to the generic op. Here it
propagates, since falling through would quietly run the plain version in
place of the kernel.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Tuple

__all__ = ["OpDef", "register_op", "register_override", "get_op", "has_op",
           "op_names", "DEFERRED"]

#: the JAX package's ops the port does not register yet, by the ROADMAP
#: Queue 1 item that ports them (none since ``vision.ops``); ``get_op``
#: names the item.
DEFERRED: Dict[str, int] = {}


def not_ported(what, item):
    """The error a caller gets on reaching ``what``, a part of the JAX
    package the port has not ported yet."""
    return NotImplementedError(f"{what} is not ported yet (ROADMAP Queue 1 "
                               f"item {item})")


class OpDef:
    __slots__ = ("name", "fn", "overrides")

    def __init__(self, name: str, fn: Callable):
        self.name = name
        self.fn = fn
        # (predicate(args, attrs) -> bool, fn), tried newest first
        self.overrides: List[Tuple[Callable, Callable]] = []

    def select(self, args, attrs) -> Callable:
        for pred, fn in reversed(self.overrides):
            if pred(args, attrs):
                return fn
        return self.fn


_OPS: Dict[str, OpDef] = {}


def register_op(name: str):
    """Decorator registering the plain body of op ``name``."""

    def deco(fn):
        if name in _OPS:
            raise KeyError(f"op {name!r} already registered")
        _OPS[name] = OpDef(name, fn)
        return fn

    return deco


def register_override(name: str, predicate: Callable):
    """Decorator registering a kernel for op ``name``, used when
    ``predicate(args, attrs)`` holds."""

    def deco(fn):
        get_op(name).overrides.append((predicate, fn))
        return fn

    return deco


def get_op(name: str) -> OpDef:
    try:
        return _OPS[name]
    except KeyError:
        if name in DEFERRED:
            raise not_ported(f"op {name!r}", DEFERRED[name]) from None
        raise NotImplementedError(f"op {name!r} is not registered") from None


def has_op(name: str) -> bool:
    return name in _OPS


def op_names():
    return sorted(_OPS)
