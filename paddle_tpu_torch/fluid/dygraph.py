"""``fluid.dygraph``: the 1.x imperative API (counterpart of
``paddle_tpu/fluid/dygraph.py``)."""
from __future__ import annotations

import contextlib

from ..nn.layer.layers import Layer  # noqa: F401


def to_variable(value, name=None, zero_copy=None, dtype=None):
    from .. import to_tensor
    return to_tensor(value, dtype=dtype)


@contextlib.contextmanager
def guard(place=None):
    """1.x dygraph.guard: dynamic mode is the default; the guard makes
    sure of it (and turns static mode back on after, if it was on)."""
    from .. import static as _s
    was_static = not _s.in_dynamic_mode()
    if was_static:
        _s.disable_static()
    try:
        yield
    finally:
        if was_static:
            _s.enable_static()


def no_grad(fn=None):
    """1.x no_grad: a context manager AND a decorator."""
    import functools
    from .. import no_grad as _no_grad
    if fn is None:
        return _no_grad()

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with _no_grad():
            return fn(*args, **kwargs)
    return wrapped
