"""Unique names (counterpart of ``paddle_tpu/utils/unique_name.py``):
``generate(key)`` gives ``key_0``, ``key_1``, ... from the thread's
current generator; ``guard`` and ``switch`` swap it."""
from __future__ import annotations

import contextlib
import threading

__all__ = ["generate", "guard", "switch"]


class _Generator:
    def __init__(self):
        self.ids = {}

    def __call__(self, key):
        self.ids[key] = self.ids.get(key, 0) + 1
        return f"{key}_{self.ids[key] - 1}"


_tls = threading.local()


def _gen() -> _Generator:
    if not hasattr(_tls, "gen"):
        _tls.gen = _Generator()
    return _tls.gen


def generate(key: str) -> str:
    return _gen()(key)


def switch(new_generator=None):
    """Make ``new_generator`` (a fresh one by default) current; return the
    one it replaces."""
    old = _gen()
    _tls.gen = new_generator or _Generator()
    return old


@contextlib.contextmanager
def guard(new_generator=None):
    """Names inside the block come from ``new_generator`` (a fresh one by
    default); the old generator, and its counts, return after it."""
    old = switch(new_generator)
    try:
        yield
    finally:
        _tls.gen = old
