"""``compat`` (counterpart of ``paddle_tpu/compat.py``): the reference's
string and number helpers from its Python 2 days, still used downstream."""
from __future__ import annotations

__all__ = ["long_type", "to_text", "to_bytes", "round", "floor_division",
           "get_exception_message"]

import math

long_type = int


def _convert(obj, conv, container_conv):
    if obj is None:
        return obj
    if isinstance(obj, (list, set)):
        return type(obj)(container_conv(o) for o in obj)
    return conv(obj)


def to_text(obj, encoding="utf-8", inplace=False):
    if isinstance(obj, dict):
        return {to_text(k, encoding): to_text(v, encoding)
                for k, v in obj.items()}
    return _convert(
        obj,
        lambda o: o.decode(encoding) if isinstance(o, bytes) else str(o),
        lambda o: to_text(o, encoding))


def to_bytes(obj, encoding="utf-8", inplace=False):
    if isinstance(obj, dict):
        return {to_bytes(k, encoding): to_bytes(v, encoding)
                for k, v in obj.items()}
    return _convert(
        obj,
        lambda o: o.encode(encoding) if isinstance(o, str) else bytes(o),
        lambda o: to_bytes(o, encoding))


def round(x, d=0):
    """Python2-style round (half away from zero)."""
    if x is None:
        return None
    p = 10 ** d
    if x >= 0:
        return float(math.floor((x * p) + 0.5)) / p
    return float(math.ceil((x * p) - 0.5)) / p


def floor_division(x, y):
    return x // y


def get_exception_message(exc):
    return str(exc)
