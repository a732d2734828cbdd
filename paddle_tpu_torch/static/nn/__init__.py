"""``static.nn``: the control-flow ops (``cond`` / ``while_loop`` /
``case`` / ``switch_case``), the ``fc`` builder and the fluid layer
builders (counterpart of ``paddle_tpu/static/nn/__init__.py``).

Reference: python/paddle/static/nn/__init__.py re-exporting
fluid/layers/control_flow.py (cond:68, while_loop:86), backed by
conditional_block_op.cc / while_op.cc in the C++ executor.

As in the JAX package, a concrete predicate picks the branch in Python
(the reference's dygraph mode, and a static program's build, which runs
on its placeholders). Under a ``torch.export`` trace (``jit.to_static``,
``jit.save``), where the predicate is a traced tensor, they lower to
``torch.cond`` and ``torch._higher_order_ops.while_loop``, the
counterparts of ``lax.cond``/``lax.while_loop`` that ``jit/dy2static.py``
emits too: real control flow in the exported program. ``switch_case`` is
a chain of ``torch.cond`` over the keys (torch has no ``lax.switch``);
an index that matches no key runs ``default``, or else the branch with
the largest key, as in the reference.
"""
from __future__ import annotations

from typing import Callable, Sequence

import torch

from ...framework import static_capture as _capture
from ...jit.dy2static import Dy2StaticError, _is_tracer, _tree_has_tracer

__all__ = ["cond", "while_loop", "case", "switch_case"]


def _traced_cond(pred, true_fn, false_fn):
    """``torch.cond`` over two no-argument branches returning the same
    structure of tensors (the branches close over what they read)."""
    try:
        return torch.cond(pred, lambda: true_fn(), lambda: false_fn(), ())
    except Exception as e:  # torch's own errors: one type per version
        raise Dy2StaticError(
            "both branches of static.nn.cond must return structures of "
            f"matching shapes/dtypes: {e}") from e


def cond(pred, true_fn: Callable, false_fn: Callable, name=None):
    """Reference: fluid/layers/control_flow.py cond; both branches must
    return structures of matching shapes/dtypes."""
    if not _is_tracer(pred):
        return true_fn() if bool(pred) else false_fn()
    return _traced_cond(pred, true_fn, false_fn)


def _as_list(out):
    return list(out) if isinstance(out, (list, tuple)) else [out]


def while_loop(cond_fn: Callable, body_fn: Callable,
               loop_vars: Sequence, is_test=False, name=None):
    """Reference: fluid/layers/control_flow.py while_loop. ``loop_vars``
    is a list; ``cond_fn(*vars)`` gives a boolean scalar and
    ``body_fn(*vars)`` the new vars (a traced loop keeps each one's shape
    and dtype)."""
    loop_vars = list(loop_vars)
    pred = cond_fn(*loop_vars)
    if not (_is_tracer(pred) or _tree_has_tracer(loop_vars)):
        while bool(pred):
            loop_vars = _as_list(body_fn(*loop_vars))
            pred = cond_fn(*loop_vars)
        return loop_vars
    from torch._higher_order_ops import while_loop as _while
    try:
        out = _while(lambda *vs: cond_fn(*vs),
                     lambda *vs: tuple(_as_list(body_fn(*vs))),
                     tuple(loop_vars))
    except Exception as e:  # torch's own errors: one type per version
        raise Dy2StaticError(
            "static.nn.while_loop must keep the shape and dtype of every "
            f"variable it carries: {e}") from e
    return list(out)


def case(pred_fn_pairs, default=None, name=None):
    """Reference: fluid/layers/control_flow.py case; the first true
    predicate wins, then ``default`` (else the last pair's function)."""
    if not pred_fn_pairs:
        raise ValueError("pred_fn_pairs must not be empty")

    def build(i):
        if i >= len(pred_fn_pairs):
            if default is None:
                return pred_fn_pairs[-1][1]()
            return default()
        pred, fn = pred_fn_pairs[i]
        return cond(pred, fn, lambda: build(i + 1))

    return build(0)


def switch_case(branch_index, branch_fns, default=None, name=None):
    """Reference: fluid/layers/control_flow.py switch_case. An unmatched
    index runs ``default``, or the branch with the largest key when no
    default is given, traced or not."""
    if isinstance(branch_fns, dict):
        pairs = sorted(branch_fns.items())
    else:
        pairs = list(enumerate(branch_fns))
    keys = [k for k, _ in pairs]
    fallback = default if default is not None else \
        pairs[keys.index(max(keys))][1]
    if not _is_tracer(branch_index):
        i = int(branch_index)
        for k, fn in pairs:
            if k == i:
                return fn()
        return fallback()

    def chain(j):
        if j == len(pairs):
            return fallback()
        k, fn = pairs[j]
        return _traced_cond(branch_index == k, fn, lambda: chain(j + 1))

    return chain(0)


def fc(x, size, num_flatten_dims=1, weight_attr=None, bias_attr=None,
       activation=None, name=None):
    """Fully-connected layer for static graphs (reference:
    python/paddle/static/nn/common.py fc): dims ``x.shape[nfd:]`` flatten
    into the weight's input axis and the output keeps the leading dims,
    ``x.shape[:nfd] + [size]``. Each call creates fresh parameters on
    ``x``'s device (the graph is built once, so each call site is its
    own layer, as the reference's unique auto-named parameters)."""
    import numpy as np
    from ...nn import Linear
    from ...nn import functional as F
    nfd = num_flatten_dims if num_flatten_dims >= 0 \
        else len(x.shape) + num_flatten_dims
    in_features = int(np.prod(x.shape[nfd:]))
    if len(x.shape) != nfd + 1:
        # the batch (dim 0) stays -1 so the recorded reshape replays at
        # any batch size
        x = x.reshape([-1] + [int(d) for d in x.shape[1:nfd]]
                      + [in_features])
    with _capture.paused():             # the layer's making: no ops
        layer = Linear(in_features, size, weight_attr=weight_attr,
                       bias_attr=bias_attr).to(x.device)
    out = layer(x)
    if activation is not None:
        out = getattr(F, activation)(out)
    return out


__all__.append("fc")


from .layers_compat import *  # noqa: E402,F401,F403  (fluid layer builders)
from . import layers_compat as _compat  # noqa: E402
__all__ += [n for n in _compat.__all__ if n != "fc_compat_registry"]

from ..extras import py_func  # noqa: E402,F401  (shared with static.py_func)
__all__.append("py_func")
