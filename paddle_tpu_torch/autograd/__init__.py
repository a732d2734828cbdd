"""``autograd`` (counterpart of ``paddle_tpu/autograd``): ``backward``,
``grad``, ``PyLayer`` and the functional ``jacobian``/``hessian``/
``vjp``/``jvp``, on ``torch.autograd``.

``grad`` is ``torch.autograd.grad``: it leaves every input's ``.grad``
as it was and honours ``allow_unused`` and ``create_graph``; the graph
is kept by default, as in the JAX package. ``PyLayer`` is a
``torch.autograd.Function`` underneath: its ``forward(ctx, ...)`` and
``backward(ctx, *grads)`` get a ``PyLayerContext`` with
``save_for_backward`` and ``saved_tensor()``, and the backward returns
one gradient for each tensor argument. The functional transforms are
``torch.autograd.functional``'s, with the JAX package's return
structure (a tensor where there is one input and one output, else
nested lists ``[output][input]``).

The flash attention and LayerNorm kernels' ``autograd.Function``s have
no double backward (neither have the JAX package's custom VJPs):
``hessian``, ``jvp`` and a second differentiation of ``grad(...,
create_graph=True)`` through them raise, never giving a wrong number.
"""
from __future__ import annotations

import contextlib

import torch

from ..framework.tensor import no_grad  # noqa: F401  (re-exported)

__all__ = ["backward", "grad", "PyLayer", "PyLayerContext", "no_grad",
           "jacobian", "hessian", "vjp", "jvp", "differentiable_apply"]


def _list(x):
    return [x] if torch.is_tensor(x) else list(x)


def backward(tensors, grad_tensors=None, retain_graph=False):
    """Accumulate the gradients of ``tensors`` (weighted by
    ``grad_tensors``, ones for scalars) into the leaves' ``.grad``."""
    tensors = _list(tensors)
    if grad_tensors is not None:
        grad_tensors = _list(grad_tensors)
    torch.autograd.backward(tensors, grad_tensors, retain_graph=retain_graph)


def grad(outputs, inputs, grad_outputs=None, retain_graph=None,
         create_graph=False, only_inputs=True, allow_unused=False,
         no_grad_vars=None):
    """The gradients of ``outputs`` with respect to ``inputs``, a list
    (``None`` for an input the outputs do not reach, with
    ``allow_unused``; else that raises). No input's ``.grad`` changes.
    ``retain_graph`` defaults to True (the JAX package keeps the graph);
    ``create_graph`` records the gradients' own graph. ``only_inputs``
    is the reference's deprecated switch and changes nothing; a
    ``no_grad_vars`` is not ported yet (ROADMAP Queue 1 item 5)."""
    if no_grad_vars:
        from ..ops.registry import not_ported
        raise not_ported("autograd.grad(no_grad_vars=...)", 5)
    outputs, inputs = _list(outputs), _list(inputs)
    if grad_outputs is not None:
        grad_outputs = _list(grad_outputs)
    return list(torch.autograd.grad(
        outputs, inputs, grad_outputs,
        retain_graph=True if retain_graph is None else retain_graph,
        create_graph=create_graph, allow_unused=allow_unused))


class PyLayerContext:
    """What ``PyLayer.forward`` and ``backward`` share: the tensors saved
    for the backward and any attribute the forward sets."""

    _ctx = None     # torch's context, lent for each forward and backward

    def save_for_backward(self, *tensors):
        self._ctx.save_for_backward(*tensors)

    def saved_tensor(self):
        return self._ctx.saved_tensors

    def mark_non_differentiable(self, *tensors):
        self._ctx.mark_non_differentiable(*tensors)


@contextlib.contextmanager
def _lent(ctx):
    """``ctx.pctx`` reaches torch's ``ctx`` only inside the call (a lasting
    link would make a reference cycle through the graph)."""
    ctx.pctx._ctx = ctx
    try:
        yield
    finally:
        ctx.pctx._ctx = None


class _PyLayerFunction(torch.autograd.Function):
    """The ``torch.autograd.Function`` behind every ``PyLayer``: the
    layer class and the keyword arguments ride as its first two
    arguments."""

    @staticmethod
    def forward(ctx, layer, kwargs, *args):
        ctx.layer, ctx.pctx = layer, PyLayerContext()
        ctx.tensor_args = [torch.is_tensor(a) for a in args]
        with _lent(ctx):
            return layer.forward(ctx.pctx, *args, **kwargs)

    @staticmethod
    def backward(ctx, *grads):
        with _lent(ctx):
            gin = ctx.layer.backward(ctx.pctx, *grads)
        gin = iter([gin] if gin is None or torch.is_tensor(gin)
                   else list(gin))
        return (None, None) + tuple(next(gin, None) if is_tensor else None
                                    for is_tensor in ctx.tensor_args)


class PyLayer:
    """A custom differentiable operation: subclass with static
    ``forward(ctx, *args, **kwargs)`` and ``backward(ctx, *grads)``
    (one gradient, or ``None``, for each tensor argument, in order) and
    call ``apply``."""

    @classmethod
    def apply(cls, *args, **kwargs):
        return _PyLayerFunction.apply(cls, kwargs, *args)

    @staticmethod
    def forward(ctx, *args, **kwargs):
        raise NotImplementedError

    @staticmethod
    def backward(ctx, *args):
        raise NotImplementedError


def _inputs(xs):
    single = torch.is_tensor(xs)
    return single, tuple(x.detach() for x in _list(xs))


def _as_tuple(out):
    return tuple(out) if isinstance(out, (list, tuple)) else (out,)


def _nested(obj):
    """The JAX package's structure: lists of lists, each of one element
    collapsed to the element."""
    if isinstance(obj, (tuple, list)):
        out = [_nested(o) for o in obj]
        return out[0] if len(out) == 1 else out
    return obj


def jacobian(func, xs, create_graph=False, allow_unused=False):
    """The jacobian of ``func`` at ``xs``: a tensor of shape ``out.shape +
    x.shape`` for one input and one output, else lists ``[output]
    [input]``. An input an output does not reach gives zeros."""
    _, xs = _inputs(xs)

    def fn(*a):
        return _as_tuple(func(*a))

    jac = torch.autograd.functional.jacobian(fn, xs,
                                             create_graph=create_graph)
    return _nested(jac)


def hessian(func, xs, create_graph=False, allow_unused=False):
    """The hessian of the scalar ``func`` at ``xs``: ``x.shape * 2`` for
    one input, else lists ``[input][input]``."""
    _, xs = _inputs(xs)

    def fn(*a):
        return func(*a).reshape(())

    return _nested(torch.autograd.functional.hessian(
        fn, xs, create_graph=create_graph))


def vjp(func, xs, v=None):
    """``(outputs, v^T J)``: the cotangent ``v`` (ones by default) pulled
    back to each input; a tensor for one output or input, else a list."""
    single, xs = _inputs(xs)
    with torch.enable_grad():
        xs_g = tuple(x.requires_grad_() for x in (t.clone() for t in xs))
        outs = _as_tuple(func(*xs_g))
        cot = tuple(torch.ones_like(o) for o in outs) if v is None \
            else tuple(_list(v))
        grads = torch.autograd.grad(outs, xs_g, cot, allow_unused=True)
    grads = [torch.zeros_like(x) if g is None else g
             for g, x in zip(grads, xs)]
    outs = [o.detach() for o in outs]
    return (outs[0] if len(outs) == 1 else outs,
            grads[0] if single else grads)


def jvp(func, xs, v=None):
    """``(outputs, J v)``: the tangent ``v`` (ones by default) pushed to
    each output; a tensor for one output, else a list."""
    _, xs = _inputs(xs)
    tangents = tuple(torch.ones_like(x) for x in xs) if v is None \
        else tuple(_list(v))

    def fn(*a):
        return _as_tuple(func(*a))

    outs, jouts = torch.autograd.functional.jvp(fn, xs, tangents)
    return (outs[0] if len(outs) == 1 else list(outs),
            jouts[0] if len(jouts) == 1 else list(jouts))


def differentiable_apply(fn, *tensors):
    """``fn(*tensors)`` (a tensor or a tuple of them) with gradients
    recorded when grad mode is on and an input requires one, else
    outputs that require none; a list comes back as a tuple."""
    wants = torch.is_grad_enabled() and any(
        t.requires_grad for t in tensors)
    with torch.set_grad_enabled(wants):
        outs = fn(*tensors)
    return tuple(outs) if isinstance(outs, (list, tuple)) else outs
