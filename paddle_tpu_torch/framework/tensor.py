"""Tensors (counterpart of ``paddle_tpu/framework/tensor.py``).

The port's tensor is ``torch.Tensor`` itself, with no facade class: a
wrapper would duplicate torch autograd and add host cost to every op.
Paddle's semantics map onto torch directly: a new tensor is
``stop_gradient=True``, which is ``requires_grad=False``; a ``Parameter``
is trainable, which is ``nn.Parameter`` (:class:`Parameter` builds one
the JAX package's way); ``detach()`` stops the gradient.

The Paddle-only members of the JAX ``Tensor`` that ``torch.Tensor``
lacks are installed on ``torch.Tensor`` once, when the port is imported
(:func:`install_tensor_methods`): ``stop_gradient`` (get and set),
``place``, ``clear_grad``/``clear_gradient`` and ``_rebind``. The
installer raises if torch already defines one of these names, so nothing
of torch is shadowed.
"""
from __future__ import annotations

import numpy as np
import torch

from . import dtypes
from .dtypes import convert_dtype
from .enforce import PreconditionNotMetError
from .place import from_torch_device, to_torch_device

__all__ = ["to_tensor", "no_grad", "is_grad_enabled", "grad_enabled_guard",
           "Parameter", "Tensor", "install_tensor_methods"]

#: ``paddle.no_grad``: a context manager and a decorator
no_grad = torch.no_grad
is_grad_enabled = torch.is_grad_enabled
#: grad recording set to ``mode`` for a ``with`` block (True re-enables
#: it inside an enclosing ``no_grad``)
grad_enabled_guard = torch.set_grad_enabled


class Parameter(torch.nn.Parameter):
    """``Parameter(data, name=None, trainable=True)``, the JAX package's
    constructor: an ``nn.Parameter`` over ``data`` whose
    ``requires_grad`` is ``trainable``. ``name`` is taken and not kept
    (a torch tensor's ``name`` cannot be set). The layers' own parameters
    are plain ``nn.Parameter``s."""

    def __new__(cls, data, name=None, trainable=True):
        return super().__new__(cls, data, requires_grad=bool(trainable))

    def __deepcopy__(self, memo):
        # nn.Parameter's would pass requires_grad where name goes
        if id(self) not in memo:
            memo[id(self)] = type(self)(
                self.data.clone(memory_format=torch.preserve_format),
                trainable=self.requires_grad)
        return memo[id(self)]


def to_tensor(data, dtype=None, place=None, stop_gradient=True):
    """A new tensor holding a copy of ``data`` (a tensor, a numpy array, a
    list or a Python scalar) on ``place`` (``None``: the current place,
    the card unless ``set_device("cpu")``). Python ints become int64,
    Python floats and float64 arrays the default dtype, as in the JAX
    package. ``stop_gradient=False`` gives a leaf that requires grad."""
    device = to_torch_device(place)
    if isinstance(data, torch.Tensor):
        out = data.detach().to(device=device, dtype=convert_dtype(dtype)
                               if dtype is not None else None, copy=True)
    else:
        arr = np.asarray(data)
        if dtype is None and arr.dtype == np.float64:
            dtype = dtypes.DEFAULT_DTYPE
        out = torch.tensor(arr, device=device, dtype=convert_dtype(dtype)
                           if dtype is not None else None)
    if not stop_gradient:
        out.requires_grad_()
    return out


class _TensorType(type):
    """:class:`Tensor`'s metaclass: every ``torch.Tensor`` is an instance,
    every torch tensor class a subclass."""

    def __instancecheck__(cls, obj):
        return isinstance(obj, torch.Tensor)

    def __subclasscheck__(cls, sub):
        return isinstance(sub, type) and issubclass(sub, torch.Tensor)


class Tensor(metaclass=_TensorType):
    """``paddle.Tensor``: the port's tensor is ``torch.Tensor``, so
    ``isinstance(x, Tensor)`` holds for every torch tensor, and
    ``Tensor(data, stop_gradient=True, name=None)`` makes one on the
    current place (as ``to_tensor``; ``name`` is taken and not kept). A
    tensor's methods are torch's, plus the Paddle-only members torch
    lacks (``stop_gradient``, ``place``, ``clear_grad``,
    ``clear_gradient``, ``_rebind``: :func:`install_tensor_methods`).
    Where a JAX method's name is torch's with another signature
    (``backward(grad_tensor=)``, ``split(num_or_sections, axis)``, ...)
    the tensor keeps torch's; the ``paddle.*`` functions take the JAX
    signatures."""

    def __new__(cls, data, stop_gradient=True, name=None):
        return to_tensor(data, stop_gradient=stop_gradient)


# -- the Paddle-only members of the JAX ``Tensor``, on ``torch.Tensor`` ------------

def _can_require_grad(t):
    return t.is_floating_point() or t.is_complex()


def _get_stop_gradient(self):
    """``not requires_grad``. Where torch cannot hold the flag (a
    non-leaf tensor, or a dtype that cannot require grad) the value last
    set is kept beside it, as the JAX ``Tensor`` keeps it: setting it on
    a non-leaf does not cut the graph there, and an integer tensor never
    gets a gradient."""
    if self.grad_fn is None and _can_require_grad(self):
        return not self.requires_grad
    return getattr(self, "_paddle_stop_gradient", not self.requires_grad)


def _set_stop_gradient(self, value):
    if self.grad_fn is None and _can_require_grad(self):
        self.requires_grad_(not value)
        self.__dict__.pop("_paddle_stop_gradient", None)
    else:
        self._paddle_stop_gradient = bool(value)


def _place(self):
    """The port's ``Place`` of the tensor's device."""
    return from_torch_device(self.device)


def _clear_grad(self):
    self.grad = None


def _rebind(self, new_value):
    """Take over ``new_value``'s value in place (the JAX ``setitem`` and
    ``*_`` ops' primitive). When ``new_value`` has a graph this is a
    ``copy_`` that torch autograd records: the gradient reaching ``self``
    afterwards flows into ``new_value``'s graph and none to ``self``'s
    old value, as the JAX tape's snapshot routes it; a leaf that requires
    grad cannot take it over (the JAX error). Without a graph the value
    is copied and a leaf takes ``new_value``'s ``stop_gradient``. A value
    of another shape is taken over only without a graph (``set_``);
    another dtype raises."""
    graph = new_value.grad_fn is not None and torch.is_grad_enabled()
    if graph and self.grad_fn is None and self.requires_grad:
        raise PreconditionNotMetError(
            "in-place modification of a leaf tensor that requires grad; "
            "wrap the mutation in paddle.no_grad() or operate on a non-leaf "
            "result")
    if new_value.dtype != self.dtype:
        raise ValueError(f"_rebind: a {new_value.dtype} value cannot replace "
                         f"a {self.dtype} tensor in place")
    if graph:
        if new_value.shape != self.shape:
            raise ValueError(
                f"_rebind: torch autograd records an in-place take-over only "
                f"at the same shape ({tuple(self.shape)} vs "
                f"{tuple(new_value.shape)})")
        return self.copy_(new_value)
    if self.grad_fn is not None:
        raise ValueError("_rebind: a tensor with a graph takes over only a "
                         "value with a graph")
    leaf_grad = new_value.requires_grad and _can_require_grad(self)
    self.requires_grad_(False)
    with torch.no_grad():
        if new_value.shape == self.shape:
            self.copy_(new_value)
        else:
            self.set_(new_value.detach().clone())
    return self.requires_grad_(leaf_grad)


_TENSOR_MEMBERS = {
    "stop_gradient": property(_get_stop_gradient, _set_stop_gradient),
    "place": property(_place),
    "clear_grad": _clear_grad,
    "clear_gradient": _clear_grad,
    "_rebind": _rebind,
}


def install_tensor_methods():
    """Put the Paddle-only members on ``torch.Tensor``. Idempotent; raises
    ``RuntimeError`` if torch defines one of the names itself."""
    for name, member in _TENSOR_MEMBERS.items():
        have = getattr(torch.Tensor, name, None)
        if have is member:
            continue
        if have is not None:
            raise RuntimeError(f"torch.Tensor already defines {name!r}; the "
                               f"port does not shadow torch")
        setattr(torch.Tensor, name, member)


install_tensor_methods()
