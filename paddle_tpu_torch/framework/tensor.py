"""Tensors (counterpart of ``paddle_tpu/framework/tensor.py``).

The port's tensor is ``torch.Tensor`` itself, with no facade class: a
wrapper would duplicate torch autograd and add host cost to every op.
Paddle's semantics map onto torch directly: a new tensor is
``stop_gradient=True``, which is ``requires_grad=False``; a ``Parameter``
is trainable, which is ``nn.Parameter`` (:class:`Parameter` builds one
the JAX package's way); ``detach()`` stops the gradient.
The Paddle-only methods of the JAX ``Tensor`` (``.stop_gradient``,
``.place``, ``clear_grad``, ``_rebind``) are not ported.
"""
from __future__ import annotations

import numpy as np
import torch

from . import dtypes
from .dtypes import convert_dtype
from .place import to_torch_device

__all__ = ["to_tensor", "no_grad", "is_grad_enabled", "grad_enabled_guard",
           "Parameter", "Tensor"]

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
    tensor's methods are torch's: the Paddle-only methods and signatures
    of the JAX ``Tensor`` (``stop_gradient``, ``place``, ``clear_grad``,
    ``backward(grad_tensor=)``, ``split(num_or_sections, axis)``, ...) are
    not ported yet (ROADMAP Queue 1 item 6)."""

    def __new__(cls, data, stop_gradient=True, name=None):
        return to_tensor(data, stop_gradient=stop_gradient)
