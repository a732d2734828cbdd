"""``ParamAttr`` and the ``Layer`` base class (counterparts of
``paddle_tpu/nn/layer/layers.py`` :27 and :62).

:class:`Layer` is a ``torch.nn.Module`` with the JAX ``Layer``'s public
methods: ``add_sublayer``, ``add_parameter``, ``register_buffer`` (its
``persistable``), ``create_parameter``, ``sublayers``/
``named_sublayers``, ``register_forward_post_hook``, ``state_dict`` /
``set_state_dict``, ``clear_gradients``, ``to``/``astype`` with Paddle
dtype names, and ``full_name``. Everything else — parameters, buffers,
modes, forward hooks, ``__call__`` — is torch's own machinery. A
sublayer's attribute name is its structured name, so ``state_dict``
keys are the JAX package's (``encoder.layers.0.self_attn.q_proj.weight``).

``create_parameter`` takes the initializer in the JAX package's order:
the ``ParamAttr``'s, then ``nn.initializer.set_global_initializer``'s,
then the layer's default, then ``Constant(0)`` for a bias and
``XavierUniform`` for a weight. It sets on the new ``nn.Parameter`` the
attributes the optimizer and the clips read (:func:`set_param_attr`):

* ``optimize_attr = {"learning_rate": attr.learning_rate}``, the scale
  the optimizer's step puts on its learning rate for this parameter;
* ``need_clip``: ``False`` leaves its gradient out of every clip;
* ``regularizer`` (kept, as in the JAX package, which reads only the
  optimizer's global decay);
* ``requires_grad = attr.trainable``;
* ``_paddle_name = attr.name`` when the attribute names it (a torch
  tensor's own ``name`` cannot be set): a static ``Program`` keys the
  parameter by it, as the JAX package keys its ``Parameter.name``.
"""
from __future__ import annotations

from collections import OrderedDict

import numpy as np
import torch
from torch import nn

from ...framework.dtypes import convert_dtype
from ...framework.place import to_torch_device

__all__ = ["ParamAttr", "set_param_attr", "Layer"]


class ParamAttr:
    def __init__(self, name=None, initializer=None, learning_rate=1.0,
                 regularizer=None, trainable=True, need_clip=True):
        self.name = name
        self.initializer = initializer
        self.learning_rate = learning_rate
        self.regularizer = regularizer
        self.trainable = trainable
        self.need_clip = need_clip

    @staticmethod
    def _to_attr(attr):
        """A layer's ``weight_attr``/``bias_attr`` as the JAX package reads
        it: ``None`` is the default ``ParamAttr()``, ``False`` no parameter
        (returned as is), a string its name, an initializer a
        ``ParamAttr`` holding it."""
        if attr is None:
            return ParamAttr()
        if isinstance(attr, ParamAttr):
            return attr
        if attr is False:
            return False
        if isinstance(attr, str):
            return ParamAttr(name=attr)
        return ParamAttr(initializer=attr)


def set_param_attr(param, attr: ParamAttr):
    """Give the torch ``param`` the attributes of ``attr``; returns it."""
    param.optimize_attr = {"learning_rate": attr.learning_rate}
    param.regularizer = attr.regularizer
    param.need_clip = attr.need_clip
    param.requires_grad_(attr.trainable)
    if attr.name:
        param._paddle_name = attr.name
    return param


def make_parameter(shape, attr=None, dtype=None, is_bias=False,
                   default_initializer=None, device=None):
    """A new ``nn.Parameter`` of ``shape`` as ``create_parameter`` makes
    it (``None`` for ``attr=False``)."""
    from ..initializer import Constant, XavierUniform, _global_initializer
    attr = ParamAttr._to_attr(attr)
    if attr is False:
        return None
    init = attr.initializer or _global_initializer(is_bias) or \
        default_initializer or (Constant(0.0) if is_bias
                                else XavierUniform())
    data = init(tuple(int(s) for s in shape), convert_dtype(dtype))
    device = None if device is None else torch.device(device)
    return set_param_attr(nn.Parameter(data.to(device=device)), attr)


def jax_perm(t):
    """The permutation that gives the JAX layout of ``t`` (``None``: the
    same layout)."""
    return getattr(t, "_jax_perm", None)


def mark_jax_perm(t, perm):
    """Give ``t`` the layout mark ``perm`` (kept only where it has one
    axis per entry); returns ``t``."""
    if perm is not None and t.dim() == len(perm):
        t._jax_perm = tuple(perm)
    return t


def jax_view(t):
    """``t`` in the JAX package's layout (a view)."""
    perm = jax_perm(t)
    return t if perm is None else t.permute(perm)


def from_jax_view(t, perm):
    """The inverse of :func:`jax_view`: a JAX-layout ``t`` in the layout
    that ``perm`` marks."""
    if perm is None:
        return t
    inv = [0] * len(perm)
    for i, p in enumerate(perm):
        inv[p] = i
    return t.permute(inv)


def port_axis(t, axis):
    """The axis of ``t`` that is axis ``axis`` of its JAX layout."""
    perm = jax_perm(t)
    axis = axis % len(t.shape)
    return axis if perm is None else perm[axis]


class Layer(nn.Module):
    """The base of the port's layers: a ``torch.nn.Module``.
    ``name_scope`` names it for ``full_name``; ``dtype`` is the dtype of
    the parameters ``create_parameter`` makes (float32 by default)."""

    #: parameter name -> the permutation that gives its JAX layout (a
    #: ``Linear``'s weight: ``(1, 0)``); the marks go onto the
    #: parameters, and come back after a copy, which drops them
    _jax_perms: dict = {}

    def __init__(self, name_scope=None, dtype=None):
        super().__init__()
        self._dtype = convert_dtype(dtype)
        self._name_scope = name_scope or self.__class__.__name__.lower()

    def _mark_layouts(self):
        for name, perm in self._jax_perms.items():
            p = self._parameters.get(name)
            if p is not None:
                mark_jax_perm(p, perm)

    def __setstate__(self, state):
        super().__setstate__(state)
        self._mark_layouts()

    # -- registration ---------------------------------------------------------
    def add_parameter(self, name, parameter):
        if parameter is not None and not isinstance(parameter,
                                                    nn.Parameter):
            raise TypeError("add_parameter expects a Parameter")
        self.register_parameter(str(name), parameter)
        return parameter

    def add_sublayer(self, name, sublayer):
        self.add_module(str(name), sublayer)
        return sublayer

    def register_buffer(self, name, tensor, persistable=True, *,
                        persistent=None):
        """``persistable=False`` (torch's ``persistent``) keeps it out of
        ``state_dict``."""
        if persistent is not None:
            persistable = persistent
        super().register_buffer(name, tensor, persistent=bool(persistable))
        return tensor

    def create_parameter(self, shape, attr=None, dtype=None,
                         is_bias=False, default_initializer=None):
        return make_parameter(shape, attr, dtype or self._dtype, is_bias,
                              default_initializer)

    # -- iteration --------------------------------------------------------------
    def named_sublayers(self, prefix="", include_self=False):
        for name, layer in self.named_modules(prefix=prefix):
            if layer is not self or include_self:
                yield name, layer

    def sublayers(self, include_self=False):
        return [l for _, l in self.named_sublayers(include_self=include_self)]

    # -- hooks --------------------------------------------------------------------
    def register_forward_post_hook(self, hook):
        """``hook(layer, inputs, output)``; a non-None return replaces the
        output. Returns a handle whose ``remove()`` drops the hook."""
        return self.register_forward_hook(hook)

    # -- state dict -----------------------------------------------------------------
    def state_dict(self, destination=None, include_sublayers=True,
                   use_hook=True, *, prefix="", keep_vars=False):
        """The parameters and persistable buffers by structured name
        (``include_sublayers=False``: this layer's own)."""
        if include_sublayers:
            return super().state_dict(destination=destination,
                                      prefix=prefix, keep_vars=keep_vars)
        dest = OrderedDict() if destination is None else destination
        self._save_to_state_dict(dest, prefix, keep_vars)
        return dest

    def set_state_dict(self, state_dict, use_structured_name=True):
        """Copy ``state_dict`` (tensors or numpy arrays by structured name)
        into the parameters and buffers, each cast to its dtype; returns
        ``(missing, unexpected)`` key lists. A misshapen value raises
        ``ValueError``."""
        own = self.state_dict(keep_vars=True)
        missing = [k for k in own if k not in state_dict]
        unexpected = [k for k in state_dict if k not in own]
        with torch.no_grad():
            for name, target in own.items():
                if name not in state_dict:
                    continue
                value = state_dict[name]
                src = value.detach() if isinstance(value, torch.Tensor) \
                    else torch.as_tensor(np.asarray(value))
                if tuple(src.shape) != tuple(target.shape):
                    raise ValueError(
                        f"shape mismatch for {name}: {tuple(src.shape)} vs "
                        f"{tuple(target.shape)}")
                target.copy_(src.to(target.dtype))
        return missing, unexpected

    set_dict = set_state_dict
    load_dict = set_state_dict

    # -- dtype / device ---------------------------------------------------------------
    def to(self, device=None, dtype=None, blocking=None, *args, **kwargs):
        """``to(device=, dtype=)`` with Paddle names (``"gpu:0"``,
        ``"float16"``) as well as torch's; torch's positional forms
        (``to(torch.float16)``, ``to(tensor)``) pass through."""
        pos = []
        for v in (device, dtype):
            if isinstance(v, str):
                try:
                    v = convert_dtype(v)
                except TypeError:        # not a dtype name: a place
                    v = to_torch_device(v)
            if v is not None:
                pos.append(v)
        if blocking is not None:
            kwargs.setdefault("non_blocking", not blocking)
        return super().to(*pos, *args, **kwargs)

    def astype(self, dtype):
        return self.to(dtype=dtype)

    def clear_gradients(self):
        for p in self.parameters():
            p.grad = None

    def full_name(self):
        return self._name_scope
