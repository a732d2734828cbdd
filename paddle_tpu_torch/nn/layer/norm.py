"""Normalization layers (counterpart of ``paddle_tpu/nn/layer/norm.py``):
``LayerNorm``, the ``BatchNorm`` family, ``GroupNorm``, the
``InstanceNorm`` family, ``RMSNorm``, ``LocalResponseNorm`` and
``SpectralNorm``; and the override that sends the ``layer_norm`` op to
the fused LayerNorm kernels (K2, and K3 as its gradient) when its
operand is on the card and the kernels take its shape: an affine
LayerNorm over the last axis of at most ``MAX_D`` values (the JAX
override's predicate, ``_ln_supported``). On the CPU the op's plain body
runs; on the card a dtype the kernels do not take raises in the kernel
wrapper.

A BatchNorm's running statistics are the buffers ``_mean`` and
``_variance`` (the JAX layer's names, so its ``state_dict`` keys); the
``batch_norm`` op returns their update and the layer writes it into them
in training. ``SyncBatchNorm`` is multi-device (ROADMAP Queue 1 item 4)."""
from __future__ import annotations

import torch

from ...framework.dispatch import call_op
from ...framework.static_capture import exporting
from ...ops.layer_norm import MAX_D, layer_norm
from ...ops.registry import register_override
from .. import functional as F
from ..initializer import Constant, Normal
from .layers import Layer, make_parameter

__all__ = ["BatchNorm", "BatchNorm1D", "BatchNorm2D", "BatchNorm3D",
           "LayerNorm", "GroupNorm", "InstanceNorm1D", "InstanceNorm2D",
           "InstanceNorm3D", "LocalResponseNorm", "RMSNorm", "SpectralNorm",
           "ln_supported"]


def ln_supported(x, weight, bias, begin_norm_axis=None) -> bool:
    """The kernels take ``x``: on the card (or on any device while
    ``torch.export`` captures the port: the graph then holds the kernel's
    custom op), affine, the last axis of at most ``MAX_D`` values."""
    return ((x.is_cuda or exporting()) and weight is not None
            and bias is not None and begin_norm_axis in (None, x.dim() - 1)
            and 1 <= x.shape[-1] <= MAX_D)


def _ln_kernel(x, weight=None, bias=None, epsilon=1e-5,
               begin_norm_axis=None):
    return layer_norm(x, weight, bias, epsilon)


register_override(
    "layer_norm",
    lambda args, attrs: ln_supported(
        args[0], args[1] if len(args) > 1 else attrs.get("weight"),
        args[2] if len(args) > 2 else attrs.get("bias"),
        attrs.get("begin_norm_axis")),
)(_ln_kernel)


class LayerNorm(Layer):
    """LayerNorm over the last axis with affine ``weight``/``bias``
    (ones/zeros at init): the ``layer_norm`` op, so the fused LayerNorm
    kernels on the card (forward, and backward under autograd) and the
    plain body on the CPU. ``layer_norm`` is on the AMP black list: inside
    ``amp.auto_cast`` x, weight and bias are cast to float32 first, so the
    output is float32. Only a 1-D ``normalized_shape`` is taken: the
    kernels normalize the last axis (``F.layer_norm`` takes more).
    ``weight_attr``/``bias_attr`` go onto the parameters as in the JAX
    layer (``False``: no such parameter); ``device``/``dtype``
    (keyword-only) place them."""

    def __init__(self, normalized_shape, epsilon=1e-5, weight_attr=None,
                 bias_attr=None, name=None, *, device=None, dtype=None):
        super().__init__(dtype=dtype)
        if isinstance(normalized_shape, int):
            normalized_shape = [normalized_shape]
        if len(normalized_shape) != 1:
            raise ValueError(
                f"LayerNorm normalizes the last axis only, got "
                f"normalized_shape={list(normalized_shape)}")
        self._normalized_shape = [int(normalized_shape[0])]
        self._epsilon = float(epsilon)
        self.weight = make_parameter(
            self._normalized_shape, weight_attr, self._dtype,
            default_initializer=Constant(1.0), device=device)
        self.bias = make_parameter(self._normalized_shape, bias_attr,
                                   self._dtype, is_bias=True, device=device)

    def forward(self, x):
        return call_op("layer_norm", x, self.weight, self.bias,
                       epsilon=self._epsilon)

    def extra_repr(self):
        return (f"normalized_shape={self._normalized_shape}, "
                f"epsilon={self._epsilon}")


class _BatchNormBase(Layer):
    def __init__(self, num_features, momentum=0.9, epsilon=1e-5,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 use_global_stats=None, name=None):
        super().__init__()
        self._num_features = num_features
        self._momentum = momentum
        self._epsilon = epsilon
        self._data_format = data_format
        self._use_global_stats = use_global_stats
        self.weight = self.create_parameter(
            [num_features], attr=weight_attr,
            default_initializer=Constant(1.0))
        self.bias = self.create_parameter([num_features], attr=bias_attr,
                                          is_bias=True)
        self.register_buffer("_mean", torch.zeros(num_features))
        self.register_buffer("_variance", torch.ones(num_features))

    def forward(self, x):
        training = self.training and not (self._use_global_stats or False)
        y, new_mean, new_var = call_op(
            "batch_norm", x, self._mean, self._variance, self.weight,
            self.bias, training=training, momentum=self._momentum,
            epsilon=self._epsilon, data_format=self._data_format)
        if training:
            with torch.no_grad():
                self._mean.copy_(new_mean)
                self._variance.copy_(new_var)
        return y

    def extra_repr(self):
        return f"num_features={self._num_features}, " \
               f"momentum={self._momentum}, epsilon={self._epsilon}"


class BatchNorm(_BatchNormBase):
    """The legacy constructor (the reference's ``fluid.dygraph.BatchNorm``):
    ``act`` names an op applied to the output."""

    def __init__(self, num_channels, act=None, momentum=0.9, epsilon=1e-5,
                 param_attr=None, bias_attr=None, data_layout="NCHW",
                 use_global_stats=False, **kwargs):
        super().__init__(num_channels, momentum, epsilon, param_attr,
                         bias_attr, data_layout,
                         use_global_stats=use_global_stats)
        self._act = act

    def forward(self, x):
        y = super().forward(x)
        if self._act:
            y = call_op(self._act, y)
        return y


class BatchNorm1D(_BatchNormBase):
    def __init__(self, num_features, momentum=0.9, epsilon=1e-5,
                 weight_attr=None, bias_attr=None, data_format="NCL",
                 use_global_stats=None, name=None):
        super().__init__(num_features, momentum, epsilon, weight_attr,
                         bias_attr, data_format, use_global_stats)


class BatchNorm2D(_BatchNormBase):
    pass


class BatchNorm3D(_BatchNormBase):
    def __init__(self, num_features, momentum=0.9, epsilon=1e-5,
                 weight_attr=None, bias_attr=None, data_format="NCDHW",
                 use_global_stats=None, name=None):
        super().__init__(num_features, momentum, epsilon, weight_attr,
                         bias_attr, data_format, use_global_stats)


class RMSNorm(Layer):
    def __init__(self, normalized_shape, epsilon=1e-6, weight_attr=None,
                 name=None):
        super().__init__()
        if isinstance(normalized_shape, int):
            normalized_shape = [normalized_shape]
        self._epsilon = epsilon
        self.weight = self.create_parameter(
            list(normalized_shape), attr=weight_attr,
            default_initializer=Constant(1.0))

    def forward(self, x):
        return F.rms_norm(x, self.weight, self._epsilon)


class GroupNorm(Layer):
    def __init__(self, num_groups, num_channels, epsilon=1e-5,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 name=None):
        super().__init__()
        self._num_groups = num_groups
        self._epsilon = epsilon
        self._data_format = data_format
        self.weight = self.create_parameter(
            [num_channels], attr=weight_attr,
            default_initializer=Constant(1.0))
        self.bias = self.create_parameter([num_channels], attr=bias_attr,
                                          is_bias=True)

    def forward(self, x):
        return F.group_norm(x, self._num_groups, self._epsilon, self.weight,
                            self.bias, self._data_format)


class _InstanceNormBase(Layer):
    def __init__(self, num_features, epsilon=1e-5, momentum=0.9,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 name=None):
        super().__init__()
        self._epsilon = epsilon
        if weight_attr is False or bias_attr is False:
            self.weight = None
            self.bias = None
        else:
            self.weight = self.create_parameter(
                [num_features], attr=weight_attr,
                default_initializer=Constant(1.0))
            self.bias = self.create_parameter([num_features], attr=bias_attr,
                                              is_bias=True)

    def forward(self, x):
        return F.instance_norm(x, weight=self.weight, bias=self.bias,
                               eps=self._epsilon)


class InstanceNorm1D(_InstanceNormBase):
    pass


class InstanceNorm2D(_InstanceNormBase):
    pass


class InstanceNorm3D(_InstanceNormBase):
    pass


class LocalResponseNorm(Layer):
    def __init__(self, size, alpha=1e-4, beta=0.75, k=1.0,
                 data_format="NCHW", name=None):
        super().__init__()
        self.size = size
        self.alpha = alpha
        self.beta = beta
        self.k = k

    def forward(self, x):
        return F.local_response_norm(x, self.size, self.alpha, self.beta,
                                     self.k)


class SpectralNorm(Layer):
    """Power-iteration spectral normalization of a weight (the reference's
    ``SpectralNorm``); ``weight_u``/``weight_v`` are frozen parameters and
    the output carries no gradient, as the JAX op's."""

    def __init__(self, weight_shape, dim=0, power_iters=1, eps=1e-12,
                 name=None):
        super().__init__()
        self._dim = dim
        self._power_iters = power_iters
        self._eps = eps
        h = weight_shape[dim]
        w = 1
        for i, s in enumerate(weight_shape):
            if i != dim:
                w *= s
        self.weight_u = self.create_parameter(
            [h], default_initializer=Normal(0.0, 1.0))
        self.weight_u.requires_grad_(False)
        self.weight_v = self.create_parameter(
            [w], default_initializer=Normal(0.0, 1.0))
        self.weight_v.requires_grad_(False)

    def forward(self, weight):
        return call_op("spectral_norm", weight, self.weight_u, self.weight_v,
                       dim=self._dim, power_iters=self._power_iters,
                       eps=self._eps)
