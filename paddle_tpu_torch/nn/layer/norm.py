"""Normalization layers (counterpart of ``paddle_tpu/nn/layer/norm.py``),
and the override that sends the ``layer_norm`` op to the fused LayerNorm
kernels (K2, and K3 as its gradient) when its operand is on the card and
the kernels take its shape: an affine LayerNorm over the last axis of at
most ``MAX_D`` values. On the CPU the op's plain body runs; on the card a
dtype the kernels do not take raises in the kernel wrapper."""
from __future__ import annotations

import torch
from torch import nn

from ...framework.dispatch import call_op
from ...ops.layer_norm import MAX_D, layer_norm
from ...ops.registry import register_override
from .layers import ParamAttr, set_param_attr

__all__ = ["LayerNorm", "ln_supported"]


def ln_supported(x, weight, bias, begin_norm_axis=None) -> bool:
    """The kernels take ``x``: on the card, affine, the last axis of at
    most ``MAX_D`` values."""
    return (x.is_cuda and weight is not None and bias is not None
            and begin_norm_axis in (None, x.dim() - 1)
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


class LayerNorm(nn.Module):
    """LayerNorm over the last axis with affine ``weight``/``bias``
    (ones/zeros at init): the ``layer_norm`` op, so the fused LayerNorm
    kernels on the card (forward, and backward under autograd) and the
    plain body on the CPU. ``layer_norm`` is on the AMP black list: inside
    ``amp.auto_cast`` x, weight and bias are cast to float32 first, so
    the output is float32. Only a 1-D ``normalized_shape`` is taken: the
    kernels normalize the last axis. ``weight_attr``/``bias_attr`` go
    onto the parameters as in the JAX layer (``False``: no such
    parameter); ``device``/``dtype`` (keyword-only) place them."""

    def __init__(self, normalized_shape, epsilon=1e-5, weight_attr=None,
                 bias_attr=None, name=None, *, device=None, dtype=None):
        super().__init__()
        w_attr = ParamAttr._to_attr(weight_attr)
        b_attr = ParamAttr._to_attr(bias_attr)
        if not isinstance(normalized_shape, int):
            shape = list(normalized_shape)
            if len(shape) != 1:
                raise ValueError(
                    f"LayerNorm normalizes the last axis only, got "
                    f"normalized_shape={shape}")
            normalized_shape = shape[0]
        self._normalized_shape = [int(normalized_shape)]
        self._epsilon = float(epsilon)
        self.weight = None if w_attr is False else set_param_attr(
            nn.Parameter(torch.ones(self._normalized_shape, device=device,
                                    dtype=dtype)), w_attr)
        self.bias = None if b_attr is False else set_param_attr(
            nn.Parameter(torch.zeros(self._normalized_shape, device=device,
                                     dtype=dtype)), b_attr)

    def forward(self, x):
        return call_op("layer_norm", x, self.weight, self.bias,
                       epsilon=self._epsilon)

    def extra_repr(self):
        return (f"normalized_shape={self._normalized_shape}, "
                f"epsilon={self._epsilon}")
