"""Linear and Dropout (counterparts of ``paddle_tpu/nn/layer/common.py``).

``Linear`` is ``torch.nn.Linear`` (weight ``[out, in]``) run through the
``linear`` op, built from the JAX layer's parameters: ``weight_attr`` and
``bias_attr`` (``nn.ParamAttr``, a name, or ``bias_attr=False`` for no
bias) go onto its parameters through ``set_param_attr``. ``Dropout``
draws its mask from the port's seeded generators.
"""
from __future__ import annotations

from torch import nn

from ...framework.dispatch import call_op
from .. import functional as F
from .layers import ParamAttr, set_param_attr

__all__ = ["Linear", "Dropout"]


class Linear(nn.Linear):
    """``y = x W^T + b``, the ``linear`` op (which takes ``W^T``, the JAX
    package's ``[in, out]`` layout); under ``amp.auto_cast`` x, W and b
    run in bf16. ``device``/``dtype`` (keyword-only) place the
    parameters."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 bias_attr=None, name=None, *, device=None, dtype=None):
        w_attr = ParamAttr._to_attr(weight_attr)
        b_attr = ParamAttr._to_attr(bias_attr)
        if w_attr is False:
            raise ValueError("Linear needs its weight: weight_attr=False")
        super().__init__(in_features, out_features, bias=b_attr is not False,
                         device=device, dtype=dtype)
        set_param_attr(self.weight, w_attr)
        if self.bias is not None:
            set_param_attr(self.bias, b_attr)

    def forward(self, x):
        return call_op("linear", x, self.weight.t(), self.bias)


class Dropout(nn.Module):
    """Dropout with probability ``p`` (``functional.dropout``: ``axis``
    and ``mode`` as in the JAX layer); the identity in eval mode or at
    ``p == 0``, except that ``"downscale_in_infer"`` scales by ``1 - p``
    in eval."""

    def __init__(self, p=0.5, axis=None, mode="upscale_in_train",
                 name=None):
        super().__init__()
        self.p = float(p)
        self.axis = axis
        self.mode = mode

    def forward(self, x):
        return F.dropout(x, p=self.p, axis=self.axis, training=self.training,
                         mode=self.mode)

    def extra_repr(self):
        return f"p={self.p}"
