"""Linear and Dropout (counterparts of ``paddle_tpu/nn/layer/common.py``).

``Linear`` is ``torch.nn.Linear`` (weight ``[out, in]``) run through the
``linear`` op; ``Dropout`` draws its mask from the port's seeded
generators.
"""
from __future__ import annotations

from torch import nn

from ...framework.dispatch import call_op
from .. import functional as F

__all__ = ["Linear", "Dropout"]


class Linear(nn.Linear):
    """``y = x W^T + b``, the ``linear`` op (which takes ``W^T``, the JAX
    package's ``[in, out]`` layout); under ``amp.auto_cast`` x, W and b
    run in bf16."""

    def forward(self, x):
        return call_op("linear", x, self.weight.t(), self.bias)


class Dropout(nn.Module):
    """``upscale_in_train`` dropout with probability ``p``; the identity
    in eval mode or at ``p == 0``."""

    def __init__(self, p: float = 0.5):
        super().__init__()
        self.p = float(p)

    def forward(self, x):
        return F.dropout(x, self.p, self.training)

    def extra_repr(self):
        return f"p={self.p}"
