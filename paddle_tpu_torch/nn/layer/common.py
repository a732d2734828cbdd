"""Linear and Dropout (counterparts of ``paddle_tpu/nn/layer/common.py``).

``Linear`` is ``torch.nn.Linear`` (weight ``[out, in]``) with the AMP
cast of the ``linear`` op applied to its inputs; ``Dropout`` draws its
mask from the port's seeded generators.
"""
from __future__ import annotations

from torch import nn
from torch.nn import functional as TF

from ... import amp
from .. import functional as F

__all__ = ["Linear", "Dropout"]


class Linear(nn.Linear):
    """``y = x W^T + b``; under ``amp.auto_cast`` x, W and b run in
    bf16."""

    def forward(self, x):
        x, w, b = amp.cast_inputs("linear", x, self.weight, self.bias)
        return TF.linear(x, w, b)


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
