"""Normalization layers (counterpart of ``paddle_tpu/nn/layer/norm.py``)."""
from __future__ import annotations

import torch
from torch import nn

from ... import amp
from ...ops.layer_norm import layer_norm

__all__ = ["LayerNorm"]


class LayerNorm(nn.Module):
    """LayerNorm over the last axis with affine ``weight``/``bias``
    (ones/zeros at init), through the fused LayerNorm kernels on the card
    (forward, and backward under autograd) and their plain versions on
    the CPU. ``layer_norm`` is on the AMP black list: inside
    ``amp.auto_cast`` x, weight and bias are cast to float32 first, so
    the output is float32. Only a 1-D ``normalized_shape`` is taken: the
    kernels normalize the last axis."""

    def __init__(self, normalized_shape, epsilon: float = 1e-5,
                 device=None, dtype=None):
        super().__init__()
        if not isinstance(normalized_shape, int):
            shape = list(normalized_shape)
            if len(shape) != 1:
                raise ValueError(
                    f"LayerNorm normalizes the last axis only, got "
                    f"normalized_shape={shape}")
            normalized_shape = shape[0]
        self._normalized_shape = [int(normalized_shape)]
        self._epsilon = float(epsilon)
        self.weight = nn.Parameter(torch.ones(
            self._normalized_shape, device=device, dtype=dtype))
        self.bias = nn.Parameter(torch.zeros(
            self._normalized_shape, device=device, dtype=dtype))

    def forward(self, x):
        x, w, b = amp.cast_inputs("layer_norm", x, self.weight, self.bias)
        return layer_norm(x, w, b, self._epsilon)

    def extra_repr(self):
        return (f"normalized_shape={self._normalized_shape}, "
                f"epsilon={self._epsilon}")
