"""``nn.quant`` (counterpart of ``paddle_tpu/nn/quant/__init__.py``): an
empty ``__all__``; the quantized layers of ``quantization`` under this
path."""
from ...quantization import (  # noqa: F401
    FakeQuantAbsMax, MovingAverageAbsMaxScale, QuantizedConv2D,
    QuantizedLinear,
)

__all__ = []
