"""``incubate.nn`` (counterpart of ``paddle_tpu/incubate/nn``): the fused
transformer layers and their functional forms. "Fused" is a property of
the kernels underneath, not of the layer classes: the LayerNorm and
flash attention kernels take the norms and the unmasked attention on the
card, and the bias, dropout and residual epilogues are torch's; the
classes keep the reference's pre/post-LN and residual wiring."""
from . import functional  # noqa: F401
from .layer.fused_transformer import (  # noqa: F401
    FusedBiasDropoutResidualLayerNorm, FusedFeedForward, FusedLinear,
    FusedMultiHeadAttention, FusedMultiTransformer,
    FusedTransformerEncoderLayer,
)

__all__ = ["FusedMultiHeadAttention", "FusedFeedForward",
           "FusedTransformerEncoderLayer", "FusedLinear",
           "FusedBiasDropoutResidualLayerNorm", "FusedMultiTransformer",
           "functional"]
