"""Layers and functional ops of the port that GPT-2 uses."""
from . import functional
from .layer.common import Dropout, Linear
from .layer.norm import LayerNorm
from .layer.transformer import MultiHeadAttention

__all__ = ["functional", "Dropout", "Linear", "LayerNorm",
           "MultiHeadAttention"]
