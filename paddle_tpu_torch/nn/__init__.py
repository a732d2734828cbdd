"""Layers of the port that GPT-2 uses."""
from .layer.norm import LayerNorm
from .layer.transformer import MultiHeadAttention

__all__ = ["LayerNorm", "MultiHeadAttention"]
