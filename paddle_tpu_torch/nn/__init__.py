"""Layers, functional ops and gradient clips of the port that GPT-2
training uses."""
from . import clip, functional
from .clip import ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue
from .layer.common import Dropout, Linear
from .layer.layers import ParamAttr, set_param_attr
from .layer.norm import LayerNorm
from .layer.transformer import MultiHeadAttention

__all__ = ["clip", "functional", "ClipGradByGlobalNorm", "ClipGradByNorm",
           "ClipGradByValue", "Dropout", "Linear", "LayerNorm",
           "MultiHeadAttention", "ParamAttr", "set_param_attr"]
