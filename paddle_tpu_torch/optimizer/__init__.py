"""Optimizers of the port: Adam and AdamW on the fused AdamW kernel."""
from .optimizer import Adam, AdamW, L2Decay, Optimizer

__all__ = ["Optimizer", "Adam", "AdamW", "L2Decay"]
