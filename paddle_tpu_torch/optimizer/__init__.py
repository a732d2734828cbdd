"""Optimizers and learning-rate schedulers of the port (counterpart of
``paddle_tpu/optimizer``): Adam and AdamW on the fused AdamW kernel, the
other rules in plain torch, and ``lr``'s schedulers."""
from . import lr
from .optimizer import (SGD, Adadelta, Adagrad, Adam, Adamax, AdamW,
                        L1Decay, L2Decay, Lamb, Momentum, Optimizer, RMSProp)

__all__ = ["lr", "Optimizer", "SGD", "Momentum", "Adam", "AdamW", "Adamax",
           "Adagrad", "Adadelta", "RMSProp", "Lamb", "L1Decay", "L2Decay"]
