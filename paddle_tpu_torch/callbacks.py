"""``callbacks``: the hapi callbacks under their top-level name
(counterpart of ``paddle_tpu/callbacks.py``)."""
from .hapi.callbacks import (Callback, EarlyStopping, History, LRScheduler,
                             ModelCheckpoint, ProgBarLogger,
                             ReduceLROnPlateau, VisualDL)

__all__ = ["Callback", "ProgBarLogger", "ModelCheckpoint", "LRScheduler",
           "EarlyStopping", "ReduceLROnPlateau", "History", "VisualDL"]
