"""``regularizer``: the weight-decay regularizers (counterpart of
``paddle_tpu/regularizer.py``). The classes live in
``optimizer/optimizer.py``, where the step applies them; this module is
their public name."""
from .optimizer.optimizer import L1Decay, L2Decay

__all__ = ["L1Decay", "L2Decay"]
