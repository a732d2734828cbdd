"""``fluid.backward`` (counterpart of ``paddle_tpu/fluid/backward.py``)."""
from ..static import append_backward, gradients  # noqa: F401
