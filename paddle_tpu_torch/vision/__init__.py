"""``vision`` (counterpart of ``paddle_tpu/vision``): the ResNet family
and LeNet, in :mod:`.models`.

Not ported yet (ROADMAP Queue 1 item 5; reaching one raises
``NotImplementedError`` naming it): the other models, ``datasets``,
``transforms``, ``ops`` and the image backend."""
from . import models  # noqa: F401
from .models import LeNet  # noqa: F401
from ..ops.registry import not_ported as _not_ported

__all__ = ["models", "LeNet"]

_DEFERRED = frozenset(("datasets", "ops", "transforms",
                       "get_image_backend", "set_image_backend",
                       "image_load"))


def __getattr__(name):
    if name in _DEFERRED:
        raise _not_ported(f"vision.{name}", 5)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
