"""``vision`` (counterpart of ``paddle_tpu/vision``): :mod:`.models`
(LeNet, the ResNet family and nine other families), :mod:`.datasets`,
:mod:`.transforms` (numpy on the host), :mod:`.ops` (the detection ops)
and the image backend.

The image backend (reference ``vision/image.py``): PIL decodes on the
host, imported when an image is first loaded; no ``cv2`` is bundled, and
``set_image_backend("cv2")`` says so."""
from . import datasets  # noqa: F401
from . import models  # noqa: F401
from . import ops  # noqa: F401
from . import transforms  # noqa: F401
from .models import LeNet  # noqa: F401

__all__ = ["models", "datasets", "ops", "transforms", "LeNet",
           "get_image_backend", "set_image_backend", "image_load"]

_BACKEND = ["pil"]


def get_image_backend() -> str:
    return _BACKEND[0]


def set_image_backend(backend: str) -> None:
    if backend not in ("pil", "cv2", "tensor"):
        raise ValueError(f"unknown image backend {backend!r} "
                         f"(pil | cv2 | tensor)")
    if backend == "cv2":
        raise RuntimeError("cv2 is not bundled in this environment; the "
                           "pil backend serves all decode paths")
    _BACKEND[0] = backend


def image_load(path, backend=None):
    """Load an image file (reference ``vision/image.py`` ``image_load``):
    a PIL image (``"pil"``) or an HWC uint8 numpy array (``"tensor"``)."""
    import numpy as np
    from PIL import Image
    img = Image.open(path)
    b = backend or _BACKEND[0]
    if b == "pil":
        return img
    return np.asarray(img.convert("RGB") if img.mode not in
                      ("RGB", "L") else img)
