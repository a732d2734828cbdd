"""DLPack exchange (counterpart of ``paddle_tpu/utils/dlpack.py``), on
``torch.utils.dlpack``: zero-copy, so a tensor sent out and read back
keeps its memory (its ``data_ptr()``)."""
from __future__ import annotations

import torch
import torch.utils.dlpack as _dlpack

__all__ = ["to_dlpack", "from_dlpack"]


def to_dlpack(x):
    """A DLPack capsule of tensor ``x`` (an array is taken as a tensor
    first), for any framework's ``from_dlpack``."""
    return _dlpack.to_dlpack(x if torch.is_tensor(x) else torch.as_tensor(x))


def from_dlpack(ext) -> torch.Tensor:
    """A tensor over the memory of ``ext``: an object with ``__dlpack__``
    (a torch, numpy or JAX array) or a DLPack capsule."""
    return _dlpack.from_dlpack(ext)
