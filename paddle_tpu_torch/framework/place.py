"""Places and the default device (counterpart of
``paddle_tpu/framework/place.py``): ``CPUPlace`` and ``CUDAPlace(i)`` map
to ``torch.device``; ``CUDAPinnedPlace`` is host memory (the CPU).

The default place is ``"gpu:0"``, which resolves through
``_device.resolve_device``: without a card it raises instead of falling
back to the CPU (the JAX package warns and falls back). ``set_device
("cpu")`` is the only way to make the CPU the default.
"""
from __future__ import annotations

import torch

from .._device import resolve_device

__all__ = ["Place", "CPUPlace", "CUDAPlace", "CUDAPinnedPlace",
           "set_device", "get_device", "is_compiled_with_tpu",
           "current_place", "to_torch_device", "from_torch_device"]


class Place:
    device_type = "unknown"

    def __init__(self, device_id: int = 0):
        self._device_id = int(device_id)

    def get_device_id(self) -> int:
        return self._device_id

    def __eq__(self, other):
        return (type(self) is type(other)
                and self._device_id == other._device_id)

    def __hash__(self):
        return hash((type(self).__name__, self._device_id))

    def __repr__(self):
        return f"Place({self.device_type}:{self._device_id})"


class CPUPlace(Place):
    device_type = "cpu"


class CUDAPlace(Place):
    device_type = "gpu"


class CUDAPinnedPlace(Place):
    """Pinned host memory: it lives on the host, so it resolves to the
    CPU."""

    device_type = "cpu"

    def __init__(self):
        super().__init__(0)


def is_compiled_with_tpu() -> bool:
    """The port runs on CUDA cards, never on a TPU."""
    return False


_NAMES = {"cpu": CPUPlace, "gpu": CUDAPlace, "cuda": CUDAPlace}

_current_place: Place = CUDAPlace(0)


def _parse(device) -> Place:
    if isinstance(device, Place):
        return device
    if isinstance(device, torch.device):
        return from_torch_device(device)
    name, _, idx = str(device).lower().partition(":")
    cls = _NAMES.get(name)
    if cls is None:
        raise ValueError(f"Unknown device {device!r}")
    return cls(int(idx) if idx else 0)


def set_device(device) -> Place:
    """``paddle.set_device("gpu")`` / ``"gpu:1"`` / ``"cpu"``: the place
    that ``to_tensor`` and the creation ops use when given none."""
    global _current_place
    _current_place = _parse(device)
    return _current_place


def get_device() -> str:
    p = _current_place
    return f"{p.device_type}:{p.get_device_id()}"


def current_place() -> Place:
    return _current_place


def to_torch_device(place=None) -> torch.device:
    """The ``torch.device`` of ``place`` (a ``Place``, a name such as
    ``"gpu:1"`` or ``"cpu"``, or a ``torch.device``); ``None`` is the
    current place. A GPU place raises when no card is present."""
    p = _current_place if place is None else _parse(place)
    if p.device_type == "cpu":
        return torch.device("cpu")
    resolve_device(None)
    return torch.device("cuda", p.get_device_id())


def from_torch_device(device) -> Place:
    device = torch.device(device)
    if device.type == "cpu":
        return CPUPlace(0)
    if device.type == "cuda":
        return CUDAPlace(0 if device.index is None else device.index)
    raise ValueError(f"no place for device {device}")
