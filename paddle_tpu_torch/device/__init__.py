"""``device`` (counterpart of ``paddle_tpu/device``): device queries,
synchronisation and the card's memory statistics, on ``torch.cuda``.

The answers are this build's: ``is_compiled_with_cuda()`` reads
``torch.version.cuda``, ``get_cudnn_version()`` cuDNN's version,
``get_all_device_type()`` lists ``gpu`` when a card is present. The
memory functions read the CUDA caching allocator (0, or no statistics,
without a card). ``device.cuda`` is the same surface under the
reference's ``paddle.device.cuda`` name. XPU, MLU and IPU places raise,
as the reference's do on a build without them.
"""
from __future__ import annotations

import torch

from ..framework.place import _UnavailablePlace, get_device, set_device

__all__ = ["get_device", "set_device", "device_count", "synchronize",
           "get_device_properties", "memory_allocated",
           "max_memory_allocated", "memory_reserved", "memory_stats",
           "memory_summary", "cuda", "is_compiled_with_cuda"]


def _card() -> bool:
    return torch.cuda.is_available()


def _index(device=None):
    """The CUDA device index that ``device`` (``None``, an int, ``"gpu:1"``,
    ``"cuda:1"``, a ``torch.device``) names; ``None`` for the CPU."""
    if device is None:
        return torch.cuda.current_device() if _card() else None
    if isinstance(device, int):
        return device
    d = torch.device(str(device).replace("gpu", "cuda"))
    if d.type == "cpu":
        return None
    if d.type != "cuda":
        raise ValueError(f"unknown device {device!r}")
    if not _card():
        raise RuntimeError(f"no CUDA device is available for {device!r}")
    return d.index if d.index is not None else torch.cuda.current_device()


def device_count() -> int:
    """The CUDA cards this process sees (0 without one)."""
    return torch.cuda.device_count()


def is_compiled_with_cuda() -> bool:
    return torch.version.cuda is not None


def synchronize(device=None):
    """Wait until the card has finished all queued work (nothing to wait
    for on the CPU)."""
    idx = _index(device)
    if idx is not None:
        torch.cuda.synchronize(idx)


def memory_stats(device=None) -> dict:
    """The caching allocator's statistics (``torch.cuda.memory_stats``)
    with the JAX package's keys beside them: ``bytes_in_use``,
    ``peak_bytes_in_use``, ``bytes_reserved`` and ``bytes_limit`` (the
    card's memory); ``{}`` on the CPU, which reports none."""
    idx = _index(device)
    if idx is None:
        return {}
    stats = dict(torch.cuda.memory_stats(idx))
    stats.update(bytes_in_use=torch.cuda.memory_allocated(idx),
                 peak_bytes_in_use=torch.cuda.max_memory_allocated(idx),
                 bytes_reserved=torch.cuda.memory_reserved(idx),
                 bytes_limit=torch.cuda.get_device_properties(
                     idx).total_memory)
    return stats


def memory_allocated(device=None) -> int:
    """Bytes held by live tensors on the card."""
    idx = _index(device)
    return 0 if idx is None else int(torch.cuda.memory_allocated(idx))


def max_memory_allocated(device=None) -> int:
    """The peak of ``memory_allocated`` since the start or the last
    ``torch.cuda.reset_peak_memory_stats``."""
    idx = _index(device)
    return 0 if idx is None else int(torch.cuda.max_memory_allocated(idx))


def memory_reserved(device=None) -> int:
    """Bytes the caching allocator holds from the card."""
    idx = _index(device)
    return 0 if idx is None else int(torch.cuda.memory_reserved(idx))


def memory_summary(device=None) -> str:
    """The caching allocator's table (``torch.cuda.memory_summary``); on
    the CPU a line saying there are no statistics, never zeros that look
    like measurements."""
    idx = _index(device)
    if idx is None:
        return "device cpu:0 (cpu)\n  (backend reports no memory statistics)"
    return torch.cuda.memory_summary(idx)


class _Properties:
    def __init__(self, idx):
        if idx is None:
            self.name, self.total_memory, self.platform, self.id = \
                "cpu", 0, "cpu", 0
        else:
            props = torch.cuda.get_device_properties(idx)
            self.name, self.total_memory = props.name, props.total_memory
            self.platform, self.id = "gpu", idx
            self.major, self.minor = props.major, props.minor
            self.multi_processor_count = props.multi_processor_count

    def __repr__(self):
        return (f"DeviceProperties(name={self.name!r}, id={self.id}, "
                f"platform={self.platform!r}, "
                f"total_memory={self.total_memory})")


def get_device_properties(device=None) -> _Properties:
    return _Properties(_index(device))


class _CudaAlias:
    """``device.cuda``: the reference's ``paddle.device.cuda`` names."""
    device_count = staticmethod(device_count)
    synchronize = staticmethod(synchronize)
    memory_allocated = staticmethod(memory_allocated)
    max_memory_allocated = staticmethod(max_memory_allocated)
    memory_reserved = staticmethod(memory_reserved)
    memory_summary = staticmethod(memory_summary)
    get_device_properties = staticmethod(get_device_properties)

    @staticmethod
    def empty_cache():
        """Return the caching allocator's unused blocks to the card."""
        if _card():
            torch.cuda.empty_cache()


cuda = _CudaAlias()


class _DevicePlace(_UnavailablePlace):
    def __init__(self, dev_id=0):       # the reference's parameter name
        super().__init__(dev_id)


class XPUPlace(_DevicePlace):
    _kind = "XPU"


class MLUPlace(_DevicePlace):
    _kind = "MLU"


class IPUPlace(_DevicePlace):
    _kind = "IPU"


def is_compiled_with_ipu() -> bool:
    return False


def is_compiled_with_mlu() -> bool:
    return False


def is_compiled_with_npu() -> bool:
    return False


def is_compiled_with_xpu() -> bool:
    return False


def is_compiled_with_cinn() -> bool:
    return False


def is_compiled_with_rocm() -> bool:
    return torch.version.hip is not None


def get_cudnn_version():
    """cuDNN's version as an int (e.g. 90100), ``None`` without cuDNN."""
    if not torch.backends.cudnn.is_available():
        return None
    return torch.backends.cudnn.version()


def get_all_device_type():
    return sorted({"cpu"} | ({"gpu"} if _card() else set()))


def get_all_custom_device_type():
    return []


def get_available_device():
    """``gpu:<i>`` for each card, else ``["cpu:0"]``."""
    if _card():
        return [f"gpu:{i}" for i in range(torch.cuda.device_count())]
    return ["cpu:0"]


def get_available_custom_device():
    return []


__all__ += ["XPUPlace", "MLUPlace", "IPUPlace", "is_compiled_with_ipu",
            "is_compiled_with_mlu", "is_compiled_with_npu",
            "is_compiled_with_xpu", "is_compiled_with_cinn",
            "is_compiled_with_rocm", "get_cudnn_version",
            "get_all_device_type", "get_all_custom_device_type",
            "get_available_device", "get_available_custom_device"]
