"""``utils`` (counterpart of ``paddle_tpu/utils``): ``unique_name``,
``deprecated``, ``try_import``, ``require_version``, ``run_check``,
:mod:`.dlpack` (on ``torch.utils.dlpack``), :mod:`.download` (local files
only: nothing downloads), the C++ extension toolchain
:mod:`.cpp_extension`, :mod:`.pretrained` (reference-format ``.pdparams``
read from a local file) and the ``monitor``/``profiler`` aliases.
"""
from __future__ import annotations

import functools
import warnings

from .. import profiler  # noqa: F401  (span profiler, device traces)
from ..framework import monitor  # noqa: F401  (counters + histograms)
from . import (cpp_extension, dlpack, download, pretrained,  # noqa: F401
               unique_name)

__all__ = ["unique_name", "deprecated", "try_import", "monitor",
           "profiler", "dlpack", "download", "require_version", "run_check",
           "cpp_extension"]


def deprecated(update_to: str = "", since: str = "", reason: str = ""):
    """A decorator whose function warns ``DeprecationWarning`` at each
    call, naming its replacement, version and reason."""

    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            msg = f"API {fn.__module__}.{fn.__name__} is deprecated"
            if since:
                msg += f" since {since}"
            if update_to:
                msg += f", use {update_to} instead"
            if reason:
                msg += f" ({reason})"
            warnings.warn(msg, DeprecationWarning, stacklevel=2)
            return fn(*args, **kwargs)

        return wrapper

    return deco


def try_import(module_name: str, err_msg: str = None):
    """The module, or ``ImportError`` with ``err_msg`` when it is not
    installed."""
    import importlib
    try:
        return importlib.import_module(module_name)
    except ImportError as e:
        raise ImportError(
            err_msg or f"{module_name} is required but not installed"
        ) from e


def require_version(min_version, max_version=None):
    """Raise unless this package's version lies within ``[min_version,
    max_version]``."""
    from ..version import full_version

    def parse(v):
        return tuple(int(p) for p in str(v).split(".")[:3] if p.isdigit())

    cur = parse(full_version)
    if parse(min_version) > cur:
        raise Exception(
            f"installed version {full_version} < required {min_version}")
    if max_version is not None and parse(max_version) < cur:
        raise Exception(
            f"installed version {full_version} > allowed {max_version}")


def run_check(device=None):
    """Check that the install computes on the card (``device``; ``None``
    means the card, and without one this raises): one train step of a
    small ``Linear`` (forward, backward, an SGD step) against the same
    step in float64 on the host, then a summary line."""
    import torch

    from .._device import resolve_device
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(64, 32, generator=gen, dtype=torch.float64)
    w0 = torch.randn(32, 16, generator=gen, dtype=torch.float64)
    want = w0 - 0.1 * x.t() @ torch.ones(64, 16, dtype=torch.float64) / (
        64 * 16)
    w = w0.float().to(dev).requires_grad_()
    (x.float().to(dev) @ w).mean().backward()
    with torch.no_grad():
        w -= 0.1 * w.grad
    err = float((w.detach().double().cpu() - want).abs().max())
    if not err < 1e-5:
        raise RuntimeError(f"run_check: a train step on {dev} is off by "
                           f"{err} against the host's float64 step")
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"paddle_tpu_torch works on {dev} ({name}): one train step "
          f"within {err:.1e} of the host's float64 step.")
    print("paddle_tpu_torch is installed successfully!")
