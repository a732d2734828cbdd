"""Build the package's CUDA kernels with ``nvcc`` and load them with ctypes.

Each ``csrc/<name>.cu`` exports a plain C interface (no PyTorch headers,
so a build takes seconds, not minutes) and compiles on its own into
``build/paddle_tpu_torch/<name>-<hash>.so`` at the root of the checkout,
where ``<hash>`` covers the source text, the text of every shared header
``csrc/*.cuh`` and the compiler flags: an edited source or header
rebuilds, an unchanged one loads the library already there.
``PADDLE_TPU_TORCH_BUILD_DIR`` moves the build directory (an installed
package has no checkout root to build into).

:func:`build_all` starts one ``nvcc`` per source at once and waits for
all of them, so a cold start costs the slowest build, not their sum.
:func:`load` returns the loaded library, building it first when needed.
:func:`function` binds one exported
symbol, and :data:`DTYPE_CODE` is the dtype numbering every C interface
takes. Nothing here runs at import time: this module imports on hosts without
``nvcc`` or a card, where only the plain versions of the kernels run.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, List

import torch

__all__ = ["NVCC_FLAGS", "SOURCES", "DTYPE_CODE", "build_all", "load",
           "function", "build_dir"]

_CSRC = Path(__file__).resolve().parent.parent / "csrc"

#: kernel sources, one shared library each
SOURCES = ("ragged_paged_attention", "ragged_paged_attention_sm90",
           "layer_norm", "flash_attention", "flash_attention_sm90", "adamw")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

#: the ``dtype`` argument of every kernel's C interface
DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def build_dir() -> Path:
    env = os.environ.get("PADDLE_TPU_TORCH_BUILD_DIR")
    if env:
        return Path(env)
    return _CSRC.parent.parent / "build" / "paddle_tpu_torch"


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    for cand in (shutil.which("nvcc"), os.path.join(home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (searched PATH and $CUDA_HOME/bin): the CUDA "
        "kernels of paddle_tpu_torch are built from source at first use")


def _target(name: str) -> Path:
    digest = hashlib.sha256((_CSRC / f"{name}.cu").read_bytes())
    for header in sorted(_CSRC.glob("*.cuh")):   # any source may include one
        digest.update(header.name.encode() + header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return build_dir() / f"{name}-{digest.hexdigest()[:16]}.so"


def _start(name: str) -> "tuple[subprocess.Popen, Path, Path]":
    out = _target(name)
    out.parent.mkdir(parents=True, exist_ok=True)
    # compile into a private file and rename it into place: a reader
    # never sees a half-written library, and two processes building the
    # same source race harmlessly
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(_CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(name: str, proc: subprocess.Popen, tmp: Path,
            out: Path) -> None:
    log, _ = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed on csrc/{name}.cu "
                           f"(exit {proc.returncode}):\n{log}")
    os.replace(tmp, out)


def build_all(names: List[str] = None) -> float:
    """Build every listed source whose library is missing, one ``nvcc``
    each, all started together. Returns the wall seconds spent."""
    t0 = time.perf_counter()
    with _lock:
        todo = [n for n in (names or SOURCES) if not _target(n).exists()]
        started = [(n, *_start(n)) for n in todo]
        errors = []
        for name, proc, tmp, out in started:
            try:
                _finish(name, proc, tmp, out)
            except RuntimeError as e:
                errors.append(str(e))
        if errors:
            raise RuntimeError("\n".join(errors))
    return time.perf_counter() - t0


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built at first use."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    build_all([name])
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = _libs[name] = ctypes.CDLL(str(_target(name)))
    return lib


def function(name: str, symbol: str, argtypes: list):
    """``symbol`` of ``csrc/<name>.cu``'s library, its C arguments set to
    ``argtypes`` and its result to ``int`` (a CUDA error code)."""
    fn = getattr(load(name), symbol)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn
