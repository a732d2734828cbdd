"""ctypes bindings for the native tpu_prof event recorder (counterpart of
``paddle_tpu/profiler/native.py``; reference analog: platform/profiler/
host_event_recorder.h).

The recorder's source is the repository's ``native/tpu_prof.cc``, a host
C++ file with a plain C interface: ``ops/_build.py`` compiles it with the
host ``g++`` into the build directory beside the CUDA kernels
(``build/paddle_tpu_torch/``), once per source text. Without a compiler
:func:`available` is False and ``Profiler`` keeps the python recorder of
``profiler.py``, which stays the source of truth for the tests.
"""
from __future__ import annotations

import ctypes
import json
import os
import threading
from typing import Optional

__all__ = ["available", "enable", "disable", "begin", "end", "instant",
           "count", "dropped", "dump", "merge_into"]

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(os.path.dirname(os.path.dirname(_HERE)), "native",
                    "tpu_prof.cc")

_lib = None
_lib_err: Optional[str] = None
_build_lock = threading.Lock()


def _load():
    global _lib, _lib_err
    if _lib is not None or _lib_err is not None:
        return _lib
    with _build_lock:
        if _lib is not None or _lib_err is not None:
            return _lib
        try:
            from ..ops import _build
            lib = _build.load_host("tpu_prof", _SRC)
        except Exception as e:
            _lib_err = f"{type(e).__name__}: {e}"
            return None
        lib.tp_enable.argtypes = [ctypes.c_uint64]
        lib.tp_begin.argtypes = [ctypes.c_char_p]
        lib.tp_instant.argtypes = [ctypes.c_char_p]
        lib.tp_count.restype = ctypes.c_uint64
        lib.tp_dropped.restype = ctypes.c_uint64
        lib.tp_dump.argtypes = [ctypes.c_char_p, ctypes.c_longlong]
        lib.tp_dump.restype = ctypes.c_longlong
        lib.tp_enabled.restype = ctypes.c_int
        _lib = lib
    return _lib


def available() -> bool:
    return _load() is not None


def enable(capacity: int = 1 << 20):
    lib = _load()
    if lib is not None:
        lib.tp_enable(capacity)


def disable():
    lib = _load()
    if lib is not None:
        lib.tp_disable()


def resume():
    """Re-arm recording without clearing accumulated events."""
    lib = _load()
    if lib is not None:
        lib.tp_resume()


def begin(name: str):
    lib = _load()
    if lib is not None:
        lib.tp_begin(name.encode())


def end():
    lib = _load()
    if lib is not None:
        lib.tp_end()


def instant(name: str):
    lib = _load()
    if lib is not None:
        lib.tp_instant(name.encode())


def count() -> int:
    lib = _load()
    return int(lib.tp_count()) if lib is not None else 0


def dropped() -> int:
    lib = _load()
    return int(lib.tp_dropped()) if lib is not None else 0


def dump(path: str, pid: Optional[int] = None) -> int:
    lib = _load()
    if lib is None:
        return 0
    return int(lib.tp_dump(path.encode(),
                           os.getpid() if pid is None else pid))


def merge_into(trace: dict) -> dict:
    """Append the native events into the chrome-trace dict as a separate
    pid lane (pid+1, labeled via a process_name metadata event)."""
    import tempfile
    if not available() or count() == 0:
        return trace
    lane = os.getpid() + 1
    with tempfile.NamedTemporaryFile(suffix=".json", delete=False) as f:
        tmp = f.name
    try:
        n = dump(tmp, pid=lane)
        if n <= 0:
            return trace  # IO error in the C recorder: keep the py trace
        try:
            with open(tmp) as f:
                native_trace = json.load(f)
        except ValueError:
            return trace
        events = trace.setdefault("traceEvents", [])
        events.append({"ph": "M", "name": "process_name", "pid": lane,
                       "args": {"name": "tpu_prof (native recorder)"}})
        events.extend(native_trace.get("traceEvents", []))
    finally:
        os.unlink(tmp)
    return trace
