"""Custom C++ op toolchain (``paddle.utils.cpp_extension``; counterpart
of ``paddle_tpu/utils/cpp_extension.py``).

Reference: python/paddle/utils/cpp_extension/cpp_extension.py:
``load()`` JIT-compiles a C++/CUDA source registering ops via
``PD_BUILD_OP`` (framework/custom_operator.cc) and returns a module of
generated Python wrappers; ``setup()`` is the setuptools variant.

Here a "custom op" is host-side C++ with a C ABI (data prep, tokenizers,
samplers, IO: the roles the reference's CPU custom ops play, and the C
inference API of ``inference/capi.py``), compiled with the system ``g++``
and bound through ctypes. The returned namespace exposes one Python
callable per exported ``extern "C"`` symbol; a signature table maps
numpy arrays to pointers. Device code is the port's CUDA kernels, built
by ``ops/_build.py`` with ``nvcc``. The libraries go under the
checkout's ``build/`` (``PADDLE_EXTENSION_DIR`` moves them).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import subprocess
import types
from typing import Dict, Optional, Sequence

import numpy as np

__all__ = ["load", "get_build_directory", "CppExtension",
           "CUDAExtension", "setup"]

_CACHE_ENV = "PADDLE_EXTENSION_DIR"


def get_build_directory() -> str:
    from ..ops._build import build_dir
    d = os.environ.get(_CACHE_ENV) or str(build_dir() / "extensions")
    os.makedirs(d, exist_ok=True)
    return d


class CppExtension:
    """setup()-style description (reference CppExtension); carried for
    API parity — building happens through load()."""

    def __init__(self, sources: Sequence[str], *args, **kwargs):
        self.sources = list(sources)
        self.extra_compile_args = kwargs.get("extra_compile_args", [])


_C_TYPES = {
    "void": None,
    "int": ctypes.c_int,
    "long": ctypes.c_long,
    "long long": ctypes.c_longlong,
    "float": ctypes.c_float,
    "double": ctypes.c_double,
    "int*": ctypes.POINTER(ctypes.c_int),
    "long*": ctypes.POINTER(ctypes.c_long),
    "float*": ctypes.POINTER(ctypes.c_float),
    "double*": ctypes.POINTER(ctypes.c_double),
    "const int*": ctypes.POINTER(ctypes.c_int),
    "const long*": ctypes.POINTER(ctypes.c_long),
    "const float*": ctypes.POINTER(ctypes.c_float),
    "const double*": ctypes.POINTER(ctypes.c_double),
    "const char*": ctypes.c_char_p,
    "char*": ctypes.c_char_p,
}

# type token: "long long" before "long" so backtracking can't misbind a
# two-word type's first word as the whole return type
_TYPE_TOKEN = (r"(?:const\s+)?(?:unsigned\s+)?"
               r"(?:long\s+long|[A-Za-z_]\w*)\s*\*?")


def _parse_signatures(source: str) -> Dict[str, Optional[tuple]]:
    """Best-effort parse of `extern "C"` function signatures so ctypes
    bindings get argtypes/restype. Functions with unrecognized types map
    to None and are exported UNTYPED (ctypes defaults)."""
    sigs: Dict[str, Optional[tuple]] = {}
    pat = re.compile(
        r'(?:extern\s+"C"\s+)?'
        r'(?P<ret>' + _TYPE_TOKEN + r')\s+'
        r'(?P<name>\w+)\s*\((?P<args>[^)]*)\)\s*\{')

    def norm(t):
        # canonical form: single spaces, '*' glued to the type name
        t = re.sub(r"\s+", " ", t).strip()
        return t.replace(" *", "*")

    for m in pat.finditer(source):
        name = m.group("name")
        ret = norm(m.group("ret"))
        args = []
        ok = ret in _C_TYPES
        for a in m.group("args").split(","):
            a = a.strip()
            if not a or a == "void":
                continue
            # drop the parameter name
            a = norm(re.sub(r"\s*\w+$", "", a))
            if a not in _C_TYPES or _C_TYPES[a] is None:
                ok = False
                break
            args.append(_C_TYPES[a])
        sigs[name] = (_C_TYPES[ret], args) if ok else None
    return sigs


def _as_ctypes_arg(a, expected):
    if isinstance(a, np.ndarray):
        if expected is not None:
            return a.ctypes.data_as(expected)
        # untyped function: pass a c_void_p, NOT the bare int address —
        # ctypes masks bare ints to C int width, truncating the pointer
        return a.ctypes.data_as(ctypes.c_void_p)
    if isinstance(a, str):
        return a.encode()
    return a


def load(name: str, sources: Sequence[str],
         extra_cxx_cflags: Optional[Sequence[str]] = None,
         extra_ldflags: Optional[Sequence[str]] = None,
         build_directory: Optional[str] = None,
         verbose: bool = False, **kwargs) -> types.SimpleNamespace:
    """JIT-build a C++ extension and return a module-like namespace of
    its ``extern "C"`` functions (reference cpp_extension.py:738 load).
    Recompiles only when sources change (content hash in the .so name).
    """
    build_dir = build_directory or get_build_directory()
    srcs = [os.path.abspath(s) for s in sources]
    for s in srcs:
        if not os.path.exists(s):
            raise FileNotFoundError(s)
    content = "".join(open(s).read() for s in srcs)
    tag = hashlib.sha256(
        (content + repr(extra_cxx_cflags) + repr(extra_ldflags))
        .encode()).hexdigest()[:16]
    so_path = os.path.join(build_dir, f"{name}_{tag}.so")
    if not os.path.exists(so_path):
        # compile to a private temp path and rename atomically: a killed
        # or concurrent build must never leave a truncated .so that
        # poisons the content-hash cache forever
        tmp_path = f"{so_path}.tmp.{os.getpid()}"
        cmd = ["g++", "-O2", "-shared", "-fPIC", "-std=c++17",
               *(extra_cxx_cflags or []), "-o", tmp_path, *srcs,
               *(extra_ldflags or [])]
        if verbose:
            print("[cpp_extension]", " ".join(cmd))
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True,
                                  timeout=600)
            if proc.returncode != 0:
                raise RuntimeError(
                    f"extension '{name}' failed to build:\n{proc.stderr}")
            os.rename(tmp_path, so_path)
        finally:
            if os.path.exists(tmp_path):
                os.unlink(tmp_path)
    lib = ctypes.CDLL(so_path)
    sigs = _parse_signatures(content)

    ns = types.SimpleNamespace(__name__=name, __so_path__=so_path,
                               __lib__=lib)
    for fname, sig in sigs.items():
        fn = getattr(lib, fname, None)
        if fn is None:
            continue
        argtypes = None
        if sig is not None:
            ret, argtypes = sig
            fn.restype = ret
            fn.argtypes = argtypes

        def make(fn=fn, argtypes=argtypes, fname=fname):
            def call(*args):
                conv = [_as_ctypes_arg(a, t)
                        for a, t in zip(args, argtypes)] if argtypes \
                    else [_as_ctypes_arg(a, None) for a in args]
                return fn(*conv)
            call.__name__ = fname
            return call

        setattr(ns, fname, make())
    return ns


class CUDAExtension(CppExtension):
    """Accepted for porting convenience: ``load`` builds host C++ with
    ``g++``, so ``.cu`` sources are refused. The port's device code is
    its hand-written kernels, built with ``nvcc`` by ``ops/_build.py``
    (add a kernel there, with its plain version beside it)."""

    def __init__(self, sources, *args, **kwargs):
        bad = [s for s in sources if str(s).endswith((".cu", ".cuh"))]
        if bad:
            raise ValueError(f"cpp_extension builds host C++ only; CUDA "
                             f"sources go through ops/_build.py: {bad}")
        super().__init__(sources, *args, **kwargs)


def setup(name=None, ext_modules=None, **kwargs):
    """Reference cpp_extension.setup: build the extension(s) at install
    time. Here it eagerly JIT-builds each extension through load() and
    returns the namespaces (no setuptools involvement — the .so cache
    under get_build_directory() is the 'install')."""
    exts = ext_modules if isinstance(ext_modules, (list, tuple)) else \
        [ext_modules] if ext_modules else []
    built = []
    for i, ext in enumerate(exts):
        srcs = getattr(ext, "sources", ext)
        built.append(load(f"{name or 'ext'}_{i}", list(srcs)))
    return built[0] if len(built) == 1 else built
