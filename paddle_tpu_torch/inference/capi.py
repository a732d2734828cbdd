"""Build + bind the C inference API (``csrc/tpu_infer_capi.cc``;
counterpart of ``paddle_tpu/inference/capi.py``).

Reference analog: paddle/fluid/inference/capi_exp/pd_inference_api.h —
the C ABI that lets C/C++/Go/Rust serving processes run a saved model
without the host language's runtime. Here the .so embeds CPython (the
predictor is Python over PyTorch), so a C consumer links
``libtpu_infer_capi`` and calls::

    PDT_Init("/path/to/site-packages-or-repo");
    void* p = PDT_PredictorCreate("/models/resnet50");   // on the card
    // or PDT_PredictorCreateOn("/models/resnet50", "cpu")
    PDT_PredictorRun(p, data, shape, ndim, &out, &out_shape, &out_ndim);

``load_capi()`` builds the library with ``g++`` and this interpreter's
embed flags at first use (into the checkout's ``build/``) and returns
(ctypes CDLL, path): the path is what a real C build would link
against.
"""
from __future__ import annotations

import ctypes
import os
import sysconfig

_SRC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "csrc", "tpu_infer_capi.cc")


def _embed_flags():
    inc = sysconfig.get_paths()["include"]
    libdir = sysconfig.get_config_var("LIBDIR") or ""
    ver = sysconfig.get_config_var("LDVERSION") or \
        sysconfig.get_config_var("VERSION")
    cflags = [f"-I{inc}"]
    ldflags = [f"-L{libdir}", f"-lpython{ver}"] if libdir else \
        [f"-lpython{ver}"]
    return cflags, ldflags


def build_capi_library() -> str:
    """Compile (cached) and return the .so path for C consumers."""
    from ..utils import cpp_extension
    cflags, ldflags = _embed_flags()
    ns = cpp_extension.load("tpu_infer_capi", [_SRC],
                            extra_cxx_cflags=cflags,
                            extra_ldflags=ldflags)
    return ns.__so_path__


def load_capi():
    """(CDLL with typed signatures, library path) for in-process use —
    the test harness's stand-in for a real C caller."""
    path = build_capi_library()
    lib = ctypes.CDLL(path)
    lib.PDT_Init.argtypes = [ctypes.c_char_p]
    lib.PDT_Init.restype = ctypes.c_int
    lib.PDT_PredictorCreate.argtypes = [ctypes.c_char_p]
    lib.PDT_PredictorCreate.restype = ctypes.c_void_p
    lib.PDT_PredictorCreateOn.argtypes = [ctypes.c_char_p, ctypes.c_char_p]
    lib.PDT_PredictorCreateOn.restype = ctypes.c_void_p
    lib.PDT_PredictorDestroy.argtypes = [ctypes.c_void_p]
    lib.PDT_PredictorDestroy.restype = None
    lib.PDT_BufferFree.argtypes = [ctypes.c_void_p]
    lib.PDT_BufferFree.restype = None
    lib.PDT_LastError.argtypes = []
    lib.PDT_LastError.restype = ctypes.c_char_p
    lib.PDT_PredictorRun.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_int64), ctypes.c_int,
        ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
        ctypes.POINTER(ctypes.POINTER(ctypes.c_int64)),
        ctypes.POINTER(ctypes.c_int)]
    lib.PDT_PredictorRun.restype = ctypes.c_int
    return lib, path
