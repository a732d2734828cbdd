"""Paddle dtype names and ``torch.dtype`` (counterpart of
``paddle_tpu/framework/dtypes.py``, which aliases the names to numpy
dtypes). The canonical name of a dtype is the JAX package's
``np.dtype(...).name``; ``float8_e4m3fn`` is the 1-byte KV-pool code type
of the quantized serving path."""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["convert_dtype", "dtype_name", "DEFAULT_DTYPE", "NAMES"]

#: canonical name -> dtype
NAMES = {
    "bool": torch.bool, "uint8": torch.uint8, "int8": torch.int8, "int16": torch.int16, "int32": torch.int32,
    "int64": torch.int64, "float16": torch.float16,
    "bfloat16": torch.bfloat16, "float32": torch.float32,
    "float64": torch.float64, "complex64": torch.complex64,
    "complex128": torch.complex128, "float8_e4m3fn": torch.float8_e4m3fn,
}
if hasattr(torch, "uint32"):        # raw PRNG key words in the JAX package
    NAMES["uint32"] = torch.uint32

_ALIASES = dict(NAMES, fp16=torch.float16, half=torch.float16,
                bf16=torch.bfloat16, fp32=torch.float32,
                float=torch.float32, fp64=torch.float64,
                double=torch.float64)

_TO_NAME = {d: n for n, d in NAMES.items()}

#: the dtype of float data given without one
DEFAULT_DTYPE = torch.float32


def convert_dtype(dtype) -> torch.dtype:
    """Any dtype spec — a Paddle name or alias, a ``torch.dtype``, a numpy
    dtype — to a ``torch.dtype``; ``None`` is the default dtype."""
    if dtype is None:
        return DEFAULT_DTYPE
    if isinstance(dtype, torch.dtype):
        return dtype
    if isinstance(dtype, str):
        key = dtype.lower()
        if key in _ALIASES:
            return _ALIASES[key]
        raise TypeError(f"Unsupported dtype string: {dtype!r}")
    name = np.dtype(dtype).name
    if name not in NAMES:
        raise TypeError(f"Unsupported dtype: {dtype!r}")
    return NAMES[name]


def dtype_name(dtype) -> str:
    """The canonical Paddle name of ``dtype``."""
    return _TO_NAME[convert_dtype(dtype)]
