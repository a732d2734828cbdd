"""``save`` / ``load`` in the JAX package's file format (counterpart of
``paddle_tpu/framework/io.py:20-63``).

The file is a pickle of the object with every tensor turned into a
numpy array; bfloat16, which numpy lacks, is stored as
``{"__bf16__": True, "data": <its bits as a uint16 array>, "name":
None}``. So a ``.pdparams`` or ``.pdopt`` file written by either package
opens in the other. :func:`load` returns torch tensors on the CPU, where
the JAX package returns its own tensors; dicts, lists, tuples and plain
values pass through both ways. Unpickling runs code: load only files
this program or the JAX package wrote.
"""
from __future__ import annotations

import os
import pickle

import numpy as np
import torch

__all__ = ["save", "load"]

_BF16_TAG = "__bf16__"


def _to_picklable(obj):
    if isinstance(obj, torch.Tensor):
        t = obj.detach().cpu()
        if t.dtype == torch.bfloat16:
            return {_BF16_TAG: True,
                    "data": t.view(torch.int16).numpy().view(np.uint16),
                    "name": None}
        return t.numpy().copy()
    if isinstance(obj, dict):
        return {k: _to_picklable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_picklable(v) for v in obj)
    return obj


def _from_picklable(obj):
    if isinstance(obj, dict):
        if obj.get(_BF16_TAG):
            bits = np.ascontiguousarray(obj["data"]).view(np.int16)
            return torch.from_numpy(bits.copy()).view(torch.bfloat16)
        return {k: _from_picklable(v) for k, v in obj.items()}
    if isinstance(obj, np.ndarray):
        return torch.from_numpy(np.array(obj))
    if isinstance(obj, (list, tuple)):
        return type(obj)(_from_picklable(v) for v in obj)
    return obj


def save(obj, path, protocol=4, **configs):
    """Pickle ``obj`` to ``path``, tensors as numpy arrays; makes the
    parent directory."""
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump(_to_picklable(obj), f, protocol=protocol)


def load(path, **configs):
    """The object :func:`save` (or the JAX package's ``save``) wrote, its
    arrays as CPU torch tensors."""
    with open(path, "rb") as f:
        return _from_picklable(pickle.load(f))
