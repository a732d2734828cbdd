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

:func:`load_pdparams` reads a reference-format ``.pdparams`` (a copy of
``paddle_tpu/utils/pretrained.py``'s reader): a restricted unpickling
that admits numpy arrays in builtin containers and nothing else.
"""
from __future__ import annotations

import os
import pickle

import numpy as np
import torch

__all__ = ["save", "load", "load_pdparams"]

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


# reference python/paddle/fluid/framework.py: extra key carried in saved
# state dicts mapping structured names -> parameter names
_STRUCT_KEY = "StructuredToParameterName@@"

_ALLOWED = {
    ("numpy.core.multiarray", "_reconstruct"),
    ("numpy.core.multiarray", "scalar"),
    ("numpy._core.multiarray", "_reconstruct"),  # numpy 2.x module path
    ("numpy._core.multiarray", "scalar"),
    ("numpy", "ndarray"),
    ("numpy", "dtype"),
    ("numpy.core.numeric", "_frombuffer"),
    ("numpy._core.numeric", "_frombuffer"),
    ("collections", "OrderedDict"),
    # protocol<=2 numpy array payloads are latin-1 strings decoded via this
    ("_codecs", "encode"),
}


class RestrictedUnpickler(pickle.Unpickler):
    """Only numpy array reconstruction and builtin containers may load: a
    ``.pdparams`` is a pickle, and pickles run arbitrary callables on
    load."""

    def find_class(self, module, name):
        if (module, name) in _ALLOWED:
            return super().find_class(module, name)
        # numpy scalar TYPES only (float32, int64, ...): np.save, np.load
        # and the like are callables a tampered file could smuggle in
        if module in ("numpy", "numpy.core.multiarray",
                      "numpy._core.multiarray") and hasattr(np, name):
            obj = getattr(np, name)
            if isinstance(obj, type) and issubclass(obj, np.generic):
                return obj
        raise pickle.UnpicklingError(
            f"refusing to unpickle {module}.{name}: .pdparams files may "
            f"only contain numpy arrays")


def load_pdparams(path: str) -> dict:
    """A reference-format ``.pdparams`` as ``{name: array}``: numpy
    arrays, and a bfloat16 array (this format's ``__bf16__`` entry;
    numpy has no bfloat16) as a CPU ``torch.bfloat16`` tensor. Drops the
    ``StructuredToParameterName@@`` entry and flattens one level of
    nesting (optimizer checkpoints keep master weights in a sub-dict)."""
    with open(path, "rb") as f:
        raw = RestrictedUnpickler(f).load()
    if not isinstance(raw, dict):
        raise ValueError(
            f"{path}: expected a pickled state dict, got {type(raw)}")
    out = {}
    for k, v in raw.items():
        if k == _STRUCT_KEY:
            continue
        if isinstance(v, np.ndarray):
            out[str(k)] = v
        elif isinstance(v, dict):
            if v.get(_BF16_TAG) and isinstance(v.get("data"), np.ndarray):
                out[str(k)] = _from_picklable(v)
                continue
            for kk, vv in v.items():
                if isinstance(vv, np.ndarray):
                    out[f"{k}.{kk}"] = vv
        elif np.isscalar(v):
            out[str(k)] = np.asarray(v)
    return out
