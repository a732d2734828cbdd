"""``sparse`` (counterpart of ``paddle_tpu/sparse/__init__.py``): COO and
CSR sparse tensors and their math.

A ``SparseCooTensor`` holds its indices ``[sparse_ndim, nnz]`` and values
``[nnz, *dense_dims]`` as given (duplicates and order kept, as a BCOO
does; ``coalesce`` sums the duplicates and sorts); ``to_dense`` goes
through ``torch.sparse_coo_tensor``. A ``SparseCsrTensor`` holds
``crows``, ``cols`` and ``values``. Elementwise math maps onto the
values; two COO operands with one pattern give a COO result, otherwise
the result is dense. ``matmul`` of a CSR tensor converts it to COO, as
the JAX package does; a 2-D COO operand multiplies through
``torch.sparse.mm``. The values keep their autograd graph.
"""
from __future__ import annotations

import numpy as np
import torch

from ..framework.place import to_torch_device

__all__ = ["sparse_coo_tensor", "sparse_csr_tensor", "SparseCooTensor",
           "SparseCsrTensor", "is_sparse", "add", "subtract", "multiply",
           "divide", "matmul", "masked_matmul", "relu", "sqrt", "sin",
           "tanh", "abs", "pow", "neg", "cast", "to_dense", "nn"]


def _t(x, device=None):
    if isinstance(x, torch.Tensor):
        return x if device is None else x.to(device)
    return torch.as_tensor(np.asarray(x), device=device)


class SparseCooTensor:
    """A COO sparse tensor: ``indices`` ``[sparse_ndim, nnz]`` (int64),
    ``values`` ``[nnz, *dense_dims]``, ``shape``. ``bcoo`` (the JAX
    package's argument name) is a torch sparse COO tensor or an
    ``(indices, values, shape)`` triple."""

    def __init__(self, bcoo):
        if isinstance(bcoo, torch.Tensor):
            bcoo = (bcoo._indices(), bcoo._values(), bcoo.shape)
        indices, values, shape = bcoo
        self._indices = indices
        self._values = values
        self._shape = tuple(int(s) for s in shape)

    @classmethod
    def from_parts(cls, indices, values, shape):
        vals = _t(values)
        idx = _t(indices, vals.device).long()
        if idx.dim() != 2:
            raise ValueError("indices must be [sparse_ndim, nnz]")
        return cls((idx, vals, shape))

    @property
    def shape(self):
        return list(self._shape)

    @property
    def dtype(self):
        return self._values.dtype

    def nnz(self) -> int:
        return int(self._values.shape[0])

    def indices(self):
        return self._indices

    def values(self):
        return self._values

    def _torch(self):
        return torch.sparse_coo_tensor(self._indices, self._values,
                                       self._shape)

    def to_dense(self):
        return self._torch().to_dense()

    def coalesce(self) -> "SparseCooTensor":
        c = self._torch().coalesce()
        return SparseCooTensor((c.indices(), c.values(), self._shape))

    def is_sparse_coo(self):
        return True

    def is_sparse_csr(self):
        return False

    def __repr__(self):
        return (f"SparseCooTensor(shape={self.shape}, nnz={self.nnz()}, "
                f"dtype={self.dtype})")

    def _map_values(self, fn) -> "SparseCooTensor":
        return SparseCooTensor((self._indices, fn(self._values),
                                self._shape))


class SparseCsrTensor:
    """A CSR sparse matrix: ``crows`` ``[rows + 1]``, ``cols`` and
    ``values`` ``[nnz]``. ``bcsr`` is a torch sparse CSR tensor or a
    ``(crows, cols, values, shape)`` tuple."""

    def __init__(self, bcsr):
        if isinstance(bcsr, torch.Tensor):
            bcsr = (bcsr.crow_indices(), bcsr.col_indices(), bcsr.values(),
                    bcsr.shape)
        crows, cols, values, shape = bcsr
        self._crows, self._cols, self._values = crows, cols, values
        self._shape = tuple(int(s) for s in shape)

    @classmethod
    def from_parts(cls, crows, cols, values, shape):
        vals = _t(values)
        return cls((_t(crows, vals.device).long(),
                    _t(cols, vals.device).long(), vals, shape))

    @property
    def shape(self):
        return list(self._shape)

    @property
    def dtype(self):
        return self._values.dtype

    def nnz(self) -> int:
        return int(self._values.shape[0])

    def crows(self):
        return self._crows

    def cols(self):
        return self._cols

    def values(self):
        return self._values

    def to_dense(self):
        return torch.sparse_csr_tensor(self._crows, self._cols,
                                       self._values, self._shape).to_dense()

    def to_coo(self) -> SparseCooTensor:
        """The same entries in COO, row by row."""
        counts = self._crows[1:] - self._crows[:-1]
        rows = torch.repeat_interleave(
            torch.arange(len(counts), device=counts.device), counts)
        return SparseCooTensor((torch.stack([rows, self._cols]),
                                self._values, self._shape))

    def is_sparse_coo(self):
        return False

    def is_sparse_csr(self):
        return True

    def __repr__(self):
        return (f"SparseCsrTensor(shape={self.shape}, nnz={self.nnz()}, "
                f"dtype={self.dtype})")

    def _map_values(self, fn) -> "SparseCsrTensor":
        return SparseCsrTensor((self._crows, self._cols, fn(self._values),
                                self._shape))


def _values_of(values, dtype, place):
    if isinstance(values, torch.Tensor) and place is None:
        vals = values
    else:
        vals = _t(values, to_torch_device(place))
    if dtype is not None:
        from ..framework.dtypes import convert_dtype
        vals = vals.to(convert_dtype(dtype))
    return vals


def sparse_coo_tensor(indices, values, shape=None, dtype=None,
                      place=None, stop_gradient=True):
    """A ``SparseCooTensor`` from ``indices`` ``[sparse_ndim, nnz]`` and
    ``values``; without ``shape``, each sparse dimension is its largest
    index plus one."""
    vals = _values_of(values, dtype, place)
    idx = _t(indices, vals.device).long()
    if shape is None:
        shape = tuple(int(m) + 1 for m in idx.amax(dim=1).tolist())
    return SparseCooTensor.from_parts(idx, vals, shape)


def sparse_csr_tensor(crows, cols, values, shape, dtype=None,
                      place=None, stop_gradient=True):
    vals = _values_of(values, dtype, place)
    return SparseCsrTensor.from_parts(crows, cols, vals, shape)


def is_sparse(x) -> bool:
    return isinstance(x, (SparseCooTensor, SparseCsrTensor))


def to_dense(x):
    return x.to_dense() if is_sparse(x) else x


# ---------------------------------------------------------------------------
# math
# ---------------------------------------------------------------------------

def _same_pattern(a: SparseCooTensor, b: SparseCooTensor) -> bool:
    return a._indices.shape == b._indices.shape and bool(
        torch.equal(a._indices, b._indices))


def _binary(a, b, fn):
    if isinstance(a, SparseCooTensor) and isinstance(b, SparseCooTensor):
        if _same_pattern(a, b):
            return SparseCooTensor((a._indices, fn(a._values, b._values),
                                    a._shape))
        # the patterns differ: a dense result
        return fn(a.to_dense(), b.to_dense())
    return fn(to_dense(a), to_dense(b))


def add(a, b):
    return _binary(a, b, lambda x, y: x + y)


def subtract(a, b):
    return _binary(a, b, lambda x, y: x - y)


def multiply(a, b):
    return _binary(a, b, lambda x, y: x * y)


def divide(a, b):
    return _binary(a, b, lambda x, y: x / y)


def matmul(a, b):
    """sparse @ dense, contracting the sparse operand's last axis."""
    db = _t(b)
    if isinstance(a, SparseCsrTensor):
        a = a.to_coo()
    if isinstance(a, SparseCooTensor):
        if a._indices.shape[0] == 2 and a._values.dim() == 1:
            return torch.sparse.mm(a._torch(), db)
        return a.to_dense() @ db
    return _t(a) @ db


def masked_matmul(x, y, mask):
    """``x @ y`` sampled at ``mask``'s pattern (SDDMM)."""
    if not isinstance(mask, SparseCooTensor):
        raise TypeError("mask must be a SparseCooTensor")
    dx, dy = _t(x), _t(y)
    rows, cols = mask._indices[0], mask._indices[1]
    vals = (dx[rows, :] * dy[:, cols].t()).sum(-1)
    return SparseCooTensor((mask._indices, vals, mask._shape))


_VALUE_FNS = {"relu": torch.relu, "sqrt": torch.sqrt, "sin": torch.sin,
              "tanh": torch.tanh, "abs": torch.abs, "neg": torch.neg}


def _unary(name):
    value_fn = _VALUE_FNS[name]

    def op(x):
        if is_sparse(x):
            return x._map_values(value_fn)
        from ..framework.dispatch import call_op
        return call_op(name, x)
    op.__name__ = op.__qualname__ = name
    return op


relu = _unary("relu")
sqrt = _unary("sqrt")
sin = _unary("sin")
tanh = _unary("tanh")
abs = _unary("abs")  # noqa: A001
neg = _unary("neg")


def pow(x, factor):  # noqa: A001
    if is_sparse(x):
        return x._map_values(lambda v: v ** factor)
    from ..framework.dispatch import call_op
    return call_op("pow", x, y=factor)


def cast(x, index_dtype=None, value_dtype=None):
    from ..framework.dtypes import convert_dtype
    if isinstance(x, SparseCooTensor):
        idx, vals = x._indices, x._values
        if index_dtype is not None:
            idx = idx.to(convert_dtype(index_dtype))
        if value_dtype is not None:
            vals = vals.to(convert_dtype(value_dtype))
        return SparseCooTensor((idx, vals, x._shape))
    raise TypeError("cast expects a SparseCooTensor")


from . import nn  # noqa: E402,F401
