"""``linalg`` (counterpart of ``paddle_tpu/linalg.py``): the linear
algebra namespace over the registered ops (``ops/linalg_ops.py``: torch
``linalg``, cuSOLVER on the card), with ``cholesky_solve``, ``cov``,
``corrcoef`` and ``lu_unpack`` in torch directly.

``lu`` returns 1-based pivots (LAPACK's, as the JAX package's) and, with
``get_infos``, a zero status per matrix; ``eig`` runs on the card here
(a host callback in the JAX package) and returns complex values and
vectors, defined up to each vector's phase.
"""
from __future__ import annotations

import torch

from .framework.dispatch import call_op as _op

__all__ = ["cholesky", "det", "slogdet", "norm", "cond", "inv", "pinv",
           "svd", "qr", "lu", "eig", "eigvals", "eigh", "eigvalsh",
           "matrix_power", "matrix_rank", "solve", "triangular_solve",
           "lstsq", "multi_dot", "cholesky_solve", "corrcoef", "cov",
           "lu_unpack"]


def cholesky(x, upper=False, name=None):
    out = _op("cholesky", x)
    return _op("transpose", out, perm=list(range(out.ndim - 2))
               + [out.ndim - 1, out.ndim - 2]) if upper else out


def det(x, name=None):
    return _op("det", x)


def slogdet(x, name=None):
    return _op("slogdet", x)


def norm(x, p=None, axis=None, keepdim=False, name=None):
    if p == "fro" or (p is None and axis is None):
        return _op("frobenius_norm", x, axis=axis, keepdim=keepdim)
    if p == "nuc":
        s = _op("svd", x, full_matrices=False)[1]
        return _op("sum", s, axis=-1, keepdim=keepdim)
    return _op("p_norm", x, porder=2.0 if p is None else p, axis=axis,
               keepdim=keepdim)


def cond(x, p=None, name=None):
    return _op("cond", x, p=p)


def inv(x, name=None):
    return _op("inverse", x)


def pinv(x, rcond=1e-15, hermitian=False, name=None):
    return _op("pinv", x, rtol=rcond, hermitian=hermitian)


def svd(x, full_matrices=False, name=None):
    return _op("svd", x, full_matrices=full_matrices)


def qr(x, mode="reduced", name=None):
    return _op("qr", x, mode=mode)


def lu(x, pivot=True, get_infos=False, name=None):
    lu_mat, piv = _op("lu", x)
    if get_infos:
        # the factorization carries no per-matrix status: report success
        # (LAPACK's info 0) for the factorizations it returns, as the JAX
        # package does
        info = torch.zeros(tuple(x.shape[:-2]) or (1,), dtype=torch.int32,
                           device=lu_mat.device)
        return lu_mat, piv, info
    return lu_mat, piv


def eig(x, name=None):
    return _op("eig", x)


def eigvals(x, name=None):
    return _op("eigvals", x)


def eigh(x, UPLO="L", name=None):
    return _op("eigh", x, UPLO=UPLO)


def eigvalsh(x, UPLO="L", name=None):
    return _op("eigvalsh", x, UPLO=UPLO)


def matrix_power(x, n, name=None):
    return _op("matrix_power", x, n=int(n))


def matrix_rank(x, tol=None, hermitian=False, name=None):
    return _op("matrix_rank", x, rtol=tol)


def solve(x, y, name=None):
    return _op("solve", x, y)


def triangular_solve(x, y, upper=True, transpose=False,
                     unitriangular=False, name=None):
    return _op("triangular_solve", x, y, upper=upper,
               transpose=transpose, unitriangular=unitriangular)


def lstsq(x, y, rcond=None, driver=None, name=None):
    return _op("lstsq", x, y, rcond=rcond)


def multi_dot(xs, name=None):
    return _op("multi_dot", xs)


def _a(v):
    return v if isinstance(v, torch.Tensor) else torch.as_tensor(v)


def cholesky_solve(x, y, upper=False, name=None):
    """Solve ``A @ out = x`` given ``y``, the Cholesky factor of ``A``."""
    return torch.cholesky_solve(_a(x), _a(y), upper=upper)


def cov(x, rowvar=True, ddof=True, fweights=None, aweights=None,
        name=None):
    """The covariance matrix (numpy's ``cov``: a row per variable unless
    ``rowvar`` is false; ``ddof`` true divides by N - 1)."""
    x = _a(x)
    if not rowvar and x.dim() == 2:
        x = x.t()
    return torch.cov(x, correction=1 if ddof else 0,
                     fweights=None if fweights is None else _a(fweights),
                     aweights=None if aweights is None else _a(aweights))


def corrcoef(x, rowvar=True, name=None):
    x = _a(x)
    if not rowvar and x.dim() == 2:
        x = x.t()
    return torch.corrcoef(x)


def lu_unpack(x, y, unpack_ludata=True, unpack_pivots=True, name=None):
    """``(LU, pivots) -> (P, L, U)`` with ``A = P @ L @ U``; ``y`` holds
    the 1-based sequential pivots that :func:`lu` returns. Any leading
    batch dimensions; ``None`` in place of what is not unpacked."""
    P, L, U = torch.lu_unpack(_a(x), _a(y).to(torch.int32),
                              unpack_data=unpack_ludata,
                              unpack_pivots=unpack_pivots)
    return (P if unpack_pivots else None,
            L if unpack_ludata else None, U if unpack_ludata else None)
