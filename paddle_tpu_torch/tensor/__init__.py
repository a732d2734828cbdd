"""The user-facing tensor functions (counterpart of
``paddle_tpu/tensor/__init__.py``): ``paddle.add``, ``paddle.matmul``,
``paddle.full``, ... over the op library, each through ``call_op``.
``paddle_tpu_torch`` re-exports them at the top level, as the JAX
package does.

The tensor is ``torch.Tensor``. A function that makes a tensor from
nothing (``full``, ``arange``, ``rand``, ...) makes it on the current
place (the card unless ``set_device("cpu")``; ``device=`` chooses); the
random functions draw from the port's generator of that device
(``framework.random``). In-place functions (``reshape_``, ``increment``,
``assign(x, output)``) write into their tensor under ``no_grad``, as the
JAX package rebinds its tensor's data. The Paddle-only ``Tensor`` members
(``stop_gradient``, ``place``, ``clear_grad``, ``_rebind``) are installed
on ``torch.Tensor`` by ``framework/tensor.py``.
"""
from __future__ import annotations

import builtins

import numpy as np
import torch

from ..framework import random as _random
from ..framework.dispatch import call_op as _op
from ..framework import dtypes
from ..framework.dtypes import convert_dtype
from ..framework.place import to_torch_device
from ..framework.tensor import to_tensor

__all__ = ["to_tensor"]


def _export(fn):
    __all__.append(fn.__name__)
    return fn


def _dt(dtype):
    return None if dtype is None else convert_dtype(dtype)


def _v(x):
    """A 0-d tensor as its Python value (any other value as is)."""
    return x.item() if isinstance(x, torch.Tensor) else x


def _shape_list(shape):
    if isinstance(shape, torch.Tensor):
        return tuple(int(s) for s in shape.tolist())
    if isinstance(shape, (int, np.integer)):
        return (int(shape),)
    return tuple(int(_v(s)) for s in shape)


def _ax(axis):
    if isinstance(axis, torch.Tensor):
        return int(axis.item())
    if isinstance(axis, (list, tuple)):
        return tuple(int(a) for a in axis)
    return axis


# -- creation ---------------------------------------------------------------

@_export
def zeros(shape, dtype=None, name=None, *, device=None):
    return full(shape, 0.0, dtype, device=device)


@_export
def ones(shape, dtype=None, name=None, *, device=None):
    return full(shape, 1.0, dtype, device=device)


@_export
def full(shape, fill_value, dtype=None, name=None, *, device=None):
    return _op("full", shape=_shape_list(shape), fill_value=_v(fill_value),
               dtype=convert_dtype(dtype), device=device)


@_export
def empty(shape, dtype=None, name=None, *, device=None):
    return zeros(shape, dtype, device=device)


@_export
def zeros_like(x, dtype=None, name=None):
    return _op("full_like", x, 0, dtype=_dt(dtype))


@_export
def ones_like(x, dtype=None, name=None):
    return _op("full_like", x, 1, dtype=_dt(dtype))


@_export
def full_like(x, fill_value, dtype=None, name=None):
    return _op("full_like", x, _v(fill_value), dtype=_dt(dtype))


@_export
def empty_like(x, dtype=None, name=None):
    return zeros_like(x, dtype)


@_export
def arange(start=0, end=None, step=1, dtype=None, name=None, *,
           device=None):
    start, end, step = _v(start), _v(end), _v(step)
    if dtype is None:
        dtype = "int64" if builtins.all(
            isinstance(v, (int, type(None))) for v in (start, end, step)) \
            else dtypes.DEFAULT_DTYPE
    return _op("arange", start=start, end=end, step=step,
               dtype=convert_dtype(dtype), device=device)


@_export
def linspace(start, stop, num, dtype=None, name=None, *, device=None):
    return _op("linspace", start=float(_v(start)), stop=float(_v(stop)),
               num=int(_v(num)), dtype=convert_dtype(dtype), device=device)


@_export
def logspace(start, stop, num, base=10.0, dtype=None, name=None, *,
             device=None):
    return _op("logspace", start=float(_v(start)), stop=float(_v(stop)),
               num=int(_v(num)), base=float(_v(base)),
               dtype=convert_dtype(dtype), device=device)


@_export
def eye(num_rows, num_columns=None, dtype=None, name=None, *, device=None):
    return _op("eye", num_rows=num_rows, num_columns=num_columns,
               dtype=convert_dtype(dtype), device=device)


@_export
def clone(x, name=None):
    return _op("assign", x)


@_export
def assign(x, output=None):
    r = _op("assign", x if isinstance(x, torch.Tensor) else to_tensor(x))
    if output is not None:
        with torch.no_grad():
            output.copy_(r)
        return output
    return r


@_export
def numel(x, name=None):
    return torch.tensor(x.numel(), dtype=torch.int64, device=x.device)


# -- random -----------------------------------------------------------------

@_export
def rand(shape, dtype=None, name=None, *, device=None):
    return uniform(shape, dtype, min=0.0, max=1.0, device=device)


@_export
def uniform(shape, dtype=None, min=-1.0, max=1.0, seed=0, name=None, *,
            device=None):
    """Uniform on ``[min, max)``; ``seed`` other than 0 draws from a fresh
    generator seeded with it, as the reference's does."""
    gen = None
    if seed:
        gen = torch.Generator(device=to_torch_device(device))
        gen.manual_seed(int(seed))
    return _op("uniform_random", gen, shape=_shape_list(shape),
               dtype=convert_dtype(dtype), min=float(min), max=float(max),
               device=device)


@_export
def randn(shape, dtype=None, name=None, *, device=None):
    return normal(0.0, 1.0, shape, dtype, device=device)


@_export
def normal(mean=0.0, std=1.0, shape=None, dtype=None, name=None, *,
           device=None):
    if isinstance(mean, torch.Tensor) or isinstance(std, torch.Tensor):
        like = mean if isinstance(mean, torch.Tensor) else std
        g = _op("gaussian_random", None, shape=tuple(like.shape),
                dtype=convert_dtype(dtype), mean=0.0, std=1.0,
                device=like.device)
        return add(multiply(g, std), mean)
    return _op("gaussian_random", None, shape=_shape_list(shape),
               dtype=convert_dtype(dtype), mean=float(mean),
               std=float(std), device=device)


@_export
def standard_normal(shape, dtype=None, name=None, *, device=None):
    return normal(0.0, 1.0, shape, dtype, device=device)


@_export
def randint(low=0, high=None, shape=(1,), dtype="int64", name=None, *,
            device=None):
    return _op("randint", None, low=int(low),
               high=None if high is None else int(high),
               shape=_shape_list(shape), dtype=convert_dtype(dtype),
               device=device)


@_export
def randperm(n, dtype="int64", name=None, *, device=None):
    return _op("randperm", None, n=int(n), dtype=convert_dtype(dtype),
               device=device)


@_export
def bernoulli(x, name=None):
    return _op("bernoulli", None, x)


@_export
def multinomial(x, num_samples=1, replacement=False, name=None):
    return _op("multinomial", None, x, num_samples=int(num_samples),
               replacement=bool(replacement))


@_export
def poisson(x, name=None):
    return _op("poisson", None, x)


@_export
def standard_gamma(x, name=None):
    return _op("standard_gamma", None, x)


@_export
def seed(value):
    return _random.seed(value)


@_export
def get_rng_state():
    """The states of the port's generators (CPU and cards), by device."""
    return _random.get_rng_state()


@_export
def set_rng_state(state):
    _random.set_rng_state(state)


# -- thin wrappers -----------------------------------------------------------

def _unary(opname):
    def fn(x, name=None):
        return _op(opname, x)
    fn.__name__ = fn.__qualname__ = opname
    return _export(fn)


def _binary(opname):
    def fn(x, y, name=None):
        return _op(opname, x, y)
    fn.__name__ = fn.__qualname__ = opname
    return _export(fn)


_UNARY = """exp expm1 log log2 log10 log1p sqrt rsqrt abs sign sin cos tan
asin acos atan sinh cosh tanh asinh acosh atanh floor ceil round trunc frac
reciprocal square erf erfinv lgamma digamma angle conj real imag i0 i1
isnan isinf isfinite logical_not bitwise_not rint neg sigmoid
inverse det eigvals""".split()
for _n in _UNARY:
    globals()[_n] = _unary(_n)

_BINARY = """add subtract multiply divide floor_divide mod remainder maximum
minimum fmax fmin pow atan2 logaddexp nextafter copysign heaviside hypot
ldexp equal not_equal greater_than greater_equal less_than less_equal
logical_and logical_or logical_xor bitwise_and bitwise_or bitwise_xor
dot bmm mv outer inner kron equal_all""".split()
for _n in _BINARY:
    globals()[_n] = _binary(_n)

floor_mod = mod  # noqa: F821
__all__.append("floor_mod")


@_export
def divide_trunc(x, y, name=None):
    return _op("divide_trunc", x, y)


# -- math with attributes ------------------------------------------------------

@_export
def scale(x, scale=1.0, bias=0.0, bias_after_scale=True, act=None,
          name=None):
    r = _op("scale", x, scale=float(_v(scale)), bias=float(bias),
            bias_after_scale=bool(bias_after_scale))
    if act:
        r = _op(act, r)
    return r


@_export
def clip(x, min=None, max=None, name=None):
    return _op("clip", x, min=_v(min), max=_v(max))


@_export
def logit(x, eps=None, name=None):
    return _op("logit", x, eps=eps)


@_export
def stanh(x, scale_a=0.67, scale_b=1.7159, name=None):
    return _op("stanh", x, scale_a=scale_a, scale_b=scale_b)


@_export
def isclose(x, y, rtol=1e-5, atol=1e-8, equal_nan=False, name=None):
    return _op("isclose", x, y, rtol=rtol, atol=atol, equal_nan=equal_nan)


@_export
def allclose(x, y, rtol=1e-5, atol=1e-8, equal_nan=False, name=None):
    return _op("allclose", x, y, rtol=rtol, atol=atol, equal_nan=equal_nan)


@_export
def cast(x, dtype):
    return _op("cast", x, dtype=convert_dtype(dtype))


# reductions ---------------------------------------------------------------

def _reduction(opname):
    def fn(x, axis=None, keepdim=False, name=None):
        return _op(opname, x, axis=_ax(axis), keepdim=keepdim)
    fn.__name__ = fn.__qualname__ = opname
    return _export(fn)


for _n in ["mean", "max", "min", "amax", "amin", "nanmean", "logsumexp",
           "all", "any", "median"]:
    globals()[_n] = _reduction(_n)


@_export
def sum(x, axis=None, dtype=None, keepdim=False, name=None):
    return _op("sum", x, axis=_ax(axis), keepdim=keepdim, dtype=_dt(dtype))


@_export
def nansum(x, axis=None, dtype=None, keepdim=False, name=None):
    return _op("nansum", x, axis=_ax(axis), keepdim=keepdim,
               dtype=_dt(dtype))


@_export
def prod(x, axis=None, keepdim=False, dtype=None, name=None):
    return _op("prod", x, axis=_ax(axis), keepdim=keepdim, dtype=_dt(dtype))


@_export
def var(x, axis=None, unbiased=True, keepdim=False, name=None):
    return _op("var", x, axis=_ax(axis), unbiased=unbiased, keepdim=keepdim)


@_export
def std(x, axis=None, unbiased=True, keepdim=False, name=None):
    return _op("std", x, axis=_ax(axis), unbiased=unbiased, keepdim=keepdim)


@_export
def argmax(x, axis=None, keepdim=False, dtype="int64", name=None):
    return _op("argmax", x, axis=axis, keepdim=keepdim,
               dtype=convert_dtype(dtype))


@_export
def argmin(x, axis=None, keepdim=False, dtype="int64", name=None):
    return _op("argmin", x, axis=axis, keepdim=keepdim,
               dtype=convert_dtype(dtype))


@_export
def count_nonzero(x, axis=None, keepdim=False, name=None):
    return _op("count_nonzero", x, axis=_ax(axis), keepdim=keepdim)


@_export
def cumsum(x, axis=None, name=None):
    return _op("cumsum", x, axis=axis)


@_export
def cumprod(x, dim=None, name=None):
    return _op("cumprod", x, dim=dim)


@_export
def cummax(x, axis=-1, name=None):
    return _op("cummax", x, axis=axis)


@_export
def cummin(x, axis=-1, name=None):
    return _op("cummin", x, axis=axis)


@_export
def quantile(x, q, axis=None, keepdim=False, name=None):
    return _op("quantile", x, q=q, axis=_ax(axis), keepdim=keepdim)


@_export
def kthvalue(x, k, axis=-1, keepdim=False, name=None):
    return _op("kthvalue", x, k=int(k), axis=axis, keepdim=keepdim)


@_export
def trace(x, offset=0, axis1=0, axis2=1, name=None):
    return _op("trace_reduce", x, offset=offset, axis1=axis1, axis2=axis2)


# linalg -------------------------------------------------------------------

@_export
def matmul(x, y, transpose_x=False, transpose_y=False, name=None):
    return _op("matmul", x, y, transpose_x=transpose_x,
               transpose_y=transpose_y)


mm = matmul
__all__.append("mm")


@_export
def addmm(input, x, y, beta=1.0, alpha=1.0, name=None):
    return _op("addmm", input, x, y, beta=float(beta), alpha=float(alpha))


@_export
def einsum(equation, *operands):
    return _op("einsum", list(operands), equation=equation)


@_export
def norm(x, p=None, axis=None, keepdim=False, name=None):
    if p is None:
        p = "fro" if axis is None or isinstance(axis, (list, tuple)) else 2.0
    if p == "fro":
        return _op("frobenius_norm", x, axis=_ax(axis), keepdim=keepdim)
    return _op("p_norm", x, porder=float(p), axis=_ax(axis), keepdim=keepdim)


@_export
def cross(x, y, axis=None, name=None):
    return _op("cross", x, y, axis=axis)


@_export
def cholesky(x, upper=False, name=None):
    r = _op("cholesky", x)
    return transpose_last(r) if upper else r


def transpose_last(x):
    perm = list(range(x.dim()))
    perm[-1], perm[-2] = perm[-2], perm[-1]
    return _op("transpose", x, perm=tuple(perm))


@_export
def t(x, name=None):
    if x.dim() < 2:
        return x
    return _op("transpose", x, perm=(1, 0))


@_export
def histogram(x, bins=100, min=0, max=0, name=None):
    return _op("histogram", x, bins=bins, min=min, max=max)


@_export
def bincount(x, weights=None, minlength=0, name=None):
    if weights is None:
        return _op("bincount", x, minlength=minlength)
    return _op("bincount", x, weights, minlength=minlength)


@_export
def eig(x, name=None):
    return _op("eig", x)


@_export
def eigh(x, UPLO="L", name=None):
    return _op("eigh", x, UPLO=UPLO)


@_export
def eigvalsh(x, UPLO="L", name=None):
    return _op("eigvalsh", x, UPLO=UPLO)


@_export
def qr(x, mode="reduced", name=None):
    return _op("qr", x, mode=mode)


@_export
def svd(x, full_matrices=False, name=None):
    return _op("svd", x, full_matrices=full_matrices)


@_export
def lu(x, pivot=True, get_infos=False, name=None):
    lu_mat, piv = _op("lu", x)
    if get_infos:
        # the factorizations returned are the successful ones (info 0)
        info = torch.zeros(tuple(x.shape[:-2]) or (1,), dtype=torch.int32,
                           device=x.device)
        return lu_mat, piv, info
    return lu_mat, piv


@_export
def matrix_power(x, n, name=None):
    return _op("matrix_power", x, n=int(n))


@_export
def multi_dot(xs, name=None):
    return _op("multi_dot", xs)


@_export
def cond(x, p=None, name=None):
    return _op("cond", x, p=p)


@_export
def lstsq(x, y, rcond=None, driver=None, name=None):
    return _op("lstsq", x, y, rcond=rcond)


@_export
def solve(x, y, name=None):
    return _op("solve", x, y)


@_export
def pinv(x, rcond=1e-15, hermitian=False, name=None):
    return _op("pinv", x, rtol=rcond, hermitian=hermitian)


# manipulation -------------------------------------------------------------

def _shape_sig(shape):
    # -1 and 0 entries as the reference's ReshapeInferMeta reads them
    return tuple(int(_v(s)) for s in (shape if isinstance(shape, (list, tuple))
                                      else [shape]))


@_export
def reshape(x, shape, name=None):
    return _op("reshape", x, shape=_shape_sig(shape))


@_export
def transpose(x, perm, name=None):
    return _op("transpose", x, perm=tuple(perm))


@_export
def concat(x, axis=0, name=None):
    return _op("concat", list(x), axis=_ax(axis))


@_export
def stack(x, axis=0, name=None):
    return _op("stack", list(x), axis=axis)


@_export
def unstack(x, axis=0, num=None):
    return list(_op("unstack", x, axis=axis, num=num))


@_export
def split(x, num_or_sections, axis=0, name=None):
    if isinstance(num_or_sections, (list, tuple)):
        num_or_sections = tuple(int(s) for s in num_or_sections)
    return list(_op("split", x, num_or_sections=num_or_sections,
                    axis=_ax(axis)))


@_export
def chunk(x, chunks, axis=0, name=None):
    return list(_op("chunk", x, chunks=chunks, axis=_ax(axis)))


@_export
def squeeze(x, axis=None, name=None):
    return _op("squeeze", x, axis=_ax(axis))


@_export
def unsqueeze(x, axis, name=None):
    return _op("unsqueeze", x, axis=_ax(axis))


@_export
def flatten(x, start_axis=0, stop_axis=-1, name=None):
    return _op("flatten", x, start_axis=start_axis, stop_axis=stop_axis)


@_export
def gather(x, index, axis=0, name=None):
    return _op("gather", x, index, axis=_ax(axis))


@_export
def gather_nd(x, index, name=None):
    return _op("gather_nd", x, index)


@_export
def scatter(x, index, updates, overwrite=True, name=None):
    return _op("scatter", x, index, updates, overwrite=overwrite)


@_export
def scatter_nd_add(x, index, updates, name=None):
    return _op("scatter_nd_add", x, index, updates)


@_export
def scatter_nd(index, updates, shape, name=None):
    z = torch.zeros(_shape_list(shape), dtype=updates.dtype,
                    device=updates.device)
    return _op("scatter_nd_add", z, index, updates)


@_export
def index_select(x, index, axis=0, name=None):
    return _op("index_select", x, index, axis=_ax(axis))


@_export
def index_sample(x, index):
    return _op("index_sample", x, index)


@_export
def take_along_axis(arr, indices, axis):
    return _op("take_along_axis", arr, indices, axis=axis)


@_export
def put_along_axis(arr, indices, values, axis, reduce="assign"):
    if not isinstance(values, torch.Tensor):
        values = torch.as_tensor(values, dtype=arr.dtype, device=arr.device)
    return _op("put_along_axis", arr, indices, values, axis=axis,
               reduce=reduce)


@_export
def where(condition, x=None, y=None, name=None):
    if x is None and y is None:
        return nonzero(condition, as_tuple=True)
    return _op("where", condition, x, y)


@_export
def nonzero(x, as_tuple=False):
    return _op("nonzero", x, as_tuple=as_tuple)


@_export
def masked_select(x, mask, name=None):
    return _op("masked_select", x, mask)


@_export
def masked_fill(x, mask, value, name=None):
    return _op("masked_fill", x, mask, value=_v(value))


@_export
def tile(x, repeat_times, name=None):
    return _op("tile", x, repeat_times=tuple(repeat_times))


@_export
def expand(x, shape, name=None):
    return _op("expand", x, shape=_shape_sig(shape))


@_export
def broadcast_to(x, shape, name=None):
    return _op("broadcast_to", x, shape=_shape_sig(shape))


@_export
def expand_as(x, y, name=None):
    return _op("expand_as", x, y)


@_export
def broadcast_tensors(inputs, name=None):
    shape = torch.broadcast_shapes(*[tuple(t.shape) for t in inputs])
    return [broadcast_to(t, shape) for t in inputs]


@_export
def flip(x, axis, name=None):
    return _op("flip", x, axis=_ax(axis))


@_export
def roll(x, shifts, axis=None, name=None):
    return _op("roll", x, shifts=shifts if isinstance(shifts, int)
               else tuple(shifts), axis=_ax(axis))


@_export
def rot90(x, k=1, axes=(0, 1), name=None):
    return _op("rot90", x, k=k, axes=tuple(axes))


@_export
def moveaxis(x, source, destination, name=None):
    return _op("moveaxis", x, source=_ax(source),
               destination=_ax(destination))


@_export
def swapaxes(x, axis0, axis1, name=None):
    return _op("swapaxes", x, axis0=axis0, axis1=axis1)


@_export
def tril(x, diagonal=0, name=None):
    return _op("tril", x, diagonal=diagonal)


@_export
def triu(x, diagonal=0, name=None):
    return _op("triu", x, diagonal=diagonal)


@_export
def diag(x, offset=0, padding_value=0, name=None):
    return _op("diag", x, offset=offset, padding_value=padding_value)


@_export
def diagflat(x, offset=0, name=None):
    return _op("diagflat", x, offset=offset)


@_export
def diag_embed(x, offset=0, dim1=-2, dim2=-1):
    return _op("diag_embed", x, offset=offset, dim1=dim1, dim2=dim2)


@_export
def diagonal(x, offset=0, axis1=0, axis2=1, name=None):
    return _op("diagonal", x, offset=offset, axis1=axis1, axis2=axis2)


@_export
def meshgrid(*args, **kwargs):
    if len(args) == 1 and isinstance(args[0], (list, tuple)):
        args = tuple(args[0])
    return list(_op("meshgrid", list(args)))


@_export
def sort(x, axis=-1, descending=False, name=None):
    return _op("sort", x, axis=axis, descending=descending)


@_export
def argsort(x, axis=-1, descending=False, name=None):
    return _op("argsort", x, axis=axis, descending=descending)


@_export
def topk(x, k, axis=-1, largest=True, sorted=True, name=None):
    return _op("topk", x, k=int(_v(k)), axis=axis, largest=largest,
               sorted=sorted)


@_export
def searchsorted(sorted_sequence, values, out_int32=False, right=False,
                 name=None):
    return _op("searchsorted", sorted_sequence, values, out_int32=out_int32,
               right=right)


@_export
def bucketize(x, sorted_sequence, out_int32=False, right=False, name=None):
    return _op("bucketize", x, sorted_sequence, out_int32=out_int32,
               right=right)


@_export
def unique(x, return_index=False, return_inverse=False, return_counts=False,
           axis=None, dtype="int64", name=None):
    return _op("unique", x, return_index=return_index,
               return_inverse=return_inverse, return_counts=return_counts,
               axis=axis)


@_export
def unique_consecutive(x, return_inverse=False, return_counts=False,
                       axis=None, dtype="int64", name=None):
    return _op("unique_consecutive", x, return_inverse=return_inverse,
               return_counts=return_counts)


@_export
def one_hot(x, num_classes, name=None):
    return _op("one_hot", x, num_classes=int(num_classes))


@_export
def repeat_interleave(x, repeats, axis=None, name=None):
    if isinstance(repeats, torch.Tensor):
        return _op("repeat_interleave", x, repeats, axis=_ax(axis))
    return _op("repeat_interleave", x, repeats=int(repeats), axis=_ax(axis))


@_export
def slice(input, axes, starts, ends):
    return _op("slice", input, axes=tuple(axes), starts=tuple(starts),
               ends=tuple(ends))


@_export
def strided_slice(x, axes, starts, ends, strides, name=None):
    return _op("strided_slice", x, axes=tuple(axes), starts=tuple(starts),
               ends=tuple(ends), strides=tuple(strides))


@_export
def crop(x, shape=None, offsets=None, name=None):
    return _op("crop", x, shape=tuple(shape), offsets=tuple(offsets))


@_export
def as_strided(x, shape, stride, offset=0, name=None):
    return _op("as_strided", x, shape=tuple(shape), stride=tuple(stride),
               offset=offset)


@_export
def tensordot(x, y, axes=2, name=None):
    if isinstance(axes, (list, tuple)):
        axes = tuple(tuple(a) if isinstance(a, (list, tuple)) else a
                     for a in axes)
    return _op("tensordot", x, y, axes=axes)


@_export
def tolist(x):
    return x.tolist()


@_export
def is_tensor(x):
    return isinstance(x, torch.Tensor)


@_export
def rank(x):
    return torch.tensor(x.dim(), dtype=torch.int32, device=x.device)


@_export
def shape(x):
    return torch.tensor(tuple(x.shape), dtype=torch.int32, device=x.device)


@_export
def iinfo(dtype):
    return torch.iinfo(convert_dtype(dtype))


@_export
def finfo(dtype):
    return torch.finfo(convert_dtype(dtype))


# -- the rest of the reference surface ----------------------------------------

@_export
def add_n(inputs, name=None):
    if isinstance(inputs, torch.Tensor):
        return _op("assign", inputs)        # a fresh output, never an alias
    return _op("add_n", list(inputs))


@_export
def lerp(x, y, weight, name=None):
    if isinstance(weight, float):
        weight = full_like(x, weight)
    return _op("lerp", x, y, weight)


@_export
def deg2rad(x, name=None):
    return _op("deg2rad", x)


@_export
def rad2deg(x, name=None):
    return _op("rad2deg", x)


@_export
def gcd(x, y, name=None):
    return _op("gcd", x, y)


@_export
def lcm(x, y, name=None):
    return _op("lcm", x, y)


@_export
def diff(x, n=1, axis=-1, prepend=None, append=None, name=None):
    return _op("diff", x, prepend, append, n=n, axis=axis)


@_export
def dist(x, y, p=2.0, name=None):
    return _op("dist", x, y, p=float(p))


@_export
def logcumsumexp(x, axis=None, dtype=None, name=None):
    out = _op("logcumsumexp", x, axis=axis)
    if dtype is not None:
        out = _op("cast", out, dtype=dtype)
    return out


@_export
def mode(x, axis=-1, keepdim=False, name=None):
    return _op("mode", x, axis=axis, keepdim=keepdim)


@_export
def multiplex(inputs, index, name=None):
    return _op("multiplex", list(inputs), index)


@_export
def nanmedian(x, axis=None, keepdim=False, name=None):
    return _op("nanmedian", x, axis=axis, keepdim=keepdim)


@_export
def nanquantile(x, q, axis=None, keepdim=False, name=None):
    return _op("nanquantile", x, q=q, axis=axis, keepdim=keepdim)


@_export
def unbind(input, axis=0):
    return list(_op("unstack", input, axis=axis))


@_export
def cov(x, rowvar=True, ddof=True, fweights=None, aweights=None, name=None):
    return _op("cov", x, fweights, aweights, rowvar=rowvar, ddof=ddof)


@_export
def corrcoef(x, rowvar=True, name=None):
    return _op("corrcoef", x, rowvar=rowvar)


@_export
def cholesky_solve(x, y, upper=False, name=None):
    return _op("cholesky_solve", x, y, upper=upper)


@_export
def lu_unpack(x, y, unpack_ludata=True, unpack_pivots=True, name=None):
    p, l, u = _op("lu_unpack", x, y)
    # the outputs not asked for are None, as in the reference
    if not unpack_ludata:
        l = u = None
    if not unpack_pivots:
        p = None
    return p, l, u


@_export
def shard_index(input, index_num, nshards, shard_id, ignore_value=-1):
    if not 0 <= shard_id < nshards:
        raise ValueError("shard_id must be in [0, nshards)")
    return _op("shard_index", input, index_num=index_num, nshards=nshards,
               shard_id=shard_id, ignore_value=ignore_value)


@_export
def as_complex(x, name=None):
    return _op("as_complex", x)


@_export
def as_real(x, name=None):
    return _op("as_real", x)


@_export
def complex(real, imag, name=None):
    return _op("make_complex", real, imag)


def _dtype_of(x):
    return x.dtype if isinstance(x, torch.Tensor) \
        else torch.as_tensor(x).dtype


@_export
def is_complex(x):
    return _dtype_of(x).is_complex


@_export
def is_floating_point(x):
    return _dtype_of(x).is_floating_point


@_export
def is_integer(x):
    d = _dtype_of(x)
    return not (d.is_floating_point or d.is_complex or d == torch.bool)


@_export
def is_empty(x, name=None):
    return torch.tensor(x.numel() == 0, device=x.device)


@_export
def increment(x, value=1.0, name=None):
    out = _op("scale", x, scale=1.0, bias=float(value))
    with torch.no_grad():
        x.copy_(out)
    return x


@_export
def randint_like(x, low=0, high=None, dtype=None, name=None):
    out = _op("randint_like", x, None, low=low, high=high)
    # dtype defaults to x's, as in the reference
    return _op("cast", out, dtype=dtype if dtype is not None else x.dtype)


@_export
def broadcast_shape(x_shape, y_shape):
    return list(np.broadcast_shapes(tuple(x_shape), tuple(y_shape)))


@_export
def set_printoptions(precision=None, threshold=None, edgeitems=None,
                     sci_mode=None, linewidth=None):
    torch.set_printoptions(precision=precision, threshold=threshold,
                           edgeitems=edgeitems, linewidth=linewidth,
                           sci_mode=sci_mode)


# the tensor-array facade: a plain list, as the JAX package keeps it

@_export
def create_array(dtype="float32", initialized_list=None):
    return list(initialized_list) if initialized_list is not None else []


@_export
def array_write(x, i, array=None):
    idx = int(_v(i))
    if array is None:
        array = []
    while len(array) <= idx:
        array.append(None)
    array[idx] = x
    return array


@_export
def array_read(array, i):
    return array[int(_v(i))]


@_export
def array_length(array):
    return torch.tensor(len(array), dtype=torch.int64)


@_export
def reverse(x, axis, name=None):
    return flip(x, axis)


@_export
def renorm(x, p, axis, max_norm, name=None):
    """Scale each slice along ``axis`` whose p-norm exceeds ``max_norm``
    down to it (ops that autograd follows, so the gradient holds the
    scale's dependence on x)."""
    nd = x.dim()
    if not -nd <= axis < nd:
        raise ValueError(f"renorm: axis {axis} out of range for rank {nd}")
    red = tuple(i for i in range(nd) if i != axis % nd)
    norms = _op("pow", _op("sum", _op("pow", _op("abs", x), float(p)),
                           axis=red, keepdim=True), 1.0 / float(p))
    eps = _op("full_like", norms, fill_value=1e-12)
    ratio = _op("divide", _op("full_like", norms,
                              fill_value=float(max_norm)),
                _op("maximum", norms, eps))
    one = _op("full_like", norms, fill_value=1.0)
    return _op("multiply", x, _op("minimum", ratio, one))


@_export
def tril_indices(row, col=None, offset=0, dtype="int64", *, device=None):
    col = row if col is None else col
    return torch.tril_indices(int(row), int(col), int(offset),
                              dtype=convert_dtype(dtype),
                              device=to_torch_device(device))


@_export
def triu_indices(row, col=None, offset=0, dtype="int64", *, device=None):
    col = row if col is None else col
    return torch.triu_indices(int(row), int(col), int(offset),
                              dtype=convert_dtype(dtype),
                              device=to_torch_device(device))


@_export
def create_parameter(shape, dtype="float32", name=None, attr=None,
                     is_bias=False, default_initializer=None):
    """A free-standing parameter, initialised as ``Layer.
    create_parameter`` initialises one (``attr`` > the global
    initializer > ``default_initializer`` > the built-in default)."""
    from ..nn.layer.layers import ParamAttr, make_parameter
    attr = ParamAttr._to_attr(attr)
    if attr is not False and name is not None and attr.name is None:
        attr.name = name
    return make_parameter(shape, attr, dtype, is_bias, default_initializer)


@_export
def disable_signal_handler():
    """Without effect, as in the JAX package: Python's own handlers stay."""
    return None


@_export
def check_shape(shape):
    if isinstance(shape, torch.Tensor):
        return
    for s in shape:
        if not isinstance(s, (int, np.integer)) or (s < 0 and s != -1):
            raise ValueError(f"invalid shape entry {s!r} in {shape}")


def _inplace_alias(fn_name, base_fn):
    def f(x, *args, **kwargs):
        out = base_fn(x, *args, **kwargs)
        with torch.no_grad():
            if out.shape == x.shape:
                x.copy_(out)
            else:
                x.set_(out.detach().clone())
        return x
    f.__name__ = f.__qualname__ = fn_name
    return _export(f)


reshape_ = _inplace_alias("reshape_", reshape)
squeeze_ = _inplace_alias("squeeze_", squeeze)
unsqueeze_ = _inplace_alias("unsqueeze_", unsqueeze)
tanh_ = _inplace_alias("tanh_", tanh)  # noqa: F821
scatter_ = _inplace_alias("scatter_", scatter)

del _n
