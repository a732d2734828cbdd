"""Elementwise math, reduction and comparison ops (counterpart of
``paddle_tpu/ops/math_ops.py``): each op's plain PyTorch body, under the
JAX op's name and attributes, with the JAX op's dtypes (a bool or
integer ``sum``/``prod`` widens to int64, ``cumsum`` keeps the input's
dtype, an index comes back int64)."""
from __future__ import annotations

import torch

from ..framework.dtypes import convert_dtype
from .registry import register_op

__all__ = ["norm_axis", "reduce_over"]


def _t(x, like=None):
    """A Python scalar beside a tensor as a tensor of that tensor's
    device (its dtype follows torch's promotion with the other operand)."""
    if isinstance(x, torch.Tensor):
        return x
    device = like.device if isinstance(like, torch.Tensor) else None
    return torch.as_tensor(x, device=device)


def _binary(fn):
    def op(x, y):
        return fn(_t(x, y), _t(y, x))
    return op


# -- binary elementwise -----------------------------------------------------

for _name, _fn in {
    "add": torch.add,
    "subtract": torch.subtract,
    "multiply": torch.mul,
    "divide": torch.true_divide,
    "floor_divide": torch.floor_divide,
    "mod": torch.remainder,
    "remainder": torch.remainder,
    "maximum": torch.maximum,
    "minimum": torch.minimum,
    "fmax": torch.fmax,
    "fmin": torch.fmin,
    "atan2": torch.atan2,
    "logaddexp": torch.logaddexp,
    "nextafter": torch.nextafter,
    "copysign": torch.copysign,
    "heaviside": torch.heaviside,
    "hypot": torch.hypot,
    "ldexp": torch.ldexp,
    "pow": torch.pow,
}.items():
    register_op(_name)(_binary(_fn))


@register_op("divide_trunc")
def _divide_trunc(x, y):
    x, y = _t(x, y), _t(y, x)
    return torch.trunc(torch.true_divide(x, y)).to(
        torch.result_type(x, y))


# -- unary elementwise ------------------------------------------------------

def _frac(x):
    return x - torch.trunc(x)


def _neg(x):
    return torch.logical_not(x) if x.dtype == torch.bool else torch.neg(x)


for _name, _fn in {
    "exp": torch.exp, "expm1": torch.expm1, "log": torch.log,
    "log2": torch.log2, "log10": torch.log10, "log1p": torch.log1p,
    "sqrt": torch.sqrt, "rsqrt": torch.rsqrt, "abs": torch.abs,
    "sign": torch.sign, "sin": torch.sin, "cos": torch.cos,
    "tan": torch.tan, "asin": torch.asin, "acos": torch.acos,
    "atan": torch.atan, "sinh": torch.sinh, "cosh": torch.cosh,
    "tanh": torch.tanh, "asinh": torch.asinh, "acosh": torch.acosh,
    "atanh": torch.atanh, "floor": torch.floor, "ceil": torch.ceil,
    "round": torch.round, "trunc": torch.trunc, "frac": _frac,
    "reciprocal": torch.reciprocal, "square": torch.square, "neg": _neg,
    "erf": torch.erf, "erfinv": torch.erfinv, "lgamma": torch.lgamma,
    "digamma": torch.digamma, "i0": torch.i0,
    "i1": torch.special.i1, "sigmoid": torch.sigmoid,
    "logit_raw": torch.logit,
}.items():
    register_op(_name)(_fn)


@register_op("conj")
def _conj(x):
    # a materialised conjugate: torch's is a lazy view
    return torch.conj_physical(x) if x.is_complex() else x


@register_op("real")
def _real(x):
    return torch.real(x) if x.is_complex() else x


@register_op("imag")
def _imag(x):
    return torch.imag(x) if x.is_complex() else torch.zeros_like(x)


@register_op("angle")
def _angle(x):
    return torch.angle(x)


def _in_dtype(value, dtype):
    """A Python number rounded to ``dtype`` on the host, as the JAX op's
    ``jnp.asarray(value, x.dtype)`` rounds it (no copy to the card)."""
    return torch.tensor(value, dtype=dtype).item()


@register_op("scale")
def _scale(x, scale=1.0, bias=0.0, bias_after_scale=True):
    s, b = _in_dtype(scale, x.dtype), _in_dtype(bias, x.dtype)
    return x * s + b if bias_after_scale else (x + b) * s


@register_op("clip")
def _clip(x, min=None, max=None):
    if min is None and max is None:
        return x.clone()
    return torch.clamp(x, min, max)


@register_op("logit")
def _logit(x, eps=None):
    if eps:
        x = torch.clamp(x, eps, 1.0 - eps)
    return torch.logit(x)


@register_op("stanh")
def _stanh(x, scale_a=0.67, scale_b=1.7159):
    return scale_b * torch.tanh(scale_a * x)


@register_op("rint")
def _rint(x):
    return torch.round(x)


# -- predicates ---------------------------------------------------------------

def _bitwise_not(x):
    return torch.logical_not(x) if x.dtype == torch.bool \
        else torch.bitwise_not(x)


for _name, _fn in {
    "equal": torch.eq, "not_equal": torch.ne,
    "greater_than": torch.gt, "greater_equal": torch.ge,
    "less_than": torch.lt, "less_equal": torch.le,
    "logical_and": torch.logical_and, "logical_or": torch.logical_or,
    "logical_xor": torch.logical_xor,
    "bitwise_and": torch.bitwise_and, "bitwise_or": torch.bitwise_or,
    "bitwise_xor": torch.bitwise_xor,
}.items():
    register_op(_name)(_binary(_fn))

for _name, _fn in {
    "isnan": torch.isnan, "isinf": torch.isinf, "isfinite": torch.isfinite,
    "logical_not": torch.logical_not, "bitwise_not": _bitwise_not,
    "signbit": torch.signbit,
}.items():
    register_op(_name)(_fn)


@register_op("isclose")
def _isclose(x, y, rtol=1e-5, atol=1e-8, equal_nan=False):
    return torch.isclose(x, y, rtol=rtol, atol=atol, equal_nan=equal_nan)


@register_op("allclose")
def _allclose(x, y, rtol=1e-5, atol=1e-8, equal_nan=False):
    # a 0-d bool tensor on the operands' device (no host read)
    return torch.isclose(x, y, rtol=rtol, atol=atol,
                         equal_nan=equal_nan).all()


@register_op("equal_all")
def _equal_all(x, y):
    if x.shape != y.shape:
        return torch.zeros((), dtype=torch.bool, device=x.device)
    return torch.eq(x, y).all()


# -- reductions ---------------------------------------------------------------

def norm_axis(axis, ndim):
    """The JAX ``_norm_axis`` as a tuple of non-negative dims (all the dims
    for ``None``)."""
    if axis is None:
        return tuple(range(ndim))
    if isinstance(axis, (list, tuple)):
        return tuple(int(a) % max(ndim, 1) for a in axis)
    return (int(axis) % max(ndim, 1),)


def reduce_over(x, axis, keepdim, fn):
    """``fn(t)`` reduces the last dim of ``t``: applied to ``x`` with the
    dims of ``axis`` moved last and flattened into one, so reductions that
    take one dim (median, quantile, mode) take any set of them."""
    dims = norm_axis(axis, x.dim())
    if x.dim() == 0:
        return fn(x.reshape(1))
    rest = [d for d in range(x.dim()) if d not in dims]
    moved = x.permute(*rest, *dims)
    flat = moved.reshape(*[x.shape[d] for d in rest], -1)
    out = fn(flat)
    if keepdim:
        shape = [1 if d in dims else x.shape[d] for d in range(x.dim())]
        out = out.reshape(shape)
    return out


def _dims(axis, x):
    return None if axis is None else norm_axis(axis, x.dim())


@register_op("sum")
def _sum(x, axis=None, keepdim=False, dtype=None):
    if dtype is not None:
        dtype = convert_dtype(dtype)
    elif x.dtype == torch.bool or not (x.is_floating_point()
                                       or x.is_complex()):
        dtype = torch.int64
    dims = _dims(axis, x)
    if dims is None:
        out = torch.sum(x, dtype=dtype)
        return out.reshape([1] * x.dim()) if keepdim else out
    return torch.sum(x, dim=dims, keepdim=keepdim, dtype=dtype)


@register_op("mean")
def _mean(x, axis=None, keepdim=False):
    if not (x.is_floating_point() or x.is_complex()):
        x = x.float()
    dims = _dims(axis, x)
    return torch.mean(x, dim=dims, keepdim=keepdim)


def _extreme(fn):
    def op(x, axis=None, keepdim=False):
        dims = _dims(axis, x)
        if dims is None:
            out = fn(x)
            return out.reshape([1] * x.dim()) if keepdim else out
        return fn(x, dim=dims, keepdim=keepdim)
    return op


for _name, _fn in {"max": torch.amax, "min": torch.amin,
                   "amax": torch.amax, "amin": torch.amin}.items():
    register_op(_name)(_extreme(_fn))


@register_op("prod")
def _prod(x, axis=None, keepdim=False, dtype=None):
    if dtype is not None:
        dtype = convert_dtype(dtype)
    elif not (x.is_floating_point() or x.is_complex()):
        dtype = torch.int64
    if dtype is not None:
        x = x.to(dtype)
    return reduce_over(x, axis, keepdim, lambda t: torch.prod(t, -1))


@register_op("nansum")
def _nansum(x, axis=None, keepdim=False, dtype=None):
    dims = _dims(axis, x)
    dt = None if dtype is None else convert_dtype(dtype)
    if dims is None:
        out = torch.nansum(x, dtype=dt)
        return out.reshape([1] * x.dim()) if keepdim else out
    return torch.nansum(x, dim=dims, keepdim=keepdim, dtype=dt)


@register_op("nanmean")
def _nanmean(x, axis=None, keepdim=False):
    return torch.nanmean(x, dim=_dims(axis, x), keepdim=keepdim)


@register_op("all")
def _all(x, axis=None, keepdim=False):
    return reduce_over(x.bool(), axis, keepdim, lambda t: t.all(-1))


@register_op("any")
def _any(x, axis=None, keepdim=False):
    return reduce_over(x.bool(), axis, keepdim, lambda t: t.any(-1))


def _arg(fn):
    def op(x, axis=None, keepdim=False, dtype="int64"):
        if axis is None:
            r = fn(x.reshape(-1), dim=0)
        else:
            r = fn(x, dim=int(axis), keepdim=keepdim)
        return r.to(convert_dtype(dtype))
    return op


register_op("argmax")(_arg(torch.argmax))
register_op("argmin")(_arg(torch.argmin))


@register_op("logsumexp")
def _logsumexp(x, axis=None, keepdim=False):
    return torch.logsumexp(x, dim=norm_axis(axis, x.dim()), keepdim=keepdim)


@register_op("cumsum")
def _cumsum(x, axis=None):
    # in x's dtype: torch would widen an integer sum to int64
    if axis is None:
        return torch.cumsum(x.reshape(-1), 0, dtype=x.dtype)
    return torch.cumsum(x, int(axis), dtype=x.dtype)


@register_op("cumprod")
def _cumprod(x, dim=None):
    if dim is None:
        return torch.cumprod(x.reshape(-1), 0, dtype=x.dtype)
    return torch.cumprod(x, int(dim), dtype=x.dtype)


@register_op("cummax")
def _cummax(x, axis=-1):
    return torch.cummax(x, int(axis)).values


@register_op("cummin")
def _cummin(x, axis=-1):
    return torch.cummin(x, int(axis)).values


def _median_last(t):
    # numpy's median: the mean of the two middle values for an even count;
    # NaN when the row holds one
    n = t.shape[-1]
    s = torch.sort(t, dim=-1).values
    mid = (s[..., (n - 1) // 2] + s[..., n // 2]) / 2
    return torch.where(torch.isnan(t).any(-1),
                       torch.full_like(mid, float("nan")), mid)


@register_op("median")
def _median(x, axis=None, keepdim=False):
    if not x.is_floating_point():
        x = x.float()
    return reduce_over(x, axis, keepdim, _median_last)


def _q_tensor(q, like):
    return torch.as_tensor(q, dtype=like.dtype, device=like.device)


@register_op("quantile")
def _quantile(x, q, axis=None, keepdim=False):
    qt = _q_tensor(q, x)

    def fn(t):
        out = torch.quantile(t, qt, dim=-1)
        return out.movedim(0, -1) if qt.dim() else out

    out = reduce_over(x, axis, keepdim, fn)
    return out.movedim(-1, 0) if qt.dim() else out


@register_op("count_nonzero")
def _count_nonzero(x, axis=None, keepdim=False):
    return _sum(x != 0, axis, keepdim)


def _var_like(fn):
    def op(x, axis=None, unbiased=True, keepdim=False):
        if not (x.is_floating_point() or x.is_complex()):
            x = x.float()
        return fn(x, dim=_dims(axis, x), correction=1 if unbiased else 0,
                  keepdim=keepdim)
    return op


register_op("var")(_var_like(torch.var))
register_op("std")(_var_like(torch.std))


@register_op("kthvalue")
def _kthvalue(x, k, axis=-1, keepdim=False):
    # the k-th of a stable ascending sort, as the JAX op takes it
    axis = int(axis) % x.dim()
    idx = torch.argsort(x, dim=axis, stable=True)
    vals = torch.gather(x, axis, idx)
    taken = vals.select(axis, int(k) - 1)
    itaken = idx.select(axis, int(k) - 1)
    if keepdim:
        taken, itaken = taken.unsqueeze(axis), itaken.unsqueeze(axis)
    return taken, itaken


@register_op("trace_reduce")
def _trace(x, offset=0, axis1=0, axis2=1):
    return torch.diagonal(x, offset, axis1, axis2).sum(-1)
