"""The remaining tensor-op families (counterpart of
``paddle_tpu/ops/extra_math_ops.py``): complex views, statistics, numeric
utilities, LU unpack, sharding helpers. ``randint_like`` takes a
``torch.Generator`` where the JAX op takes a key (by default the port's
generator of ``x``'s device)."""
from __future__ import annotations

import torch

from ..framework.random import get_generator
from .math_ops import reduce_over
from .registry import register_op


@register_op("add_n")
def _add_n(inputs):
    out = inputs[0]
    for x in inputs[1:]:
        out = out + x
    return out


@register_op("lerp")
def _lerp(x, y, weight):
    return x + weight * (y - x)


@register_op("deg2rad")
def _deg2rad(x):
    return torch.deg2rad(x)


@register_op("rad2deg")
def _rad2deg(x):
    return torch.rad2deg(x)


@register_op("gcd")
def _gcd(x, y):
    return torch.gcd(x, y)


@register_op("lcm")
def _lcm(x, y):
    return torch.lcm(x, y)


def _edge(v, x, axis):
    """``prepend``/``append`` as numpy takes them: a scalar is broadcast
    to a slice of ``x`` one long along ``axis``."""
    if v is None:
        return None
    v = torch.as_tensor(v, dtype=x.dtype, device=x.device)
    if v.dim() == 0:
        shape = list(x.shape)
        shape[axis] = 1
        v = v.expand(shape)
    return v


@register_op("diff")
def _diff(x, prepend=None, append=None, n=1, axis=-1):
    axis = axis % x.dim()
    return torch.diff(x, n=n, dim=axis, prepend=_edge(prepend, x, axis),
                      append=_edge(append, x, axis))


@register_op("dist")
def _dist(x, y, p=2.0):
    d = (x - y).reshape(-1)
    p = float(p)
    if p == float("inf"):
        return d.abs().max()
    if p == float("-inf"):
        return d.abs().min()
    if p == 0:
        return (d != 0).sum().to(x.dtype)
    return (d.abs() ** p).sum() ** (1.0 / p)


@register_op("logcumsumexp")
def _logcumsumexp(x, axis=None):
    if axis is None:
        x, axis = x.reshape(-1), 0
    return torch.logcumsumexp(x, int(axis))


@register_op("mode")
def _mode(x, axis=-1, keepdim=False):
    """The most frequent value along ``axis``, ties to the largest value,
    with the index of its last occurrence (the JAX op's rule)."""
    ax = axis % x.dim()
    xs = x.movedim(ax, -1)
    n = xs.shape[-1]
    counts = (xs[..., :, None] == xs[..., None, :]).sum(-1)
    best = counts.max(-1, keepdim=True).values
    low = torch.finfo(x.dtype).min if x.is_floating_point() \
        else torch.iinfo(x.dtype).min
    values = torch.where(counts == best, xs,
                         torch.full_like(xs, low)).max(-1).values
    eq = xs == values[..., None]
    idx = (n - 1) - eq.flip(-1).to(torch.int8).argmax(-1)
    if keepdim:
        values, idx = values.unsqueeze(ax), idx.unsqueeze(ax)
    return values, idx.to(torch.int64)


@register_op("multiplex")
def _multiplex(inputs, index):
    stacked = torch.stack(list(inputs))               # [K, N, ...]
    idx = index.reshape(-1).long()                    # [N]
    rows = torch.arange(stacked.shape[1], device=stacked.device)
    return stacked[idx, rows]


def _nanmedian_last(t):
    return torch.nanquantile(t, 0.5, dim=-1)


@register_op("nanmedian")
def _nanmedian(x, axis=None, keepdim=False):
    xf = x if x.is_floating_point() else x.float()
    return reduce_over(xf, axis, keepdim, _nanmedian_last).to(x.dtype)


@register_op("nanquantile")
def _nanquantile(x, q, axis=None, keepdim=False):
    x = x.double() if x.dtype == torch.float64 else x.float()
    qt = torch.as_tensor(q, dtype=x.dtype, device=x.device)

    def fn(t):
        out = torch.nanquantile(t, qt, dim=-1)
        return out.movedim(0, -1) if qt.dim() else out

    out = reduce_over(x, axis, keepdim, fn)
    return out.movedim(-1, 0) if qt.dim() else out


@register_op("cov")
def _cov(x, fweights=None, aweights=None, rowvar=True, ddof=True):
    xs = x if rowvar or x.dim() < 2 else x.t()
    out = torch.cov(xs, correction=1 if ddof else 0, fweights=fweights,
                    aweights=aweights)
    return out.to(x.dtype)


@register_op("corrcoef")
def _corrcoef(x, rowvar=True):
    xs = x if rowvar or x.dim() < 2 else x.t()
    return torch.corrcoef(xs).to(x.dtype)


@register_op("lu_unpack")
def _lu_unpack(lu_mat, pivots, unpack_ludata=True, unpack_pivots=True):
    p, l, u = torch.lu_unpack(lu_mat, pivots.to(torch.int32))
    return p, l, u


@register_op("shard_index")
def _shard_index(x, index_num, nshards, shard_id, ignore_value=-1):
    shard_size = (index_num + nshards - 1) // nshards
    in_shard = torch.div(x, shard_size, rounding_mode="floor") == shard_id
    return torch.where(in_shard, torch.remainder(x, shard_size),
                       torch.full_like(x, ignore_value)).to(torch.int64)


@register_op("as_complex")
def _as_complex(x):
    return torch.complex(x[..., 0], x[..., 1])


@register_op("as_real")
def _as_real(x):
    return torch.stack([torch.real(x), torch.imag(x)], dim=-1)


@register_op("make_complex")
def _make_complex(real, imag):
    return torch.complex(real, imag)


@register_op("randint_like")
def _randint_like(x, generator=None, low=0, high=None):
    if high is None:
        low, high = 0, low
    gen = generator if generator is not None else get_generator(x.device)
    return torch.randint(int(low), int(high), tuple(x.shape),
                         generator=gen, device=x.device, dtype=torch.int64)
