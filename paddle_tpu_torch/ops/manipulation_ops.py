"""Shape and layout manipulation, indexing, search and sort ops
(counterpart of ``paddle_tpu/ops/manipulation_ops.py``).

``setitem`` returns a new tensor, as the JAX op does (``x.at[idx].set``):
it never writes into its input. ``_decode_index`` is the port's own copy
of the JAX helper that turns an encoded index spec back into an index.
Ties order as the JAX ops order them: ``sort``/``argsort`` are stable
and ``descending=True`` flips the ascending order; ``topk`` keeps the
lower index first (``lax.top_k``).
"""
from __future__ import annotations

import torch
from torch.nn import functional as TF

from ..framework.dtypes import convert_dtype
from .registry import register_op


@register_op("reshape")
def _reshape(x, shape):
    # a 0 in the target copies the input's dim at that position
    shape = tuple(x.shape[i] if d == 0 and i < x.dim() else d
                  for i, d in enumerate(shape))
    return torch.reshape(x, shape)


@register_op("transpose")
def _transpose(x, perm):
    return x.permute(tuple(perm))


@register_op("concat")
def _concat(xs, axis=0):
    return torch.cat(list(xs), dim=int(axis))


@register_op("stack")
def _stack(xs, axis=0):
    return torch.stack(list(xs), dim=int(axis))


@register_op("unstack")
def _unstack(x, axis=0, num=None):
    return tuple(torch.unbind(x, dim=int(axis)))


@register_op("split")
def _split(x, num_or_sections, axis=0):
    axis = int(axis)
    if isinstance(num_or_sections, int):
        if x.shape[axis] % num_or_sections:
            raise ValueError(
                f"split: axis {axis} of size {x.shape[axis]} does not "
                f"divide into {num_or_sections} equal sections")
        return tuple(torch.chunk(x, num_or_sections, dim=axis))
    sections = list(num_or_sections)
    # one -1 entry takes the rest, as in the reference
    if -1 in sections:
        known = sum(s for s in sections if s != -1)
        sections[sections.index(-1)] = x.shape[axis] - known
    return tuple(torch.split(x, sections, dim=axis))


@register_op("squeeze")
def _squeeze(x, axis=None):
    if axis is None:
        return torch.squeeze(x)
    axes = axis if isinstance(axis, (list, tuple)) else [axis]
    dims = tuple(a % x.dim() for a in axes if x.shape[a] == 1)
    return torch.squeeze(x, dims) if dims else x


@register_op("unsqueeze")
def _unsqueeze(x, axis):
    if isinstance(axis, (list, tuple)):
        out = x
        for a in sorted(axis):
            out = torch.unsqueeze(out, a)
        return out
    return torch.unsqueeze(x, int(axis))


@register_op("flatten")
def _flatten(x, start_axis=0, stop_axis=-1):
    if x.dim() == 0:
        return x.reshape(1)
    return torch.flatten(x, start_axis % x.dim(), stop_axis % x.dim())


def _take(x, idx, axis):
    """``jnp.take`` along ``axis`` with an index of any rank."""
    out = torch.index_select(x, axis, idx.reshape(-1).long())
    return out.reshape(*x.shape[:axis], *idx.shape, *x.shape[axis + 1:])


@register_op("gather")
def _gather(x, index, axis=0):
    idx = index if index.dim() else index[None]
    return _take(x, idx, int(axis) % x.dim())


@register_op("gather_nd")
def _gather_nd(x, index):
    # index[..., k] indexes the first k dims of x
    return x[tuple(index.long().movedim(-1, 0))]


@register_op("scatter")
def _scatter(x, index, updates, overwrite=True):
    idx = index.reshape(-1).long()
    if overwrite:
        return x.index_put((idx,), updates)
    # overwrite=False: zero the rows, then accumulate
    zeroed = x.index_put((idx,), torch.zeros_like(updates))
    return zeroed.index_put((idx,), updates, accumulate=True)


@register_op("scatter_nd_add")
def _scatter_nd_add(x, index, updates):
    return x.index_put(tuple(index.long().movedim(-1, 0)), updates,
                       accumulate=True)


@register_op("index_select")
def _index_select(x, index, axis=0):
    return _take(x, index, int(axis) % x.dim())


@register_op("index_sample")
def _index_sample(x, index):
    return torch.gather(x, 1, index.long())


@register_op("take_along_axis")
def _take_along_axis(x, indices, axis):
    return torch.take_along_dim(x, indices.long(), dim=int(axis))


@register_op("put_along_axis")
def _put_along_axis(x, indices, values, axis, reduce="assign"):
    """``reduce``: ``"assign"`` sets, ``"add"`` adds, ``"multiply"``
    (or ``"mul"``) multiplies. (The JAX op's ``"add"`` goes through
    ``jnp.put_along_axis``, which sets: there ``"add"`` assigns.)"""
    axis = int(axis) % x.dim()
    idx = indices.long()
    v = torch.as_tensor(values, dtype=x.dtype, device=x.device).expand(
        idx.shape).contiguous()
    if reduce == "add":
        return x.scatter_add(axis, idx, v)
    if reduce in ("multiply", "mul"):
        return x.scatter_reduce(axis, idx, v, "prod")
    return x.scatter(axis, idx, v)


@register_op("where")
def _where(cond, x, y):
    return torch.where(cond, x, y)


@register_op("nonzero")
def _nonzero(x, as_tuple=False):
    nz = torch.nonzero(x)
    if as_tuple:
        return tuple(nz[:, i:i + 1] for i in range(nz.shape[1]))
    return nz


@register_op("masked_select")
def _masked_select(x, mask):
    return x[mask]


def _leading_mask(mask, ndim):
    """A leading-dims mask for broadcasting against the trailing-aligned
    ``where`` (``x[mask]`` aligns the mask with x's leading axes)."""
    return mask.reshape(*mask.shape, *([1] * (ndim - mask.dim())))


@register_op("masked_fill")
def _masked_fill(x, mask, value):
    return x.masked_fill(_leading_mask(mask, x.dim()), value)


@register_op("tile")
def _tile(x, repeat_times):
    return torch.tile(x, tuple(repeat_times))


@register_op("expand")
def _expand(x, shape):
    shape = tuple(s if s != -1 else x.shape[i - (len(shape) - x.dim())]
                  for i, s in enumerate(shape))
    return torch.broadcast_to(x, shape)


@register_op("broadcast_to")
def _broadcast_to(x, shape):
    return torch.broadcast_to(x, tuple(shape))


@register_op("expand_as")
def _expand_as(x, y):
    return torch.broadcast_to(x, y.shape)


@register_op("flip")
def _flip(x, axis):
    if isinstance(axis, int):
        axis = [axis]
    return torch.flip(x, tuple(axis))


@register_op("roll")
def _roll(x, shifts, axis=None):
    if axis is None:
        return torch.roll(x, shifts)
    return torch.roll(x, shifts, axis)


@register_op("rot90")
def _rot90(x, k=1, axes=(0, 1)):
    return torch.rot90(x, k, tuple(axes))


def _pad_index(n, lo, hi, mode, device):
    """The source index of every output position of one padded dim, as
    ``np.pad``'s ``reflect``/``edge``/``wrap`` modes pick it."""
    pos = torch.arange(-lo, n + hi, device=device)
    if mode == "edge":
        return pos.clamp(0, n - 1)
    if mode == "wrap":
        return torch.remainder(pos, n)
    period = 2 * (n - 1) if n > 1 else 1        # reflect, edge not repeated
    r = torch.remainder(pos.abs(), period)
    return torch.where(r >= n, period - r, r)


@register_op("pad")
def _pad(x, pad, mode="constant", value=0.0, data_format="NCHW"):
    # ``pad`` is a flat list in the reference's order
    nd = x.dim()
    if len(pad) == 2 * nd:
        widths = [(pad[2 * i], pad[2 * i + 1]) for i in range(nd)]
    else:
        # a partial spec pads the trailing spatial dims, the last first:
        # [left, right, top, bottom] pads W by (left, right), then H
        n_spatial = len(pad) // 2
        widths = [(0, 0)] * nd
        if data_format.startswith("N") and data_format[1] == "C":
            start = 2
        elif data_format.startswith("N"):
            start = 1
        else:
            start = nd - n_spatial
        for i in range(n_spatial):
            widths[start + n_spatial - 1 - i] = (pad[2 * i], pad[2 * i + 1])
    if mode == "constant":
        flat = [w for lo_hi in reversed(widths) for w in lo_hi]
        return TF.pad(x, flat, mode="constant", value=value)
    kind = {"reflect": "reflect", "replicate": "edge",
            "circular": "wrap"}[mode]
    out = x
    for d, (lo, hi) in enumerate(widths):
        if lo or hi:
            out = torch.index_select(
                out, d, _pad_index(x.shape[d], lo, hi, kind, x.device))
    return out


@register_op("chunk")
def _chunk(x, chunks, axis=0):
    # np.array_split: the first (n % chunks) pieces one longer
    return tuple(torch.tensor_split(x, int(chunks), dim=int(axis)))


@register_op("unique")
def _unique(x, return_index=False, return_inverse=False,
            return_counts=False, axis=None):
    vals, inverse, counts = torch.unique(
        x, sorted=True, return_inverse=True, return_counts=True, dim=axis)
    out = [vals]
    if return_index:
        n = x.shape[axis] if axis is not None else x.numel()
        inv = inverse.reshape(-1) if axis is None else inverse
        first = torch.full((vals.shape[0] if axis is None
                            else vals.shape[axis],), n, dtype=torch.int64,
                           device=x.device)
        first = first.scatter_reduce(0, inv, torch.arange(
            n, device=x.device), "amin")
        out.append(first)
    if return_inverse:
        out.append(inverse)
    if return_counts:
        out.append(counts)
    return out[0] if len(out) == 1 else tuple(out)


@register_op("unique_consecutive")
def _unique_consecutive(x, return_inverse=False, return_counts=False):
    vals, inverse, counts = torch.unique_consecutive(
        x, return_inverse=True, return_counts=True)
    out = [vals]
    if return_inverse:
        out.append(inverse)
    if return_counts:
        out.append(counts)
    return out[0] if len(out) == 1 else tuple(out)


@register_op("sort")
def _sort(x, axis=-1, descending=False, stable=True):
    r = torch.sort(x, dim=int(axis), stable=True).values
    return torch.flip(r, (int(axis),)) if descending else r


@register_op("argsort")
def _argsort(x, axis=-1, descending=False, stable=True):
    r = torch.argsort(x, dim=int(axis), stable=True)
    return torch.flip(r, (int(axis),)) if descending else r


@register_op("topk")
def _topk(x, k, axis=-1, largest=True, sorted=True):
    # a stable sort keeps ties in index order, as lax.top_k does
    axis = int(axis) % x.dim()
    r = torch.sort(x, dim=axis, descending=bool(largest), stable=True)
    return (r.values.narrow(axis, 0, int(k)),
            r.indices.narrow(axis, 0, int(k)))


@register_op("searchsorted")
def _searchsorted(sorted_sequence, values, out_int32=False, right=False):
    if sorted_sequence.dim() > 1:
        lead = sorted_sequence.shape[:-1]
        values = values.reshape(*lead, -1)
    return torch.searchsorted(sorted_sequence, values, right=right,
                              out_int32=out_int32)


@register_op("bucketize")
def _bucketize(x, sorted_sequence, out_int32=False, right=False):
    return torch.bucketize(x, sorted_sequence, out_int32=out_int32,
                           right=right)


@register_op("one_hot")
def _one_hot(x, num_classes, dtype="float32"):
    # out-of-range ids give a zero row, as jax.nn.one_hot
    classes = torch.arange(int(num_classes), device=x.device)
    return (x[..., None] == classes).to(convert_dtype(dtype))


@register_op("repeat_interleave")
def _repeat_interleave(x, repeats, axis=None):
    if axis is None:
        x, axis = x.reshape(-1), 0
    return torch.repeat_interleave(x, repeats, dim=int(axis))


def _decode_index(spec, arrays):
    """The index an encoded spec describes (the JAX package's
    ``_decode_index``): ``("slice", start, stop, step)``, ``("int", i)``,
    ``("none",)``, ``("ellipsis",)``, ``("array",)`` (the next of
    ``arrays``) and ``("tuple", items)``."""
    out = []
    for item in spec:
        kind = item[0]
        if kind == "slice":
            out.append(slice(item[1], item[2], item[3]))
        elif kind == "int":
            out.append(item[1])
        elif kind == "none":
            out.append(None)
        elif kind == "ellipsis":
            out.append(Ellipsis)
        elif kind == "array":
            a = arrays.pop(0)
            out.append(a.long() if not a.dtype == torch.bool else a)
        elif kind == "tuple":
            out.append(tuple(item[1]))
    return tuple(out)


def _neg_step(i):
    return isinstance(i, slice) and i.step is not None and i.step < 0


def _index(x, idx):
    """``(flips, idx')``: numpy's ``x[idx]`` is ``x.flip(flips)[idx']``.
    Torch slices take positive steps only, so each dim a negative-step
    slice walks is flipped and that slice becomes the same walk forwards
    over the flipped dim."""
    if not any(_neg_step(i) for i in idx):
        return [], idx

    def width(i):
        if isinstance(i, torch.Tensor) and i.dtype == torch.bool:
            return i.dim()
        return 1

    used = sum(width(i) for i in idx if i is not None and i is not Ellipsis)
    items = []
    for i in idx:
        items += [slice(None)] * (x.dim() - used) if i is Ellipsis else [i]
    out, flips, d = [], [], 0
    for i in items:
        if i is None:
            out.append(None)
            continue
        if _neg_step(i):
            n = x.shape[d]
            walk = range(*i.indices(n))
            start = n - 1 - walk.start if len(walk) else 0
            out.append(slice(start, start + len(walk) * -i.step, -i.step))
            flips.append(d)
        else:
            out.append(i)
        d += width(i)
    return flips, tuple(out)


def _select(x, idx):
    flips, idx = _index(x, idx)
    return (x.flip(flips) if flips else x)[idx]


@register_op("getitem")
def _getitem(x, *index_arrays, index_spec=None):
    return _select(x, _decode_index(index_spec, list(index_arrays)))


@register_op("setitem")
def _setitem(x, value, *index_arrays, index_spec=None):
    flips, idx = _index(x, _decode_index(index_spec, list(index_arrays)))
    out = x.flip(flips) if flips else x.clone()
    out[idx] = torch.as_tensor(value, dtype=x.dtype, device=x.device)
    return out.flip(flips) if flips else out


@register_op("strided_slice")
def _strided_slice(x, axes, starts, ends, strides=None):
    strides = strides or [1] * len(axes)
    idx = [slice(None)] * x.dim()
    for a, s, e, st in zip(axes, starts, ends, strides):
        idx[a] = slice(s, e, st)
    return _select(x, tuple(idx))


@register_op("slice")
def _slice(x, axes, starts, ends):
    idx = [slice(None)] * x.dim()
    for a, s, e in zip(axes, starts, ends):
        idx[a] = slice(s, e)
    return x[tuple(idx)]


@register_op("moveaxis")
def _moveaxis(x, source, destination):
    return torch.movedim(x, source, destination)


@register_op("swapaxes")
def _swapaxes(x, axis0, axis1):
    return torch.swapaxes(x, axis0, axis1)


@register_op("as_strided")
def _as_strided(x, shape, stride, offset=0):
    idx = torch.full(tuple(shape), int(offset), dtype=torch.long,
                     device=x.device)
    for d, (s, st) in enumerate(zip(shape, stride)):
        r = torch.arange(s, device=x.device) * st
        idx = idx + r.reshape(tuple(-1 if i == d else 1
                                    for i in range(len(shape))))
    return x.reshape(-1)[idx]


@register_op("tensordot")
def _tensordot(x, y, axes=2):
    if isinstance(axes, (list, tuple)):
        axes = [list(a) if isinstance(a, (list, tuple)) else [a]
                for a in axes]
    return torch.tensordot(x, y, dims=axes)


@register_op("crop")
def _crop(x, shape, offsets):
    idx = tuple(slice(o, o + s) for o, s in zip(offsets, shape))
    return x[idx]


@register_op("masked_fill_tensor")
def _masked_fill_tensor(x, mask, value):
    """numpy's ``x[mask] = value``: a one-element value fills the selected
    region; a 1-D value of length k goes to the k True positions in
    row-major order."""
    value = value.to(x.dtype)
    if value.numel() == 1:
        return torch.where(_leading_mask(mask, x.dim()),
                           value.reshape(()), x)
    if value.dim() == 1:
        flat_mask = torch.broadcast_to(_leading_mask(mask, x.dim()),
                                       x.shape).reshape(-1)
        pos = torch.cumsum(flat_mask.long(), 0) - 1
        vals = value[pos.clamp(0, value.shape[0] - 1)]
        return torch.where(flat_mask, vals, x.reshape(-1)).reshape(x.shape)
    return torch.where(_leading_mask(mask, x.dim()),
                       torch.broadcast_to(value, x.shape), x)
