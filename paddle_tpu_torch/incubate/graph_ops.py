"""Graph-learning ops (counterpart of ``paddle_tpu/incubate/graph_ops.py``).

The message passing (``segment_*``, ``graph_send_recv``) and the masked
softmaxes run where their input lies, differentiably: the sums through
``index_add``, the extrema through ``scatter_reduce``. The number of
segments is ``max(ids) + 1``, read on the host, as in the JAX package.
``graph_send_recv``'s ``max``/``min`` give 0 where no edge arrives (and
where a result is not finite), as the JAX op does; ``segment_max``/
``segment_min`` give -inf/+inf for an empty segment, as
``jax.ops.segment_max``/``segment_min`` do.

The samplers (``graph_sample_neighbors``, ``graph_reindex``,
``graph_khop_sampler``) have data-dependent output shapes and run on the
host in numpy, where the reference's CPU sampler kernels run; they draw
from numpy's global generator, as the JAX ones do, so one
``np.random.seed`` gives both packages the same samples. Their outputs
are CPU tensors.
"""
from __future__ import annotations

import numpy as np
import torch

from ..framework.place import to_torch_device

__all__ = ["segment_sum", "segment_mean", "segment_max", "segment_min",
           "graph_send_recv", "graph_khop_sampler", "graph_reindex",
           "graph_sample_neighbors", "softmax_mask_fuse",
           "softmax_mask_fuse_upper_triangle"]


def _t(x, device=None):
    """``x`` as a tensor: a tensor as it is; other data on ``device``,
    by default the current place (the card unless ``set_device("cpu")``),
    as ``to_tensor`` places it."""
    if isinstance(x, torch.Tensor):
        return x
    return torch.as_tensor(np.asarray(x), device=device if device is not None
                           else to_torch_device(None))


def _reduce(msgs, idx, n, mode):
    """Reduce the rows of ``msgs`` onto ``n`` rows by ``idx``: ``sum``,
    ``mean`` (the sum over the count, at least 1), or ``max``/``min``
    (``scatter_reduce``, rows no index reaches left at the empty value
    ``None`` gives: -inf for max, +inf for min)."""
    shape = (n,) + tuple(msgs.shape[1:])
    if mode in ("sum", "mean"):
        out = msgs.new_zeros(shape).index_add(0, idx, msgs)
        if mode == "mean":
            cnt = torch.zeros(n, dtype=msgs.dtype, device=msgs.device)
            cnt = cnt.index_add(0, idx, torch.ones_like(idx, dtype=msgs.dtype))
            out = out / cnt.clamp(min=1).reshape((n,) + (1,) * (
                msgs.dim() - 1))
        return out
    fill = float("-inf") if mode == "max" else float("inf")
    target = idx.reshape((-1,) + (1,) * (msgs.dim() - 1)).expand_as(msgs)
    return msgs.new_full(shape, fill).scatter_reduce(
        0, target, msgs, "amax" if mode == "max" else "amin",
        include_self=False)


def _segment(data, ids, mode):
    d = _t(data)
    i = _t(ids, d.device).to(device=d.device, dtype=torch.int64)
    n = int(i.max()) + 1 if i.numel() else 0
    return _reduce(d, i, n, mode)


def segment_sum(data, segment_ids, name=None):
    return _segment(data, segment_ids, "sum")


def segment_mean(data, segment_ids, name=None):
    return _segment(data, segment_ids, "mean")


def segment_max(data, segment_ids, name=None):
    return _segment(data, segment_ids, "max")


def segment_min(data, segment_ids, name=None):
    return _segment(data, segment_ids, "min")


def graph_send_recv(x, src_index, dst_index, pool_type="sum",
                    out_size=None, name=None):
    """Message passing: gather ``x`` at ``src_index`` and reduce onto
    ``dst_index`` (``sum``, ``mean``, ``max``, ``min``) over ``out_size``
    rows (``x``'s row count by default)."""
    xv = _t(x)
    src = _t(src_index, xv.device).to(device=xv.device, dtype=torch.int64)
    dst = _t(dst_index, xv.device).to(device=xv.device, dtype=torch.int64)
    n = int(out_size) if out_size else xv.shape[0]
    mode = pool_type.lower()
    if mode not in ("sum", "mean", "max", "min"):
        raise ValueError(f"unknown pool_type {pool_type!r}")
    out = _reduce(xv[src], dst, n, mode)
    if mode in ("max", "min"):
        out = torch.where(torch.isfinite(out), out, 0)   # empty dst -> 0
    return out


# -- the host samplers -----------------------------------------------------

def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def graph_sample_neighbors(row, colptr, input_nodes, sample_size=-1,
                           eids=None, return_eids=False, perm_buffer=None,
                           name=None):
    """Uniform neighbour sampling on a CSC graph: ``(out_neighbors,
    out_count[, out_eids])``."""
    rng = np.random
    row_np, colptr_np = _np(row), _np(colptr)
    nodes = _np(input_nodes)
    eids_np = _np(eids) if eids is not None else None
    out, out_eids, counts = [], [], []
    for v in nodes.reshape(-1):
        lo, hi = int(colptr_np[v]), int(colptr_np[v + 1])
        neigh = row_np[lo:hi]
        idx = np.arange(lo, hi)
        if sample_size >= 0 and len(neigh) > sample_size:
            pick = rng.choice(len(neigh), sample_size, replace=False)
            neigh, idx = neigh[pick], idx[pick]
        out.append(neigh)
        counts.append(len(neigh))
        if eids_np is not None:
            out_eids.append(eids_np[idx])
    out_neigh = torch.from_numpy(np.concatenate(out) if out else
                                 np.zeros((0,), row_np.dtype))
    out_count = torch.from_numpy(np.asarray(counts, np.int32))
    if return_eids:
        if eids_np is None:
            raise ValueError("return_eids=True requires eids")
        return out_neigh, out_count, torch.from_numpy(
            np.concatenate(out_eids) if out_eids else
            np.zeros((0,), eids_np.dtype))
    return out_neigh, out_count


def graph_reindex(x, neighbors, count, value_buffer=None,
                  index_buffer=None, flag_buffer_hashtable=False,
                  name=None):
    """Compact global node ids to local ones: ``(reindexed_src,
    reindexed_dst, out_nodes)``."""
    xs, neigh, cnt = _np(x).reshape(-1), _np(neighbors).reshape(-1), \
        _np(count).reshape(-1)
    order: dict = {}
    for v in xs:
        order.setdefault(int(v), len(order))
    for v in neigh:
        order.setdefault(int(v), len(order))
    out_nodes = np.fromiter(order.keys(), dtype=xs.dtype,
                            count=len(order))
    re_src = np.asarray([order[int(v)] for v in neigh], np.int64)
    re_dst = np.repeat(np.arange(len(xs), dtype=np.int64), cnt)
    return (torch.from_numpy(re_src), torch.from_numpy(re_dst),
            torch.from_numpy(out_nodes))


def graph_khop_sampler(row, colptr, input_nodes, sample_sizes,
                       sorted_eids=None, return_eids=False, name=None):
    """K-hop sampling, a neighbour sampling a hop and one reindex:
    ``(edge_src, edge_dst, sample_index, reindex_nodes[, edge_eids])``,
    the edges in local ids, the global ids of every node touched (the
    centres first), the centres' local ids."""
    if return_eids and sorted_eids is None:
        raise ValueError("return_eids=True requires sorted_eids")
    centers = _np(input_nodes).reshape(-1)
    all_src, all_dst, all_eids = [], [], []
    frontier = centers
    for size in sample_sizes:
        res = graph_sample_neighbors(row, colptr, frontier,
                                     sample_size=size, eids=sorted_eids,
                                     return_eids=return_eids)
        neigh_np, cnt_np = _np(res[0]), _np(res[1])
        all_src.append(neigh_np)
        all_dst.append(np.repeat(frontier, cnt_np))
        if return_eids:
            all_eids.append(_np(res[2]))
        frontier = np.unique(neigh_np)
    src = np.concatenate(all_src) if all_src else np.zeros((0,), np.int64)
    dst = np.concatenate(all_dst) if all_dst else np.zeros((0,), np.int64)
    order: dict = {}
    for v in centers:
        order.setdefault(int(v), len(order))
    for v in src:
        order.setdefault(int(v), len(order))
    nodes = np.fromiter(order.keys(), dtype=np.int64, count=len(order))
    edge_src = np.asarray([order[int(v)] for v in src], np.int64)
    edge_dst = np.asarray([order[int(v)] for v in dst], np.int64)
    center_local = np.asarray([order[int(v)] for v in centers], np.int64)
    out = tuple(torch.from_numpy(a) for a in (edge_src, edge_dst, nodes,
                                               center_local))
    if return_eids:
        eids_cat = np.concatenate(all_eids) if all_eids else \
            np.zeros((0,), np.int64)
        return out + (torch.from_numpy(eids_cat),)
    return out


# -- the masked softmaxes ------------------------------------------------------

def softmax_mask_fuse(x, mask, name=None):
    """``softmax(x + mask)`` along the last axis in float32, in ``x``'s
    dtype."""
    x = _t(x)
    m = _t(mask, x.device)
    z = x.float() + m.float()
    return torch.softmax(z, dim=-1).to(x.dtype)


def softmax_mask_fuse_upper_triangle(x):
    """The causal masked softmax: the entries above the diagonal of the
    last two axes at -1e9, in float32, in ``x``'s dtype."""
    x = _t(x)
    s = x.shape[-1]
    keep = torch.ones(s, s, dtype=torch.bool, device=x.device).tril()
    z = torch.where(keep, x.float(), -1e9)
    return torch.softmax(z, dim=-1).to(x.dtype)
