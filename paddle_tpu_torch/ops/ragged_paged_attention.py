"""Ragged paged attention: the hand-written CUDA kernels of the fused
serving step, their plain PyTorch version, and the host-side row layout.

Replaces the Pallas TPU kernel ``paddle_tpu/ops/ragged_paged_attention.py``
(``_rpa_kernel`` via ``ragged_paged_attention``) with
``csrc/ragged_paged_attention.cu``: K1 over float pools (float32,
bfloat16 or float16, q's dtype) and K1q over quantized pools (int8 or float8_e4m3fn
codes with a per-(layer, K/V, block, head) f32 max-abs scale, dequantized
in registers). The layout contract is unchanged, so the engine's host
operands are the JAX engine's:

* queries are FLATTENED over the batch, ``[H, Qp, Dh]``: each sequence's
  ``q_len[s]`` rows sit contiguously, padded to a multiple of
  ``BLOCK_Q`` so no q block mixes sequences;
* ``blk_seq [Qp / BLOCK_Q]`` names the sequence of each q block (-1 =
  pad block, output zeros); ``seq_qstart``/``seq_pos0`` recover every
  row's virtual cache position; ``tables [S, T]`` is the page table,
  ``kv_len`` bounds the KV walk and ``lo`` is the window floor;
* a row at position ``p`` attends to cache columns ``[lo, p]`` of the
  pool ``[L, 2, NB + 1, H, bs, Dh]``, whose ``layer`` plane is read in
  place;
* a quantized pool comes with ``scales [L, 2, NB + 1, H]``: each block
  reads as ``code * scale`` rounded to q's dtype, as in the JAX kernel.

Two routes, both hand-written, chosen by :func:`rpa_route` before the
launch from q's and the pool's dtypes, the head width and the block size:

- ``"tc"``, ``csrc/ragged_paged_attention_sm90.cu``: bfloat16 or float16
  q over a pool of q's dtype, int8 or float8_e4m3fn at head width 64 or
  128 and KV
  blocks of 16, 32 or 64 rows; products on the tensor cores
  (``mma.sync``) over q tiles of up to 64 rows of one sequence, the
  walk stopped at the diagonal and split every :data:`SPLIT_COLS` KV
  columns (:func:`split_count`, :func:`tc_plan`); a second launch
  combines the splits when there is more than one;
- ``"cuda_core"``, ``csrc/ragged_paged_attention.cu``: everything else
  (float32 q, other widths and block sizes), one CTA per (8-row block,
  head) on CUDA cores in f32.

:func:`ragged_paged_attention` takes the plain version only for tensors
on the CPU. A CUDA tensor goes to a kernel, or the call raises: there
is no fallback and no dequantized copy of the pool.
``ragged_paged_attention.launches`` counts calls over float pools,
``.quant_launches`` over int8/fp8 pools; ``.tc_launches`` and
``.core_launches`` count the calls of each route, and
``.combine_launches`` the tensor-core route's combine launches.
"""
from __future__ import annotations

import ctypes
import math
from typing import Sequence, Tuple

import numpy as np
import torch

from . import _build

__all__ = ["ragged_paged_attention", "ragged_paged_attention_plain",
           "ragged_layout", "reference_ragged_attention", "BLOCK_Q",
           "MIN_KV_BLOCK", "min_kv_block_for", "rpa_route", "split_count",
           "tile_slots", "tc_plan", "TC_HEAD_DIMS", "TC_BLOCK_SIZES",
           "TC_DTYPES",
           "TILE_BLOCKS", "SPLIT_COLS"]

_NEG_INF = -1e30

# q rows per CTA (and per q block of the layout): a decode row wastes at
# most 7 pad rows, a prefill chunk fills whole blocks
BLOCK_Q = 8

# smallest KV block the engine accepts: kept from the TPU contract so the
# two engines take the same configurations
MIN_KV_BLOCK = 8

# quantized storage: the TPU kernel needed 32-row blocks for 1-byte types
# (their sublane count); the floor is kept from that contract, not from
# this card, so both engines accept the same configurations
_MIN_KV_BLOCK_BY_DTYPE = {"int8": 32, "float8_e4m3fn": 32}

# quantized pool storage types -> the ``storage`` argument of
# rpa_quant_launch
_QUANT_CODE = {torch.int8: 0, torch.float8_e4m3fn: 1}

#: head widths and KV block sizes of the tensor-core route
TC_HEAD_DIMS = (64, 128)
TC_BLOCK_SIZES = (16, 32, 64)
#: layout blocks a tensor-core q tile takes at most (64 rows)
TILE_BLOCKS = 8
#: KV columns of a split of the tensor-core route's walk
SPLIT_COLS = 128

#: q dtypes of the tensor-core route (mma.sync's 16-bit operands)
TC_DTYPES = (torch.bfloat16, torch.float16)
# quantized pool storage -> the ``storage`` argument of rpa_tc_launch (0
# is a pool of q's dtype)
_TC_QUANT_CODE = {torch.int8: 1, torch.float8_e4m3fn: 2}


def rpa_route(q_dtype, pool_dtype, head_dim, block_size):
    """The kernel route for q of ``q_dtype`` over a pool of ``pool_dtype``
    at ``head_dim`` and KV ``block_size``: ``"tc"`` (the tensor-core
    kernel: bfloat16 or float16 q over a pool of q's dtype, int8 or
    float8_e4m3fn at a width in :data:`TC_HEAD_DIMS` and a block size in
    :data:`TC_BLOCK_SIZES`) or ``"cuda_core"``. Float32 q stays on CUDA
    cores: a TF32 product would change the function."""
    if (q_dtype in TC_DTYPES
            and (pool_dtype == q_dtype or pool_dtype in _TC_QUANT_CODE)
            and head_dim in TC_HEAD_DIMS and block_size in TC_BLOCK_SIZES):
        return "tc"
    return "cuda_core"


def split_count(table_len: int, block_size: int) -> int:
    """Splits of the tensor-core route's grid (``grid.z``): enough
    :data:`SPLIT_COLS`-column splits to cover a page table of
    ``table_len`` blocks. A function of the operands' shapes alone."""
    return max(1, -(-int(table_len) * int(block_size) // SPLIT_COLS))


def tile_slots(q_rows: int, n_seqs: int) -> int:
    """CTAs of the tensor-core route's grid per head and split
    (``grid.x``): ``ceil(q_rows / 64) + n_seqs``, a bound on its tiles (a
    sequence of k layout blocks makes at most k / 8 + 1 of them)."""
    return -(-int(q_rows) // (TILE_BLOCKS * BLOCK_Q)) + int(n_seqs)


def tc_plan(blk_seq, seq_qstart, seq_pos0, lo, kv_len, block_size):
    """The tensor-core route's decomposition, as the kernel computes it on
    the device: one dict a q tile with its sequence ``seq``, ``first``
    layout block, ``rows`` (8 a block, at most :data:`TILE_BLOCKS`
    blocks of one sequence, starting at every 8th block of it),
    ``qpos0`` (the virtual position of its row 0), the pages it walks,
    ``[p_begin, p_end)`` (from the page holding ``lo`` to the one holding
    its last row's position, within ``ceil(kv_len / bs)``; all of them
    when a row lies below ``lo``), and the splits ``[z_first, z_last]``
    those pages fall in."""
    blk_seq, seq_qstart, seq_pos0, lo, kv_len = (
        _host(m) for m in (blk_seq, seq_qstart, seq_pos0, lo, kv_len))
    bs = int(block_size)
    tiles = []
    for b, s in enumerate(blk_seq):
        s = int(s)
        b0 = int(seq_qstart[s]) // BLOCK_Q if s >= 0 else 0
        if s < 0 or (b - b0) % TILE_BLOCKS:
            continue
        n = 1
        while n < TILE_BLOCKS and b + n < len(blk_seq) \
                and int(blk_seq[b + n]) == s:
            n += 1
        rows = n * BLOCK_Q
        qpos0 = int(seq_pos0[s]) + (b - b0) * BLOCK_Q
        floor, n_kv = int(lo[s]), -(-int(kv_len[s]) // bs)
        if qpos0 < floor:
            p_begin, p_end = 0, n_kv
        else:
            p_begin = floor // bs
            p_end = min(n_kv, (qpos0 + rows - 1) // bs + 1)
        if p_end <= p_begin:
            p_begin = p_end = z_first = z_last = 0
        else:
            z_first = p_begin * bs // SPLIT_COLS
            z_last = (p_end * bs - 1) // SPLIT_COLS
        tiles.append(dict(seq=s, first=b, rows=rows, qpos0=qpos0,
                          p_begin=p_begin, p_end=p_end, z_first=z_first,
                          z_last=z_last))
    return tiles


def _dtype_name(dtype) -> str:
    return str(dtype).removeprefix("torch.")


def min_kv_block_for(dtype) -> int:
    """Smallest KV ``block_size`` the engine takes for a pool storage
    type (a torch dtype or its name)."""
    return _MIN_KV_BLOCK_BY_DTYPE.get(_dtype_name(dtype), MIN_KV_BLOCK)


def _check(q, pool, layer, scales):
    h, qp, dh = q.shape
    L, two, nb1, hp, bs, dhp = pool.shape
    if (hp, dhp) != (h, dh):
        raise ValueError(f"pool heads/head_dim {(hp, dhp)} != q {(h, dh)}")
    if qp % BLOCK_Q:
        raise ValueError(
            f"padded q rows {qp} must be a multiple of block_q {BLOCK_Q}")
    min_bs = min_kv_block_for(pool.dtype)
    if bs < min_bs:
        raise ValueError(f"block_size {bs} < {min_bs}: the engine takes "
                         f"{_dtype_name(pool.dtype)} KV blocks of at least "
                         f"{min_bs} rows")
    if two != 2:
        raise ValueError(f"pool axis 1 must hold K and V, got {two}")
    if not 0 <= int(layer) < L:
        raise ValueError(f"layer {layer} out of range [0, {L})")
    if pool.dtype in _QUANT_CODE:
        if scales is None:
            raise ValueError(
                f"a {_dtype_name(pool.dtype)} pool is quantized storage: "
                f"pass the per-block scale array (PagedKVPool.scales)")
        if tuple(scales.shape) != (L, 2, nb1, h):
            raise ValueError(
                f"scales shape {tuple(scales.shape)} != per-block layout "
                f"{(L, 2, nb1, h)}")
    elif scales is not None:
        raise ValueError(f"scales given for a {_dtype_name(pool.dtype)} "
                         f"pool: only int8/float8_e4m3fn pools are scaled")


def _host(m) -> np.ndarray:
    return m.cpu().numpy() if torch.is_tensor(m) else np.asarray(m)


def ragged_paged_attention_plain(q, pool, layer, blk_seq, seq_qstart,
                                 seq_pos0, tables, lo, kv_len, scale=None,
                                 scales=None):
    """The kernels' function as a plain composition, in f32, on any
    device. Every real q block attends over its sequence's first
    ``ceil(kv_len / bs)`` whole blocks with the ``[lo, qpos]`` mask, as
    the kernels do, so pad rows inside a real block match too; pad
    blocks are zeros. The kernels' roundings are repeated: a quantized
    block is dequantized (``code * scale``) and rounded to q's dtype, and
    the probabilities are rounded to V's dtype before the PV product."""
    _check(q, pool, layer, scales)
    h, qp, dh = q.shape
    bs = pool.shape[4]
    scale = float(scale) if scale is not None else 1.0 / math.sqrt(dh)
    blk_seq, seq_qstart, seq_pos0, lo, kv_len, tables = (
        _host(m) for m in (blk_seq, seq_qstart, seq_pos0, lo, kv_len,
                           tables))
    tables = torch.from_numpy(tables.astype(np.int64)).to(pool.device)
    # V's dtype in the kernels: the pool's, or q's once a block is
    # dequantized
    v_dtype = q.dtype if scales is not None else pool.dtype

    def block(kv, ids):
        """Blocks ``ids`` of plane (layer, kv) as f32 ``[n, H, bs, Dh]``."""
        if scales is None:
            return pool[layer, kv, ids].float()
        deq = pool[layer, kv, ids].float() \
            * scales[layer, kv, ids].float()[:, :, None, None]
        return deq.to(q.dtype).float()

    out = torch.zeros((h, qp, dh), dtype=torch.float32, device=q.device)
    for s in sorted({int(v) for v in blk_seq if v >= 0}):
        blocks = [b for b, v in enumerate(blk_seq) if v == s]
        rows = torch.arange(blocks[0] * BLOCK_Q, (blocks[-1] + 1) * BLOCK_Q,
                            device=q.device)
        n_kv = -(-int(kv_len[s]) // bs)
        ids = tables[s, :n_kv]
        # [n_kv, H, bs, Dh] -> [H, n_kv * bs, Dh]
        k, v = (block(kv, ids).permute(1, 0, 2, 3).reshape(h, n_kv * bs, dh)
                for kv in (0, 1))
        qs = q[:, rows].float()                              # [H, R, Dh]
        s_ = torch.matmul(qs, k.transpose(1, 2)) * scale     # [H, R, C]
        qpos = int(seq_pos0[s]) + (rows - int(seq_qstart[s]))
        cols = torch.arange(n_kv * bs, device=q.device)
        keep = (cols[None, :] >= int(lo[s])) \
            & (cols[None, :] <= qpos[:, None])
        s_ = torch.where(keep[None], s_, torch.full_like(s_, _NEG_INF))
        p = torch.exp(s_ - s_.amax(dim=-1, keepdim=True))
        l_ = p.sum(dim=-1, keepdim=True)
        out[:, rows] = torch.matmul(p.to(v_dtype).float(), v) \
            / l_.clamp_min(1e-30)
    return out.to(q.dtype)


_ARGS = [ctypes.c_int] + [ctypes.c_void_p] * 9 + [ctypes.c_int] * 7 + [
    ctypes.c_float, ctypes.c_void_p]
# rpa_quant_launch: storage code, q dtype code, then q, pool, scales, out
# and the metadata as in rpa_launch
_QUANT_ARGS = [ctypes.c_int] * 2 + [ctypes.c_void_p] * 10 \
    + [ctypes.c_int] * 7 + [ctypes.c_float, ctypes.c_void_p]
# rpa_tc_launch: storage code, q dtype code, q, pool, scales, out, the
# three partial buffers, the metadata, H, Qp, S, Dh, NB + 1, bs, T, layer,
# scale, the slot and split counts, the stream
_TC_ARGS = [ctypes.c_int] * 2 + [ctypes.c_void_p] * 13 + [ctypes.c_int] * 8 + [
    ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]


def ragged_paged_attention(q, pool, layer, blk_seq, seq_qstart, seq_pos0,
                           tables, lo, kv_len, *, scales=None, scale=None):
    """Fused paged attention over one layer of the serving block pool.

    * ``q`` — ``[H, Qp, Dh]`` flattened padded query rows (``Qp`` a
      multiple of ``BLOCK_Q``), float32, bfloat16 or float16;
    * ``pool`` — the WHOLE block pool ``[L, 2, NB + 1, H, bs, Dh]``;
      ``layer`` is an int and no per-layer slice is made. A float pool
      has q's dtype; an int8 or float8_e4m3fn pool is quantized storage;
    * ``scales`` — required for a quantized pool, and only then: the
      per-block max-abs scales ``[L, 2, NB + 1, H]`` float32
      (``PagedKVPool.scales``), read whole like the pool;
    * ``blk_seq [Qp / BLOCK_Q]``, ``seq_qstart``/``seq_pos0``/``lo``/
      ``kv_len [S]``, ``tables [S, T]`` — int32 metadata
      (:func:`ragged_layout` builds the first three); on the card they
      are int32 tensors on q's device;
    * returns ``[H, Qp, Dh]`` in ``q``'s dtype.
    """
    if q.device.type == "cpu":
        return ragged_paged_attention_plain(
            q, pool, layer, blk_seq, seq_qstart, seq_pos0, tables, lo,
            kv_len, scale=scale, scales=scales)
    if q.device.type != "cuda":
        raise ValueError(f"ragged_paged_attention runs on cuda or cpu "
                         f"tensors, got {q.device}")
    _check(q, pool, layer, scales)
    h, qp, dh = q.shape
    L, _, nb1, _, bs, _ = pool.shape
    S = int(seq_qstart.shape[0]) if torch.is_tensor(seq_qstart) else -1
    expect = {"blk_seq": (blk_seq, (qp // BLOCK_Q,)),
              "seq_qstart": (seq_qstart, (S,)),
              "seq_pos0": (seq_pos0, (S,)), "lo": (lo, (S,)),
              "kv_len": (kv_len, (S,)),
              "tables": (tables, (S, tables.shape[-1]
                                  if torch.is_tensor(tables) else -1))}
    for name, (t, shape) in expect.items():
        if not torch.is_tensor(t) or t.device != q.device \
                or t.dtype != torch.int32 or not t.is_contiguous() \
                or tuple(t.shape) != shape:
            raise ValueError(
                f"{name} must be a contiguous int32 tensor of shape "
                f"{shape} on {q.device}, got "
                f"{getattr(t, 'dtype', type(t).__name__)} "
                f"{tuple(getattr(t, 'shape', ()))} on "
                f"{getattr(t, 'device', 'host')}")
    quantized = pool.dtype in _QUANT_CODE
    if pool.device != q.device or (pool.dtype != q.dtype and not quantized):
        raise ValueError(f"pool {pool.dtype} on {pool.device} must match "
                         f"q {q.dtype} on {q.device}, or be an int8/"
                         f"float8_e4m3fn pool there")
    if q.dtype not in _build.DTYPE_CODE:
        raise TypeError(f"the attention kernels take float32, bfloat16 or "
                        f"float16 q, got {q.dtype}")
    if not (q.is_contiguous() and pool.is_contiguous()):
        raise ValueError("q and pool must be contiguous")
    vec = 16 // pool.element_size()
    if dh % max(vec, 8) or q.data_ptr() % 16 or pool.data_ptr() % 16:
        raise ValueError(f"the kernel loads 16-byte vectors: head_dim {dh} "
                         f"must be a multiple of {max(vec, 8)} and q/pool "
                         f"16-byte aligned")
    scale = float(scale) if scale is not None else 1.0 / math.sqrt(dh)
    if quantized and (scales.device != q.device
                      or scales.dtype != torch.float32
                      or not scales.is_contiguous()):
        raise ValueError(f"scales must be a contiguous float32 tensor "
                         f"on {q.device}, got {scales.dtype} on "
                         f"{scales.device}")
    out = torch.empty_like(q)
    T = int(tables.shape[1])
    ints = (blk_seq.data_ptr(), seq_qstart.data_ptr(), seq_pos0.data_ptr(),
            tables.data_ptr(), lo.data_ptr(), kv_len.data_ptr())
    stream = torch.cuda.current_stream(q.device).cuda_stream
    sc = scales.data_ptr() if quantized else None
    route = rpa_route(q.dtype, pool.dtype, dh, bs)
    if route == "tc":
        z = split_count(T, bs)
        # partials of multi-split tiles and each block's split range, for
        # the combine launch
        n = (h * qp * z * dh, h * qp * z * 2, qp // BLOCK_Q) if z > 1 \
            else (0, 0, 0)
        part = [torch.empty(k, dtype=t, device=q.device) for k, t in zip(
            n, (torch.float32, torch.float32, torch.int32))]
        rc = _build.function("ragged_paged_attention_sm90", "rpa_tc_launch",
                             _TC_ARGS)(
            _TC_QUANT_CODE.get(pool.dtype, 0), _build.DTYPE_CODE[q.dtype],
            q.data_ptr(), pool.data_ptr(), sc,
            out.data_ptr(), *(t.data_ptr() for t in part), *ints, h, qp, S,
            dh, nb1, bs, T, int(layer), scale, tile_slots(qp, S), z, stream)
    else:
        meta = (*ints, h, qp, dh, nb1, bs, T, int(layer), scale, stream)
        if quantized:
            rc = _build.function("ragged_paged_attention",
                                 "rpa_quant_launch", _QUANT_ARGS)(
                _QUANT_CODE[pool.dtype], _build.DTYPE_CODE[q.dtype],
                q.data_ptr(), pool.data_ptr(), sc, out.data_ptr(), *meta)
        else:
            rc = _build.function("ragged_paged_attention", "rpa_launch",
                                 _ARGS)(
                _build.DTYPE_CODE[q.dtype], q.data_ptr(), pool.data_ptr(),
                out.data_ptr(), *meta)
    if rc != 0:
        raise RuntimeError(
            f"ragged paged attention kernel launch failed ({route} route): "
            f"CUDA error {rc}")
    fn = ragged_paged_attention
    if quantized:
        fn.quant_launches += 1
    else:
        fn.launches += 1
    if route == "tc":
        fn.tc_launches += 1
        fn.combine_launches += z > 1
    else:
        fn.core_launches += 1
    return out


ragged_paged_attention.launches = 0
ragged_paged_attention.quant_launches = 0
ragged_paged_attention.tc_launches = 0
ragged_paged_attention.core_launches = 0
ragged_paged_attention.combine_launches = 0


def ragged_layout(q_lens: Sequence[int], pos0s: Sequence[int], *,
                  block_q: int = BLOCK_Q,
                  q_bucket: int = 0) -> Tuple[np.ndarray, np.ndarray,
                                              np.ndarray, np.ndarray, int]:
    """Host-side row layout of a ragged batch (numpy, scheduler thread).

    ``q_lens[s]`` query rows for sequence ``s`` (0 = absent this
    launch), first token at virtual position ``pos0s[s]``. Each present
    sequence's rows are laid out contiguously and padded to a multiple
    of ``block_q`` so no q block straddles sequences.

    Returns ``(blk_seq, seq_qstart, seq_pos0, last_row, total_rows)``:
    ``blk_seq [q_bucket / block_q]`` int32 (-1 pads), ``seq_qstart`` /
    ``seq_pos0`` ``[S]`` int32, ``last_row [S]`` int32 (flattened row of
    each present sequence's LAST real token; 0 for absent sequences —
    its logits row is garbage the caller ignores), and the unpadded
    ``total_rows``. ``q_bucket`` (a multiple of ``block_q``) fixes the
    padded width; 0 sizes it to the content.
    """
    S = len(q_lens)
    if len(pos0s) != S:
        raise ValueError(f"q_lens/pos0s length mismatch: {S} vs "
                         f"{len(pos0s)}")
    rows_padded = sum(-(-int(n) // block_q) * block_q
                      for n in q_lens if n > 0)
    if q_bucket:
        if q_bucket % block_q:
            raise ValueError(
                f"q_bucket {q_bucket} must be a multiple of block_q "
                f"{block_q}")
        if q_bucket < rows_padded:
            raise ValueError(
                f"q_bucket {q_bucket} cannot hold {rows_padded} padded "
                f"rows")
    else:
        q_bucket = max(rows_padded, block_q)
    blk_seq = np.full(q_bucket // block_q, -1, np.int32)
    seq_qstart = np.zeros(S, np.int32)
    seq_pos0 = np.zeros(S, np.int32)
    last_row = np.zeros(S, np.int32)
    cursor = 0
    total = 0
    for s, n in enumerate(q_lens):
        n = int(n)
        if n <= 0:
            continue
        nblk = -(-n // block_q)
        seq_qstart[s] = cursor
        seq_pos0[s] = int(pos0s[s])
        last_row[s] = cursor + n - 1
        blk_seq[cursor // block_q: cursor // block_q + nblk] = s
        cursor += nblk * block_q
        total += n
    return blk_seq, seq_qstart, seq_pos0, last_row, total


def reference_ragged_attention(q_rows, pool, layer, row_seq, row_pos,
                               tables, lo, scale=None, scales=None):
    """Numpy oracle (tests): per-row full-precision softmax attention
    over the row's ``[lo, pos]`` window gathered through the page table.
    ``q_rows [N, H, Dh]``, ``row_seq/row_pos [N]``; ``scales
    [L, 2, NB + 1, H]`` dequantizes a quantized pool's codes up front."""
    pool = np.asarray(pool, np.float32)
    if scales is not None:
        pool = pool * np.asarray(scales, np.float32)[..., None, None]
    q_rows = np.asarray(q_rows, np.float32)
    n, h, dh = q_rows.shape
    bs = pool.shape[4]
    scale = float(scale) if scale is not None else 1.0 / math.sqrt(dh)
    out = np.zeros_like(q_rows)
    for i in range(n):
        s = int(row_seq[i])
        p = int(row_pos[i])
        cols = np.arange(int(lo[s]), p + 1)
        k = np.stack([pool[layer, 0, tables[s][c // bs], :, c % bs, :]
                      for c in cols])                    # [ctx, H, Dh]
        v = np.stack([pool[layer, 1, tables[s][c // bs], :, c % bs, :]
                      for c in cols])
        for hh in range(h):
            logits = (k[:, hh] @ q_rows[i, hh]) * scale
            w = np.exp(logits - logits.max())
            w /= w.sum()
            out[i, hh] = w @ v[:, hh]
    return out
