"""The two routes of the port's ragged paged attention
(paddle_tpu_torch/ops/ragged_paged_attention.py) on the CPU: the route
table, the tensor-core route's host-side split arithmetic and tile plan,
and a plain PyTorch model of that route's decomposition (tiles of one
sequence, the walk stopped at the diagonal, splits and their combine)
held against the JAX Pallas kernel (interpret mode) and the port's plain
version on ragged batches of edge cases.

The kernels themselves run only on the card (tests/test_torch_cuda.py);
here the wrapper takes its plain version. Tolerance: bf16 outputs at
atol 2e-2 + rtol 1e-2, the card tests' (one bf16 ulp after upcasting):
the model, the plain version and the JAX kernel round P to bf16 against
running maxima taken over different column groups.
"""
import math
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops import ragged_paged_attention as jrpa
from paddle_tpu_torch.models import GPTConfig
from paddle_tpu_torch.ops import ragged_paged_attention as trpa

TOL = dict(atol=2e-2, rtol=1e-2)
_COUNTS = ("launches", "quant_launches", "tc_launches", "core_launches",
           "combine_launches")

# (q_len, pos0, kv_len, lo) a sequence, as in tests/test_torch_cuda.py: a
# decode row at position 0; kv_len ending mid-page with pad rows in its
# block; a chunk crossing pages; a 64-row tile spanning a split boundary
# (its first rows see nothing in the second split); a decode row past
# several splits; a chunk there; lo > 0 cutting a split; rows below lo.
EDGES = [(1, 0, 1, 0), (5, 32, 37, 0), (30, 10, 40, 0), (64, 230, 294, 0),
         (1, 1316, 1317, 0), (100, 1200, 1300, 0), (1, 699, 700, 300),
         (16, 10, 26, 20)]


def _edge_batch(storage, bs, dh=64, h=2, pad_blocks=2, seed=0):
    """EDGES over a random page table, made with numpy: (q bf16, pool of
    ``storage`` with its scales or None, metadata as numpy int32)."""
    rng = np.random.RandomState(seed)
    S = len(EDGES)
    T = max(-(-kv // bs) for _, _, kv, _ in EDGES)
    nb = sum(-(-kv // bs) for _, _, kv, _ in EDGES)
    vals = rng.randn(1, 2, nb + 1, h, bs, dh).astype(np.float32)
    if storage == "bfloat16":
        pool = torch.from_numpy(vals).to(torch.bfloat16)
        scales = None
    else:
        sc = np.abs(vals).max(axis=(-2, -1)) / 127.0
        pool = torch.from_numpy(np.clip(np.round(
            vals / sc[..., None, None]), -127, 127).astype(np.int8))
        scales = torch.from_numpy(sc.astype(np.float32))
    tables = np.zeros((S, T), np.int32)
    free = rng.permutation(np.arange(1, nb + 1)).tolist()
    for s, (_, _, kv, _) in enumerate(EDGES):
        n = -(-kv // bs)
        tables[s, :n] = [free.pop() for _ in range(n)]
    q_lens, pos0s = [e[0] for e in EDGES], [e[1] for e in EDGES]
    qp = (len(trpa.ragged_layout(q_lens, pos0s)[0]) + pad_blocks) * 8
    blk_seq, qstart, pos0, _, _ = trpa.ragged_layout(q_lens, pos0s,
                                                     q_bucket=qp)
    q = torch.from_numpy(rng.randn(h, qp, dh).astype(np.float32)).to(
        torch.bfloat16)
    meta = (blk_seq, qstart, pos0, tables,
            np.asarray([e[3] for e in EDGES], np.int32),
            np.asarray([e[2] for e in EDGES], np.int32))
    return q, pool, scales, meta


def _merge(parts):
    """(m, l, acc) summed with weights exp(m_i - max m), in order."""
    big = torch.stack([p[0] for p in parts]).amax(0)
    w = [torch.exp(p[0] - big) for p in parts]
    return (big, sum(wi * p[1] for wi, p in zip(w, parts)),
            sum(wi[..., None] * p[2] for wi, p in zip(w, parts)))


def _tc_model(q, pool, layer, meta, scales=None, parts_out=None):
    """The tensor-core route's decomposition as plain PyTorch: for each
    tile of ``tc_plan``, each of its splits walks its pages 64 columns a
    step with an online softmax (P rounded to bf16 before PV, l summing
    it unrounded); a tile of at most 16 rows runs it per 16-column quarter
    of every step (the kernel's 4 warps), one of at most 32 rows per half,
    and sums the parts in order;
    one split divides, several are combined in split order with weights
    exp(m_z - max m). ``parts_out`` collects each split's (tile, z, m,
    l)."""
    blk_seq, qstart, pos0, tables, lo, kv_len = meta
    h, qp, dh = q.shape
    bs = pool.shape[4]
    scale = 1.0 / math.sqrt(dh)
    per_split, per_step = trpa.SPLIT_COLS // bs, 64 // bs

    def page(kv, pid):
        x = pool[layer, kv, int(pid)].float()               # [H, bs, Dh]
        if scales is not None:
            x = (x * scales[layer, kv, int(pid)][:, None, None]).to(
                torch.bfloat16).float()
        return x

    out = torch.zeros(h, qp, dh)
    for t in trpa.tc_plan(blk_seq, qstart, pos0, lo, kv_len, bs):
        rows = slice(t["first"] * 8, t["first"] * 8 + t["rows"])
        qt = q[:, rows].float()
        qpos = t["qpos0"] + torch.arange(t["rows"])
        parts = []
        n_cg = 4 if t["rows"] <= 16 else 2 if t["rows"] <= 32 else 1
        windows = [(64 // n_cg * w, 64 // n_cg * (w + 1))
                   for w in range(n_cg)]
        for z in range(t["z_first"], t["z_last"] + 1):
            pg0 = max(t["p_begin"], z * per_split)
            pg1 = min(t["p_end"], (z + 1) * per_split)
            quarters = []
            for c0, c1 in windows:
                m = torch.full((h, t["rows"]), -1e30)
                l = torch.zeros(h, t["rows"])
                acc = torch.zeros(h, t["rows"], dh)
                for p0 in range(pg0, pg1, per_step):
                    pids = tables[t["seq"], p0:min(p0 + per_step, pg1)]
                    k = torch.cat([page(0, p) for p in pids], dim=1)[:, c0:c1]
                    v = torch.cat([page(1, p) for p in pids], dim=1)[:, c0:c1]
                    if not k.shape[1]:
                        continue
                    cols = p0 * bs + c0 + torch.arange(k.shape[1])
                    s = torch.matmul(qt, k.transpose(1, 2)) * scale
                    keep = (cols[None] >= int(lo[t["seq"]])) \
                        & (cols[None] <= qpos[:, None])
                    s = torch.where(keep[None], s, torch.tensor(-1e30))
                    m_new = torch.maximum(m, s.amax(-1))
                    alpha = torch.exp(m - m_new)
                    p = torch.exp(s - m_new[..., None])
                    l = l * alpha + p.sum(-1)
                    acc = acc * alpha[..., None] + torch.matmul(
                        p.to(torch.bfloat16).float(), v)
                    m = m_new
                quarters.append((m, l, acc))
            parts.append(_merge(quarters))
            if parts_out is not None:
                parts_out.append((t, z) + parts[-1][:2])
        _, l, acc = parts[0] if len(parts) == 1 else _merge(parts)
        out[:, rows] = acc / l.clamp_min(1e-30)[..., None]
    return out.to(torch.bfloat16)


# ---------------------------------------------------------------- routes
@pytest.mark.parametrize("q_dtype, pool_dtype, dh, bs, route", [
    (torch.bfloat16, torch.bfloat16, 64, 16, "tc"),
    (torch.bfloat16, torch.bfloat16, 64, 32, "tc"),
    (torch.bfloat16, torch.bfloat16, 128, 64, "tc"),
    (torch.bfloat16, torch.int8, 64, 32, "tc"),
    (torch.bfloat16, torch.int8, 128, 64, "tc"),
    (torch.bfloat16, torch.float8_e4m3fn, 64, 32, "tc"),
    (torch.bfloat16, torch.float8_e4m3fn, 128, 32, "tc"),
    (torch.float32, torch.float32, 64, 16, "cuda_core"),
    (torch.float32, torch.int8, 64, 32, "cuda_core"),
    (torch.float32, torch.float8_e4m3fn, 128, 32, "cuda_core"),
    (torch.bfloat16, torch.bfloat16, 32, 16, "cuda_core"),
    (torch.bfloat16, torch.bfloat16, 256, 16, "cuda_core"),
    (torch.bfloat16, torch.bfloat16, 64, 8, "cuda_core"),
    (torch.bfloat16, torch.bfloat16, 64, 128, "cuda_core"),
    (torch.bfloat16, torch.int8, 16, 32, "cuda_core"),
    (torch.float16, torch.float16, 64, 16, "tc"),
    (torch.float16, torch.float16, 128, 64, "tc"),
    (torch.float16, torch.int8, 64, 32, "tc"),
    (torch.float16, torch.float8_e4m3fn, 128, 32, "tc"),
    (torch.float16, torch.float16, 32, 16, "cuda_core"),
    (torch.float16, torch.float16, 64, 8, "cuda_core"),
    (torch.float16, torch.bfloat16, 64, 16, "cuda_core"),
    (torch.bfloat16, torch.float16, 64, 16, "cuda_core"),
])
def test_route_table(q_dtype, pool_dtype, dh, bs, route):
    assert trpa.rpa_route(q_dtype, pool_dtype, dh, bs) == route


@pytest.mark.parametrize("kv_dtype, block_size", [
    (None, 16), ("int8", 32), ("float8_e4m3fn", 32)])
def test_the_engines_configurations_take_the_tensor_core_route(kv_dtype,
                                                               block_size):
    """GPT-2 small served from bf16 weights over a bf16 pool in blocks of
    16 and over int8 / fp8 pools in blocks of 32, as the card runs it."""
    cfg = GPTConfig.gpt2_small()
    dh = cfg.hidden_size // cfg.num_attention_heads
    pool_dtype = getattr(torch, kv_dtype) if kv_dtype else torch.bfloat16
    assert block_size >= trpa.min_kv_block_for(pool_dtype)
    assert trpa.rpa_route(torch.bfloat16, pool_dtype, dh,
                          block_size) == "tc"


# ---------------------------------------------------------------- splits
@pytest.mark.parametrize("T, bs, splits", [
    (1, 16, 1), (8, 16, 1), (9, 16, 2), (64, 16, 8), (4, 32, 1),
    (5, 32, 2), (64, 32, 16), (100, 64, 50), (1, 64, 1)])
def test_split_count_from_the_table_shape(T, bs, splits):
    assert trpa.split_count(T, bs) == splits
    assert trpa.split_count(T, bs) * trpa.SPLIT_COLS >= T * bs


@pytest.mark.parametrize("bs", [16, 32, 64])
def test_splits_lie_at_fixed_column_multiples(bs):
    """Every tile's pages fall in the splits that hold their columns,
    split z holding columns [128 z, 128 (z + 1)); the walk runs from the
    page holding lo to the page holding the tile's last position."""
    _, _, _, meta = _edge_batch("bfloat16", bs)
    blk_seq, qstart, pos0, tables, lo, kv_len = meta
    tiles = trpa.tc_plan(blk_seq, qstart, pos0, lo, kv_len, bs)
    assert {t["seq"] for t in tiles} == set(range(len(EDGES)))
    for t in tiles:
        q_len, p0, kv, floor = EDGES[t["seq"]]
        assert t["rows"] <= trpa.TILE_BLOCKS * 8
        assert (t["first"] - qstart[t["seq"]] // 8) % trpa.TILE_BLOCKS == 0
        last = t["qpos0"] + t["rows"] - 1
        n_kv = -(-kv // bs)
        if t["qpos0"] < floor:
            assert (t["p_begin"], t["p_end"]) == (0, n_kv)
        else:
            assert t["p_begin"] == floor // bs
            assert t["p_end"] == min(n_kv, last // bs + 1)
        assert t["z_first"] == t["p_begin"] * bs // trpa.SPLIT_COLS
        assert t["z_last"] == (t["p_end"] * bs - 1) // trpa.SPLIT_COLS
    # a 100-row chunk: two tiles, 64 rows then 40 (13 blocks)
    chunk = [t for t in tiles if t["seq"] == 5]
    assert [t["rows"] for t in chunk] == [64, 40]
    # the decode row past several splits takes several
    long = next(t for t in tiles if t["seq"] == 4)
    assert long["z_last"] - long["z_first"] + 1 == -(-1317 // 128)


@pytest.mark.parametrize("seed", range(6))
def test_tile_slots_bound_the_tiles(seed):
    """The grid's tile slots, ceil(Qp / 64) + S, hold every tile of random
    ragged layouts (chunks of up to 200 rows, absent sequences, padded
    buckets) and of the edge batch."""
    rng = np.random.RandomState(seed)
    S = int(rng.randint(1, 12))
    q_lens = [int(rng.choice([0, 1, rng.randint(1, 200)])) for _ in range(S)]
    pos0s = [0] * S
    blk_seq, qstart, pos0, _, _ = trpa.ragged_layout(q_lens, pos0s)
    qp = len(blk_seq) * 8 + 8 * int(rng.randint(0, 20))
    blk_seq, qstart, pos0, _, _ = trpa.ragged_layout(q_lens, pos0s,
                                                     q_bucket=qp)
    kv = np.asarray(q_lens, np.int32)
    tiles = trpa.tc_plan(blk_seq, qstart, pos0, np.zeros(S, np.int32), kv,
                         16)
    assert len(tiles) == sum(-(-(-(-n // 8)) // 8) for n in q_lens if n)
    assert len(tiles) <= trpa.tile_slots(qp, S)
    _, _, _, meta = _edge_batch("bfloat16", 16)
    assert len(trpa.tc_plan(*meta[:3], meta[4], meta[5], 16)) \
        <= trpa.tile_slots(len(meta[0]) * 8, len(meta[1]))


def test_a_sequences_tiles_do_not_depend_on_its_batch_mates():
    """The same sequence alone and at the end of the edge batch: the same
    tiles, pages and splits, relative to its first block."""
    bs = 32
    _, _, _, meta = _edge_batch("bfloat16", bs)
    blk_seq, qstart, pos0, tables, lo, kv_len = meta
    batch = [t for t in trpa.tc_plan(blk_seq, qstart, pos0, lo, kv_len, bs)
             if t["seq"] == 5]
    b1, q1, p1, _, _ = trpa.ragged_layout([100], [1200])
    alone = trpa.tc_plan(b1, q1, p1, [0], [1300], bs)
    shift = qstart[5] // 8
    for a, b in zip(alone, batch):
        assert a["first"] + shift == b["first"]
        for key in ("rows", "qpos0", "p_begin", "p_end", "z_first",
                    "z_last"):
            assert a[key] == b[key]


def test_nothing_reads_the_sm_count(monkeypatch):
    """The split arithmetic runs with no card to ask, and the kernel
    source asks the device nothing."""
    def refuse(*a, **k):
        raise AssertionError("the device was asked")
    monkeypatch.setattr(torch.cuda, "get_device_properties", refuse)
    monkeypatch.setattr(torch.cuda, "device_count", refuse)
    _, _, _, meta = _edge_batch("bfloat16", 16)
    assert trpa.split_count(83, 16) == 11
    assert trpa.tc_plan(*meta[:3], meta[4], meta[5], 16)
    src = (Path(trpa.__file__).resolve().parent.parent / "csrc"
           / "ragged_paged_attention_sm90.cu").read_text()
    assert not re.search(r"MultiProcessor|multiProcessor|"
                         r"cudaGetDeviceProperties|cudaDeviceGetAttribute|"
                         r"\batomic[A-Z]\w*\(|\batom\.", src)


# ------------------------------------------------------------ the CPU wrapper
@pytest.mark.parametrize("storage, bs", [("bfloat16", 16), ("int8", 32)])
def test_the_cpu_wrapper_runs_the_plain_version_and_counts_nothing(storage,
                                                                   bs):
    q, pool, scales, meta = _edge_batch(storage, bs)
    fn = trpa.ragged_paged_attention
    before = [getattr(fn, c) for c in _COUNTS]
    got = fn(q, pool, 0, *meta, scales=scales)
    assert [getattr(fn, c) for c in _COUNTS] == before
    want = trpa.ragged_paged_attention_plain(q, pool, 0, *meta,
                                             scales=scales)
    assert torch.equal(got, want)


# ---------------------------------------------------------------- the model
@pytest.mark.parametrize("storage, bs", [
    ("bfloat16", 16), ("bfloat16", 32), ("int8", 32), ("int8", 64)])
def test_decomposition_model_matches_the_plain_version(storage, bs):
    q, pool, scales, meta = _edge_batch(storage, bs, seed=bs)
    got = _tc_model(q, pool, 0, meta, scales)
    want = trpa.ragged_paged_attention_plain(q, pool, 0, *meta,
                                             scales=scales)
    torch.testing.assert_close(got.float(), want.float(), **TOL)
    assert torch.all(got[:, -16:] == 0)


@pytest.mark.parametrize("storage, bs", [("bfloat16", 16), ("int8", 32)])
def test_decomposition_model_matches_the_jax_kernel(storage, bs):
    """The JAX Pallas kernel in interpret mode on the same numpy inputs
    (an int8 pool with its scales as the JAX engine keeps them)."""
    q, pool, scales, meta = _edge_batch(storage, bs, seed=7)
    got = _tc_model(q, pool, 0, meta, scales)
    jq = jnp.asarray(q.float().numpy()).astype(jnp.bfloat16)
    if scales is None:
        jpool = jnp.asarray(pool.float().numpy()).astype(jnp.bfloat16)
        want = jrpa.ragged_paged_attention(jq, jpool, 0, *meta)
    else:
        want = jrpa.ragged_paged_attention(
            jq, jnp.asarray(pool.numpy()), 0, *meta,
            scales=jnp.asarray(scales.numpy()))
    want = torch.from_numpy(np.asarray(want.astype(jnp.float32)))
    torch.testing.assert_close(got.float(), want, **TOL)


def test_a_wholly_masked_split_weighs_exactly_zero():
    """The tile of the 64-row chunk at positions 230..293 walks three
    splits; rows 230..255 see nothing in the last one, columns 256..383
    (m = -1e30, l > 0), and the combine gives it weight exp(-1e30 - m)
    = 0."""
    q, pool, scales, meta = _edge_batch("bfloat16", 16)
    parts = []
    _tc_model(q, pool, 0, meta, scales, parts_out=parts)
    splits = [(z, m, l) for t, z, m, l in parts if t["seq"] == 3]
    assert [z for z, _, _ in splits] == [0, 1, 2]
    _, m, l = splits[-1]
    masked = torch.arange(64) < 256 - 230
    assert torch.all(m[:, masked] == -1e30) and torch.all(l[:, masked] > 0)
    assert torch.all(m[:, ~masked] > -1e30)
    top = torch.stack([m_ for _, m_, _ in splits]).amax(0)
    weight = torch.exp(m - top)
    assert torch.all(weight[:, masked] == 0)


def test_rows_below_lo_take_the_plain_versions_mean():
    """Rows whose every column is masked (position < lo): the plain
    version's mean of V over every page; the model walks every page for
    their tile, so it agrees to the bit's neighbourhood."""
    q, pool, scales, meta = _edge_batch("bfloat16", 16)
    qstart = meta[1]
    rows = slice(int(qstart[7]), int(qstart[7]) + 10)   # positions 10..19
    got = _tc_model(q, pool, 0, meta, scales)[:, rows].float()
    pids = meta[3][7, :2]
    v = torch.cat([pool[0, 1, int(p)].float() for p in pids], dim=1)
    torch.testing.assert_close(got, v.mean(1, keepdim=True).expand_as(got),
                               **TOL)
