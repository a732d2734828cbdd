"""Quantized KV blocks of the PyTorch port (int8 and float8_e4m3fn codes
with per-(layer, K/V, block, head) max-abs scales) against the JAX
package, on the CPU. Each test runs for both storage types:

* ``_quant_append`` (the row scatter with scatter-max scales and
  requantization) against JAX's, on chunk rows sharing a block, pad rows
  on scratch block 0, a larger second append and a NaN row;
* the plain K1q against the JAX Pallas kernel (interpret mode) and the
  numpy oracle on ragged mixed batches over random page tables;
* one quantized fused step against JAX's ``build_fused_step_fn(...,
  quantized=True)``;
* the pool: bytes, same-budget sizing, recycled-block scales, copy-on-
  write and reset against the JAX pool;
* the engine: greedy tokens and ``stats()`` equal to the JAX fused
  engine's with the same ``kv_dtype``; validation; the non-finite
  sentinel through a quantized pool.

Also K1's bfloat16 path, whose probabilities are rounded to V's dtype
before the PV product as in the JAX kernel.

Pools and scales cross between the packages through numpy: int8 codes as
they are, fp8 codes as their float32 values (exact both ways).
Tolerances: scales rtol 1e-5; codes equal except that at most 0.1% may
lie one code apart (the two packages' f32 K/V rows may fall on opposite
sides of a .5 tie); attention with f32 q atol 1e-5, with bf16 q atol 2e-2
+ rtol 1e-2; tokens exactly.
"""
import dataclasses
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models import GPTConfig as JaxGPTConfig
from paddle_tpu.models import GPTForPretraining as JaxGPT
from paddle_tpu.models import generation as jgen
from paddle_tpu.nn.layer.layers import get_buffers_tree, get_params_tree
from paddle_tpu.ops import ragged_paged_attention as jrpa
from paddle_tpu.serving import GenerationEngine as JaxEngine
from paddle_tpu.serving import paging as jpaging
from paddle_tpu_torch.convert import gpt_from_jax_params
from paddle_tpu_torch.models import GPTConfig
from paddle_tpu_torch.models import generation as tgen
from paddle_tpu_torch.ops import ragged_paged_attention as trpa
from paddle_tpu_torch.serving import GenerationEngine
from paddle_tpu_torch.serving import paging as tpaging

VOCAB = 96
BS = 32
KV = ["int8", "float8_e4m3fn"]
QMAX = {"int8": 127.0, "float8_e4m3fn": 448.0}
TDT = {"int8": torch.int8, "float8_e4m3fn": torch.float8_e4m3fn}
JDT = {"int8": jnp.int8, "float8_e4m3fn": jnp.float8_e4m3fn}
Q_TOL = {"float32": dict(atol=1e-5, rtol=0),
         "bfloat16": dict(atol=2e-2, rtol=1e-2)}


@pytest.fixture(scope="module")
def models():
    """The 2-layer, hidden-64, 4-head GPT of test_torch_serving.py (wide
    embeddings: clear argmax margins) and its port twin."""
    paddle.seed(21)
    jcfg = JaxGPTConfig(vocab_size=VOCAB, hidden_size=64,
                        num_hidden_layers=2, num_attention_heads=4,
                        intermediate_size=128, max_position_embeddings=64,
                        hidden_dropout_prob=0.0, attention_dropout_prob=0.0,
                        initializer_range=0.5)
    jmodel = JaxGPT(jcfg)
    jmodel.eval()
    params = {k: np.asarray(v) for k, v in get_params_tree(jmodel).items()}
    tmodel = gpt_from_jax_params(
        params, GPTConfig(**dataclasses.asdict(jcfg)), device="cpu")
    return jmodel, tmodel


# ---------------------------------------------------------------------------
# codes across the packages
# ---------------------------------------------------------------------------

def _np_codes(pool) -> np.ndarray:
    """A pool of either package as numpy: int8 as is, fp8 as float32."""
    if torch.is_tensor(pool):
        return pool.numpy() if pool.dtype == torch.int8 \
            else pool.float().numpy()
    return np.asarray(pool if pool.dtype == jnp.int8
                      else pool.astype(jnp.float32))


def _torch_pool(codes, kv):
    return torch.from_numpy(codes).to(TDT[kv])


def _jax_pool(codes, kv):
    return jnp.asarray(codes).astype(JDT[kv])


def _ordinal(codes, kv) -> np.ndarray:
    """Each code's rank among its type's codes, so neighbours differ
    by 1 (fp8 bits are sign-magnitude)."""
    if kv == "int8":
        return codes.astype(np.int64)
    bits = torch.from_numpy(np.ascontiguousarray(codes, np.float32)).to(
        torch.float8_e4m3fn).view(torch.uint8).numpy().astype(np.int64)
    mag = bits & 0x7F
    return np.where(bits & 0x80, -mag, mag)


def _assert_codes_close(got, want, kv):
    """Equal, except at most 0.1% of the codes one code apart."""
    steps = np.abs(_ordinal(got, kv) - _ordinal(want, kv))
    assert steps.max(initial=0) <= 1, steps.max()
    assert (steps > 0).mean() <= 1e-3, (steps > 0).mean()


def _quantize(vals, kv):
    """Float blocks ``[..., bs, Dh]`` -> (codes as numpy, scales
    ``[...]``) by the per-block max-abs rule."""
    qmax = QMAX[kv]
    sc = (np.abs(vals).max(axis=(-2, -1)) / qmax).astype(np.float32)
    codes = np.clip(np.round(vals / np.maximum(sc, 1e-30)[..., None, None]),
                    -qmax, qmax).astype(np.float32)
    return _np_codes(_torch_pool(codes, kv)), sc


# ---------------------------------------------------------------------------
# _quant_append
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kv", KV)
def test_quant_append_matches_jax(kv):
    rng = np.random.RandomState(1)
    L, NB, H, Dh = 1, 4, 4, 16
    qmax = QMAX[kv]
    shape = (L, 2, NB + 1, H, BS, Dh)
    codes = np.zeros(shape, np.int8 if kv == "int8" else np.float32)
    tpool, tsc = _torch_pool(codes, kv), torch.zeros(L, 2, NB + 1, H)
    jpool, jsc = _jax_pool(codes, kv), jnp.zeros((L, 2, NB + 1, H))

    def append(wb, off, rows, kvi=0):
        nonlocal jpool, jsc
        jpool, jsc = jgen._quant_append(
            jpool, jsc, 0, kvi, jnp.asarray(wb), jnp.asarray(off),
            jnp.asarray(rows), qmax)
        tgen._quant_append(tpool, tsc, 0, kvi, torch.from_numpy(wb).long(),
                           torch.from_numpy(off).long(),
                           torch.from_numpy(rows), qmax)

    # a 10-row chunk of block 2, one row of block 3, 5 pad rows (the same
    # row, as the step's pad rows are) on scratch block 0
    pad = rng.randn(1, H, Dh).astype(np.float32)
    rows = np.concatenate([rng.randn(11, H, Dh).astype(np.float32),
                           np.repeat(pad, 5, 0)])
    wb = np.array([2] * 10 + [3] + [0] * 5, np.int32)
    off = np.array(list(range(10)) + [5] + [0] * 5, np.int32)
    for kvi in (0, 1):
        append(wb, off, rows, kvi)
    # larger rows raise both blocks' scales: their codes are requantized
    append(np.array([2, 2, 2, 3], np.int32), np.array([10, 11, 12, 6],
                                                      np.int32),
           4 * rng.randn(4, H, Dh).astype(np.float32))
    np.testing.assert_allclose(tsc.numpy(), np.asarray(jsc), rtol=1e-5,
                               atol=0)
    _assert_codes_close(_np_codes(tpool), _np_codes(jpool), kv)
    assert (tsc[0, 0, 2] > tsc[0, 1, 2]).all()      # K plane grew
    # a NaN row turns its block's scale NaN in both packages
    nan = np.full((1, H, Dh), np.nan, np.float32)
    append(np.array([3], np.int32), np.array([7], np.int32), nan)
    assert torch.isnan(tsc[0, 0, 3]).all()
    assert np.isnan(np.asarray(jsc)[0, 0, 3]).all()
    assert torch.isfinite(tsc[0, 0, 2]).all()


# ---------------------------------------------------------------------------
# K1q: the plain version against the JAX kernel and the oracle
# ---------------------------------------------------------------------------

def _quant_case(rng, kv, *, L=2, H=2, DH=16, S=4, T=3, NB=12):
    """A ragged batch over a random page table of a quantized pool: one
    decode row, chunk tails, one absent sequence."""
    vals = rng.randn(L, 2, NB + 1, H, BS, DH).astype(np.float32)
    vals *= rng.uniform(0.2, 3.0, (L, 2, NB + 1, H, 1, 1)).astype(np.float32)
    codes, scales = _quantize(vals, kv)
    tables = np.zeros((S, T), np.int32)
    q_lens, pos0s, kv_lens = [], [], []
    free = list(rng.permutation(np.arange(1, NB + 1)))
    for s in range(S):
        if s == S - 1:
            q_lens.append(0), pos0s.append(0), kv_lens.append(0)
            continue
        n = int(rng.randint(1, T * BS + 1))
        q = 1 if s == 0 else int(rng.randint(1, min(n, 40) + 1))
        nblk = -(-n // BS)
        tables[s, :nblk] = [free.pop() for _ in range(nblk)]
        q_lens.append(q)
        pos0s.append(n - q)
        kv_lens.append(n)
    blk_seq, qstart, pos0, _, _ = trpa.ragged_layout(q_lens, pos0s)
    q = rng.randn(H, len(blk_seq) * 8, DH).astype(np.float32)
    meta = (blk_seq, qstart, pos0, tables, np.zeros(S, np.int32),
            np.asarray(kv_lens, np.int32))
    return q, codes, scales, int(rng.randint(0, L)), meta, q_lens, pos0s


def _real_rows(out, meta, q_lens):
    return np.stack([np.asarray(out, np.float32)[:, meta[1][s] + i, :]
                     for s in range(len(q_lens)) for i in range(q_lens[s])])


@pytest.mark.parametrize("kv", KV)
@pytest.mark.parametrize("qdt", ["float32", "bfloat16"])
@pytest.mark.parametrize("seed", [0, 1])
def test_plain_k1q_matches_jax_kernel_and_oracle(kv, qdt, seed):
    q, codes, scales, layer, meta, q_lens, pos0s = _quant_case(
        np.random.RandomState(seed), kv)
    tq = torch.from_numpy(q).to(getattr(torch, qdt))
    want = jrpa.ragged_paged_attention(
        jnp.asarray(tq.float().numpy()).astype(qdt), _jax_pool(codes, kv),
        layer, *meta, scales=jnp.asarray(scales))
    want = np.asarray(want.astype(jnp.float32))
    before = trpa.ragged_paged_attention.quant_launches
    got = trpa.ragged_paged_attention(tq, _torch_pool(codes, kv), layer,
                                      *meta, scales=torch.from_numpy(scales))
    assert trpa.ragged_paged_attention.quant_launches == before  # plain
    assert got.dtype == tq.dtype and tuple(got.shape) == q.shape
    np.testing.assert_allclose(got.float().numpy(), want, **Q_TOL[qdt])
    rows, row_seq, row_pos = [], [], []
    for s, n in enumerate(q_lens):
        for i in range(n):
            rows.append(tq.float().numpy()[:, meta[1][s] + i, :])
            row_seq.append(s)
            row_pos.append(pos0s[s] + i)
    ref = trpa.reference_ragged_attention(
        np.stack(rows), codes, layer, row_seq, row_pos,
        [list(t) for t in meta[3]], meta[4], scales=scales)
    np.testing.assert_allclose(_real_rows(got.float(), meta, q_lens), ref,
                               **Q_TOL[qdt])


@pytest.mark.parametrize("kv", KV)
def test_k1q_validates_scales_and_block_size(kv):
    q = torch.zeros(2, 8, 16)
    pool = torch.zeros(1, 2, 3, 2, BS, 16, dtype=TDT[kv])
    z = np.zeros(1, np.int32)
    meta = (z, z, z, np.zeros((1, 1), np.int32), z, z)
    with pytest.raises(ValueError, match="per-block scale array"):
        trpa.ragged_paged_attention(q, pool, 0, *meta)
    with pytest.raises(ValueError, match="scales shape"):
        trpa.ragged_paged_attention(q, pool, 0, *meta,
                                    scales=torch.zeros(1, 2, 3, 3))
    with pytest.raises(ValueError, match="block_size 16 < 32"):
        trpa.ragged_paged_attention(
            q, torch.zeros(1, 2, 3, 2, 16, 16, dtype=TDT[kv]), 0, *meta,
            scales=torch.zeros(1, 2, 3, 2))
    with pytest.raises(ValueError, match="only int8/float8_e4m3fn"):
        trpa.ragged_paged_attention(q, torch.zeros(1, 2, 3, 2, 8, 16), 0,
                                    *meta, scales=torch.zeros(1, 2, 3, 2))
    assert trpa.min_kv_block_for(kv) == trpa.min_kv_block_for(TDT[kv]) \
        == jrpa.min_kv_block_for(kv) == 32
    assert trpa.min_kv_block_for(torch.bfloat16) \
        == jrpa.min_kv_block_for("bfloat16") == 8


def test_k1_bfloat16_plain_matches_jax_kernel():
    """K1 over a bf16 pool with bf16 q: P is rounded to V's dtype before
    the PV product in both packages."""
    rng = np.random.RandomState(5)
    L, H, bs, DH, S, T, NB = 2, 3, 8, 16, 4, 4, 24
    pool = torch.from_numpy(rng.randn(L, 2, NB + 1, H, bs, DH).astype(
        np.float32)).to(torch.bfloat16)
    tables = np.zeros((S, T), np.int32)
    free = list(rng.permutation(np.arange(1, NB + 1)))
    q_lens, pos0s, kv_lens = [1, 0, 0, 0], [0] * S, [0] * S
    for s, n in ((0, 29), (1, 17), (2, 32)):
        nblk = -(-n // bs)
        tables[s, :nblk] = [free.pop() for _ in range(nblk)]
        q_lens[s] = 1 if s == 0 else min(n, 9)
        pos0s[s], kv_lens[s] = n - q_lens[s], n
    blk_seq, qstart, pos0, _, _ = trpa.ragged_layout(q_lens, pos0s)
    q = torch.from_numpy(rng.randn(H, len(blk_seq) * 8, DH).astype(
        np.float32)).to(torch.bfloat16)
    meta = (blk_seq, qstart, pos0, tables, np.zeros(S, np.int32),
            np.asarray(kv_lens, np.int32))
    want = jrpa.ragged_paged_attention(
        jnp.asarray(q.float().numpy()).astype(jnp.bfloat16),
        jnp.asarray(pool.float().numpy()).astype(jnp.bfloat16), 1, *meta)
    got = trpa.ragged_paged_attention(q, pool, 1, *meta)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               **Q_TOL["bfloat16"])


# ---------------------------------------------------------------------------
# one quantized fused step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kv", KV)
def test_quantized_fused_step_matches_jax(models, kv):
    jmodel, tmodel = models
    rng = np.random.RandomState(2)
    L, H, Dh, S, T, NB = 2, 4, 16, 4, 2, 8
    codes, scales = _quantize(
        0.5 * rng.randn(L, 2, NB + 1, H, BS, Dh).astype(np.float32), kv)
    # slot 0 decodes at 40, slot 1 feeds a 9-row chunk from 28 (across a
    # block edge), slot 2 is absent, slot 3 feeds its first 3 tokens
    q_lens, pos0s = [1, 9, 0, 3], [40, 28, 0, 0]
    tables = np.zeros((S, T), np.int32)
    tables[0] = [7, 3]
    tables[1] = [5, 1]
    tables[3, :1] = [6]
    Q = 32
    blk_seq, qstart, pos0, last_row, _ = jrpa.ragged_layout(
        q_lens, pos0s, q_bucket=Q)
    token_ids, qpos, wb, wo = (np.zeros(Q, np.int32) for _ in range(4))
    for s, n in enumerate(q_lens):
        for i in range(n):
            r, p = qstart[s] + i, pos0s[s] + i
            token_ids[r] = rng.randint(1, VOCAB)
            qpos[r] = p
            wb[r], wo[r] = tables[s, p // BS], p % BS
    kv_len = np.asarray([p + n for p, n in zip(pos0s, q_lens)], np.int32)
    ops = (token_ids, qpos, wb, wo, blk_seq, qstart, pos0, tables,
           np.zeros(S, np.int32), kv_len, last_row)
    sample = np.zeros(S, bool)
    temps = np.ones(S, np.float32)

    jfn = jgen.build_fused_step_fn(jmodel, S, Q, T, BS, quantized=True,
                                   qmax=QMAX[kv])
    jpool, jsc, jnxt, _ = jfn(
        get_params_tree(jmodel), get_buffers_tree(jmodel),
        _jax_pool(codes, kv), jnp.asarray(scales), *map(jnp.asarray, ops),
        jnp.asarray(sample), jnp.asarray(temps), jax.random.PRNGKey(0))
    tpool = _torch_pool(codes, kv)
    tsc = torch.from_numpy(scales.copy())
    tfn = tgen.build_fused_step_fn(tmodel, S, Q, T, BS, quantized=True,
                                   qmax=QMAX[kv])
    tnxt = tfn(tpool, tsc, *map(torch.from_numpy, ops),
               torch.from_numpy(sample), torch.from_numpy(temps),
               torch.Generator().manual_seed(0))
    present = [s for s in range(S) if q_lens[s]] + [S]     # + sentinel
    np.testing.assert_array_equal(tnxt.numpy()[present],
                                  np.asarray(jnxt)[present])
    assert tnxt[S] == 0
    # block 0 (pad-row writes, never read) is excluded
    np.testing.assert_allclose(tsc.numpy()[:, :, 1:],
                               np.asarray(jsc)[:, :, 1:], rtol=1e-5, atol=0)
    _assert_codes_close(_np_codes(tpool)[:, :, 1:],
                        _np_codes(jpool)[:, :, 1:], kv)
    assert not np.array_equal(tsc.numpy(), scales)     # the rows landed


# ---------------------------------------------------------------------------
# the pool
# ---------------------------------------------------------------------------

def _pools(kv, num_slots=4, num_blocks=6):
    """The port's pool and the JAX pool: 2 layers, 4 heads, head_dim 16,
    max_len 64."""
    args = (2, num_slots, 4, 64, 16)
    kw = dict(block_size=BS, num_blocks=num_blocks, dtype=kv)
    return (tpaging.PagedKVPool(*args, min_bucket=BS, device="cpu", **kw),
            jpaging.PagedKVPool(*args, min_bucket=BS, **kw))


@pytest.mark.parametrize("kv", KV)
def test_pool_bytes_and_budget_match_jax(kv):
    tpool, jpool = _pools(kv)
    assert tpool.quantized and tpool.qmax == jpool.qmax == QMAX[kv]
    assert tpool.scales.shape == tpool.scales_shape == jpool.scales_shape
    assert not tpool.scales.any() and tpool.scales.dtype == torch.float32
    assert tpool.data.dtype == TDT[kv] and tpool.dtype_name == kv
    for name in ("block_storage_bytes", "scales_bytes", "capacity_bytes",
                 "block_bytes"):
        assert getattr(tpool, name) == getattr(jpool, name), name
    fp, jfp = _pools("float32")
    assert fp.scales is None and fp.scales_bytes == jfp.scales_bytes == 0
    assert fp.capacity_bytes == jfp.capacity_bytes
    for budget in (fp.capacity_bytes, 10 ** 6, 123457):
        for dtype in (kv, "float32", "bfloat16"):
            kw = dict(num_layers=2, num_heads=4, block_size=BS, head_dim=16,
                      dtype=dtype)
            assert tpaging.PagedKVPool.blocks_within_budget(budget, **kw) \
                == jpaging.PagedKVPool.blocks_within_budget(budget, **kw)


@pytest.mark.parametrize("kv", KV)
def test_same_budget_quantized_admits_2x_vs_fp32(kv):
    """Mirrors the JAX suite's test_same_budget_int8_admits_2x_vs_fp32:
    at the byte budget of an f32 pool (scales counted) a quantized pool
    admits at least twice the concurrent requests."""
    fp = tpaging.PagedKVPool(2, 64, 4, 64, 16, block_size=BS, min_bucket=BS,
                             num_blocks=16, device="cpu")
    budget = fp.capacity_bytes
    blocks = tpaging.PagedKVPool.blocks_within_budget(
        budget, num_layers=2, num_heads=4, block_size=BS, head_dim=16,
        dtype=kv)
    q = tpaging.PagedKVPool(2, 64, 4, 64, 16, block_size=BS, min_bucket=BS,
                            num_blocks=blocks, dtype=kv, device="cpu")
    assert q.capacity_bytes <= budget

    def admitted(pool):
        n = 0
        while pool.can_admit(BS):
            slot = pool.alloc()
            if slot is None:
                break
            pool.admit_fresh(slot, BS)
            n += 1
        return n

    n_fp, n_q = admitted(fp), admitted(q)
    assert n_q >= 2 * n_fp, (n_fp, n_q)


@pytest.mark.parametrize("kv", KV)
def test_recycled_block_scale_is_reset(kv):
    """A block back from the free list must not keep its last tenant's
    scale (appends only grow it). Mirrors the JAX suite's test."""
    tpool, jpool = _pools(kv, num_slots=2, num_blocks=2)
    rows = np.full((1, 4, 16), 100.0, np.float32)
    grown = []
    for pool, mod in ((tpool, "t"), (jpool, "j")):
        a = pool.alloc()
        blocks = pool.admit_fresh(a, 64)            # takes both blocks
        if mod == "t":
            tgen._quant_append(pool.data, pool.scales, 0, 0,
                               torch.tensor([blocks[1]]), torch.tensor([0]),
                               torch.from_numpy(rows), pool.qmax)
        else:
            pool.data, pool.scales = jgen._quant_append(
                pool.data, pool.scales, 0, 0, jnp.asarray([blocks[1]]),
                jnp.asarray([0]), jnp.asarray(rows), pool.qmax)
        assert np.asarray(pool.scales)[0, 0, blocks[1]].min() \
            == np.float32(100.0) / np.float32(pool.qmax)
        pool.free(a)                                # blocks recycled
        b = pool.alloc()
        pool.admit_fresh(b, BS)
        pool.set_slot(b, pos=BS, lo=0)
        pool.ensure_writable_range(b, BS)           # growth allocates
        grown.append(pool.slot_table(b)[1])
        assert not np.asarray(pool.scales)[:, :, grown[-1]].any()
    assert grown[0] == grown[1]


@pytest.mark.parametrize("kv", KV)
def test_copy_on_write_and_reset_carry_the_scales(models, kv):
    _, tmodel = models
    rng = np.random.RandomState(3)
    eng = GenerationEngine(tmodel, num_slots=2, max_len=64, block_size=BS,
                           kv_layout="paged", attention="fused",
                           kv_dtype=kv, device="cpu")
    try:
        pool = eng._pool
        codes, scales = _quantize(rng.randn(*pool.shape).astype(np.float32),
                                  kv)
        pool.data.copy_(_torch_pool(codes, kv))
        pool.scales.copy_(torch.from_numpy(scales))
        eng._run_copy(2, 1)
        assert torch.equal(pool.scales[:, :, 2], pool.scales[:, :, 1])
        assert torch.equal(pool.data[:, :, 2].float(),
                           pool.data[:, :, 1].float())
        assert torch.equal(pool.scales[:, :, 3],
                           torch.from_numpy(scales[:, :, 3]))
        pool.reset_data()
        assert not pool.scales.any() and not pool.data.float().any()
    finally:
        eng.close()


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

def _serve(eng, first, rest):
    """``first`` alone (its blocks get published), then ``rest`` from
    client threads, admitted together in one order. Over a quantized
    pool the tokens depend on the schedule (which rows land in one chunk
    decides how often a block is requantized), so both engines must
    serve the same one: each client submits after the one before it, and
    the scheduler's admission waits until all have."""
    out = [eng.submit(p, max_new_tokens=n).result(timeout=300)
           for p, n in first]
    handles = [None] * len(rest)
    submitted = [threading.Event() for _ in rest]
    sched = eng._sched
    admit = sched._admit

    def gated_admit():
        submitted[-1].wait(60)
        admit()

    sched._admit = gated_admit

    def client(i):
        if i:
            submitted[i - 1].wait(60)
        handles[i] = eng.submit(rest[i][0], max_new_tokens=rest[i][1])
        submitted[i].set()

    threads = [threading.Thread(target=client, args=(i,))
               for i in range(len(rest))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive()
    out += [h.result(timeout=600) for h in handles]
    stats = eng.stats()
    eng.close()
    return out, stats


@pytest.mark.parametrize("kv", KV)
def test_engine_greedy_tokens_match_jax_fused_engine(models, kv):
    jmodel, tmodel = models
    rng = np.random.RandomState(4)
    preamble = rng.randint(1, VOCAB, 34)        # one full cached block
    first = [(np.concatenate([preamble, rng.randint(1, VOCAB, 3)]), 6)]
    rest = [(np.concatenate([preamble, rng.randint(1, VOCAB, 5)]), 10),
            (rng.randint(1, VOCAB, 40), 12)]          # chunked: budget 16
    # one block each at admission, a second one to grow into: with 4
    # blocks among 4 slots, growth preempts
    rest += [(rng.randint(1, VOCAB, int(rng.randint(24, 31))),
              int(rng.randint(16, 25))) for _ in range(5)]
    kw = dict(num_slots=4, max_len=64, kv_layout="paged", block_size=BS,
              num_blocks=4, attention="fused", prefill_budget=16,
              kv_dtype=kv)
    want, jstats = _serve(JaxEngine(jmodel, **kw), first, rest)
    got, stats = _serve(GenerationEngine(tmodel, device="cpu", **kw),
                        first, rest)
    assert len(got) == len(want) == 8
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(g, w, err_msg=f"request {i}")
    assert stats["prefix_hits"] >= 1 and stats["prefill_tokens_saved"] >= BS
    assert stats["preempts"] >= 1
    assert stats["prefill_chunks"] > len(got)          # the 40-token prompt
    assert stats["nonfinite_cycles"] == 0
    assert stats["kv_blocks_in_use"] == 0 and stats["active_requests"] == 0
    assert stats["kv_dtype"] == jstats["kv_dtype"] == kv
    assert stats["kv_bytes"] == jstats["kv_bytes"]
    assert stats["kv_pool_capacity_bytes"] == sum(stats["kv_bytes"].values())


@pytest.mark.parametrize("kv", KV)
def test_engine_validation_like_jax(models, kv):
    jmodel, tmodel = models
    kw = dict(max_len=64, kv_layout="paged", attention="fused", block_size=16)
    with pytest.raises(ValueError, match="block_size >= 32 for kv_dtype="):
        GenerationEngine(tmodel, device="cpu", kv_dtype=kv, **kw)
    with pytest.raises(ValueError, match="block_size >= 32 for kv_dtype="):
        JaxEngine(jmodel, kv_dtype=kv, **kw)
    kw["block_size"] = BS
    with pytest.raises(ValueError, match="kv_dtype must be"):
        GenerationEngine(tmodel, device="cpu", kv_dtype="bogus", **kw)
    with pytest.raises((TypeError, ValueError)):
        JaxEngine(jmodel, kv_dtype="bogus", **kw)
    with GenerationEngine(tmodel, device="cpu", **kw) as eng:
        stats = eng.stats()
    assert stats["kv_dtype"] == "float32"
    assert stats["kv_bytes"]["scales"] == 0


def test_sampled_pick_draws_the_distribution_and_takes_nan():
    """The sampled branch runs in every step: it draws from the filtered
    softmax, and NaN logits give a token instead of an error."""
    logits = torch.tensor([[0.0, 1.0, 2.0, -1.0], [0.0, 0.0, 5.0, 5.0]])
    gen = torch.Generator().manual_seed(0)
    n = 20000
    # n independent draws per row in one call: row 2i + r is a copy of
    # row r, and each row's race takes its own exponentials
    draws = tgen._pick_token(logits.repeat(n, 1), gen, True, 0, 1.0,
                             torch.ones(2 * n, 1)).view(n, 2)
    for row in range(2):
        freq = torch.bincount(draws[:, row].long(), minlength=4) / n
        np.testing.assert_allclose(freq.numpy(),
                                   torch.softmax(logits[row], -1).numpy(),
                                   atol=0.015)
    top1 = tgen._pick_token(logits, gen, True, 1, 1.0, torch.ones(2, 1))
    assert top1[0] == 2 and int(top1[1]) in (2, 3)   # top-k keeps ties
    bad = torch.full((2, 4), float("nan"))
    assert tgen._pick_token(bad, gen, True, 0, 0.9, torch.ones(2, 1)).shape \
        == (2,)


@pytest.mark.parametrize("kv", KV)
def test_nonfinite_sentinel_trips_through_quantized_pool(models, kv):
    """A NaN model drives its blocks' scales NaN, the logits go non-finite,
    the sentinel counts the cycles, and the loop serves on."""
    import copy
    _, tmodel = models
    poisoned = copy.deepcopy(tmodel)
    with torch.no_grad():
        next(poisoned.parameters()).fill_(float("nan"))
    with GenerationEngine(poisoned, num_slots=2, max_len=64, block_size=BS,
                          kv_layout="paged", attention="fused",
                          kv_dtype=kv, device="cpu") as eng:
        out = eng.submit(np.arange(1, 6), max_new_tokens=4).result(
            timeout=120)
        assert out.shape == (9,)
        assert torch.isnan(eng._pool.scales).any()
        again = eng.submit(np.arange(1, 4), max_new_tokens=2).result(
            timeout=120)
        stats = eng.stats()
    assert again.shape == (5,)
    assert stats["nonfinite_cycles"] >= 2
    assert stats["requests_retired"] == 2
