"""Serving a float16 GPT in the port against the JAX package, on the CPU.

The float16 serving path is the fused paged engine over a model whose
parameters are float16: K1 over a float16 pool, K1q over int8 and fp8
pools with float16 q (each code dequantized as ``(code * scale)`` in f32,
rounded once to float16), P rounded to float16 before PV, the softmax and
the accumulators in f32. On the CPU the kernel wrappers run their plain
versions; the JAX side runs its Pallas kernel in interpret mode.

* the plain K1/K1q in float16 against the JAX ``ragged_paged_attention``
  on the same numpy inputs: atol 2e-3 + rtol 2e-3 (outputs of magnitude
  below 3 rounded to float16 once, and P rounded at a running maximum in
  the kernel and at the row maximum in the plain version);
* ``_quant_append`` with float16 rows: the max-abs reduction runs in f32,
  scales within rtol 1e-5 and codes as ``test_torch_quant_kv.py`` holds
  them;
* one fused step of a tiny float16 GPT against the JAX
  ``build_fused_step_fn`` over each pool: the next tokens exactly, the
  pool's K/V within one float16 ulp (atol 2e-3 at magnitudes below 2), or
  the scales within rtol 2e-3 and at most 1% of the codes one code apart
  (a block's scale is the max-abs of float16 K/V rows, and the codes are
  those rows over it: the two packages' float16 projections may round a
  row one ulp apart, which moves a scale by up to 1e-3 and the codes
  near a rounding tie by one);
* the float16 engine's greedy tokens equal to the JAX fused engine's for
  the three pools, on the wide-embedding GPT of
  ``tests/test_torch_serving.py`` (clear argmax margins).
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
from paddle_tpu_torch.convert import gpt_from_jax_params
from paddle_tpu_torch.models import GPTConfig
from paddle_tpu_torch.models import generation as tgen
from paddle_tpu_torch.ops import ragged_paged_attention as trpa
from paddle_tpu_torch.serving import GenerationEngine

VOCAB = 96
POOLS = ["float16", "int8", "float8_e4m3fn"]
BLOCK = {"float16": 16, "int8": 32, "float8_e4m3fn": 32}
QMAX = {"int8": 127.0, "float8_e4m3fn": 448.0}
TDT = {"float16": torch.float16, "int8": torch.int8,
       "float8_e4m3fn": torch.float8_e4m3fn}
JDT = {"float16": jnp.float16, "int8": jnp.int8,
       "float8_e4m3fn": jnp.float8_e4m3fn}
F16_TOL = dict(atol=2e-3, rtol=2e-3)


@pytest.fixture(scope="module")
def models():
    """The 2-layer, hidden-64, 4-head GPT of test_torch_serving.py (wide
    embeddings: clear argmax margins) in float16, and its port twin: both
    round the same float32 weights to float16 once."""
    paddle.seed(21)
    jcfg = JaxGPTConfig(vocab_size=VOCAB, hidden_size=64,
                        num_hidden_layers=2, num_attention_heads=4,
                        intermediate_size=128, max_position_embeddings=64,
                        hidden_dropout_prob=0.0, attention_dropout_prob=0.0,
                        initializer_range=0.5)
    jmodel = JaxGPT(jcfg)
    jmodel.eval()
    params = {k: np.asarray(v) for k, v in get_params_tree(jmodel).items()}
    jmodel.to(dtype="float16")
    tmodel = gpt_from_jax_params(
        params, GPTConfig(**dataclasses.asdict(jcfg)),
        device="cpu").to(torch.float16)
    for p in get_params_tree(jmodel).values():
        assert p.dtype == jnp.float16
    assert all(p.dtype == torch.float16 for p in tmodel.parameters())
    return jmodel, tmodel


def _np(pool):
    """A pool of either package as numpy: fp8 as float32 values."""
    if torch.is_tensor(pool):
        return pool.float().numpy() if pool.dtype != torch.int8 \
            else pool.numpy()
    return np.asarray(pool if pool.dtype == jnp.int8
                      else pool.astype(jnp.float32))


def _pool_from(vals, kind):
    """Float blocks -> (numpy pool values of ``kind``, scales or None)."""
    if kind == "float16":
        return vals.astype(np.float16).astype(np.float32), None
    qmax = QMAX[kind]
    sc = (np.abs(vals).max(axis=(-2, -1)) / qmax).astype(np.float32)
    codes = np.clip(np.round(vals / np.maximum(sc, 1e-30)[..., None, None]),
                    -qmax, qmax).astype(np.float32)
    return _np(torch.from_numpy(codes).to(TDT[kind])), sc


def _both(values, kind):
    """numpy values -> (torch pool, jax pool) of ``kind``."""
    return (torch.from_numpy(values.copy()).to(TDT[kind]),
            jnp.asarray(values).astype(JDT[kind]))


def _code_step(codes, kind):
    """The gap to the next code the quantizer can give at ``codes``: it
    rounds to an integer and then (fp8) to 3 mantissa bits, so the gap is
    1 below 16 and fp8's spacing above."""
    if kind == "int8":
        return np.ones_like(codes, np.float32)
    mag = np.maximum(np.abs(codes.astype(np.float32)), 1.0)
    return np.maximum(1.0, 2.0 ** (np.floor(np.log2(mag)) - 3))


def _assert_codes_close(got, want, kind, share=1e-3):
    """Equal, except that at most ``share`` of the codes lie one code
    apart (rows may fall on opposite sides of a rounding tie)."""
    got, want = got.astype(np.float32), want.astype(np.float32)
    diff = np.abs(got - want)
    step = _code_step(np.maximum(np.abs(got), np.abs(want)), kind)
    assert (diff <= step).all(), diff.max()
    assert (diff > 0).mean() <= share, (diff > 0).mean()


# ---------------------------------------------------------------------------
# K1 / K1q in float16
# ---------------------------------------------------------------------------

def _ragged_case(rng, kind, *, L=2, H=3, DH=16, S=4, T=3, NB=14):
    """A ragged batch over a random page table: a decode row, chunks
    crossing blocks, an absent sequence."""
    bs = BLOCK[kind]
    vals = rng.randn(L, 2, NB + 1, H, bs, DH).astype(np.float32)
    vals *= rng.uniform(0.2, 3.0, (L, 2, NB + 1, H, 1, 1)).astype(np.float32)
    pool, scales = _pool_from(vals, kind)
    tables = np.zeros((S, T), np.int32)
    q_lens, pos0s, kv_lens = [], [], []
    free = list(rng.permutation(np.arange(1, NB + 1)))
    for s in range(S):
        if s == S - 1:
            q_lens.append(0), pos0s.append(0), kv_lens.append(0)
            continue
        n = int(rng.randint(1, T * bs + 1))
        q = 1 if s == 0 else int(rng.randint(1, min(n, 40) + 1))
        nblk = -(-n // bs)
        tables[s, :nblk] = [free.pop() for _ in range(nblk)]
        q_lens.append(q)
        pos0s.append(n - q)
        kv_lens.append(n)
    blk_seq, qstart, pos0, _, _ = trpa.ragged_layout(q_lens, pos0s)
    q = rng.randn(H, len(blk_seq) * 8, DH).astype(np.float16)
    meta = (blk_seq, qstart, pos0, tables, np.zeros(S, np.int32),
            np.asarray(kv_lens, np.int32))
    return q, pool, scales, int(rng.randint(0, L)), meta


@pytest.mark.parametrize("kind", POOLS)
@pytest.mark.parametrize("seed", [0, 1])
def test_plain_k1_float16_matches_jax_kernel(kind, seed):
    q, pool, scales, layer, meta = _ragged_case(
        np.random.RandomState(seed), kind)
    tpool, jpool = _both(pool, kind)
    kw_j = {} if scales is None else dict(scales=jnp.asarray(scales))
    kw_t = {} if scales is None else dict(scales=torch.from_numpy(scales))
    want = jrpa.ragged_paged_attention(jnp.asarray(q), jpool, layer, *meta,
                                       **kw_j)
    assert want.dtype == jnp.float16
    counts = (trpa.ragged_paged_attention.launches,
              trpa.ragged_paged_attention.quant_launches)
    got = trpa.ragged_paged_attention(torch.from_numpy(q), tpool, layer,
                                      *meta, **kw_t)
    assert (trpa.ragged_paged_attention.launches,
            trpa.ragged_paged_attention.quant_launches) == counts  # plain
    assert got.dtype == torch.float16 and tuple(got.shape) == q.shape
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               **F16_TOL)


@pytest.mark.parametrize("kind", ["int8", "float8_e4m3fn"])
def test_quant_append_of_float16_rows_matches_jax(kind):
    rng = np.random.RandomState(3)
    L, NB, H, Dh, bs = 1, 4, 4, 16, BLOCK[kind]
    qmax = QMAX[kind]
    zeros = np.zeros((L, 2, NB + 1, H, bs, Dh), np.float32)
    tpool, jpool = _both(zeros, kind)
    tsc, jsc = torch.zeros(L, 2, NB + 1, H), jnp.zeros((L, 2, NB + 1, H))
    grown = []
    for wb, off, scale in ((np.array([2] * 10 + [3, 0, 0], np.int32),
                            np.array(list(range(10)) + [5, 0, 0], np.int32),
                            1.0),
                           (np.array([2, 3], np.int32),
                            np.array([10, 6], np.int32), 40.0)):
        rows = (scale * rng.randn(len(wb), H, Dh)).astype(np.float16)
        jpool, jsc = jgen._quant_append(
            jpool, jsc, 0, 0, jnp.asarray(wb), jnp.asarray(off),
            jnp.asarray(rows), qmax)
        tgen._quant_append(tpool, tsc, 0, 0, torch.from_numpy(wb).long(),
                           torch.from_numpy(off).long(),
                           torch.from_numpy(rows), qmax)
        grown.append(tsc[0, 0, 2].clone())
    assert tsc.dtype == torch.float32
    np.testing.assert_allclose(tsc.numpy()[:, :, 1:],
                               np.asarray(jsc)[:, :, 1:], rtol=1e-5, atol=0)
    _assert_codes_close(_np(tpool)[:, :, 1:], _np(jpool)[:, :, 1:], kind)
    assert (grown[1] > grown[0]).all()        # the second append rescaled


# ---------------------------------------------------------------------------
# one fused step of a float16 GPT
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", POOLS)
def test_float16_fused_step_matches_jax(models, kind):
    jmodel, tmodel = models
    rng = np.random.RandomState(2)
    bs = BLOCK[kind]
    L, H, Dh, S, T, NB = 2, 4, 16, 4, 64 // bs, 12
    pool, scales = _pool_from(
        0.5 * rng.randn(L, 2, NB + 1, H, bs, Dh).astype(np.float32), kind)
    # slot 0 decodes at 40, slot 1 feeds a 9-row chunk from 28 (across a
    # block edge), slot 2 is absent, slot 3 feeds its first 3 tokens
    q_lens, pos0s = [1, 9, 0, 3], [40, 28, 0, 0]
    tables = np.zeros((S, T), np.int32)
    free = list(rng.permutation(np.arange(1, NB + 1)))
    for s, n in ((0, 41), (1, 37), (3, 3)):
        nblk = -(-n // bs)
        tables[s, :nblk] = [free.pop() for _ in range(nblk)]
    Q = 32
    blk_seq, qstart, pos0, last_row, _ = jrpa.ragged_layout(
        q_lens, pos0s, q_bucket=Q)
    token_ids, qpos, wb, wo = (np.zeros(Q, np.int32) for _ in range(4))
    for s, n in enumerate(q_lens):
        for i in range(n):
            r, p = qstart[s] + i, pos0s[s] + i
            token_ids[r] = rng.randint(1, VOCAB)
            qpos[r] = p
            wb[r], wo[r] = tables[s, p // bs], p % bs
    kv_len = np.asarray([p + n for p, n in zip(pos0s, q_lens)], np.int32)
    ops = (token_ids, qpos, wb, wo, blk_seq, qstart, pos0, tables,
           np.zeros(S, np.int32), kv_len, last_row)
    sample, temps = np.zeros(S, bool), np.ones(S, np.float32)
    quant = scales is not None
    kw = dict(quantized=True, qmax=QMAX[kind]) if quant else {}
    tpool, jpool = _both(pool, kind)
    jfn = jgen.build_fused_step_fn(jmodel, S, Q, T, bs, **kw)
    jargs = (jpool, jnp.asarray(scales)) if quant else (jpool,)
    jout = jfn(get_params_tree(jmodel), get_buffers_tree(jmodel), *jargs,
               *map(jnp.asarray, ops), jnp.asarray(sample),
               jnp.asarray(temps), jax.random.PRNGKey(0))
    tsc = torch.from_numpy(scales.copy()) if quant else None
    tfn = tgen.build_fused_step_fn(tmodel, S, Q, T, bs, **kw)
    targs = (tpool, tsc) if quant else (tpool,)
    tnxt = tfn(*targs, *map(torch.from_numpy, ops), torch.from_numpy(sample),
               torch.from_numpy(temps), torch.Generator().manual_seed(0))
    jnxt = jout[-2]
    present = [s for s in range(S) if q_lens[s]] + [S]     # + sentinel
    np.testing.assert_array_equal(tnxt.numpy()[present],
                                  np.asarray(jnxt)[present])
    assert tnxt[S] == 0
    # block 0 (pad-row writes, never read) is excluded
    if quant:
        np.testing.assert_allclose(tsc.numpy()[:, :, 1:],
                                   np.asarray(jout[1])[:, :, 1:], rtol=2e-3,
                                   atol=0)
        _assert_codes_close(_np(tpool)[:, :, 1:], _np(jout[0])[:, :, 1:],
                            kind, share=1e-2)
    else:
        assert tpool.dtype == torch.float16
        np.testing.assert_allclose(_np(tpool)[:, :, 1:],
                                   _np(jout[0])[:, :, 1:], **F16_TOL)
    assert not np.array_equal(_np(tpool), pool)          # the rows landed


# ---------------------------------------------------------------------------
# the float16 engine
# ---------------------------------------------------------------------------

def _serve(eng, first, rest):
    """``first`` alone (its blocks get published), then ``rest`` from
    concurrent client threads."""
    out = [eng.submit(p, max_new_tokens=n).result(timeout=300)
           for p, n in first]
    handles = [None] * len(rest)

    def client(i):
        handles[i] = eng.submit(rest[i][0], max_new_tokens=rest[i][1])

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


@pytest.mark.parametrize("kind", POOLS)
def test_float16_engine_greedy_tokens_match_jax_fused_engine(models, kind):
    jmodel, tmodel = models
    bs = BLOCK[kind]
    rng = np.random.RandomState(4)
    preamble = rng.randint(1, VOCAB, bs + 2)     # one full cached block
    first = [(np.concatenate([preamble, rng.randint(1, VOCAB, 3)]), 6)]
    rest = [(np.concatenate([preamble, rng.randint(1, VOCAB, 5)]), 10),
            (rng.randint(1, VOCAB, 40), 12)]          # chunked: budget 16
    rest += [(rng.randint(1, VOCAB, int(rng.randint(8, 25))),
              int(rng.randint(6, 16))) for _ in range(4)]
    kw = dict(num_slots=4, max_len=64, kv_layout="paged", block_size=bs,
              attention="fused", prefill_budget=16,
              kv_dtype=None if kind == "float16" else kind)
    want, jstats = _serve(JaxEngine(jmodel, **kw), first, rest)
    got, stats = _serve(GenerationEngine(tmodel, device="cpu", **kw),
                        first, rest)
    assert len(got) == len(want) == 7
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(g, w, err_msg=f"request {i}")
    assert stats["prefix_hits"] >= 1
    assert stats["prefill_chunks"] > len(got)          # the 40-token prompt
    assert stats["nonfinite_cycles"] == jstats["nonfinite_cycles"] == 0
    assert stats["kv_dtype"] == jstats["kv_dtype"] == kind
