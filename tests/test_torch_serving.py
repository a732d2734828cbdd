"""Serving of the PyTorch port (paddle_tpu_torch.serving) against the JAX
package's fused paged engine, on the CPU:

* one fused step launch on a mixed batch: the same pool and the same next
  tokens as the JAX step (the JAX kernel runs in interpret mode);
* the paged pool: allocation order, page tables, prefix matching,
  copy-on-write and exhaustion equal to the JAX pool's over one op
  sequence;
* the engine: greedy tokens identical to the JAX fused engine's over
  mixed concurrent requests with a chunked long prompt, a prefix hit and
  block-pressure preemption; stream/close/cancel/deadline behaviour; the
  CUDA default device.

Weights are drawn by the JAX package from a seed and carried across with
gpt_from_jax_params. Tolerances: the pool after one step at float32 atol
1e-5; tokens exactly.
"""
import dataclasses
import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models import GPTConfig as JaxGPTConfig
from paddle_tpu.models import GPTForPretraining as JaxGPT
from paddle_tpu.models.generation import \
    build_fused_step_fn as jax_build_fused_step_fn
from paddle_tpu.nn.layer.layers import get_buffers_tree, get_params_tree
from paddle_tpu.ops.ragged_paged_attention import \
    ragged_layout as jax_ragged_layout
from paddle_tpu.serving import GenerationEngine as JaxEngine
from paddle_tpu.serving import paging as jpaging
from paddle_tpu_torch.convert import gpt_from_jax_params
from paddle_tpu_torch.models import GPTConfig
from paddle_tpu_torch.models.generation import build_fused_step_fn
from paddle_tpu_torch.serving import (DeadlineExceeded, GenerationEngine,
                                      PoolCapacityError, RequestCancelled)
from paddle_tpu_torch.serving import paging as tpaging

VOCAB = 96


@pytest.fixture(scope="module")
def models():
    """A JAX GPT with wide embeddings (clear argmax margins, so greedy
    parity cannot flake on float noise) and its port twin."""
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
# one fused step
# ---------------------------------------------------------------------------

def test_fused_step_matches_jax(models):
    jmodel, tmodel = models
    rng = np.random.RandomState(0)
    L, H, Dh, bs, S, T, NB = 2, 4, 16, 8, 4, 4, 16
    pool = (0.5 * rng.randn(L, 2, NB + 1, H, bs, Dh)).astype(np.float32)
    # slot 0 decodes at 10, slot 1 feeds a 9-row chunk from 5, slot 2 is
    # absent, slot 3 feeds its first 3 tokens
    q_lens, pos0s = [1, 9, 0, 3], [10, 5, 0, 0]
    tables = np.zeros((S, T), np.int32)
    tables[0, :2] = [7, 3]
    tables[1, :2] = [12, 1]
    tables[3, :1] = [9]
    Q = 32
    blk_seq, qstart, pos0, last_row, _ = jax_ragged_layout(
        q_lens, pos0s, q_bucket=Q)
    token_ids = np.zeros(Q, np.int32)
    qpos = np.zeros(Q, np.int32)
    wb = np.zeros(Q, np.int32)
    wo = np.zeros(Q, np.int32)
    for s, n in enumerate(q_lens):
        for i in range(n):
            r, p = qstart[s] + i, pos0s[s] + i
            token_ids[r] = rng.randint(1, VOCAB)
            qpos[r] = p
            wb[r], wo[r] = tables[s, p // bs], p % bs
    kv_len = np.asarray([p + n for p, n in zip(pos0s, q_lens)], np.int32)
    ops = (token_ids, qpos, wb, wo, blk_seq, qstart, pos0, tables,
           np.zeros(S, np.int32), kv_len, last_row)
    sample = np.zeros(S, bool)
    temps = np.ones(S, np.float32)

    jfn = jax_build_fused_step_fn(jmodel, S, Q, T, bs)
    jpool, jnxt, _ = jfn(get_params_tree(jmodel), get_buffers_tree(jmodel),
                         jnp.asarray(pool), *map(jnp.asarray, ops),
                         jnp.asarray(sample), jnp.asarray(temps),
                         jax.random.PRNGKey(0))
    tpool = torch.from_numpy(pool.copy())
    tfn = build_fused_step_fn(tmodel, S, Q, T, bs)
    gen = torch.Generator().manual_seed(0)
    tnxt = tfn(tpool, *map(torch.from_numpy, ops), torch.from_numpy(sample),
               torch.from_numpy(temps), gen)
    assert tnxt.dtype == torch.int32 and tuple(tnxt.shape) == (S + 1,)
    present = [s for s in range(S) if q_lens[s]] + [S]     # + sentinel
    np.testing.assert_array_equal(tnxt.numpy()[present],
                                  np.asarray(jnxt)[present])
    assert tnxt[S] == 0
    # the scatter lands exactly where JAX's did; block 0 (pad-row writes,
    # never read) is excluded because duplicate writes pick any winner
    np.testing.assert_allclose(tpool.numpy()[:, :, 1:],
                               np.asarray(jpool)[:, :, 1:], atol=1e-5,
                               rtol=0)
    with pytest.raises(ValueError, match="q_rows"):
        build_fused_step_fn(tmodel, S, 12, T, bs)


# ---------------------------------------------------------------------------
# the paged pool
# ---------------------------------------------------------------------------

def _drive_pool(pool, mod):
    """One op sequence over a pool: fresh admission, prefix publish and
    hit, copy-on-write, growth to exhaustion, release, eviction."""
    log = []

    def note(tag, value=None):
        log.append((tag, value, pool.blocks_in_use, pool.blocks_available,
                    pool.cached_blocks, pool.prefix_hits,
                    pool.prefix_misses, pool.tokens_saved, pool.evictions))

    toks = list(range(100, 120))
    s0 = pool.alloc()
    note("fresh", pool.admit_fresh(s0, 20))
    pool.set_slot(s0, pos=20, lo=0)
    pool.register_prefix(s0, toks)
    s1 = pool.alloc()
    hit = pool.match_prefix(toks[:16] + [1, 2, 3])
    note("match", hit)
    note("match_capped", pool.match_prefix(toks[:16]))
    pool.admit_cached(s1, hit)
    pool.set_slot(s1, pos=16, lo=0)
    note("grow", pool.ensure_writable_range(s1, 18))
    s2 = pool.alloc()
    pool.admit_cached(s2, hit)
    pool.set_slot(s2, pos=8, lo=0)
    note("cow", pool.ensure_writable_range(s2, 9))
    note("grow_s0", pool.ensure_writable_range(s0, 31))
    try:
        pool.ensure_writable_range(s1, 31)
        note("no_exhaustion")
    except mod.PoolExhaustedError as e:
        note("exhausted", getattr(e, "partial_cows", None))
    note("tables", [pool.slot_table(s) for s in (s0, s1, s2)])
    note("buckets", [pool.table_bucket(s) for s in (s0, s1, s2)])
    note("array", pool.table_array(4, [s0, s2]).tolist())
    for s in (s0, s1, s2):
        pool.free(s)
        note("freed", s)
    s3 = pool.alloc()
    note("evicting", pool.admit_fresh(s3, 41))
    with pytest.raises(mod.BlockError):
        pool.admit_fresh(s3, 8)
    s4 = pool.alloc()
    try:
        pool.admit_fresh(s4, 8)
        note("no_exhaustion")
    except mod.PoolExhaustedError:
        note("exhausted_fresh", pool.slot_table(s4))
    pool.free(s3)
    pool.free(s4)
    note("drained", pool.active_slots())
    pool.reset_data()
    note("reset")
    return log


def test_paged_pool_matches_jax_pool():
    kw = dict(block_size=8, num_blocks=6)
    jlog = _drive_pool(jpaging.PagedKVPool(1, 4, 1, 32, 8, min_bucket=8,
                                           **kw), jpaging)
    pool = tpaging.PagedKVPool(1, 4, 1, 32, 8, device="cpu", **kw)
    tlog = _drive_pool(pool, tpaging)
    assert tlog == jlog
    assert pool.data.shape == (1, 2, 7, 1, 8, 8)
    assert not pool.data.any()


def test_paged_pool_validates_like_jax():
    for kw, match in ((dict(block_size=12), "power of two"),
                      (dict(num_blocks=2), "cannot hold")):
        args = (1, 2, 1, 32, 8)
        full = dict(dict(block_size=8), **kw)
        with pytest.raises(ValueError, match=match):
            tpaging.PagedKVPool(*args, device="cpu", **full)
        with pytest.raises(ValueError, match=match):
            jpaging.PagedKVPool(*args, min_bucket=8, **full)


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


def test_engine_greedy_tokens_match_jax_fused_engine(models):
    jmodel, tmodel = models
    rng = np.random.RandomState(4)
    preamble = rng.randint(1, VOCAB, 16)
    first = [(np.concatenate([preamble, rng.randint(1, VOCAB, 3)]), 6)]
    rest = [(np.concatenate([preamble, rng.randint(1, VOCAB, 5)]), 8),
            (rng.randint(1, VOCAB, 40), 12)]          # chunked: budget 16
    rest += [(rng.randint(1, VOCAB, int(rng.randint(3, 21))),
              int(rng.randint(4, 21))) for _ in range(7)]
    kw = dict(num_slots=4, max_len=64, kv_layout="paged", block_size=8,
              num_blocks=8, attention="fused", prefill_budget=16)
    want, jstats = _serve(JaxEngine(jmodel, **kw), first, rest)
    got, stats = _serve(GenerationEngine(tmodel, device="cpu", **kw),
                        first, rest)
    assert len(got) == 10
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(g, w, err_msg=f"request {i}")
    assert stats["prefix_hits"] >= 1 and stats["prefill_tokens_saved"] >= 16
    assert stats["preempts"] >= 1
    assert stats["prefill_chunks"] > len(got)          # the 40-token prompt
    assert stats["kv_blocks_in_use"] == 0 and stats["active_requests"] == 0
    assert stats["nonfinite_cycles"] == 0
    assert stats["ttft_ms"]["count"] == len(got)
    assert jstats["prefix_hits"] >= 1


def test_stream_close_cancel_and_deadline(models):
    _, tmodel = models
    eng = GenerationEngine(tmodel, num_slots=2, max_len=64, block_size=8,
                           kv_layout="paged", attention="fused",
                           device="cpu")
    p = np.arange(1, 8)
    h = eng.submit(p, max_new_tokens=6)
    streamed = list(h.stream())
    np.testing.assert_array_equal(h.result(timeout=60)[7:], streamed)
    assert len(streamed) == 6 and h.trace.ttft_ms is not None
    assert eng.stream(p, max_new_tokens=6).__next__() == streamed[0]
    hc = eng.submit(p, max_new_tokens=50)
    hc.cancel()
    with pytest.raises(RequestCancelled):
        hc.result(timeout=60)
    hd = eng.submit(p, max_new_tokens=50, timeout=1e-6)
    with pytest.raises(DeadlineExceeded):
        hd.result(timeout=60)
    queued = [eng.submit(np.arange(1, 5 + i), max_new_tokens=5)
              for i in range(4)]
    eng.close()                  # drains everything queued and in flight
    assert all(q.done() and len(q.tokens) == 5 for q in queued)
    with pytest.raises(RuntimeError, match="closed"):
        eng.submit(p, max_new_tokens=2)
    eng.close()                  # idempotent


def test_concurrent_submitters_lose_no_request(models):
    """16 client threads (more than cores) against the scheduler thread,
    with a shortened switch interval: every request completes with its
    own tokens, equal to serving it alone."""
    _, tmodel = models
    rng = np.random.RandomState(9)
    prompts = [rng.randint(1, VOCAB, int(rng.randint(2, 12)))
               for _ in range(16)]
    with GenerationEngine(tmodel, num_slots=4, max_len=32, block_size=8,
                          kv_layout="paged", attention="fused",
                          device="cpu") as eng:
        alone = [eng.submit(p, max_new_tokens=3).result(timeout=60)
                 for p in prompts]
    eng = GenerationEngine(tmodel, num_slots=4, max_len=32, block_size=8,
                           num_blocks=6, kv_layout="paged",
                           attention="fused", device="cpu")
    outs = [None] * len(prompts)

    def client(i):
        outs[i] = eng.submit(prompts[i], max_new_tokens=3).result(
            timeout=120)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(len(prompts))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(old)
        eng.close()
    for got, want in zip(outs, alone):
        np.testing.assert_array_equal(got, want)
    assert eng.stats()["requests_retired"] == len(prompts)


def test_failed_step_fails_its_requests_and_serving_goes_on(models):
    _, tmodel = models
    with GenerationEngine(tmodel, num_slots=2, max_len=32, block_size=8,
                          kv_layout="paged", attention="fused",
                          device="cpu") as eng:
        p = np.arange(1, 6)
        want = eng.submit(p, max_new_tokens=4).result(timeout=60)
        step = eng._sched._do_chunked
        boom = RuntimeError("device fault")

        def failing(*a):
            eng._sched._do_chunked = step        # fail once
            raise boom

        eng._sched._do_chunked = failing
        with pytest.raises(RuntimeError, match="serving step failed") as e:
            eng.submit(p, max_new_tokens=4).result(timeout=60)
        assert e.value.__cause__ is boom
        assert eng.stats()["cached_blocks"] == 0      # the pool was reset
        np.testing.assert_array_equal(
            eng.submit(p, max_new_tokens=4).result(timeout=60), want)


def test_engine_validation(models):
    _, tmodel = models
    for kw, exc, match in (
            (dict(mesh=object()), NotImplementedError, "ROADMAP"),
            (dict(block_size=4), ValueError, "block_size >= 8"),
            (dict(max_len=128), ValueError, "max_position_embeddings")):
        with pytest.raises(exc, match=match):
            GenerationEngine(tmodel, kv_layout="paged", attention="fused",
                             device="cpu", **kw)
    with GenerationEngine(tmodel, max_len=32, block_size=8,
                          kv_layout="paged", attention="fused",
                          device="cpu") as eng:
        with pytest.raises(PoolCapacityError):
            eng.submit(np.arange(1, 30), max_new_tokens=8)
        with pytest.raises(ValueError, match="top_k"):
            eng.submit(np.arange(1, 4), top_k=5)


def test_engine_defaults_to_the_card(models):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device; the default is usable")
    _, tmodel = models
    with pytest.raises(RuntimeError, match='device="cpu"'):
        GenerationEngine(tmodel, kv_layout="paged", attention="fused")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        tpaging.PagedKVPool(1, 1, 1, 16, 8, block_size=8)
