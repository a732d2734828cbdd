"""The port's host-DRAM KV tier (``paddle_tpu_torch/serving/host_tier.py``
and the tier hooks of ``paging.py``, ``scheduler.py`` and ``engine.py``)
against the JAX package, on the CPU.

* the host store: capacity, LRU eviction inside the tier, named errors
  on misuse only, idempotent close (both packages raise the same errors);
* exactness: a demoted block is bit-identical to the device block, a
  promoted block lands bit-identical (float32, and int8 with its
  scales), and a promoted block shared by two requests copies on write;
* degradation: a full spill queue drops the demotion, a failed copy is
  dropped, promotions coalesce and skip republished keys, adoption in an
  exhausted pool degrades to a miss, a dead waiter releases its ticket;
* the engine: the serial churn (a preamble, churn until its blocks are
  demoted, the preamble again) gives exactly the JAX engine's tokens and
  tier counts on the same weights, on float32 and int8 pools, through
  the gather and the fused engines; decode never waits on a promotion in
  flight; a one-entry tier degrades and never errors; ``close`` joins
  the tier's threads; the tier needs a paged pool in both packages.

Prompts stay inside the vocabulary (the JAX embedding clamps an id past
it, the port's raises). Tolerances: none; blocks bit for bit, tokens and
counts exactly.
"""
import dataclasses
import threading
import time

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models import GPTConfig as JaxGPTConfig
from paddle_tpu.models import GPTForPretraining as JaxGPT
from paddle_tpu.nn.layer.layers import get_params_tree
from paddle_tpu.serving import GenerationEngine as JaxEngine
from paddle_tpu.serving import host_tier as jtier
from paddle_tpu_torch.convert import gpt_from_jax_params
from paddle_tpu_torch.models import GPTConfig
from paddle_tpu_torch.serving import (GenerationEngine, HostBlockPool,
                                      HostTierError, HostTierFullError,
                                      PagedKVPool, PromotionTicket)

VOCAB = 96


@pytest.fixture(scope="module")
def models():
    """A 2-layer, hidden-64 GPT with wide embeddings (clear argmax
    margins) and its port twin."""
    paddle.seed(11)
    jcfg = JaxGPTConfig(vocab_size=VOCAB, hidden_size=64,
                        num_hidden_layers=2, num_attention_heads=4,
                        intermediate_size=128, max_position_embeddings=80,
                        hidden_dropout_prob=0.0, attention_dropout_prob=0.0,
                        initializer_range=0.5)
    jmodel = JaxGPT(jcfg)
    jmodel.eval()
    params = {k: np.asarray(v) for k, v in get_params_tree(jmodel).items()}
    tmodel = gpt_from_jax_params(
        params, GPTConfig(**dataclasses.asdict(jcfg)), device="cpu")
    return jmodel, tmodel


def _tiered_pool(tier_blocks=16, **kw):
    args = dict(num_layers=1, num_slots=4, num_heads=1, max_len=64,
                head_dim=2, block_size=8, device="cpu")
    args.update(kw)
    pool = PagedKVPool(**args)
    tier = HostBlockPool(
        tier_blocks * (pool.host_block_nbytes + pool.host_scale_nbytes),
        pool.host_block_nbytes, scale_nbytes=pool.host_scale_nbytes,
        device="cpu")
    pool.attach_host_tier(tier)
    return pool, tier


def _publish(pool, toks, values):
    """Prefill stand-in: a slot whose blocks each hold one constant (an
    int8 pool: that code, scale |v| / 127), its prefix published, the
    slot freed. Returns the blocks."""
    slot = pool.alloc()
    blocks = pool.admit_fresh(slot, len(toks))
    for b, v in zip(blocks, values):
        pool.data[:, :, b] = v
        if pool.quantized:
            pool.scales[:, :, b] = abs(v) / 127.0
    pool.register_prefix(slot, toks)
    pool.free(slot)
    return blocks


def _demote(pool, tier):
    pool.tier_tick()
    tier.drain()


def _evict_all(pool):
    while pool._lru:
        pool._evict_one()


def _promote(pool, tier, probe):
    host_keys, _ = pool.tier_match(probe)
    assert host_keys, "expected a host-tier chain to promote"
    tk = tier.request_promotion(host_keys)
    assert tk is not None
    assert tk.ready.wait(20), "the promoter never staged the chain"
    assert tk.landed()
    assert pool.adopt_promotion(tk)
    # the promoter records the copy's time after ``ready``: wait for it to
    # finish the ticket before the caller reads the tier's stats
    tier._promo_q.join()
    return tk


def _gate(tier):
    """Hold the spiller inside its copy until ``gate`` is set."""
    gate, entered = threading.Event(), threading.Event()
    orig = tier._fetch

    def gated(*a):
        entered.set()
        assert gate.wait(20)
        return orig(*a)
    tier._fetch = gated
    return gate, entered


# ---------------------------------------------------------------------------
# the host store
# ---------------------------------------------------------------------------

def test_oversized_entry_rejected_at_ctor_in_both_packages():
    with pytest.raises(HostTierFullError):
        HostBlockPool(100, 512, device="cpu")
    with pytest.raises(jtier.HostTierFullError):
        jtier.HostBlockPool(100, 512)


def test_capacity_pressure_evicts_host_lru_silently():
    tier = HostBlockPool(2 * 64, 64, device="cpu")
    ref = jtier.HostBlockPool(2 * 64, 64)
    try:
        for t in (tier, ref):
            for k in range(3):
                t.put((k,), np.full(16, float(k), np.float32))
            assert t.blocks == 2 and t.tier_evictions == 1
            assert not t.has((0,)) and t.has((1,)) and t.has((2,))
            assert t.bytes_in_use == 2 * 64
        block, scale = tier.get((2,))
        assert scale is None
        np.testing.assert_array_equal(block.numpy(), ref.get((2,))[0])
    finally:
        tier.close()
        ref.close()


def test_get_missing_and_closed_put_raise_named_errors():
    tier = HostBlockPool(1 << 12, 64, device="cpu")
    with pytest.raises(HostTierError):
        tier.get((1, 2, 3))
    tier.close()
    with pytest.raises(HostTierError):
        tier.put((1,), np.zeros(16, np.float32))
    assert tier.spill([(1,)], torch.zeros(1, 16)) is False  # no raise


def test_close_is_idempotent_and_joins_threads():
    tier = HostBlockPool(1 << 12, 64, device="cpu")
    tier.close()
    tier.close()
    assert not tier._spiller.is_alive()
    assert not tier._promoter.is_alive()


# ---------------------------------------------------------------------------
# exactness (pool level)
# ---------------------------------------------------------------------------

def test_float32_demotion_and_promotion_are_bit_identical():
    pool, tier = _tiered_pool()
    try:
        toks = tuple(range(10, 26))              # 2 full blocks
        blocks = _publish(pool, toks, (3.0, 5.0))
        assert pool._tier_pending
        want = [pool.data[:, :, b].clone() for b in blocks]
        _demote(pool, tier)
        assert tier.demoted_blocks == 2
        for i in range(2):
            host, scale = tier.get(toks[:(i + 1) * 8])
            assert scale is None and torch.equal(host, want[i])
        _evict_all(pool)
        probe = list(toks) + [1]
        assert pool.match_prefix(probe) == []
        host_keys, covered = pool.tier_match(probe)
        assert covered == 16 and len(host_keys) == 2
        _promote(pool, tier, probe)
        got = pool.match_prefix(probe)
        assert len(got) == 2
        for i, b in enumerate(got):
            assert torch.equal(pool.data[:, :, b], want[i])
        assert tier.promoted_blocks == 2
        s = tier.stats()
        assert s["promotion_ms"]["count"] == 1
        assert s["promotion_copy_ms"]["count"] == 1
        assert s["demotion_copy_ms"]["count"] == 1
    finally:
        tier.close()


def test_int8_round_trip_carries_scales():
    pool, tier = _tiered_pool(dtype="int8")
    try:
        toks = tuple(range(40, 56))
        blocks = _publish(pool, toks, (17, 33))
        want = [(pool.data[:, :, b].clone(), pool.scales[:, :, b].clone())
                for b in blocks]
        _demote(pool, tier)
        for i in range(2):
            host, scale = tier.get(toks[:(i + 1) * 8])
            assert torch.equal(host, want[i][0])
            assert torch.equal(scale, want[i][1])
        _evict_all(pool)
        probe = list(toks) + [1]
        _promote(pool, tier, probe)
        for i, b in enumerate(pool.match_prefix(probe)):
            assert torch.equal(pool.data[:, :, b], want[i][0])
            assert torch.equal(pool.scales[:, :, b], want[i][1])
    finally:
        tier.close()


def test_promoted_block_cows_on_shared_append():
    pool, tier = _tiered_pool()
    try:
        toks = tuple(range(10, 26))
        _publish(pool, toks, (3.0, 5.0))
        _demote(pool, tier)
        _evict_all(pool)
        probe = list(toks) + [1]
        _promote(pool, tier, probe)
        got = pool.match_prefix(probe)
        shared = got[-1]
        a, b = pool.alloc(), pool.alloc()
        pool.admit_cached(a, got)
        pool.admit_cached(b, got)
        assert pool._ref[shared] == 2
        pool.set_slot(a, pos=8, lo=0)            # a writer in the tail
        dst, src = pool.ensure_writable(a)
        assert src == shared and dst != shared
        assert pool.slot_table(a)[1] == dst
        assert pool.slot_table(b)[1] == shared   # the reader untouched
        assert pool._trie[toks].block == shared  # the trie untouched
    finally:
        tier.close()


# ---------------------------------------------------------------------------
# races and degradation
# ---------------------------------------------------------------------------

def test_demotion_in_flight_while_prefix_republished():
    pool, tier = _tiered_pool()
    gate, entered = _gate(tier)
    try:
        toks = tuple(range(10, 26))
        _publish(pool, toks, (3.0, 5.0))
        pool.tier_tick()
        assert entered.wait(20)                  # the spiller holds a copy
        _evict_all(pool)
        again = _publish(pool, toks, (3.0, 5.0))  # republished meanwhile
        gate.set()
        tier.drain()
        assert tier.demoted_blocks == 2
        assert pool.tier_match(list(toks) + [1])[0] == []   # device first
        for i, b in enumerate(again):
            host, _ = tier.get(toks[:(i + 1) * 8])
            assert torch.equal(host, pool.data[:, :, b])
    finally:
        gate.set()
        tier.close()


def test_full_spill_queue_degrades_to_plain_eviction():
    pool, tier = _tiered_pool()
    gate, entered = _gate(tier)
    try:
        blk = torch.zeros(1, 1, 2, 1, 8, 2)
        assert tier.spill([(0,)], blk)
        assert entered.wait(20)                  # the worker holds item 0
        for i in range(1, 5):                    # fill the depth-4 queue
            assert tier.spill([(i,)], blk)
        assert tier.spill([(9, 9)], blk) is False
        assert tier.dropped_blocks == 1
        gate.set()
        tier.drain()
        assert tier.demoted_blocks == 5          # the queued ones landed
    finally:
        gate.set()
        tier.close()


def test_failed_fetch_is_dropped_not_raised():
    pool, tier = _tiered_pool()

    def boom(*a):
        raise RuntimeError("device torn down mid-copy")
    tier._fetch = boom
    try:
        assert tier.spill([(1,), (2,)], torch.zeros(2, 1, 2, 1, 8, 2))
        tier.drain()
        assert tier.demoted_blocks == 0 and tier.dropped_blocks == 2
        assert tier._spiller.is_alive()
        assert len(tier._free_rows) == tier.capacity_blocks  # rows back
    finally:
        tier.close()


def test_promotion_coalesces_and_adoption_skips_republished():
    pool, tier = _tiered_pool()
    try:
        toks = tuple(range(10, 26))
        _publish(pool, toks, (3.0, 5.0))
        _demote(pool, tier)
        _evict_all(pool)
        host_keys, _ = pool.tier_match(list(toks) + [1])
        t1 = tier.request_promotion(host_keys)
        assert tier.request_promotion(host_keys) is t1
        assert t1.ready.wait(20)
        _publish(pool, toks, (3.0, 5.0))         # back while it staged
        before = len(pool._free)
        assert pool.adopt_promotion(t1)          # nothing to land
        assert len(pool._free) == before and tier.promoted_blocks == 0
    finally:
        tier.close()


def test_adoption_under_exhaustion_degrades_to_miss():
    pool, tier = _tiered_pool(num_slots=2, num_blocks=8)
    try:
        toks = tuple(range(10, 26))
        _publish(pool, toks, (3.0, 5.0))
        _demote(pool, tier)
        _evict_all(pool)
        tk = tier.request_promotion(pool.tier_match(list(toks) + [1])[0])
        assert tk.ready.wait(20)
        slot = pool.alloc()
        pool.admit_fresh(slot, 64)               # every block pinned
        assert not pool._free and not pool._lru
        assert pool.adopt_promotion(tk) is False
        assert pool.tier_degraded == 1
        assert tk not in tier._tickets.values()  # released
    finally:
        tier.close()


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

SYSTEM = np.arange(2, 18, dtype=np.int32)        # 2 full 8-token blocks
CHURN = [np.arange(20 + 18 * j, 36 + 18 * j, dtype=np.int32)
         for j in range(3)]


def _wait_for(cond, timeout):
    t0 = time.monotonic()
    while time.monotonic() - t0 < timeout:
        if cond():
            return True
        time.sleep(0.01)
    return cond()


def _mk(cls, model, **kw):
    args = dict(num_slots=2, max_len=48, min_bucket=8, kv_layout="paged",
                block_size=8, num_blocks=8)
    if cls is GenerationEngine:
        args["device"] = "cpu"
    args.update(kw)
    return cls(model, **args)


def _drain_tier(eng):
    tier = eng._pool.host_tier
    if tier is not None:
        eng._pool.tier_tick()
        tier.drain()


def _churn(eng, system=SYSTEM, churn=CHURN, new=4):
    """The preamble with a tail, churn until its blocks leave the device
    pool, the tier drained, then the preamble again with the same tail."""
    try:
        outs = [eng.submit(np.concatenate([system, [40]]),
                           max_new_tokens=new).result(timeout=300)]
        for p in churn:
            outs.append(eng.submit(p, max_new_tokens=new).result(
                timeout=300))
        _drain_tier(eng)
        outs.append(eng.submit(np.concatenate([system, [40]]),
                               max_new_tokens=new).result(timeout=300))
        return outs, eng.stats()
    finally:
        eng.close()


def _tier_counts(s):
    ht = s["host_tier"]
    return (s["tier_hits"], ht["demoted_blocks"], ht["promoted_blocks"],
            ht["dropped_blocks"], ht["tier_evictions"])


LONG_SYSTEM = np.arange(2, 66, dtype=np.int32) % 90 + 3   # 2 blocks of 32
LONG_CHURN = [(np.arange(64) * (j + 2) + 5 * j) % 90 + 3 for j in range(3)]

ENGINES = {
    "gather-float32": (dict(), SYSTEM, CHURN),
    "gather-int8": (dict(kv_dtype="int8"), SYSTEM, CHURN),
    "fused-int8": (dict(kv_dtype="int8", attention="fused", block_size=32,
                        num_blocks=6, max_len=80, min_bucket=32,
                        prefill_budget=32), LONG_SYSTEM, LONG_CHURN),
}


@pytest.mark.parametrize("kind", sorted(ENGINES))
def test_tiered_churn_matches_jax_engine_and_untiered(models, kind):
    jmodel, tmodel = models
    kw, system, churn = ENGINES[kind]
    got, s = _churn(_mk(GenerationEngine, tmodel, host_tier_bytes=4 << 20,
                        **kw), system, churn)
    want, js = _churn(_mk(JaxEngine, jmodel, host_tier_bytes=4 << 20,
                          **kw), system, churn)
    plain, ps = _churn(_mk(GenerationEngine, tmodel, **kw), system, churn)
    for i, (g, w, p) in enumerate(zip(got, want, plain)):
        np.testing.assert_array_equal(g, w, err_msg=f"request {i}")
        np.testing.assert_array_equal(g, p, err_msg=f"request {i}")
    assert _tier_counts(s) == _tier_counts(js)
    assert s["tier_hits"]["host"] >= 1
    assert s["host_tier"]["promoted_blocks"] >= len(system) // \
        s["block_size"]
    assert s["prefix_hit_hbm"] + s["prefix_hit_host"] \
        + s["prefix_miss"] == pytest.approx(1.0)
    assert ps["tier_hits"]["host"] == 0 and "host_tier" not in ps


def test_dead_waiter_releases_its_ticket(models):
    eng = _mk(GenerationEngine, models[1], host_tier_bytes=4 << 20)
    try:
        eng.submit(np.concatenate([SYSTEM, [40]]),
                   max_new_tokens=4).result(timeout=300)
        tier = eng._pool.host_tier
        tk = PromotionTicket([(1, 2)])           # never becomes ready
        tier._tickets[(1, 2)] = tk
        tier.request_promotion = lambda keys: tk
        for p in CHURN:
            eng.submit(p, max_new_tokens=4).result(timeout=300)
        _drain_tier(eng)
        h = eng.submit(np.concatenate([SYSTEM, [50]]), max_new_tokens=4)
        assert _wait_for(lambda: h._promo_ticket is tk, 15)
        h.cancel()
        assert _wait_for(h.done, 30)
        assert _wait_for(lambda: (1, 2) not in tier._tickets, 10)
    finally:
        eng.close()


def test_decode_never_blocks_on_inflight_promotion(models):
    eng = _mk(GenerationEngine, models[1], host_tier_bytes=4 << 20)
    try:
        eng.submit(np.concatenate([SYSTEM, [40]]),
                   max_new_tokens=4).result(timeout=300)
        for p in CHURN:
            eng.submit(p, max_new_tokens=4).result(timeout=300)
        _drain_tier(eng)
        tier = eng._pool.host_tier
        held = PromotionTicket([(1, 2)])         # never becomes ready
        orig = tier.request_promotion
        tier.request_promotion = lambda keys: held
        waiter = eng.submit(np.concatenate([SYSTEM, [50]]),
                            max_new_tokens=4)
        fresh = eng.submit(np.arange(5, 17, dtype=np.int32),
                           max_new_tokens=4)
        assert fresh.result(timeout=300).size == 12 + 4   # while parked
        assert not waiter.done()
        tier.request_promotion = orig
        held.failed = True                       # released: a plain miss
        held.ready.set()
        tier._progress.set()
        assert waiter.result(timeout=300).size == SYSTEM.size + 1 + 4
    finally:
        eng.close()


def test_tiny_host_tier_degrades_never_errors(models):
    with _mk(GenerationEngine, models[1], host_tier_bytes=4 << 20) as probe:
        entry = probe._pool.host_block_nbytes \
            + probe._pool.host_scale_nbytes
    outs, s = _churn(_mk(GenerationEngine, models[1],
                         host_tier_bytes=entry))
    assert all(o.size > 0 for o in outs)
    assert s["host_tier"]["tier_evictions"] >= 1
    assert s["host_tier"]["capacity_blocks"] == 1


def test_close_drains_and_joins_tier_threads(models):
    eng = _mk(GenerationEngine, models[1], host_tier_bytes=4 << 20)
    tier = eng._pool.host_tier
    try:
        eng.submit(np.concatenate([SYSTEM, [40]]),
                   max_new_tokens=4).result(timeout=300)
        for p in CHURN:
            eng.submit(p, max_new_tokens=4).result(timeout=300)
    finally:
        eng.close()
    assert not tier._spiller.is_alive() and not tier._promoter.is_alive()
    assert tier.demoted_blocks >= 2


def test_host_tier_requires_paged_layout_in_both_packages(models):
    jmodel, tmodel = models
    with pytest.raises(ValueError, match="kv_layout='paged'"):
        GenerationEngine(tmodel, num_slots=2, max_len=48,
                         host_tier_bytes=1 << 20, device="cpu")
    with pytest.raises(ValueError, match="kv_layout='paged'"):
        JaxEngine(jmodel, num_slots=2, max_len=48, host_tier_bytes=1 << 20)
