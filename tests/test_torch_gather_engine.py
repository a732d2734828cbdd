"""The dense slot engine and the paged gather engine of the PyTorch port
(``GenerationEngine(kv_layout="dense" | "paged", attention="gather")``,
float and int8/fp8 pools) against the JAX package's, on the CPU:

* one step of each builder (``build_slot_prefill_fn``,
  ``build_slot_decode_fn``, ``build_paged_prefill_fn``,
  ``build_paged_decode_fn``, float and quantized) against the JAX
  step on the same pool: slots at different positions and free slots
  writing the scratch block; the pool after the step (the scratch block
  excluded: duplicate writes pick any winner) and the next tokens;
* ``_quant_write_blocks`` and ``_dequant_gather`` against the JAX
  functions on shared float32 inputs;
* the engines: greedy tokens equal to the JAX engine of the same
  configuration over 24 mixed concurrent requests, to the port's
  ``generate()`` and to the port's fused engine; a prefix hit with its
  replay, copy-on-write and block-pressure preemption; EOS; the
  bucketed prefill budget; the validation errors of the JAX engine;
  the scheduler's two modes.

Weights are drawn by the JAX package from a seed and carried across with
``gpt_from_jax_params``. Tolerances: float32 pools atol 1e-5; codes
quantized from the same float32 inputs exactly, codes of K/V that each
package computed equal except that at most 0.1% may lie one code apart
(the two packages' f32 rows may fall on opposite sides of a .5 tie);
scales rtol 1e-6; tokens exactly.
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
from paddle_tpu.serving import GenerationEngine as JaxEngine
from paddle_tpu.serving import paging as jpaging
from paddle_tpu_torch.convert import gpt_from_jax_params
from paddle_tpu_torch.models import GPTConfig
from paddle_tpu_torch.models import generation as tgen
from paddle_tpu_torch.serving import GenerationEngine, PoolCapacityError
from paddle_tpu_torch.serving import kv_pool as tkv_pool
from paddle_tpu_torch.serving import paging as tpaging

VOCAB = 96
KV = ["int8", "float8_e4m3fn"]
QMAX = {"int8": 127.0, "float8_e4m3fn": 448.0}
TDT = {"int8": torch.int8, "float8_e4m3fn": torch.float8_e4m3fn}
JDT = {"int8": jnp.int8, "float8_e4m3fn": jnp.float8_e4m3fn}
L, H, DH = 2, 4, 16


@pytest.fixture(scope="module")
def models():
    """The 2-layer, hidden-64, 4-head GPT of test_torch_serving.py (wide
    embeddings: clear argmax margins) and its port twin."""
    paddle.seed(21)
    jcfg = JaxGPTConfig(vocab_size=VOCAB, hidden_size=64,
                        num_hidden_layers=L, num_attention_heads=H,
                        intermediate_size=128, max_position_embeddings=64,
                        hidden_dropout_prob=0.0, attention_dropout_prob=0.0,
                        initializer_range=0.5)
    jmodel = JaxGPT(jcfg)
    jmodel.eval()
    params = {k: np.asarray(v) for k, v in get_params_tree(jmodel).items()}
    tmodel = gpt_from_jax_params(
        params, GPTConfig(**dataclasses.asdict(jcfg)), device="cpu")
    return jmodel, tmodel


def _jtrees(jmodel):
    return get_params_tree(jmodel), get_buffers_tree(jmodel)


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else
                      jnp.asarray(x, jnp.float32))


def _codes(vals, kv):
    """float32 values already on the code grid -> the port's and the
    JAX package's pools of that storage type."""
    return (torch.from_numpy(vals).to(TDT[kv]),
            jnp.asarray(vals).astype(JDT[kv]))


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


def _random_quant_pool(rng, shape, kv):
    """Random codes and per-(layer, kv, block, head) scales."""
    vals = rng.randn(*shape).astype(np.float32)
    sc = np.abs(vals).max(axis=(-2, -1)) / QMAX[kv]
    codes = np.clip(np.round(vals / sc[..., None, None]), -QMAX[kv],
                    QMAX[kv])
    # fp8 codes go through the storage type once: exact in both packages
    codes = _np(torch.from_numpy(codes.astype(np.float32)).to(TDT[kv]))
    return codes, sc.astype(np.float32)


# ---------------------------------------------------------------------------
# one step of each builder
# ---------------------------------------------------------------------------

def test_slot_prefill_and_decode_steps_match_jax(models):
    """The dense steps: a left-padded prefill into slot 2, then one
    decode over 4 slots at different positions (the per-slot scatter
    puts ``[S, H, Dh]`` rows at ``pool[li, kv, s, :, pos[s], :]``), slot
    1 free."""
    jmodel, tmodel = models
    rng = np.random.RandomState(0)
    S, ML, Lb = 4, 32, 16
    pool = (0.5 * rng.randn(L, 2, S, H, ML, DH)).astype(np.float32)
    prompt = rng.randint(1, VOCAB, 11)
    ids = np.zeros((1, Lb), np.int32)
    ids[0, Lb - 11:] = prompt
    kv = np.zeros((1, Lb), bool)
    kv[0, Lb - 11:] = True
    params, buffers = _jtrees(jmodel)
    key = jax.random.PRNGKey(0)
    jfn = jgen.build_slot_prefill_fn(jmodel, Lb, ML)
    jpool, jfirst, _ = jfn(params, buffers, jnp.asarray(pool),
                           jnp.asarray(ids), jnp.asarray(kv), np.int32(2),
                           np.bool_(False), np.float32(1.0), key)
    tpool = torch.from_numpy(pool.copy())
    gen = torch.Generator().manual_seed(0)
    tfirst = tgen.build_slot_prefill_fn(tmodel, Lb, ML)(
        tpool, torch.from_numpy(ids).long(), torch.from_numpy(kv), 2,
        False, 1.0, gen)
    assert int(tfirst[0]) == int(jfirst[0])
    np.testing.assert_allclose(tpool.numpy(), np.asarray(jpool), atol=1e-5,
                               rtol=0)

    tokens = rng.randint(1, VOCAB, S).astype(np.int32)
    pos = np.asarray([20, 0, 16, 7], np.int32)
    lo = np.asarray([3, 0, 5, 0], np.int32)
    sample = np.zeros(S, bool)
    temps = np.ones(S, np.float32)
    jfn = jgen.build_slot_decode_fn(jmodel, S, ML)
    jpool2, jnxt, _ = jfn(params, buffers, jpool, *map(
        jnp.asarray, (tokens, pos, lo, sample, temps)), key)
    tnxt = tgen.build_slot_decode_fn(tmodel, S, ML)(
        tpool, *map(torch.from_numpy, (tokens, pos, lo, sample, temps)),
        gen)
    assert tnxt.dtype == torch.int32 and tuple(tnxt.shape) == (S + 1,)
    live = [0, 2, 3, S]                          # + the sentinel
    np.testing.assert_array_equal(tnxt.numpy()[live],
                                  np.asarray(jnxt)[live])
    np.testing.assert_allclose(tpool.numpy(), np.asarray(jpool2), atol=1e-5,
                               rtol=0)
    # each slot's row landed at its own position, nowhere else
    changed = np.abs(tpool.numpy() - np.asarray(jpool)).max(axis=(0, 1, 3,
                                                                  5))
    assert {(int(s), int(t)) for s, t in zip(*np.nonzero(changed > 1e-3))} \
        == {(s, int(pos[s])) for s in range(S)}


@pytest.mark.parametrize("kv", [None] + KV)
def test_paged_prefill_and_decode_steps_match_jax(models, kv):
    """The paged gather steps over a float or quantized pool: a
    right-padded 13-token prefill through a 2-block table, then one
    decode over 4 slots, two of them free (both write the scratch block
    at offset 0), one at a position past its bucket's first block."""
    jmodel, tmodel = models
    rng = np.random.RandomState(1)
    S, bs, NB, T, Lb = 4, 8, 12, 4, 16
    shape = (L, 2, NB + 1, H, bs, DH)
    quantized = kv is not None
    qmax = QMAX.get(kv, 127.0)
    if quantized:
        vals, scales = _random_quant_pool(rng, shape, kv)
        tpool, jpool = _codes(vals, kv)
        tscales = torch.from_numpy(scales.copy())
        jscales = jnp.asarray(scales)
        extra_t, extra_j = (tscales,), (jscales,)
    else:
        vals = (0.5 * rng.randn(*shape)).astype(np.float32)
        tpool, jpool = torch.from_numpy(vals.copy()), jnp.asarray(vals)
        extra_t = extra_j = ()
    params, buffers = _jtrees(jmodel)
    key = jax.random.PRNGKey(0)
    feed = rng.randint(1, VOCAB, 13)
    ids = np.zeros((1, Lb), np.int32)
    ids[0, :13] = feed
    kvalid = np.zeros((1, Lb), bool)
    kvalid[0, :13] = True
    table = np.asarray([5, 9], np.int32)
    jfn = jgen.build_paged_prefill_fn(jmodel, Lb, bs, quantized=quantized,
                                      qmax=qmax)
    jout = jfn(params, buffers, jpool, *extra_j, jnp.asarray(ids),
               jnp.asarray(kvalid), jnp.asarray(table), np.int32(13),
               np.bool_(False), np.float32(1.0), key)
    gen = torch.Generator().manual_seed(0)
    tfirst = tgen.build_paged_prefill_fn(tmodel, Lb, bs, quantized=quantized,
                                         qmax=qmax)(
        tpool, *extra_t, torch.from_numpy(ids).long(),
        torch.from_numpy(kvalid), torch.from_numpy(table), 13, False, 1.0,
        gen)
    jpool, jfirst = jout[0], jout[-2]
    if quantized:
        jscales = jout[1]
    assert int(tfirst[0]) == int(jfirst[0])

    def check(tpool, jpool, tscales=None, jscales=None):
        # block 0 excluded: duplicate scratch writes pick any winner
        if quantized:
            _assert_codes_close(_np(tpool)[:, :, 1:], _np(jpool)[:, :, 1:],
                                kv)
            np.testing.assert_allclose(tscales.numpy()[:, :, 1:],
                                       np.asarray(jscales)[:, :, 1:],
                                       rtol=1e-6, atol=0)
        else:
            np.testing.assert_allclose(_np(tpool)[:, :, 1:],
                                       _np(jpool)[:, :, 1:], atol=1e-5,
                                       rtol=0)

    check(tpool, jpool, *((tscales, jscales) if quantized else ()))
    tokens = np.asarray([int(jfirst[0]), 0, 7, 0], np.int32)
    pos = np.asarray([13, 0, 8, 0], np.int32)
    lo = np.zeros(S, np.int32)
    tables = np.zeros((S, T), np.int32)
    tables[0, :2] = table
    tables[2, :2] = [3, 11]
    sample = np.zeros(S, bool)
    temps = np.ones(S, np.float32)
    jfn = jgen.build_paged_decode_fn(jmodel, S, T, bs, quantized=quantized,
                                     qmax=qmax)
    jout = jfn(params, buffers, jpool, *((jscales,) if quantized else ()),
               *map(jnp.asarray, (tokens, pos, lo, tables, sample, temps)),
               key)
    tnxt = tgen.build_paged_decode_fn(tmodel, S, T, bs, quantized=quantized,
                                      qmax=qmax)(
        tpool, *extra_t,
        *map(torch.from_numpy, (tokens, pos, lo, tables, sample, temps)),
        gen)
    np.testing.assert_array_equal(tnxt.numpy()[[0, 2, S]],
                                  np.asarray(jout[-2])[[0, 2, S]])
    check(tpool, jout[0], *((tscales, jout[1]) if quantized else ()))


@pytest.mark.parametrize("kv", KV)
def test_quant_write_blocks_and_dequant_gather_match_jax(kv):
    rng = np.random.RandomState(2)
    shape = (L, 2, 9, H, 8, DH)
    tpool, jpool = _codes(np.zeros(shape, np.float32), kv)
    tscales = torch.zeros(shape[:4])
    jscales = jnp.zeros(shape[:4])
    vals = (3 * rng.randn(3, H, 8, DH)).astype(np.float32)
    vals[1, 2] = 0.0                                # an all-zero head
    table = np.asarray([4, 1, 7], np.int32)
    tgen._quant_write_blocks(tpool, tscales, 1, 0, torch.from_numpy(table),
                             torch.from_numpy(vals), QMAX[kv])
    jpool, jscales = jgen._quant_write_blocks(
        jpool, jscales, 1, 0, jnp.asarray(table), jnp.asarray(vals),
        QMAX[kv])
    np.testing.assert_array_equal(_np(tpool), _np(jpool))
    np.testing.assert_allclose(tscales.numpy(), np.asarray(jscales),
                               rtol=1e-6, atol=0)
    assert tscales[1, 0, 1, 2] == 0 and not tpool[1, 0, 1, 2].float().any()
    tables = np.asarray([[4, 1, 0], [7, 7, 4]], np.int32)
    got = tgen._dequant_gather(tpool, tscales, 1, 0,
                               torch.from_numpy(tables).long())
    want = jgen._dequant_gather(jpool, jscales, 1, 0, jnp.asarray(tables))
    assert got.dtype == torch.float32 and tuple(got.shape) == (2, 3, H, 8,
                                                              DH)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=0)


# ---------------------------------------------------------------------------
# the engines
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


def _mix(seed, n=24, preamble=16):
    """``n`` mixed requests; the first and two later ones share a
    ``preamble``-token prefix with short tails."""
    rng = np.random.RandomState(seed)
    pre = rng.randint(1, VOCAB, preamble)
    first = [(np.concatenate([pre, rng.randint(1, VOCAB, 3)]), 6)]
    rest = [(np.concatenate([pre, rng.randint(1, VOCAB, k)]), 8)
            for k in (5, 2)]
    rest += [(rng.randint(1, VOCAB, int(rng.randint(2, 21))),
              int(rng.randint(2, 13))) for _ in range(n - 3)]
    return first, rest


def _generate(tmodel, prompt, n):
    return tmodel.generate(torch.from_numpy(prompt[None]).long(),
                           max_new_tokens=n).numpy()[0]


def test_dense_engine_matches_jax_engine_and_generate(models):
    jmodel, tmodel = models
    first, rest = _mix(3)
    kw = dict(num_slots=8, max_len=48, min_bucket=8, prefill_budget=32)
    want, jstats = _serve(JaxEngine(jmodel, **kw), first, rest)
    got, stats = _serve(GenerationEngine(tmodel, device="cpu", **kw),
                        first, rest)
    assert len(got) == len(want) == 24
    for i, ((p, n), g, w) in enumerate(zip(first + rest, got, want)):
        np.testing.assert_array_equal(g, w, err_msg=f"request {i}")
        np.testing.assert_array_equal(g, _generate(tmodel, p, n),
                                      err_msg=f"request {i}")
    assert stats["kv_layout"] == jstats["kv_layout"] == "dense"
    assert stats["attention"] == jstats["attention"] == "gather"
    assert stats["prefills"] == 24 and stats["steps"] > 0
    assert stats["active_requests"] == 0 and stats["nonfinite_cycles"] == 0
    assert stats["ttft_ms"]["count"] == 24


@pytest.mark.parametrize("kv", [None, "int8"])
def test_paged_gather_engine_matches_jax_and_fused(models, kv):
    """The paged gather engine over a float or int8 pool: tokens equal
    to the JAX gather engine's with the same ``kv_dtype`` through a
    prefix hit (its tail replayed) and block-pressure preemption (the
    victim's history replayed), and, for the float pool, to the port's
    fused engine."""
    jmodel, tmodel = models
    if kv is None:
        first, rest = _mix(4)
        bs, nb = 8, 12
    else:
        # blocks of 32: one cached preamble block; prompts of 24-30
        # tokens that grow into a second block, 4 blocks among 4 slots
        rng = np.random.RandomState(4)
        pre = rng.randint(1, VOCAB, 32)
        first = [(np.concatenate([pre, rng.randint(1, VOCAB, 3)]), 6)]
        rest = [(np.concatenate([pre, rng.randint(1, VOCAB, 5)]), 10)]
        rest += [(rng.randint(1, VOCAB, int(rng.randint(24, 31))),
                  int(rng.randint(16, 25))) for _ in range(5)]
        bs, nb = 32, 4
    kw = dict(num_slots=4, max_len=64, kv_layout="paged", block_size=bs,
              num_blocks=nb, kv_dtype=kv, attention="gather")
    want, jstats = _serve(JaxEngine(jmodel, **kw), first, rest)
    got, stats = _serve(GenerationEngine(tmodel, device="cpu", **kw),
                        first, rest)
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(g, w, err_msg=f"request {i}")
    assert stats["prefix_hits"] >= 1 and jstats["prefix_hits"] >= 1
    assert stats["preempts"] >= 1
    assert stats["kv_blocks_in_use"] == 0 and stats["active_requests"] == 0
    assert stats["nonfinite_cycles"] == 0
    assert stats["kv_dtype"] == jstats["kv_dtype"]
    assert stats["kv_bytes"] == jstats["kv_bytes"]
    assert stats["prefills"] == stats["prefix_misses"]
    if kv is None:
        fused = dict(kw, attention="fused", prefill_budget=16)
        got_f, _ = _serve(GenerationEngine(tmodel, device="cpu", **fused),
                          first, rest)
        for i, (g, f) in enumerate(zip(got, got_f)):
            np.testing.assert_array_equal(g, f, err_msg=f"request {i}")


@pytest.mark.parametrize("kv", [None] + KV)
def test_copy_on_write_in_the_gather_engine_matches_jax(models, kv):
    """A slot whose write position lies inside a shared block (the
    normal flow writes past it; copy-on-write is the guard rail): the
    same copy order, table swap and copied block (codes and scales) as
    the JAX engine's."""
    jmodel, tmodel = models
    bs = 8 if kv is None else 32
    kw = dict(num_slots=2, max_len=64, kv_layout="paged", block_size=bs,
              kv_dtype=kv)
    prompt = np.arange(1, bs + 4) % VOCAB + 1      # one full block + 3
    pools = []
    for eng in (JaxEngine(jmodel, **kw),
                GenerationEngine(tmodel, device="cpu", **kw)):
        eng.submit(prompt, max_new_tokens=2).result(timeout=300)
        pool = eng._pool
        shared = pool.match_prefix(list(prompt) + [1])
        assert len(shared) == 1
        a, b = pool.alloc(), pool.alloc()
        pool.admit_cached(a, shared)
        pool.admit_cached(b, shared)
        pool.set_slot(b, pos=3, lo=0)
        cow = pool.ensure_writable(b)
        eng._run_copy(*cow)
        pools.append((cow, pool.slot_table(b), pool.slot_table(a),
                      _np(pool.data),
                      None if kv is None else _np(pool.scales)))
        pool.free(a)
        pool.free(b)
        eng.close()
    (jcow, jtab, jown, jdata, jsc), (tcow, ttab, town, tdata, tsc) = pools
    assert tcow == jcow and ttab == jtab and town == jown
    dst, src = tcow
    assert dst != src and ttab == [dst] and town == [src]
    np.testing.assert_array_equal(tdata[:, :, dst], tdata[:, :, src])
    if kv is None:
        np.testing.assert_allclose(tdata[:, :, 1:], jdata[:, :, 1:],
                                   atol=1e-5, rtol=0)
    else:
        _assert_codes_close(tdata[:, :, 1:], jdata[:, :, 1:], kv)
        np.testing.assert_allclose(tsc[:, :, 1:], jsc[:, :, 1:], rtol=1e-6,
                                   atol=0)


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_eos_stops_early_like_generate(models, layout):
    _, tmodel = models
    p = np.random.RandomState(3).randint(1, VOCAB, 6)
    ref8 = _generate(tmodel, p, 8)
    eos = int(ref8[6 + 2])
    ref = tmodel.generate(torch.from_numpy(p[None]).long(), max_new_tokens=8,
                          eos_token_id=eos, pad_token_id=0).numpy()[0]
    with GenerationEngine(tmodel, num_slots=2, max_len=48, block_size=8,
                          kv_layout=layout, device="cpu") as eng:
        h = eng.submit(p, max_new_tokens=8, eos_token_id=eos)
        out = h.result(timeout=300)
    np.testing.assert_array_equal(out, ref)
    assert h.tokens == list(ref8[6:6 + list(ref8[6:]).index(eos) + 1])


def test_prefill_budget_is_charged_only_when_a_prefill_runs(models):
    """While slots decode, a cycle's prefills may spend at most
    ``prefill_budget`` bucket tokens; a paged prefix hit runs no program
    and is not charged. Both engines admit the same way."""
    jmodel, tmodel = models
    rng = np.random.RandomState(6)
    pre = rng.randint(1, VOCAB, 16)
    other = rng.randint(1, VOCAB, 20)
    kw = dict(num_slots=4, max_len=64, kv_layout="paged", block_size=8,
              prefill_budget=16)
    outs = []
    for eng in (JaxEngine(jmodel, **kw),
                GenerationEngine(tmodel, device="cpu", **kw)):
        eng.submit(np.concatenate([pre, [5]]), max_new_tokens=2).result(
            timeout=300)
        hs = [eng.submit(np.concatenate([pre, tail]), max_new_tokens=6)
              for tail in ([7, 8], [9], [10, 11, 12])]
        hs.append(eng.submit(other, max_new_tokens=6))
        outs.append([h.result(timeout=300) for h in hs])
        s = eng.stats()
        eng.close()
    for j, t in zip(*outs):
        np.testing.assert_array_equal(t, j)
    assert s["prefix_hits"] == 3 and s["prefills"] == 2


def test_validation_matches_jax(models):
    jmodel, tmodel = models
    with pytest.raises(ValueError, match="requires kv_layout='paged'"):
        JaxEngine(jmodel, kv_layout="dense", kv_dtype="int8")
    with pytest.raises(ValueError, match="requires kv_layout='paged'"):
        GenerationEngine(tmodel, kv_layout="dense", kv_dtype="int8",
                         device="cpu")
    with pytest.raises(ValueError, match="requires kv_layout='paged'"):
        GenerationEngine(tmodel, kv_layout="dense", attention="fused",
                         device="cpu")
    for eng_cls, kw in ((JaxEngine, {}), (GenerationEngine,
                                          dict(device="cpu"))):
        for layout in ("dense", "paged"):
            with pytest.raises(ValueError, match="max_position_embeddings"):
                eng_cls(jmodel if eng_cls is JaxEngine else tmodel,
                        max_len=128, kv_layout=layout, block_size=8, **kw)
    for mod, extra in ((jpaging, {}), (tpaging, dict(device="cpu"))):
        with pytest.raises(ValueError, match="multiple"):
            mod.PagedKVPool(1, 2, 1, 32, 8, block_size=8, min_bucket=12,
                            **extra)
    for name in ("mesh", "hbm_budget_bytes"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            GenerationEngine(tmodel, device="cpu", **{name: object()})
    # the paged engine rounds min_bucket up to whole blocks, as JAX's does
    with GenerationEngine(tmodel, max_len=48, kv_layout="paged",
                          block_size=8, min_bucket=12, device="cpu") as eng:
        assert eng._pool.min_bucket == 16
        # footprint 34 <= 48, but bucket_for(33) = 64 > 48
        with pytest.raises(PoolCapacityError, match="prefill bucket"):
            eng.submit(np.ones(33, np.int32), max_new_tokens=1)
        with pytest.raises(PoolCapacityError, match="preemption"):
            eng.submit(np.ones(20, np.int32), max_new_tokens=14)
        assert eng.submit(np.ones(20, np.int32), max_new_tokens=13).result(
            timeout=300).shape == (33,)
    jeng = JaxEngine(jmodel, max_len=48, kv_layout="paged", block_size=8)
    with pytest.raises(ValueError, match="prefill bucket"):
        jeng.submit(np.ones(33, np.int32), max_new_tokens=1)
    jeng.close()
    with GenerationEngine(tmodel, max_len=32, min_bucket=8,
                          device="cpu") as eng:
        # dense: the prompt's bucket (16) + max_new must fit max_len
        with pytest.raises(ValueError, match="prompt bucket 16"):
            eng.submit(np.ones(9, np.int32), max_new_tokens=17)
        assert eng.stats()["kv_layout"] == "dense"
    jeng = JaxEngine(jmodel, max_len=32, min_bucket=8)
    with pytest.raises(ValueError, match="prompt bucket 16"):
        jeng.submit(np.ones(9, np.int32), max_new_tokens=17)
    jeng.close()


def test_dense_pool_buckets_and_positions():
    pool = tkv_pool.KVCachePool(2, 3, 4, 64, 16, min_bucket=8, device="cpu")
    assert pool.data.shape == (2, 2, 3, 4, 64, 16)
    assert pool.buckets() == [8, 16, 32, 64]
    assert [pool.bucket_for(n) for n in (1, 8, 9, 33)] == [8, 8, 16, 64]
    a, b = pool.alloc(), pool.alloc()
    pool.set_slot(b, pos=16, lo=5)
    pos, lo = pool.position_arrays()
    assert pos.tolist() == [0, 16, 0] and lo.tolist() == [0, 5, 0]
    assert pool.slot_lo(b) == 5 and a == 0
    with pytest.raises(ValueError, match="below min_bucket"):
        tkv_pool.KVCachePool(1, 1, 1, 4, 1, min_bucket=8, device="cpu")


def test_scheduler_takes_one_mode():
    """The callables given pick the scheduler's mode: the bucketed pair
    or the chunked pair, whole, and never parts of both."""
    from paddle_tpu_torch.serving.scheduler import Scheduler

    pool = tkv_pool.KVCachePool(1, 2, 1, 16, 4, min_bucket=8, device="cpu")

    def f(*a):
        return None

    for kw in (dict(do_prefill=f), dict(do_decode=f), dict(do_admit=f),
               dict(do_chunked_step=f),
               dict(do_prefill=f, do_decode=f, do_admit=f),
               dict(do_admit=f, do_chunked_step=f, do_prefill=f)):
        with pytest.raises(ValueError, match="bucketed mode"):
            Scheduler(pool, **kw)
    for kw in (dict(do_prefill=f, do_decode=f),
               dict(do_admit=f, do_chunked_step=f)):
        Scheduler(pool, **kw).close()
