"""The speculative-decoding functions of the PyTorch port against their
JAX twins on the same numpy inputs, on the CPU:

* ``build_spec_verify_fn``: one verify launch mixing two speculating
  slots (one accepting every candidate, one rejecting its second), a
  prefill chunk and an absent slot, greedy: accepted counts, corrected
  tokens and the draft echo equal, the float32 pool within 1e-5 (block 0
  excluded: pad rows write it with any winner); over an int8 pool (blocks
  of 32) the same tokens;
* ``build_draft_prefill_fn`` then ``build_draft_propose_scan_fn`` (and one
  ``build_draft_propose_fn`` step) over the dense draft pool: greedy
  proposals equal, probabilities within 1e-5, the draft pool within 1e-5,
  a slot at ``max_len - 2`` clamping its later steps to ``max_len - 1``,
  and a sampled slot's first-step distribution within 1e-5;
* ``_spec_accept`` on one-hot distributions (``tests/test_spec_decode.py``'s
  cases, a slot verifying nothing, a slot verifying fewer than
  ``spec_k``): exactly the JAX results; ``_sample_probs`` with top-k,
  top-p and temperatures within 1e-6.

Sampled draws come from different generators (``jax.random`` keys, a
``torch.Generator``) and are compared in distribution only, in
``tests/test_torch_spec_decode.py``. The model is
``tests/test_spec_decode.py``'s trained tiny char GPT, carried across
with ``gpt_from_jax_params``.
"""
import dataclasses

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
from paddle_tpu.ops.ragged_paged_attention import \
    ragged_layout as jax_ragged_layout
from paddle_tpu_torch.convert import gpt_from_jax_params
from paddle_tpu_torch.models import GPTConfig
from paddle_tpu_torch.models import generation as tgen

VOCAB = 96


@pytest.fixture(scope="module")
def models():
    """The trained tiny char GPT of tests/test_spec_decode.py (JAX) and
    the port's copy of its weights."""
    paddle.seed(11)
    jcfg = JaxGPTConfig(vocab_size=VOCAB, hidden_size=64,
                        num_hidden_layers=2, num_attention_heads=4,
                        intermediate_size=128, max_position_embeddings=64,
                        hidden_dropout_prob=0.0, attention_dropout_prob=0.0)
    jmodel = JaxGPT(jcfg)
    opt = paddle.optimizer.Adam(learning_rate=3e-3,
                                parameters=jmodel.parameters())
    corpus = ("the quick brown fox jumps over the lazy dog. "
              "pack my box with five dozen liquor jugs. ") * 6
    data = np.frombuffer(corpus.encode(), np.uint8).astype(np.int32) % VOCAB
    rng = np.random.RandomState(0)
    for _ in range(30):
        starts = rng.randint(0, len(data) - 25, 8)
        chunk = np.stack([data[s:s + 25] for s in starts])
        loss, _ = jmodel(paddle.to_tensor(chunk[:, :-1]),
                         paddle.to_tensor(chunk[:, 1:].astype(np.int64)))
        loss.backward()
        opt.step()
        opt.clear_grad()
    jmodel.eval()
    params = {k: np.asarray(v) for k, v in get_params_tree(jmodel).items()}
    tmodel = gpt_from_jax_params(
        params, GPTConfig(**dataclasses.asdict(jcfg)), device="cpu")
    return jmodel, tmodel.eval()


def _jtree(model):
    return get_params_tree(model), get_buffers_tree(model)


# -- the verify launch --------------------------------------------------------

S, K, BS, T = 4, 4, 8, 4


def _verify_operands(rng, n_spec, chunk, Q, bs=BS):
    """Ragged operands of a launch: slot 0 verifies n_spec[0] candidates
    from position 10, slot 1 feeds a 9-row chunk from 5, slot 2 is
    absent, slot 3 verifies n_spec[3] from 3."""
    q_lens = [n_spec[0], chunk, 0, n_spec[3]]
    pos0s = [10, 5, 0, 3]
    tables = np.zeros((S, T), np.int32)
    tables[0, :2] = [7, 3]
    tables[1, :2] = [12, 1]
    tables[3, :1] = [9]
    blk_seq, qstart, pos0, last_row, _ = jax_ragged_layout(
        q_lens, pos0s, q_bucket=Q)
    token_ids = np.zeros(Q, np.int32)
    qpos = np.zeros(Q, np.int32)
    wb = np.zeros(Q, np.int32)
    wo = np.zeros(Q, np.int32)
    for s, n in enumerate(q_lens):
        for i in range(n):
            r, p = qstart[s] + i, pos0s[s] + i
            # a verify slot knows only its first row's token on the host
            if i == 0 or s == 1:
                token_ids[r] = rng.randint(1, VOCAB)
            qpos[r] = p
            wb[r], wo[r] = tables[s, p // bs], p % bs
    kv_len = np.asarray([p + n for p, n in zip(pos0s, q_lens)], np.int32)
    return (token_ids, qpos, wb, wo, blk_seq, qstart, pos0, tables,
            np.zeros(S, np.int32), kv_len, last_row)


def _run_verify(tmodel, jmodel, pool, ops, n_spec, drafts, Q, scales=None,
                qmax=127.0, bs=BS):
    """The port's and the JAX verify on copies of ``pool`` (and
    ``scales``); greedy, one-hot draft distributions. Returns ((port
    out, port pool), (JAX out, JAX pool))."""
    quant = scales is not None
    dprobs = np.eye(VOCAB, dtype=np.float32)[drafts]
    sample = np.zeros(S, bool)
    temps = np.ones(S, np.float32)
    tail = (n_spec, drafts, dprobs, sample, temps)
    tfn = tgen.build_spec_verify_fn(tmodel, S, Q, K, T, bs, quantized=quant,
                                    qmax=qmax)
    tpool = torch.from_numpy(pool.copy())
    tsc = (torch.from_numpy(scales.copy()),) if quant else ()
    tout = tfn(tpool, *tsc, *map(torch.from_numpy, ops + tail),
               torch.Generator().manual_seed(0))
    jfn = jgen.build_spec_verify_fn(jmodel, S, Q, K, T, bs, quantized=quant,
                                    qmax=qmax)
    jsc = (jnp.asarray(scales),) if quant else ()
    res = jfn(*_jtree(jmodel), jnp.asarray(pool), *jsc,
              *map(jnp.asarray, ops + tail), jax.random.PRNGKey(0))
    return (tout.numpy(), tpool.numpy()), (np.asarray(res[-2]),
                                           np.asarray(res[0]))


def _accepting_drafts(tmodel, jmodel, pool, ops, n_spec, Q):
    """Draft tokens the target accepts in full: each round replaces the
    first rejected candidate by the corrected token."""
    drafts = np.ones((S, K), np.int32)
    for _ in range(K):
        (out, _), _ = _run_verify(tmodel, jmodel, pool, ops, n_spec, drafts,
                                  Q)
        for s in (0, 3):
            a = int(out[s])
            if a < n_spec[s]:
                drafts[s, a] = out[S + s]
    return drafts


def test_spec_verify_matches_jax(models):
    jmodel, tmodel = models
    rng = np.random.RandomState(0)
    L, H, Dh, NB, Q = 2, 4, 16, 16, 32
    pool = (0.5 * rng.randn(L, 2, NB + 1, H, BS, Dh)).astype(np.float32)
    n_spec = np.array([4, 0, 0, 3], np.int32)
    ops = _verify_operands(rng, n_spec, 9, Q)
    drafts = _accepting_drafts(tmodel, jmodel, pool, ops, n_spec, Q)
    drafts[3, 1] = (drafts[3, 1] + 1) % VOCAB    # slot 3 rejects its 2nd
    (tout, tpool), (jout, jpool) = _run_verify(tmodel, jmodel, pool, ops,
                                               n_spec, drafts, Q)
    assert tout.dtype == np.int32 and tout.shape == (2 * S + S * K + 1,)
    present = [0, 1, 3]
    np.testing.assert_array_equal(tout[:S][present], jout[:S][present])
    np.testing.assert_array_equal(tout[S:2 * S][present],
                                  jout[S:2 * S][present])
    np.testing.assert_array_equal(tout[2 * S:], jout[2 * S:])
    assert list(tout[:S][[0, 3]]) == [4, 1]      # full accept; reject at 2
    assert tout[-1] == 0                          # logits finite
    np.testing.assert_allclose(tpool[:, :, 1:], jpool[:, :, 1:], atol=1e-5,
                               rtol=0)
    with pytest.raises(ValueError, match="q_rows"):
        tgen.build_spec_verify_fn(tmodel, S, 12, K, T, BS)
    with pytest.raises(ValueError, match="spec_k"):
        tgen.build_spec_verify_fn(tmodel, S, Q, 0, T, BS)
    from paddle_tpu_torch.framework import trace_probe
    site = trace_probe.site("test/spec_verify_probe")
    tgen.build_spec_verify_fn(tmodel, S, Q, K, T, BS, probe=site)
    assert site.traces == 1 and site.last_static == {"q": Q, "table": T,
                                                     "k": K}


def test_spec_verify_int8_pool_matches_jax(models):
    """The same launch over an int8 pool in blocks of 32: the rows land
    through the quantized append (scales only grow), the kernel reads
    codes times scales; the same accepted/corrected/echo as JAX."""
    jmodel, tmodel = models
    rng = np.random.RandomState(1)
    L, H, Dh, NB, Q, bs = 2, 4, 16, 16, 32, 32
    vals = 0.5 * rng.randn(L, 2, NB + 1, H, bs, Dh)
    scales = (np.abs(vals).max(axis=(-2, -1)) / 127.0).astype(np.float32)
    pool = np.round(vals / scales[..., None, None]).astype(np.int8)
    n_spec = np.array([4, 0, 0, 3], np.int32)
    ops = _verify_operands(rng, n_spec, 9, Q, bs=bs)
    drafts = rng.randint(1, VOCAB, (S, K)).astype(np.int32)
    (tout, _), (jout, _) = _run_verify(tmodel, jmodel, pool, ops, n_spec,
                                       drafts, Q, scales=scales, bs=bs)
    present = [0, 1, 3]
    np.testing.assert_array_equal(tout[:2 * S].reshape(2, S)[:, present],
                                  jout[:2 * S].reshape(2, S)[:, present])
    np.testing.assert_array_equal(tout[2 * S:], jout[2 * S:])


# -- the draft chain ---------------------------------------------------------

DS, DL = 3, 32          # draft slots, draft pool positions


def test_draft_prefill_and_scan_match_jax(models):
    jmodel, tmodel = models
    jdraft = jgen.make_draft_model(jmodel, 1)
    tdraft = tgen.make_draft_model(tmodel, 1)
    H, Dh = 4, 16
    shape = (1, 2, DS, H, DL, Dh)
    tpool = torch.zeros(shape)
    jpool = jnp.zeros(shape, jnp.float32)
    rng = np.random.RandomState(3)
    ctx = {1: rng.randint(1, VOCAB, 11), 2: rng.randint(1, VOCAB, 5)}
    for slot, c in ctx.items():
        b = 16 if c.size > 8 else 8
        ids = np.zeros((1, b), np.int32)
        ids[0, :c.size] = c
        kv = np.zeros((1, b), bool)
        kv[0, :c.size] = True
        tgen.build_draft_prefill_fn(tdraft, b, DL)(
            tpool, torch.from_numpy(ids).long(), torch.from_numpy(kv), slot)
        jpool = jgen.build_draft_prefill_fn(jdraft, b, DL)(
            *_jtree(jdraft), jpool, ids, kv, np.int32(slot))
    np.testing.assert_allclose(tpool.numpy(), np.asarray(jpool), atol=1e-5,
                               rtol=0)

    # slot 0 sits at DL - 2 over an empty context: its later steps clamp
    feed = np.array([7, 21, 40], np.int32)
    pos = np.array([DL - 2, 11, 5], np.int32)
    lo = np.zeros(DS, np.int32)
    sample = np.array([False, False, True])
    temps = np.array([1.0, 1.0, 0.7], np.float32)
    kk = 3
    tprops, tprobs = tgen.build_draft_propose_scan_fn(
        tdraft, DS, DL, kk, top_k=20, top_p=0.9)(
        tpool, *map(torch.from_numpy, (feed, pos, lo, sample, temps)),
        torch.Generator().manual_seed(0))
    jres = jgen.build_draft_propose_scan_fn(
        jdraft, DS, DL, kk, top_k=20, top_p=0.9)(
        *_jtree(jdraft), jpool, feed, pos, lo, sample, temps,
        jax.random.PRNGKey(0))
    jpool2, jprops, jprobs = (np.asarray(x) for x in jres[:3])
    assert tprops.shape == (DS, kk) and tprobs.shape == (DS, kk, VOCAB)
    greedy = [0, 1]
    np.testing.assert_array_equal(tprops.numpy()[greedy], jprops[greedy])
    np.testing.assert_allclose(tprobs.numpy()[greedy], jprobs[greedy],
                               atol=1e-5, rtol=0)
    # the sampled slot: the same first-step distribution (later steps
    # feed draws of different generators)
    np.testing.assert_allclose(tprobs.numpy()[2, 0], jprobs[2, 0],
                               atol=1e-5, rtol=0)
    assert (tprobs.numpy()[2, 0] > 0).sum() <= 20
    np.testing.assert_allclose(tpool.numpy()[:, :, greedy],
                               jpool2[:, :, greedy], atol=1e-5, rtol=0)

    # one unrolled step over the scanned pool, as the JAX step
    tprop, tpr = tgen.build_draft_propose_fn(tdraft, DS, DL)(
        tpool, *map(torch.from_numpy, (feed, pos - 1, lo,
                                       np.zeros(DS, bool), temps)),
        torch.Generator().manual_seed(0))
    jres = jgen.build_draft_propose_fn(jdraft, DS, DL)(
        *_jtree(jdraft), jnp.asarray(jpool2), feed, pos - 1, lo,
        np.zeros(DS, bool), temps, jax.random.PRNGKey(0))
    np.testing.assert_array_equal(tprop.numpy()[greedy],
                                  np.asarray(jres[1])[greedy])
    np.testing.assert_allclose(tpr.numpy()[greedy],
                               np.asarray(jres[2])[greedy], atol=1e-5,
                               rtol=0)
    with pytest.raises(ValueError, match="max_position_embeddings"):
        tgen.build_draft_propose_scan_fn(tdraft, DS, 128, 2)
    with pytest.raises(ValueError, match="exceeds pool max_len"):
        tgen.build_draft_prefill_fn(tdraft, 64, DL)


# -- the sampler -------------------------------------------------------------

def _accept_both(p, q, d, n, base):
    t = tgen._spec_accept(*(torch.from_numpy(np.asarray(x))
                            for x in (p, q, d, n, base)),
                          torch.Generator().manual_seed(0))
    j = jgen._spec_accept(*(jnp.asarray(x) for x in (p, q, d, n, base)),
                          jax.random.PRNGKey(0))
    return [x.numpy() for x in t], [np.asarray(x) for x in j]


def test_spec_accept_one_hot_cases_match_jax():
    V = 8
    eye = np.eye(V, dtype=np.float32)
    cases = [
        # target argmaxes 1,2,3, draft 1,5,3: accept 1, correct to 2
        (eye[[1, 2, 3]][None], eye[[1, 5, 3]][None], [[1, 5, 3]], [3]),
        # full agreement
        (eye[[1, 2, 3]][None], eye[[1, 2, 3]][None], [[1, 2, 3]], [3]),
        # two slots: one verifies 2 of 3, one nothing (its base draw)
        (eye[[[4, 6, 0], [2, 2, 2]]], eye[[[4, 6, 7], [5, 5, 5]]],
         [[4, 6, 7], [5, 5, 5]], [2, 0]),
        # the first candidate rejected
        (eye[[[3, 3, 3]]], eye[[[1, 3, 3]]], [[1, 3, 3]], [3]),
    ]
    for p, q, d, n in cases:
        p, q = np.asarray(p), np.asarray(q)
        d, n = np.asarray(d, np.int32), np.asarray(n, np.int32)
        base = eye[[6] * p.shape[0]]
        (ta, tt), (ja, jt) = _accept_both(p, q, d, n, base)
        np.testing.assert_array_equal(ta, ja)
        # the token is read only when a candidate was rejected or none
        # was verified
        read = (ja < n) | (n == 0)
        np.testing.assert_array_equal(tt[read], jt[read])
    (ta, tt), _ = _accept_both(*cases[2][:2], np.asarray(cases[2][2],
                                                         np.int32),
                               np.asarray([2, 0], np.int32), eye[[6, 6]])
    assert list(ta) == [2, 0] and list(tt) == [6, 6]


def test_sample_probs_match_jax():
    rng = np.random.RandomState(5)
    logits = (2 * rng.randn(6, VOCAB)).astype(np.float32)
    mask = np.array([True, False, True, True, False, True])
    temps = np.array([1.0, 1.0, 0.5, 1.7, 1.0, 0.9], np.float32)
    for top_k, top_p in ((0, 1.0), (10, 1.0), (0, 0.8), (12, 0.7)):
        t = tgen._sample_probs(torch.from_numpy(logits),
                               torch.from_numpy(mask), top_k, top_p,
                               torch.from_numpy(temps))
        j = jgen._sample_probs(jnp.asarray(logits), jnp.asarray(mask),
                               top_k, top_p, jnp.asarray(temps))
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=1e-6,
                                   rtol=0)
        np.testing.assert_array_equal(t.numpy()[~mask].argmax(-1),
                                      logits[~mask].argmax(-1))
