"""Speculative decoding of the PyTorch port
(``GenerationEngine(kv_layout="paged", attention="fused", spec_draft=...,
spec_k=...)``) against the JAX package, on the CPU:

* greedy parity: 12 mixed concurrent requests through the port's
  speculative engine with a weak 1-layer draft (real rejections, blocks
  of 8) give the tokens of the JAX speculative engine of the same
  configuration, of the JAX ``generate`` and of the port's
  non-speculative fused engine; each speculative cycle's flight-recorder
  record holds exactly one draft dispatch;
* the same tokens as the JAX ``generate`` over an int8 pool (blocks of
  32), under block pressure with a preemption and prefix hits
  (``num_blocks=12``, a shared system prompt) and with the agreeing
  draft (draft == target) through reused slots: accept rate exactly
  1.0, more than one token per slot-cycle — the check a stale draft
  cache after preemption or slot reuse would fail;
* the rejection-sampling identity: the first emitted token of a cycle is
  distributed as the target's ``p`` (within 0.02), whatever the draft's
  ``q``, drawn with a ``torch.Generator``; one-hot (greedy) cases
  exactly;
* machinery: the signed ``advance`` and ``unpublish_from`` of the port's
  pool, ``make_draft_model``'s shared embeddings, construction errors.

The model is ``tests/test_spec_decode.py``'s tiny char GPT (2 layers,
hidden 64), trained a few steps by the JAX package and carried across
with ``gpt_from_jax_params``: trained logits have clear argmax margins,
so float32 parity is token-exact. The JAX test's ``analyze()`` and
retrace checks have no counterpart in the eager port and are left out.
"""
import dataclasses

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models import GPTConfig as JaxGPTConfig
from paddle_tpu.models import GPTForPretraining as JaxGPT
from paddle_tpu.models import generate as jax_generate
from paddle_tpu.models.generation import \
    make_draft_model as jax_make_draft_model
from paddle_tpu.nn.layer.layers import get_params_tree
from paddle_tpu.serving import GenerationEngine as JaxEngine
from paddle_tpu_torch.convert import gpt_from_jax_params
from paddle_tpu_torch.models import GPTConfig, GPTForPretraining
from paddle_tpu_torch.models.generation import (_categorical_probs,
                                                _spec_accept,
                                                make_draft_model)
from paddle_tpu_torch.serving import GenerationEngine, PagedKVPool

VOCAB = 96


@pytest.fixture(scope="module")
def models():
    """(JAX model, port model): the tiny char GPT of
    tests/test_spec_decode.py trained 30 Adam steps in the JAX package,
    and the port's copy of its weights."""
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
    seq, batch = 24, 8
    for _ in range(30):
        starts = rng.randint(0, len(data) - seq - 1, batch)
        chunk = np.stack([data[s:s + seq + 1] for s in starts])
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


def _prompt(rng, n):
    return rng.randint(1, VOCAB, n).astype(np.int32)


def _refs(jmodel, prompts, news, eos=None):
    kw = {} if eos is None else {"eos_token_id": eos}
    return [jax_generate(jmodel, p[None, :], max_new_tokens=n,
                         **kw).numpy()[0] for p, n in zip(prompts, news)]


def _serve(engine, prompts, news, eos=None):
    kw = {} if eos is None else {"eos_token_id": eos}
    hs = [engine.submit(p, max_new_tokens=n, **kw)
          for p, n in zip(prompts, news)]
    outs = [h.result(timeout=300) for h in hs]
    stats = engine.stats()
    engine.close()
    return outs, stats


FUSED = dict(num_slots=8, max_len=48, kv_layout="paged", block_size=8,
             attention="fused", prefill_budget=16)


def test_weak_draft_mix_matches_jax_engine_generate_and_plain(models):
    jmodel, tmodel = models
    rng = np.random.RandomState(2)
    specs = [(_prompt(rng, int(rng.randint(2, 21))),
              int(rng.randint(2, 12))) for _ in range(12)]
    prompts, news = [p for p, _ in specs], [n for _, n in specs]
    refs = _refs(jmodel, prompts, news, eos=3)
    j_outs, j_stats = _serve(
        JaxEngine(jmodel, spec_draft=jax_make_draft_model(jmodel, 1),
                  spec_k=4, **FUSED), prompts, news, eos=3)
    eng = GenerationEngine(tmodel, spec_draft=make_draft_model(tmodel, 1),
                           spec_k=4, device="cpu", **FUSED)
    outs, stats = _serve(eng, prompts, news, eos=3)
    plain, _ = _serve(GenerationEngine(tmodel, device="cpu", **FUSED),
                      prompts, news, eos=3)
    for i, ref in enumerate(refs):
        np.testing.assert_array_equal(j_outs[i], ref)
        np.testing.assert_array_equal(outs[i], ref)
        np.testing.assert_array_equal(plain[i], ref)
    # a weak draft: real rejections, corrected tokens
    assert 0 < stats["spec_accept_rate"] < 1.0
    assert stats["spec_proposed"] > stats["spec_accepted"] > 0
    assert stats["draft_layers"] == j_stats["draft_layers"] == 1
    assert stats["spec_k"] == 4 and stats["spec_cycles"] > 0
    assert stats["kv_bytes"]["draft"] == j_stats["kv_bytes"]["draft"]
    assert stats["requests_retired"] == len(prompts)
    # the whole proposal chain is one call each speculative cycle
    cycles = eng.flight_recorder.snapshot()["cycles"]
    disp = [c["spec_draft_dispatches"] for c in cycles
            if "spec_draft_dispatches" in c]
    assert disp and all(d == 1 for d in disp), disp
    spec = [c for c in cycles if "spec_proposed" in c]
    assert len(spec) == len(disp) == stats["spec_cycles"]
    assert sum(c["spec_accepted"] for c in spec) == stats["spec_accepted"]


def test_int8_pool_matches_generate(models):
    jmodel, tmodel = models
    rng = np.random.RandomState(4)
    prompts = [_prompt(rng, n) for n in (5, 11, 3)]
    refs = _refs(jmodel, prompts, [8] * 3)
    outs, stats = _serve(GenerationEngine(
        tmodel, num_slots=4, max_len=64, kv_layout="paged", block_size=32,
        attention="fused", kv_dtype="int8", spec_draft=tmodel, spec_k=4,
        prefill_budget=16, device="cpu"), prompts, [8] * 3)
    for ref, out in zip(refs, outs):
        np.testing.assert_array_equal(out, ref)
    assert stats["kv_dtype"] == "int8"
    assert stats["spec_accept_rate"] == 1.0


def test_agreeing_draft_under_preemption_and_prefix_hits(models):
    """Draft == target under block pressure with a shared system
    prompt: every candidate is accepted (a stale draft cache after a
    preemption or a slot's reuse would propose wrong tokens here), more
    than one token a slot-cycle, prefix hits, the blocks all returned."""
    jmodel, tmodel = models
    rng = np.random.RandomState(6)
    system = (np.arange(1, 17) % (VOCAB - 2) + 1).astype(np.int32)
    prompts = [np.concatenate([system, _prompt(rng, n)])
               for n in (5, 9, 3, 7)]
    refs = _refs(jmodel, prompts, [20] * 4)
    eng = GenerationEngine(
        tmodel, num_slots=3, max_len=64, kv_layout="paged", block_size=8,
        num_blocks=12, attention="fused", spec_draft=tmodel, spec_k=4,
        prefill_budget=16, device="cpu")
    outs, stats = _serve(eng, prompts, [20] * 4)
    for ref, out in zip(refs, outs):
        np.testing.assert_array_equal(out, ref)
    assert stats["preempts"] > 0 and stats["prefix_hits"] > 0
    assert stats["spec_accept_rate"] == 1.0
    assert stats["spec_accepted"] == stats["spec_proposed"] > 0
    assert stats["spec_tokens_per_cycle"] > 1.0
    assert eng._pool.blocks_in_use == 0


def test_agreeing_draft_multiplies_tokens_per_cycle(models):
    """Draft == target, 6 requests of unrelated prompts through 2 slots:
    every candidate is accepted, so each reused slot's draft cache was
    rebuilt for its new request (a stale one takes the accept rate to
    about 0.4 here)."""
    jmodel, tmodel = models
    rng = np.random.RandomState(9)
    prompts = [_prompt(rng, n) for n in (5, 9, 14, 3, 11, 7)]
    refs = _refs(jmodel, prompts, [10] * 6)
    outs, stats = _serve(GenerationEngine(
        tmodel, num_slots=2, max_len=48, kv_layout="paged", block_size=8,
        attention="fused", spec_draft=tmodel, spec_k=4, prefill_budget=16,
        device="cpu"), prompts, [10] * 6)
    for ref, out in zip(refs, outs):
        np.testing.assert_array_equal(out, ref)
    assert stats["spec_accept_rate"] == 1.0
    assert stats["spec_tokens_per_cycle"] > 1.0


def test_sampled_requests_complete(models):
    _, tmodel = models
    rng = np.random.RandomState(5)
    prompts = [_prompt(rng, n) for n in (4, 9, 6, 3)]
    eng = GenerationEngine(
        tmodel, num_slots=4, max_len=48, kv_layout="paged", block_size=8,
        attention="fused", spec_draft=make_draft_model(tmodel, 1),
        spec_k=3, prefill_budget=16, device="cpu")
    hs = [eng.submit(p, max_new_tokens=6, do_sample=bool(i % 2),
                     temperature=0.9) for i, p in enumerate(prompts)]
    outs = [h.result(timeout=300) for h in hs]
    stats = eng.stats()
    eng.close()
    for p, out in zip(prompts, outs):
        assert out.shape == (p.size + 6,)
        assert ((out >= 0) & (out < VOCAB)).all()
    assert stats["spec_proposed"] > 0
    assert 0.0 <= stats["spec_accept_rate"] <= 1.0


# -- the sampler ----------------------------------------------------------

def test_rejection_sampling_identity():
    """For fixed p (target) and q (draft), the first token a cycle emits
    (the accepted draft or the residual correction) is distributed as
    p[0], over many independent slots."""
    rng = np.random.RandomState(0)
    V, K, S, ROUNDS = 6, 3, 512, 12
    p1 = rng.dirichlet(np.ones(V)).astype(np.float32)
    q1 = rng.dirichlet(np.ones(V)).astype(np.float32)
    p = np.broadcast_to(rng.dirichlet(np.ones(V), size=K).astype(np.float32),
                        (S, K, V)).copy()
    p[:, 0] = p1
    q = np.broadcast_to(rng.dirichlet(np.ones(V), size=K).astype(np.float32),
                        (S, K, V)).copy()
    q[:, 0] = q1
    p_t, q_t = torch.from_numpy(p), torch.from_numpy(q)
    base = p_t[:, 0].clone()
    n_spec = torch.full((S,), K, dtype=torch.int32)
    gen = torch.Generator().manual_seed(0)
    counts = np.zeros(V)
    for _ in range(ROUNDS):
        d = torch.stack([_categorical_probs(gen, q_t[:, j])
                         for j in range(K)], dim=1)
        acc, tok = _spec_accept(p_t, q_t, d, n_spec, base, gen)
        first = torch.where(acc >= 1, d[:, 0], tok).numpy()
        counts += np.bincount(first, minlength=V)
    emp = counts / counts.sum()
    assert np.abs(emp - p1).max() < 0.02, (emp, p1)


def test_categorical_never_draws_a_zero_probability_token():
    gen = torch.Generator().manual_seed(3)
    probs = torch.tensor([[0.0, 0.5, 0.0, 0.5], [0.0, 0.0, 1.0, 0.0]])
    draws = torch.stack([_categorical_probs(gen, probs)
                         for _ in range(2000)])
    assert set(draws[:, 0].tolist()) == {1, 3}
    assert (draws[:, 1] == 2).all()


def test_greedy_degenerate_case_is_exact():
    """One-hot p/q: acceptance is token equality and the correction the
    target's argmax, for every generator seed."""
    V, K = 8, 3
    eye = torch.eye(V)
    p, q = eye[[1, 2, 3]][None], eye[[1, 5, 3]][None]
    d = torch.tensor([[1, 5, 3]], dtype=torch.int32)
    n = torch.tensor([K], dtype=torch.int32)
    for seed in range(5):
        gen = torch.Generator().manual_seed(seed)
        acc, tok = _spec_accept(p, q, d, n, p[:, 0], gen)
        assert int(acc[0]) == 1 and int(tok[0]) == 2
    acc, _ = _spec_accept(p, p, torch.tensor([[1, 2, 3]], dtype=torch.int32),
                          n, p[:, 0], torch.Generator().manual_seed(7))
    assert int(acc[0]) == K


# -- machinery --------------------------------------------------------------

def test_signed_advance_and_floor():
    pool = PagedKVPool(num_layers=1, num_slots=2, num_heads=1, max_len=64,
                       head_dim=1, block_size=8, device="cpu")
    slot = pool.alloc()
    pool.admit_fresh(slot, 10)
    pool.set_slot(slot, pos=10, lo=0)
    assert pool.advance(slot, 4) == 14       # candidate rows written
    assert pool.advance(slot, -3) == 11      # 3 rejected, 1 kept
    with pytest.raises(ValueError, match="n != 0"):
        pool.advance(slot, 0)
    with pytest.raises(RuntimeError, match="rollback below"):
        pool.advance(slot, -12)
    with pytest.raises(RuntimeError, match="overran"):
        pool.advance(slot, 64)
    assert pool.slot_pos(slot) == 11


def test_rollback_unpublishes_dirtied_blocks():
    pool = PagedKVPool(num_layers=1, num_slots=2, num_heads=1, max_len=64,
                       head_dim=1, block_size=8, device="cpu")
    slot = pool.alloc()
    pool.admit_fresh(slot, 16)               # two full blocks
    toks = np.arange(1, 17, dtype=np.int32)
    pool.register_prefix(slot, toks)
    assert pool.cached_blocks == 2
    pool.set_slot(slot, pos=16, lo=0)
    # rows grew into a third block, then rolled back to 12, inside cached
    # block 1: its registration goes, block 0's stays
    pool.ensure_writable_range(slot, 19)
    pool.set_slot(slot, pos=20, lo=0)
    pool.advance(slot, -8)
    pool.unpublish_from(slot, pool.slot_pos(slot))
    assert pool.cached_blocks == 1
    assert pool.match_prefix(toks) == [pool.slot_table(slot)[0]]
    pool.free(slot)


def test_draft_model_shares_embeddings_and_truncates(models):
    _, tmodel = models
    draft = make_draft_model(tmodel, num_layers=1)
    assert draft.wte is tmodel.gpt.wte and draft.wpe is tmodel.gpt.wpe
    assert draft.cfg.num_hidden_layers == 1 and len(draft.blocks) == 1
    mine = dict(draft.blocks[0].named_parameters())
    for name, p in tmodel.gpt.blocks[0].named_parameters():
        assert torch.equal(mine[name], p)
        assert mine[name].data_ptr() != p.data_ptr()     # a copy
    for name, p in tmodel.gpt.ln_f.named_parameters():
        assert torch.equal(dict(draft.ln_f.named_parameters())[name], p)
    assert not draft.training
    with pytest.raises(ValueError, match="num_layers"):
        make_draft_model(tmodel, num_layers=9)


def test_construction_validation(models):
    _, tmodel = models
    fused = dict(kv_layout="paged", attention="fused", block_size=8,
                 max_len=48, device="cpu")
    with pytest.raises(ValueError, match="attention='fused'"):
        GenerationEngine(tmodel, kv_layout="paged", spec_draft=tmodel,
                         device="cpu")
    with pytest.raises(ValueError, match="spec_k"):
        GenerationEngine(tmodel, spec_draft=tmodel, spec_k=0, **fused)
    other = GPTForPretraining(GPTConfig(
        vocab_size=32, hidden_size=32, num_hidden_layers=1,
        num_attention_heads=2, intermediate_size=64,
        max_position_embeddings=64))
    with pytest.raises(ValueError, match="vocab"):
        GenerationEngine(tmodel, spec_draft=other, **fused)
    short = GPTForPretraining(GPTConfig(
        vocab_size=VOCAB, hidden_size=32, num_hidden_layers=1,
        num_attention_heads=2, intermediate_size=64,
        max_position_embeddings=32))
    with pytest.raises(ValueError, match="draft's max_position_embeddings"):
        GenerationEngine(tmodel, spec_draft=short, **fused)
    with pytest.raises(ValueError, match="'auto'"):
        GenerationEngine(tmodel, spec_draft="small", **fused)
