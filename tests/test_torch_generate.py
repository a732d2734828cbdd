"""``generate()`` of the PyTorch port (paddle_tpu_torch/models/generation.py,
``GPTModel.prefill``/``decode_step``) against the JAX package's, on the
CPU, with shared weights: the JAX ``GPTForPretraining`` at
``GPTConfig.tiny()`` (2 layers) from seed 0, carried across with
``convert.gpt_from_jax_params``. The JAX side runs its Pallas kernels
(flash attention in the unmasked prefill, LayerNorm) in interpret mode
under ``FLAGS_pallas_force``; the port runs the kernels' plain versions.

- Greedy tokens equal the JAX ``generate()``'s token for token: unmasked,
  left-padded (and each row equal to its own unpadded decode), stopped
  by ``eos_token_id`` with the tail padded, and through a
  ``GenerationConfig``.
- The first-step logits of ``prefill`` and of one ``decode_step`` equal
  the JAX ones in float32 within atol 1e-5 (the same f32 arithmetic in
  another summation order, over 2 blocks and a 256-word head).
- Top-k and top-p keep the support of the JAX ``_filter_logits``; samples
  are compared in distribution only (the two frameworks' generators
  differ): the frequencies of 20000 draws lie within 5 standard errors of
  the filtered softmax.
- Every argument check of ``tests/test_generation.py`` has its
  counterpart here. Its tests on recompiles
  (``test_temperature_change_does_not_recompile``,
  ``test_seeded_and_unseeded_share_one_compile``) have none: the port's
  loop runs eagerly, with no compile cache to count.
  ``test_save_for_serving_roundtrip``'s counterpart is
  ``tests/test_torch_serving_export.py``.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.framework.flags import set_flags
from paddle_tpu.framework.tensor import Tensor as JaxTensor
from paddle_tpu.models import GenerationConfig as JaxGenerationConfig
from paddle_tpu.models import GPTConfig as JaxGPTConfig
from paddle_tpu.models import GPTForPretraining as JaxGPT
from paddle_tpu.models import generation as jax_generation
from paddle_tpu.nn.layer.layers import get_params_tree
import paddle_tpu_torch as pt
from paddle_tpu_torch.convert import gpt_from_jax_params
from paddle_tpu_torch.framework import monitor
from paddle_tpu_torch.framework.random import get_generator
from paddle_tpu_torch.models import GenerationConfig, GPTConfig, generate
from paddle_tpu_torch.models import generation
from paddle_tpu_torch.nn import functional as F

ATOL = 1e-5
L = 2                                   # GPTConfig.tiny() layers


class _Forced:
    """The JAX package's Pallas kernels on (interpret mode), for the
    duration."""

    def __enter__(self):
        set_flags({"FLAGS_pallas_force": True})

    def __exit__(self, *exc):
        set_flags({"FLAGS_pallas_force": False})


@pytest.fixture(scope="module")
def models():
    paddle.seed(0)
    jax_model = JaxGPT(JaxGPTConfig.tiny())
    jax_model.eval()
    params = {k: np.asarray(v) for k, v in get_params_tree(jax_model).items()}
    port = gpt_from_jax_params(params, GPTConfig.tiny(), device="cpu").eval()
    return jax_model, port


def _jax_generate(jax_model, ids, **kw):
    with _Forced():
        return jax_generation.generate(jax_model, ids, **kw).numpy()


def _port_generate(port, ids, **kw):
    return port.generate(torch.from_numpy(np.asarray(ids)), **kw).numpy()


def _prompt(batch=2, length=8):
    return np.arange(1, 1 + length, dtype=np.int32)[None, :].repeat(
        batch, axis=0)


def _ragged(lens, width, seed=9):
    rng = np.random.RandomState(seed)
    prompts = [rng.randint(1, 200, (n,)).astype(np.int32) for n in lens]
    ids = np.stack([np.concatenate([np.zeros(width - len(p), np.int32), p])
                    for p in prompts])
    mask = np.stack([np.concatenate([np.zeros(width - len(p), np.int32),
                                     np.ones(len(p), np.int32)])
                     for p in prompts])
    return prompts, ids, mask


# -- greedy tokens against the JAX generate() ---------------------------

@pytest.mark.parametrize("batch, length", [(2, 8), (3, 13)])
def test_greedy_matches_jax(models, batch, length):
    jax_model, port = models
    ids = np.random.RandomState(length).randint(
        1, 256, (batch, length)).astype(np.int32)
    want = _jax_generate(jax_model, ids, max_new_tokens=6)
    got = _port_generate(port, ids, max_new_tokens=6)
    assert got.shape == (batch, length + 6) and got.dtype == np.int32
    np.testing.assert_array_equal(got, want)


def test_left_padded_matches_jax_and_per_example_decodes(models):
    """Pads are invisible to attention and to position embeddings: each
    row's continuation equals its own unpadded decode."""
    jax_model, port = models
    prompts, ids, mask = _ragged([5, 8, 3], 8)
    want = _jax_generate(jax_model, ids, max_new_tokens=6,
                         attention_mask=mask)
    got = _port_generate(port, ids, max_new_tokens=6, attention_mask=mask)
    np.testing.assert_array_equal(got, want)
    for i, p in enumerate(prompts):
        solo = _port_generate(port, p[None, :], max_new_tokens=6)
        np.testing.assert_array_equal(got[i, 8:], solo[0, len(p):],
                                      err_msg=f"row {i} length {len(p)}")


def test_eos_stops_early_and_pads_the_tail(models, monkeypatch):
    jax_model, port = models
    ids = _prompt()
    first = int(_port_generate(port, ids, max_new_tokens=1)[0, 8])
    kw = dict(max_new_tokens=6, eos_token_id=first, pad_token_id=99)
    steps = []
    decode = port.gpt.decode_step
    monkeypatch.setattr(port.gpt, "decode_step",
                        lambda *a, **k: steps.append(1) or decode(*a, **k))
    got = _port_generate(port, ids, **kw)
    assert steps == []            # every row finished at its first token
    np.testing.assert_array_equal(got, _jax_generate(jax_model, ids, **kw))
    assert (got[:, 8] == first).all()
    np.testing.assert_array_equal(got[:, 9:], np.full((2, 5), 99))


def test_eos_in_one_row_pads_only_that_row(models):
    jax_model, port = models
    ids = np.random.RandomState(3).randint(1, 256, (3, 8)).astype(np.int32)
    free = _port_generate(port, ids, max_new_tokens=6)
    eos = int(free[1, 10])                       # row 1's third new token
    kw = dict(max_new_tokens=6, eos_token_id=eos, pad_token_id=255)
    got = _port_generate(port, ids, **kw)
    np.testing.assert_array_equal(got, _jax_generate(jax_model, ids, **kw))
    stop = 8 + int(np.argmax(free[1, 8:] == eos))
    np.testing.assert_array_equal(got[1, :stop + 1], free[1, :stop + 1])
    assert (got[1, stop + 1:] == 255).all()


def test_generation_config_matches_jax_and_kwargs(models):
    jax_model, port = models
    ids = _prompt()
    fields = dict(max_new_tokens=4, eos_token_id=7, pad_token_id=3)
    got = _port_generate(port, ids, config=GenerationConfig(**fields))
    np.testing.assert_array_equal(got, _port_generate(port, ids, **fields))
    np.testing.assert_array_equal(got, _jax_generate(
        jax_model, ids, config=JaxGenerationConfig(**fields)))
    sample = dict(max_new_tokens=4, do_sample=True, top_k=8,
                  temperature=0.9, seed=3)
    np.testing.assert_array_equal(
        _port_generate(port, ids, config=GenerationConfig(**sample)),
        _port_generate(port, ids, **sample))


# -- first-step logits -----------------------------------------------------

@pytest.mark.parametrize("ragged", [False, True])
def test_prefill_and_decode_step_logits_match_jax(models, ragged):
    import jax.numpy as jnp
    jax_model, port = models
    if ragged:
        _, ids, mask = _ragged([6, 8], 8, seed=4)
    else:
        ids, mask = np.random.RandomState(5).randint(
            1, 256, (2, 8)).astype(np.int32), None
    total = 10
    jg = jax_model.gpt
    with _Forced():
        if ragged:
            kv, real = jax_generation._mask_preamble(jnp.asarray(mask), 2, 2)
        caches = jg.init_cache(2, total, jnp.float32)
        h, caches = jg.prefill(JaxTensor(jnp.asarray(ids)), caches,
                               key_valid=kv[:, :8] if ragged else None)
        want0 = np.asarray(jg.logits(h)._data)
        tok = np.argmax(want0[:, 0], -1).astype(np.int32)[:, None]
        if ragged:
            kv1, positions = jax_generation._step_mask(kv, real, 8, total, 8)
        else:
            kv1 = positions = None
        h, _ = jg.decode_step(JaxTensor(jnp.asarray(tok)), caches, 8,
                              key_valid=kv1, positions=positions)
        want1 = np.asarray(jg.logits(h)._data)
    g = port.gpt
    with torch.no_grad():
        tids = torch.from_numpy(ids).long()
        caches = g.init_cache(2, total, torch.float32)
        if ragged:
            tkv, treal = generation._mask_preamble(torch.from_numpy(mask),
                                                   2, 2)
        h, caches = g.prefill(tids, caches,
                              key_valid=tkv[:, :8] if ragged else None)
        got0 = g.logits(h).numpy()
        if ragged:
            tkv1, tpos = generation._step_mask(tkv, treal, 8, total, 8)
        else:
            tkv1 = tpos = None
        h, _ = g.decode_step(torch.from_numpy(tok), caches, 8,
                             key_valid=tkv1, positions=tpos)
        got1 = g.logits(h).numpy()
    np.testing.assert_allclose(got0, want0, atol=ATOL, rtol=0)
    np.testing.assert_allclose(got1, want1, atol=ATOL, rtol=0)
    if ragged:
        np.testing.assert_array_equal(tkv1.numpy(), np.asarray(kv1))
        np.testing.assert_array_equal(tpos.numpy(), np.asarray(positions))


def test_greedy_matches_the_full_forward(models):
    """Static-cache greedy == greedy through the ordinary forward (the
    whole sequence recomputed each step)."""
    _, port = models
    ids = torch.from_numpy(_prompt(length=5)).long()
    cur = ids
    with torch.no_grad():
        for _ in range(6):
            nxt = port(cur)[:, -1].argmax(-1)
            cur = torch.cat([cur, nxt[:, None]], dim=1)
    np.testing.assert_array_equal(
        port.generate(ids, max_new_tokens=6).numpy(), cur.numpy())


# -- the op path: layer_norm and attention counts, and the routes ----------

@pytest.mark.parametrize("masked", [False, True])
def test_ops_per_generate_and_the_prefill_route(models, monkeypatch, masked):
    """One generate of N tokens runs ``layer_norm`` (2L + 1) x N times
    (the prefill and N - 1 decode steps); its prefill reaches the flash
    wrapper once a layer when unmasked and never when masked, as K4's
    launches on the card."""
    _, port = models
    n = 5
    ids = np.random.RandomState(2).randint(1, 256, (2, 8)).astype(np.int32)
    mask = np.array([[0, 0, 1, 1, 1, 1, 1, 1], [1] * 8]) if masked else None
    flash = []
    real = F.flash_attention
    monkeypatch.setattr(F, "flash_attention",
                        lambda *a, **k: flash.append(1) or real(*a, **k))
    before = {op: monitor.stat_get(f"op_count/{op}") for op in
              ("layer_norm", "scaled_dot_product_attention")}
    _port_generate(port, ids, max_new_tokens=n, attention_mask=mask)
    moved = {op: monitor.stat_get(f"op_count/{op}") - v
             for op, v in before.items()}
    assert moved == {"layer_norm": (2 * L + 1) * n,
                     "scaled_dot_product_attention": L * n}
    assert len(flash) == (0 if masked else L)


# -- sampling ---------------------------------------------------------------

def _first_logits(port, ids):
    with torch.no_grad():
        g = port.gpt
        h, _ = g.prefill(torch.from_numpy(ids).long(),
                         g.init_cache(ids.shape[0], ids.shape[1] + 1,
                                      torch.float32))
        return g.logits(h)[:, 0].float()


@pytest.mark.parametrize("top_k, top_p", [(1, 1.0), (4, 1.0), (50, 1.0),
                                          (0, 0.5), (0, 0.9), (8, 0.7)])
def test_filter_keeps_the_jax_support(models, top_k, top_p):
    import jax.numpy as jnp
    _, port = models
    logits = _first_logits(port, _prompt(batch=1)).numpy()
    rand = np.random.RandomState(top_k).randn(3, 256).astype(np.float32) * 3
    for x in (logits, rand):
        got = generation._filter_logits(torch.from_numpy(x), top_k, top_p,
                                        torch.tensor(0.8))
        want = jax_generation._filter_logits(jnp.asarray(x), top_k, top_p,
                                             0.8)
        np.testing.assert_array_equal(torch.isfinite(got).numpy(),
                                      np.isfinite(np.asarray(want)))


@pytest.mark.parametrize("top_k, top_p", [(4, 1.0), (0, 0.9)])
def test_samples_follow_the_filtered_distribution(models, top_k, top_p):
    """20000 first-token draws against the softmax of the JAX
    ``_filter_logits``: every count within 5 standard errors, none
    outside the support; and ``generate``'s first sampled token inside
    the support."""
    import jax.numpy as jnp
    _, port = models
    ids = _prompt(batch=1)
    logits = _first_logits(port, ids)
    probs = np.asarray(jax_generation._filter_logits(
        jnp.asarray(logits.numpy()), top_k, top_p, 1.0), np.float64)
    probs = np.exp(probs - probs.max())
    probs /= probs.sum()
    n = 20000
    gen = torch.Generator().manual_seed(0)
    draws = generation._pick_token(logits.expand(n, -1), gen, True, top_k,
                                   top_p, torch.tensor(1.0))
    counts = np.bincount(draws.numpy(), minlength=256)
    assert counts[probs[0] == 0].sum() == 0
    se = np.sqrt(n * probs[0] * (1 - probs[0]))
    assert (np.abs(counts - n * probs[0]) <= 5 * se + 1).all()
    for seed in range(3):
        out = _port_generate(port, ids, max_new_tokens=1, do_sample=True,
                             top_k=top_k, top_p=top_p, seed=seed)
        assert probs[0, out[0, 8]] > 0


def test_sampling_is_deterministic_by_seed(models):
    _, port = models
    ids = _prompt()
    kw = dict(max_new_tokens=5, do_sample=True, top_k=8, temperature=0.9)
    a = _port_generate(port, ids, seed=3, **kw)
    np.testing.assert_array_equal(a, _port_generate(port, ids, seed=3, **kw))
    assert not np.array_equal(a, _port_generate(port, ids, seed=4, **kw))


def test_unseeded_sampling_draws_from_the_port_stream(models):
    _, port = models
    ids = _prompt()
    kw = dict(max_new_tokens=8, do_sample=True, temperature=1.5)
    pt.seed(11)
    a = _port_generate(port, ids, **kw)
    b = _port_generate(port, ids, **kw)
    assert not np.array_equal(a, b)         # a fresh draw per call
    pt.seed(11)
    np.testing.assert_array_equal(a, _port_generate(port, ids, **kw))


def test_greedy_does_not_advance_the_port_generator(models):
    _, port = models
    pt.seed(123)
    want = torch.rand(4, generator=get_generator("cpu"))
    pt.seed(123)
    _port_generate(port, _prompt(), max_new_tokens=2)
    _port_generate(port, _prompt(), max_new_tokens=2, top_k=5, top_p=0.5)
    torch.testing.assert_close(torch.rand(4, generator=get_generator("cpu")),
                               want)


# -- argument checks (tests/test_generation.py) ----------------------------

def test_prompt_is_preserved(models):
    _, port = models
    ids = _prompt()
    np.testing.assert_array_equal(
        _port_generate(port, ids, max_new_tokens=3)[:, :8], ids)


def test_budget_exceeding_positions_raises(models):
    _, port = models
    with pytest.raises(ValueError, match="max_position_embeddings"):
        _port_generate(port, _prompt(length=60), max_new_tokens=10)


def test_zero_new_tokens_raises(models):
    _, port = models
    with pytest.raises(ValueError, match="max_new_tokens"):
        _port_generate(port, _prompt(), max_new_tokens=0)


def test_bad_top_p_raises_and_overlarge_top_k_clamps(models):
    _, port = models
    for p in (0.0, 1.5):
        with pytest.raises(ValueError, match="top_p"):
            _port_generate(port, _prompt(), max_new_tokens=1,
                           do_sample=True, top_p=p)
    with pytest.raises(ValueError, match="top_k"):
        _port_generate(port, _prompt(), max_new_tokens=1, top_k=-1)
    out = _port_generate(port, _prompt(), max_new_tokens=2, do_sample=True,
                         top_k=10_000, seed=0)
    assert out.shape == (2, 10)


def test_config_plus_explicit_kwargs_raises(models):
    _, port = models
    cfg = GenerationConfig(max_new_tokens=4, do_sample=True)
    with pytest.raises(ValueError, match="not both"):
        _port_generate(port, _prompt(), config=cfg, temperature=1.0)


def test_all_ones_mask_equals_no_mask(models):
    _, port = models
    ids = _prompt()
    np.testing.assert_array_equal(
        _port_generate(port, ids, max_new_tokens=4),
        _port_generate(port, ids, max_new_tokens=4,
                       attention_mask=np.ones_like(ids)))


def test_bad_attention_masks_raise(models):
    _, port = models
    ids = _prompt()
    for mask, match in (
            (np.array([[1, 1, 1, 1, 0, 0, 1, 1], [1] * 8]), "left-padded"),
            (np.array([[0] * 8, [1] * 8]), "all-pad"),
            (np.ones((2, 4), np.int32), "shape")):
        with pytest.raises(ValueError, match=match):
            _port_generate(port, ids, max_new_tokens=2,
                           attention_mask=torch.from_numpy(mask))


def test_beam_search_is_not_ported_yet(models):
    """Beam search is ported now (tests/test_torch_beam.py holds it
    against the JAX package): ``num_beams=3`` decodes, and the argument
    checks stay."""
    _, port = models
    out = _port_generate(port, _prompt(), max_new_tokens=2, num_beams=3)
    assert out.shape == (2, 10) and out.dtype == np.int32
    with pytest.raises(ValueError, match="num_beams"):
        _port_generate(port, _prompt(), max_new_tokens=2, num_beams=0)
    with pytest.raises(ValueError, match="length_penalty"):
        _port_generate(port, _prompt(), max_new_tokens=2,
                       length_penalty=0.5)


def test_model_method_and_training_mode_restored(models):
    _, port = models
    port.train()
    try:
        out = generate(port, torch.from_numpy(_prompt()), max_new_tokens=2)
        assert tuple(out.shape) == (2, 10) and out.device.type == "cpu"
        assert port.training            # generate() restores train mode
    finally:
        port.eval()


def test_generate_runs_where_the_parameters_are(models):
    """A 1-D prompt is one row; the result lies on the model's device
    whatever the prompt's, and nothing else picks the device."""
    _, port = models
    out = port.generate(list(range(1, 9)), max_new_tokens=2)
    assert out.shape == (1, 10) and out.device.type == "cpu"
    assert out.dtype == torch.int32
