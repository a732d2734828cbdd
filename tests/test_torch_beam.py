"""Beam search of the PyTorch port (``generate(num_beams=K)``,
``paddle_tpu_torch/models/generation.py`` ``_beam_search``) against the
JAX package's ``generate(num_beams=K)`` (``_build_beam_fn``), on the CPU,
with shared weights: the JAX ``GPTForPretraining`` at ``GPTConfig.tiny()``
(2 layers, width 64, vocab 256, float32) from seed 0, carried across with
``convert.gpt_from_jax_params``. The JAX side runs its Pallas kernels
(flash attention in the unmasked prefill, LayerNorm) in interpret mode
under ``FLAGS_pallas_force``; the port runs the kernels' plain versions.

- Tokens equal the JAX tokens for K = 2, 3, 4 on unmasked prompts, with
  an ``eos_token_id`` that finishes beams early, with ``length_penalty``
  0.6, on left-padded ragged prompts (each row also equal to its own
  unpadded beam search), and through a ``GenerationConfig``.
- Forced ties: a model whose token embeddings repeat in pairs, so tokens
  ``2i`` and ``2i + 1`` tie exactly at every step and two beams that
  differ only in them tie over every candidate. The K best are taken
  lowest flat index first, as ``lax.top_k`` takes them; the tokens equal
  the JAX tokens.
- The best beam's summed log-probability equals the JAX model's, teacher
  forced over the JAX output, within 1e-5 (the same float32 arithmetic
  through a cache against a full forward).
- The argument checks of ``tests/test_beam_search.py`` raise as the JAX
  ones do.
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
from paddle_tpu_torch.convert import gpt_from_jax_params
from paddle_tpu_torch.models import GenerationConfig, GPTConfig
from paddle_tpu_torch.models import generation

SCORE_TOL = 1e-5


class _Forced:
    """The JAX package's Pallas kernels on (interpret mode), for the
    duration."""

    def __enter__(self):
        set_flags({"FLAGS_pallas_force": True})

    def __exit__(self, *exc):
        set_flags({"FLAGS_pallas_force": False})


def _pair(params):
    jax_model = JaxGPT(JaxGPTConfig.tiny())
    jax_model.set_state_dict(params)
    jax_model.eval()
    port = gpt_from_jax_params(params, GPTConfig.tiny(), device="cpu").eval()
    return jax_model, port


@pytest.fixture(scope="module")
def models():
    paddle.seed(0)
    params = {k: np.asarray(v)
              for k, v in get_params_tree(JaxGPT(JaxGPTConfig.tiny())).items()}
    return _pair(params)


@pytest.fixture(scope="module")
def tied_models():
    """Token embeddings (and so the tied head's columns) repeated in
    pairs: tokens 2i and 2i + 1 have equal logits everywhere."""
    paddle.seed(0)
    params = {k: np.asarray(v)
              for k, v in get_params_tree(JaxGPT(JaxGPTConfig.tiny())).items()}
    wte = params["gpt.wte.weight"].copy()
    wte[1::2] = wte[0::2]
    params["gpt.wte.weight"] = wte
    return _pair(params)


def _prompt(batch=2, length=6, seed=5):
    return np.random.RandomState(seed).randint(1, 200, (batch, length)) \
        .astype(np.int32)


def _jax_generate(jax_model, ids, **kw):
    with _Forced():
        return jax_generation.generate(jax_model, ids, **kw).numpy()


def _port_generate(port, ids, **kw):
    return port.generate(torch.from_numpy(np.asarray(ids)), **kw).numpy()


def _jax_score(jax_model, out, prompt_len, eos):
    """Summed log-probability of each row's generated tokens under the
    JAX model's full forward, up to and including its first ``eos`` (a
    finished beam goes on at log-probability 0)."""
    import jax
    import jax.numpy as jnp
    total = np.zeros(out.shape[0])
    done = np.zeros(out.shape[0], bool)
    for t in range(prompt_len, out.shape[1]):
        logits = jax_model(JaxTensor(jnp.asarray(out[:, :t])))._data[:, -1]
        logp = np.asarray(jax.nn.log_softmax(logits.astype(jnp.float32)))
        tok = out[:, t]
        total += np.where(done, 0.0, logp[np.arange(len(tok)), tok])
        if eos is not None:
            done |= tok == eos
    return total


def _port_beam(port, ids, max_new, k, eos=None, alpha=0.0):
    with torch.no_grad():
        tokens, score = generation._beam_search(
            port, torch.from_numpy(ids).long(), None, max_new, k, eos, 0,
            alpha)
    return tokens.numpy(), score.numpy()


@pytest.mark.parametrize("k", [2, 3, 4])
def test_beam_tokens_and_scores_match_jax(models, k):
    jax_model, port = models
    ids = _prompt()
    want = _jax_generate(jax_model, ids, max_new_tokens=5, num_beams=k)
    got = _port_generate(port, ids, max_new_tokens=5, num_beams=k)
    assert got.shape == (2, 11) and got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    tokens, score = _port_beam(port, ids, 5, k)
    np.testing.assert_array_equal(tokens, got)
    np.testing.assert_allclose(score, _jax_score(jax_model, want, 6, None),
                               atol=SCORE_TOL, rtol=0)


def test_beam_with_eos_matches_jax(models):
    """The greedy first token of row 0 as EOS: beams finish early and
    then only continue with the pad."""
    jax_model, port = models
    ids = _prompt(batch=3)
    eos = int(_port_generate(port, ids, max_new_tokens=1)[0, 6])
    kw = dict(max_new_tokens=5, num_beams=3, eos_token_id=eos,
              pad_token_id=0)
    want = _jax_generate(jax_model, ids, **kw)
    got = _port_generate(port, ids, **kw)
    np.testing.assert_array_equal(got, want)
    tokens, score = _port_beam(port, ids, 5, 3, eos=eos)
    np.testing.assert_array_equal(tokens, got)
    np.testing.assert_allclose(score, _jax_score(jax_model, want, 6, eos),
                               atol=SCORE_TOL, rtol=0)


def test_length_penalty_matches_jax(models):
    jax_model, port = models
    ids = _prompt(seed=7)
    eos = int(_port_generate(port, ids, max_new_tokens=2)[1, 7])
    for kw in (dict(length_penalty=0.6),
               dict(length_penalty=0.6, eos_token_id=eos),
               dict(length_penalty=-1.0, eos_token_id=eos)):
        want = _jax_generate(jax_model, ids, max_new_tokens=6, num_beams=4,
                             **kw)
        got = _port_generate(port, ids, max_new_tokens=6, num_beams=4, **kw)
        np.testing.assert_array_equal(got, want, err_msg=str(kw))


def test_ragged_beam_matches_jax_and_per_example_beams(models):
    """Left-padded prompts: equal to the JAX tokens, and each row equal
    to its own unpadded beam search (pads invisible to beams too)."""
    jax_model, port = models
    lens, width = [4, 6, 2], 6
    rng = np.random.RandomState(11)
    prompts = [rng.randint(1, 200, (n,)).astype(np.int32) for n in lens]
    ids = np.stack([np.concatenate([np.zeros(width - len(p), np.int32), p])
                    for p in prompts])
    mask = (ids != 0).astype(np.int32)
    for p, m in zip(prompts, mask):
        assert m.sum() == len(p)
    kw = dict(max_new_tokens=4, num_beams=3, attention_mask=mask)
    want = _jax_generate(jax_model, ids, **kw)
    got = _port_generate(port, ids, **kw)
    np.testing.assert_array_equal(got, want)
    for i, p in enumerate(prompts):
        solo = _port_generate(port, p[None, :], max_new_tokens=4,
                              num_beams=3)
        np.testing.assert_array_equal(got[i, width:], solo[0, len(p):],
                                      err_msg=f"row {i}")


def test_forced_ties_break_lowest_index_first_like_jax(tied_models):
    jax_model, port = tied_models
    ids = _prompt(batch=3, length=5, seed=3)
    with torch.no_grad():
        logits = port(torch.from_numpy(ids).long())[:, -1]
    assert torch.equal(logits[:, 0::2], logits[:, 1::2])    # ties, exact
    topk = generation._beam_topk(logits, 4)[1]
    assert ((topk[:, 0] % 2 == 0) & (topk[:, 1] == topk[:, 0] + 1)).all()
    for k, eos in ((2, None), (4, None), (3, 6)):
        kw = dict(max_new_tokens=5, num_beams=k, eos_token_id=eos)
        want = _jax_generate(jax_model, ids, **kw)
        got = _port_generate(port, ids, **kw)
        np.testing.assert_array_equal(got, want, err_msg=str(kw))


def test_beam_topk_orders_ties_like_lax_top_k():
    import jax
    rng = np.random.RandomState(0)
    cand = np.round(rng.randn(6, 40) * 2) / 2              # many ties
    cand[0] = 1.0
    cand[1, ::3] = -np.inf
    vals, idx = generation._beam_topk(torch.from_numpy(cand), 7)
    jvals, jidx = jax.lax.top_k(cand, 7)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jvals))


def test_beam_via_config_matches_kwargs(models):
    jax_model, port = models
    ids = _prompt()
    a = _port_generate(port, ids, config=GenerationConfig(
        max_new_tokens=4, num_beams=2, length_penalty=0.6))
    b = _port_generate(port, ids, max_new_tokens=4, num_beams=2,
                       length_penalty=0.6)
    want = _jax_generate(jax_model, ids, config=JaxGenerationConfig(
        max_new_tokens=4, num_beams=2, length_penalty=0.6))
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(a, want)
    assert a.shape == (2, 10)


@pytest.mark.parametrize("kw, match", [
    (dict(num_beams=3, do_sample=True), "num_beams"),
    (dict(num_beams=0), "num_beams must be >= 1"),
    (dict(num_beams=3, top_k=50), "no effect"),
    (dict(num_beams=3, temperature=0.5), "no effect"),
    (dict(num_beams=3, seed=1), "no effect"),
    (dict(length_penalty=0.6), "length_penalty"),
    (dict(num_beams=300), r"num_beams must be in \[2, vocab\]"),
])
def test_beam_argument_errors_match_jax(models, kw, match):
    jax_model, port = models
    ids = _prompt()
    with pytest.raises(ValueError, match=match):
        _jax_generate(jax_model, ids, max_new_tokens=2, **kw)
    with pytest.raises(ValueError, match=match):
        _port_generate(port, ids, max_new_tokens=2, **kw)
