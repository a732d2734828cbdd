"""``save_for_serving`` of the PyTorch port with sampling
(``paddle_tpu_torch/models/generation.py``), on the CPU, on the JAX
``GPTForPretraining`` at ``GPTConfig.tiny()`` from seed 0 carried across
with ``convert.gpt_from_jax_params``.

- ``runtime_key=True``: the same key gives the same tokens, another key
  other tokens, through ``jit.load`` and a ``Predictor``; the artifact's
  draws are those of the loop run eagerly.
- A seeded sampled export fixes one draw per prompt, another seed
  another.
- The counted draw (``_keyed_pick``, the Gumbel-max rule over a
  counter-based hash) follows the softmax of the JAX ``_filter_logits``:
  the counts of 20000 draws lie within 5 standard errors, none outside
  the support; its uniforms are uniform (16 bins within 5 standard
  errors) and uncorrelated from step to step.

The JAX property "key ``PRNGKey(s)`` gives ``generate(seed=s)``'s
tokens" is not carried: the frameworks' generators differ, so sampled
output is compared in distribution only.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models import GPTConfig as JaxGPTConfig
from paddle_tpu.models import GPTForPretraining as JaxGPT
from paddle_tpu.models import generation as jax_generation
from paddle_tpu.nn.layer.layers import get_params_tree
from paddle_tpu_torch import inference, jit
from paddle_tpu_torch.convert import gpt_from_jax_params
from paddle_tpu_torch.models import GPTConfig, save_for_serving
from paddle_tpu_torch.models import generation


@pytest.fixture(scope="module")
def models():
    paddle.seed(0)
    jax_model = JaxGPT(JaxGPTConfig.tiny())
    jax_model.eval()
    params = {k: np.asarray(v) for k, v in get_params_tree(jax_model).items()}
    port = gpt_from_jax_params(params, GPTConfig.tiny(), device="cpu").eval()
    return jax_model, port


def _ids(batch=2, length=8, seed=0):
    return np.random.RandomState(seed).randint(
        1, 256, (batch, length)).astype(np.int32)


def test_runtime_key_reproduces_and_rerandomizes(models, tmp_path):
    _, port = models
    path = str(tmp_path / "keyed")
    save_for_serving(port, path, batch=2, prompt_len=8, max_new_tokens=5,
                     do_sample=True, temperature=0.8, runtime_key=True)
    ids = _ids()
    k1 = np.array([0, 1], np.uint32)
    k2 = np.array([0, 2], np.uint32)
    loaded = jit.load(path, device="cpu")
    cfg = inference.Config(path + ".pdmodel")
    cfg.disable_gpu()
    pred = inference.create_predictor(cfg)
    o1, o1b, o2 = (loaded(ids, k).numpy() for k in (k1, k1, k2))
    np.testing.assert_array_equal(o1, o1b)
    np.testing.assert_array_equal(pred.run([ids, k1])[0], o1)
    np.testing.assert_array_equal(pred.run([ids, k2])[0], o2)
    assert not np.array_equal(o1, o2)
    np.testing.assert_array_equal(o1[:, :8], ids)
    # a key word above 2**31 stays a 32-bit word
    big = np.array([0xFFFFFFFF, 0x80000001], np.uint32)
    ob = loaded(ids, big).numpy()
    assert ob.min() >= 0 and ob.max() < 256
    # the artifact's draws are the loop's own, run eagerly
    r = generation._resolve(port, dict(
        generation._GEN_DEFAULTS, max_new_tokens=5, do_sample=True,
        temperature=0.8), None)
    eager = generation._serve_tokens(
        port, torch.from_numpy(ids), torch.from_numpy(k1.astype(np.int64)),
        r, None)
    np.testing.assert_array_equal(eager.numpy(), o1)


def test_seeded_sampled_export_fixes_one_draw_per_seed(models, tmp_path):
    _, port = models
    ids = _ids()
    outs = []
    for seed in (1, 2):
        path = str(tmp_path / f"s{seed}")
        save_for_serving(port, path, batch=2, prompt_len=8,
                         max_new_tokens=5, do_sample=True, seed=seed)
        loaded = jit.load(path, device="cpu")
        outs.append(loaded(ids).numpy())
        np.testing.assert_array_equal(loaded(ids).numpy(), outs[-1])
    assert not np.array_equal(outs[0], outs[1])
    with pytest.raises(ValueError, match="seed must be >= 0"):
        save_for_serving(port, str(tmp_path / "n"), batch=2, prompt_len=8,
                         do_sample=True, seed=-1)


@pytest.mark.parametrize("top_k, top_p", [(0, 1.0), (4, 1.0), (0, 0.9)])
def test_keyed_draws_follow_the_filtered_distribution(top_k, top_p):
    """20000 counted draws of one row of logits (each element of the
    batch its own counter) against the softmax of the JAX
    ``_filter_logits``; a second step's draws differ from the first's."""
    import jax.numpy as jnp
    logits = torch.from_numpy(
        np.random.RandomState(3).randn(1, 64).astype(np.float32) * 2)
    probs = np.asarray(jax_generation._filter_logits(
        jnp.asarray(logits.numpy()), top_k, top_p, 0.8), np.float64)
    probs = np.exp(probs - probs.max())
    probs /= probs.sum()
    n = 20000
    key = torch.tensor([12345, 678], dtype=torch.int64)
    draws = generation._keyed_pick(logits.expand(n, -1), key, 9, top_k,
                                   top_p, torch.tensor(0.8))
    counts = np.bincount(draws.numpy(), minlength=64)
    assert counts[probs[0] == 0].sum() == 0
    se = np.sqrt(n * probs[0] * (1 - probs[0]))
    assert (np.abs(counts - n * probs[0]) <= 5 * se + 1).all()
    again = generation._keyed_pick(logits.expand(n, -1), key, 9, top_k,
                                   top_p, torch.tensor(0.8))
    assert torch.equal(draws, again)
    other = generation._keyed_pick(logits.expand(n, -1), key, 10, top_k,
                                   top_p, torch.tensor(0.8))
    assert (other != draws).float().mean() > 0.5 * (1 - (probs ** 2).sum())


def test_keyed_uniforms_are_uniform_and_independent_of_the_step():
    key = torch.tensor([7, 0xFFFFFFFF], dtype=torch.int64)
    u = generation._keyed_uniform(key, 0, (256, 256), torch.device("cpu"))
    v = generation._keyed_uniform(key, 1, (256, 256), torch.device("cpu"))
    assert 0.0 < float(u.min()) and float(u.max()) < 1.0
    n = u.numel()
    hist = np.histogram(u.numpy(), bins=16, range=(0, 1))[0]
    se = np.sqrt(n / 16 * (1 - 1 / 16))
    assert (np.abs(hist - n / 16) <= 5 * se).all()
    corr = np.corrcoef(u.numpy().ravel(), v.numpy().ravel())[0, 1]
    assert abs(corr) < 5 / np.sqrt(n)
