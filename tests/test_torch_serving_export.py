"""``save_for_serving`` of the PyTorch port
(``paddle_tpu_torch/models/generation.py``) against the JAX package's, on
the CPU, with shared weights: the JAX ``GPTForPretraining`` at
``GPTConfig.tiny()`` (2 layers) from seed 0, carried across with
``convert.gpt_from_jax_params``.

- Greedy, EOS-stopped and beam artifacts, served through ``jit.load`` and
  through ``inference.create_predictor``, give exactly the tokens of the
  JAX ``generate()`` and of the JAX artifact (``jax.export``) on the same
  prompts.
- Every validation error of ``tests/test_inference_serving.py``
  (``test_validation_is_independent_of_export_backend``) has its
  counterpart, with the same error type and message.
- ``runtime_key=True`` and the seeded sampled export are held in
  ``test_torch_serving_keyed.py``.
- The exported graph is one decode step large (a ``while_loop``), holds
  the LayerNorm and flash attention custom ops, and is the same size for
  any ``max_new_tokens``.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import jit as jax_jit
from paddle_tpu.framework.flags import set_flags
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


def _jax_generate(jax_model, ids, **kw):
    set_flags({"FLAGS_pallas_force": True})
    try:
        return jax_generation.generate(jax_model, ids, **kw).numpy()
    finally:
        set_flags({"FLAGS_pallas_force": False})


def _served(path, *inputs):
    """The artifact's tokens through ``jit.load`` and through a
    ``Predictor``, on the CPU."""
    loaded = jit.load(path, device="cpu")(*inputs).numpy()
    cfg = inference.Config(path + ".pdmodel")
    cfg.disable_gpu()
    predicted = inference.create_predictor(cfg).run(list(inputs))[0]
    return loaded, np.asarray(predicted)


@pytest.mark.parametrize("kw", [
    dict(max_new_tokens=6),
    dict(max_new_tokens=6, eos_token_id=3, pad_token_id=0),
    dict(max_new_tokens=5, num_beams=3),
    dict(max_new_tokens=5, num_beams=2, eos_token_id=7, length_penalty=0.6),
], ids=["greedy", "eos", "beams", "beams_eos"])
def test_artifact_equals_jax_generate_and_the_jax_artifact(models, tmp_path,
                                                           kw):
    jax_model, port = models
    ids = _ids()
    want = _jax_generate(jax_model, ids, **kw)
    save_for_serving(port, str(tmp_path / "port"), batch=2, prompt_len=8,
                     **kw)
    loaded, predicted = _served(str(tmp_path / "port"), ids)
    assert loaded.dtype == np.int32 and loaded.shape == want.shape
    np.testing.assert_array_equal(loaded, want)
    np.testing.assert_array_equal(predicted, want)
    jax_generation.save_for_serving(jax_model, str(tmp_path / "jax"),
                                    batch=2, prompt_len=8, **kw)
    jax_art = jax_jit.load(str(tmp_path / "jax"))(
        paddle.to_tensor(ids)).numpy()
    np.testing.assert_array_equal(loaded, jax_art)


def test_eos_artifact_stops_with_generate(models, tmp_path):
    """Every row finishing at its first token ends the served loop after
    the prefill, as ``generate``'s early stop does; the tail is pad."""
    jax_model, port = models
    ids = _ids()
    first = int(port.generate(torch.from_numpy(ids), max_new_tokens=1)
                .numpy()[0, 8])
    ids[1] = ids[0]
    kw = dict(max_new_tokens=6, eos_token_id=first, pad_token_id=99)
    save_for_serving(port, str(tmp_path / "e"), batch=2, prompt_len=8, **kw)
    steps = []
    step = port.gpt.decode_step_at
    port.gpt.decode_step_at = lambda *a: steps.append(1) or step(*a)
    try:
        loaded, predicted = _served(str(tmp_path / "e"), ids)
    finally:
        del port.gpt.decode_step_at
    assert steps == []          # the artifact runs no model code
    np.testing.assert_array_equal(loaded, _jax_generate(jax_model, ids, **kw))
    np.testing.assert_array_equal(loaded[:, 9:], np.full((2, 5), 99))
    np.testing.assert_array_equal(predicted, loaded)


_INVALID = [
    (dict(runtime_key=True), ValueError, "do_sample"),
    (dict(runtime_key=True, do_sample=True, seed=3), ValueError, "seed"),
    (dict(runtime_key=True, do_sample=True, num_beams=2), ValueError,
     "num_beams"),
    (dict(runtime_key=True, do_sample=True, bogus_kwarg=1), ValueError,
     "unsupported"),
    (dict(do_sample=True), ValueError, "runtime_key"),
    (dict(do_sample=True, max_new_tokens=2), ValueError, "explicit seed"),
]


@pytest.mark.parametrize("kw, err, match", _INVALID)
def test_validation_errors_match_jax(models, tmp_path, kw, err, match):
    jax_model, port = models
    with pytest.raises(err, match=match):
        jax_generation.save_for_serving(jax_model, str(tmp_path / "j"),
                                        batch=1, prompt_len=4, **kw)
    with pytest.raises(err, match=match):
        save_for_serving(port, str(tmp_path / "p"), batch=1, prompt_len=4,
                         **kw)
    assert not (tmp_path / "p.pdmodel").exists()


def test_generate_checks_and_unknown_kwargs_raise(models, tmp_path):
    """``generate``'s own checks hold at export; a keyword ``generate``
    does not take raises ``TypeError``, as the JAX export's call of
    ``generate(**kwargs)`` does; the artifact takes no mask."""
    _, port = models
    path = str(tmp_path / "x")
    with pytest.raises(ValueError, match="length_penalty requires"):
        save_for_serving(port, path, batch=1, prompt_len=4,
                         length_penalty=0.5)
    with pytest.raises(ValueError, match="max_position_embeddings"):
        save_for_serving(port, path, batch=1, prompt_len=60,
                         max_new_tokens=8)
    with pytest.raises(TypeError, match="bogus"):
        save_for_serving(port, path, batch=1, prompt_len=4, bogus=1)
    with pytest.raises(TypeError, match="attention_mask"):
        save_for_serving(port, path, batch=1, prompt_len=4,
                         attention_mask=np.ones((1, 4)))


def test_export_restores_the_models_mode_and_takes_a_config(models,
                                                            tmp_path):
    jax_model, port = models
    port.train()
    try:
        save_for_serving(port, str(tmp_path / "c"), batch=2, prompt_len=8,
                         config=generation.GenerationConfig(
                             max_new_tokens=4, num_beams=2))
        assert port.training
    finally:
        port.eval()
    loaded, _ = _served(str(tmp_path / "c"), _ids())
    np.testing.assert_array_equal(loaded, _jax_generate(
        jax_model, _ids(), max_new_tokens=4, num_beams=2))


def _graph_nodes(ep):
    return {name: list(m.graph.nodes)
            for name, m in ep.graph_module.named_modules()
            if isinstance(m, torch.fx.GraphModule)}


def test_the_graph_is_one_step_large_with_the_custom_ops(models, tmp_path):
    _, port = models
    sizes = {}
    for new in (3, 9):
        path = str(tmp_path / f"g{new}")
        save_for_serving(port, path, batch=2, prompt_len=8,
                         max_new_tokens=new)
        graphs = _graph_nodes(jit.load(path, device="cpu")._exported)
        sizes[new] = {k: len(v) for k, v in graphs.items()}
        targets = {k: [str(n.target) for n in v] for k, v in graphs.items()}
    assert sizes[3] == sizes[9]
    assert set(targets) == {"", "while_loop_cond_graph_0",
                            "while_loop_body_graph_0"}
    top, body = targets[""], targets["while_loop_body_graph_0"]
    assert sum("while_loop" in t for t in top) == 3   # op + its 2 graphs
    # the prefill: 2 LayerNorms a block and ln_f, flash in every block
    assert top.count("paddle_tpu_torch.fused_layer_norm.default") == 5
    assert top.count("paddle_tpu_torch.flash_attention_fwd.default") == 2
    # a decode step: the same LayerNorms, the masked attention in plain ops
    assert body.count("paddle_tpu_torch.fused_layer_norm.default") == 5
    assert body.count("paddle_tpu_torch.flash_attention_fwd.default") == 0
