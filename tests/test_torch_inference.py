"""``inference`` and the saved artifacts of the port against the JAX
package, on the CPU.

The same 2-layer BERT and LeNet as ``tests/test_torch_jit.py``, from the
same weights:

* the JAX ``jit.save`` -> ``inference.create_predictor`` output against
  the port's, from the same weights, at batch 1, 3 and 8 out of one
  port artifact (the ``None`` batch stays dynamic), through
  ``Predictor.run`` and the ``PredictorTensor`` handles;
  ``Model.save(training=False)`` and ``static.save_inference_model`` /
  ``load_inference_model`` the same way. The JAX BERT artifact takes
  batch 1 only: its two ``[None, L]`` inputs get a symbolic batch each,
  which the embedding sum must unify, so ``jax.export`` fails and the
  JAX ``jit.save`` falls back to static shapes at 1 (ROADMAP Queue 3).
  There the port's batches 3 and 8 are held to the JAX network's own
  forward;
* a fresh process loads the artifact and runs it, importing no model
  code (no ``paddle_tpu_torch.models``, ``.vision`` or ``.serving``
  module);
* loading without a card raises unless the caller (or the ``Config``)
  asks for the CPU; the TensorRT/IR/memory knobs warn.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models import bert as jbert
from paddle_tpu.vision.models import LeNet as JLeNet
import paddle_tpu_torch as pt
from paddle_tpu_torch import inference, jit
from paddle_tpu_torch.convert import layer_from_jax
from paddle_tpu_torch.models import bert as tbert
from paddle_tpu_torch.static import InputSpec
from paddle_tpu_torch.vision.models import LeNet

BERT_TOL = 1e-4       # tests/test_torch_bert.py's FWD_TOL
LENET_TOL = 1e-5
SEQ, VOCAB = 16, 100
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def cpu_default():
    old = pt.get_device()
    pt.set_device("cpu")
    yield
    pt.set_device(old)


def _cfg(mod):
    return mod.BertConfig(vocab_size=VOCAB, hidden_size=64,
                          num_hidden_layers=2, num_attention_heads=4,
                          intermediate_size=128, hidden_dropout_prob=0.0,
                          attention_dropout_prob=0.0)


def _bert_pair(seed=0):
    paddle.seed(seed)
    jnet = jbert.BertForQuestionAnswering(_cfg(jbert))
    jnet.eval()
    tnet = tbert.BertForQuestionAnswering(_cfg(tbert)).eval()
    layer_from_jax(tnet, jnet.state_dict())
    return jnet, tnet


def _lenet_pair(seed=0):
    paddle.seed(seed)
    jnet = JLeNet()
    jnet.eval()
    tnet = LeNet().eval()
    layer_from_jax(tnet, jnet.state_dict())
    return jnet, tnet


def _ids(rows, seed=1):
    rs = np.random.RandomState(seed)
    return (rs.randint(0, VOCAB, (rows, SEQ)).astype(np.int64),
            rs.randint(0, 2, (rows, SEQ)).astype(np.int64))


def _images(rows, seed=2):
    return np.random.RandomState(seed).randn(rows, 1, 28, 28).astype(
        np.float32)


def _close(got, want, tol):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * max(np.abs(want).max(), 1e-30))


def _bert_specs(mod):
    return [mod.static.InputSpec([None, SEQ], "int64", "input_ids"),
            mod.static.InputSpec([None, SEQ], "int64", "token_type_ids")]




def _jax_predictor(path):
    from paddle_tpu.inference import Config, create_predictor
    return create_predictor(Config(path + ".pdmodel"))


def _port_predictor(path):
    cfg = inference.Config(path + ".pdmodel")
    cfg.disable_gpu()
    return inference.create_predictor(cfg)


def test_bert_artifact_serves_like_the_jax_one(tmp_path):
    jnet, tnet = _bert_pair()
    paddle.jit.save(jnet, str(tmp_path / "j"), input_spec=_bert_specs(paddle))
    jit.save(tnet, str(tmp_path / "t"), input_spec=_bert_specs(pt))
    jpred, tpred = (_jax_predictor(str(tmp_path / "j")),
                    _port_predictor(str(tmp_path / "t")))
    assert tpred.get_input_names() == ["input_ids", "token_type_ids"]
    for rows in (1, 3, 8):
        ids, types = _ids(rows, seed=rows)
        if rows == 1:
            want = jpred.run([ids, types])
        else:
            with pytest.raises(ValueError, match="Shape mismatch"):
                jpred.run([ids, types])
            want = [o.numpy() for o in jnet(paddle.to_tensor(ids),
                                            paddle.to_tensor(types))]
        got = tpred.run([ids, types])
        assert len(got) == len(want) == 2
        for g, w in zip(got, want):
            _close(g, w, BERT_TOL)
    meta = json.load(open(str(tmp_path / "t.meta.json")))
    assert meta["format_version"] == 1 and "cuda" in meta["platforms"]
    assert meta["input_specs"][0] == {"shape": [None, SEQ],
                                      "dtype": "int64", "name": "input_ids"}


def test_predictor_tensor_handles(tmp_path):
    jnet, tnet = _lenet_pair()
    spec = [InputSpec([None, 1, 28, 28], "float32", "image")]
    jit.save(tnet, str(tmp_path / "t"), input_spec=spec)
    pred = _port_predictor(str(tmp_path / "t"))
    x = _images(3)
    h = pred.get_input_handle("image")
    h.reshape([3, 1, 28, 28])
    h.copy_from_cpu(x.reshape(3, -1))
    outs = pred.run()
    want = jnet(paddle.to_tensor(x)).numpy()
    _close(outs[0], want, LENET_TOL)
    oh = pred.get_output_handle(pred.get_output_names()[0])
    _close(oh.copy_to_cpu(), want, LENET_TOL)
    with pytest.raises(ValueError, match="never set"):
        _port_predictor(str(tmp_path / "t")).run()


def test_model_save_training_false_matches_jax(tmp_path):
    jnet, tnet = _lenet_pair()
    jspec = [paddle.static.InputSpec([None, 1, 28, 28], "float32", "x")]
    paddle.Model(jnet, inputs=jspec).save(str(tmp_path / "j"),
                                          training=False)
    model = pt.Model(tnet, inputs=[InputSpec([None, 1, 28, 28], "float32",
                                             "x")], device="cpu")
    model.network.train()
    model.save(str(tmp_path / "t"), training=False)
    assert model.network.training      # the export flips to eval only
    for suffix in (".pdmodel", ".pdiparams", ".meta.json"):
        assert os.path.exists(str(tmp_path / "t") + suffix)
    x = _images(5)
    want = _jax_predictor(str(tmp_path / "j")).run([x])[0]
    got = _port_predictor(str(tmp_path / "t")).run([x])[0]
    _close(got, want, LENET_TOL)
    state = jit.load(str(tmp_path / "t"), device="cpu").state_dict()
    assert set(state) == set(tnet.state_dict())


def test_save_load_inference_model(tmp_path):
    jnet, tnet = _lenet_pair()
    x = _images(2)
    prefix = str(tmp_path / "inf")
    pt.static.save_inference_model(
        prefix, [InputSpec([None, 1, 28, 28], "float32", "x")], tnet)
    exe = pt.static.Executor(pt.CPUPlace())
    layer, feed_names, _ = pt.static.load_inference_model(prefix, exe)
    assert feed_names == ["x"]
    _close(layer(x).numpy(), jnet(paddle.to_tensor(x)).numpy(), LENET_TOL)


def test_load_in_a_fresh_process_imports_no_model_code(tmp_path):
    _, tnet = _bert_pair()
    prefix = str(tmp_path / "m")
    jit.save(tnet, prefix, input_spec=_bert_specs(pt))
    ids, types = _ids(2)
    with torch.no_grad():
        ref = tnet(torch.from_numpy(ids), torch.from_numpy(types))
    np.save(str(tmp_path / "ids.npy"), ids)
    np.save(str(tmp_path / "types.npy"), types)
    code = (
        "import sys\n"
        "import numpy as np\n"
        "from paddle_tpu_torch import inference\n"
        f"cfg = inference.Config({prefix + '.pdmodel'!r})\n"
        "cfg.disable_gpu()\n"
        "pred = inference.create_predictor(cfg)\n"
        f"outs = pred.run([np.load({str(tmp_path / 'ids.npy')!r}), "
        f"np.load({str(tmp_path / 'types.npy')!r})])\n"
        f"np.save({str(tmp_path / 'start.npy')!r}, outs[0])\n"
        "bad = [m for m in sys.modules if m.startswith(("
        "'paddle_tpu_torch.models', 'paddle_tpu_torch.vision', "
        "'paddle_tpu_torch.serving', 'jax', 'paddle_tpu.'))]\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    _close(np.load(str(tmp_path / "start.npy")), ref[0].numpy(), 1e-6)


def test_loading_without_a_card_raises_unless_the_cpu_is_asked(
        tmp_path, monkeypatch):
    _, tnet = _lenet_pair()
    prefix = str(tmp_path / "m")
    jit.save(tnet, prefix, input_spec=[InputSpec([None, 1, 28, 28])])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        jit.load(prefix)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        inference.create_predictor(inference.Config(prefix + ".pdmodel"))
    cfg = inference.Config(prefix + ".pdmodel")
    cfg.enable_use_gpu(100, 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        inference.create_predictor(cfg)
    cfg.disable_gpu()
    assert inference.create_predictor(cfg).device == torch.device("cpu")


def test_the_inert_knobs_warn_and_the_device_knobs_do_not():
    import warnings
    cfg = inference.Config("/nowhere/m.pdmodel")
    assert cfg.prog_file() == "/nowhere/m.pdmodel"
    for knob in (lambda: cfg.enable_tensorrt_engine(workspace_size=1),
                 lambda: cfg.switch_ir_optim(True),
                 cfg.enable_memory_optim):
        with pytest.warns(UserWarning, match="no effect"):
            knob()
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        cfg.disable_gpu()
        cfg.enable_use_gpu()
