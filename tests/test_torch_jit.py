"""``jit`` in the port against the JAX package, on the CPU.

Both packages build a 2-layer BERT question-answering network (hidden 64,
4 heads, ffn 128, vocabulary 100, dropouts 0) and LeNet from the same
weights (the JAX state carried across with ``convert.layer_from_jax``),
and take the same ``RandomState`` inputs. ``to_static`` outputs agree
with the JAX ``to_static`` within ``tests/test_torch_bert.py``'s float32
bound (1e-4 of the largest value; LeNet 1e-5), the captured BERT program
calls the kernels' custom ops, and a ``to_static`` layer computes with
the new weights after an optimizer step. ``TracedLayer`` round-trips,
and ``jit.save`` raises when the traced code fixes a ``None`` dimension
instead of exporting it static. ``tests/test_torch_inference.py`` holds
the saved artifacts against the JAX package's.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models import bert as jbert
from paddle_tpu.vision.models import LeNet as JLeNet
import paddle_tpu_torch as pt
from paddle_tpu_torch import jit
from paddle_tpu_torch.convert import layer_from_jax
from paddle_tpu_torch.models import bert as tbert
from paddle_tpu_torch.static import InputSpec
from paddle_tpu_torch.vision.models import LeNet

BERT_TOL = 1e-4       # tests/test_torch_bert.py's FWD_TOL
LENET_TOL = 1e-5
SEQ, VOCAB = 16, 100


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




def test_to_static_bert_matches_jax():
    jnet, tnet = _bert_pair()
    ids, types = _ids(3)
    jnet = paddle.jit.to_static(jnet)
    want = jnet(paddle.to_tensor(ids), paddle.to_tensor(types))
    tnet = jit.to_static(tnet)
    with torch.no_grad():
        got = tnet(torch.from_numpy(ids), torch.from_numpy(types))
    assert len(tnet.forward._programs) == 1
    for g, w in zip(got, want):
        _close(g.numpy(), w.numpy(), BERT_TOL)
    targets = {str(n.target) for n in
               tnet.forward.concrete_program.graph.nodes}
    assert "paddle_tpu_torch.fused_layer_norm.default" in targets
    assert "paddle_tpu_torch.flash_attention_fwd.default" in targets


def test_to_static_lenet_matches_jax():
    jnet, tnet = _lenet_pair()
    x = _images(4)
    want = paddle.jit.to_static(jnet)(paddle.to_tensor(x)).numpy()
    with torch.no_grad():
        got = jit.to_static(tnet)(torch.from_numpy(x)).numpy()
    _close(got, want, LENET_TOL)


def test_to_static_layer_is_not_stale_after_a_step():
    _, net = _lenet_pair()
    net = jit.to_static(net)
    x = torch.from_numpy(_images(4))
    with torch.no_grad():
        before = net(x).clone()
    opt = pt.optimizer.SGD(learning_rate=0.1, parameters=net.parameters())
    loss = (net(x) ** 2).mean()            # the tape: grad is enabled
    loss.backward()
    opt.step()
    with torch.no_grad():
        after = net(x)
        eager = jit.ProgramTranslator()
        eager.enable(False)
        try:
            want = net(x)
        finally:
            eager.enable(True)
    assert len(net.forward._programs) == 1
    assert not torch.allclose(before, after)
    torch.testing.assert_close(after, want, rtol=0, atol=0)


def test_traced_layer_roundtrip(tmp_path):
    _, net = _lenet_pair()
    x = torch.from_numpy(_images(2))
    out, traced = jit.TracedLayer.trace(net, [x])
    path = str(tmp_path / "traced")
    traced.save_inference_model(path)
    loaded = jit.load(path, device="cpu")
    with torch.no_grad():
        torch.testing.assert_close(loaded(x), net(x), rtol=1e-5, atol=1e-6)


def test_a_dimension_the_trace_fixes_raises(tmp_path):
    class Fixed(pt.nn.Layer):
        def forward(self, x):
            return x + torch.ones(2, 3)    # needs the batch at 2 rows

    with pytest.raises(ValueError, match=r"\[\(0, 0\)\].*fixes them"):
        jit.save(Fixed(), str(tmp_path / "f"),
                 input_spec=[InputSpec([None, 3])])
