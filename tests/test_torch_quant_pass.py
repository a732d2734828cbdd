"""Quantization's convolution layers and its static-program pass, PyTorch
port against the JAX package, on the CPU.

* ``QuantizedConv2D`` and ``QuantizedInferenceConv2D`` on a ResNet
  ``BasicBlock``: outputs within 1e-5 of the largest over two observed
  batches and after ``convert_to_int8``, whose codes are equal;
* the static pass over recorded BERT and LeNet programs: every
  ``linear`` and ``conv2d`` node has its weight found (through the
  ``t`` node for a ``Linear``, whose ``[out, in]`` weight the port hands
  to ``linear`` transposed), and the transformed program quantizes only
  those nodes;
* LeNet's PTQ program (``PostTrainingQuantizationProgram``: abs-max
  calibration, then the pass with frozen scales) agrees with the JAX one
  within 1e-5, the scales within 1e-6 (abs-max) and 1e-5 (the 99th
  percentile); the float program's output is untouched.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import quantization as jq
from paddle_tpu.vision.models import LeNet as JLeNet
from paddle_tpu.vision.models.resnet import BasicBlock as JBlock
import paddle_tpu_torch as pt
from paddle_tpu_torch import quantization as tq, static
from paddle_tpu_torch.convert import layer_from_jax, layer_to_numpy
from paddle_tpu_torch.models import bert as tbert
from paddle_tpu_torch.vision.models import LeNet
from paddle_tpu_torch.vision.models.resnet import BasicBlock as TBlock

SCALE_TOL = 1e-6
FWD_TOL = 1e-5


@pytest.fixture(autouse=True)
def cpu_default():
    old = pt.get_device()
    pt.set_device("cpu")
    yield
    pt.set_device(old)
    pt.disable_static()


def _np(t):
    return np.asarray(t._data if hasattr(t, "_data") else t)


def _jstate(net):
    return {k: _np(v) for k, v in net.state_dict().items()}


def _close(got, want, tol=FWD_TOL):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * max(np.abs(want).max(), 1e-30))


def _bert_cfg(mod):
    return mod.BertConfig(vocab_size=128, hidden_size=64,
                          num_hidden_layers=2, num_attention_heads=2,
                          intermediate_size=128, max_position_embeddings=32,
                          hidden_dropout_prob=0.0, attention_dropout_prob=0.0)


def test_quantized_conv_on_a_resnet_block_matches_jax():
    paddle.seed(4)
    jb = JBlock(8, 8)
    tb = TBlock(8, 8)
    layer_from_jax(tb, _jstate(jb))
    jb.eval()
    tb.eval()
    x = np.random.RandomState(2).randn(2, 8, 10, 10).astype(np.float32)
    jq.ImperativeQuantAware().quantize(jb)
    tq.ImperativeQuantAware().quantize(tb)
    assert sum(isinstance(m, tq.QuantizedConv2D) for m in tb.modules()) == 2
    for _ in range(2):          # the observers' first and second batch
        jb.train()
        tb.train()
        want = _np(jb(paddle.to_tensor(x)).numpy())
        with torch.no_grad():
            got = tb(torch.tensor(x)).numpy()
        _close(got, want)
    jq.convert_to_int8(jb)
    tq.convert_to_int8(tb)
    js, ts = _jstate(jb), layer_to_numpy(tb)
    assert set(js) == set(ts)
    for k in js:
        if k.endswith("weight_int8"):
            assert np.array_equal(ts[k], js[k])
    jb.eval()
    tb.eval()
    with torch.no_grad():
        got = tb(torch.tensor(x)).numpy()
    _close(got, _np(jb(paddle.to_tensor(x)).numpy()))


def _record(pkg, net, name, shape, dtype):
    main = pkg.static.Program()
    with pkg.static.program_guard(main, pkg.static.Program()):
        x = pkg.static.data(name=name, shape=shape, dtype=dtype)
        out = net(x)
    return main, out


@pytest.fixture
def both_static():
    paddle.enable_static()
    pt.enable_static()
    try:
        yield
    finally:
        paddle.disable_static()
        pt.disable_static()


def test_static_pass_finds_every_weight_of_bert_and_lenet(both_static):
    from paddle_tpu_torch.quantization.passes import (
        _transposed_params, _weight_and_act_indices)
    paddle.seed(5)
    cases = ((tbert.BertModel(_bert_cfg(tbert)), "ids", [None, 16], "int64",
              {"linear": 13}),
             (LeNet(), "image", [None, 1, 28, 28], "float32",
              {"linear": 3, "conv2d": 2}))
    for net, name, shape, dtype, want in cases:
        net.eval()
        prog, _ = _record(pt, net, name, shape, dtype)
        t_params = _transposed_params(prog)
        found = {}
        for node in prog._nodes:
            if node.op not in ("linear", "conv2d") or node.torch_function:
                continue
            widx, aidx = _weight_and_act_indices(node, t_params)
            assert widx is not None and aidx is not None, node.op
            tid = node.inputs[widx][0]
            if node.op == "linear":
                # the operand is the t of a Linear's [out, in] weight
                assert tid in t_params
            else:
                assert isinstance(node.inputs[widx][1], torch.nn.Parameter)
            found[node.op] = found.get(node.op, 0) + 1
        assert found == want
        qprog = tq.QuantizationTransformPass().apply(prog)
        assert qprog._quant_info["nodes"] and all(
            prog._nodes[i].op in want for i in qprog._quant_info["nodes"])


def test_lenet_ptq_program_matches_jax(both_static):
    paddle.seed(6)
    jnet, tnet = JLeNet(), LeNet()
    layer_from_jax(tnet, _jstate(jnet))
    rs = np.random.RandomState(3)
    feeds = [{"image": rs.randn(4, 1, 28, 28).astype(np.float32)}
             for _ in range(2)]
    outs = {}
    for key, pkg, net, q in (("jax", paddle, jnet, jq),
                             ("port", pt, tnet, tq)):
        prog, out = _record(pkg, net, "image", [None, 1, 28, 28],
                            "float32")
        ptq = q.PostTrainingQuantizationProgram(prog, feeds)
        qprog = ptq.quantize()
        exe = pkg.static.Executor()
        outs[key] = (ptq.scales, exe.run(qprog, feed=feeds[0],
                                         fetch_list=[out])[0],
                     exe.run(prog, feed=feeds[0], fetch_list=[out])[0])
        pct = q.calibrate_program(prog, feeds, algo="percentile",
                                  percentile=99.0)
        outs[key] += (pct,)
    (js, jout, jfloat, jpct), (ts, tout, tfloat, tpct) = \
        outs["jax"], outs["port"]
    assert len(ts) == len(js) == 5
    for a, b in zip(sorted(ts.values()), sorted(js.values())):
        assert abs(a - b) <= SCALE_TOL * b
    for a, b in zip(sorted(tpct.values()), sorted(jpct.values())):
        assert abs(a - b) <= 1e-5 * b
    _close(tout, jout)
    _close(tfloat, jfloat)
    assert not np.array_equal(tout, tfloat)
    with pytest.raises(ValueError, match="cannot quantize"):
        tq.QuantizationTransformPass(quantizable_op_type=("gru",))
    with pytest.raises(ValueError, match="at least one"):
        tq.PostTrainingQuantizationProgram(static.Program(), [])


def test_quantized_conv_keeps_its_data_format():
    """An NHWC ``Conv2D`` quantized runs NHWC (the JAX ``QuantizedConv2D``
    drops the format, ROADMAP Queue 3): its output is the NCHW layer's
    on the transposed input, transposed back."""
    pt.seed(9)
    nchw = pt.nn.Conv2D(3, 4, 3)
    nhwc = pt.nn.Conv2D(3, 4, 3, data_format="NHWC")
    nhwc.load_dict(nchw.state_dict())
    x = torch.from_numpy(np.random.RandomState(4).randn(2, 3, 6, 6)
                         .astype(np.float32))
    outs = []
    for net, inp in ((nchw, x), (nhwc, x.permute(0, 2, 3, 1))):
        q = tq.ImperativeQuantAware().quantize(torch.nn.Sequential(net))
        outs.append(q(inp).detach())
    _close(outs[1].permute(0, 3, 1, 2).numpy(), outs[0].numpy())
