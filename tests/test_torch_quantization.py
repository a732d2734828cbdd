"""``quantization`` of the PyTorch port against the JAX package's, on the
CPU.

* ``fake_quant``: the same values bit for bit (both round half to even,
  in the input's dtype, in one order) and the straight-through gradient
  (ones);
* the observers: ``MovingAverageAbsMaxScale``'s state after three
  batches in training and its frozen scale in eval, equal within 1e-6;
* ``ImperativeQuantAware.quantize`` swaps every ``Linear`` and
  ``Conv2D``, and the AMP orders give the JAX dtypes: ``decorate`` (O2,
  bf16) after ``quantize`` makes the observers' state bf16, before it
  leaves it float32; ``decorate`` after ``convert_to_int8`` makes
  ``weight_scale`` bf16 and leaves ``weight_int8`` int8 without a
  gradient;
* a 2-layer, hidden-64 BERT (question answering) trained three QAT steps
  (SGD, lr 0.05) in both packages from the same weights: the losses
  within 1e-4 relative; ``convert_to_int8`` then gives equal int8 codes
  and scales within 1e-6. Fake quantization is discontinuous at a
  rounding boundary, so an activation that lies within float32 rounding
  of one in either package flips a code and moves the loss by ~1e-3;
  the data here puts none there (the codes are compared, so a flip
  would show as such);
* ``quantize_weight`` of a ``Linear``'s weight is per output channel
  (the JAX ``[in, out]`` axis -1, the port's axis 0);
* PTQ: the recorded scales equal the JAX ones within 1e-6, and the
  frozen model's output agrees within 1e-5;
* ``convert`` carries QAT-wrapped and int8 models both ways;
  ``save_quantized_model`` writes int8 to the ``.pdiparams`` and its
  artifact reproduces the live model.

``test_torch_quant_pass.py`` holds the convolution layers and the static
pass.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import quantization as jq
from paddle_tpu.models import bert as jbert
import paddle_tpu_torch as pt
from paddle_tpu_torch import quantization as tq
from paddle_tpu_torch.convert import layer_from_jax, layer_to_numpy
from paddle_tpu_torch.models import bert as tbert
from paddle_tpu_torch.vision.models import LeNet

LOSS_TOL = 1e-4
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


@pytest.mark.parametrize("bits", [8, 4])
def test_fake_quant_codes_and_straight_through_gradient(bits):
    rs = np.random.RandomState(bits)
    x = (rs.randn(64, 96) * 0.3).astype(np.float32)
    for scale in (np.abs(x).max(), 0.2, 0.0):
        want = _np(jq.fake_quant(x, scale, bits))
        t = torch.tensor(x, requires_grad=True)
        got = tq.fake_quant(t, scale, bits)
        assert np.array_equal(got.detach().numpy(), want)
        got.sum().backward()
        assert torch.equal(t.grad, torch.ones_like(t))


def test_moving_average_observer_matches_jax():
    rs = np.random.RandomState(1)
    jo, to = jq.MovingAverageAbsMaxScale(), tq.MovingAverageAbsMaxScale()
    for i in range(3):
        x = (rs.randn(8, 16) * (i + 1)).astype(np.float32)
        want = _np(jo(paddle.to_tensor(x)).numpy())
        got = to(torch.tensor(x)).numpy()
        assert np.array_equal(got, want)
        np.testing.assert_allclose(to.scale_state.numpy(),
                                   _np(jo.scale_state), rtol=SCALE_TOL)
    assert to.scale_state.dtype == torch.float32
    jo.eval()
    to.eval()
    x = (rs.randn(8, 16) * 9).astype(np.float32)
    before = to.scale_state.clone()
    assert np.array_equal(to(torch.tensor(x)).numpy(),
                          _np(jo(paddle.to_tensor(x)).numpy()))
    assert torch.equal(to.scale_state, before)


def _bert_cfg(mod):
    return mod.BertConfig(vocab_size=128, hidden_size=64,
                          num_hidden_layers=2, num_attention_heads=2,
                          intermediate_size=128, max_position_embeddings=32,
                          hidden_dropout_prob=0.0, attention_dropout_prob=0.0)


def _bert_pair(seed=1, tiny=False):
    """The JAX and the port's question-answering BERT (hidden 64, or
    ``BertConfig.tiny()``'s 32 where nothing trains)."""
    paddle.seed(seed)
    cfg = (lambda m: m.BertConfig.tiny()) if tiny else _bert_cfg
    return (jbert.BertForQuestionAnswering(cfg(jbert)),
            tbert.BertForQuestionAnswering(cfg(tbert)))


def _bert_batch():
    rs = np.random.RandomState(0)
    return (rs.randint(0, 128, (4, 16)), rs.randint(0, 16, (4,)),
            rs.randint(0, 16, (4,)))


def test_quantize_swaps_every_linear_and_conv():
    jn, tn = _bert_pair(tiny=True)
    n_linear = sum(isinstance(m, pt.nn.Linear) for m in tn.modules())
    tq.ImperativeQuantAware().quantize(tn)
    jq.ImperativeQuantAware().quantize(jn)
    got = sum(isinstance(m, tq.QuantizedLinear) for m in tn.modules())
    want = sum(isinstance(m, jq.QuantizedLinear)
               for _, m in jn.named_sublayers())
    assert got == want == n_linear == 2 * 6 + 2
    assert not any(type(m) is pt.nn.Linear and not isinstance(
        p, tq.QuantizedLinear) for p in tn.modules()
        for m in p.children())
    assert set(tn.state_dict()) == set(jn.state_dict())
    net = LeNet()
    tq.ImperativeQuantAware().quantize(net)
    kinds = [type(m).__name__ for m in net.modules()]
    assert kinds.count("QuantizedConv2D") == 2
    assert kinds.count("QuantizedLinear") == 3
    only = tq.ImperativeQuantAware(quantizable_layer_type=("Conv2D",))
    net = only.quantize(LeNet())
    assert not any(isinstance(m, tq.QuantizedLinear) for m in net.modules())


@pytest.mark.parametrize("order", ["decorate_after", "decorate_before"])
def test_amp_orders_give_the_jax_dtypes(order):
    """O2 ``decorate`` casts the floating parameters and buffers and
    leaves int8 alone, in both packages."""
    jn, tn = _bert_pair(tiny=True)
    layer_from_jax(tn, _jstate(jn))
    for pkg, net, q in ((paddle, jn, jq), (pt, tn, tq)):
        if order == "decorate_before":
            pkg.amp.decorate(net, level="O2", dtype="bfloat16")
        q.ImperativeQuantAware().quantize(net)
        if order == "decorate_after":
            pkg.amp.decorate(net, level="O2", dtype="bfloat16")
    jstate = jn.bert.pooler.act_quant.scale_state
    tstate = tn.bert.pooler.act_quant.scale_state
    want = "bfloat16" if order == "decorate_after" else "float32"
    assert str(_np(jstate).dtype) == want
    assert str(tstate.dtype) == f"torch.{want}"
    for net, q in ((jn, jq), (tn, tq)):
        q.convert_to_int8(net)
    pt.amp.decorate(tn, level="O2", dtype="bfloat16")
    paddle.amp.decorate(jn, level="O2", dtype="bfloat16")
    lin = tn.bert.pooler
    jlin = jn.bert.pooler
    assert lin.weight_int8.dtype == torch.int8
    assert not lin.weight_int8.requires_grad
    assert not lin.weight_scale.requires_grad
    assert lin.weight_scale.dtype == torch.bfloat16
    assert str(_np(jlin.weight_scale).dtype) == "bfloat16"
    assert str(_np(jlin.weight_int8).dtype) == "int8"
    assert tuple(lin.weight_int8.shape) == tuple(
        reversed(_np(jlin.weight_int8).shape))


def test_bert_qat_steps_and_int8_codes_match_jax():
    jn, tn = _bert_pair()
    jq.ImperativeQuantAware().quantize(jn)
    tq.ImperativeQuantAware().quantize(tn)
    layer_from_jax(tn, _jstate(jn))
    ids, st, en = _bert_batch()
    jopt = paddle.optimizer.SGD(learning_rate=0.05,
                                parameters=jn.parameters())
    topt = pt.optimizer.SGD(learning_rate=0.05, parameters=tn.parameters())
    for _ in range(3):
        jl = jn(paddle.to_tensor(ids), start_positions=paddle.to_tensor(st),
                end_positions=paddle.to_tensor(en))[0]
        jl.backward()
        jopt.step()
        jopt.clear_grad()
        tl = tn(torch.tensor(ids), start_positions=torch.tensor(st),
                end_positions=torch.tensor(en))[0]
        tl.backward()
        topt.step()
        topt.clear_grad()
        want = float(_np(jl.numpy()))
        assert abs(tl.item() - want) <= LOSS_TOL * abs(want)
    js, ts = _jstate(jn), layer_to_numpy(tn)
    for key in js:
        if key.endswith("scale_state"):
            np.testing.assert_allclose(ts[key], js[key], rtol=SCALE_TOL)
    jq.convert_to_int8(jn)
    tq.convert_to_int8(tn)
    js, ts = _jstate(jn), layer_to_numpy(tn)
    assert set(js) == set(ts)
    codes = [k for k in js if k.endswith("weight_int8")]
    assert len(codes) == 14
    for key in codes:
        assert ts[key].dtype == np.int8 and np.array_equal(ts[key], js[key])
        scale = key.replace("int8", "scale")
        assert ts[scale].shape == js[scale].shape == (1, js[key].shape[1])
        np.testing.assert_allclose(ts[scale], js[scale], rtol=SCALE_TOL)
    with torch.no_grad():
        got = tn(torch.tensor(ids))
    want = jn(paddle.to_tensor(ids))
    for g, w in zip(got, want):
        _close(g.numpy(), _np(w.numpy()))


def test_quantize_weight_of_a_linear_is_per_output_channel():
    paddle.seed(3)
    jlin = paddle.nn.Linear(24, 10)
    tlin = pt.nn.Linear(24, 10)
    layer_from_jax(tlin, _jstate(jlin))
    jqw, jsc = jq.quantize_weight(_np(jlin.weight._data))
    with torch.no_grad():
        tqw, tsc = tq.quantize_weight(tlin.weight)
    assert tuple(tqw.shape) == (10, 24) and tuple(tsc.shape) == (10, 1)
    assert np.array_equal(tqw.t().numpy(), _np(jqw))
    np.testing.assert_allclose(tsc.t().numpy(), _np(jsc), rtol=SCALE_TOL)
    # an unmarked array takes the axis as given, as the JAX function does
    w = np.random.RandomState(0).randn(3, 4, 5).astype(np.float32)
    for axis in (0, 1, -1):
        jqw, jsc = jq.quantize_weight(w, channel_axis=axis)
        tqw, tsc = tq.quantize_weight(torch.tensor(w), channel_axis=axis)
        assert np.array_equal(tqw.numpy(), _np(jqw))
        np.testing.assert_allclose(tsc.numpy(), _np(jsc), rtol=SCALE_TOL)


def test_ptq_scales_match_jax():
    jn, tn = _bert_pair(2)
    layer_from_jax(tn, _jstate(jn))
    ids, _, _ = _bert_batch()
    batches = [ids[:2], ids[2:]]
    jp = jq.PostTrainingQuantization(jn)
    tp = tq.PostTrainingQuantization(tn)
    want = jp.collect([paddle.to_tensor(b) for b in batches])
    got = tp.collect([torch.tensor(b) for b in batches])
    # neither question-answering head runs the pooler
    assert set(got) == set(want) and len(got) == 13
    for k in want:
        assert abs(got[k] - want[k]) <= SCALE_TOL * want[k], k
    # each scale is the largest |input| of that Linear, read directly
    seen = {}
    lin = tn.bert.encoder.layers[0].linear1
    h = lin.register_forward_pre_hook(
        lambda m, i: seen.setdefault("x", []).append(i[0].abs().max()))
    with torch.no_grad():
        for b in batches:
            tn(torch.tensor(b))
    h.remove()
    assert got["bert.encoder.layers.0.linear1"] == max(seen["x"]).item()
    jm, tm = jp.quantize(), tp.quantize()
    assert not tm.training
    assert tm.bert.encoder.layers[0].linear1.act_quant.scale_state.item() \
        == pytest.approx(got["bert.encoder.layers.0.linear1"], rel=1e-7)
    with torch.no_grad():
        out = tm(torch.tensor(ids))
    for g, w in zip(out, jm(paddle.to_tensor(ids))):
        _close(g.numpy(), _np(w.numpy()))


def test_convert_round_trips_qat_and_int8_models():
    jn, tn = _bert_pair(7, tiny=True)
    for q, net in ((jq, jn), (tq, tn)):
        q.ImperativeQuantAware().quantize(net)
    js = _jstate(jn)
    layer_from_jax(tn, js)
    back = layer_to_numpy(tn)
    assert set(back) == set(js)
    for k in js:
        np.testing.assert_array_equal(back[k], js[k].astype(back[k].dtype))
    for q, net in ((jq, jn), (tq, tn)):
        q.convert_to_int8(net)
    js = _jstate(jn)
    tn2 = tbert.BertForQuestionAnswering(tbert.BertConfig.tiny())
    tq.convert_to_int8(tn2)
    layer_from_jax(tn2, js)
    back = layer_to_numpy(tn2)
    for k in js:
        assert back[k].dtype == js[k].dtype or k.endswith("scale"), k
        np.testing.assert_array_equal(back[k], js[k].astype(back[k].dtype))


def test_save_quantized_model_keeps_int8_and_serves(tmp_path):
    from paddle_tpu_torch import jit
    from paddle_tpu_torch.static import InputSpec
    _, tn = _bert_pair(8, tiny=True)
    tq.ImperativeQuantAware().quantize(tn)
    ids, st, en = _bert_batch()
    tn(torch.tensor(ids), start_positions=torch.tensor(st),
       end_positions=torch.tensor(en))        # one observed batch
    path = str(tmp_path / "qat")
    model = tq.ImperativeQuantAware().save_quantized_model(
        tn, path, input_spec=[InputSpec([None, 16], "int64", "ids")])
    state = pt.load(path + ".pdiparams")
    keys = [k for k in state if k.endswith("weight_int8")]
    assert len(keys) == 14
    assert all(np.asarray(state[k]).dtype == np.int8 for k in keys)
    loaded = jit.load(path, device="cpu")
    with torch.no_grad():
        want = model(torch.tensor(ids))
        got = loaded(torch.tensor(ids[:3]))
    for g, w in zip(got, want):
        _close(g.detach().numpy(), w[:3].numpy())
    # the int8 weights reach the graph as int8 inputs, dequantized there
    ep = loaded._exported
    int8 = [n for n in ep.graph.nodes if n.op == "placeholder"
            and n.meta.get("val") is not None
            and n.meta["val"].dtype == torch.int8]
    assert len(int8) == 14
    # each one the forward reads (all but the pooler's) is dequantized
    # by the graph's own ops
    read = [n for n in int8 if n.users]
    assert len(read) == 13 and all(
        u.op == "call_function" for n in read for u in n.users)
