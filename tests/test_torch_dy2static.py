"""dy2static in the port against the JAX package, on the CPU.

The JAX suite's programs (``tests/test_dy2static.py``: a tensor-dependent
``if`` with both branches assigning or both returning, an augmented
assignment in one branch, counted and data-bounded ``while`` loops, an
``if`` inside a ``while``, a Python-bool early return) run through both
packages' ``jit.to_static`` on the same numpy inputs and give equal
outputs (float32, within 1e-6 relative: the same few operations); the
program the JAX package refuses (a tensor-dependent return from one
branch only) the port refuses too, with a ``Dy2StaticError`` that names
the function and the line. Under the port's trace (``torch.export``) a
tensor ``if`` becomes ``torch.cond`` and a tensor ``while``
``while_loop``: one captured program gives each input its own branch and
trip count. A Layer with control flow round-trips through ``jit.save`` /
``jit.load`` with a dynamic batch, trains on the tape, and the
``ProgramTranslator`` switch gives the same outputs eagerly.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.jit as jjit
import paddle_tpu_torch as pt
from paddle_tpu_torch import jit, nn
from paddle_tpu_torch.convert import layer_from_jax
from paddle_tpu_torch.jit.dy2static import Dy2StaticError, convert_to_static
from paddle_tpu_torch.static import InputSpec

RTOL = 1e-6


@pytest.fixture(autouse=True)
def cpu_default():
    old = pt.get_device()
    pt.set_device("cpu")
    yield
    pt.set_device(old)


def _j(a, dtype="float32"):
    return paddle.to_tensor(np.asarray(a, dtype))


def _t(a, dtype="float32"):
    return pt.to_tensor(np.asarray(a, dtype))


# module-level defs so inspect.getsource works; ``T`` makes a tensor of
# the package under test (both packages run the same source)

T = _t


def branch_assign(x):
    if x.mean() > 0:
        y = x + 1.0
    else:
        y = x - 1.0
    return y * 2.0


def branch_return(x):
    if x.sum() > 0:
        return x * 2.0
    else:
        return -x


def counted_while(x):
    i = T(0, "int32")
    s = x
    while i < 5:
        s = s * 1.5
        i = i + 1
    return s


def data_bounded_while(x):
    s = T(0.0)
    i = T(0.0)
    while i < x.sum():
        s = s + i
        i = i + 1.0
    return s


def python_early_return(x, labels=None):
    y = x * 2.0
    if labels is None:
        return y
    return y + labels


def if_in_while(x):
    i = T(0, "int32")
    s = x
    while i < 4:
        if s.sum() > 10.0:
            s = s - 1.0
        else:
            s = s + 3.0
        i = i + 1
    return s


def one_sided_return(x):
    if x.mean() > 0:
        return x
    x = x * 2.0
    return x


def augassign_branch(x):
    total = x * 0.0
    if x.mean() > 0:
        total += x
    return total


CASES = [
    ("branch_assign", ([1.0, 2.0], [-1.0, -2.0])),
    ("branch_return", ([1.0, 2.0], [-1.0, -2.0])),
    ("counted_while", ([1.0], [-0.5])),
    ("data_bounded_while", ([4.0], [6.0])),
    ("python_early_return", ([1.0], [-3.0])),
    ("if_in_while", ([1.0], [20.0])),
    ("augassign_branch", ([2.0], [-2.0])),
]


def _jax_out(fn, x):
    global T
    T = _j
    try:
        return np.asarray(jjit.to_static(fn)(_j(x)).numpy())
    finally:
        T = _t


@pytest.mark.parametrize("name,inputs", CASES, ids=[c[0] for c in CASES])
def test_program_matches_jax_to_static(name, inputs):
    fn = globals()[name]
    sf = jit.to_static(fn)
    for x in inputs:
        got = sf(_t(x)).numpy()
        np.testing.assert_allclose(got, _jax_out(fn, x), rtol=RTOL)
    # both inputs share a signature: one captured program took both
    # branches / trip counts
    assert len(sf._programs) == 1


@pytest.mark.parametrize("name,hop", [("branch_assign", "cond"),
                                      ("counted_while", "while_loop"),
                                      ("if_in_while", "while_loop")])
def test_tensor_control_flow_becomes_a_higher_order_op(name, hop):
    sf = jit.to_static(globals()[name])
    sf(_t([1.0]))
    targets = {getattr(n.target, "__name__", str(n.target))
               for n in sf.concrete_program.graph.nodes
               if n.op == "call_function"}
    assert hop in targets, targets


def test_one_sided_tensor_return_is_refused_by_both():
    with pytest.raises(Exception, match="one_sided_return"):
        _jax_out(one_sided_return, [1.0, 2.0])
    with pytest.raises(Dy2StaticError, match="one_sided_return") as e:
        jit.to_static(one_sided_return)(_t([1.0, 2.0]))
    assert "if x.mean() > 0" in str(e.value)


def test_mismatched_branches_are_refused():
    def mismatched(x):
        if x.mean() > 0:
            y = x.sum()
        else:
            y = x
        return y

    with pytest.raises(Dy2StaticError, match="matching"):
        jit.to_static(mismatched)(_t([1.0, 2.0]))


class CtrlNet(nn.Layer):
    def __init__(self):
        super().__init__()
        self.fc = nn.Linear(4, 4)

    def forward(self, x):
        h = self.fc(x)
        if h.mean() > 0:
            out = h * 2.0
        else:
            out = h - 1.0
        i = T(0, "int32")
        while i < 3:
            out = out + 0.5
            i = i + 1
        return out


class JCtrlNet(paddle.nn.Layer):
    def __init__(self):
        super().__init__()
        self.fc = paddle.nn.Linear(4, 4)

    def forward(self, x):
        h = self.fc(x)
        if h.mean() > 0:
            out = h * 2.0
        else:
            out = h - 1.0
        i = _j(0, "int32")
        while i < 3:
            out = out + 0.5
            i = i + 1
        return out


def _ctrl_pair(seed):
    paddle.seed(seed)
    jnet = JCtrlNet()
    tnet = CtrlNet()
    layer_from_jax(tnet, jnet.state_dict())
    return jnet, tnet


def test_layer_save_load_round_trip_matches_jax(tmp_path):
    jnet, tnet = _ctrl_pair(0)
    spec = [InputSpec([None, 4], "float32")]
    tnet = jit.to_static(tnet, input_spec=spec)
    jnet = jjit.to_static(jnet, input_spec=[paddle.static.InputSpec(
        [None, 4], "float32")])
    x = np.random.RandomState(0).randn(2, 4).astype(np.float32)
    with torch.no_grad():
        y0 = tnet(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(y0, jnet(_j(x)).numpy(), rtol=1e-5,
                               atol=1e-6)
    jit.save(tnet, str(tmp_path / "model"))
    loaded = jit.load(str(tmp_path / "model"), device="cpu")
    np.testing.assert_allclose(loaded(x).numpy(), y0, rtol=1e-5)
    for rows in (1, 5):                     # the batch stayed dynamic
        xb = np.random.RandomState(rows).randn(rows, 4).astype(np.float32)
        with torch.no_grad():
            want = tnet(torch.from_numpy(xb)).numpy()
        np.testing.assert_allclose(loaded(xb).numpy(), want, rtol=1e-5)


def test_training_still_on_tape():
    _, net = _ctrl_pair(1)
    net = jit.to_static(net)
    x = torch.from_numpy(np.random.RandomState(1).randn(2, 4).astype(
        np.float32))
    opt = pt.optimizer.SGD(learning_rate=0.1, parameters=net.parameters())
    loss = (net(x) ** 2).mean()
    loss.backward()
    assert net.fc.weight.grad is not None
    opt.step()
    assert np.isfinite(float(loss))
    assert net.forward._programs == {}      # nothing was captured


def test_program_translator_toggle():
    _, net = _ctrl_pair(2)
    net = jit.to_static(net)
    x = torch.from_numpy(np.random.RandomState(2).randn(2, 4).astype(
        np.float32))
    with torch.no_grad():
        y_static = net(x)
        jit.ProgramTranslator().enable(False)
        try:
            y_eager = net(x)
        finally:
            jit.ProgramTranslator().enable(True)
    assert len(net.forward._programs) == 1
    np.testing.assert_allclose(y_eager.numpy(), y_static.numpy(), rtol=1e-5)


def test_no_control_flow_returns_original():
    def plain(x):
        return x + 1

    assert convert_to_static(plain) is plain


def test_source_unavailable_returns_original():
    fn = eval("lambda x: x + 1")
    assert convert_to_static(fn) is fn


def test_closure_preserved():
    scale = 3.0

    def outer():
        def inner(x):
            if x.mean() > 0:
                y = x * scale
            else:
                y = x
            return y
        return inner

    conv = convert_to_static(outer())
    out = jit.to_static(conv)(_t([2.0]))
    np.testing.assert_allclose(out.numpy(), [6.0])
