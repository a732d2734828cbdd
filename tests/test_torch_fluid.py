"""``fluid``, the 1.x namespace, in the port against the JAX package on
the CPU: the cases of ``tests/test_fluid_shim.py`` run in both packages
on the same numpy inputs, the program's parameters carried across
(``convert.program_from_jax``). Forward values within rtol 1e-5 / atol
1e-6 (float32); the losses of a 1.x fit-a-line program after a few
``Executor.run`` steps within 1e-4. ``fluid.layers.data`` prepends the
batch dimension, ``fluid.layers.cross_entropy`` takes probabilities,
``fluid.io`` keeps the executor-first calling convention, and
``fluid.layers.<name>`` falls through to the top level, then to
``nn.functional``.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.fluid as jfluid
import paddle_tpu_torch as pt
from paddle_tpu_torch import fluid
from paddle_tpu_torch.convert import program_from_jax, program_to_numpy

RTOL, ATOL = 1e-5, 1e-6
TRAINED_TOL = 1e-4


@pytest.fixture(autouse=True)
def cpu_default():
    old = pt.get_device()
    pt.set_device("cpu")
    yield
    pt.set_device(old)
    pt.disable_static()
    paddle.disable_static()


@pytest.fixture
def both_static():
    paddle.enable_static()
    pt.enable_static()
    yield


def _close(got, want, rtol=RTOL, atol=ATOL):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


def _jax_params(prog):
    return {n: np.asarray(p._data) for n, p in prog._params.items()}


def _line(flu, hidden):
    main, startup = flu.Program(), flu.Program()
    with flu.program_guard(main, startup):
        x = flu.layers.data(name="x", shape=[13], dtype="float32")
        y = flu.layers.data(name="y", shape=[1], dtype="float32")
        h = flu.layers.fc(x, size=hidden, activation="tanh")
        pred = flu.layers.fc(h, size=1)
        loss = flu.layers.mean(flu.layers.square_error_cost(pred, y))
        flu.optimizer.SGD(learning_rate=0.02).minimize(loss)
    return main, startup, loss, pred


@pytest.mark.parametrize("hidden", [8, 16])
def test_fit_a_line_1x_style_matches_jax(both_static, hidden):
    jmain, jstart, jloss, _ = _line(jfluid, hidden)
    tmain, tstart, tloss, _ = _line(fluid, hidden)
    program_from_jax(tmain, _jax_params(jmain))
    rng = np.random.RandomState(0)
    xs = rng.randn(64, 13).astype("float32")
    ys = (xs @ rng.randn(13, 1)).astype("float32")
    losses = []
    for flu, main, start, loss in ((jfluid, jmain, jstart, jloss),
                                   (fluid, tmain, tstart, tloss)):
        exe = flu.Executor(flu.CPUPlace())
        exe.run(start)
        losses.append([float(exe.run(main, feed={"x": xs, "y": ys},
                                     fetch_list=[loss])[0])
                       for _ in range(5)])
    _close(losses[1], losses[0], rtol=TRAINED_TOL, atol=TRAINED_TOL)
    assert losses[1][-1] < losses[1][0]
    for got, want in zip(program_to_numpy(tmain).values(),
                         _jax_params(jmain).values()):
        _close(got, want, rtol=TRAINED_TOL, atol=TRAINED_TOL)


def test_data_prepends_the_batch_dim(both_static):
    outs = []
    for flu in (jfluid, fluid):
        main = flu.Program()
        with flu.program_guard(main):
            x = flu.layers.data(name="x", shape=[13])
            pred = flu.layers.fc(x, size=1)
        if flu is fluid:
            program_from_jax(main, _jax_params(jmain))
        else:
            jmain = main
        exe = flu.Executor()
        outs.append([exe.run(main, feed={"x": np.full((n, 13), 0.5,
                                                      "float32")},
                             fetch_list=[pred])[0] for n in (3, 7)])
    for got, want in zip(outs[1], outs[0]):
        _close(got, want)
    assert [o.shape for o in outs[1]] == [(3, 1), (7, 1)]
    main = fluid.Program()
    with fluid.program_guard(main):
        raw = fluid.layers.data(name="r", shape=[2, 5],
                                append_batch_size=False)
    assert tuple(raw.shape) == (2, 5)
    assert main._declared[main._feeds["r"]] == (2, 5)


def test_dygraph_guard_and_variable():
    with fluid.dygraph.guard():
        v = fluid.dygraph.to_variable(np.ones(3, "float32"))
        assert isinstance(v, fluid.Variable)
        assert fluid.in_dygraph_mode()
    pt.enable_static()
    with fluid.dygraph.guard():
        assert fluid.in_dygraph_mode()
    assert not fluid.in_dygraph_mode()


def test_layers_fallthrough_and_error():
    t = torch.ones(2, 3)
    assert tuple(fluid.layers.reshape(t, [3, 2]).shape) == (3, 2)  # top
    assert tuple(fluid.layers.relu(t).shape) == (2, 3)   # nn.functional
    assert fluid.layers.fc is pt.static.nn.fc
    assert fluid.layers.cond is pt.static.nn.cond
    with pytest.raises(AttributeError, match="not mapped"):
        fluid.layers.definitely_not_an_op
    with pytest.raises(AttributeError, match="not mapped"):
        jfluid.layers.definitely_not_an_op


@pytest.mark.parametrize("soft", [False, True])
def test_1x_cross_entropy_takes_probabilities(soft):
    probs = np.array([[0.9, 0.1], [0.2, 0.8]], "float32")
    label = np.array([[0], [1]], "int64") if not soft else \
        np.array([[0.7, 0.3], [0.1, 0.9]], "float32")
    want = jfluid.layers.cross_entropy(paddle.to_tensor(probs),
                                       paddle.to_tensor(label),
                                       soft_label=soft)
    got = fluid.layers.cross_entropy(torch.from_numpy(probs),
                                     torch.from_numpy(label),
                                     soft_label=soft)
    _close(got.numpy(), np.asarray(want.numpy()))
    if not soft:
        _close(got.numpy().reshape(-1), -np.log([0.9, 0.8]))


def test_cross_entropy_ignore_index_and_rank3():
    probs = np.random.RandomState(1).dirichlet(np.ones(4), (2, 3)).astype(
        "float32")
    label = np.random.RandomState(2).randint(0, 4, (2, 3, 1)).astype("int64")
    label[0, 1, 0] = -100                       # ignored position
    want = jfluid.layers.cross_entropy(paddle.to_tensor(probs),
                                       paddle.to_tensor(label),
                                       ignore_index=-100)
    got = fluid.layers.cross_entropy(torch.from_numpy(probs),
                                     torch.from_numpy(label),
                                     ignore_index=-100)
    assert tuple(got.shape) == (2, 3, 1) and float(got[0, 1, 0]) == 0.0
    _close(got.numpy(), np.asarray(want.numpy()))


def test_softmax_with_cross_entropy_matches_jax():
    logits = np.random.RandomState(3).randn(4, 5).astype("float32")
    label = np.array([[0], [4], [2], [1]], "int64")
    want = jfluid.layers.softmax_with_cross_entropy(
        paddle.to_tensor(logits), paddle.to_tensor(label))
    got = fluid.layers.softmax_with_cross_entropy(
        torch.from_numpy(logits), torch.from_numpy(label))
    _close(got.numpy(), np.asarray(want.numpy()))


def test_io_1x_calling_convention(both_static, tmp_path):
    progs = []
    for flu in (jfluid, fluid):
        main, startup = flu.Program(), flu.Program()
        with flu.program_guard(main, startup):
            x = flu.layers.data(name="x", shape=[4])  # per-sample shape
            out = flu.layers.fc(x, size=2)
        progs.append((main, out))
    (jm, jout), (tm, tout) = progs
    program_from_jax(tm, _jax_params(jm))
    exe = fluid.Executor(fluid.CPUPlace())
    d = str(tmp_path / "ckpt_dir")
    fluid.io.save_persistables(exe, d, tm)       # 1.x: executor first
    orig = program_to_numpy(tm)
    for p in tm._params.values():
        p.data.zero_()
    fluid.io.load_persistables(exe, d, tm)
    for n, arr in program_to_numpy(tm).items():
        np.testing.assert_array_equal(arr, orig[n])
    xs = np.random.RandomState(4).randn(5, 4).astype("float32")
    (want,) = jfluid.Executor().run(jm, feed={"x": xs}, fetch_list=[jout])
    fluid.io.save_inference_model(str(tmp_path / "inf"), ["x"], [tout],
                                  exe, tm)
    runner, feeds, fetches = fluid.io.load_inference_model(
        str(tmp_path / "inf"), exe)
    assert feeds == ["x"]
    _close(runner(xs).numpy(), want)
    _close(runner(xs[:2]).numpy(), want[:2])   # the batch stays dynamic


def test_framework_backward_are_submodules():
    from paddle_tpu_torch.fluid.backward import append_backward, gradients
    from paddle_tpu_torch.fluid.framework import (Parameter, Program,
                                                  in_dygraph_mode)
    assert Program is fluid.Program is pt.static.Program
    assert callable(append_backward) and callable(gradients)
    assert Parameter is pt.Parameter
    assert in_dygraph_mode() in (True, False)
    assert fluid.CUDAPinnedPlace().device_type == "cpu"
    assert fluid.cuda_places() == jfluid.cuda_places() == []
    assert len(fluid.cpu_places()) == 1
    assert fluid.is_compiled_with_cuda() in (True, False)
    assert fluid.ParamAttr is pt.ParamAttr
    assert fluid.initializer.Constant is pt.nn.initializer.Constant


def test_no_grad_decorator_and_context():
    @fluid.dygraph.no_grad
    def eval_fn(t):
        return t * 2

    x = torch.ones(2, requires_grad=True)
    assert not eval_fn(x).requires_grad
    with fluid.dygraph.no_grad():
        assert not (x * 2).requires_grad
    assert (x * 2).requires_grad


@pytest.mark.parametrize("module", ["fluid", "fluid.backward",
                                    "fluid.dygraph", "fluid.framework",
                                    "fluid.io", "fluid.layers"])
def test_every_public_name_of_the_jax_module_exists(module):
    """The JAX ``fluid`` modules (only ``fluid.io`` has an ``__all__``)
    against the port's, name by name: every public name the JAX module
    binds resolves in the port's (``fluid.layers`` through its
    fall-through too)."""
    import importlib
    ref = importlib.import_module(f"paddle_tpu.{module}")
    port = importlib.import_module(f"paddle_tpu_torch.{module}")
    names = [n for n in vars(ref) if not n.startswith("_")
             and n != "annotations"]
    assert names
    missing = [n for n in names if not hasattr(port, n)]
    assert missing == []
