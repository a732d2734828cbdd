"""``static`` (Program, Executor, InputSpec) and the static-mode ``Model``
in the port against the JAX package, on the CPU.

The JAX suite's program semantics (``tests/test_static_program.py``,
``tests/test_hapi_static.py``) in the port: a dynamic batch through one
recorded program, fetch by variable and by name, an unknown fetch and a
missing feed raising, an unused feed omitted, ``clone(for_test=True)``
dropping the optimizer. Against the JAX package, from the same weights
(``convert.layer_from_jax``) and the same numpy feeds: a fit-a-line
program's losses over 3 ``minimize`` steps (SGD and Adam), the gradients
``append_backward`` makes fetchable, and ``Model.fit`` / ``train_batch``
/ ``predict_batch`` of LeNet under ``enable_static()`` (Adam, the
optimizer of ``bench.py``'s ``bench_lenet``): losses and gradients
within 1e-5 of the largest value (float32, the same operations in
another order), weights and outputs after Adam steps within 1e-4
(``TRAINED_TOL``: Adam divides by the root of the second moment, so a
gradient entry near zero carries rounding noise into a step of about
the learning rate). The
recording follows ``torch.Tensor``'s own operators and methods (``x *
2.0``, ``w.t()``), which do not pass through ``call_op``, and leaves a
layer's initialisation out of the program.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.vision.models import LeNet as JLeNet
import paddle_tpu_torch as pt
from paddle_tpu_torch import static
from paddle_tpu_torch.convert import layer_from_jax
from paddle_tpu_torch.framework import static_capture
from paddle_tpu_torch.static import InputSpec
from paddle_tpu_torch.vision.models import LeNet

TOL = 1e-5
TRAINED_TOL = 1e-4


@pytest.fixture(autouse=True)
def cpu_default():
    old = pt.get_device()
    pt.set_device("cpu")
    yield
    pt.set_device(old)
    pt.disable_static()


@pytest.fixture
def both_static():
    paddle.enable_static()
    pt.enable_static()
    try:
        yield
    finally:
        paddle.disable_static()
        pt.disable_static()


def _close(got, want, tol=TOL):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * max(np.abs(want).max(), 1e-30))


def test_dynamic_batch_size(both_static):
    main = static.Program()
    with static.program_guard(main):
        x = static.data(name="x", shape=[None, 4], dtype="float32")
        out = pt.mean(x * 2.0)
    exe = static.Executor()
    for n in (3, 7):
        arr = np.full((n, 4), 1.5, "float32")
        (val,) = exe.run(main, feed={"x": arr}, fetch_list=[out])
        np.testing.assert_allclose(val, 3.0, rtol=1e-6)


def test_fetch_by_name_and_var(both_static):
    main = static.Program()
    with static.program_guard(main):
        x = static.data(name="x", shape=[None, 2], dtype="float32")
        y = x + 1.0
    exe = static.Executor()
    arr = np.zeros((2, 2), "float32")
    by_var, by_name = exe.run(main, feed={"x": arr}, fetch_list=[y, "x"])
    np.testing.assert_allclose(by_var, 1.0)
    np.testing.assert_allclose(by_name, 0.0)
    with pytest.raises(KeyError):
        exe.run(main, feed={"x": arr}, fetch_list=["nope"])


def test_missing_feed_raises_and_unused_feed_may_be_omitted(both_static):
    main = static.Program()
    with static.program_guard(main):
        x = static.data(name="x", shape=[None, 2], dtype="float32")
        static.data(name="y", shape=[None, 1], dtype="float32")
        pred = x * 3.0
    exe = static.Executor()
    with pytest.raises(ValueError, match="missing"):
        exe.run(main, feed={}, fetch_list=[pred])
    (val,) = exe.run(main, feed={"x": np.ones((2, 2), "float32")},
                     fetch_list=[pred])
    np.testing.assert_allclose(val, 3.0)


def _line_pair():
    paddle.seed(3)
    jfc = paddle.nn.Linear(13, 1)
    tfc = pt.nn.Linear(13, 1)
    layer_from_jax(tfc, jfc.state_dict())
    return jfc, tfc


def _line_data():
    rng = np.random.RandomState(0)
    w = rng.randn(13, 1).astype("float32")
    x = rng.randn(64, 13).astype("float32")
    return x, x @ w + 0.1 * rng.randn(64, 1).astype("float32")


def _fit_a_line(pkg, fc, opt_cls, steps=3):
    main = pkg.static.Program()
    with pkg.static.program_guard(main, pkg.static.Program()):
        x = pkg.static.data(name="x", shape=[None, 13], dtype="float32")
        y = pkg.static.data(name="y", shape=[None, 1], dtype="float32")
        cost = pkg.nn.functional.square_error_cost(fc(x), y)
        avg = pkg.mean(cost)
        opt_cls(pkg)(learning_rate=0.01,
                     parameters=fc.parameters()).minimize(avg)
    exe = pkg.static.Executor()
    xs, ys = _line_data()
    return [float(np.asarray(exe.run(main, feed={"x": xs, "y": ys},
                                     fetch_list=[avg])[0]))
            for _ in range(steps)]


@pytest.mark.parametrize("opt", ["SGD", "Adam"])
def test_minimize_losses_match_jax(both_static, opt):
    jfc, tfc = _line_pair()
    want = _fit_a_line(paddle, jfc, lambda p: getattr(p.optimizer, opt))
    got = _fit_a_line(pt, tfc, lambda p: getattr(p.optimizer, opt))
    _close(got, want)
    assert got[-1] < got[0]
    _close(tfc.weight.detach().numpy().T, jfc.weight.numpy())


def test_append_backward_grads_match_jax(both_static):
    jfc, tfc = _line_pair()
    xs, _ = _line_data()
    vals = {}
    for key, pkg, fc in (("j", paddle, jfc), ("t", pt, tfc)):
        main = pkg.static.Program()
        with pkg.static.program_guard(main):
            x = pkg.static.data(name="x", shape=[None, 13], dtype="float32")
            loss = pkg.mean(fc(x) ** 2)
            grads = pkg.static.append_backward(loss)
        out = pkg.static.Executor().run(main, feed={"x": xs},
                                        fetch_list=[g for _, g in grads])
        vals[key] = sorted(out, key=lambda a: a.size)
    (jb, jw), (tb, tw) = vals["j"], vals["t"]
    _close(tb, jb)
    _close(tw.T, jw)
    assert static.default_main_program().num_blocks == 1


def test_clone_for_test_drops_the_optimizer(both_static):
    _, fc = _line_pair()
    main = static.Program()
    with static.program_guard(main):
        x = static.data(name="x", shape=[None, 13], dtype="float32")
        loss = pt.mean(fc(x) ** 2)
        pt.optimizer.SGD(learning_rate=0.01,
                         parameters=fc.parameters()).minimize(loss)
    test_prog = main.clone(for_test=True)
    exe = static.Executor()
    xs = np.ones((2, 13), "float32")
    (l0,) = exe.run(test_prog, feed={"x": xs}, fetch_list=[loss])
    (l1,) = exe.run(test_prog, feed={"x": xs}, fetch_list=[loss])
    np.testing.assert_allclose(l0, l1)
    (t0,) = exe.run(main, feed={"x": xs}, fetch_list=[loss])
    (t1,) = exe.run(main, feed={"x": xs}, fetch_list=[loss])
    assert float(t1) < float(t0)


def test_initialisation_and_eager_data_stay_out_of_the_program(both_static):
    main = static.Program()
    with static.program_guard(main):
        x = static.data(name="x", shape=[None, 4], dtype="float32")
        fc = pt.nn.Linear(4, 2)            # initialised inside the guard
        out = fc(x)
        torch.ones(3) * 2.0                # touches nothing recorded
    ops = [n.op for n in main._nodes]
    assert ops == ["t", "linear"], ops
    w0 = fc.weight.detach().clone()
    (val,) = static.Executor().run(main, feed={"x": np.ones((1, 4),
                                                            "float32")},
                                   fetch_list=[out])
    torch.testing.assert_close(fc.weight.detach(), w0)
    np.testing.assert_allclose(val, (fc(torch.ones(1, 4))).detach().numpy(),
                               rtol=1e-6)


def test_mode_flags():
    assert pt.in_dynamic_mode()
    pt.enable_static()
    assert not pt.in_dynamic_mode()
    assert static_capture.current is static.default_main_program()
    pt.disable_static()
    assert pt.in_dynamic_mode()
    assert static_capture.current is None
    assert static_capture._recorder is None


def _lenet_pair(seed=0):
    paddle.seed(seed)
    jnet = JLeNet()
    tnet = LeNet()
    layer_from_jax(tnet, jnet.state_dict())
    return jnet, tnet


def _lenet_data(n, seed=4):
    rs = np.random.RandomState(seed)
    return (rs.randn(n, 1, 28, 28).astype("float32"),
            rs.randint(0, 10, (n, 1)).astype("int64"))


def _lenet_model(pkg, net, **kw):
    model = pkg.Model(net, inputs=[pkg.static.InputSpec(
        [None, 1, 28, 28], "float32", "image")],
        labels=[pkg.static.InputSpec([None, 1], "int64", "label")], **kw)
    model.prepare(pkg.optimizer.Adam(learning_rate=1e-3,
                                     parameters=net.parameters()),
                  pkg.nn.CrossEntropyLoss())
    return model


class _DS(paddle.io.Dataset):
    def __init__(self, x, y):
        self.x, self.y = x, y

    def __len__(self):
        return len(self.x)

    def __getitem__(self, i):
        return self.x[i], self.y[i]


def test_static_lenet_train_batch_and_predict_match_jax(both_static):
    jnet, tnet = _lenet_pair()
    jm = _lenet_model(paddle, jnet)
    tm = _lenet_model(pt, tnet, device="cpu")
    x, y = _lenet_data(24)
    for i in range(3):
        xb, yb = x[8 * i:8 * i + 8], y[8 * i:8 * i + 8]
        want = jm.train_batch([xb], [yb])
        got = tm.train_batch([torch.from_numpy(xb)], [torch.from_numpy(yb)])
        _close(got, want)
    (want,) = jm.predict_batch([x[:5]])
    (got,) = tm.predict_batch([torch.from_numpy(x[:5])])
    _close(got, want, TRAINED_TOL)


def test_static_lenet_fit_matches_jax(both_static):
    jnet, tnet = _lenet_pair(1)
    x, y = _lenet_data(64, seed=5)
    jm, tm = _lenet_model(paddle, jnet), _lenet_model(pt, tnet,
                                                     device="cpu")
    jm.fit(_DS(x, y), batch_size=16, epochs=1, shuffle=False, verbose=0)
    tm.fit(pt.io.TensorDataset([x, y]), batch_size=16, epochs=1,
           shuffle=False, verbose=0)
    for k, v in jnet.state_dict().items():
        got = tnet.state_dict()[k].detach().numpy()
        _close(got.T if got.ndim == 2 else got, v.numpy(), TRAINED_TOL)
    want = jm.evaluate(_DS(x, y), batch_size=32, verbose=0)["loss"]
    got = tm.evaluate(pt.io.TensorDataset([x, y]), batch_size=32,
                      verbose=0)["loss"]
    _close([got], [want], TRAINED_TOL)
    # the static Model's two captures record the ops, nothing eager
    ops = {n.op for n in tm._static_adapter._main._nodes}
    assert {"conv2d", "max_pool2d", "linear", "cross_entropy"} <= ops, ops


def test_static_model_requires_input_specs(both_static):
    net = pt.nn.Linear(4, 2)
    model = pt.Model(net, device="cpu")
    model.prepare(pt.optimizer.SGD(learning_rate=0.1,
                                   parameters=net.parameters()),
                  pt.nn.CrossEntropyLoss())
    with pytest.raises(ValueError, match="InputSpec"):
        model.train_batch([torch.zeros(2, 4)], [torch.zeros(2, 1).long()])


def test_static_train_batch_without_labels_raises(both_static):
    _, tnet = _lenet_pair()
    model = _lenet_model(pt, tnet, device="cpu")
    x, _ = _lenet_data(4)
    with pytest.raises(ValueError, match="labels"):
        model.train_batch([torch.from_numpy(x)])


def test_data_loader_takes_the_static_arguments():
    x, y = _lenet_data(6)
    ds = pt.io.TensorDataset([x, y])
    plain = [tuple(t.numpy() for t in b)
             for b in pt.io.DataLoader(ds, batch_size=4)]
    spec = InputSpec([None, 1, 28, 28], "float32", "image")
    static_args = [tuple(t.numpy() for t in b) for b in pt.io.DataLoader(
        ds, feed_list=[spec], places=[pt.CPUPlace()], return_list=False,
        batch_size=4)]
    assert len(plain) == len(static_args) == 2
    for a, b in zip(plain, static_args):
        for u, v in zip(a, b):
            np.testing.assert_array_equal(u, v)
