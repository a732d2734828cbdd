"""The legacy ``static`` surface in the port against the JAX package, on
the CPU: ``static/extras.py`` (program state files, serialization,
``gradients``, ``py_func``, the metric expressions, ``Print``, EMA, the
facades, the places), ``static.nn``'s control flow and its layer
builders (``fc`` and ``layers_compat.py``), and static-mode
``minimize(parameters=, no_grad_set=)`` / ``train_batch(update=False)``.

The JAX cases of ``tests/test_static_extras.py``,
``tests/test_static_nn_layers.py`` and the control-flow cases of
``tests/test_rnn_distribution_controlflow.py``, run in both packages on
the same numpy inputs, the parameters carried across
(``convert.program_from_jax``): forward values within rtol 1e-5 / atol
1e-6 (float32), losses after a few ``Executor.run`` steps within 1e-4.
Exact: the arrays of ``.pdparams``/``.pdopt`` files and of
``serialize_persistables`` bytes that one package writes and the other
reads, ``switch_case``'s fallback, the layer cache (fresh parameters
unnamed, shared with ``name=``) and ``cuda_places()`` (``[]`` without a
card, the JAX package's answer).

Where the reference means something other than what the JAX package
does, the port is held to the reference: a static ``minimize(
parameters=, no_grad_set=)`` steps only that subset (the JAX package
steps every parameter), and a static ``train_batch(update=False)``
accumulates the gradients for a later step (the JAX package steps at
once).
"""
import pickle

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import static as jstatic
import paddle_tpu_torch as pt
from paddle_tpu_torch import static
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


def _fc_programs(names=None, size=3):
    """``x [None, 4] -> fc(size)`` in both packages; ``names`` gives the
    weight and bias ``ParamAttr`` names, else the parameters are carried
    by position."""
    progs = []
    for pkg, st in ((paddle, jstatic), (pt, static)):
        main, startup = st.Program(), st.Program()
        with st.program_guard(main, startup):
            x = st.data(name="x", shape=[None, 4], dtype="float32")
            kw = {} if names is None else dict(
                weight_attr=pkg.ParamAttr(name=names[0]),
                bias_attr=pkg.ParamAttr(name=names[1]))
            y = st.nn.fc(x, size=size, **kw)
        progs.append((main, x, y))
    (jmain, _, _), (tmain, _, _) = progs
    if names is not None:   # named alike: carried by name
        assert list(tmain._params) == list(jmain._params) == list(names)
    program_from_jax(tmain, _jax_params(jmain))
    return progs


XS = np.random.RandomState(0).randn(3, 4).astype("float32")


# -- program state files ------------------------------------------------------

def test_fc_program_matches_and_is_keyed_by_param_attr_names(both_static):
    (jm, _, jy), (tm, _, ty) = _fc_programs(("fc_w", "fc_b"))
    (want,) = jstatic.Executor().run(jm, feed={"x": XS}, fetch_list=[jy])
    (got,) = static.Executor().run(tm, feed={"x": XS}, fetch_list=[ty])
    _close(got, want)
    # the weight is stored [out, in] and held [in, out] in the files
    assert tuple(tm._params["fc_w"].shape) == (3, 4)
    np.testing.assert_array_equal(program_to_numpy(tm)["fc_w"],
                                  _jax_params(jm)["fc_w"])


def test_pdparams_cross_both_ways_bit_equal(both_static, tmp_path):
    (jm, _, jy), (tm, _, ty) = _fc_programs(("x_w", "x_b"))
    jstatic.save(jm, str(tmp_path / "jax"))
    # a port program of other values takes the JAX file
    for p in tm._params.values():
        torch.nn.init.normal_(p.data)
    static.load(tm, str(tmp_path / "jax"))
    for n, arr in _jax_params(jm).items():
        np.testing.assert_array_equal(program_to_numpy(tm)[n], arr)
    static.save(tm, str(tmp_path / "port"))
    with open(tmp_path / "jax.pdparams", "rb") as f:
        jfile = pickle.load(f)
    with open(tmp_path / "port.pdparams", "rb") as f:
        tfile = pickle.load(f)
    assert list(jfile) == list(tfile)
    for n in jfile:
        assert tfile[n].dtype == jfile[n].dtype
        np.testing.assert_array_equal(tfile[n], jfile[n])
    # and the JAX package takes the port's file
    import jax.numpy as jnp
    for p in jm._params.values():
        p._data = jnp.zeros_like(p._data)
    jstatic.load(jm, str(tmp_path / "port"))
    (want,) = jstatic.Executor().run(jm, feed={"x": XS}, fetch_list=[jy])
    (got,) = static.Executor().run(tm, feed={"x": XS}, fetch_list=[ty])
    _close(got, want)
    state = static.load_program_state(str(tmp_path / "jax"))
    assert set(state) == {"x_w", "x_b"}
    np.testing.assert_array_equal(state["x_w"], jfile["x_w"])


def _adam_programs(names):
    progs = []
    for pkg, st in ((paddle, jstatic), (pt, static)):
        main = st.Program()
        with st.program_guard(main):
            x = st.data(name="x", shape=[None, 4], dtype="float32")
            y = st.nn.fc(x, size=2,
                         weight_attr=pkg.ParamAttr(name=names[0]),
                         bias_attr=pkg.ParamAttr(name=names[1]))
            loss = pkg.mean(y * y)
            pkg.optimizer.Adam(learning_rate=0.1).minimize(loss)
        progs.append((main, loss))
    program_from_jax(progs[1][0], _jax_params(progs[0][0]))
    return progs


def test_pdopt_crosses_both_ways_bit_equal(both_static, tmp_path):
    (jm, jl), (tm, tl) = _adam_programs(("o_w", "o_b"))
    for _ in range(2):
        (a,) = jstatic.Executor().run(jm, feed={"x": XS}, fetch_list=[jl])
        (b,) = static.Executor().run(tm, feed={"x": XS}, fetch_list=[tl])
        _close(b, a, rtol=TRAINED_TOL, atol=TRAINED_TOL)
    jstatic.save(jm, str(tmp_path / "jax"))
    static.load(tm, str(tmp_path / "jax"))
    static.save(tm, str(tmp_path / "port"))
    with open(tmp_path / "jax.pdopt", "rb") as f:
        jopt = pickle.load(f)
    with open(tmp_path / "port.pdopt", "rb") as f:
        topt = pickle.load(f)
    assert int(topt["step"]) == int(jopt["step"]) == 2
    assert set(topt["slots"]) == set(jopt["slots"]) == {"o_w", "o_b"}
    for n, slots in jopt["slots"].items():
        assert set(topt["slots"][n]) == set(slots)
        for s, arr in slots.items():
            np.testing.assert_array_equal(topt["slots"][n][s],
                                          np.asarray(arr))
    # the JAX package reads the port's .pdopt into its optimizer state
    jstatic.load(jm, str(tmp_path / "port"))
    for n, slots in topt["slots"].items():
        for s, arr in slots.items():
            np.testing.assert_array_equal(
                np.asarray(jm._opt_state["slots"][n][s].numpy()), arr)


def test_serialize_persistables_cross_both_ways(both_static):
    (jm, jx, jy), (tm, tx, ty) = _fc_programs(("s_w", "s_b"))
    jblob = jstatic.serialize_persistables([jx], [jy], jm)
    tblob = static.serialize_persistables([tx], [ty], tm)
    jstate, tstate = pickle.loads(jblob), pickle.loads(tblob)
    assert list(jstate) == list(tstate)
    for n in jstate:
        np.testing.assert_array_equal(tstate[n], jstate[n])
    for p in tm._params.values():
        p.data.zero_()
    static.deserialize_persistables(tm, jblob)
    for n, arr in jstate.items():
        np.testing.assert_array_equal(program_to_numpy(tm)[n], arr)
    import jax.numpy as jnp
    for p in jm._params.values():
        p._data = jnp.zeros_like(p._data)
    jstatic.deserialize_persistables(jm, tblob)
    for n, arr in _jax_params(jm).items():
        np.testing.assert_array_equal(arr, tstate[n])


def test_set_program_state_names_the_missing(both_static):
    (_, _, _), (tm, _, _) = _fc_programs()
    with pytest.raises(ValueError, match="missing"):
        static.set_program_state(tm, {})


def test_serialize_program_roundtrip():
    net = pt.nn.Linear(4, 2)
    spec = static.InputSpec([None, 4], "float32")
    blob = static.serialize_program([spec], net)
    runner = static.deserialize_program(blob)
    xs = np.random.RandomState(1).randn(2, 4).astype("float32")
    net.eval()
    _close(runner(torch.from_numpy(xs)).numpy(),
           net(torch.from_numpy(xs)).detach().numpy())


# -- metric expressions, py_func, facades -------------------------------------

def test_accuracy_and_auc_match_jax(both_static):
    rng = np.random.RandomState(0)
    probs = rng.rand(64).astype("float32")
    labels = (probs + 0.3 * rng.randn(64) > 0.5).astype("int64")
    inp = np.stack([1 - probs, probs], axis=1)
    lg = rng.randn(16, 3).astype("float32")
    lb = rng.randint(0, 3, (16, 1)).astype("int64")
    feed = {"p": inp, "lb": labels.reshape(-1, 1), "lg": lg, "lb3": lb}
    out = []
    for st in (jstatic, static):
        main = st.Program()
        with st.program_guard(main):
            p = st.data(name="p", shape=[None, 2], dtype="float32")
            lab = st.data(name="lb", shape=[None, 1], dtype="int64")
            logits = st.data(name="lg", shape=[None, 3], dtype="float32")
            lab3 = st.data(name="lb3", shape=[None, 1], dtype="int64")
            fetches = [st.auc(p, lab), st.accuracy(logits, lab3, k=1),
                       st.accuracy(logits, lab3, k=2)]
        out.append(st.Executor().run(main, feed=feed, fetch_list=fetches))
    for got, want in zip(out[1], out[0]):
        _close(got, want)


def test_py_func_follows_the_feed_batch_and_matches_jax(both_static):
    out = []
    for pkg, st in ((paddle, jstatic), (pt, static)):
        main = st.Program()
        with st.program_guard(main):
            x = st.data(name="x", shape=[None, 3], dtype="float32")
            template = pkg.to_tensor(np.zeros((2, 3), "float32"))
            y = st.py_func(lambda a: np.tanh(a) * 3.0, x, template)
            z = y + 1.0
        exe = st.Executor()
        out.append([exe.run(main, feed={"x": np.full((n, 3), 0.5, "float32")},
                            fetch_list=[z])[0] for n in (2, 5)])
    for got, want in zip(out[1], out[0]):
        _close(got, want)
    assert out[1][1].shape == (5, 3)
    with pytest.raises(NotImplementedError, match="backward_func"):
        static.py_func(lambda a: a, torch.zeros(2, 3), torch.zeros(2, 3),
                       backward_func=lambda g: g)


def test_compiled_program_and_parallel_executor(both_static):
    (_, _, _), (tm, _, ty) = _fc_programs()
    exe = static.Executor()
    compiled = static.CompiledProgram(tm).with_data_parallel()
    (via_compiled,) = exe.run(compiled, feed={"x": XS}, fetch_list=[ty])
    pe = static.ParallelExecutor(main_program=tm)
    (via_pe,) = pe.run(fetch_list=[ty], feed={"x": XS})
    (plain,) = exe.run(tm, feed={"x": XS}, fetch_list=[ty])
    np.testing.assert_array_equal(via_compiled, plain)
    np.testing.assert_array_equal(via_pe, plain)
    many = [pt.CPUPlace()] * 2
    with pytest.raises(NotImplementedError, match="Queue 1 item 4"):
        static.CompiledProgram(tm).with_data_parallel(places=many)
    bs = static.BuildStrategy()
    bs.fuse_all_reduce_ops = True
    assert bs.fuse_all_reduce_ops is True and bs.unknown is None


def test_scope_finds_program_params(both_static):
    (_, _, _), (tm, _, _) = _fc_programs(("sc_w", "sc_b"))
    scope = static.Scope()
    scope.set("custom", np.arange(3.0))
    np.testing.assert_allclose(scope.find_var("custom").get_tensor(),
                               [0.0, 1.0, 2.0])
    with static.program_guard(tm):
        np.testing.assert_array_equal(
            scope.find_var("sc_b").get_tensor(),
            tm._params["sc_b"].detach().numpy())
        assert scope.find_var("nope") is None
    with static.scope_guard(scope):
        assert static.global_scope() is scope
    assert static.global_scope() is not scope


def test_ema_matches_jax_and_restores_bit_equal(both_static):
    import jax.numpy as jnp
    vals = [np.ones(3, "float32"), np.full(3, 3.0, "float32"),
            np.array([0.5, -2.0, 7.0], "float32")]
    shadows = []
    for st in (jstatic, static):
        main = st.Program()
        with st.program_guard(main):
            p = st.create_parameter([3], "float32", name="ema_p")
            ema = st.ExponentialMovingAverage(decay=0.7)
        for v in vals:
            if st is jstatic:
                p._data = jnp.asarray(v)
            else:
                p.data.copy_(torch.from_numpy(v))
            with st.program_guard(main):
                ema.update()
        with st.program_guard(main):
            before = _np(p).copy()
            with ema.apply():
                shadows.append(_np(p).copy())
            np.testing.assert_array_equal(_np(p), before)
    _close(shadows[1], shadows[0])


def test_ema_binds_the_program_it_was_built_in(both_static):
    main = static.Program()
    with static.program_guard(main):
        p = static.create_parameter([2], "float32", name="ema_bound")
        ema = static.ExponentialMovingAverage(decay=0.5)
    p.data.fill_(1.0)
    ema.update()                        # outside the guard: still main's
    p.data.fill_(3.0)
    ema.update()
    with ema.apply():
        np.testing.assert_array_equal(p.detach().numpy(), [2.0, 2.0])
    np.testing.assert_array_equal(p.detach().numpy(), [3.0, 3.0])


def test_variable_alias_and_places():
    t = pt.to_tensor(np.zeros(2, "float32"))
    assert isinstance(t, static.Variable)
    assert not isinstance(np.zeros(2), static.Variable)
    assert static.cuda_places() == jstatic.cuda_places() == []
    assert static.npu_places() == static.xpu_places() == []
    assert static.mlu_places() == []


def test_ipu_family_and_ctr_bundle_raise_as_the_jax_package():
    for name in ("IpuStrategy", "IpuCompiledProgram", "ipu_shard_guard",
                 "set_ipu_shard"):
        with pytest.raises(RuntimeError, match="IPU"):
            getattr(static, name)()
        with pytest.raises(RuntimeError, match="IPU"):
            getattr(jstatic, name)()
    with pytest.raises(NotImplementedError, match="PS/CTR"):
        static.ctr_metric_bundle(None, None)


def test_gradients_match_jax_and_sum_targets(both_static):
    xs = np.random.RandomState(3).randn(4, 2).astype("float32")
    w0 = np.random.RandomState(4).randn(2, 1).astype("float32")
    out = []
    for pkg, st in ((paddle, jstatic), (pt, static)):
        main = st.Program()
        with st.program_guard(main):
            x = st.data(name="x", shape=[None, 2], dtype="float32")
            w = st.create_parameter([2, 1], "float32", name="g_w")
            a = pkg.mean(pkg.matmul(x, w) ** 2)
            b = pkg.mean(pkg.matmul(x, w)) * 2.0
            (g1,) = st.gradients(a, [w])
            (g2,) = st.gradients([a, b], [w])
        if st is static:
            program_from_jax(main, {"g_w": w0})
        else:
            import jax.numpy as jnp
            w._data = jnp.asarray(w0)
        out.append(st.Executor().run(main, feed={"x": xs},
                                     fetch_list=[g1, g2]))
        with pytest.raises(NotImplementedError, match="Parameters"):
            with st.program_guard(main):
                st.gradients(a, [x])
    for got, want in zip(out[1], out[0]):
        _close(got, want)


def test_print_is_identity_and_passes_the_gradient(capsys):
    x = torch.arange(3.0, requires_grad=True)
    out = static.Print(x, message="dbg")
    assert "dbg" in capsys.readouterr().out
    np.testing.assert_array_equal(out.detach().numpy(), [0.0, 1.0, 2.0])
    (out * 2.0).sum().backward()
    np.testing.assert_array_equal(x.grad.numpy(), [2.0, 2.0, 2.0])


def test_print_records_and_prints_at_each_run(both_static, capsys):
    main = static.Program()
    with static.program_guard(main):
        x = static.data(name="x", shape=[None, 2], dtype="float32")
        y = static.Print(x * 2.0, message="replayed")
    capsys.readouterr()
    (val,) = static.Executor().run(main, feed={"x": np.ones((1, 2),
                                                            "float32")},
                                   fetch_list=[y])
    assert "replayed" in capsys.readouterr().out
    np.testing.assert_array_equal(val, [[2.0, 2.0]])


def test_exponential_decay_and_global_var(both_static):
    for st in (jstatic, static):
        lr = st.exponential_decay(0.1, 10, 0.5)
        lrs = st.exponential_decay(0.1, 10, 0.5, staircase=True)
        assert type(lr).__name__ == "ExponentialDecay"
        assert type(lrs).__name__ == "StepDecay"
    main = static.Program()
    with static.program_guard(main):
        x = static.data(name="x", shape=[None, 2], dtype="float32")
        g = static.create_global_var([2], 3.0, "float32", name="gv")
        y = x * g
    exe = static.Executor()
    (val, gv) = exe.run(main, feed={"x": np.ones((2, 2), "float32")},
                        fetch_list=[y, "gv"])
    np.testing.assert_array_equal(val, np.full((2, 2), 3.0))
    np.testing.assert_array_equal(gv, [3.0, 3.0])
    g.fill_(5.0)                        # read live at the next run
    (val,) = exe.run(main, feed={"x": np.ones((2, 2), "float32")},
                     fetch_list=[y])
    np.testing.assert_array_equal(val, np.full((2, 2), 5.0))


def test_normalize_program_drops_the_optimizer(both_static):
    (_, _), (tm, _) = _adam_programs(("n_w", "n_b"))
    norm = static.normalize_program(tm, [], [])
    assert norm._optimizer is None and norm._nodes == tm._nodes


# -- static minimize(parameters=, no_grad_set=), train_batch(update=False) ----

def test_static_minimize_steps_only_the_chosen_subset(both_static):
    """The reference steps only ``parameters`` less ``no_grad_set``; the
    JAX package steps every parameter: the frozen ones keep their bits
    (and get no gradient), the rest move."""
    progs = []
    for pkg, st in ((paddle, jstatic), (pt, static)):
        main = st.Program()
        with st.program_guard(main):
            x = st.data(name="x", shape=[None, 4], dtype="float32")
            h = st.nn.fc(x, size=5,
                         weight_attr=pkg.ParamAttr(name="m_w1"),
                         bias_attr=pkg.ParamAttr(name="m_b1"))
            y = st.nn.fc(h, size=2,
                         weight_attr=pkg.ParamAttr(name="m_w2"),
                         bias_attr=pkg.ParamAttr(name="m_b2"))
            loss = pkg.mean(y * y)
            opt = pkg.optimizer.Adam(learning_rate=0.05)
            if st is static:
                frozen = [main._params["m_w1"], "m_b1"]
                opt.minimize(loss, no_grad_set=frozen)
            else:
                opt.minimize(loss)
        progs.append((main, loss))
    (jm, jl), (tm, tl) = progs
    program_from_jax(tm, _jax_params(jm))
    before = program_to_numpy(tm)
    for _ in range(3):
        (a,) = jstatic.Executor().run(jm, feed={"x": XS}, fetch_list=[jl])
        static.Executor().run(tm, feed={"x": XS}, fetch_list=[tl])
    after, jafter = program_to_numpy(tm), _jax_params(jm)
    assert [n for n, _ in tm._opt_chosen] == ["m_w2", "m_b2"]
    for n in ("m_w1", "m_b1"):
        np.testing.assert_array_equal(after[n], before[n])
        assert tm._params[n].grad is None
        assert not np.allclose(jafter[n], before[n])   # JAX: all stepped
    for n in ("m_w2", "m_b2"):
        assert not np.allclose(after[n], before[n])


def test_static_minimize_subset_first_step_matches_jax(both_static):
    progs = []
    for pkg, st in ((paddle, jstatic), (pt, static)):
        main = st.Program()
        with st.program_guard(main):
            x = st.data(name="x", shape=[None, 4], dtype="float32")
            y = st.nn.fc(x, size=2,
                         weight_attr=pkg.ParamAttr(name="f_w"),
                         bias_attr=pkg.ParamAttr(name="f_b"))
            loss = pkg.mean(y * y)
            opt = pkg.optimizer.SGD(learning_rate=0.1)
            if st is static:
                opt.minimize(loss, parameters=[main._params["f_w"]])
            else:
                opt.minimize(loss)
        progs.append((main, loss))
    (jm, jl), (tm, tl) = progs
    program_from_jax(tm, _jax_params(jm))
    before = program_to_numpy(tm)
    jstatic.Executor().run(jm, feed={"x": XS}, fetch_list=[jl])
    static.Executor().run(tm, feed={"x": XS}, fetch_list=[tl])
    after = program_to_numpy(tm)
    _close(after["f_w"], _jax_params(jm)["f_w"])
    np.testing.assert_array_equal(after["f_b"], before["f_b"])


def test_static_train_batch_without_update_accumulates():
    """``train_batch(update=False)`` twice, then ``update=True``: one SGD
    step on the summed gradients of the three batches (the reference's
    meaning; the JAX package's static adapter steps at every call). The
    gradients come from the JAX package's eager autograd."""
    from paddle_tpu_torch.hapi import Model
    rng = np.random.RandomState(7)
    batches = [(rng.randn(4, 3).astype("float32"),
                rng.randn(4, 1).astype("float32")) for _ in range(3)]
    paddle.seed(2)
    jnet = paddle.nn.Linear(3, 1)
    w0, b0 = np.asarray(jnet.weight.numpy()), np.asarray(jnet.bias.numpy())
    gw, gb = np.zeros_like(w0), np.zeros_like(b0)
    for x, y in batches:
        loss = paddle.nn.functional.mse_loss(jnet(paddle.to_tensor(x)),
                                             paddle.to_tensor(y))
        loss.backward()
        gw += np.asarray(jnet.weight.grad.numpy())
        gb += np.asarray(jnet.bias.grad.numpy())
        jnet.clear_gradients()
    net = pt.nn.Linear(3, 1)
    from paddle_tpu_torch.convert import layer_from_jax
    layer_from_jax(net, {"weight": w0, "bias": b0})
    pt.enable_static()
    model = Model(net, inputs=[static.InputSpec([None, 3], "float32", "x")],
                  labels=[static.InputSpec([None, 1], "float32", "y")],
                  device="cpu")
    model.prepare(pt.optimizer.SGD(learning_rate=0.1,
                                   parameters=net.parameters()),
                  pt.nn.MSELoss())
    for i, (x, y) in enumerate(batches):
        model.train_batch([x], [y], update=i == 2)
        if i < 2:
            np.testing.assert_array_equal(net.bias.detach().numpy(), b0)
    _close(net.weight.detach().numpy().T, w0 - 0.1 * gw)
    _close(net.bias.detach().numpy(), b0 - 0.1 * gb)
    assert net.weight.grad is None


# -- static.nn control flow ---------------------------------------------------

def test_control_flow_eager_matches_jax():
    from paddle_tpu.static.nn import (case as jcase, cond as jcond,
                                      switch_case as jswitch,
                                      while_loop as jwhile)
    from paddle_tpu_torch.static.nn import case, cond, switch_case, \
        while_loop
    for v in (3.0, 7.0):
        jx = paddle.to_tensor(np.array(v, np.float32))
        tx = torch.tensor(v)
        assert float(cond(tx > 5, lambda: tx * 2, lambda: tx - 1)) == \
            float(jcond(jx > 5, lambda: jx * 2, lambda: jx - 1))
    i, s = while_loop(lambda i, s: i < 5,
                      lambda i, s: [i + 1, s + i.float() + 1.0],
                      [torch.tensor(0), torch.tensor(0.0)])
    ji, js = jwhile(lambda i, s: i < 5,
                    lambda i, s: [i + 1, s + paddle.cast(i, "float32")
                                  + 1.0],
                    [paddle.to_tensor(np.array(0, np.int64)),
                     paddle.to_tensor(np.array(0.0, np.float32))])
    assert (int(i), float(s)) == (int(ji), float(js)) == (5, 15.0)
    (single,) = while_loop(lambda v: v < 10, lambda v: v * 2,
                           [torch.tensor(1)])
    assert int(single) == 16
    fns = {1: lambda: torch.tensor(10.0), 2: lambda: torch.tensor(20.0)}
    jfns = {1: lambda: paddle.to_tensor(10.0),
            2: lambda: paddle.to_tensor(20.0)}
    for idx, dflt in ((2, True), (9, True), (9, False), (1, False)):
        got = switch_case(torch.tensor(idx), fns,
                          default=(lambda: torch.tensor(-1.0))
                          if dflt else None)
        want = jswitch(paddle.to_tensor(np.array(idx, np.int32)), jfns,
                       default=(lambda: paddle.to_tensor(-1.0))
                       if dflt else None)
        assert float(got) == float(want)
    assert float(switch_case(torch.tensor(9), fns)) == 20.0   # max key
    assert float(switch_case(torch.tensor(7), [
        lambda: torch.tensor(1.0), lambda: torch.tensor(2.0)])) == 2.0
    out = case([(torch.tensor(False), lambda: torch.tensor(1.0)),
                (torch.tensor(True), lambda: torch.tensor(2.0))],
               default=lambda: torch.tensor(3.0))
    jout = jcase([(paddle.to_tensor(False), lambda: paddle.to_tensor(1.0)),
                  (paddle.to_tensor(True), lambda: paddle.to_tensor(2.0))],
                 default=lambda: paddle.to_tensor(3.0))
    assert float(out) == float(jout) == 2.0
    assert float(case([(torch.tensor(False), lambda: torch.tensor(1.0))])) \
        == 1.0
    with pytest.raises(ValueError):
        case([])


def _branchy(x):
    from paddle_tpu_torch.static.nn import cond, switch_case, while_loop
    y = cond(x.sum() > 0, lambda: x * 2.0, lambda: x - 1.0)
    i, acc = while_loop(lambda i, a: i < 3,
                        lambda i, a: [i + 1, a + x],
                        [torch.zeros((), dtype=torch.int64),
                         torch.zeros_like(x)])
    k = (x[:, 0] > 0).sum().to(torch.int64)
    z = switch_case(k, {0: lambda: acc * 0.5, 2: lambda: acc + 100.0})
    return z + y


def _branchy_ref(x):
    y = x * 2.0 if x.sum() > 0 else x - 1.0
    acc = 3.0 * x
    k = int((x[:, 0] > 0).sum())
    return (acc * 0.5 if k == 0 else acc + 100.0) + y


def test_control_flow_under_to_static_exports_and_serves_both_branches(
        tmp_path):
    from paddle_tpu_torch import jit
    pos = np.array([[1.0, 2.0], [3.0, -4.0]], np.float32)
    neg = np.array([[-1.0, -2.0], [-3.0, 0.5]], np.float32)
    one = np.array([[1.0, 2.0], [-3.0, 0.5]], np.float32)
    fn = jit.to_static(_branchy,
                       input_spec=[static.InputSpec([None, 2], "float32")])
    for arr in (pos, neg, one):
        _close(fn(torch.from_numpy(arr)).numpy(), _branchy_ref(arr))
    jit.save(fn, str(tmp_path / "branchy"))
    served = jit.load(str(tmp_path / "branchy"), device="cpu")
    graph = str(served._exported.graph_module.code)
    assert "cond" in graph and "while_loop" in graph
    for arr in (pos, neg, one):
        # the switch's unmatched index (1) runs the max-key branch
        _close(served(arr).numpy(), _branchy_ref(arr))


# -- static.nn layer builders -------------------------------------------------

def test_conv_bn_emb_program_trains_as_jax(both_static):
    rng = np.random.RandomState(0)
    feed = {"x": rng.randn(8, 3, 8, 8).astype("float32"),
            "ids": rng.randint(0, 50, (8, 4)).astype("int64"),
            "y": rng.randint(0, 3, (8, 1)).astype("int64")}
    losses = []
    progs = []
    for pkg, st in ((paddle, jstatic), (pt, static)):
        main, startup = st.Program(), st.Program()
        with st.program_guard(main, startup):
            x = st.data("x", [None, 3, 8, 8], "float32")
            h = st.nn.conv2d(x, 6, 3, padding=1, name="lc_c1")
            h = st.nn.batch_norm(h, act="relu", name="lc_bn1")
            h = st.nn.sequence_reshape(pkg.flatten(h, start_axis=2), 32)
            pooled = st.nn.sequence_pool(h, "max")
            ids = st.data("ids", [None, 4], "int64")
            e = st.nn.embedding(ids, (50, 8), name="lc_emb")
            feat = pkg.concat([pooled, pkg.flatten(e, start_axis=1)],
                              axis=1)
            logits = st.nn.fc(feat, size=3)
            y = st.data("y", [None, 1], "int64")
            loss = pkg.mean(pkg.nn.functional.cross_entropy(logits, y))
            pkg.optimizer.Adam(learning_rate=1e-2).minimize(loss)
        progs.append((main, loss))
    program_from_jax(progs[1][0], _jax_params(progs[0][0]))
    for (main, loss), st in zip(progs, (jstatic, static)):
        exe = st.Executor()
        losses.append([float(exe.run(main, feed=feed,
                                     fetch_list=[loss])[0])
                       for _ in range(4)])
    _close(losses[1], losses[0], rtol=TRAINED_TOL, atol=TRAINED_TOL)
    assert losses[1][-1] < losses[1][0]


def test_layer_cache_fresh_unnamed_shared_named():
    from paddle_tpu.static.nn.layers_compat import \
        fc_compat_registry as jreg
    from paddle_tpu_torch.static.nn.layers_compat import fc_compat_registry
    ids = torch.tensor([[1]])
    a = static.nn.embedding(ids, (10, 4))
    b = static.nn.embedding(ids, (10, 4))
    assert not torch.equal(a, b)
    n_before = len(fc_compat_registry)
    e1 = static.nn.embedding(ids, (10, 4), name="cache_probe_t")
    e2 = static.nn.embedding(ids, (10, 4), name="cache_probe_t")
    assert torch.equal(e1, e2)
    assert len(fc_compat_registry) == n_before + 1
    key = ("embedding", "cache_probe_t", (10, 4), None)
    assert key in fc_compat_registry
    jids = paddle.to_tensor(np.array([[1]], "int64"))
    paddle_tpu_keys = len(jreg)
    paddle.static.nn.embedding(jids, (10, 4), name="cache_probe_t")
    paddle.static.nn.embedding(jids, (10, 4), name="cache_probe_t")
    assert len(jreg) == paddle_tpu_keys + 1 and key in jreg
    x = torch.randn(1, 4, 8, 8)
    outs = [static.nn.conv2d(x, 4, 3, padding=1) for _ in range(2)]
    assert not torch.allclose(outs[0], outs[1])
    o1 = static.nn.conv2d(x, 3, 3, padding=2, dilation=1, name="cd_t")
    o2 = static.nn.conv2d(x, 3, 3, padding=2, dilation=2, name="cd_t")
    assert o1.shape != o2.shape


def _both(fn, *arrays, **kw):
    """``fn(pkg, st, *tensors)`` in both packages on the same arrays."""
    jout = fn(paddle, jstatic, *[paddle.to_tensor(a) for a in arrays], **kw)
    tout = fn(pt, static, *[torch.from_numpy(a) for a in arrays], **kw)
    return jout, tout


def _np(t):
    return np.asarray(t.numpy() if not isinstance(t, torch.Tensor)
                      else t.detach().numpy())


def test_static_rnn_and_sequence_builders_match_jax():
    rng = np.random.RandomState(5)
    xs = rng.randn(2, 5, 4).astype("float32")
    mask = np.ones((2, 5, 1), "float32")
    lengths = np.array([3, 5])

    def rnn(pkg, st, x, m):
        r = st.nn.StaticRNN()
        r.step_input(x)
        r.step_input(m)
        r.memory(shape=(4,), batch_ref=x)
        return r.unroll(lambda xt, mt, h: (h + xt * mt, h + xt * mt))

    j, t = _both(rnn, xs, mask)
    _close(_np(t), _np(j))
    _close(_np(t), np.cumsum(xs, axis=1))
    with pytest.raises(NotImplementedError, match="unroll"):
        static.nn.StaticRNN().step()

    def seqs(pkg, st, x, n):
        out = [st.nn.sequence_first_step(x), st.nn.sequence_last_step(x),
               st.nn.sequence_reverse(x), st.nn.sequence_softmax(x),
               st.nn.sequence_last_step(x, lengths=n),
               st.nn.sequence_pool(x, "average", lengths=n),
               st.nn.sequence_reverse(x, lengths=n),
               st.nn.sequence_reshape(x, 2),
               st.nn.sequence_enumerate(x[:, :, 0], 2),
               st.nn.sequence_expand(x[:, 0], x),
               st.nn.sequence_slice(x, np.array([1, 0]), np.array([2, 3]),
                                    lengths=n),
               st.nn.sequence_concat([x, x])[0]]
        return out

    j, t = _both(seqs, xs, lengths)
    for a, b in zip(t, j):
        _close(_np(a), _np(b))


def test_functional_builders_match_jax():
    rng = np.random.RandomState(6)
    w = rng.randn(6, 4).astype("float32")
    seq = rng.randn(2, 5, 4).astype("float32")
    x = rng.randn(4, 8).astype("float32")

    def fns(pkg, st, w, seq, x):
        return [st.nn.spectral_norm(w), st.nn.row_conv(seq, 2),
                st.nn.data_norm(x), st.nn.sequence_conv(seq, 3)]

    j, t = _both(fns, w, seq, x)
    for a, b in zip(t, j):
        _close(_np(a), _np(b))
    sigma = np.linalg.svd(_np(t[0]), compute_uv=False)[0]
    assert abs(sigma - 1.0) < 0.05
    with pytest.raises(NotImplementedError, match="stride"):
        static.nn.sequence_conv(torch.from_numpy(seq), 3, filter_stride=2)


def test_layer_builders_match_jax_with_carried_weights(both_static):
    rng = np.random.RandomState(8)
    feed = {"a": rng.randn(3, 4).astype("float32"),
            "b": rng.randn(3, 5).astype("float32"),
            "img": rng.randn(2, 3, 6, 6).astype("float32"),
            "vol": rng.randn(2, 3, 4, 4, 4).astype("float32")}
    outs = []
    progs = []
    for pkg, st in ((paddle, jstatic), (pt, static)):
        main = st.Program()
        with st.program_guard(main):
            a = st.data("a", [None, 4], "float32")
            b = st.data("b", [None, 5], "float32")
            img = st.data("img", [None, 3, 6, 6], "float32")
            vol = st.data("vol", [None, 3, 4, 4, 4], "float32")
            fetches = [
                st.nn.bilinear_tensor_product(a, b, 6, act="tanh"),
                st.nn.prelu(img, mode="channel"),
                st.nn.prelu(img),
                st.nn.conv2d(img, 4, 3, padding=1, act="relu"),
                st.nn.conv2d_transpose(img, 2, None, stride=2,
                                       output_size=[12, 12]),
                st.nn.conv3d(vol, 2, 3, padding=1),
                st.nn.batch_norm(vol, is_test=True),
                st.nn.layer_norm(img, begin_norm_axis=3),
                st.nn.instance_norm(img),
                st.nn.group_norm(img, 3, act="relu"),
                st.nn.fc(img, size=5, num_flatten_dims=1),
                st.nn.fc(img, size=5, num_flatten_dims=2,
                         activation="sigmoid")]
        progs.append((main, fetches))
    program_from_jax(progs[1][0], _jax_params(progs[0][0]))
    for (main, fetches), st in zip(progs, (jstatic, static)):
        outs.append(st.Executor().run(main, feed=feed, fetch_list=fetches))
    for i, (got, want) in enumerate(zip(outs[1], outs[0])):
        assert got.shape == want.shape, i
        _close(got, want)
    assert outs[1][-1].shape == (2, 3, 5)


def test_nce_label_flows_and_crf_decoding_matches(both_static):
    main = static.Program()
    with static.program_guard(main):
        x = static.data("x", [None, 8], "float32")
        y = static.data("y", [None, 1], "int64")
        loss = pt.mean(static.nn.nce(x, y, 20, name="nce_tt"))
    exe = static.Executor()
    xs = np.random.RandomState(9).randn(4, 8).astype("float32")
    (l1,) = exe.run(main, feed={"x": xs, "y": np.zeros((4, 1), "int64")},
                    fetch_list=[loss])
    (l2,) = exe.run(main, feed={"x": xs, "y": np.full((4, 1), 7, "int64")},
                    fetch_list=[loss])
    assert np.isfinite(l1) and abs(float(l1) - float(l2)) > 1e-6
    pt.disable_static()
    paddle.disable_static()
    em = np.random.RandomState(10).randn(2, 6, 5).astype("float32")
    jpath = jstatic.nn.crf_decoding(paddle.to_tensor(em))
    path = static.nn.crf_decoding(torch.from_numpy(em))
    np.testing.assert_array_equal(path.numpy(), np.asarray(jpath.numpy()))


def test_builders_that_wait_or_raise_name_it():
    ids = torch.zeros(2, 3, dtype=torch.int64)
    with pytest.raises(NotImplementedError, match="Queue 1 item 4"):
        static.nn.sparse_embedding(ids, (30, 8))
    with pytest.raises(NotImplementedError, match="Queue 1 item 5"):
        static.nn.deform_conv2d(torch.zeros(1, 2, 4, 4), None, None, 2, 3)
    with pytest.raises(NotImplementedError, match="vision.ops"):
        static.nn.multi_box_head()
    x = torch.randn(1, 2, 4, 4)
    with pytest.raises(NotImplementedError, match="element"):
        static.nn.prelu(x, mode="element")
    with pytest.raises(TypeError, match="unsupported"):
        static.nn.conv2d(x, 3, 3, use_cudnn=True)


def test_data_norm_accumulates_as_jax():
    from paddle_tpu.static.nn.layers_compat import \
        fc_compat_registry as jreg
    from paddle_tpu_torch.static.nn.layers_compat import fc_compat_registry
    means = []
    for st, reg, make in ((jstatic, jreg, paddle.to_tensor),
                          (static, fc_compat_registry, torch.from_numpy)):
        st.nn.data_norm(make(np.full((4, 3), 10.0, "float32")),
                        name="dn_acc_t")
        st.nn.data_norm(make(np.full((4, 3), -10.0, "float32")),
                        name="dn_acc_t")
        layer = reg[("data_norm", "dn_acc_t", 3)]
        means.append(_np(layer._mean))
    _close(means[1], means[0])
