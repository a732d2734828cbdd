"""The port's optimizers and gradient clips against the JAX package's, on
the CPU.

Every optimizer (with its decay, per-parameter learning-rate scale,
birth step, multi-precision and exclusion options) takes 3 eager steps
on the same parameters and gradients as the JAX eager ``step()``; the
parameters and every slot agree within 1e-6 (atol + rtol, float32: the
rules are the same float32 arithmetic in another order). bf16
parameters agree exactly after rounding their masters, which agree
within 1e-6. The clips give the JAX clips' gradients and norms within
1e-6.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import nn as jnn
from paddle_tpu import optimizer as jopt
from paddle_tpu.framework.tensor import Parameter as JaxParameter
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.nn import clip as tclip
from paddle_tpu_torch.optimizer import lr as tlr

TOL = dict(atol=1e-6, rtol=1e-6)
SHAPES = [(4, 3), (3,), (5,)]
NAMES = ["w0", "b1", "g2"]


def _arrays(seed, scale=1.0):
    rng = np.random.RandomState(seed)
    return [(scale * rng.randn(*s)).astype(np.float32) for s in SHAPES]


GRADS = [_arrays(10 + i, 0.5) for i in range(3)]


def _no_bias(name):
    return not name.startswith("b")


# name -> (JAX class, port class, kwargs); "wd" values are built per side
CASES = {
    "SGD": ("SGD", dict(learning_rate=0.1)),
    "SGD_L1Decay": ("SGD", dict(learning_rate=0.1, weight_decay=("L1",
                                                                  0.01))),
    "Momentum": ("Momentum", dict(learning_rate=0.05, momentum=0.9,
                                  weight_decay=0.01)),
    "Momentum_nesterov": ("Momentum", dict(learning_rate=0.05,
                                           momentum=0.9,
                                           use_nesterov=True)),
    "Adam": ("Adam", dict(learning_rate=0.01)),
    "Adam_L2Decay": ("Adam", dict(learning_rate=0.01,
                                  weight_decay=("L2", 0.05))),
    "Adam_L1Decay": ("Adam", dict(learning_rate=0.01,
                                  weight_decay=("L1", 0.05))),
    "AdamW": ("AdamW", dict(learning_rate=0.01, weight_decay=0.1)),
    "AdamW_L1Decay": ("AdamW", dict(learning_rate=0.01,
                                    weight_decay=("L1", 0.2))),
    "AdamW_apply_decay_param_fun": ("AdamW", dict(
        learning_rate=0.01, weight_decay=0.1,
        apply_decay_param_fun=_no_bias)),
    "Adamax": ("Adamax", dict(learning_rate=0.01)),
    "Adagrad": ("Adagrad", dict(learning_rate=0.1,
                                initial_accumulator_value=0.1)),
    "Adadelta": ("Adadelta", dict(learning_rate=1.0, rho=0.9)),
    "RMSProp": ("RMSProp", dict(learning_rate=0.01, momentum=0.9)),
    "RMSProp_centered": ("RMSProp", dict(learning_rate=0.01, momentum=0.5,
                                         centered=True)),
    "Lamb": ("Lamb", dict(learning_rate=0.01, lamb_weight_decay=0.05)),
    "Lamb_exclusion": ("Lamb", dict(
        learning_rate=0.01, lamb_weight_decay=0.05,
        exclude_from_weight_decay_fn=lambda p: len(p.shape) == 1)),
}


def _kwargs(kw, mod):
    kw = dict(kw)
    wd = kw.get("weight_decay")
    if isinstance(wd, tuple):
        kw["weight_decay"] = getattr(mod, f"{wd[0]}Decay")(wd[1])
    return kw


def _jax_params(values, dtype=np.float32):
    import jax.numpy as jnp
    return [JaxParameter(jnp.asarray(v).astype(dtype), name=n)
            for n, v in zip(NAMES, values)]


def _port_params(values, dtype=torch.float32):
    return [torch.nn.Parameter(torch.from_numpy(v.copy()).to(dtype))
            for v in values]


def _run_jax(cls, kw, values, grads, attrs=None, state=None,
             dtype=np.float32, steps=3):
    params = _jax_params(values, dtype)
    for p, a in zip(params, attrs or [{}] * len(params)):
        for k, v in a.items():
            setattr(p, k, v)
    opt = getattr(jopt, cls)(parameters=params, **_kwargs(kw, jopt))
    if state is not None:
        opt.set_state_dict(state)
    for g in grads[:steps]:
        for p, gi in zip(params, g):
            p.grad = paddle.to_tensor(gi.astype(dtype))
        opt.step()
        opt.clear_grad()
    return params, opt


def _run_port(cls, kw, values, grads, attrs=None, state=None,
              dtype=torch.float32, steps=3):
    params = _port_params(values, dtype)
    for p, a in zip(params, attrs or [{}] * len(params)):
        for k, v in a.items():
            setattr(p, k, v)
    opt = getattr(topt, cls)(parameters=list(zip(NAMES, params)),
                             **_kwargs(kw, topt))
    if state is not None:
        opt.set_state_dict(state)
    for g in grads[:steps]:
        for p, gi in zip(params, g):
            p.grad = torch.from_numpy(gi).to(dtype)
        opt.step()
        opt.clear_grad()
    return params, opt


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(getattr(x, "_data", x)).astype(np.float32)


def _assert_same(jparams, jopt_, tparams, topt_, tol=TOL):
    for name, a, b in zip(NAMES, jparams, tparams):
        np.testing.assert_allclose(_np(b), _np(a), **tol, err_msg=name)
    jstate, tstate = jopt_.state_dict(), topt_.state_dict()
    assert sorted(tstate) == sorted(jstate)
    for key, want in jstate.items():
        if key == "@step":
            assert tstate[key] == want
        elif key != "LR_Scheduler":
            np.testing.assert_allclose(_np(tstate[key]), _np(want), **TOL,
                                       err_msg=key)


def test_every_optimizer_is_a_case():
    from paddle_tpu.optimizer import optimizer as jmod
    names = set(jmod.__all__) - {"Optimizer"}
    assert {c for c, _ in CASES.values()} == names
    assert all(hasattr(topt, n) for n in names)


@pytest.mark.parametrize("case", sorted(CASES))
def test_three_eager_steps_match_jax(case):
    cls, kw = CASES[case]
    values = _arrays(1)
    jp, jo = _run_jax(cls, kw, values, GRADS)
    tp, to = _run_port(cls, kw, values, GRADS)
    _assert_same(jp, jo, tp, to)
    assert to._step_count == jo._step_count == 3


@pytest.mark.parametrize("cls", ["SGD", "Adam", "AdamW", "Momentum"])
def test_optimize_attr_scales_one_parameters_lr(cls):
    kw = dict(CASES[cls][1])
    attrs = [{}, {"optimize_attr": {"learning_rate": 0.25}}, {}]
    values = _arrays(2)
    jp, jo = _run_jax(cls, kw, values, GRADS, attrs)
    tp, to = _run_port(cls, kw, values, GRADS, attrs)
    _assert_same(jp, jo, tp, to)
    plain, _ = _run_port(cls, kw, values, GRADS)
    assert not np.allclose(_np(plain[1]), _np(tp[1]))
    np.testing.assert_array_equal(_np(plain[0]), _np(tp[0]))


@pytest.mark.parametrize("cls", ["Adam", "AdamW", "Lamb"])
def test_birth_step_t0_is_honoured_and_restored(cls):
    """A parameter born at step 2 (``_t0``) bias-corrects from its own
    step 1 while the others go on from step 3."""
    kw = CASES[cls][1]
    values = _arrays(3)
    base = {"@step": 2, "b1__t0": 2}
    for n, v in zip(NAMES, values):
        zeros = np.zeros_like(v)
        base[f"{n}_moment1"] = zeros + (0.0 if n == "b1" else 0.01)
        base[f"{n}_moment2"] = zeros + (0.0 if n == "b1" else 1e-3)
    jp, jo = _run_jax(cls, kw, values, GRADS,
                      state={k: (paddle.to_tensor(v)
                                 if isinstance(v, np.ndarray) else v)
                             for k, v in base.items()}, steps=2)
    tp, to = _run_port(cls, kw, values, GRADS, state=base, steps=2)
    _assert_same(jp, jo, tp, to)
    assert to.state_dict()["b1__t0"] == 2 and to._step_count == 4
    # without the marker the step differs: the marker is what moved it
    no_t0 = {k: v for k, v in base.items() if k != "b1__t0"}
    up, _ = _run_port(cls, kw, values, GRADS, state=no_t0, steps=2)
    assert not np.allclose(_np(up[1]), _np(tp[1]))


@pytest.mark.parametrize("cls", ["AdamW", "SGD", "Adam"])
def test_multi_precision_keeps_float32_masters(cls):
    import jax.numpy as jnp
    kw = dict(CASES[cls][1], multi_precision=True)
    values = _arrays(4)
    jp, jo = _run_jax(cls, kw, values, GRADS, dtype=jnp.bfloat16)
    tp, to = _run_port(cls, kw, values, GRADS, dtype=torch.bfloat16)
    jstate, tstate = jo.state_dict(), to.state_dict()
    assert sorted(tstate) == sorted(jstate)
    for n, a, b in zip(NAMES, jp, tp):
        master = tstate[f"{n}_master_weight"]
        assert b.dtype == torch.bfloat16 and master.dtype == torch.float32
        np.testing.assert_allclose(_np(master),
                                   _np(jstate[f"{n}_master_weight"]), **TOL)
        np.testing.assert_array_equal(_np(b), _np(master.bfloat16()))
        np.testing.assert_allclose(_np(b), _np(a), atol=0, rtol=2 ** -7)


def test_lr_scheduler_drives_the_step_and_rides_in_state_dict():
    jsched = paddle.optimizer.lr.StepDecay(0.1, step_size=1, gamma=0.5)
    tsched = tlr.StepDecay(0.1, step_size=1, gamma=0.5)
    values = _arrays(5)
    jp = _jax_params(values)
    tp = _port_params(values)
    jo = jopt.SGD(jsched, parameters=jp)
    to = topt.SGD(tsched, parameters=list(zip(NAMES, tp)))
    for g in GRADS:
        for p, q, gi in zip(jp, tp, g):
            p.grad = paddle.to_tensor(gi)
            q.grad = torch.from_numpy(gi)
        assert to.get_lr() == jo.get_lr()
        jo.step()
        to.step()
        jsched.step()
        tsched.step()
    _assert_same(jp, jo, tp, to)
    assert to.state_dict()["LR_Scheduler"] == jo.state_dict()["LR_Scheduler"]
    with pytest.raises(RuntimeError, match="LRScheduler"):
        to.set_lr(0.5)
    fresh = topt.SGD(tlr.StepDecay(0.1, step_size=1, gamma=0.5),
                     parameters=list(zip(NAMES, tp)))
    fresh.set_state_dict(to.state_dict())
    assert fresh.get_lr() == to.get_lr() == 0.1 * 0.5 ** 3


# ------------------------------------------------------------------- clips
def _pairs_jax(grads, need_clip=(True, True, True)):
    ps = _jax_params(_arrays(6))
    for p, nc in zip(ps, need_clip):
        p.need_clip = nc
    import jax.numpy as jnp
    return [(p, jnp.asarray(g)) for p, g in zip(ps, grads)]


def _pairs_port(grads, need_clip=(True, True, True)):
    ps = _port_params(_arrays(6))
    for p, nc in zip(ps, need_clip):
        p.need_clip = nc
    return [(p, torch.from_numpy(g.copy())) for p, g in zip(ps, grads)]


CLIPS = {
    "ByValue": lambda m: m.ClipGradByValue(0.3, -0.2),
    "ByNorm": lambda m: m.ClipGradByNorm(0.5),
    "ByGlobalNorm": lambda m: m.ClipGradByGlobalNorm(0.7),
}


@pytest.mark.parametrize("need_clip", [(True, True, True),
                                       (True, False, True)])
@pytest.mark.parametrize("name", sorted(CLIPS))
def test_clips_match_jax(name, need_clip):
    grads = GRADS[0]
    want = CLIPS[name](jnn)(_pairs_jax(grads, need_clip))
    got = CLIPS[name](tnn)(_pairs_port(grads, need_clip))
    for (_, a), (_, b) in zip(want, got):
        np.testing.assert_allclose(_np(b), np.asarray(a), **TOL)
    if name == "ByGlobalNorm":
        if need_clip[1] is False:
            np.testing.assert_array_equal(_np(got[1][1]), grads[1])
        jn = jnn.ClipGradByGlobalNorm(0.7).clip_with_norm(
            _pairs_jax(grads, need_clip))[1]
        tn = tnn.ClipGradByGlobalNorm(0.7).clip_with_norm(
            _pairs_port(grads, need_clip))[1]
        assert tn.dtype == torch.float32
        np.testing.assert_allclose(float(tn), float(jn), **TOL)


def test_global_norm_reduces_bf16_in_float32_and_floors_at_clip_norm():
    """The norm of bf16 gradients is the f32 norm of their values; under
    the clip norm nothing scales (no epsilon)."""
    rng = np.random.RandomState(7)
    g = [torch.from_numpy(rng.randn(1000).astype(np.float32)).bfloat16()
         for _ in range(3)]
    pairs = [(torch.nn.Parameter(torch.zeros(1000)), x) for x in g]
    out, norm = tnn.ClipGradByGlobalNorm(1e9).clip_with_norm(pairs)
    want = float(np.sqrt(sum((x.float().numpy().astype(np.float64) ** 2)
                             .sum() for x in g)))
    np.testing.assert_allclose(float(norm), want, rtol=1e-6)
    assert all(torch.equal(a, b) for (_, a), b in zip(out, g))
    assert all(b.dtype == torch.bfloat16 for _, b in out)


def test_clip_functions_match_jax():
    from paddle_tpu.nn import clip as jclip
    x = GRADS[1][0]
    want = jclip.clip_by_norm(paddle.to_tensor(x), 0.5)
    np.testing.assert_allclose(
        tclip.clip_by_norm(torch.from_numpy(x), 0.5).numpy(),
        want.numpy(), **TOL)
    want = jclip.clip_by_global_norm([paddle.to_tensor(g)
                                      for g in GRADS[2]], 0.4)
    got = tclip.clip_by_global_norm([torch.from_numpy(g)
                                     for g in GRADS[2]], 0.4)
    for a, b in zip(want, got):
        np.testing.assert_allclose(b.numpy(), a.numpy(), **TOL)


@pytest.mark.parametrize("cls", ["SGD", "AdamW"])
def test_grad_clip_runs_first_in_the_step(cls):
    """The step clips the raw gradients, then decays: the same parameters
    as the JAX step, and a different result from clipping nothing."""
    kw = dict(CASES[cls][1], weight_decay=0.05)
    for side, mod in (("jax", jnn), ("port", tnn)):
        kw[f"clip_{side}"] = mod.ClipGradByGlobalNorm(0.3)
    jkw = {k: v for k, v in kw.items() if not k.startswith("clip_")}
    values = _arrays(8)
    jp, jo = _run_jax(cls, dict(jkw, grad_clip=kw["clip_jax"]), values,
                      GRADS)
    tp, to = _run_port(cls, dict(jkw, grad_clip=kw["clip_port"]), values,
                       GRADS)
    _assert_same(jp, jo, tp, to)
    up, _ = _run_port(cls, jkw, values, GRADS)
    assert not np.allclose(_np(up[0]), _np(tp[0]))


def test_param_attr_sets_what_the_step_and_the_clips_read():
    p = torch.nn.Parameter(torch.zeros(3))
    out = tnn.set_param_attr(p, tnn.ParamAttr(learning_rate=0.5,
                                              need_clip=False,
                                              trainable=False))
    assert out is p and p.optimize_attr == {"learning_rate": 0.5}
    assert p.need_clip is False and p.requires_grad is False
    j = jnn.ParamAttr(learning_rate=0.5, need_clip=False)
    assert (j.learning_rate, j.need_clip, j.trainable) == (0.5, False, True)
    # an untrainable parameter takes no step, as a stop_gradient one
    p.grad = torch.ones(3)
    topt.SGD(0.1, parameters=[p]).step()
    assert torch.equal(p, torch.zeros(3))


def test_regularizer_reexports_the_decays():
    from paddle_tpu_torch import regularizer
    assert regularizer.L1Decay is topt.L1Decay
    assert regularizer.L2Decay is topt.L2Decay
