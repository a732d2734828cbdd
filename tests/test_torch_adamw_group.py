"""The multi-tensor AdamW of the PyTorch port (``adamw_plan``,
``fused_adamw_group_`` and the one-pass ``Adam``/``AdamW`` step) against
the JAX package's per-parameter eager step, whose Pallas kernel runs in
interpret mode (``FLAGS_pallas_force``, as ``tests/test_torch_adamw.py``
runs it).

On the CPU the group wrapper runs its plain version tensor by tensor;
the CUDA kernel is checked on the card by chip_smoke.py and
tests/test_torch_cuda.py. Tolerance: float32 atol 1e-6, rtol 1e-6 (the
same float32 arithmetic in the same order, after three steps); a 16-bit
parameter is its own master rounded, exactly, on each side.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu.optimizer as jopt
from paddle_tpu.framework.flags import set_flags
from paddle_tpu.framework.tensor import Parameter, Tensor
from paddle_tpu_torch import amp
from paddle_tpu_torch.models import GPTConfig, GPTForPretraining
from paddle_tpu_torch.ops import fused_adamw as fad
from paddle_tpu_torch.optimizer import Adam, AdamW
from paddle_tpu_torch.optimizer import optimizer as opt_module

TOL = dict(atol=1e-6, rtol=1e-6)
LR = 1e-2

# (name, shape, dtype, ParamAttr learning rate or None); "late" has no
# gradient at step 1, "t0" is given a birth step of 1 after step 1
PARAMS = (("w0", (3, 50), "float32", None),
          ("bias0", (50,), "float32", None),
          ("one", (1,), "float32", None),
          ("scaled", (4, 7), "float32", 0.5),
          ("late", (5, 3), "float32", None),
          ("t0", (9,), "float32", None),
          ("wbf", (6, 40), "bfloat16", None),
          ("bias_bf", (40,), "bfloat16", 2.0),
          ("wf16", (6, 40), "float16", None))


def _no_bias(name):
    return "bias" not in name


def _grads(seed):
    rng = np.random.RandomState(seed)
    out = []
    for step in range(1, 4):
        out.append({name: None if (name == "late" and step == 1) else
                    rng.randn(*shape).astype(np.float32)
                    for name, shape, _, _ in PARAMS})
    return out


def _initial(seed):
    rng = np.random.RandomState(seed)
    return {name: rng.randn(*shape).astype(np.float32)
            for name, shape, _, _ in PARAMS}


def _rounded(x, dtype):
    """``x`` rounded to ``dtype`` as float32 numpy: the values both sides
    hold for a 16-bit parameter or gradient."""
    return torch.from_numpy(x).to(getattr(torch, dtype)).float().numpy()


def _run_port(kind, init, grads):
    params = {name: torch.nn.Parameter(
        torch.tensor(init[name]).to(getattr(torch, dt)))
        for name, _, dt, _ in PARAMS}
    for name, _, _, scale in PARAMS:
        if scale is not None:       # as nn.layer.ParamAttr sets it
            params[name].optimize_attr = {"learning_rate": scale}
    named = list(params.items())
    if kind == "adamw":
        opt = AdamW(LR, parameters=named, weight_decay=0.05,
                    apply_decay_param_fun=_no_bias, multi_precision=True)
    else:
        opt = Adam(LR, parameters=named, multi_precision=True)
    for step, gs in enumerate(grads, start=1):
        for name, p in params.items():
            g = gs[name]
            p.grad = None if g is None else torch.tensor(g).to(p.dtype)
        opt.step()
        if step == 1:
            state = opt.state_dict()
            state["t0__t0"] = 1
            opt.set_state_dict(state)
    return params, opt


def _run_jax(kind, init, grads):
    params = {name: Parameter(jnp.asarray(_rounded(init[name], dt))
                              .astype(dt), name=name)
              for name, _, dt, _ in PARAMS}
    for name, _, _, scale in PARAMS:
        if scale is not None:
            params[name].optimize_attr = {"learning_rate": scale}
    if kind == "adamw":
        opt = jopt.AdamW(learning_rate=LR, parameters=list(params.values()),
                         weight_decay=0.05, apply_decay_param_fun=_no_bias,
                         multi_precision=True)
    else:
        opt = jopt.Adam(learning_rate=LR, parameters=list(params.values()),
                        multi_precision=True)
    set_flags({"FLAGS_pallas_force": True})
    try:
        for step, gs in enumerate(grads, start=1):
            for name, _, dt, _ in PARAMS:
                g = gs[name]
                params[name].grad = None if g is None else Tensor(
                    jnp.asarray(_rounded(g, dt)).astype(dt))
            opt.step()
            if step == 1:
                state = opt.state_dict()
                state["t0__t0"] = 1
                opt.set_state_dict(state)
    finally:
        set_flags({"FLAGS_pallas_force": False})
    return params, opt


@pytest.mark.parametrize("kind", ["adamw", "adam"])
def test_one_pass_matches_the_jax_per_parameter_step(kind):
    """Three steps over one mixed list: several shapes and a 1-element
    tensor, a ParamAttr learning rate, no decay on the biases (AdamW), a
    parameter whose first gradient comes at step 2, one whose birth step
    is 1, bf16 and f16 parameters on f32 masters."""
    init, grads = _initial(0), _grads(1)
    calls = []
    orig = opt_module.fused_adamw_group_

    def spy(*a, **kw):
        calls.append(len(a[0]))
        return orig(*a, **kw)

    opt_module.fused_adamw_group_ = spy
    try:
        tparams, topt = _run_port(kind, init, grads)
    finally:
        opt_module.fused_adamw_group_ = orig
    jparams, jopt_ = _run_jax(kind, init, grads)
    # one call a step, over every parameter with a gradient
    assert calls == [len(PARAMS) - 1, len(PARAMS), len(PARAMS)]
    assert topt._step_count == jopt_._step_count == 3
    for name, _, dt, _ in PARAMS:
        tslots, jslots = topt._slots[name], jopt_._slots[name]
        for s in ("moment1", "moment2"):
            np.testing.assert_allclose(tslots[s].numpy(),
                                       np.asarray(jslots[s]), **TOL,
                                       err_msg=f"{name} {s}")
        tp = tparams[name].detach()
        jp = np.asarray(jparams[name]._data)
        if dt == "float32":
            np.testing.assert_allclose(tp.numpy(), jp, **TOL, err_msg=name)
            continue
        tm = tslots["master_weight"]
        jm = np.asarray(jslots["master_weight"])
        np.testing.assert_allclose(tm.numpy(), jm, **TOL, err_msg=name)
        assert torch.equal(tp, tm.to(tp.dtype))
        np.testing.assert_array_equal(
            jp.astype(np.float32),
            np.asarray(jnp.asarray(jm).astype(dt).astype(jnp.float32)))


def test_grad_scaler_skip_changes_no_bit_and_launches_nothing():
    init, grads = _initial(2), _grads(3)
    params, opt = _run_port("adamw", init, grads[:1])
    scaler = amp.GradScaler(init_loss_scaling=2. ** 10,
                            decr_every_n_nan_or_inf=1)
    before = {n: p.detach().clone() for n, p in params.items()}
    slots = {(n, s): t.clone() for n, d in opt._slots.items()
             for s, t in d.items() if torch.is_tensor(t)}
    step = opt._step_count
    for name, p in params.items():
        g = grads[1][name]
        p.grad = torch.tensor(init[name] if g is None else g).to(p.dtype)
    params["w0"].grad[0, 0] = float("inf")
    calls = []
    orig = opt_module.fused_adamw_group_

    def spy(*a, **kw):
        calls.append(a)
        return orig(*a, **kw)

    opt_module.fused_adamw_group_ = spy
    try:
        scaler.step(opt)
        scaler.update()
    finally:
        opt_module.fused_adamw_group_ = orig
    assert calls == [] and opt._step_count == step
    assert scaler.get_loss_scaling() == 2. ** 9
    for name, p in params.items():
        assert torch.equal(p.detach(), before[name]), name
    for (name, s), t in slots.items():
        assert torch.equal(opt._slots[name][s], t), (name, s)


def _capture(opt, params, grads):
    """Run one step and return the operand lists it handed the group
    wrapper, as ``(p, g, m, v, low)`` per tensor."""
    got = []
    orig = opt_module.fused_adamw_group_

    def spy(ps, gs, ms, vs, lows, *rest):
        got.extend(zip(ps, gs, ms, vs, lows))
        return orig(ps, gs, ms, vs, lows, *rest)

    for name, p in params.items():
        g = grads[name]
        p.grad = torch.tensor(np.zeros(p.shape, np.float32) if g is None
                              else g).to(p.dtype)
    opt_module.fused_adamw_group_ = spy
    try:
        opt.step()
    finally:
        opt_module.fused_adamw_group_ = orig
    return got


def test_state_dict_round_trip_rebuilds_the_cached_operands():
    """The wrapper's cache, run here on CPU tensors (its checks and plan
    are pure Python): the same operands hit it, and the moments that
    ``set_state_dict`` reallocates miss it and carry their new pointers."""
    init, grads = _initial(4), _grads(5)
    params, opt = _run_port("adamw", init, grads[:1])
    ops = _capture(opt, params, grads[1])
    first = fad._operands_of(ops)
    assert fad._operands_of(ops) is first          # a steady step: a hit
    opt.set_state_dict(opt.state_dict())
    again = _capture(opt, params, grads[2])
    rebuilt = fad._operands_of(again)
    assert rebuilt is not first
    ptrs = rebuilt.ptrs.reshape(-1, 5)
    for row, (p, g, m, v, low) in zip(ptrs, again):
        assert row[2] == m.data_ptr() and row[3] == v.data_ptr()
    old = {int(x) for x in first.ptrs.reshape(-1, 5)[:, 2:4].ravel()}
    assert not old & {int(x) for x in ptrs[:, 2:4].ravel()}
    assert rebuilt.plan.launches == len(fad.adamw_plan(
        [p.numel() for p, *_ in again],
        [fad._check(*o) for o in again]))


def test_operand_checks_raise_before_any_plan():
    p = torch.zeros(8, 2).t()
    ok = torch.zeros(16)
    with pytest.raises(ValueError, match="contiguous"):
        fad._operands_of([(p, ok, ok, ok, None)])
    q = torch.zeros(8, dtype=torch.bfloat16)
    with pytest.raises(TypeError, match="bfloat16 p takes a bfloat16 g"):
        fad._operands_of([(q, torch.zeros(8), torch.zeros(8),
                           torch.zeros(8), None)])
    with pytest.raises(TypeError, match="moments must be float32"):
        fad._operands_of([(torch.zeros(8), torch.zeros(8),
                           torch.zeros(8, dtype=torch.float64),
                           torch.zeros(8), None)])


def _covered(plan, numels, kinds, chunk, max_tensors, max_chunks):
    seen = {}
    for launch in plan:
        assert 0 < len(launch.tensors) <= max_tensors
        assert 0 < len(launch.chunks) <= max_chunks
        assert {kinds[i] for i in launch.tensors} == {launch.kind}
        assert len(set(launch.tensors)) == len(launch.tensors)
        slots = {s for s, _ in launch.chunks}
        assert slots == set(range(len(launch.tensors)))
        for s, c in launch.chunks:
            i = launch.tensors[s]
            seen.setdefault(i, []).append(c)
    for i, n in enumerate(numels):
        assert sorted(seen.get(i, [])) == list(range(-(-n // chunk)))
        # every element in exactly one chunk: the chunks tile [0, n)
        cover = np.zeros(n, np.int32)
        for c in seen.get(i, []):
            cover[c * chunk:(c + 1) * chunk] += 1
        assert (cover == 1).all()


@pytest.mark.parametrize("limits", [(8, 3, 5), (16, 1, 1), (4, 2, 64),
                                    (fad.ADAMW_CHUNK, fad.ADAMW_MAX_TENSORS,
                                     fad.ADAMW_MAX_CHUNKS)])
def test_plan_tiles_every_tensor_within_the_limits(limits):
    chunk, max_tensors, max_chunks = limits
    rng = np.random.RandomState(6)
    numels = [0, 1, 3, 5, 4097] + [int(n) for n in rng.randint(
        0, 40 * chunk, 40)]
    kinds = [("f32", "bf16", "bf16"), ("f32", "f32", None),
             ("bf16", "bf16", None)]
    kinds = [kinds[k] for k in rng.randint(0, 3, len(numels))]
    plan = fad.adamw_plan(numels, kinds, chunk, max_tensors, max_chunks)
    _covered(plan, numels, kinds, chunk, max_tensors, max_chunks)
    # each kind's launches come together, in the order kinds first appear
    order = [k for k in dict.fromkeys(kinds)
             if any(n for kk, n in zip(kinds, numels) if kk == k)]
    assert list(dict.fromkeys(l.kind for l in plan)) == order


def test_gpt2_small_step_takes_the_launches_the_docs_state():
    with torch.device("meta"):
        net = GPTForPretraining(GPTConfig.gpt2_small())
    numels = [p.numel() for p in net.parameters()]
    assert (len(numels), sum(numels)) == (196, 124475904)
    plan = fad.adamw_plan(numels, [(0, 1, 1)] * len(numels))
    _covered(plan, numels, [(0, 1, 1)] * len(numels), fad.ADAMW_CHUNK,
             fad.ADAMW_MAX_TENSORS, fad.ADAMW_MAX_CHUNKS)
    assert len(plan) == 7
    assert "196 parameter tensors (124,475,904 elements,\none dtype " \
        "combination) take 7 launches" in fad.__doc__
