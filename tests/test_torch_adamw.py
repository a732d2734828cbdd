"""Fused AdamW of the PyTorch port (paddle_tpu_torch/ops/fused_adamw.py) and
the optimizers on it (paddle_tpu_torch/optimizer) against the JAX package:
its Pallas kernel ``fused_adamw`` in interpret mode, and the eager
``step()`` of its ``Adam``/``AdamW`` with the kernel forced on.

On the CPU the port's wrapper runs its plain version; the CUDA kernel is
checked on the card by chip_smoke.py and tests/test_torch_cuda.py.
Tolerance: float32 atol 1e-6, rtol 1e-6 (the same float32 arithmetic in
the same order, after three steps).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.framework.flags import set_flags
from paddle_tpu.framework.tensor import Parameter, Tensor
from paddle_tpu.ops import pallas_kernels as pk
from paddle_tpu_torch.ops.fused_adamw import adamw_plain_, fused_adamw_
from paddle_tpu_torch.optimizer import Adam, AdamW

TOL = dict(atol=1e-6, rtol=1e-6)
HYPER = dict(lr=1e-2, beta1=0.9, beta2=0.999, eps=1e-8)


def _state(seed, shape=(3, 50)):
    rng = np.random.RandomState(seed)
    p = rng.randn(*shape).astype(np.float32)
    grads = [rng.randn(*shape).astype(np.float32) for _ in range(3)]
    return p, grads


@pytest.mark.parametrize("wd", [0.0, 0.05])
def test_three_steps_match_the_jax_kernel(wd):
    p, grads = _state(0)
    jp, jm, jv = jnp.asarray(p), jnp.zeros(p.shape), jnp.zeros(p.shape)
    tp = torch.from_numpy(p.copy())
    tm, tv = torch.zeros(p.shape), torch.zeros(p.shape)
    for step, g in enumerate(grads, start=1):
        jp, jm, jv = pk.fused_adamw(jp, jnp.asarray(g), jm, jv,
                                    weight_decay=wd, step=step, **HYPER)
        fused_adamw_(tp, torch.from_numpy(g), tm, tv, weight_decay=wd,
                     step=step, **HYPER)
    for got, want in ((tp, jp), (tm, jm), (tv, jv)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_low_copy_is_the_master_rounded_down():
    p, (g, *_) = _state(1)
    master = torch.from_numpy(p.copy())
    low = master.to(torch.bfloat16)
    m, v = torch.zeros(p.shape), torch.zeros(p.shape)
    fused_adamw_(master, torch.from_numpy(g).to(torch.bfloat16), m, v,
                 weight_decay=0.01, step=1, low=low, **HYPER)
    assert torch.equal(low, master.to(torch.bfloat16))
    ref = torch.from_numpy(p.copy())
    adamw_plain_(ref, torch.from_numpy(g).to(torch.bfloat16).float(),
                 torch.zeros(p.shape), torch.zeros(p.shape),
                 weight_decay=0.01, step=1, **HYPER)
    assert torch.equal(master, ref)


def _jax_eager(cls, p, grads, **kw):
    param = Parameter(jnp.asarray(p))
    opt = cls(learning_rate=HYPER["lr"], parameters=[param], **kw)
    set_flags({"FLAGS_pallas_force": True})
    try:
        for g in grads:
            param.grad = Tensor(jnp.asarray(g))
            opt.step()
    finally:
        set_flags({"FLAGS_pallas_force": False})
    return np.asarray(param._data)


@pytest.mark.parametrize("kind", ["adamw", "adam_l2"])
def test_eager_step_matches_the_jax_optimizer(kind):
    import paddle_tpu.optimizer as jopt
    p, grads = _state(2)
    if kind == "adamw":
        want = _jax_eager(jopt.AdamW, p, grads, weight_decay=0.05)
    else:
        want = _jax_eager(jopt.Adam, p, grads, weight_decay=0.05)
    param = torch.nn.Parameter(torch.from_numpy(p.copy()))
    opt = (AdamW if kind == "adamw" else Adam)(
        learning_rate=HYPER["lr"], parameters=[param], weight_decay=0.05)
    for g in grads:
        param.grad = torch.from_numpy(g)
        opt.step()
    np.testing.assert_allclose(param.detach().numpy(), want, **TOL)


def test_multi_precision_keeps_a_float32_master():
    """A bf16 parameter under ``multi_precision``: the gradient is rounded
    to bf16, the rule runs on the f32 master, and the parameter is the
    master rounded down (``Optimizer._apply_rule``)."""
    p, grads = _state(3)
    param = torch.nn.Parameter(torch.from_numpy(p).to(torch.bfloat16))
    opt = AdamW(HYPER["lr"], parameters=[("w", param)], weight_decay=0.01,
                multi_precision=True)
    master = param.detach().float().clone()
    m, v = torch.zeros(p.shape), torch.zeros(p.shape)
    for step, g in enumerate(grads, start=1):
        param.grad = torch.from_numpy(g).to(torch.bfloat16)
        opt.step()
        adamw_plain_(master, torch.from_numpy(g).to(torch.bfloat16), m, v,
                     weight_decay=0.01, step=step, **HYPER)
    state = opt.state_dict()
    assert torch.equal(state["w_master_weight"], master)
    assert torch.equal(param.detach(), master.to(torch.bfloat16))
    assert state["@step"] == 3


def test_apply_decay_param_fun_and_state_dict_round_trip():
    p, grads = _state(4, (4, 8))
    params = [torch.nn.Parameter(torch.from_numpy(p.copy()))
              for _ in range(2)]
    opt = AdamW(HYPER["lr"], parameters=list(zip(("w", "bias"), params)),
                weight_decay=0.5, apply_decay_param_fun=lambda n: n == "w")
    for g in grads[:2]:
        for t in params:
            t.grad = torch.from_numpy(g)
        opt.step()
        opt.clear_grad()
    assert all(t.grad is None for t in params)
    assert not torch.equal(params[0], params[1])      # only w decays
    fresh = [torch.nn.Parameter(t.detach().clone()) for t in params]
    opt2 = AdamW(HYPER["lr"], parameters=list(zip(("w", "bias"), fresh)),
                 weight_decay=0.5, apply_decay_param_fun=lambda n: n == "w")
    opt2.set_state_dict(opt.state_dict())
    for o, ts in ((opt, params), (opt2, fresh)):
        for t in ts:
            t.grad = torch.from_numpy(grads[2])
        o.step()
    for a, b in zip(params, fresh):
        assert torch.equal(a, b)


def test_cpu_wrapper_counts_no_launches_and_step_needs_parameters():
    before = fused_adamw_.launches
    p = torch.zeros(4)
    fused_adamw_(p, torch.ones(4), torch.zeros(4), torch.zeros(4),
                 weight_decay=0.0, step=1, **HYPER)
    assert fused_adamw_.launches == before
    with pytest.raises(ValueError, match="parameter list"):
        AdamW(parameters=None).step()
