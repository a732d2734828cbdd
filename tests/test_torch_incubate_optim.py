"""``incubate.optimizer`` and ``incubate.asp`` of the PyTorch port against
the JAX package's, on the CPU.

* ``LookAhead`` (around ``AdamW``) and ``ModelAverage`` (beside ``SGD``)
  take the JAX trajectory on a float32 two-``Linear`` net, 9 steps;
  ``ModelAverage.apply()`` swaps in the JAX averages and gives the live
  weights back bit for bit; the ``state_dict`` keys (``@lookahead_step``,
  ``<name>_slow``) round-trip into a new optimizer that continues the
  same trajectory.
* The master weights: with bf16 parameters and ``multi_precision``
  (``SGD``: its update is linear in the gradient, so the two packages'
  bf16 forward passes, which round their products differently, stay
  within an ulp of each other over a few steps; Adam's normalised update
  would amplify those roundings), the
  JAX ``LookAhead`` writes its sync into the parameters only, and the
  master keeps the fast weights (shown here in the JAX package); the
  port's sync reaches the master, and its next step starts from the slow
  weights.
* ASP: the masks of a ``Linear`` net pick the same entries in both
  packages (the port computes them on the JAX ``[in, out]`` view of its
  ``[out, in]`` weights), the pruned weights and ``check_sparsity``
  agree, and ``decorate(...).minimize`` keeps the 2:4 pattern through 3
  steps with the JAX parameters; under bf16 ``multi_precision`` the JAX
  master trains the pruned entries while the port's keeps them at zero,
  and the parameters agree.

float32 within rtol 1e-5 / atol 1e-6, except the trajectories through
``AdamW`` at atol 1e-5: Adam's ``m / sqrt(v)`` takes away the gradient's
scale, so the float32 differences of a near-zero gradient component
(the two packages' backward passes sum in other orders) reach the
update at the learning rate's scale, 0.05 here; bf16 parameters within
two bf16 ulps of the weights' scale (``BF16_ATOL``).
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.incubate import asp as jasp
from paddle_tpu.incubate import optimizer as jopt
import paddle_tpu_torch as pt
from paddle_tpu_torch.convert import layer_from_jax, layer_to_numpy
from paddle_tpu_torch.incubate import asp as tasp
from paddle_tpu_torch.incubate import optimizer as topt

RTOL, ATOL = 1e-5, 1e-6
ADAM_ATOL = 1e-5
#: two bf16 ulps at the weights' scale (|w| < 0.6): the two packages'
#: bf16 products round differently, a gradient an ulp apart moves the
#: float32 master across a bf16 rounding boundary now and then
BF16_ATOL = 2.0 ** -8


@pytest.fixture(autouse=True)
def cpu_default():
    old = pt.get_device()
    pt.set_device("cpu")
    jasp.reset_excluded_layers()
    tasp.reset_excluded_layers()
    yield
    pt.set_device(old)


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.asarray(t._data if hasattr(t, "_data") else t,
                      dtype=np.float32)


def _nets(seed, dims=(16, 12, 8)):
    paddle.seed(seed)
    layers = [(dims[i], dims[i + 1]) for i in range(len(dims) - 1)]
    j = paddle.nn.Sequential(*[paddle.nn.Linear(a, b) for a, b in layers])
    t = pt.nn.Sequential(*[pt.nn.Linear(a, b) for a, b in layers])
    layer_from_jax(t, {k: _np(v) for k, v in j.state_dict().items()})
    return j, t


def _x(seed, rows=6, d=16):
    return np.random.RandomState(seed).randn(rows, d).astype(np.float32)


def _loss(net, x, mod):
    y = net(mod(x))
    return (y * y).mean()


def _step(j, t, jo, to, x):
    _loss(j, paddle.to_tensor(x), paddle.to_tensor).backward()
    jo.step()
    jo.clear_grad()
    _loss(t, torch.tensor(x).to(next(t.parameters()).dtype),
          lambda a: a).backward()
    to.step()
    to.clear_grad()


def _same_params(j, t, rtol=RTOL, atol=ATOL):
    want = {k: _np(v) for k, v in j.state_dict().items()}
    got = layer_to_numpy(t)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=rtol, atol=atol,
                                   err_msg=k)


def test_lookahead_trajectory_and_state_round_trip():
    j, t = _nets(70)
    jo = jopt.LookAhead(paddle.optimizer.AdamW(
        0.05, parameters=j.parameters(), weight_decay=0.01), alpha=0.5, k=4)
    to = topt.LookAhead(pt.optimizer.AdamW(
        0.05, parameters=t.named_parameters(), weight_decay=0.01),
        alpha=0.5, k=4)
    for i in range(9):
        _step(j, t, jo, to, _x(71 + i))
        _same_params(j, t, RTOL, ADAM_ATOL)
    state = to.state_dict()
    names = [n for n, _ in t.named_parameters()]
    assert state["@lookahead_step"] == 9 == jo.state_dict()["@lookahead_step"]
    assert sorted(k for k in state if k.endswith("_slow")) == \
        sorted(f"{n}_slow" for n in names)
    # the slow weights are the weights at the sync of step 8
    jslow = [_np(v) for k, v in jo.state_dict().items()
             if k.endswith("_slow")]
    for got, want in zip([state[f"{n}_slow"] for n in names], jslow):
        np.testing.assert_allclose(
            _np(got).T if got.dim() == 2 else _np(got), want, RTOL,
            ADAM_ATOL)
    # a new optimizer over the same parameters continues the trajectory
    to2 = topt.LookAhead(pt.optimizer.AdamW(
        0.05, parameters=t.named_parameters(), weight_decay=0.01),
        alpha=0.5, k=4)
    to2.set_state_dict(state)
    assert "@lookahead_step" in state        # the caller's dict is kept
    for i in range(3):
        _step(j, t, jo, to2, _x(90 + i))
        _same_params(j, t, RTOL, ADAM_ATOL)


def test_lookahead_sync_reaches_the_float32_master():
    j, t = _nets(72)
    j.to(dtype="bfloat16")
    t.to(dtype=torch.bfloat16)
    jinner = paddle.optimizer.SGD(0.5, parameters=j.parameters(),
                                  multi_precision=True)
    tinner = pt.optimizer.SGD(0.5, parameters=t.named_parameters(),
                              multi_precision=True)
    jo = jopt.LookAhead(jinner, alpha=0.5, k=2)
    to = topt.LookAhead(tinner, alpha=0.5, k=2)
    _step(j, t, jo, to, _x(73))
    _same_params(j, t, 0, BF16_ATOL)
    _step(j, t, jo, to, _x(74))                # step 2 syncs
    # the JAX package interpolates the bf16 weights, the port the float32
    # masters: the two round apart by an ulp more
    _same_params(j, t, 0, BF16_ATOL)
    # the JAX package: the master keeps the fast weights, off the
    # parameter it rounds to
    jp = j.parameters()[0]
    jmaster = np.asarray(jinner._slots[jp.name]["master_weight"])
    assert np.abs(jmaster - _np(jp)).max() > 1e-3
    # the port: master = slow = the parameter's value before rounding
    name, tp = next(iter(t.named_parameters()))
    tmaster = tinner._slots[name]["master_weight"]
    assert torch.equal(tmaster, to._slow[name])
    assert torch.equal(tp, tmaster.to(torch.bfloat16))
    # and the next step starts from the slow weights
    slow = {n: s.clone() for n, s in to._slow.items()}
    _loss(t, torch.tensor(_x(75)).bfloat16(), lambda a: a).backward()
    grads = {n: p.grad.clone() for n, p in t.named_parameters()}
    moments = {n: {k: v.clone() for k, v in s.items()
                   if k != "master_weight"}
               for n, s in tinner._slots.items()}
    to.step()
    ref = pt.optimizer.SGD(0.5, parameters=[
        (n, torch.nn.Parameter(slow[n].clone())) for n in slow])
    ref._slots = moments
    ref._step_count = 2
    for n, p in ref._params:
        p.grad = grads[n].float()
    ref.step()
    for n, p in ref._params:
        torch.testing.assert_close(tinner._slots[n]["master_weight"], p,
                                   rtol=1e-6, atol=1e-7)


def test_model_average_apply_and_restore():
    j, t = _nets(76)
    jsgd = paddle.optimizer.SGD(0.1, parameters=j.parameters())
    tsgd = pt.optimizer.SGD(0.1, parameters=t.named_parameters())
    jma = jopt.ModelAverage(0.15, parameters=j.parameters(),
                            min_average_window=2, max_average_window=4)
    tma = topt.ModelAverage(0.15, parameters=t.named_parameters(),
                            min_average_window=2, max_average_window=4)
    for i in range(7):
        _step(j, t, jsgd, tsgd, _x(77 + i))
        jma.step()
        tma.step()
        _same_params(j, t)
    live = {n: p.detach().clone() for n, p in t.named_parameters()}
    with jma.apply(), tma.apply():
        _same_params(j, t)
        assert not all(torch.equal(live[n], p)
                       for n, p in t.named_parameters())
    for n, p in t.named_parameters():
        assert torch.equal(live[n], p)
    _same_params(j, t)
    with tma.apply(need_restore=False):
        pass
    assert not torch.equal(live["0.weight"], t[0].weight)
    tma.restore()                             # nothing kept: a no-op


def test_asp_masks_match_and_minimize_keeps_sparsity():
    j, t = _nets(80, dims=(16, 12, 8, 2))
    jm = jasp.prune_model(j)
    tm = tasp.prune_model(t)
    assert len(jm) == len(tm) == 2            # the [8, 2] head is too small
    for jmask, (name, tmask) in zip(jm.values(), tm.items()):
        layer = t[int(name.split(".")[0])]
        np.testing.assert_array_equal(_np(tmask.t()), _np(jmask))
        assert tasp.check_sparsity(layer.weight)
        assert tasp.calculate_density(layer.weight) == 0.5
    _same_params(j, t, 0, 0)
    jo = jasp.decorate(paddle.optimizer.AdamW(0.05,
                                              parameters=j.parameters()))
    to = tasp.decorate(pt.optimizer.AdamW(0.05, parameters=t.parameters()))
    for i in range(3):
        jo.minimize(_loss(j, paddle.to_tensor(_x(81 + i)), paddle.to_tensor))
        to.minimize(_loss(t, torch.tensor(_x(81 + i)), lambda a: a))
        _same_params(j, t, RTOL, ADAM_ATOL)
        for name in tm:
            w = t[int(name.split(".")[0])].weight
            assert tasp.check_sparsity(w)
            assert tasp.check_sparsity(_np(w).T)  # the JAX layout's groups
    with pytest.raises(ValueError, match="mask_algo"):
        tasp.prune_model(t, mask_algo="mask_3d")


def test_asp_masks_stay_with_their_model():
    """Two models of one structure pruned one after the other keep their
    own masks: the first model's masked step re-applies its own pattern,
    not the second's, and zeroes nothing its mask keeps."""
    _, first = _nets(88)
    _, second = _nets(89)
    m1 = tasp.prune_model(first)
    m2 = tasp.prune_model(second)
    assert list(m1) == list(m2) == ["0.weight", "1.weight"]
    assert any(not torch.equal(m1[k], m2[k]) for k in m1)
    opt = tasp.decorate(pt.optimizer.SGD(0.5,
                                         parameters=first.parameters()))
    _loss(first, torch.tensor(_x(90)), lambda a: a).backward()
    opt.step()
    for name, mask in m1.items():
        w = first[int(name.split(".")[0])].weight
        assert torch.equal(w != 0, mask != 0)
        assert w._asp_mask is mask


def test_asp_excluded_layers_and_the_masked_master():
    j, t = _nets(84)
    tasp.set_excluded_layers(param_names=["1.weight"])
    assert list(tasp.prune_model(t)) == ["0.weight"]
    tasp.reset_excluded_layers()
    j, t = _nets(85)
    j.to(dtype="bfloat16")
    t.to(dtype=torch.bfloat16)
    jasp.prune_model(j)
    tm = tasp.prune_model(t)
    jinner = paddle.optimizer.SGD(0.5, parameters=j.parameters(),
                                  multi_precision=True)
    tinner = pt.optimizer.SGD(0.5, parameters=t.named_parameters(),
                              multi_precision=True)
    jo, to = jasp.decorate(jinner), tasp.decorate(tinner)
    for i in range(2):
        _step(j, t, jo, to, _x(86 + i))
    _same_params(j, t, 0, BF16_ATOL)
    mask = tm["0.weight"].float()
    jp = j.parameters()[0]
    jmaster = np.asarray(jinner._slots[jp.name]["master_weight"])
    # JAX: the master moves at the pruned entries; the port's stays 0
    assert np.abs(jmaster * (1 - _np(mask).T)).max() > 0
    tmaster = tinner._slots["0.weight"]["master_weight"]
    assert torch.equal(tmaster * (1 - mask), torch.zeros_like(tmaster))
    assert tasp.check_sparsity(t[0].weight)
