"""``incubate.moe`` of the PyTorch port against the JAX package's, on the
CPU: ``MoELayer``'s output, ``l_aux`` and the gradients of the input,
the gate and the stacked experts (the weights carried by ``convert``,
the stacks ``[E, in, out]`` in JAX and ``[E, out, in]`` in the port), at
top-2 with capacity factor 1.25, at 0.5 (tokens dropped), at top-1, and
with every probability tied (zero gate: both packages send every token
to experts 0 and 1, ``lax.top_k``'s order).

float32 within rtol 1e-5 / atol 1e-6 for the outputs, rtol 1e-4 / atol
1e-5 for the gradients (sums over the tokens in another order).
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import incubate as jinc
import paddle_tpu_torch as pt
from paddle_tpu_torch import incubate as tinc
from paddle_tpu_torch.convert import layer_from_jax, layer_to_numpy

D, E, H = 16, 4, 24


@pytest.fixture(autouse=True)
def cpu_default():
    old = pt.get_device()
    pt.set_device("cpu")
    yield
    pt.set_device(old)


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().numpy()
    return np.asarray(t._data if hasattr(t, "_data") else t)


def _close(got, want, rtol=1e-5, atol=1e-6):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


def _pair(seed, **kw):
    paddle.seed(seed)
    j = jinc.MoELayer(D, num_experts=E, d_hidden=H, **kw)
    t = tinc.MoELayer(D, num_experts=E, d_hidden=H, **kw)
    layer_from_jax(t, {k: _np(v) for k, v in j.state_dict().items()})
    return j, t


def _check(j, t, x):
    jx = paddle.to_tensor(x, stop_gradient=False)
    tx = torch.tensor(x, requires_grad=True)
    jy, ty = j(jx), t(tx)
    _close(ty, jy)
    _close(t.l_aux, j.l_aux)
    ((jy * jy).sum() + j.l_aux).backward()
    ((ty * ty).sum() + t.l_aux).backward()
    _close(tx.grad, jx.grad, 1e-4, 1e-5)
    want = {n: _np(p.grad) for n, p in j.named_parameters()}
    t.l_aux = None
    with torch.no_grad():
        for p in t.parameters():
            p.copy_(p.grad)
    got = layer_to_numpy(t)
    assert set(got) == set(want)
    for n in want:
        _close(got[n], want[n], 1e-4, 1e-5)
    return ty


def _tokens(seed, b=2, length=12):
    return np.random.RandomState(seed).randn(b, length, D).astype(
        np.float32)


@pytest.mark.parametrize("topk, factor", [(2, 1.25), (2, 0.5), (1, 1.0)])
def test_moe_output_aux_loss_and_gradients(topk, factor):
    j, t = _pair(60 + topk, topk=topk, capacity_factor=factor)
    x = _tokens(61)
    if factor < 1:
        # the capacity is ceil(24 / 4 * 0.5) = 3 slots an expert: fewer
        # than the 48 choices, so tokens are dropped
        probs = torch.softmax(t.gate(torch.tensor(x).reshape(-1, D)), -1)
        dispatch = t._route(probs.detach(), 3)[0]
        assert dispatch.sum() < 24 * topk
    _check(j, t, x)


def test_tied_probabilities_route_to_the_lower_experts():
    j, t = _pair(62)
    for layer in (j, t):
        for p in layer.gate.parameters():
            if isinstance(p, torch.Tensor):
                with torch.no_grad():
                    p.zero_()
            else:
                p._data = p._data * 0
    x = _tokens(63, length=4)
    probs = torch.softmax(t.gate(torch.tensor(x).reshape(-1, D)), -1)
    assert torch.equal(tinc.moe.top_k(probs, 2)[1],
                       torch.tensor([[0, 1]] * 8))
    _check(j, t, x)


def test_given_experts_are_stacked_with_their_layout_mark():
    paddle.seed(64)
    jexp = [jinc.moe.ExpertMLP(D, H) for _ in range(3)]
    texp = [tinc.moe.ExpertMLP(D, H) for _ in range(3)]
    for a, b in zip(jexp, texp):
        layer_from_jax(b, {k: _np(v) for k, v in a.state_dict().items()})
    j = jinc.MoELayer(D, experts=jexp, topk=2)
    t = tinc.MoELayer(D, experts=texp, topk=2)
    assert tuple(t.expert_fc1_weight.shape) == (3, H, D)
    assert t.expert_fc1_weight._jax_perm == (0, 2, 1)
    state = layer_to_numpy(t)
    for k in ("expert_fc1_weight", "expert_fc2_weight", "expert_fc1_bias"):
        np.testing.assert_array_equal(state[k], _np(getattr(j, k)))
    assert not any(p is texp[0].fc1.weight for p in t.parameters())
    layer_from_jax(t, {k: _np(v) for k, v in j.state_dict().items()})
    _check(j, t, _tokens(65, length=6))
    with pytest.raises(NotImplementedError, match="Queue 1 item 4"):
        tinc.MoELayer(D, num_experts=2, d_hidden=H, group=object())
    with pytest.raises(ValueError, match="num_experts"):
        tinc.MoELayer(D)
