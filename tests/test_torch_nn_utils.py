"""``nn.utils`` of the PyTorch port against the JAX package's, on the CPU.

The port's ``Linear`` stores its weight ``[out, in]`` (the JAX package
``[in, out]``), so each function is held on a ``Linear``, where the
layouts differ, and on a ``Conv2D``, where they agree:

* ``weight_norm(dim=0)`` normalises over the JAX axes: the forward, the
  gradients of ``weight_v``/``weight_g`` (compared through
  ``convert.layer_to_numpy``, which gives ``g`` its JAX shape ``[in,
  1]``), ``dim=None`` and ``remove_weight_norm``;
* ``spectral_norm``: ``u`` drawn from ``RandomState(0)`` over the JAX
  matrix's ``dim``-th axis, the forward after one and after several
  power iterations, the gradient of ``weight_orig``;
* ``parameters_to_vector`` flattens each parameter in its JAX layout, so
  the vector equals the JAX one element for element, and
  ``vector_to_parameters`` inverts it (a length mismatch raises).

Values within 1e-5 of each result's largest magnitude.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.nn import utils as jutils
import paddle_tpu_torch as pt
from paddle_tpu_torch.convert import layer_from_jax, layer_to_numpy
from paddle_tpu_torch.nn import utils as tutils

TOL = 1e-5


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


def _close(got, want, tol=TOL):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * max(np.abs(want).max(), 1e-30))


def _pair(kind, seed=0):
    paddle.seed(seed)
    if kind == "linear":
        j, t = paddle.nn.Linear(6, 4), pt.nn.Linear(6, 4)
        x = np.random.RandomState(seed).randn(3, 6).astype(np.float32)
    else:
        j, t = paddle.nn.Conv2D(3, 4, 3), pt.nn.Conv2D(3, 4, 3)
        x = np.random.RandomState(seed).randn(2, 3, 6, 6).astype(np.float32)
    layer_from_jax(t, {k: _np(v) for k, v in j.state_dict().items()})
    return j, t, x


def _run(j, t, x):
    jx = paddle.to_tensor(x)
    jy = j(jx)
    (jy * jy).sum().backward()
    ty = t(torch.tensor(x))
    (ty * ty).sum().backward()
    return jy, ty


def _grads(j, t):
    jg = {n: _np(p.grad) for n, p in j.named_parameters()}
    tg = {n: p.grad for n, p in t.named_parameters()}
    # the port's gradients in the JAX layouts, by way of a carrier layer
    carrier = {n: p for n, p in t.named_parameters()}
    with torch.no_grad():
        saved = {n: p.detach().clone() for n, p in carrier.items()}
        for n, p in carrier.items():
            p.copy_(tg[n])
        tgj = {k: v.copy() for k, v in layer_to_numpy(t).items()}
        for n, p in carrier.items():
            p.copy_(saved[n])
    return jg, {n: tgj[n] for n in tg}


@pytest.mark.parametrize("kind", ["linear", "conv"])
@pytest.mark.parametrize("dim", [0, 1, None])
def test_weight_norm_matches_jax(kind, dim):
    j, t, x = _pair(kind, 1)
    jutils.weight_norm(j, dim=dim)
    tutils.weight_norm(t, dim=dim)
    state = layer_to_numpy(t)
    jstate = {k: _np(v) for k, v in j.state_dict().items()}
    assert set(state) == set(jstate)
    for k in jstate:
        _close(state[k], jstate[k])
    if kind == "linear" and dim == 0:
        assert tuple(t.weight_g.shape) == (1, 6)
        assert jstate["weight_g"].shape == (6, 1)
    jy, ty = _run(j, t, x)
    _close(ty, jy)
    jg, tg = _grads(j, t)
    for k in jg:
        _close(tg[k], jg[k])
    jutils.remove_weight_norm(j)
    tutils.remove_weight_norm(t)
    assert set(dict(t.named_parameters())) == {"weight", "bias"}
    _close(layer_to_numpy(t)["weight"], _np(j.weight))
    with pytest.raises(ValueError):
        tutils.remove_weight_norm(t)


@pytest.mark.parametrize("kind", ["linear", "conv"])
@pytest.mark.parametrize("dim, iters", [(None, 1), (1, 3)])
def test_spectral_norm_matches_jax(kind, dim, iters):
    j, t, x = _pair(kind, 2)
    jutils.spectral_norm(j, n_power_iterations=iters, dim=dim)
    tutils.spectral_norm(t, n_power_iterations=iters, dim=dim)
    _close(t._sn_u, _np(j._sn_u))
    for _ in range(2):
        j.clear_gradients()
        t.clear_gradients()
        jy, ty = _run(j, t, x)
        _close(ty, jy)
        _close(t._sn_u, _np(j._sn_u))
    jg, tg = _grads(j, t)
    assert set(jg) == set(tg) == {"weight_orig", "bias"}
    for k in jg:
        _close(tg[k], jg[k])


def test_parameters_to_vector_is_the_jax_vector():
    paddle.seed(3)
    jnet = paddle.nn.Sequential(paddle.nn.Linear(5, 3), paddle.nn.ReLU(),
                                paddle.nn.Conv2D(1, 2, 2),
                                paddle.nn.Linear(3, 2))
    tnet = torch.nn.Sequential(pt.nn.Linear(5, 3), pt.nn.ReLU(),
                               pt.nn.Conv2D(1, 2, 2), pt.nn.Linear(3, 2))
    layer_from_jax(tnet, {k: _np(v) for k, v in jnet.state_dict().items()})
    jv = _np(jutils.parameters_to_vector(jnet.parameters()))
    tv = tutils.parameters_to_vector(tnet.parameters())
    assert np.array_equal(tv.detach().numpy(), jv)
    new = np.arange(jv.size, dtype=np.float32)
    jutils.vector_to_parameters(paddle.to_tensor(new), jnet.parameters())
    tutils.vector_to_parameters(torch.tensor(new), tnet.parameters())
    back = layer_to_numpy(tnet)
    for k, v in jnet.state_dict().items():
        assert np.array_equal(back[k], _np(v)), k
    with pytest.raises(ValueError, match="elements"):
        tutils.vector_to_parameters(torch.zeros(3), tnet.parameters())
