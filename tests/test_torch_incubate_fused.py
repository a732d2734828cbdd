"""``incubate.nn`` of the PyTorch port against the JAX package's, on the
CPU: the functional forms and each fused layer (forward and gradients,
the weights carried by ``convert``). ``FusedMultiTransformer`` and the
CacheKV attention are in ``test_torch_incubate_cachekv.py``.

Inputs from ``numpy.random.RandomState``; dropout off (the two packages'
random streams differ). float32 within rtol 1e-5 / atol 1e-6, except
where a test says otherwise.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import incubate as jinc
import paddle_tpu_torch as pt
from paddle_tpu_torch import incubate as tinc
from paddle_tpu_torch.convert import layer_from_jax, layer_to_numpy

RTOL, ATOL = 1e-5, 1e-6


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


def _close(got, want, rtol=RTOL, atol=ATOL):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


def _carry(jlayer, tlayer):
    layer_from_jax(tlayer, {k: _np(v) for k, v in
                            jlayer.state_dict().items()})
    return jlayer, tlayer


def _rand(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _grads_close(jlayer, tlayer, rtol=1e-4, atol=1e-5):
    """The port's gradients in the JAX layouts (carried through the
    parameters by ``layer_to_numpy``) against the JAX ones."""
    want = {n: _np(p.grad) for n, p in jlayer.named_parameters()}
    live = [p.detach().clone() for p in tlayer.parameters()]
    with torch.no_grad():
        for p in tlayer.parameters():
            p.copy_(p.grad)
        got = layer_to_numpy(tlayer)
        for p, v in zip(tlayer.parameters(), live):
            p.copy_(v)
    assert set(got) == set(want)
    for n in want:
        _close(got[n], want[n], rtol, atol)


def _run_both(jlayer, tlayer, *arrays, **kw):
    jx = [paddle.to_tensor(a, stop_gradient=False) for a in arrays]
    tx = [torch.tensor(a, requires_grad=True) for a in arrays]
    jy, ty = jlayer(*jx, **kw), tlayer(*tx, **kw)
    (jy * jy).sum().backward()
    (ty * ty).sum().backward()
    return jx, tx, jy, ty


# -- the functional forms ------------------------------------------------------

def test_fused_matmul_bias_and_linear():
    x, w, b = _rand(0, 3, 4, 6), _rand(1, 6, 5), _rand(2, 5)
    jF, tF = jinc.nn.functional, tinc.nn.functional
    J = paddle.to_tensor
    _close(tF.fused_matmul_bias(torch.tensor(x), torch.tensor(w),
                                torch.tensor(b)),
           jF.fused_matmul_bias(J(x), J(w), J(b)))
    wt = np.ascontiguousarray(w.T)
    _close(tF.fused_linear(torch.tensor(x), torch.tensor(wt),
                           transpose_weight=True),
           jF.fused_linear(J(x), J(wt), transpose_weight=True))


def test_fused_bias_dropout_residual_layer_norm():
    x, r, b = _rand(3, 2, 5, 8), _rand(4, 2, 5, 8), _rand(5, 8)
    s, c = 1 + _rand(6, 8) * 0.1, _rand(7, 8)
    J = paddle.to_tensor
    _close(tinc.nn.functional.fused_bias_dropout_residual_layer_norm(
               *map(torch.tensor, (x, r, b, s, c)), dropout_rate=0.0),
           jinc.nn.functional.fused_bias_dropout_residual_layer_norm(
               *map(J, (x, r, b, s, c)), dropout_rate=0.0))


@pytest.mark.parametrize("pre", [False, True])
def test_fused_multi_head_attention_functional(pre):
    d, h = 16, 4
    x = _rand(8, 2, 5, d)
    qkv_w, qkv_b = _rand(9, 3, h, d // h, d) * 0.3, _rand(10, 3, h, d // h)
    lin_w, lin_b = _rand(11, d, d) * 0.3, _rand(12, d)
    s, c = 1 + _rand(13, d) * 0.1, _rand(14, d) * 0.1
    args = (x, qkv_w, lin_w)
    kw = dict(pre_layer_norm=pre, qkv_bias=qkv_b, linear_bias=lin_b,
              dropout_rate=0.0, attn_dropout_rate=0.0)
    kw.update(dict(pre_ln_scale=s, pre_ln_bias=c) if pre
              else dict(ln_scale=s, ln_bias=c))
    J = paddle.to_tensor
    jy = jinc.nn.functional.fused_multi_head_attention(
        *map(J, args), **{k: J(v) if isinstance(v, np.ndarray) else v
                          for k, v in kw.items()})
    ty = tinc.nn.functional.fused_multi_head_attention(
        *map(torch.tensor, args),
        **{k: torch.tensor(v) if isinstance(v, np.ndarray) else v
           for k, v in kw.items()})
    _close(ty, jy)
    with pytest.raises(NotImplementedError, match="cache_kv"):
        tinc.nn.functional.fused_multi_head_attention(
            torch.tensor(x), torch.tensor(qkv_w), torch.tensor(lin_w),
            cache_kv=torch.zeros(1))
    with pytest.raises(NotImplementedError, match="Queue 1 item 4"):
        tinc.nn.functional.fused_multi_head_attention(
            torch.tensor(x), torch.tensor(qkv_w), torch.tensor(lin_w),
            ring_id=0)


@pytest.mark.parametrize("pre", [False, True])
def test_fused_feedforward_functional(pre):
    d, f = 8, 12
    arrays = dict(x=_rand(15, 2, 3, d), linear1_weight=_rand(16, d, f),
                  linear2_weight=_rand(17, f, d), linear1_bias=_rand(18, f),
                  linear2_bias=_rand(19, d), ln1_scale=1 + _rand(20, d),
                  ln1_bias=_rand(21, d), ln2_scale=1 + _rand(22, d),
                  ln2_bias=_rand(23, d))
    kw = dict(dropout1_rate=0.0, dropout2_rate=0.0, activation="gelu",
              pre_layer_norm=pre)
    jy = jinc.nn.functional.fused_feedforward(
        **{k: paddle.to_tensor(v) for k, v in arrays.items()}, **kw)
    ty = tinc.nn.functional.fused_feedforward(
        **{k: torch.tensor(v) for k, v in arrays.items()}, **kw)
    _close(ty, jy)


# -- the layers -------------------------------------------------------------------

@pytest.mark.parametrize("pre", [False, True])
def test_fused_multi_head_attention_layer(pre):
    paddle.seed(30)
    j, t = _carry(*(m.nn.FusedMultiHeadAttention(
        16, 4, dropout_rate=0.0, attn_dropout_rate=0.0,
        normalize_before=pre) for m in (jinc, tinc)))
    mask = np.where(np.tril(np.ones((5, 5), bool)), 0.0, -1e9).astype(
        np.float32).reshape(1, 1, 5, 5)
    jx, tx, jy, ty = _run_both(j, t, _rand(31, 2, 5, 16))
    _close(ty, jy)
    _close(tx[0].grad, jx[0].grad, 1e-4, 1e-5)
    _grads_close(j, t)
    _close(t(torch.tensor(_rand(32, 2, 5, 16)),
             attn_mask=torch.tensor(mask)),
           j(paddle.to_tensor(_rand(32, 2, 5, 16)),
             attn_mask=paddle.to_tensor(mask)))


def test_fused_feedforward_and_encoder_layer():
    paddle.seed(33)
    j, t = _carry(*(m.nn.FusedFeedForward(8, 16, dropout_rate=0.0,
                                          activation="gelu")
                    for m in (jinc, tinc)))
    jx, tx, jy, ty = _run_both(j, t, _rand(34, 2, 3, 8))
    _close(ty, jy)
    _grads_close(j, t)
    with pytest.raises(ValueError, match="unknown activation"):
        tinc.nn.FusedFeedForward(8, 16, activation="no_such_act")
    paddle.seed(35)
    j, t = _carry(*(m.nn.FusedTransformerEncoderLayer(
        16, 4, 32, dropout_rate=0.0, activation="gelu")
        for m in (jinc, tinc)))
    assert sorted(t.state_dict()) == sorted(j.state_dict())
    jx, tx, jy, ty = _run_both(j, t, _rand(36, 2, 6, 16))
    _close(ty, jy)
    _close(tx[0].grad, jx[0].grad, 1e-4, 1e-5)
    _grads_close(j, t)


def test_fused_linear_keeps_the_paddle_weight_shape():
    for tw in (False, True):
        paddle.seed(37)
        j, t = _carry(*(m.nn.FusedLinear(6, 4, transpose_weight=tw)
                        for m in (jinc, tinc)))
        assert tuple(t.weight.shape) == ((4, 6) if tw else (6, 4))
        np.testing.assert_array_equal(layer_to_numpy(t)["weight"],
                                      _np(j.weight))
        jx, tx, jy, ty = _run_both(j, t, _rand(38, 3, 6))
        _close(ty, jy)
        _grads_close(j, t)


def test_fused_bias_dropout_residual_layer_norm_layer():
    paddle.seed(39)
    j, t = _carry(*(m.nn.FusedBiasDropoutResidualLayerNorm(
        8, dropout_rate=0.0) for m in (jinc, tinc)))
    jx, tx, jy, ty = _run_both(j, t, _rand(40, 2, 3, 8), _rand(41, 2, 3, 8))
    _close(ty, jy)
    _grads_close(j, t)
