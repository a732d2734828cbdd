"""The port's ``autograd`` against the JAX package's, on the CPU.

* ``grad`` of a 2-layer GPT-2-tiny's loss (float32, weights carried
  across with ``convert``) against the JAX ``grad``: every parameter's
  gradient within 1e-5 of that tensor's largest (the two frameworks sum
  in other orders), but the attention key biases', whose true gradient
  is 0 (a constant per softmax row): there both sides are rounding noise,
  held below 1e-5 of the largest gradient; ``.grad`` is left as it was, ``allow_unused`` and
  ``create_graph`` act as in torch;
* ``PyLayer`` forward and backward against the JAX ``PyLayer``, with
  keyword and non-tensor arguments and a ``None`` gradient;
* ``jacobian``, ``hessian``, ``vjp`` and ``jvp`` of small functions
  against the JAX ones at atol 1e-5 in float32, with the same nesting;
* the flash attention and LayerNorm functions have no double backward:
  ``hessian``, ``jvp`` and ``create_graph=True`` through them raise.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu_torch as pt
from paddle_tpu import autograd as jag
from paddle_tpu.models import GPTConfig as JaxGPTConfig
from paddle_tpu.models import GPTForPretraining as JaxGPT
from paddle_tpu.nn.layer.layers import get_params_tree
from paddle_tpu_torch import autograd as ag
from paddle_tpu_torch.convert import _linear_keys, gpt_from_jax_params
from paddle_tpu_torch.models import GPTConfig

ATOL = 1e-5


def _gpt_pair(seed=0):
    paddle.seed(seed)
    jnet = JaxGPT(JaxGPTConfig.tiny(), lm_loss_chunks=2)
    params = {k: np.asarray(v) for k, v in get_params_tree(jnet).items()}
    tnet = gpt_from_jax_params(params, GPTConfig.tiny(), device="cpu",
                               lm_loss_chunks=2)
    return jnet, tnet


def _batch(seed=1, batch=2, seq=16):
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, JaxGPTConfig.tiny().vocab_size, (batch, seq))
    labels = np.concatenate([ids[:, 1:], np.full((batch, 1), -100)], 1)
    return ids.astype(np.int64), labels.astype(np.int64)


def test_grad_of_gpt_tiny_matches_the_jax_grad():
    jnet, tnet = _gpt_pair()
    ids, labels = _batch()
    jparams = dict(jnet.named_parameters())
    jloss, _ = jnet(paddle.to_tensor(ids), paddle.to_tensor(labels))
    jgrads = dict(zip(jparams, jag.grad(jloss, list(jparams.values()))))
    tparams = dict(tnet.named_parameters())
    marker = torch.full_like(tparams["gpt.wte.weight"], 7.0)
    tparams["gpt.wte.weight"].grad = marker
    tloss, _ = tnet(torch.from_numpy(ids), torch.from_numpy(labels))
    tgrads = dict(zip(tparams, pt.grad(tloss, list(tparams.values()))))
    assert tparams["gpt.wte.weight"].grad is marker
    assert all(p.grad is None for n, p in tparams.items()
               if n != "gpt.wte.weight")
    np.testing.assert_allclose(tloss.item(), float(jloss), atol=ATOL)
    linear = _linear_keys(tnet)
    assert set(tgrads) == set(jgrads)
    largest = max(np.abs(np.asarray(g.numpy())).max()
                  for g in jgrads.values())
    for name, g in tgrads.items():
        want = np.asarray(jgrads[name].numpy())
        got = g.numpy().T if name in linear else g.numpy()
        if name.endswith("k_proj.bias"):
            # its true gradient is 0 (a constant per softmax row): both
            # sides are rounding noise far below every other gradient
            assert max(np.abs(got).max(), np.abs(want).max()) < \
                ATOL * largest, name
            continue
        scale = max(np.abs(want).max(), 1e-30)
        np.testing.assert_allclose(got, want, atol=ATOL * scale, rtol=0,
                                   err_msg=name)


def test_grad_options():
    x = torch.tensor([1.0, 2.0], requires_grad=True)
    y = torch.tensor([3.0], requires_grad=True)
    out = (x ** 3).sum()
    (g,) = ag.grad(out, x)                        # the graph is kept
    assert g.tolist() == [3.0, 12.0] and x.grad is None
    with pytest.raises(RuntimeError):
        ag.grad(out, [x, y])
    gx, gy = ag.grad(out, [x, y], allow_unused=True)
    assert gy is None and torch.equal(gx, g)
    (g2,) = ag.grad(out, x, create_graph=True)
    (h,) = ag.grad(g2.sum(), x)
    assert h.tolist() == [6.0, 12.0]
    with pytest.raises(NotImplementedError, match="Queue 1 item 5"):
        ag.grad(out, x, no_grad_vars=[y])
    assert pt.grad is ag.grad


def test_backward_accumulates_like_the_jax_one():
    xs = np.array([1.0, -2.0, 0.5], np.float32)
    tx = torch.tensor(xs, requires_grad=True)
    jx = paddle.to_tensor(xs, stop_gradient=False)
    ag.backward([tx * tx, tx.sum()], [torch.ones(3), torch.tensor(2.0)])
    jag.backward([jx * jx, jx.sum()],
                 [paddle.to_tensor(np.ones(3, np.float32)),
                  paddle.to_tensor(np.float32(2.0))])
    np.testing.assert_allclose(tx.grad.numpy(), jx.grad.numpy(), atol=ATOL)


def _layers():
    class PortTanh(ag.PyLayer):
        @staticmethod
        def forward(ctx, x, w, scale=1.0):
            y = torch.tanh(x) * scale
            ctx.save_for_backward(y)
            ctx.scale = scale
            return y * w

        @staticmethod
        def backward(ctx, dy):
            (y,) = ctx.saved_tensor()
            return dy * (ctx.scale - y * y / ctx.scale), None

    class JaxTanh(jag.PyLayer):
        @staticmethod
        def forward(ctx, x, w, scale=1.0):
            y = paddle.tanh(x) * scale
            ctx.save_for_backward(y)
            ctx.scale = scale
            return y * w

        @staticmethod
        def backward(ctx, dy):
            (y,) = ctx.saved_tensor()
            return dy * (ctx.scale - y * y / ctx.scale), None

    return PortTanh, JaxTanh


def test_py_layer_matches_the_jax_one():
    port, ref = _layers()
    xs = np.random.RandomState(3).randn(4, 3).astype(np.float32)
    ws = np.random.RandomState(4).randn(4, 3).astype(np.float32)
    tx = torch.tensor(xs, requires_grad=True)
    tw = torch.tensor(ws, requires_grad=True)
    jx = paddle.to_tensor(xs, stop_gradient=False)
    jw = paddle.to_tensor(ws, stop_gradient=False)
    ty = port.apply(tx, tw, scale=2.0)
    jy = ref.apply(jx, jw, scale=2.0)
    np.testing.assert_allclose(ty.detach().numpy(), jy.numpy(), atol=ATOL)
    (ty * ty).sum().backward()
    (jy * jy).sum().backward()
    np.testing.assert_allclose(tx.grad.numpy(), jx.grad.numpy(), atol=ATOL)
    assert tw.grad is None                        # its gradient is None
    with torch.no_grad():
        assert not port.apply(tx, tw).requires_grad


def _funcs(mod):
    tanh, exp = (torch.tanh, torch.exp) if mod is torch else \
        (paddle.tanh, paddle.exp)
    return {
        "one": (lambda x: tanh(x) * x.sum(), 1),
        "two": (lambda x, y: (x * y, exp(x) * y.sum()), 2),
    }


def _close(got, want):
    """Equal nesting (lists and tuples alike), each leaf within ATOL."""
    if isinstance(want, (list, tuple)):
        assert isinstance(got, (list, tuple)) and len(got) == len(want)
        for g, w in zip(got, want):
            _close(g, w)
    else:
        got = got.detach().numpy()
        want = np.asarray(want.numpy())
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def _args(n, seed=5):
    rng = np.random.RandomState(seed)
    arrays = [rng.randn(3).astype(np.float32) for _ in range(n)]
    return ([torch.tensor(a) for a in arrays],
            [paddle.to_tensor(a) for a in arrays])


@pytest.mark.parametrize("name", ["one", "two"])
def test_jacobian_vjp_jvp_match_the_jax_ones(name):
    (tf, n), (jf, _) = _funcs(torch)[name], _funcs(paddle)[name]
    tx, jx = _args(n)
    t_in, j_in = (tx[0], jx[0]) if n == 1 else (tx, jx)
    _close(ag.jacobian(tf, t_in), jag.jacobian(jf, j_in))
    _close(ag.vjp(tf, t_in), jag.vjp(jf, j_in))
    _close(ag.jvp(tf, t_in), jag.jvp(jf, j_in))
    tv, jv = _args(n, seed=6)
    t_v, j_v = (tv[0], jv[0]) if n == 1 else (tv, jv)
    _close(ag.jvp(tf, t_in, t_v), jag.jvp(jf, j_in, j_v))
    tcot = [torch.full((3,), 0.5)] * (1 if n == 1 else 2)
    jcot = [paddle.to_tensor(np.full((3,), 0.5, np.float32))] * len(tcot)
    _close(ag.vjp(tf, t_in, tcot), jag.vjp(jf, j_in, jcot))


@pytest.mark.parametrize("n", [1, 2])
def test_hessian_matches_the_jax_one(n):
    def f(mod):
        def fn(*xs):
            s = (xs[0] ** 3).sum() + xs[0][0] * xs[0][1]
            return s + (xs[0] * xs[1]).sum() if len(xs) > 1 else s
        return fn

    tx, jx = _args(n)
    t_in, j_in = (tx[0], jx[0]) if n == 1 else (tx, jx)
    _close(ag.hessian(f(torch), t_in), jag.hessian(f(paddle), j_in))


def test_differentiable_apply():
    x = torch.tensor([1.0, 2.0], requires_grad=True)
    a, b = ag.differentiable_apply(lambda t: [t * 2, t.sum()], x)
    b.backward()
    assert a.requires_grad and x.grad.tolist() == [1.0, 1.0]
    with torch.no_grad():
        assert not ag.differentiable_apply(torch.exp, x).requires_grad


def _flash(q):
    from paddle_tpu_torch.ops.flash_attention import flash_attention
    k = torch.randn(1, 8, 2, 16, generator=torch.Generator().manual_seed(1))
    return flash_attention(q, k, k, is_causal=True).sum()


def _layer_norm(x):
    from paddle_tpu_torch.ops.layer_norm import layer_norm
    return (layer_norm(x, torch.ones(16), torch.zeros(16)) ** 2).sum()


@pytest.mark.parametrize("fn", [_flash, _layer_norm], ids=["flash",
                                                            "layer_norm"])
def test_no_double_backward_through_the_kernels(fn):
    shape = (1, 8, 2, 16) if fn is _flash else (4, 16)
    x = torch.randn(*shape, generator=torch.Generator().manual_seed(0))
    assert ag.grad(fn(x.requires_grad_()), x)[0].shape == x.shape
    with pytest.raises(RuntimeError, match="no double backward"):
        ag.hessian(fn, x.detach())
    with pytest.raises(RuntimeError, match="no double backward"):
        ag.grad(fn(x), x, create_graph=True)
    with pytest.raises(RuntimeError, match="no double backward"):
        ag.jvp(fn, x.detach())
