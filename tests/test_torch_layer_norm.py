"""Fused LayerNorm of the PyTorch port (paddle_tpu_torch/ops/layer_norm.py)
against the JAX package's Pallas kernels (interpret mode on the CPU): the
forward, and the backward through ``jax.grad`` of ``fused_layer_norm``.

On the CPU the port's wrapper runs its plain version; the CUDA kernel
itself is checked on the card by chip_smoke.py and tests/test_torch_cuda.py.
Tolerances: float32 atol 1e-5 (the same f32 statistics in another
summation order); the backward's dw/db, sums over every row, atol 1e-4.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.ops import pallas_kernels as pk
from paddle_tpu_torch import amp
from paddle_tpu_torch.nn import LayerNorm
from paddle_tpu_torch.ops.layer_norm import (fused_layer_norm,
                                             fused_layer_norm_bwd, layer_norm,
                                             layer_norm_plain)

ATOL = 1e-5


def _inputs(seed, shape, d):
    rng = np.random.RandomState(seed)
    return (rng.randn(*shape, d).astype(np.float32),
            (1 + 0.1 * rng.randn(d)).astype(np.float32),
            (0.1 * rng.randn(d)).astype(np.float32))


@pytest.mark.parametrize("shape,d", [((8,), 64), ((6, 128), 64),
                                     ((2, 16), 768)])
def test_plain_matches_jax_kernel(shape, d):
    x, w, b = _inputs(0, shape, d)
    ref = np.asarray(pk.fused_layer_norm(jnp.asarray(x), jnp.asarray(w),
                                         jnp.asarray(b)))
    got = fused_layer_norm(torch.from_numpy(x), torch.from_numpy(w),
                           torch.from_numpy(b))
    assert got.dtype == torch.float32 and tuple(got.shape) == x.shape
    np.testing.assert_allclose(got.numpy(), ref, atol=ATOL, rtol=0)


def test_any_row_count_and_epsilon():
    """Rows need not divide any block (the JAX kernel's VMEM limit), and
    epsilon reaches the statistics."""
    x, w, b = _inputs(1, (13,), 32)
    xt, wt, bt = map(torch.from_numpy, (x, w, b))
    np.testing.assert_allclose(
        fused_layer_norm(xt, wt, bt, 1e-2).numpy(),
        torch.nn.functional.layer_norm(xt, (32,), wt, bt, 1e-2).numpy(),
        atol=ATOL, rtol=0)


def test_bfloat16_stays_in_dtype():
    x, w, b = _inputs(2, (4,), 64)
    xt, wt, bt = (torch.from_numpy(a).to(torch.bfloat16) for a in (x, w, b))
    got = fused_layer_norm(xt, wt, bt)
    assert got.dtype == torch.bfloat16
    ref = layer_norm_plain(xt.float(), wt.float(), bt.float())
    np.testing.assert_allclose(got.float().numpy(), ref.numpy(),
                               atol=2e-2, rtol=1e-2)


def test_cpu_tensors_take_the_plain_version_without_counting():
    before = fused_layer_norm.launches
    x, w, b = map(torch.from_numpy, _inputs(3, (2,), 16))
    fused_layer_norm(x, w, b)
    assert fused_layer_norm.launches == before


def test_rejects_mismatched_affine_shape():
    x, w, b = map(torch.from_numpy, _inputs(4, (2,), 16))
    with pytest.raises(ValueError, match="normalize the last axis"):
        fused_layer_norm(x, w[:8], b)


def test_layer_norm_module_matches_jax_layer():
    x, w, b = _inputs(5, (3, 5), 48)
    ref_ln = paddle.nn.LayerNorm(48)
    ref_ln.set_state_dict({"weight": w, "bias": b})
    ref = ref_ln(paddle.to_tensor(x)).numpy()
    ln = LayerNorm(48)
    with torch.no_grad():
        ln.weight.copy_(torch.from_numpy(w))
        ln.bias.copy_(torch.from_numpy(b))
        got = ln(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=0)
    with pytest.raises(ValueError, match="last axis only"):
        LayerNorm([4, 48])


@pytest.mark.parametrize("shape,d", [((8,), 64), ((2, 128), 96)])
def test_backward_matches_jax_grad(shape, d):
    x, w, b = _inputs(6, shape, d)
    g = np.random.RandomState(7).randn(*shape, d).astype(np.float32)

    def loss(x_, w_, b_):
        return jnp.sum(pk.fused_layer_norm(x_, w_, b_) * g)

    want = jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray, (x, w, b)))
    got = fused_layer_norm_bwd(*map(torch.from_numpy, (x, w, g)))
    for name, t, ref in zip(("dx", "dw", "db"), got, want):
        assert t.dtype == torch.float32 and t.shape == ref.shape, name
        np.testing.assert_allclose(t.numpy(), np.asarray(ref),
                                   atol=ATOL if name == "dx" else 1e-4,
                                   rtol=0, err_msg=name)


def test_autograd_runs_the_backward_and_no_grad_only_the_forward():
    x, w, b = _inputs(8, (5,), 32)
    g = np.random.RandomState(9).randn(5, 32).astype(np.float32)
    xt, wt, bt = (torch.from_numpy(a).requires_grad_() for a in (x, w, b))
    out = layer_norm(xt, wt, bt)
    assert out.grad_fn is not None
    out.backward(torch.from_numpy(g))
    ref = [t.clone().requires_grad_() for t in map(torch.from_numpy,
                                                   (x, w, b))]
    torch.nn.functional.layer_norm(ref[0], (32,), ref[1], ref[2]).backward(
        torch.from_numpy(g))
    for t, r in zip((xt, wt, bt), ref):
        np.testing.assert_allclose(t.grad.numpy(), r.grad.numpy(),
                                   atol=ATOL, rtol=0)
    with torch.no_grad():
        assert layer_norm(xt, wt, bt).grad_fn is None


def test_bfloat16_backward_stays_in_dtype():
    x, w, _ = _inputs(10, (6,), 64)
    g = np.random.RandomState(11).randn(6, 64).astype(np.float32)
    xb, wb, gb = (torch.from_numpy(a).to(torch.bfloat16) for a in (x, w, g))
    got = fused_layer_norm_bwd(xb, wb, gb)
    assert all(t.dtype == torch.bfloat16 for t in got)
    ref = fused_layer_norm_bwd(xb.float(), wb.float(), gb.float())
    for t, r in zip(got, ref):
        np.testing.assert_allclose(t.float().numpy(), r.numpy(),
                                   atol=2e-2, rtol=1e-2)


def test_layer_norm_runs_in_float32_under_o2():
    """``layer_norm`` is on the AMP black list: bf16 x, weight and bias are
    cast to f32, so the kernels run in f32 and the output is f32."""
    x, w, b = _inputs(12, (4,), 32)
    ln = LayerNorm(32).to(torch.bfloat16)
    with torch.no_grad():
        ln.weight.copy_(torch.from_numpy(w))
        ln.bias.copy_(torch.from_numpy(b))
    xb = torch.from_numpy(x).to(torch.bfloat16)
    with amp.auto_cast(level="O2"):
        out = ln(xb)
    assert out.dtype == torch.float32
    want = layer_norm_plain(xb.float(), ln.weight.float(), ln.bias.float())
    np.testing.assert_allclose(out.detach().numpy(), want.detach().numpy(),
                               atol=ATOL, rtol=0)
    assert ln(xb).dtype == torch.bfloat16
