"""Fused LayerNorm of the PyTorch port (paddle_tpu_torch/ops/layer_norm.py)
against the JAX package's Pallas kernel (interpret mode on the CPU).

On the CPU the port's wrapper runs its plain version; the CUDA kernel
itself is checked on the card by chip_smoke.py and tests/test_torch_cuda.py.
Tolerances: float32 atol 1e-5 (the same f32 statistics in another
summation order).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.ops import pallas_kernels as pk
from paddle_tpu_torch.nn import LayerNorm
from paddle_tpu_torch.ops.layer_norm import (fused_layer_norm,
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
