"""The LayerNorm forward (K2) and flash attention forward (K4) as
``torch.library`` custom ops, on the CPU.

``paddle_tpu_torch::fused_layer_norm`` and ``::flash_attention_fwd``
carry three parts each: a fake (shapes and dtypes only, the ``[B, H,
Sq]`` float32 ``lse`` of K4 among them), the plain version for CPU
tensors and the kernel for CUDA tensors (on the card only; the card
tests launch it). ``torch.library.opcheck`` holds each fake to the plain
version here: schema, fake tensor, autograd registration and the
dynamic-shape trace. A trace (``torch.export``) records the op, runs the
fake, launches nothing and counts nothing; the wrappers route through
the ops and keep their results equal to the plain versions; the
JAX-package kernels (interpret mode under ``FLAGS_pallas_force``) agree
with the op on the same inputs within the float32 tolerance of the
kernel tests.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.ops import pallas_kernels as pk
from paddle_tpu_torch.framework.static_capture import export_scope
from paddle_tpu_torch.ops import flash_attention as fa
from paddle_tpu_torch.ops import layer_norm as ln

LN_OP = torch.ops.paddle_tpu_torch.fused_layer_norm.default
FA_OP = torch.ops.paddle_tpu_torch.flash_attention_fwd.default
#: float32 kernel against its JAX counterpart (the kernel tests' bound)
TOL = 1e-5


def _rand(rs, *shape, dtype=torch.float32):
    return torch.from_numpy(rs.randn(*shape).astype(np.float32)).to(dtype)


@pytest.mark.parametrize("shape,dtype", [((6, 64), torch.float32),
                                         ((2, 5, 768), torch.float32),
                                         ((3, 7, 32), torch.bfloat16),
                                         ((0, 16), torch.float32)])
def test_opcheck_layer_norm(shape, dtype):
    rs = np.random.RandomState(0)
    d = shape[-1]
    args = (_rand(rs, *shape, dtype=dtype), _rand(rs, d, dtype=dtype),
            _rand(rs, d, dtype=dtype), 1e-5)
    torch.library.opcheck(LN_OP, args)


@pytest.mark.parametrize("shape,causal,dtype", [
    ((2, 9, 3, 16), False, torch.float32),
    ((1, 12, 2, 64), True, torch.float32),
    ((2, 8, 4, 64), False, torch.bfloat16)])
def test_opcheck_flash_attention(shape, causal, dtype):
    rs = np.random.RandomState(1)
    q, k, v = (_rand(rs, *shape, dtype=dtype) for _ in range(3))
    torch.library.opcheck(FA_OP, (q, k, v, causal, 0.125))


def test_the_fakes_give_the_kernels_shapes_and_dtypes():
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        x = torch.empty(4, 5, 32, dtype=torch.bfloat16)
        w = torch.empty(32, dtype=torch.bfloat16)
        y = LN_OP(x, w, w, 1e-5)
        q = torch.empty(3, 7, 2, 16, dtype=torch.bfloat16)
        o, lse = FA_OP(q, q, q, False, 0.25)
    assert (tuple(y.shape), y.dtype) == ((4, 5, 32), torch.bfloat16)
    assert (tuple(o.shape), o.dtype) == ((3, 7, 2, 16), torch.bfloat16)
    assert (tuple(lse.shape), lse.dtype) == ((3, 2, 7), torch.float32)


def test_the_wrappers_route_through_the_ops_and_equal_the_plain_versions():
    rs = np.random.RandomState(2)
    x, w, b = _rand(rs, 5, 48), _rand(rs, 48), _rand(rs, 48)
    torch.testing.assert_close(ln.fused_layer_norm(x, w, b),
                               ln.layer_norm_plain(x, w, b), rtol=0, atol=0)
    q, k, v = (_rand(rs, 2, 6, 3, 16) for _ in range(3))
    for got, want in zip(fa.flash_attention_fwd(q, k, v, True),
                         fa.flash_attention_fwd_plain(q, k, v, True)):
        torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_a_trace_records_the_ops_and_launches_nothing():
    class Block(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.w = torch.nn.Parameter(torch.ones(16))
            self.b = torch.nn.Parameter(torch.zeros(16))

        def forward(self, x):
            h = ln.layer_norm(x, self.w, self.b)
            q = h.reshape(x.shape[0], x.shape[1], 2, 8)
            return fa.flash_attention(q, q, q)

    counts = [(f, f.launches) for f in (ln.fused_layer_norm,
                                        fa.flash_attention_fwd)]
    with torch.no_grad(), export_scope():
        ep = torch.export.export(Block(), (torch.ones(2, 5, 16),))
    targets = {str(n.target) for n in ep.graph.nodes
               if n.op == "call_function"}
    assert "paddle_tpu_torch.fused_layer_norm.default" in targets
    assert "paddle_tpu_torch.flash_attention_fwd.default" in targets
    assert [(f, f.launches) for f, _ in counts] == counts


def test_the_ops_hold_the_jax_kernels_values():
    """The ops' CPU versions against the JAX package's Pallas kernels in
    interpret mode, float32, on the same inputs."""
    from paddle_tpu.framework.flags import set_flags
    rs = np.random.RandomState(3)
    x, w, b = (rs.randn(*s).astype(np.float32) for s in ((16, 128), (128,),
                                                          (128,)))
    q, k, v = (rs.randn(1, 128, 2, 64).astype(np.float32) for _ in range(3))
    set_flags({"FLAGS_pallas_force": True})
    try:
        jy = np.asarray(pk.fused_layer_norm(x, w, b, 1e-5))
        jo = np.asarray(paddle.nn.functional.scaled_dot_product_attention(
            paddle.to_tensor(q), paddle.to_tensor(k), paddle.to_tensor(v),
            is_causal=True).numpy())
    finally:
        set_flags({"FLAGS_pallas_force": False})
    ty = LN_OP(*(torch.from_numpy(a) for a in (x, w, b)), 1e-5).numpy()
    to, _ = FA_OP(*(torch.from_numpy(a) for a in (q, k, v)), True,
                  1.0 / 8.0)
    np.testing.assert_allclose(ty, jy, rtol=0, atol=TOL * np.abs(jy).max())
    np.testing.assert_allclose(to.numpy(), jo, rtol=0,
                               atol=TOL * np.abs(jo).max())
