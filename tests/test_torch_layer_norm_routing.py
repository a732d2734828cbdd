"""The route choice of the port's LayerNorm wrappers
(paddle_tpu_torch/ops/layer_norm.py): rows of at most 2048 values that
fill whole 16-byte vectors, with 16-byte-aligned bases, go to the
warp-row kernels; everything else the wrappers take goes to the
CTA-per-row kernels (both in csrc/layer_norm.cu). The choice and the
warp-row backward's grid are plain Python over shapes, dtypes and base
pointers, so they are tested here on CPU tensors; the kernels themselves
run only on the card (tests/test_torch_cuda.py).

Also: on the CPU both wrappers run the plain versions and count no launch
on any route, and the plain versions agree with the JAX package's Pallas
kernels (interpret mode on the CPU) at widths on both sides of the route
boundary. Tolerances as tests/test_torch_layer_norm.py: float32 atol
1e-5 (the same f32 statistics summed in another order), the backward's
dw/db, sums over every row, atol 1e-4.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops import pallas_kernels as pk
from paddle_tpu_torch.ops import layer_norm as ln

ATOL = 1e-5


def _unaligned(shape, dtype):
    """A contiguous tensor of ``shape`` whose base is one element past the
    (aligned) start of its storage."""
    n = int(np.prod(shape))
    return torch.zeros(n + 1, dtype=dtype)[1:].view(shape)


def _operands(d, dtype):
    return (torch.zeros(4, d, dtype=dtype), torch.zeros(d, dtype=dtype),
            torch.zeros(d, dtype=dtype))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [768, 1024, 1280, 1600, 2048, 8, 16])
def test_gpt2_widths_with_aligned_bases_take_the_warp_route(d, dtype):
    x, w, b = _operands(d, dtype)
    assert all(t.data_ptr() % 16 == 0 for t in (x, w, b))
    assert ln.ln_route(x, w, b) == "warp"


@pytest.mark.parametrize("dtype, d", [
    (torch.float32, 1), (torch.float32, 7), (torch.float32, 770),
    (torch.float32, 2049), (torch.float32, 2052), (torch.float32, 4096),
    (torch.float32, 16384), (torch.bfloat16, 1), (torch.bfloat16, 772),
    (torch.bfloat16, 2049), (torch.bfloat16, 2056), (torch.bfloat16, 16384),
])
def test_other_widths_take_the_row_route(dtype, d):
    x, w, b = _operands(d, dtype)
    assert ln.ln_route(x, w, b) == "row"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("which", [0, 1, 2])
def test_one_unaligned_operand_sends_the_call_to_the_row_route(dtype, which):
    ops = list(_operands(768, dtype))
    assert ln.ln_route(*ops) == "warp"
    ops[which] = _unaligned(tuple(ops[which].shape), dtype)
    assert ops[which].is_contiguous() and ops[which].data_ptr() % 16 != 0
    assert ln.ln_route(*ops) == "row"


def test_route_limits():
    assert ln.WARP_MAX_D == 2048 and ln.MAX_D == 16384
    assert ln.WARP_BWD_MAX_CTAS == 128


@pytest.mark.parametrize("rows", [1, 7, 15, 16, 17, 300, 2047, 2048, 2049,
                                  8192, 8193, 100000, 1 << 20])
def test_warp_backward_grid_covers_every_row_once_under_its_cap(rows):
    ctas, per = ln.warp_bwd_grid(rows)
    assert (ctas, per) == ln.warp_bwd_grid(rows)        # the same every call
    assert 1 <= ctas <= ln.WARP_BWD_MAX_CTAS
    # one ticket counter a group of 16 CTAs, one more for the groups
    assert -(-ctas // 16) + 1 <= 16
    seen = np.zeros(rows, np.int32)
    for c in range(ctas):
        lo, hi = c * per, min((c + 1) * per, rows)
        assert lo < hi, f"CTA {c} of {ctas} has no rows"
        seen[lo:hi] += 1
    assert (seen == 1).all()


def test_warp_backward_grid_depends_on_the_rows_alone():
    """The grid takes the row count and nothing of the card: the CTA count
    grows with the rows until the cap, then stays there."""
    counts = [ln.warp_bwd_grid(r)[0] for r in (16, 32, 64, 2048, 4096,
                                               8192, 65536)]
    assert counts == sorted(counts)
    assert counts[-3:] == [ln.WARP_BWD_MAX_CTAS] * 3


@pytest.mark.parametrize("aligned", [True, False])
def test_cpu_wrappers_take_the_plain_versions_and_count_nothing(aligned):
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randn(6, 768).astype(np.float32))
    if not aligned:
        x = _unaligned((6, 768), torch.float32).copy_(x)
    w = torch.from_numpy((1 + 0.1 * rng.randn(768)).astype(np.float32))
    b = torch.from_numpy((0.1 * rng.randn(768)).astype(np.float32))
    g = torch.from_numpy(rng.randn(6, 768).astype(np.float32))
    counters = ("launches", "warp_launches", "row_launches")
    wrappers = (ln.fused_layer_norm, ln.fused_layer_norm_bwd)
    before = [[getattr(f, c) for c in counters] for f in wrappers]
    y = ln.fused_layer_norm(x, w, b)
    dx, dw, db = ln.fused_layer_norm_bwd(x, w, g)
    assert [[getattr(f, c) for c in counters] for f in wrappers] == before
    torch.testing.assert_close(y, ln.layer_norm_plain(x, w, b), atol=0,
                               rtol=0)
    for got, want in zip((dx, dw, db), ln.layer_norm_bwd_plain(x, w, g)):
        torch.testing.assert_close(got, want, atol=0, rtol=0)


def _inputs(seed, rows, d):
    rng = np.random.RandomState(seed)
    return (rng.randn(rows, d).astype(np.float32),
            (1 + 0.1 * rng.randn(d)).astype(np.float32),
            (0.1 * rng.randn(d)).astype(np.float32),
            rng.randn(rows, d).astype(np.float32))


@pytest.mark.parametrize("d", [1, 7, 768, 1600, 2049])
def test_plain_versions_match_the_jax_kernels_across_the_route_boundary(d):
    x, w, b, g = _inputs(d, 8, d)
    ref = np.asarray(pk.fused_layer_norm(*map(jnp.asarray, (x, w, b))))
    got = ln.layer_norm_plain(*map(torch.from_numpy, (x, w, b)))
    np.testing.assert_allclose(got.numpy(), ref, atol=ATOL, rtol=0)

    def loss(x_, w_, b_):
        return jnp.sum(pk.fused_layer_norm(x_, w_, b_) * g)

    want = jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray, (x, w, b)))
    got = ln.layer_norm_bwd_plain(*map(torch.from_numpy, (x, w, g)))
    for name, t, r in zip(("dx", "dw", "db"), got, want):
        np.testing.assert_allclose(t.numpy(), np.asarray(r),
                                   atol=ATOL if name == "dx" else 1e-4,
                                   rtol=0, err_msg=f"{name} at D={d}")
