"""The route choice of the port's flash attention wrappers
(paddle_tpu_torch/ops/flash_attention.py): bfloat16 or float16 operands
at head width 64 or 128 with 16-byte-aligned bases go to the tensor-core
kernels (csrc/flash_attention_sm90.cu), everything else the wrappers take
to the CUDA-core kernels (csrc/flash_attention.cu). The choice is plain Python
over dtype, width and base pointers, so it is tested here on CPU tensors;
the kernels themselves run only on the card (tests/test_torch_cuda.py).

Also: the routing of ``nn.functional.scaled_dot_product_attention`` does
not look at dtypes, the CPU wrappers run the plain versions and count
nothing on either route, and the plain versions agree with the JAX
package's Pallas kernels (interpret mode, ``block_q = block_k = 32``) at
the tensor-core widths, in bfloat16 at atol 3e-2, rtol 3e-2 (as
tests/test_torch_flash_attention.py: P is rounded to bf16 against a
running maximum in the kernel and the row maximum in the plain version,
and every output is one bf16 rounding away).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops import pallas_kernels as pk
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.ops import flash_attention as fa

BF16_TOL = dict(atol=3e-2, rtol=3e-2)


@pytest.mark.parametrize("dtype, d, aligned, route", [
    (torch.bfloat16, 64, True, "tc"),
    (torch.bfloat16, 128, True, "tc"),
    (torch.bfloat16, 64, False, "cuda_core"),
    (torch.bfloat16, 128, False, "cuda_core"),
    (torch.bfloat16, 32, True, "cuda_core"),
    (torch.bfloat16, 96, True, "cuda_core"),
    (torch.bfloat16, 256, True, "cuda_core"),
    (torch.float32, 64, True, "cuda_core"),
    (torch.float32, 128, True, "cuda_core"),
    (torch.float16, 64, True, "tc"),
    (torch.float16, 128, True, "tc"),
    (torch.float16, 64, False, "cuda_core"),
    (torch.float16, 32, True, "cuda_core"),
    (torch.float16, 256, True, "cuda_core"),
])
def test_route_follows_dtype_width_and_alignment(dtype, d, aligned, route):
    assert fa.flash_route(dtype, d, aligned) == route


def _unaligned(shape, dtype):
    """A contiguous tensor of ``shape`` whose base is one element past the
    (aligned) start of its storage."""
    n = int(np.prod(shape))
    return torch.zeros(n + 1, dtype=dtype)[1:].view(shape)


@pytest.mark.parametrize("which", ["q", "k", "v", "do"])
def test_one_unaligned_operand_sends_the_call_to_the_cuda_cores(which):
    shape = (1, 8, 2, 64)
    ops = {n: torch.zeros(shape, dtype=torch.bfloat16)
           for n in ("q", "k", "v", "do")}
    assert all(t.data_ptr() % 16 == 0 for t in ops.values())
    assert fa.flash_route_of(ops["q"], ops["k"], ops["v"], ops["do"]) == "tc"
    ops[which] = _unaligned(shape, torch.bfloat16)
    assert ops[which].is_contiguous()
    assert fa.flash_route_of(ops["q"], ops["k"], ops["v"],
                             ops["do"]) == "cuda_core"


def test_head_widths_of_the_two_routes():
    assert fa.MAX_HEAD_DIM == 256
    assert set(fa.TC_HEAD_DIMS) == {64, 128}


@pytest.mark.parametrize("dtypes", [
    (torch.float16,) * 3,
    (torch.float32, torch.bfloat16, torch.float32),
    (torch.bfloat16, torch.float16, torch.bfloat16),
    (torch.bfloat16,) * 3,
    (torch.float32,) * 3,
])
@pytest.mark.parametrize("d", [64, 128])
def test_sdpa_hands_every_dtype_to_the_wrapper(dtypes, d, monkeypatch):
    """The routing of ``scaled_dot_product_attention`` is structural only:
    the route by dtype is chosen inside the kernel wrappers, and on the
    card the wrappers raise on dtypes neither route takes."""
    calls = []
    monkeypatch.setattr(F, "flash_attention", lambda *a, **kw: calls.append(
        [t.dtype for t in a[:3]]))
    q, k, v = (torch.zeros(1, 16, 2, d, dtype=dt) for dt in dtypes)
    F.scaled_dot_product_attention(q, k, v, is_causal=True)
    assert calls == [list(dtypes)]


@pytest.mark.parametrize("dtype, d", [(torch.bfloat16, 64),
                                      (torch.bfloat16, 128),
                                      (torch.bfloat16, 32),
                                      (torch.float32, 64)])
def test_cpu_wrappers_run_plain_and_count_nothing(dtype, d):
    g = torch.Generator().manual_seed(d)
    q, k, v, do = (torch.randn(1, 24, 2, d, generator=g).to(dtype)
                   for _ in range(4))
    wrappers = (fa.flash_attention_fwd, fa.flash_attention_bwd)
    before = [(w.launches, w.tc_launches, w.core_launches) for w in wrappers]
    o, lse = fa.flash_attention_fwd(q, k, v, True)
    grads = fa.flash_attention_bwd(q, k, v, o, lse, do, True)
    assert [(w.launches, w.tc_launches, w.core_launches)
            for w in wrappers] == before
    want_o, want_lse = fa.flash_attention_fwd_plain(q, k, v, True)
    assert torch.equal(o, want_o) and torch.equal(lse, want_lse)
    for got, want in zip(grads, fa.flash_attention_bwd_plain(
            q, k, v, o, lse, do, True)):
        assert torch.equal(got, want)


@pytest.mark.parametrize("d", [64, 128])
def test_plain_matches_jax_kernels_at_tensor_core_widths(d):
    """Forward, LSE and gradients of the plain versions, which the card's
    tensor-core kernels are held to, against the Pallas kernels in
    bfloat16, causal, with a ragged-free length of two blocks."""
    b, s, h = 1, 64, 2
    rng = np.random.RandomState(d)
    q, k, v, do = (rng.randn(b, s, h, d).astype(np.float32)
                   for _ in range(4))
    jargs = [jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)]
    want, vjp = jax.vjp(lambda q_, k_, v_: pk.flash_attention(
        q_, k_, v_, is_causal=True, block_q=32, block_k=32), *jargs)
    bhsd = [a.transpose(0, 2, 1, 3).reshape(b * h, s, d) for a in jargs]
    _, want_lse = pk._fa_call_fwd(*bhsd, 1.0 / np.sqrt(d), True, 32, 32)
    want_grads = vjp(jnp.asarray(do, jnp.bfloat16))

    tq, tk, tv, tdo = (torch.from_numpy(a).bfloat16() for a in (q, k, v, do))
    o, lse = fa.flash_attention_fwd_plain(tq, tk, tv, True)
    np.testing.assert_allclose(o.float().numpy(),
                               np.asarray(want, np.float32), **BF16_TOL)
    np.testing.assert_allclose(lse.reshape(b * h, s).numpy(),
                               np.asarray(want_lse)[..., 0], **BF16_TOL)
    grads = fa.flash_attention_bwd_plain(tq, tk, tv, o, lse, tdo, True)
    for name, got, w in zip("qkv", grads, want_grads):
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(w, np.float32),
                                   err_msg=f"d{name}", **BF16_TOL)
