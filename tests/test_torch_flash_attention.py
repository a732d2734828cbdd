"""Flash attention of the PyTorch port (paddle_tpu_torch/ops/flash_attention.py
and the routing of paddle_tpu_torch/nn/functional.py) against the JAX
package: the Pallas kernels in interpret mode (``flash_attention``, its
streaming forward ``_fa_call_fwd`` for the LSE, and ``jax.vjp`` through its
backward kernels) and the lax composition ``_sdpa`` for the shapes the
kernels do not take.

On the CPU the port's wrappers run their plain versions; the CUDA kernels
are checked on the card by chip_smoke.py and tests/test_torch_cuda.py.
Tolerances: float32 atol 2e-5 (the same f32 arithmetic, summed in another
order and with the online softmax against the full one); bfloat16 atol
3e-2, rtol 3e-2 (P is rounded to bf16 relative to a running maximum in the
kernel and to the row maximum in the plain version, and every output is one
bf16 rounding away, 2^-8 relative).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops import pallas_kernels as pk
from paddle_tpu.ops.registry import get_op
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.ops import flash_attention as fa

TOL = {"float32": dict(atol=2e-5, rtol=2e-5),
       "bfloat16": dict(atol=3e-2, rtol=3e-2)}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _qkvo(seed, b, sq, sk, h, d):
    rng = np.random.RandomState(seed)
    return [rng.randn(b, s, h, d).astype(np.float32)
            for s in (sq, sk, sk, sq)]


def _t(a, dtype):
    return torch.from_numpy(a).to(TDT[dtype])


def _np(t):
    return t.detach().float().numpy()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [False, True])
def test_forward_and_lse_match_jax_kernels(dtype, causal):
    b, s, h, d = 2, 64, 2, 32
    q, k, v, _ = _qkvo(1, b, s, s, h, d)
    jq, jk, jv = (jnp.asarray(a, JDT[dtype]) for a in (q, k, v))
    want = pk.flash_attention(jq, jk, jv, is_causal=causal,
                              block_q=32, block_k=32)
    bhsd = [a.transpose(0, 2, 1, 3).reshape(b * h, s, d)
            for a in (jq, jk, jv)]
    _, want_lse = pk._fa_call_fwd(*bhsd, 1.0 / np.sqrt(d), causal, 32, 32)
    o, lse = fa.flash_attention_fwd(_t(q, dtype), _t(k, dtype),
                                    _t(v, dtype), causal)
    assert o.dtype == TDT[dtype] and tuple(o.shape) == (b, s, h, d)
    assert lse.dtype == torch.float32 and tuple(lse.shape) == (b, h, s)
    np.testing.assert_allclose(_np(o), np.asarray(want, np.float32),
                               **TOL[dtype])
    np.testing.assert_allclose(lse.reshape(b * h, s).numpy(),
                               np.asarray(want_lse)[..., 0], **TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [False, True])
def test_gradients_match_jax_vjp(dtype, causal):
    b, s, h, d = 1, 64, 2, 16
    q, k, v, do = _qkvo(2, b, s, s, h, d)
    jargs = [jnp.asarray(a, JDT[dtype]) for a in (q, k, v)]
    _, vjp = jax.vjp(lambda q_, k_, v_: pk.flash_attention(
        q_, k_, v_, is_causal=causal, block_q=32, block_k=32), *jargs)
    want = vjp(jnp.asarray(do, JDT[dtype]))
    targs = [_t(a, dtype).requires_grad_() for a in (q, k, v)]
    out = fa.flash_attention(*targs, is_causal=causal)
    out.backward(_t(do, dtype))
    for name, t, w in zip("qkv", targs, want):
        assert t.grad.dtype == TDT[dtype]
        np.testing.assert_allclose(_np(t.grad), np.asarray(w, np.float32),
                                   err_msg=f"d{name}", **TOL[dtype])


@pytest.mark.parametrize("causal", [False, True])
def test_ragged_lengths_match_lax_composition(causal):
    """Lengths the TPU kernels refused (not a multiple of the block): the
    port masks tails, so its result is the lax composition's."""
    b, sq, h, d = 2, 37, 3, 24
    sk = sq if causal else 45
    q, k, v, do = _qkvo(3, b, sq, sk, h, d)
    jargs = [jnp.asarray(a) for a in (q, k, v)]
    want, vjp = jax.vjp(lambda q_, k_, v_: get_op(
        "scaled_dot_product_attention").fn(q_, k_, v_, None, None,
                                           is_causal=causal), *jargs)
    targs = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    out = fa.flash_attention(*targs, is_causal=causal)
    np.testing.assert_allclose(_np(out), np.asarray(want),
                               **TOL["float32"])
    out.backward(torch.from_numpy(do))
    for t, w in zip(targs, vjp(jnp.asarray(do))):
        np.testing.assert_allclose(_np(t.grad), np.asarray(w),
                                   **TOL["float32"])


def test_backward_of_plain_matches_autograd():
    """The plain backward (P recomputed from the LSE) against autograd
    through the plain forward."""
    q, k, v, do = (torch.from_numpy(a) for a in _qkvo(4, 2, 20, 20, 2, 8))
    qs, ks, vs = (t.clone().requires_grad_() for t in (q, k, v))
    o, lse = fa.flash_attention_fwd_plain(qs, ks, vs, True)
    o.backward(do)
    dq, dk, dv = fa.flash_attention_bwd_plain(q, k, v, o.detach(), lse, do,
                                              True)
    for got, t in zip((dq, dk, dv), (qs, ks, vs)):
        torch.testing.assert_close(got, t.grad, **TOL["float32"])


@pytest.mark.parametrize("case", ["mask", "dropout", "causal_cross",
                                  "wide_head"])
def test_routing_follows_fa_supported(case, monkeypatch):
    """Shapes outside the structural half of ``_fa_supported`` run the
    plain composition, and agree with the JAX package's ``_sdpa``; the
    others reach the kernel wrapper."""
    b, sq, h, d = 1, 16, 2, 300 if case == "wide_head" else 16
    sk = 24 if case == "causal_cross" else sq
    q, k, v, _ = _qkvo(5, b, sq, sk, h, d)
    mask = np.tril(np.ones((sq, sk), bool))[None, None] if case == "mask" \
        else None
    calls = []
    monkeypatch.setattr(F, "flash_attention",
                        lambda *a, **kw: calls.append(1))
    causal = case == "causal_cross"
    got = F.scaled_dot_product_attention(
        *(torch.from_numpy(a) for a in (q, k, v)),
        attn_mask=None if mask is None else torch.from_numpy(mask),
        dropout_p=1.0 if case == "dropout" else 0.0, is_causal=causal)
    assert calls == []
    if case == "dropout":          # p = 1 drops every probability
        assert torch.all(got == 0)
        return
    want = get_op("scaled_dot_product_attention").fn(
        *(jnp.asarray(a) for a in (q, k, v)),
        None if mask is None else jnp.asarray(mask), None,
        is_causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               **TOL["float32"])
    F.scaled_dot_product_attention(*(torch.from_numpy(a)
                                     for a in (q, q, q)), is_causal=True)
    assert calls == ([1] if d <= fa.MAX_HEAD_DIM else [])


def test_routing_takes_no_account_of_dtypes(monkeypatch):
    """A supported shape reaches the kernel wrapper whatever its dtypes;
    on the card the wrapper raises for those its kernels do not take
    (``tests/test_torch_cuda.py``)."""
    calls = []
    monkeypatch.setattr(F, "flash_attention", lambda *a, **kw: calls.append(
        [t.dtype for t in a[:3]]))
    q = torch.randn(1, 16, 2, 16)
    F.scaled_dot_product_attention(q.half(), q.half(), q.half(),
                                   is_causal=True)
    F.scaled_dot_product_attention(q, q.bfloat16(), q)
    assert calls == [[torch.float16] * 3,
                     [torch.float32, torch.bfloat16, torch.float32]]


def test_cpu_wrappers_count_no_launches_and_reject_bad_shapes():
    q = torch.randn(1, 8, 2, 16)
    before = (fa.flash_attention_fwd.launches,
              fa.flash_attention_bwd.launches)
    o, lse = fa.flash_attention_fwd(q, q, q, True)
    fa.flash_attention_bwd(q, q, q, o, lse, o, True)
    assert (fa.flash_attention_fwd.launches,
            fa.flash_attention_bwd.launches) == before
    with pytest.raises(ValueError, match="B, S, H, D"):
        fa._check(q[0], q, q)
    with pytest.raises(ValueError, match="do not fit"):
        fa._check(q, q[:, :, :1], q)
