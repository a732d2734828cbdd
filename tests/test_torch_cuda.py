"""The port's CUDA kernels against their plain versions, on the card.

Every test here needs a CUDA device and the ``nvcc`` that builds the
kernels; on a host without one each skips. This file imports neither jax
nor the JAX package, so it also runs where only PyTorch is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances: float32 atol 1e-4; bfloat16 atol 2e-2 + rtol 1e-2 (one bf16
ulp of the output, after upcasting); float16 atol 5e-3 + rtol 5e-3 (a few
f16 ulps: P and dS are rounded to f16 where the f32 sums of kernel and
plain version may differ in their last bits); the quantized KV kernel takes its q
dtype's, since kernel and plain dequantize to the same values. The
LayerNorm backward's dw/db, sums over every row, take rtol 1e-5 beside
atol 1e-4 in float32; AdamW, the same float32 arithmetic with fused
multiply-adds, atol 1e-6 + rtol 1e-6.
"""
import numpy as np
import pytest
import torch

from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.ops import flash_attention as fa
from paddle_tpu_torch.ops import fused_adamw as adamw
from paddle_tpu_torch.ops import layer_norm as ln
from paddle_tpu_torch.ops import ragged_paged_attention as rpa

pytestmark = pytest.mark.cuda

TOL = {torch.float32: dict(atol=1e-4, rtol=0),
       torch.bfloat16: dict(atol=2e-2, rtol=1e-2),
       torch.float16: dict(atol=5e-3, rtol=5e-3)}
_F16 = [torch.float32, torch.bfloat16, torch.float16]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", _F16)
@pytest.mark.parametrize("rows", [1, 8, 300])
def test_layer_norm_kernel_matches_plain(cuda, dtype, rows):
    g = torch.Generator(device=cuda).manual_seed(rows)
    x = torch.randn(rows, 768, device=cuda, generator=g).to(dtype)
    w = (1 + 0.1 * torch.randn(768, device=cuda, generator=g)).to(dtype)
    b = (0.1 * torch.randn(768, device=cuda, generator=g)).to(dtype)
    before = ln.fused_layer_norm.launches
    got = ln.fused_layer_norm(x, w, b)
    torch.cuda.synchronize()
    assert ln.fused_layer_norm.launches == before + 1
    torch.testing.assert_close(got.float(),
                               ln.layer_norm_plain(x, w, b).float(),
                               **TOL[dtype])


@pytest.mark.parametrize("dtype", _F16)
def test_ragged_attention_kernel_matches_plain(cuda, dtype):
    rng = np.random.RandomState(0)
    L, H, bs, Dh, S, T = 2, 12, 16, 64, 5, 8
    nb = S * T
    pool = torch.from_numpy(rng.randn(L, 2, nb + 1, H, bs, Dh)
                            .astype(np.float32)).to(cuda, dtype)
    tables = np.zeros((S, T), np.int32)
    free = rng.permutation(np.arange(1, nb + 1)).tolist()
    q_lens, pos0s, kv_lens = [], [], []
    for s in range(S):
        kv = int(rng.randint(1, T * bs + 1))
        q = 0 if s == 2 else 1 if s % 2 == 0 else int(rng.randint(1, kv + 1))
        nblk = -(-kv // bs)
        tables[s, :nblk] = [free.pop() for _ in range(nblk)]
        q_lens.append(q)
        pos0s.append(kv - q)
        kv_lens.append(kv if q else 0)
    # two pad blocks past the content
    qp = (len(rpa.ragged_layout(q_lens, pos0s)[0]) + 2) * 8
    blk_seq, qstart, pos0, _, _ = rpa.ragged_layout(q_lens, pos0s,
                                                    q_bucket=qp)
    q = torch.from_numpy(rng.randn(H, qp, Dh).astype(np.float32)).to(
        cuda, dtype)
    meta = [torch.from_numpy(np.asarray(a, np.int32)).to(cuda)
            for a in (blk_seq, qstart, pos0, tables, np.zeros(S, np.int32),
                      kv_lens)]
    got = rpa.ragged_paged_attention(q, pool, 1, *meta)
    torch.cuda.synchronize()
    want = rpa.ragged_paged_attention_plain(q, pool, 1, *meta)
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])
    assert torch.all(got[:, qp - 16:] == 0)


def _quantize_blocks(vals, storage):
    """Float blocks ``[..., bs, Dh]`` -> codes of ``storage`` and their
    per-block max-abs scales ``[...]``."""
    qmax = 127.0 if storage == torch.int8 else 448.0
    sc = vals.abs().amax(dim=(-2, -1)) / qmax
    codes = (vals / sc.clamp_min(1e-30)[..., None, None]).round().clamp(
        -qmax, qmax).to(storage)
    return codes, sc


@pytest.mark.parametrize("dtype", _F16)
@pytest.mark.parametrize("storage", [torch.int8, torch.float8_e4m3fn])
def test_quantized_ragged_attention_kernel_matches_plain(cuda, dtype,
                                                         storage):
    rng = np.random.RandomState(1)
    L, H, bs, Dh, S, T = 2, 12, 32, 64, 5, 8
    nb = S * T
    g = torch.Generator(device=cuda).manual_seed(3)
    vals = torch.randn(L, 2, nb + 1, H, bs, Dh, device=cuda, generator=g)
    pool, scales = _quantize_blocks(vals, storage)
    tables = np.zeros((S, T), np.int32)
    free = rng.permutation(np.arange(1, nb + 1)).tolist()
    q_lens, pos0s, kv_lens = [], [], []
    for s in range(S):
        kv = int(rng.randint(1, T * bs + 1))
        q = 0 if s == 2 else 1 if s % 2 == 0 else int(rng.randint(1, kv + 1))
        nblk = -(-kv // bs)
        tables[s, :nblk] = [free.pop() for _ in range(nblk)]
        q_lens.append(q)
        pos0s.append(kv - q)
        kv_lens.append(kv if q else 0)
    qp = (len(rpa.ragged_layout(q_lens, pos0s)[0]) + 2) * 8
    blk_seq, qstart, pos0, _, _ = rpa.ragged_layout(q_lens, pos0s,
                                                    q_bucket=qp)
    q = torch.randn(H, qp, Dh, device=cuda, generator=g).to(dtype)
    meta = [torch.from_numpy(np.asarray(a, np.int32)).to(cuda)
            for a in (blk_seq, qstart, pos0, tables, np.zeros(S, np.int32),
                      kv_lens)]
    before = (rpa.ragged_paged_attention.launches,
              rpa.ragged_paged_attention.quant_launches)
    got = rpa.ragged_paged_attention(q, pool, 1, *meta, scales=scales)
    torch.cuda.synchronize()
    assert (rpa.ragged_paged_attention.launches,
            rpa.ragged_paged_attention.quant_launches) == (before[0],
                                                           before[1] + 1)
    want = rpa.ragged_paged_attention_plain(q, pool, 1, *meta, scales=scales)
    assert got.dtype == dtype
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])
    assert torch.all(got[:, qp - 16:] == 0)
    # a NaN scale reaches the rows that read its block
    scales[1, 1, tables[1, 0]] = float("nan")
    got = rpa.ragged_paged_attention(q, pool, 1, *meta, scales=scales)
    torch.cuda.synchronize()
    rows = slice(int(qstart[1]), int(qstart[1]) + q_lens[1])
    assert torch.isnan(got[:, rows]).all()
    assert torch.isfinite(got[:, int(qstart[0])]).all()


def test_quantized_ragged_attention_raises_without_its_kernel_inputs(cuda):
    q = torch.zeros(2, 8, 16, device=cuda)
    pool = torch.zeros(1, 2, 3, 2, 32, 16, dtype=torch.int8, device=cuda)
    meta = [torch.zeros(1, dtype=torch.int32, device=cuda)] * 3 + [
        torch.zeros(1, 1, dtype=torch.int32, device=cuda)] + [
        torch.zeros(1, dtype=torch.int32, device=cuda)] * 2
    with pytest.raises(ValueError, match="per-block scale array"):
        rpa.ragged_paged_attention(q, pool, 0, *meta)
    with pytest.raises(ValueError, match="float32 tensor"):
        rpa.ragged_paged_attention(
            q, pool, 0, *meta,
            scales=torch.zeros(1, 2, 3, 2, dtype=torch.bfloat16,
                               device=cuda))
    with pytest.raises(ValueError, match="multiple of 16"):
        rpa.ragged_paged_attention(
            torch.zeros(2, 8, 8, device=cuda),
            torch.zeros(1, 2, 3, 2, 32, 8, dtype=torch.int8, device=cuda),
            0, *meta, scales=torch.zeros(1, 2, 3, 2, device=cuda))


def _ordinal(codes):
    """Each code's rank among its type's codes: neighbours differ by 1
    (fp8 bits are sign-magnitude)."""
    if codes.dtype == torch.int8:
        return codes.long()
    bits = codes.view(torch.uint8).long()
    return torch.where(bits >= 0x80, -(bits & 0x7F), bits & 0x7F)


@pytest.mark.parametrize("storage", [torch.int8, torch.float8_e4m3fn])
def test_quant_append_on_the_card_matches_the_cpu(cuda, storage):
    """The scale update's scatter-max keeps NaN on the card as on the
    CPU, and the codes agree within one."""
    from paddle_tpu_torch.models.generation import _quant_append
    qmax = 127.0 if storage == torch.int8 else 448.0
    g = torch.Generator().manual_seed(5)
    wb = torch.tensor([2] * 20 + [4] + [0] * 11)
    off = torch.tensor(list(range(20)) + [3] + [0] * 11)
    rows = torch.randn(32, 12, 64, generator=g)
    rows[21:] = rows[21]                        # identical pad rows
    big = 3 * torch.randn(3, 12, 64, generator=g)
    nan = torch.full((1, 12, 64), float("nan"))
    state = {}
    for dev in ("cpu", cuda):
        p = torch.zeros(2, 2, 6, 12, 32, 64, dtype=storage, device=dev)
        s = torch.zeros(2, 2, 6, 12, device=dev)
        for li, kv in ((0, 0), (0, 1), (1, 0)):
            _quant_append(p, s, li, kv, wb.to(dev), off.to(dev),
                          rows.to(dev), qmax)
        _quant_append(p, s, 0, 0, torch.tensor([2, 2, 4], device=dev),
                      torch.tensor([20, 21, 4], device=dev), big.to(dev),
                      qmax)
        _quant_append(p, s, 1, 0, torch.tensor([4], device=dev),
                      torch.tensor([5], device=dev), nan.to(dev), qmax)
        state[str(dev)] = (_ordinal(p.cpu()), s.cpu())
    (p_cpu, s_cpu), (p_gpu, s_gpu) = state["cpu"], state[str(cuda)]
    assert torch.isnan(s_gpu[1, 0, 4]).all() and torch.isnan(
        s_cpu[1, 0, 4]).all()
    torch.testing.assert_close(s_gpu, s_cpu, rtol=1e-5, atol=0,
                               equal_nan=True)
    assert (p_gpu - p_cpu).abs().max() <= 1


def test_ragged_attention_rejects_host_metadata(cuda):
    q = torch.zeros(2, 8, 16, device=cuda)
    pool = torch.zeros(1, 2, 3, 2, 8, 16, device=cuda)
    z = np.zeros(1, np.int32)
    with pytest.raises(ValueError, match="int32 tensor"):
        rpa.ragged_paged_attention(q, pool, 0, z, z, z,
                                   np.zeros((1, 1), np.int32), z, z)


def _randn(gen, *shape, dtype=torch.float32, scale=1.0):
    return (scale * torch.randn(*shape, device=gen.device,
                                generator=gen)).to(dtype)


@pytest.mark.parametrize("dtype", _F16)
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("seq", [128, 100])
def test_flash_attention_kernels_match_plain(cuda, dtype, causal, seq):
    g = torch.Generator(device=cuda).manual_seed(seq)
    q, k, v, do = (_randn(g, 2, seq, 3, 64, dtype=dtype) for _ in range(4))
    before = (fa.flash_attention_fwd.launches,
              fa.flash_attention_bwd.launches)
    o, lse = fa.flash_attention_fwd(q, k, v, causal)
    grads = fa.flash_attention_bwd(q, k, v, o, lse, do, causal)
    torch.cuda.synchronize()
    assert (fa.flash_attention_fwd.launches,
            fa.flash_attention_bwd.launches) == (before[0] + 1,
                                                 before[1] + 1)
    want_o, want_lse = fa.flash_attention_fwd_plain(q, k, v, causal)
    torch.testing.assert_close(o.float(), want_o.float(), **TOL[dtype])
    torch.testing.assert_close(lse, want_lse, **TOL[torch.float32])
    want = fa.flash_attention_bwd_plain(q, k, v, o, lse, do, causal)
    for got, ref in zip(grads, want):
        assert got.dtype == dtype
        torch.testing.assert_close(got.float(), ref.float(), **TOL[dtype])


def test_flash_attention_autograd_runs_both_kernels(cuda):
    g = torch.Generator(device=cuda).manual_seed(1)
    q, k, v = (_randn(g, 1, 64, 2, 32).requires_grad_() for _ in range(3))
    before = fa.flash_attention_bwd.launches
    fa.flash_attention(q, k, v, is_causal=True).sum().backward()
    torch.cuda.synchronize()
    assert fa.flash_attention_bwd.launches == before + 1
    assert all(t.grad is not None for t in (q, k, v))


@pytest.mark.parametrize("dtypes", [(torch.float64,) * 3,
                                    (torch.float32, torch.bfloat16,
                                     torch.float32)])
def test_attention_raises_on_dtypes_the_kernels_do_not_take(cuda, dtypes):
    """The routing sends every supported shape to the kernel wrapper,
    which raises rather than run a plain version on the card."""
    q, k, v = (torch.zeros(1, 16, 2, 16, device=cuda, dtype=dt)
               for dt in dtypes)
    before = fa.flash_attention_fwd.launches
    with pytest.raises(TypeError, match="float32, bfloat16 or float16"):
        F.scaled_dot_product_attention(q, k, v, is_causal=True)
    assert fa.flash_attention_fwd.launches == before


@pytest.mark.parametrize("dtype", _F16)
@pytest.mark.parametrize("rows", [1, 300, 2049])
def test_layer_norm_backward_kernel_matches_plain(cuda, dtype, rows):
    g = torch.Generator(device=cuda).manual_seed(rows)
    x = _randn(g, rows, 768, dtype=dtype)
    w = (1 + _randn(g, 768, scale=0.1)).to(dtype)
    dy = _randn(g, rows, 768, dtype=dtype)
    before = ln.fused_layer_norm_bwd.launches
    got = ln.fused_layer_norm_bwd(x, w, dy)
    again = ln.fused_layer_norm_bwd(x, w, dy)
    torch.cuda.synchronize()
    assert ln.fused_layer_norm_bwd.launches == before + 2
    want = ln.layer_norm_bwd_plain(x, w, dy)
    tol = [TOL[dtype]] + [dict(atol=1e-4, rtol=1e-5)
                          if dtype == torch.float32 else TOL[dtype]] * 2
    for a, b, ref, t in zip(got, again, want, tol):
        assert torch.equal(a, b)           # no atomics: the same bits
        torch.testing.assert_close(a.float(), ref.float(), **t)


@pytest.mark.parametrize("case", ["f32_master_bf16_copy", "f32", "bf16",
                                  "f32_master_f16_copy", "f16"])
def test_adamw_kernel_matches_plain(cuda, case):
    g = torch.Generator(device=cuda).manual_seed(7)
    n = 100_003
    half = torch.float16 if "f16" in case else torch.bfloat16
    p_dtype = half if case in ("bf16", "f16") else torch.float32
    g_dtype = torch.float32 if case == "f32" else half
    p = _randn(g, n, dtype=p_dtype)
    grad = _randn(g, n, dtype=g_dtype)
    m = _randn(g, n, scale=0.1)
    v = _randn(g, n, scale=0.1).abs()
    low = torch.empty(n, dtype=half, device=cuda) \
        if case.startswith("f32_master") else None
    kw = dict(lr=1e-3, beta1=0.9, beta2=0.999, eps=1e-8, weight_decay=0.01,
              step=3)
    ref = [t.clone() for t in (p, m, v)]
    ref_low = None if low is None else low.clone()
    before = adamw.fused_adamw_.launches
    adamw.fused_adamw_(p, grad, m, v, low=low, **kw)
    torch.cuda.synchronize()
    assert adamw.fused_adamw_.launches == before + 1
    adamw.adamw_plain_(*ref[:1], grad, *ref[1:], low=ref_low, **kw)
    exact = dict(atol=1e-6, rtol=1e-6)
    for got, want in zip((p, m, v), ref):
        torch.testing.assert_close(got.float(), want.float(),
                                   **(exact if got.dtype == torch.float32
                                      else TOL[got.dtype]))
    if low is not None:
        torch.testing.assert_close(low, p.to(half), atol=0, rtol=0)


def test_adamw_rejects_a_bf16_parameter_with_an_f32_gradient(cuda):
    """The step casts g to p's dtype first, so the kernel has no such
    case."""
    p = torch.zeros(8, dtype=torch.bfloat16, device=cuda)
    m, v, g = (torch.zeros(8, device=cuda) for _ in range(3))
    with pytest.raises(TypeError, match="bfloat16 p takes a bfloat16 g"):
        adamw.fused_adamw_(p, g, m, v, lr=1e-3, beta1=0.9, beta2=0.999,
                           eps=1e-8, weight_decay=0.0, step=1)


_FLASH = (fa.flash_attention_fwd, fa.flash_attention_bwd)


def _route_counts():
    return [(w.launches, w.tc_launches, w.core_launches) for w in _FLASH]


def _flash_route_matches_plain(q, k, v, do, causal, route):
    """One forward and one backward call against the plain versions at
    ``TOL[q.dtype]`` (the LSE at float32's); each wrapper counts the call
    once, in its total and on ``route``, and the other route not at all.
    Returns the backward's gradients."""
    before = _route_counts()
    o, lse = fa.flash_attention_fwd(q, k, v, causal)
    grads = fa.flash_attention_bwd(q, k, v, o, lse, do, causal)
    torch.cuda.synchronize()
    step = (1, 1, 0) if route == "tc" else (1, 0, 1)
    assert _route_counts() == [tuple(a + s for a, s in zip(counts, step))
                               for counts in before]
    want_o, want_lse = fa.flash_attention_fwd_plain(q, k, v, causal)
    torch.testing.assert_close(o.float(), want_o.float(), **TOL[q.dtype])
    torch.testing.assert_close(lse, want_lse, **TOL[torch.float32])
    want = fa.flash_attention_bwd_plain(q, k, v, o, lse, do, causal)
    for name, got, ref in zip("qkv", grads, want):
        assert got.dtype == q.dtype, name
        torch.testing.assert_close(got.float(), ref.float(), **TOL[q.dtype],
                                   msg=lambda m: f"d{name}: {m}")
    return grads


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("seq", [64, 100, 1000, 1024])
@pytest.mark.parametrize("causal", [False, True])
def test_flash_tensor_core_route_matches_plain(cuda, d, seq, causal):
    g = torch.Generator(device=cuda).manual_seed(seq + d)
    q, k, v, do = (_randn(g, 2, seq, 3, d, dtype=torch.bfloat16)
                   for _ in range(4))
    _flash_route_matches_plain(q, k, v, do, causal, "tc")


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("sq, sk", [(100, 1000), (1024, 64), (64, 100)])
def test_flash_tensor_core_route_cross_lengths(cuda, d, sq, sk):
    """Sq != Sk, not causal: the q side and the k side tile separately."""
    g = torch.Generator(device=cuda).manual_seed(sq * sk + d)
    q, do = (_randn(g, 2, sq, 3, d, dtype=torch.bfloat16) for _ in range(2))
    k, v = (_randn(g, 2, sk, 3, d, dtype=torch.bfloat16) for _ in range(2))
    _flash_route_matches_plain(q, k, v, do, False, "tc")


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("causal", [False, True])
def test_flash_tensor_core_route_over_many_waves(cuda, d, causal):
    """batch * heads = 192, more CTAs per q or k tile than the card's 132
    SMs; the backward gives the same bits on a second run."""
    g = torch.Generator(device=cuda).manual_seed(d)
    q, k, v, do = (_randn(g, 4, 256, 48, d, dtype=torch.bfloat16)
                   for _ in range(4))
    grads = _flash_route_matches_plain(q, k, v, do, causal, "tc")
    o, lse = fa.flash_attention_fwd(q, k, v, causal)
    again = fa.flash_attention_bwd(q, k, v, o, lse, do, causal)
    assert all(torch.equal(a, b) for a, b in zip(grads, again))


@pytest.mark.parametrize("dtype, d", [(torch.bfloat16, 32),
                                      (torch.float32, 64),
                                      (torch.float16, 32),
                                      (torch.float16, 96)])
def test_flash_cuda_core_route_takes_what_wgmma_does_not(cuda, dtype, d):
    g = torch.Generator(device=cuda).manual_seed(d)
    q, k, v, do = (_randn(g, 2, 100, 3, d, dtype=dtype) for _ in range(4))
    _flash_route_matches_plain(q, k, v, do, True, "cuda_core")


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("seq", [64, 100, 1024])
@pytest.mark.parametrize("causal", [False, True])
def test_flash_f16_tensor_core_route_matches_plain_and_the_cuda_cores(
        cuda, d, seq, causal):
    """float16 on the tensor-core route against the plain versions at
    float16's tolerance, against the CUDA-core kernels on the same
    operands at an unaligned base (the same tolerance: both round P and
    dS to float16 once), and the same bits on a second call."""
    g = torch.Generator(device=cuda).manual_seed(seq + d + causal)
    q, k, v, do = (_randn(g, 2, seq, 3, d, dtype=torch.float16)
                   for _ in range(4))
    grads = _flash_route_matches_plain(q, k, v, do, causal, "tc")
    o, lse = fa.flash_attention_fwd(q, k, v, causal)
    again = fa.flash_attention_bwd(q, k, v, o, lse, do, causal)
    assert all(torch.equal(a, b) for a, b in zip(grads, again))
    o2, _ = fa.flash_attention_fwd(q, k, v, causal)
    assert torch.equal(o, o2)
    n = q.numel()
    qc, kc, vc, doc = (torch.empty(n + 1, dtype=torch.float16,
                                   device=cuda)[1:].view(q.shape).copy_(t)
                       for t in (q, k, v, do))
    core = _flash_route_matches_plain(qc, kc, vc, doc, causal, "cuda_core")
    oc, _ = fa.flash_attention_fwd(qc, kc, vc, causal)
    torch.testing.assert_close(o.float(), oc.float(), **TOL[torch.float16])
    for name, a, b in zip("qkv", grads, core):
        torch.testing.assert_close(a.float(), b.float(), **TOL[torch.float16],
                                   msg=lambda m: f"d{name}: {m}")


def test_flash_cuda_core_route_takes_an_unaligned_base(cuda):
    """A contiguous bf16 view 2 bytes off a 16-byte boundary, which TMA
    cannot read, goes to the CUDA-core kernels."""
    g = torch.Generator(device=cuda).manual_seed(7)
    shape, n = (2, 100, 3, 64), 2 * 100 * 3 * 64
    q, k, v, do = (_randn(g, n + 1, dtype=torch.bfloat16)[1:].view(shape)
                   for _ in range(4))
    assert q.is_contiguous() and q.data_ptr() % 16 != 0
    _flash_route_matches_plain(q, k, v, do, True, "cuda_core")


# ---------------------------------------------------------------- LayerNorm routes
_LN = (ln.fused_layer_norm, ln.fused_layer_norm_bwd)
_LN_COUNTS = ("launches", "warp_launches", "row_launches")


def _ln_counts():
    return [tuple(getattr(f, c) for c in _LN_COUNTS) for f in _LN]


def _ln_expected_route(d, dtype, aligned):
    """The warp-row route takes aligned rows of at most 2048 values that
    fill whole 16-byte vectors; the row route everything else."""
    size = torch.finfo(dtype).bits // 8
    return "warp" if aligned and d <= 2048 and d * size % 16 == 0 else "row"


def _ln_operands(seed, rows, d, dtype, aligned):
    """x, w, b, g of a LayerNorm call; with ``aligned`` False, x and g are
    contiguous views one element past their storage's start."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = _randn(g, rows, d, dtype=dtype)
    w = (1 + _randn(g, d, scale=0.1)).to(dtype)
    b = _randn(g, d, dtype=dtype, scale=0.1)
    dy = _randn(g, rows, d, dtype=dtype)
    if not aligned:
        x, dy = (torch.empty(t.numel() + 1, dtype=dtype, device=t.device)
                 [1:].view(t.shape).copy_(t) for t in (x, dy))
    return x, w, b, dy


def _ln_routes_match_plain(x, w, b, dy, route):
    """Both kernels against their plain versions, each counted once in its
    total and on ``route``; the backward run twice gives the same bits.
    Returns the backward's outputs."""
    dtype = x.dtype
    step = (1, 1, 0) if route == "warp" else (1, 0, 1)
    before = _ln_counts()
    y = ln.fused_layer_norm(x, w, b)
    got = ln.fused_layer_norm_bwd(x, w, dy)
    again = ln.fused_layer_norm_bwd(x, w, dy)
    torch.cuda.synchronize()
    after = _ln_counts()
    assert after[0] == tuple(a + s for a, s in zip(before[0], step))
    assert after[1] == tuple(a + 2 * s for a, s in zip(before[1], step))
    torch.testing.assert_close(y.float(), ln.layer_norm_plain(x, w, b).float(),
                               **TOL[dtype])
    want = ln.layer_norm_bwd_plain(x, w, dy)
    tol = [TOL[dtype]] + [dict(atol=1e-4, rtol=1e-5)
                          if dtype == torch.float32 else TOL[dtype]] * 2
    for name, a, a2, ref, t in zip(("dx", "dw", "db"), got, again, want, tol):
        assert a.dtype == dtype, name
        assert torch.equal(a, a2), f"{name}: another run, other bits"
        torch.testing.assert_close(a.float(), ref.float(), **t,
                                   msg=lambda m: f"{name}: {m}")
    return got


@pytest.mark.parametrize("dtype", _F16)
@pytest.mark.parametrize("rows", [1, 7, 300, 8192])
@pytest.mark.parametrize("d", [1, 768, 1024, 1600, 2049, 16384])
def test_layer_norm_routes_match_plain(cuda, d, rows, dtype):
    """Every width on both sides of the route boundary, aligned (the
    warp-row route where it applies) and unaligned (the row route)."""
    for aligned in (True, False):
        ops = _ln_operands(d * 31 + rows, rows, d, dtype, aligned)
        assert ln.ln_route(*ops) == _ln_expected_route(d, dtype, aligned)
        _ln_routes_match_plain(*ops, _ln_expected_route(d, dtype, aligned))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_layer_norm_routes_agree_with_each_other(cuda, dtype):
    """The same operands through both routes: the same values within the
    dtype's tolerance (the sums run in other orders)."""
    fast = _ln_operands(5, 2049, 768, dtype, True)
    slow = tuple(torch.empty(t.numel() + 1, dtype=dtype, device=t.device)
                 [1:].view(t.shape).copy_(t) for t in fast)
    a = _ln_routes_match_plain(*fast, "warp")
    b = _ln_routes_match_plain(*slow, "row")
    tol = dict(atol=1e-4, rtol=1e-5) if dtype == torch.float32 else TOL[dtype]
    for x, y in zip(a, b):
        torch.testing.assert_close(x.float(), y.float(), **tol)


@pytest.mark.parametrize("aligned", [True, False])
def test_layer_norm_zero_rows_on_both_routes(cuda, aligned):
    """No rows: empty outputs, zero dw/db, no launch on either route."""
    x, w, b, dy = _ln_operands(0, 0, 768, torch.float32, aligned)
    before = _ln_counts()
    y = ln.fused_layer_norm(x, w, b)
    dx, dw, db = ln.fused_layer_norm_bwd(x, w, dy)
    torch.cuda.synchronize()
    assert _ln_counts() == before
    assert y.shape == (0, 768) and dx.shape == (0, 768)
    assert not dw.any() and not db.any()


def test_layer_norm_backward_launches_back_to_back(cuda):
    """Many warp-row backward launches queued with no sync between them,
    over grids of 1 to 128 CTAs: every one sums its own dw/db partials."""
    outs, refs = [], []
    for rows in (1, 20, 300, 2049, 8192, 17, 8192):
        x, w, _, dy = _ln_operands(rows, rows, 1024, torch.float32, True)
        outs.append(ln.fused_layer_norm_bwd(x, w, dy)[1:])
        refs.append(ln.layer_norm_bwd_plain(x, w, dy)[1:])
    torch.cuda.synchronize()
    for got, want in zip(outs, refs):
        for a, r in zip(got, want):
            torch.testing.assert_close(a, r, atol=1e-4, rtol=1e-5)


def test_layer_norm_module_under_autograd_takes_the_warp_route(cuda):
    """GPT-2's LayerNorm at width 768 through nn.LayerNorm and autograd:
    one forward and one backward launch, both on the warp-row route."""
    from paddle_tpu_torch.nn import LayerNorm
    layer = LayerNorm(768).to(cuda)
    g = torch.Generator(device=cuda).manual_seed(3)
    x = _randn(g, 4, 64, 768).requires_grad_()
    before = _ln_counts()
    layer(x).square().sum().backward()
    torch.cuda.synchronize()
    assert _ln_counts() == [tuple(c + s for c, s in zip(counts, (1, 1, 0)))
                            for counts in before]


# ---------------------------------------------------------------- ragged attention routes
_RPA = rpa.ragged_paged_attention
_RPA_COUNTS = ("launches", "quant_launches", "tc_launches", "core_launches",
               "combine_launches")

# (q_len, pos0, kv_len, lo) a sequence: the tensor-core route's edge cases
# in one ragged batch. A decode row at position 0; kv_len ending mid-page
# with pad rows in its block; a chunk whose rows cross pages; a chunk
# whose 64-row tile spans a split boundary, so its first rows see nothing
# in the second split; a decode row past several splits; a chunk there;
# lo > 0 cutting a split; rows below lo (wholly masked: the mean of
# every page, as the plain version has it).
_RPA_EDGES = [(1, 0, 1, 0), (5, 32, 37, 0), (30, 10, 40, 0),
              (64, 230, 294, 0), (1, 1316, 1317, 0), (100, 1200, 1300, 0),
              (1, 699, 700, 300), (16, 10, 26, 20)]


def _rpa_edge_batch(dev, storage, dh, bs, extra_t=0, pad_blocks=2, seed=0,
                    q_dtype=torch.bfloat16):
    """``_RPA_EDGES`` over a random page table of ``bs``-row blocks, as
    (q, pool, scales, meta): q of ``q_dtype``, the pool of ``storage``
    (q's dtype, or int8/fp8 codes with per-block scales), 2 layers;
    ``extra_t`` more table columns than the longest sequence needs,
    ``pad_blocks`` pad blocks."""
    rng = np.random.RandomState(seed)
    S, H = len(_RPA_EDGES), 2
    T = max(-(-kv // bs) for _, _, kv, _ in _RPA_EDGES) + extra_t
    nb = sum(-(-kv // bs) for _, _, kv, _ in _RPA_EDGES)
    vals = torch.from_numpy(rng.randn(2, 2, nb + 1, H, bs, dh)
                            .astype(np.float32)).to(dev)
    if storage in (torch.bfloat16, torch.float16):
        pool, scales = vals.to(storage), None
    else:
        pool, scales = _quantize_blocks(vals, storage)
    tables = np.zeros((S, T), np.int32)
    free = rng.permutation(np.arange(1, nb + 1)).tolist()
    for s, (_, _, kv, _) in enumerate(_RPA_EDGES):
        n = -(-kv // bs)
        tables[s, :n] = [free.pop() for _ in range(n)]
    q_lens = [e[0] for e in _RPA_EDGES]
    pos0s = [e[1] for e in _RPA_EDGES]
    qp = (len(rpa.ragged_layout(q_lens, pos0s)[0]) + pad_blocks) * 8
    blk_seq, qstart, pos0, _, _ = rpa.ragged_layout(q_lens, pos0s,
                                                    q_bucket=qp)
    q = torch.from_numpy(rng.randn(H, qp, dh).astype(np.float32)).to(
        dev, q_dtype)
    meta = [torch.from_numpy(np.asarray(a, np.int32)).to(dev)
            for a in (blk_seq, qstart, pos0, tables,
                      [e[3] for e in _RPA_EDGES], [e[2] for e in _RPA_EDGES])]
    return q, pool, scales, meta


def _rpa_counts():
    return tuple(getattr(_RPA, c) for c in _RPA_COUNTS)


def _rpa_call(q, pool, scales, meta, route, layer=1):
    """One call, which must count once in its pool kind's total and on
    ``route`` (and the combine once when the tensor-core route splits)."""
    before = _rpa_counts()
    out = _RPA(q, pool, layer, *meta, scales=scales)
    torch.cuda.synchronize()
    quant = pool.dtype in (torch.int8, torch.float8_e4m3fn)
    splits = rpa.split_count(meta[3].shape[1], pool.shape[4])
    step = (int(not quant), int(quant), int(route == "tc"),
            int(route != "tc"), int(route == "tc" and splits > 1))
    assert _rpa_counts() == tuple(b + s for b, s in zip(before, step))
    return out


@pytest.mark.parametrize("storage, bs", [
    (torch.bfloat16, 16), (torch.bfloat16, 32), (torch.bfloat16, 64),
    (torch.int8, 32), (torch.int8, 64),
    (torch.float8_e4m3fn, 32), (torch.float8_e4m3fn, 64)])
@pytest.mark.parametrize("dh", [64, 128])
def test_ragged_attention_tensor_core_route_matches_plain(cuda, storage, bs,
                                                          dh):
    """The edge-case batch through the tensor-core route against the plain
    version, every row (pad rows of real blocks included); pad blocks are
    zeros and a second call gives the same bits."""
    q, pool, scales, meta = _rpa_edge_batch(cuda, storage, dh, bs)
    assert rpa.rpa_route(q.dtype, pool.dtype, dh, bs) == "tc"
    got = _rpa_call(q, pool, scales, meta, "tc")
    want = rpa.ragged_paged_attention_plain(q, pool, 1, *meta, scales=scales)
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got.float(), want.float(),
                               **TOL[torch.bfloat16])
    assert torch.all(got[:, -16:] == 0)
    again = _RPA(q, pool, 1, *meta, scales=scales)
    torch.cuda.synchronize()
    assert torch.equal(got, again)


@pytest.mark.parametrize("storage", [torch.bfloat16, torch.int8])
def test_ragged_attention_tensor_core_route_with_a_long_table(cuda, storage):
    """T far larger than any walk needs: more splits in the grid than any
    tile uses; the CTAs past a tile's walk exit."""
    q, pool, scales, meta = _rpa_edge_batch(cuda, storage, 64, 32,
                                            extra_t=100, seed=1)
    got = _rpa_call(q, pool, scales, meta, "tc")
    want = rpa.ragged_paged_attention_plain(q, pool, 1, *meta, scales=scales)
    torch.testing.assert_close(got.float(), want.float(),
                               **TOL[torch.bfloat16])


@pytest.mark.parametrize("storage", [torch.bfloat16, torch.int8])
def test_ragged_attention_tensor_core_route_in_a_wide_bucket(cuda, storage):
    """200 pad blocks after the batch: the CTAs scan blk_seq 128 blocks at
    a time, and every pad block, in either chunk, is zeros."""
    q, pool, scales, meta = _rpa_edge_batch(cuda, storage, 64, 32,
                                            pad_blocks=200, seed=5)
    assert meta[0].shape[0] > 128
    got = _rpa_call(q, pool, scales, meta, "tc")
    want = rpa.ragged_paged_attention_plain(q, pool, 1, *meta, scales=scales)
    torch.testing.assert_close(got.float(), want.float(),
                               **TOL[torch.bfloat16])
    assert torch.all(got[:, -200 * 8:] == 0)


@pytest.mark.parametrize("storage", [torch.bfloat16, torch.float8_e4m3fn])
def test_ragged_attention_tensor_core_route_all_pad_blocks(cuda, storage):
    q, pool, scales, meta = _rpa_edge_batch(cuda, storage, 64, 32, seed=2)
    meta[0] = torch.full_like(meta[0], -1)
    got = _rpa_call(q, pool, scales, meta, "tc")
    assert torch.all(got == 0)


def test_ragged_attention_tensor_core_route_agrees_with_the_cuda_core_kernel(
        cuda):
    """The same bf16 operands through both kernels, the old one by its C
    entry (which the wrapper no longer takes for them)."""
    from paddle_tpu_torch.ops import _build
    q, pool, _, meta = _rpa_edge_batch(cuda, torch.bfloat16, 64, 16, seed=3)
    got = _rpa_call(q, pool, None, meta, "tc")
    old = torch.empty_like(q)
    rc = _build.function("ragged_paged_attention", "rpa_launch", rpa._ARGS)(
        1, q.data_ptr(), pool.data_ptr(), old.data_ptr(),
        *(m.data_ptr() for m in meta[:3]), meta[3].data_ptr(),
        meta[4].data_ptr(), meta[5].data_ptr(), 2, q.shape[1], 64,
        pool.shape[2], 16, meta[3].shape[1], 1, 0.125,
        torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    assert rc == 0
    torch.testing.assert_close(got.float(), old.float(),
                               **TOL[torch.bfloat16])


def _rpa_core(q, pool, scales, meta, layer=1):
    """The CUDA-core kernel on (q, pool) by its C entry, whatever route
    the wrapper would take; counts nothing."""
    from paddle_tpu_torch.ops import _build
    out = torch.empty_like(q)
    h, qp, dh = q.shape
    args = (*(m.data_ptr() for m in meta), h, qp, dh, pool.shape[2],
            pool.shape[4], meta[3].shape[1], layer, 1.0 / dh ** 0.5,
            torch.cuda.current_stream().cuda_stream)
    if scales is None:
        rc = _build.function("ragged_paged_attention", "rpa_launch",
                             rpa._ARGS)(
            _build.DTYPE_CODE[q.dtype], q.data_ptr(), pool.data_ptr(),
            out.data_ptr(), *args)
    else:
        rc = _build.function("ragged_paged_attention", "rpa_quant_launch",
                             rpa._QUANT_ARGS)(
            rpa._QUANT_CODE[pool.dtype], _build.DTYPE_CODE[q.dtype],
            q.data_ptr(), pool.data_ptr(), scales.data_ptr(),
            out.data_ptr(), *args)
    torch.cuda.synchronize()
    assert rc == 0
    return out


@pytest.mark.parametrize("storage, bs", [
    (torch.float16, 16), (torch.float16, 32), (torch.float16, 64),
    (torch.int8, 32), (torch.int8, 64),
    (torch.float8_e4m3fn, 32), (torch.float8_e4m3fn, 64)])
@pytest.mark.parametrize("dh", [64, 128])
def test_ragged_attention_f16_on_both_routes_matches_plain(cuda, storage, bs,
                                                           dh):
    """float16 q over a float16, int8 or fp8 pool: the edge-case batch
    through the tensor-core route (the wrapper's) and through the
    CUDA-core kernel, each against the plain version at float16's
    tolerance, every row; pad blocks are zeros and a second call gives
    the same bits."""
    q, pool, scales, meta = _rpa_edge_batch(cuda, storage, dh, bs,
                                            q_dtype=torch.float16)
    assert rpa.rpa_route(q.dtype, pool.dtype, dh, bs) == "tc"
    got = _rpa_call(q, pool, scales, meta, "tc")
    want = rpa.ragged_paged_attention_plain(q, pool, 1, *meta, scales=scales)
    assert got.dtype == torch.float16
    torch.testing.assert_close(got.float(), want.float(),
                               **TOL[torch.float16])
    assert torch.all(got[:, -16:] == 0)
    again = _RPA(q, pool, 1, *meta, scales=scales)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    old = _rpa_core(q, pool, scales, meta)
    torch.testing.assert_close(old.float(), want.float(),
                               **TOL[torch.float16])


@pytest.mark.parametrize("storage", [torch.float16, torch.int8])
def test_ragged_attention_f16_tensor_core_route_with_a_long_table(cuda,
                                                                  storage):
    """float16 with more splits than any tile uses, and the combine."""
    q, pool, scales, meta = _rpa_edge_batch(cuda, storage, 64, 32,
                                            extra_t=100, seed=1,
                                            q_dtype=torch.float16)
    got = _rpa_call(q, pool, scales, meta, "tc")
    want = rpa.ragged_paged_attention_plain(q, pool, 1, *meta, scales=scales)
    torch.testing.assert_close(got.float(), want.float(),
                               **TOL[torch.float16])


@pytest.mark.parametrize("case", ["float32 q", "bf16 Dh 32", "bf16 bs 8"])
def test_ragged_attention_cuda_core_route_takes_the_rest(cuda, case):
    dh, bs = (32, 16) if case == "bf16 Dh 32" else (64, 16)
    if case == "bf16 bs 8":
        bs = 8
    q, pool, _, meta = _rpa_edge_batch(cuda, torch.bfloat16, dh, bs, seed=4)
    if case == "float32 q":
        q, pool = q.float(), pool.float()
    assert rpa.rpa_route(q.dtype, pool.dtype, dh, bs) == "cuda_core"
    got = _rpa_call(q, pool, None, meta, "cuda_core")
    want = rpa.ragged_paged_attention_plain(q, pool, 1, *meta)
    torch.testing.assert_close(got.float(), want.float(), **TOL[q.dtype])


# -- generate() and the op layer on the card --------------------------------

def test_layer_norm_op_takes_the_kernel_or_raises(cuda):
    """On the card the ``layer_norm`` op reaches K2 through its override,
    and a dtype the kernels do not take raises there: no plain fallback."""
    from paddle_tpu_torch.framework.dispatch import call_op
    x = torch.randn(4, 768, device=cuda)
    w, b = torch.ones(768, device=cuda), torch.zeros(768, device=cuda)
    before = ln.fused_layer_norm.launches
    got = call_op("layer_norm", x, w, b, epsilon=1e-5)
    torch.cuda.synchronize()
    assert ln.fused_layer_norm.launches == before + 1
    torch.testing.assert_close(got, ln.layer_norm_plain(x, w, b),
                               **TOL[torch.float32])
    with pytest.raises(TypeError, match="float32, bfloat16 or float16"):
        call_op("layer_norm", x.double(), w.double(), b.double())


def _tiny_gpt(cuda, dtype, hidden=64, heads=4):
    from paddle_tpu_torch import seed
    from paddle_tpu_torch.models import GPTConfig, GPTForPretraining
    seed(0)
    cfg = GPTConfig.tiny()
    cfg.hidden_size, cfg.num_attention_heads = hidden, heads
    cfg.max_position_embeddings = 128
    return GPTForPretraining(cfg).to(cuda, dtype).eval()


@pytest.mark.parametrize("masked", [False, True])
def test_generate_launch_counts(cuda, masked):
    """One greedy generate of N tokens at L layers launches K2 (2L + 1) x N
    times (the prefill and N - 1 decode steps) and K4 L times for an
    unmasked prompt, 0 for a left-padded one."""
    net = _tiny_gpt(cuda, torch.float32)
    n, layers = 5, net.gpt.cfg.num_hidden_layers
    ids = torch.randint(1, 256, (2, 16), device=cuda)
    mask = torch.ones_like(ids)
    mask[0, :3] = 0
    ln0, fa0 = ln.fused_layer_norm.launches, fa.flash_attention_fwd.launches
    out = net.generate(ids, max_new_tokens=n,
                       attention_mask=mask if masked else None)
    torch.cuda.synchronize()
    assert out.is_cuda and tuple(out.shape) == (2, 16 + n)
    assert ln.fused_layer_norm.launches - ln0 == (2 * layers + 1) * n
    assert fa.flash_attention_fwd.launches - fa0 == (0 if masked else layers)


def test_generate_bf16_first_token_equals_f32(cuda):
    """bf16 (flash on the tensor-core route at head width 64) and f32 (the
    CUDA-core route) greedy decodes of the same weights pick the same
    first token in every row whose f32 top-2 logit margin exceeds twice
    the largest bf16-vs-f32 logit difference."""
    f32 = _tiny_gpt(cuda, torch.float32, hidden=128, heads=2)
    bf16 = _tiny_gpt(cuda, torch.bfloat16, hidden=128, heads=2)
    ids = torch.randint(1, 256, (16, 64), device=cuda,
                        generator=torch.Generator(cuda).manual_seed(1))
    tc0 = fa.flash_attention_fwd.tc_launches
    a = bf16.generate(ids, max_new_tokens=1)[:, 64]
    assert fa.flash_attention_fwd.tc_launches - tc0 == 2
    b = f32.generate(ids, max_new_tokens=1)[:, 64]
    with torch.no_grad():
        logits = []
        for net in (f32, bf16):
            g = net.gpt
            h, _ = g.prefill(ids, g.init_cache(16, 65, g.wte.weight.dtype))
            logits.append(g.logits(h)[:, 0].float())
    err = (logits[1] - logits[0]).abs().max()
    top2 = logits[0].topk(2, dim=-1).values
    clear = (top2[:, 0] - top2[:, 1]) > 2 * err
    assert clear.any()
    assert torch.equal(a[clear], b[clear])


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16,
                                   torch.float32])
def test_global_norm_clip_multiplies_in_float32_on_the_card(cuda, dtype):
    """The clip's scale multiplies each gradient in float32 and rounds
    once, as the JAX package's ``(g * scale).astype(g.dtype)``: the card's
    fused product of a 16-bit list and an f32 scalar would round the
    scale to 16 bits first."""
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm
    g = torch.Generator(device=cuda).manual_seed(3)
    grads = [_randn(g, n, dtype=dtype) for n in (1000, 4096, 33)]
    pairs = [(torch.nn.Parameter(torch.zeros(1, device=cuda)), x)
             for x in grads]
    out, norm = ClipGradByGlobalNorm(0.3).clip_with_norm(pairs)
    scale = 0.3 / norm.clamp_min(0.3)
    for (_, got), x in zip(out, grads):
        assert got.dtype == dtype
        assert torch.equal(got, (x.float() * scale).to(dtype))
