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


# the five dtype combinations the AdamW kernel takes: (p, g, copy)
_ADAMW_KINDS = ((torch.float32, torch.float32, None),
                (torch.float32, torch.bfloat16, torch.bfloat16),
                (torch.float32, torch.float16, torch.float16),
                (torch.bfloat16, torch.bfloat16, None),
                (torch.float16, torch.float16, None))


def _adamw_edge_list(dev, seed=11):
    """The group kernel's edge cases: each kind at sizes 0, 1, 3, 5, 4097
    and 3 chunks + 7, plus a 4097-element view at an offset of one
    element (no operand 16-byte aligned: the scalar path), and 40 more
    5-element f32 tensors (over one launch's tensor limit); per tensor
    its own lr, decay and step."""
    g = torch.Generator(device=dev).manual_seed(seed)
    lists = [[] for _ in range(8)]

    def add(n, p_dt, g_dt, low_dt, offset=0):
        def make(dt, scale, pos=False):
            buf = _randn(g, n + offset, scale=scale)
            buf = buf.abs() if pos else buf
            return buf.to(dt)[offset:]
        i = len(lists[0])
        for out, x in zip(lists, (
                make(p_dt, 1.0), make(g_dt, 1.0), make(torch.float32, 0.1),
                make(torch.float32, 0.1, pos=True),
                None if low_dt is None else make(low_dt, 1.0),
                1e-3 * (1 + i % 3), 0.01 * (i % 2), 1 + i % 4)):
            out.append(x)

    for p_dt, g_dt, low_dt in _ADAMW_KINDS:
        for n in (0, 1, 3, 5, 4097, 3 * adamw.ADAMW_CHUNK + 7):
            add(n, p_dt, g_dt, low_dt)
        add(4097, p_dt, g_dt, low_dt, offset=1)
    for _ in range(40):
        add(5, torch.float32, torch.float32, None)
    return lists


def test_adamw_group_kernel_matches_plain_on_the_edge_list(cuda):
    ps, gs, ms, vs, lows, lrs, wds, steps = _adamw_edge_list(cuda)
    assert ps[6].data_ptr() % 16 and ps[6].is_contiguous()
    ref = [[None if t is None else t.clone() for t in ts]
           for ts in (ps, ms, vs, lows)]
    hyper = (0.9, 0.999, 1e-8)
    plan = adamw.adamw_plan([p.numel() for p in ps], [
        adamw._check(*o) for o in zip(ps, gs, ms, vs, lows)])
    before = (adamw.fused_adamw_.launches, adamw.fused_adamw_.tensors)
    adamw.fused_adamw_group_(ps, gs, ms, vs, lows, lrs, wds, steps, *hyper)
    torch.cuda.synchronize()
    assert len(plan) > len(_ADAMW_KINDS)      # the f32 kind spans launches
    assert (adamw.fused_adamw_.launches, adamw.fused_adamw_.tensors) == (
        before[0] + len(plan), before[1] + len(ps))
    adamw.adamw_group_plain_(ref[0], gs, ref[1], ref[2], ref[3], lrs, wds,
                             steps, *hyper)
    exact = dict(atol=1e-6, rtol=1e-6)
    for got, want in zip((ps, ms, vs), ref[:3]):
        for a, b in zip(got, want):
            torch.testing.assert_close(a.float(), b.float(), **(
                exact if a.dtype == torch.float32 else TOL[a.dtype]))
    for low, p in zip(lows, ps):
        if low is not None:
            torch.testing.assert_close(low, p.to(low.dtype), atol=0, rtol=0)


def test_adamw_group_on_the_card_never_reaches_the_plain_version(
        cuda, monkeypatch):
    def plain(*a, **kw):
        raise AssertionError("plain AdamW on a CUDA tensor")

    monkeypatch.setattr(adamw, "adamw_plain_", plain)
    p = torch.zeros(8, dtype=torch.float64, device=cuda)
    m, v, g = (torch.zeros(8, device=cuda) for _ in range(3))
    with pytest.raises(TypeError, match="float32, bfloat16 or float16"):
        adamw.fused_adamw_group_([p], [g], [m], [v], [None], [1e-3], [0.0],
                                 [1], 0.9, 0.999, 1e-8)
    q = torch.zeros(8, device=cuda)
    adamw.fused_adamw_group_([q], [g], [m], [v], [None], [1e-3], [0.0],
                             [1], 0.9, 0.999, 1e-8)
    torch.cuda.synchronize()


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


# -- speculative decoding ---------------------------------------------------

def _spec_gpt(dev, dtype):
    """A 2-layer GPT at head width 64 (the tensor-core route's)."""
    from paddle_tpu_torch import seed
    from paddle_tpu_torch.models import GPTConfig, GPTForPretraining
    seed(5)
    cfg = GPTConfig(vocab_size=256, hidden_size=128, num_hidden_layers=2,
                    num_attention_heads=2, intermediate_size=256,
                    max_position_embeddings=256)
    return GPTForPretraining(cfg).to(dev, dtype).eval()


def _verify_operands(dev, S=4, K=4, bs=16, T=4, Q=32, seed=0):
    """One verify launch's operands: slot 0 verifies 4 candidates from
    position 10, slot 1 feeds a 9-row chunk from 5, slot 2 is absent,
    slot 3 verifies 3 from 3; greedy one-hot draft distributions."""
    rng = np.random.RandomState(seed)
    n_spec = np.array([4, 0, 0, 3], np.int32)
    q_lens, pos0s = [4, 9, 0, 3], [10, 5, 0, 3]
    tables = np.zeros((S, T), np.int32)
    tables[0, :1], tables[1, :1], tables[3, :1] = 7, 12, 9
    blk_seq, qstart, pos0, last_row, _ = rpa.ragged_layout(
        q_lens, pos0s, q_bucket=Q)
    ids, qpos, wb, wo = (np.zeros(Q, np.int32) for _ in range(4))
    for s, n in enumerate(q_lens):
        for i in range(n):
            r, p = qstart[s] + i, pos0s[s] + i
            ids[r] = rng.randint(1, 256) if (i == 0 or s == 1) else 0
            qpos[r], wb[r], wo[r] = p, tables[s, p // bs], p % bs
    kv_len = np.asarray([p + n for p, n in zip(pos0s, q_lens)], np.int32)
    drafts = rng.randint(1, 256, (S, K)).astype(np.int32)
    ops = [ids, qpos, wb, wo, blk_seq, qstart, pos0, tables,
           np.zeros(S, np.int32), kv_len, last_row, n_spec, drafts]
    ops = [torch.from_numpy(np.asarray(a, np.int32)).to(dev) for a in ops]
    probs = torch.eye(256, device=dev)[ops[-1].long()]
    return ops + [probs, torch.zeros(S, dtype=torch.bool, device=dev),
                  torch.ones(S, device=dev)]


def test_spec_verify_bf16_on_the_card_matches_the_cpu(cuda):
    """One bf16 verify launch on the card and on a CPU copy (the plain
    versions): the pool rows written within bf16's tolerance (the
    scratch block aside), the same argmax on every head row whose CPU
    top-2 margin exceeds twice the largest logit difference, the same
    draft echo, and K1 once a layer, on the tensor-core route."""
    import copy

    from paddle_tpu_torch.models import generation as gen
    card = _spec_gpt(cuda, torch.bfloat16)
    cpu = copy.deepcopy(card).to("cpu")
    pool = torch.randn(2, 2, 17, 2, 16, 64,
                       generator=torch.Generator().manual_seed(1)).to(
        torch.bfloat16)
    seen, outs, pools = {}, {}, {}
    for where, net in (("cpu", cpu), ("card", card)):
        def spy(h, _g=net.gpt, _w=where):
            out = type(_g).logits(_g, h)
            seen[_w] = out[:, 0].float().cpu()
            return out
        net.gpt.logits = spy
        dev = torch.device("cpu") if where == "cpu" else cuda
        p = pool.clone().to(dev)
        fn = gen.build_spec_verify_fn(net, 4, 32, 4, 4, 16)
        before = _rpa_counts()
        outs[where] = fn(p, *_verify_operands(dev),
                         torch.Generator(dev).manual_seed(0)).cpu()
        pools[where] = p.cpu()
        del net.gpt.logits
        if where == "card":
            torch.cuda.synchronize()
            assert _RPA.launches - before[0] == 2
            assert _RPA.tc_launches - before[2] == 2
    # block 0 excluded: pad rows write it, duplicates with any winner
    torch.testing.assert_close(pools["card"][:, :, 1:].float(),
                               pools["cpu"][:, :, 1:].float(),
                               **TOL[torch.bfloat16])
    err = (seen["card"] - seen["cpu"]).abs().max()
    top2 = seen["cpu"].topk(2, dim=-1).values
    clear = (top2[:, 0] - top2[:, 1]) > 2 * err
    assert clear.any()
    assert torch.equal(seen["card"].argmax(-1)[clear],
                       seen["cpu"].argmax(-1)[clear])
    assert torch.equal(outs["card"][8:24], outs["cpu"][8:24])  # the echo
    if clear.all():
        assert torch.equal(outs["card"], outs["cpu"])


_VERIFY_CTX = (4, 37, 100, 257, 512, 1000, 16, 700)


@pytest.mark.parametrize("storage, bs", [
    (torch.bfloat16, 16), (torch.int8, 32), (torch.float8_e4m3fn, 32)])
def test_ragged_attention_at_a_verify_layout(cuda, storage, bs):
    """K1/K1q at a speculative verify's layout, GPT-2's heads: 8 slots
    of 4 rows each at context lengths 4 to 1000, on the tensor-core
    route, against the plain version; a second call gives the same
    bits."""
    rng = np.random.RandomState(4)
    S, H, dh, rows = len(_VERIFY_CTX), 12, 64, 4
    T = max(-(-(c + rows) // bs) for c in _VERIFY_CTX)
    nb = sum(-(-(c + rows) // bs) for c in _VERIFY_CTX)
    vals = torch.from_numpy(rng.randn(1, 2, nb + 1, H, bs, dh)
                            .astype(np.float32)).to(cuda)
    if storage == torch.bfloat16:
        pool, scales = vals.to(storage), None
    else:
        pool, scales = _quantize_blocks(vals, storage)
    tables = np.zeros((S, T), np.int32)
    free = rng.permutation(np.arange(1, nb + 1)).tolist()
    for s, c in enumerate(_VERIFY_CTX):
        n = -(-(c + rows) // bs)
        tables[s, :n] = [free.pop() for _ in range(n)]
    blk_seq, qstart, pos0, _, _ = rpa.ragged_layout(
        [rows] * S, list(_VERIFY_CTX), q_bucket=S * 8)
    q = torch.from_numpy(rng.randn(H, S * 8, dh).astype(np.float32)).to(
        cuda, torch.bfloat16)
    meta = [torch.from_numpy(np.asarray(a, np.int32)).to(cuda)
            for a in (blk_seq, qstart, pos0, tables, [0] * S,
                      [c + rows for c in _VERIFY_CTX])]
    assert rpa.rpa_route(q.dtype, pool.dtype, dh, bs) == "tc"
    got = _rpa_call(q, pool, scales, meta, "tc", layer=0)
    want = rpa.ragged_paged_attention_plain(q, pool, 0, *meta, scales=scales)
    torch.testing.assert_close(got.float(), want.float(),
                               **TOL[torch.bfloat16])
    again = _RPA(q, pool, 0, *meta, scales=scales)
    torch.cuda.synchronize()
    assert torch.equal(got, again)


def test_spec_chain_makes_no_host_sync(cuda):
    """The draft's proposal chain and the verify launch read nothing back
    to the host: both run under ``torch.cuda.set_sync_debug_mode("error")``
    (after a first call that builds and loads the kernels)."""
    from paddle_tpu_torch.models import generation as gen
    net = _spec_gpt(cuda, torch.bfloat16)
    draft = gen.make_draft_model(net, 1)
    S, K, L = 4, 4, 64
    dpool = torch.zeros(1, 2, S, 2, L, 64, dtype=torch.bfloat16, device=cuda)
    scan = gen.build_draft_propose_scan_fn(draft, S, L, K)
    verify = gen.build_spec_verify_fn(net, S, 32, K, 4, 16)
    pool = torch.zeros(2, 2, 17, 2, 16, 64, dtype=torch.bfloat16,
                       device=cuda)
    i32 = dict(dtype=torch.int32, device=cuda)
    feed = torch.tensor([5, 6, 7, 8], **i32)
    pos = torch.tensor([3, 10, 0, 20], **i32)
    lo = torch.zeros(S, **i32)
    sample = torch.tensor([False, True, False, True], device=cuda)
    temps = torch.full((S,), 0.8, device=cuda)
    gen_ = torch.Generator(cuda).manual_seed(0)

    def chain():
        d, q = scan(dpool, feed, pos, lo, sample, temps, gen_)
        ops = _verify_operands(cuda)
        return verify(pool, *ops[:12], d, q, *ops[14:], gen_)

    chain()
    torch.cuda.synchronize()
    ops = _verify_operands(cuda)           # host-to-device copies first
    torch.cuda.set_sync_debug_mode("error")
    try:
        d, q = scan(dpool, feed, pos, lo, sample, temps, gen_)
        out = verify(pool, *ops[:12], d, q, *ops[14:], gen_)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    out = out.cpu()
    assert out.shape == (2 * S + S * K + 1,) and out[-1] == 0
    assert torch.equal(out[2 * S:-1].view(S, K), d.cpu())


def _tiered_card_pool(cuda, kind):
    from paddle_tpu_torch.serving import HostBlockPool, PagedKVPool
    pool = PagedKVPool(2, 2, 2, 64, 64, block_size=32, num_blocks=6,
                       min_bucket=32, dtype=kind, device=cuda)
    tier = HostBlockPool(8 * (pool.host_block_nbytes
                              + pool.host_scale_nbytes),
                         pool.host_block_nbytes,
                         scale_nbytes=pool.host_scale_nbytes, device=cuda)
    pool.attach_host_tier(tier)
    assert tier._arena.is_pinned()
    g = torch.Generator(device=cuda).manual_seed(5)
    vals = torch.randn(pool.shape, device=cuda, generator=g)
    if pool.quantized:
        pool.data.copy_((vals * 40).clamp(-127, 127).to(torch.int8))
        pool.scales.copy_(torch.rand(pool.scales_shape, device=cuda,
                                     generator=g))
    else:
        pool.data.copy_(vals.to(pool.dtype))
    toks = tuple(range(100, 164))              # 2 full blocks
    slot = pool.alloc()
    pool.admit_fresh(slot, len(toks) + 1)
    pool.register_prefix(slot, toks)
    pool.free(slot)
    return pool, tier, toks


@pytest.mark.parametrize("kind", ["bfloat16", "int8"])
def test_host_tier_pinned_round_trip_is_bit_exact(cuda, kind):
    """Demote two published blocks through the pinned arena, evict them,
    promote them back into other blocks: codes (and scales) bit for
    bit."""
    pool, tier, toks = _tiered_card_pool(cuda, kind)
    try:
        blocks = pool.match_prefix(list(toks) + [1])
        want = [pool.data[:, :, b].cpu() for b in blocks]
        want_s = [pool.scales[:, :, b].cpu() for b in blocks] \
            if pool.quantized else None
        pool.tier_tick()
        tier.drain()
        for i in range(2):
            host, scale = tier.get(toks[:(i + 1) * 32])
            assert torch.equal(host, want[i])
            if want_s is not None:
                assert torch.equal(scale, want_s[i])
        while pool._lru:
            pool._evict_one()
        pool.data[:, :, blocks] = 0           # the old blocks' bytes gone
        slot = pool.alloc()
        pool.admit_fresh(slot, 32)             # the promotion lands elsewhere
        tk = tier.request_promotion(pool.tier_match(list(toks) + [1])[0])
        assert tk.ready.wait(30)
        while not tk.landed():
            pass
        assert pool.adopt_promotion(tk)
        got = pool.match_prefix(list(toks) + [1])
        assert len(got) == 2 and got != blocks
        torch.cuda.synchronize()
        for i, b in enumerate(got):
            assert torch.equal(pool.data[:, :, b].cpu(), want[i])
            if want_s is not None:
                assert torch.equal(pool.scales[:, :, b].cpu(), want_s[i])
        s = tier.stats()
        assert s["promotion_copy_gb_per_s"] > 0
        assert s["demotion_copy_gb_per_s"] > 0
    finally:
        tier.close()


def test_tier_tick_and_adopt_promotion_never_synchronise(cuda):
    """The scheduler thread's tier calls, the demotion gather and the
    adoption's copies, run under ``torch.cuda.set_sync_debug_mode(
    "error")``."""
    pool, tier, toks = _tiered_card_pool(cuda, "int8")
    try:
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            pool.tier_tick()
        finally:
            torch.cuda.set_sync_debug_mode(0)
        tier.drain()
        while pool._lru:
            pool._evict_one()
        tk = tier.request_promotion(pool.tier_match(list(toks) + [1])[0])
        assert tk.ready.wait(30)
        torch.cuda.set_sync_debug_mode("error")
        try:
            landed = tk.landed()
            adopted = pool.adopt_promotion(tk)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        assert adopted and len(pool.match_prefix(list(toks) + [1])) == 2
        assert isinstance(landed, bool)
    finally:
        tier.close()


def _numerics_model(cuda):
    """``Model`` over the 2-layer head-width-64 GPT in bf16 O2 with the
    numerics audit armed, as ``fit(numerics=...)`` arms it, and a batch
    on the card."""
    from paddle_tpu_torch.hapi import Model
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.profiler import numerics
    net = _spec_gpt(cuda, torch.float32).train()
    m = Model(net, inputs=["ids", "labels"])
    m.prepare(AdamW(1e-3, parameters=net.parameters(),
                    multi_precision=True),
              loss=lambda loss, logits: loss,
              amp_configs={"level": "O2", "dtype": "bfloat16"})
    m._numerics_mode = "warn"
    m._numerics_recorder = numerics.NumericsRecorder()
    m._audit_layout = numerics.AuditLayout.build(list(m._audit_params()))
    m._audit_collect = True
    g = torch.Generator(device=cuda).manual_seed(3)
    ids = torch.randint(0, 256, (2, 128), device=cuda, generator=g)
    return m, [ids, ids.clone()]


def test_memory_marks_unarmed_spans_and_the_audit_never_synchronise(cuda):
    """Between the log windows nothing of the observability layer reads
    the card back: ``memory.mark``, the scheduler's spans with no session
    armed and two audited train steps run under
    ``torch.cuda.set_sync_debug_mode("error")``; the window after them
    fetches the loss and both audits in one copy."""
    from paddle_tpu_torch.profiler import memory
    from paddle_tpu_torch.profiler import span
    m, batch = _numerics_model(cuda)
    m._train_step(batch[:2], [])             # builds the kernels
    loss = m._flush(m._train_step(batch[:2], [])[0], [])["loss"]
    torch.cuda.synchronize()
    assert not span.is_active()
    torch.cuda.set_sync_debug_mode("error")
    try:
        memory.mark("serving/cycle", cycle=1, active=2)
        with span.record("serving/cycle", "serving", args={"cycle": 1}):
            with span.record("serving/decode_dispatch", "serving"):
                last, _ = m._train_step(batch[:2], [])
        last, _ = m._train_step(batch[:2], [])
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert len(m._audit_window) == 2
    logs = m._flush(last, [])
    snap = m._numerics_recorder.snapshot()
    assert [r["step"] for r in snap["records"]] == [1, 2, 3, 4]
    assert all(r["finite"] for r in snap["records"])
    assert logs["loss"] == snap["records"][-1]["loss"] and np.isfinite(loss)


def test_fleet_launch_and_span_counts_stay_exact_across_threads(cuda):
    """Two fused engines over one bf16 model on two scheduler threads,
    under an armed session: each kernel's count is exactly the steps of
    both, and each engine's ``serving/cycle`` spans its recorder's
    cycles."""
    from paddle_tpu_torch import profiler
    from paddle_tpu_torch.serving import EngineFleet, GenerationEngine
    net = _spec_gpt(cuda, torch.bfloat16)
    engines = [GenerationEngine(net, kv_layout="paged", attention="fused",
                                num_slots=4, block_size=16, device=cuda)
               for _ in range(2)]
    fleet = EngineFleet(engines)
    fleet.submit(np.arange(1, 9), max_new_tokens=2).result(timeout=120)
    for e in engines:
        while e._sched._rec is not None or e._sched.active:
            pass
    rng = np.random.RandomState(0)
    steps0 = sum(e.stats()["steps"] for e in engines)
    cycles0 = [e.flight_recorder.cycles_recorded for e in engines]
    for attr in ("launches", "quant_launches", "tc_launches",
                 "core_launches", "combine_launches"):
        setattr(rpa.ragged_paged_attention, attr, 0)
    ln.fused_layer_norm.launches = 0
    with profiler.profile():
        hs = [fleet.submit(rng.randint(1, 256, int(rng.randint(8, 80))),
                           max_new_tokens=6) for _ in range(12)]
        for h in hs:
            h.result(timeout=300)
        for e in engines:
            while e._sched._rec is not None or e._sched.active:
                pass
    steps = sum(e.stats()["steps"] for e in engines) - steps0
    fleet.close()
    assert rpa.ragged_paged_attention.launches == 2 * steps
    assert ln.fused_layer_norm.launches == 5 * steps
    by_tid = {}
    for ev in profiler.events():
        if ev["name"] == "serving/cycle":
            by_tid[ev["tid"]] = by_tid.get(ev["tid"], 0) + 1
    want = sorted(e.flight_recorder.cycles_recorded - c0
                  for e, c0 in zip(engines, cycles0))
    assert sorted(by_tid.values()) == want


def test_fit_oom_postmortem_reraises_the_original_error(cuda, tmp_path):
    """A batch whose logits cannot fit on the card: ``fit`` raises the
    allocator's own ``torch.cuda.OutOfMemoryError`` after the memory
    postmortem, which holds the ledger and the largest live tensors."""
    import gc
    import json
    from paddle_tpu_torch import io, seed
    from paddle_tpu_torch.hapi import Model
    from paddle_tpu_torch.models import GPTConfig, GPTForPretraining
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.profiler import memory
    seed(0)
    net = GPTForPretraining(GPTConfig(
        vocab_size=50304, hidden_size=64, num_hidden_layers=1,
        num_attention_heads=1, intermediate_size=128,
        max_position_embeddings=1024))
    m = Model(net, inputs=["ids", "labels"])
    m.prepare(AdamW(1e-3, parameters=net.parameters()),
              loss=lambda loss, logits: loss)
    ids = torch.zeros(2048, 1024, dtype=torch.int64, device=cuda)
    dumps = memory.tracker().dumps
    try:
        with pytest.raises(torch.cuda.OutOfMemoryError):
            m.fit(io.TensorDataset([ids, ids]), batch_size=2048, verbose=0)
        assert memory.tracker().dumps == dumps + 1
        with open(memory.tracker().last_dump_path) as f:
            doc = json.load(f)
        assert doc["phase"] == "Model.fit"
        assert "OutOfMemoryError" in doc["reason"]
        assert any(k.endswith("/params") for k in doc["ledger"])
        assert doc["largest_live_arrays"][0]["nbytes"] > 0
        assert doc["crosscheck"]["device_bytes_in_use"] > 0
    finally:
        del m, net, ids
        gc.collect()
        torch.cuda.empty_cache()


def _launch_counts():
    return (fa.flash_attention_fwd.launches, fa.flash_attention_bwd.launches,
            ln.fused_layer_norm.launches, ln.fused_layer_norm_bwd.launches)


def test_transformer_block_launches_flash_and_layer_norm(cuda):
    """An ``nn.TransformerEncoderLayer`` and a ``TransformerDecoderLayer``
    on the card under bf16 O1, forward and backward: the encoder's
    self-attention and the decoder's cross-attention launch K4 once each
    and K6 once each (the tensor-core route), their five post-norm
    LayerNorms K2 and K3 five times each (the warp-row route), and the
    decoder's masked self-attention runs the op's plain body."""
    from paddle_tpu_torch import amp, nn, seed
    from paddle_tpu_torch.framework import monitor
    seed(0)
    enc = nn.TransformerEncoderLayer(512, 8, 2048, dropout=0.0).to(cuda)
    dec = nn.TransformerDecoderLayer(512, 8, 2048, dropout=0.0).to(cuda)
    x = torch.randn(2, 128, 512, device=cuda)
    y = torch.randn(2, 128, 512, device=cuda)
    mask = nn.Transformer.generate_square_subsequent_mask(128, device=cuda)
    before, tc = _launch_counts(), fa.flash_attention_fwd.tc_launches
    warp = ln.fused_layer_norm.warp_launches
    sdpa = monitor.stat_get("op_count/scaled_dot_product_attention")
    with amp.auto_cast(level="O1"):
        out = dec(y, enc(x), tgt_mask=mask)
    out.float().square().mean().backward()
    torch.cuda.synchronize()
    moved = tuple(a - b for a, b in zip(_launch_counts(), before))
    assert moved == (2, 2, 5, 5)
    assert fa.flash_attention_fwd.tc_launches - tc == 2
    assert ln.fused_layer_norm.warp_launches - warp == 5
    assert monitor.stat_get("op_count/scaled_dot_product_attention") \
        - sdpa == 3
    assert torch.isfinite(out).all()
    assert all(p.grad is not None and torch.isfinite(p.grad).all()
               for p in list(enc.parameters()) + list(dec.parameters()))


def test_masked_attention_reaches_the_plain_body_and_no_kernel(cuda):
    """A mask (or attention dropout) runs the op's plain body on the card,
    where the JAX override refuses too: no flash launch."""
    from paddle_tpu_torch import nn
    attn = nn.MultiHeadAttention(64, 4).to(cuda)
    x = torch.randn(2, 16, 64, device=cuda)
    mask = torch.rand(2, 1, 16, 16, device=cuda) > 0.2
    before = _launch_counts()
    out = attn(x, attn_mask=mask)
    out.sum().backward()
    torch.cuda.synchronize()
    assert _launch_counts() == before
    want = F.sdpa_reference(
        attn._split_heads(attn.q_proj(x)), attn._split_heads(attn.k_proj(x)),
        attn._split_heads(attn.v_proj(x)),
        mask=nn.layer.transformer._convert_attn_mask(mask, torch.float32))
    torch.testing.assert_close(
        out, attn.out_proj(attn._merge_heads(want)), **TOL[torch.float32])


def test_setitem_on_the_card_leaves_its_input_alone(cuda):
    from paddle_tpu_torch.framework.dispatch import call_op
    x = torch.zeros(4, 6, device=cuda)
    idx = torch.tensor([3, 0], device=cuda)
    out = call_op("setitem", x, torch.tensor(2.0, device=cuda), idx,
                  index_spec=(("array",), ("slice", None, None, -2)))
    torch.cuda.synchronize()
    assert out.is_cuda and not x.any()
    assert out.sum().item() == 2.0 * 2 * 3
    assert out[[0, 3]][:, 1::2].eq(2).all()


def _all_kernel_counts():
    """K1-K8's launch counters (K1 and K1q apart)."""
    return (rpa.ragged_paged_attention.launches,
            rpa.ragged_paged_attention.quant_launches) + _launch_counts() \
        + (adamw.fused_adamw_.launches,)


def test_conv_bn_pool_block_in_nhwc_stays_on_the_card(cuda):
    """``Conv2D`` + ``BatchNorm2D`` + ``MaxPool2D`` in NHWC on the card,
    forward and backward: the output, the running statistics and every
    gradient lie on the card, the step reads nothing back to the host,
    and the result equals the same block on the CPU (float32, atol
    1e-4)."""
    import copy
    from paddle_tpu_torch import nn, seed
    seed(0)
    host = nn.Sequential(nn.Conv2D(3, 8, 3, padding=1, data_format="NHWC"),
                         nn.BatchNorm2D(8, data_format="NHWC"),
                         nn.MaxPool2D(3, stride=2, padding=1,
                                      data_format="NHWC"))
    card = copy.deepcopy(host).to(cuda)
    x = torch.randn(4, 16, 16, 3)
    xc = x.to(cuda).requires_grad_()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = card(xc)
        out.square().mean().backward()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert out.is_cuda and out.shape == (4, 8, 8, 8)
    assert all(t.is_cuda for t in [xc.grad] + list(card.buffers())
               + [p.grad for p in card.parameters()])
    xh = x.clone().requires_grad_()
    want = host(xh)
    want.square().mean().backward()
    torch.testing.assert_close(out.cpu(), want, **TOL[torch.float32])
    torch.testing.assert_close(xc.grad.cpu(), xh.grad, **TOL[torch.float32])
    for (name, p), q in zip(card.named_parameters(), host.parameters()):
        torch.testing.assert_close(p.grad.cpu(), q.grad, atol=1e-4,
                                   rtol=1e-4, msg=name)
    torch.testing.assert_close(card[1]._variance.cpu(), host[1]._variance,
                               **TOL[torch.float32])


@pytest.mark.parametrize("nd", [2, 3])
def test_max_pool_mask_round_trips_through_max_unpool(cuda, nd):
    """``max_pool{nd}d(return_mask=True)`` then ``max_unpool{nd}d`` on the
    card: the mask equals the CPU's (int32, flat over the spatial dims)
    and unpooling puts every window's maximum back in place."""
    from paddle_tpu_torch.nn import functional as TF
    x = torch.randn(*((2, 3) + (8,) * nd))
    pool, unpool = getattr(TF, f"max_pool{nd}d"), getattr(
        TF, f"max_unpool{nd}d")
    out, mask = pool(x.to(cuda), 2, stride=2, return_mask=True)
    back = unpool(out, mask, 2, stride=2)
    assert out.is_cuda and mask.is_cuda and back.is_cuda
    assert mask.dtype == torch.int32
    want_out, want_mask = pool(x, 2, stride=2, return_mask=True)
    torch.testing.assert_close(out.cpu(), want_out)
    assert torch.equal(mask.cpu(), want_mask)
    kept = back.cpu() != 0
    assert int(kept.sum()) == out.numel()
    torch.testing.assert_close(back.cpu()[kept], x[kept])


def test_resnet18_momentum_step_launches_no_kernel(cuda):
    """A ``resnet18`` Momentum step on the card (bf16 O2, NHWC) runs no
    hand-written kernel: K1-K8's counters stay where they were, as the
    JAX package runs ResNet without a Pallas kernel. The loss is
    finite and the parameters move."""
    from paddle_tpu_torch import amp, nn, seed
    from paddle_tpu_torch.optimizer import Momentum
    from paddle_tpu_torch.vision.models import resnet18
    seed(0)
    net = resnet18(num_classes=10, data_format="NHWC").to(cuda)
    amp.decorate(net, level="O2", dtype="bfloat16")
    opt = Momentum(0.1, 0.9, parameters=net.parameters(),
                   multi_precision=True)
    x = torch.randn(4, 32, 32, 3, device=cuda)
    y = torch.randint(0, 10, (4, 1), device=cuda)
    before = _all_kernel_counts()
    w0 = net.fc.weight.detach().clone()
    with amp.auto_cast(level="O2", dtype="bfloat16"):
        loss = nn.CrossEntropyLoss()(net(x), y)
    loss.backward()
    opt.step()
    torch.cuda.synchronize()
    assert _all_kernel_counts() == before
    assert torch.isfinite(loss) and not torch.equal(net.fc.weight, w0)


def test_bert_qa_step_launches_the_kernels_without_a_host_sync(cuda):
    """A 2-layer BERT at base width (QA head) under bf16 O2, forward and
    backward with ``set_sync_debug_mode("error")`` on: K4 and K6 once a
    layer on the tensor-core route at ``[2, 128, 12, 64]`` not causal, K2
    and K3 once a LayerNorm (5) on the warp-row route; the loss and every
    gradient finite, the pooler's none."""
    from paddle_tpu_torch import amp, seed
    from paddle_tpu_torch.models.bert import (BertConfig,
                                              BertForQuestionAnswering)
    seed(0)
    net = BertForQuestionAnswering(BertConfig(
        num_hidden_layers=2, hidden_dropout_prob=0.0,
        attention_dropout_prob=0.0)).to(cuda)
    amp.decorate(net, level="O2", dtype="bfloat16")
    ids = torch.randint(0, 30522, (2, 128), device=cuda)
    pos = torch.tensor([3, 77], device=cuda)
    before, tc = _launch_counts(), fa.flash_attention_fwd.tc_launches
    warp = ln.fused_layer_norm_bwd.warp_launches
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        with amp.auto_cast(level="O2", dtype="bfloat16"):
            loss = net(ids, start_positions=pos, end_positions=pos)[0]
        loss.backward()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert tuple(a - b for a, b in zip(_launch_counts(), before)) == \
        (2, 2, 5, 5)
    assert fa.flash_attention_fwd.tc_launches - tc == 2
    assert ln.fused_layer_norm_bwd.warp_launches - warp == 5
    assert torch.isfinite(loss)
    pooler = {id(p) for p in net.bert.pooler.parameters()}
    for p in net.parameters():
        assert (p.grad is None) == (id(p) in pooler)
        assert p.grad is None or torch.isfinite(p.grad).all()


def test_sequence_ops_on_the_card_read_nothing_back(cuda):
    """Every ``sequence_ops`` case on CUDA tensors under
    ``set_sync_debug_mode("error")``, each result on the card and equal
    to the CPU's (float32 atol 1e-5 + rtol 1e-5, integers exactly)."""
    from paddle_tpu_torch.framework.dispatch import call_op
    from paddle_tpu_torch.ops import op_cases, sequence_ops
    from paddle_tpu_torch.ops.registry import get_op
    cases = {k: c for k, c in op_cases.cases().items()
             if get_op(c.name).fn.__module__ == sequence_ops.__name__}
    assert len({c.name for c in cases.values()}) == 13

    def conv(a, dev):
        if isinstance(a, np.ndarray):
            return torch.as_tensor(np.array(a), device=dev)
        if isinstance(a, list):
            return [conv(v, dev) for v in a]
        return a

    for key, case in sorted(cases.items()):
        args = [conv(a, cuda) for a in case.args]
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            got = call_op(case.name, *args, **case.attrs)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        want = call_op(case.name, *[conv(a, "cpu") for a in case.args],
                       **case.attrs)
        outs = got if isinstance(got, tuple) else (got,)
        assert all(o.is_cuda for o in outs), key
        op_cases.check(case, op_cases.to_numpy_tree(got),
                       op_cases.to_numpy_tree(want), 1e-5, 1e-5)


def test_seq2seq_generate_on_the_card_equals_the_cpu(cuda):
    """A small float32 ``TransformerModel`` decodes on the card as on a
    CPU copy, greedy and with beams: the same tokens (a model whose
    logits have clear margins: its output projection scaled by 10); K2
    launches 2 x L + 3 x L a decode step, no flash kernel."""
    import copy

    from paddle_tpu_torch import seed
    from paddle_tpu_torch.models.seq2seq import TransformerModel
    seed(0)
    host = TransformerModel(50, 50, d_model=64, nhead=4,
                            num_encoder_layers=2, num_decoder_layers=2,
                            dim_feedforward=128, max_length=32).eval()
    with torch.no_grad():
        host.out_proj.weight.mul_(10.0)
    card = copy.deepcopy(host).to(cuda)
    src = torch.randint(2, 50, (3, 10))
    src[1, 6:] = 0
    for kw in ({}, {"num_beams": 3, "length_penalty": 0.6}):
        before = _launch_counts()
        got = card.generate(src.to(cuda), max_length=12, **kw)
        torch.cuda.synchronize()
        moved = tuple(a - b for a, b in zip(_launch_counts(), before))
        assert moved[:2] == (0, 0) and moved[3] == 0
        assert moved[2] % 6 == 4 and moved[2] >= 4 + 6
        assert torch.equal(got.cpu(), host.generate(src, max_length=12,
                                                    **kw))


def test_lstm_on_the_card_equals_the_cpu(cuda):
    """A bidirectional 2-layer ``nn.LSTM`` with ``sequence_length`` on the
    card against a CPU copy: outputs, final states and gradients within
    atol 1e-4."""
    import copy

    from paddle_tpu_torch import nn, seed
    seed(0)
    host = nn.LSTM(16, 32, num_layers=2, direction="bidirect")
    card = copy.deepcopy(host).to(cuda)
    x = torch.randn(4, 12, 16)
    lengths = torch.tensor([12, 7, 3, 10])
    res = []
    for net, dev in ((card, cuda), (host, "cpu")):
        xt = x.to(dev).requires_grad_()
        y, (h, c) = net(xt, sequence_length=lengths.to(dev))
        (y.square().sum() + h.sum() + c.sum()).backward()
        res.append([t.detach().cpu() for t in (y, h, c, xt.grad)] +
                   [p.grad.cpu() for p in net.parameters()])
    for got, want in zip(*res):
        torch.testing.assert_close(got, want, atol=1e-4, rtol=0)


def _deploy_bert(device, layers=2):
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.models.bert import (BertConfig,
                                              BertForQuestionAnswering)
    pt.seed(0)
    cfg = BertConfig(vocab_size=1000, hidden_size=128,
                     num_hidden_layers=layers, num_attention_heads=2,
                     intermediate_size=256,
                     hidden_dropout_prob=0.0, attention_dropout_prob=0.0)
    return BertForQuestionAnswering(cfg).to(device).eval()


def _deploy_specs():
    from paddle_tpu_torch.static import InputSpec
    return [InputSpec([None, 32], "int64", "input_ids"),
            InputSpec([None, 32], "int64", "token_type_ids")]


def test_custom_ops_launch_on_cuda_tensors_and_trace_without(cuda):
    from paddle_tpu_torch.framework.static_capture import export_scope
    g = torch.Generator(device=cuda).manual_seed(7)
    x = torch.randn(64, 768, device=cuda, generator=g)
    w, b = torch.ones(768, device=cuda), torch.zeros(768, device=cuda)
    q = torch.randn(2, 128, 4, 64, device=cuda, generator=g).bfloat16()
    n_ln, n_fa = ln.fused_layer_norm.launches, fa.flash_attention_fwd.launches
    y = torch.ops.paddle_tpu_torch.fused_layer_norm(x, w, b, 1e-5)
    o, lse = torch.ops.paddle_tpu_torch.flash_attention_fwd(
        q, q, q, False, 0.125)
    torch.cuda.synchronize()
    assert (ln.fused_layer_norm.launches, fa.flash_attention_fwd.launches) \
        == (n_ln + 1, n_fa + 1)
    torch.testing.assert_close(y, ln.layer_norm_plain(x, w, b), **TOL[
        torch.float32])
    want_o, want_lse = fa.flash_attention_fwd_plain(q, q, q, False, 0.125)
    torch.testing.assert_close(o.float(), want_o.float(),
                               **TOL[torch.bfloat16])
    assert lse.dtype == torch.float32 and lse.shape == (2, 4, 128)

    class M(torch.nn.Module):
        def forward(self, x, q):
            return (torch.ops.paddle_tpu_torch.fused_layer_norm(x, w, b, 1e-5),
                    fa.flash_attention(q, q, q))

    with torch.no_grad(), export_scope():
        torch.export.export(M(), (x, q))
    assert (ln.fused_layer_norm.launches, fa.flash_attention_fwd.launches) \
        == (n_ln + 1, n_fa + 1)


def test_exported_bert_launches_the_kernels_from_the_loaded_program(
        cuda, tmp_path):
    from paddle_tpu_torch import inference, jit
    net = _deploy_bert(cuda)
    jit.save(net, str(tmp_path / "b"), input_spec=_deploy_specs())
    pred = inference.create_predictor(
        inference.Config(str(tmp_path / "b.pdmodel")))
    assert pred.device.type == "cuda"
    for rows in (1, 5):
        ids = np.random.RandomState(rows).randint(0, 1000, (rows, 32))
        types = np.zeros_like(ids)
        before = (ln.fused_layer_norm.warp_launches,
                  fa.flash_attention_fwd.launches)
        got = pred.run([ids, types])
        torch.cuda.synchronize()
        # 2L + 1 LayerNorms (warp-row), L flash forwards (float32: the
        # CUDA-core route)
        assert (ln.fused_layer_norm.warp_launches - before[0],
                fa.flash_attention_fwd.launches - before[1]) == (5, 2)
        with torch.no_grad():
            want = net(torch.from_numpy(ids).to(cuda),
                       torch.from_numpy(types).to(cuda))
        for g, w in zip(got, want):
            torch.testing.assert_close(torch.from_numpy(g), w.cpu(),
                                       **TOL[torch.float32])


def test_an_artifact_saved_on_the_card_runs_on_the_cpu_and_back(
        cuda, tmp_path):
    from paddle_tpu_torch import jit
    net = _deploy_bert(cuda, layers=1)
    jit.save(net, str(tmp_path / "c"), input_spec=_deploy_specs())
    ids = np.random.RandomState(0).randint(0, 1000, (3, 32))
    types = np.zeros_like(ids)
    host = jit.load(str(tmp_path / "c"), device="cpu")
    card = jit.load(str(tmp_path / "c"))
    assert card.device.type == "cuda"
    on_cpu = host(ids, types)
    on_card = card(ids, types)
    for a, b in zip(on_cpu, on_card):
        assert a.device.type == "cpu" and b.device.type == "cuda"
        torch.testing.assert_close(b.cpu(), a, **TOL[torch.float32])


def test_device_prefetch_copies_on_its_side_stream(cuda, monkeypatch):
    """While the consumer's stream is held by a long kernel, the batch it
    was handed is already on the card: the copy ran on the prefetch's own
    stream (read back through that stream, the other still busy)."""
    from paddle_tpu_torch import io
    made = []

    class Recording(torch.cuda.Stream):
        def __new__(cls, *a, **kw):
            s = super().__new__(cls, *a, **kw)
            if "stream_id" not in kw:   # a new stream, not current_stream()
                made.append(s)
            return s

    monkeypatch.setattr(torch.cuda, "Stream", Recording)
    src = torch.arange(1 << 20, dtype=torch.float32)
    back = torch.empty_like(src).pin_memory()
    # a first run fills the pinned-memory cache: allocating pinned memory
    # may wait for the card, reusing it does not
    assert len(list(io.device_prefetch([(src,)], device=cuda))) == 1
    torch.cuda.synchronize()
    torch.cuda._sleep(2_000_000_000)              # ~1 s on the consumer's
    it = io.device_prefetch([(src,)], device=cuda)
    (x,) = next(it)
    side = made[-1]
    with torch.cuda.stream(side):
        back.copy_(x, non_blocking=True)
    side.synchronize()
    busy = not torch.cuda.current_stream().query()
    torch.cuda.synchronize()
    assert busy, "the consumer's stream finished before the check"
    assert torch.equal(back, src)
    assert list(it) == []


def test_device_prefetch_batches_stay_right_after_the_producer_moves_on(
        cuda):
    """Each batch is read by a kernel queued behind a long one on the
    consumer's stream after its last reference is dropped, while the
    producer copies the next ones: the allocator must not hand its memory
    out early (``record_stream``). Pinning, copies, event waits: no host
    sync under sync debug "error"."""
    from paddle_tpu_torch import io
    batches = [(torch.full((1 << 20,), float(i)),
                torch.full((4,), i, dtype=torch.int64)) for i in range(8)]
    sums = []
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for x, y in io.device_prefetch(batches, buffer_size=2, device=cuda):
            torch.cuda._sleep(20_000_000)
            sums.append((x.sum(), y.sum()))
            del x, y
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert [(float(a), int(b)) for a, b in sums] == [
        (float(i * (1 << 20)), 4 * i) for i in range(8)]


def _served_gpt(cuda, dtype=torch.bfloat16):
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.models import GPTConfig, GPTForPretraining
    pt.seed(0)
    cfg = GPTConfig(vocab_size=512, hidden_size=128, num_hidden_layers=2,
                    num_attention_heads=2, intermediate_size=256,
                    max_position_embeddings=128, hidden_dropout_prob=0.0,
                    attention_dropout_prob=0.0)
    return GPTForPretraining(cfg).to(cuda, dtype).eval()


@pytest.mark.parametrize("kw", [dict(max_new_tokens=6),
                                dict(max_new_tokens=5, num_beams=3)],
                         ids=["greedy", "beams"])
def test_a_served_generate_artifact_launches_the_kernels(cuda, tmp_path, kw):
    """``save_for_serving`` on the card: the loaded artifact's tokens equal
    eager ``generate``'s, and each call launches K2 (2L + 1) a forward
    (warp-row) and K4 L times in the prefill (tensor-core), counted by
    the wrappers inside the ``while_loop``'s body too."""
    from paddle_tpu_torch import jit
    from paddle_tpu_torch.models import save_for_serving
    net = _served_gpt(cuda)
    ids = torch.randint(1, 512, (2, 16), device=cuda,
                        generator=torch.Generator(cuda).manual_seed(1))
    want = net.generate(ids, **kw)
    save_for_serving(net, str(tmp_path / "g"), batch=2, prompt_len=16, **kw)
    layer = jit.load(str(tmp_path / "g"))
    before = (ln.fused_layer_norm.launches, ln.fused_layer_norm.warp_launches,
              fa.flash_attention_fwd.launches,
              fa.flash_attention_fwd.tc_launches)
    got = layer(ids.to(torch.int32).cpu().numpy())
    torch.cuda.synchronize()
    after = (ln.fused_layer_norm.launches, ln.fused_layer_norm.warp_launches,
             fa.flash_attention_fwd.launches,
             fa.flash_attention_fwd.tc_launches)
    forwards = kw["max_new_tokens"]
    assert [a - b for a, b in zip(after, before)] == [
        5 * forwards, 5 * forwards, 2, 2]
    assert got.is_cuda and torch.equal(got, want)


def test_a_keyed_artifact_draws_on_the_card_as_on_the_cpu(cuda, tmp_path):
    """The counted draw is integer arithmetic and a float32 transform of
    it: the card's sampled tokens equal the same artifact's on the CPU
    (float32 weights, so the logits agree far inside a draw's margin)."""
    from paddle_tpu_torch import jit
    from paddle_tpu_torch.models import save_for_serving
    net = _served_gpt(cuda, torch.float32)
    save_for_serving(net, str(tmp_path / "k"), batch=2, prompt_len=8,
                     max_new_tokens=6, do_sample=True, top_k=20,
                     runtime_key=True)
    ids = np.random.RandomState(2).randint(1, 512, (2, 8)).astype(np.int32)
    key = np.array([7, 0xFFFFFFF0], np.uint32)
    card = jit.load(str(tmp_path / "k"))(ids, key)
    host = jit.load(str(tmp_path / "k"), device="cpu")(ids, key)
    assert card.is_cuda and torch.equal(card.cpu(), host)


def _vision_case_operands(case, dev):
    def conv(a):
        return None if a is None else torch.as_tensor(np.array(a),
                                                      device=dev)
    return [conv(a) for a in case.args], case.attrs


@pytest.mark.parametrize("key", [
    "roi_align", "roi_align_unaligned", "roi_pool", "roi_pool_edges",
    "psroi_pool", "nms",
    "nms_top_k", "nms_unscored", "deform_conv2d", "deform_conv2d_groups",
    "yolo_box", "yolo_box_scaled", "yolo_loss", "yolo_loss_scored"])
def test_the_detection_ops_on_the_card_match_the_cpu(cuda, key):
    """Each detection op's case on CUDA tensors against the same call on
    the CPU: float32 within atol 1e-4, NMS indices exactly; the outputs
    on the card; the differentiable ops' input gradients too."""
    from paddle_tpu_torch.framework.dispatch import call_op
    from paddle_tpu_torch.ops import op_cases
    case = op_cases.cases()[key]
    results = []
    for dev in (cuda, torch.device("cpu")):
        args, attrs = _vision_case_operands(case, dev)
        grad = case.name not in ("nms", "yolo_box")
        if grad:
            args[0].requires_grad_(True)
        out = call_op(case.name, *args, **attrs)
        outs = list(out) if isinstance(out, tuple) else [out]
        assert all(o.device.type == dev.type for o in outs)
        if grad:
            outs[0].float().square().sum().backward()
            outs.append(args[0].grad)
        results.append([o.detach().cpu() for o in outs])
    for got, want in zip(*results):
        if want.dtype == torch.int64:
            assert torch.equal(got, want)
        else:
            torch.testing.assert_close(got, want, **TOL[torch.float32])


def _qat_bert(dev, dtype=None):
    """A 2-layer, 768-wide BERT (QA head, dropout 0), seeded."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.models.bert import (BertConfig,
                                              BertForQuestionAnswering)
    pt.seed(3)
    cfg = BertConfig(num_hidden_layers=2, hidden_dropout_prob=0.0,
                     attention_dropout_prob=0.0)
    return BertForQuestionAnswering(cfg).to(dev, dtype)


def test_a_qat_step_runs_without_a_host_sync(cuda):
    """Quantization-aware BERT in bf16 O2: a training step (the observers'
    moving averages, the weight fake-quant, AdamW) reads nothing back to
    the host, and every LayerNorm and flash launch took the kernels."""
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.quantization import ImperativeQuantAware
    net = _qat_bert(cuda)
    amp.decorate(net, level="O2", dtype="bfloat16")
    ImperativeQuantAware().quantize(net)
    opt = AdamW(learning_rate=1e-4, parameters=net.parameters(),
                multi_precision=True)
    g = torch.Generator(cuda).manual_seed(4)
    ids = torch.randint(0, 30522, (4, 128), device=cuda, generator=g)
    pos = torch.randint(0, 128, (2, 4), device=cuda, generator=g)

    def step():
        with amp.auto_cast(level="O2", dtype="bfloat16"):
            loss = net(ids, start_positions=pos[0], end_positions=pos[1])[0]
        loss.backward()
        opt.step()
        opt.clear_grad()
        return loss.detach()

    step()
    before = (ln.fused_layer_norm.launches, fa.flash_attention_fwd.launches)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        loss = step()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    after = (ln.fused_layer_norm.launches, fa.flash_attention_fwd.launches)
    assert [a - b for a, b in zip(after, before)] == [5, 2]
    assert torch.isfinite(loss).item()


def test_an_int8_weight_artifact_serves_on_the_card(cuda, tmp_path):
    """``save_quantized_model`` of a card model: the artifact keeps int8
    weights, launches K2 and K4 from the loaded graph, and its logits
    equal the live converted model's within the bf16 tolerance."""
    from paddle_tpu_torch import amp, jit
    from paddle_tpu_torch.quantization import ImperativeQuantAware
    from paddle_tpu_torch.static import InputSpec
    net = _qat_bert(cuda).eval()
    amp.decorate(net, level="O2", dtype="bfloat16")
    qat = ImperativeQuantAware()
    qat.quantize(net)
    ids = torch.randint(0, 30522, (3, 128), device=cuda,
                        generator=torch.Generator(cuda).manual_seed(5))
    with amp.auto_cast(level="O2", dtype="bfloat16"):
        live = qat.save_quantized_model(
            net, str(tmp_path / "q"),
            input_spec=[InputSpec([None, 128], "int64", "ids")])
        with torch.no_grad():
            want = live(ids)
    layer = jit.load(str(tmp_path / "q"))
    before = (ln.fused_layer_norm.launches, fa.flash_attention_fwd.launches)
    got = layer(ids.cpu().numpy())
    torch.cuda.synchronize()
    after = (ln.fused_layer_norm.launches, fa.flash_attention_fwd.launches)
    assert [a - b for a, b in zip(after, before)] == [5, 2]
    for g_, w in zip(got, want):
        torch.testing.assert_close(torch.as_tensor(g_).float().cpu(),
                                   w.float().cpu(), **TOL[torch.bfloat16])
    assert live.bert.encoder.layers[0].linear1.weight_int8.dtype == \
        torch.int8


@pytest.mark.parametrize("name", ["beta", "dirichlet", "categorical",
                                  "multinomial"])
def test_distribution_draws_on_the_card(cuda, name):
    """Draws on the card (``torch._standard_gamma``, Gumbel-max) follow the
    distribution: 50000 draws' means within 5 standard errors."""
    from paddle_tpu_torch import distribution as D
    conc = torch.tensor([[0.7, 2.0, 3.5], [4.0, 1.2, 0.9]], device=cuda)
    d, mean = {
        "beta": (D.Beta(conc[:, 0], conc[:, 1]),
                 conc[:, 0] / conc[:, :2].sum(-1)),
        "dirichlet": (D.Dirichlet(conc), conc / conc.sum(-1, keepdim=True)),
        "categorical": (D.Categorical(conc.log()),
                        (conc / conc.sum(-1, keepdim=True)
                         * torch.arange(3., device=cuda)).sum(-1)),
        "multinomial": (D.Multinomial(5, conc),
                        5 * conc / conc.sum(-1, keepdim=True))}[name]
    draws = d.sample((50000,), seed=11)
    assert draws.is_cuda
    draws = draws.double()
    se = (draws.var(0) / 50000).sqrt()
    assert ((draws.mean(0) - mean.double()).abs() <= 5 * se + 1e-9).all()


def _fused_encoder(cuda, layers):
    from paddle_tpu_torch import nn, seed
    from paddle_tpu_torch.incubate.nn import FusedTransformerEncoderLayer

    class Encoder(nn.Layer):
        def __init__(self):
            super().__init__()
            self.embed = nn.Embedding(30522, 768)
            self.layers = nn.LayerList([FusedTransformerEncoderLayer(
                768, 12, 3072, dropout_rate=0.1, attn_dropout_rate=0.0,
                activation="gelu") for _ in range(layers)])
            self.head = nn.Linear(768, 2)

        def forward(self, ids):
            h = self.embed(ids)
            for layer in self.layers:
                h = layer(h)
            return self.head(h.mean(1))

    seed(0)
    return Encoder().to(cuda)


def test_fused_encoder_step_under_asp_and_lookahead_reads_nothing_back(
        cuda):
    """Two ``FusedTransformerEncoderLayer`` s at BERT-base width, bf16 O2,
    2:4-pruned, ``asp.decorate(LookAhead(AdamW(multi_precision)))``: a
    step launches K4/K6 once a layer on the tensor-core route at ``[4,
    128, 12, 64]``, K2/K3 twice a layer on the warp-row route, reads
    nothing back to the host, and keeps every pruned weight 2:4 on its
    JAX view, its master too."""
    from paddle_tpu_torch import amp
    from paddle_tpu_torch import nn as pnn
    from paddle_tpu_torch.incubate import LookAhead, asp
    from paddle_tpu_torch.optimizer import AdamW
    net = _fused_encoder(cuda, 2)
    amp.decorate(net, level="O2", dtype="bfloat16")
    masks = asp.prune_model(net)
    assert len(masks) == 8                      # 4 Linears a layer
    inner = AdamW(1e-3, parameters=net.parameters(), multi_precision=True)
    opt = asp.decorate(LookAhead(inner, alpha=0.5, k=2))
    g = torch.Generator(cuda).manual_seed(1)
    ids = torch.randint(0, 30522, (4, 128), device=cuda, generator=g)
    labels = torch.randint(0, 2, (4,), device=cuda, generator=g)

    def step():
        with amp.auto_cast(level="O2", dtype="bfloat16"):
            loss = F.cross_entropy(net(ids), labels)
        loss.backward()
        opt.step()
        opt.clear_grad()
        return loss.detach()

    step()
    before, tc = _launch_counts(), fa.flash_attention_bwd.tc_launches
    warp = ln.fused_layer_norm.warp_launches
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        loss = step()                           # step 2: the sync
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert tuple(a - b for a, b in zip(_launch_counts(), before)) == \
        (2, 2, 4, 4)
    assert fa.flash_attention_bwd.tc_launches - tc == 2
    assert ln.fused_layer_norm.warp_launches - warp == 4
    assert torch.isfinite(loss)
    masters = inner._master_weights()
    for layer in net.sublayers():
        if isinstance(layer, pnn.Linear) and layer is not net.head:
            assert asp.check_sparsity(layer.weight)
            master = masters[id(layer.weight)]
            assert torch.equal(master.to(torch.bfloat16), layer.weight)


def test_fused_multi_transformer_decodes_on_the_card(cuda):
    """A 2-layer bf16 ``FusedMultiTransformer`` at GPT-2 small width: K2
    twice a layer a call on the warp-row route and no flash launch (the
    masks send attention to the op's plain body); the context stage and
    4 decode steps equal the uncached causal forward's rows within bf16
    rounding of the residual stream."""
    from paddle_tpu_torch import seed
    from paddle_tpu_torch.incubate.nn import FusedMultiTransformer
    seed(0)
    net = FusedMultiTransformer(768, 12, 3072, num_layers=2).to(
        cuda, torch.bfloat16).eval()
    g = torch.Generator(cuda).manual_seed(2)
    x = torch.randn(2, 20, 768, device=cuda, generator=g).bfloat16()
    with torch.no_grad():
        full = net(x)
        caches = net.gen_cache(2, 20, dtype="bfloat16")
        before = (ln.fused_layer_norm.launches, fa.flash_attention_fwd.launches)
        out, caches = net(x[:, :16], caches=caches)
        assert (ln.fused_layer_norm.launches - before[0],
                fa.flash_attention_fwd.launches - before[1]) == (4, 0)
        rows = [out]
        for t in range(16, 20):
            step, caches = net(x[:, t:t + 1], caches=caches, time_step=t)
            rows.append(step)
    got = torch.cat(rows, 1).float()
    scale = full.float().abs().max().item()
    assert (got - full.float()).abs().max().item() <= 2e-2 * scale


def test_graph_ops_put_array_input_on_the_card(cuda):
    """Under the default place, numpy input to the graph ops and the
    masked softmaxes lands on the card, as ``to_tensor`` puts it, and
    gives what the same arrays give on the CPU."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import incubate as tinc
    rs = np.random.RandomState(6)
    x = rs.randn(50, 8).astype(np.float32)
    src, dst = rs.randint(0, 50, 200), rs.randint(0, 50, 200)
    logits = rs.randn(2, 2, 16, 16).astype(np.float32)
    calls = [lambda: tinc.graph_send_recv(x, src, dst, pool_type="max"),
             lambda: tinc.segment_mean(x, np.sort(src[:50])),
             lambda: tinc.softmax_mask_fuse(logits, np.zeros_like(logits)),
             lambda: tinc.softmax_mask_fuse_upper_triangle(logits)]
    old = pt.get_device()
    try:
        pt.set_device("gpu")
        outs = [f() for f in calls]
        pt.set_device("cpu")
        refs = [f() for f in calls]
    finally:
        pt.set_device(old)
    for out, ref in zip(outs, refs):
        assert out.is_cuda and not ref.is_cuda
        torch.testing.assert_close(out.cpu(), ref, rtol=1e-5, atol=1e-6)


def test_moe_on_the_card_equals_the_cpu(cuda):
    """A float32 ``MoELayer`` (8 experts, top-2) on the card against a CPU
    copy: the same routing, output, ``l_aux`` and gradients within 1e-4
    of each result's largest value (TF32 off)."""
    import copy

    from paddle_tpu_torch import seed
    from paddle_tpu_torch.incubate import MoELayer
    seed(3)
    cpu = MoELayer(64, num_experts=8, d_hidden=128, topk=2)
    card = copy.deepcopy(cpu).to(cuda)
    x = torch.randn(4, 32, 64, generator=torch.Generator().manual_seed(4))
    outs = []
    for layer, dev in ((cpu, "cpu"), (card, cuda)):
        xd = x.to(dev, copy=True).requires_grad_()
        y = layer(xd)
        ((y * y).sum() + layer.l_aux).backward()
        outs.append([y, layer.l_aux, xd.grad] +
                    [p.grad for p in layer.parameters()])
    for a, b in zip(*outs):
        scale = a.abs().max().item()
        assert (b.detach().cpu() - a.detach()).abs().max().item() <= \
            1e-4 * max(scale, 1e-6)
