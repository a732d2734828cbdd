"""Drive the PyTorch/CUDA port on one NVIDIA card and check it.

    python3 chip_smoke.py [--profile]

Phases, each fatal on failure (the script then exits non-zero and
prints no result line):

1. environment: the card's name and power limit, torch/CUDA/nvcc
   versions, the build of every kernel from ``paddle_tpu_torch/csrc``
   (one ``nvcc`` per source, all at once), and the count of ``HGMMA``
   (wgmma) and ``UTMALDG`` (TMA load) instructions in the SASS of the
   tensor-core flash library, each of which must be above 0, and of
   ``HMMA`` (mma.sync, above 0) and ``LDGSTS``/``UBLKCP`` (cp.async or
   bulk copies, above 0 together) in the tensor-core ragged attention
   library;
2. kernel vs plain: each kernel against its plain PyTorch version on the
   card, in float32 and bfloat16, with the errors, the median times, the
   bounds and the library call's time: the serving kernels at the
   serving path's widths (GPT-2: 12 heads, head_dim 64, hidden 768, KV
   blocks of 16; the quantized KV kernel over int8 and float8_e4m3fn
   pools in blocks of 32), the training kernels at the training path's
   (flash attention at [8, 1024, 12, 64] and at the ragged length 1000,
   causal, on both routes: bfloat16 on the tensor-core kernels, also at
   head_dim 128, float32 and the same bfloat16 operands at an unaligned
   base on the CUDA-core kernels; the LayerNorm forward and backward at
   [8192, 768]; AdamW on a [50304, 768] parameter). Each LayerNorm case
   runs on the warp-row kernels and, on the same operands at an unaligned
   base, on the CTA-per-row kernels, checked and timed on both; and both
   LayerNorm routes are held against the plain versions at D 1, 768,
   1024, 1600, 2049 and 16384 by 1, 7, 300 and 8192 rows in both dtypes;
3. engine: GPT-2 small (124M width, random weights from a seed, bf16)
   served through ``GenerationEngine(kv_layout="paged",
   attention="fused")`` — 16 concurrent requests with a chunked long
   prompt and a shared preamble — with the serving kernels' launch
   counts read around that run (every attention launch on the
   tensor-core route), and a float32 reference check of the engine's
   greedy tokens against the model's full forward;
3b. quantized KV: the same 16 requests served from an int8 pool
   (``kv_dtype="int8", block_size=32``) with the quantized kernel's
   launches counted and the float kernel's held at 0, the share of first
   tokens equal to phase 3's, the logit drift of one step against a bf16
   pool holding the same prompt, then 4 requests from a float8_e4m3fn
   pool; and the capacity line: the int8 tokens that fit phase 3's pool
   bytes;
3c. generate: ``model.generate`` on the same bf16 model (GPT-2 small at
   full width and depth): 8 unmasked prompts of 512 tokens, 64 new
   tokens, greedy, then sampled (top-k 50, top-p 0.9, seed 1); 4
   left-padded prompts of 96-256 real tokens in a 256-wide batch, 32 new
   tokens. Each run's K2 and K4 launches are counted around it and held
   to (2L + 1) x N and L (0 when masked), every K2 launch on the
   warp-row route and every K4 launch on the tensor-core route;
   generated tokens/s, prefill ms (a ``max_new_tokens=1`` call) and
   decode ms per token step; ``call_op``'s host cost per call. Then the
   unmasked greedy case in float32 at GPT-2 width cut to 2 layers, on
   the card and on a CPU copy (plain versions): the first step's logits
   within ``GEN_TOL``, and each row's tokens equal up to the first step
   where the CPU's top-2 logit margin falls below ``GEN_TOL``;
4. train: GPT-2 small at full width, bf16 AMP O2, AdamW with float32
   master weights, batch 8 x 1024 with next-token labels and the LM loss
   in 8 chunks (``bench.py``'s ``bench_gpt2`` configuration), through
   ``Model.fit``: 2 warm-up steps, then 8 timed steps with every training
   kernel's launch count read around them, every flash launch on the
   tensor-core route and every LayerNorm launch on the warp-row route (as
   in each engine run of phase 3); the same batch repeated must lower the
   loss; one float32 step of GPT-2 width at 2 layers on the card
   (kernels, flash on the CUDA-core route) against a CPU copy of the same
   weights (plain versions): loss, every gradient and every updated
   parameter;
5. real operands: the layer-0 operands of one real step of each path
   through kernel and plain: the engine's attention rows (float, int8
   and fp8 pools) at its widest step and at its last decode-only step
   with the most sequences, each with a "work shape" line (q blocks,
   tiles, splits, CTAs, the longest page walk, the CUDA-core kernel's
   grid), through the tensor-core route and through the CUDA-core
   kernel's C entry on the same operands, both checked and timed, and a
   second call's bits; the engine's LayerNorm input, timed; the training step's
   q/k/v/dO, LayerNorm input and output gradient and the token
   embedding's AdamW operands, each output held to its own scale (max
   |error| over max |plain|), since the gradients of a loss averaged
   over 8192 tokens lie below any fixed atol;
6. a ``{"kernels": [...]}`` line, the card's name and power limit, and
   last the ``{"ok": true, "device": ...}`` line. The training kernels'
   errors and times in it come from phase 2 at the train path's shapes
   and dtypes (flash bf16 [8, 1024, 12, 64] causal, the LayerNorm
   forward (``fused_layer_norm_train``) and backward f32 [8192, 768],
   AdamW with an f32 master and a bf16 gradient and copy), their
   launches from phase 4; the ``fused_layer_norm`` row times the
   engine's widest step's rows and counts the three engine runs; the
   ``_f32`` flash rows (the CUDA-core kernels) take phase 2's float32
   flash case and the float32 step's launches (and the forward, the
   float32 generate's); ``fused_layer_norm_generate`` (K2 at a decode
   step's rows, bf16 [8, 768]) and ``flash_attention_fwd_generate`` (K4
   at the prefill's shape, bf16 [8, 512, 12, 64] causal) count phase
   3c's runs.

``--profile`` adds one more batch to the bf16 and the int8 engines, one
more greedy generate and two more train steps under torch.profiler and
prints device time by kernel and the device's idle share.

Times come from CUDA events around single launches, median of 20,
with the 50 MB L2 cache flushed and the device kept busy until the
launch is queued, so neither a warm cache nor the host's launch
overhead enters them. Float32 products run without TF32.
"""
from __future__ import annotations

import gc
import json
import math
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

SEED = 0
HBM_BYTES_PER_S = 3.35e12            # H100 SXM data sheet
PEAK_OPS = {torch.bfloat16: 989e12,   # dense tensor-core rate
            torch.float32: 67e12}     # outside the tensor cores
TOL = {torch.float32: (1e-4, 0.0),    # (atol, rtol)
       torch.bfloat16: (2e-2, 1e-2)}  # one bf16 ulp of |y| < 4 is <= 1.6e-2
# max |kernel - plain| over max |plain|, for the operands of a real step:
# f32 sums in another order; a little over two bf16 ulps of the largest value
REL_TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
RPA_SRC = "paddle_tpu_torch/csrc/ragged_paged_attention.cu"
RPA_TC_SRC = "paddle_tpu_torch/csrc/ragged_paged_attention_sm90.cu"
LN_SRC = "paddle_tpu_torch/csrc/layer_norm.cu"
FA_SRC = "paddle_tpu_torch/csrc/flash_attention.cu"
FA_TC_SRC = "paddle_tpu_torch/csrc/flash_attention_sm90.cu"
ADAMW_SRC = "paddle_tpu_torch/csrc/adamw.cu"
RPA_TPU = "paddle_tpu/ops/ragged_paged_attention.py:198"
RPA_COUNTS = ("launches", "quant_launches", "tc_launches", "core_launches",
              "combine_launches")
QMAX = {torch.int8: 127.0, torch.float8_e4m3fn: 448.0}
QNAME = {torch.int8: "int8", torch.float8_e4m3fn: "fp8"}
LN_TPU = "paddle_tpu/ops/pallas_kernels.py:868"
LN_BWD_TPU = "paddle_tpu/ops/pallas_kernels.py:893"
FA_FWD_TPU = "paddle_tpu/ops/pallas_kernels.py:269"
FA_BWD_TPU = "paddle_tpu/ops/pallas_kernels.py:305"
ADAMW_TPU = "paddle_tpu/ops/pallas_kernels.py:1003"
# the bench_gpt2 configuration (bench.py:158)
BATCH, SEQ, LM_CHUNKS, LR, WD = 8, 1024, 8, 1e-4, 0.01
WARM_STEPS, TIMED_STEPS = 2, 8
# generate: 8 prompts x 512 tokens, 64 new; 4 left-padded rows of a
# 256-wide batch, 32 new
GEN_BATCH, GEN_PROMPT, GEN_NEW = 8, 512, 64
GEN_MASKED = (4, 256, 32)
# float32 first-step logits, card vs CPU: the same f32 arithmetic summed
# in other orders over 2 blocks and a 768-wide head, |logits| ~ 1
GEN_TOL = 2e-4


def log(*a):
    print(*a, flush=True)


def smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


class Timer:
    """Median device ms of single launches, L2 flushed before each. A
    GPU-side spin ahead of the start event lets the host enqueue the
    launch before the device reaches it, so the host's launch overhead
    stays out of the reading."""

    def __init__(self, device):
        self._flush = torch.empty(128 << 20, dtype=torch.uint8,
                                  device=device)

    def ms(self, fn, reps: int = 20, warmup: int = 3) -> float:
        for _ in range(warmup):
            fn()
        times = []
        for _ in range(reps):
            self._flush.zero_()
            torch.cuda._sleep(2_000_000)          # ~1 ms of device spin
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            torch.cuda.synchronize()
            times.append(a.elapsed_time(b))
        return statistics.median(times)


def check_close(name, got, want, dtype, tol=None):
    atol, rtol = tol or TOL[dtype]
    got, want = got.float(), want.float()
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: non-finite kernel output")
    err = (got - want).abs()
    bad = err > atol + rtol * want.abs()
    if bad.any():
        raise AssertionError(
            f"{name}: {int(bad.sum())} values outside atol={atol} "
            f"rtol={rtol}; max abs err {err.max().item()}")
    return err.max().item()


def check_scaled(name, got, want, dtype):
    """Kernel against plain relative to the values' scale: max |got -
    want| over max |want|, within REL_TOL. For the operands of a real
    step, whose gradients lie far below any fixed atol (the loss is a
    mean over 8192 tokens); a kernel that wrote zeros scores 1."""
    got, want = got.float(), want.float()
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: non-finite kernel output")
    top = want.abs().max().item()
    if not top > 0:
        raise AssertionError(f"{name}: the plain version is all zeros")
    err = (got - want).abs().max().item() / top
    if err > REL_TOL[dtype]:
        raise AssertionError(f"{name}: off by {err:.3e} of its largest "
                             f"value {top:.3e}, over {REL_TOL[dtype]}")
    return err


def sass_counts(source, ops):
    """How many SASS instructions of each of ``ops`` the built library of
    ``csrc/<source>.cu`` holds (``cuobjdump -sass``)."""
    from pathlib import Path

    from paddle_tpu_torch.ops import _build
    lib = _build.load(source)._name
    tool = Path(_build._nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(tool), "-sass", lib], capture_output=True,
                          text=True, check=True).stdout
    counts = {op: sum(op in line for line in sass.splitlines())
              for op in ops}
    log(f"SASS of {Path(lib).name}: {json.dumps(counts)} instructions")
    return counts


def sass_check():
    """The proof that the tensor-core libraries run on the tensor cores
    and keep loads in flight: ``HGMMA`` (wgmma) and ``UTMALDG`` (TMA tile
    load) in the flash library; ``HMMA`` (mma.sync) and ``LDGSTS``
    (cp.async) or ``UBLKCP`` (bulk copy) in the ragged attention library.
    Fails if a count is 0."""
    counts = sass_counts("flash_attention_sm90", ("HGMMA", "UTMALDG"))
    if not all(counts.values()):
        raise AssertionError(f"tensor-core flash library: {counts}")
    counts = sass_counts("ragged_paged_attention_sm90",
                         ("HMMA", "LDGSTS", "UBLKCP"))
    if not counts["HMMA"] or not counts["LDGSTS"] + counts["UBLKCP"]:
        raise AssertionError(f"tensor-core ragged attention library: "
                             f"{counts}")


# ---------------------------------------------------------------- bounds
def rpa_work(q, pool, meta, scales=None):
    """Bytes the attention call must move and operations it must do,
    counted from this call's data: every KV block each real sequence
    owns, read once per head (and its K and V scales for a quantized
    pool); q read and o written once."""
    blk_seq, _, _, tables, _, kv_len = (m.cpu().numpy() for m in meta)
    h, qp, dh = q.shape
    bs = pool.shape[4]
    e = q.element_size()
    seqs = sorted({int(s) for s in blk_seq if s >= 0})
    blocks = sum(-(-int(kv_len[s]) // bs) for s in seqs)
    kv_bytes = blocks * bs * h * dh * 2 * pool.element_size()
    if scales is not None:
        kv_bytes += blocks * h * 2 * scales.element_size()
    meta_bytes = sum(m.numel() * 4 for m in meta)
    nbytes = kv_bytes + 2 * qp * h * dh * e + meta_bytes
    ops = 0
    for s in seqs:
        rows = int((blk_seq == s).sum()) * 8
        cols = -(-int(kv_len[s]) // bs) * bs
        ops += 4 * rows * cols * dh * h          # q.k and p.v, 2 ops each
    return nbytes, ops


def bound(nbytes, ops, dtype):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------- phase 2
def random_ragged_batch(rng, dtype, device, L=12, H=12, Dh=64, bs=16,
                        S=8, max_ctx=1024, max_chunk=256):
    """Decode rows mixed with prompt chunks over random page tables."""
    from paddle_tpu_torch.ops.ragged_paged_attention import ragged_layout
    T = max_ctx // bs
    nb = S * T
    pool = torch.randn(L, 2, nb + 1, H, bs, Dh, device=device).to(dtype)
    tables = np.zeros((S, T), np.int32)
    free = rng.permutation(np.arange(1, nb + 1)).tolist()
    q_lens, pos0s, kv_lens = [], [], []
    for s in range(S):
        kv = int(rng.randint(1, max_ctx + 1))
        q = 1 if s % 2 == 0 else int(rng.randint(1, min(kv, max_chunk) + 1))
        nblk = -(-kv // bs)
        tables[s, :nblk] = [free.pop() for _ in range(nblk)]
        q_lens.append(q)
        pos0s.append(kv - q)
        kv_lens.append(kv)
    blk_seq, qstart, pos0, _, _ = ragged_layout(q_lens, pos0s)
    q = torch.randn(H, len(blk_seq) * 8, Dh, device=device).to(dtype)
    meta = [torch.from_numpy(np.asarray(a, np.int32)).to(device)
            for a in (blk_seq, qstart, pos0, tables, np.zeros(S, np.int32),
                      kv_lens)]
    return q, pool, int(rng.randint(0, L)), meta


def quantize_blocks(vals, storage):
    """Float blocks ``[..., bs, Dh]`` -> (codes of ``storage``, float32
    per-block max-abs scales ``[...]``), the pool's quantization rule."""
    qmax = QMAX[storage]
    sc = vals.float().abs().amax(dim=(-2, -1)) / qmax
    codes = (vals.float() / sc.clamp_min(1e-30)[..., None, None]).round() \
        .clamp(-qmax, qmax).to(storage)
    return codes, sc


def phase_quant_kernel(device, timer):
    """K1q on random ragged batches at GPT-2 widths, KV blocks of 32:
    int8 and fp8 pools, f32 and bf16 q, against the plain version."""
    from paddle_tpu_torch.ops.ragged_paged_attention import (
        ragged_paged_attention, ragged_paged_attention_plain, rpa_route)
    rng = np.random.RandomState(SEED + 3)
    torch.manual_seed(SEED + 3)
    for storage in (torch.int8, torch.float8_e4m3fn):
        for dtype in (torch.float32, torch.bfloat16):
            q, vals, layer, meta = random_ragged_batch(
                rng, torch.float32, device, bs=32)
            q = q.to(dtype)
            pool, scales = quantize_blocks(vals, storage)
            del vals
            got = ragged_paged_attention(q, pool, layer, *meta,
                                         scales=scales)
            torch.cuda.synchronize()
            want = ragged_paged_attention_plain(q, pool, layer, *meta,
                                                scales=scales)
            name = f"ragged_paged_attention {QNAME[storage]} {dtype}"
            err = check_close(name, got, want, dtype)
            ms = timer.ms(lambda: ragged_paged_attention(
                q, pool, layer, *meta, scales=scales))
            plain = timer.ms(lambda: ragged_paged_attention_plain(
                q, pool, layer, *meta, scales=scales), reps=5, warmup=1)
            b_ms, b_by = bound(*rpa_work(q, pool, meta, scales), dtype)
            log(f"K1q ragged_paged_attention {QNAME[storage]} pool, "
                f"{str(dtype)[6:]} q{tuple(q.shape)} bs 32 "
                f"{rpa_route(q.dtype, pool.dtype, q.shape[2], 32)} route "
                f"max_abs_err "
                f"{err:.3e} kernel_ms {ms:.4f} plain_ms {plain:.4f} "
                f"bound_ms {b_ms:.6f} ({b_by})")
            del pool, scales


def phase_kernels(device, timer):
    from paddle_tpu_torch.ops.ragged_paged_attention import (
        ragged_paged_attention, ragged_paged_attention_plain, rpa_route)
    rng = np.random.RandomState(SEED)
    torch.manual_seed(SEED)
    for dtype in (torch.float32, torch.bfloat16):
        q, pool, layer, meta = random_ragged_batch(rng, dtype, device)
        got = ragged_paged_attention(q, pool, layer, *meta)
        torch.cuda.synchronize()
        want = ragged_paged_attention_plain(q, pool, layer, *meta)
        err = check_close(f"ragged_paged_attention {dtype}", got, want, dtype)
        nbytes, ops = rpa_work(q, pool, meta)
        ms = timer.ms(lambda: ragged_paged_attention(q, pool, layer, *meta))
        plain = timer.ms(lambda: ragged_paged_attention_plain(
            q, pool, layer, *meta), reps=5, warmup=1)
        log(f"K1 ragged_paged_attention {str(dtype)[6:]} q{tuple(q.shape)} "
            f"{rpa_route(q.dtype, pool.dtype, q.shape[2], pool.shape[4])} "
            f"route "
            f"max_abs_err {err:.3e} kernel_ms {ms:.4f} plain_ms "
            f"{plain:.4f} bound_ms {bound(nbytes, ops, dtype)[0]:.4f}")
        del pool
        for rows in (8, 256, 4096):
            x = torch.randn(rows, 768, device=device).to(dtype)
            w = (1 + 0.1 * torch.randn(768, device=device)).to(dtype)
            b = (0.1 * torch.randn(768, device=device)).to(dtype)
            row = ln_fwd_case(timer, x, w, b)
            log(f"K2 fused_layer_norm {str(dtype)[6:]} [{rows}, 768] "
                f"{fmt(row)}")


# ---------------------------------------------------------------- phase 2: training kernels
def flash_work(q, causal, backward):
    """Bytes and operations one flash call on self-attention at q's shape
    must take: the forward reads q, k, v and writes o and the LSE; the
    backward reads q, k, v, o, dO and the LSE and writes dq, dk, dv. Per
    head-dim element of every (row, key) pair the mask keeps, the
    forward does 4 operations (q.k, p.v), the backward 10 (q.k again,
    dO.v, and the dV, dQ, dK products)."""
    b, s, h, d = q.shape
    pairs = b * h * (s * (s + 1) // 2 if causal else s * s)
    tensor, lse = q.numel() * q.element_size(), b * h * s * 4
    if backward:
        return 8 * tensor + lse, 10 * d * pairs
    return 4 * tensor + lse, 4 * d * pairs


def flash_counts():
    """(total, tensor-core, CUDA-core) launches of the flash wrappers."""
    from paddle_tpu_torch.ops import flash_attention as fa
    return [(w.launches, w.tc_launches, w.core_launches)
            for w in (fa.flash_attention_fwd, fa.flash_attention_bwd)]


def unaligned(t):
    """A contiguous copy of ``t`` whose base lies one element past a
    16-byte boundary: TMA cannot read it, so the wrappers send it to the
    CUDA-core kernels."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    return buf[1:].view(t.shape).copy_(t)


def ln_call(fn, route, *args):
    """``fn(*args)`` for a LayerNorm wrapper, which must count the call
    once, in its total and on ``route``."""
    counts = ("launches", "warp_launches", "row_launches")
    before = [getattr(fn, c) for c in counts]
    out = fn(*args)
    torch.cuda.synchronize()
    moved = tuple(getattr(fn, c) - b for c, b in zip(counts, before))
    if moved != ((1, 1, 0) if route == "warp" else (1, 0, 1)):
        raise AssertionError(f"{fn.__name__}: counts moved {moved}, expected "
                             f"one launch on the {route} route")
    return out


def ln_fwd_case(timer, x, w, b):
    """The LayerNorm forward on the warp-row route against its plain
    version on [rows, D] operands, timed beside ``F.layer_norm``; the same
    operands at an unaligned base through the row route, checked and timed
    too (``row_ms``)."""
    from paddle_tpu_torch.ops import layer_norm as ln
    dtype = x.dtype
    rows, d = x.shape
    want = ln.layer_norm_plain(x, w, b)
    xu = unaligned(x)
    err = {route: check_close(
        f"fused_layer_norm {route} route {dtype} [{rows}, {d}]",
        ln_call(ln.fused_layer_norm, route, xr, w, b), want, dtype)
        for route, xr in (("warp", x), ("row", xu))}
    e = x.element_size()
    row = {"max_abs_err": err["warp"], "row_err": err["row"],
           "ms": timer.ms(lambda: ln.fused_layer_norm(x, w, b)),
           "row_ms": timer.ms(lambda: ln.fused_layer_norm(xu, w, b)),
           "plain_ms": timer.ms(lambda: ln.layer_norm_plain(x, w, b)),
           "library_ms": timer.ms(lambda: torch.nn.functional.layer_norm(
               x, (d,), w, b, 1e-5))}
    # x read and y written, w and b read
    row["bound_ms"], row["bound_by"] = bound(
        2 * rows * d * e + 2 * d * e, 7 * rows * d, dtype)
    return row


def ln_bwd_check(x, w, g, route, want):
    """The LayerNorm backward on ``route`` against ``want`` (the plain
    version's dx, dw, db); a second call must give the same bits. dw and
    db sum over every row: they take rtol 1e-5 beside the atol."""
    from paddle_tpu_torch.ops import layer_norm as ln
    dtype = x.dtype
    got = ln_call(ln.fused_layer_norm_bwd, route, x, w, g)
    again = ln.fused_layer_norm_bwd(x, w, g)
    torch.cuda.synchronize()
    sums = (TOL[dtype][0], max(TOL[dtype][1], 1e-5))
    err = 0.0
    for n, a, a2, ref in zip(("dx", "dw", "db"), got, again, want):
        if not torch.equal(a, a2):
            raise AssertionError(f"LayerNorm backward {route} route {n}: "
                                 f"another call, other bits")
        err = max(err, check_close(
            f"LayerNorm backward {route} route {dtype} {tuple(x.shape)} {n}",
            a, ref, dtype, None if n == "dx" else sums))
    return err


def phase_ln_routes(device):
    """Both routes of both LayerNorm kernels against their plain versions
    at widths on both sides of the route boundary (1, GPT-2's 768, 1024
    and 1600, 2049, and the widest, 16384) and 1, 7, 300 and 8192 rows, in
    float32 and bfloat16: aligned operands take the warp-row route where
    it applies, unaligned ones the row route; dw/db repeat their bits."""
    from paddle_tpu_torch.ops import layer_norm as ln
    gen = torch.Generator(device=device).manual_seed(SEED + 5)

    def randn(*shape, dtype, scale=1.0):
        return (scale * torch.randn(*shape, device=device,
                                    generator=gen)).to(dtype)

    worst, cases = {}, 0
    for d in (1, 768, 1024, 1600, 2049, 16384):
        for rows in (1, 7, 300, 8192):
            for dtype in (torch.float32, torch.bfloat16):
                x, g = (randn(rows, d, dtype=dtype) for _ in range(2))
                w = (1 + randn(d, dtype=torch.float32, scale=0.1)).to(dtype)
                b = randn(d, dtype=dtype, scale=0.1)
                y_want = ln.layer_norm_plain(x, w, b)
                bwd_want = ln.layer_norm_bwd_plain(x, w, g)
                fits = d <= ln.WARP_MAX_D and d * x.element_size() % 16 == 0
                for xs, gs, route in (
                        (x, g, "warp" if fits else "row"),
                        (unaligned(x), unaligned(g), "row")):
                    if ln.ln_route(xs, w, b) != route:
                        raise AssertionError(f"LayerNorm {dtype} D={d}: "
                                             f"route {ln.ln_route(xs, w, b)}"
                                             f", expected {route}")
                    err = check_close(
                        f"fused_layer_norm {route} route {dtype} "
                        f"[{rows}, {d}]",
                        ln_call(ln.fused_layer_norm, route, xs, w, b),
                        y_want, dtype)
                    err = max(err, ln_bwd_check(xs, w, gs, route, bwd_want))
                    key = f"{route} {str(dtype)[6:]}"
                    worst[key] = max(worst.get(key, 0.0), err)
                    cases += 1
                del x, g, y_want, bwd_want
    log(f"LayerNorm routes vs plain: {cases} cases (forward and backward "
        f"each), D 1/768/1024/1600/2049/16384 x rows 1/7/300/8192 x "
        f"f32/bf16, aligned and unaligned; dw/db repeat their bits; max "
        f"abs err by route: " + json.dumps(worst))


def flash_check(q, k, v, do, causal, route):
    """Forward and backward kernels against their plain versions on (q, k,
    v, dO); each wrapper must count the call once, on ``route``. Returns
    the forward's and the backward's max |error| and the forward's (o,
    lse)."""
    from paddle_tpu_torch.ops import flash_attention as fa
    dtype = q.dtype
    before = flash_counts()
    o, lse = fa.flash_attention_fwd(q, k, v, causal)
    grads = fa.flash_attention_bwd(q, k, v, o, lse, do, causal)
    torch.cuda.synchronize()
    moved = [tuple(a - b for a, b in zip(x, y))
             for x, y in zip(flash_counts(), before)]
    step = (1, 1, 0) if route == "tc" else (1, 0, 1)
    if moved != [step, step]:
        raise AssertionError(f"flash {dtype} {tuple(q.shape)}: counts moved "
                             f"{moved}, expected {step} on the {route} route")
    want_o, want_lse = fa.flash_attention_fwd_plain(q, k, v, causal)
    err_f = max(check_close(f"flash {route} forward o", o, want_o, dtype),
                check_close(f"flash {route} forward lse", lse, want_lse,
                            torch.float32))
    want = fa.flash_attention_bwd_plain(q, k, v, o, lse, do, causal)
    err_b = max(check_close(f"flash {route} backward d{n}", g, w, dtype)
                for n, g, w in zip("qkv", grads, want))
    return err_f, err_b, o, lse


def flash_case(timer, q, k, v, do, causal=True, route="tc", core=False):
    """Forward and backward kernels of ``route`` against their plain
    versions on (q, k, v, dO), timed beside the plain versions and beside
    ``scaled_dot_product_attention`` and its autograd backward; with
    ``core``, the same operands at an unaligned base through the CUDA-core
    kernels too, checked and timed (``core_ms``). Returns the forward's
    and the backward's measurements."""
    from paddle_tpu_torch.ops import flash_attention as fa
    dtype = q.dtype
    err_f, err_b, o, lse = flash_check(q, k, v, do, causal, route)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qt, kt, vt, dot = (t.transpose(1, 2).contiguous() for t in (q, k, v, do))
    qg, kg, vg = (t.requires_grad_() for t in (qt, kt, vt))
    out = sdpa(qg, kg, vg, is_causal=causal)
    fwd = {"max_abs_err": err_f,
           "ms": timer.ms(lambda: fa.flash_attention_fwd(q, k, v, causal)),
           "plain_ms": timer.ms(lambda: fa.flash_attention_fwd_plain(
               q, k, v, causal), reps=5, warmup=1),
           "library_ms": timer.ms(lambda: sdpa(qt.detach(), kt.detach(),
                                               vt.detach(),
                                               is_causal=causal))}
    bwd = {"max_abs_err": err_b,
           "ms": timer.ms(lambda: fa.flash_attention_bwd(q, k, v, o, lse,
                                                         do, causal)),
           "plain_ms": timer.ms(lambda: fa.flash_attention_bwd_plain(
               q, k, v, o, lse, do, causal), reps=5, warmup=1),
           "library_ms": timer.ms(lambda: torch.autograd.grad(
               out, (qg, kg, vg), dot, retain_graph=True))}
    del out, qt, kt, vt, dot, qg, kg, vg
    if core:
        qc, kc, vc, doc = (unaligned(t) for t in (q, k, v, do))
        fwd["core_err"], bwd["core_err"], oc, lc = flash_check(
            qc, kc, vc, doc, causal, "cuda_core")
        fwd["core_ms"] = timer.ms(lambda: fa.flash_attention_fwd(
            qc, kc, vc, causal))
        bwd["core_ms"] = timer.ms(lambda: fa.flash_attention_bwd(
            qc, kc, vc, oc, lc, doc, causal))
    for row, backward in ((fwd, False), (bwd, True)):
        row["bound_ms"], row["bound_by"] = bound(
            *flash_work(q, causal, backward), dtype)
    return fwd, bwd


def ln_bwd_case(timer, x, w, g):
    """The LayerNorm backward kernel on the warp-row route against its
    plain version on [rows, D] operands, timed beside aten's
    ``native_layer_norm_backward``; the same operands at an unaligned base
    through the row route, checked and timed too (``row_ms``)."""
    from paddle_tpu_torch.ops import layer_norm as ln
    dtype = x.dtype
    rows, d = x.shape
    want = ln.layer_norm_bwd_plain(x, w, g)
    xu, gu = unaligned(x), unaligned(g)
    err = ln_bwd_check(x, w, g, "warp", want)
    row_err = ln_bwd_check(xu, w, gu, "row", want)
    b = torch.zeros_like(w)
    _, mean, rstd = torch.ops.aten.native_layer_norm(x, [d], w, b, 1e-5)
    e = x.element_size()
    row = {"max_abs_err": err, "row_err": row_err,
           "ms": timer.ms(lambda: ln.fused_layer_norm_bwd(x, w, g)),
           "row_ms": timer.ms(lambda: ln.fused_layer_norm_bwd(xu, w, gu)),
           "plain_ms": timer.ms(lambda: ln.layer_norm_bwd_plain(x, w, g)),
           "library_ms": timer.ms(
               lambda: torch.ops.aten.native_layer_norm_backward(
                   g, x, [d], mean, rstd, w, b, [True, True, True]))}
    # x and g read, dx written; w read, dw and db written
    row["bound_ms"], row["bound_by"] = bound(
        (3 * rows * d + 3 * d) * e, 15 * rows * d, dtype)
    return row


def adamw_case(timer, p, g, m, v, low, lr, beta1, beta2, eps, wd, step):
    """The AdamW kernel against its plain version on copies of one
    parameter's operands, timed beside ``torch.optim.AdamW(fused=True)``
    on a float32 copy. The same float32 arithmetic with fused
    multiply-adds: atol 1e-6 + rtol 1e-6."""
    from paddle_tpu_torch.ops.fused_adamw import adamw_plain_, fused_adamw_
    hyper = (lr, beta1, beta2, eps, wd, step)
    ops = [t.clone() for t in (p, m, v)]
    ref = [t.clone() for t in (p, m, v)]
    low_k = None if low is None else low.clone()
    low_r = None if low is None else low.clone()
    fused_adamw_(ops[0], g, ops[1], ops[2], *hyper, low=low_k)
    torch.cuda.synchronize()
    adamw_plain_(ref[0], g, ref[1], ref[2], *hyper, low=low_r)
    exact = (1e-6, 1e-6)
    err = max(check_close(f"AdamW {n}", a, b, a.dtype,
                          exact if a.dtype == torch.float32 else None)
              for n, a, b in zip(("p", "m", "v"), ops, ref))
    if low is not None:
        err = max(err, check_close("AdamW bf16 copy", low_k, low_r,
                                   torch.bfloat16))
    lib_p = torch.nn.Parameter(p.detach().float().clone())
    lib_p.grad = g.float()
    lib = torch.optim.AdamW([lib_p], lr=lr, betas=(beta1, beta2), eps=eps,
                            weight_decay=wd, fused=True)
    n = p.numel()
    row = {"max_abs_err": err,
           "ms": timer.ms(lambda: fused_adamw_(ops[0], g, ops[1], ops[2],
                                               *hyper, low=low_k)),
           "plain_ms": timer.ms(lambda: adamw_plain_(
               ref[0], g, ref[1], ref[2], *hyper, low=low_r)),
           "library_ms": timer.ms(lib.step)}
    # p, m, v read and written, g read, the bf16 copy written
    nbytes = n * (2 * p.element_size() + g.element_size() + 16
                  + (2 if low is not None else 0))
    row["bound_ms"], row["bound_by"] = bound(nbytes, 16 * n, torch.float32)
    return row


def fmt(row):
    line = (f"max_abs_err {row['max_abs_err']:.3e} kernel_ms "
            f"{row['ms']:.5f} plain_ms {row['plain_ms']:.4f} library_ms "
            f"{row['library_ms']:.5f} bound_ms {row['bound_ms']:.5f} "
            f"({row['bound_by']})")
    if "core_ms" in row:
        line += (f"; CUDA-core route on the same operands: max_abs_err "
                 f"{row['core_err']:.3e} kernel_ms {row['core_ms']:.5f}")
    if "row_ms" in row:
        line += (f"; row route (the CTA-per-row kernels) on the same "
                 f"operands: max_abs_err {row['row_err']:.3e} kernel_ms "
                 f"{row['row_ms']:.5f}")
    return line


def phase_train_kernels(device, timer):
    gen = torch.Generator(device=device).manual_seed(SEED)

    def randn(*shape, dtype=torch.float32, scale=1.0):
        return (scale * torch.randn(*shape, device=device,
                                    generator=gen)).to(dtype)

    main = {}          # the train path's shapes and dtypes, for the kernels line
    for dtype, seq, d, route in (
            (torch.float32, SEQ, 64, "cuda_core"),
            (torch.float32, 1000, 64, "cuda_core"),
            (torch.bfloat16, SEQ, 64, "tc"),
            (torch.bfloat16, 1000, 64, "tc"),
            (torch.bfloat16, SEQ, 128, "tc")):
        q, k, v, do = (randn(BATCH, seq, 12, d, dtype=dtype)
                       for _ in range(4))
        fwd, bwd = flash_case(timer, q, k, v, do, route=route,
                              core=route == "tc" and d == 64)
        if seq == SEQ and d == 64:
            tail = "" if dtype == torch.bfloat16 else "_f32"
            main["flash_attention_fwd" + tail] = fwd
            main["flash_attention_bwd" + tail] = bwd
        shape = f"{str(dtype)[6:]} [{BATCH}, {seq}, 12, {d}] causal"
        log(f"K4/K5 flash_attention_fwd {route} route {shape} {fmt(fwd)}")
        log(f"K6/K7 flash_attention_bwd {route} route {shape} {fmt(bwd)}")
        del q, k, v, do
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype)[6:]
        x = randn(BATCH * SEQ, 768, dtype=dtype)
        w = (1 + randn(768, scale=0.1)).to(dtype)
        g = randn(BATCH * SEQ, 768, dtype=dtype)
        row = ln_bwd_case(timer, x, w, g)
        log(f"K3 fused_layer_norm_bwd {name} [{BATCH * SEQ}, 768] "
            f"{fmt(row)}")
        fwd = ln_fwd_case(timer, x, w, randn(768, dtype=dtype, scale=0.1))
        log(f"K2 fused_layer_norm {name} [{BATCH * SEQ}, 768] {fmt(fwd)}")
        if dtype == torch.float32:           # O2 runs LayerNorm in f32
            main["fused_layer_norm_bwd"] = row
            main["fused_layer_norm_train"] = fwd
    n = (50304, 768)
    for p_dtype, low in ((torch.float32, True), (torch.float32, False)):
        p = randn(*n, scale=0.02)
        g = randn(*n, dtype=torch.bfloat16 if low else torch.float32,
                  scale=1e-3)
        m, v = randn(*n, scale=1e-4), randn(*n, scale=1e-4).square()
        bf16 = torch.empty(n, dtype=torch.bfloat16, device=device) \
            if low else None
        row = adamw_case(timer, p, g, m, v, bf16, LR, 0.9, 0.999, 1e-8, WD,
                         3)
        log(f"K8 fused_adamw {'f32 master, bf16 grad and copy' if low else 'f32'}"
            f" [50304, 768] {fmt(row)}")
        if low:
            main["fused_adamw"] = row
    return main


# ---------------------------------------------------------------- phase 3
def reference_check(device):
    """Float32 engine greedy tokens == greedy decoding through the
    model's full forward, at GPT-2 width with the depth cut to 2."""
    from paddle_tpu_torch import seed
    from paddle_tpu_torch.models import GPTConfig, GPTForPretraining
    from paddle_tpu_torch.serving import GenerationEngine
    seed(SEED + 1)
    cfg = GPTConfig.gpt2_small()
    cfg.num_hidden_layers = 2
    model = GPTForPretraining(cfg).to(device)
    rng = np.random.RandomState(SEED + 1)
    prompts = [rng.randint(0, cfg.vocab_size, n) for n in (40, 7)]
    with GenerationEngine(model, num_slots=2, block_size=16,
                          prefill_budget=32, device=device) as eng:
        outs = [h.result(timeout=300) for h in
                [eng.submit(p, max_new_tokens=8) for p in prompts]]
    with torch.no_grad():
        for p, out in zip(prompts, outs):
            ids = torch.from_numpy(p).long().to(device)[None]
            for _ in range(8):
                nxt = model(ids)[0, -1].argmax()
                ids = torch.cat([ids, nxt.view(1, 1)], dim=1)
            if not np.array_equal(ids[0].cpu().numpy(), out):
                raise AssertionError(
                    f"engine tokens {out[len(p):]} != full-forward greedy "
                    f"{ids[0, len(p):].cpu().numpy()}")
    log("reference check: float32 engine greedy == full-forward greedy "
        "(2 requests x 8 tokens, GPT-2 width, 2 layers)")


def profile_engine(eng, rng, vocab):
    """Where the engine's device time goes: one more batch of 8
    requests (256-token prompts, 32 new tokens each) under
    torch.profiler; prints device time by kernel and the idle share."""
    from torch.profiler import ProfilerActivity, profile
    prompts = [rng.randint(0, vocab, 256) for _ in range(8)]
    steps0 = eng.stats()["steps"]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for h in [eng.submit(p, max_new_tokens=32) for p in prompts]:
            h.result(timeout=600)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    device_time_report("engine", prof, wall_ms, eng.stats()["steps"] - steps0)


def device_time_report(what, prof, wall_ms, steps):
    """Device time by kernel over a profiled window (the 15 largest and
    every hand-written kernel), and the idle share."""
    from torch.autograd import DeviceType
    kernels = [(ev.self_device_time_total / 1e3, ev.count, ev.key)
               for ev in prof.key_averages()
               if ev.device_type == DeviceType.CUDA
               and ev.self_device_time_total > 0]
    busy = sum(k[0] for k in kernels)
    log(f"profile {what}: {steps} steps in {wall_ms:.3f} ms wall, device "
        f"busy {busy:.3f} ms, idle share {1 - busy / wall_ms:.4f}, "
        f"{busy / steps:.4f} device ms per step")
    ranked = sorted(kernels, reverse=True)
    # the top 15, then the port's own kernels (csrc/*.cu keeps them in an
    # anonymous namespace at the top level) below them
    shown = ranked[:15] + [k for k in ranked[15:]
                           if k[2].startswith("void (anonymous namespace)::")]
    for ms, n, name in shown:
        log(f"  {ms:10.3f} ms {ms / busy:7.2%} {n:7d} calls "
            f"{ms / steps:8.4f} ms/step  {name[:90]}")


def serve_mix(model, prompts, max_new, profile=False, rng=None, **kw):
    """Serve ``prompts`` at once through a fused paged engine built with
    ``kw``, after one short warm-up request, with every serving kernel's
    count set to 0 just before and read just after; every attention
    launch must take the tensor-core route. Keeps the layer-0 attention
    operands of the widest step and of the last of the decode-only steps
    (one row a sequence) with the most sequences. Returns (outputs,
    stats, launches, steps, wall seconds, captured operands: ``{"wide":
    ..., "decode": ...}``)."""
    import paddle_tpu_torch.models.generation as gen_mod
    from paddle_tpu_torch.ops.layer_norm import fused_layer_norm
    from paddle_tpu_torch.ops.ragged_paged_attention import (
        ragged_paged_attention)
    from paddle_tpu_torch.serving import GenerationEngine
    vocab = model.gpt.cfg.vocab_size
    eng = GenerationEngine(model, kv_layout="paged", attention="fused",
                           num_slots=8, prefill_budget=256, seed=SEED,
                           device=next(model.parameters()).device, **kw)
    warm = np.random.RandomState(SEED + 9)
    eng.submit(warm.randint(0, vocab, 24), max_new_tokens=4).result(
        timeout=300)
    captured = {"wide": {}, "decode": {}}
    # the step being run, from its host operands (no device sync):
    # decode-only when every present sequence feeds one row
    # (kv_len - pos0 == 1), and how many sequences it has
    step = {}
    operands = eng._ragged_operands

    def spy(*a, **k):
        out = operands(*a, **k)
        blk_seq, _, pos0, _, _, kv_len = out[2][4:10]
        seqs = {int(x) for x in blk_seq if x >= 0}
        step.update(seqs=len(seqs), decode=all(
            int(kv_len[x]) - int(pos0[x]) == 1 for x in seqs))
        return out

    def keep(slot, q, pool, meta, scales, **info):
        slot.update(q=q.clone(), pool=pool[:1].clone(),
                    scales=None if scales is None else scales[:1].clone(),
                    meta=[m.clone() for m in meta], **info)

    def capture(q, pool, layer, *meta, scales=None, **kw2):
        if layer == 0:
            if q.shape[1] > captured["wide"].get("qp", 0):
                keep(captured["wide"], q, pool, meta, scales, qp=q.shape[1])
            if step["decode"] and step["seqs"] >= captured["decode"].get(
                    "seqs", 0):
                keep(captured["decode"], q, pool, meta, scales,
                     seqs=step["seqs"])
        return ragged_paged_attention(q, pool, layer, *meta, scales=scales,
                                      **kw2)

    gen_mod.ragged_paged_attention = capture
    eng._ragged_operands = spy
    steps0 = eng.stats()["steps"]
    for attr in RPA_COUNTS:
        setattr(ragged_paged_attention, attr, 0)
    fused_layer_norm.launches = fused_layer_norm.warp_launches = 0
    fused_layer_norm.row_launches = 0
    try:
        t0 = time.perf_counter()
        handles = [eng.submit(p, max_new_tokens=max_new) for p in prompts]
        outs = [h.result(timeout=600) for h in handles]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        gen_mod.ragged_paged_attention = ragged_paged_attention
        del eng._ragged_operands
    launches = {"ragged_paged_attention": ragged_paged_attention.launches,
                "ragged_paged_attention_quant":
                    ragged_paged_attention.quant_launches,
                "fused_layer_norm": fused_layer_norm.launches}
    check_ln_route("engine", (fused_layer_norm,))
    check_rpa_route("engine")
    launches["combine"] = ragged_paged_attention.combine_launches
    if not captured["decode"]:
        raise AssertionError("no decode-only step in the engine run")
    stats = eng.stats()
    if profile:
        profile_engine(eng, rng, vocab)
    eng.close()
    steps = stats["steps"] - steps0
    for p, h, out in zip(prompts, handles, outs):
        if len(h.tokens) != max_new or out.shape != (len(p) + max_new,):
            raise AssertionError(f"request {h.id}: {len(h.tokens)} tokens")
        if not ((out >= 0) & (out < vocab)).all():
            raise AssertionError(f"request {h.id}: token out of range")
    if stats["nonfinite_cycles"]:
        raise AssertionError(f"non-finite logits in "
                             f"{stats['nonfinite_cycles']} cycles")
    return outs, stats, launches, steps, wall, captured


def check_rpa_route(what):
    """Every attention launch since the counts were set to 0 took the
    tensor-core route."""
    from paddle_tpu_torch.ops.ragged_paged_attention import (
        ragged_paged_attention as fn)
    total = fn.launches + fn.quant_launches
    if not (total > 0 and fn.tc_launches == total and fn.core_launches == 0):
        raise AssertionError(
            f"{what}: {total} attention launches, {fn.tc_launches} on the "
            f"tensor-core route and {fn.core_launches} on the CUDA-core "
            f"route; all should be on the tensor-core route")


def check_serve_launches(what, launches, steps, n_layers, quantized):
    """The attention kernel of the pool's kind once per layer per step,
    the other one never; LayerNorm 2L + 1 times per step."""
    attn = "ragged_paged_attention_quant" if quantized \
        else "ragged_paged_attention"
    want = {"ragged_paged_attention": 0, "ragged_paged_attention_quant": 0,
            "fused_layer_norm": (2 * n_layers + 1) * steps}
    want[attn] = n_layers * steps
    launches = {k: v for k, v in launches.items() if k != "combine"}
    if launches != want:
        raise AssertionError(f"{what}: launches {launches} over {steps} "
                             f"steps, expected {want}")


def serve_line(what, prompts, max_new, stats, steps, wall):
    toks = max_new * len(prompts)
    log(f"{what}, {len(prompts)} requests x {max_new} tokens, prompts "
        f"{min(map(len, prompts))}-{max(map(len, prompts))}, {steps} steps "
        f"in {wall:.3f} s: {toks / wall:.1f} tokens/s, mean step "
        f"{wall / steps * 1e3:.3f} ms (wall / steps), TTFT p50 "
        f"{stats['ttft_ms']['p50']:.1f} ms p95 "
        f"{stats['ttft_ms']['p95']:.1f} ms, TPOT p50 "
        f"{stats['tpot_ms']['p50']:.2f} ms, prefix hits "
        f"{stats['prefix_hits']}, chunks {stats['prefill_chunks']}, "
        f"preempts {stats['preempts']}")


def phase_engine(device, profile=False):
    """Phase 3: GPT-2 small in bf16 through the fused engine over a bf16
    pool. Returns the model, the request mix, the outputs, the engine's
    stats, the launches and the captured operands."""
    from paddle_tpu_torch.models import GPTConfig, GPTForPretraining
    from paddle_tpu_torch import seed

    reference_check(device)
    seed(SEED)
    cfg = GPTConfig.gpt2_small()
    model = GPTForPretraining(cfg).to(device=device, dtype=torch.bfloat16)
    rng = np.random.RandomState(SEED)
    rng.randint(0, cfg.vocab_size, 24)        # the warm-up request's draw
    preamble = rng.randint(0, cfg.vocab_size, 64)
    prompts = []
    for i in range(16):
        n = 512 if i == 0 else int(rng.randint(32, 513))
        p = rng.randint(0, cfg.vocab_size, n)
        if i in (1, 12):                 # the second one admits later
            p = np.concatenate([preamble, p[:max(1, n - 64)]])
        prompts.append(p)
    outs, stats, launches, steps, wall, captured = serve_mix(
        model, prompts, 64, profile, rng, block_size=16)
    check_serve_launches("bf16 engine", launches, steps,
                         cfg.num_hidden_layers, quantized=False)
    if stats["prefix_hits"] < 1 or stats["prefill_chunks"] <= len(prompts):
        raise AssertionError(f"no prefix hit or no chunked prompt: {stats}")
    serve_line("engine: GPT-2 small bf16", prompts, 64, stats, steps, wall)
    log("engine launches: " + json.dumps(launches) + f" over {steps} steps")
    return model, prompts, outs, stats, launches, captured


def logit_drift(model, prompt):
    """One fused step feeding ``prompt`` whole into a bf16 pool and into
    an int8 pool: max |logit difference| and max |bf16 logit|."""
    from paddle_tpu_torch.serving import GenerationEngine
    gpt = model.gpt
    logits = {}
    for kv_dtype in (None, "int8"):
        seen = []

        def keep(h, _orig=type(gpt).logits):
            out = _orig(gpt, h)
            seen.append(out.float().clone())
            return out

        gpt.logits = keep
        try:
            with GenerationEngine(model, num_slots=1, block_size=32,
                                  prefill_budget=len(prompt),
                                  kv_dtype=kv_dtype,
                                  device=next(model.parameters()).device) \
                    as eng:
                eng.submit(prompt, max_new_tokens=1).result(timeout=300)
        finally:
            del gpt.logits
        if len(seen) != 1:
            raise AssertionError(f"{len(seen)} steps for one prompt")
        logits[kv_dtype] = seen[0][0, 0]
    drift = (logits["int8"] - logits[None]).abs().max().item()
    return drift, logits[None].abs().max().item()


def phase_engine_quant(model, prompts, bf16_outs, bf16_stats,
                       profile=False):
    """Phase 3b: the phase-3 mix from an int8 pool, the logit drift, the
    fp8 pool and the capacity line. Returns launches and operands."""
    from paddle_tpu_torch.serving.paging import PagedKVPool
    cfg = model.gpt.cfg
    L = cfg.num_hidden_layers
    rng = np.random.RandomState(SEED + 4)
    outs, stats, launches, steps, wall, cap_i8 = serve_mix(
        model, prompts, 64, profile, rng, kv_dtype="int8", block_size=32)
    check_serve_launches("int8 engine", launches, steps, L, quantized=True)
    if stats["prefix_hits"] < 1 or stats["prefill_chunks"] <= len(prompts):
        raise AssertionError(f"no prefix hit or no chunked prompt: {stats}")
    serve_line("engine: GPT-2 small bf16, int8 KV (block 32)", prompts, 64,
               stats, steps, wall)
    same = sum(int(a[len(p)] == b[len(p)])
               for p, a, b in zip(prompts, outs, bf16_outs))
    log(f"int8 engine: {same} of {len(prompts)} first tokens equal the bf16 "
        f"engine's (reported, not gated: random weights have thin "
        f"margins); kv_bytes {json.dumps(stats['kv_bytes'])}; launches "
        + json.dumps(launches) + f" over {steps} steps")
    drift, top = logit_drift(model, prompts[0])
    limit = 0.05 * max(top, 1.0)
    log(f"logit drift, one step over a {len(prompts[0])}-token prompt, int8 "
        f"pool vs bf16 pool: max |diff| {drift:.4f}, max |logit| "
        f"{top:.4f}, limit {limit:.4f}")
    if not drift < limit:
        raise AssertionError(f"int8 logit drift {drift} over {limit}")

    fp8_prompts = prompts[:4]
    outs8, stats8, launches8, steps8, wall8, cap_f8 = serve_mix(
        model, fp8_prompts, 32, kv_dtype="float8_e4m3fn", block_size=32)
    check_serve_launches("fp8 engine", launches8, steps8, L, quantized=True)
    serve_line("engine: GPT-2 small bf16, float8_e4m3fn KV (block 32)",
               fp8_prompts, 32, stats8, steps8, wall8)

    budget = bf16_stats["kv_pool_capacity_bytes"]
    n_i8 = PagedKVPool.blocks_within_budget(
        budget, num_layers=L, num_heads=cfg.num_attention_heads,
        block_size=32,
        head_dim=cfg.hidden_size // cfg.num_attention_heads, dtype="int8")
    bf16_tokens = bf16_stats["num_blocks"] * bf16_stats["block_size"]
    ratio = n_i8 * 32 / bf16_tokens
    log(f"capacity: phase 3's bf16 pool, {budget} bytes, holds "
        f"{bf16_tokens} tokens; int8 blocks of 32 in the same bytes: "
        f"{n_i8} ({n_i8 * 32} tokens), {ratio:.4f}x")
    if ratio < 1.9:
        raise AssertionError(f"int8 capacity only {ratio:.4f}x bf16")
    return ({"ragged_paged_attention_int8":
                 launches["ragged_paged_attention_quant"],
             "ragged_paged_attention_int8_combine": launches["combine"],
             "ragged_paged_attention_fp8":
                 launches8["ragged_paged_attention_quant"],
             "ragged_paged_attention_fp8_combine": launches8["combine"],
             "fused_layer_norm": launches["fused_layer_norm"]
                 + launches8["fused_layer_norm"]},
            {"int8": cap_i8, "fp8": cap_f8})


# ---------------------------------------------------------------- phase 3c
def gen_counters():
    """The launch-counting wrappers of the kernels ``generate`` runs."""
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.ops import layer_norm as ln
    return {"fused_layer_norm": ln.fused_layer_norm,
            "flash_attention_fwd": fa.flash_attention_fwd}


def gen_want(n_layers, new_tokens, masked):
    """K2 and K4 launches of one greedy or sampled ``generate``: K2 at
    ln_1, ln_2 of every block and ln_f in the prefill and in each of the
    N - 1 decode steps; K4 once a layer in an unmasked prefill, never in
    a masked one (the decode steps attend over the cache through the
    plain masked composition, as in the JAX package)."""
    return {"fused_layer_norm": (2 * n_layers + 1) * new_tokens,
            "flash_attention_fwd": 0 if masked else n_layers}


def op_calls():
    """Every ``op_count/<name>`` counter of ``call_op``, summed."""
    from paddle_tpu_torch.framework import monitor
    return sum(v for k, v in monitor.all_stats().items()
               if k.startswith("op_count/"))


def gen_run(what, model, ids, want, flash_route, **kw):
    """One ``model.generate(ids, **kw)`` with the counts set to 0 just
    before and read just after: they must equal ``want``, every
    LayerNorm launch on the warp-row route and every flash launch on
    ``flash_route``. Returns (tokens, wall seconds, launches, call_op
    calls)."""
    counters = gen_counters()
    reset_counts(counters)
    calls0 = op_calls()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = model.generate(ids, **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in counters.items()}
    if launches != want:
        raise AssertionError(f"{what}: launches {launches}, expected {want}")
    check_ln_route(what, (counters["fused_layer_norm"],))
    fa_fn = counters["flash_attention_fwd"]
    on = fa_fn.tc_launches if flash_route == "tc" else fa_fn.core_launches
    if on != fa_fn.launches:
        raise AssertionError(f"{what}: {fa_fn.launches} flash launches, "
                             f"{on} on the {flash_route} route")
    n = kw["max_new_tokens"]
    vocab = model.gpt.cfg.vocab_size
    if not (out.is_cuda == ids.is_cuda and tuple(out.shape) == (
            ids.shape[0], ids.shape[1] + n)):
        raise AssertionError(f"{what}: tokens {tuple(out.shape)} on "
                             f"{out.device}")
    if not (torch.equal(out[:, :ids.shape[1]].long(), ids.long())
            and bool(((out >= 0) & (out < vocab)).all())):
        raise AssertionError(f"{what}: prompt changed or token out of range")
    return out, wall, launches, op_calls() - calls0


def call_op_cost(device):
    """Host µs that ``call_op`` adds to one op on the card: ``reshape``
    (a view, no launch) and the ``layer_norm`` op (predicate, override,
    K2 launch) against calling ``torch.reshape`` and the K2 wrapper
    directly, 500 calls a batch (under the launch queue's depth), median
    of 9 batches."""
    from paddle_tpu_torch.framework.dispatch import call_op
    from paddle_tpu_torch.ops.layer_norm import layer_norm
    x = torch.randn(8, 768, device=device, dtype=torch.bfloat16)
    w, b = torch.ones_like(x[0]), torch.zeros_like(x[0])
    pairs = {"reshape": (lambda: call_op("reshape", x, (2, 4, 768)),
                         lambda: torch.reshape(x, (2, 4, 768))),
             "layer_norm": (lambda: call_op("layer_norm", x, w, b,
                                            epsilon=1e-5),
                            lambda: layer_norm(x, w, b, 1e-5))}
    cost = {}
    for name, fns in pairs.items():
        per = []
        for fn in fns:
            runs = []
            for _ in range(9):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(500):
                    fn()
                runs.append((time.perf_counter() - t0) / 500 * 1e6)
                torch.cuda.synchronize()
            per.append(statistics.median(runs))
        cost[name] = {"call_op_us": per[0], "direct_us": per[1],
                      "added_us": per[0] - per[1]}
    return cost


def profile_generate(model, ids, new_tokens):
    """Device time by kernel and the idle share over one more greedy
    generate, under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        model.generate(ids, max_new_tokens=new_tokens)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    device_time_report("generate", prof, wall_ms, new_tokens)


def phase_generate(model, device, profile=False):
    """Phase 3c: ``model.generate`` on GPT-2 small in bf16 (the engine's
    model): 8 unmasked prompts of 512 tokens, 64 new tokens, greedy, then
    sampled (top-k 50, top-p 0.9, seed 1); 4 left-padded prompts of
    96-256 real tokens in a 256-wide batch, 32 new tokens. Returns the
    K2 and K4 launches of those runs."""
    cfg = model.gpt.cfg
    L, vocab = cfg.num_hidden_layers, cfg.vocab_size
    rng = np.random.RandomState(SEED + 6)
    ids = torch.from_numpy(rng.randint(0, vocab, (GEN_BATCH, GEN_PROMPT))
                           ).to(device)
    model.generate(ids, max_new_tokens=2)                   # warm-up
    first, prefill_s, pre_l, _ = gen_run(
        "generate prefill", model, ids, gen_want(L, 1, False), "tc",
        max_new_tokens=1)
    greedy, wall, launches, calls = gen_run(
        "generate greedy", model, ids, gen_want(L, GEN_NEW, False), "tc",
        max_new_tokens=GEN_NEW)
    if not torch.equal(first[:, GEN_PROMPT], greedy[:, GEN_PROMPT]):
        raise AssertionError("generate: the first greedy token differs "
                             "between two calls")
    toks = GEN_BATCH * GEN_NEW
    decode_ms = (wall - prefill_s) / (GEN_NEW - 1) * 1e3
    log(f"generate: GPT-2 small bf16, {GEN_BATCH} prompts x {GEN_PROMPT} "
        f"tokens, {GEN_NEW} new, greedy: {wall:.4f} s, {toks / wall:.1f} "
        f"generated tokens/s; prefill (max_new_tokens=1) "
        f"{prefill_s * 1e3:.3f} ms; decode {decode_ms:.4f} ms per token "
        f"step ((wall - prefill) / {GEN_NEW - 1}); launches "
        f"{json.dumps(launches)}; call_op calls {calls:.0f} "
        f"({calls / GEN_NEW:.1f} per token step)")
    sampled, s_wall, s_launches, _ = gen_run(
        "generate sampled", model, ids, gen_want(L, GEN_NEW, False), "tc",
        max_new_tokens=GEN_NEW, do_sample=True, top_k=50, top_p=0.9, seed=1)
    if torch.equal(sampled, greedy):
        raise AssertionError("sampled generate equals the greedy one")
    log(f"generate sampled (top_k 50, top_p 0.9, seed 1): {s_wall:.4f} s, "
        f"{toks / s_wall:.1f} tokens/s; launches {json.dumps(s_launches)}")
    rows, width, new = GEN_MASKED
    lens = [96, 256] + [int(n) for n in rng.randint(96, 257, rows - 2)]
    mids = torch.from_numpy(rng.randint(0, vocab, (rows, width))).to(device)
    mask = torch.zeros(rows, width, dtype=torch.int64, device=device)
    for i, n in enumerate(lens):
        mask[i, width - n:] = 1
    masked, m_wall, m_launches, _ = gen_run(
        "generate left-padded", model, mids * mask,
        gen_want(L, new, True), "tc", max_new_tokens=new,
        attention_mask=mask)
    log(f"generate left-padded: {rows} prompts of {lens} real tokens in a "
        f"{width}-wide batch, {new} new, greedy: {m_wall:.4f} s, "
        f"{rows * new / m_wall:.1f} tokens/s; launches "
        f"{json.dumps(m_launches)}")
    cost = call_op_cost(device)
    log("call_op host cost on the card, µs per call (call_op, direct, "
        "added): " + json.dumps(cost))
    if profile:
        profile_generate(model, ids, GEN_NEW)
    return {name: pre_l[name] + launches[name] + s_launches[name]
            + m_launches[name] for name in launches}


def phase_generate_f32(device):
    """The unmasked greedy case in float32, GPT-2 width at 2 layers: on the
    card (K2; K4 on the CUDA-core route) and on a CPU copy of the same
    weights (plain versions). The first step's logits agree within
    GEN_TOL; each row's tokens are equal up to the first step where the
    CPU's top-2 logit margin is below GEN_TOL (there rounding may pick
    either token). Returns the card run's launches."""
    import copy

    import paddle_tpu_torch as pt
    from paddle_tpu_torch.models import GPTConfig, GPTForPretraining
    pt.seed(SEED + 3)
    cfg = GPTConfig.gpt2_small()
    cfg.num_hidden_layers = 2
    cpu_net = GPTForPretraining(cfg).eval()
    card_net = copy.deepcopy(cpu_net).to(device)
    ids = torch.from_numpy(np.random.RandomState(SEED + 6).randint(
        0, cfg.vocab_size, (GEN_BATCH, GEN_PROMPT)))
    seen = {}
    for where, net in (("cpu", cpu_net), ("card", card_net)):
        gpt, rec = net.gpt, seen.setdefault(where, [])

        def keep(h, _gpt=gpt, _rec=rec):
            out = type(_gpt).logits(_gpt, h)
            top2 = out[:, 0].float().topk(2, dim=-1).values
            _rec.append((out[:, 0].float().cpu() if not _rec else None,
                         (top2[:, 0] - top2[:, 1]).cpu()))
            return out

        gpt.logits = keep
    try:
        card, _, launches, _ = gen_run(
            "generate float32 on the card", card_net, ids.to(device),
            gen_want(2, GEN_NEW, False), "cuda_core",
            max_new_tokens=GEN_NEW)
        cpu = cpu_net.generate(ids, max_new_tokens=GEN_NEW)
    finally:
        del cpu_net.gpt.logits, card_net.gpt.logits
    err = (seen["card"][0][0] - seen["cpu"][0][0]).abs().max().item()
    if not err <= GEN_TOL:
        raise AssertionError(f"float32 first-step logits: card vs CPU off by "
                             f"{err}, over {GEN_TOL}")
    margins = torch.stack([m for _, m in seen["cpu"]])      # [steps, B]
    card, cpu = card.cpu()[:, GEN_PROMPT:], cpu[:, GEN_PROMPT:]
    tie = [int(torch.nonzero(margins[:, b] < GEN_TOL)[0])
           if bool((margins[:, b] < GEN_TOL).any()) else GEN_NEW
           for b in range(GEN_BATCH)]
    for b, t in enumerate(tie):
        if not torch.equal(card[b, :t], cpu[b, :t]):
            raise AssertionError(
                f"float32 generate row {b}: card tokens {card[b, :t]} != CPU "
                f"{cpu[b, :t]} before its first near-tie at step {t}")
    same = int((card == cpu).all(dim=1).sum())
    log(f"generate float32 check (GPT-2 width, 2 layers, {GEN_BATCH} x "
        f"{GEN_PROMPT}, {GEN_NEW} new, card vs CPU): first-step logits max "
        f"|diff| {err:.3e} (limit {GEN_TOL}); first CPU top-2 margin below "
        f"{GEN_TOL} per row at step {tie} ({GEN_NEW} = none); tokens equal "
        f"before it in every row, all {GEN_NEW} equal in {same} of "
        f"{GEN_BATCH} rows; launches {json.dumps(launches)}, flash on the "
        f"CUDA-core route")
    return launches


def generate_rows(device, timer, launches):
    """The kernels line's rows of the generate path: K2 at a decode step's
    rows (bf16 [8, 768], most of its launches) and K4 at the prefill's
    shape (bf16 [8, 512, 12, 64] causal, tensor-core route), each with the
    launches of ``launches`` (the generate runs). K2 at the prefill's rows
    is logged."""
    gen = torch.Generator(device=device).manual_seed(SEED + 7)

    def randn(*shape, scale=1.0):
        return (scale * torch.randn(*shape, device=device, generator=gen)
                ).to(torch.bfloat16)

    rows = []
    for n, step in ((GEN_BATCH * GEN_PROMPT, "prefill"),
                    (GEN_BATCH, "decode")):
        row = ln_fwd_case(timer, randn(n, 768), 1 + randn(768, scale=0.1),
                          randn(768, scale=0.1))
        log(f"K2 fused_layer_norm at the generate path's {step} rows, bf16 "
            f"[{n}, 768] {fmt(row)}")
    rows.append(("fused_layer_norm_generate", LN_SRC, LN_TPU, row,
                 launches["fused_layer_norm"]))
    q, k, v, do = (randn(GEN_BATCH, GEN_PROMPT, 12, 64) for _ in range(4))
    fwd, _ = flash_case(timer, q, k, v, do, route="tc")
    log(f"K4/K5 flash_attention_fwd at the generate prefill's shape, bf16 "
        f"[{GEN_BATCH}, {GEN_PROMPT}, 12, 64] causal, tc route {fmt(fwd)}")
    rows.append(("flash_attention_fwd_generate", FA_TC_SRC, FA_FWD_TPU, fwd,
                 launches["flash_attention_fwd"]))
    return [{"name": name, "route": "cuda", "source": src, "replaces": tpu,
             "launches": count,
             **{k: row[k] for k in ("max_abs_err", "ms", "plain_ms",
                                    "bound_ms", "bound_by", "library_ms")}}
            for name, src, tpu, row, count in rows]


# ---------------------------------------------------------------- phase 5
def rpa_core(q, pool, meta, scales=None):
    """The CUDA-core kernel (``csrc/ragged_paged_attention.cu``) on layer 0
    of the operands, through its C entry: the wrapper sends bf16 operands
    at these widths to the tensor-core kernel, so this is how the old
    kernel is held and timed on the same operands. Counts nothing."""
    from paddle_tpu_torch.ops import _build
    from paddle_tpu_torch.ops import ragged_paged_attention as rpa
    out = torch.empty_like(q)
    h, qp, dh = q.shape
    args = (*(m.data_ptr() for m in meta), h, qp, dh, pool.shape[2],
            pool.shape[4], meta[3].shape[1], 0, 1.0 / math.sqrt(dh),
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
    if rc != 0:
        raise RuntimeError(f"CUDA-core attention kernel: CUDA error {rc}")
    return out


def work_shape(what, q, pool, meta):
    """What each route launches on these operands: real q blocks, tiles,
    splits, CTAs, the longest page walk of any CTA; and the CUDA-core
    kernel's grid and longest walk."""
    from paddle_tpu_torch.ops import ragged_paged_attention as rpa
    blk_seq, qstart, pos0, tables, lo, kv_len = (m.cpu().numpy()
                                                 for m in meta)
    h, qp, _ = q.shape
    bs = pool.shape[4]
    z = rpa.split_count(tables.shape[1], bs)
    tiles = rpa.tc_plan(blk_seq, qstart, pos0, lo, kv_len, bs)
    per_split = rpa.SPLIT_COLS // bs
    walks = [min(t["p_end"], (zz + 1) * per_split)
             - max(t["p_begin"], zz * per_split)
             for t in tiles for zz in range(t["z_first"], t["z_last"] + 1)]
    real = [int(s) for s in blk_seq if s >= 0]
    slots = rpa.tile_slots(qp, len(qstart))
    shape = {"q_rows": qp, "real_q_blocks": len(real), "tiles": len(tiles),
             "tile_splits": len(walks),
             "multi_split_tiles": sum(t["z_last"] > t["z_first"]
                                      for t in tiles),
             "grid": [slots, h, z],
             "ctas_launched": slots * h * z + (qp // 8 * h if z > 1 else 0),
             "ctas_with_work": len(walks) * h,
             "longest_walk_pages": max(walks, default=0),
             "old_grid": [qp // 8, h], "old_ctas_with_work": len(real) * h,
             "old_longest_walk_pages": max(
                 (-(-int(kv_len[s]) // bs) for s in real), default=0)}
    log(f"work shape, {what}: " + json.dumps(shape))


def rpa_case(name, timer, cap):
    """The attention kernel through the wrapper (the tensor-core route)
    and the CUDA-core kernel on the same operands, each against the plain
    version and timed; the bound from these operands."""
    from paddle_tpu_torch.ops.ragged_paged_attention import (
        ragged_paged_attention, ragged_paged_attention_plain)
    q, pool, meta, scales = cap["q"], cap["pool"], cap["meta"], cap["scales"]
    want = ragged_paged_attention_plain(q, pool, 0, *meta, scales=scales)
    got = ragged_paged_attention(q, pool, 0, *meta, scales=scales)
    old = rpa_core(q, pool, meta, scales)
    torch.cuda.synchronize()
    err = check_close(f"{name} on an engine step", got, want, q.dtype)
    core_err = check_close(f"{name}, CUDA-core kernel, on an engine step",
                           old, want, q.dtype)
    again = ragged_paged_attention(q, pool, 0, *meta, scales=scales)
    torch.cuda.synchronize()
    if not torch.equal(got, again):
        raise AssertionError(f"{name}: another call, other bits")
    nbytes, ops = rpa_work(q, pool, meta, scales)
    b_ms, b_by = bound(nbytes, ops, q.dtype)
    row = {"max_abs_err": err, "core_err": core_err,
           "ms": timer.ms(lambda: ragged_paged_attention(
               q, pool, 0, *meta, scales=scales)),
           "core_ms": timer.ms(lambda: rpa_core(q, pool, meta, scales)),
           "plain_ms": timer.ms(lambda: ragged_paged_attention_plain(
               q, pool, 0, *meta, scales=scales), reps=5, warmup=1),
           "bound_ms": b_ms, "bound_by": b_by}
    log(f"{name}: q{tuple(q.shape)} {q.dtype}, pool {pool.dtype}, {nbytes} "
        f"bytes, {ops} ops; tensor-core route max_abs_err {err:.3e} "
        f"kernel_ms {row['ms']:.5f}; CUDA-core kernel max_abs_err "
        f"{core_err:.3e} kernel_ms {row['core_ms']:.5f}; plain_ms "
        f"{row['plain_ms']:.4f} bound_ms {b_ms:.6f} ({b_by})")
    return row


def rpa_row(name, timer, captured, launches):
    """One row of the kernels line for the attention kernel (K1, or K1q
    for a quantized pool) on the layer-0 operands of an engine's widest
    step; its decode-only step's numbers and the CUDA-core kernel's on
    the same operands as extra keys (``decode_*``, ``core_*``)."""
    for k in ("wide", "decode"):
        work_shape(f"{name} {k} step", captured[k]["q"], captured[k]["pool"],
                   captured[k]["meta"])
    wide = rpa_case(f"{name}, widest step layer 0", timer, captured["wide"])
    dec = rpa_case(f"{name}, decode-only step layer 0", timer,
                   captured["decode"])
    row = {"name": name, "route": "cuda", "source": RPA_TC_SRC,
           "replaces": RPA_TPU, "launches": launches["attn"],
           "max_abs_err": wide["max_abs_err"], "ms": wide["ms"],
           "plain_ms": wide["plain_ms"], "bound_ms": wide["bound_ms"],
           "bound_by": wide["bound_by"], "library_ms": None,
           "combine_launches": launches["combine"],
           "core_source": RPA_SRC, "core_ms": wide["core_ms"],
           "core_err": wide["core_err"]}
    row.update({f"decode_{k}": dec[k] for k in (
        "max_abs_err", "ms", "core_ms", "core_err", "plain_ms", "bound_ms",
        "bound_by")})
    return row


def report_engine(device, timer, launches, captured, quant_launches,
                  quant_captured):
    rows_out = [rpa_row("ragged_paged_attention", timer, captured,
                        {"attn": launches["ragged_paged_attention"],
                         "combine": launches["combine"]})]
    for kind in ("int8", "fp8"):
        name = f"ragged_paged_attention_{kind}"
        counts = {"attn": quant_launches[name],
                  "combine": quant_launches[name + "_combine"]}
        rows_out.append(rpa_row(name, timer, quant_captured[kind], counts))
    q = captured["wide"]["q"]
    dtype = q.dtype
    rows, d = q.shape[1], q.shape[0] * q.shape[2]
    torch.manual_seed(SEED)
    x = torch.randn(rows, d, device=device).to(dtype)
    w = (1 + 0.1 * torch.randn(d, device=device)).to(dtype)
    b = (0.1 * torch.randn(d, device=device)).to(dtype)
    row = ln_fwd_case(timer, x, w, b)
    log(f"K2 fused_layer_norm at the engine step's rows, {str(dtype)[6:]} "
        f"[{rows}, {d}] {fmt(row)}")
    ln = {"name": "fused_layer_norm", "route": "cuda", "source": LN_SRC,
          "replaces": LN_TPU, "launches": launches["fused_layer_norm"]}
    ln.update({k: row[k] for k in ("max_abs_err", "ms", "plain_ms",
                                   "bound_ms", "bound_by", "library_ms")})
    return rows_out + [ln]


# ---------------------------------------------------------------- phase 4
def train_counters():
    """The launch-counting wrappers of the training path's kernels."""
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.ops import fused_adamw as fad
    from paddle_tpu_torch.ops import layer_norm as ln
    return {"flash_attention_fwd": fa.flash_attention_fwd,
            "flash_attention_bwd": fa.flash_attention_bwd,
            "fused_layer_norm": ln.fused_layer_norm,
            "fused_layer_norm_bwd": ln.fused_layer_norm_bwd,
            "fused_adamw": fad.fused_adamw_}


def expected_launches(n_layers, n_tensors):
    """Launches of one train step: one flash forward and backward per
    block, a LayerNorm forward and backward at ln_1, ln_2 of every block
    and ln_f (the checkpointed loss recomputes only the LM head), and
    one AdamW per parameter tensor."""
    return {"flash_attention_fwd": n_layers, "flash_attention_bwd": n_layers,
            "fused_layer_norm": 2 * n_layers + 1,
            "fused_layer_norm_bwd": 2 * n_layers + 1,
            "fused_adamw": n_tensors}


def reset_counts(counters):
    """Every launch count of the wrappers to 0 (the flash and LayerNorm
    wrappers' per-route counts too)."""
    for fn in counters.values():
        for attr in ("launches", "tc_launches", "core_launches",
                     "warp_launches", "row_launches"):
            if hasattr(fn, attr):
                setattr(fn, attr, 0)


def check_flash_route(what, counters, route):
    """Every flash launch since the counts were set to 0 took ``route``."""
    for name in ("flash_attention_fwd", "flash_attention_bwd"):
        fn = counters[name]
        on = fn.tc_launches if route == "tc" else fn.core_launches
        if not (fn.launches > 0 and on == fn.launches
                and fn.tc_launches + fn.core_launches == fn.launches):
            raise AssertionError(
                f"{what}: {name} launched {fn.launches} times, "
                f"{fn.tc_launches} on the tensor-core route and "
                f"{fn.core_launches} on the CUDA-core route; all should "
                f"be {route}")


def check_ln_route(what, wrappers):
    """Every LayerNorm launch since the counts were set to 0 took the
    warp-row route (the path's rows are 768 wide and freshly allocated)."""
    for fn in wrappers:
        if not (fn.launches > 0 and fn.warp_launches == fn.launches
                and fn.row_launches == 0):
            raise AssertionError(
                f"{what}: {fn.__name__} launched {fn.launches} times, "
                f"{fn.warp_launches} on the warp-row route and "
                f"{fn.row_launches} on the row route; all should be warp")


def check_launches(what, launches, per_step, steps):
    want = {k: v * steps for k, v in per_step.items()}
    if launches != want:
        raise AssertionError(f"{what}: launches {launches} over {steps} "
                             f"steps, expected {want}")


def capture_train_operands(model, opt_module, ids, labels):
    """Run one train step with spies on the callers of the kernels and
    keep layer 0's operands: q, k, v and dO of its attention, x, weight
    and the output gradient of its first LayerNorm, and the first AdamW
    update's (the token embedding's) p, g, m, v, copy and scalars."""
    import paddle_tpu_torch.nn.functional as nnf
    import paddle_tpu_torch.nn.layer.norm as norm_mod
    cap = {}
    fa_orig, ln_orig = nnf.flash_attention, norm_mod.layer_norm
    ad_orig = opt_module.fused_adamw_

    def fa_spy(q, k, v, is_causal=False, scale=None):
        out = fa_orig(q, k, v, is_causal=is_causal, scale=scale)
        if "qkv" not in cap:
            cap["qkv"] = [t.detach().clone() for t in (q, k, v)]
            out.register_hook(lambda g: cap.update(do=g.detach().clone()))
        return out

    def ln_spy(x, w, b, epsilon=1e-5):
        out = ln_orig(x, w, b, epsilon)
        if "ln" not in cap:
            cap["ln"] = [t.detach().clone() for t in (x, w)]
            out.register_hook(lambda g: cap.update(ln_g=g.detach().clone()))
        return out

    def adamw_spy(p, g, m, v, *hyper, low=None):
        if "adamw" not in cap:
            cap["adamw"] = ([t.clone() for t in (p, g, m, v)],
                            None if low is None else low.clone(), hyper)
        return ad_orig(p, g, m, v, *hyper, low=low)

    nnf.flash_attention, norm_mod.layer_norm = fa_spy, ln_spy
    opt_module.fused_adamw_ = adamw_spy
    try:
        loss = model.train_batch([ids, labels])
    finally:
        nnf.flash_attention, norm_mod.layer_norm = fa_orig, ln_orig
        opt_module.fused_adamw_ = ad_orig
    if not math.isfinite(loss) or len(cap) != 5:
        raise AssertionError(f"capture step: loss {loss}, kept {sorted(cap)}")
    return cap


def profile_train(model, ids, labels, steps=2):
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            model.train_batch([ids, labels])
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    device_time_report("train", prof, wall_ms, steps)


def phase_train(device, profile=False):
    """GPT-2 small, bf16 O2, through Model.fit at the bench_gpt2
    configuration; returns the timed run's launches and the operands of
    one more real step."""
    import paddle_tpu_torch as pt
    import paddle_tpu_torch.optimizer.optimizer as opt_module
    from paddle_tpu_torch.hapi import Callback, Model
    from paddle_tpu_torch.models import GPTConfig, GPTForPretraining
    from paddle_tpu_torch.optimizer import AdamW

    class Record(Callback):
        """Each step's loss (log_freq=1 reads it back every step) and the
        host clock at the end of the step."""

        def __init__(self):
            super().__init__()
            self.losses, self.stamps = [], []

        def on_train_batch_end(self, step, logs=None):
            self.losses.append(logs["loss"])
            self.stamps.append(time.perf_counter())

    pt.seed(SEED)
    cfg = GPTConfig.gpt2_small()
    cfg.hidden_dropout_prob = cfg.attention_dropout_prob = 0.0
    net = GPTForPretraining(cfg, lm_loss_chunks=LM_CHUNKS).to(device)
    n_params = sum(p.numel() for p in net.parameters())
    n_tensors = len(list(net.parameters()))
    model = Model(net, inputs=["ids", "labels"])
    model.prepare(AdamW(LR, parameters=net.parameters(), weight_decay=WD,
                        multi_precision=True),
                  loss=lambda loss, logits: loss,
                  amp_configs={"level": "O2", "dtype": "bfloat16"})
    rng = np.random.RandomState(SEED)
    tokens = rng.randint(0, cfg.vocab_size,
                         (BATCH * (WARM_STEPS + TIMED_STEPS), SEQ + 1))
    ids, labels = tokens[:, :-1], tokens[:, 1:]       # next-token labels
    split = BATCH * WARM_STEPS

    def fit(i, l, callbacks=None):
        model.fit(pt.io.TensorDataset([i, l]), batch_size=BATCH,
                  shuffle=False, log_freq=1, verbose=0, callbacks=callbacks)

    fit(ids[:split], labels[:split])                  # warm-up
    torch.cuda.synchronize()
    # the peak counts what the steps hold, not what earlier phases left
    # for the garbage collector (an engine's pool in a reference cycle)
    gc.collect()
    torch.cuda.reset_peak_memory_stats()
    counters = train_counters()
    reset_counts(counters)
    rec = Record()
    t0 = time.perf_counter()
    fit(ids[split:], labels[split:], [rec])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in counters.items()}
    peak = torch.cuda.max_memory_allocated()
    if len(rec.losses) != TIMED_STEPS or not all(
            math.isfinite(x) for x in rec.losses):
        raise AssertionError(f"train losses {rec.losses}")
    check_launches("train", launches,
                   expected_launches(cfg.num_hidden_layers, n_tensors),
                   TIMED_STEPS)
    check_flash_route("train", counters, "tc")
    check_ln_route("train", (counters["fused_layer_norm"],
                             counters["fused_layer_norm_bwd"]))
    step_ms = np.diff([t0] + rec.stamps) * 1e3
    log(f"train: GPT-2 small ({n_params} parameters in {n_tensors} "
        f"tensors), bf16 O2, AdamW multi_precision, batch {BATCH} x {SEQ}, "
        f"{LM_CHUNKS} loss chunks, Model.fit: {TIMED_STEPS} steps in "
        f"{wall:.3f} s: {BATCH * SEQ * TIMED_STEPS / wall:.1f} tokens/s, "
        f"{wall / TIMED_STEPS * 1e3:.3f} ms per step (wall / steps), "
        f"median step {float(np.median(step_ms)):.3f} ms, max memory "
        f"allocated {peak} bytes ({peak / 2 ** 30:.3f} GiB)")
    log("train losses: " + json.dumps(rec.losses))
    log("train launches: " + json.dumps(launches) + f" over {TIMED_STEPS} "
        f"steps; LayerNorm on the warp-row route: "
        f"{counters['fused_layer_norm'].warp_launches} forward, "
        f"{counters['fused_layer_norm_bwd'].warp_launches} backward")

    rec = Record()                                    # convergence
    fit(np.repeat(ids[:BATCH][None], 4, 0).reshape(-1, SEQ),
        np.repeat(labels[:BATCH][None], 4, 0).reshape(-1, SEQ), [rec])
    if not rec.losses[-1] < rec.losses[0]:
        raise AssertionError(f"a repeated batch did not lower the loss: "
                             f"{rec.losses}")
    log("convergence: one batch repeated, losses " + json.dumps(rec.losses))
    if profile:
        profile_train(model, ids[:BATCH], labels[:BATCH])
    cap = capture_train_operands(model, opt_module, ids[:BATCH],
                                 labels[:BATCH])
    return launches, cap


def phase_f32_check(device):
    """One float32 train step of GPT-2 width at 2 layers, sequence 512,
    batch 2, eager (loss.backward(); opt.step()), on the card (kernels)
    and on a CPU copy of the same weights (plain versions). The loss
    agrees within rtol 1e-5; every gradient within 1e-3 of its tensor's
    largest, but the attention key biases', whose true value is zero (a
    constant per softmax row): there both sides are rounding noise below
    1e-4 of the largest gradient. Every updated parameter agrees within
    2 * lr: Adam's first step is lr * g / (|g| + eps), so an element whose
    gradient's sign is rounding noise may land on the other side, and no
    more than 1e-4 of the elements may differ by more than 1e-6."""
    import copy

    import paddle_tpu_torch as pt
    from paddle_tpu_torch.models import GPTConfig, GPTForPretraining
    from paddle_tpu_torch.optimizer import AdamW
    pt.seed(SEED + 2)
    cfg = GPTConfig.gpt2_small()
    cfg.num_hidden_layers = 2
    cfg.hidden_dropout_prob = cfg.attention_dropout_prob = 0.0
    cpu_net = GPTForPretraining(cfg, lm_loss_chunks=LM_CHUNKS)
    nets = {"cpu": (cpu_net, torch.device("cpu")),
            "card": (copy.deepcopy(cpu_net).to(device), device)}
    tokens = np.random.RandomState(SEED + 2).randint(0, cfg.vocab_size,
                                                     (2, 513))
    counters = train_counters()
    out = {}
    for where, (net, dev) in nets.items():      # the card's run last
        reset_counts(counters)
        opt = AdamW(LR, parameters=net.named_parameters(), weight_decay=WD)
        ids, labels = (torch.from_numpy(a).to(dev)
                       for a in (tokens[:, :-1], tokens[:, 1:]))
        loss, _ = net(ids, labels)
        loss.backward()
        grads = {n: p.grad.detach().cpu().clone()
                 for n, p in net.named_parameters()}
        opt.step()
        opt.clear_grad()
        out[where] = (loss.item(), grads,
                    {n: p.detach().cpu().clone()
                     for n, p in net.named_parameters()})
        launches = {name: fn.launches for name, fn in counters.items()}
    check_launches("float32 step on the card", launches,
                   expected_launches(2, len(out["cpu"][1])), 1)
    check_flash_route("float32 step on the card", counters, "cuda_core")
    check_ln_route("float32 step on the card",
                   (counters["fused_layer_norm"],
                    counters["fused_layer_norm_bwd"]))
    (l_cpu, g_cpu, p_cpu), (l_gpu, g_gpu, p_gpu) = out["cpu"], out["card"]
    if not abs(l_gpu - l_cpu) <= 1e-5 * abs(l_cpu):
        raise AssertionError(f"float32 loss {l_gpu} on the card, {l_cpu} "
                             f"on the CPU")
    top = max(g.abs().max().item() for g in g_cpu.values())
    worst_g, off, total, worst_p = 0.0, 0, 0, 0.0
    for name, ref in g_cpu.items():
        diff = (g_gpu[name] - ref).abs().max().item()
        if name.endswith("k_proj.bias"):
            if max(ref.abs().max().item(),
                   g_gpu[name].abs().max().item()) > 1e-4 * top:
                raise AssertionError(f"{name}: gradient not at the "
                                     f"rounding floor")
            continue
        rel = diff / max(ref.abs().max().item(), 1e-30)
        worst_g = max(worst_g, rel)
        if rel > 1e-3:
            raise AssertionError(f"{name}: gradient off by {rel:.3e} of "
                                 f"its largest")
        d = (p_gpu[name] - p_cpu[name]).abs()
        off += int((d > 1e-6).sum())
        total += d.numel()
        worst_p = max(worst_p, d.max().item())
    if worst_p > 2 * LR * (1 + 1e-3) + 1e-6 or off > 1e-4 * total:
        raise AssertionError(f"updated parameters: max diff {worst_p}, "
                             f"{off} of {total} elements off by > 1e-6")
    log(f"float32 check (GPT-2 width, 2 layers, batch 2 x 512, one AdamW "
        f"step, card vs CPU): loss {l_gpu:.6f} vs {l_cpu:.6f}, worst "
        f"gradient error {worst_g:.3e} of its tensor's largest, updated "
        f"parameters max diff {worst_p:.3e}, {off} of {total} elements "
        f"off by > 1e-6; launches {json.dumps(launches)}, flash on the "
        f"CUDA-core route")
    return launches


def check_train_operands(cap):
    """The training kernels against their plain versions on the operands
    of one real step (layer 0's attention and first LayerNorm, the token
    embedding's AdamW), each output relative to its scale
    (``check_scaled``); returns the worst relative error per kernel."""
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.ops import layer_norm as ln
    from paddle_tpu_torch.ops.fused_adamw import adamw_plain_, fused_adamw_
    q, k, v = cap["qkv"]
    do = cap["do"]
    o, lse = fa.flash_attention_fwd(q, k, v, True)
    grads = fa.flash_attention_bwd(q, k, v, o, lse, do, True)
    torch.cuda.synchronize()
    want_o, want_lse = fa.flash_attention_fwd_plain(q, k, v, True)
    err = {"flash_attention_fwd": max(
        check_scaled("flash forward o", o, want_o, q.dtype),
        check_scaled("flash forward lse", lse, want_lse, torch.float32))}
    want = fa.flash_attention_bwd_plain(q, k, v, o, lse, do, True)
    err["flash_attention_bwd"] = max(
        check_scaled(f"flash backward d{n}", g, w, q.dtype)
        for n, g, w in zip("qkv", grads, want))
    del o, lse, grads, want_o, want_lse, want
    x, w = cap["ln"]
    d = x.shape[-1]
    x, g = x.reshape(-1, d), cap["ln_g"].reshape(-1, d)
    got = ln.fused_layer_norm_bwd(x, w, g)
    torch.cuda.synchronize()
    err["fused_layer_norm_bwd"] = max(
        check_scaled(f"LayerNorm backward {n}", a, b, x.dtype)
        for n, a, b in zip(("dx", "dw", "db"), got,
                           ln.layer_norm_bwd_plain(x, w, g)))
    (p, g, m, v_), low, hyper = cap["adamw"]
    ops = [t.clone() for t in (p, m, v_, low)]
    ref = [t.clone() for t in (p, m, v_, low)]
    fused_adamw_(ops[0], g, ops[1], ops[2], *hyper, low=ops[3])
    torch.cuda.synchronize()
    adamw_plain_(ref[0], g, ref[1], ref[2], *hyper, low=ref[3])
    err["fused_adamw"] = max(
        check_scaled(f"AdamW {n}", a, b, a.dtype)
        for n, a, b in zip(("p", "m", "v", "bf16 copy"), ops, ref))
    log(f"train step layer 0: q/k/v/dO {tuple(q.shape)} {q.dtype}, "
        f"LayerNorm x {tuple(x.shape)} {x.dtype}, AdamW p "
        f"{tuple(p.shape)} {p.dtype} grad {g.dtype}; kernel vs plain, max "
        f"|error| over max |plain| (limits {REL_TOL[torch.float32]} f32, "
        f"{REL_TOL[torch.bfloat16]} bf16): " + json.dumps(err))
    return err


def train_rows(launches, f32_launches, main):
    """The kernels line's rows of the training kernels: the train path's
    launches and the phase-2 measurements at its shapes and dtypes (the
    LayerNorm forward's as ``fused_layer_norm_train``); the ``_f32`` flash
    rows, the CUDA-core kernels, the float32 step's launches and phase
    2's float32 case."""
    rows = []
    for name, src, tpu, count in (
            ("flash_attention_fwd", FA_TC_SRC, FA_FWD_TPU,
             launches["flash_attention_fwd"]),
            ("flash_attention_bwd", FA_TC_SRC, FA_BWD_TPU,
             launches["flash_attention_bwd"]),
            ("flash_attention_fwd_f32", FA_SRC, FA_FWD_TPU,
             f32_launches["flash_attention_fwd"]),
            ("flash_attention_bwd_f32", FA_SRC, FA_BWD_TPU,
             f32_launches["flash_attention_bwd"]),
            ("fused_layer_norm_train", LN_SRC, LN_TPU,
             launches["fused_layer_norm"]),
            ("fused_layer_norm_bwd", LN_SRC, LN_BWD_TPU,
             launches["fused_layer_norm_bwd"]),
            ("fused_adamw", ADAMW_SRC, ADAMW_TPU, launches["fused_adamw"])):
        row = main[name]
        rows.append({"name": name, "route": "cuda", "source": src,
                     "replaces": tpu, "launches": count,
                     "max_abs_err": row["max_abs_err"], "ms": row["ms"],
                     "plain_ms": row["plain_ms"],
                     "bound_ms": row["bound_ms"],
                     "bound_by": row["bound_by"],
                     "library_ms": row["library_ms"]})
    return rows


def main() -> int:
    profile = "--profile" in sys.argv[1:]
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    try:
        from paddle_tpu_torch.ops import _build
    except ImportError as e:
        print(f"chip_smoke: the port is not importable here: {e}",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda")
    card = smi()
    log(card)
    nvcc = subprocess.run([_build._nvcc(), "--version"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()
    log(f"python {sys.version.split()[0]} torch {torch.__version__} cuda "
        f"{torch.version.cuda} nvcc '{nvcc[-1]}' device "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    log(f"kernel build: {_build.build_all():.2f} s for {len(_build.SOURCES)} "
        f"sources into {_build.build_dir()}")
    sass_check()
    timer = Timer(device)
    phase_kernels(device, timer)
    phase_ln_routes(device)
    phase_quant_kernel(device, timer)
    train_main = phase_train_kernels(device, timer)
    model, prompts, outs, bf16_stats, launches, captured = phase_engine(
        device, profile)
    quant_launches, quant_captured = phase_engine_quant(
        model, prompts, outs, bf16_stats, profile)
    gen_launches = phase_generate(model, device, profile)
    del model
    gen_f32_launches = phase_generate_f32(device)
    train_launches, train_cap = phase_train(device, profile)
    f32_launches = phase_f32_check(device)
    kernels = report_engine(device, timer, launches, captured,
                            quant_launches, quant_captured)
    # the engine row of the LayerNorm forward counts the three serving
    # runs; its fused_layer_norm_train row, the train path's
    ln_row = next(k for k in kernels if k["name"] == "fused_layer_norm")
    ln_row["launches"] += quant_launches["fused_layer_norm"]
    check_train_operands(train_cap)
    kernels += train_rows(train_launches, f32_launches, train_main)
    # the float32 generate's K2 launches join the generate row, its K4
    # launches (the CUDA-core route) the _f32 flash row
    kernels += generate_rows(device, timer, {
        "fused_layer_norm": gen_launches["fused_layer_norm"]
        + gen_f32_launches["fused_layer_norm"],
        "flash_attention_fwd": gen_launches["flash_attention_fwd"]})
    f32_fwd = next(k for k in kernels
                   if k["name"] == "flash_attention_fwd_f32")
    f32_fwd["launches"] += gen_f32_launches["flash_attention_fwd"]
    for k in kernels:
        for key, v in k.items():
            if isinstance(v, float) and not math.isfinite(v):
                raise AssertionError(f"{k['name']}: {key} = {v}")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
