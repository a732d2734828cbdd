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
   card, in float32, bfloat16 and float16, with the errors, the median
   times, the bounds and the library call's time: the serving kernels at
   the serving path's widths (GPT-2: 12 heads, head_dim 64, hidden 768,
   KV blocks of 16; the quantized KV kernel over int8 and float8_e4m3fn
   pools in blocks of 32), the training kernels at the training path's
   (flash attention at [8, 1024, 12, 64] and at the ragged length 1000,
   causal, on both routes: bfloat16 and float16 on the tensor-core
   kernels (a second call must give the same bits), bfloat16 also at
   head_dim 128, float32 and the same 16-bit operands at an unaligned
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
   where the CPU's top-2 logit margin falls below ``GEN_TOL``. Beam
   search (``num_beams=4``, 32 new tokens) on the 8 unmasked prompts (K4
   L times in the prefill, K2 (2L + 1) x steps at [32, 768] rows) and on
   the left-padded batch with ``length_penalty=0.6`` and an
   ``eos_token_id`` (no K4; the steps counted by a spy); beam tokens/s
   and ms a step; then a float32 2-layer beam search on the card and on
   a CPU copy: every row whose K + 1 best candidates never come within
   ``GEN_TOL`` of each other gives the same tokens;
3d. gather engines: phase 3's 16 requests (64 new tokens, greedy) on the
   same bf16 model through ``GenerationEngine(kv_layout="dense",
   attention="gather", min_bucket=32)``, ``kv_layout="paged",
   attention="gather", block_size=16`` and the same with
   ``kv_dtype="int8", block_size=32``: tokens/s, mean step ms, TTFT;
   K2 launches equal to (2L + 1) x (prefills + decode steps), K4 and
   K1/K1q held at 0 launches (the gather path computes attention
   without them). Then float32 at GPT-2 width cut to 2 layers: the dense
   and paged gather engines on the card against a CPU copy (first-step
   logits within ``GEN_TOL``), and the dense, paged gather and fused
   engines on the card agreeing token for token up to each request's
   first top-2 logit margin below ``GEN_TOL``; the int8 paged gather
   engine on the card against a CPU copy, one request at a time (every
   step's logits within ``QUANT_GEN_TOL``, tokens equal up to the first
   top-2 margin below it), and to that step the concurrent int8 gather
   and int8 fused engines on the card giving the same tokens;
3e. float16 serving: GPT-2 small in float16 (full width and depth,
   random weights from a seed) through the fused engine over a float16
   pool (blocks of 16) and over int8 and fp8 pools (blocks of 32), phase
   3's 16 requests each: K1/K1q 12 launches a step, all on the
   tensor-core route, K2 (2L + 1) a step, tokens/s, TTFT, mean step ms;
   the float16 dense gather engine on the same requests as the card's
   oracle (K1/K1q at 0; its tokens equal the fused float16 engine's up
   to each request's first top-2 logit margin below ``F16_GEN_TOL``);
   the int8 pool's one-step logit drift against a float16 pool within
   phase 3b's bound; ``generate`` over 8 unmasked prompts of 512, 32 new
   tokens (K4 float16 on the tensor-core route in the prefill); no plain
   version on the card; then a 2-layer float16 fused engine on the card
   and on a CPU copy: the first step's logits within ``F16_GEN_TOL``.
   Forward pre-hooks record the shape of every float16 K2 launch of the
   phase under ``fused_layer_norm_serve_f16``;
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
4b. the recipe: GPT-2 small (full width and depth) trained through
   ``Model.fit`` the way it is trained: AdamW with f32 masters, bf16 O2,
   ``LinearWarmup(CosineAnnealingDecay(6e-4))`` over 4 warmup steps,
   ``ClipGradByGlobalNorm(1.0)``, no decay on biases and LayerNorm, 2
   epochs of 8 batches of 8 x 1024 tokens, 2 held-out batches evaluated
   after each epoch, checkpoints in a temporary ``save_dir`` and
   ``History``: each step's lr equal to the
   scheduler's closed form, each step's pre-clip global norm logged
   (GPT-2's stays below 1.0 here, so after the fit one more step runs
   with the clip norm at half the smallest, and its clipped gradients
   must have that global norm), the launches as phase 4 derives them plus
   the evaluated batches' forward kernels, and no call of any plain
   version; ``evaluate`` and ``eval_batch`` give 0.0 (GPT's labels are
   among its inputs, so there is no label batch: the JAX package's
   value), and the held-out loss is read from ``predict``'s first output
   (the network's own loss) and must be finite; a fresh ``Model`` loaded
   from the ``final`` checkpoint gives the same held-out loss and takes
   two more train steps within ``RESUME_TOL`` of the live one;
4c. float16: GPT-2 small in float16 O2 through the eager loop
   ``scaler.scale(loss).backward(); scaler.step(opt); scaler.update()``
   (``GradScaler(2**15, decr_every_n_nan_or_inf=1)``, AdamW with f32
   masters), 8 steps: flash on the tensor-core route in float16, AdamW on
   f32 masters with float16 gradients and copies, one AdamW launch per
   parameter of each step the scaler applied, no plain version; then one
   step whose gradient a hook makes non-finite: parameters, masters and
   moments keep their bits, AdamW launches 0 times, the scale halves, the
   optimizer's step stays; the next step applies. Then the same loop at
   GPT-2 width cut to 2 layers (batch 2 x 128) on the card and on a CPU
   copy: losses within ``FP16_LOSS_TOL`` and the same loss scales;
4d. bf16 O1: GPT-2 small with float32 parameters through ``Model.fit``
   at ``amp_configs={"level": "O1"}``, 8 steps on one repeated batch:
   AdamW on f32 parameters and gradients (no master), flash in bf16 on
   the tensor-core route, LayerNorm in f32, the loss finite and falling.
   Each of 4b-4d prints tokens/s, ms a step (wall / steps and the median
   step) and the peak memory, with the card's name and power limit;
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
   float32 generate's and beam search's); ``fused_layer_norm_generate``,
   ``fused_layer_norm_beam`` and ``fused_layer_norm_gather`` count the K2
   launches of phase 3c's generate runs, of its beam searches and of
   phase 3d's gather engines: forward pre-hooks on the model's LayerNorm
   modules record the dtype and rows of each of those launches, every
   such shape is held against the plain version and timed, and each row
   reports the largest error and the times at its decode step's rows
   (bf16 [8, 768], [32, 768] and [8, 768]);
   ``flash_attention_fwd_generate`` (K4 at the prefill's shape, bf16 [8,
   512, 12, 64] causal) counts the unmasked generate and beam prefills.
   The float16 rows (``_f16``: flash [8, 1024, 12, 64] causal on the
   tensor-core kernels beside SDPA in float16, with the CUDA-core
   kernels' time on the same operands as ``core_ms``, the LayerNorm
   forward and
   backward at [8192, 768], AdamW with an f32 master and a float16
   gradient and copy) and ``fused_adamw_f32`` (an f32 parameter and
   gradient) come from phase 2 too; the float16 rows count phase 4c's
   launches, ``fused_adamw_f32`` phase 4d's and the float32 step's. The
   float16 LayerNorm rows count 0, with the reason: LayerNorm is on the
   AMP black list, so every AMP path runs it in float32, and the f32
   rows count phases 4, 4b, 4c and 4d; the bf16 tensor-core flash rows
   count phases 4, 4b and 4d. Phase 3e's rows: K1 float16 and K1q
   int8/fp8 with float16 q (``ragged_paged_attention_f16``,
   ``_int8_f16``, ``_fp8_f16``) on the layer-0 operands of each float16
   engine's widest and decode-only steps, with the CUDA-core kernel on
   the same operands (``core_ms``); ``fused_layer_norm_serve_f16``
   (every float16 K2 launch of phase 3e, held at each shape, timed at
   the widest fused step's rows, the row route as ``core_ms``);
   ``flash_attention_fwd_generate_f16`` (K4 float16 at [8, 512, 12,
   64] causal, the float16 generate's prefill).

``--profile`` adds one more batch to the bf16 and the int8 engines and
to the dense and paged gather engines, one more greedy generate, one
more beam search and two more train steps under torch.profiler and
prints device time by kernel and the device's idle share.

Times come from CUDA events around single launches, median of 20,
with the 50 MB L2 cache flushed and the device kept busy until the
launch is queued, so neither a warm cache nor the host's launch
overhead enters them. Float32 products run without TF32.
"""
from __future__ import annotations

import collections
import contextlib
import gc
import json
import math
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

SEED = 0
HBM_BYTES_PER_S = 3.35e12            # H100 SXM data sheet
PEAK_OPS = {torch.bfloat16: 989e12,   # dense tensor-core rate
            torch.float16: 989e12,
            torch.float32: 67e12}     # outside the tensor cores
TOL = {torch.float32: (1e-4, 0.0),    # (atol, rtol)
       torch.bfloat16: (2e-2, 1e-2),  # one bf16 ulp of |y| < 4 is <= 1.6e-2
       torch.float16: (5e-3, 5e-3)}   # a few f16 ulps (P, dS rounded to f16)
# max |kernel - plain| over max |plain|, for the operands of a real step:
# f32 sums in another order; a little over two bf16 ulps of the largest value
REL_TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2, torch.float16: 5e-3}
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
# the kernels line's row suffix of each dtype's measurements
DTYPE_TAIL = {torch.bfloat16: "", torch.float32: "_f32",
              torch.float16: "_f16"}
# the bench_gpt2 configuration (bench.py:158)
BATCH, SEQ, LM_CHUNKS, LR, WD = 8, 1024, 8, 1e-4, 0.01
WARM_STEPS, TIMED_STEPS = 2, 8
# generate: 8 prompts x 512 tokens, 64 new; 4 left-padded rows of a
# 256-wide batch, 32 new
GEN_BATCH, GEN_PROMPT, GEN_NEW = 8, 512, 64
GEN_MASKED = (4, 256, 32)
# beam search: 4 beams, 32 new tokens, on the generate prompts
BEAM_K, BEAM_NEW = 4, 32
# float32 first-step logits, card vs CPU: the same f32 arithmetic summed
# in other orders over 2 blocks and a 768-wide head, |logits| ~ 1
GEN_TOL = 2e-4
# float32 logits over an int8 pool, card vs CPU: a K/V value that lies
# within float32 rounding of a code boundary takes the neighbouring code
# on one side, and one such code moves a logit by far more than GEN_TOL
QUANT_GEN_TOL = 5e-3
# float16 serving (phase 3e): logits of |x| < ~3 carry float16 rounding
# at every block; one float16 forward of GPT-2 small lies within 3.7e-3
# of the float32 one (measured on the CPU), so two float16 paths may
# pick either of two tokens whose logits are closer than this
F16_GEN_TOL = 1e-2
# float16 generate: 8 unmasked prompts of 512 tokens, 32 new
F16_GEN = (8, 512, 32)
# the dtype and [rows, D] of every LayerNorm a path ran, under the
# kernels line's row that counts its launches (see ln_shapes)
LN_SHAPES = collections.defaultdict(collections.Counter)


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
    int8 and fp8 pools, f32, bf16 and f16 q, against the plain version."""
    from paddle_tpu_torch.ops.ragged_paged_attention import (
        ragged_paged_attention, ragged_paged_attention_plain, rpa_route)
    rng = np.random.RandomState(SEED + 3)
    torch.manual_seed(SEED + 3)
    for storage in (torch.int8, torch.float8_e4m3fn):
        for dtype in (torch.float32, torch.bfloat16, torch.float16):
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
    for dtype in (torch.float32, torch.bfloat16, torch.float16):
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


@contextlib.contextmanager
def ln_shapes(model, row):
    """Record under ``LN_SHAPES[row]`` the dtype and [rows, D] of every
    LayerNorm that ``model`` (on the card) runs inside the block, each one
    K2 launch, through forward pre-hooks on its LayerNorm modules."""
    from paddle_tpu_torch.nn.layer.norm import LayerNorm
    seen = LN_SHAPES[row]

    def hook(_module, args):
        x = args[0]
        seen[(x.dtype, x.numel() // x.shape[-1], x.shape[-1])] += 1

    handles = [m.register_forward_pre_hook(hook) for m in model.modules()
               if isinstance(m, LayerNorm)]
    try:
        yield
    finally:
        for h in handles:
            h.remove()


def ln_shape_row(timer, name, launches, main):
    """The kernels line's LayerNorm-forward row ``name``: K2 against its
    plain version (both routes, timed) at every dtype and [rows, D] that
    the row's ``launches`` ran at (``LN_SHAPES[name]``, which must count
    them all); the row reports the largest warp-route error of any shape
    (the route every path launch took) and the times of ``main``, a
    (dtype, rows, D) key."""
    shapes = LN_SHAPES[name]
    if sum(shapes.values()) != launches or main not in shapes:
        raise AssertionError(f"{name}: {launches} launches, LayerNorm "
                             f"calls by shape {dict(shapes)}")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 7)

    def randn(*shape, dtype, scale=1.0):
        return (scale * torch.randn(*shape, device="cuda", generator=gen)
                ).to(dtype)

    rows, err = {}, 0.0
    for dtype, n, d in sorted(shapes, key=lambda k: (str(k[0]), k[1])):
        row = ln_fwd_case(timer, randn(n, d, dtype=dtype),
                          1 + randn(d, dtype=dtype, scale=0.1),
                          randn(d, dtype=dtype, scale=0.1))
        rows[(dtype, n, d)] = row
        err = max(err, row["max_abs_err"])
        log(f"K2 {name}: {str(dtype)[6:]} [{n}, {d}], "
            f"{shapes[(dtype, n, d)]} launches {fmt(row)}")
    return dict(rows[main], max_abs_err=err)


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
    return err_f, err_b, o, lse, grads


def flash_case(timer, q, k, v, do, causal=True, route="tc", core=False):
    """Forward and backward kernels of ``route`` against their plain
    versions on (q, k, v, dO), timed beside the plain versions and beside
    ``scaled_dot_product_attention`` and its autograd backward (on the
    tensor-core route a second call must give the same bits); with
    ``core``, the same operands at an unaligned base through the CUDA-core
    kernels too, checked and timed (``core_ms``). Returns the forward's
    and the backward's measurements."""
    from paddle_tpu_torch.ops import flash_attention as fa
    dtype = q.dtype
    err_f, err_b, o, lse, grads = flash_check(q, k, v, do, causal, route)
    if route == "tc":      # no output is shared between CTAs
        again = (*fa.flash_attention_fwd(q, k, v, causal),
                 *fa.flash_attention_bwd(q, k, v, o, lse, do, causal))
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip((o, lse, *grads),
                                                     again)):
            raise AssertionError(f"flash tc {dtype} {tuple(q.shape)}: a "
                                 f"second call gave other bits")
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
        fwd["core_err"], bwd["core_err"], oc, lc, _ = flash_check(
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
        err = max(err, check_close(f"AdamW {low.dtype} copy", low_k, low_r,
                                   low.dtype))
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
    # p, m, v read and written, g read, the 16-bit copy written
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
            (torch.bfloat16, SEQ, 128, "tc"),
            (torch.float16, SEQ, 64, "tc"),
            (torch.float16, 1000, 64, "tc")):
        q, k, v, do = (randn(BATCH, seq, 12, d, dtype=dtype)
                       for _ in range(4))
        fwd, bwd = flash_case(timer, q, k, v, do, route=route,
                              core=route == "tc" and d == 64)
        if seq == SEQ and d == 64:
            tail = DTYPE_TAIL[dtype]
            main["flash_attention_fwd" + tail] = fwd
            main["flash_attention_bwd" + tail] = bwd
        shape = f"{str(dtype)[6:]} [{BATCH}, {seq}, 12, {d}] causal"
        log(f"K4/K5 flash_attention_fwd {route} route {shape} {fmt(fwd)}")
        log(f"K6/K7 flash_attention_bwd {route} route {shape} {fmt(bwd)}")
        del q, k, v, do
    for dtype in (torch.float32, torch.bfloat16, torch.float16):
        name = str(dtype)[6:]
        x = randn(BATCH * SEQ, 768, dtype=dtype)
        w = (1 + randn(768, scale=0.1)).to(dtype)
        g = randn(BATCH * SEQ, 768, dtype=dtype)
        row = ln_bwd_case(timer, x, w, g)
        log(f"K3 fused_layer_norm_bwd {name} [{BATCH * SEQ}, 768] "
            f"{fmt(row)}")
        fwd = ln_fwd_case(timer, x, w, randn(768, dtype=dtype, scale=0.1))
        log(f"K2 fused_layer_norm {name} [{BATCH * SEQ}, 768] {fmt(fwd)}")
        if dtype == torch.float32:           # AMP runs LayerNorm in f32
            main["fused_layer_norm_bwd"] = row
            main["fused_layer_norm_train"] = fwd
        if dtype == torch.float16:
            main["fused_layer_norm_bwd_f16"] = row
            main["fused_layer_norm_f16"] = fwd
    n = (50304, 768)
    # (grad and copy dtype or None): the O2 bf16 master, the O1 / float32
    # parameter, the O2 float16 master
    for half in (torch.bfloat16, None, torch.float16):
        p = randn(*n, scale=0.02)
        g = randn(*n, dtype=half or torch.float32, scale=1e-3)
        m, v = randn(*n, scale=1e-4), randn(*n, scale=1e-4).square()
        low = None if half is None else torch.empty(n, dtype=half,
                                                    device=device)
        row = adamw_case(timer, p, g, m, v, low, LR, 0.9, 0.999, 1e-8, WD,
                         3)
        what = "f32" if half is None else \
            f"f32 master, {str(half)[6:]} grad and copy"
        log(f"K8 fused_adamw {what} [50304, 768] {fmt(row)}")
        main["fused_adamw" + DTYPE_TAIL[half or torch.float32]] = row
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
    with GenerationEngine(model, kv_layout="paged", attention="fused",
                          num_slots=2, block_size=16, prefill_budget=32,
                          device=device) as eng:
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


def serve_mix(model, prompts, max_new, profile=False, rng=None,
              ln_row=None, **kw):
    """Serve ``prompts`` at once through a fused paged engine built with
    ``kw``, after one short warm-up request, with every serving kernel's
    count set to 0 just before and read just after; every attention
    launch must take the tensor-core route. With ``ln_row``, the shape of
    every LayerNorm launch of the counted window is recorded under that
    kernels-line row. Keeps the layer-0 attention
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
        with contextlib.ExitStack() as stack:
            if ln_row is not None:
                stack.enter_context(ln_shapes(model, ln_row))
            t0 = time.perf_counter()
            handles = [eng.submit(p, max_new_tokens=max_new)
                       for p in prompts]
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
            with GenerationEngine(model, kv_layout="paged",
                                  attention="fused", num_slots=1,
                                  block_size=32, prefill_budget=len(prompt),
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


# ---------------------------------------------------------------- phase 3d
def gather_counters():
    """The launch-counting wrappers a gather engine's run is held to:
    K2 at every LayerNorm, and K4 and K1/K1q, which must not launch."""
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.ops import layer_norm as ln
    from paddle_tpu_torch.ops.ragged_paged_attention import (
        ragged_paged_attention)
    return {"fused_layer_norm": ln.fused_layer_norm,
            "flash_attention_fwd": fa.flash_attention_fwd,
            "ragged_paged_attention": ragged_paged_attention}


def gather_launches(counters):
    rpa = counters["ragged_paged_attention"]
    return {"fused_layer_norm": counters["fused_layer_norm"].launches,
            "flash_attention_fwd": counters["flash_attention_fwd"].launches,
            "ragged_paged_attention": rpa.launches + rpa.quant_launches}


def gather_want(n_layers, programs):
    """K2 at ln_1, ln_2 of every block and ln_f in each prefill and each
    decode step; the prefills are masked (left- or right-padded in their
    bucket) and every decode attends through the masked plain
    composition, so K4 never launches, and the gather path never reaches
    K1/K1q."""
    return {"fused_layer_norm": (2 * n_layers + 1) * programs,
            "flash_attention_fwd": 0, "ragged_paged_attention": 0}


def serve_gather(what, model, prompts, max_new, profile=False, rng=None,
                 ln_row="fused_layer_norm_gather", **kw):
    """Serve ``prompts`` at once through a gather engine built with
    ``kw``, after one short warm-up request, with the counts set to 0 just
    before and read just after: they must equal :func:`gather_want` over
    the prefills and decode steps the engine ran, every K2 launch on the
    warp-row route. Returns (outputs, stats, launches, steps, prefills,
    wall seconds)."""
    from paddle_tpu_torch.serving import GenerationEngine
    vocab = model.gpt.cfg.vocab_size
    L = model.gpt.cfg.num_hidden_layers
    eng = GenerationEngine(model, num_slots=8, seed=SEED,
                           device=next(model.parameters()).device, **kw)
    warm = np.random.RandomState(SEED + 9)
    eng.submit(warm.randint(0, vocab, 24), max_new_tokens=4).result(
        timeout=300)
    counters = gather_counters()
    reset_counts(counters)
    for attr in RPA_COUNTS:
        setattr(counters["ragged_paged_attention"], attr, 0)
    s0 = eng.stats()
    with ln_shapes(model, ln_row):
        t0 = time.perf_counter()
        handles = [eng.submit(p, max_new_tokens=max_new) for p in prompts]
        outs = [h.result(timeout=600) for h in handles]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    stats = eng.stats()
    launches = gather_launches(counters)
    steps = stats["steps"] - s0["steps"]
    prefills = stats["prefills"] - s0["prefills"]
    want = gather_want(L, steps + prefills)
    if launches != want:
        raise AssertionError(f"{what}: launches {launches} over {prefills} "
                             f"prefills and {steps} decode steps, expected "
                             f"{want}")
    check_ln_route(what, (counters["fused_layer_norm"],))
    if profile:
        profile_engine(eng, rng, vocab)
    eng.close()
    for p, h, out in zip(prompts, handles, outs):
        if len(h.tokens) != max_new or out.shape != (len(p) + max_new,):
            raise AssertionError(f"{what}: request {h.id}: "
                                 f"{len(h.tokens)} tokens")
        if not ((out >= 0) & (out < vocab)).all():
            raise AssertionError(f"{what}: request {h.id}: token out of "
                                 f"range")
    if stats["nonfinite_cycles"]:
        raise AssertionError(f"{what}: non-finite logits in "
                             f"{stats['nonfinite_cycles']} cycles")
    return outs, stats, launches, steps, prefills, wall


def phase_gather(model, prompts, fused_outs, profile=False):
    """Phase 3d: phase 3's 16 requests (64 new tokens, greedy) through
    the dense engine, the paged gather engine and the int8 paged gather
    engine on the bf16 model; then the float32 check. Returns the K2
    launches of the phase: the gather engines' and the float32 fused
    engines'."""
    L = model.gpt.cfg.num_hidden_layers
    rng = np.random.RandomState(SEED + 8)
    total = 0
    for what, kw in (
            ("dense engine", dict(kv_layout="dense", attention="gather",
                                  min_bucket=32)),
            ("paged gather engine", dict(kv_layout="paged",
                                         attention="gather",
                                         block_size=16)),
            ("int8 paged gather engine", dict(kv_layout="paged",
                                              attention="gather",
                                              kv_dtype="int8",
                                              block_size=32))):
        outs, stats, launches, steps, prefills, wall = serve_gather(
            what, model, prompts, 64, profile and "int8" not in what, rng,
            **kw)
        total += launches["fused_layer_norm"]
        toks = 64 * len(prompts)
        same = sum(int(a[len(p)] == b[len(p)])
                   for p, a, b in zip(prompts, outs, fused_outs))
        hits = stats.get("prefix_hits", 0)
        log(f"{what}: GPT-2 small bf16, {len(prompts)} requests x 64 "
            f"tokens, {prefills} prefills and {steps} decode steps in "
            f"{wall:.3f} s: {toks / wall:.1f} tokens/s, mean step "
            f"{wall / steps * 1e3:.3f} ms (wall / decode steps), TTFT p50 "
            f"{stats['ttft_ms']['p50']:.1f} ms p95 "
            f"{stats['ttft_ms']['p95']:.1f} ms, TPOT p50 "
            f"{stats['tpot_ms']['p50']:.2f} ms, prefix hits {hits}, "
            f"preempts {stats['preempts']}; launches {json.dumps(launches)} "
            f"(K1/K1q held at 0); {same} of {len(prompts)} first tokens "
            f"equal the fused engine's (reported, not gated: bf16 paths "
            f"round differently and random weights have thin margins)")
    f32 = phase_gather_f32(next(model.parameters()).device)
    return {"gather": total + f32["gather"], "fused": f32["fused"]}


def engine_run(net, prompts, new, spy, row=None, num_slots=4, alone=1,
               **kw):
    """``prompts[:alone]`` one after another, then the rest at once,
    through an engine built with ``kw``; ``spy`` stands in for the head
    (``gpt.logits``). With ``row``, the LayerNorm shapes are recorded
    under it. Returns the outputs and the K2 launches."""
    from paddle_tpu_torch.serving import GenerationEngine
    counters = gather_counters()
    reset_counts(counters)
    net.gpt.logits = spy
    try:
        with contextlib.ExitStack() as stack:
            if row is not None:
                stack.enter_context(ln_shapes(net, row))
            eng = stack.enter_context(GenerationEngine(
                net, num_slots=num_slots,
                device=next(net.parameters()).device, **kw))
            outs = [eng.submit(p, max_new_tokens=new).result(timeout=300)
                    for p in prompts[:alone]]
            outs += [h.result(timeout=300) for h in
                     [eng.submit(p, max_new_tokens=new)
                      for p in prompts[alone:]]]
    finally:
        del net.gpt.logits
    return outs, counters["fused_layer_norm"].launches


def first_near_tie(margins, tol):
    """Per request, the first step whose top-2 logit margin (``margins
    [R, steps]``) is below ``tol``; ``steps`` where none is."""
    low = margins < tol
    return [int(torch.nonzero(m)[0]) if bool(m.any()) else len(m)
            for m in low]


def hold_tokens(what, outs, ref, prompts, ties):
    """``outs`` equal to ``ref`` for every request before its near-tie
    step in ``ties``; returns how many are equal in full."""
    for i, (p, t) in enumerate(zip(prompts, ties)):
        got, want = outs[i][len(p):len(p) + t], ref[i][len(p):len(p) + t]
        if not np.array_equal(got, want):
            raise AssertionError(f"request {i}: {what} tokens {got} "
                                 f"!= {want} before its first near-tie at "
                                 f"step {t}")
    return sum(np.array_equal(a, b) for a, b in zip(outs, ref))


def phase_gather_f32(device):
    """Float32 at GPT-2 width cut to 2 layers, 4 requests of 16 tokens,
    the first alone and then three at once. Float pools: the dense and
    paged gather engines on the card and on a CPU copy of the same
    weights (plain versions), the first prefill's logits within
    ``GEN_TOL``, and the dense, paged gather and fused engines' greedy
    tokens on the card equal up to each request's first step whose top-2
    logit margin (a full forward over the fused engine's tokens) falls
    below ``GEN_TOL``. The int8 pool: the paged gather engine's first
    prefill logits card vs CPU within ``GEN_TOL``; then the requests one
    at a time (one slot) on the card and on the CPU, every step's logits
    within ``QUANT_GEN_TOL`` and the tokens equal up to each request's
    first CPU top-2 margin below ``QUANT_GEN_TOL``, and to that step the
    concurrent int8 gather and int8 fused engines on the card give the
    same tokens (the fused engine takes each prompt in one chunk, so
    both quantize the same blocks from the same rows). Returns the card
    runs' K2 launches: the gather engines' and the fused engines'."""
    import copy

    import paddle_tpu_torch as pt
    from paddle_tpu_torch.models import GPTConfig, GPTForPretraining
    pt.seed(SEED + 5)
    cfg = GPTConfig.gpt2_small()
    cfg.num_hidden_layers = 2
    cpu_net = GPTForPretraining(cfg).eval()
    card_net = copy.deepcopy(cpu_net).to(device)
    rng = np.random.RandomState(SEED + 5)
    prompts = [rng.randint(0, cfg.vocab_size, n) for n in (40, 7, 100, 300)]
    new = 16
    int8 = dict(kv_layout="paged", kv_dtype="int8", block_size=32)
    engines = {"dense": dict(kv_layout="dense", min_bucket=32),
               "paged gather": dict(kv_layout="paged", block_size=16),
               "int8 paged gather": int8,
               "fused": dict(kv_layout="paged", attention="fused",
                             block_size=16, prefill_budget=128),
               "int8 fused": dict(int8, attention="fused",
                                  prefill_budget=512)}
    card, errs = {}, {}
    launches = {"gather": 0, "fused": 0}
    for kind, kw in engines.items():
        fused = "fused" in kind
        first = {}
        for where, net in (("cpu", cpu_net), ("card", card_net)):
            if fused and where == "cpu":
                continue

            def spy(h, _gpt=net.gpt, _rec=first, _where=where):
                out = type(_gpt).logits(_gpt, h)
                _rec.setdefault(_where, out[:, -1].float().cpu())
                return out

            row = None if fused or where == "cpu" \
                else "fused_layer_norm_gather"
            outs, n = engine_run(net, prompts, new, spy, row, **kw)
            if where == "card":
                card[kind] = outs
                launches["fused" if fused else "gather"] += n
        if not fused:
            errs[kind] = (first["card"] - first["cpu"]).abs().max().item()
            if not errs[kind] <= GEN_TOL:
                raise AssertionError(
                    f"float32 {kind} engine: first-step logits card vs CPU "
                    f"off by {errs[kind]}, over {GEN_TOL}")
    with torch.no_grad():
        margins = []
        for i, p in enumerate(prompts):
            seq = torch.from_numpy(card["fused"][i]).long().to(device)
            top2 = card_net(seq[None])[0, len(p) - 1:-1].float().topk(
                2, dim=-1).values
            margins.append((top2[:, 0] - top2[:, 1]).cpu())
    ties = first_near_tie(torch.stack(margins), GEN_TOL)
    full = min(hold_tokens(f"{k} engine", card[k], card["fused"], prompts,
                           ties) for k in ("dense", "paged gather"))
    log(f"gather engines float32 check (GPT-2 width, 2 layers, "
        f"{len(prompts)} requests of {[len(p) for p in prompts]} tokens, "
        f"{new} new): first-step logits card vs CPU max |diff| dense "
        f"{errs['dense']:.3e}, paged gather {errs['paged gather']:.3e} "
        f"(limit {GEN_TOL}); on the card the dense, paged gather and fused "
        f"engines' tokens agree before each request's first top-2 margin "
        f"below {GEN_TOL} (step {ties}, {new} = none), all {new} equal in "
        f"{full} of {len(prompts)} requests")

    # the int8 pool, one request at a time: every logits call is one
    # step of one request, in order
    steps = {}
    for where, net in (("cpu", cpu_net), ("card", card_net)):
        rec = []

        def spy(h, _gpt=net.gpt, _rec=rec):
            out = type(_gpt).logits(_gpt, h)
            _rec.append(out[:, -1].float().cpu())
            return out

        outs, n = engine_run(
            net, prompts, new, spy,
            None if where == "cpu" else "fused_layer_norm_gather",
            num_slots=1, alone=len(prompts), **int8)
        if len(rec) != len(prompts) * new:
            raise AssertionError(f"int8 gather engine, one slot: "
                                 f"{len(rec)} logits calls")
        steps[where] = (outs, torch.cat(rec).view(len(prompts), new, -1))
        if where == "card":
            launches["gather"] += n
    (cpu_outs, cpu_l), (card_outs, card_l) = steps["cpu"], steps["card"]
    top2 = cpu_l.topk(2, dim=-1).values
    qties = first_near_tie(top2[..., 0] - top2[..., 1], QUANT_GEN_TOL)
    # steps up to the near-tie feed the same tokens on both sides
    diff = (card_l - cpu_l).abs().amax(dim=-1)                  # [R, new]
    qerr = max(diff[i, :t + 1].max().item() for i, t in enumerate(qties))
    if not qerr <= QUANT_GEN_TOL:
        raise AssertionError(f"float32 int8 gather engine: step logits card "
                             f"vs CPU off by {qerr}, over {QUANT_GEN_TOL}")
    same = [hold_tokens(what, outs, card_outs, prompts, qties)
            for what, outs in (
                ("int8 gather engine one slot, CPU", cpu_outs),
                ("int8 gather engine", card["int8 paged gather"]),
                ("int8 fused engine", card["int8 fused"]))]
    log(f"int8 gather engine float32 check (block 32, same requests): "
        f"first-step logits card vs CPU max |diff| "
        f"{errs['int8 paged gather']:.3e} (limit {GEN_TOL}); one slot, "
        f"every step's logits card vs CPU up to each request's first CPU "
        f"top-2 margin below {QUANT_GEN_TOL} (step {qties}, {new} = none) "
        f"within {qerr:.3e} (limit {QUANT_GEN_TOL}); before it the card's "
        f"tokens equal the CPU's, the concurrent int8 gather engine's and "
        f"the int8 fused engine's, all {new} equal in {same} of "
        f"{len(prompts)} requests; K2 launches {json.dumps(launches)}")
    return launches


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


def gen_run(what, model, ids, want, flash_route,
            ln_row="fused_layer_norm_generate", **kw):
    """One ``model.generate(ids, **kw)`` with the counts set to 0 just
    before and read just after: they must equal ``want``, every
    LayerNorm launch on the warp-row route and every flash launch on
    ``flash_route``. Returns (tokens, wall seconds, launches, call_op
    calls)."""
    counters = gen_counters()
    reset_counts(counters)
    calls0 = op_calls()
    torch.cuda.synchronize()
    with ln_shapes(model, ln_row):
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


def beam_run(what, model, ids, flash_want, flash_route, **kw):
    """One beam-search ``model.generate(ids, **kw)`` with the counts set
    to 0 just before and read just after. Its steps (the prefill and
    each decode step, counted by a spy on ``decode_step``) give the want:
    K2 (2L + 1) x steps, K4 ``flash_want`` (L in an unmasked prefill at
    ``[B]``, 0 masked), every K2 launch on the warp-row route and every
    K4 launch on ``flash_route``. Returns (tokens, wall seconds,
    launches, steps)."""
    gpt = model.gpt
    L = gpt.cfg.num_hidden_layers
    counters = gen_counters()
    reset_counts(counters)
    calls = []
    decode = gpt.decode_step
    gpt.decode_step = lambda *a, **k: calls.append(1) or decode(*a, **k)
    try:
        torch.cuda.synchronize()
        with ln_shapes(model, "fused_layer_norm_beam"):
            t0 = time.perf_counter()
            out = model.generate(ids, **kw)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    finally:
        del gpt.decode_step
    steps = len(calls) + 1
    launches = {name: fn.launches for name, fn in counters.items()}
    want = {"fused_layer_norm": (2 * L + 1) * steps,
            "flash_attention_fwd": flash_want}
    if launches != want:
        raise AssertionError(f"{what}: launches {launches} over {steps} "
                             f"steps, expected {want}")
    if kw.get("eos_token_id") is None and steps != kw["max_new_tokens"]:
        raise AssertionError(f"{what}: {steps} steps for "
                             f"{kw['max_new_tokens']} tokens")
    check_ln_route(what, (counters["fused_layer_norm"],))
    fa_fn = counters["flash_attention_fwd"]
    on = fa_fn.tc_launches if flash_route == "tc" else fa_fn.core_launches
    if on != fa_fn.launches:
        raise AssertionError(f"{what}: {fa_fn.launches} flash launches, "
                             f"{on} on the {flash_route} route")
    vocab = gpt.cfg.vocab_size
    if not (tuple(out.shape) == (ids.shape[0],
                                 ids.shape[1] + kw["max_new_tokens"])
            and torch.equal(out[:, :ids.shape[1]].long(), ids.long())
            and bool(((out >= 0) & (out < vocab)).all())):
        raise AssertionError(f"{what}: tokens {tuple(out.shape)}, prompt "
                             f"changed or token out of range")
    return out, wall, launches, steps


def profile_beam(model, ids):
    """Device time by kernel and the idle share over one more beam
    search, under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        model.generate(ids, max_new_tokens=BEAM_NEW, num_beams=BEAM_K)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    device_time_report("beam search", prof, wall_ms, BEAM_NEW)


def phase_beam(model, ids, mids, mask, eos, profile=False):
    """Beam search on the bf16 model: ``num_beams=4``, 32 new tokens, on
    phase 3c's 8 unmasked 512-token prompts (K4 in the prefill at [8],
    K2 at [32, 768] rows a decode step), then on its left-padded batch
    with ``length_penalty=0.6`` and an ``eos_token_id``. Returns the
    launches."""
    L = model.gpt.cfg.num_hidden_layers
    beam, wall, launches, steps = beam_run(
        "beam search", model, ids, L, "tc", max_new_tokens=BEAM_NEW,
        num_beams=BEAM_K)
    log(f"beam search: GPT-2 small bf16, {ids.shape[0]} prompts x "
        f"{ids.shape[1]} tokens, num_beams {BEAM_K}, {BEAM_NEW} new: "
        f"{wall:.4f} s, {ids.shape[0] * BEAM_NEW / wall:.1f} generated "
        f"tokens/s ({ids.shape[0] * BEAM_K * BEAM_NEW / wall:.1f} beam "
        f"rows/s), {wall / steps * 1e3:.3f} ms a step (wall / {steps} "
        f"steps, the prefill included); launches {json.dumps(launches)}")
    m_beam, m_wall, m_launches, m_steps = beam_run(
        "beam search left-padded", model, mids, 0, "tc",
        max_new_tokens=GEN_MASKED[2], num_beams=BEAM_K, length_penalty=0.6,
        eos_token_id=eos, attention_mask=mask)
    log(f"beam search left-padded: {mids.shape[0]} prompts in a "
        f"{mids.shape[1]}-wide batch, num_beams {BEAM_K}, length_penalty "
        f"0.6, eos {eos}, {GEN_MASKED[2]} new: {m_steps} steps in "
        f"{m_wall:.4f} s, {m_wall / m_steps * 1e3:.3f} ms a step; "
        f"launches {json.dumps(m_launches)}; rows ending in eos "
        f"{int((m_beam[:, mids.shape[1]:] == eos).any(dim=1).sum())}")
    if profile:
        profile_beam(model, ids)
    return {k: launches[k] + m_launches[k] for k in launches}


def phase_beam_f32(device):
    """Beam search in float32 at GPT-2 width cut to 2 layers, on the card
    (K2; K4 on the CUDA-core route) and on a CPU copy of the same weights
    (plain versions). A spy on ``_beam_topk`` records, each step, the
    smallest gap between neighbours among each row's K + 1 best
    candidates on the CPU: a row whose gaps all stay at or above
    ``GEN_TOL`` must give the same tokens on both (the final pick, with
    no length penalty and no eos, is the first of the last step's K).
    Returns the card run's launches."""
    import copy

    import paddle_tpu_torch as pt
    import paddle_tpu_torch.models.generation as gen_mod
    from paddle_tpu_torch.models import GPTConfig, GPTForPretraining
    pt.seed(SEED + 10)
    cfg = GPTConfig.gpt2_small()
    cfg.num_hidden_layers = 2
    cpu_net = GPTForPretraining(cfg).eval()
    card_net = copy.deepcopy(cpu_net).to(device)
    ids = torch.from_numpy(np.random.RandomState(SEED + 10).randint(
        0, cfg.vocab_size, (4, 128)))
    gaps = []
    topk = gen_mod._beam_topk

    def spy(cand, k):
        if not cand.is_cuda:
            best = cand.topk(k + 1, dim=-1).values
            gaps.append((best[:, :-1] - best[:, 1:]).min(dim=1).values)
        return topk(cand, k)

    gen_mod._beam_topk = spy
    try:
        card, _, launches, _ = beam_run(
            "beam search float32 on the card", card_net, ids.to(device), 2,
            "cuda_core", max_new_tokens=16, num_beams=BEAM_K)
        cpu = cpu_net.generate(ids, max_new_tokens=16, num_beams=BEAM_K)
    finally:
        gen_mod._beam_topk = topk
    near = (torch.stack(gaps) < GEN_TOL).any(dim=0)           # [B]
    same = (card.cpu() == cpu).all(dim=1)
    if bool((~near & ~same).any()):
        raise AssertionError(
            f"float32 beam search: rows {torch.nonzero(~near & ~same)} "
            f"differ between the card and the CPU with no near-tie")
    log(f"beam search float32 check (GPT-2 width, 2 layers, 4 x 128, "
        f"num_beams {BEAM_K}, 16 new, card vs CPU): rows with a gap below "
        f"{GEN_TOL} among the K + 1 best candidates: {int(near.sum())}; "
        f"tokens equal in {int(same.sum())} of 4 rows, every row without "
        f"a near-tie equal; launches {json.dumps(launches)}, flash on the "
        f"CUDA-core route")
    return launches


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
    96-256 real tokens in a 256-wide batch, 32 new tokens; beam search.
    Returns the K2 and K4 launches of the generate runs and of the beam
    searches."""
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
    b_launches = phase_beam(model, ids, mids * mask, mask,
                            int(masked[0, width]), profile)
    cost = call_op_cost(device)
    log("call_op host cost on the card, µs per call (call_op, direct, "
        "added): " + json.dumps(cost))
    if profile:
        profile_generate(model, ids, GEN_NEW)
    return ({name: pre_l[name] + launches[name] + s_launches[name]
             + m_launches[name] for name in launches}, b_launches)


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
    """The kernels line's rows of the generate path, each with its count
    in ``launches``: K2 for greedy and sampled generate (timed at a
    decode step's rows, bf16 [8, 768]), for beam search (at a beam decode
    step's [B*K, 768] rows, bf16 [32, 768]) and for the gather engines
    (at a decode step's slots, bf16 [8, 768]), each also held against
    its plain version at every other shape its launches ran at; and K4
    at the prefill's shape (bf16 [8, 512, 12, 64] causal, tensor-core
    route), which generate and beam search share."""
    bf16 = torch.bfloat16
    rows = [(name, LN_SRC, LN_TPU, ln_shape_row(
                timer, name, launches[name], (bf16, n, 768)),
             launches[name])
            for name, n in (("fused_layer_norm_generate", GEN_BATCH),
                            ("fused_layer_norm_beam", GEN_BATCH * BEAM_K),
                            ("fused_layer_norm_gather", 8))]
    gen = torch.Generator(device=device).manual_seed(SEED + 7)
    q, k, v, do = (
        torch.randn(GEN_BATCH, GEN_PROMPT, 12, 64, device=device,
                    generator=gen).to(bf16) for _ in range(4))
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


# ---------------------------------------------------------------- phase 3e
F16_KINDS = (("f16", dict(block_size=16)),
             ("int8_f16", dict(kv_dtype="int8", block_size=32)),
             ("fp8_f16", dict(kv_dtype="float8_e4m3fn", block_size=32)))
F16_LN_ROW = "fused_layer_norm_serve_f16"


def phase_serve_f16(device, prompts, profile=False):
    """Phase 3e: GPT-2 small in float16 (full width and depth, random
    weights from a seed) served through the fused engine over a float16
    pool (blocks of 16) and over int8 and fp8 pools (blocks of 32), phase
    3's 16 requests each, 64 new tokens: K1/K1q 12 launches a step, every
    one on the tensor-core route, K2 (2L + 1) a step. Then the card's
    oracle, the float16 dense gather engine (no K1) over the same
    requests: the fused float16 engine's tokens equal its tokens up to
    each request's first step whose top-2 logit margin (a float16 full
    forward over the fused tokens) falls below ``F16_GEN_TOL``; the int8
    pool's logit drift against a float16 pool on one step, within phase
    3b's bound; and ``generate`` (8 unmasked prompts of 512, 32 new,
    greedy: K4 float16 on the tensor-core route in the prefill). No plain
    version runs. Returns the launches and the captured attention
    operands."""
    from paddle_tpu_torch import seed
    from paddle_tpu_torch.models import GPTConfig, GPTForPretraining
    seed(SEED + 10)
    cfg = GPTConfig.gpt2_small()
    model = GPTForPretraining(cfg).to(device=device, dtype=torch.float16)
    model.eval()
    L, vocab = cfg.num_hidden_layers, cfg.vocab_size
    rng = np.random.RandomState(SEED + 10)
    out = {"captured": {}, "attn": {}, "combine": {}, "wide_rows": 0,
           "fused_layer_norm": 0}
    fused = {}
    with count_plain() as plain:
        for kind, kw in F16_KINDS:
            outs, stats, launches, steps, wall, cap = serve_mix(
                model, prompts, 64, profile and kind == "f16", rng,
                ln_row=F16_LN_ROW, **kw)
            quant = kind != "f16"
            check_serve_launches(f"float16 {kind} engine", launches, steps,
                                 L, quantized=quant)
            serve_line(f"engine: GPT-2 small float16, {kind} pool (block "
                       f"{kw['block_size']})", prompts, 64, stats, steps,
                       wall)
            log(f"float16 {kind} engine launches: {json.dumps(launches)} "
                f"over {steps} steps; kv_bytes "
                f"{json.dumps(stats['kv_bytes'])}")
            fused[kind] = outs
            out["captured"][kind] = cap
            out["attn"][kind] = launches["ragged_paged_attention_quant"
                                         if quant else
                                         "ragged_paged_attention"]
            out["combine"][kind] = launches["combine"]
            out["fused_layer_norm"] += launches["fused_layer_norm"]
        out["wide_rows"] = out["captured"]["f16"]["wide"]["qp"]

        # the card's oracle: the dense gather engine, plain attention
        g_outs, g_stats, g_launches, g_steps, g_prefills, g_wall = \
            serve_gather("float16 dense engine", model, prompts, 64,
                         ln_row=F16_LN_ROW, kv_layout="dense",
                         attention="gather", min_bucket=32)
        out["fused_layer_norm"] += g_launches["fused_layer_norm"]
        with torch.no_grad():
            margins = []
            for p, seq in zip(prompts, fused["f16"]):
                ids = torch.from_numpy(seq).long().to(device)[None]
                top2 = model(ids)[0, len(p) - 1:-1].float().topk(
                    2, dim=-1).values
                margins.append((top2[:, 0] - top2[:, 1]).cpu())
        ties = first_near_tie(torch.stack(margins), F16_GEN_TOL)
        full = hold_tokens("float16 dense gather engine", g_outs,
                           fused["f16"], prompts, ties)
        log(f"float16 dense engine (the oracle), {len(prompts)} requests x "
            f"64 tokens, {g_prefills} prefills and {g_steps} decode steps "
            f"in {g_wall:.3f} s: {64 * len(prompts) / g_wall:.1f} tokens/s, "
            f"mean step {g_wall / g_steps * 1e3:.3f} ms, TTFT p50 "
            f"{g_stats['ttft_ms']['p50']:.1f} ms p95 "
            f"{g_stats['ttft_ms']['p95']:.1f} ms; launches "
            f"{json.dumps(g_launches)} (K1/K1q held at 0); its tokens equal "
            f"the fused float16 engine's before each request's first top-2 "
            f"margin below {F16_GEN_TOL} (step {ties}, 64 = none), all 64 "
            f"in {full} of {len(prompts)} requests")
        drift, top = logit_drift(model, prompts[0])
        limit = 0.05 * max(top, 1.0)
        log(f"float16 logit drift, one step over a {len(prompts[0])}-token "
            f"prompt, int8 pool vs float16 pool: max |diff| {drift:.4f}, "
            f"max |logit| {top:.4f}, limit {limit:.4f}")
        if not drift < limit:
            raise AssertionError(f"float16 int8 logit drift {drift} over "
                                 f"{limit}")

        n, width, new = F16_GEN
        ids = torch.from_numpy(rng.randint(0, vocab, (n, width))).to(device)
        model.generate(ids[:, :32], max_new_tokens=2)            # warm-up
        toks, wall, launches, _ = gen_run(
            "generate float16", model, ids, gen_want(L, new, False), "tc",
            ln_row=F16_LN_ROW, max_new_tokens=new)
        out["fused_layer_norm"] += launches["fused_layer_norm"]
        out["generate_flash"] = launches["flash_attention_fwd"]
        log(f"generate float16: GPT-2 small, {n} prompts x {width} tokens, "
            f"{new} new, greedy: {wall:.4f} s, {n * new / wall:.1f} "
            f"generated tokens/s; launches {json.dumps(launches)} (K4 on "
            f"the tensor-core route)")
    if sum(plain.values()):
        raise AssertionError(f"float16 serving: plain versions ran on the "
                             f"card: {dict(plain)}")
    del model
    out["fused_layer_norm"] += phase_serve_f16_check(device)
    return out


def phase_serve_f16_check(device):
    """Phase 3e, then: the fused engine over a float16 pool at GPT-2 width
    cut to 2 layers, float16 weights, on the card and on a CPU copy
    (plain versions), 4 requests of 16 new tokens: the first step's
    logits within ``F16_GEN_TOL``. Returns the card run's K2 launches."""
    import copy

    import paddle_tpu_torch as pt
    from paddle_tpu_torch.models import GPTConfig, GPTForPretraining
    pt.seed(SEED + 11)
    cfg = GPTConfig.gpt2_small()
    cfg.num_hidden_layers = 2
    cpu_net = GPTForPretraining(cfg).to(torch.float16).eval()
    card_net = copy.deepcopy(cpu_net).to(device)
    rng = np.random.RandomState(SEED + 11)
    prompts = [rng.randint(0, cfg.vocab_size, n) for n in (40, 7, 100, 300)]
    first, outs, launches = {}, {}, 0
    for where, net in (("cpu", cpu_net), ("card", card_net)):
        def spy(h, _gpt=net.gpt, _where=where):
            logits = type(_gpt).logits(_gpt, h)
            first.setdefault(_where, logits[:, -1].float().cpu())
            return logits

        outs[where], n = engine_run(
            net, prompts, 16, spy, F16_LN_ROW if where == "card" else None,
            kv_layout="paged", attention="fused", block_size=16,
            prefill_budget=128)
        if where == "card":
            launches = n
    err = (first["card"] - first["cpu"]).abs().max().item()
    if not err <= F16_GEN_TOL:
        raise AssertionError(f"float16 fused engine: first-step logits card "
                             f"vs CPU off by {err}, over {F16_GEN_TOL}")
    same = sum(np.array_equal(a, b) for a, b in zip(outs["card"],
                                                     outs["cpu"]))
    log(f"float16 fused engine check (GPT-2 width, 2 layers, "
        f"{len(prompts)} requests of {[len(p) for p in prompts]} tokens, 16 "
        f"new, card vs CPU): first-step logits max |diff| {err:.3e} (limit "
        f"{F16_GEN_TOL}); all 16 tokens equal in {same} of {len(prompts)} "
        f"requests (reported)")
    return launches


def serve_f16_rows(device, timer, f16):
    """The kernels line's rows of phase 3e: K1 float16 and K1q int8/fp8
    with float16 q on the layer-0 operands of each engine's widest and
    decode-only steps (tensor-core route, the CUDA-core kernel beside it);
    K2 float16 at every shape its launches ran at, timed at the widest
    fused step's rows; K4 float16 at the generate prefill's shape."""
    rows = [rpa_row(f"ragged_paged_attention_{kind}", timer,
                    f16["captured"][kind],
                    {"attn": f16["attn"][kind],
                     "combine": f16["combine"][kind]})
            for kind, _ in F16_KINDS]
    ln = ln_shape_row(timer, F16_LN_ROW, f16["fused_layer_norm"],
                      (torch.float16, f16["wide_rows"], 768))
    rows.append({"name": F16_LN_ROW, "route": "cuda", "source": LN_SRC,
                 "replaces": LN_TPU, "launches": f16["fused_layer_norm"],
                 **{k: ln[k] for k in ("max_abs_err", "ms", "plain_ms",
                                       "bound_ms", "bound_by",
                                       "library_ms")},
                 "core_route": "row", "core_ms": ln["row_ms"],
                 "core_err": ln["row_err"]})
    n, width, _ = F16_GEN
    gen = torch.Generator(device=device).manual_seed(SEED + 12)
    q, k, v, do = (torch.randn(n, width, 12, 64, device=device,
                               generator=gen).half() for _ in range(4))
    fwd, _ = flash_case(timer, q, k, v, do, route="tc", core=True)
    log(f"K4/K5 flash_attention_fwd at the float16 generate prefill's "
        f"shape, float16 [{n}, {width}, 12, 64] causal, tc route {fmt(fwd)}")
    rows.append({"name": "flash_attention_fwd_generate_f16", "route": "cuda",
                 "source": FA_TC_SRC, "replaces": FA_FWD_TPU,
                 "launches": f16["generate_flash"],
                 **{k: fwd[k] for k in ("max_abs_err", "ms", "plain_ms",
                                        "bound_ms", "bound_by",
                                        "library_ms")},
                 "core_source": FA_SRC, "core_ms": fwd["core_ms"],
                 "core_err": fwd["core_err"]})
    return rows


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


# ------------------------------------------------------- phases 4b to 4d
# the recipe: 8 batches of BATCH x SEQ tokens for 2 epochs, 2 held-out
# batches evaluated after each epoch
RECIPE_BATCHES, RECIPE_EVAL, RECIPE_EPOCHS = 8, 2, 2
RECIPE_LR, RECIPE_WARMUP, RECIPE_WD = 6e-4, 4, 0.1
# a fresh Model loaded from the recipe's final checkpoint evaluates and
# trains as the live one: the same kernels on the same bits
RESUME_TOL = 1e-6
# the clipped gradients' global norm against the clip norm, relative
CLIP_TOL = 1e-4
FP16_STEPS = 8
# float16 O2 at GPT-2 width cut to 2 layers, card vs CPU: activations in
# float16 (11 bits) rounded at other places by cuBLAS and the CPU's
# products, a loss of ~10.9 whose f16-level noise is ~1e-3 of it
FP16_LOSS_TOL = 2e-2
O1_STEPS = 8
PLAIN = (("ops.ragged_paged_attention", "ragged_paged_attention_plain"),
         ("ops.fused_adamw", "adamw_plain_"),
         ("ops.layer_norm", "layer_norm_plain"),
         ("ops.layer_norm", "layer_norm_bwd_plain"),
         ("ops.flash_attention", "flash_attention_fwd_plain"),
         ("ops.flash_attention", "flash_attention_bwd_plain"))


@contextlib.contextmanager
def count_plain():
    """Count the calls of every kernel's plain version while the block
    runs (the wrappers call them by their module's name); yields the
    counts, which must stay 0 on the card."""
    import importlib
    counts = collections.Counter()
    saved = []
    for mod_name, fn_name in PLAIN:
        mod = importlib.import_module(f"paddle_tpu_torch.{mod_name}")
        orig = getattr(mod, fn_name)

        def spy(*a, _orig=orig, _name=fn_name, **kw):
            counts[_name] += 1
            return _orig(*a, **kw)

        saved.append((mod, fn_name, orig))
        setattr(mod, fn_name, spy)
    try:
        yield counts
    finally:
        for mod, fn_name, orig in saved:
            setattr(mod, fn_name, orig)


@contextlib.contextmanager
def adamw_dtypes(opt_module):
    """The (p, g, copy) dtypes of every AdamW launch the optimizers make
    while the block runs."""
    seen = collections.Counter()
    orig = opt_module.fused_adamw_

    def spy(p, g, m, v, *hyper, low=None):
        seen[(str(p.dtype)[6:], str(g.dtype)[6:],
              None if low is None else str(low.dtype)[6:])] += 1
        return orig(p, g, m, v, *hyper, low=low)

    opt_module.fused_adamw_ = spy
    try:
        yield seen
    finally:
        opt_module.fused_adamw_ = orig


def gpt2_small(seed, device, layers=None, dtype=None):
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.models import GPTConfig, GPTForPretraining
    pt.seed(seed)
    cfg = GPTConfig.gpt2_small()
    cfg.hidden_dropout_prob = cfg.attention_dropout_prob = 0.0
    if layers is not None:
        cfg.num_hidden_layers = layers
    return GPTForPretraining(cfg, lm_loss_chunks=LM_CHUNKS).to(device), cfg


def next_token_batches(seed, vocab, rows, seq=None):
    """``rows`` random sequences of ``seq`` (default SEQ) tokens and their
    next-token labels."""
    seq = seq or SEQ
    tokens = np.random.RandomState(seed).randint(0, vocab, (rows, seq + 1))
    return tokens[:, :-1], tokens[:, 1:]


def no_decay(name):
    """The recipe's decay filter: biases and LayerNorm take no decay."""
    return not (name.endswith(".bias") or ".ln_" in name
                or name.startswith("gpt.ln_f"))


def recipe_lr(t):
    """The lr of train step t (0-based) in closed form: linear warmup from
    0 over RECIPE_WARMUP steps, then cosine decay over T_max = all the
    steps, as LinearWarmup(CosineAnnealingDecay) computes it."""
    if t < RECIPE_WARMUP:
        return (RECIPE_LR - 0.0) * t / RECIPE_WARMUP + 0.0
    t_max = RECIPE_BATCHES * RECIPE_EPOCHS
    return 0 + (RECIPE_LR - 0) * (
        1 + math.cos(math.pi * (t - RECIPE_WARMUP) / t_max)) / 2


def predicted_loss(model, data):
    """The mean over ``data``'s batches of the network's own loss, the
    first of ``Model.predict``'s outputs (GPT fed ``(ids, labels)``)."""
    losses = model.predict(data, batch_size=BATCH)[0]
    return float(np.mean([float(x) for x in losses]))


def recipe_model(net, device):
    """``Model`` over ``net`` with the recipe's optimizer, bf16 O2."""
    from paddle_tpu_torch.hapi import Model
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.optimizer.lr import (CosineAnnealingDecay,
                                               LinearWarmup)
    sched = LinearWarmup(
        CosineAnnealingDecay(RECIPE_LR,
                             T_max=RECIPE_BATCHES * RECIPE_EPOCHS),
        warmup_steps=RECIPE_WARMUP, start_lr=0.0, end_lr=RECIPE_LR)
    model = Model(net, inputs=["ids", "labels"], device=device)
    model.prepare(AdamW(sched, parameters=net.named_parameters(),
                        weight_decay=RECIPE_WD,
                        apply_decay_param_fun=no_decay,
                        grad_clip=ClipGradByGlobalNorm(1.0),
                        multi_precision=True),
                  loss=lambda loss, logits: loss,
                  amp_configs={"level": "O2", "dtype": "bfloat16"})
    return model


def step_times(what, card, steps, wall, durations, peak):
    """The phase's line: tokens/s and ms a step over the train steps
    (wall / steps, and the median step), peak memory, the card."""
    log(f"{what}: {steps} steps in {wall:.3f} s: "
        f"{BATCH * SEQ * steps / wall:.1f} tokens/s, "
        f"{wall / steps * 1e3:.3f} ms per step (wall / steps), median step "
        f"{float(np.median(durations)) * 1e3:.3f} ms, max memory allocated "
        f"{peak} bytes ({peak / 2 ** 30:.3f} GiB) on {card}")


def phase_recipe(device, card):
    """4b: GPT-2 small trained through Model.fit the way it is trained:
    warmup then cosine decay, a global-norm clip at 1.0, no decay on
    biases and LayerNorm, AdamW with f32 masters, bf16 O2, a held-out
    evaluation after each epoch, checkpoints, then a resume from the
    final one. Returns the fit's launches."""
    import tempfile

    import paddle_tpu_torch as pt
    import paddle_tpu_torch.optimizer.optimizer as opt_module
    from paddle_tpu_torch.callbacks import Callback, History

    class Steps(Callback):
        """Each step's lr (before the scheduler steps), loss and time, and
        each evaluation's loss."""

        def __init__(self):
            super().__init__()
            self.lr, self.loss, self.spans, self.evals = [], [], [], []

        def on_eval_end(self, logs=None):
            self.evals.append(logs["loss"])

        def on_train_batch_begin(self, step, logs=None):
            self._t0 = time.perf_counter()

        def on_train_batch_end(self, step, logs=None):
            self.spans.append(time.perf_counter() - self._t0)
            self.lr.append(self.model._optimizer.get_lr())
            self.loss.append(logs["loss"])

    gc.collect()
    net, cfg = gpt2_small(SEED + 4, device)
    n_tensors = len(list(net.parameters()))
    model = recipe_model(net, device)
    norms = []
    clip = model._optimizer._grad_clip
    clip_with_norm = clip.clip_with_norm

    def watched(pairs):
        out, norm = clip_with_norm(pairs)
        norms.append(norm.detach())
        return out, norm

    clip.clip_with_norm = watched
    rows = BATCH * (RECIPE_BATCHES + RECIPE_EVAL)
    ids, labels = next_token_batches(SEED + 4, cfg.vocab_size, rows)
    split = BATCH * RECIPE_BATCHES
    train = pt.io.TensorDataset([ids[:split], labels[:split]])
    held = pt.io.TensorDataset([ids[split:], labels[split:]])
    steps = RECIPE_BATCHES * RECIPE_EPOCHS
    evals = RECIPE_EPOCHS * RECIPE_EVAL
    rec, hist = Steps(), History()
    counters = train_counters()
    with tempfile.TemporaryDirectory() as save_dir:
        torch.cuda.synchronize()
        gc.collect()
        torch.cuda.reset_peak_memory_stats()
        reset_counts(counters)
        with count_plain() as plain, adamw_dtypes(opt_module) as kinds:
            t0 = time.perf_counter()
            model.fit(train, eval_data=held, batch_size=BATCH,
                      epochs=RECIPE_EPOCHS, eval_freq=1, log_freq=1,
                      save_dir=save_dir, save_freq=2, shuffle=False,
                      verbose=0, callbacks=[rec, hist])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        launches = {name: fn.launches for name, fn in counters.items()}
        peak = torch.cuda.max_memory_allocated()
        per_step = expected_launches(cfg.num_hidden_layers, n_tensors)
        want = {k: v * steps for k, v in per_step.items()}
        # each evaluated batch runs the forward kernels once more
        want["flash_attention_fwd"] += cfg.num_hidden_layers * evals
        want["fused_layer_norm"] += (2 * cfg.num_hidden_layers + 1) * evals
        if launches != want or sum(plain.values()):
            raise AssertionError(f"recipe: launches {launches}, plain "
                                 f"versions {dict(plain)}; expected {want} "
                                 f"and no plain call")
        if set(kinds) != {("float32", "bfloat16", "bfloat16")}:
            raise AssertionError(f"recipe: AdamW launches {dict(kinds)}")
        check_flash_route("recipe", counters, "tc")
        check_ln_route("recipe", (counters["fused_layer_norm"],
                                  counters["fused_layer_norm_bwd"]))
        files = sorted(os.listdir(save_dir))
        if files != ["0.pdopt", "0.pdparams", "final.pdopt",
                     "final.pdparams"]:
            raise AssertionError(f"recipe checkpoints: {files}")
        want_lr = [recipe_lr(t) for t in range(steps)]
        if len(rec.lr) != steps or not all(
                math.isclose(a, b, rel_tol=1e-12, abs_tol=0.0)
                for a, b in zip(rec.lr, want_lr)):
            raise AssertionError(f"recipe lr {rec.lr}, closed form "
                                 f"{want_lr}")
        pre_clip = [float(n) for n in norms]
        if len(pre_clip) != steps or not all(
                math.isfinite(x) for x in rec.loss + pre_clip):
            raise AssertionError(f"recipe: pre-clip norms {pre_clip}, "
                                 f"losses {rec.loss}")
        # GPT takes its labels among its inputs (an inputs-only spec):
        # fit's evaluations, evaluate and eval_batch give 0.0, as in the
        # JAX package; the held-out loss is predict's first output, the
        # network's own loss
        per = [model.eval_batch([ids[i:i + BATCH], labels[i:i + BATCH]])
               for i in range(split, rows, BATCH)]
        if len(hist.history.get("loss", ())) != RECIPE_EPOCHS \
                or rec.evals != [0.0] * RECIPE_EPOCHS \
                or model.evaluate(held, batch_size=BATCH,
                                  verbose=0) != {"loss": 0.0} \
                or per != [0.0] * RECIPE_EVAL or model.stop_training:
            raise AssertionError(f"recipe: history {hist.history}, "
                                 f"evaluations {rec.evals}, eval_batch "
                                 f"{per}")
        held_loss = predicted_loss(model, held)
        if not math.isfinite(held_loss):
            raise AssertionError(f"recipe: held-out loss {held_loss}")
        # a fresh Model from the final checkpoint
        fresh_net, _ = gpt2_small(SEED + 5, device)
        fresh = recipe_model(fresh_net, device)
        fresh.load(os.path.join(save_dir, "final"))
    diffs = {}
    got = predicted_loss(fresh, held)
    diffs["held-out loss"] = abs(got - held_loss) / abs(held_loss)
    for i in range(2):
        b = [ids[i * BATCH:(i + 1) * BATCH], labels[i * BATCH:(i + 1) * BATCH]]
        live_loss, fresh_loss = model.train_batch(b), fresh.train_batch(b)
        diffs[f"train step {i + 1}"] = abs(fresh_loss - live_loss) / abs(
            live_loss)
    if fresh._optimizer._step_count != model._optimizer._step_count or \
            max(diffs.values()) > RESUME_TOL:
        raise AssertionError(f"resume from the final checkpoint: relative "
                             f"differences {diffs}, limit {RESUME_TOL}")
    del fresh, fresh_net
    bite = clip_bites(model, clip, clip_with_norm, pre_clip,
                      [ids[:BATCH], labels[:BATCH]])
    step_times(f"recipe: GPT-2 small, bf16 O2, Model.fit with warmup + "
               f"cosine lr, clip 1.0, batch {BATCH} x {SEQ}, "
               f"{RECIPE_EPOCHS} epochs x {RECIPE_BATCHES} batches",
               card, steps, sum(rec.spans), rec.spans, peak)
    log(f"recipe: fit {wall:.3f} s in all (with {evals} evaluated batches "
        f"and 2 checkpoints); losses {json.dumps(rec.loss)}; evaluate's "
        f"loss after each epoch {json.dumps(rec.evals)} (no label batch: "
        f"0.0, as in the JAX package); held-out loss from predict "
        f"{held_loss:.6f}; lr "
        f"{json.dumps(rec.lr)}; pre-clip "
        f"global norms {json.dumps(pre_clip)} (clipped at 1.0 in "
        f"{sum(x > 1.0 for x in pre_clip)} of {steps} steps)")
    log(f"recipe launches: {json.dumps(launches)} over {steps} steps and "
        f"{evals} evaluated batches, plain versions {dict(plain)}; resume "
        f"from the final checkpoint, relative differences "
        f"{json.dumps(diffs)} (limit {RESUME_TOL}); {bite}")
    del model, net
    return launches


def clip_bites(model, clip, clip_with_norm, pre_clip, batch):
    """One more step of the recipe's model with the clip norm set to half
    the smallest pre-clip norm the fit saw: the gradients the optimizer
    receives have that global norm within CLIP_TOL. The scale multiplies
    in float32 and each bf16 element rounds once, independently, so the
    norm moves by far less than a bf16 ulp (2**-8); a scale rounded to
    bf16 first would move it by up to 2**-9. Returns the line's text."""
    target = 0.5 * min(pre_clip)
    seen = []

    def watched(pairs):
        out, norm = clip_with_norm(pairs)
        post = torch._foreach_norm([g for _, g in out], 2,
                                   dtype=torch.float32)
        seen.append((float(norm), float(torch.linalg.vector_norm(
            torch.stack(post)))))
        return out, norm

    clip.clip_with_norm, clip.clip_norm = watched, target
    try:
        model.train_batch(batch)
    finally:
        clip.clip_with_norm, clip.clip_norm = clip_with_norm, 1.0
    (pre, post), = seen
    if not (pre > target and abs(post - target) <= CLIP_TOL * target):
        raise AssertionError(f"clip at {target}: norm {pre} before, {post} "
                             f"after")
    return (f"a step clipped at {target:.6f}: global norm {pre:.6f} before, "
            f"{post:.6f} after")


def fp16_step(net, opt, scaler, ids, labels, device):
    """One step of the float16 eager loop; returns the loss (a device
    scalar) and whether the scaler found a non-finite gradient."""
    from paddle_tpu_torch import amp
    ids, labels = (torch.from_numpy(a).to(device) for a in (ids, labels))
    with amp.auto_cast(level="O2", dtype="float16"):
        loss, _ = net(ids, labels)
    scaler.scale(loss).backward()
    scaler.step(opt)
    found = scaler.state()["found_inf"]
    scaler.update()
    opt.clear_grad()
    return loss.detach(), found


def fp16_loop(net, device, rows_ids, rows_labels, batch):
    """The eager float16 O2 loop of phase 4c over ``batch``-row batches;
    returns the optimizer, the scaler, and per step the loss, the scale
    after it and whether it was skipped."""
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.optimizer import AdamW
    amp.decorate(net, level="O2", dtype="float16")
    opt = AdamW(LR, parameters=net.named_parameters(), weight_decay=WD,
                multi_precision=True)
    scaler = amp.GradScaler(init_loss_scaling=2. ** 15,
                            decr_every_n_nan_or_inf=1)
    trace, stamps = [], [time.perf_counter()]
    for i in range(0, len(rows_ids), batch):
        loss, found = fp16_step(net, opt, scaler, rows_ids[i:i + batch],
                                rows_labels[i:i + batch], device)
        trace.append((loss, scaler.get_loss_scaling(), found))
        stamps.append(time.perf_counter())   # the scaler read its flag
    return opt, scaler, [(float(l), s, f) for l, s, f in trace], \
        np.diff(stamps)


def phase_fp16(device, card):
    """4c: GPT-2 small in float16 O2 through the eager loop with dynamic
    loss scaling, then one step whose gradient is made non-finite (a hook
    on one parameter's gradient), then the loop goes on. Returns the
    loop's launches."""
    import paddle_tpu_torch.optimizer.optimizer as opt_module
    gc.collect()
    net, cfg = gpt2_small(SEED + 6, device)
    n_tensors = len(list(net.parameters()))
    ids, labels = next_token_batches(SEED + 6, cfg.vocab_size,
                                     BATCH * (FP16_STEPS + 2))
    loop = BATCH * FP16_STEPS
    counters = train_counters()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(counters)
    with count_plain() as plain, adamw_dtypes(opt_module) as kinds:
        t0 = time.perf_counter()
        opt, scaler, trace, spans = fp16_loop(net, device, ids[:loop],
                                              labels[:loop], BATCH)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in counters.items()}
    peak = torch.cuda.max_memory_allocated()
    applied = sum(not found for _, _, found in trace)
    per_step = expected_launches(cfg.num_hidden_layers, n_tensors)
    want = {k: v * (applied if k == "fused_adamw" else FP16_STEPS)
            for k, v in per_step.items()}
    if launches != want or sum(plain.values()) or not applied:
        raise AssertionError(f"float16 loop: launches {launches}, plain "
                             f"versions {dict(plain)}, {applied} steps "
                             f"applied; expected {want}")
    if set(kinds) != {("float32", "float16", "float16")}:
        raise AssertionError(f"float16 loop: AdamW launches {dict(kinds)}")
    check_flash_route("float16 loop", counters, "tc")
    check_ln_route("float16 loop", (counters["fused_layer_norm"],
                                    counters["fused_layer_norm_bwd"]))
    if not all(math.isfinite(l) for l, _, _ in trace):
        raise AssertionError(f"float16 loop losses {trace}")

    # one step with a non-finite gradient: nothing moves, the scale halves
    state = [t.clone() for t in net.parameters()] + [
        t.clone() for slots in opt._slots.values() for t in slots.values()]
    steps_before, scale_before = opt._step_count, scaler.get_loss_scaling()
    victim = net.gpt.blocks[0].attn.q_proj.weight
    hook = victim.register_hook(lambda g: g * float("inf"))
    reset_counts(counters)
    _, found = fp16_step(net, opt, scaler, ids[loop:loop + BATCH],
                         labels[loop:loop + BATCH], device)
    hook.remove()
    after = [t for t in net.parameters()] + [
        t for slots in opt._slots.values() for t in slots.values()]
    same = all(torch.equal(a, b) for a, b in zip(state, after))
    if not (found and same and len(after) == len(state)
            and counters["fused_adamw"].launches == 0
            and opt._step_count == steps_before
            and scaler.get_loss_scaling() == max(scale_before * 0.5, 1.0)):
        raise AssertionError(
            f"non-finite step: found {found}, state unchanged {same}, "
            f"AdamW launches {counters['fused_adamw'].launches}, step "
            f"{opt._step_count} (was {steps_before}), scale "
            f"{scaler.get_loss_scaling()} (was {scale_before})")
    del state, after
    held = victim.detach().clone()
    reset_counts(counters)
    loss, found = fp16_step(net, opt, scaler, ids[loop + BATCH:],
                            labels[loop + BATCH:], device)
    moved = opt._step_count == steps_before + 1 and \
        not torch.equal(victim, held)
    if found or not moved or counters["fused_adamw"].launches != n_tensors \
            or not math.isfinite(float(loss)):
        raise AssertionError(f"after the non-finite step: found {found}, "
                             f"step {opt._step_count}, AdamW launches "
                             f"{counters['fused_adamw'].launches}")
    step_times(f"float16 O2 eager loop: GPT-2 small, AdamW multi_precision,"
               f" GradScaler(2**15), batch {BATCH} x {SEQ}", card,
               FP16_STEPS, wall, spans, peak)
    log(f"float16 loop: (loss, scale after, skipped) per step "
        f"{json.dumps(trace)}; launches {json.dumps(launches)}, plain "
        f"versions {dict(plain)}, AdamW (p, g, copy) dtypes {dict(kinds)}; "
        f"the injected non-finite step: nothing moved, no AdamW launch, "
        f"scale {scale_before} -> {scale_before * 0.5}; the next step "
        f"applied (loss {float(loss):.6f})")
    del net, opt
    return launches


def phase_fp16_check(device):
    """4c, then: the float16 loop at GPT-2 width cut to 2 layers, batch 2
    x 128, on the card and on a CPU copy of the same weights (plain
    versions): the losses within FP16_LOSS_TOL and the same loss-scale
    trajectory."""
    import copy
    cpu_net, cfg = gpt2_small(SEED + 7, torch.device("cpu"), layers=2)
    ids, labels = next_token_batches(SEED + 7, cfg.vocab_size,
                                     2 * FP16_STEPS, seq=128)
    out = {}
    for where, net, dev in (("card", copy.deepcopy(cpu_net).to(device),
                             device),
                            ("cpu", cpu_net, torch.device("cpu"))):
        out[where] = fp16_loop(net, dev, ids, labels, 2)[2]
    diff = max(abs(a[0] - b[0]) for a, b in zip(out["card"], out["cpu"]))
    scales = [[s for _, s, _ in out[w]] for w in ("card", "cpu")]
    if diff > FP16_LOSS_TOL or scales[0] != scales[1]:
        raise AssertionError(f"float16 2-layer loop, card vs CPU: "
                             f"{out}; largest loss difference {diff}")
    log(f"float16 check (GPT-2 width, 2 layers, batch 2 x 128, "
        f"{FP16_STEPS} steps of the loop, card vs CPU): largest loss "
        f"difference {diff:.3e} (limit {FP16_LOSS_TOL}), loss scales "
        f"{scales[0]} on both; card {json.dumps(out['card'])}")


def phase_o1(device, card):
    """4d: GPT-2 small at bf16 O1 through Model.fit: float32 parameters
    and no master (K8 on f32 p and f32 g), attention in bf16 on the
    tensor-core route, 8 steps over one repeated batch."""
    import paddle_tpu_torch as pt
    import paddle_tpu_torch.optimizer.optimizer as opt_module
    from paddle_tpu_torch.callbacks import Callback
    from paddle_tpu_torch.hapi import Model
    from paddle_tpu_torch.optimizer import AdamW

    class Steps(Callback):
        def __init__(self):
            super().__init__()
            self.loss, self.spans = [], []

        def on_train_batch_begin(self, step, logs=None):
            self._t0 = time.perf_counter()

        def on_train_batch_end(self, step, logs=None):
            self.spans.append(time.perf_counter() - self._t0)
            self.loss.append(logs["loss"])

    gc.collect()
    net, cfg = gpt2_small(SEED + 8, device)
    n_tensors = len(list(net.parameters()))
    model = Model(net, inputs=["ids", "labels"], device=device)
    model.prepare(AdamW(LR, parameters=net.named_parameters(),
                        weight_decay=WD, multi_precision=True),
                  loss=lambda loss, logits: loss,
                  amp_configs={"level": "O1", "dtype": "bfloat16"})
    ids, labels = next_token_batches(SEED + 8, cfg.vocab_size, BATCH)
    data = pt.io.TensorDataset([np.tile(ids, (O1_STEPS, 1)),
                                np.tile(labels, (O1_STEPS, 1))])
    counters = train_counters()
    rec = Steps()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(counters)
    with count_plain() as plain, adamw_dtypes(opt_module) as kinds:
        t0 = time.perf_counter()
        model.fit(data, batch_size=BATCH, shuffle=False, log_freq=1,
                  verbose=0, callbacks=[rec])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in counters.items()}
    peak = torch.cuda.max_memory_allocated()
    if any(p.dtype != torch.float32 for p in net.parameters()) or any(
            "master_weight" in s for s in model._optimizer._slots.values()):
        raise AssertionError("O1: parameters must stay float32 without "
                             "masters")
    check_launches("O1", launches,
                   expected_launches(cfg.num_hidden_layers, n_tensors),
                   O1_STEPS)
    if sum(plain.values()) or set(kinds) != {("float32", "float32", None)}:
        raise AssertionError(f"O1: plain versions {dict(plain)}, AdamW "
                             f"launches {dict(kinds)}")
    check_flash_route("O1", counters, "tc")
    check_ln_route("O1", (counters["fused_layer_norm"],
                          counters["fused_layer_norm_bwd"]))
    if len(rec.loss) != O1_STEPS or not all(
            math.isfinite(x) for x in rec.loss) \
            or not rec.loss[-1] < rec.loss[0]:
        raise AssertionError(f"O1 losses on a repeated batch: {rec.loss}")
    step_times(f"bf16 O1: GPT-2 small, float32 parameters, Model.fit, batch "
               f"{BATCH} x {SEQ}, one batch repeated", card, O1_STEPS,
               wall, rec.spans, peak)
    log(f"O1 losses {json.dumps(rec.loss)}; launches {json.dumps(launches)}"
        f", plain versions {dict(plain)}, AdamW (p, g, copy) dtypes "
        f"{dict(kinds)}")
    del model, net
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


TRAIN_ROWS = (
    ("flash_attention_fwd", FA_TC_SRC, FA_FWD_TPU),
    ("flash_attention_bwd", FA_TC_SRC, FA_BWD_TPU),
    ("flash_attention_fwd_f32", FA_SRC, FA_FWD_TPU),
    ("flash_attention_bwd_f32", FA_SRC, FA_BWD_TPU),
    ("fused_layer_norm_train", LN_SRC, LN_TPU),
    ("fused_layer_norm_bwd", LN_SRC, LN_BWD_TPU),
    ("fused_adamw", ADAMW_SRC, ADAMW_TPU),
    ("flash_attention_fwd_f16", FA_TC_SRC, FA_FWD_TPU),
    ("flash_attention_bwd_f16", FA_TC_SRC, FA_BWD_TPU),
    ("fused_layer_norm_f16", LN_SRC, LN_TPU),
    ("fused_layer_norm_bwd_f16", LN_SRC, LN_BWD_TPU),
    ("fused_adamw_f16", ADAMW_SRC, ADAMW_TPU),
    ("fused_adamw_f32", ADAMW_SRC, ADAMW_TPU))

# why a float16 row counts no launch on the main path
F16_LN_NOTE = ("LayerNorm is on the AMP black list: the float16 paths run "
               "it in float32 (fused_layer_norm_train, fused_layer_norm_bwd)")


def train_rows(counts, main):
    """The kernels line's rows of the training kernels: phase 2's
    measurements at the train path's shapes, one row per dtype (the
    LayerNorm forward's f32 one as ``fused_layer_norm_train``), each with
    the launches ``counts`` gives it from the paths that ran it."""
    rows = []
    for name, src, tpu in TRAIN_ROWS:
        row = main[name]
        rows.append({"name": name, "route": "cuda", "source": src,
                     "replaces": tpu, "launches": counts[name],
                     "max_abs_err": row["max_abs_err"], "ms": row["ms"],
                     "plain_ms": row["plain_ms"],
                     "bound_ms": row["bound_ms"],
                     "bound_by": row["bound_by"],
                     "library_ms": row["library_ms"]})
        if "core_ms" in row:   # the CUDA-core kernels on the same operands
            rows[-1].update(core_source=FA_SRC, core_ms=row["core_ms"],
                            core_err=row["core_err"])
        if name in ("fused_layer_norm_f16", "fused_layer_norm_bwd_f16"):
            rows[-1]["launches_note"] = F16_LN_NOTE
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
    gen_launches, beam_launches = phase_generate(model, device, profile)
    gather_ln = phase_gather(model, prompts, outs, profile)
    del model
    f16 = phase_serve_f16(device, prompts, profile)
    gen_f32_launches = phase_generate_f32(device)
    beam_f32_launches = phase_beam_f32(device)
    train_launches, train_cap = phase_train(device, profile)
    f32_launches = phase_f32_check(device)
    recipe = phase_recipe(device, card)
    fp16 = phase_fp16(device, card)
    phase_fp16_check(device)
    o1 = phase_o1(device, card)
    kernels = report_engine(device, timer, launches, captured,
                            quant_launches, quant_captured)
    # the engine row of the LayerNorm forward counts the fused engines'
    # runs (phase 3d's float32 ones too); its fused_layer_norm_train row,
    # the train path's
    kernels += serve_f16_rows(device, timer, f16)
    ln_row = next(k for k in kernels if k["name"] == "fused_layer_norm")
    ln_row["launches"] += quant_launches["fused_layer_norm"] \
        + gather_ln["fused"]
    check_train_operands(train_cap)
    # each row counts the paths that ran its kernel at its dtype: the bf16
    # tensor-core flash rows phase 4, the recipe and O1; the f32 LayerNorm
    # rows every AMP path (LayerNorm is on the black list); AdamW's rows
    # by (grad, copy) dtype
    counts = {
        "flash_attention_fwd": train_launches["flash_attention_fwd"]
        + recipe["flash_attention_fwd"] + o1["flash_attention_fwd"],
        "flash_attention_bwd": train_launches["flash_attention_bwd"]
        + recipe["flash_attention_bwd"] + o1["flash_attention_bwd"],
        "flash_attention_fwd_f32": f32_launches["flash_attention_fwd"],
        "flash_attention_bwd_f32": f32_launches["flash_attention_bwd"],
        "fused_layer_norm_train": sum(
            r["fused_layer_norm"] for r in (train_launches, recipe, fp16,
                                            o1)),
        "fused_layer_norm_bwd": sum(
            r["fused_layer_norm_bwd"] for r in (train_launches, recipe,
                                                fp16, o1)),
        "fused_adamw": train_launches["fused_adamw"]
        + recipe["fused_adamw"],
        "flash_attention_fwd_f16": fp16["flash_attention_fwd"],
        "flash_attention_bwd_f16": fp16["flash_attention_bwd"],
        "fused_layer_norm_f16": 0,
        "fused_layer_norm_bwd_f16": 0,
        "fused_adamw_f16": fp16["fused_adamw"],
        "fused_adamw_f32": o1["fused_adamw"] + f32_launches["fused_adamw"]}
    kernels += train_rows(counts, train_main)
    # the float32 runs' K2 launches join their path's row, their K4
    # launches (the CUDA-core route) the _f32 flash row
    kernels += generate_rows(device, timer, {
        "fused_layer_norm_generate": gen_launches["fused_layer_norm"]
        + gen_f32_launches["fused_layer_norm"],
        "fused_layer_norm_beam": beam_launches["fused_layer_norm"]
        + beam_f32_launches["fused_layer_norm"],
        "fused_layer_norm_gather": gather_ln["gather"],
        "flash_attention_fwd": gen_launches["flash_attention_fwd"]
        + beam_launches["flash_attention_fwd"]})
    f32_fwd = next(k for k in kernels
                   if k["name"] == "flash_attention_fwd_f32")
    f32_fwd["launches"] += gen_f32_launches["flash_attention_fwd"] \
        + beam_f32_launches["flash_attention_fwd"]
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
