"""Drive the PyTorch/CUDA port on one NVIDIA card and check it.

    python3 chip_smoke.py [--profile]

Phases, each fatal on failure (the script then exits non-zero and
prints no result line):

1. environment: the card's name and power limit, torch/CUDA/nvcc
   versions, and the build of every kernel from ``paddle_tpu_torch/csrc``
   (one ``nvcc`` per source, all at once);
2. kernel vs plain: each kernel against its plain PyTorch version on the
   card at the serving path's widths (GPT-2: 12 heads, head_dim 64,
   hidden 768, KV blocks of 16), in float32 and bfloat16, with the
   errors, the median times and the bytes-over-bandwidth bounds;
3. engine: GPT-2 small (124M width, random weights from a seed, bf16)
   served through ``GenerationEngine(kv_layout="paged",
   attention="fused")`` — 16 concurrent requests with a chunked long
   prompt and a shared preamble — with every kernel's launch count read
   around that run, one real step's layer-0 attention operands checked
   kernel against plain, and a float32 reference check of the engine's
   greedy tokens against the model's full forward;
4. a ``{"kernels": [...]}`` line, the card's name and power limit, and
   last the ``{"ok": true, "device": ...}`` line.

``--profile`` adds one more engine batch under torch.profiler after
phase 3 and prints device time by kernel and the device's idle share.

Times come from CUDA events around single launches, median of 20,
with the 50 MB L2 cache flushed and the device kept busy until the
launch is queued, so neither a warm cache nor the host's launch
overhead enters them. Float32 products run without TF32.
"""
from __future__ import annotations

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
RPA_SRC = "paddle_tpu_torch/csrc/ragged_paged_attention.cu"
LN_SRC = "paddle_tpu_torch/csrc/layer_norm.cu"
RPA_TPU = "paddle_tpu/ops/ragged_paged_attention.py:198"
LN_TPU = "paddle_tpu/ops/pallas_kernels.py:868"


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


def check_close(name, got, want, dtype):
    atol, rtol = TOL[dtype]
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


# ---------------------------------------------------------------- bounds
def rpa_work(q, pool, meta):
    """Bytes the attention call must move and operations it must do,
    counted from this call's data: every KV block each real sequence
    owns, read once per head; q read and o written once."""
    blk_seq, _, _, tables, _, kv_len = (m.cpu().numpy() for m in meta)
    h, qp, dh = q.shape
    bs = pool.shape[4]
    e = q.element_size()
    seqs = sorted({int(s) for s in blk_seq if s >= 0})
    kv_bytes = sum(-(-int(kv_len[s]) // bs) * bs for s in seqs) \
        * h * dh * 2 * e
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


def phase_kernels(device, timer):
    from paddle_tpu_torch.ops.layer_norm import (fused_layer_norm,
                                                 layer_norm_plain)
    from paddle_tpu_torch.ops.ragged_paged_attention import (
        ragged_paged_attention, ragged_paged_attention_plain)
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
            f"max_abs_err {err:.3e} kernel_ms {ms:.4f} plain_ms "
            f"{plain:.4f} bound_ms {bound(nbytes, ops, dtype)[0]:.4f}")
        del pool
        for rows in (8, 256, 4096):
            x = torch.randn(rows, 768, device=device).to(dtype)
            w = (1 + 0.1 * torch.randn(768, device=device)).to(dtype)
            b = (0.1 * torch.randn(768, device=device)).to(dtype)
            got = fused_layer_norm(x, w, b)
            torch.cuda.synchronize()
            err = check_close(f"fused_layer_norm {dtype} rows={rows}", got,
                              layer_norm_plain(x, w, b), dtype)
            ms = timer.ms(lambda: fused_layer_norm(x, w, b))
            plain = timer.ms(lambda: layer_norm_plain(x, w, b))
            lib = timer.ms(lambda: torch.nn.functional.layer_norm(
                x, (768,), w, b, 1e-5))
            e = x.element_size()
            bnd = bound(2 * rows * 768 * e + 2 * 768 * e, 7 * rows * 768,
                        dtype)[0]
            log(f"K2 fused_layer_norm {str(dtype)[6:]} [{rows}, 768] "
                f"max_abs_err {err:.3e} kernel_ms {ms:.4f} plain_ms "
                f"{plain:.4f} library_ms {lib:.4f} bound_ms {bnd:.4f}")


# ---------------------------------------------------------------- phase 3
def reference_check(device):
    """Float32 engine greedy tokens == greedy decoding through the
    model's full forward, at GPT-2 width with the depth cut to 2."""
    from paddle_tpu_torch.models import GPTConfig, GPTForPretraining
    from paddle_tpu_torch.serving import GenerationEngine
    torch.manual_seed(SEED + 1)
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
    from torch.autograd import DeviceType
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
    steps = eng.stats()["steps"] - steps0
    kernels = [(ev.self_device_time_total / 1e3, ev.count, ev.key)
               for ev in prof.key_averages()
               if ev.device_type == DeviceType.CUDA
               and ev.self_device_time_total > 0]
    busy = sum(k[0] for k in kernels)
    log(f"profile: {steps} steps in {wall_ms:.3f} ms wall, device busy "
        f"{busy:.3f} ms, idle share {1 - busy / wall_ms:.4f}, "
        f"{busy / steps:.4f} device ms per step")
    for ms, n, name in sorted(kernels, reverse=True)[:15]:
        log(f"  {ms:10.3f} ms {ms / busy:7.2%} {n:7d} calls "
            f"{ms / steps:8.4f} ms/step  {name[:90]}")


def phase_engine(device, profile=False):
    import paddle_tpu_torch.models.generation as gen_mod
    from paddle_tpu_torch.models import GPTConfig, GPTForPretraining
    from paddle_tpu_torch.ops.layer_norm import fused_layer_norm
    from paddle_tpu_torch.ops.ragged_paged_attention import (
        ragged_paged_attention)
    from paddle_tpu_torch.serving import GenerationEngine

    reference_check(device)
    torch.manual_seed(SEED)
    cfg = GPTConfig.gpt2_small()
    model = GPTForPretraining(cfg).to(device=device, dtype=torch.bfloat16)
    eng = GenerationEngine(model, kv_layout="paged", attention="fused",
                           num_slots=8, block_size=16, prefill_budget=256,
                           seed=SEED, device=device)
    rng = np.random.RandomState(SEED)
    # warm-up: one short request outside the measured window
    eng.submit(rng.randint(0, cfg.vocab_size, 24),
               max_new_tokens=4).result(timeout=300)

    # keep the layer-0 operands of the widest real step for phase 4
    captured = {}

    def capture(q, pool, layer, *meta, **kw):
        if layer == 0 and q.shape[1] > captured.get("qp", 0):
            captured.update(qp=q.shape[1], q=q.clone(),
                            pool=pool[:1].clone(),
                            meta=[m.clone() for m in meta])
        return ragged_paged_attention(q, pool, layer, *meta, **kw)

    gen_mod.ragged_paged_attention = capture
    preamble = rng.randint(0, cfg.vocab_size, 64)
    prompts = []
    for i in range(16):
        n = 512 if i == 0 else int(rng.randint(32, 513))
        p = rng.randint(0, cfg.vocab_size, n)
        if i in (1, 12):                 # the second one admits later
            p = np.concatenate([preamble, p[:max(1, n - 64)]])
        prompts.append(p)
    steps0 = eng.stats()["steps"]
    ragged_paged_attention.launches = 0
    fused_layer_norm.launches = 0
    t0 = time.perf_counter()
    handles = [eng.submit(p, max_new_tokens=64) for p in prompts]
    outs = [h.result(timeout=600) for h in handles]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"ragged_paged_attention": ragged_paged_attention.launches,
                "fused_layer_norm": fused_layer_norm.launches}
    gen_mod.ragged_paged_attention = ragged_paged_attention
    stats = eng.stats()
    if profile:
        profile_engine(eng, rng, cfg.vocab_size)
    eng.close()
    steps = stats["steps"] - steps0
    for p, h, out in zip(prompts, handles, outs):
        if len(h.tokens) != 64 or out.shape != (len(p) + 64,):
            raise AssertionError(f"request {h.id}: {len(h.tokens)} tokens")
        if not ((out >= 0) & (out < cfg.vocab_size)).all():
            raise AssertionError(f"request {h.id}: token out of range")
    L = cfg.num_hidden_layers
    if launches["ragged_paged_attention"] != L * steps \
            or launches["fused_layer_norm"] != (2 * L + 1) * steps:
        raise AssertionError(f"launches {launches} over {steps} steps: "
                             f"expected {L} and {2 * L + 1} per step")
    if stats["prefix_hits"] < 1 or stats["prefill_chunks"] <= len(prompts):
        raise AssertionError(f"no prefix hit or no chunked prompt: {stats}")
    if stats["nonfinite_cycles"]:
        raise AssertionError(f"non-finite logits in "
                             f"{stats['nonfinite_cycles']} cycles")
    toks = 64 * len(prompts)
    log(f"engine: GPT-2 small bf16, {len(prompts)} requests x 64 tokens, "
        f"prompts {min(map(len, prompts))}-{max(map(len, prompts))}, "
        f"{steps} steps in {wall:.3f} s: {toks / wall:.1f} tokens/s, "
        f"mean step {wall / steps * 1e3:.3f} ms (wall / steps), "
        f"TTFT p50 {stats['ttft_ms']['p50']:.1f} ms p95 "
        f"{stats['ttft_ms']['p95']:.1f} ms, TPOT p50 "
        f"{stats['tpot_ms']['p50']:.2f} ms, prefix hits "
        f"{stats['prefix_hits']}, chunks {stats['prefill_chunks']}, "
        f"preempts {stats['preempts']}")
    log("engine launches: " + json.dumps(launches) + f" over {steps} steps")
    return launches, captured


# ---------------------------------------------------------------- phase 4
def phase_report(device, timer, launches, captured):
    from paddle_tpu_torch.ops.layer_norm import (fused_layer_norm,
                                                 layer_norm_plain)
    from paddle_tpu_torch.ops.ragged_paged_attention import (
        ragged_paged_attention, ragged_paged_attention_plain)
    q, pool, meta = captured["q"], captured["pool"], captured["meta"]
    dtype = q.dtype
    got = ragged_paged_attention(q, pool, 0, *meta)
    torch.cuda.synchronize()
    err = check_close("ragged_paged_attention on an engine step", got,
                      ragged_paged_attention_plain(q, pool, 0, *meta), dtype)
    nbytes, ops = rpa_work(q, pool, meta)
    b_ms, b_by = bound(nbytes, ops, dtype)
    rpa = {"name": "ragged_paged_attention", "route": "cuda",
           "source": RPA_SRC, "replaces": RPA_TPU,
           "launches": launches["ragged_paged_attention"],
           "max_abs_err": err,
           "ms": timer.ms(lambda: ragged_paged_attention(q, pool, 0, *meta)),
           "plain_ms": timer.ms(lambda: ragged_paged_attention_plain(
               q, pool, 0, *meta), reps=5, warmup=1),
           "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}
    log(f"engine step layer 0: q{tuple(q.shape)}, {nbytes} bytes, "
        f"{ops} ops")
    rows, d = q.shape[1], q.shape[0] * q.shape[2]
    torch.manual_seed(SEED)
    x = torch.randn(rows, d, device=device).to(dtype)
    w = (1 + 0.1 * torch.randn(d, device=device)).to(dtype)
    b = (0.1 * torch.randn(d, device=device)).to(dtype)
    got = fused_layer_norm(x, w, b)
    torch.cuda.synchronize()
    err = check_close("fused_layer_norm at the engine step's rows", got,
                      layer_norm_plain(x, w, b), dtype)
    e = x.element_size()
    b_ms, b_by = bound(2 * rows * d * e + 2 * d * e, 7 * rows * d, dtype)
    ln = {"name": "fused_layer_norm", "route": "cuda", "source": LN_SRC,
          "replaces": LN_TPU, "launches": launches["fused_layer_norm"],
          "max_abs_err": err,
          "ms": timer.ms(lambda: fused_layer_norm(x, w, b)),
          "plain_ms": timer.ms(lambda: layer_norm_plain(x, w, b)),
          "bound_ms": b_ms, "bound_by": b_by,
          "library_ms": timer.ms(lambda: torch.nn.functional.layer_norm(
              x, (d,), w, b, 1e-5))}
    return [rpa, ln]


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
    timer = Timer(device)
    phase_kernels(device, timer)
    launches, captured = phase_engine(device, profile)
    kernels = phase_report(device, timer, launches, captured)
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
