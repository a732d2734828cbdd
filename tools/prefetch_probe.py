"""Where a prefetched GPT-2 step's batch wait goes, on the card.

Runs ``chip_smoke.py``'s phase-13 fit (GPT-2 small, bf16 O2, 8 x 1024,
fed from ``np.memmap`` token windows through ``io.DataLoader``) in four
configurations, each twice in the order A B B0 Bs A2 A2 Bs B0 B A:

* A: no worker, no prefetch;
* A2: 2 worker processes, no prefetch;
* B: 2 worker processes and ``device_prefetch`` (``fit``'s default);
* B0: no worker, ``device_prefetch`` (the producer thread alone);
* Bs: as B with the interpreter's thread switch interval at 0.5 ms
  instead of 5 ms.

Each fit runs under the port's span profiler, and ``Tensor.pin_memory``
is timed in whichever thread calls it. For every prefetched batch after
the first it reads the producer's ``io/device_put`` span and the
consumer's ``io/queue_wait`` span: a batch whose copy was queued before
the consumer asked for it was ready, so that wait is spent taking the
queue's lock and the interpreter lock back from the producer thread;
otherwise the producer was behind. The monitor's ``prefetch_wait_ms``
spans the queue's wait and what the consumer does with the batch after
it (the stream's wait on the copy, ``record_stream``): the difference is
that part. Prints one line per fit and writes one JSON object per fit
to the file given (default ``build/prefetch_probe.jsonl``).

Run from the repository root on a machine with a CUDA card::

    python3 tools/prefetch_probe.py [OUT.jsonl]
"""
from __future__ import annotations

import gc
import json
import os
import sys
import tempfile
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as cs  # noqa: E402

CONFIGS = {"A": (0, False, None), "A2": (cs.CORE_WORKERS, False, None),
           "B": (cs.CORE_WORKERS, True, None), "B0": (0, True, None),
           "Bs": (cs.CORE_WORKERS, True, 0.0005)}
ORDER = ["A", "B", "B0", "Bs", "A2", "A2", "Bs", "B0", "B", "A"]


def timed_pin_memory(samples):
    """``Tensor.pin_memory`` that appends each call's host ms to
    ``samples``."""
    orig = torch.Tensor.pin_memory

    def pin_memory(self, *a, **kw):
        t0 = time.perf_counter()
        out = orig(self, *a, **kw)
        samples.append((time.perf_counter() - t0) * 1e3)
        return out

    return orig, pin_memory


def split_waits(events):
    """Per prefetched batch after the first: (wait ms, whether its copy
    was queued before the wait began, put ms)."""
    puts = [e for e in events if e["name"] == "io/device_put"]
    waits = [e for e in events if e["name"] == "io/queue_wait"]
    rows = []
    for i, w in enumerate(waits[1:len(puts)], start=1):
        p = puts[i]
        rows.append((w["dur"] / 1e3, p["ts"] + p["dur"] <= w["ts"],
                     p["dur"] / 1e3))
    return rows


def pct(xs, q):
    return float(np.percentile(xs, q)) if len(xs) else None


def main() -> int:
    from paddle_tpu_torch.ops import _build
    from paddle_tpu_torch.models import GPTConfig
    from paddle_tpu_torch.profiler import span
    if not torch.cuda.is_available():
        print("prefetch_probe: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda")
    card = cs.smi()
    cs.log(card)
    cs.log(f"kernel build: {_build.build_all():.2f} s")
    counters = cs.train_counters()
    n = cs.CORE_WARM + cs.CORE_TIMED
    vocab = GPTConfig.gpt2_small().vocab_size
    out_path = sys.argv[1] if len(sys.argv) > 1 else os.path.join(
        "build", "prefetch_probe.jsonl")
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    switch = sys.getswitchinterval()
    with tempfile.TemporaryDirectory(prefix="prefetch_probe_") as tmp, \
            open(out_path, "w") as out:
        path = os.path.join(tmp, "tokens.u16")
        np.random.RandomState(cs.SEED).randint(
            0, vocab, cs.BATCH * n * (cs.SEQ + 1)).astype(
                np.uint16).tofile(path)
        ds = cs.token_windows(path)
        for which in ORDER:
            workers, prefetch, interval = CONFIGS[which]
            gc.collect()
            pins = []
            orig, timed = timed_pin_memory(pins)
            torch.Tensor.pin_memory = timed
            sys.setswitchinterval(interval or switch)
            try:
                with span.profile():
                    rec, model = cs.core_run(which, device, ds, workers,
                                             prefetch, counters)
                    events = span.events()
            finally:
                torch.Tensor.pin_memory = orig
                sys.setswitchinterval(switch)
            del model
            rows = split_waits(events)
            ready = [w for w, r, _ in rows if r]
            behind = [w for w, r, _ in rows if not r]
            after = [t - w for t, (w, _, _) in zip(rec["waits"][1:], rows)]
            res = {"config": which, "workers": workers,
                   "prefetch": prefetch,
                   "switch_interval_s": interval or switch,
                   "ms": rec["ms"], "step_ms": rec["step_ms"],
                   "wait_ms": [w for w, _, _ in rows],
                   "ready": [r for _, r, _ in rows],
                   "prefetch_wait_ms": rec["waits"][1:],
                   "put_ms": [p for _, _, p in rows],
                   "pin_ms": pins, "card": card}
            out.write(json.dumps(res) + "\n")
            cs.log(
                f"probe {which} (workers {workers}, prefetch {prefetch}, "
                f"switch interval {(interval or switch) * 1e3:g} ms): "
                f"{rec['ms']:.3f} ms a step (CUDA events, {cs.CORE_TIMED} "
                f"timed steps); batches 2-{n}: {len(ready)} ready before "
                f"the wait (wait p50 {pct(ready, 50)}, max "
                f"{max(ready, default=None)} ms), {len(behind)} behind "
                f"(wait p50 {pct(behind, 50)} ms); after the wait p50 "
                f"{pct(after, 50)} max {max(after, default=None)} ms; put p50 "
                f"{pct([p for _, _, p in rows], 50)} ms; pin_memory "
                f"{len(pins)} calls, p50 {pct(pins, 50)} max "
                f"{max(pins, default=None)} ms; on {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
