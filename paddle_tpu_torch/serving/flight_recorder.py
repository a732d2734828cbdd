"""Scheduler flight recorder (counterpart of
``paddle_tpu/serving/flight_recorder.py``): bounded postmortem
telemetry, always on.

Two bounded rings the scheduler writes every cycle (host dicts, no
device work), dumpable as JSON after the fact:

* **cycle records**: per scheduler cycle, the sweep / admission /
  prefill / dispatch / host-fetch wall-time breakdown, occupancy, queue
  depth, tokens emitted, blocks in use, and on a speculative engine the
  draft dispatches and the proposed, accepted and emitted tokens;
* **request events**: every request's lifecycle marks (submit,
  admitted, preempt, first_token, finish/cancel/deadline/error) in
  arrival order.

It also keeps this engine's latency samples: every retired
:class:`~.tracing.RequestTrace` deposits its TTFT/TPOT here, and
``engine.stats()`` reads its percentiles from THIS recorder, so two
engines in one process never mix their figures as the process-wide
monitor histograms would.

Tail sampling: the recorder keeps full trace snapshots of the slowest-N
requests by TTFT, of every request over the TTFT SLO armed with
:meth:`set_tail_slo`, and of the latest few (:meth:`tail_traces`).
Retire hooks (:meth:`add_retire_hook`) see every retired trace; a
bounded ring of retire stamps gives the windowed :meth:`goodput`.

``engine.dump_flight_recorder()`` snapshots everything on demand; the
scheduler calls :meth:`auto_dump` when a cycle fails, into
``FLAGS_flight_dump_dir`` (or the system temp directory).

Threading: the scheduler thread writes, any thread reads; every method
takes the one small lock. Retire hooks run on the scheduler thread
outside the lock (a hook may read the recorder back).
"""
from __future__ import annotations

import heapq
import json
import os
import tempfile
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional

from ..framework import flags as _flags
from ..framework.monitor import _percentile

__all__ = ["FlightRecorder"]


class FlightRecorder:
    """Bounded ring buffers of scheduler cycles + request events, plus
    per-engine TTFT/TPOT sample reservoirs."""

    def __init__(self, max_cycles: int = 256, max_events: int = 2048,
                 max_samples: int = 4096, tail_keep: int = 8,
                 recent_traces: int = 16):
        if max_cycles < 1 or max_events < 1:
            raise ValueError("flight recorder rings must hold >= 1 entry")
        self._lock = threading.Lock()
        self._cycles: deque = deque(maxlen=int(max_cycles))
        self._events: deque = deque(maxlen=int(max_events))
        self._ttft: deque = deque(maxlen=int(max_samples))
        self._tpot: deque = deque(maxlen=int(max_samples))
        self.cycles_recorded = 0       # monotonic (ring drops, this doesn't)
        self.events_recorded = 0
        self.retired = 0
        self.last_dump_path: Optional[str] = None
        self.dumps = 0
        # tail sampling: slowest-N (min-heap keyed by TTFT so the heap
        # root is the cheapest entry to evict), SLO violations, and a
        # recent ring for context; all hold JSON trace snapshots, not
        # live RequestTrace objects, so /tracez serialization is safe
        # off the scheduler thread
        self._tail_keep = max(1, int(tail_keep))
        self._tail_slow: List[tuple] = []           # (ttft, seq, snapshot)
        self._tail_seq = 0
        self._tail_violations: deque = deque(maxlen=self._tail_keep * 4)
        self._recent: deque = deque(maxlen=int(recent_traces))
        self.tail_slo_ms: Optional[float] = None
        self.slo_violations = 0                     # monotonic
        # (t_retired, ttft_ms) stamps for windowed goodput; bounded
        self._retire_stamps: deque = deque(maxlen=int(max_samples))
        # per-tenant accounting (the front door's multi-tenancy plane):
        # lifetime retire counters plus a bounded per-tenant stamp ring
        # so goodput splits by tenant label without a second pass over
        # the traces. Keyed by trace.tenant; untagged traffic lands
        # under "default".
        self._tenant_counts: Dict[str, int] = {}
        self._tenant_stamps: Dict[str, deque] = {}
        self._tenant_ring = max(256, int(max_samples) // 4)
        self._retire_hooks: List[Callable[[Any], None]] = []

    # -- SLO plane wiring ---------------------------------------------------
    def set_tail_slo(self, slo_ms: Optional[float]) -> None:
        """Arm (or disarm with None) the TTFT SLO that decides which
        retiring traces are tail-sampled as violations and which count
        as "good" in :meth:`goodput`."""
        with self._lock:
            self.tail_slo_ms = float(slo_ms) if slo_ms is not None else None

    def add_retire_hook(self, fn: Callable[[Any], None]) -> None:
        """``fn(trace)`` runs on the scheduler thread after every
        retire, outside the recorder lock; a raising hook is dropped
        from that call only (the scheduler must never die for an
        observer)."""
        with self._lock:
            self._retire_hooks.append(fn)

    # -- writers (scheduler thread) ----------------------------------------
    def record_cycle(self, rec: Dict[str, Any]) -> None:
        with self._lock:
            self._cycles.append(rec)
            self.cycles_recorded += 1

    def record_event(self, request_id: int, name: str,
                     t: Optional[float] = None,
                     meta: Optional[dict] = None) -> None:
        ev = {"request": int(request_id), "event": name,
              "t": t if t is not None else time.perf_counter()}
        if meta:
            ev["meta"] = meta
        with self._lock:
            self._events.append(ev)
            self.events_recorded += 1

    def retire(self, trace) -> None:
        """A request finished: bank its derived latencies so stats()
        percentiles come from this engine's own traffic, tail-sample
        the trace, and fan out to the registered retire hooks."""
        ttft, tpot = trace.ttft_ms, trace.tpot_ms
        now = time.perf_counter()
        snap = None
        try:
            snap = trace.snapshot()
        except Exception:                                # noqa: BLE001
            pass        # a malformed trace must not kill the scheduler
        tenant = getattr(trace, "tenant", None) or "default"
        with self._lock:
            self.retired += 1
            if ttft is not None:
                self._ttft.append(ttft)
            if tpot is not None:
                self._tpot.append(tpot)
            self._retire_stamps.append((now, ttft))
            self._tenant_counts[tenant] = \
                self._tenant_counts.get(tenant, 0) + 1
            ring = self._tenant_stamps.get(tenant)
            if ring is None:
                ring = self._tenant_stamps[tenant] = deque(
                    maxlen=self._tenant_ring)
            ring.append((now, ttft))
            if snap is not None:
                self._recent.append(snap)
                violated = (self.tail_slo_ms is not None
                            and ttft is not None
                            and ttft > self.tail_slo_ms)
                if violated:
                    self.slo_violations += 1
                    self._tail_violations.append(
                        dict(snap, tail="slo_violation"))
                if ttft is not None:
                    self._tail_seq += 1
                    heapq.heappush(self._tail_slow,
                                   (ttft, self._tail_seq, snap))
                    if len(self._tail_slow) > self._tail_keep:
                        heapq.heappop(self._tail_slow)   # evict fastest
            hooks = list(self._retire_hooks)
        for fn in hooks:
            try:
                fn(trace)
            except Exception:                            # noqa: BLE001
                pass

    # -- readers -----------------------------------------------------------
    def latency_samples(self) -> Dict[str, List[float]]:
        """Raw copies of the TTFT/TPOT reservoirs (bounded, newest
        window). The fleet aggregator pools THESE into mergeable
        histograms — fleet percentiles must come from pooled samples or
        summed bucket counts, never from averaging per-replica
        percentiles."""
        with self._lock:
            return {"ttft_ms": list(self._ttft),
                    "tpot_ms": list(self._tpot)}

    def latency_summary(self) -> Dict[str, Optional[dict]]:
        """Per-engine ``{"ttft_ms": {...}, "tpot_ms": {...}}`` with
        count/p50/p95/p99 over the retired-trace reservoirs (None while
        no request has produced the respective samples)."""
        with self._lock:
            ttft, tpot = list(self._ttft), list(self._tpot)

        def pct(vals: List[float]) -> Optional[dict]:
            if not vals:
                return None
            s = sorted(vals)
            return {"count": len(s), "p50": _percentile(s, 0.5),
                    "p95": _percentile(s, 0.95),
                    "p99": _percentile(s, 0.99)}

        return {"ttft_ms": pct(ttft), "tpot_ms": pct(tpot)}

    def tail_traces(self) -> Dict[str, Any]:
        """The tail-sampled populations for ``/tracez``: slowest-N by
        TTFT (slowest first), SLO-violating traces, and the recent ring
        — full JSON trace snapshots, outliers the percentiles hide."""
        with self._lock:
            slowest = [dict(s, tail="slowest")
                       for _, _, s in sorted(self._tail_slow,
                                             key=lambda e: -e[0])]
            violations = [dict(v) for v in self._tail_violations]
            recent = [dict(r) for r in self._recent]
            return {"tail_slo_ms": self.tail_slo_ms,
                    "slo_violations_total": self.slo_violations,
                    "slowest": slowest,
                    "slo_violations": violations,
                    "recent": recent}

    def goodput(self, window_s: float = 60.0,
                slo_ms: Optional[float] = None) -> Dict[str, Any]:
        """SLO-meeting completions per second over the trailing window:
        a retired request counts as good when its TTFT met the SLO
        (armed via :meth:`set_tail_slo` or passed here). The divisor is
        the window, clipped to the observed span when the engine is
        younger than the window — a 10s-old engine must not report a
        60x-diluted rate."""
        now = time.perf_counter()
        with self._lock:
            stamps = list(self._retire_stamps)
            slo = slo_ms if slo_ms is not None else self.tail_slo_ms
        in_window = [(t, v) for t, v in stamps if now - t <= window_s]
        if not in_window:
            return {"window_s": window_s, "total": 0, "good": 0,
                    "goodput_rps": 0.0}
        total = len(in_window)
        good = sum(1 for _, v in in_window
                   if v is not None and (slo is None or v <= slo))
        # fully covered window: oldest surviving stamp predates it
        if stamps[0][0] <= now - window_s:
            span = window_s
        else:
            span = max(1e-3, now - in_window[0][0])
        return {"window_s": window_s, "total": total, "good": good,
                "goodput_rps": good / span}

    def tenant_summary(self, window_s: float = 60.0) -> Dict[str, Any]:
        """Per-tenant retire/goodput split over the trailing window —
        the numbers behind the ``serving_tenant_*`` labeled metrics and
        the front door's per-tenant view. A retired request counts as
        good under the same armed tail SLO :meth:`goodput` uses; with
        no SLO armed every completed-with-a-TTFT request is good.
        Empty until the first retire (no phantom "default" row)."""
        now = time.perf_counter()
        with self._lock:
            slo = self.tail_slo_ms
            tenants = {t: (self._tenant_counts.get(t, 0), list(ring))
                       for t, ring in self._tenant_stamps.items()}
        out: Dict[str, Any] = {}
        for tenant, (retired, stamps) in sorted(tenants.items()):
            in_window = [(t, v) for t, v in stamps if now - t <= window_s]
            good = sum(1 for _, v in in_window
                       if v is not None and (slo is None or v <= slo))
            if stamps and stamps[0][0] <= now - window_s:
                span = window_s
            elif in_window:
                span = max(1e-3, now - in_window[0][0])
            else:
                span = window_s
            ttfts = sorted(v for _, v in in_window if v is not None)
            out[tenant] = {
                "retired": retired,
                "window_total": len(in_window),
                "window_good": good,
                "goodput_rps": good / span,
                "ttft_p50_ms": _percentile(ttfts, 0.5) if ttfts else None,
                "ttft_p95_ms": _percentile(ttfts, 0.95) if ttfts else None,
            }
        return out

    def cycle_throughput(self) -> Dict[str, float]:
        """Decode throughput over the cycle ring: cycles recorded in the
        ring, tokens emitted, and summed cycle wall seconds —
        ``engine.stats()`` derives per-engine tokens/sec and serving MFU
        from THIS ring (per-engine by construction, like the latency
        reservoirs)."""
        with self._lock:
            cycles = len(self._cycles)
            emitted = sum(c.get("emitted", 0) for c in self._cycles)
            secs = sum(c.get("cycle_ms", 0.0) for c in self._cycles) / 1e3
            decode_cycles = sum(
                1 for c in self._cycles
                if c.get("decode_dispatch_ms", 0.0) > 0.0)
            decode_flops = sum(c.get("decode_flops", 0.0)
                               for c in self._cycles)
            chunk_tokens = sum(c.get("chunk_tokens", 0)
                               for c in self._cycles)
            prefill_chunks = sum(c.get("prefill_chunks", 0)
                                 for c in self._cycles)
            spec_emitted = sum(c.get("spec_emitted", 0)
                               for c in self._cycles)
            spec_slots = sum(c.get("spec_slots", 0)
                             for c in self._cycles)
            spec_accepted = sum(c.get("spec_accepted", 0)
                                for c in self._cycles)
            spec_proposed = sum(c.get("spec_proposed", 0)
                                for c in self._cycles)
            # hierarchical-KV promotion accounting: cycles
            # spent with a waiter skipped for an in-flight H2D copy,
            # and blocks adopted back — the ring-window evidence that
            # promotions overlap decode instead of stalling it
            promo_waits = sum(c.get("promo_waits", 0)
                              for c in self._cycles)
            promoted_blocks = sum(c.get("promoted_blocks", 0)
                                  for c in self._cycles)
        return {"cycles": cycles, "emitted": emitted, "cycle_secs": secs,
                "decode_cycles": decode_cycles,
                "decode_flops": decode_flops,
                "chunk_tokens": chunk_tokens,
                "prefill_chunks": prefill_chunks,
                "spec_emitted": spec_emitted, "spec_slots": spec_slots,
                "spec_accepted": spec_accepted,
                "spec_proposed": spec_proposed,
                "promo_waits": promo_waits,
                "promoted_blocks": promoted_blocks}

    def snapshot(self) -> Dict[str, Any]:
        """JSON-serializable copy of both rings + the counters."""
        with self._lock:
            return {
                "cycles": [dict(c) for c in self._cycles],
                "events": [dict(e) for e in self._events],
                "cycles_recorded": self.cycles_recorded,
                "events_recorded": self.events_recorded,
                "requests_retired": self.retired,
                "ring_capacity": {"cycles": self._cycles.maxlen,
                                  "events": self._events.maxlen},
                "tail": {"slo_ms": self.tail_slo_ms,
                         "slowest": len(self._tail_slow),
                         "slo_violations": self.slo_violations,
                         "recent": len(self._recent)},
            }

    # -- dumps -------------------------------------------------------------
    def dump(self, path: Optional[str] = None,
             extra: Optional[dict] = None) -> Dict[str, Any]:
        """Snapshot (plus ``extra``, e.g. engine stats); written to
        ``path`` as JSON when given. Returns the document."""
        doc = self.snapshot()
        doc["latency"] = self.latency_summary()
        doc["tail_traces"] = self.tail_traces()
        if extra:
            doc.update(extra)
        if path:
            d = os.path.dirname(os.path.abspath(path))
            os.makedirs(d, exist_ok=True)
            with open(path, "w") as f:
                json.dump(doc, f, default=repr)
        return doc

    def auto_dump(self, reason: str) -> Optional[str]:
        """Failure-path dump: best effort, NEVER raises (it runs inside
        the scheduler's exception handler — a broken disk must not turn
        a poisoned step into a dead loop). Returns the file path.

        The filename carries a monotonic per-recorder sequence number:
        two poisoned cycles in quick succession are exactly the case a
        postmortem exists for, and without the suffix the second dump
        OVERWRITES the first — the origin cycle's evidence — at the
        pid+recorder path.

        The directory honors ``FLAGS_flight_dump_dir`` (env var wins
        over the flag registry so ops can redirect a running deployment
        without code) and is created on demand; empty falls back to the
        system tempdir."""
        try:
            d = os.environ.get("FLAGS_flight_dump_dir", "").strip()
            if not d:
                d = str(_flags.flag_value(
                    "FLAGS_flight_dump_dir") or "").strip()
            d = d or tempfile.gettempdir()
            os.makedirs(d, exist_ok=True)
            with self._lock:
                seq = self.dumps
            path = os.path.join(
                d,
                f"paddle_serving_flight_{os.getpid()}_{id(self):x}"
                f"_{seq:04d}.json")
            self.dump(path, extra={"reason": reason,
                                   "dumped_at": time.time()})
            with self._lock:
                self.last_dump_path = path
                self.dumps += 1
            return path
        except Exception:                                # noqa: BLE001
            return None

    def __repr__(self):
        with self._lock:
            return (f"<FlightRecorder cycles={len(self._cycles)}/"
                    f"{self.cycles_recorded} events={len(self._events)}/"
                    f"{self.events_recorded} retired={self.retired}>")
