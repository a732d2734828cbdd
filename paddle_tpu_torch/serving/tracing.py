"""Per-request lifecycle tracing (counterpart of
``paddle_tpu/serving/tracing.py``'s ``RequestTrace``).

Every request carries a :class:`RequestTrace`: timestamped lifecycle
events (submit, admitted, prefill chunks, prefix hit, preemptions,
first token, finish/cancel/deadline/error) plus one host stamp per
emitted token. From those it derives TTFT (submit -> first token), TPOT
(mean interval between later tokens) and the admission wait, and it
renders itself as a JSON timeline (:meth:`RequestTrace.snapshot`, the
unit the flight recorder keeps of a retired request). Stamps are
``time.perf_counter()`` readings taken in host code only.

Chrome-trace export: when a ``profiler.span.profile`` session is
armed, a finished trace exports itself as a REQUEST LANE — a synthetic
tid per request carrying queued/prefill/decode phase spans — next to
the scheduler thread's per-cycle spans, so one trace file shows both
views of the same stall (``export_spans``).
"""
from __future__ import annotations

import time
from typing import Any, Dict, List, Optional, Tuple

from ..profiler import span as _prof

__all__ = ["RequestTrace", "TERMINAL_EVENTS", "REQUEST_LANE_BASE"]

# lifecycle events that end a request (exactly one per trace)
TERMINAL_EVENTS = ("finish", "cancelled", "deadline", "error")

# synthetic chrome-trace tids for request lanes: far above any real
# thread ident the viewer would otherwise collide with
REQUEST_LANE_BASE = 1_000_000_000


class RequestTrace:
    """Timestamped lifecycle of one generation request. The scheduler
    thread writes it; callers read it after ``handle.result()``."""

    __slots__ = ("request_id", "events", "token_times", "tenant", "lane")

    def __init__(self, request_id: int, t_submit: Optional[float] = None,
                 tenant: Optional[str] = None, lane: Optional[str] = None):
        self.request_id = int(request_id)
        self.tenant, self.lane = tenant, lane
        self.events: List[Tuple[str, float, Optional[dict]]] = [
            ("submit", t_submit if t_submit is not None
             else time.perf_counter(), None)]
        self.token_times: List[float] = []   # one host stamp per token

    def mark(self, name: str, t: Optional[float] = None, **meta) -> None:
        self.events.append((name, t if t is not None
                            else time.perf_counter(), meta or None))

    def stamp_token(self, t: float) -> None:
        self.token_times.append(t)

    def t(self, name: str) -> Optional[float]:
        """Timestamp of the FIRST occurrence of ``name``, or None."""
        for n, ts, _ in self.events:
            if n == name:
                return ts
        return None

    def count(self, name: str) -> int:
        return sum(1 for n, _, _ in self.events if n == name)

    @property
    def submitted_at(self) -> float:
        return self.events[0][1]

    @property
    def finished_at(self) -> Optional[float]:
        for n, ts, _ in reversed(self.events):
            if n in TERMINAL_EVENTS:
                return ts
        return None

    @property
    def completed(self) -> bool:
        return self.finished_at is not None

    @property
    def ttft_ms(self) -> Optional[float]:
        """Submit -> first token, the latency a client feels."""
        if not self.token_times:
            return None
        return (self.token_times[0] - self.submitted_at) * 1e3

    @property
    def tpot_ms(self) -> Optional[float]:
        """Mean inter-token interval after the first token (needs >= 2
        tokens)."""
        if len(self.token_times) < 2:
            return None
        return (self.token_times[-1] - self.token_times[0]) * 1e3 \
            / (len(self.token_times) - 1)

    @property
    def admission_wait_ms(self) -> Optional[float]:
        """Submit -> first admission: the queueing share of TTFT."""
        t_adm = self.t("admitted")
        if t_adm is None:
            return None
        return (t_adm - self.submitted_at) * 1e3

    @property
    def decode_intervals_ms(self) -> List[float]:
        tt = self.token_times
        return [(b - a) * 1e3 for a, b in zip(tt, tt[1:])]

    def timeline(self) -> List[Dict[str, Any]]:
        """JSON-friendly event list, times in ms relative to submit."""
        t0 = self.submitted_at
        out = [{"event": n, "t_ms": round((ts - t0) * 1e3, 3),
                **({"meta": m} if m else {})}
               for n, ts, m in self.events]
        for i, ts in enumerate(self.token_times):
            out.append({"event": "token", "i": i,
                        "t_ms": round((ts - t0) * 1e3, 3)})
        out.sort(key=lambda e: e["t_ms"])
        return out

    def snapshot(self) -> Dict[str, Any]:
        """The whole trace as one JSON dict, derived latencies included,
        so a kept snapshot outlives the live trace."""
        return {"request": self.request_id,
                **({"tenant": self.tenant} if self.tenant else {}),
                **({"lane": self.lane} if self.lane else {}),
                "completed": self.completed,
                "ttft_ms": self.ttft_ms,
                "tpot_ms": self.tpot_ms,
                "tokens": len(self.token_times),
                "preempts": self.count("preempt"),
                "prefix_hits": self.count("prefix_hit"),
                "timeline": self.timeline()}

    # -- chrome-trace export -----------------------------------------------
    def export_spans(self) -> None:
        """Emit this (finished) request as a chrome-trace lane into the
        armed profiler span buffer: one whole-lifetime span plus
        queued/prefill/decode phase children and zero-duration marks for
        preemptions and prefix hits. No-op (one bool check) when no
        profile() session is active — the scheduler calls this from the
        terminal path unconditionally."""
        if not _prof.is_active():
            return
        t0, t1 = self.submitted_at, self.finished_at
        if t1 is None:
            t1 = time.perf_counter()
        tid = REQUEST_LANE_BASE + self.request_id
        _prof.set_thread_name(f"request {self.request_id}", tid=tid)
        _prof.add_event(
            f"request {self.request_id}", "serving/request", t0, t1,
            tid=tid, depth=0,
            args={"ttft_ms": self.ttft_ms, "tpot_ms": self.tpot_ms,
                  "tokens": len(self.token_times),
                  "preempts": self.count("preempt")})
        name = f"request {self.request_id}"
        t_adm = self.t("admitted")
        if t_adm is not None:
            _prof.add_event("queued", "serving/request", t0, t_adm,
                            tid=tid, depth=1, parent=name)
        pending_ps = None   # pair prefill_start/_end sequentially: a
        for n, ts, meta in self.events:   # preempted request has several
            if n == "prefill_start":
                pending_ps = ts
            elif n == "prefill_end":
                if pending_ps is not None:
                    _prof.add_event("prefill", "serving/request",
                                    pending_ps, ts, tid=tid, depth=1,
                                    parent=name, args=meta)
                    pending_ps = None
            elif n in ("preempt", "prefix_hit", "replay_done"):
                _prof.add_event(n, "serving/request", ts, ts, tid=tid,
                                depth=1, parent=name, args=meta)
        if self.token_times:
            _prof.add_event("decode", "serving/request",
                            self.token_times[0], t1, tid=tid, depth=1,
                            parent=name,
                            args={"tokens": len(self.token_times)})

    def __repr__(self):
        return (f"<RequestTrace #{self.request_id} events="
                f"{len(self.events)} tokens={len(self.token_times)} "
                f"ttft_ms={self.ttft_ms} tpot_ms={self.tpot_ms}>")
