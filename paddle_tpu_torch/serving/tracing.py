"""Per-request lifecycle tracing (counterpart of
``paddle_tpu/serving/tracing.py``'s ``RequestTrace``).

Every request carries a :class:`RequestTrace`: timestamped lifecycle
events (submit, admitted, prefill chunks, prefix hit, preemptions,
first token, finish/cancel/deadline/error) plus one host stamp per
emitted token. From those it derives TTFT (submit -> first token) and
TPOT (mean interval between later tokens). Stamps are
``time.perf_counter()`` readings taken in host code only.
"""
from __future__ import annotations

import time
from typing import List, Optional, Tuple

__all__ = ["RequestTrace", "TERMINAL_EVENTS"]

# lifecycle events that end a request (exactly one per trace)
TERMINAL_EVENTS = ("finish", "cancelled", "deadline", "error")


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

    def __repr__(self):
        return (f"<RequestTrace #{self.request_id} events="
                f"{len(self.events)} tokens={len(self.token_times)} "
                f"ttft_ms={self.ttft_ms} tpot_ms={self.tpot_ms}>")
