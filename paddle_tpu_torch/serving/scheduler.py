"""Continuous-batching scheduler (counterpart of
``paddle_tpu/serving/scheduler.py``): admit, run one step, retire, every
cycle. Two modes, as the engine picks:

* **bucketed** (the dense and paged gather engines) — admission pops
  queued requests FCFS (preempted requests first) into free slots and
  runs the prefill program of each one's pow2 capacity bucket, which
  returns its first token. While slots decode, the prefills of one
  cycle may spend at most ``prefill_budget`` bucket tokens; a paged
  prefix hit runs no program and costs nothing, its uncovered tail (and
  a preempted request's own history) then replays through the decode
  step one token a cycle. Each cycle is then ONE decode step over every
  slot; paged slots first get a writable block at their position (copy
  on write), and block exhaustion preempts the youngest request.
* **chunked** (the fused engine) — admission is host bookkeeping: the
  engine reserves blocks and arms ``req.pending_feed``. Each cycle is
  ONE fused ragged launch mixing up to ``prefill_budget`` tokens of
  prompt chunks with one row for every decoding slot. Decode rows are
  never charged to the budget, so a prompt burst cannot monopolize a
  cycle; a slot whose final chunk lands emits its first token from the
  same launch. Block exhaustion while growing preempts the youngest
  request, which re-queues and later replays its own history as a feed.

Finished (EOS / token budget), cancelled and expired requests free their
slot at once.

Threading contract: ``submit``/``cancel`` may be called from any
thread; the loop, the pool and the slot state belong to the scheduler
thread. The ONLY device-to-host copy of the loop is :func:`_fetch`, one
per cycle.
"""
from __future__ import annotations

import itertools
import logging
import queue
import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional

import numpy as np

from .paging import PoolExhaustedError
from .tracing import RequestTrace

__all__ = ["QueueFullError", "DeadlineExceeded", "RequestCancelled",
           "GenerationRequest", "Scheduler"]


class QueueFullError(RuntimeError):
    """The admission queue is at capacity — shed load and retry later.
    ``queue_depth`` and ``est_wait_s`` are the load hints a front door
    reads (None where the raiser has none)."""

    def __init__(self, message: str = "", *,
                 queue_depth: Optional[int] = None,
                 est_wait_s: Optional[float] = None):
        super().__init__(message)
        self.queue_depth = queue_depth
        self.est_wait_s = est_wait_s


class DeadlineExceeded(TimeoutError):
    """The request's deadline passed before it finished (tokens produced
    before it were streamed); the load hints as ``QueueFullError``'s."""

    def __init__(self, message: str = "", *,
                 queue_depth: Optional[int] = None,
                 est_wait_s: Optional[float] = None):
        super().__init__(message)
        self.queue_depth = queue_depth
        self.est_wait_s = est_wait_s


class RequestCancelled(RuntimeError):
    """The request was cancelled via ``GenerationRequest.cancel()``."""


_log = logging.getLogger(__name__)

_DONE = object()          # stream terminator sentinel

# retired-request latency samples kept for stats() percentiles
_RESERVOIR = 4096


def _fetch(tokens):
    """THE one device-to-host copy of the serving loop: the step's
    ``[num_slots + 1]`` next-token tensor, once per cycle."""
    return tokens.cpu().numpy()


def _percentile(sorted_vals: List[float], q: float) -> float:
    """Linear-interpolated percentile of an already sorted list."""
    if len(sorted_vals) == 1:
        return sorted_vals[0]
    k = (len(sorted_vals) - 1) * q
    lo = int(k)
    hi = min(lo + 1, len(sorted_vals) - 1)
    return sorted_vals[lo] + (sorted_vals[hi] - sorted_vals[lo]) * (k - lo)


class GenerationRequest:
    """One submitted generation: the scheduler's work item AND the
    caller's handle (``stream()`` / ``result()`` / ``cancel()``)."""

    _ids = itertools.count()

    def __init__(self, prompt: np.ndarray, max_new_tokens: int, *,
                 do_sample: bool = False, temperature: float = 1.0,
                 eos_token_id: Optional[int] = None, pad_token_id: int = 0,
                 timeout: Optional[float] = None, tenant: str = "default",
                 lane: str = "interactive"):
        self.id = next(self._ids)
        self.tenant, self.lane = tenant, lane
        self.prompt = np.asarray(prompt, np.int32).reshape(-1)
        self.max_new_tokens = int(max_new_tokens)
        self.do_sample = bool(do_sample)
        self.temperature = float(temperature)
        self.eos_token_id = None if eos_token_id is None \
            else int(eos_token_id)
        self.pad_token_id = int(pad_token_id)
        self._preempted = False     # replay victims outrank the queue
        self.submitted_at = time.perf_counter()
        self.deadline = None if timeout is None \
            else self.submitted_at + float(timeout)
        # scheduler-side decode state
        self.tokens: List[int] = []     # generated so far (incl. EOS)
        self.emitted = 0
        self.last_token: Optional[int] = None
        # bucketed paged engines: known tokens still to go through the
        # decode step without emitting (a prefix hit's tail, a preempted
        # request's history); rebuilt at every admission
        self.replay: List[int] = []
        # chunked engines: the not-yet-fed feed tokens (prompt, plus the
        # generated history after a preemption), drained in budgeted
        # chunks; rebuilt at every admission
        self.pending_feed: List[int] = []
        self.trace = RequestTrace(self.id, t_submit=self.submitted_at,
                                  tenant=tenant, lane=lane)
        self._q: "queue.Queue" = queue.Queue()
        self._done = threading.Event()
        self.error: Optional[BaseException] = None
        self._cancelled = False

    # -- caller side -------------------------------------------------------
    def cancel(self) -> None:
        """Ask the scheduler to drop this request; queued requests are
        rejected at admission, active ones retire at the next cycle."""
        self._cancelled = True

    @property
    def cancelled(self) -> bool:
        return self._cancelled and not self._done.is_set()

    def stream(self):
        """Iterator of generated token ids, yielded as each is produced.
        Raises the terminal error after any tokens produced before it."""
        while True:
            item = self._q.get()
            if item is _DONE:
                return
            if isinstance(item, BaseException):
                raise item
            yield item

    def result(self, timeout: Optional[float] = None) -> np.ndarray:
        """Block until the request finishes; returns the full sequence
        ``[prompt_len + max_new_tokens]`` int32 with post-EOS positions
        filled with ``pad_token_id``."""
        if not self._done.wait(timeout):
            raise TimeoutError(
                f"request {self.id} not finished within {timeout}s")
        if self.error is not None:
            raise self.error
        pad = self.max_new_tokens - len(self.tokens)
        return np.concatenate([
            self.prompt, np.asarray(self.tokens, np.int32),
            np.full(pad, self.pad_token_id, np.int32)])

    def done(self) -> bool:
        return self._done.is_set()

    # -- scheduler side ----------------------------------------------------
    def expired(self, now: Optional[float] = None) -> bool:
        return self.deadline is not None \
            and (now or time.perf_counter()) > self.deadline

    def _emit(self, tok: int) -> None:
        now = time.perf_counter()
        if not self.trace.token_times:
            self.trace.mark("first_token", t=now)
        self.trace.stamp_token(now)
        self.tokens.append(tok)
        self.emitted += 1
        self.last_token = tok
        self._q.put(tok)

    def _finish(self, error: Optional[BaseException] = None) -> None:
        self.error = error
        if error is None:
            name = "finish"
        elif isinstance(error, RequestCancelled):
            name = "cancelled"
        elif isinstance(error, DeadlineExceeded):
            name = "deadline"
        else:
            name = "error"
        self.trace.mark(name,
                        **({} if error is None else {"error": repr(error)}))
        self._done.set()
        self._q.put(error if error is not None else _DONE)

    def __repr__(self):
        return (f"<GenerationRequest #{self.id} prompt={len(self.prompt)} "
                f"max_new={self.max_new_tokens} emitted={self.emitted}>")


class Scheduler:
    """The continuous-batching loop over a
    :class:`~.kv_pool.KVCachePool` or a :class:`~.paging.PagedKVPool`.
    Device work is delegated to engine-provided callables, so the policy
    here stays host-pure:

    * bucketed mode (the gather engines):
      ``do_prefill(request, slot, bucket) -> first token`` runs the
      bucket's prefill and writes the slot (a paged engine returns None
      on a prefix hit: no program ran, ``request.replay`` is armed);
      ``do_decode(slot_requests) -> [num_slots + 1] tensor`` runs ONE
      decode step over every slot and returns its next-token tensor
      un-fetched (garbage for free slots);
    * chunked mode (the fused engine): ``do_admit(request, slot)``
      reserves the slot's blocks and arms ``request.pending_feed``;
      ``do_chunked_step(slot_requests, plan) -> [num_slots + 1] tensor``
      runs ONE fused ragged launch with ``plan[slot]`` rows per slot;
    * ``do_copy(dst, src)`` — copy-on-write block copy (paged pools).

    The pair of callables given picks the mode (``do_prefill`` and
    ``do_decode`` are None in chunked mode); the pool's ``is_paged`` picks
    the layout. Admission is first come, first served: speculative steps
    (``do_spec_step``, ``spec_k``), the flight recorder (``recorder``) and
    weighted lanes (``lane_weights``) raise ``NotImplementedError``
    (ROADMAP Queue 1 item 2).
    """

    def __init__(self, pool, do_prefill: Optional[Callable] = None,
                 do_decode: Optional[Callable] = None, *,
                 max_queue: int = 128,
                 prefill_budget: Optional[int] = None,
                 do_copy: Optional[Callable] = None,
                 do_chunked_step: Optional[Callable] = None,
                 do_spec_step: Optional[Callable] = None, spec_k: int = 0,
                 recorder=None, lane_weights: Optional[Dict] = None,
                 do_admit: Optional[Callable] = None):
        if do_spec_step is not None or spec_k or recorder is not None \
                or lane_weights is not None:
            raise NotImplementedError(
                "speculative steps, the flight recorder and weighted lanes "
                "are not ported yet: ROADMAP.md Queue 1 item 2")
        if max_queue < 1:
            raise ValueError(f"max_queue must be >= 1, got {max_queue}")
        self._chunked = do_chunked_step is not None
        mode = (do_admit, do_chunked_step) if self._chunked \
            else (do_prefill, do_decode)
        other = (do_prefill, do_decode) if self._chunked else (do_admit,)
        if any(f is None for f in mode) or any(f is not None for f in other):
            raise ValueError(
                "pass do_prefill and do_decode (bucketed mode) or do_admit "
                "and do_chunked_step (chunked mode)")
        self._pool = pool
        self._do_prefill = do_prefill
        self._do_decode = do_decode
        self._do_admit = do_admit
        self._do_chunked = do_chunked_step
        self._do_copy = do_copy
        self._max_queue = int(max_queue)
        # chunked: prompt tokens fed per cycle (decode rows are never
        # charged); bucketed: bucket tokens prefilled per cycle while
        # slots decode (an idle pool admits unthrottled)
        self._prefill_budget = int(prefill_budget or pool.max_len)
        if self._prefill_budget < 1:
            raise ValueError(
                f"prefill_budget must be >= 1, got {self._prefill_budget}")
        self.prefill_chunks = 0          # chunk launches fed (slot-cycles)
        self.chunk_tokens = 0            # prompt tokens fed via chunks
        self.nonfinite_cycles = 0        # cycles whose logits held NaN/Inf
        self.preempts = 0                # requests evicted mid-flight
        self.steps = 0                   # decode steps or fused launches
        self.prefills = 0                # prefill programs run (bucketed)
        self.retired = 0
        self._ttft: deque = deque(maxlen=_RESERVOIR)
        self._tpot: deque = deque(maxlen=_RESERVOIR)
        self._queue: List[GenerationRequest] = []
        self._slots: Dict[int, GenerationRequest] = {}
        self._cond = threading.Condition()
        self._closing = False
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="paddle-torch-serving")
        self._thread.start()

    # -- producer side -----------------------------------------------------
    def submit(self, req: GenerationRequest) -> GenerationRequest:
        with self._cond:
            if self._closing:
                raise RuntimeError("GenerationEngine is closed")
            if len(self._queue) >= self._max_queue:
                raise QueueFullError(
                    f"admission queue is full ({self._max_queue} "
                    f"requests); retry after in-flight work drains")
            self._queue.append(req)
            self._cond.notify_all()
        return req

    def close(self, cancel_pending: bool = False) -> None:
        """Stop accepting work and DRAIN: every queued and in-flight
        request runs to completion before the loop exits (with
        ``cancel_pending`` queued requests are cancelled instead)."""
        with self._cond:
            self._closing = True
            if cancel_pending:
                for r in self._queue:
                    r.cancel()
            self._cond.notify_all()
        self._thread.join()

    @property
    def queue_depth(self) -> int:
        with self._cond:
            return len(self._queue)

    @property
    def active(self) -> int:
        return len(self._slots)

    def latency_summary(self) -> Dict[str, Optional[dict]]:
        """``{"ttft_ms": {...}, "tpot_ms": {...}}`` with count/p50/p95/p99
        over retired requests (None before any sample)."""
        def pct(vals) -> Optional[dict]:
            if not vals:
                return None
            s = sorted(vals)
            return {"count": len(s), "p50": _percentile(s, 0.5),
                    "p95": _percentile(s, 0.95),
                    "p99": _percentile(s, 0.99)}

        with self._cond:
            ttft, tpot = list(self._ttft), list(self._tpot)
        return {"ttft_ms": pct(ttft), "tpot_ms": pct(tpot)}

    # -- scheduler thread --------------------------------------------------
    def _loop(self) -> None:
        while True:
            with self._cond:
                while not self._closing and not self._queue \
                        and not self._slots:
                    self._cond.wait()
                if self._closing and not self._queue and not self._slots:
                    return
            try:
                self._sweep_queue()
                self._admit()
                if self._slots:
                    if self._chunked:
                        self._chunked_cycle()
                    else:
                        self._decode_cycle()
            except Exception as e:                      # noqa: BLE001
                # a step failure poisons the requests in flight, never
                # the loop: each caller gets the error (traceback
                # chained) and serving goes on
                _log.exception("serving cycle failed")
                self._fail_inflight(e)

    def _note_nonfinite(self, toks) -> None:
        """Read the logits-finite sentinel (element ``[num_slots]``)."""
        idx = self._pool.num_slots
        if toks.shape[0] > idx and bool(toks[idx]):
            self.nonfinite_cycles += 1

    def _fail_inflight(self, error: BaseException) -> None:
        for slot in list(self._slots):
            req = self._slots.pop(slot)
            self._pool.free(slot)
            err = RuntimeError(
                f"serving step failed for request {req.id}: {error!r}")
            err.__cause__ = error
            req._finish(err)
        # the step writes the pool (and a quantized pool's scales) in
        # place, so a failed step may have left them half-written: start
        # from zeros, zero scales and an empty cache
        self._pool.reset_data()

    def _sweep_queue(self) -> None:
        """Resolve cancelled / expired entries ANYWHERE in the queue."""
        now = time.perf_counter()
        with self._cond:
            live = []
            for r in self._queue:
                if r.cancelled:
                    r._finish(RequestCancelled(
                        f"request {r.id} cancelled while queued"))
                elif r.expired(now):
                    r._finish(DeadlineExceeded(
                        f"request {r.id} exceeded its deadline while "
                        f"queued"))
                else:
                    live.append(r)
            self._queue[:] = live

    def _select_next(self) -> int:
        """Index of the next admission candidate: a preempted replay
        victim first (it predates every queued arrival), else the FCFS
        head. Caller holds ``self._cond``."""
        for i, r in enumerate(self._queue):
            if r._preempted:
                return i
        return 0

    def _admit(self) -> None:
        decode_waiting = bool(self._slots)
        budget = self._prefill_budget
        while True:
            with self._cond:
                if not self._queue:
                    return
                idx = self._select_next()
                req = self._queue[idx]
                # a paged re-admission (after a preemption) re-feeds its
                # generated history; a dense one starts over
                feed_len = len(req.prompt) + (
                    len(req.tokens) if self._pool.is_paged else 0)
                bucket = None if self._chunked \
                    else self._pool.bucket_for(feed_len)
                if self._pool.is_paged and not self._pool.can_admit(feed_len):
                    return       # block pressure: wait for retirements
                if not self._chunked and decode_waiting \
                        and budget < bucket:
                    # this cycle's prefill budget is spent: decode the
                    # active slots first; the head keeps its place
                    return
                slot = self._pool.alloc()
                if slot is None:
                    return       # every slot busy: a cycle will retire
                self._queue.pop(idx)
                req._preempted = False
            try:
                ran = self._prefill(req, slot, bucket)
            except Exception as exc:                    # noqa: BLE001
                # the request is in neither the queue nor the slots:
                # fail it here (or its caller hangs), then let the loop
                # fail the rest
                self._slots.pop(slot, None)
                if self._pool.is_allocated(slot):
                    self._pool.free(slot)
                if not req.done():
                    err = RuntimeError(
                        f"serving step failed for request {req.id}: "
                        f"{exc!r}")
                    err.__cause__ = exc
                    req._finish(err)
                raise
            if ran:
                # a prefix hit ran no program, so it costs the cycle's
                # budget nothing
                budget -= bucket

    def _prefill(self, req: GenerationRequest, slot: int,
                 bucket: Optional[int]) -> bool:
        """Admit ``req`` into ``slot``. Returns whether a prefill
        program ran (chunked admission and a paged prefix hit run
        none)."""
        req.trace.mark("admitted", slot=slot, bucket=bucket,
                       feed=len(req.prompt) + len(req.tokens))
        if self._chunked:
            # blocks and pending_feed are the engine's bookkeeping; the
            # feed itself runs in chunks
            self._do_admit(req, slot)
            self._slots[slot] = req
            return False
        req.trace.mark("prefill_start", bucket=bucket)
        first = self._do_prefill(req, slot, bucket)
        req.trace.mark("prefill_end", bucket=bucket, ran=first is not None)
        if not self._pool.is_paged:
            # the first generated token lands at cache index `bucket`;
            # the slot's valid keys start past the bucket's left pad
            self._pool.set_slot(slot, pos=bucket,
                                lo=bucket - len(req.prompt))
        self._slots[slot] = req
        if first is None:
            return False         # prefix hit: the replay feeds the tail
        self.prefills += 1
        req._emit(int(first))
        if self._finished(req, int(first)):
            self._retire(slot)
        return True

    def _finished(self, req: GenerationRequest, tok: int) -> bool:
        return (req.eos_token_id is not None and tok == req.eos_token_id) \
            or req.emitted >= req.max_new_tokens

    def _retire(self, slot: int,
                error: Optional[BaseException] = None) -> None:
        req = self._slots.pop(slot)
        self._pool.free(slot)
        self.retired += 1
        with self._cond:
            if req.trace.ttft_ms is not None:
                self._ttft.append(req.trace.ttft_ms)
            if req.trace.tpot_ms is not None:
                self._tpot.append(req.trace.tpot_ms)
        req._finish(error)

    # -- memory pressure: preemption ---------------------------------------
    def _preempt_youngest(self) -> bool:
        """Evict the youngest active request to free its blocks. It is
        not failed: it re-enters the queue at the head and replays its
        own history on re-admission. Returns False when nothing is
        active."""
        if not self._slots:
            return False
        slot = max(self._slots, key=lambda s: self._slots[s].id)
        req = self._slots.pop(slot)
        self._pool.free(slot)
        req.replay = []                  # rebuilt at re-admission
        req.pending_feed = []
        req._preempted = True
        self.preempts += 1
        req.trace.mark("preempt", emitted=req.emitted)
        with self._cond:
            self._queue.insert(0, req)
            self._cond.notify_all()
        return True

    # -- bucketed decode -----------------------------------------------------
    def _prepare_paged(self) -> bool:
        """Before a paged decode step: every active slot must own a
        writable block at its position. Exhaustion preempts the youngest
        request (oldest first, so the youngest is the victim, never the
        beneficiary). Returns False when no slot survives."""
        for slot in sorted(self._slots, key=lambda s: self._slots[s].id):
            while slot in self._slots:
                try:
                    cow = self._pool.ensure_writable(slot)
                except PoolExhaustedError:
                    # the slot itself is active, so there is always a
                    # youngest to evict, possibly this slot
                    self._preempt_youngest()
                    continue
                if cow is not None:
                    self._do_copy(*cow)
                break
        return bool(self._slots)

    def _decode_cycle(self) -> None:
        """One decode step over every slot, then one fetch of the next
        tokens. A slot replaying known tokens feeds the next one and
        emits nothing until its replay drains."""
        if self._pool.is_paged and not self._prepare_paged():
            return
        active = dict(self._slots)
        toks = _fetch(self._do_decode(active))
        self.steps += 1
        self._note_nonfinite(toks)
        now = time.perf_counter()
        for slot, req in active.items():
            self._pool.advance(slot)
            if req.cancelled:
                self._retire(slot, RequestCancelled(
                    f"request {req.id} cancelled mid-generation"))
                continue
            if req.expired(now):
                self._retire(slot, DeadlineExceeded(
                    f"request {req.id} exceeded its deadline after "
                    f"{req.emitted} token(s)"))
                continue
            if req.replay:
                # this cycle fed one known token: its prediction is
                # dropped and the next known token queued
                req.last_token = req.replay.pop(0)
                if not req.replay:
                    req.trace.mark("replay_done", emitted=req.emitted)
                continue
            tok = int(toks[slot])
            req._emit(tok)
            if self._finished(req, tok):
                self._retire(slot)

    # -- chunked prefill ---------------------------------------------------
    def _chunk_plan(self) -> Dict[int, int]:
        """Rows each active slot contributes to this cycle's launch:
        decode slots always get 1 (never budget-charged); feeding slots
        split the prefill token budget FCFS by request age, and a slot
        whose share is 0 waits a cycle."""
        budget = self._prefill_budget
        plan: Dict[int, int] = {}
        for slot in sorted(self._slots,
                           key=lambda s: self._slots[s].id):
            req = self._slots[slot]
            if req.pending_feed:
                n = min(len(req.pending_feed), budget)
                budget -= n
                if n > 0:
                    plan[slot] = n
            else:
                plan[slot] = 1
        return plan

    def _prepare_chunked(self, plan: Dict[int, int]) -> Dict[int, int]:
        """Every planned slot must own writable blocks for its WHOLE row
        range this cycle. Exhaustion preempts the youngest request;
        evicted slots drop out of the plan."""
        for slot in sorted(plan, key=lambda s: self._slots[s].id
                           if s in self._slots else -1):
            while slot in self._slots and slot in plan:
                try:
                    cows = self._pool.ensure_writable_range(
                        slot, self._pool.slot_pos(slot) + plan[slot] - 1)
                except PoolExhaustedError as e:
                    # table swaps made before the failure need their
                    # copies now: a retry sees refcount-1 blocks
                    for cow in e.partial_cows:
                        self._do_copy(*cow)
                    self._preempt_youngest()
                    continue
                for cow in cows:
                    self._do_copy(*cow)
                break
        return {s: n for s, n in plan.items() if s in self._slots}

    def _chunked_cycle(self) -> None:
        """One fused ragged launch: budgeted prompt chunks mixed with
        every decode row, then one fetch of the next tokens."""
        plan = self._prepare_chunked(self._chunk_plan())
        if not plan:
            return
        active = {s: self._slots[s] for s in plan}
        toks = _fetch(self._do_chunked(active, plan))
        self.steps += 1
        self._note_nonfinite(toks)
        now = time.perf_counter()
        for slot, req in active.items():
            n = plan[slot]
            feeding = bool(req.pending_feed)
            self._pool.advance(slot, n)
            if feeding:
                del req.pending_feed[:n]
                self.prefill_chunks += 1
                self.chunk_tokens += n
                req.trace.mark("prefill_chunk", tokens=n,
                               remaining=len(req.pending_feed))
            if req.cancelled:
                self._retire(slot, RequestCancelled(
                    f"request {req.id} cancelled mid-generation"))
                continue
            if req.expired(now):
                self._retire(slot, DeadlineExceeded(
                    f"request {req.id} exceeded its deadline after "
                    f"{req.emitted} token(s)"))
                continue
            if feeding:
                if req.pending_feed:
                    continue             # mid-feed: row output ignored
                # final chunk landed: publish the written feed blocks,
                # then emit the token this same launch produced
                self._pool.register_prefix(slot, np.concatenate(
                    [req.prompt, np.asarray(req.tokens, np.int32)]))
                req.trace.mark("chunked_prefill_done",
                               emitted=req.emitted)
            tok = int(toks[slot])
            req._emit(tok)
            if self._finished(req, tok):
                self._retire(slot)
