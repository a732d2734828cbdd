"""Continuous-batching scheduler (counterpart of
``paddle_tpu/serving/scheduler.py``): admit, run one step, retire, every
cycle. Two modes, as the engine picks:

* **bucketed** (the dense and paged gather engines) — admission pops
  queued requests (preempted requests first, then weighted-fair, below)
  into free slots and
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
  With a speculative step (``do_spec_step``), each decoding slot feeds
  up to ``spec_k`` draft candidates as rows of the same launch instead
  of one: the accepted ones (and, after a rejection, one corrected
  token) are emitted, and the slot's position rolls back over the
  rejected rows.

Admission is WEIGHTED-FAIR over (lane, tenant) classes: deficit
round-robin credits each queued class ``quantum x lane weight`` feed
tokens a rotation (``interactive`` 4 : ``batch`` 1 by default), and a
class admits while its deficit covers its head request's feed. One
queued class is plain FCFS.

With a host tier on the paged pool (``serving/host_tier.py``), each cycle
first pumps the blocks released last cycle to the tier
(``PagedKVPool.tier_tick``) and starts the host-to-device promotions of
the queue front; a request whose prefix continues in the tier waits,
like a pending feed, until its promotion has landed, while the decode
slots keep running.

Finished (EOS / token budget), cancelled and expired requests free their
slot at once. A full queue raises :class:`QueueFullError` and an expired
request ends with :class:`DeadlineExceeded`, both carrying the queue
depth and an estimated wait (depth x the EWMA interval between
admissions, None before two admissions).

Observability: every request carries a :class:`~.tracing.RequestTrace`,
every cycle writes a record into the always-on
:class:`~.flight_recorder.FlightRecorder` (the sweep / admit / prefill /
dispatch / fetch breakdown, occupancy, queue depth, emitted tokens, the
speculative figures), which dumps itself when a cycle fails, and the
``serving/*`` counters and distributions of the monitor are fed as in
the JAX scheduler. Under an armed span session (``profiler.profile()``)
each cycle lands as a ``serving/cycle`` span with its ``serving/sweep``,
``serving/admit``, ``serving/prefill``, ``serving/decode_dispatch`` and
``serving/host_fetch`` children, the JAX scheduler's names and
categories at the same points; unarmed, each costs one check of a
module-level bool. Each cycle stamps a host-only ``serving/cycle`` mark
on the memory timeline (no device poll), a finished request exports its
lane into an armed session (``RequestTrace.export_spans``), and a cycle
that dies of ``torch.cuda.OutOfMemoryError`` leaves the memory
postmortem beside the flight recorder's dump.

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
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from ..framework.monitor import stat_add, stat_observe
from ..profiler import memory as _memory
from ..profiler import span as _prof
from .flight_recorder import FlightRecorder
from .paging import PoolExhaustedError
from .tracing import RequestTrace

__all__ = ["QueueFullError", "DeadlineExceeded", "RequestCancelled",
           "GenerationRequest", "Scheduler"]


class QueueFullError(RuntimeError):
    """The admission queue is at capacity — shed load and retry later.
    ``queue_depth`` (entries queued when the submit was refused) and
    ``est_wait_s`` (depth x the EWMA interval between admissions, None
    before two admissions) are stamped when it is raised."""

    def __init__(self, message: str = "", *,
                 queue_depth: Optional[int] = None,
                 est_wait_s: Optional[float] = None):
        super().__init__(message)
        self.queue_depth = queue_depth
        self.est_wait_s = est_wait_s


class DeadlineExceeded(TimeoutError):
    """The request's deadline passed before it finished (tokens produced
    before it were streamed); ``queue_depth``/``est_wait_s`` as
    ``QueueFullError``'s, stamped when it is raised."""

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


def _fetch(tokens):
    """THE one device-to-host copy of the serving loop: the step's token
    tensor (``[num_slots + 1]``, or a speculative step's ``[2S + S*K +
    1]``), once per cycle."""
    return tokens.cpu().numpy()


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
        # host-tier promotion: the ticket this request waits on, and
        # whether its admission was served through one (a host hit)
        self._promo_ticket = None
        self._tier_promoted = False
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
        self.first_token_at: Optional[float] = None
        self._last_token_at: Optional[float] = None
        self.trace = RequestTrace(self.id, t_submit=self.submitted_at,
                                  tenant=tenant, lane=lane)
        self._recorder: Optional[FlightRecorder] = None   # set at submit
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
        _prof.set_thread_name(
            f"stream consumer ({threading.current_thread().name})")
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
        if self.first_token_at is None:
            self.first_token_at = now
            stat_observe("serving/ttft_ms",
                         (now - self.submitted_at) * 1e3)
            self.trace.mark("first_token", t=now)
            if self._recorder is not None:
                self._recorder.record_event(self.id, "first_token", t=now)
        else:
            # one inter-token sample per decoded token after the first
            stat_observe("serving/tpot_ms",
                         (now - self._last_token_at) * 1e3)
        self._last_token_at = now
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
        if self._recorder is not None:
            self._recorder.record_event(
                self.id, name,
                meta=None if error is None else {"error": repr(error)})
            self._recorder.retire(self.trace)
        self.trace.export_spans()   # chrome-trace lane; no-op unarmed
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
      with ``do_spec_step(slot_requests, plan, spec) -> [2S + S*spec_k +
      1] tensor`` a cycle with decoding slots runs the speculative
      verify launch instead, ``spec[slot]`` candidate rows for each
      decoding slot: ``[accepted (S) | corrected token (S) | draft echo
      (S*spec_k) | logits-finite sentinel]``;
    * ``do_copy(dst, src)`` — copy-on-write block copy (paged pools).

    The pair of callables given picks the mode (``do_prefill`` and
    ``do_decode`` are None in chunked mode); the pool's ``is_paged`` picks
    the layout. ``recorder`` is the :class:`~.flight_recorder.
    FlightRecorder` the cycles and events go to (a fresh one by
    default). ``lane_weights`` overrides the lanes' admission weights
    (``interactive`` 4.0, ``batch`` 1.0; any other lane 1.0).
    """

    def __init__(self, pool, do_prefill: Optional[Callable] = None,
                 do_decode: Optional[Callable] = None, *,
                 max_queue: int = 128,
                 prefill_budget: Optional[int] = None,
                 do_copy: Optional[Callable] = None,
                 do_chunked_step: Optional[Callable] = None,
                 do_spec_step: Optional[Callable] = None, spec_k: int = 0,
                 recorder: Optional[FlightRecorder] = None,
                 lane_weights: Optional[Dict] = None,
                 do_admit: Optional[Callable] = None):
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
        self._spec = do_spec_step is not None
        self._spec_k = int(spec_k)
        if self._spec and not self._chunked:
            raise ValueError(
                "do_spec_step requires do_chunked_step: speculative "
                "verify rows ride the fused ragged launch")
        if self._spec and self._spec_k < 1:
            raise ValueError(f"spec_k must be >= 1, got {spec_k}")
        self._pool = pool
        self._do_prefill = do_prefill
        self._do_decode = do_decode
        self._do_admit = do_admit
        self._do_chunked = do_chunked_step
        self._do_spec = do_spec_step
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
        self.spec_cycles = 0             # cycles that verified >= 1 slot
        self.spec_proposed = 0           # draft tokens verified
        self.spec_accepted = 0           # draft tokens accepted
        self.nonfinite_cycles = 0        # cycles whose logits held NaN/Inf
        self.preempts = 0                # requests evicted mid-flight
        self.steps = 0                   # decode steps or fused launches
        self.prefills = 0                # prefill programs run (bucketed)
        self.recorder = recorder if recorder is not None \
            else FlightRecorder()
        self._cycle = 0
        self._rec: Optional[dict] = None   # the current cycle's record
        # EWMA of the interval between admissions: est_wait_s's evidence
        self._admit_stamp: Optional[float] = None
        self._admit_interval_s: Optional[float] = None
        self._queue: List[GenerationRequest] = []
        # weighted deficit round-robin over the queued (lane, tenant)
        # classes; deficits are capped (in _select_next) so an idle class
        # cannot bank credit and then monopolize admission
        self._lane_weights: Dict[str, float] = {
            "interactive": 4.0, "batch": 1.0}
        for lane, w in (lane_weights or {}).items():
            if float(w) <= 0:
                raise ValueError(f"lane weight must be > 0, got {lane}={w}")
            self._lane_weights[str(lane)] = float(w)
        self._wdrr_quantum = 32.0            # deficit tokens per weight
        self._deficit: Dict[Tuple[str, str], float] = {}
        self._rr: List[Tuple[str, str]] = []  # class rotation order
        self._slots: Dict[int, GenerationRequest] = {}
        self._cond = threading.Condition()
        self._closing = False
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="paddle-torch-serving")
        self._thread.start()

    # -- producer side -----------------------------------------------------
    def _est_wait_s(self, depth: int) -> Optional[float]:
        """Estimated queue wait for ``depth`` entries: depth x the EWMA
        interval between admissions (None before two admissions)."""
        if self._admit_interval_s is None:
            return None
        return depth * self._admit_interval_s

    def submit(self, req: GenerationRequest) -> GenerationRequest:
        _prof.set_thread_name(
            f"submitter ({threading.current_thread().name})")
        with self._cond:
            if self._closing:
                raise RuntimeError("GenerationEngine is closed")
            if len(self._queue) >= self._max_queue:
                stat_add("serving/queue_full")
                depth = len(self._queue)
                raise QueueFullError(
                    f"admission queue is full ({self._max_queue} "
                    f"requests); retry after in-flight work drains",
                    queue_depth=depth, est_wait_s=self._est_wait_s(depth))
            req._recorder = self.recorder
            # recorded before notify: the event ring never shows this
            # request admitted ahead of its own submit
            self.recorder.record_event(
                req.id, "submit", t=req.submitted_at,
                meta={"tenant": req.tenant, "lane": req.lane})
            self._queue.append(req)
            stat_observe("serving/queue_depth", len(self._queue))
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

    # -- scheduler thread --------------------------------------------------
    def _loop(self) -> None:
        _prof.set_thread_name("serving scheduler")
        while True:
            with self._cond:
                while not self._closing and not self._queue \
                        and not self._slots:
                    self._cond.wait()
                if self._closing and not self._queue and not self._slots:
                    return
            self._cycle += 1
            t0 = time.perf_counter()
            # the cycle record is always taken: host dicts, a bounded ring
            rec = self._rec = {
                "cycle": self._cycle, "t": t0, "sweep_ms": 0.0,
                "admit_ms": 0.0, "prefill_ms": 0.0,
                "decode_dispatch_ms": 0.0, "fetch_ms": 0.0,
                "admitted": [], "retired": [], "emitted": 0,
                "preempts": 0, "active": 0, "occupancy": 0.0,
                "promo_waits": 0, "promoted_blocks": 0,
            }
            failed = None
            tier = getattr(self._pool, "host_tier", None)
            try:
                with _prof.record("serving/cycle", "serving",
                                  args={"cycle": self._cycle}):
                    t = time.perf_counter()
                    with _prof.record("serving/sweep", "serving"):
                        self._sweep_queue()
                    rec["sweep_ms"] = (time.perf_counter() - t) * 1e3
                    if tier is not None:
                        # blocks released last cycle spill before this
                        # cycle's admissions can evict them, and the
                        # queue front's promotions start while the slots
                        # decode
                        self._pool.tier_tick()
                        self._prefetch_promotions()
                    t = time.perf_counter()
                    with _prof.record("serving/admit", "serving"):
                        self._admit()
                    rec["admit_ms"] = (time.perf_counter() - t) * 1e3
                    if self._slots:
                        if self._chunked:
                            self._chunked_cycle()
                        else:
                            self._decode_cycle()
                    elif rec["promo_waits"]:
                        # nothing decodes and the queue only waits on
                        # promotions: nap on the tier's progress beacon
                        # (a host event) instead of spinning. With slots
                        # active this never runs: decode never waits on
                        # a copy.
                        tier.wait_progress(0.002)
            except Exception as e:                      # noqa: BLE001
                # a step failure poisons the requests in flight, never
                # the loop: each caller gets the error (traceback
                # chained) and serving goes on
                _log.exception("serving cycle failed")
                failed = e
                self._fail_inflight(e)
            finally:
                with self._cond:
                    rec["queue_depth"] = len(self._queue)
                if self._pool.is_paged:
                    rec["blocks_in_use"] = self._pool.blocks_in_use
                if failed is not None:
                    rec["failed"] = repr(failed)
                rec["cycle_ms"] = (time.perf_counter() - t0) * 1e3
                stat_observe("serving/cycle_ms", rec["cycle_ms"])
                self.recorder.record_cycle(rec)
                # a memory watermark per cycle: host-only (the ledger
                # total, no device poll — polling is the sampler's)
                _memory.mark("serving/cycle", cycle=self._cycle,
                             active=rec["active"])
                self._rec = None
                if failed is not None:
                    # the postmortem: the rings, this cycle included
                    self.recorder.auto_dump(reason=repr(failed))
                    if _memory.is_resource_exhausted(failed):
                        # out of device memory: the memory picture
                        # (ledger, timeline, largest live tensors) lands
                        # beside the recorder's dump; the original error
                        # is already on its way to every failed request
                        _memory.oom_postmortem(failed, extra={
                            "phase": "serving.scheduler",
                            "cycle": self._cycle,
                            "flight_recorder":
                                self.recorder.last_dump_path})

    def _note_nonfinite(self, toks, rec, idx: Optional[int] = None) -> None:
        """Read the logits-finite sentinel: element ``[num_slots]`` of the
        fetched row, or ``idx`` (the speculative layout's, past the draft
        echo). A tripped flag counts the cycle and marks its record."""
        idx = self._pool.num_slots if idx is None else int(idx)
        if toks.shape[0] > idx and bool(toks[idx]):
            self.nonfinite_cycles += 1
            stat_add("serving/nonfinite_cycles")
            if rec is not None:
                rec["nonfinite"] = True

    def note_decode_flops(self, flops: float) -> None:
        """Record the counted FLOPs of the step run THIS cycle into the
        live cycle record (the engine calls it, on the scheduler
        thread): ``cycle_throughput`` sums them beside the cycle wall
        times, so ``stats()``'s achieved FLOP/s keeps one window."""
        if self._rec is not None:
            self._rec["decode_flops"] = \
                self._rec.get("decode_flops", 0.0) + float(flops)

    def note_spec_dispatches(self, n: int) -> None:
        """Count the draft-proposal calls made THIS cycle into its record
        (the engine's speculative step calls it, on the scheduler
        thread): the whole proposal chain is one call, so each
        speculative cycle should record 1."""
        if self._rec is not None:
            self._rec["spec_draft_dispatches"] = \
                self._rec.get("spec_draft_dispatches", 0) + int(n)

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

    def _deadline(self, req: GenerationRequest, where: str,
                  depth: int) -> DeadlineExceeded:
        stat_add("serving/deadline_exceeded")
        return DeadlineExceeded(
            f"request {req.id} exceeded its deadline {where}",
            queue_depth=depth, est_wait_s=self._est_wait_s(depth))

    def _sweep_queue(self) -> None:
        """Resolve cancelled / expired entries ANYWHERE in the queue."""
        now = time.perf_counter()
        with self._cond:
            live = []
            for r in self._queue:
                if r.cancelled:
                    self._drop_ticket(r)
                    stat_add("serving/cancelled")
                    r._finish(RequestCancelled(
                        f"request {r.id} cancelled while queued"))
                elif r.expired(now):
                    self._drop_ticket(r)
                    r._finish(self._deadline(r, "while queued",
                                             len(self._queue)))
                else:
                    live.append(r)
            if len(live) != len(self._queue):
                self._queue[:] = live
                stat_observe("serving/queue_depth", len(live))

    def _select_next(self, skip=frozenset()) -> int:
        """Index into the queue of the next admission candidate (caller
        holds ``self._cond``); requests whose id is in ``skip`` (this
        cycle's promotion-waiters) are invisible, and -1 means nothing
        else is queued. A preempted replay victim comes first (it
        predates every queued arrival). Else weighted deficit round-robin
        over the queued (lane, tenant) classes: the class at the rotation
        head admits its FCFS head while its deficit covers that request's
        feed, else it is credited ``quantum x lane weight`` and the
        rotation moves on. One queued class is its FCFS head."""
        q = self._queue
        for i, r in enumerate(q):
            if r._preempted and r.id not in skip:
                return i
        heads: Dict[Tuple[str, str], int] = {}
        for i, r in enumerate(q):
            if r.id not in skip:
                heads.setdefault((r.lane, r.tenant), i)
        if len(heads) <= 1:
            return next(iter(heads.values()), -1)
        # keep the rotation stable across calls; retire dead classes
        self._rr = [k for k in self._rr if k in heads]
        for k in heads:
            if k not in self._rr:
                self._rr.append(k)
                self._deficit.setdefault(k, 0.0)
        # the cap must exceed any admissible feed (bounded by max_len at
        # submit) or a fat head could starve its own class
        cap = max(2.0 * self._pool.max_len, 8.0 * self._wdrr_quantum)
        for _ in range(10_000):
            k = self._rr[0]
            head = q[heads[k]]
            cost = float(max(1, len(head.prompt) + len(head.tokens)))
            if self._deficit.get(k, 0.0) >= cost:
                self._deficit[k] -= cost
                return heads[k]
            w = self._lane_weights.get(k[0], 1.0)
            self._deficit[k] = min(
                self._deficit.get(k, 0.0) + self._wdrr_quantum * w, cap)
            self._rr.append(self._rr.pop(0))
        return heads[self._rr[0]]     # unreachable: cap >= any cost

    # -- host-tier promotions ----------------------------------------------
    def _drop_ticket(self, req: GenerationRequest) -> None:
        """Release a dead waiter's promotion ticket, so the tier's
        registry (and the staged device copy it holds) does not outlive
        the request. A ticket another waiter shares survives: adoption
        by that waiter still works."""
        tk, req._promo_ticket = req._promo_ticket, None
        tier = getattr(self._pool, "host_tier", None)
        if tk is not None and tier is not None:
            tier.ticket_done(tk)

    def _prefetch_promotions(self) -> None:
        """Start (or poll) the promotions of the queue's first two live
        requests while every decode slot is still busy, so a host chain
        is on its way before a slot frees up. Adoption waits for the
        admission, which adopts and references the blocks in one step:
        adopted now, they would sit refcount-0 in a pressured pool for
        the next fresh admission to evict."""
        with self._cond:
            head = [r for r in self._queue if not r.cancelled][:2]
            for req in head:
                self._promotion_state(req, adopt=False)

    def _promotion_state(self, req: GenerationRequest,
                         adopt: bool = True) -> str:
        """Drive ``req``'s promotion (caller holds ``_cond``; scheduler
        thread): ``"go"`` — admit now (no host chain, the engine would
        not take the hit, the tier shed the promotion, or the staged
        blocks were just adopted) — or ``"wait"`` — its host-to-device
        copy has not landed yet (``ticket.landed()`` reads the copy's
        event without blocking)."""
        pool = self._pool
        tk = req._promo_ticket
        if tk is not None:
            if not tk.landed():
                return "wait"
            if not adopt:
                return "go"     # staged; admission adopts and refs
            req._promo_ticket = None
            if pool.adopt_promotion(tk):
                req._tier_promoted = True
                if self._rec is not None:
                    self._rec["promoted_blocks"] += len(tk.staged_keys)
            return "go"         # a failed ticket is a plain miss
        feed = np.concatenate(
            [req.prompt, np.asarray(req.tokens, np.int32)])
        host_keys, covered = pool.tier_match(feed)
        if not host_keys:
            return "go"
        if not self._chunked and feed.size - covered > pool.min_bucket:
            # the gather engine prefills fresh past a min_bucket tail
            # anyway: waiting on a promotion would only add latency
            return "go"
        tk = pool.host_tier.request_promotion(host_keys)
        if tk is None:
            return "go"         # the tier shed it: a plain miss
        req._promo_ticket = tk
        return "wait"

    def _admit(self) -> None:
        decode_waiting = bool(self._slots)
        budget = self._prefill_budget
        tiered = getattr(self._pool, "host_tier", None) is not None
        skip: set = set()       # promotion-waiters sit out this cycle
        while True:
            with self._cond:
                if not self._queue:
                    return
                # a promotion that has landed admits ahead of the fair
                # rotation: it runs no prefill, and a fresh prefill ahead
                # of it would give back what the tier saved. So does a
                # chain adopted on an earlier pass that then met a
                # capacity gate (its blocks sit refcount-0, evictable).
                idx = next((i for i, r in enumerate(self._queue)
                            if r.id not in skip and (
                                r._promo_ticket.landed()
                                if r._promo_ticket is not None
                                else r._tier_promoted)), -1)
                if idx < 0:
                    idx = self._select_next(skip)
                if idx < 0:
                    return      # only promotion-waiters are queued
                req = self._queue[idx]
                # the head may have been cancelled or expired since the
                # sweep
                if req.cancelled:
                    self._queue.pop(idx)
                    self._drop_ticket(req)
                    stat_add("serving/cancelled")
                    req._finish(RequestCancelled(
                        f"request {req.id} cancelled while queued"))
                    continue
                if req.expired():
                    self._queue.pop(idx)
                    self._drop_ticket(req)
                    req._finish(self._deadline(req, "while queued",
                                               len(self._queue)))
                    continue
                if tiered and self._promotion_state(req) == "wait":
                    if self._rec is not None:
                        self._rec["promo_waits"] += 1
                    tk = req._promo_ticket
                    if tk is not None and \
                            time.perf_counter() - tk.created_at < 0.05:
                        # hold the line while the copy is young (it lands
                        # within a cycle or two); past 50 ms a wedged
                        # promoter no longer holds the queue back
                        return
                    skip.add(req.id)
                    continue
                # a paged re-admission (after a preemption) re-feeds its
                # generated history; a dense one starts over
                feed_len = len(req.prompt) + (
                    len(req.tokens) if self._pool.is_paged else 0)
                bucket = None if self._chunked \
                    else self._pool.bucket_for(feed_len)
                if self._pool.is_paged and not self._pool.can_admit(feed_len):
                    return       # block pressure: wait for retirements
                if not self._chunked and decode_waiting \
                        and budget < bucket and not req._tier_promoted:
                    # this cycle's prefill budget is spent: decode the
                    # active slots first; the head keeps its place (an
                    # adopted promotion is a sure prefix hit that runs no
                    # prefill, so the budget does not hold it back)
                    stat_add("serving/preempt")
                    return
                slot = self._pool.alloc()
                if slot is None:
                    return       # every slot busy: a cycle will retire
                self._queue.pop(idx)
                req._preempted = False
                now = time.perf_counter()
                if self._admit_stamp is not None:
                    dt = now - self._admit_stamp
                    self._admit_interval_s = dt \
                        if self._admit_interval_s is None \
                        else 0.8 * self._admit_interval_s + 0.2 * dt
                self._admit_stamp = now
                stat_observe("serving/queue_depth", len(self._queue))
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

    def _event(self, req: GenerationRequest, name: str, **meta) -> None:
        """One lifecycle event, stamped once into the request's trace and
        the flight recorder's event ring."""
        t = time.perf_counter()
        req.trace.mark(name, t=t, **meta)
        self.recorder.record_event(req.id, name, t=t, meta=meta or None)

    def _prefill(self, req: GenerationRequest, slot: int,
                 bucket: Optional[int]) -> bool:
        """Admit ``req`` into ``slot``. Returns whether a prefill
        program ran (chunked admission and a paged prefix hit run
        none)."""
        wait_ms = (time.perf_counter() - req.submitted_at) * 1e3
        stat_observe("serving/lane_wait_ms", wait_ms)
        self._event(req, "admitted", slot=slot, bucket=bucket,
                    feed=len(req.prompt) + len(req.tokens),
                    tenant=req.tenant, lane=req.lane,
                    wait_ms=round(wait_ms, 3))
        if self._rec is not None:
            self._rec["admitted"].append(req.id)
        req.trace.mark("prefill_start", bucket=bucket)
        if self._chunked:
            # blocks and pending_feed are the engine's bookkeeping; the
            # feed itself runs in chunks
            with _prof.record("serving/prefill", "serving",
                              args={"bucket": bucket, "slot": slot}):
                self._do_admit(req, slot)
            req.trace.mark("prefill_end", bucket=bucket, ran=False)
            self._slots[slot] = req
            return False
        t0 = time.perf_counter()
        with _prof.record("serving/prefill", "serving",
                          args={"bucket": bucket, "slot": slot}):
            first = self._do_prefill(req, slot, bucket)
        if self._rec is not None:
            self._rec["prefill_ms"] += (time.perf_counter() - t0) * 1e3
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
        stat_add("serving/prefill_tokens", bucket)
        req._emit(int(first))
        stat_add("serving/tokens")
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
        if error is None:
            stat_add("serving/completed")
        if self._rec is not None:
            self._rec["retired"].append(req.id)
        req._finish(error)

    def _end_early(self, slot: int, req: GenerationRequest, now) -> bool:
        """Retire a cancelled or expired active request; True if it
        was."""
        if req.cancelled:
            stat_add("serving/cancelled")
            self._retire(slot, RequestCancelled(
                f"request {req.id} cancelled mid-generation"))
            return True
        if req.expired(now):
            self._retire(slot, self._deadline(
                req, f"after {req.emitted} token(s)", len(self._queue)))
            return True
        return False

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
        req._tier_promoted = False       # re-classified at re-admission
        self.preempts += 1
        self._event(req, "preempt", emitted=req.emitted)
        if self._rec is not None:
            self._rec["preempts"] += 1
        stat_add("serving/preempt")
        with self._cond:
            self._queue.insert(0, req)
            stat_observe("serving/queue_depth", len(self._queue))
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

    def _note_occupancy(self, n: int) -> None:
        occupancy = n / self._pool.num_slots
        stat_observe("serving/active_slots", n)
        stat_observe("serving/batch_occupancy", occupancy)
        if self._rec is not None:
            self._rec["active"] = n
            self._rec["occupancy"] = occupancy

    def _dispatch(self, fn, *args, span_args=None):
        """Run a step and fetch its tokens, timing the dispatch and the
        fetch apart into the cycle record (and into the
        ``serving/decode_dispatch`` and ``serving/host_fetch`` spans).
        Returns (tokens, seconds)."""
        t0 = time.perf_counter()
        with _prof.record("serving/decode_dispatch", "serving",
                          args=span_args):
            toks_dev = fn(*args)
        t1 = time.perf_counter()
        with _prof.record("serving/host_fetch", "serving"):
            toks = _fetch(toks_dev)
        t2 = time.perf_counter()
        self.steps += 1
        if self._rec is not None:
            self._rec["decode_dispatch_ms"] += (t1 - t0) * 1e3
            self._rec["fetch_ms"] += (t2 - t1) * 1e3
        return toks, t2 - t0

    def _decode_cycle(self) -> None:
        """One decode step over every slot, then one fetch of the next
        tokens. A slot replaying known tokens feeds the next one and
        emits nothing until its replay drains."""
        if self._pool.is_paged and not self._prepare_paged():
            return
        active = dict(self._slots)
        self._note_occupancy(len(active))
        rec = self._rec
        toks, dt = self._dispatch(self._do_decode, active,
                                  span_args={"active": len(active)})
        self._note_nonfinite(toks, rec)
        emitted = 0
        now = time.perf_counter()
        for slot, req in active.items():
            self._pool.advance(slot)
            if self._end_early(slot, req, now):
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
            emitted += 1
            if self._finished(req, tok):
                self._retire(slot)
        stat_add("serving/tokens", emitted)
        if rec is not None:
            rec["emitted"] += emitted
        if dt > 0:
            stat_observe("serving/tokens_per_sec", emitted / dt)

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

    def _spec_plan(self, plan: Dict[int, int]) -> Dict[int, int]:
        """Speculative rows: every DECODING slot (feed drained) verifies
        ``min(spec_k, tokens it may still emit)`` candidates instead of
        feeding 1 row, and emits up to that many tokens this cycle;
        feeding slots keep their chunks. Updates ``plan`` (so the
        writable blocks cover the candidate rows) and returns ``{slot:
        n_candidates}``."""
        spec: Dict[int, int] = {}
        for slot in list(plan):
            req = self._slots[slot]
            if req.pending_feed:
                continue
            k = min(self._spec_k, req.max_new_tokens - req.emitted)
            plan[slot] = spec[slot] = max(1, k)
        return spec

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
        every decode row, then one fetch. Real tokens come out for
        decode slots and for slots whose final chunk landed this cycle;
        mid-feed rows are ignored. With speculation, decoding slots feed
        their draft candidates and the launch returns ``[accepted |
        corrected | draft echo | sentinel]``: the accepted candidates
        (and a corrected token after a rejection) are emitted, the
        slot's position rolls back over the rejected rows (a negative
        ``advance``) and any prefix-cache registration they touched is
        dropped."""
        plan = self._chunk_plan()
        spec = self._spec_plan(plan) if self._spec else {}
        plan = self._prepare_chunked(plan)
        spec = {s: n for s, n in spec.items() if s in plan}
        if not plan:
            return
        active = {s: self._slots[s] for s in plan}
        self._note_occupancy(len(self._slots))
        rec = self._rec
        span_args = {"active": len(active), "spec_slots": len(spec),
                     "chunk_rows": sum(n for s, n in plan.items()
                                       if active[s].pending_feed)}
        if spec:
            toks, dt = self._dispatch(self._do_spec, active, plan, spec,
                                      span_args=span_args)
        else:
            toks, dt = self._dispatch(self._do_chunked, active, plan,
                                      span_args=span_args)
        S = self._pool.num_slots
        K = self._spec_k
        if spec:
            # [accepted (S) | corrected (S) | draft echo (S*K) | sentinel]
            acc_row = toks[:S]
            corr_row = toks[S:2 * S]
            draft_rows = toks[2 * S:2 * S + S * K].reshape(S, K)
            self._note_nonfinite(toks, rec, idx=2 * S + S * K)
        else:
            self._note_nonfinite(toks, rec)
        emitted = chunks = chunk_tokens = 0
        spec_accepted = spec_proposed = spec_emitted = 0
        now = time.perf_counter()
        for slot, req in active.items():
            n = plan[slot]
            feeding = bool(req.pending_feed)
            self._pool.advance(slot, n)
            if feeding:
                # accounted before the terminal checks, so a cancel
                # mid-feed leaves the chunk counted
                del req.pending_feed[:n]
                chunks += 1
                chunk_tokens += n
                self.prefill_chunks += 1
                self.chunk_tokens += n
                stat_add("serving/prefill_chunks")
                stat_add("serving/chunk_tokens", n)
                req.trace.mark("prefill_chunk", tokens=n,
                               remaining=len(req.pending_feed))
            elif slot in spec:
                # keep the longest agreeing prefix plus, after a
                # rejection, one corrected token; roll the position back
                # over the dead rows and unpublish what they touched
                a = min(int(acc_row[slot]), n)
                cov = a + 1 if a < n else n
                if cov < n:
                    self._pool.advance(slot, cov - n)
                    self._pool.unpublish_from(
                        slot, self._pool.slot_pos(slot))
                spec_proposed += n
                spec_accepted += a
                self.spec_proposed += n
                self.spec_accepted += a
                stat_add("serving/spec_proposed", n)
                stat_add("serving/spec_accept", a)
                req.trace.mark("spec_verify", proposed=n, accepted=a)
            if self._end_early(slot, req, now):
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
            if slot in spec and not feeding:
                a = min(int(acc_row[slot]), n)
                emit = [int(t) for t in draft_rows[slot, :a]]
                if a < n:
                    emit.append(int(corr_row[slot]))
                slot_emitted = 0
                for tok in emit:
                    req._emit(tok)
                    emitted += 1
                    slot_emitted += 1
                    if self._finished(req, tok):
                        self._retire(slot)
                        break
                spec_emitted += slot_emitted
                stat_observe("serving/spec_tokens_per_cycle", slot_emitted)
                continue
            tok = int(toks[S + slot] if spec else toks[slot])
            req._emit(tok)
            emitted += 1
            if self._finished(req, tok):
                self._retire(slot)
        if spec:
            self.spec_cycles += 1
            stat_add("serving/spec_cycles")
        stat_add("serving/tokens", emitted)
        if rec is not None:
            rec["emitted"] += emitted
            rec["prefill_chunks"] = rec.get("prefill_chunks", 0) + chunks
            rec["chunk_tokens"] = rec.get("chunk_tokens", 0) + chunk_tokens
            if spec:
                rec["spec_proposed"] = spec_proposed
                rec["spec_accepted"] = spec_accepted
                rec["spec_emitted"] = spec_emitted
                rec["spec_slots"] = len(spec)
        if dt > 0 and emitted:
            stat_observe("serving/tokens_per_sec", emitted / dt)
