"""Host-DRAM tier for the paged prefix cache (counterpart of
``paddle_tpu/serving/host_tier.py``).

The prefix trie (``paging.py``) is bounded by the device pool: a block
the LRU evicts dies, and its prefill is paid again on the next hit.
:class:`HostBlockPool` gives such blocks a second life in a bounded host
store, keyed by the same exact token-prefix tuples as the trie.

The pool's steps write K/V IN PLACE, so (unlike the JAX tier, whose
gathered array is an immutable value) every copy here is ordered by CUDA
streams and events:

* **demotion (device to host)** — ``PagedKVPool.tier_tick`` runs on the
  scheduler thread and gathers the blocks that just went refcount-0 into
  a fresh device tensor on the current stream, where the steps' kernels
  launch: the gather is ordered before the next step's in-place writes.
  :meth:`HostBlockPool.spill` records an event after it and queues the
  gather for the SPILLER thread, whose copy stream waits on that event,
  copies into rows of the pinned arena with ``non_blocking=True``, and
  synchronises its own event. The queue item keeps the gathered tensor
  referenced until that copy has ended.
* **promotion (host to device)** — a prefix hit on a demoted chain
  makes a :class:`PromotionTicket`; the PROMOTER thread copies the chain's
  arena rows into a staging tensor on a side stream
  (``torch.cuda.Stream()``, which does not synchronise with the default
  stream) and records an event. The scheduler reads the event with
  ``query()`` (``PromotionTicket.landed``), never blocking, and
  ``PagedKVPool.adopt_promotion`` makes the current stream wait on it
  before copying the staged blocks (and scales) into freshly allocated
  pool blocks. The arena rows stay pinned against reuse until the
  promoter has seen its copy land.

No host synchronisation happens on the scheduler thread: decode cycles
never wait on a copy. The arena of ``capacity_bytes`` is allocated at
construction, pinned when the tier stages to a card (a copy from
pageable memory would be synchronous).

Content-canonical invariant: every device write path copies on write or
unregisters the trie key first, so a published key's block content is a
function of the key. A host copy filed under a key can be adopted at any
later time, bit-identical to a block never evicted (float pools, and
int8/fp8 pools with their per-(layer, K/V, block, head) scales).

Nothing on the serving path raises: a full spill queue drops the
demotion, a busy promoter sheds to a plain miss, a failed copy is
dropped (``serving/tier_degraded`` counts each). The named errors fire
only on misuse (an entry larger than the tier, a closed tier). The
tier's bytes are in the memory ledger (``profiler/memory.py``) under
``host/<name>/capacity`` and ``.../in_use``, which ``crosscheck()``
reports apart from the device's, in :meth:`HostBlockPool.stats` and in
the engine's registry collector.

Threading: ``spill``/``request_promotion``/``has``/``get`` run on the
scheduler thread; the spiller and promoter threads touch the store under
``_lock`` plus their queues.
"""
from __future__ import annotations

import contextlib
import itertools
import queue
import threading
import time
import weakref
from collections import OrderedDict, deque
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .._device import resolve_device
from ..framework import metrics as _metrics
from ..framework.monitor import _percentile, stat_add, stat_observe
from ..profiler import memory as _memory

__all__ = ["HostBlockPool", "PromotionTicket", "HostTierError",
           "HostTierFullError"]

_tier_ids = itertools.count(1)


def _drop_tier_ledger(ledger_key: str) -> None:
    """weakref.finalize target — a module function so the finalizer
    holds no reference to the tier."""
    _memory.ledger_drop(f"{ledger_key}/capacity")
    _memory.ledger_drop(f"{ledger_key}/in_use")

_END = object()                      # queue sentinel


class HostTierError(RuntimeError):
    """Host-tier misuse (operating a closed tier, a malformed entry)."""


class HostTierFullError(HostTierError):
    """A single entry exceeds the tier's whole capacity: a configuration
    error (pressure is answered by the tier's own LRU eviction)."""


class PromotionTicket:
    """One in-flight host-to-device promotion of a chain of demoted
    blocks. Made by ``request_promotion`` (scheduler thread), staged by
    the promoter thread (``staged`` ``[n, L, 2, H, bs, Dh]`` and
    ``staged_scales`` ``[n, L, 2, H]`` on the device, ``event`` after
    their copy, then ``ready`` is set), adopted once by
    ``PagedKVPool.adopt_promotion`` (scheduler thread)."""

    __slots__ = ("keys", "staged_keys", "staged", "staged_scales",
                 "ready", "failed", "adopted", "created_at", "staged_at",
                 "event")

    def __init__(self, keys: List[Tuple[int, ...]]):
        self.keys = list(keys)           # requested chain, root-first
        self.staged_keys: List[Tuple[int, ...]] = []
        self.staged = None
        self.staged_scales = None
        self.ready = threading.Event()
        self.failed = False
        self.adopted = False
        self.created_at = time.perf_counter()
        self.staged_at: Optional[float] = None
        self.event = None                # the copy's CUDA event, or None

    def landed(self) -> bool:
        """Whether the chain is staged and its copy has completed, read
        without blocking (a CPU stage copies synchronously and has no
        event)."""
        return self.ready.is_set() and (self.event is None
                                        or self.event.query())


def _runs(pairs):
    """Maximal runs of ``(a, b)`` index pairs in which both step by one,
    as ``[a0, b0, length]``: a chain in consecutive arena rows moves in
    one copy."""
    out: List[List[int]] = []
    for a, b in pairs:
        if out and a == out[-1][0] + out[-1][2] \
                and b == out[-1][1] + out[-1][2]:
            out[-1][2] += 1
        else:
            out.append([a, b, 1])
    return out


def _ring_summary(ring) -> dict:
    vals = sorted(ring)
    if not vals:
        return {"count": 0}
    return {"count": len(vals), "p50": _percentile(vals, 0.5),
            "p95": _percentile(vals, 0.95)}


def _mark(stream):
    """A point in time: a timing event recorded on ``stream`` (the card)
    or the host clock (``stream`` None, the CPU)."""
    if stream is None:
        return time.perf_counter()
    ev = torch.cuda.Event(enable_timing=True)
    ev.record(stream)
    return ev


def _elapsed_ms(start, done) -> float:
    """Milliseconds between two marks; waits for ``done`` on the card."""
    if isinstance(start, float):
        return (done - start) * 1e3
    done.synchronize()
    return start.elapsed_time(done)


class HostBlockPool:
    """Bounded host store of demoted KV blocks, keyed by exact
    token-prefix tuples. ``block_nbytes``/``scale_nbytes`` are the host
    bytes of one block and of its scale row (``PagedKVPool.
    host_block_nbytes``/``host_scale_nbytes``); ``capacity_bytes`` fixes
    how many such entries the arena holds. ``device`` is where
    promotions stage (``None`` = the card; ``"cpu"`` copies
    synchronously into an arena that is not pinned)."""

    def __init__(self, capacity_bytes: int, block_nbytes: int, *,
                 scale_nbytes: int = 0, name: Optional[str] = None,
                 spill_depth: int = 4, promote_depth: int = 2,
                 device=None):
        if capacity_bytes < 1:
            raise ValueError(
                f"capacity_bytes must be >= 1, got {capacity_bytes}")
        if block_nbytes < 1:
            raise ValueError(
                f"block_nbytes must be >= 1, got {block_nbytes}")
        self.capacity_bytes = int(capacity_bytes)
        self.block_nbytes = int(block_nbytes)
        self.scale_nbytes = int(scale_nbytes)
        self.entry_nbytes = self.block_nbytes + self.scale_nbytes
        if self.entry_nbytes > self.capacity_bytes:
            raise HostTierFullError(
                f"one block+scale entry is {self.entry_nbytes} bytes but "
                f"host_tier capacity is only {self.capacity_bytes} — the "
                f"tier could never hold a single block")
        self.name = name or f"serving/host_tier#{next(_tier_ids)}"
        self.device = resolve_device(device)
        self._cuda = self.device.type == "cuda"
        # one row of entry_nbytes a block: the block's bytes, then its
        # scale row's
        self._arena = torch.empty(
            (self.capacity_blocks, self.entry_nbytes), dtype=torch.uint8,
            pin_memory=self._cuda)
        # popped from the end: rows go out in ascending order, so a
        # chain demoted together lands in consecutive rows
        self._free_rows: List[int] = list(
            range(self.capacity_blocks - 1, -1, -1))
        self._pins: Dict[int, int] = {}  # row -> promotions reading it
        # (block dtype, block shape, scale shape), fixed by the first entry
        self._layout: Optional[tuple] = None
        self._store: "OrderedDict[Tuple[int, ...], int]" = OrderedDict()
        self._lock = threading.Lock()
        self._tickets: Dict[Tuple[int, ...], PromotionTicket] = {}
        # set on every ticket completion, so a scheduler with nothing to
        # decode and only promotion-waiters queued can nap
        self._progress = threading.Event()
        self._closed = False
        self.demoted_blocks = 0
        self.promoted_blocks = 0
        self.dropped_blocks = 0          # demotions dropped (queue/copy)
        self.tier_evictions = 0          # host-LRU capacity evictions
        self.promo_shed = 0              # promotions shed (promoter busy)
        self._promo_ms: "deque[float]" = deque(maxlen=512)
        self._demo_ms: "deque[float]" = deque(maxlen=512)
        # host ledger (host/ prefix: crosscheck() keeps these out of the
        # device's explained bytes)
        self.ledger_key = f"host/{self.name}"
        weakref.finalize(self, _drop_tier_ledger, self.ledger_key)
        _memory.ledger_set(f"{self.ledger_key}/capacity",
                           self.capacity_bytes)
        _memory.ledger_set(f"{self.ledger_key}/in_use", 0)
        # the copies alone (CUDA events on the card), with their bytes:
        # the rate the host link gave
        self._h2d: "deque[Tuple[float, int]]" = deque(maxlen=512)
        self._d2h: "deque[Tuple[float, int]]" = deque(maxlen=512)
        # bounded: a slow copy degrades to plain eviction, never to the
        # scheduler blocking
        self._spill_q: "queue.Queue" = queue.Queue(maxsize=spill_depth)
        self._d2h_stream = None          # made by the spiller thread
        self._h2d_stream = None          # made by the promoter thread
        # depth 2: one chain copying while one waits to be adopted
        self._promo_q: "queue.Queue" = queue.Queue(maxsize=promote_depth)
        self._spiller = threading.Thread(
            target=self._spill_loop, name=f"{self.name}-spiller",
            daemon=True)
        self._promoter = threading.Thread(
            target=self._promote_loop, name=f"{self.name}-promoter",
            daemon=True)
        self._spiller.start()
        self._promoter.start()

    # -- capacity / introspection ------------------------------------------
    @property
    def blocks(self) -> int:
        with self._lock:
            return len(self._store)

    @property
    def bytes_in_use(self) -> int:
        with self._lock:
            return len(self._store) * self.entry_nbytes

    @property
    def capacity_blocks(self) -> int:
        return self.capacity_bytes // self.entry_nbytes

    def has(self, key: Tuple[int, ...]) -> bool:
        with self._lock:
            return key in self._store

    def get(self, key: Tuple[int, ...]):
        """A copy of the host entry under ``key`` as ``(block, scale)``
        CPU tensors (scale None for float pools); refreshes the tier LRU.
        Raises :class:`HostTierError` on a missing key (tests only: the
        serving path goes through tickets)."""
        with self._lock:
            row = self._store.get(key)
            if row is None:
                raise HostTierError(f"key {key!r} is not host-resident")
            self._store.move_to_end(key)
            block, scale = self._views(row)
            return block.clone(), None if scale is None else scale.clone()

    # -- the arena (caller holds _lock) ---------------------------------------
    def _set_layout(self, block, scale) -> None:
        layout = (block.dtype, tuple(block.shape),
                  None if scale is None else tuple(scale.shape))
        if self._layout is None:
            nbytes = block.numel() * block.element_size()
            sbytes = 0 if scale is None else scale.numel() * 4
            if (nbytes, sbytes) != (self.block_nbytes, self.scale_nbytes):
                raise HostTierError(
                    f"an entry of {nbytes} + {sbytes} bytes in a tier of "
                    f"{self.block_nbytes} + {self.scale_nbytes}-byte "
                    f"entries")
            self._layout = layout
        elif layout != self._layout:
            raise HostTierError(f"entry layout {layout} differs from the "
                                f"tier's {self._layout}")

    def _views(self, row: int):
        dtype, shape, sshape = self._layout
        r = self._arena[row]
        block = r[:self.block_nbytes].view(dtype).view(shape)
        scale = None if sshape is None else \
            r[self.block_nbytes:].view(torch.float32).view(sshape)
        return block, scale

    def _take_row(self) -> Optional[int]:
        """A free arena row, evicting the tier's oldest entry whose row no
        promotion is reading; None when every row is being read."""
        if self._free_rows:
            return self._free_rows.pop()
        for key, row in self._store.items():
            if not self._pins.get(row):
                del self._store[key]
                self.tier_evictions += 1
                return row
        return None

    def _file(self, key, row: int) -> None:
        """File a filled ``row`` under ``key`` (or return it when the key
        arrived meanwhile: its content is the same)."""
        if key in self._store:
            self._store.move_to_end(key)
            self._free_rows.append(row)
            return
        self._store[key] = row
        self.demoted_blocks += 1

    # -- demotion (device to host) ------------------------------------------
    def spill(self, keys: List[Tuple[int, ...]], blocks_dev,
              scales_dev=None) -> bool:
        """Queue a batched demotion (scheduler thread): ``blocks_dev`` is
        the gather ``[len(keys), L, 2, H, bs, Dh]`` just enqueued on the
        current stream, ``scales_dev`` its ``[len(keys), L, 2, H]``
        companion for quantized pools. On the card an event recorded here
        orders the spiller's copy after the gather. Never blocks: a full
        spill queue drops the demotion (the blocks die as they would
        without a tier) and returns False."""
        if self._closed or not keys:
            return False
        event = None
        if blocks_dev.is_cuda:
            event = torch.cuda.Event()
            event.record()
        item = (list(keys), blocks_dev, scales_dev, event,
                time.perf_counter())
        try:
            self._spill_q.put_nowait(item)
        except queue.Full:
            self.dropped_blocks += len(keys)
            stat_add("serving/tier_degraded", len(keys))
            return False
        return True

    def put(self, key: Tuple[int, ...], block,
            scale=None) -> None:
        """File one host block directly (tests). Raises
        :class:`HostTierFullError` only for an entry that could never
        fit; capacity pressure evicts the tier's own LRU."""
        if self._closed:
            raise HostTierError(f"{self.name} is closed")
        block = torch.as_tensor(np.asarray(block)
                                if not torch.is_tensor(block) else block)
        if scale is not None:
            scale = torch.as_tensor(np.asarray(scale, np.float32)
                                    if not torch.is_tensor(scale)
                                    else scale)
        if block.numel() * block.element_size() + (
                0 if scale is None else scale.numel() * 4) \
                > self.capacity_bytes:
            raise HostTierFullError(f"an entry larger than {self.name}")
        with self._lock:
            self._set_layout(block, scale)
            if key in self._store:
                self._store.move_to_end(key)
                return
            row = self._take_row()
            if row is None:
                return                    # every row is being promoted
            dst, sdst = self._views(row)
            dst.copy_(block)
            if sdst is not None:
                sdst.copy_(scale)
            self._file(key, row)
        self._update_ledger()

    def _side_stream(self, stream):
        """``stream``, or a new side stream on the card (None on the
        CPU): each copy thread keeps its own."""
        if stream is None and self._cuda:
            stream = torch.cuda.Stream(self.device)
        return stream

    def _fetch(self, blocks_dev, scales_dev, event, dests) -> float:
        """THE device-to-host copy of the serving package, on the spiller
        thread: blocks ``blocks_dev[i]`` and their scales, packed into
        ``[n, entry_nbytes]`` bytes, into arena rows (``dests = [(i, row),
        ...]``), one copy a run of consecutive rows. On the card the copy
        stream first waits on the gather's event, the copies are
        ``non_blocking`` into the pinned arena, and this thread
        synchronises the copy's own event. Returns the copy's
        milliseconds. A method so tests can gate or fail it."""
        stream = self._d2h_stream = self._side_stream(self._d2h_stream)
        with contextlib.nullcontext() if stream is None \
                else torch.cuda.stream(stream):
            if event is not None:
                stream.wait_event(event)
            start = _mark(stream)
            n = blocks_dev.shape[0]
            parts = [blocks_dev.reshape(n, -1).view(torch.uint8)]
            if scales_dev is not None:
                parts.append(scales_dev.reshape(n, -1).view(torch.uint8))
            packed = torch.cat(parts, 1) if len(parts) > 1 else parts[0]
            for i, row, k in _runs(dests):
                self._arena[row:row + k].copy_(packed[i:i + k],
                                               non_blocking=self._cuda)
            done = _mark(stream)
        return _elapsed_ms(start, done)

    def _spill_loop(self) -> None:
        while True:
            item = self._spill_q.get()
            try:
                if item is _END:
                    return
                keys, blocks_dev, scales_dev, event, t0 = item
                dests: List[Tuple[int, int]] = []
                try:
                    with self._lock:
                        self._set_layout(blocks_dev[0], None
                                         if scales_dev is None
                                         else scales_dev[0])
                        for i, key in enumerate(keys):
                            if key in self._store:
                                self._store.move_to_end(key)
                                continue
                            row = self._take_row()
                            if row is None:
                                self.dropped_blocks += 1
                                stat_add("serving/tier_degraded")
                                continue
                            # unfiled until its copy lands: unreadable
                            dests.append((i, row))
                    copy_ms = self._fetch(blocks_dev, scales_dev, event,
                                          dests)
                except Exception:                        # noqa: BLE001
                    # a failed copy (the engine torn down mid-flight) is a
                    # degradation, never a crash on a daemon thread
                    with self._lock:
                        self._free_rows.extend(row for _, row in dests)
                    self.dropped_blocks += len(keys)
                    stat_add("serving/tier_degraded", len(keys))
                    continue
                with self._lock:
                    for i, row in dests:
                        self._file(keys[i], row)
                self._update_ledger()
                nbytes = len(dests) * self.entry_nbytes
                self._d2h.append((copy_ms, nbytes))
                dt_ms = (time.perf_counter() - t0) * 1e3
                self._demo_ms.append(dt_ms)
                stat_add("serving/tier_demote", len(keys))
                stat_observe("serving/demotion_ms", dt_ms)
                stat_observe("serving/demotion_bytes", nbytes)
                _metrics.observe("serving_demotion_ms", dt_ms)
                _metrics.observe("serving_demotion_bytes", nbytes)
            finally:
                # drop the gather only now: its copy has ended
                item = None
                self._spill_q.task_done()

    # -- promotion (host to device) -----------------------------------------
    def request_promotion(
            self, keys: List[Tuple[int, ...]]) -> Optional[PromotionTicket]:
        """One ticket for the host-resident chain ``keys`` (root-first);
        a second request for the same chain returns the in-flight ticket.
        None (a plain miss) when the tier is closed, the chain's root
        left the store, or the promoter is busy past its double
        buffer."""
        if self._closed or not keys:
            return None
        keys = [tuple(k) for k in keys]
        with self._lock:
            tk = self._tickets.get(keys[-1])
            if tk is not None:
                return tk
            if keys[0] not in self._store:
                return None
            tk = PromotionTicket(keys)
            try:
                self._promo_q.put_nowait(tk)
            except queue.Full:
                self.promo_shed += 1
                stat_add("serving/tier_degraded")
                return None
            self._tickets[keys[-1]] = tk
            return tk

    def _stage(self, tk: PromotionTicket, rows: List[int]) -> float:
        """Copy the chain's arena rows into one staging tensor on the
        device, one copy a run of consecutive rows; on the card on a side
        stream, recording ``tk.event`` after the copies, and waiting for
        it here (the rows stay pinned until then) after ``ready`` is set.
        Returns the copy's milliseconds."""
        dtype, shape, sshape = self._layout
        n = len(rows)
        stream = self._h2d_stream = self._side_stream(self._h2d_stream)
        with contextlib.nullcontext() if stream is None \
                else torch.cuda.stream(stream):
            packed = torch.empty((n, self.entry_nbytes), dtype=torch.uint8,
                                 device=self.device)
            start = _mark(stream)
            for row, i, k in _runs(zip(rows, range(n))):
                packed[i:i + k].copy_(self._arena[row:row + k],
                                      non_blocking=self._cuda)
            done = _mark(stream)
        if stream is not None:
            tk.event = done
        tk.staged = packed[:, :self.block_nbytes].view(dtype).view(
            (n,) + shape)
        tk.staged_scales = None if sshape is None else \
            packed[:, self.block_nbytes:].view(torch.float32).view(
                (n,) + sshape)
        tk.staged_at = time.perf_counter()
        tk.ready.set()
        self._progress.set()
        return _elapsed_ms(start, done)

    def _promote_loop(self) -> None:
        while True:
            tk = self._promo_q.get()
            rows: List[int] = []
            try:
                if tk is _END:
                    return
                try:
                    with self._lock:
                        staged_keys = []
                        for key in tk.keys:
                            row = self._store.get(key)
                            if row is None:
                                break     # the chain ends at its first gap
                            self._store.move_to_end(key)
                            self._pins[row] = self._pins.get(row, 0) + 1
                            rows.append(row)
                            staged_keys.append(key)
                    if not rows:
                        tk.failed = True
                        continue
                    tk.staged_keys = staged_keys
                    copy_ms = self._stage(tk, rows)
                except Exception:                        # noqa: BLE001
                    tk.failed = True
                    continue
                self._h2d.append((copy_ms, len(rows) * self.entry_nbytes))
            finally:
                if tk is not _END:
                    with self._lock:
                        for row in rows:
                            self._pins[row] -= 1
                            if not self._pins[row]:
                                del self._pins[row]
                    tk.ready.set()
                    self._progress.set()
                self._promo_q.task_done()

    def note_promoted(self, ticket: PromotionTicket, n_blocks: int) -> None:
        """Adoption callback (scheduler thread): the chain's blocks are on
        the device and republished; closes the latency record (ticket
        made to adoption)."""
        dt_ms = (time.perf_counter() - ticket.created_at) * 1e3
        nbytes = n_blocks * self.entry_nbytes
        self.promoted_blocks += n_blocks
        self._promo_ms.append(dt_ms)
        stat_add("serving/tier_promote", n_blocks)
        stat_observe("serving/promotion_ms", dt_ms)
        stat_observe("serving/promotion_bytes", nbytes)
        _metrics.observe("serving_promotion_ms", dt_ms)
        _metrics.observe("serving_promotion_bytes", nbytes)

    def ticket_done(self, ticket: PromotionTicket) -> None:
        """Retire a ticket from the registry (adopted or failed), so a
        later hit on the same chain can promote again."""
        with self._lock:
            for key, tk in list(self._tickets.items()):
                if tk is ticket:
                    del self._tickets[key]

    def wait_progress(self, timeout: float) -> bool:
        """Nap until some ticket completes (or ``timeout``): a host event
        wait, never a device sync."""
        hit = self._progress.wait(timeout)
        self._progress.clear()
        return hit

    # -- lifecycle ---------------------------------------------------------
    def _update_ledger(self) -> None:
        _memory.ledger_set(f"{self.ledger_key}/in_use", self.bytes_in_use)

    def drain(self) -> None:
        """Block until every queued demotion and promotion has been
        processed (tests and drives; the serving path never calls it)."""
        self._spill_q.join()
        self._promo_q.join()

    def close(self) -> None:
        """Stop both worker threads (queued work drains first) and fail
        the open tickets. Idempotent; the store survives, so late
        ``get``s stay safe."""
        if self._closed:
            return
        self._closed = True
        self._spill_q.put(_END)
        self._promo_q.put(_END)
        self._spiller.join(timeout=10.0)
        self._promoter.join(timeout=10.0)
        with self._lock:
            for tk in self._tickets.values():
                tk.failed = True
                tk.ready.set()
            self._tickets.clear()
        self._progress.set()

    @staticmethod
    def _rate(ring) -> Optional[float]:
        """Bytes over copy seconds across the ring, in GB/s."""
        pairs = list(ring)
        ms = sum(m for m, _ in pairs)
        return sum(b for _, b in pairs) / ms / 1e6 if ms > 0 else None

    def stats(self) -> dict:
        """Host-tier snapshot for ``engine.stats()['host_tier']``: the
        JAX tier's keys, plus the copies' own milliseconds and rates
        (``*_copy_ms``, ``*_copy_gb_per_s``)."""
        with self._lock:
            blocks = len(self._store)
        return {
            "capacity_bytes": self.capacity_bytes,
            "bytes_in_use": blocks * self.entry_nbytes,
            "blocks": blocks,
            "capacity_blocks": self.capacity_blocks,
            "demoted_blocks": self.demoted_blocks,
            "promoted_blocks": self.promoted_blocks,
            "dropped_blocks": self.dropped_blocks,
            "tier_evictions": self.tier_evictions,
            "promo_shed": self.promo_shed,
            "promotion_ms": _ring_summary(self._promo_ms),
            "demotion_ms": _ring_summary(self._demo_ms),
            "promotion_copy_ms": _ring_summary(
                [m for m, _ in list(self._h2d)]),
            "demotion_copy_ms": _ring_summary(
                [m for m, _ in list(self._d2h)]),
            "promotion_copy_gb_per_s": self._rate(self._h2d),
            "demotion_copy_gb_per_s": self._rate(self._d2h),
        }

    def __repr__(self):
        return (f"<HostBlockPool {self.name} blocks={self.blocks}/"
                f"{self.capacity_blocks} demoted={self.demoted_blocks} "
                f"promoted={self.promoted_blocks}>")
