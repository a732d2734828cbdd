"""Batched serving over the Predictor (counterpart of
``paddle_tpu/inference/serving.py``).

Reference analog: the AnalysisPredictor serve loop
(paddle/fluid/inference/api/analysis_predictor.cc:1) and its zero-copy
batch handles; production deployments there batch requests server-side
(paddle-serving). The engine gathers concurrent requests into padded
buckets (power-of-two batch sizes, so a program sees few distinct
shapes) and splits the results back per caller: on the card a call's
host work and its copies cost about the same at 1 row as at 32, so
batching is what raises requests/s.
"""
from __future__ import annotations

import queue
import threading
from typing import List, Optional

import numpy as np

__all__ = ["BatchingEngine"]


class _Request:
    __slots__ = ("arrays", "event", "result", "error")

    def __init__(self, arrays):
        self.arrays = arrays
        self.event = threading.Event()
        self.result = None
        self.error = None


class BatchingEngine:
    """Gathers concurrent ``infer`` calls into padded batches.

    * ``max_batch_size`` — upper bucket; requests beyond it wait for the
      next cycle.
    * ``max_delay_ms`` — how long the gatherer waits for co-riders after
      the first request lands. 0 serves singles immediately (latency
      mode).
    * batch sizes are rounded UP to powers of two and padded by repeating
      the last sample, so a program sees one shape per bucket; padding
      rows are dropped before returning.

    Thread-safe; callers block in ``infer`` until their rows return.
    """

    def __init__(self, predictor, max_batch_size: int = 32,
                 max_delay_ms: float = 2.0):
        if max_batch_size < 1:
            raise ValueError("max_batch_size must be >= 1")
        self._predictor = predictor
        self._max_batch = int(max_batch_size)
        self._delay = max(0.0, float(max_delay_ms)) / 1000.0
        self._queue: "queue.Queue[_Request]" = queue.Queue()
        self._closed = False
        self._close_lock = threading.Lock()
        self._worker = threading.Thread(target=self._loop, daemon=True)
        self._worker.start()

    # -- client side -------------------------------------------------------
    def infer(self, *arrays) -> List[np.ndarray]:
        """One logical request: each array's leading dim is this caller's
        batch (usually 1). Blocks until results are ready."""
        req = _Request([np.asarray(a) for a in arrays])
        # the lock makes enqueue atomic with close(): a request can never
        # slip in after the close sentinel and hang in event.wait()
        with self._close_lock:
            if self._closed:
                raise RuntimeError("BatchingEngine is closed")
            self._queue.put(req)
        req.event.wait()
        if req.error is not None:
            raise req.error
        return req.result

    def close(self, timeout: Optional[float] = None):
        """Stop accepting work and DRAIN: the shutdown sentinel queues
        BEHIND everything already submitted, so the worker serves every
        in-flight request before exiting — close() is a graceful drain,
        not an abandonment. Pass ``timeout`` (seconds) to bound the
        wait; requests still pending past it (or left behind by a dead
        worker) fail with a "closed" error instead of hanging their
        callers forever."""
        with self._close_lock:
            if self._closed:
                return
            self._closed = True
            self._queue.put(None)       # wake the worker
        self._worker.join(timeout)
        # after an untimed join the queue holds nothing; with a timeout
        # (or a dead worker) fail the leftovers so no caller hangs
        while True:
            try:
                r = self._queue.get_nowait()
            except queue.Empty:
                break
            if r is None:
                if self._worker.is_alive():
                    # a slow batch outlived the join timeout: the worker
                    # still needs its shutdown sentinel — put it back
                    self._queue.put(None)
                    break
                continue
            if not r.event.is_set():
                r.error = RuntimeError("BatchingEngine is closed")
                r.event.set()

    # -- worker side -------------------------------------------------------
    def _gather(self) -> Optional[List[_Request]]:
        first = self._queue.get()
        while first is not None and not self._valid(first):
            first = self._queue.get()      # malformed: already failed
        if first is None:
            return None
        batch = [first]
        rows = first.arrays[0].shape[0]
        import time
        deadline = time.perf_counter() + self._delay
        while rows < self._max_batch:
            remaining = deadline - time.perf_counter()
            if remaining <= 0 and self._delay > 0:
                break
            try:
                nxt = self._queue.get(
                    timeout=max(remaining, 0) if self._delay > 0 else None
                ) if self._delay > 0 else self._queue.get_nowait()
            except queue.Empty:
                break
            if nxt is None:
                self._queue.put(None)   # re-post the close sentinel
                break
            if not self._valid(nxt):
                continue
            batch.append(nxt)
            rows += nxt.arrays[0].shape[0]
        return batch

    @staticmethod
    def _valid(req) -> bool:
        """Fail malformed requests HERE instead of letting them raise in
        the gather loop and kill the worker thread (which would hang
        every subsequent caller forever)."""
        if req.arrays and all(getattr(a, "ndim", 0) >= 1
                              for a in req.arrays):
            return True
        req.error = ValueError(
            "infer() needs at least one array, each with a leading "
            "batch dimension")
        req.event.set()
        return False

    @staticmethod
    def _bucket(n: int, cap: int) -> int:
        """Next power of two >= n: ALWAYS a pow2, even above
        max_batch_size, so oversize client batches land in O(log n)
        buckets instead of one shape per distinct row count."""
        b = 1
        while b < n:
            b *= 2
        return b

    def _serve(self, batch: List[_Request]) -> None:
        """Pad one gathered batch to its pow2 bucket, run the predictor,
        split the rows back per caller."""
        n_inputs = len(batch[0].arrays)
        rows = [r.arrays[0].shape[0] for r in batch]
        total = sum(rows)
        padded = self._bucket(total, self._max_batch)
        feeds = []
        for j in range(n_inputs):
            stacked = np.concatenate([r.arrays[j] for r in batch])
            if padded > total:
                pad = np.repeat(stacked[-1:], padded - total, axis=0)
                stacked = np.concatenate([stacked, pad])
            feeds.append(stacked)
        outs = self._predictor.run(feeds)
        start = 0
        for r, n in zip(batch, rows):
            r.result = [o[start:start + n] for o in outs]
            start += n
            r.event.set()

    def _loop(self):
        while True:
            batch = self._gather()
            if batch is None:
                return
            try:
                self._serve(batch)
            except Exception as batch_exc:              # noqa: BLE001
                if len(batch) == 1:
                    batch[0].error = batch_exc
                    batch[0].event.set()
                    continue
                # one poisoned request must not fail its co-riders:
                # retry each request as its own batch — the healthy ones
                # succeed, only the poisoned one propagates its error
                for r in batch:
                    if r.event.is_set():
                        continue
                    try:
                        self._serve([r])
                    except Exception as e:              # noqa: BLE001
                        r.error = e
                        r.event.set()
