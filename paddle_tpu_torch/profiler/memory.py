"""Device memory tracker: timeline, ledger, and the OOM postmortem
(counterpart of ``paddle_tpu/profiler/memory.py``).

Reference analog: the profiler's memory tab +
``paddle.device.cuda.memory_allocated`` over the STAT gpu-mem counters
(fluid/memory/stats.cc). On the card, allocation belongs to PyTorch's
caching allocator — the user-visible surface is observability, three
layers of it:

* **timeline** — a bounded ring of samples over
  ``torch.cuda.memory_stats()`` (``allocated_bytes.all.current`` as
  ``bytes_in_use``, ``.peak`` as ``peak_bytes_in_use``; the card's total
  from ``torch.cuda.mem_get_info()`` as ``bytes_limit``), which never
  synchronizes the device,
  fed by a background sampler thread (:func:`start_sampler`) plus
  labeled watermarks at the moments that matter: fit's flush windows,
  serving cycles, KV-pool alloc/free. Watermarks from the scheduler hot
  path use :func:`mark` — a host-only stamp that NEVER polls the device
  (polling stays on the sampler thread); :func:`sample` additionally
  reads the device stats.
* **ledger** — the bytes WE think are live, by owner: the train state
  (params / opt_state / buffers, registered by ``Model.fit``) and the
  serving KV pools (capacity + in-use, registered by the pools).
  :func:`crosscheck` compares the ledger total against the device's
  ``bytes_in_use`` — the gap is what nobody is accounting for.
* **OOM postmortem** — ``torch.cuda.OutOfMemoryError`` caught in
  ``Model.fit`` and the serving scheduler dumps the timeline, the
  ledger, and the largest live device tensors (a walk of the live
  objects, as ``jax.live_arrays()`` lists them) to a JSON file next to
  the flight recorder's auto-dump, never masking the original error.

Threading: writers (``mark``/``ledger_set``) take the one small lock
per call — they run per flush window / pool event / scheduler cycle,
not per op, so contention is negligible (same argument as the flight
recorder). The module-level default tracker is what the framework
integrations use; tests build their own :class:`MemoryTracker` with a
mocked stats function.
"""
from __future__ import annotations

import json
import logging
import os
import tempfile
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional

from ..framework.monitor import stat_add, stat_observe

__all__ = ["MemoryTracker", "tracker", "sample", "mark", "ledger_set",
           "ledger_drop", "ledger", "ledger_total", "crosscheck",
           "start_sampler", "stop_sampler", "timeline",
           "largest_live_arrays", "oom_postmortem",
           "is_resource_exhausted"]

logger = logging.getLogger(__name__)

# substrings that mark an out-of-HBM failure across the surfaces it
# arrives on (XlaRuntimeError repr, RuntimeError text, wrapped reprs).
# Deliberately NO bare "OOM": three characters match inside unrelated
# identifiers ("BOOM", a path segment) and a spurious postmortem
# actively misdirects the triage it exists to aid.
_OOM_MARKERS = ("RESOURCE_EXHAUSTED", "Out of memory", "out of memory")


def is_resource_exhausted(error: BaseException) -> bool:
    """Does this exception look like the device ran out of memory?
    ``torch.cuda.OutOfMemoryError`` is; so is any error whose text
    carries one of the JAX package's markers."""
    import torch
    if isinstance(error, torch.cuda.OutOfMemoryError):
        return True
    text = f"{type(error).__name__}: {error!r}"
    return any(m in text for m in _OOM_MARKERS)


def _device_stats() -> dict:
    """One poll of the current CUDA device's allocator statistics; {}
    on a host where CUDA was never initialized (the CPU, as the JAX
    version returns there) or when the query fails. Neither call
    synchronizes the device."""
    import torch
    try:
        if not torch.cuda.is_initialized():
            return {}
        st = torch.cuda.memory_stats()
        out = {}
        if "allocated_bytes.all.current" in st:
            out["bytes_in_use"] = int(st["allocated_bytes.all.current"])
            out["peak_bytes_in_use"] = int(st["allocated_bytes.all.peak"])
        _free, total = torch.cuda.mem_get_info()
        out["bytes_limit"] = int(total)
        return out
    except Exception:                                    # noqa: BLE001
        return {}


class MemoryTracker:
    """Bounded device-memory timeline + byte ledger + postmortem dump."""

    def __init__(self, max_samples: int = 2048,
                 stats_fn: Optional[Callable[[], dict]] = None):
        if max_samples < 1:
            raise ValueError("max_samples must be >= 1")
        # RLock, not Lock: ledger owners drop their keys from weakref
        # FINALIZERS (hapi Model._drop_ledger_keys), and a finalizer can
        # fire on whatever thread happens to allocate — including THIS
        # thread while it holds the lock inside timeline()/ledger()'s
        # copy (the copy allocates, allocation can trigger GC). With a
        # plain Lock that is a same-thread deadlock.
        self._lock = threading.RLock()
        self._ring: deque = deque(maxlen=int(max_samples))
        self._ledger: Dict[str, int] = {}
        self._stats_fn = stats_fn or _device_stats
        self.samples_recorded = 0       # monotonic (ring drops, this doesn't)
        self.last_dump_path: Optional[str] = None
        self.dumps = 0
        self._sampler: Optional[threading.Thread] = None
        self._sampler_stop = threading.Event()

    # -- timeline ----------------------------------------------------------
    def _append(self, entry: dict) -> None:
        with self._lock:
            entry["ledger_bytes"] = sum(self._ledger.values())
            self._ring.append(entry)
            self.samples_recorded += 1

    def sample(self, label: Optional[str] = None, **meta) -> dict:
        """Poll the device stats and append one timeline entry. NOT for
        the scheduler hot path — that is :meth:`mark`'s job."""
        stats = self._stats_fn() or {}
        entry: Dict[str, Any] = {"t": time.perf_counter()}
        if label is not None:
            entry["label"] = label
        for k in ("bytes_in_use", "peak_bytes_in_use", "bytes_limit"):
            if k in stats:
                entry[k] = int(stats[k])
        entry.update(meta)
        self._append(entry)
        if "bytes_in_use" in entry:
            stat_observe("memory/bytes_in_use", entry["bytes_in_use"])
        return entry

    def mark(self, label: str, **meta) -> dict:
        """Host-only watermark: a labeled timeline stamp carrying the
        ledger total but NO device poll — safe from the scheduler
        thread, pool alloc/free, and anywhere else a stats query would
        stall the hot path. Device numbers around it come from the
        sampler thread's periodic :meth:`sample` entries."""
        entry: Dict[str, Any] = {"t": time.perf_counter(), "label": label}
        entry.update(meta)
        self._append(entry)
        return entry

    def timeline(self) -> List[dict]:
        with self._lock:
            return [dict(e) for e in self._ring]

    # -- background sampler ------------------------------------------------
    def start(self, interval: float = 0.2) -> None:
        """Start the background sampler thread (idempotent): one
        :meth:`sample` every ``interval`` seconds until :meth:`stop`."""
        with self._lock:
            if self._sampler is not None and self._sampler.is_alive():
                return
            self._sampler_stop = threading.Event()
            stop = self._sampler_stop

            def _loop():
                while not stop.wait(interval):
                    try:
                        self.sample(label="sampler")
                    except Exception:                    # noqa: BLE001
                        pass        # a flaky stats query must not kill it
            self._sampler = threading.Thread(
                target=_loop, daemon=True, name="paddle-memory-sampler")
            self._sampler.start()

    def stop(self) -> None:
        with self._lock:
            t, self._sampler = self._sampler, None
            self._sampler_stop.set()
        if t is not None:
            t.join(timeout=5)

    # -- ledger ------------------------------------------------------------
    def ledger_set(self, key: str, nbytes: int) -> None:
        with self._lock:
            self._ledger[key] = int(nbytes)

    def ledger_drop(self, key: str) -> None:
        with self._lock:
            self._ledger.pop(key, None)

    def ledger(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._ledger)

    def ledger_total(self) -> int:
        with self._lock:
            return sum(self._ledger.values())

    def crosscheck(self) -> dict:
        """Ledger vs device: how much of ``bytes_in_use`` do the
        registered owners explain? ``device_bytes_in_use`` is ``None``
        where the backend doesn't report (CPU) — then only the ledger
        side is meaningful. Ledger keys under the ``host/`` prefix
        (the serving host-DRAM spill tier) are accounted SEPARATELY as
        ``host_ledger_bytes`` — host DRAM must never inflate the
        device-side explained ratio."""
        stats = self._stats_fn() or {}
        in_use = stats.get("bytes_in_use")
        with self._lock:
            host = sum(v for k, v in self._ledger.items()
                       if k.startswith("host/"))
            led = sum(self._ledger.values()) - host
        out: Dict[str, Any] = {
            "ledger_bytes": led,
            "host_ledger_bytes": host,
            "device_bytes_in_use": None if in_use is None else int(in_use),
            "unexplained_bytes": None,
            "explained_ratio": None,
        }
        if in_use:
            out["unexplained_bytes"] = int(in_use) - led
            out["explained_ratio"] = led / int(in_use)
        return out

    # -- postmortem --------------------------------------------------------
    def largest_live_arrays(self, n: int = 20) -> List[dict]:
        """The ``n`` biggest live device tensors (shape/dtype/bytes),
        biggest first — the "what is actually holding the card's memory"
        list of the OOM postmortem: a walk of the interpreter's live
        objects for CUDA tensors, as ``jax.live_arrays()`` lists the
        live device arrays. Host bookkeeping only (sizes come from shape
        and dtype)."""
        import gc
        import warnings

        import torch
        rows = []
        seen = set()
        with warnings.catch_warnings():
            # isinstance() on a deprecated alias object warns
            warnings.simplefilter("ignore")
            objs = [o for o in gc.get_objects()
                    if isinstance(o, torch.Tensor)]
        for obj in objs:
            try:
                if not obj.is_cuda:
                    continue
                key = (obj.data_ptr(), tuple(obj.shape), obj.dtype)
                if key in seen:
                    continue
                seen.add(key)
                rows.append({"shape": list(obj.shape),
                             "dtype": str(obj.dtype).replace("torch.", ""),
                             "nbytes": obj.numel() * obj.element_size()})
            except Exception:                            # noqa: BLE001
                continue        # a tensor torn down mid-walk
        rows.sort(key=lambda r: r["nbytes"], reverse=True)
        return rows[:n]

    def oom_postmortem(self, error: Optional[BaseException] = None,
                       path: Optional[str] = None,
                       extra: Optional[dict] = None) -> Optional[str]:
        """Dump the memory picture at the moment of death: timeline,
        ledger, ledger-vs-device crosscheck, and the largest live
        arrays, as JSON. Best effort and NEVER raises — it runs inside
        failure handlers, and a broken disk must not mask the original
        error. Returns the file path (``None`` on failure)."""
        try:
            doc: Dict[str, Any] = {
                "reason": repr(error) if error is not None else "requested",
                "dumped_at": time.time(),
                "timeline": self.timeline(),
                "ledger": self.ledger(),
                "crosscheck": self.crosscheck(),
                "largest_live_arrays": self.largest_live_arrays(),
            }
            if extra:
                doc.update(extra)
            if path is None:
                path = os.path.join(
                    tempfile.gettempdir(),
                    f"paddle_oom_postmortem_{os.getpid()}_{id(self):x}"
                    f".json")
            d = os.path.dirname(os.path.abspath(path))
            os.makedirs(d, exist_ok=True)
            with open(path, "w") as f:
                json.dump(doc, f, default=repr)
            with self._lock:
                self.last_dump_path = path
                self.dumps += 1
            if error is not None:
                stat_add("memory/oom_postmortem")
                logger.error("OOM postmortem written to %s", path)
            else:
                # requested dump (e.g. riding a numerics postmortem):
                # same artifact, but nobody ran out of memory — an
                # alert gating on memory/oom_postmortem must not fire
                stat_add("memory/postmortem_requested")
                logger.info("memory postmortem written to %s", path)
            return path
        except Exception:                                # noqa: BLE001
            return None

    def __repr__(self):
        with self._lock:
            return (f"<MemoryTracker samples={len(self._ring)}/"
                    f"{self.samples_recorded} ledger_keys="
                    f"{len(self._ledger)}>")


# ---------------------------------------------------------------------------
# module-level default tracker (what the framework integrations use)
# ---------------------------------------------------------------------------

_tracker = MemoryTracker()


def tracker() -> MemoryTracker:
    return _tracker


def sample(label: Optional[str] = None, **meta) -> dict:
    return _tracker.sample(label, **meta)


def mark(label: str, **meta) -> dict:
    return _tracker.mark(label, **meta)


def ledger_set(key: str, nbytes: int) -> None:
    _tracker.ledger_set(key, nbytes)


def ledger_drop(key: str) -> None:
    _tracker.ledger_drop(key)


def ledger() -> Dict[str, int]:
    return _tracker.ledger()


def ledger_total() -> int:
    return _tracker.ledger_total()


def crosscheck() -> dict:
    return _tracker.crosscheck()


def start_sampler(interval: float = 0.2) -> None:
    _tracker.start(interval)


def stop_sampler() -> None:
    _tracker.stop()


def timeline() -> List[dict]:
    return _tracker.timeline()


def largest_live_arrays(n: int = 20) -> List[dict]:
    return _tracker.largest_live_arrays(n)


def oom_postmortem(error: Optional[BaseException] = None,
                   path: Optional[str] = None,
                   extra: Optional[dict] = None) -> Optional[str]:
    return _tracker.oom_postmortem(error, path=path, extra=extra)


def _metrics_collector():
    """Registry collector: the device-memory ledger as per-owner
    gauges plus one device poll for in-use/limit. Scrape-time only —
    the collector is PULLED by snapshot/export, so the device query
    rides the operator's scrape cadence, never a hot path."""
    led = _tracker.ledger()
    out = [("gauge", "hbm_ledger_bytes", {"owner": k}, float(v))
           for k, v in led.items()]
    out.append(("gauge", "hbm_ledger_total_bytes", {},
                float(sum(led.values()))))
    stats = _tracker._stats_fn() or {}
    if "bytes_in_use" in stats:
        out.append(("gauge", "hbm_bytes_in_use", {},
                    float(stats["bytes_in_use"])))
    if "bytes_limit" in stats:
        out.append(("gauge", "hbm_bytes_limit", {},
                    float(stats["bytes_limit"])))
    return out


def _register_memory_collector() -> None:
    try:
        from ..framework import metrics as _metrics
        _metrics.register_collector("memory", _metrics_collector)
    except Exception:                                    # noqa: BLE001
        pass


_register_memory_collector()
