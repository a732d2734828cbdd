"""Process-wide counters and value distributions (counterpart of
``paddle_tpu/framework/monitor.py``).

* **counters** (``stat_add``/``stat_get``): accumulated floats, e.g.
  ``op_count/<name>`` (``call_op`` bumps it on every call),
  ``op_time_ms/<name>`` under ``FLAGS_benchmark``, and the serving
  loop's ``serving/*`` counts;
* **histograms** (``stat_observe``/``stat_histogram``): count, sum,
  min, max and p50/p95/p99 over a bounded reservoir of the latest
  samples, e.g. ``serving/cycle_ms`` and ``serving/ttft_ms``.

Writers are lock-free: two threads racing may lose an increment or a
sample, which observability accepts, where a lock per op dispatch would
cost every op. Creating a histogram is the one locked write, once per
name. Readers and ``stat_reset`` take the lock and copy.
"""
from __future__ import annotations

import math
import threading
from collections import deque
from typing import Dict, Optional

__all__ = ["stat_add", "stat_get", "stat_reset", "stats_summary",
           "all_stats", "stat_observe", "stat_histogram", "all_histograms",
           "histogram_samples"]

_lock = threading.Lock()
_stats: Dict[str, float] = {}
_RESERVOIR = 4096
_hists: Dict[str, "_Hist"] = {}


def stat_add(name: str, value: float = 1) -> None:
    _stats[name] = _stats.get(name, 0) + value


def stat_get(name: str) -> float:
    """A counter's value; for a histogram's name, its accumulated sum."""
    with _lock:
        if name in _stats:
            return _stats[name]
        h = _hists.get(name)
        return h.total if h is not None else 0


def stat_reset(name: str = None) -> None:
    with _lock:
        if name is None:
            _stats.clear()
            _hists.clear()
        else:
            _stats.pop(name, None)
            _hists.pop(name, None)


def all_stats() -> Dict[str, float]:
    with _lock:
        return dict(_stats)


# -- histograms -------------------------------------------------------------

class _Hist:
    __slots__ = ("count", "total", "vmin", "vmax", "ring")

    def __init__(self, maxlen: int = _RESERVOIR):
        self.count = 0
        self.total = 0.0
        self.vmin = math.inf
        self.vmax = -math.inf
        self.ring = deque(maxlen=maxlen)


def stat_observe(name: str, value: float) -> None:
    """One sample into the named distribution."""
    h = _hists.get(name)
    if h is None:
        with _lock:
            h = _hists.setdefault(name, _Hist())
    value = float(value)
    h.count += 1
    h.total += value
    if value < h.vmin:
        h.vmin = value
    if value > h.vmax:
        h.vmax = value
    h.ring.append(value)


def _percentile(sorted_vals, q: float) -> float:
    """Nearest-rank percentile of an already sorted sample (0.0 when it
    is empty)."""
    if not sorted_vals:
        return 0.0
    k = max(0, min(len(sorted_vals) - 1,
                   math.ceil(q * len(sorted_vals)) - 1))
    return sorted_vals[k]


def stat_histogram(name: str) -> Optional[dict]:
    """count/sum/min/max and p50/p95/p99 of a distribution; the
    percentiles are over the reservoir (the latest samples once
    ``count`` outgrows it). None before the first sample."""
    with _lock:
        h = _hists.get(name)
        if h is None or h.count == 0:
            return None
        vals = sorted(h.ring)
        return {"count": h.count, "sum": h.total, "min": h.vmin,
                "max": h.vmax, "p50": _percentile(vals, 0.5),
                "p95": _percentile(vals, 0.95),
                "p99": _percentile(vals, 0.99)}


def histogram_samples(name: str) -> list:
    """A copy of a distribution's reservoir, oldest first."""
    with _lock:
        h = _hists.get(name)
        return list(h.ring) if h is not None else []


def all_histograms() -> Dict[str, dict]:
    with _lock:
        names = list(_hists)
    out = {}
    for n in names:
        h = stat_histogram(n)
        if h is not None:
            out[n] = h
    return out


def stats_summary(prefix: str = "") -> str:
    """A table of the counters and distributions whose names start with
    ``prefix``, one a line."""
    rows = [(k, f"{v:g}") for k, v in all_stats().items()
            if k.startswith(prefix)]
    rows += [(k, f"n={h['count']} sum={h['sum']:g} p50={h['p50']:g} "
                 f"p95={h['p95']:g} p99={h['p99']:g} max={h['max']:g}")
             for k, h in all_histograms().items() if k.startswith(prefix)]
    rows.sort()
    if not rows:
        return "(no stats)"
    w = max(len(k) for k, _ in rows)
    return "\n".join(f"{k:<{w}}  {v}" for k, v in rows)
