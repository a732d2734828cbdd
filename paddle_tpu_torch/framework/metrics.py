"""Labeled metrics registry (counterpart of
``paddle_tpu/framework/metrics.py``): the read side of the telemetry.

The monitor (``framework/monitor.py``) is the write-side hot path:
flat-named, lock-free counters and reservoir histograms in one
process-wide namespace. This module carries metric names with labels
(``{engine="2"}``) and distributions that merge:

* :class:`MetricsRegistry`: labeled counters, gauges and mergeable
  histograms (fixed log-spaced buckets, so ``merge`` sums bucket counts
  and a pooled percentile is exact to a bucket's width);
* collectors: callables registered by the telemetry sources (a serving
  engine's ``stats()``) and pulled at scrape time;
* exporters: :meth:`MetricsRegistry.to_prometheus` (text exposition
  v0.0.4: native histograms as ``_bucket``/``_sum``/``_count``, monitor
  distributions as summaries) and :meth:`MetricsRegistry.snapshot`
  (JSON); :func:`parse_prometheus` reads the text format back;
* a bounded time-series ring of periodic samples
  (:meth:`MetricsRegistry.start_sampler`);
* the monitor bridge: every ``stat_add``/``stat_observe`` name is
  published under a snake_case family name, a per-key tail as a ``key``
  label (``op_count/add`` -> ``op_count{key="add"}``, see
  :func:`monitor_metric_name`);
* :func:`statusz`: a text console of the sections registered with
  :func:`register_statusz_section` (the serving engines register one),
  each rendered best-effort.

The default console has the JAX package's ``memory`` section (the
device's memory in use and limit, and the ledger's biggest owners, from
``profiler/memory.py``) and ``training`` section (step cadence, MFU,
gradient telemetry and the latest numerics anomalies, from
``profiler/numerics.py``); its ``collectives`` section waits for
multi-device (ROADMAP Queue 1 item 4).

The text that :meth:`MetricsRegistry.to_prometheus` writes for a given
sequence of writes is byte for byte the JAX registry's.

Threading: one small lock per registry write (writes happen at scheduler
cycles and scrape time, not per op). Collector and statusz callbacks run
on the scraping thread.

Naming: snake_case ``[a-z0-9_]`` family names, unit-suffixed where a unit
exists (``_ms``, ``_bytes``); dimensions are labels, never name suffixes.
"""
from __future__ import annotations

import math
import os
import re
import threading
import time
from collections import deque
from typing import (Any, Callable, Dict, Iterable, List, Optional, Tuple)

__all__ = ["MetricsRegistry", "HistValue", "registry", "inc", "set_gauge",
           "observe", "get_value", "histogram_summary", "snapshot",
           "to_prometheus", "parse_prometheus", "register_collector",
           "unregister_collector", "register_statusz_section", "statusz",
           "monitor_metric_name", "default_buckets", "reset"]

_NAME_RE = re.compile(r"^[a-z][a-z0-9_]*$")
_LABEL_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")

# log-spaced 1/2.5/5 decade ladder: wide enough that one bucket table
# serves microseconds to terabytes, dense enough (3 buckets/decade)
# that a merged-histogram percentile lands within ~2.5x of the pooled
# sample — callers with tighter needs pass their own buckets per family
_DEFAULT_BUCKETS: Tuple[float, ...] = tuple(
    m * (10.0 ** e) for e in range(-3, 10) for m in (1.0, 2.5, 5.0))


def default_buckets() -> Tuple[float, ...]:
    return _DEFAULT_BUCKETS


def _label_key(labels: Dict[str, str]) -> Tuple[Tuple[str, str], ...]:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


class HistValue:
    """One mergeable histogram: fixed cumulative-compatible bucket
    counts + count/sum/min/max. ``merge`` sums bucket counts, which is
    why a fleet can pool replicas' latency distributions exactly (to
    bin width) where percentile-of-percentiles would be wrong."""

    __slots__ = ("buckets", "counts", "count", "total", "vmin", "vmax")

    def __init__(self, buckets: Optional[Iterable[float]] = None):
        self.buckets = tuple(buckets) if buckets is not None \
            else _DEFAULT_BUCKETS
        if list(self.buckets) != sorted(self.buckets):
            raise ValueError("histogram buckets must be sorted ascending")
        self.counts = [0] * (len(self.buckets) + 1)   # +1: the +Inf bucket
        self.count = 0
        self.total = 0.0
        self.vmin = math.inf
        self.vmax = -math.inf

    def observe(self, value: float) -> None:
        value = float(value)
        lo, hi = 0, len(self.buckets)
        while lo < hi:                    # first bucket with le >= value
            mid = (lo + hi) // 2
            if value <= self.buckets[mid]:
                hi = mid
            else:
                lo = mid + 1
        self.counts[lo] += 1
        self.count += 1
        self.total += value
        self.vmin = min(self.vmin, value)
        self.vmax = max(self.vmax, value)

    @classmethod
    def from_samples(cls, samples: Iterable[float],
                     buckets: Optional[Iterable[float]] = None
                     ) -> "HistValue":
        h = cls(buckets)
        for v in samples:
            h.observe(v)
        return h

    def merge(self, other: "HistValue") -> "HistValue":
        if self.buckets != other.buckets:
            raise ValueError(
                "cannot merge histograms with different bucket ladders")
        out = HistValue(self.buckets)
        out.counts = [a + b for a, b in zip(self.counts, other.counts)]
        out.count = self.count + other.count
        out.total = self.total + other.total
        out.vmin = min(self.vmin, other.vmin)
        out.vmax = max(self.vmax, other.vmax)
        return out

    def percentile(self, q: float) -> float:
        """Quantile from bucket counts: linear interpolation inside the
        bucket the rank lands in (clamped to observed min/max), exact
        to the bucket's width — the tolerance the fleet tests assert."""
        if self.count == 0:
            return 0.0
        rank = q * self.count
        cum = 0.0
        for i, c in enumerate(self.counts):
            if c == 0:
                continue
            prev_cum, cum = cum, cum + c
            if cum >= rank:
                lo = self.buckets[i - 1] if i > 0 else \
                    min(self.vmin, self.buckets[0])
                hi = self.buckets[i] if i < len(self.buckets) else self.vmax
                lo = max(lo, self.vmin)
                hi = min(hi, self.vmax) if self.vmax >= lo else hi
                if hi <= lo:
                    return float(hi)
                frac = (rank - prev_cum) / c
                return float(lo + (hi - lo) * frac)
        return float(self.vmax)

    def summary(self) -> Dict[str, Any]:
        if self.count == 0:
            return {"count": 0, "sum": 0.0, "min": None, "max": None,
                    "p50": None, "p95": None, "p99": None}
        return {"count": self.count, "sum": self.total, "min": self.vmin,
                "max": self.vmax, "p50": self.percentile(0.5),
                "p95": self.percentile(0.95),
                "p99": self.percentile(0.99)}

    def bucket_pairs(self) -> List[Tuple[float, int]]:
        """Cumulative ``(le, count)`` pairs, Prometheus-style, ending at
        ``(+inf, count)``."""
        out = []
        cum = 0
        for le, c in zip(self.buckets, self.counts):
            cum += c
            out.append((le, cum))
        out.append((math.inf, self.count))
        return out


# ---------------------------------------------------------------------------
# monitor bridge: flat monitor names -> (family, labels)
# ---------------------------------------------------------------------------

# monitor families whose "/<tail>" is a per-key dimension, not a new
# metric: the tail becomes a `key` label so Grafana can sum/facet it
_LABELED_MONITOR_FAMILIES = (
    "op_count", "op_time_ms", "autotune_measure_ms", "collective_count",
    "collective_bytes", "collective_time_ms", "collective_bw_gbps",
    "compile/ms", "analysis/pass_ms", "dispatch/retrace_cause",
)


def _sanitize(name: str) -> str:
    out = re.sub(r"[^a-z0-9_]", "_", name.lower())
    out = re.sub(r"_+", "_", out).strip("_")
    return out or "unnamed"


def monitor_metric_name(raw: str) -> Tuple[str, Dict[str, str]]:
    """Map a flat monitor stat name onto the registry naming scheme:
    ``(family, labels)``. Per-key families (``op_time_ms/add``) keep
    the family name and carry the tail as ``{key=...}``; every other
    path-name is flattened to snake_case
    (``serving/ttft_ms`` -> ``serving_ttft_ms``). The full mapping
    table is published in MIGRATION.md."""
    for fam in sorted(_LABELED_MONITOR_FAMILIES, key=len, reverse=True):
        if raw.startswith(fam + "/"):
            return _sanitize(fam), {"key": raw[len(fam) + 1:]}
    return _sanitize(raw), {}


# ---------------------------------------------------------------------------
# the registry
# ---------------------------------------------------------------------------

_COUNTER, _GAUGE, _HIST = "counter", "gauge", "histogram"


class MetricsRegistry:
    """Labeled metric families + collectors + exporters + sampler ring.

    One instance (module-level :func:`registry`) serves the process;
    tests build their own. Families are typed at first write; a name
    reused with a different type raises (the bug is at the caller)."""

    def __init__(self, max_series: int = 8192, ring: int = 512,
                 include_monitor: bool = True):
        self._lock = threading.RLock()
        # family -> {"type", "help", "buckets", "series": {labelkey: val}}
        self._families: Dict[str, Dict[str, Any]] = {}
        self._collectors: Dict[str, Callable[[], Iterable[tuple]]] = {}
        self._sections: List[Tuple[str, Callable[[], str]]] = []
        self._max_series = int(max_series)
        self._series_dropped = 0
        self._ring: deque = deque(maxlen=int(ring))
        self._ring_recorded = 0
        self._include_monitor = bool(include_monitor)
        self._sampler: Optional[threading.Thread] = None
        self._sampler_stop = threading.Event()

    # -- writes ------------------------------------------------------------
    def _family(self, name: str, kind: str, help: str = "",
                buckets: Optional[Iterable[float]] = None) -> dict:
        if not _NAME_RE.match(name):
            raise ValueError(
                f"metric name {name!r} violates the naming contract: "
                f"snake_case [a-z0-9_], starting with a letter "
                f"(dimensions go in labels, units in a _ms/_bytes/"
                f"_gbps suffix)")
        fam = self._families.get(name)
        if fam is None:
            fam = self._families[name] = {
                "type": kind, "help": help, "series": {},
                "buckets": tuple(buckets) if buckets is not None
                else _DEFAULT_BUCKETS}
        elif fam["type"] != kind:
            raise ValueError(
                f"metric {name!r} already registered as {fam['type']}, "
                f"cannot reuse as {kind}")
        return fam

    def _check_labels(self, labels: Dict[str, str]) -> Dict[str, str]:
        for k in labels:
            if not _LABEL_RE.match(k):
                raise ValueError(f"invalid label name {k!r}")
        return labels

    def inc(self, name: str, value: float = 1.0, **labels) -> None:
        with self._lock:
            fam = self._family(name, _COUNTER)
            key = _label_key(self._check_labels(labels))
            if key not in fam["series"] \
                    and self._n_series() >= self._max_series:
                self._series_dropped += 1
                return
            fam["series"][key] = fam["series"].get(key, 0.0) + float(value)

    def set_gauge(self, name: str, value: float, **labels) -> None:
        with self._lock:
            fam = self._family(name, _GAUGE)
            key = _label_key(self._check_labels(labels))
            if key not in fam["series"] \
                    and self._n_series() >= self._max_series:
                self._series_dropped += 1
                return
            fam["series"][key] = float(value)

    def observe(self, name: str, value: float,
                buckets: Optional[Iterable[float]] = None,
                **labels) -> None:
        with self._lock:
            fam = self._family(name, _HIST, buckets=buckets)
            key = _label_key(self._check_labels(labels))
            h = fam["series"].get(key)
            if h is None:
                if self._n_series() >= self._max_series:
                    self._series_dropped += 1
                    return
                h = fam["series"][key] = HistValue(fam["buckets"])
            h.observe(value)

    def _n_series(self) -> int:
        return sum(len(f["series"]) for f in self._families.values())

    def reset(self) -> None:
        with self._lock:
            self._families.clear()
            self._ring.clear()
            self._series_dropped = 0
            self._ring_recorded = 0

    # -- reads -------------------------------------------------------------
    def get_value(self, name: str, **labels) -> Optional[float]:
        with self._lock:
            fam = self._families.get(name)
            if fam is None or fam["type"] == _HIST:
                return None
            return fam["series"].get(_label_key(labels))

    def histogram(self, name: str, **labels) -> Optional[HistValue]:
        with self._lock:
            fam = self._families.get(name)
            if fam is None or fam["type"] != _HIST:
                return None
            return fam["series"].get(_label_key(labels))

    def histogram_summary(self, name: str, **labels) -> Optional[dict]:
        h = self.histogram(name, **labels)
        return h.summary() if h is not None else None

    def merged_histogram(self, name: str) -> Optional[HistValue]:
        """Merge every label-series of a histogram family — the fleet
        view of a per-replica distribution."""
        with self._lock:
            fam = self._families.get(name)
            if fam is None or fam["type"] != _HIST \
                    or not fam["series"]:
                return None
            out = None
            for h in fam["series"].values():
                out = h if out is None else out.merge(h)
            return out

    # -- collectors --------------------------------------------------------
    def register_collector(self, name: str,
                           fn: Callable[[], Iterable[tuple]]) -> None:
        """Register a scrape-time source. ``fn()`` yields samples
        ``(kind, name, labels_dict, value)`` with ``kind`` in
        ``counter|gauge`` — pulled (never pushed) by
        snapshot/export/sampler, so a live engine costs nothing between
        scrapes. Re-registering a name replaces it; a collector that
        raises is skipped for that scrape (statusz-grade resilience)."""
        with self._lock:
            self._collectors[str(name)] = fn

    def unregister_collector(self, name: str) -> None:
        with self._lock:
            self._collectors.pop(str(name), None)

    def _collected(self) -> List[tuple]:
        with self._lock:
            items = list(self._collectors.items())
        out = []
        for cname, fn in items:
            try:
                for kind, name, labels, value in fn():
                    if kind in (_COUNTER, _GAUGE) and _NAME_RE.match(name):
                        out.append((kind, name, dict(labels or {}),
                                    float(value)))
            except Exception:                            # noqa: BLE001
                continue    # one broken island must not kill the scrape
        return out

    # -- snapshot / export -------------------------------------------------
    def _monitor_view(self) -> Tuple[Dict, Dict]:
        """(counters, summaries) re-published from the monitor under
        registry names — {} when the bridge is off."""
        if not self._include_monitor:
            return {}, {}
        from . import monitor
        counters: Dict[str, Dict[tuple, float]] = {}
        for raw, val in monitor.all_stats().items():
            name, labels = monitor_metric_name(raw)
            counters.setdefault(name, {})[_label_key(labels)] = float(val)
        summaries: Dict[str, Dict[tuple, dict]] = {}
        for raw, h in monitor.all_histograms().items():
            name, labels = monitor_metric_name(raw)
            summaries.setdefault(name, {})[_label_key(labels)] = h
        return counters, summaries

    def snapshot(self) -> Dict[str, Any]:
        """JSON-serializable view: native families (histograms with
        summaries AND bucket pairs), collector samples, the monitor
        bridge, and the sampler ring tail."""
        with self._lock:
            fams = {n: {"type": f["type"],
                        "series": dict(f["series"])}
                    for n, f in self._families.items()}
            ring = [dict(e) for e in self._ring]
            dropped = self._series_dropped
        out: Dict[str, Any] = {"counters": {}, "gauges": {},
                               "histograms": {}, "ts": time.time(),
                               "series_dropped": dropped,
                               "timeseries": ring}
        for name, f in fams.items():
            if f["type"] == _HIST:
                out["histograms"][name] = [
                    {"labels": dict(k), **h.summary(),
                     "buckets": [[le if math.isfinite(le) else "+Inf", c]
                                 for le, c in h.bucket_pairs()]}
                    for k, h in f["series"].items()]
            else:
                dst = out["counters" if f["type"] == _COUNTER
                          else "gauges"]
                dst[name] = [{"labels": dict(k), "value": v}
                             for k, v in f["series"].items()]
        for kind, name, labels, value in self._collected():
            dst = out["counters" if kind == _COUNTER else "gauges"]
            dst.setdefault(name, []).append(
                {"labels": labels, "value": value})
        mc, ms = self._monitor_view()
        out["monitor"] = {
            "counters": {n: [{"labels": dict(k), "value": v}
                             for k, v in series.items()]
                         for n, series in mc.items()},
            "summaries": {n: [{"labels": dict(k), **h}
                              for k, h in series.items()]
                          for n, series in ms.items()},
        }
        return out

    def to_prometheus(self, path: Optional[str] = None) -> str:
        """Prometheus text exposition v0.0.4. Native counters/gauges as
        their own types, native histograms as real histogram families
        (``_bucket{le=}``/``_sum``/``_count``), collector samples
        inline, and monitor distributions as summary families with
        ``quantile`` labels. :func:`parse_prometheus` round-trips this
        — the exporter test compares the parse against registry state."""
        def num(v: float) -> str:
            f = float(v)
            if math.isinf(f):
                return "+Inf" if f > 0 else "-Inf"
            return str(int(f)) if f.is_integer() else f"{f:.17g}"

        def esc(v: str) -> str:
            return str(v).replace("\\", "\\\\").replace('"', '\\"') \
                .replace("\n", "\\n")

        def labelstr(key: Iterable[Tuple[str, str]],
                     extra: str = "") -> str:
            parts = [f'{k}="{esc(v)}"' for k, v in key]
            if extra:
                parts.append(extra)
            return "{" + ",".join(parts) + "}" if parts else ""

        with self._lock:
            fams = {n: {"type": f["type"], "help": f["help"],
                        "series": dict(f["series"])}
                    for n, f in self._families.items()}
        lines: List[str] = []
        collected: Dict[str, Dict[tuple, float]] = {}
        collected_type: Dict[str, str] = {}
        for kind, name, labels, value in self._collected():
            collected_type.setdefault(name, kind)
            collected.setdefault(name, {})[_label_key(labels)] = value
        for name in sorted(set(fams) | set(collected)):
            f = fams.get(name)
            ftype = f["type"] if f else collected_type[name]
            lines.append(f"# HELP {name} "
                         f"{esc((f or {}).get('help') or name)}")
            lines.append(f"# TYPE {name} {ftype}")
            if f and ftype == _HIST:
                for key, h in f["series"].items():
                    for le, c in h.bucket_pairs():
                        le_lab = labelstr(key, 'le="%s"' % num(le))
                        lines.append(f"{name}_bucket{le_lab} {c}")
                    lines.append(f"{name}_sum{labelstr(key)} "
                                 f"{num(h.total)}")
                    lines.append(f"{name}_count{labelstr(key)} {h.count}")
            else:
                series = dict(f["series"]) if f else {}
                for key, v in collected.get(name, {}).items():
                    series.setdefault(key, v)
                for key, v in series.items():
                    lines.append(f"{name}{labelstr(key)} {num(v)}")
        mc, ms = self._monitor_view()
        # a family may exist on BOTH sides of the bridge — e.g. a live
        # engine's collector publishes serving_queue_depth{engine=} as
        # a gauge while the scheduler's stat_observe("serving/
        # queue_depth") maps to the same family as a summary. The text
        # format forbids one family appearing twice (a real scrape
        # rejects the whole exposition), so the labeled native/
        # collected family wins and the bridge copy is skipped.
        emitted = set(fams) | set(collected)
        for name in sorted(set(mc) - emitted):
            lines.append(f"# HELP {name} monitor counter (bridge)")
            lines.append(f"# TYPE {name} counter")
            for key, v in mc[name].items():
                lines.append(f"{name}{labelstr(key)} {num(v)}")
        emitted |= set(mc)
        for name in sorted(set(ms) - emitted):
            lines.append(f"# HELP {name} monitor distribution (bridge)")
            lines.append(f"# TYPE {name} summary")
            for key, h in ms[name].items():
                for q, pk in ((0.5, "p50"), (0.95, "p95"), (0.99, "p99")):
                    q_lab = labelstr(key, 'quantile="%s"' % q)
                    lines.append(f"{name}{q_lab} {num(h[pk])}")
                lines.append(f"{name}_sum{labelstr(key)} {num(h['sum'])}")
                lines.append(f"{name}_count{labelstr(key)} {h['count']}")
        text = "\n".join(lines) + "\n"
        if path:
            d = os.path.dirname(os.path.abspath(path))
            os.makedirs(d, exist_ok=True)
            with open(path, "w") as fh:
                fh.write(text)
        return text

    # -- time-series ring --------------------------------------------------
    def sample_now(self, label: Optional[str] = None) -> dict:
        """Append one entry to the bounded time-series ring: every
        native counter/gauge value plus collector gauges, flat-keyed as
        ``name{k="v"}``."""
        values: Dict[str, float] = {}
        with self._lock:
            for name, f in self._families.items():
                if f["type"] == _HIST:
                    continue
                for key, v in f["series"].items():
                    lab = ",".join(f'{k}="{val}"' for k, val in key)
                    values[f"{name}{{{lab}}}" if lab else name] = v
        for kind, name, labels, value in self._collected():
            lab = ",".join(f'{k}="{v}"'
                           for k, v in sorted(labels.items()))
            values[f"{name}{{{lab}}}" if lab else name] = value
        entry = {"t": time.perf_counter(), "values": values}
        if label:
            entry["label"] = label
        with self._lock:
            self._ring.append(entry)
            self._ring_recorded += 1
        return entry

    def timeseries(self) -> List[dict]:
        with self._lock:
            return [dict(e) for e in self._ring]

    def start_sampler(self, interval: float = 5.0) -> None:
        """Background periodic :meth:`sample_now` (idempotent). The ring
        is bounded, so an always-on sampler costs
        O(ring * series) host memory, never more."""
        with self._lock:
            if self._sampler is not None and self._sampler.is_alive():
                return
            self._sampler_stop = threading.Event()
            stop = self._sampler_stop

            def _loop():
                while not stop.wait(interval):
                    try:
                        self.sample_now(label="sampler")
                    except Exception:                    # noqa: BLE001
                        pass
            self._sampler = threading.Thread(
                target=_loop, daemon=True, name="paddle-torch-metrics-sampler")
            self._sampler.start()

    def stop_sampler(self) -> None:
        with self._lock:
            t, self._sampler = self._sampler, None
            self._sampler_stop.set()
        if t is not None:
            t.join(timeout=5)

    # -- statusz -----------------------------------------------------------
    def register_statusz_section(self, name: str,
                                 fn: Callable[[], str]) -> None:
        """Add (or replace, by name) a console section. ``fn()`` returns
        the section body; raising renders the error in place."""
        with self._lock:
            self._sections = [(n, f) for n, f in self._sections
                              if n != name]
            self._sections.append((str(name), fn))

    def statusz(self) -> str:
        """The ops console: every registered section rendered under a
        header, best-effort — statusz exists for the moment something
        is broken, so a broken section must print, not raise."""
        with self._lock:
            sections = list(self._sections)
        lines = [f"=== paddle_tpu_torch statusz (pid {os.getpid()}) ==="]
        for name, fn in sections:
            lines.append("")
            lines.append(f"--- {name} ---")
            try:
                body = fn()
                lines.append(body if body else "(empty)")
            except Exception as e:                       # noqa: BLE001
                lines.append(f"(section error: {e!r})")
        return "\n".join(lines) + "\n"


# ---------------------------------------------------------------------------
# the text-format parser (round-trip tests + fleet gates)
# ---------------------------------------------------------------------------

# the labels group must tolerate '}' INSIDE a quoted label value
# ({v="a}b"}), so it matches quoted strings as units instead of
# stopping at the first closing brace
_SAMPLE_RE = re.compile(
    r"^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)"
    r"(?:\{(?P<labels>(?:[^\"}]|\"(?:[^\"\\]|\\.)*\")*)\})?"
    r"\s+(?P<value>\S+)\s*$")
_LABEL_PAIR_RE = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')
_UNESCAPE_RE = re.compile(r"\\(.)")
_UNESCAPE_MAP = {"\\": "\\", '"': '"', "n": "\n"}


def _unescape_label(v: str) -> str:
    """Single left-to-right pass over escape sequences. Sequential
    ``str.replace`` chains are order-sensitive and wrong: the value
    backslash+'n' (two chars) exports as ``\\\\n`` (three chars), which
    a ``.replace("\\\\n", newline)`` pass would corrupt into
    backslash+newline instead of restoring backslash+'n'."""
    return _UNESCAPE_RE.sub(
        lambda m: _UNESCAPE_MAP.get(m.group(1), "\\" + m.group(1)), v)


def parse_prometheus(text: str) -> Dict[str, Any]:
    """Parse a text exposition back into
    ``{"types": {family: type}, "samples": {(name, (labels...)): value}}``
    — the inverse the exporter round-trip test closes. Label values are
    unescaped; ``+Inf`` parses to ``math.inf``."""
    types: Dict[str, str] = {}
    samples: Dict[Tuple[str, Tuple[Tuple[str, str], ...]], float] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        if line.startswith("# TYPE "):
            _, _, rest = line.partition("# TYPE ")
            parts = rest.split()
            if len(parts) >= 2:
                types[parts[0]] = parts[1]
            continue
        if line.startswith("#"):
            continue
        m = _SAMPLE_RE.match(line)
        if not m:
            raise ValueError(f"unparseable exposition line: {line!r}")
        labels = []
        for k, v in _LABEL_PAIR_RE.findall(m.group("labels") or ""):
            labels.append((k, _unescape_label(v)))
        raw = m.group("value")
        if raw == "+Inf":
            val = math.inf
        elif raw == "-Inf":
            val = -math.inf
        else:
            val = float(raw)
        samples[(m.group("name"), tuple(sorted(labels)))] = val
    return {"types": types, "samples": samples}


# ---------------------------------------------------------------------------
# module-level default registry + built-in statusz sections
# ---------------------------------------------------------------------------

_registry = MetricsRegistry()


def registry() -> MetricsRegistry:
    return _registry


def inc(name: str, value: float = 1.0, **labels) -> None:
    _registry.inc(name, value, **labels)


def set_gauge(name: str, value: float, **labels) -> None:
    _registry.set_gauge(name, value, **labels)


def observe(name: str, value: float, **labels) -> None:
    _registry.observe(name, value, **labels)


def get_value(name: str, **labels) -> Optional[float]:
    return _registry.get_value(name, **labels)


def histogram_summary(name: str, **labels) -> Optional[dict]:
    return _registry.histogram_summary(name, **labels)


def snapshot() -> Dict[str, Any]:
    return _registry.snapshot()


def to_prometheus(path: Optional[str] = None) -> str:
    return _registry.to_prometheus(path)


def register_collector(name: str, fn) -> None:
    _registry.register_collector(name, fn)


def unregister_collector(name: str) -> None:
    _registry.unregister_collector(name)


def register_statusz_section(name: str, fn) -> None:
    _registry.register_statusz_section(name, fn)


def statusz() -> str:
    return _registry.statusz()


def reset() -> None:
    _registry.reset()


def _fmt_bytes(n: Optional[float]) -> str:
    if n is None:
        return "n/a"
    n = float(n)
    for unit in ("B", "KiB", "MiB", "GiB", "TiB"):
        if abs(n) < 1024 or unit == "TiB":
            return f"{n:.1f} {unit}" if unit != "B" else f"{int(n)} B"
        n /= 1024
    return f"{n:.1f} TiB"


def _memory_section() -> str:
    """Device memory headroom + the ledger's biggest owners
    (profiler/memory.py). Polls the allocator's statistics once —
    statusz is operator-driven, never a hot path."""
    from ..profiler import memory as _mem
    cross = _mem.crosscheck()
    led = _mem.ledger()
    lines = []
    in_use = cross.get("device_bytes_in_use")
    limit = None
    tl = _mem.timeline()
    for e in reversed(tl):
        if "bytes_limit" in e:
            limit = e["bytes_limit"]
            break
    headroom = (limit - in_use) if (limit and in_use) else None
    lines.append(f"hbm in use     : {_fmt_bytes(in_use)}")
    lines.append(f"hbm limit      : {_fmt_bytes(limit)}")
    lines.append(f"hbm headroom   : {_fmt_bytes(headroom)}")
    lines.append(f"ledger total   : {_fmt_bytes(cross['ledger_bytes'])}")
    for k, v in sorted(led.items(), key=lambda kv: -kv[1])[:8]:
        lines.append(f"  {k:<40} {_fmt_bytes(v)}")
    return "\n".join(lines)


def _training_section() -> str:
    """Training health at a glance: step cadence, MFU, gradient
    telemetry, nonfinite/spike counters and the most recent numerics
    anomalies (profiler/numerics.py recorders)."""
    from . import monitor
    lines = []

    def hist_line(label, name, unit=""):
        h = monitor.stat_histogram(name)
        if h:
            lines.append(f"{label:<16}: p50 {h['p50']:.4g}{unit} "
                         f"p95 {h['p95']:.4g}{unit} (n={h['count']})")
    hist_line("step time", "hapi/step_time_ms", " ms")
    hist_line("mfu", "hapi/mfu")
    hist_line("grad norm", "hapi/grad_norm")
    nonfin = monitor.stat_get("hapi/nonfinite_steps")
    spikes = monitor.stat_get("hapi/loss_spikes")
    lines.append(f"nonfinite steps : {nonfin:g}   loss spikes: {spikes:g}")
    from ..profiler import numerics as _num
    for rec in _num.live_recorders():
        for a in rec.anomaly_list()[-3:]:
            lines.append(f"  anomaly: step {a.get('step')} "
                         f"{a.get('kind')} "
                         f"(blamed: {a.get('blamed_groups')})")
    return "\n".join(lines) if lines else "(no training activity)"


_registry.register_statusz_section("memory", _memory_section)
_registry.register_statusz_section("training", _training_section)
