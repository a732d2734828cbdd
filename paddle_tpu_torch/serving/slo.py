"""Serving SLO plane (counterpart of ``paddle_tpu/serving/slo.py``):
objectives, burn rates and goodput over the metrics registry.

* an **objective** is a latency target over one derived request metric
  (``ttft_ms`` or ``tpot_ms``) plus an attainment goal — "TTFT <= 250 ms
  for 99% of requests";
* **attainment** is the exact fraction of observed requests that met the
  target (good / total, counted per event, not derived from
  percentiles);
* **burn rate** is (observed error rate / error budget) over a fast (1m)
  and a slow (30m) trailing window, the error budget being ``1 - goal``;
  the windows are deltas against the registry's sampler ring
  (:meth:`MetricsRegistry.timeseries`), no second time-series store;
* **goodput** is SLO-meeting completions per second per replica, from
  each engine's :class:`~.flight_recorder.FlightRecorder` retire stamps.

The tracker attaches to engines through flight-recorder retire hooks
(the scheduler never learns it exists) and publishes through a registry
collector: ``slo_events_total``/``slo_good_total`` counters,
``slo_attainment`` and ``slo_burn_rate`` gauges, per-replica
``goodput_rps`` gauges, and a ``slo_latency_ms`` histogram written at
observe time, so a remote scraper can recompute attainment from the
cumulative buckets (:func:`attainment_from_buckets` brackets it to one
bucket). Everything here is host arithmetic over host stamps: no device
access, no scheduler blocking.
"""
from __future__ import annotations

import threading
import time
import weakref
from typing import Any, Dict, List, Optional, Tuple

from ..framework import metrics as _metrics

__all__ = ["SLOObjective", "SLOTracker", "attainment_from_buckets"]

_METRICS = ("ttft_ms", "tpot_ms")


class SLOObjective:
    """One latency objective: ``metric <= target_ms`` for ``goal`` of
    requests."""

    __slots__ = ("name", "metric", "target_ms", "goal")

    def __init__(self, name: str, metric: str, target_ms: float,
                 goal: float):
        if metric not in _METRICS:
            raise ValueError(
                f"objective metric must be one of {_METRICS}, "
                f"got {metric!r}")
        if not (0.0 < goal < 1.0):
            raise ValueError("goal must be in (0, 1) — a goal of 1.0 "
                             "has a zero error budget and an undefined "
                             "burn rate")
        self.name = str(name)
        self.metric = metric
        self.target_ms = float(target_ms)
        self.goal = float(goal)

    @property
    def error_budget(self) -> float:
        return 1.0 - self.goal

    def __repr__(self):
        return (f"<SLOObjective {self.name}: {self.metric} <= "
                f"{self.target_ms:g}ms for {self.goal:.2%}>")


def attainment_from_buckets(bucket_pairs: List[Tuple[float, float]],
                            target_ms: float
                            ) -> Tuple[Optional[float], Optional[float]]:
    """Bracket the exact attainment from cumulative ``(le, count)``
    histogram pairs: returns ``(lo, hi)`` — the cumulative fraction at
    the last bound strictly below the target and at the first bound at
    or above it. The exact per-event attainment lies in ``[lo, hi]``;
    the interval width is one bucket of resolution, which is the
    tolerance the scrape-equivalence gate asserts. ``(None, None)``
    when the histogram is empty."""
    pairs = sorted(bucket_pairs, key=lambda p: p[0])
    if not pairs:
        return None, None
    total = float(pairs[-1][1])
    if total <= 0:
        return None, None
    below = 0.0
    for le, cum in pairs:
        if le >= target_ms:
            return below / total, float(cum) / total
        below = float(cum)
    return below / total, 1.0


class SLOTracker:
    """Objectives + burn rates + goodput, published through one
    registry collector.

    One tracker serves one engine or one fleet; it observes retiring
    traces via flight-recorder hooks (:meth:`attach_engine` /
    :meth:`attach_fleet`) or direct :meth:`observe_trace` calls, and is
    read via :meth:`report` (JSON) or the registry scrape.
    """

    def __init__(self, registry: Optional[_metrics.MetricsRegistry] = None,
                 name: str = "slo", fast_window_s: float = 60.0,
                 slow_window_s: float = 1800.0):
        self._registry = registry if registry is not None \
            else _metrics.registry()
        self._name = str(name)
        self._fast = float(fast_window_s)
        self._slow = float(slow_window_s)
        self._lock = threading.Lock()
        self._objectives: Dict[str, SLOObjective] = {}
        self._counts: Dict[str, List[int]] = {}        # name -> [good, total]
        # replica key -> weakref to its FlightRecorder (goodput source);
        # weak so a closed engine's recorder can be collected
        self._recorders: Dict[str, Any] = {}
        self._collector = f"serving_slo/{self._name}"
        self._registry.register_collector(self._collector, self._samples)

    # -- objectives ---------------------------------------------------------
    def add_objective(self, name: str, metric: str = "ttft_ms",
                      target_ms: float = 250.0,
                      goal: float = 0.99) -> SLOObjective:
        obj = SLOObjective(name, metric, target_ms, goal)
        with self._lock:
            self._objectives[obj.name] = obj
            self._counts.setdefault(obj.name, [0, 0])
        return obj

    @property
    def objectives(self) -> Dict[str, SLOObjective]:
        with self._lock:
            return dict(self._objectives)

    # -- attachment ---------------------------------------------------------
    def attach_engine(self, engine, replica: Optional[str] = None) -> str:
        """Hook one engine's flight recorder: every retired trace is
        observed against every objective, the recorder's tail-sampling
        SLO is armed at the tightest TTFT target, and the replica's
        goodput gauge starts publishing. Returns the replica key."""
        rec = engine.flight_recorder
        key = str(replica if replica is not None
                  else getattr(engine, "_eid", id(engine)))
        ttft_targets = [o.target_ms for o in self.objectives.values()
                        if o.metric == "ttft_ms"]
        if ttft_targets and getattr(rec, "set_tail_slo", None):
            rec.set_tail_slo(min(ttft_targets))
        with self._lock:
            self._recorders[key] = weakref.ref(rec)
        if getattr(rec, "add_retire_hook", None):
            rec.add_retire_hook(
                lambda trace, _k=key: self.observe_trace(trace,
                                                         replica=_k))
        return key

    def attach_fleet(self, fleet) -> List[str]:
        """Attach every replica, keyed by fleet replica index — the
        same ids ``EngineFleet.stats()`` reports."""
        return [self.attach_engine(eng, replica=str(i))
                for i, eng in enumerate(fleet.replicas)]

    # -- observation --------------------------------------------------------
    def observe_trace(self, trace, replica: Optional[str] = None) -> None:
        """Score one retired trace against every objective. Runs on the
        scheduler thread (retire hook): exact counters under the
        tracker lock plus one registry histogram write per objective —
        host work only, no device, bounded cost."""
        for obj in self.objectives.values():
            value = getattr(trace, obj.metric, None)
            if value is None:
                continue
            good = value <= obj.target_ms
            with self._lock:
                counts = self._counts.setdefault(obj.name, [0, 0])
                counts[1] += 1
                if good:
                    counts[0] += 1
            self._registry.observe("slo_latency_ms", float(value),
                                   objective=obj.name)

    # -- evaluation ---------------------------------------------------------
    def _window_label(self, w: float) -> str:
        if w >= 60 and abs(w / 60 - round(w / 60)) < 1e-9:
            return f"{int(round(w / 60))}m"
        return f"{int(w)}s"

    def burn_rates(self) -> Dict[str, Dict[str, float]]:
        """Per-objective ``{window: burn}``. Burn = (windowed error
        rate) / (error budget): the window delta comes from the sampler
        ring's recorded ``slo_events_total`` / ``slo_good_total``
        counters — the baseline is the newest ring entry at least one
        window old, falling back to zero (process lifetime) when the
        ring is younger than the window. 0.0 while the window saw no
        events (no traffic burns no budget)."""
        now = time.perf_counter()
        ring = self._registry.timeseries()
        with self._lock:
            counts = {n: tuple(c) for n, c in self._counts.items()}
            objectives = dict(self._objectives)
        out: Dict[str, Dict[str, float]] = {}
        for name, obj in objectives.items():
            good, total = counts.get(name, (0, 0))
            key_total = f'slo_events_total{{objective="{name}"}}'
            key_good = f'slo_good_total{{objective="{name}"}}'
            rates: Dict[str, float] = {}
            for w in (self._fast, self._slow):
                base_total = base_good = 0.0
                for entry in reversed(ring):
                    if entry["t"] <= now - w \
                            and key_total in entry["values"]:
                        base_total = entry["values"][key_total]
                        base_good = entry["values"].get(key_good, 0.0)
                        break
                d_total = total - base_total
                d_bad = (total - good) - (base_total - base_good)
                burn = 0.0
                if d_total > 0:
                    burn = (d_bad / d_total) / obj.error_budget
                rates[self._window_label(w)] = burn
            out[name] = rates
        return out

    def report(self) -> Dict[str, Any]:
        """The JSON SLO report ``EngineFleet.stats()`` embeds: per-
        objective exact attainment + burn rates, per-replica goodput."""
        rates = self.burn_rates()
        with self._lock:
            counts = {n: tuple(c) for n, c in self._counts.items()}
            objectives = dict(self._objectives)
            recorders = dict(self._recorders)
        objs: Dict[str, Any] = {}
        for name, obj in objectives.items():
            good, total = counts.get(name, (0, 0))
            objs[name] = {"metric": obj.metric,
                          "target_ms": obj.target_ms,
                          "goal": obj.goal,
                          "good": good, "total": total,
                          "attainment": (good / total) if total else None,
                          "burn_rate": rates.get(name, {})}
        goodput: Dict[str, float] = {}
        for key, ref in recorders.items():
            rec = ref()
            if rec is None:
                continue
            try:
                goodput[key] = rec.goodput(self._fast)["goodput_rps"]
            except Exception:                            # noqa: BLE001
                continue
        return {"objectives": objs, "goodput_rps": goodput,
                "windows_s": {"fast": self._fast, "slow": self._slow}}

    # -- registry collector -------------------------------------------------
    def _samples(self):
        """Scrape-time collector: counters first (the sampler ring
        records them, closing the burn-rate loop), then the derived
        gauges."""
        with self._lock:
            counts = {n: tuple(c) for n, c in self._counts.items()}
            objectives = dict(self._objectives)
            recorders = dict(self._recorders)
        out = []
        for name in objectives:
            good, total = counts.get(name, (0, 0))
            out.append(("counter", "slo_events_total",
                        {"objective": name}, total))
            out.append(("counter", "slo_good_total",
                        {"objective": name}, good))
            if total:
                out.append(("gauge", "slo_attainment",
                            {"objective": name}, good / total))
        for name, rates in self.burn_rates().items():
            for wlab, burn in rates.items():
                out.append(("gauge", "slo_burn_rate",
                            {"objective": name, "window": wlab}, burn))
        for key, ref in recorders.items():
            rec = ref()
            if rec is None:
                continue
            try:
                g = rec.goodput(self._fast)
            except Exception:                            # noqa: BLE001
                continue
            out.append(("gauge", "goodput_rps", {"engine": key},
                        g["goodput_rps"]))
        return out

    def close(self) -> None:
        self._registry.unregister_collector(self._collector)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    def __repr__(self):
        with self._lock:
            return (f"<SLOTracker {self._name!r} "
                    f"objectives={list(self._objectives)} "
                    f"replicas={list(self._recorders)}>")
