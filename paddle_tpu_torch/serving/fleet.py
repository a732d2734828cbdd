"""EngineFleet (counterpart of ``paddle_tpu/serving/fleet.py``): N
``GenerationEngine`` replicas behind one submit and one stats surface.

Aggregation is not averaging: counters SUM over healthy replicas,
per-replica occupancy stays per replica, and latency percentiles come
from POOLING the replicas' raw reservoirs into bucketed histograms
(:class:`~..framework.metrics.HistValue`: summed bucket counts give the
fleet percentile to bin width).

Dispatch (``route=``): ``"rr"`` (default) — round-robin with spill-over
on backpressure (a replica raising ``QueueFullError`` or a capacity
error passes the request to the next; only when every replica refuses
does the last error propagate); ``"load"`` — replicas ranked by most
free blocks (free slots as the dense fallback), unhealthy last, the
rotation breaking ties; ``"affinity"`` — the prompt's block-aligned
prefix (the unit the prefix trie keys on) pins the replica that first
admitted it, so a hot system prompt stays a prefix-cache hit there.

A poisoned replica (its ``stats()`` raising) reports ``healthy: False``
with its error while the aggregates cover the healthy rest. The fleet
publishes per-replica gauges (``{fleet=, engine=}``) through a registry
collector and a ``serving fleets`` statusz section. Replicas may share
one model (its weights are only read) and one card: each has its own
scheduler thread and pool.
"""
from __future__ import annotations

import itertools
import threading
import weakref
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..framework import metrics as _metrics
from ..framework.metrics import HistValue
from .paging import PoolCapacityError, PoolExhaustedError
from .scheduler import QueueFullError

__all__ = ["EngineFleet"]

# stats() keys that SUM across healthy replicas (lifetime counters and
# additive point-in-time totals)
_SUMMED_KEYS = (
    "queue_depth", "active_requests", "num_slots", "slots_in_use",
    "preempts", "requests_retired", "nonfinite_cycles", "num_blocks",
    "kv_blocks_in_use", "cached_blocks", "prefix_hits", "prefix_misses",
    "prefill_tokens_saved", "prefix_evictions", "kv_pool_capacity_bytes",
    "kv_bytes_in_use", "prefill_chunks", "chunked_prefill_tokens",
    "spec_cycles", "spec_proposed", "spec_accepted",
)
# throughput-style keys that also sum (per-replica rates are additive)
_SUMMED_RATES = ("decode_tokens_per_sec", "serving_flops_per_sec",
                 "chunked_prefill_tokens_per_sec")

_fleet_seq = itertools.count()
_LIVE_FLEETS: "weakref.WeakSet[EngineFleet]" = weakref.WeakSet()
_section_registered = False


class EngineFleet:
    """Wrap N engines; aggregate their stats; spill submissions."""

    #: dispatch policies (see module docstring); "rr" is the default
    ROUTES = ("rr", "load", "affinity")

    def __init__(self, engines: Sequence[Any], name: Optional[str] = None,
                 *, route: str = "rr",
                 affinity_block: Optional[int] = None,
                 slo: Optional[Any] = None):
        if not engines:
            raise ValueError("EngineFleet needs at least one engine")
        if route not in self.ROUTES:
            raise ValueError(
                f"route must be one of {self.ROUTES}, got {route!r}")
        if affinity_block is not None and int(affinity_block) < 1:
            raise ValueError(
                f"affinity_block must be >= 1, got {affinity_block}")
        self._engines = list(engines)
        self._name = name or f"fleet{next(_fleet_seq)}"
        self._route = route
        # affinity prefix granularity: explicit, else the replicas' own
        # paged block_size (read lazily from stats), else one min-bucket
        self._affinity_block = (int(affinity_block)
                                if affinity_block is not None else None)
        # prefix-hash -> replica index (host dict, lock-guarded); the
        # pin is advisory — spill always wins over affinity
        self._pins: Dict[int, int] = {}
        self._rr = itertools.cycle(range(len(self._engines)))
        self._lock = threading.Lock()
        self._closed = False
        # SLO plane (serving/slo.py): an attached tracker hooks every
        # replica's flight recorder and its report rides stats()
        self._slo = None
        if slo is not None:
            self.attach_slo(slo)
        _LIVE_FLEETS.add(self)
        _register_fleet_telemetry()
        # scrape-time collector: per-replica gauges under the fleet
        # label (weakref — a dropped fleet stops being scraped)
        ref = weakref.ref(self)

        def _collect():
            f = ref()
            return f._metric_samples() if f is not None else ()
        _metrics.register_collector(f"serving_fleet/{self._name}",
                                    _collect)

    def attach_slo(self, tracker) -> None:
        """Attach an :class:`~.slo.SLOTracker`: every replica's retired
        traces feed its objectives (replica keys = fleet indices) and
        ``stats()`` gains the ``slo`` report + per-replica goodput."""
        tracker.attach_fleet(self)
        self._slo = tracker

    @property
    def slo(self):
        return self._slo

    # -- dispatch ----------------------------------------------------------
    def _rotation(self) -> List[int]:
        """Round-robin visit order: the rotation start advances once
        per submit, so equal replicas share admissions."""
        with self._lock:
            start = next(self._rr)
        n = len(self._engines)
        return [(start + i) % n for i in range(n)]

    def _load_order(self) -> List[int]:
        """Rotation order re-ranked by load: healthy replicas first,
        MOST free blocks first (free slots as the dense tie-breaker /
        fallback), the round-robin rotation breaking exact ties — a
        stable sort over the rotated list, so equally-loaded replicas
        still take turns."""
        reps = {r["replica"]: r for r in self._replica_stats()}

        def rank(i):
            r = reps[i]
            if not r["healthy"]:
                return (1, 0, 0)
            blocks = r.get("num_blocks"), r.get("kv_blocks_in_use")
            free_b = (blocks[0] - blocks[1]
                      if None not in blocks else -1)
            slots = r.get("num_slots"), r.get("slots_in_use")
            free_s = (slots[0] - slots[1]
                      if None not in slots else -1)
            return (0, -free_b, -free_s)
        return sorted(self._rotation(), key=rank)

    def _prefix_pin_key(self, prompt_ids) -> Optional[int]:
        """Affinity key: hash of the prompt's BLOCK-ALIGNED prefix —
        the exact unit the paged prefix-cache trie keys on, so two
        prompts share a pin iff they could share cached blocks. None
        when the prompt doesn't cover one full block (nothing cacheable
        to be affine to)."""
        ids = np.asarray(prompt_ids, np.int32).reshape(-1)
        bs = self._affinity_block
        if bs is None:
            for r in self._replica_stats():
                if r["healthy"] and r.get("block_size"):
                    bs = int(r["block_size"])
                    break
            else:
                bs = 16
            self._affinity_block = bs
        m = (ids.size // bs) * bs
        if m < bs:
            return None
        return hash(tuple(int(t) for t in ids[:m]))

    def _submit_order(self, prompt_ids) -> Tuple[List[int], Optional[int]]:
        """(replica visit order, affinity key to pin on success)."""
        if self._route == "rr":
            return self._rotation(), None
        order = self._load_order()
        if self._route == "load":
            return order, None
        key = self._prefix_pin_key(prompt_ids)
        if key is None:
            return order, None
        with self._lock:
            pinned = self._pins.get(key)
        if pinned is not None and pinned in order:
            order.remove(pinned)
            order.insert(0, pinned)
        return order, key

    def submit(self, prompt_ids, max_new_tokens: int = 32, **kwargs):
        """Routed submit with spill-over: replicas are visited in the
        active policy's order (round-robin rotation, load rank, or
        pinned-replica-first — see the class docstring); a replica
        refusing with backpressure/capacity (QueueFullError,
        PoolCapacityError, a closed engine) passes the request on.
        When every replica refuses, the LAST error propagates. Returns
        the accepted replica's handle (``handle.trace`` etc.
        unchanged)."""
        if self._closed:
            raise RuntimeError("EngineFleet is closed")
        order, key = self._submit_order(prompt_ids)
        last_err: Optional[BaseException] = None
        for i in order:
            eng = self._engines[i]
            try:
                handle = eng.submit(prompt_ids, max_new_tokens, **kwargs)
            except (QueueFullError, PoolCapacityError,
                    PoolExhaustedError) as e:
                last_err = e        # backpressure/capacity: try the next
                # (PoolCapacityError IS a ValueError — it must be
                # caught before the malformed-request clause below)
            except (ValueError, TypeError):
                raise               # a malformed request fails everywhere
            except Exception as e:                       # noqa: BLE001
                last_err = e        # closed/poisoned: try the next
            else:
                if key is not None:
                    # pin follows the ACCEPTING replica: a spilled-over
                    # hot prefix warms its new home's cache, so later
                    # requests chase the blocks, not the original pin
                    with self._lock:
                        self._pins[key] = i
                return handle
        assert last_err is not None
        raise last_err

    def close(self, cancel_pending: bool = False) -> None:
        """Close every replica (each best-effort: one replica's broken
        close must not leak the rest)."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
        _metrics.unregister_collector(f"serving_fleet/{self._name}")
        for eng in self._engines:
            try:
                eng.close(cancel_pending=cancel_pending)
            except Exception:                            # noqa: BLE001
                continue

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    def __len__(self) -> int:
        return len(self._engines)

    @property
    def name(self) -> str:
        return self._name

    @property
    def replicas(self) -> List[Any]:
        return list(self._engines)

    # -- aggregation -------------------------------------------------------
    def _replica_stats(self) -> List[Dict[str, Any]]:
        """Per-replica stats() snapshots, fault-isolated: a poisoned
        replica yields ``{healthy: False, error: repr}`` instead of
        killing the collection."""
        out = []
        for i, eng in enumerate(self._engines):
            try:
                s = dict(eng.stats())
                s["healthy"] = True
            except Exception as e:                       # noqa: BLE001
                s = {"healthy": False, "error": repr(e)}
            s["replica"] = i
            out.append(s)
        return out

    def _pooled_latency(self) -> Dict[str, Optional[dict]]:
        """Fleet TTFT/TPOT: each healthy replica's raw reservoir
        becomes a bucketed histogram; the bucket MERGE is the fleet
        distribution (percentiles exact to bin width vs pooling the
        raw samples — the acceptance tolerance)."""
        merged: Dict[str, Optional[HistValue]] = {"ttft_ms": None,
                                                  "tpot_ms": None}
        for eng in self._engines:
            try:
                samples = eng.flight_recorder.latency_samples()
            except Exception:                            # noqa: BLE001
                continue
            for key in merged:
                vals = samples.get(key) or []
                if not vals:
                    continue
                h = HistValue.from_samples(vals)
                merged[key] = h if merged[key] is None \
                    else merged[key].merge(h)
        return {k: (h.summary() if h is not None else None)
                for k, h in merged.items()}

    def stats(self) -> Dict[str, Any]:
        """The fleet operator snapshot: summed counters over healthy
        replicas, pooled latency percentiles, fleet-derived ratios, and
        the full per-replica gauge list (the router's future input:
        free slots/blocks, occupancy, health)."""
        reps = self._replica_stats()
        healthy = [r for r in reps if r["healthy"]]
        agg: Dict[str, Any] = {
            "fleet": self._name,
            "route": self._route,
            "replicas_total": len(reps),
            "replicas_healthy": len(healthy),
        }
        for key in _SUMMED_KEYS + _SUMMED_RATES:
            vals = [r[key] for r in healthy
                    if isinstance(r.get(key), (int, float))]
            if vals:
                agg[key] = type(vals[0])(sum(vals))
        if agg.get("num_slots"):
            agg["slot_utilization"] = \
                agg.get("slots_in_use", 0) / agg["num_slots"]
        if agg.get("num_blocks"):
            agg["block_utilization"] = \
                agg.get("kv_blocks_in_use", 0) / agg["num_blocks"]
        hits = agg.get("prefix_hits")
        if hits is not None:
            agg["prefix_hit_ratio"] = \
                hits / max(1, hits + agg.get("prefix_misses", 0))
        # tiered hit split summed across healthy replicas, re-derived
        # as fleet-level ratios (the aggregate prefix_hit_ratio above
        # stays for dashboards)
        th = {"hbm": 0, "host": 0, "miss": 0}
        tiered = False
        for r in healthy:
            for k, v in (r.get("tier_hits") or {}).items():
                th[k] = th.get(k, 0) + v
                tiered = True
        if tiered:
            denom = max(1, sum(th.values()))
            agg["tier_hits"] = th
            agg["prefix_hit_hbm"] = th["hbm"] / denom
            agg["prefix_hit_host"] = th["host"] / denom
            agg["prefix_miss"] = th["miss"] / denom
        if agg.get("spec_proposed"):
            agg["spec_accept_rate"] = \
                agg.get("spec_accepted", 0) / agg["spec_proposed"]
        # per-tenant goodput split summed across healthy replicas (the
        # front door's multi-tenancy plane — a tenant's traffic may be
        # routed anywhere, so only the fleet sum is the tenant's truth)
        tenants: Dict[str, Dict[str, Any]] = {}
        for r in healthy:
            for t, ts in (r.get("tenants") or {}).items():
                row = tenants.setdefault(
                    t, {"retired": 0, "goodput_rps": 0.0})
                row["retired"] += ts.get("retired", 0)
                row["goodput_rps"] += ts.get("goodput_rps", 0.0)
        if tenants:
            agg["tenants"] = tenants
        agg.update(self._pooled_latency())
        # SLO plane: exact attainment + burn rates + per-replica
        # goodput, fault-isolated like everything else on this surface
        goodput: Dict[str, float] = {}
        if self._slo is not None:
            try:
                rep = self._slo.report()
                agg["slo"] = rep
                goodput = rep.get("goodput_rps") or {}
                if goodput:
                    agg["goodput_rps"] = float(sum(goodput.values()))
            except Exception as e:                       # noqa: BLE001
                agg["slo"] = {"error": repr(e)}
        # per-replica view: identity + the load/health gauges a router
        # dispatches on, straight from each replica's own stats
        agg["replicas"] = [{
            "replica": r["replica"],
            "healthy": r["healthy"],
            **({"error": r["error"]} if not r["healthy"] else {}),
            "queue_depth": r.get("queue_depth"),
            "active_requests": r.get("active_requests"),
            "slots_in_use": r.get("slots_in_use"),
            "slot_utilization": r.get("slot_utilization"),
            "free_slots": (r["num_slots"] - r["slots_in_use"])
            if r.get("num_slots") is not None
            and r.get("slots_in_use") is not None else None,
            "free_blocks": (r["num_blocks"] - r["kv_blocks_in_use"])
            if r.get("num_blocks") is not None
            and r.get("kv_blocks_in_use") is not None else None,
            "kv_bytes_in_use": r.get("kv_bytes_in_use"),
            "prefix_hit_ratio": r.get("prefix_hit_ratio"),
            "goodput_rps": goodput.get(str(r["replica"])),
        } for r in reps]
        return agg

    # -- telemetry wiring --------------------------------------------------
    def _metric_samples(self):
        """Registry collector payload: per-replica gauges labeled
        ``{fleet, engine}`` plus fleet-level counters."""
        if self._closed:
            return ()
        out = []
        for r in self._replica_stats():
            labels = {"fleet": self._name, "engine": str(r["replica"])}
            out.append(("gauge", "serving_replica_healthy", labels,
                        1.0 if r["healthy"] else 0.0))
            if not r["healthy"]:
                continue
            for key, metric in (("queue_depth", "serving_queue_depth"),
                                ("slots_in_use", "serving_slots_in_use"),
                                ("kv_blocks_in_use",
                                 "serving_kv_blocks_in_use"),
                                ("kv_bytes_in_use",
                                 "serving_kv_bytes_in_use")):
                v = r.get(key)
                if isinstance(v, (int, float)):
                    out.append(("gauge", metric, labels, float(v)))
            v = r.get("requests_retired")
            if isinstance(v, (int, float)):
                out.append(("counter", "serving_requests_retired",
                            labels, float(v)))
        return out


def _fleet_section() -> str:
    fleets = [f for f in list(_LIVE_FLEETS) if not f._closed]
    if not fleets:
        return "(no fleets)"
    lines = []
    for f in fleets:
        s = f.stats()
        ttft = s.get("ttft_ms")
        head = (f"fleet {s['fleet']}: {s['replicas_healthy']}/"
                f"{s['replicas_total']} healthy, "
                f"retired {s.get('requests_retired', 0)}")
        if ttft:
            head += f", ttft p50 {ttft['p50']:.1f} ms"
        lines.append(head)
        slo = s.get("slo") or {}
        for oname, o in sorted((slo.get("objectives") or {}).items()):
            att = o.get("attainment")
            burns = o.get("burn_rate") or {}
            burn_txt = " ".join(f"burn[{w}]={b:.2f}"
                                for w, b in sorted(burns.items()))
            lines.append(
                f"  slo {oname}: {o['metric']} <= {o['target_ms']:g}ms "
                f"goal {o['goal']:.2%} attainment "
                + (f"{att:.2%}" if att is not None else "n/a")
                + (f" {burn_txt}" if burn_txt else ""))
        for r in s["replicas"]:
            mark = "ok " if r["healthy"] else "DOWN"
            lines.append(
                f"  [{r['replica']}] {mark} queue={r['queue_depth']} "
                f"active={r['active_requests']} "
                f"free_slots={r['free_slots']} "
                f"free_blocks={r['free_blocks']}"
                + (f" err={r.get('error')}" if not r["healthy"] else ""))
    return "\n".join(lines)


def _register_fleet_telemetry() -> None:
    global _section_registered
    if not _section_registered:
        _metrics.register_statusz_section("serving fleets",
                                          _fleet_section)
        _section_registered = True
