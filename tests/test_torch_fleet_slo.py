"""The port's fleet, SLO plane and ops server
(``paddle_tpu_torch/serving/{fleet,slo,opsserver}.py``) against the JAX
package's, on the CPU.

* routing: a port ``EngineFleet`` and a JAX one over stub replicas of
  the same script (block gauges that fill as requests land, refusals on
  given submits) send every request to the same replica — round-robin
  rotation, load order, the prefix pin (``_prefix_pin_key``) and
  spill-over on ``QueueFullError``/``PoolCapacityError`` — and raise the
  same error when every replica refuses; the fleets' ``stats()`` agree
  (summed counters, pooled percentiles, the tier split, tenants);
* the SLO plane: ``attainment_from_buckets`` and ``burn_rates``/
  ``report`` give the same numbers on the same traces and buckets;
* the ops server: each route's status code (``/timeline`` answers 200
  with the unified chrome-trace document), a poisoned replica flips
  ``/healthz`` but not ``/readyz``, binding anywhere but 127.0.0.1
  raises; a real two-replica fleet of tiny port engines with an SLO
  tracker behind a front door puts its ``serving fleets`` statusz
  section, its series and the SLO report on the wire.

Exact; burn rates and attainment to 1e-12 (the same float arithmetic).
"""
import json
import urllib.error
import urllib.request

import numpy as np
import pytest

from paddle_tpu.framework import metrics as JM
from paddle_tpu.serving import fleet as jfleet
from paddle_tpu.serving import paging as jpaging
from paddle_tpu.serving import scheduler as jsched
from paddle_tpu.serving import slo as jslo
from paddle_tpu_torch.framework import metrics as TM
from paddle_tpu_torch.serving import fleet as tfleet
from paddle_tpu_torch.serving import opsserver as tops
from paddle_tpu_torch.serving import paging as tpaging
from paddle_tpu_torch.serving import scheduler as tsched
from paddle_tpu_torch.serving import slo as tslo

PKG = {"jax": (jfleet, jsched, jpaging, jslo, JM),
       "torch": (tfleet, tsched, tpaging, tslo, TM)}


class _Recorder:
    def __init__(self, ttft, tpot):
        self._ttft, self._tpot = list(ttft), list(tpot)

    def latency_samples(self):
        return {"ttft_ms": list(self._ttft), "tpot_ms": list(self._tpot)}


class _Replica:
    """A stub engine: its used blocks grow by a prompt's blocks at each
    accepted submit; ``refuse[k]`` names the error of its k-th submit."""

    def __init__(self, idx, errors, blocks=(0, 16), refuse=(),
                 ttft=(), tpot=(), tenants=None, tier=None,
                 fail_stats=False):
        self.idx = idx
        self._errors = errors
        self.used, self.total = blocks
        self.refuse = dict(refuse)
        self.calls = 0
        self.flight_recorder = _Recorder(ttft, tpot)
        self.tenants = tenants
        self.tier = tier
        self.fail_stats = fail_stats

    def submit(self, prompt_ids, max_new_tokens=32, **kw):
        k, self.calls = self.calls, self.calls + 1
        if k in self.refuse:
            raise self._errors[self.refuse[k]]("refused")
        self.used += -(-len(prompt_ids) // 8)
        return self.idx

    def stats(self):
        if self.fail_stats:
            raise RuntimeError("scheduler thread is dead")
        s = {"queue_depth": 0, "active_requests": 1, "num_slots": 4,
             "slots_in_use": 1, "slot_utilization": 0.25, "preempts": 1,
             "requests_retired": 3 + self.idx, "nonfinite_cycles": 0,
             "num_blocks": self.total, "kv_blocks_in_use": self.used,
             "prefix_hits": 2, "prefix_misses": 1, "block_size": 8,
             "kv_pool_capacity_bytes": 1000, "kv_bytes_in_use": 10}
        if self.tier is not None:
            s["tier_hits"] = dict(self.tier)
        if self.tenants is not None:
            s["tenants"] = self.tenants
        return s

    def close(self, cancel_pending=False):
        pass


def _fleet(package, specs, **kw):
    fleet_mod, sched_mod, paging_mod = PKG[package][:3]
    errors = {"full": sched_mod.QueueFullError,
              "capacity": paging_mod.PoolCapacityError}
    reps = [_Replica(i, errors, **spec) for i, spec in enumerate(specs)]
    return fleet_mod.EngineFleet(reps, **kw)


def _route(package, specs, prompts, **kw):
    """The replica each prompt landed on, or the refusal's class name."""
    f = _fleet(package, specs, **kw)
    out = []
    try:
        for p in prompts:
            try:
                out.append(f.submit(p, 4))
            except Exception as e:                       # noqa: BLE001
                out.append(type(e).__name__)
        return out, f.stats()
    finally:
        f.close()


_rng = np.random.RandomState(0)
_SYSTEMS = [list(range(1 + 10 * j, 9 + 10 * j)) for j in range(3)]
PROMPTS = [(_SYSTEMS[int(_rng.randint(3))] if _rng.rand() < 0.7 else [])
           + list(_rng.randint(50, 90, int(_rng.randint(1, 12))))
           for _ in range(24)]

SCRIPTS = {
    "rr, spill on a full queue": (
        [dict(refuse={2: "full", 3: "full"}), dict(), dict(
            refuse={1: "capacity"})], {}),
    "load order": ([dict(blocks=(4, 16)), dict(blocks=(0, 16)),
                    dict(blocks=(2, 16), refuse={0: "full"})],
                   {"route": "load"}),
    "affinity pins and spills": (
        [dict(), dict(refuse={1: "full", 2: "full"}), dict(blocks=(1, 16))],
        {"route": "affinity"}),
    "affinity, explicit block": ([dict(), dict()],
                                 {"route": "affinity", "affinity_block": 4}),
    "every replica refuses": (
        [dict(refuse={k: "full" for k in range(30)}),
         dict(refuse={k: "capacity" for k in range(30)})], {}),
}


@pytest.mark.parametrize("script", sorted(SCRIPTS))
def test_fleet_routes_like_the_jax_fleet(script):
    specs, kw = SCRIPTS[script]
    got, _ = _route("torch", specs, PROMPTS, **kw)
    want, _ = _route("jax", specs, PROMPTS, **kw)
    assert got == want
    if script == "every replica refuses":
        # the last refusal propagates: the rotation decides whose
        assert set(got) == {"PoolCapacityError", "QueueFullError"}
    else:
        assert len(set(got)) > 1 or kw.get("route") == "affinity"


def test_fleet_pin_key_matches_jax():
    for prompt in PROMPTS:
        keys = [_fleet(p, [dict()], route="affinity")._prefix_pin_key(
            prompt) for p in ("torch", "jax")]
        assert keys[0] == keys[1]


def test_fleet_stats_match_jax():
    rng = np.random.RandomState(1)
    specs = [dict(ttft=rng.gamma(2.0, 30.0, 40), tpot=rng.gamma(2.0, 5.0, 90),
                  tier={"hbm": 3, "host": 1 + i, "miss": 2},
                  tenants={"acme": {"retired": 2 + i, "goodput_rps": 0.5}})
             for i in range(2)] + [dict(fail_stats=True)]
    stats = [_route(p, specs, [])[1] for p in ("torch", "jax")]
    for s in stats:
        s.pop("fleet")
    assert stats[0] == stats[1]
    assert stats[0]["replicas_healthy"] == 2
    assert stats[0]["tier_hits"] == {"hbm": 6, "host": 3, "miss": 4}
    assert stats[0]["tenants"]["acme"]["retired"] == 5


# ---------------------------------------------------------------------------
# the SLO plane
# ---------------------------------------------------------------------------

class _Trace:
    def __init__(self, ttft_ms, tpot_ms=None):
        self.ttft_ms, self.tpot_ms = ttft_ms, tpot_ms


def test_attainment_from_buckets_matches_jax():
    rng = np.random.RandomState(2)
    for _ in range(20):
        les = sorted(set(rng.choice([1, 5, 10, 25, 50, 100, 250, 500,
                                     float("inf")], 6)))
        cum = list(np.cumsum(rng.randint(0, 9, len(les))))
        pairs = list(zip(les, cum))
        for target in (0.5, 10.0, 99.0, 250.0, 1e4):
            assert tslo.attainment_from_buckets(pairs, target) == \
                jslo.attainment_from_buckets(pairs, target)
    assert tslo.attainment_from_buckets([], 1.0) == (None, None)


def _tracker(package, traces_before, traces_after):
    slo_mod, metrics_mod = PKG[package][3], PKG[package][4]
    reg = metrics_mod.MetricsRegistry(include_monitor=False)
    t = slo_mod.SLOTracker(registry=reg, name="parity")
    t.add_objective("ttft", "ttft_ms", 100.0, 0.9)
    t.add_objective("tpot", "tpot_ms", 20.0, 0.95)
    for tr in traces_before:
        t.observe_trace(tr)
    reg.sample_now()
    reg._ring[-1]["t"] -= 120.0     # a baseline past the fast window
    for tr in traces_after:
        t.observe_trace(tr)
    rates, report = t.burn_rates(), t.report()
    scrape = reg.to_prometheus()
    t.close()
    return rates, report, scrape


def test_burn_rates_and_report_match_jax():
    rng = np.random.RandomState(3)
    before = [_Trace(float(v), float(w)) for v, w in
              zip(rng.gamma(2, 30, 30), rng.gamma(2, 6, 30))]
    after = [_Trace(float(v), None) for v in rng.gamma(3, 60, 12)]
    got = _tracker("torch", before, after)
    want = _tracker("jax", before, after)
    for name in ("ttft", "tpot"):
        for w in ("1m", "30m"):
            assert got[0][name][w] == pytest.approx(want[0][name][w],
                                                    abs=1e-12)
    assert got[1]["objectives"] == want[1]["objectives"]
    assert got[0]["ttft"]["1m"] > 0
    assert "slo_latency_ms_bucket" in got[2]
    with pytest.raises(ValueError):
        tslo.SLOObjective("x", "latency_ms", 100.0, 0.9)
    with pytest.raises(ValueError):
        tslo.SLOObjective("x", "ttft_ms", 100.0, 1.0)


# ---------------------------------------------------------------------------
# the ops server
# ---------------------------------------------------------------------------

def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=30) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def test_ops_server_routes_and_codes():
    specs = [dict(), dict(fail_stats=True)]
    f = _fleet("torch", specs)
    srv = tops.OpsServer(target=f).start()
    try:
        assert srv.url.startswith("http://127.0.0.1:")
        codes = {p: _get(srv.url + p)[0] for p in (
            "/metrics", "/varz", "/statusz", "/readyz", "/tracez", "/",
            "/healthz", "/timeline", "/nope")}
        assert codes == {"/metrics": 200, "/varz": 200, "/statusz": 200,
                         "/readyz": 200, "/tracez": 200, "/": 200,
                         "/healthz": 503, "/timeline": 200, "/nope": 404}
        doc = json.loads(_get(srv.url + "/timeline")[1])
        assert doc["displayTimeUnit"] == "ms"
        assert doc["traceEvents"][0]["name"] == "process_name"
        health = json.loads(_get(srv.url + "/healthz")[1])
        assert health["unhealthy"] == [1]
        index = json.loads(_get(srv.url + "/")[1])
        assert "/timeline" in index["endpoints"]
    finally:
        srv.close()
        srv.close()                      # idempotent
        f.close()
    assert srv.url is None
    with pytest.raises(ValueError, match="loopback"):
        tops.OpsServer(host="0.0.0.0")


def test_real_fleet_behind_the_front_door():
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.models import GPTConfig, GPTForPretraining
    from paddle_tpu_torch.serving import (EngineFleet, FrontDoor,
                                          GenerationEngine, SLOTracker)
    pt.seed(3)
    model = GPTForPretraining(GPTConfig.tiny()).eval()
    engines = [GenerationEngine(model, num_slots=2, max_len=32,
                                kv_layout="paged", block_size=8,
                                device="cpu") for _ in range(2)]
    fleet = EngineFleet(engines, name="door-fleet")
    slo = SLOTracker(name="door-slo")
    slo.add_objective("ttft", "ttft_ms", 60_000.0, 0.99)
    fleet.attach_slo(slo)
    ops = tops.OpsServer(target=fleet, slo=slo)
    FrontDoor(fleet).mount(ops)
    try:
        url = ops.start().url
        for i, tenant in enumerate(("acme", "acme", "zoo", "acme")):
            req = urllib.request.Request(
                url + "/v1/completions",
                data=json.dumps({"prompt": [3 + i, 4, 5],
                                 "max_tokens": 3}).encode(),
                headers={"Content-Type": "application/json",
                         "X-Tenant": tenant})
            with urllib.request.urlopen(req, timeout=60) as r:
                assert len(json.loads(r.read())["choices"][0][
                    "token_ids"]) == 3
        s = fleet.stats()
        assert s["requests_retired"] == 4
        assert all(e.stats()["requests_retired"] == 2 for e in engines)
        assert s["tenants"]["acme"]["retired"] == 3
        assert s["slo"]["objectives"]["ttft"]["total"] == 4
        assert s["tier_hits"]["miss"] == 4
        assert "serving fleets" in _get(url + "/statusz")[1]
        parsed = TM.parse_prometheus(_get(url + "/metrics")[1])
        assert "serving_replica_healthy" in parsed["types"]
        assert "slo_events_total" in parsed["types"]
        tracez = json.loads(_get(url + "/tracez")[1])
        assert set(tracez["engines"]) == {"0", "1"}
        assert tracez["slo"]["objectives"]["ttft"]["good"] == 4
    finally:
        ops.close()
        fleet.close()
        slo.close()
