"""The serving telemetry of the PyTorch port against the JAX package's, on
the CPU:

* ``FlightRecorder``: the same ``record_cycle``/``record_event``/
  ``retire`` calls, under one fixed clock, give equal ``snapshot()``,
  ``latency_summary()``, ``cycle_throughput()``, ``goodput()``,
  ``tenant_summary()``, ``tail_traces()`` and ``dump()`` documents in
  both packages; retire hooks, ``auto_dump`` into
  ``FLAGS_flight_dump_dir``;
* ``RequestTrace``: the same marks give equal ``timeline()``,
  ``snapshot()``, ``admission_wait_ms`` and ``decode_intervals_ms``;
* the scheduler's load hints: both schedulers driven through the same
  full queue and the same expired request stamp equal ``queue_depth`` on
  ``QueueFullError`` and ``DeadlineExceeded``, and ``est_wait_s`` is None
  in both before two admissions and a number in both after (it is wall
  time, so only its presence is compared);
* the port's engine: its cycles and events land in its recorder, its
  ``stats()`` percentiles come from it, ``dump_flight_recorder(path)``
  writes JSON that parses, and a failed cycle dumps the recorder.
"""
import json
import os
import threading
import time

import numpy as np
import pytest
import torch

from paddle_tpu.serving import flight_recorder as jfr
from paddle_tpu.serving import kv_pool as jkv
from paddle_tpu.serving import scheduler as jsched
from paddle_tpu.serving import tracing as jtr
from paddle_tpu_torch.models import GPTConfig, GPTForPretraining
from paddle_tpu_torch.serving import GenerationEngine
from paddle_tpu_torch.serving import flight_recorder as tfr
from paddle_tpu_torch.serving import kv_pool as tkv
from paddle_tpu_torch.serving import scheduler as tsched
from paddle_tpu_torch.serving import tracing as ttr


@pytest.fixture
def clock(monkeypatch):
    """A settable ``time.perf_counter`` (both recorders read it)."""
    now = [1000.0]
    monkeypatch.setattr(time, "perf_counter", lambda: now[0])
    monkeypatch.setattr(time, "time", lambda: 1.7e9 + now[0])
    return now


def _trace(mod, rid, t0, tenant, ttft, n_tokens, preempt=False):
    tr = mod.RequestTrace(rid, t_submit=t0, tenant=tenant, lane="batch")
    tr.mark("admitted", t=t0 + 0.004, slot=rid % 3, bucket=None, feed=7)
    if preempt:
        tr.mark("preempt", t=t0 + 0.006, emitted=0)
    tr.mark("prefix_hit", t=t0 + 0.005, tokens_saved=16, pending=3)
    for i in range(n_tokens):
        tr.stamp_token(t0 + ttft / 1e3 + 0.0125 * i)
    tr.mark("finish", t=t0 + ttft / 1e3 + 0.0125 * n_tokens)
    return tr


def _drive(mod, tmod, clock):
    """One scripted history for a recorder of ``mod`` (traces from
    ``tmod``)."""
    rec = mod.FlightRecorder(max_cycles=4, max_events=6, tail_keep=2,
                             recent_traces=3)
    seen = []
    rec.add_retire_hook(lambda tr: seen.append(tr.request_id))
    rec.add_retire_hook(lambda tr: 1 / 0)        # a broken observer
    rec.set_tail_slo(40.0)
    for c in range(6):
        clock[0] = 1000.0 + c
        rec.record_cycle({"cycle": c + 1, "t": clock[0], "cycle_ms": 2.5 + c,
                          "decode_dispatch_ms": 1.0 if c % 2 else 0.0,
                          "emitted": c, "chunk_tokens": 3 * c,
                          "prefill_chunks": c % 3, "spec_proposed": 4,
                          "spec_accepted": c % 4, "spec_emitted": 1 + c % 4,
                          "spec_slots": 1, "spec_draft_dispatches": 1})
        rec.record_event(c, "submit", t=clock[0],
                         meta={"tenant": "t", "lane": "batch"})
        rec.record_event(c, "first_token")
    for i, (tenant, ttft, n) in enumerate(
            [("a", 12.0, 5), ("b", 55.0, 1), ("a", 31.0, 3), ("b", 80.0, 0),
             ("a", 47.5, 9)]):
        clock[0] = 1010.0 + 7 * i
        rec.retire(_trace(tmod, i, clock[0] - 1.0, tenant, ttft, n,
                          preempt=i == 2))
    clock[0] = 1050.0
    return rec, seen


def test_flight_recorder_matches_jax(clock, tmp_path):
    recs = {}
    for name, mod, tmod in (("jax", jfr, jtr), ("port", tfr, ttr)):
        rec, seen = _drive(mod, tmod, clock)
        recs[name] = {
            "snapshot": rec.snapshot(),
            "latency": rec.latency_summary(),
            "samples": rec.latency_samples(),
            "throughput": rec.cycle_throughput(),
            "goodput": [rec.goodput(), rec.goodput(window_s=30.0),
                        rec.goodput(window_s=10.0, slo_ms=50.0)],
            "tenants": [rec.tenant_summary(), rec.tenant_summary(20.0)],
            "tail": rec.tail_traces(),
            "dump": json.loads(json.dumps(rec.dump(
                str(tmp_path / f"{name}.json"), extra={"x": 1}))),
            "seen": seen, "retired": rec.retired,
            "violations": rec.slo_violations,
        }
        with open(tmp_path / f"{name}.json") as f:
            assert json.load(f) == recs[name]["dump"]
    assert recs["port"] == recs["jax"]
    port = recs["port"]
    # a request without a token has no TTFT, so it violates nothing
    assert port["seen"] == [0, 1, 2, 3, 4] and port["violations"] == 2
    assert len(port["snapshot"]["cycles"]) == 4
    assert port["snapshot"]["cycles_recorded"] == 6
    assert port["throughput"]["spec_emitted"] == sum(
        1 + c % 4 for c in range(2, 6))


def test_auto_dump_goes_to_the_flag_directory(tmp_path, monkeypatch):
    monkeypatch.setenv("FLAGS_flight_dump_dir", str(tmp_path / "dumps"))
    rec = tfr.FlightRecorder()
    rec.record_cycle({"cycle": 1, "failed": "boom"})
    first = rec.auto_dump("RuntimeError('boom')")
    second = rec.auto_dump("again")
    assert first != second and rec.last_dump_path == second
    assert os.path.dirname(first) == str(tmp_path / "dumps")
    with open(first) as f:
        doc = json.load(f)
    assert doc["reason"] == "RuntimeError('boom')"
    assert doc["cycles"] == [{"cycle": 1, "failed": "boom"}]
    assert rec.dumps == 2


def test_request_trace_matches_jax():
    t0 = 50.0
    traces = [_trace(m, 7, t0, "a", 21.0, 4, preempt=True)
              for m in (jtr, ttr)]
    for tr in traces:
        tr.mark("replay_done", t=t0 + 0.03, emitted=2)
    j, t = traces
    assert t.timeline() == j.timeline()
    assert t.snapshot() == j.snapshot()
    assert t.admission_wait_ms == pytest.approx(j.admission_wait_ms) \
        == pytest.approx(4.0)
    assert t.decode_intervals_ms == j.decode_intervals_ms
    assert t.snapshot()["preempts"] == 1 and t.snapshot()["tokens"] == 4
    empty = [m.RequestTrace(1, t_submit=t0) for m in (jtr, ttr)]
    assert empty[1].snapshot() == empty[0].snapshot()
    assert empty[1].admission_wait_ms is None


# -- the scheduler's load hints ------------------------------------------------

def _hints(sched_mod, pool):
    """Drive a 1-slot scheduler with max_queue=1 through two full-queue
    refusals and one request that expires in the queue; returns the
    (queue_depth, est_wait_s is None) of each error."""
    started = {}
    release = {}

    def do_prefill(req, slot, bucket):
        started[req.id].set()
        release[req.id].wait(30)
        return 5

    def do_decode(active):
        raise AssertionError("every request ends at its first token")

    sched = sched_mod.Scheduler(pool, do_prefill, do_decode, max_queue=1)

    def request(timeout=None):
        req = sched_mod.GenerationRequest(np.arange(1, 3), 1,
                                          timeout=timeout)
        started[req.id] = threading.Event()
        release[req.id] = threading.Event()
        return req

    out = []

    def refused():
        with pytest.raises(sched_mod.QueueFullError) as e:
            sched.submit(request())
        out.append((e.value.queue_depth, e.value.est_wait_s is None))

    try:
        a = sched.submit(request())
        assert started[a.id].wait(30)
        b = sched.submit(request())
        refused()                          # one admission so far
        release[a.id].set()
        assert started[b.id].wait(30)      # the second admission
        d = sched.submit(request(timeout=0.05))
        refused()
        time.sleep(0.1)                    # d expires in the queue
        release[b.id].set()
        with pytest.raises(sched_mod.DeadlineExceeded) as e:
            d.result(timeout=30)
        out.append((e.value.queue_depth, e.value.est_wait_s is None))
        assert a.result(timeout=30)[-1] == 5
    finally:
        for ev in release.values():
            ev.set()
        sched.close()
    return out


def test_queue_errors_carry_the_jax_load_hints():
    want = _hints(jsched, jkv.KVCachePool(1, 1, 1, 32, 4))
    got = _hints(tsched, tkv.KVCachePool(1, 1, 1, 32, 4, device="cpu"))
    assert got == want == [(1, True), (1, False), (0, False)]


# -- the port's engine ------------------------------------------------------------

def _tiny():
    import paddle_tpu_torch as pt
    pt.seed(3)
    return GPTForPretraining(GPTConfig(
        vocab_size=64, hidden_size=32, num_hidden_layers=2,
        num_attention_heads=2, intermediate_size=64,
        max_position_embeddings=64)).eval()


def test_engine_records_cycles_and_dumps(tmp_path, monkeypatch):
    monkeypatch.setenv("FLAGS_flight_dump_dir", str(tmp_path / "auto"))
    model = _tiny()
    kw = dict(num_slots=2, max_len=48, kv_layout="paged", attention="fused",
              block_size=8, prefill_budget=8, spec_draft="auto", spec_k=3,
              device="cpu")
    eng = GenerationEngine(model, **kw)
    hs = [eng.submit(np.arange(1, n), max_new_tokens=6) for n in (5, 12, 3)]
    for h in hs:
        h.result(timeout=60)
    # a request's result is out before its cycle's record is in the
    # ring: closing joins the loop
    eng.close()
    stats = eng.stats()
    doc = eng.dump_flight_recorder(str(tmp_path / "fr.json"))
    with open(tmp_path / "fr.json") as f:
        assert json.load(f)["engine"]["requests_retired"] == 3
    snap = eng.flight_recorder.snapshot()
    assert stats["requests_retired"] == snap["requests_retired"] == 3
    assert stats["ttft_ms"] == doc["latency"]["ttft_ms"]
    assert stats["ttft_ms"]["count"] == 3 and stats["tpot_ms"]["count"] == 3
    assert stats["chunked_prefill_tokens_per_sec"] > 0
    spec = [c for c in snap["cycles"] if "spec_proposed" in c]
    assert spec and all(c["spec_draft_dispatches"] == 1 for c in spec)
    assert all({"spec_proposed", "spec_accepted", "spec_emitted"} <= set(c)
               for c in spec)
    assert sum(c["emitted"] for c in snap["cycles"]) == 18
    events = [e["event"] for e in snap["events"]]
    for name in ("submit", "admitted", "first_token", "finish"):
        assert events.count(name) == 3, (name, events)
    assert sum(len(c["admitted"]) for c in snap["cycles"]) == 3
    assert sum(len(c["retired"]) for c in snap["cycles"]) == 3

    # a failing cycle poisons its requests and leaves a dump behind
    eng = GenerationEngine(model, **kw)
    boom = RuntimeError("boom")

    def failing(*a):
        raise boom

    eng._sched._do_spec = failing
    eng._sched._do_chunked = failing
    with pytest.raises(RuntimeError, match="serving step failed"):
        eng.submit(np.arange(1, 6), max_new_tokens=4).result(timeout=60)
    eng.close()
    path = eng.flight_recorder.last_dump_path
    assert path and os.path.dirname(path) == str(tmp_path / "auto")
    with open(path) as f:
        dumped = json.load(f)
    assert dumped["reason"] == repr(boom)
    assert dumped["cycles"][-1]["failed"] == repr(boom)
    assert not eng._draft_synced.any()
    assert not torch.count_nonzero(eng._draft_pool)
