"""Observability over the serving engine and ``Model.fit`` (the port
against the JAX package, on the CPU).

* a tiny fused engine (2 layers, hidden 64, 4 heads, float32) serves the
  single schedule of ``tests/test_torch_fp16_serving.py``'s ``_serve``
  under an armed span session in both packages: the same set of the
  scheduler's span names and categories, the same children under every
  ``serving/cycle``, and the same request lanes from
  ``RequestTrace.export_spans``; the tokens equal those of the same
  engine served with no session armed, and both packages' tokens;
* the statusz ``memory`` and ``training`` sections render;
* ``GET /timeline`` answers 200 with a document holding host spans,
  request lanes and memory events;
* ``ProfilerCallback`` writes its chrome trace and Prometheus files from
  a 6-step ``fit``, its window's ``hapi/step`` spans in them;
* a fleet of two engines on two scheduler threads: each engine's
  ``serving/cycle`` spans equal its flight recorder's cycles, on its own
  thread lane.
"""
import json
import re
import threading
import urllib.request

import numpy as np
import pytest

import paddle_tpu as paddle
from paddle_tpu import profiler as jprof
from paddle_tpu.models import GPTConfig as JaxGPTConfig
from paddle_tpu.models import GPTForPretraining as JaxGPT
from paddle_tpu.nn.layer.layers import get_params_tree
from paddle_tpu.serving import GenerationEngine as JaxEngine
import paddle_tpu_torch as pt
from paddle_tpu_torch import profiler as tprof
from paddle_tpu_torch.convert import gpt_from_jax_params
from paddle_tpu_torch.framework import metrics as tm
from paddle_tpu_torch.hapi import Model
from paddle_tpu_torch.hapi.callbacks import ProfilerCallback
from paddle_tpu_torch.models import GPTConfig
from paddle_tpu_torch.optimizer import AdamW
from paddle_tpu_torch.serving import (EngineFleet, GenerationEngine,
                                      OpsServer)
from paddle_tpu_torch.serving.tracing import REQUEST_LANE_BASE

VOCAB = 96
KW = dict(num_slots=4, max_len=64, kv_layout="paged", block_size=16,
          attention="fused", prefill_budget=16)


@pytest.fixture(scope="module")
def models():
    paddle.seed(21)
    jcfg = JaxGPTConfig(vocab_size=VOCAB, hidden_size=64,
                        num_hidden_layers=2, num_attention_heads=4,
                        intermediate_size=128, max_position_embeddings=64,
                        hidden_dropout_prob=0.0, attention_dropout_prob=0.0,
                        initializer_range=0.5)
    jmodel = JaxGPT(jcfg)
    jmodel.eval()
    params = {k: np.asarray(v) for k, v in get_params_tree(jmodel).items()}
    cfg = GPTConfig(**{k: getattr(jcfg, k) for k in (
        "vocab_size", "hidden_size", "num_hidden_layers",
        "num_attention_heads", "intermediate_size",
        "max_position_embeddings", "hidden_dropout_prob",
        "attention_dropout_prob", "initializer_range")})
    return jmodel, gpt_from_jax_params(params, cfg, device="cpu").eval()


def _requests():
    rng = np.random.RandomState(4)
    preamble = rng.randint(1, VOCAB, 18)
    first = [(np.concatenate([preamble, rng.randint(1, VOCAB, 3)]), 6)]
    rest = [(np.concatenate([preamble, rng.randint(1, VOCAB, 5)]), 10),
            (rng.randint(1, VOCAB, 40), 12)]
    rest += [(rng.randint(1, VOCAB, int(rng.randint(8, 25))),
              int(rng.randint(6, 16))) for _ in range(3)]
    return first, rest


def _serve(eng, first, rest):
    """The serial schedule of ``test_torch_fp16_serving.py``: ``first``
    alone, then ``rest`` from client threads that submit one after
    another, admitted together."""
    out = [eng.submit(p, max_new_tokens=n).result(timeout=300)
           for p, n in first]
    handles = [None] * len(rest)
    submitted = [threading.Event() for _ in rest]
    sched = eng._sched
    admit = sched._admit

    def gated_admit():
        submitted[-1].wait(60)
        admit()

    sched._admit = gated_admit

    def client(i):
        if i:
            submitted[i - 1].wait(60)
        handles[i] = eng.submit(rest[i][0], max_new_tokens=rest[i][1])
        submitted[i].set()

    threads = [threading.Thread(target=client, args=(i,))
               for i in range(len(rest))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    out += [h.result(timeout=600) for h in handles]
    eng.close()
    return out


def _lanes(events):
    """Request lanes, by request: the sorted (name, depth, parent kind)
    of each lane's events, request ids taken out."""
    lanes = {}
    for e in events:
        if e["cat"] == "serving/request":
            lanes.setdefault(e["tid"], []).append(
                (re.sub(r"\d+", "N", e["name"]), e["cat"], e["depth"],
                 e["parent"] is not None))
    return sorted(sorted(v) for v in lanes.values())


def _children(events):
    """Per scheduler-thread span: name -> sorted child names."""
    kids = {}
    for e in events:
        if e["cat"] == "serving" and e["parent"] == "serving/cycle":
            kids.setdefault(e["name"], 0)
            kids[e["name"]] += 1
    return kids


def test_serving_spans_and_lanes_match_jax(models):
    jmodel, tmodel = models
    first, rest = _requests()
    plain = _serve(GenerationEngine(tmodel, device="cpu", **KW), first, rest)
    with tprof.profile():
        got = _serve(GenerationEngine(tmodel, device="cpu", **KW), first,
                     rest)
    tevents = tprof.events()
    with jprof.profile():
        want = _serve(JaxEngine(jmodel, **KW), first, rest)
    jevents = jprof.events()
    for g, p, w in zip(got, plain, want):
        np.testing.assert_array_equal(g, p)         # armed = unarmed
        np.testing.assert_array_equal(g, w)
    # the scheduler's spans (the JAX package also spans its op dispatch
    # and jit caches, which the port does not have)
    names = lambda evs: {(e["name"], e["cat"]) for e in evs  # noqa: E731
                         if e["cat"] == "serving"}
    assert names(tevents) == names(jevents)
    assert {"serving/cycle", "serving/sweep", "serving/admit",
            "serving/decode_dispatch", "serving/host_fetch"} <= \
        {n for n, _ in names(tevents)}
    assert _lanes(tevents) == _lanes(jevents)
    assert len(_lanes(tevents)) == len(first) + len(rest)
    cycles = [e for e in tevents if e["name"] == "serving/cycle"]
    kids = _children(tevents)
    assert kids["serving/sweep"] == kids["serving/admit"] == len(cycles)
    assert kids["serving/decode_dispatch"] == kids["serving/host_fetch"]
    names_by_tid = tprof.span.thread_names()
    assert names_by_tid[cycles[0]["tid"]] == "serving scheduler"


def test_statusz_sections_render(models):
    _, tmodel = models
    with GenerationEngine(tmodel, device="cpu", **KW) as eng:
        eng.submit(np.arange(1, 20), max_new_tokens=4).result(timeout=120)
        text = tm.statusz()
    assert "--- memory ---" in text and "--- training ---" in text
    assert "ledger total" in text and "serving/kv_pool#" in text
    assert "nonfinite steps" in text
    assert f"engine #{eng._eid} [paged/fused]" in text and "tok/s=" in text


def test_ops_server_timeline_has_host_lane_and_memory_events(models):
    _, tmodel = models
    eng = GenerationEngine(tmodel, device="cpu", **KW)
    srv = OpsServer(target=eng).start()
    try:
        with tprof.profile():
            eng.submit(np.arange(1, 20), max_new_tokens=4).result(
                timeout=120)
            eng.submit(np.arange(30, 40), max_new_tokens=3).result(
                timeout=120)
        with urllib.request.urlopen(srv.url + "/timeline",
                                    timeout=30) as r:
            assert r.status == 200
            doc = json.loads(r.read().decode())
    finally:
        srv.close()
        eng.close()
    evs = doc["traceEvents"]
    assert any(e.get("name") == "serving/cycle" and e["ph"] == "X"
               for e in evs)
    assert any(e.get("ph") == "X" and e.get("cat") == "serving/request"
               for e in evs)
    assert any(e.get("cat") == "memory" and e["name"] == "kv/alloc"
               for e in evs)
    assert any(e.get("ph") == "C" and e["name"] == "hbm" for e in evs)
    procs = {e["args"]["name"] for e in evs if e["name"] == "process_name"}
    assert {"paddle_tpu_torch host", "paddle_tpu_torch memory"} <= procs


def test_profiler_callback_writes_its_files_from_a_fit(tmp_path, capsys):
    pt.seed(0)
    from paddle_tpu_torch.models import GPTForPretraining
    net = GPTForPretraining(GPTConfig.tiny())
    m = Model(net, inputs=["ids", "labels"], device="cpu")
    m.prepare(AdamW(1e-3, parameters=net.parameters()),
              loss=lambda loss, logits: loss)
    ids = np.random.RandomState(1).randint(0, 256, (12, 16))
    trace, prom = tmp_path / "t" / "trace.json", tmp_path / "p.prom"
    m.fit(pt.io.TensorDataset([ids, ids]), batch_size=2, verbose=0,
          callbacks=[ProfilerCallback(
              start_step=1, stop_step=4, chrome_trace_path=str(trace),
              prometheus_path=str(prom), summary=True, verbose=1)])
    with open(trace) as f:
        doc = json.load(f)
    steps = sorted(e["args"]["global_step"] for e in doc["traceEvents"]
                   if e.get("name") == "hapi/step")
    assert steps == [1, 2, 3]
    text = prom.read_text()
    parsed = tm.parse_prometheus(text)
    assert parsed["types"]["paddle_tpu_span_ms"] == "summary"
    assert parsed["samples"][(
        "paddle_tpu_span_ms_count",
        (("category", "hapi"), ("name", "hapi/step")))] == 3
    out = capsys.readouterr().out
    assert "chrome trace written" in out and "hapi/step" in out
    assert not tprof.is_active()


def test_a_fit_that_ends_before_the_window_warns():
    pt.seed(0)
    from paddle_tpu_torch.models import GPTForPretraining
    net = GPTForPretraining(GPTConfig.tiny())
    m = Model(net, inputs=["ids", "labels"], device="cpu")
    m.prepare(AdamW(1e-3, parameters=net.parameters()),
              loss=lambda loss, logits: loss)
    ids = np.zeros((2, 16), np.int64)
    with pytest.warns(UserWarning, match="before the profiling window"):
        m.fit(pt.io.TensorDataset([ids, ids]), batch_size=2, verbose=0,
              callbacks=[ProfilerCallback(start_step=5, stop_step=6,
                                          chrome_trace_path="x.json")])


def test_fleet_spans_stay_exact_across_two_scheduler_threads(models):
    _, tmodel = models
    engines = [GenerationEngine(tmodel, device="cpu", **KW)
               for _ in range(2)]
    fleet = EngineFleet(engines)
    rng = np.random.RandomState(7)
    with tprof.profile():
        hs = [fleet.submit(rng.randint(1, VOCAB, int(rng.randint(5, 30))),
                           max_new_tokens=5) for _ in range(8)]
        for h in hs:
            h.result(timeout=300)
        for e in engines:
            while e._sched._rec is not None or e._sched.active:
                threading.Event().wait(0.005)
    events = tprof.events()
    fleet.close()
    cycles = [e for e in events if e["name"] == "serving/cycle"]
    by_tid = {}
    for e in cycles:
        by_tid[e["tid"]] = by_tid.get(e["tid"], 0) + 1
    assert len(by_tid) == 2
    recorded = sorted(e.flight_recorder.cycles_recorded for e in engines)
    assert sorted(by_tid.values()) == recorded
    lanes = {e["tid"] for e in events if e["cat"] == "serving/request"}
    assert len(lanes) == 8
    assert all(t >= REQUEST_LANE_BASE and t < REQUEST_LANE_BASE + 10**6
               for t in lanes)
