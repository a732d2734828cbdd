"""The port's memory tracker (``paddle_tpu_torch.profiler.memory``) against
``paddle_tpu.profiler.memory`` on the CPU.

* the same calls on both packages' ``MemoryTracker`` (a mocked device
  stats function) give the same ledger, the same ``crosscheck()`` with
  its ``host/`` split, the same bounded timeline and an OOM postmortem
  with the same JSON keys;
* ``mark`` never polls the device; ``is_resource_exhausted`` knows
  ``torch.cuda.OutOfMemoryError`` and the JAX markers; the CPU has no
  device statistics, as in the JAX package;
* the ledger keys of a tiny fused engine with a host tier, and of a
  ``Model.fit``, are the JAX package's keys (up to the process-wide
  numbering);
* an out-of-memory error in ``Model.fit`` or in a serving cycle leaves
  the postmortem and reaches the caller as the original error.
"""
import json
import re
import time

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.hapi import Model as JaxModel
from paddle_tpu.models import GPTConfig as JaxGPTConfig
from paddle_tpu.models import GPTForPretraining as JaxGPT
from paddle_tpu.optimizer import AdamW as JaxAdamW
from paddle_tpu.profiler import memory as jmem
from paddle_tpu.serving import GenerationEngine as JaxEngine
import paddle_tpu_torch as pt
from paddle_tpu_torch.framework import metrics as tm
from paddle_tpu_torch.hapi import Model
from paddle_tpu_torch.models import GPTConfig, GPTForPretraining
from paddle_tpu_torch.optimizer import AdamW
from paddle_tpu_torch.profiler import memory as tmem
from paddle_tpu_torch.serving import GenerationEngine


class _Stats:
    """A device stats function that counts its polls."""

    def __init__(self):
        self.polls = 0
        self.in_use = 1000

    def __call__(self):
        self.polls += 1
        self.in_use += 100
        return {"bytes_in_use": self.in_use, "peak_bytes_in_use": 5000,
                "bytes_limit": 8000}


def _drive(mod):
    stats = _Stats()
    tr = mod.MemoryTracker(max_samples=3, stats_fn=stats)
    tr.ledger_set("serving/kv_pool#1/capacity", 600)
    tr.ledger_set("serving/kv_pool#1/in_use", 200)
    tr.ledger_set("host/serving/host_tier#1/capacity", 4096)
    tr.ledger_set("host/serving/host_tier#1/in_use", 512)
    polls = stats.polls
    tr.mark("kv/alloc", slot=0)
    assert stats.polls == polls            # a mark never polls
    tr.sample("hapi/flush", steps=1)
    tr.mark("serving/cycle", cycle=1)
    tr.sample()
    tr.ledger_drop("serving/kv_pool#1/in_use")
    cross = tr.crosscheck()
    tl = [{k: v for k, v in e.items() if k != "t"} for e in tr.timeline()]
    return tr, tr.ledger(), tr.ledger_total(), cross, tl, \
        tr.samples_recorded


def test_tracker_calls_give_the_jax_ledger_timeline_and_crosscheck():
    got, want = _drive(tmem), _drive(jmem)
    assert got[1:] == want[1:]
    cross = got[3]
    assert cross["host_ledger_bytes"] == 4096 + 512
    assert cross["ledger_bytes"] == 600
    assert cross["explained_ratio"] == 600 / cross["device_bytes_in_use"]
    assert len(got[4]) == 3 and got[5] == 4      # the ring is bounded


def test_oom_postmortem_keeps_the_jax_keys(tmp_path):
    docs = []
    for mod, err in ((tmem, torch.cuda.OutOfMemoryError("CUDA out of "
                                                         "memory")),
                     (jmem, RuntimeError("RESOURCE_EXHAUSTED: hbm"))):
        tr = _drive(mod)[0]
        path = tr.oom_postmortem(err, path=str(tmp_path / f"{mod.__name__}"
                                                          ".json"),
                                 extra={"phase": "test"})
        assert path is not None and tr.last_dump_path == path
        assert tr.dumps == 1
        with open(path) as f:
            docs.append(json.load(f))
    assert set(docs[0]) == set(docs[1])
    assert set(docs[0]["crosscheck"]) == set(docs[1]["crosscheck"])
    assert docs[0]["ledger"] == docs[1]["ledger"]
    assert docs[0]["phase"] == "test"
    assert "OutOfMemoryError" in docs[0]["reason"]
    # a failing disk never raises out of a failure handler
    assert tmem.MemoryTracker().oom_postmortem(
        path=str(tmp_path / "no" / "\0bad")) is None


def test_is_resource_exhausted_matches_the_jax_markers():
    cases = [RuntimeError("RESOURCE_EXHAUSTED: out of HBM"),
             RuntimeError("CUDA error: out of memory"),
             RuntimeError("BOOM"), ValueError("oom in a path/OOM")]
    for e in cases:
        assert tmem.is_resource_exhausted(e) == jmem.is_resource_exhausted(e)
    assert tmem.is_resource_exhausted(torch.cuda.OutOfMemoryError("x"))
    assert not tmem.is_resource_exhausted(RuntimeError("BOOM"))


def test_the_cpu_has_no_device_statistics_as_in_jax():
    assert tmem._device_stats() == {}
    assert tmem.largest_live_arrays() == []     # no CUDA tensors here
    entry = tmem.MemoryTracker().sample("x")
    assert "bytes_in_use" not in entry
    cross = tmem.MemoryTracker().crosscheck()
    assert cross["device_bytes_in_use"] is None
    assert cross["explained_ratio"] is None


def test_sampler_thread_starts_and_stops():
    stats = _Stats()
    tr = tmem.MemoryTracker(stats_fn=stats)
    tr.start(interval=0.01)
    tr.start(interval=0.01)                 # idempotent
    deadline = time.time() + 10
    while stats.polls < 3 and time.time() < deadline:
        time.sleep(0.01)
    tr.stop()
    assert stats.polls >= 3
    assert all(e.get("label") == "sampler" for e in tr.timeline())


def test_the_ledger_is_a_registry_collector():
    tmem.ledger_set("test/owner", 1234)
    try:
        samples = tm.parse_prometheus(tm.to_prometheus())["samples"]
        assert samples[("hbm_ledger_bytes", (("owner", "test/owner"),))] \
            == 1234
        assert ("hbm_ledger_total_bytes", ()) in samples
    finally:
        tmem.ledger_drop("test/owner")


def _norm(keys):
    return sorted(re.sub(r"#\d+", "#N", k) for k in keys)


def _tiny_jax_gpt():
    paddle.seed(3)
    jcfg = JaxGPTConfig(vocab_size=64, hidden_size=32, num_hidden_layers=1,
                        num_attention_heads=2, intermediate_size=64,
                        max_position_embeddings=64, hidden_dropout_prob=0.0,
                        attention_dropout_prob=0.0)
    m = JaxGPT(jcfg)
    m.eval()
    return m


def _tiny_gpt():
    pt.seed(3)
    return GPTForPretraining(GPTConfig(
        vocab_size=64, hidden_size=32, num_hidden_layers=1,
        num_attention_heads=2, intermediate_size=64,
        max_position_embeddings=64, hidden_dropout_prob=0.0,
        attention_dropout_prob=0.0)).eval()


def _engine_keys(mod, engine, model, **extra):
    before = set(mod.ledger())
    kw = dict(num_slots=2, max_len=32, kv_layout="paged",
              attention="fused", block_size=16, host_tier_bytes=1 << 20)
    eng = engine(model, **kw, **extra)
    try:
        eng.submit(np.arange(1, 20), max_new_tokens=3).result(timeout=120)
        live = set(mod.ledger()) - before
        cross = mod.crosscheck()
        timeline = [e.get("label") for e in mod.timeline()]
    finally:
        eng.close()
    return live, cross, timeline


def test_engine_ledger_keys_equal_the_jax_engines():
    got, cross, timeline = _engine_keys(tmem, GenerationEngine,
                                        _tiny_gpt(), device="cpu")
    want, jcross, _ = _engine_keys(jmem, JaxEngine, _tiny_jax_gpt())
    assert _norm(got) == _norm(want)
    assert _norm(got) == ["host/serving/host_tier#N/capacity",
                          "host/serving/host_tier#N/in_use",
                          "serving/kv_pool#N/capacity",
                          "serving/kv_pool#N/in_use"]
    assert cross["host_ledger_bytes"] >= 1 << 20
    assert {"kv/alloc", "kv/free", "serving/cycle"} <= set(timeline)


def test_fit_ledger_keys_equal_the_jax_models():
    rng = np.random.RandomState(0)
    ids = rng.randint(0, 64, (4, 16)).astype(np.int64)
    labels = rng.randint(0, 64, (4, 16)).astype(np.int64)
    before = set(tmem.ledger())
    net = _tiny_gpt().train()
    m = Model(net, inputs=["ids", "labels"], device="cpu")
    m.prepare(AdamW(1e-3, parameters=net.parameters()),
              loss=lambda loss, logits: loss)
    m.fit(pt.io.TensorDataset([ids, labels]), batch_size=2, verbose=0)
    got = set(tmem.ledger()) - before
    jbefore = set(jmem.ledger())
    jnet = _tiny_jax_gpt()
    jnet.train()
    jm = JaxModel(jnet, inputs=["ids", "labels"])
    jm.prepare(JaxAdamW(1e-3, parameters=jnet.parameters()),
               loss=lambda loss, logits: loss)
    jm.fit(paddle.io.TensorDataset([ids, labels]), batch_size=2, verbose=0)
    want = set(jmem.ledger()) - jbefore
    assert _norm(got) == _norm(want)
    led = tmem.ledger()
    base = next(k for k in got if k.endswith("/params")).rsplit("/", 1)[0]
    n_params = sum(p.numel() for p in net.parameters())
    assert led[f"{base}/params"] == 4 * n_params
    assert led[f"{base}/opt_state"] == 2 * 4 * n_params     # m and v
    labels_seen = [e.get("label") for e in tmem.timeline()]
    assert "hapi/flush" in labels_seen
    del m, net
    import gc
    gc.collect()
    assert not set(tmem.ledger()) & got      # dropped with the Model


def test_fit_oom_leaves_the_postmortem_and_reraises_the_error(tmp_path):
    net = _tiny_gpt().train()
    m = Model(net, inputs=["ids", "labels"], device="cpu")
    m.prepare(AdamW(1e-3, parameters=net.parameters()),
              loss=lambda loss, logits: loss)
    err = torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to "
                                      "allocate 80.00 GiB")

    def boom(*a, **k):
        raise err

    net.forward = boom
    dumps = tmem.tracker().dumps
    ids = np.zeros((2, 8), np.int64)
    with pytest.raises(torch.cuda.OutOfMemoryError) as info:
        m.fit(pt.io.TensorDataset([ids, ids]), batch_size=2, verbose=0)
    assert info.value is err
    assert tmem.tracker().dumps == dumps + 1
    with open(tmem.tracker().last_dump_path) as f:
        doc = json.load(f)
    assert doc["phase"] == "Model.fit"
    assert {"ledger", "largest_live_arrays", "timeline", "crosscheck",
            "reason"} <= set(doc)
    assert any(k.endswith("/params") for k in doc["ledger"])
    # any other error leaves no memory postmortem
    net.forward = lambda *a, **k: 1 / 0
    with pytest.raises(ZeroDivisionError):
        m.fit(pt.io.TensorDataset([ids, ids]), batch_size=2, verbose=0)
    assert tmem.tracker().dumps == dumps + 1


def test_serving_oom_leaves_the_postmortem_beside_the_recorder_dump(
        tmp_path, monkeypatch):
    from paddle_tpu_torch.framework import flags
    flags.set_flags({"FLAGS_flight_dump_dir": str(tmp_path)})
    eng = GenerationEngine(_tiny_gpt(), num_slots=2, max_len=32,
                           kv_layout="paged", attention="fused",
                           block_size=16, device="cpu")
    err = torch.cuda.OutOfMemoryError("CUDA out of memory")

    def boom(*a, **k):
        raise err

    eng._sched._do_chunked = boom
    dumps = tmem.tracker().dumps
    try:
        with pytest.raises(RuntimeError) as info:
            eng.submit(np.arange(1, 9), max_new_tokens=2).result(timeout=60)
        assert info.value.__cause__ is err
        deadline = time.time() + 30
        while tmem.tracker().dumps == dumps and \
                time.time() < deadline:
            time.sleep(0.01)
        with open(tmem.tracker().last_dump_path) as f:
            doc = json.load(f)
        assert doc["phase"] == "serving.scheduler"
        assert doc["flight_recorder"] == \
            eng.flight_recorder.last_dump_path
    finally:
        flags.set_flags({"FLAGS_flight_dump_dir": ""})
        eng.close()
