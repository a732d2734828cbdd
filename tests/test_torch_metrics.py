"""The metrics registry and the monitor's distributions of the PyTorch
port against the JAX package's, on the CPU:

* the same sequence of ``inc``/``set_gauge``/``observe`` calls, with
  labels (values that need escaping among them), custom buckets and a
  collector, gives byte-identical ``to_prometheus()`` text and equal
  ``snapshot()`` documents (``ts``, a wall-clock stamp, aside) in both
  packages, and ``parse_prometheus`` reads each text back to the same
  samples; histograms merge and give the same percentiles; the naming
  contract raises alike;
* the monitor bridge: the same ``stat_add``/``stat_observe`` calls into
  both monitors (each emptied for the test) give the same exposition;
  ``stat_histogram``/``all_histograms``/``histogram_samples``/
  ``stats_summary``/``stat_reset`` agree;
* a port engine publishes its ``stats()`` through the default registry
  (``{engine=<id>}`` series) and the ``serving engines`` statusz section
  while it lives, and neither once it is closed.
"""
import math

import numpy as np
import pytest

from paddle_tpu.framework import metrics as jm
from paddle_tpu.framework import monitor as jmon
from paddle_tpu_torch.framework import metrics as tm
from paddle_tpu_torch.framework import monitor as tmon
from paddle_tpu_torch.models import GPTConfig, GPTForPretraining
from paddle_tpu_torch.serving import GenerationEngine


def _drive(mod, include_monitor=False):
    reg = mod.MetricsRegistry(include_monitor=include_monitor, ring=4)
    reg.inc("serving_requests_total", engine="1")
    reg.inc("serving_requests_total", 2.5, engine="1")
    reg.inc("serving_requests_total", engine="2", lane='inter"active')
    reg.set_gauge("queue_depth", 7, engine="1")
    reg.set_gauge("queue_depth", 0.125, engine="2")
    reg.set_gauge("kv_bytes_in_use", 3 << 30)
    for v in (0.0004, 0.3, 2.5, 2.6, 40.0, 7e9, 1e12):
        reg.observe("cycle_ms", v, engine="1")
    for v in (1.0, 3.0, 9.0):
        reg.observe("ttft_ms", v, buckets=(2.0, 5.0), tenant="a\\b\nc")
    reg.register_collector("island", lambda: [
        ("gauge", "serving_slots_in_use", {"engine": "1"}, 3),
        ("counter", "serving_preempts", {"engine": "1"}, 2),
        ("gauge", "Bad-Name", {}, 1),             # dropped: naming contract
        ("histogram", "ignored_kind", {}, 1)])
    reg.register_collector("broken", lambda: 1 / 0)
    reg.sample_now(label="t0")
    return reg


def _no_ts(snap):
    snap = dict(snap)
    snap.pop("ts")
    snap["timeseries"] = [{k: v for k, v in e.items() if k != "t"}
                          for e in snap["timeseries"]]
    return snap


def test_registry_exposition_is_byte_identical():
    j, t = _drive(jm), _drive(tm)
    text = t.to_prometheus()
    assert text == j.to_prometheus()
    assert _no_ts(t.snapshot()) == _no_ts(j.snapshot())
    parsed = tm.parse_prometheus(text)
    assert parsed == jm.parse_prometheus(text)
    s = parsed["samples"]
    assert parsed["types"]["cycle_ms"] == "histogram"
    assert s[("serving_requests_total", (("engine", "1"),))] == 3.5
    assert s[("serving_requests_total",
              (("engine", "2"), ("lane", 'inter"active')))] == 1.0
    assert s[("ttft_ms_bucket", (("le", "+Inf"), ("tenant", "a\\b\nc")))] \
        == 3
    assert s[("cycle_ms_bucket", (("engine", "1"), ("le", "+Inf")))] == 7
    assert s[("serving_slots_in_use", (("engine", "1"),))] == 3
    assert ("Bad-Name", ()) not in s
    assert t.get_value("queue_depth", engine="2") == 0.125
    assert t.histogram_summary("cycle_ms", engine="1") \
        == j.histogram_summary("cycle_ms", engine="1")


def test_histograms_merge_and_percentiles_match():
    rng = np.random.RandomState(0)
    a, b = rng.lognormal(2, 1, 500), rng.lognormal(3, 0.5, 300)
    for buckets in (None, (1.0, 10.0, 100.0)):
        th = tm.HistValue.from_samples(a, buckets).merge(
            tm.HistValue.from_samples(b, buckets))
        jh = jm.HistValue.from_samples(a, buckets).merge(
            jm.HistValue.from_samples(b, buckets))
        assert th.counts == jh.counts and th.count == 800
        assert th.summary() == jh.summary()
        assert th.bucket_pairs() == jh.bucket_pairs()
        assert [th.percentile(q) for q in (0.1, 0.5, 0.9, 0.999)] \
            == [jh.percentile(q) for q in (0.1, 0.5, 0.9, 0.999)]
    with pytest.raises(ValueError, match="different bucket"):
        tm.HistValue((1.0,)).merge(tm.HistValue((2.0,)))
    reg = tm.MetricsRegistry(include_monitor=False)
    for i, v in enumerate((1.0, 2.0, 30.0, 400.0)):
        reg.observe("lat_ms", v, engine=str(i % 2))
    merged = reg.merged_histogram("lat_ms")
    assert merged.count == 4 and merged.vmax == 400.0
    assert tm.default_buckets() == jm.default_buckets()
    for name, bad in (("Bad", "counter"), ("ok", "gauge")):
        reg2 = tm.MetricsRegistry(include_monitor=False)
        if bad == "counter":
            with pytest.raises(ValueError, match="naming contract"):
                reg2.inc(name)
        else:
            reg2.inc(name)
            with pytest.raises(ValueError, match="already registered"):
                reg2.set_gauge(name, 1)
    with pytest.raises(ValueError, match="invalid label"):
        tm.MetricsRegistry().inc("x", **{"1bad": "v"})
    for raw in ("op_count/add", "serving/ttft_ms", "compile/ms/step#3",
                "A B//c"):
        assert tm.monitor_metric_name(raw) == jm.monitor_metric_name(raw)


@pytest.fixture
def empty_monitors(monkeypatch):
    for mon in (jmon, tmon):
        monkeypatch.setattr(mon, "_stats", {})
        monkeypatch.setattr(mon, "_hists", {})


def _feed(mon):
    mon.stat_add("serving/tokens", 5)
    mon.stat_add("serving/tokens")
    mon.stat_add("op_count/matmul", 3)
    mon.stat_add("collective_bytes/all_gather", 1024)
    for v in (3.0, 1.0, 4.0, 1.5, 9.25, 2.0, 6.5):
        mon.stat_observe("serving/ttft_ms", v)
    mon.stat_observe("op_time_ms/add", 0.25)
    mon.stat_observe("serving/queue_depth", 2)


def test_monitor_bridge_and_histograms_match(empty_monitors):
    _feed(jmon)
    _feed(tmon)
    assert tmon.all_stats() == jmon.all_stats()
    assert tmon.stat_histogram("serving/ttft_ms") \
        == jmon.stat_histogram("serving/ttft_ms")
    assert tmon.all_histograms() == jmon.all_histograms()
    assert tmon.histogram_samples("serving/ttft_ms") \
        == jmon.histogram_samples("serving/ttft_ms")
    assert tmon.stats_summary("serving/") == jmon.stats_summary("serving/")
    assert tmon.stat_get("serving/ttft_ms") == 27.25     # the sum
    assert tmon.stat_histogram("nothing") is None
    # a native family takes the bridge's family name: it wins
    regs = [mod.MetricsRegistry() for mod in (jm, tm)]
    for reg in regs:
        reg.set_gauge("serving_queue_depth", 4, engine="9")
    text = regs[1].to_prometheus()
    assert text == regs[0].to_prometheus()
    assert 'op_count{key="matmul"} 3' in text
    assert 'serving_ttft_ms{quantile="0.5"} 3' in text
    assert "# TYPE serving_queue_depth gauge" in text
    assert "# TYPE serving_queue_depth summary" not in text
    samples = tm.parse_prometheus(text)["samples"]
    assert samples[("serving_ttft_ms_count", ())] == 7
    tmon.stat_reset("serving/ttft_ms")
    jmon.stat_reset("serving/ttft_ms")
    assert tmon.all_histograms() == jmon.all_histograms()
    tmon.stat_reset()
    assert tmon.all_stats() == {} and tmon.stats_summary() == "(no stats)"


def test_statusz_renders_sections_best_effort():
    for mod in (jm, tm):
        reg = mod.MetricsRegistry(include_monitor=False)
        reg.register_statusz_section("one", lambda: "body")
        reg.register_statusz_section("two", lambda: 1 / 0)
        reg.register_statusz_section("one", lambda: "replaced")
        out = reg.statusz()
        assert "--- one ---\nreplaced" in out
        assert "--- two ---\n(section error: ZeroDivisionError" in out
    assert tm.registry() is tm.registry()
    assert math.isinf(tm.parse_prometheus("x_bucket{le=\"+Inf\"} +Inf")
                      ["samples"][("x_bucket", (("le", "+Inf"),))])


def test_engine_publishes_its_stats():
    import paddle_tpu_torch as pt
    pt.seed(4)
    model = GPTForPretraining(GPTConfig(
        vocab_size=64, hidden_size=32, num_hidden_layers=1,
        num_attention_heads=2, intermediate_size=64,
        max_position_embeddings=64)).eval()
    eng = GenerationEngine(model, num_slots=2, max_len=32,
                           kv_layout="paged", attention="fused",
                           block_size=8, device="cpu")
    eng.submit(np.arange(1, 6), max_new_tokens=3).result(timeout=60)
    label = (("engine", str(eng._eid)),)
    samples = tm.parse_prometheus(tm.to_prometheus())["samples"]
    assert samples[("serving_requests_retired", label)] == 1
    assert samples[("serving_slots_in_use", label)] == 0
    assert ("serving_kv_blocks_in_use", label) in samples
    snap = tm.snapshot()
    assert any(s["labels"] == dict(label)
               for s in snap["gauges"]["serving_queue_depth"])
    console = tm.statusz()
    assert "--- serving engines ---" in console
    assert f"engine #{eng._eid} [paged/fused]" in console
    eng.close()
    samples = tm.parse_prometheus(tm.to_prometheus())["samples"]
    assert ("serving_requests_retired", label) not in samples
    assert f"engine #{eng._eid} " not in tm.statusz()
