"""The port's ``profiler`` package against the JAX package's on the CPU.

* ``make_scheduler``'s states over steps 0-20 equal the JAX function's,
  exactly, and so do a ``Profiler``'s states stepped through a
  ``(start, end)`` scheduler;
* the same nested ``record`` spans through both span profilers give the
  same chrome-trace names, categories, depths and parents; the
  Prometheus text of both parses into the same metric families and the
  same samples for the names the test wrote; a cross-thread nesting
  test keeps its threads alive behind a barrier until it asserts, so no
  thread ident is reused;
* ``load_profiler_result`` reads back what the ``export_chrome_tracing``
  handler wrote, in both packages;
* ``device_trace`` reads a small Kineto-format trace built here: device
  events by kernel name and stream (the table counts a zero-length
  event as a launch, as the XPlane table does; the event list drops
  it), the anchor annotation, the newest file; the unified timeline
  shifts device events by the anchor;
* ``native`` (the ``native/tpu_prof.cc`` recorder, built with the host
  ``g++``) records ranges and merges them into ``Profiler.export``;
* a span under ``jax_bridge`` lands in a ``torch.profiler`` trace as a
  ``record_function`` annotation.
"""
import json
import os
import threading

import pytest
import torch

from paddle_tpu import profiler as jprof
from paddle_tpu.framework import monitor as jmon
from paddle_tpu.profiler import span as jspan
from paddle_tpu_torch import profiler as tprof
from paddle_tpu_torch.framework import metrics as tm
from paddle_tpu_torch.framework import monitor as tmon
from paddle_tpu_torch.profiler import device_trace, native
from paddle_tpu_torch.profiler import span as tspan
from paddle_tpu_torch.profiler import timeline

SCHEDULES = [dict(closed=1, ready=1, record=2),
             dict(closed=0, ready=0, record=1),
             dict(closed=2, ready=1, record=3, repeat=2),
             dict(closed=1, ready=2, record=2, repeat=1, skip_first=3)]


@pytest.mark.parametrize("kw", SCHEDULES, ids=lambda kw: "-".join(
    f"{k}{v}" for k, v in kw.items()))
def test_make_scheduler_states_equal_jax(kw):
    got = tprof.make_scheduler(**kw)
    want = jprof.make_scheduler(**kw)
    assert [got(s).name for s in range(21)] == \
        [want(s).name for s in range(21)]


def test_make_scheduler_rejects_what_jax_rejects():
    for mod in (tprof, jprof):
        with pytest.raises(ValueError, match="record>=1"):
            mod.make_scheduler(closed=0, ready=0, record=0)


def test_profiler_step_states_follow_the_tuple_scheduler():
    def states(mod):
        from importlib import import_module
        impl = import_module(mod.__name__ + ".profiler")
        impl._current_step[0] = 0
        p = mod.Profiler(targets=[mod.ProfilerTarget.CPU], scheduler=(2, 5),
                         use_native=False)
        p.start()
        out = [p.current_state.name]
        for _ in range(7):
            p.step()
            out.append(p.current_state.name)
        p.stop()
        impl._current_step[0] = 0
        return out
    assert states(tprof) == states(jprof)


def _nested_spans(mod):
    with mod.profile():
        with mod.record("outer", "test", args={"k": 1}):
            with mod.record("middle", "test"):
                with mod.record("inner", "other"):
                    pass
            with mod.record("sibling", "test"):
                pass

        @mod.record("decorated", "deco")
        def f():
            with mod.record("in_deco", "deco"):
                return 1
        f()


def _shape(trace):
    return sorted((e["name"], e["cat"], e["args"]["depth"],
                   e["args"]["parent"]) for e in trace["traceEvents"]
                  if e["ph"] == "X")


def test_nested_spans_give_the_jax_chrome_trace(tmp_path):
    docs = []
    for mod in (tspan, jspan):
        _nested_spans(mod)
        path = mod.export_chrome_trace(str(tmp_path / f"{mod.__name__}.json"))
        with open(path) as f:
            docs.append(json.load(f))
    assert _shape(docs[0]) == _shape(docs[1])
    assert len(_shape(docs[0])) == 6
    outer = next(e for e in docs[0]["traceEvents"] if e["name"] == "outer")
    assert outer["args"]["k"] == 1 and outer["dur"] > 0


def test_prometheus_text_parses_into_the_same_families():
    texts = []
    for span, mon in ((tspan, tmon), (jspan, jmon)):
        mon.stat_add("test_profiler/counter", 3)
        mon.stat_observe("test_profiler/hist", 2.0)
        mon.stat_observe("test_profiler/hist", 4.0)
        _nested_spans(span)
        texts.append(span.export_prometheus())
    got, want = (tm.parse_prometheus(t) for t in texts)
    assert got["types"] == want["types"]
    assert set(got["types"]) == {"paddle_tpu_counter", "paddle_tpu_stat",
                                 "paddle_tpu_span_ms"}

    def mine(parsed):
        return {k: v for k, v in parsed["samples"].items()
                if any("test_profiler" in str(x) for x in k[1])
                or k[0].startswith("paddle_tpu_span_ms_count")}
    assert mine(got) == mine(want)


def test_span_buffer_cap_counts_dropped_events():
    for mod in (tspan, jspan):
        with mod.profile(max_events=2):
            for i in range(5):
                with mod.record(f"s{i}"):
                    pass
        assert len(mod.events()) == 2 and mod.dropped() == 3
        with mod.profile():
            pass
        assert mod.dropped() == 0 and not mod.is_active()


def test_span_nesting_across_live_threads():
    """Each thread nests its own spans; the threads stay alive behind a
    barrier until the assertions, so no two share an ident."""
    n = 4
    barrier = threading.Barrier(n + 1)
    done = threading.Barrier(n + 1)

    def work(i):
        tspan.set_thread_name(f"worker {i}")
        with tspan.record(f"t{i}/outer", "thread"):
            barrier.wait(30)
            with tspan.record(f"t{i}/inner", "thread"):
                pass
        done.wait(30)

    with tspan.profile():
        threads = [threading.Thread(target=work, args=(i,))
                   for i in range(n)]
        for t in threads:
            t.start()
        barrier.wait(30)
        while len(tspan.events()) < 2 * n:
            threading.Event().wait(0.01)
        evs = tspan.events()
        tids = {e["tid"] for e in evs}
        names = tspan.thread_names()
        done.wait(30)
    for t in threads:
        t.join(30)
    assert len(tids) == n
    for e in evs:
        i = e["name"].split("/")[0][1:]
        if e["name"].endswith("inner"):
            assert (e["depth"], e["parent"]) == (1, f"t{i}/outer")
        else:
            assert (e["depth"], e["parent"]) == (0, None)
        assert names[e["tid"]] == f"worker {i}"


def test_load_profiler_result_reads_back_the_exported_trace(tmp_path):
    for mod in (tprof, jprof):
        d = tmp_path / mod.__name__
        p = mod.Profiler(targets=[mod.ProfilerTarget.CPU],
                         on_trace_ready=mod.export_chrome_tracing(
                             str(d), worker_name="w"), use_native=False)
        p.reset()       # events an earlier session of the process left
        with p:
            with mod.RecordEvent("region"):
                with mod.RecordEvent("nested"):
                    pass
        files = sorted(os.listdir(d))
        assert len(files) == 1 and files[0].startswith("w_step")
        doc = mod.load_profiler_result(str(d / files[0]))
        names = sorted(e["name"] for e in doc["traceEvents"]
                       if e.get("ph") == "X")
        assert names == ["nested", "region"]
        assert "region" in p.summary()
        p.reset()


def _kineto_fixture(path, anchor_ts=1000.0, gpu_anchor_ts=None):
    """A minimal trace in the shape ``torch.profiler`` exports: CPU ops,
    the anchor annotation (and its device-side twin), kernels on two
    streams, a copy and a set."""
    ev = [] if gpu_anchor_ts is None else [
        {"ph": "X", "cat": "gpu_user_annotation",
         "name": "paddle_tpu_torch/trace_anchor", "pid": 0, "tid": 7,
         "ts": gpu_anchor_ts, "dur": 1.5},
        {"ph": "X", "cat": "kernel", "name": "pad kernel", "pid": 0,
         "tid": 7, "ts": gpu_anchor_ts - 40.0, "dur": 1.0}]
    ev += [
        {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "pid": 11,
         "tid": 11, "ts": 990.0, "dur": 30.0},
        {"ph": "X", "cat": "user_annotation",
         "name": "paddle_tpu_torch/trace_anchor", "pid": 11, "tid": 11,
         "ts": anchor_ts, "dur": 2.0},
        {"ph": "X", "cat": "kernel", "name":
         "void (anonymous namespace)::rpa_tc_kernel<__nv_bfloat16>(...)",
         "pid": 0, "tid": 7, "ts": 1010.0, "dur": 17.0},
        {"ph": "X", "cat": "kernel", "name":
         "void (anonymous namespace)::rpa_tc_kernel<__nv_bfloat16>(...)",
         "pid": 0, "tid": 7, "ts": 1030.0, "dur": 15.0},
        {"ph": "X", "cat": "kernel", "name":
         "void (anonymous namespace)::ln_fwd_warp_kernel<float>(...)",
         "pid": 0, "tid": 8, "ts": 1050.0, "dur": 5.0},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH", "pid": 0,
         "tid": 7, "ts": 1060.0, "dur": 3.0},
        {"ph": "X", "cat": "gpu_memset", "name": "Memset", "pid": 0,
         "tid": 7, "ts": 1070.0, "dur": 0.0},
        {"ph": "f", "cat": "ac2g", "name": "flow", "pid": 0, "tid": 7,
         "ts": 1010.0},
    ]
    with open(path, "w") as f:
        json.dump({"traceEvents": ev, "schemaVersion": 1}, f)
    return path


def test_device_trace_reads_a_kineto_trace(tmp_path):
    old = _kineto_fixture(tmp_path / "a.pt.trace.json", anchor_ts=5.0)
    os.utime(old, (1, 1))
    os.makedirs(tmp_path / "sub")
    _kineto_fixture(tmp_path / "sub" / "b.pt.trace.json")
    assert device_trace.latest_trace_file(str(tmp_path)).endswith(
        "b.pt.trace.json")
    rows = device_trace.device_op_table(str(tmp_path))
    assert [(r["name"], r["calls"], r["total_us"], r["plane"])
            for r in rows] == [
        ("void (anonymous namespace)::rpa_tc_kernel<__nv_bfloat16>(...)",
         2, 32.0, "/device:GPU:0"),
        ("void (anonymous namespace)::ln_fwd_warp_kernel<float>(...)",
         1, 5.0, "/device:GPU:0"),
        ("Memcpy DtoH", 1, 3.0, "/device:GPU:0"),
        ("Memset", 1, 0.0, "/device:GPU:0")]   # a launch, if 0 us long
    assert "aten::mm" in [r["name"] for r in device_trace.device_op_table(
        str(tmp_path), device_only=False)]
    evs = device_trace.device_events(str(tmp_path))
    assert [e["t_us"] for e in evs] == [1010.0, 1030.0, 1050.0, 1060.0]
    assert {e["line"] for e in evs} == {"stream 7", "stream 8"}
    assert device_trace.trace_anchor_us(str(tmp_path)) == 1000.0
    table = tprof.summary_table(str(tmp_path))
    assert "rpa_tc_kernel" in table and "Calls" in table
    assert "no device trace" in tprof.summary_table(str(tmp_path / "none"))


def test_device_op_table_orders_rows_like_the_xplane_table(tmp_path):
    _kineto_fixture(tmp_path / "t.pt.trace.json")
    rows = device_trace.device_op_table(str(tmp_path))
    assert [r["total_us"] for r in rows] == sorted(
        (r["total_us"] for r in rows), reverse=True)
    assert set(rows[0]) == {"name", "plane", "calls", "total_us", "avg_us"}
    assert rows[0]["avg_us"] == rows[0]["total_us"] / rows[0]["calls"]


def test_unified_timeline_aligns_device_events_on_the_anchor(tmp_path):
    """On the device-side anchor when the trace has it (whatever offset
    Kineto's clock conversion carries), else on the host-side one, else
    on the first device event. The profiler's padding before the
    device-side anchor is left out of the trace's device events."""
    _kineto_fixture(tmp_path / "g.pt.trace.json", gpu_anchor_ts=992.0)
    assert "pad kernel" not in {r["name"] for r in
                                device_trace.device_op_table(str(tmp_path))}
    doc = timeline.unified_trace_doc(trace_dir=str(tmp_path),
                                     anchor_us=5_000_000.0)
    dev = [e for e in doc["traceEvents"] if e.get("cat") == "device"]
    assert {e["args"]["clock"] for e in dev} == {"kineto_gpu_anchor"}
    assert min(e["ts"] for e in dev) == pytest.approx(5_000_000.0 + 18.0)
    assert device_trace.trace_anchor_us(str(tmp_path), device=True) == 992.0
    os.remove(tmp_path / "g.pt.trace.json")
    _kineto_fixture(tmp_path / "t.pt.trace.json")
    with tspan.profile():
        with tspan.record("host", "test"):
            pass
    doc = timeline.unified_trace_doc(trace_dir=str(tmp_path),
                                     anchor_us=5_000_000.0)
    dev = [e for e in doc["traceEvents"] if e.get("cat") == "device"]
    assert len(dev) == 4
    assert {e["args"]["clock"] for e in dev} == {"kineto_anchor"}
    first = min(dev, key=lambda e: e["ts"])
    assert first["ts"] == pytest.approx(5_000_000.0 + 10.0)
    assert any(e.get("name") == "host" and e.get("ph") == "X"
               for e in doc["traceEvents"])
    # without the host stamp: the JAX heuristic, first event on the
    # earliest host span
    doc = timeline.unified_trace_doc(trace_dir=str(tmp_path))
    dev = [e for e in doc["traceEvents"] if e.get("cat") == "device"]
    assert {e["args"]["clock"] for e in dev} == {"kineto_first_event"}


def test_profiler_writes_a_torch_trace_with_the_anchor(tmp_path):
    """On a host without a card the device target records the CPU
    activity: the trace exists, holds the anchor and no device event."""
    p = tprof.Profiler(trace_dir=str(tmp_path), use_native=False)
    with p:
        torch.ones(4).add_(1)
    assert p.last_trace_file and os.path.exists(p.last_trace_file)
    assert device_trace.trace_anchor_us(str(tmp_path)) is not None
    assert p.device_op_table() == []
    assert "no device events" in p.summary()
    out = p.export_unified(str(tmp_path / "u.json"))
    with open(out) as f:
        assert json.load(f)["displayTimeUnit"] == "ms"


def test_span_bridge_lands_in_a_torch_profiler_trace():
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tspan.profile(jax_bridge=True):
            with tspan.record("bridged/span", "test"):
                torch.ones(2).mul_(3)
            with tspan.record("bridged/second", "test"):
                pass
    keys = {e.key for e in prof.key_averages()}
    assert "bridged/span" in keys and "bridged/second" in keys
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tspan.profile():
            with tspan.record("plain/span", "test"):
                pass
    assert "plain/span" not in {e.key for e in prof.key_averages()}


def test_native_recorder_builds_and_merges(tmp_path, monkeypatch):
    if not native.available():
        pytest.skip(f"no host C++ toolchain: {native._lib_err}")
    native.enable()
    native.begin("native/outer")
    native.begin("native/inner")
    native.end()
    native.end()
    native.instant("native/mark")
    assert native.count() == 3 and native.dropped() == 0
    doc = native.merge_into({"traceEvents": []})
    names = {e.get("name") for e in doc["traceEvents"]}
    assert {"native/outer", "native/inner", "process_name"} <= names
    native.disable()
    p = tprof.Profiler(targets=[tprof.ProfilerTarget.CPU], use_native=True)
    assert p._use_native
    with p:
        with tprof.RecordEvent("both/lanes"):
            pass
    doc = tprof.load_profiler_result(p.export(str(tmp_path / "n.json")))
    lanes = {e["pid"] for e in doc["traceEvents"]
             if e.get("name") == "both/lanes"}
    assert len(lanes) == 2          # the python lane and the native one
    p.reset()
