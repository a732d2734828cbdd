"""Unified chrome-trace merger: every timeline, one clock, one file
(counterpart of ``paddle_tpu/profiler/timeline.py``).

Three observability layers record time-stamped events against DIFFERENT
buffers: the span profiler (host spans + the serving request lanes,
``perf_counter`` seconds), the memory tracker (timeline ring, also
``perf_counter``), and ``torch.profiler``'s Kineto trace (its own clock,
microseconds). This module merges them:

* **host spans** — re-emitted as-is (they already share the
  ``perf_counter`` axis), thread/lane labels included, under the main
  process;
* **memory timeline** — ``ph:"C"`` counter events (``bytes_in_use``,
  ``ledger_bytes``) plus ``ph:"i"`` instant marks for the labeled
  watermarks (``kv/alloc``, ``serving/cycle``, fit flushes);
* **device ops** — the kernels, copies and sets of the newest Kineto
  trace (:func:`.device_trace.device_events`) on a separate "device"
  pid.

Clock alignment: ``Profiler`` opens each trace with a
``record_function`` annotation (``profiler.ANCHOR``) whose host
``perf_counter`` stamp it keeps (``Profiler._trace_anchor_us``) and,
on the card, one kernel launched inside it and waited for. Kineto puts
the annotation on the device lane too (``gpu_user_annotation``: the
start of that kernel, on the device events' own converted clock). So
the shift is the host stamp minus the device-side annotation's start
(``clock: "kineto_gpu_anchor"``): exact up to the kernel's launch
latency, a few microseconds, whatever offset Kineto's conversion of
device timestamps onto its CPU clock carries. Without the device-side
twin, the host-side annotation's start is used (``"kineto_anchor"``,
which assumes that conversion exact); without either (a trace written
by another tool), the JAX package's heuristic: the FIRST device event
pinned to ``anchor_us``, else to the earliest host span
(``"kineto_first_event"``, good to the trace-start latency). The
``clock`` and ``shift_us`` args of every device event record which was
applied, so a reader can un-shift.
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional

__all__ = ["export_unified_trace", "unified_trace_doc"]


def unified_trace_doc(trace_dir: Optional[str] = None,
                      include_memory: bool = True,
                      anchor_us: Optional[float] = None,
                      window_us: Optional[tuple] = None) -> Dict[str, Any]:
    """Build the merged chrome-trace document (see module docstring).
    ``trace_dir`` adds the device lane when it holds a trace;
    ``anchor_us`` is the host ``perf_counter``-microseconds stamp of the
    trace's anchor annotation (device-lane alignment). ``window_us`` (t0, t1)
    clips the MEMORY lane to a profiling session's window — the memory
    timeline ring is process-global and outlives any one session, so
    without the clip a long-lived process drags hours-old HBM samples
    into every trace. Host spans are already session-scoped (the span
    recorder is cleared per session) and are never clipped."""
    from . import span as _span

    pid = os.getpid()
    trace: List[dict] = [{"name": "process_name", "ph": "M", "pid": pid,
                          "args": {"name": "paddle_tpu_torch host"}}]
    for tid, tname in sorted(_span.thread_names().items()):
        trace.append({"name": "thread_name", "ph": "M", "pid": pid,
                      "tid": tid, "args": {"name": tname}})
    span_events = _span.events()
    first_host_us = min((ev["ts"] for ev in span_events), default=None)
    for ev in span_events:
        trace.append({
            "name": ev["name"], "cat": ev["cat"], "ph": "X", "pid": pid,
            "tid": ev["tid"], "ts": ev["ts"], "dur": ev["dur"],
            "args": {"depth": ev["depth"], "parent": ev["parent"],
                     **(ev["args"] or {})},
        })

    if include_memory:
        from . import memory as _memory
        mem_pid = pid + 1
        trace.append({"name": "process_name", "ph": "M", "pid": mem_pid,
                      "args": {"name": "paddle_tpu_torch memory"}})
        # 0.25 s slack: sampler ticks straddling the window edges stay
        w0, w1 = (window_us if window_us else (None, None))
        slack = 0.25e6
        for entry in _memory.timeline():
            ts = entry["t"] * 1e6            # perf_counter s -> us
            if w0 is not None and not (w0 - slack <= ts <= w1 + slack):
                continue
            counters = {k: entry[k] for k in
                        ("bytes_in_use", "ledger_bytes") if k in entry}
            if counters:
                trace.append({"name": "hbm", "ph": "C", "pid": mem_pid,
                              "ts": ts, "args": counters})
            label = entry.get("label")
            if label and label != "sampler":
                trace.append({"name": label, "cat": "memory", "ph": "i",
                              "pid": mem_pid, "tid": 0, "ts": ts,
                              "s": "p"})

    if trace_dir:
        from .device_trace import device_events, trace_anchor_us
        devs = device_events(trace_dir)
        if devs:
            dev_pid = pid + 2
            trace.append({"name": "process_name", "ph": "M",
                          "pid": dev_pid,
                          "args": {"name": "paddle_tpu_torch device "
                                           "(Kineto)"}})
            gpu_marker = trace_anchor_us(trace_dir, device=True)
            marker = trace_anchor_us(trace_dir)
            if anchor_us is not None and gpu_marker is not None:
                clock, shift_us = "kineto_gpu_anchor", anchor_us - gpu_marker
            elif anchor_us is not None and marker is not None:
                clock, shift_us = "kineto_anchor", anchor_us - marker
            else:
                first_dev_us = min(d["t_us"] for d in devs)
                anchor = anchor_us if anchor_us is not None \
                    else first_host_us
                clock = "kineto_first_event"
                shift_us = (anchor - first_dev_us) if anchor is not None \
                    else 0.0
            lanes: Dict[str, int] = {}
            for d in devs:
                key = f"{d['plane']}:{d['line']}"
                if key not in lanes:
                    lanes[key] = len(lanes)
                    trace.append({"name": "thread_name", "ph": "M",
                                  "pid": dev_pid, "tid": lanes[key],
                                  "args": {"name": d["line"] or
                                           d["plane"]}})
                lane = lanes[key]
                trace.append({
                    "name": d["name"], "cat": "device", "ph": "X",
                    "pid": dev_pid, "tid": lane,
                    "ts": d["t_us"] + shift_us, "dur": d["dur_us"],
                    "args": {"clock": clock,
                             "shift_us": round(shift_us, 3)},
                })
    return {"traceEvents": trace, "displayTimeUnit": "ms"}


def export_unified_trace(path: str, trace_dir: Optional[str] = None,
                         include_memory: bool = True,
                         anchor_us: Optional[float] = None,
                         window_us: Optional[tuple] = None) -> str:
    """Write :func:`unified_trace_doc` to ``path``; returns the path."""
    doc = unified_trace_doc(trace_dir=trace_dir,
                            include_memory=include_memory,
                            anchor_us=anchor_us,
                            window_us=window_us)
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    with open(path, "w") as f:
        json.dump(doc, f)
    return path
