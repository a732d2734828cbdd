"""Device-op statistics from a Kineto chrome trace (the counterpart of
``paddle_tpu/profiler/xplane.py``).

The JAX package reads its device timeline from the XPlane protobuf that
``jax.profiler`` writes. Here the device timeline is the chrome trace
that ``torch.profiler`` (Kineto, over CUPTI) exports: ``Profiler`` writes
one ``*.pt.trace.json`` into its ``trace_dir`` per RECORD window, and
this module reads the newest one back. A device event is a complete
(``ph: "X"``) event of category ``kernel``, ``gpu_memcpy`` or
``gpu_memset``: Kineto puts them on the device's lane (``pid`` the
device index, ``tid`` the stream), here reported as the plane
``/device:GPU:<pid>`` and the line ``stream <tid>``. Times are
microseconds on Kineto's clock, which it shares with the trace's CPU
events. In a trace that ``Profiler`` wrote, the device events before
its anchor annotation's device-side start are the profiler's own
padding (``profiler.PAD_LAUNCHES``) and are left out.
"""
from __future__ import annotations

import glob
import json
import os
from typing import Dict, List, Optional, Tuple

__all__ = ["DEVICE_CATEGORIES", "load_trace", "trace_events",
           "device_op_table", "device_events", "latest_trace_file",
           "trace_anchor_us", "summary_table"]

#: the Kineto event categories that ran on the device
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


def latest_trace_file(trace_dir: str) -> Optional[str]:
    """The newest ``*.pt.trace.json`` under ``trace_dir`` (None without
    one)."""
    files = glob.glob(os.path.join(trace_dir, "**", "*.pt.trace.json"),
                      recursive=True)
    return max(files, key=os.path.getmtime) if files else None


_cache: Dict[str, tuple] = {}


def load_trace(path: str) -> dict:
    """The parsed trace at ``path``; the last one read is kept while the
    file is unchanged (a window's trace is read by several readers)."""
    st = os.stat(path)
    key = (st.st_mtime_ns, st.st_size)
    hit = _cache.get(path)
    if hit is not None and hit[0] == key:
        return hit[1]
    with open(path) as f:
        doc = json.load(f)
    _cache.clear()
    _cache[path] = (key, doc)
    return doc


def _is_device(ev: dict) -> bool:
    return ev.get("cat") in DEVICE_CATEGORIES


def _where(ev: dict) -> Tuple[str, str]:
    if _is_device(ev):
        return f"/device:GPU:{ev.get('pid')}", f"stream {ev.get('tid')}"
    return f"/host:CPU:{ev.get('pid')}", f"thread {ev.get('tid')}"


def _anchor(doc: dict, cat: str) -> Optional[float]:
    from .profiler import ANCHOR
    for ev in doc.get("traceEvents", []):
        if ev.get("ph") == "X" and ev.get("name") == ANCHOR and \
                ev.get("cat", "user_annotation") == cat:
            return float(ev.get("ts", 0.0))
    return None


def trace_events(doc: dict, device_only: bool = True,
                 keep_zero: bool = False) -> List[dict]:
    """The timed events of one loaded trace: ``{name, cat, plane, line,
    t_us, dur_us}``, in time order; zero-length ones dropped unless
    ``keep_zero``; the device events before the device-side anchor (the
    profiler's padding) left out."""
    start = _anchor(doc, "gpu_user_annotation")
    rows = []
    for ev in doc.get("traceEvents", []):
        if ev.get("ph") != "X" or (device_only and not _is_device(ev)):
            continue
        if start is not None and _is_device(ev) and \
                float(ev.get("ts", 0.0)) < start:
            continue
        dur = float(ev.get("dur", 0.0))
        if dur <= 0 and not keep_zero:
            continue
        plane, line = _where(ev)
        rows.append({"name": ev.get("name", ""), "cat": ev.get("cat"),
                     "plane": plane, "line": line,
                     "t_us": float(ev.get("ts", 0.0)), "dur_us": dur})
    rows.sort(key=lambda r: r["t_us"])
    return rows


def device_op_table(trace_dir: str, device_only: bool = True
                    ) -> List[dict]:
    """Per-op device time from the newest trace under ``trace_dir``:
    ``{name, plane, calls, total_us, avg_us}`` rows, largest total
    first (one row per kernel name and device). Every event counts, a
    zero-length one too, as in the JAX table: ``calls`` is launches."""
    path = latest_trace_file(trace_dir)
    if path is None:
        return []
    agg: Dict[Tuple[str, str], List[float]] = {}
    for ev in trace_events(load_trace(path), device_only, keep_zero=True):
        cell = agg.setdefault((ev["name"], ev["plane"]), [0.0, 0])
        cell[0] += ev["dur_us"]
        cell[1] += 1
    rows = [{"name": name, "plane": plane, "calls": cnt,
             "total_us": tot, "avg_us": tot / cnt}
            for (name, plane), (tot, cnt) in agg.items()]
    rows.sort(key=lambda r: -r["total_us"])
    return rows


def device_events(trace_dir: str, device_only: bool = True) -> List[dict]:
    """Individual timed device events of the newest trace, ``{name,
    plane, line, t_us, dur_us}`` with ``t_us`` on Kineto's clock (the
    unified timeline shifts them onto the host ``perf_counter`` axis)."""
    path = latest_trace_file(trace_dir)
    if path is None:
        return []
    return [{k: ev[k] for k in ("name", "plane", "line", "t_us", "dur_us")}
            for ev in trace_events(load_trace(path), device_only)]


def trace_anchor_us(trace_dir: str, device: bool = False
                    ) -> Optional[float]:
    """Kineto-clock start of the anchor annotation ``Profiler`` drops
    into each trace at a known host stamp (None without one): its host
    side (``user_annotation``), or with ``device`` its device-side twin
    (``gpu_user_annotation``, the start of the kernel it launched)."""
    path = latest_trace_file(trace_dir)
    if path is None:
        return None
    return _anchor(load_trace(path),
                   "gpu_user_annotation" if device else "user_annotation")


def summary_table(trace_dir: str, limit: int = 30,
                  device_only: bool = True) -> str:
    """Formatted device-op table (≙ profiler_statistic.py's device view)."""
    rows = device_op_table(trace_dir, device_only=device_only)
    if not rows:
        path = latest_trace_file(trace_dir)
        return f"(no device events in {path})" if path else \
            f"(no device trace found under {trace_dir})"
    lines = [f"{'Device op':<48} {'Calls':>7} {'Total(us)':>12} "
             f"{'Avg(us)':>10}"]
    for r in rows[:limit]:
        lines.append(f"{r['name'][:48]:<48} {r['calls']:>7} "
                     f"{r['total_us']:>12.1f} {r['avg_us']:>10.1f}")
    if len(rows) > limit:
        lines.append(f"... ({len(rows) - limit} more rows)")
    return "\n".join(lines)
