"""Structured span profiler: trace spans + exporters over the monitor stats
(counterpart of ``paddle_tpu/profiler/span.py``).

Reference analog: paddle/fluid/platform/profiler/ — ``RecordEvent`` ranges
feeding a host event recorder, chrome-tracing export
(chrometracing_logger.cc) and the ``StatRegistry`` counter tables. The
class-based ``Profiler`` in profiler.py keeps the reference's *API shape*
(scheduler states, step()); this module is the low-level substrate the
framework itself is instrumented with:

* ``record(name, category)`` — span context manager AND decorator with
  thread-local nesting (each span knows its depth and parent) writing to
  one lock-guarded global event buffer;
* ``profile()`` — session context manager arming the buffer; when no
  session is active every instrumentation point reduces to ONE module-bool
  check (near-zero cost — the dispatch hot loop stays within the perf-gate
  budget);
* exporters — ``export_chrome_trace`` (chrome://tracing / Perfetto JSON),
  ``export_prometheus`` (text exposition of monitor counters, histograms
  and span aggregates), ``span_summary`` (human-readable table with
  p50/p95/p99 from the event buffer).

Threading contract: ``_Span.__exit__`` appends under ``_lock`` (spans are
orders of magnitude rarer than counter bumps, so a lock here is fine —
unlike monitor.stat_add, see framework/monitor.py for that contract); the
per-thread nesting stack is ``threading.local`` and needs no lock.

``jax_bridge`` keeps the JAX package's parameter name: here it forwards
each span into ``torch.profiler.record_function``, so that while a
``torch.profiler`` trace runs (``Profiler(targets=[..., GPU])``) the span
appears as a user annotation in that trace, above the kernels it
launched. A failing annotation raises: no span is silently dropped from
the device trace.

Flags: ``FLAGS_enable_profiler`` arms the buffer at import (env
``FLAGS_enable_profiler=1`` profiles a whole process without code
changes); ``FLAGS_profiler_max_events`` bounds the buffer — past the cap
events are counted in ``dropped()`` instead of appended, so a runaway
loop cannot eat the host's RAM.
"""
from __future__ import annotations

import functools
import json
import os
import threading
import time
from typing import Any, Callable, Dict, List, Optional

__all__ = ["record", "profile", "enable", "disable", "reset", "is_active",
           "events", "dropped", "add_event", "set_thread_name",
           "thread_names", "export_chrome_trace", "export_prometheus",
           "span_summary"]

# hot-path gate: instrumentation sites check this module attribute before
# allocating anything. Sessions nest (reentrant profile() is a no-op
# restart, not an error) via _active_count; _active mirrors count > 0.
_active = False
_active_count = 0
_lock = threading.Lock()
_events: List[tuple] = []   # (name, cat, t0, t1, tid, depth, parent, args)
_dropped = 0
_max_events = 1_000_000
_jax_bridge = False
_tls = threading.local()
# tid -> human label for the trace viewer (real python threads AND the
# synthetic per-request lanes the serving tracer emits). Survives
# reset() — lane identity is stable across sessions — and is bounded so
# a thread-churning server cannot grow it without limit.
_thread_names: Dict[int, str] = {}
# tid -> the Thread object that registered it (weakref; absent for
# synthetic lanes registered with an explicit tid). The OS REUSES thread
# idents: without owner tracking, a label registered by a long-dead
# thread would stick to its recycled ident forever and first-writer-wins
# would silently mislabel every later thread that inherits the ident
# (the order-dependent serving-trace flake).
_thread_owners: Dict[int, Any] = {}
_MAX_THREAD_NAMES = 4096


def _flag(name: str, default):
    try:
        from ..framework.flags import flag_value
        return flag_value(name)
    except Exception:
        return default


def is_active() -> bool:
    return _active


def dropped() -> int:
    """Events discarded because the buffer hit FLAGS_profiler_max_events."""
    return _dropped


_enable_stack: List[tuple] = []   # (max_events, jax_bridge) to restore


def enable(max_events: Optional[int] = None, jax_bridge: bool = False):
    """Arm the global span buffer (idempotent / reentrant). A nested
    enable may override the cap or turn the jax bridge on for its window;
    without explicit arguments it INHERITS the enclosing session's
    settings, and the matching disable always restores them."""
    global _active, _active_count, _max_events, _jax_bridge
    with _lock:
        nested = _active_count > 0
        _active_count += 1
        _enable_stack.append((_max_events, _jax_bridge))
        if max_events is not None:
            _max_events = int(max_events)
        elif not nested:
            _max_events = int(_flag("FLAGS_profiler_max_events",
                                    _max_events))
        _jax_bridge = _jax_bridge or jax_bridge
        _active = True


def disable():
    global _active, _active_count, _max_events, _jax_bridge
    with _lock:
        _active_count = max(0, _active_count - 1)
        if _enable_stack:
            _max_events, _jax_bridge = _enable_stack.pop()
        if _active_count == 0:
            _active = False
            _jax_bridge = False


_generation = 0   # bumped by reset(): spans begun before a reset are stale


def reset():
    """Drop all buffered events (does not change the active state)."""
    global _dropped, _generation
    with _lock:
        _events.clear()
        _dropped = 0
        _generation += 1


def events() -> List[Dict[str, Any]]:
    """Snapshot of the buffer as dicts (ts/dur in microseconds)."""
    with _lock:
        snap = list(_events)
    out = []
    for name, cat, t0, t1, tid, depth, parent, args in snap:
        out.append({"name": name, "cat": cat, "ts": t0 * 1e6,
                    "dur": (t1 - t0) * 1e6, "tid": tid, "depth": depth,
                    "parent": parent, "args": args})
    return out


def set_thread_name(name: str, tid: Optional[int] = None) -> None:
    """Label a trace lane for the chrome-trace viewer: the calling
    thread's by default, or an explicit ``tid`` (used for the serving
    tracer's synthetic per-request lanes). The export emits these as
    ``thread_name`` metadata events so the viewer shows "serving
    scheduler" instead of a bare thread ident. Cheap enough to call
    unconditionally; first-writer-wins per tid keeps a thread that
    plays several roles from flapping — but a label whose registering
    thread has DIED is stale (the OS recycles idents), so the current
    thread reclaims its own ident instead of inheriting a dead
    thread's role."""
    import weakref
    cur = None
    if tid is None:
        tid = threading.get_ident()
        cur = threading.current_thread()
    with _lock:
        if tid in _thread_names:
            owner = _thread_owners.get(tid)
            # single deref: GC may collect the Thread between checks
            owner_thread = owner() if owner is not None else None
            alive = owner_thread is not None and owner_thread.is_alive()
            if cur is None or alive:
                return          # same-thread role flap / synthetic lane
        elif len(_thread_names) >= _MAX_THREAD_NAMES:
            return
        _thread_names[tid] = str(name)
        if cur is not None:
            _thread_owners[tid] = weakref.ref(cur)


def thread_names() -> Dict[int, str]:
    with _lock:
        return dict(_thread_names)


def add_event(name: str, category: str, t0: float, t1: float, *,
              tid: Optional[int] = None, depth: int = 0,
              parent: Optional[str] = None,
              args: Optional[dict] = None) -> None:
    """Append one already-timed span to the buffer (same gate/cap as a
    live ``record()`` span). The escape hatch for events whose begin/end
    do not bracket a code region on the current thread — e.g. a serving
    request's lifecycle, reconstructed onto a synthetic lane when it
    finishes. ``t0``/``t1`` are ``time.perf_counter()`` seconds."""
    if not _active:
        return
    global _dropped
    if tid is None:
        tid = threading.get_ident()
    with _lock:
        if len(_events) < _max_events:
            _events.append((name, category, float(t0), float(t1),
                            int(tid), int(depth), parent, args))
        else:
            _dropped += 1


def _stack() -> list:
    st = getattr(_tls, "stack", None)
    if st is None:
        st = _tls.stack = []
    return st


class _Span:
    """One annotation range. Context manager, begin()/end() pair, and
    decorator (``@record("name", "cat")``). All state is per-instance, so
    a scheduler flip between begin and end cannot desync the thread-local
    nesting stack."""

    __slots__ = ("name", "category", "args", "_t0", "_depth", "_parent",
                 "_ann", "_open", "_gen")

    def __init__(self, name: str, category: str = "user",
                 args: Optional[dict] = None):
        self.name = name
        self.category = category
        self.args = args
        self._t0 = None
        self._ann = None
        self._open = False

    def begin(self):
        if not _active:
            return self
        st = _stack()
        self._parent = st[-1] if st else None
        self._depth = len(st)
        st.append(self.name)
        self._open = True
        self._gen = _generation
        if _jax_bridge:
            # the span also lands in the torch.profiler trace when one
            # runs (a user annotation above the span's kernels)
            import torch
            ann = torch.profiler.record_function(self.name)
            ann.__enter__()
            self._ann = ann
        self._t0 = time.perf_counter()
        return self

    def end(self):
        if not self._open:
            return
        t1 = time.perf_counter()
        if self._ann is not None:
            try:
                self._ann.__exit__(None, None, None)
            finally:
                self._ann = None
        st = _stack()
        if st and st[-1] is self.name:
            st.pop()
        elif self.name in st:          # unbalanced exit: repair, don't leak
            st.remove(self.name)
        self._open = False
        global _dropped
        with _lock:
            if self._gen != _generation:
                pass   # the buffer was reset mid-span (a new session
                       # started): a stale event from the old timeline
                       # must not pollute the new session's trace
            elif len(_events) < _max_events:
                _events.append((self.name, self.category, self._t0, t1,
                                threading.get_ident(), self._depth,
                                self._parent, self.args))
            else:
                _dropped += 1
        self._t0 = None

    def __enter__(self):
        return self.begin()

    def __exit__(self, *exc):
        self.end()
        return False

    def __call__(self, fn: Callable) -> Callable:
        name = self.name or getattr(fn, "__qualname__", fn.__name__)
        category, args = self.category, self.args

        @functools.wraps(fn)
        def wrapper(*a, **kw):
            if not _active:           # decoration-time state is irrelevant;
                return fn(*a, **kw)   # activity is sampled per call
            with _Span(name, category, args):
                return fn(*a, **kw)

        return wrapper


def record(name: str, category: str = "user",
           args: Optional[dict] = None) -> _Span:
    """Span over a code region: ``with record("op/add", "dispatch"): ...``
    or ``@record("step", "hapi")``. A no-op (one bool check) when no
    ``profile()`` session is active."""
    return _Span(name, category, args)


class _Session:
    """Handle returned by ``profile()`` — scopes the armed buffer and
    carries the exporters so the common flow reads::

        with profiler.profile() as sess:
            model.train_batch(...)
        sess.export_chrome_trace("trace.json")
    """

    def __init__(self, max_events=None, jax_bridge=False, clear=True):
        self._max_events = max_events
        self._jax_bridge = jax_bridge
        self._clear = clear

    def __enter__(self):
        # never clear when nesting inside an active session — an inner
        # window (e.g. ProfilerCallback inside a user's own profile())
        # must not wipe the outer session's buffer
        if self._clear and _active_count == 0:
            reset()
        enable(self._max_events, self._jax_bridge)
        return self

    def __exit__(self, *exc):
        disable()
        return False

    # exporters operate on the retained buffer, usable after __exit__
    events = staticmethod(events)
    dropped = staticmethod(dropped)

    def export_chrome_trace(self, path: str) -> str:
        return export_chrome_trace(path)

    def export_prometheus(self, path: Optional[str] = None) -> str:
        return export_prometheus(path)

    def summary(self) -> str:
        return span_summary()


def profile(max_events: Optional[int] = None, jax_bridge: bool = False,
            clear: bool = True) -> _Session:
    """Profiling session context manager. Entering arms the global span
    buffer (cleared first unless ``clear=False``); leaving disarms it but
    KEEPS the events so the session's exporters still work."""
    return _Session(max_events, jax_bridge, clear)


# ---------------------------------------------------------------------------
# exporters
# ---------------------------------------------------------------------------

def export_chrome_trace(path: str) -> str:
    """Write the buffered spans as a chrome://tracing (catapult) JSON file
    — ``ph:"X"`` complete events with ``cat``/``ts``/``dur`` in
    microseconds, one ``tid`` lane per python thread. Open in
    chrome://tracing, Perfetto, or speedscope."""
    pid = os.getpid()
    trace = [{"name": "process_name", "ph": "M", "pid": pid,
              "args": {"name": "paddle_tpu_torch"}}]
    # thread/lane labels: scheduler, submitter and stream-consumer
    # threads (and the serving tracer's per-request lanes) show their
    # registered names in the viewer instead of bare tids
    for tid, tname in sorted(thread_names().items()):
        trace.append({"name": "thread_name", "ph": "M", "pid": pid,
                      "tid": tid, "args": {"name": tname}})
    for ev in events():
        trace.append({
            "name": ev["name"], "cat": ev["cat"], "ph": "X", "pid": pid,
            "tid": ev["tid"], "ts": ev["ts"], "dur": ev["dur"],
            "args": {"depth": ev["depth"], "parent": ev["parent"],
                     **(ev["args"] or {})},
        })
    doc = {"traceEvents": trace, "displayTimeUnit": "ms"}
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    with open(path, "w") as f:
        json.dump(doc, f)
    return path


def _span_aggregates() -> Dict[tuple, list]:
    agg: Dict[tuple, list] = {}
    for ev in events():
        agg.setdefault((ev["cat"], ev["name"]), []).append(ev["dur"] / 1e3)
    return agg


def span_summary() -> str:
    """Human-readable per-span table (calls, total/avg/p50/p95/p99 ms),
    sorted by total time — the profiler_statistic table analog."""
    from ..framework.monitor import _percentile
    agg = _span_aggregates()
    if not agg:
        return "(no spans recorded)"
    rows = sorted(agg.items(), key=lambda kv: -sum(kv[1]))
    head = (f"{'Category':<12} {'Name':<36} {'Calls':>7} {'Total(ms)':>11} "
            f"{'Avg(ms)':>9} {'p50':>8} {'p95':>8} {'p99':>8}")
    lines = [head, "-" * len(head)]
    for (cat, name), durs in rows:
        s = sorted(durs)
        tot = sum(durs)
        lines.append(
            f"{cat:<12} {name:<36} {len(durs):>7} {tot:>11.3f} "
            f"{tot / len(durs):>9.3f} {_percentile(s, 0.5):>8.3f} "
            f"{_percentile(s, 0.95):>8.3f} {_percentile(s, 0.99):>8.3f}")
    if _dropped:
        lines.append(f"(+ {_dropped} events dropped at the "
                     f"FLAGS_profiler_max_events={_max_events} cap)")
    return "\n".join(lines)


def export_prometheus(path: Optional[str] = None) -> str:
    """Prometheus text exposition (v0.0.4) of the full observability
    surface: monitor counters as a counter family, monitor histograms and
    span durations as summary families with quantile labels. Returns the
    text; also writes it to ``path`` when given (point a node_exporter
    textfile collector at it)."""
    from ..framework import monitor

    def _num(v: float) -> str:
        # exact exposition: %g truncates past 6 significant digits, which
        # makes large monotone counters (collective_bytes, op_count past
        # 1e6) appear frozen between scrapes; .17g round-trips any float
        f = float(v)
        return str(int(f)) if f.is_integer() else f"{f:.17g}"

    def esc(v: str) -> str:
        return v.replace("\\", "\\\\").replace('"', '\\"').replace(
            "\n", "\\n")

    lines = ["# HELP paddle_tpu_counter process-wide monitor counters",
             "# TYPE paddle_tpu_counter counter"]
    for name, val in sorted(monitor.all_stats().items()):
        lines.append(f'paddle_tpu_counter{{name="{esc(name)}"}} {_num(val)}')
    lines.append("# HELP paddle_tpu_stat monitor value distributions")
    lines.append("# TYPE paddle_tpu_stat summary")
    for name, h in sorted(monitor.all_histograms().items()):
        n = esc(name)
        for q, key in ((0.5, "p50"), (0.95, "p95"), (0.99, "p99")):
            lines.append(f'paddle_tpu_stat{{name="{n}",quantile="{q}"}} '
                         f'{_num(h[key])}')
        lines.append(f'paddle_tpu_stat_sum{{name="{n}"}} {_num(h["sum"])}')
        lines.append(f'paddle_tpu_stat_count{{name="{n}"}} {h["count"]}')
    lines.append("# HELP paddle_tpu_span_ms profiler span durations (ms)")
    lines.append("# TYPE paddle_tpu_span_ms summary")
    for (cat, name), durs in sorted(_span_aggregates().items()):
        from ..framework.monitor import _percentile
        s = sorted(durs)
        lab = f'name="{esc(name)}",category="{esc(cat)}"'
        for q in (0.5, 0.95, 0.99):
            lines.append(f'paddle_tpu_span_ms{{{lab},quantile="{q}"}} '
                         f'{_num(_percentile(s, q))}')
        lines.append(f'paddle_tpu_span_ms_sum{{{lab}}} {_num(sum(durs))}')
        lines.append(f'paddle_tpu_span_ms_count{{{lab}}} {len(durs)}')
    text = "\n".join(lines) + "\n"
    if path:
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(path, "w") as f:
            f.write(text)
    return text


# env-seeded whole-process profiling: FLAGS_enable_profiler=1 arms the
# buffer from import, no code changes needed (flags.py seeds from env)
if _flag("FLAGS_enable_profiler", False):
    enable()
