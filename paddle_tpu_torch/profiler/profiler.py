"""``Profiler`` (counterpart of ``paddle_tpu/profiler/profiler.py``;
reference: python/paddle/profiler/profiler.py).

The host timeline is the ``RecordEvent`` recorder below (and, with
``use_native``, the C++ recorder of ``native/tpu_prof.cc``). The device
timeline is ``torch.profiler``'s: a target of ``ProfilerTarget.GPU`` (in
the default targets) runs a ``torch.profiler.profile`` with the CPU and
CUDA activities over every RECORD window, and writes its Kineto chrome
trace into ``trace_dir`` when the window closes; ``device_trace.py``
reads it back (``device_op_table``, ``summary_table``). Where the JAX
package swallows a failed ``jax.profiler.start_trace``, here a GPU
target on a host with a CUDA device either starts the CUDA activity or
raises. On a host without one (the CPU tests) the trace records the
CPU activity only: there is no device to trace.
"""
from __future__ import annotations

import enum
import itertools
import json
import os
import socket
import threading
import time
from typing import Callable, Iterable, Optional

__all__ = ["Profiler", "ProfilerState", "ProfilerTarget", "RecordEvent",
           "make_scheduler", "export_chrome_tracing",
           "load_profiler_result"]

#: the user annotation ``_transition`` drops into every device trace at
#: the host stamp ``Profiler._trace_anchor_us``: the timeline aligns the
#: trace's clock on it (``timeline.py``)
ANCHOR = "paddle_tpu_torch/trace_anchor"
#: kernels the profiler launches at the start of each device trace,
#: before its anchor (see ``Profiler._transition``)
PAD_LAUNCHES = 128


class ProfilerState(enum.Enum):
    """Reference: profiler.py ProfilerState (scheduler output per step)."""
    CLOSED = 0
    READY = 1
    RECORD = 2
    RECORD_AND_RETURN = 3   # last record step of a cycle: trace is returned


class ProfilerTarget(enum.Enum):
    CPU = 0
    GPU = 1   # the CUDA activity of torch.profiler
    TPU = 2   # the JAX package's device; here the same as GPU


def make_scheduler(*, closed: int, ready: int, record: int,
                   repeat: int = 0, skip_first: int = 0
                   ) -> Callable[[int], ProfilerState]:
    """Reference: profiler.py make_scheduler — cyclic CLOSED^closed →
    READY^ready → RECORD^(record-1) → RECORD_AND_RETURN, repeated
    ``repeat`` times (0 = forever), after ``skip_first`` CLOSED steps."""
    if closed < 0 or ready < 0 or record < 1:
        raise ValueError("make_scheduler: need closed>=0, ready>=0, "
                         "record>=1")
    span = closed + ready + record

    def schedule(step: int) -> ProfilerState:
        if step < skip_first:
            return ProfilerState.CLOSED
        step -= skip_first
        if repeat and step >= repeat * span:
            return ProfilerState.CLOSED
        pos = step % span
        if pos < closed:
            return ProfilerState.CLOSED
        if pos < closed + ready:
            return ProfilerState.READY
        if pos == span - 1:
            return ProfilerState.RECORD_AND_RETURN
        return ProfilerState.RECORD

    return schedule


def _default_state_scheduler(step: int) -> ProfilerState:
    return ProfilerState.RECORD


# ---------------------------------------------------------------------------
# host event recorder (≙ HostTracer ring buffers, host_event_recorder.h)
# ---------------------------------------------------------------------------

class _HostEvent:
    __slots__ = ("name", "t0", "t1", "tid", "step")

    def __init__(self, name, t0, t1, tid, step):
        self.name, self.t0, self.t1 = name, t0, t1
        self.tid, self.step = tid, step


class _HostRecorder:
    def __init__(self, capacity: int = 1_000_000):
        self.events: list[_HostEvent] = []
        self.capacity = capacity
        self.enabled = False
        self.native_active = False
        self._lock = threading.Lock()

    def add(self, ev: _HostEvent):
        with self._lock:
            if len(self.events) < self.capacity:
                self.events.append(ev)

    def clear(self):
        with self._lock:
            self.events = []


_recorder = _HostRecorder()
_current_step = [0]
_trace_seq = itertools.count(1)


def _native():
    from . import native as _native_mod
    return _native_mod


class RecordEvent:
    """User annotation range (reference: profiler.py RecordEvent).

    Context manager AND begin/end object; while a profiler records, the
    range also lands in the ``torch.profiler`` trace as a
    ``record_function`` annotation, so host ranges line up with the
    kernels they launched.
    """

    def __init__(self, name: str, event_type=None):
        self.name = name
        self._t0 = None
        self._ann = None
        self._native_open = False

    def begin(self):
        self._t0 = time.perf_counter()
        if _recorder.enabled:
            if _recorder.native_active:
                _native().begin(self.name)
                self._native_open = True
            import torch
            ann = torch.profiler.record_function(self.name)
            ann.__enter__()
            self._ann = ann

    def end(self):
        if self._t0 is None:
            return
        t1 = time.perf_counter()
        if self._ann is not None:
            self._ann.__exit__(None, None, None)
            self._ann = None
        if self._native_open:
            # paired per-instance: an end never pops a range it didn't
            # open
            _native().end()
            self._native_open = False
        if _recorder.enabled:
            _recorder.add(_HostEvent(self.name, self._t0, t1,
                                     threading.get_ident(),
                                     _current_step[0]))
        self._t0 = None

    def __enter__(self):
        self.begin()
        return self

    def __exit__(self, *exc):
        self.end()
        return False


def export_chrome_tracing(dir_name: str, worker_name: Optional[str] = None):
    """Reference: profiler.py export_chrome_tracing — returns an
    ``on_trace_ready`` callback writing a chrome trace per cycle."""

    def handler(prof: "Profiler"):
        os.makedirs(dir_name, exist_ok=True)
        name = worker_name or f"host_{os.getpid()}"
        path = os.path.join(
            dir_name, f"{name}_step{_current_step[0]}.json")
        prof.export(path)

    return handler


def load_profiler_result(path: str):
    """Load a chrome trace JSON written by Profiler.export."""
    with open(path) as f:
        return json.load(f)


def _activities(device_trace: bool):
    """The ``torch.profiler`` activities of a session: CPU always, CUDA
    when a device target was asked for on a host with a CUDA device —
    where the CUDA activity must exist, or the call raises."""
    import torch
    from torch.profiler import ProfilerActivity
    acts = [ProfilerActivity.CPU]
    if device_trace and torch.cuda.is_available():
        if ProfilerActivity.CUDA not in torch.profiler.supported_activities():
            raise RuntimeError(
                "a GPU profiler target was requested on a CUDA device, but "
                "this torch.profiler has no CUDA activity (no CUPTI): the "
                "device timeline cannot be recorded")
        acts.append(ProfilerActivity.CUDA)
    return acts


class Profiler:
    """Reference: profiler.py:271.

    ``targets`` including GPU (or TPU) runs a ``torch.profiler`` trace
    over each RECORD window, written as a Kineto chrome trace into
    ``trace_dir`` (``device_trace.py`` reads it); the host RecordEvent
    timeline is always captured and exportable as chrome trace JSON via
    ``export``.
    """

    def __init__(self, *, targets: Optional[Iterable] = None,
                 scheduler=None, on_trace_ready=None,
                 trace_dir: Optional[str] = None, timer_only: bool = False,
                 use_native: Optional[bool] = None):
        # use_native: mirror host ranges into the C++ tpu_prof recorder
        # (native/tpu_prof.cc). Resolved HERE — a first-use build (a g++
        # subprocess) must happen at construction, never inside the
        # profiled region.
        if use_native or use_native is None:
            requested = bool(use_native)
            use_native = _native().available()
            if requested and not use_native:
                import warnings
                warnings.warn("use_native=True but the tpu_prof extension "
                              "is unavailable; falling back to the python "
                              "recorder")
        self._use_native = bool(use_native)
        self._native_session = False
        if scheduler is None:
            self._scheduler = _default_state_scheduler
        elif callable(scheduler):
            self._scheduler = scheduler
        elif isinstance(scheduler, (tuple, list)) and len(scheduler) == 2:
            start, end = scheduler
            self._scheduler = make_scheduler(
                closed=max(start - 1, 0), ready=1 if start > 0 else 0,
                record=end - start, repeat=1)
        else:
            raise TypeError(f"bad scheduler: {scheduler!r}")
        targets = list(targets) if targets is not None else \
            [ProfilerTarget.CPU, ProfilerTarget.GPU]
        self._device_trace = any(
            t in (ProfilerTarget.TPU, ProfilerTarget.GPU) for t in targets)
        self._timer_only = timer_only
        self._on_trace_ready = on_trace_ready
        self.trace_dir = trace_dir or os.path.join(
            os.getcwd(), "paddle_profiler_trace")
        self._device_active = False
        self._torch_prof = None
        self.last_trace_file: Optional[str] = None
        self.current_state = ProfilerState.CLOSED
        self._step_t0 = None
        self._step_times: list[float] = []

    # -- lifecycle ---------------------------------------------------------
    def start(self):
        self.current_state = self._scheduler(_current_step[0])
        self._transition(ProfilerState.CLOSED, self.current_state)
        self._step_t0 = time.perf_counter()
        self._session_t0_us = self._step_t0 * 1e6
        return self

    def stop(self):
        self._transition(self.current_state, ProfilerState.CLOSED)
        self.current_state = ProfilerState.CLOSED
        self._session_t1_us = time.perf_counter() * 1e6
        if self._native_session:
            _native().disable()
        if self._on_trace_ready is not None and _recorder.events:
            self._on_trace_ready(self)

    def step(self):
        """Advance the scheduler one training step."""
        now = time.perf_counter()
        if self._step_t0 is not None:
            self._step_times.append(now - self._step_t0)
        self._step_t0 = now
        old = self.current_state
        _current_step[0] += 1
        new = self._scheduler(_current_step[0])
        self._transition(old, new)
        self.current_state = new
        if old == ProfilerState.RECORD_AND_RETURN and \
                self._on_trace_ready is not None:
            self._on_trace_ready(self)

    def _transition(self, old: ProfilerState, new: ProfilerState):
        was = old in (ProfilerState.RECORD, ProfilerState.RECORD_AND_RETURN)
        now = new in (ProfilerState.RECORD, ProfilerState.RECORD_AND_RETURN)
        if now and not was:
            _recorder.enabled = True
            if self._use_native:
                if not self._native_session:
                    # first RECORD of this profiler: clear + arm; later
                    # cycles AND restarts resume without clearing, so the
                    # native lane accumulates like the python lane
                    _native().enable()
                    self._native_session = True
                else:
                    _native().resume()
                _recorder.native_active = True
            if self._device_trace and not self._timer_only and \
                    not self._device_active:
                import torch
                acts = _activities(True)
                cuda = len(acts) > 1
                prof = torch.profiler.profile(activities=acts)
                prof.__enter__()
                self._torch_prof = prof
                self._device_active = True
                self._cuda_trace = cuda
                if cuda:
                    # in a process that traced before, a new session's
                    # first kernel records go missing (on the H100: its
                    # first 12 launches, each with its cudaLaunchKernel
                    # record but no kernel event): the session opens with
                    # PAD_LAUNCHES kernels of its own, which take that
                    # loss; device_trace leaves out every device event
                    # before the anchor's
                    torch.cuda.synchronize()
                    with torch.profiler.record_function(ANCHOR + "/pad"):
                        pad = torch.zeros(1, device="cuda")
                        for _ in range(PAD_LAUNCHES):
                            pad.add_(1)
                        torch.cuda.synchronize()
                # the host anchor of the unified timeline: the annotation
                # opens right after this perf_counter stamp, and on the
                # card its one kernel gives the annotation's device-side
                # twin
                self._trace_anchor_us = time.perf_counter() * 1e6
                with torch.profiler.record_function(ANCHOR):
                    if cuda:
                        torch.zeros(1, device="cuda")
                        torch.cuda.synchronize()
        elif was and not now:
            _recorder.enabled = False
            _recorder.native_active = False
            if self._device_active:
                prof, self._torch_prof = self._torch_prof, None
                self._device_active = False
                if self._cuda_trace:
                    import torch
                    torch.cuda.synchronize()   # the window's work ends in it
                prof.__exit__(None, None, None)
                os.makedirs(self.trace_dir, exist_ok=True)
                path = os.path.join(
                    self.trace_dir,
                    f"{socket.gethostname()}_{os.getpid()}_"
                    f"{next(_trace_seq)}.pt.trace.json")
                prof.export_chrome_trace(path)
                self.last_trace_file = path

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()
        return False

    # -- results -----------------------------------------------------------
    def export(self, path: str, format: str = "json"):
        """Write the host timeline as a chrome trace (catapult) file.

        Reference: chrome-trace export profiler.py:158 /
        chrometracing_logger.cc. The device trace is written separately
        into ``trace_dir``.
        """
        events = []
        for ev in _recorder.events:
            events.append({
                "name": ev.name, "ph": "X", "pid": os.getpid(),
                "tid": ev.tid, "ts": ev.t0 * 1e6,
                "dur": (ev.t1 - ev.t0) * 1e6,
                "args": {"step": ev.step},
            })
        doc = {"traceEvents": events, "displayTimeUnit": "ms"}
        if self._native_session and _native().count():
            # the native recorder's (monotonic-clock) timeline as a
            # separate pid lane
            doc = _native().merge_into(doc)
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(path, "w") as f:
            json.dump(doc, f)
        return path

    def summary(self, sorted_by=None, op_detail=True, thread_sep=False,
                time_unit="ms"):
        """Aggregate host ranges by name (≙ profiler_statistic tables),
        then, with a device trace, the device-op table."""
        agg = {}
        for ev in _recorder.events:
            tot, cnt = agg.get(ev.name, (0.0, 0))
            agg[ev.name] = (tot + (ev.t1 - ev.t0), cnt + 1)
        scale = {"s": 1.0, "ms": 1e3, "us": 1e6}[time_unit]
        rows = sorted(agg.items(), key=lambda kv: -kv[1][0])
        lines = [f"{'Name':<40} {'Calls':>8} {'Total(' + time_unit + ')':>14}"
                 f" {'Avg(' + time_unit + ')':>12}"]
        for name, (tot, cnt) in rows:
            lines.append(f"{name:<40} {cnt:>8} {tot * scale:>14.3f} "
                         f"{tot * scale / cnt:>12.3f}")
        if self._step_times:
            import numpy as np
            st = np.asarray(self._step_times[1:] or self._step_times)
            lines.append(f"{'[step]':<40} {len(st):>8} "
                         f"{st.sum() * scale:>14.3f} "
                         f"{st.mean() * scale:>12.3f}")
        if self._device_trace and not self._timer_only:
            from .device_trace import summary_table
            lines.append("")
            lines.append("-- Device ops (from the Kineto trace) " + "-" * 38)
            lines.append(summary_table(self.trace_dir))
        return "\n".join(lines)

    def device_op_table(self, device_only: bool = True):
        """Per-kernel device-time rows from the newest trace in
        ``trace_dir``: [{name, plane, calls, total_us, avg_us}] sorted by
        total."""
        from .device_trace import device_op_table
        return device_op_table(self.trace_dir, device_only=device_only)

    def export_unified(self, path: str) -> str:
        """ONE chrome-trace file with everything on one clock: the span
        profiler's host timeline (serving request lanes included), the
        memory timeline as counter/instant events, and this profiler's
        device events aligned on the trace anchor (:mod:`.timeline`)."""
        from .timeline import export_unified_trace
        t0 = getattr(self, "_session_t0_us", None)
        t1 = getattr(self, "_session_t1_us", None)
        window = (t0, t1) if t0 is not None and t1 is not None else None
        return export_unified_trace(
            path, trace_dir=self.trace_dir,
            anchor_us=getattr(self, "_trace_anchor_us", None),
            window_us=window)

    @property
    def events(self):
        return list(_recorder.events)

    def reset(self):
        _recorder.clear()
        self._step_times = []


class SortedKeys:
    """Sort keys for Profiler.summary (reference profiler/profiler.py
    SortedKeys enum)."""
    CPUTotal = 0
    CPUAvg = 1
    CPUMax = 2
    CPUMin = 3
    GPUTotal = 4
    GPUAvg = 5
    GPUMax = 6
    GPUMin = 7


def export_protobuf(dir_name: str, worker_name: Optional[str] = None):
    """Reference: profiler.export_protobuf — an ``on_trace_ready``
    handler keeping the device trace. The JAX package copies its XPlane
    ``.pb``; here the device trace is the Kineto JSON, and the handler
    copies the newest one into ``dir_name``."""

    def handler(prof: "Profiler"):
        import shutil
        from .device_trace import latest_trace_file
        os.makedirs(dir_name, exist_ok=True)
        trace_dir = getattr(prof, "trace_dir", None)
        if not trace_dir:
            return
        f = latest_trace_file(trace_dir)
        if f is not None:
            name = worker_name or f"host_{os.getpid()}"
            shutil.copy(f, os.path.join(dir_name, f"{name}.pt.trace.json"))

    return handler
