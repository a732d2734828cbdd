"""``paddle_tpu_torch.profiler`` — the tracing/profiling surface
(counterpart of ``paddle_tpu/profiler``).

Reference: python/paddle/profiler/profiler.py:271 (``Profiler`` with
scheduler states + ``RecordEvent`` annotations + chrome-trace export,
stats in profiler_statistic.py).

On the card the device timeline is ``torch.profiler``'s (Kineto over
CUPTI): ``Profiler`` brackets a ``torch.profiler.profile`` with the CPU
and CUDA activities and writes its chrome trace into ``trace_dir``;
``device_op_table``/``summary_table`` (``device_trace.py``, the
counterpart of ``xplane.py``) read the kernels back from it. Beside it:
the structured span profiler (``span.py``: ``record`` spans and a
``profile()`` session, the substrate the serving scheduler and
``Model.fit`` are instrumented with), the memory tracker
(``memory.py``), the unified timeline (``timeline.py``) and the
training numerics health layer (``numerics.py``).
"""
from .profiler import (  # noqa: F401
    Profiler, ProfilerState, ProfilerTarget, RecordEvent, load_profiler_result,
    make_scheduler, export_chrome_tracing, export_protobuf, SortedKeys,
)
from .device_trace import device_op_table, summary_table  # noqa: F401

# structured span profiler (span.py): record() spans, a profile()
# session, and chrome-trace / Prometheus / table exporters over spans +
# monitor stats
from .span import (  # noqa: F401
    record, profile, enable, disable, reset, is_active, events, dropped,
    span_summary, export_chrome_trace, export_prometheus,
)

# device-memory tracker (memory.py): bounded timeline + byte ledger
# (train state, KV pools, the host tier) + the OOM postmortem dump
from . import memory  # noqa: F401

# unified chrome-trace merger (timeline.py): host spans + request
# lanes + memory timeline + device kernels on one clock in one file
from .timeline import export_unified_trace  # noqa: F401

# training numerics health (numerics.py): device-side NaN/Inf audit of
# the eager train step, gradient telemetry, the train-loop flight
# recorder and the anomaly postmortem
from . import numerics  # noqa: F401
from .numerics import NumericsError  # noqa: F401

__all__ = ["Profiler", "ProfilerState", "ProfilerTarget", "RecordEvent",
           "make_scheduler", "export_chrome_tracing", "export_protobuf",
           "SortedKeys", "load_profiler_result", "device_op_table",
           "summary_table",
           "record", "profile", "enable", "disable", "reset", "is_active",
           "events", "dropped", "span_summary", "export_chrome_trace",
           "export_prometheus", "export_unified_trace", "memory",
           "numerics", "NumericsError"]
