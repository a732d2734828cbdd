"""Process-wide counters (counterpart of the counter half of
``paddle_tpu/framework/monitor.py``): ``call_op`` bumps ``op_count/<name>``
on every call, and ``op_time_ms/<name>`` under ``FLAGS_benchmark``.

Writers are lock-free: two threads racing may lose an increment, which
counters for observability accept, where a lock per op dispatch would
cost every op. Readers take the lock and copy."""
from __future__ import annotations

import threading
from typing import Dict

__all__ = ["stat_add", "stat_get", "all_stats"]

_lock = threading.Lock()
_stats: Dict[str, float] = {}


def stat_add(name: str, value: float = 1) -> None:
    _stats[name] = _stats.get(name, 0) + value


def stat_get(name: str) -> float:
    with _lock:
        return _stats.get(name, 0)


def all_stats() -> Dict[str, float]:
    with _lock:
        return dict(_stats)
