"""``FLAGS_*`` get and set (counterpart of ``paddle_tpu/framework/
flags.py``): the flags that ``call_op``, the span profiler and
``Model.fit``'s numerics read. A flag may be seeded from
an environment variable of its name (``FLAGS_flight_dump_dir`` is read
from the environment at each dump). ``FLAGS_pallas_force`` has no
counterpart: on the card the kernels are always used."""
from __future__ import annotations

import os
from typing import Any, Dict

__all__ = ["get_flags", "set_flags", "flag_value"]


def _parse(text: str, default):
    if isinstance(default, bool):
        return text.strip().lower() in ("1", "true", "yes", "on")
    return type(default)(text)


_DEFAULTS = {
    "FLAGS_check_nan_inf": (False, "Sweep every op's outputs for NaN/Inf "
                            "and raise FloatingPointError (a device sync "
                            "per op: for debugging)"),
    "FLAGS_check_shapes": (True, "InferMeta-style shape checks before "
                           "every op, raising ShapeError at the call site "
                           "(framework/infermeta.py)"),
    "FLAGS_benchmark": (False, "Time every op to its end (a device sync "
                        "per op) into the op_time_ms/<name> counters"),
    "FLAGS_flight_dump_dir": ("", "Directory of the serving flight "
                              "recorder's automatic dumps when a cycle "
                              "fails (empty: the system temp directory)"),
    "FLAGS_enable_profiler": (False, "Arm the structured span profiler "
                              "for the whole process at import "
                              "(profiler/span.py)"),
    "FLAGS_profiler_max_events": (1_000_000, "Span buffer cap: past it "
                                  "events are dropped (and counted in "
                                  "profiler.dropped())"),
    "FLAGS_numerics": ("", "Default numerics-health mode for Model.fit "
                       "(off|record|warn|halt)"),
}

_values: Dict[str, Any] = {
    name: (_parse(os.environ[name], default) if name in os.environ
           else default)
    for name, (default, _) in _DEFAULTS.items()}


def _canon(name: str) -> str:
    key = name if name.startswith("FLAGS_") else "FLAGS_" + name
    if key not in _values:
        raise ValueError(f"Flag {name} not registered")
    return key


def get_flags(flags) -> Dict[str, Any]:
    if isinstance(flags, str):
        flags = [flags]
    return {_canon(f): _values[_canon(f)] for f in flags}


def set_flags(flags: Dict[str, Any]) -> None:
    for name, value in flags.items():
        key = _canon(name)
        _values[key] = type(_DEFAULTS[key][0])(value)


def flag_value(name: str):
    return _values[name]
