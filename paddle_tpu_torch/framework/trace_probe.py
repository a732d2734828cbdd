"""Retrace-cause tracking: records WHY a step was built again for a new
signature (counterpart of ``paddle_tpu/framework/trace_probe.py``).

The JAX package registers a site's signature when ``jax.jit`` traces it,
once per new input signature. The port has no trace: its step builders
(``models/generation.py``) record the signature of the operands a built
closure takes when they build it for a new bucket, which is when the
JAX engine traces. A SECOND record at the same site diffs the new
signature against the last one and classifies the cause:

* ``shape``      — same leaf structure/dtypes, at least one shape changed
                   (the "bucket your variable-length data" class);
* ``dtype``      — a leaf dtype changed;
* ``structure``  — leaf count / tree structure changed;
* ``static_arg`` — a static (non-array) argument changed, keyed by which
                   component (a known component name, such as
                   ``frozen_set``, is the cause itself).

Counters (framework/monitor.py): ``dispatch/retrace_cause`` (total) and
``dispatch/retrace_cause/<cause>``.

Cost model: ``record`` runs when a step is built, never per call. Site
bookkeeping takes a lock; builds are orders of magnitude rarer than
calls.
"""
from __future__ import annotations

import threading
from typing import Any, Dict, Optional, Tuple

from .monitor import stat_add

__all__ = ["site", "snapshot", "reset", "sig_of"]

_lock = threading.Lock()
_sites: Dict[str, "_Site"] = {}
# registry bound: hapi allocates one site per Model instance (and a
# serving engine several per bucket), so a sweep/notebook creating
# thousands of Models must not grow host memory (and snapshot() cost)
# without bound. Past the cap site() returns an UNREGISTERED _Site:
# counting still works for callers that hold the returned site by
# reference across builds — only snapshot() visibility is bounded.
# ~100 bytes per site: 4096 is still nothing.
_MAX_SITES = 4096


class _Site:
    """One trace location: last signature + per-cause retrace counts."""

    __slots__ = ("name", "last_sig", "last_static", "traces", "causes")

    def __init__(self, name: str):
        self.name = name
        self.last_sig: Optional[Tuple] = None
        self.last_static: Optional[Any] = None
        self.traces = 0
        self.causes: Dict[str, int] = {}

    def record(self, sig: Tuple, static_key: Any = None) -> Optional[str]:
        """Register one trace of this site. ``sig`` is a tuple of
        (shape, dtype) leaf descriptors; ``static_key`` is a dict of
        named static components (the differing NAME becomes the cause
        when it is a known one). Returns the classified cause, or None
        for the site's first trace."""
        with _lock:
            self.traces += 1
            if self.traces == 1:
                self.last_sig, self.last_static = sig, static_key
                return None
            cause = _classify(self.last_sig, sig,
                              self.last_static, static_key)
            self.last_sig, self.last_static = sig, static_key
            self.causes[cause] = self.causes.get(cause, 0) + 1
        stat_add("dispatch/retrace_cause")
        stat_add(f"dispatch/retrace_cause/{cause}")
        return cause


def _classify(old_sig, new_sig, old_static, new_static) -> str:
    if old_static != new_static:
        if isinstance(old_static, dict) and isinstance(new_static, dict):
            for k in old_static:
                if new_static.get(k, old_static[k]) != old_static[k]:
                    # a named static component (e.g. "frozen_set") IS the
                    # cause label when it diffs
                    return k if k in _NAMED_CAUSES else "static_arg"
        return "static_arg"
    if old_sig == new_sig:
        # same signature re-traced: the wrapper identity changed (cache
        # cleared / rebuilt fn) — still a compile, still worth counting
        return "rebuild"
    old_leaves, new_leaves = list(old_sig), list(new_sig)
    if len(old_leaves) != len(new_leaves):
        return "structure"
    dtype_diff = any(o[1] != n[1] for o, n in zip(old_leaves, new_leaves))
    if dtype_diff:
        return "dtype"
    return "shape"


_NAMED_CAUSES = frozenset({"frozen_set", "n_inputs"})


def site(name: str) -> _Site:
    """Get-or-create the named trace site. A serving engine keeps one
    site per step kind and bucket (``serving/fused[q<Q>,t<T>]#<engine>``,
    as the JAX engine names them)."""
    with _lock:
        s = _sites.get(name)
        if s is None:
            s = _Site(name)
            if len(_sites) < _MAX_SITES:
                _sites[name] = s
        return s


def sig_of(arrays) -> Tuple:
    """(shape, dtype) leaf descriptors for a flat sequence of tensors (or
    of ``(shape, dtype)`` pairs, as a builder describes the operands of
    the closure it builds). Dtypes are named as the JAX package names
    them (``bfloat16``, not ``torch.bfloat16``)."""
    out = []
    for a in arrays:
        if isinstance(a, tuple) and len(a) == 2:
            shape, dtype = a
        else:
            shape = getattr(a, "shape", ())
            dtype = getattr(a, "dtype", type(a).__name__)
        out.append((tuple(int(d) for d in shape),
                    str(dtype).replace("torch.", "")))
    return tuple(out)


def snapshot() -> Dict[str, dict]:
    """Per-site view: traces (builds) and retrace causes."""
    with _lock:
        return {name: {"traces": s.traces, "causes": dict(s.causes)}
                for name, s in _sites.items()}


def reset() -> None:
    """Zero all site counts IN PLACE: builders hold their _Site by
    reference, so dropping the registry entries would orphan them —
    their later records would never reach snapshot()."""
    with _lock:
        for s in _sites.values():
            s.last_sig = None
            s.last_static = None
            s.traces = 0
            s.causes = {}
