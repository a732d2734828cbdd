"""Training numerics health: device-side sentinels, gradient telemetry,
and a train-loop flight recorder with anomaly postmortem (counterpart of
``paddle_tpu/profiler/numerics.py``).

The reference framework's numerics debugging story is
``FLAGS_check_nan_inf`` — a synchronous host sweep of EVERY op output
after EVERY kernel launch — which is exactly the per-step host sync an
asynchronous train loop exists to avoid. This module keeps one rule:
**the audit is computed ON THE DEVICE in the eager train step, after the
optimizer, and fetched only at the windows where ``Model.fit`` already
reads the loss back**, so a ``fit()`` with numerics armed costs no extra
host sync.

Three layers:

* **device audit** (:func:`build_audit`, called by ``hapi/model.py``'s
  step when ``Model.fit(numerics=...)`` is not ``'off'``) — one small
  f32 device vector per step: a packed finite bitmask (loss / grads /
  post-update params), the global grad norm (REUSED from the
  ``ClipGradByGlobalNorm`` clip when one is set — never computed
  twice), the clipped norm, the global param norm, the update norm
  ``‖Δw‖``, and per-layer-group nonfinite gradient element counts for
  blame. The vectors wait on the device and are copied to the host in
  the same copy as the window's loss.
* **telemetry + flight recorder** (:class:`NumericsRecorder`) — on
  every window the decoded records feed the monitor histograms
  (``hapi/grad_norm``, ``hapi/update_ratio``, ``hapi/grad_clip_ratio``)
  and counters (``hapi/nonfinite_steps``, ``hapi/loss_spikes``), and
  land in a bounded per-Model ring of per-step records (loss, grad
  norm, update ratio, lr, finite bitmask, GradScaler state,
  retrace-cause delta, ledger bytes), dumpable after the fact.
* **policy + postmortem** — ``Model.fit(numerics='record'|'warn'|
  'halt')`` reacts at the window: nonfinite steps in ``halt`` mode
  raise a named :class:`NumericsError` AFTER the anomaly postmortem
  JSON lands (ring tail + blamed layer groups + scaler state + monitor
  snapshot + the memory postmortem's path) and fit's
  ``on_train_abort`` teardown runs; ``warn`` dumps the same postmortem
  and warns without killing the run. A loss-spike detector (robust
  z-score over the ring: ``|loss - median| / (1.4826 * MAD)``) fires
  the postmortem in ``warn``/``halt`` mode but NEVER raises — a spike
  is a lead, not a verdict.

Threading / sync contract: everything in this module is host-pure over
NUMPY inputs except :func:`build_audit` and :func:`build_audit_flat`,
which queue device work and read nothing back.
"""
from __future__ import annotations

import json
import math
import os
import statistics
import tempfile
import threading
import time
import warnings
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..framework.monitor import (all_stats, stat_add, stat_histogram,
                                 stat_observe)
from . import memory as _memory

__all__ = ["NumericsError", "AuditLayout", "NumericsRecorder",
           "build_audit", "build_audit_flat", "group_params",
           "decode_audit", "flag_mode", "live_recorders", "MODES",
           "N_FIXED", "FINITE_ALL"]

MODES = ("off", "record", "warn", "halt")

# live recorders, for the statusz training section and the metrics
# registry collector (weakly held: recorders die with their Models)
import weakref  # noqa: E402

_LIVE_RECORDERS: "weakref.WeakSet" = weakref.WeakSet()
_recorder_seq = 0


def live_recorders() -> List["NumericsRecorder"]:
    """The process's live training recorders, recorder_id order."""
    return sorted(_LIVE_RECORDERS,
                  key=lambda r: getattr(r, "recorder_id", 0))


def _metrics_collector():
    """Registry collector: per-recorder anomaly counters, labeled
    ``{recorder=<id>}`` — the numerics island on the fleet scrape."""
    out = []
    for rec in list(_LIVE_RECORDERS):
        labels = {"recorder": str(getattr(rec, "recorder_id", 0))}
        out.append(("counter", "training_steps_recorded", labels,
                    rec.steps_recorded))
        out.append(("counter", "training_anomalies_recorded", labels,
                    rec.anomalies_recorded))
        out.append(("counter", "training_postmortem_dumps", labels,
                    rec.dumps))
    return out


def _register_numerics_collector() -> None:
    try:
        from ..framework import metrics as _metrics
        _metrics.register_collector("training_numerics",
                                    _metrics_collector)
    except Exception:                                    # noqa: BLE001
        pass


_register_numerics_collector()

# audit vector layout: fixed scalar slots, then one per-group count
IDX_BITS = 0          # packed finite bitmask (see bit constants below)
IDX_LOSS = 1          # the step's loss value (f32)
IDX_GRAD_NORM = 2     # global UNCLIPPED grad norm
IDX_CLIPPED_NORM = 3  # global grad norm after clipping (== raw w/o clip)
IDX_PARAM_NORM = 4    # global trainable-param norm (pre-update)
IDX_UPDATE_NORM = 5   # global update norm ‖Δw‖ (post - pre)
N_FIXED = 6

BIT_LOSS = 1          # loss is finite
BIT_GRADS = 2         # every gradient element is finite
BIT_UPDATE = 4        # every post-update param element is finite
FINITE_ALL = BIT_LOSS | BIT_GRADS | BIT_UPDATE


class NumericsError(RuntimeError):
    """Training numerics went nonfinite under ``fit(numerics='halt')``.

    Raised at the flush window that detected the anomaly, AFTER the
    anomaly postmortem JSON was dumped (its path is in the message) —
    fit's ``on_train_abort`` teardown runs on the way out exactly as for
    any other training failure."""


def group_params(names: Sequence[str],
                 max_groups: int = 32) -> Dict[str, Tuple[str, ...]]:
    """Deterministic layer-group partition of parameter tree names, for
    nonfinite blame. Prefers the parent-module path (``"0.weight"`` →
    ``"0"``, ``"gpt.blocks.3.attn.q.weight"`` → the attn layer), then
    coarsens (first two components, then the first) until the group
    count fits ``max_groups`` — the audit vector carries one count per
    group, so blame granularity trades off against vector size."""
    names = sorted(names)

    def parent(n: str) -> str:
        head, _, _ = n.rpartition(".")
        return head or n

    keyfns = [parent,
              lambda n: ".".join(n.split(".")[:2]),
              lambda n: n.split(".", 1)[0]]
    groups: Dict[str, List[str]] = {}
    for keyfn in keyfns:
        groups = {}
        for n in names:
            groups.setdefault(keyfn(n), []).append(n)
        if len(groups) <= max_groups:
            break
    if len(groups) > max_groups:
        # a flat net (40+ sibling layers) defeats every prefix keyfn —
        # the cap is a hard bound on the device vector's size, so merge
        # lexicographic RANGES of groups until it holds, labeled by
        # their span ("0..17.weight") so blame still localizes
        keys = list(groups)
        per = -(-len(keys) // max_groups)
        merged: Dict[str, List[str]] = {}
        for i in range(0, len(keys), per):
            chunk = keys[i:i + per]
            label = chunk[0] if len(chunk) == 1 \
                else f"{chunk[0]}..{chunk[-1]}"
            merged[label] = [n for k in chunk for n in groups[k]]
        groups = merged
    return {g: tuple(ms) for g, ms in groups.items()}


@dataclass(frozen=True)
class AuditLayout:
    """Host-side schema of the device audit vector: the ordered layer
    groups and their member parameter names. Static per train-step
    trace (the frozen set is baked in, so the trainable name set is
    too); held on the Model next to the step it describes."""

    groups: Tuple[str, ...]
    members: Dict[str, Tuple[str, ...]] = field(hash=False)

    @staticmethod
    def build(trainable_names: Sequence[str],
              max_groups: int = 32) -> "AuditLayout":
        members = group_params(trainable_names, max_groups)
        return AuditLayout(groups=tuple(members), members=members)

    @property
    def size(self) -> int:
        return N_FIXED + len(self.groups)


def global_grad_norm(grads):
    """True global L2 norm over a gradient dict, f32-accumulated — THE
    reduction the audit reports when the clip has none to reuse. One
    owner (here) so the audit's fallback in ``build_audit`` and the
    per-tensor-clip fallback in ``hapi/model.py`` can never diverge."""
    import torch
    vals = [g for g in grads.values()] if isinstance(grads, dict) \
        else list(grads)
    if not vals:
        return torch.zeros((), dtype=torch.float32)
    sq = torch.stack([torch.sum(torch.square(g.float())) for g in vals])
    return torch.sqrt(sq.sum())


def _sq_sum(tensors, ref):
    import torch
    if not tensors:
        return torch.zeros((), dtype=torch.float32, device=ref.device)
    return torch.stack([torch.sum(torch.square(t.float()))
                        for t in tensors]).sum()


def build_audit(loss, grads, params, new_params, layout: AuditLayout,
                grad_norm=None, clipped_norm=None):
    """The device-side audit of one step: device work queued behind the
    step, nothing read back.

    ``grads``/``params``/``new_params`` are dicts of the RAW trainable
    parameters' tensors by name (grads pre-clip, so blame points at the
    true origin: a global-norm clip smears one NaN over every gradient;
    ``params`` before the update, ``new_params`` after it).
    ``grad_norm``/``clipped_norm`` reuse the clip's reduction when the
    optimizer clips by global norm — the norm is never computed twice.
    Returns one f32 device vector of ``layout.size`` elements (see the
    ``IDX_*`` layout constants)."""
    import torch

    loss_s = torch.as_tensor(loss).detach().reshape(-1)[0].float()
    dev = loss_s.device
    zero_i = torch.zeros((), dtype=torch.int64, device=dev)
    counts = []
    for g in layout.groups:
        c = zero_i
        for name in layout.members[g]:
            c = c + torch.sum(~torch.isfinite(grads[name]))
        counts.append(c)
    total_nonfinite = torch.stack(counts).sum() if counts else zero_i
    if grad_norm is None:
        grad_norm = global_grad_norm(grads)
    grad_norm = torch.as_tensor(grad_norm).float().to(dev)
    clipped_norm = grad_norm if clipped_norm is None \
        else torch.as_tensor(clipped_norm).float().to(dev)
    p_sq = _sq_sum(list(params.values()), loss_s)
    u_sq = _sq_sum([new_params[k].float() - params[k].float()
                    for k in params], loss_s)
    update_ok = torch.ones((), dtype=torch.bool, device=dev)
    for v in new_params.values():
        update_ok = update_ok & torch.all(torch.isfinite(v))
    bits = (torch.isfinite(loss_s).float() * BIT_LOSS
            + (total_nonfinite == 0).float() * BIT_GRADS
            + update_ok.float() * BIT_UPDATE)
    vec = torch.stack([bits, loss_s, grad_norm.reshape(()),
                       clipped_norm.reshape(()), torch.sqrt(p_sq),
                       torch.sqrt(u_sq)])
    if counts:
        vec = torch.cat([vec, torch.stack(counts).float()])
    return vec


def build_audit_flat(loss, flat_grads, flat_params, flat_new_params,
                     group_ids, layout: AuditLayout, axis_name=None,
                     grad_norm=None, clipped_norm=None):
    """Sharded-stripe variant of :func:`build_audit` for a train step
    whose replicas each hold a STRIPE of the flat gradient/param
    vectors: every reduction is summed over ``axis_name`` — the
    ``torch.distributed`` process group of the replicas (None: the
    default group; a process without ``torch.distributed`` initialized
    is one replica) — so the reported norms and finite bits cover the
    FULL gradient and update, never the local shard. ``group_ids`` maps
    each stripe element to its layer group (the extra ``len(groups)``
    bucket is padding and is dropped). Same output layout as
    build_audit; decode_audit reads both."""
    import torch
    import torch.distributed as dist

    def psum(x):
        if dist.is_available() and dist.is_initialized():
            dist.all_reduce(x, group=axis_name)
        return x

    n_groups = len(layout.groups)
    loss_s = torch.as_tensor(loss).detach().reshape(-1)[0].float()
    nf = (~torch.isfinite(flat_grads)).long()
    counts = torch.zeros(n_groups + 1, dtype=torch.int64,
                         device=flat_grads.device)
    counts.index_add_(0, group_ids.long(), nf)
    counts = psum(counts[:n_groups].clone())
    total_nonfinite = counts.sum() if n_groups else psum(nf.sum())
    if grad_norm is None:
        grad_norm = torch.sqrt(psum(torch.sum(torch.square(
            flat_grads.float()))))
    grad_norm = torch.as_tensor(grad_norm).float()
    clipped_norm = grad_norm if clipped_norm is None \
        else torch.as_tensor(clipped_norm).float()
    pf = flat_params.float()
    nf32 = flat_new_params.float()
    p_sq = psum(torch.sum(torch.square(pf)))
    u_sq = psum(torch.sum(torch.square(nf32 - pf)))
    bad_new = psum((~torch.isfinite(flat_new_params)).long().sum())
    bits = (torch.isfinite(loss_s).float() * BIT_LOSS
            + (total_nonfinite == 0).float() * BIT_GRADS
            + (bad_new == 0).float() * BIT_UPDATE)
    vec = torch.stack([bits, loss_s, grad_norm.reshape(()),
                       clipped_norm.reshape(()), torch.sqrt(p_sq),
                       torch.sqrt(u_sq)])
    if n_groups:
        vec = torch.cat([vec, counts.float()])
    return vec


def decode_audit(vec: np.ndarray, layout: AuditLayout) -> Dict[str, Any]:
    """Host-side decode of one fetched audit vector (numpy in, plain
    Python out) into the per-step record the recorder rings."""
    v = np.asarray(vec, np.float64).ravel()
    bits = int(v[IDX_BITS])
    grad_norm = float(v[IDX_GRAD_NORM])
    clipped = float(v[IDX_CLIPPED_NORM])
    p_norm = float(v[IDX_PARAM_NORM])
    u_norm = float(v[IDX_UPDATE_NORM])
    rec: Dict[str, Any] = {
        "finite_bits": bits,
        "finite": bits == FINITE_ALL,
        "loss_finite": bool(bits & BIT_LOSS),
        "grads_finite": bool(bits & BIT_GRADS),
        "update_finite": bool(bits & BIT_UPDATE),
        "loss": float(v[IDX_LOSS]),
        "grad_norm": grad_norm,
        "clipped_grad_norm": clipped,
        "param_norm": p_norm,
        "update_norm": u_norm,
    }
    rec["update_ratio"] = (u_norm / p_norm) if p_norm > 0 else 0.0
    rec["clip_ratio"] = (clipped / grad_norm) \
        if (grad_norm > 0 and math.isfinite(grad_norm)) else 1.0
    rec["nonfinite_groups"] = {
        g: int(c) for g, c in zip(layout.groups, v[N_FIXED:]) if c > 0}
    return rec


def flag_mode() -> str:
    """Env-seeded default mode for ``Model.fit(numerics=None)``:
    ``FLAGS_numerics`` when set to a known mode (lenient normalization
    — a bad env value means un-audited, never a crash blaming an
    argument that was never passed); otherwise ``FLAGS_check_nan_inf``
    seeds ``'halt'`` — the reference flag ABORTS on the first NaN/Inf,
    and this is its windowed, zero-sync analog — else ``'off'``."""
    from ..framework.flags import flag_value
    v = str(flag_value("FLAGS_numerics") or "").strip().lower()
    if v in MODES:
        return v
    if v in ("1", "on", "true", "yes"):
        return "warn"
    if flag_value("FLAGS_check_nan_inf"):
        return "halt"
    return "off"


class NumericsRecorder:
    """The TRAINING flight recorder: a bounded ring of per-step numerics
    records plus the anomaly policy, mirroring the serving
    :class:`~..serving.flight_recorder.FlightRecorder` (host dicts,
    bounded, always on while numerics is armed, dumpable postmortem).

    Written by ``Model._flush_window`` (one ``record_window`` call per
    flush, decoded numpy in); read by anyone (``snapshot()`` / the
    postmortem dump) — the one small lock covers both, and writes are
    per-window, not per-step-dispatch, so contention is negligible."""

    def __init__(self, max_steps: int = 1024, max_anomalies: int = 64,
                 spike_zscore: float = 8.0, spike_min_history: int = 8,
                 spike_window: int = 64):
        if max_steps < 1:
            raise ValueError("max_steps must be >= 1")
        self._lock = threading.Lock()
        self._ring: deque = deque(maxlen=int(max_steps))
        self._anomalies: deque = deque(maxlen=int(max_anomalies))
        self.steps_recorded = 0       # monotonic (ring drops, this doesn't)
        self.anomalies_recorded = 0
        self.last_dump_path: Optional[str] = None
        self.dumps = 0
        self._spike_z = float(spike_zscore)
        self._spike_min = int(spike_min_history)
        self._spike_window = int(spike_window)
        self._run = 0        # fit generation (see new_run)
        # telemetry spine: live recorders are a statusz
        # section and a registry-collector source; weak, so a dropped
        # Model's recorder leaves the console with it
        global _recorder_seq
        _recorder_seq += 1
        self.recorder_id = _recorder_seq
        _LIVE_RECORDERS.add(self)

    def new_run(self) -> None:
        """Mark a fit boundary. The ring deliberately persists across
        fits (the flight-recorder continuity that makes postmortems
        useful), but the loss-SPIKE baseline must not: a new task/
        dataset whose healthy initial loss sits far from the previous
        run's converged median would otherwise z-score as a spike on
        its very first windows. Records are stamped with the run
        generation and the spike history reads only the current one."""
        with self._lock:
            self._run += 1

    # -- spike detection ---------------------------------------------------
    def _run_losses(self) -> List[float]:
        """The current run's finite losses in ring order — the spike
        baseline. Built ONCE per flush (record_window extends it
        incrementally as the window's records ring), so a big epoch-tail
        window costs O(window + ring), not O(window × ring)."""
        with self._lock:
            return [r["loss"] for r in self._ring
                    if r.get("run") == self._run
                    and math.isfinite(r.get("loss", math.nan))]

    def _spike_z_of(self, loss: float,
                    hist: List[float]) -> Optional[float]:
        """Robust z-score of ``loss`` against the recent FINITE losses
        in ``hist``: ``|x - median| / max(1.4826 * MAD, floor)``. The
        floor (1e-3 of the median's magnitude) keeps a perfectly flat
        loss history from turning any wiggle into an infinite score
        while still letting a genuine jump off a plateau register."""
        if not math.isfinite(loss):
            return None
        hist = hist[-self._spike_window:]
        if len(hist) < self._spike_min:
            return None
        med = statistics.median(hist)
        mad = statistics.median([abs(x - med) for x in hist])
        scale = max(1.4826 * mad, 1e-3 * max(1.0, abs(med)))
        return abs(loss - med) / scale

    # -- the per-flush entry point -----------------------------------------
    def record_window(self, entries: Sequence[Tuple[int, np.ndarray]],
                      layout: AuditLayout, *, mode: str = "record",
                      lr: Optional[float] = None,
                      scaler: Optional[dict] = None,
                      retrace_delta: int = 0,
                      ledger_bytes: Optional[int] = None,
                      context: Optional[dict] = None) -> Dict[str, Any]:
        """Ingest one flush window's decoded audits: feed the monitor,
        ring the per-step records, detect anomalies, and apply the
        policy. ``entries`` is ``[(global_step, numpy audit vector)]``
        in step order — ALREADY fetched by the caller (this module
        never syncs).

        Returns the flush-log update (``grad_norm``, plus
        ``loss_scale`` when a scaler is active) for the ProgBar.
        Raises :class:`NumericsError` only in ``halt`` mode on a
        nonfinite step, AFTER the postmortem dump; a loss spike warns
        and dumps but never raises, and every other internal failure is
        the caller's to absorb."""
        anomalies: List[dict] = []
        last: Optional[dict] = None
        hist = self._run_losses()
        for step, vec in entries:
            rec = decode_audit(vec, layout)
            rec["step"] = int(step)
            rec["run"] = self._run
            if lr is not None:
                rec["lr"] = float(lr)
            if scaler is not None:
                rec["scaler"] = dict(scaler)
            # window-level context rides on every record of the window:
            # retraces since the last flush and the HBM-ledger watermark
            rec["retrace_delta"] = int(retrace_delta)
            if ledger_bytes is not None:
                rec["ledger_bytes"] = int(ledger_bytes)
            if math.isfinite(rec["grad_norm"]):
                stat_observe("hapi/grad_norm", rec["grad_norm"])
            if math.isfinite(rec["update_ratio"]):
                stat_observe("hapi/update_ratio", rec["update_ratio"])
            if math.isfinite(rec["clip_ratio"]):
                stat_observe("hapi/grad_clip_ratio", rec["clip_ratio"])
            if not rec["finite"]:
                stat_add("hapi/nonfinite_steps")
                anomalies.append({
                    "kind": "nonfinite", "step": rec["step"],
                    "loss_finite": rec["loss_finite"],
                    "grads_finite": rec["grads_finite"],
                    "update_finite": rec["update_finite"],
                    "blamed_groups": sorted(rec["nonfinite_groups"]),
                    "nonfinite_counts": rec["nonfinite_groups"],
                })
            else:
                z = self._spike_z_of(rec["loss"], hist)
                if z is not None and z >= self._spike_z:
                    stat_add("hapi/loss_spikes")
                    anomalies.append({
                        "kind": "loss_spike", "step": rec["step"],
                        "loss": rec["loss"], "zscore": round(z, 2),
                    })
            with self._lock:
                self._ring.append(rec)
                self.steps_recorded += 1
            if math.isfinite(rec["loss"]):
                hist.append(rec["loss"])
            last = rec
        logs: Dict[str, Any] = {}
        if last is not None:
            logs["grad_norm"] = last["grad_norm"]
            if scaler is not None:
                logs["loss_scale"] = float(scaler.get("scale", 0.0))
        if not anomalies:
            return logs
        with self._lock:
            for a in anomalies:
                self._anomalies.append(a)
                self.anomalies_recorded += 1
        if mode in ("warn", "halt"):
            hard = [a for a in anomalies if a["kind"] == "nonfinite"]
            lead = hard[0] if hard else anomalies[0]
            path = self.postmortem(lead, context=context)
            if mode == "halt" and hard:
                blamed = hard[0]["blamed_groups"] or "loss/update only"
                raise NumericsError(
                    f"nonfinite training numerics at step "
                    f"{hard[0]['step']} (blamed layer groups: {blamed}); "
                    f"anomaly postmortem: {path}")
            warnings.warn(
                f"training numerics anomaly: {lead} "
                f"(postmortem: {path})", RuntimeWarning, stacklevel=3)
        return logs

    # -- readers -----------------------------------------------------------
    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "records": [dict(r) for r in self._ring],
                "anomalies": [dict(a) for a in self._anomalies],
                "steps_recorded": self.steps_recorded,
                "anomalies_recorded": self.anomalies_recorded,
                "ring_capacity": self._ring.maxlen,
            }

    def anomaly_list(self) -> List[dict]:
        with self._lock:
            return [dict(a) for a in self._anomalies]

    # -- postmortem --------------------------------------------------------
    def postmortem(self, anomaly: Optional[dict] = None,
                   path: Optional[str] = None,
                   context: Optional[dict] = None) -> Optional[str]:
        """Dump the numerics picture: the ring tail, the anomaly and its
        blamed layer groups, the active GradScaler state, a monitor
        snapshot (``hapi/``/``amp/``/``dispatch/`` counters plus the
        numerics histograms), and the path of a MEMORY postmortem
        dumped alongside (profiler/memory.py — ledger, timeline,
        largest live arrays). Best effort and NEVER raises — it runs
        inside the flush's failure handling, and a broken disk must not
        replace the numerics error with an IO one. Returns the file
        path (``None`` on failure)."""
        try:
            mem_path = _memory.oom_postmortem(
                None, extra={"phase": "numerics",
                             "anomaly_step":
                                 (anomaly or {}).get("step")})
            hist_names = ("hapi/grad_norm", "hapi/update_ratio",
                          "hapi/grad_clip_ratio", "hapi/step_time_ms",
                          "hapi/host_sync_ms", "amp/loss_scale")
            with self._lock:
                ring = [dict(r) for r in self._ring]
                anoms = [dict(a) for a in self._anomalies]
            scaler = ring[-1].get("scaler") if ring else None
            doc: Dict[str, Any] = {
                "reason": "numerics anomaly" if anomaly is not None
                          else "requested",
                "anomaly": anomaly,
                # the full anomaly ring: once NaN propagates, every
                # later window re-dumps with ITS anomaly — the ORIGIN
                # (the first nonfinite step) must stay in the artifact
                "anomalies": anoms,
                "blamed_groups": (anomaly or {}).get("blamed_groups"),
                "dumped_at": time.time(),
                "ring": ring,
                "scaler": scaler,
                "monitor": {
                    "counters": {k: v for k, v in all_stats().items()
                                 if k.startswith(("hapi/", "amp/",
                                                  "dispatch/"))},
                    "histograms": {n: stat_histogram(n)
                                   for n in hist_names
                                   if stat_histogram(n) is not None},
                },
                "memory_postmortem": mem_path,
            }
            if context:
                doc["context"] = context
            if path is None:
                path = os.path.join(
                    tempfile.gettempdir(),
                    f"paddle_numerics_postmortem_{os.getpid()}_"
                    f"{id(self):x}.json")
            d = os.path.dirname(os.path.abspath(path))
            os.makedirs(d, exist_ok=True)
            with open(path, "w") as f:
                json.dump(doc, f, default=repr)
            with self._lock:
                self.last_dump_path = path
                self.dumps += 1
            stat_add("hapi/numerics_postmortem")
            return path
        except Exception:                                # noqa: BLE001
            return None

    def __repr__(self):
        with self._lock:
            return (f"<NumericsRecorder steps={len(self._ring)}/"
                    f"{self.steps_recorded} anomalies="
                    f"{self.anomalies_recorded} dumps={self.dumps}>")
