"""Program registry: what each build cost, and what one execution of a
step costs in FLOPs and bytes (counterpart of
``paddle_tpu/framework/program_registry.py``).

The JAX registry records the wall time of every XLA compile and the
``cost_analysis()`` FLOPs and bytes of each compiled program. The port
compiles no programs: its steps run eagerly. So here

* **compile cost** is the kernels' builds: ``ops/_build.py`` notes each
  ``nvcc`` (and host ``g++``) build with :func:`note_compile` under the
  source's name (``csrc/<name>.cu``), into the ``compile/ms`` and
  ``compile/ms/<site>`` histograms and the ``compile/count`` counter
  (framework/monitor.py);
* **program cost** is counted from the model's configuration and the
  step's bucket shapes by :func:`gpt_step_cost` — the matmuls, plus
  attention over the rows and keys the step's shapes make it read — and
  attached to the step's site with :func:`note_cost`. The count depends
  on the shapes only, never on what ran, so it is the same number on the
  CPU and on the card (the kernels are bound through ctypes, where
  ``FlopCounterMode`` cannot see them). Unlike XLA's count, it leaves
  out elementwise work (LayerNorm, GELU, softmax, sampling).

From these, ``Model.fit`` derives achieved FLOP/s and MFU per log window
(``hapi/flops_per_sec`` / ``hapi/mfu``) and ``GenerationEngine.stats()``
model-FLOPs-per-token and serving MFU — against :func:`peak_flops`, the
card's data-sheet dense 16-bit peak, overridable with
``PADDLE_TPU_PEAK_FLOPS`` (the CPU has no honest peak, so without the
override only raw FLOP/s are reported).

The JAX registry's ``AotSite``/``aot_site``, ``analyze_compiled``,
``analyze_callable`` and ``static_peak_of_trace`` read XLA executables
and jaxprs, which the port does not have (ROADMAP Queue 1 item 5, with
``analysis/``).
"""
from __future__ import annotations

import logging
import os
import threading
from typing import Dict, Optional

from .monitor import stat_add, stat_observe

__all__ = ["ProgramRecord", "note_compile", "note_cost", "get", "snapshot",
           "reset", "peak_flops", "PEAK_FLOPS_TABLE", "gpt_step_cost"]

logger = logging.getLogger(__name__)

_lock = threading.Lock()
_records: Dict[str, "ProgramRecord"] = {}
# a notebook sweep creating thousands of engines must not grow host
# memory without bound; past the cap records still accumulate for
# callers holding them by reference, only snapshot() visibility is
# bounded
_MAX_RECORDS = 1024

# dense 16-bit (bf16/fp16) tensor-core peak FLOP/s by device-name
# substring, first match wins (data sheets). Override with
# PADDLE_TPU_PEAK_FLOPS (a float) — the escape hatch for unlisted cards
# AND the pinned fake peak the tests use to exercise the MFU math on the
# CPU.
PEAK_FLOPS_TABLE = (
    ("h100 pcie", 756e12), ("h100", 989e12),
)


class ProgramRecord:
    """Per-site build + cost bookkeeping (host ints/floats only)."""

    __slots__ = ("site", "compiles", "compile_ms_total", "last_compile_ms",
                 "eqns", "flops", "bytes_accessed", "temp_bytes",
                 "argument_bytes", "output_bytes", "generated_code_bytes",
                 "static_peak_bytes")

    def __init__(self, site: str):
        self.site = site
        self.compiles = 0
        self.compile_ms_total = 0.0
        self.last_compile_ms: Optional[float] = None
        self.eqns: Optional[int] = None
        self.flops: Optional[float] = None
        self.bytes_accessed: Optional[float] = None
        self.temp_bytes: Optional[int] = None
        self.argument_bytes: Optional[int] = None
        self.output_bytes: Optional[int] = None
        self.generated_code_bytes: Optional[int] = None
        self.static_peak_bytes: Optional[int] = None

    def as_dict(self) -> dict:
        return {k: getattr(self, k) for k in self.__slots__}

    def __repr__(self):
        return (f"<ProgramRecord {self.site!r} compiles={self.compiles} "
                f"flops={self.flops}>")


def _record(site: str) -> ProgramRecord:
    with _lock:
        r = _records.get(site)
        if r is None:
            r = ProgramRecord(site)
            if len(_records) < _MAX_RECORDS:
                _records[site] = r
        return r


def note_compile(site: str, wall_ms: float, eqns: Optional[int] = None,
                 analysis: Optional[dict] = None) -> ProgramRecord:
    """Record one build of ``site``: wall ms into the ``compile/ms``
    histograms (global + per-site), ``compile/count``, and — when the
    caller has them — cost figures onto the site's :class:`ProgramRecord`
    (latest build wins)."""
    rec = _record(site)
    with _lock:
        rec.compiles += 1
        rec.compile_ms_total += float(wall_ms)
        rec.last_compile_ms = float(wall_ms)
        if eqns is not None:
            rec.eqns = int(eqns)
        if analysis:
            for k in ("flops", "bytes_accessed", "temp_bytes",
                      "argument_bytes", "output_bytes",
                      "generated_code_bytes", "static_peak_bytes"):
                if analysis.get(k) is not None:
                    setattr(rec, k, analysis[k])
        registered = _records.get(site) is rec
    stat_add("compile/count")
    stat_observe("compile/ms", float(wall_ms))
    if registered:
        # per-site histograms only for REGISTERED sites (the record cap
        # bounds their number)
        stat_observe(f"compile/ms/{site}", float(wall_ms))
    return rec


def note_cost(site: str, flops: Optional[float] = None,
              bytes_accessed: Optional[float] = None) -> ProgramRecord:
    """Attach one step's counted cost to ``site`` (a step built, not a
    compile: no ``compile/*`` series moves)."""
    rec = _record(site)
    with _lock:
        if flops is not None:
            rec.flops = float(flops)
        if bytes_accessed is not None:
            rec.bytes_accessed = float(bytes_accessed)
    return rec


def get(site: str) -> Optional[ProgramRecord]:
    with _lock:
        return _records.get(site)


def snapshot() -> Dict[str, dict]:
    with _lock:
        return {name: r.as_dict() for name, r in _records.items()}


def reset() -> None:
    with _lock:
        _records.clear()


# ---------------------------------------------------------------------------
# counted step cost
# ---------------------------------------------------------------------------

def gpt_step_cost(cfg, rows: int, key_reads: int, head_rows: int, *,
                  train: bool = False, param_bytes: int = 2,
                  kv_bytes: int = 2, kv_rows_read: int = 0,
                  kv_rows_written: int = 0) -> dict:
    """FLOPs and bytes of one GPT step from its configuration ``cfg``
    (``hidden_size``, ``num_hidden_layers``, ``intermediate_size``,
    ``vocab_size``) and shapes:

    * ``rows`` token rows through the blocks: per layer the q/k/v and
      output projections (``4 h^2``) and the MLP (``2 h i``), two FLOPs a
      multiply-add;
    * ``key_reads`` (query row, key) pairs of attention summed over the
      rows, per layer ``4 h`` FLOPs each (``q k^T`` and ``p v``);
    * ``head_rows`` rows through the tied LM head (``2 h V`` each);
    * ``train``: the backward pass counted as twice the forward.

    ``bytes_accessed`` is the weights read once (``param_bytes`` a
    parameter) plus the KV cache rows read (``kv_rows_read`` key rows,
    each ``2 L h`` elements of ``kv_bytes``) and written
    (``kv_rows_written``)."""
    h, L = int(cfg.hidden_size), int(cfg.num_hidden_layers)
    inter = int(getattr(cfg, "intermediate_size", 4 * h))
    V = int(cfg.vocab_size)
    per_row = 2 * (4 * h * h + 2 * h * inter)
    flops = L * (per_row * int(rows) + 4 * h * int(key_reads)) \
        + 2 * h * V * int(head_rows)
    if train:
        flops *= 3
    n_params = L * (4 * h * h + 2 * h * inter) + V * h \
        + int(cfg.max_position_embeddings) * h
    nbytes = n_params * param_bytes \
        + 2 * L * h * kv_bytes * (int(kv_rows_read) + int(kv_rows_written))
    return {"flops": float(flops), "bytes_accessed": float(nbytes)}


# ---------------------------------------------------------------------------
# peak FLOPs / MFU
# ---------------------------------------------------------------------------

def peak_flops(device_kind: Optional[str] = None) -> Optional[float]:
    """Peak dense 16-bit FLOP/s of the current (or named) card.
    ``PADDLE_TPU_PEAK_FLOPS`` (a float) overrides everything — the knob
    for unlisted cards and for pinning a fake peak in tests. ``None``
    when nothing applies (the CPU: report FLOP/s, never a made-up
    MFU)."""
    env = os.environ.get("PADDLE_TPU_PEAK_FLOPS", "").strip()
    if env:
        try:
            v = float(env)
            if v > 0:
                return v
        except ValueError:
            logger.debug("bad PADDLE_TPU_PEAK_FLOPS=%r ignored", env)
    if device_kind is None:
        import torch
        if not torch.cuda.is_available():
            return None
        device_kind = torch.cuda.get_device_name()
    dk = str(device_kind).lower()
    for sub, peak in PEAK_FLOPS_TABLE:
        if sub in dk:
            return peak
    return None
