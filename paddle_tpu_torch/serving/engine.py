"""``GenerationEngine`` — continuous-batching serving of a port GPT model
(counterpart of ``paddle_tpu/serving/engine.py``).

Two KV layouts and two attention paths share this surface:

* ``kv_layout="dense", attention="gather"`` (the default, as in the JAX
  package) — one ``[heads, max_len, head_dim]`` stripe per slot
  (:class:`~.kv_pool.KVCachePool`); each admission runs the prefill of
  its pow2 capacity bucket, and each cycle is ONE decode step over every
  slot, attention through the masked plain composition over the slot's
  ``[lo, pos]`` rows;
* ``kv_layout="paged", attention="gather"`` — a block pool addressed
  through per-request page tables (:class:`~.paging.PagedKVPool`):
  admission gates on free blocks, growth preempts the youngest request,
  full prompt blocks are shared through the prefix cache (a hit skips
  the prefill and replays the tail through the decode step), and each
  decode step gathers the virtual cache through the tables. It is the
  oracle the fused engine is held against;
* ``kv_layout="paged", attention="fused"`` — ONE fused launch a cycle
  over a ragged batch: prompts feed in ``prefill_budget``-token chunks
  mixed with one row per decoding slot, and the ragged paged attention
  kernel walks each sequence's page table in the block pool. With
  ``spec_draft`` (speculative decoding) a small draft model proposes
  ``spec_k`` tokens for each decoding slot in one call over its own
  dense slot pool, and the fused launch verifies them all as extra
  rows: greedy output stays token-identical, sampled output keeps the
  target's distribution (rejection sampling on the device).

With ``host_tier_bytes`` (paged layouts) a bounded host-DRAM tier
(:class:`~.host_tier.HostBlockPool`) holds the prefix-cache blocks the
device LRU evicts, and a hit on a demoted chain promotes it back through
an asynchronous host-to-device copy while the decode slots keep running.
``submit(tenant=, lane=)`` tags a request's weighted-fair admission class
(``lane_weights``, default ``interactive`` 4 : ``batch`` 1).

Telemetry: the scheduler's always-on flight recorder
(:attr:`GenerationEngine.flight_recorder`,
:meth:`GenerationEngine.dump_flight_recorder`) gives ``stats()`` its
latency percentiles and ring-window throughput; each engine publishes
its ``stats()`` through the metrics registry (``{engine=<id>}`` series,
pulled at scrape time) and a line of the ``serving engines`` statusz
section. ``stats()`` also gives ``model_flops_per_token``,
``decode_bytes_per_token``, ``decode_tokens_per_sec``,
``serving_flops_per_sec`` and, with a known peak, ``serving_mfu``: the
counted cost of each decode step (``framework/program_registry.py``
``gpt_step_cost``, from the model's configuration and the step's bucket)
over the flight recorder's cycle ring.

The JAX package caches one jitted program per bucket; here each bucket
(capacity bucket, table bucket, or q-row and table bucket) keeps one
built step function in the same dicts, and nothing is compiled: the
steps run eagerly and write the pool in place. Each build records its
signature at the bucket's trace-probe site (``serving/fused[q<Q>,t<T>]#
<engine>`` and the like, the JAX engine's names) and its counted cost at
the program-registry site of the same name.
"""
from __future__ import annotations

import threading
import weakref
from typing import Iterator, Optional

import numpy as np
import torch

from .._device import resolve_device
from ..framework import metrics as _metrics
from ..framework import program_registry as _registry
from ..framework import trace_probe as _probe
from ..framework.monitor import stat_add
from ..models.generation import (build_draft_prefill_fn,
                                 build_draft_propose_scan_fn,
                                 build_fused_step_fn, build_paged_decode_fn,
                                 build_paged_prefill_fn,
                                 build_slot_decode_fn, build_slot_prefill_fn,
                                 build_spec_verify_fn, make_draft_model)
from ..ops.ragged_paged_attention import (BLOCK_Q, MIN_KV_BLOCK,
                                          min_kv_block_for, ragged_layout)
from .host_tier import HostBlockPool
from .kv_pool import KVCachePool
from .paging import PagedKVPool, PoolCapacityError
from .scheduler import GenerationRequest, Scheduler, _fetch

__all__ = ["GenerationEngine"]

# the JAX engine's arguments for parts of the system the port has not
# taken yet, each with the ROADMAP.md queue that holds it
_NOT_PORTED = {
    "hbm_budget_bytes": "Queue 1 item 5 (the static memory plan, a "
                        "liveness pass that needs analysis/)",
    "mesh": "Queue 1 item 4 (tensor-parallel serving)",
}

_engine_seq = 0
_engine_seq_lock = threading.Lock()

# live engines for the statusz console (weak: a collected or closed
# engine drops out by itself); the section is registered once, at the
# first engine's construction
_LIVE_ENGINES: "weakref.WeakSet" = weakref.WeakSet()
_statusz_registered = False
_statusz_lock = threading.Lock()


def _next_engine_id() -> int:
    global _engine_seq
    with _engine_seq_lock:
        _engine_seq += 1
        return _engine_seq


def _engine_section() -> str:
    """statusz section: one line of load, cache and health per live
    engine, then its flight recorder's failed cycles and last dump."""
    engines = [e for e in list(_LIVE_ENGINES) if not e._closed]
    if not engines:
        return "(no live engines)"
    lines = []
    for e in sorted(engines, key=lambda e: e._eid):
        try:
            s = e.stats()
            head = (f"engine #{e._eid} [{s['kv_layout']}/"
                    f"{s['attention']}] queue={s['queue_depth']} "
                    f"active={s['active_requests']} "
                    f"slots={s['slots_in_use']}/{s['num_slots']}")
            if "kv_blocks_in_use" in s:
                head += (f" blocks={s['kv_blocks_in_use']}/"
                         f"{s['num_blocks']}")
            if "prefix_hit_ratio" in s:
                head += f" prefix_hit={s['prefix_hit_ratio']:.2f}"
            if "host_tier" in s:
                ht = s["host_tier"]
                head += (f" host_tier={ht['blocks']}/"
                         f"{ht['capacity_blocks']}")
            if "spec_accept_rate" in s:
                head += f" spec_accept={s['spec_accept_rate']:.2f}"
            if s.get("serving_mfu") is not None:
                head += f" mfu={s['serving_mfu']:.3f}"
            if s.get("decode_tokens_per_sec") is not None:
                head += f" tok/s={s['decode_tokens_per_sec']:.1f}"
            lines.append(head)
            ttft = s.get("ttft_ms")
            if ttft:
                lines.append(f"  ttft p50 {ttft['p50']:.1f} ms  "
                             f"p95 {ttft['p95']:.1f} ms  "
                             f"(n={ttft['count']})")
            if s.get("nonfinite_cycles"):
                lines.append(f"  !! nonfinite decode cycles: "
                             f"{s['nonfinite_cycles']}")
            rec = e.flight_recorder
            failed = [c for c in rec.snapshot()["cycles"]
                      if c.get("failed")]
            if failed:
                lines.append(f"  !! {len(failed)} failed cycles in the "
                             f"ring; last: {failed[-1].get('failed')}")
            if rec.last_dump_path:
                lines.append(f"  last auto-dump: {rec.last_dump_path}")
        except Exception as err:                         # noqa: BLE001
            lines.append(f"engine #{e._eid}: (stats error: {err!r})")
    return "\n".join(lines)


def _register_engine_telemetry(engine: "GenerationEngine") -> None:
    """Join the statusz console and publish ``engine.stats()`` through
    the metrics registry as ``{engine=<id>}`` gauges and counters,
    pulled only when a scrape asks."""
    global _statusz_registered
    with _statusz_lock:
        if not _statusz_registered:
            _metrics.register_statusz_section("serving engines",
                                              _engine_section)
            _statusz_registered = True
    _LIVE_ENGINES.add(engine)
    ref = weakref.ref(engine)

    def _collect():
        e = ref()
        if e is None or e._closed:
            return ()
        s = e.stats()
        labels = {"engine": str(e._eid)}
        out = [("gauge", "serving_queue_depth", labels, s["queue_depth"]),
               ("gauge", "serving_slots_in_use", labels,
                s["slots_in_use"]),
               ("gauge", "serving_kv_bytes_in_use", labels,
                s["kv_bytes_in_use"]),
               ("counter", "serving_requests_retired", labels,
                s["requests_retired"]),
               ("counter", "serving_preempts", labels, s["preempts"]),
               ("counter", "serving_nonfinite_cycles", labels,
                s["nonfinite_cycles"])]
        if "kv_blocks_in_use" in s:
            out.append(("gauge", "serving_kv_blocks_in_use", labels,
                        s["kv_blocks_in_use"]))
            out.append(("gauge", "serving_prefix_hit_ratio", labels,
                        s["prefix_hit_ratio"]))
            # the tiered hit split: one {engine, tier} series a tier
            for tier, n in s["tier_hits"].items():
                out.append(("counter", "serving_tier_hit",
                            dict(labels, tier=str(tier)), n))
        ht = s.get("host_tier")
        if ht is not None:
            out.append(("gauge", "serving_host_tier_bytes_in_use",
                        labels, ht["bytes_in_use"]))
            out.append(("counter", "serving_host_tier_demoted", labels,
                        ht["demoted_blocks"]))
            out.append(("counter", "serving_host_tier_promoted", labels,
                        ht["promoted_blocks"]))
        if s.get("decode_tokens_per_sec") is not None:
            out.append(("gauge", "serving_decode_tokens_per_sec",
                        labels, s["decode_tokens_per_sec"]))
        # per-tenant goodput: one {engine, tenant} series a tenant
        for tenant, ts in (s.get("tenants") or {}).items():
            tl = dict(labels, tenant=str(tenant))
            out.append(("counter", "serving_tenant_retired", tl,
                        ts["retired"]))
            out.append(("gauge", "serving_tenant_goodput_rps", tl,
                        ts["goodput_rps"]))
        return out
    _metrics.register_collector(f"serving_engine/{engine._eid}", _collect)


class GenerationEngine:
    """Continuous-batching autoregressive serving over a port GPT model.

    * ``model`` — a ``paddle_tpu_torch.models.GPTForPretraining`` (or
      ``GPTModel``) whose parameters already lie on ``device``;
    * ``device`` — ``None`` means ``"cuda"``, and raises without a card;
      pass ``device="cpu"`` to serve on the CPU (kernels' plain
      versions);
    * ``num_slots`` — concurrent in-flight requests; ``max_len`` —
      per-request capacity (dense: ``bucket + max_new_tokens <=
      max_len``; paged: ``prompt + max_new_tokens <= max_len``);
    * ``kv_layout`` — ``"dense"`` (default) or ``"paged"``;
      ``attention`` — ``"gather"`` (default) or ``"fused"`` (paged
      only);
    * ``min_bucket`` — the smallest prefill capacity bucket (pow2
      buckets above it); a paged pool rounds it up to whole blocks;
    * ``dtype`` — the dense pool's (and a float paged pool's) storage
      dtype, the model's parameter dtype by default;
    * ``block_size``/``num_blocks`` — the paged pool (``num_blocks``
      defaults to ``num_slots`` full-length requests; shrink it and
      admission gates on blocks, growth preempts, full prompt blocks are
      shared through the prefix cache);
    * ``prefill_budget`` — fused: prompt tokens fed per cycle; gather:
      bucket tokens prefilled per cycle while slots decode;
    * ``kv_dtype`` — paged only: ``None`` stores K/V in ``dtype``;
      ``"int8"`` or ``"float8_e4m3fn"`` stores 1-byte codes with a
      float32 max-abs scale per (layer, K/V, block, head), about half the
      bytes of a bf16 pool (the fused path needs ``block_size >= 32``);
    * ``top_k``/``top_p`` — the sampled path's truncation, fixed per
      engine; ``seed`` seeds the engine's ``torch.Generator``.

    * ``spec_draft`` — fused only: speculative decoding with a draft
      model (``"auto"``: :func:`~..models.generation.make_draft_model`,
      the target's first 2 blocks over its shared embeddings; or any
      port GPT of the same vocabulary on ``device``), ``spec_k`` draft
      tokens verified per decoding slot a cycle.
    * ``host_tier_bytes`` — paged only: a host-DRAM tier of that many
      bytes (pinned on the card) behind the prefix cache;
    * ``lane_weights`` — admission weights by lane, over the defaults
      ``{"interactive": 4.0, "batch": 1.0}``.

    ``hbm_budget_bytes`` (ROADMAP Queue 1 item 5) and ``mesh`` (item 4)
    are not ported yet and raise ``NotImplementedError``. Greedy
    output is token-identical to the JAX engine of the same configuration
    on the same weights.
    """

    def __init__(self, model, num_slots: int = 8,
                 max_len: Optional[int] = None, *, top_k: int = 0,
                 top_p: float = 1.0, pad_token_id: int = 0,
                 max_queue: int = 128, prefill_budget: Optional[int] = None,
                 min_bucket: int = 8, seed: int = 0, dtype=None,
                 kv_layout: str = "dense", block_size: int = 16,
                 num_blocks: Optional[int] = None,
                 attention: str = "gather", kv_dtype: Optional[str] = None,
                 spec_draft=None, spec_k: int = 4, mesh=None,
                 mp_axis: str = "mp", hbm_budget_bytes: Optional[int] = None,
                 lane_weights: Optional[dict] = None,
                 host_tier_bytes: Optional[int] = None, device=None):
        # mp_axis only shapes mesh's work, which raises here
        self._device = resolve_device(device)
        if host_tier_bytes is not None:
            if kv_layout != "paged":
                raise ValueError(
                    "host_tier_bytes (hierarchical KV cache) requires "
                    "kv_layout='paged': the host tier stores demoted "
                    "prefix-cache BLOCKS; the dense slot pool has no "
                    "block granularity to demote")
            if mesh is not None:
                raise ValueError(
                    "host_tier_bytes does not compose with mesh= yet: "
                    "run tiered engines single-device (or per "
                    "EngineFleet replica)")
        given = {"hbm_budget_bytes": hbm_budget_bytes, "mesh": mesh}
        for name, value in given.items():
            if value is not None:
                raise NotImplementedError(
                    f"{name}= is not ported yet: ROADMAP.md "
                    f"{_NOT_PORTED[name]}")
        if kv_layout not in ("dense", "paged"):
            raise ValueError(
                f"kv_layout must be 'dense' or 'paged', got {kv_layout!r}")
        if attention not in ("gather", "fused"):
            raise ValueError(
                f"attention must be 'gather' or 'fused', got {attention!r}")
        if kv_dtype is not None and kv_layout != "paged":
            raise ValueError(
                "kv_dtype (quantized KV blocks) requires kv_layout='paged': "
                "the per-block max-abs scales live beside the block pool "
                "(PagedKVPool.scales); the dense slot pool has no block "
                "granularity to scale")
        if kv_dtype is not None and kv_dtype not in PagedKVPool._QUANT_QMAX:
            raise ValueError(
                f"kv_dtype must be None (the parameter dtype) or one of "
                f"{sorted(PagedKVPool._QUANT_QMAX)}, got {kv_dtype!r}")
        if attention == "fused":
            if kv_layout != "paged":
                raise ValueError(
                    "attention='fused' is the fused ragged paged attention "
                    "path: it requires kv_layout='paged' (the dense slot "
                    "pool has no page tables to walk)")
            need = min_kv_block_for(kv_dtype) if kv_dtype is not None \
                else MIN_KV_BLOCK
            if int(block_size) < need:
                raise ValueError(
                    f"attention='fused' requires block_size >= {need} for "
                    f"kv_dtype={kv_dtype or 'float'}: the floor of the JAX "
                    f"engine's kernel, kept so both engines take the same "
                    f"configurations")
        if spec_draft is not None and attention != "fused":
            raise ValueError(
                "spec_draft (speculative decoding) requires "
                "attention='fused': the verify is one fused ragged launch, "
                "each slot's candidate tokens extra ragged rows")
        gpt = model.gpt if hasattr(model, "gpt") else model
        cfg = gpt.cfg
        param = next(model.parameters())
        if param.device.type != self._device.type:
            raise ValueError(
                f"the model's parameters are on {param.device}, the engine "
                f"serves on {self._device}: move the model first "
                f"(model.to({str(self._device)!r}))")
        max_len = int(max_len or cfg.max_position_embeddings)
        if max_len > cfg.max_position_embeddings:
            raise ValueError(
                f"max_len {max_len} exceeds max_position_embeddings="
                f"{cfg.max_position_embeddings}")
        model.eval()                      # serving is inference-only
        self._model = model
        self._gpt = gpt
        self._pad = int(pad_token_id)
        self._top_k, self._top_p = int(top_k), float(top_p)
        self._fused = attention == "fused"
        dtype = param.dtype if dtype is None else dtype
        head_dim = cfg.hidden_size // cfg.num_attention_heads
        if kv_layout == "paged":
            # prefill scatters WHOLE blocks, so capacity buckets are
            # block multiples: the floor rounds up rather than raising
            bs = int(block_size)
            mb = -(-max(int(min_bucket), bs) // bs) * bs
            self._pool = PagedKVPool(
                cfg.num_hidden_layers, num_slots, cfg.num_attention_heads,
                max_len, head_dim, block_size=block_size,
                num_blocks=num_blocks, dtype=kv_dtype or dtype,
                min_bucket=mb, device=self._device)
        else:
            self._pool = KVCachePool(
                cfg.num_hidden_layers, num_slots, cfg.num_attention_heads,
                max_len, head_dim, dtype=dtype, min_bucket=min_bucket,
                device=self._device)
        self._gen = torch.Generator(device=self._device)
        self._gen.manual_seed(int(seed))
        self._prefill_steps = {}          # capacity bucket -> prefill fn
        self._decode_steps = {}           # table bucket (dense: None) -> fn
        self._steps = {}                  # (q bucket, table bucket) -> fn
        self._spec_steps = {}             # (q, table) -> verify step
        self._eid = _next_engine_id()
        # the counted FLOPs of the decode steps run (stats()'s MFU)
        self._decode_flops_dispatched = 0.0
        self._decode_dispatches = 0
        self._host_tier = None
        if host_tier_bytes is not None:
            self._host_tier = HostBlockPool(
                int(host_tier_bytes), self._pool.host_block_nbytes,
                scale_nbytes=self._pool.host_scale_nbytes,
                name=f"serving/host_tier#{self._eid}", device=self._device)
            self._pool.attach_host_tier(self._host_tier)
        self._closed = False
        self._close_lock = threading.Lock()
        self._spec = spec_draft is not None
        self._spec_k = int(spec_k)
        if self._spec:
            if self._spec_k < 1:
                raise ValueError(f"spec_k must be >= 1, got {spec_k}")
            self._init_draft(spec_draft, max_len)
        if self._fused:
            self._sched = Scheduler(
                self._pool, do_admit=self._run_fused_admit,
                do_chunked_step=self._run_fused_step,
                do_spec_step=self._run_spec_step if self._spec else None,
                spec_k=self._spec_k if self._spec else 0,
                do_copy=self._run_copy, max_queue=max_queue,
                prefill_budget=prefill_budget, lane_weights=lane_weights)
        else:
            self._sched = Scheduler(
                self._pool, do_prefill=self._run_prefill,
                do_decode=self._run_decode,
                do_copy=self._run_copy if self._pool.is_paged else None,
                max_queue=max_queue, prefill_budget=prefill_budget,
                lane_weights=lane_weights)
        _register_engine_telemetry(self)

    # -- client side -------------------------------------------------------
    def submit(self, prompt_ids, max_new_tokens: int = 32, *,
               do_sample: bool = False, temperature: float = 1.0,
               top_k: Optional[int] = None, top_p: Optional[float] = None,
               eos_token_id: Optional[int] = None,
               timeout: Optional[float] = None, tenant: str = "default",
               lane: str = "interactive") -> GenerationRequest:
        """Enqueue one generation; returns its handle immediately
        (``handle.stream()``, ``handle.result()``, ``handle.cancel()``).
        ``timeout`` is a hard deadline in seconds. ``top_k``/``top_p``
        are fixed per engine: a differing value raises ``ValueError``. A
        full queue raises ``QueueFullError``; a request that can never
        fit raises ``PoolCapacityError``. ``tenant``/``lane`` tag the
        request's weighted-fair admission class (the front door sets them
        from the wire); untagged traffic shares one class, served FCFS."""
        if self._closed:
            raise RuntimeError("GenerationEngine is closed")
        if top_k is not None and int(top_k) != self._top_k:
            raise ValueError(
                f"per-request top_k={top_k} differs from the engine's "
                f"top_k={self._top_k}: build a GenerationEngine("
                f"top_k={top_k}) instead")
        if top_p is not None and float(top_p) != self._top_p:
            raise ValueError(
                f"per-request top_p={top_p} differs from the engine's "
                f"top_p={self._top_p}: build a GenerationEngine("
                f"top_p={top_p}) instead")
        ids = np.asarray(prompt_ids, np.int32).reshape(-1)
        if ids.size < 1:
            raise ValueError("prompt_ids must contain at least one token")
        if max_new_tokens < 1:
            raise ValueError(
                f"max_new_tokens must be >= 1, got {max_new_tokens}")
        pool, n = self._pool, int(max_new_tokens)
        if self._pool.is_paged:
            # paged sequences start at virtual index 0: only the true
            # footprint counts
            if ids.size + n > pool.max_len:
                raise PoolCapacityError(
                    f"prompt {ids.size} + max_new_tokens {n} exceeds the "
                    f"pool's virtual capacity {pool.max_len}")
            # the worst re-admission after a preemption prefills prompt
            # + up to max_new - 1 generated tokens, and that feed's
            # bucket must exist (the fused engine has no buckets)
            worst = ids.size + n - 1
            if not self._fused and pool.bucket_for(worst) > pool.max_len:
                raise PoolCapacityError(
                    f"no prefill bucket fits this request: prompt "
                    f"{ids.size} (+ up to {n - 1} replayed tokens after a "
                    f"preemption) needs bucket {pool.bucket_for(worst)} > "
                    f"max_len {pool.max_len}; shorten the request or build "
                    f"the engine with a larger max_len / smaller "
                    f"min_bucket")
        else:
            bucket = pool.bucket_for(ids.size)
            if bucket + n > pool.max_len:
                raise PoolCapacityError(
                    f"prompt bucket {bucket} + max_new_tokens {n} exceeds "
                    f"the pool capacity {pool.max_len}; shorten the "
                    f"request or build the engine with a larger max_len")
        req = GenerationRequest(
            ids, max_new_tokens, do_sample=do_sample,
            temperature=temperature, eos_token_id=eos_token_id,
            pad_token_id=self._pad, timeout=timeout, tenant=tenant,
            lane=lane)
        handle = self._sched.submit(req)    # QueueFullError propagates
        stat_add("serving/requests")        # counts accepted requests
        return handle

    def stream(self, prompt_ids, **kwargs) -> Iterator[int]:
        """``submit(...).stream()`` in one call."""
        return self.submit(prompt_ids, **kwargs).stream()

    def close(self, cancel_pending: bool = False) -> None:
        """Stop accepting work, DRAIN everything queued and in flight
        (or cancel the queue with ``cancel_pending``), then stop the
        scheduler thread."""
        with self._close_lock:
            if self._closed:
                return
            self._closed = True
        self._sched.close(cancel_pending=cancel_pending)
        # the tier after the scheduler: nothing dispatches to it any
        # more, so its close only drains queued copies and joins threads
        if self._host_tier is not None:
            self._host_tier.close()
        self._pool.drop_ledger()
        # a closed engine is no longer a scraped source or statusz row
        _metrics.unregister_collector(f"serving_engine/{self._eid}")
        _LIVE_ENGINES.discard(self)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    # -- introspection -----------------------------------------------------
    @property
    def flight_recorder(self):
        """This engine's always-on :class:`~.flight_recorder.
        FlightRecorder`."""
        return self._sched.recorder

    def dump_flight_recorder(self, path: Optional[str] = None) -> dict:
        """The flight recorder's snapshot (the last cycle records and
        request events, latency percentiles, tail traces) plus this
        engine's :meth:`stats`; written to ``path`` as JSON when given.
        A failed cycle dumps it by itself (the path in
        ``flight_recorder.last_dump_path``)."""
        return self._sched.recorder.dump(path, extra={"engine":
                                                      self.stats()})

    def stats(self) -> dict:
        """Operator snapshot (host bookkeeping only, no device sync):
        queue, slots, steps, the paged pool's blocks, prefix cache and
        hit split by tier (``hbm``/``host``/``miss``), the host tier,
        chunked prefill, the speculative figures, TTFT/TPOT percentiles
        over this engine's retired requests (from its flight recorder),
        goodput and SLO violations once a tail SLO is armed, and the
        per-tenant split."""
        pool, sched = self._pool, self._sched
        s = {
            "kv_layout": "paged" if self._pool.is_paged else "dense",
            "attention": "fused" if self._fused else "gather",
            "kv_dtype": pool.dtype_name,
            "device": str(self._device),
            "queue_depth": sched.queue_depth,
            "active_requests": sched.active,
            "num_slots": pool.num_slots,
            "slots_in_use": pool.n_active,
            "slot_utilization": pool.n_active / pool.num_slots,
            "preempts": sched.preempts,
            "requests_retired": sched.recorder.retired,
            "nonfinite_cycles": sched.nonfinite_cycles,
            "steps": sched.steps,
            "kv_pool_capacity_bytes": pool.capacity_bytes,
            "kv_bytes_in_use": pool.bytes_in_use,
        }
        rec = sched.recorder
        if rec.tail_slo_ms is not None:
            s["goodput_rps"] = rec.goodput()["goodput_rps"]
            s["slo_violations"] = rec.slo_violations
        tenants = rec.tenant_summary()
        if tenants:
            s["tenants"] = tenants
        if self._pool.is_paged:
            hits, misses = pool.prefix_hits, pool.prefix_misses
            th = pool.tier_hits
            denom = max(1, th["hbm"] + th["host"] + th["miss"])
            s.update({
                # block storage vs the scale array (0 for float pools)
                "kv_bytes": {"blocks": pool.block_storage_bytes,
                             "scales": pool.scales_bytes},
                "block_size": pool.block_size,
                "num_blocks": pool.num_blocks,
                "kv_blocks_in_use": pool.blocks_in_use,
                "block_utilization": pool.blocks_in_use / pool.num_blocks,
                "cached_blocks": pool.cached_blocks,
                "prefix_hits": hits,
                "prefix_misses": misses,
                "prefix_hit_ratio": hits / max(1, hits + misses),
                "tier_hits": dict(th),
                "prefix_hit_hbm": th["hbm"] / denom,
                "prefix_hit_host": th["host"] / denom,
                "prefix_miss": th["miss"] / denom,
                "prefill_tokens_saved": pool.tokens_saved,
                "prefix_evictions": pool.evictions,
            })
            if self._host_tier is not None:
                s["host_tier"] = self._host_tier.stats()
        s.update(sched.recorder.latency_summary())
        s.update(self._compute_stats())
        if self._fused:
            s["prefill_chunks"] = sched.prefill_chunks
            s["chunked_prefill_tokens"] = sched.chunk_tokens
            thr = sched.recorder.cycle_throughput()
            if thr["cycle_secs"] > 0 and thr["chunk_tokens"] > 0:
                s["chunked_prefill_tokens_per_sec"] = \
                    thr["chunk_tokens"] / thr["cycle_secs"]
        else:
            s["prefills"] = sched.prefills
        if self._spec:
            # how often the draft agrees, and how many tokens a decoding
            # slot nets a cycle (1.0 = plain decode)
            s["spec_k"] = self._spec_k
            s["spec_cycles"] = sched.spec_cycles
            s["spec_proposed"] = sched.spec_proposed
            s["spec_accepted"] = sched.spec_accepted
            s["spec_accept_rate"] = sched.spec_accepted \
                / max(1, sched.spec_proposed)
            if thr["spec_slots"] > 0:
                s["spec_tokens_per_cycle"] = \
                    thr["spec_emitted"] / thr["spec_slots"]
            s["draft_layers"] = self._draft_gpt.cfg.num_hidden_layers
            s["kv_bytes"]["draft"] = self._draft_pool.numel() \
                * self._draft_pool.element_size()
        return s

    def _compute_stats(self) -> dict:
        """Model-FLOPs-per-token and serving MFU from the counted cost
        of the decode steps run (fused steps and verifies, or gather
        decode steps). One step advances EVERY slot, so flops-per-token
        = step FLOPs / num_slots (the full batch's cost: a partly
        occupied batch still pays it). Throughput comes from THIS
        engine's flight-recorder cycle ring; MFU needs a known peak
        (``program_registry.peak_flops``, env-overridable) — absent one
        (the CPU), raw FLOP/s are reported."""
        if not self._decode_dispatches:
            return {}
        mean_step_flops = \
            self._decode_flops_dispatched / self._decode_dispatches
        if not mean_step_flops:
            return {}
        out = {}
        S = self._pool.num_slots
        out["model_flops_per_token"] = mean_step_flops / S
        steps = self._steps or self._spec_steps or self._decode_steps
        if steps:
            # the largest bucket's bytes scaled by the mean-cost ratio,
            # so bytes-per-token tracks what ran, like the FLOPs
            step = steps[max(steps, key=lambda k: (k is not None, k))]
            nbytes, flops = getattr(step, "bytes_accessed", None), \
                getattr(step, "flops", None)
            if nbytes and flops:
                out["decode_bytes_per_token"] = \
                    nbytes * (mean_step_flops / flops) / S
        thr = self._sched.recorder.cycle_throughput()
        if thr["cycle_secs"] > 0 and thr["decode_cycles"] > 0:
            out["decode_tokens_per_sec"] = \
                thr["emitted"] / thr["cycle_secs"]
            flops_in_ring = thr["decode_flops"] or \
                mean_step_flops * thr["decode_cycles"]
            achieved = flops_in_ring / thr["cycle_secs"]
            out["serving_flops_per_sec"] = achieved
            peak = _registry.peak_flops()
            if peak:
                out["serving_mfu"] = achieved / peak
        return out

    def _note_decode_dispatch(self, step) -> None:
        """Account the counted FLOPs of the decode step run this cycle
        (host arithmetic only): lifetime counters for the mean, and the
        live cycle record, so the cycle ring's FLOP/s keeps its own
        window."""
        self._decode_dispatches += 1
        flops = getattr(step, "flops", None)
        if flops:
            self._decode_flops_dispatched += flops
            self._sched.note_decode_flops(flops)

    def _site(self, kind: str) -> str:
        return f"serving/{kind}#{self._eid}"

    def _costed(self, fn, site: str, rows: int, key_reads: int,
                head_rows: int, kv_rows_read: int, kv_rows_written: int):
        """Attach a built step's counted cost (``gpt_step_cost`` of the
        model's configuration at the bucket's shapes) to the step and to
        its program-registry site."""
        gpt = self._gpt
        param = next(gpt.parameters())
        kv_bytes = 1 if getattr(self._pool, "quantized", False) \
            else param.element_size()
        cost = _registry.gpt_step_cost(
            gpt.cfg, rows, key_reads, head_rows,
            param_bytes=param.element_size(), kv_bytes=kv_bytes,
            kv_rows_read=kv_rows_read, kv_rows_written=kv_rows_written)
        fn.site = site
        fn.flops = cost["flops"]
        fn.bytes_accessed = cost["bytes_accessed"]
        fn.record = _registry.note_cost(site, **cost)
        return fn

    # -- scheduler callbacks (scheduler thread) ----------------------------
    def _put(self, *arrays):
        """Host numpy operands to the device in ONE copy."""
        sizes = [a.size for a in arrays]
        flat = torch.from_numpy(np.concatenate(
            [a.reshape(-1).astype(np.int32) for a in arrays]))
        parts = flat.to(self._device).split(sizes)
        return [p.view(a.shape) for p, a in zip(parts, arrays)]

    def _prefill_fn(self, bucket: int):
        fn = self._prefill_steps.get(bucket)
        if fn is None:
            pool = self._pool
            site = self._site(f"prefill[{bucket}]")
            probe = _probe.site(site)
            if self._pool.is_paged:
                fn = build_paged_prefill_fn(
                    self._model, bucket, pool.block_size, top_k=self._top_k,
                    top_p=self._top_p, probe=probe,
                    quantized=pool.quantized, qmax=pool.qmax or 127.0)
            else:
                fn = build_slot_prefill_fn(
                    self._model, bucket, pool.max_len, top_k=self._top_k,
                    top_p=self._top_p, probe=probe)
            self._prefill_steps[bucket] = self._costed(
                fn, site, bucket, bucket * bucket, 1, bucket, bucket)
        return fn

    def _decode_fn(self, table_len: Optional[int]):
        """The paged decode step of a table bucket, or the dense one
        (``table_len`` None)."""
        fn = self._decode_steps.get(table_len)
        if fn is None:
            pool = self._pool
            S = pool.num_slots
            if self._pool.is_paged:
                site = self._site(f"decode[t{table_len}]")
                fn = build_paged_decode_fn(
                    self._model, S, table_len, pool.block_size,
                    top_k=self._top_k, top_p=self._top_p,
                    probe=_probe.site(site), quantized=pool.quantized,
                    qmax=pool.qmax or 127.0)
                keys = table_len * pool.block_size
            else:
                site = self._site("decode")
                fn = build_slot_decode_fn(
                    self._model, S, pool.max_len, top_k=self._top_k,
                    top_p=self._top_p, probe=_probe.site(site))
                keys = pool.max_len
            self._decode_steps[table_len] = self._costed(
                fn, site, S, S * keys, S, S * keys, S)
        return fn

    def _run_prefill(self, req: GenerationRequest, slot: int,
                     bucket: int) -> Optional[int]:
        """Prefill ``req`` into ``slot`` and return its first token (the
        dense pool: the prompt LEFT-padded into its bucket)."""
        if self._pool.is_paged:
            return self._run_paged_prefill(req, slot, bucket)
        n = req.prompt.size
        ids = np.full((1, bucket), self._pad, np.int32)
        ids[0, bucket - n:] = req.prompt
        key_valid = np.zeros((1, bucket), np.int32)
        key_valid[0, bucket - n:] = 1
        ids_d, kv_d = self._put(ids, key_valid)
        first = self._prefill_fn(bucket)(
            self._pool.data, ids_d.long(), kv_d.bool(), slot,
            req.do_sample, req.temperature, self._gen)
        return int(_fetch(first)[0])

    def _run_paged_prefill(self, req: GenerationRequest, slot: int,
                           bucket: int) -> Optional[int]:
        """Admit ``req`` into the paged pool. A prefix-cache hit adopts
        the matched blocks and runs no prefill: the uncovered tail (and,
        after a preemption, the request's own history) replays through
        the decode step one token a cycle, predictions dropped until it
        drains. Replay costs a cycle a token, so the hit is taken only
        when the tail fits one ``min_bucket``; a longer tail prefills the
        whole feed fresh. A miss prefills the feed RIGHT-padded into
        freshly allocated blocks and publishes its full blocks to the
        prefix cache."""
        pool = self._pool
        feed = np.concatenate(
            [req.prompt, np.asarray(req.tokens, np.int32)])
        cached = pool.match_prefix(feed)
        if cached and feed.size - len(cached) * pool.block_size \
                > pool.min_bucket:
            cached = []                   # tail too long: prefill wins
        if cached:
            pool.admit_cached(slot, cached)
            # a hit through a just-landed promotion is a host-tier hit
            pool.note_tier_hit("host" if req._tier_promoted else "hbm")
            m = len(cached) * pool.block_size
            pool.set_slot(slot, pos=m, lo=0)
            req.last_token = int(feed[m])
            req.replay = [int(t) for t in feed[m + 1:]]
            req.trace.mark("prefix_hit", tokens_saved=m,
                           replay=len(req.replay))
            return None
        pool.note_tier_hit("miss")
        blocks = pool.admit_fresh(slot, feed.size)
        table = np.zeros(bucket // pool.block_size, np.int32)
        table[:len(blocks)] = blocks      # padding -> the scratch block
        ids = np.zeros((1, bucket), np.int32)
        ids[0, :feed.size] = feed         # RIGHT-padded: virtual index 0
        key_valid = np.zeros((1, bucket), np.int32)
        key_valid[0, :feed.size] = 1
        ids_d, kv_d, table_d = self._put(ids, key_valid, table)
        scales = (pool.scales,) if pool.quantized else ()
        first = self._prefill_fn(bucket)(
            pool.data, *scales, ids_d.long(), kv_d.bool(), table_d,
            feed.size, req.do_sample, req.temperature, self._gen)
        pool.set_slot(slot, pos=feed.size, lo=0)
        pool.register_prefix(slot, feed)
        req.replay = []
        return int(_fetch(first)[0])

    def _run_decode(self, slot_requests):
        """Run ONE decode step over every slot; returns the next-token
        tensor (``[num_slots + 1]``, on the device) un-fetched."""
        pool = self._pool
        S = pool.num_slots
        tokens = np.zeros(S, np.int32)
        sample_mask = np.zeros(S, np.int32)
        temps = torch.ones(S, dtype=torch.float32)
        for slot, req in slot_requests.items():
            tokens[slot] = req.last_token
            sample_mask[slot] = req.do_sample
            temps[slot] = req.temperature
        pos, lo = pool.position_arrays()
        temps = temps.to(self._device)
        if self._pool.is_paged:
            # the cohort decodes at its largest member's pow2 table
            # bucket; shorter tables pad with the scratch block
            T = max(pool.table_bucket(s) for s in slot_requests)
            tables = pool.table_array(T, slot_requests)
            tok_d, pos_d, lo_d, tab_d, samp_d = self._put(
                tokens, pos, lo, tables, sample_mask)
            scales = (pool.scales,) if pool.quantized else ()
            step = self._decode_fn(T)
            self._note_decode_dispatch(step)
            return step(pool.data, *scales, tok_d, pos_d, lo_d, tab_d,
                        samp_d.bool(), temps, self._gen)
        tok_d, pos_d, lo_d, samp_d = self._put(tokens, pos, lo, sample_mask)
        step = self._decode_fn(None)
        self._note_decode_dispatch(step)
        return step(pool.data, tok_d, pos_d, lo_d, samp_d.bool(), temps,
                    self._gen)

    def _run_fused_admit(self, req: GenerationRequest, slot: int) -> None:
        """Admit one request: host bookkeeping only. Blocks covering the
        whole feed are reserved, a prefix-cache match adopts its blocks
        (any tail length: chunks drain it), and the remaining tokens arm
        ``req.pending_feed``."""
        pool = self._pool
        if self._spec:
            # the slot's previous occupant's draft cache is stale: the
            # next speculative cycle re-syncs it with a draft prefill
            self._draft_synced[slot] = False
        feed = np.concatenate(
            [req.prompt, np.asarray(req.tokens, np.int32)])
        cached = pool.match_prefix(feed)
        if cached:
            pool.admit_cached(slot, cached)
            pool.note_tier_hit("host" if req._tier_promoted else "hbm")
            m = len(cached) * pool.block_size
            pool.set_slot(slot, pos=m, lo=0)
            req.pending_feed = [int(t) for t in feed[m:]]
            req.trace.mark("prefix_hit", tokens_saved=m,
                           pending=len(req.pending_feed))
        else:
            pool.note_tier_hit("miss")
            pool.admit_fresh(slot, feed.size)
            pool.set_slot(slot, pos=0, lo=0)
            req.pending_feed = [int(t) for t in feed]

    def _ragged_operands(self, slot_requests, plan, spec=None):
        """Host-side flattened ragged-row operands of one launch (numpy):
        per-slot contiguous padded rows, page-table-resolved write
        targets and the kernel's metadata, shared by the fused step and
        the speculative verify. Speculating slots (``spec``) contribute
        their candidate rows with only ``last_token`` known here: the
        draft tokens are overlaid on the device by the verify step.
        Returns ``(Q, T, ops, n_spec, sample_mask, temps)``."""
        pool = self._pool
        S = pool.num_slots
        bs = pool.block_size
        q_lens = [0] * S
        pos0s = [0] * S
        row_tokens = {}
        kv_len = np.zeros(S, np.int32)
        sample_mask = np.zeros(S, bool)
        temps = np.ones(S, np.float32)
        n_spec = np.zeros(S, np.int32)
        for slot, req in slot_requests.items():
            n = int(plan.get(slot, 0))
            if n < 1:
                continue
            p = pool.slot_pos(slot)
            q_lens[slot] = n
            pos0s[slot] = p
            kv_len[slot] = p + n
            sample_mask[slot] = req.do_sample
            temps[slot] = req.temperature
            if spec and slot in spec:
                n_spec[slot] = n
                row_tokens[slot] = [req.last_token]
            else:
                row_tokens[slot] = (req.pending_feed[:n]
                                    if req.pending_feed
                                    else [req.last_token])
        padded = sum(-(-n // BLOCK_Q) * BLOCK_Q for n in q_lens if n)
        Q = self._q_bucket(padded)
        blk_seq, qstart, pos0, last_row, _ = ragged_layout(
            q_lens, pos0s, q_bucket=Q)
        token_ids = np.zeros(Q, np.int32)
        qpos = np.zeros(Q, np.int32)
        write_block = np.zeros(Q, np.int32)   # pad rows -> scratch block
        write_off = np.zeros(Q, np.int32)
        for slot, toks in row_tokens.items():
            r0, p0 = int(qstart[slot]), int(pos0[slot])
            table = pool.slot_table(slot)
            for i in range(q_lens[slot]):
                if i < len(toks):
                    token_ids[r0 + i] = toks[i]
                qpos[r0 + i] = p0 + i
                write_block[r0 + i] = table[(p0 + i) // bs]
                write_off[r0 + i] = (p0 + i) % bs
        T = max(pool.table_bucket(s) for s in row_tokens)
        tables = pool.table_array(T, row_tokens)
        lo = np.zeros(S, np.int32)            # paged virtual floor
        return (Q, T, (token_ids, qpos, write_block, write_off, blk_seq,
                       qstart, pos0, tables, lo, kv_len, last_row),
                n_spec, sample_mask, temps)

    def _run_fused_step(self, slot_requests, plan):
        """Run ONE fused ragged launch; returns the next-token tensor
        (``[num_slots + 1]``, on the device) un-fetched."""
        Q, T, ops, _, sample_mask, temps = self._ragged_operands(
            slot_requests, plan)
        dev_ops = self._put(*ops)
        pool = self._pool
        step = self._steps.get((Q, T))
        if step is None:
            S, keys = pool.num_slots, T * pool.block_size
            site = self._site(f"fused[q{Q},t{T}]")
            step = self._steps[(Q, T)] = self._costed(build_fused_step_fn(
                self._model, S, Q, T, pool.block_size, top_k=self._top_k,
                top_p=self._top_p, probe=_probe.site(site),
                quantized=pool.quantized, qmax=pool.qmax),
                site, Q, Q * keys, S, S * keys, Q)
        self._note_decode_dispatch(step)
        scales = (pool.scales,) if pool.quantized else ()
        return step(pool.data, *scales, *dev_ops,
                    torch.from_numpy(sample_mask).to(self._device),
                    torch.from_numpy(temps).to(self._device), self._gen)

    def _q_bucket(self, rows: int) -> int:
        """pow2 bucket over the launch's padded q rows."""
        b = BLOCK_Q
        while b < rows:
            b *= 2
        return b

    def _run_copy(self, dst: int, src: int) -> None:
        """Copy-on-write: copy block ``src`` over block ``dst`` across
        every layer/kv plane, in place on the device; a quantized pool's
        scales go with the codes, so the copy reads back the same."""
        pool = self._pool
        with torch.inference_mode():
            pool.data[:, :, dst] = pool.data[:, :, src]
            if pool.quantized:
                pool.scales[:, :, dst] = pool.scales[:, :, src]

    # -- speculative decoding: draft proposals, fused verify ---------------
    def _init_draft(self, spec_draft, max_len) -> None:
        """The draft side of speculative decoding: resolve the draft
        model (``"auto"`` builds :func:`make_draft_model`'s 2-layer GPT
        over the target's embeddings) and allocate its DENSE slot pool
        ``[draft layers, 2, slots, draft heads, max_len, draft head
        dim]`` in its parameters' dtype. Draft positions mirror the
        target pool's ``slot_pos`` (both write a row's K/V when the row
        is fed), so the only per-slot draft state is a synced flag."""
        if isinstance(spec_draft, str):
            if spec_draft != "auto":
                raise ValueError(
                    f"spec_draft must be 'auto' or a GPT model, got "
                    f"{spec_draft!r}")
            spec_draft = make_draft_model(self._model)
        dgpt = spec_draft.gpt if hasattr(spec_draft, "gpt") else spec_draft
        if dgpt.cfg.vocab_size != self._gpt.cfg.vocab_size:
            raise ValueError(
                f"draft vocab {dgpt.cfg.vocab_size} != target vocab "
                f"{self._gpt.cfg.vocab_size}: rejection sampling "
                f"compares distributions over the SAME vocabulary")
        if max_len > dgpt.cfg.max_position_embeddings:
            raise ValueError(
                f"max_len {max_len} exceeds the draft's "
                f"max_position_embeddings="
                f"{dgpt.cfg.max_position_embeddings}")
        dparam = next(spec_draft.parameters())
        if dparam.device.type != self._device.type:
            raise ValueError(
                f"the draft's parameters are on {dparam.device}, the "
                f"engine serves on {self._device}: move the draft first")
        spec_draft.eval()
        self._draft_model = spec_draft
        self._draft_gpt = dgpt
        dcfg = dgpt.cfg
        self._draft_max_len = int(max_len)
        self._draft_shape = (dcfg.num_hidden_layers, 2,
                             self._pool.num_slots,
                             dcfg.num_attention_heads, self._draft_max_len,
                             dcfg.hidden_size // dcfg.num_attention_heads)
        self._draft_dtype = dparam.dtype
        self._draft_pool = torch.zeros(self._draft_shape,
                                       dtype=self._draft_dtype,
                                       device=self._device)
        self._draft_synced = np.zeros(self._pool.num_slots, bool)
        self._draft_prefill_steps = {}    # bucket -> draft prefill
        self._draft_scan_steps = {}       # kmax -> proposal chain

    def _reset_draft(self) -> None:
        """After a failed cycle: a zero draft pool and no slot synced."""
        self._draft_pool.zero_()
        self._draft_synced[:] = False

    def _draft_bucket(self, n: int) -> int:
        """pow2 context bucket of a draft prefill, capped at the draft
        pool's max_len (a slot's context is always below it)."""
        b = 8
        while b < n:
            b *= 2
        return min(b, self._draft_max_len)

    def _draft_prefill_fn(self, bucket: int):
        fn = self._draft_prefill_steps.get(bucket)
        if fn is None:
            site = self._site(f"spec_prefill[{bucket}]")
            fn = self._draft_prefill_steps[bucket] = build_draft_prefill_fn(
                self._draft_model, bucket, self._draft_max_len,
                probe=_probe.site(site))
        return fn

    def _draft_scan_fn(self, kmax: int):
        """The whole proposal chain of ``kmax`` draft steps as ONE call
        (:func:`build_draft_propose_scan_fn`); one per distinct
        ``kmax``."""
        fn = self._draft_scan_steps.get(kmax)
        if fn is None:
            site = self._site(f"spec_draft[k{kmax}]")
            fn = self._draft_scan_steps[kmax] = build_draft_propose_scan_fn(
                self._draft_model, self._pool.num_slots,
                self._draft_max_len, kmax, top_k=self._top_k,
                top_p=self._top_p, probe=_probe.site(site))
        return fn

    def _spec_step_fn(self, q_rows: int, table_len: int):
        key = (q_rows, table_len)
        fn = self._spec_steps.get(key)
        if fn is None:
            pool = self._pool
            S, keys = pool.num_slots, table_len * pool.block_size
            site = self._site(f"spec[q{q_rows},t{table_len}]")
            fn = self._spec_steps[key] = self._costed(build_spec_verify_fn(
                self._model, S, q_rows, self._spec_k, table_len,
                pool.block_size, top_k=self._top_k, top_p=self._top_p,
                probe=_probe.site(site), quantized=pool.quantized,
                qmax=pool.qmax or 127.0), site, q_rows, q_rows * keys,
                S * self._spec_k + S, S * keys, q_rows)
        return fn

    def _sync_draft(self, slot: int, req: GenerationRequest) -> None:
        """Bring the draft's cache of ``slot`` up to the target's context
        ``[0, pos)``: one right-padded draft prefill of ``prompt +
        generated`` less the last (not yet written) token. Runs when a
        slot starts, or resumes after a preemption or reuse, speculative
        decoding."""
        feed = np.concatenate(
            [req.prompt, np.asarray(req.tokens, np.int32)])
        ctx = feed[:-1]
        if ctx.size:
            b = self._draft_bucket(ctx.size)
            ids = np.zeros((1, b), np.int32)
            ids[0, :ctx.size] = ctx
            key_valid = np.zeros((1, b), np.int32)
            key_valid[0, :ctx.size] = 1
            ids_d, kv_d = self._put(ids, key_valid)
            self._draft_prefill_fn(b)(self._draft_pool, ids_d.long(),
                                      kv_d.bool(), slot)
        self._draft_synced[slot] = True

    def _run_spec_step(self, slot_requests, plan, spec):
        """ONE speculative cycle, with no device-to-host copy: (1)
        unsynced slots' draft caches catch up by a draft prefill; (2)
        ONE call proposes ``max(spec.values())`` tokens a slot, each step
        feeding the previous step's proposal on the device; (3) ONE fused
        verify launch scores every candidate row beside the cycle's
        prefill-chunk rows and runs the rejection sampling. Returns
        ``[accepted | corrected | draft echo | sentinel]`` un-fetched."""
        try:
            return self._run_spec_inner(slot_requests, plan, spec)
        except Exception:
            # the draft pool is written in place: a failure may have
            # left it half-written, as the target's
            self._reset_draft()
            raise

    def _run_spec_inner(self, slot_requests, plan, spec):
        pool = self._pool
        S, K = pool.num_slots, self._spec_k
        for slot in spec:
            if not self._draft_synced[slot]:
                self._sync_draft(slot, slot_requests[slot])
        feed0 = np.zeros(S, np.int32)
        pos_d = np.zeros(S, np.int32)
        for slot in spec:
            feed0[slot] = slot_requests[slot].last_token
            pos_d[slot] = pool.slot_pos(slot)
        Q, T, ops, n_spec, sample_mask, temps = self._ragged_operands(
            slot_requests, plan, spec=spec)
        # every host operand of the cycle in one copy, the float
        # temperatures as their bits
        dev = self._put(feed0, pos_d, n_spec, sample_mask.astype(np.int32),
                        temps.view(np.int32), *ops)
        feed_d, pos_dd, n_spec_d, samp_d, temps_d = dev[:5]
        samp_d, temps_d = samp_d.bool(), temps_d.view(torch.float32)
        dev_ops = dev[5:]
        lo_d = dev_ops[8]                 # the paged floor: all zeros
        # only as many draft steps as the cycle's largest candidate
        # count; the verify takes [S, K], zero-padded past kmax
        kmax = max(spec.values())
        d_dev, q_dev = self._draft_scan_fn(kmax)(
            self._draft_pool, feed_d, pos_dd, lo_d, samp_d, temps_d,
            self._gen)
        self._sched.note_spec_dispatches(1)
        if kmax < K:
            d_dev = torch.nn.functional.pad(d_dev, (0, K - kmax))
            q_dev = torch.nn.functional.pad(q_dev, (0, 0, 0, K - kmax))
        scales = (pool.scales,) if pool.quantized else ()
        step = self._spec_step_fn(Q, T)
        self._note_decode_dispatch(step)
        return step(pool.data, *scales, *dev_ops, n_spec_d, d_dev, q_dev,
                    samp_d, temps_d, self._gen)
