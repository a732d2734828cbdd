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
  kernel walks each sequence's page table in the block pool.

The JAX package caches one jitted program per bucket; here each bucket
(capacity bucket, table bucket, or q-row and table bucket) keeps one
built step function in the same dicts, and nothing is compiled: the
steps run eagerly and write the pool in place.
"""
from __future__ import annotations

import threading
from typing import Iterator, Optional

import numpy as np
import torch

from .._device import resolve_device
from ..models.generation import (build_fused_step_fn, build_paged_decode_fn,
                                 build_paged_prefill_fn,
                                 build_slot_decode_fn, build_slot_prefill_fn)
from ..ops.ragged_paged_attention import (BLOCK_Q, MIN_KV_BLOCK,
                                          min_kv_block_for, ragged_layout)
from .kv_pool import KVCachePool
from .paging import PagedKVPool, PoolCapacityError
from .scheduler import GenerationRequest, Scheduler, _fetch

__all__ = ["GenerationEngine"]

# the JAX engine's arguments for parts of the system the port has not
# taken yet, each with the ROADMAP.md queue that holds it
_NOT_PORTED = {
    "spec_draft": "Queue 1 item 2 (speculative decoding)",
    "host_tier_bytes": "Queue 1 item 2 (serving/host_tier.py)",
    "lane_weights": "Queue 1 item 2 (weighted admission over lanes)",
    "hbm_budget_bytes": "Queue 1 item 3 (the static HBM plan)",
    "mesh": "Queue 1 item 4 (tensor-parallel serving)",
}


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

    ``spec_draft``, ``host_tier_bytes``, ``hbm_budget_bytes`` and
    ``mesh`` are not ported yet and raise ``NotImplementedError``. Greedy
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
        # spec_k and mp_axis only shape spec_draft's and mesh's work,
        # which raise here
        self._device = resolve_device(device)
        given = {"spec_draft": spec_draft, "host_tier_bytes": host_tier_bytes,
                 "hbm_budget_bytes": hbm_budget_bytes, "mesh": mesh,
                 "lane_weights": lane_weights}
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
        self._closed = False
        self._close_lock = threading.Lock()
        if self._fused:
            self._sched = Scheduler(
                self._pool, do_admit=self._run_fused_admit,
                do_chunked_step=self._run_fused_step,
                do_copy=self._run_copy, max_queue=max_queue,
                prefill_budget=prefill_budget)
        else:
            self._sched = Scheduler(
                self._pool, do_prefill=self._run_prefill,
                do_decode=self._run_decode,
                do_copy=self._run_copy if self._pool.is_paged else None,
                max_queue=max_queue, prefill_budget=prefill_budget)

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
        fit raises ``PoolCapacityError``. The port admits in arrival
        order: another ``tenant`` or ``lane`` than the defaults raises
        ``NotImplementedError`` (ROADMAP Queue 1 item 2)."""
        if self._closed:
            raise RuntimeError("GenerationEngine is closed")
        if tenant != "default" or lane != "interactive":
            raise NotImplementedError(
                "tenants and lanes (weighted admission) are not ported "
                "yet: ROADMAP.md Queue 1 item 2")
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
            pad_token_id=self._pad, timeout=timeout)
        return self._sched.submit(req)

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

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    # -- introspection -----------------------------------------------------
    def stats(self) -> dict:
        """Operator snapshot (host bookkeeping only, no device sync):
        queue, slots, steps, the paged pool's blocks and prefix cache,
        chunked prefill, and TTFT/TPOT percentiles over this engine's
        retired requests."""
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
            "requests_retired": sched.retired,
            "nonfinite_cycles": sched.nonfinite_cycles,
            "steps": sched.steps,
            "kv_pool_capacity_bytes": pool.capacity_bytes,
            "kv_bytes_in_use": pool.bytes_in_use,
        }
        if self._pool.is_paged:
            hits, misses = pool.prefix_hits, pool.prefix_misses
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
                "prefill_tokens_saved": pool.tokens_saved,
                "prefix_evictions": pool.evictions,
            })
        if self._fused:
            s["prefill_chunks"] = sched.prefill_chunks
            s["chunked_prefill_tokens"] = sched.chunk_tokens
        else:
            s["prefills"] = sched.prefills
        s.update(sched.latency_summary())
        return s

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
            if self._pool.is_paged:
                fn = build_paged_prefill_fn(
                    self._model, bucket, pool.block_size, top_k=self._top_k,
                    top_p=self._top_p, quantized=pool.quantized,
                    qmax=pool.qmax or 127.0)
            else:
                fn = build_slot_prefill_fn(
                    self._model, bucket, pool.max_len, top_k=self._top_k,
                    top_p=self._top_p)
            self._prefill_steps[bucket] = fn
        return fn

    def _decode_fn(self, table_len: Optional[int]):
        """The paged decode step of a table bucket, or the dense one
        (``table_len`` None)."""
        fn = self._decode_steps.get(table_len)
        if fn is None:
            pool = self._pool
            if self._pool.is_paged:
                fn = build_paged_decode_fn(
                    self._model, pool.num_slots, table_len, pool.block_size,
                    top_k=self._top_k, top_p=self._top_p,
                    quantized=pool.quantized, qmax=pool.qmax or 127.0)
            else:
                fn = build_slot_decode_fn(
                    self._model, pool.num_slots, pool.max_len,
                    top_k=self._top_k, top_p=self._top_p)
            self._decode_steps[table_len] = fn
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
            m = len(cached) * pool.block_size
            pool.set_slot(slot, pos=m, lo=0)
            req.last_token = int(feed[m])
            req.replay = [int(t) for t in feed[m + 1:]]
            req.trace.mark("prefix_hit", tokens_saved=m,
                           replay=len(req.replay))
            return None
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
            return self._decode_fn(T)(
                pool.data, *scales, tok_d, pos_d, lo_d, tab_d,
                samp_d.bool(), temps, self._gen)
        tok_d, pos_d, lo_d, samp_d = self._put(tokens, pos, lo, sample_mask)
        return self._decode_fn(None)(pool.data, tok_d, pos_d, lo_d,
                                  samp_d.bool(), temps, self._gen)

    def _run_fused_admit(self, req: GenerationRequest, slot: int) -> None:
        """Admit one request: host bookkeeping only. Blocks covering the
        whole feed are reserved, a prefix-cache match adopts its blocks
        (any tail length: chunks drain it), and the remaining tokens arm
        ``req.pending_feed``."""
        pool = self._pool
        feed = np.concatenate(
            [req.prompt, np.asarray(req.tokens, np.int32)])
        cached = pool.match_prefix(feed)
        if cached:
            pool.admit_cached(slot, cached)
            m = len(cached) * pool.block_size
            pool.set_slot(slot, pos=m, lo=0)
            req.pending_feed = [int(t) for t in feed[m:]]
            req.trace.mark("prefix_hit", tokens_saved=m,
                           pending=len(req.pending_feed))
        else:
            pool.admit_fresh(slot, feed.size)
            pool.set_slot(slot, pos=0, lo=0)
            req.pending_feed = [int(t) for t in feed]

    def _ragged_operands(self, slot_requests, plan):
        """Host-side flattened ragged-row operands of one launch:
        per-slot contiguous padded rows, page-table-resolved write
        targets and the kernel's metadata (numpy)."""
        pool = self._pool
        S = pool.num_slots
        bs = pool.block_size
        q_lens = [0] * S
        pos0s = [0] * S
        row_tokens = {}
        kv_len = np.zeros(S, np.int32)
        sample_mask = np.zeros(S, bool)
        temps = np.ones(S, np.float32)
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
            row_tokens[slot] = (req.pending_feed[:n] if req.pending_feed
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
                sample_mask, temps)

    def _run_fused_step(self, slot_requests, plan):
        """Run ONE fused ragged launch; returns the next-token tensor
        (``[num_slots + 1]``, on the device) un-fetched."""
        Q, T, ops, sample_mask, temps = self._ragged_operands(
            slot_requests, plan)
        dev_ops = self._put(*ops)
        pool = self._pool
        step = self._steps.get((Q, T))
        if step is None:
            step = self._steps[(Q, T)] = build_fused_step_fn(
                self._model, pool.num_slots, Q, T, pool.block_size,
                top_k=self._top_k, top_p=self._top_p,
                quantized=pool.quantized, qmax=pool.qmax)
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
