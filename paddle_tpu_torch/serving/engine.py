"""``GenerationEngine`` — continuous-batching serving over the fused
ragged paged step (counterpart of ``paddle_tpu/serving/engine.py`` for
``kv_layout="paged", attention="fused"``).

Every cycle is ONE fused launch over a ragged batch: prompts feed in
``prefill_budget``-token chunks mixed with one row per decoding slot,
the ragged paged attention kernel walks each sequence's page table in
the block pool, and the first generated token of a prompt comes out of
the launch that feeds its final chunk. Host operands are the JAX
engine's, bucket for bucket (pow2 q rows, pow2 page tables), so the two
engines compare like with like.
"""
from __future__ import annotations

import threading
from typing import Iterator, Optional

import numpy as np
import torch

from .._device import resolve_device
from ..models.generation import build_fused_step_fn
from ..ops.ragged_paged_attention import (BLOCK_Q, MIN_KV_BLOCK,
                                          min_kv_block_for, ragged_layout)
from .paging import PagedKVPool, PoolCapacityError
from .scheduler import GenerationRequest, Scheduler

__all__ = ["GenerationEngine"]

_QUEUED = ("the dense slot engine and the gather path are queued in "
           "ROADMAP.md (\"dense/gather engine\")")


class GenerationEngine:
    """Continuous-batching autoregressive serving over a port GPT model.

    * ``model`` — a ``paddle_tpu_torch.models.GPTForPretraining`` (or
      ``GPTModel``) whose parameters already lie on ``device``;
    * ``device`` — ``None`` means ``"cuda"``, and raises without a card;
      pass ``device="cpu"`` to serve on the CPU (kernels' plain
      versions);
    * ``num_slots`` — concurrent in-flight requests; ``max_len`` —
      per-request capacity, ``prompt + max_new_tokens <= max_len``;
    * ``block_size``/``num_blocks`` — the paged pool (``num_blocks``
      defaults to ``num_slots`` full-length requests; shrink it and
      admission gates on blocks, growth preempts, full prompt blocks are
      shared through the prefix cache);
    * ``prefill_budget`` — prompt tokens fed per cycle;
    * ``kv_dtype`` — ``None`` stores K/V in the model's parameter dtype;
      ``"int8"`` or ``"float8_e4m3fn"`` stores 1-byte codes with a
      float32 max-abs scale per (layer, K/V, block, head), about half the
      bytes of a bf16 pool, and needs ``block_size >= 32``;
    * ``top_k``/``top_p`` — the sampled path's truncation, fixed per
      engine; ``seed`` seeds the engine's ``torch.Generator``.

    Only ``kv_layout="paged", attention="fused"`` exist in the port so
    far (they are the defaults here); other values raise
    ``NotImplementedError``. Greedy output is token-identical to the JAX
    fused engine on the same weights.
    """

    def __init__(self, model, num_slots: int = 8,
                 max_len: Optional[int] = None, *, top_k: int = 0,
                 top_p: float = 1.0, pad_token_id: int = 0,
                 max_queue: int = 128, prefill_budget: Optional[int] = None,
                 seed: int = 0, kv_layout: str = "paged",
                 block_size: int = 16,
                 num_blocks: Optional[int] = None,
                 attention: str = "fused", kv_dtype: Optional[str] = None,
                 device=None):
        self._device = resolve_device(device)
        if kv_layout != "paged":
            raise NotImplementedError(
                f"kv_layout={kv_layout!r} is not ported yet: {_QUEUED}")
        if attention != "fused":
            raise NotImplementedError(
                f"attention={attention!r} is not ported yet: {_QUEUED}")
        if kv_dtype is not None and kv_dtype not in PagedKVPool._QUANT_QMAX:
            raise ValueError(
                f"kv_dtype must be None (the parameter dtype) or one of "
                f"{sorted(PagedKVPool._QUANT_QMAX)}, got {kv_dtype!r}")
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
        head_dim = cfg.hidden_size // cfg.num_attention_heads
        self._pool = PagedKVPool(
            cfg.num_hidden_layers, num_slots, cfg.num_attention_heads,
            max_len, head_dim, block_size=block_size, num_blocks=num_blocks,
            dtype=kv_dtype or param.dtype, device=self._device)
        self._gen = torch.Generator(device=self._device)
        self._gen.manual_seed(int(seed))
        self._steps = {}                  # (q bucket, table bucket) -> fn
        self._closed = False
        self._close_lock = threading.Lock()
        self._sched = Scheduler(
            self._pool, self._run_fused_admit, self._run_fused_step,
            do_copy=self._run_copy, max_queue=max_queue,
            prefill_budget=prefill_budget)

    # -- client side -------------------------------------------------------
    def submit(self, prompt_ids, max_new_tokens: int = 32, *,
               do_sample: bool = False, temperature: float = 1.0,
               top_k: Optional[int] = None, top_p: Optional[float] = None,
               eos_token_id: Optional[int] = None,
               timeout: Optional[float] = None) -> GenerationRequest:
        """Enqueue one generation; returns its handle immediately
        (``handle.stream()``, ``handle.result()``, ``handle.cancel()``).
        ``timeout`` is a hard deadline in seconds. ``top_k``/``top_p``
        are fixed per engine: a differing value raises ``ValueError``. A
        full queue raises ``QueueFullError``."""
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
        if ids.size + int(max_new_tokens) > self._pool.max_len:
            raise PoolCapacityError(
                f"prompt {ids.size} + max_new_tokens {max_new_tokens} "
                f"exceeds the pool's virtual capacity {self._pool.max_len}")
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
        queue, slots, blocks, prefix cache, chunked prefill, and TTFT/
        TPOT percentiles over this engine's retired requests."""
        pool, sched = self._pool, self._sched
        hits, misses = pool.prefix_hits, pool.prefix_misses
        s = {
            "kv_layout": "paged",
            "attention": "fused",
            "kv_dtype": pool.dtype_name,
            # block storage vs the scale array (0 for float pools)
            "kv_bytes": {"blocks": pool.block_storage_bytes,
                         "scales": pool.scales_bytes},
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
            "kv_pool_capacity_bytes": pool.capacity_bytes,
            "kv_bytes_in_use": pool.bytes_in_use,
            "prefill_chunks": sched.prefill_chunks,
            "chunked_prefill_tokens": sched.chunk_tokens,
        }
        s.update(sched.latency_summary())
        return s

    # -- scheduler callbacks (scheduler thread) ----------------------------
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
        # every int32 operand crosses to the device in ONE copy
        sizes = [a.size for a in ops]
        flat = torch.from_numpy(np.concatenate([a.reshape(-1) for a in ops]))
        parts = flat.to(self._device).split(sizes)
        dev_ops = [p.view(a.shape) for p, a in zip(parts, ops)]
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
