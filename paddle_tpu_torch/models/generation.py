"""Decoding (counterpart of ``paddle_tpu/models/generation.py``): the
static-cache :func:`generate` (greedy, sampled, beam search), its
exported form :func:`save_for_serving`, and the serving steps of the
dense, paged gather and fused engines.

:func:`generate` decodes a batch of prompts through ``GPTModel.prefill``
and ``decode_step`` over a fixed per-layer K/V cache, greedily, by
sampling, or by beam search over ``batch x num_beams`` flattened rows.
The JAX package compiles that loop into one program
(``lax.while_loop``) and caches it per shape; here it is a Python loop
that runs eagerly and stops when every row is finished, with no compile
cache.

The gather engines' steps (:func:`build_slot_prefill_fn`,
:func:`build_slot_decode_fn` over the dense slot pool;
:func:`build_paged_prefill_fn`, :func:`build_paged_decode_fn` over the
block pool, float or quantized) run attention through the masked plain
composition over a materialized cache, never the ragged paged kernel:
they are the oracle the fused engine is held against.

The fused step (:func:`build_fused_step_fn`) advances a RAGGED batch of
mixed prefill-chunk and decode rows through every layer in one call, with
the ragged paged attention kernel walking each sequence's page table in
the block pool. There is no jit and no donation: it runs eagerly and
updates the pool (and a quantized pool's scales) IN PLACE, where the JAX
step donated the buffers and returned new ones.

Speculative decoding pairs a draft model's proposals with one fused
verify launch: :func:`build_draft_prefill_fn` and
:func:`build_draft_propose_scan_fn` run the draft over its dense slot
pool (masked plain attention, as in the JAX package), and
:func:`build_spec_verify_fn` scores every candidate as an extra ragged
row of the target's fused launch and runs the rejection sampling
(:func:`_spec_accept`) on the device; :func:`make_draft_model` builds the
default draft.

Sampling draws from an explicit ``torch.Generator`` in place of
``jax.random`` keys.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..framework import trace_probe as _probe
from ..framework.dispatch import call_op
from ..framework.random import get_generator
from ..nn import functional as F
from ..nn.layer.layers import Layer
from ..ops.ragged_paged_attention import BLOCK_Q, ragged_paged_attention

__all__ = ["GenerationConfig", "generate", "save_for_serving",
           "build_fused_step_fn",
           "build_slot_prefill_fn", "build_slot_decode_fn",
           "build_paged_prefill_fn", "build_paged_decode_fn",
           "build_spec_verify_fn", "build_draft_prefill_fn",
           "build_draft_propose_fn", "build_draft_propose_scan_fn",
           "make_draft_model"]


@dataclass
class GenerationConfig:
    max_new_tokens: int = 32
    do_sample: bool = False
    temperature: float = 1.0
    top_k: int = 0            # 0 = disabled
    top_p: float = 1.0        # 1.0 = disabled
    eos_token_id: Optional[int] = None
    pad_token_id: int = 0
    seed: Optional[int] = None
    num_beams: int = 1        # >1 = beam search
    length_penalty: float = 0.0   # GNMT ((5+len)/6)^alpha; 0 = off


def _filter_logits(logits, top_k, top_p, temperature):
    """Temperature scaling, then static top-k / top-p masking to
    ``-inf``, over ``[..., V]``. ``temperature`` broadcasts."""
    logits = logits / torch.clamp(temperature, min=1e-6)
    if top_k and top_k > 0:
        kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
        logits = torch.where(logits < kth, float("-inf"), logits)
    if top_p < 1.0:
        # stable, as jnp.argsort(-logits) is: tied logits keep ascending
        # index order, so the cutoff keeps the same ties as the reference
        sorted_logits, sort_idx = torch.sort(logits, dim=-1, descending=True,
                                             stable=True)
        probs = torch.softmax(sorted_logits, dim=-1)
        cum_excl = torch.cumsum(probs, dim=-1) - probs
        keep_sorted = cum_excl < top_p          # always keeps the top-1
        keep = torch.zeros_like(keep_sorted).scatter(-1, sort_idx,
                                                     keep_sorted)
        logits = torch.where(keep, logits, float("-inf"))
    return logits


def _pick_token(logits, generator, do_sample, top_k, top_p, temperature):
    """logits ``[B, V]`` f32 -> ``[B]`` int32: the argmax, or a draw
    from the filtered distribution with ``generator``."""
    if not do_sample:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    probs = torch.softmax(_filter_logits(logits, top_k, top_p, temperature),
                          dim=-1)
    # exponential race: argmax(p / E) with E ~ Exp(1) is a draw from p.
    # Unlike torch.multinomial it takes non-finite probabilities, so NaN
    # logits reach the finite sentinel instead of raising in the step
    race = torch.empty_like(probs).exponential_(generator=generator)
    return torch.argmax(probs / race, dim=-1).to(torch.int32)


def _sample_probs(logits, sample_mask, top_k, top_p, temperature):
    """Each row's SAMPLING DISTRIBUTION as explicit probabilities ``[N,
    V]`` f32, what the speculative rejection sampling needs on both
    sides: sampled rows the softmax of the :func:`_filter_logits`
    truncation, greedy rows the one-hot at the argmax (so greedy
    acceptance is token equality). ``sample_mask [N]`` bool and
    ``temperature [N]`` are tensors."""
    onehot = torch.zeros_like(logits, dtype=torch.float32).scatter_(
        -1, torch.argmax(logits, dim=-1, keepdim=True), 1.0)
    soft = torch.softmax(
        _filter_logits(logits, top_k, top_p, temperature[..., None]),
        dim=-1)
    return torch.where(sample_mask[..., None], soft, onehot)


def _categorical_probs(generator, probs):
    """Draw one token per row from explicit probabilities ``[..., V]``
    with ``generator``: the exponential race ``argmax(p / E)``, ``E ~
    Exp(1)``, over the entries with ``p > 0`` only, so a zero-probability
    token is never drawn and a one-hot row always gives its token."""
    race = torch.empty_like(probs).exponential_(generator=generator)
    score = torch.where(probs > 0, probs / race, -1.0)
    return torch.argmax(score, dim=-1).to(torch.int32)


def _spec_accept(p_probs, q_probs, drafts, n_spec, base_probs, generator):
    """Speculative rejection sampling of one cycle, on the device.

    Per slot ``s`` the draft proposed ``drafts[s, :n_spec[s]]``;
    ``p_probs [S, K, V]`` is the target's sampling distribution at each
    candidate's row and ``q_probs [S, K, V]`` the draft's proposal
    distribution. Candidate ``d`` is accepted while ``u * q(d) < p(d)``
    (``u ~ U[0, 1)``); the first rejected position draws from the
    residual ``max(p - q, 0)``, renormalized. One-hot (greedy) rows make
    this exact argmax equality and an argmax correction.
    ``base_probs [S, V]`` is each slot's last-row distribution, drawn
    for slots that verified nothing (``n_spec == 0``: a prefill chunk
    whose feed ends emits its first token from it).

    Returns ``(accepted [S] int32, token [S] int32)``: ``token`` is the
    residual draw after a rejection, the base draw when ``n_spec == 0``,
    and unused when every candidate was accepted."""
    s_, k_, _ = p_probs.shape
    dev = p_probs.device
    u = torch.rand((s_, k_), generator=generator, device=dev)
    d = drafts.long()[..., None]
    pd = p_probs.gather(-1, d)[..., 0]
    qd = q_probs.gather(-1, d)[..., 0]
    valid = torch.arange(k_, device=dev)[None, :] < n_spec[:, None]
    acc = valid & (u * qd < pd)
    accepted = torch.cumprod(acc.to(torch.int32), dim=1).sum(dim=1)
    ridx = accepted.clamp(max=k_ - 1)
    rows = torch.arange(s_, device=dev)
    pr, qr = p_probs[rows, ridx], q_probs[rows, ridx]
    res = (pr - qr).clamp_min(0.0)
    rsum = res.sum(dim=-1, keepdim=True)
    # a rejection implies p != q somewhere, so the residual has mass;
    # the p fallback only guards numerically identical distributions
    res = torch.where(rsum > 0, res / rsum.clamp_min(1e-38), pr)
    rejected = (accepted < n_spec) & (n_spec > 0)
    token = torch.where(rejected, _categorical_probs(generator, res),
                        _categorical_probs(generator, base_probs))
    return accepted.to(torch.int32), token


def _append_nonfinite_flag(nxt, logits):
    """Append the per-cycle logits-finite sentinel to the token row:
    element ``[num_slots]`` is 1 when ANY logit this cycle is NaN/Inf.
    It rides the scheduler's one fetch per cycle."""
    bad = (~torch.isfinite(logits)).any().to(torch.int32)
    return torch.cat([nxt, bad[None]])


def _to_codes(x, qmax, dtype):
    """f32 values already divided by their scale -> codes: round half to
    even, clamp to ``±qmax``, then cast (for fp8 the cast rounds once
    more, as in the JAX package: 17 -> 16, 300 -> 288)."""
    return x.round().clamp(-qmax, qmax).to(dtype)


def _quant_append(pool, scales, li, kv, wb, off, rows, qmax):
    """Scatter per-row K/V values into a QUANTIZED block pool, in place.

    ``rows [N, H, Dh]`` land at ``(block wb[n], offset off[n])`` of plane
    ``(li, kv)``. Per-block max-abs scales only grow: a row whose
    magnitude exceeds its block's scale raises it (scatter-max), and the
    touched blocks are requantized to the new scale first; where the
    scale did not change the ratio is exactly 1.0, so steady appends
    never erode earlier rows. A NaN row makes its block's scale NaN, so
    the corruption stays visible after dequantization.

    Duplicate ``wb`` entries (a chunk writing several offsets of one
    block, pad rows aimed at scratch block 0) are safe: every duplicate
    sees the same old and new scales and requantizes the same block to
    the same codes, and the row offsets of a real block are distinct."""
    rows = rows.float()
    rmax = rows.abs().amax(dim=-1) / qmax                       # [N, H]
    old = scales[li, kv]                                        # [NB+1, H]
    new = old.scatter_reduce(0, wb[:, None].expand_as(rmax), rmax,
                             reduce="amax", include_self=True)
    new_w = new[wb]                                             # [N, H]
    nb = new_w.clamp_min(1e-30)
    ratio = torch.where(new_w > 0, old[wb] / nb, 1.0)
    blk = pool[li, kv, wb].float()                              # [N,H,bs,Dh]
    pool[li, kv, wb] = _to_codes(blk * ratio[..., None, None], qmax,
                                 pool.dtype)
    qrow = torch.where(new_w[..., None] > 0, rows / nb[..., None], 0.0)
    pool[li, kv, wb, :, off, :] = _to_codes(qrow, qmax, pool.dtype)
    scales[li, kv] = new


def _quant_write_blocks(pool, scales, li, kv, table, vals, qmax):
    """Whole-block quantized write (the paged prefill), in place: ``vals
    [Tp, H, bs, Dh]`` replace the blocks named by ``table [Tp]``, each
    with a fresh per-(block, head) max-abs scale: freshly allocated
    blocks hold nothing worth rescaling. Table entries 0 (the scratch
    block) repeat; which duplicate wins there is unspecified, and
    nothing reads it."""
    vals = vals.float()
    sc = vals.abs().amax(dim=(-2, -1)) / qmax                  # [Tp, H]
    denom = sc.clamp_min(1e-30)[..., None, None]
    codes = torch.where(sc[..., None, None] > 0, vals / denom, 0.0)
    pool[li, kv, table] = _to_codes(codes, qmax, pool.dtype)
    scales[li, kv, table] = sc


def _dequant_gather(pool, scales, li, kv, tables):
    """The gather path's read of a quantized pool: the virtual cache
    through the page tables, the per-block scales multiplied in AFTER
    the pool read. ``tables [S, T]`` -> float32 ``[S, T, H, bs, Dh]``."""
    return pool[li, kv][tables].float() \
        * scales[li, kv][tables][..., None, None]


def _fused_tower(gpt, x, pool, scales, write_block, write_off, blk_seq,
                 seq_qstart, seq_pos0, tables, lo, kv_len, qmax):
    """Per layer: scatter every flattened row's K/V into the pool through
    its page-table-resolved write target (through :func:`_quant_append`
    when ``scales`` is given), run the ragged paged attention kernel over
    the pool, and apply the block tail. Returns ``ln_f(x)``; ``pool`` and
    ``scales`` are updated in place.

    The scatter ``pool[li, 0, write_block, :, write_off, :] = k`` puts
    its advanced indices apart (separated by a slice), so the indexed
    row axis comes first and the value is ``[Q, H, Dh]``. Pad rows all
    write scratch block 0 at offset 0, as duplicates whose winner is
    unspecified: harmless only because no page-table walk ever reads
    block 0 (tables pad with it past ``kv_len``, never before)."""
    wb = write_block.long()
    wo = write_off.long()
    for li, block in enumerate(gpt.blocks):
        q, k, v = block._qkv(x)                        # [1, Q, H, Dh]
        if scales is not None:
            _quant_append(pool, scales, li, 0, wb, wo, k[0], qmax)
            _quant_append(pool, scales, li, 1, wb, wo, v[0], qmax)
        else:
            pool[li, 0, wb, :, wo, :] = k[0].to(pool.dtype)
            pool[li, 1, wb, :, wo, :] = v[0].to(pool.dtype)
        qh = q[0].transpose(0, 1).contiguous()         # [H, Q, Dh]
        a = ragged_paged_attention(qh, pool, li, blk_seq, seq_qstart,
                                   seq_pos0, tables, lo, kv_len,
                                   scales=scales)
        x = block._tail(x, a.transpose(0, 1)[None])
    return gpt.ln_f(x)


def build_fused_step_fn(model, num_slots, q_rows, table_len, block_size,
                        top_k=0, top_p=1.0, probe=None, quantized=False,
                        qmax=127.0):
    """Build THE fused ragged serving step for one ``(q_rows,
    table_len)`` bucket.

    Returns ``fn(pool, token_ids, qpos, write_block, write_off, blk_seq,
    seq_qstart, seq_pos0, tables, lo, kv_len, last_row, sample_mask,
    temperature, generator) -> next_tokens`` over the block pool
    ``[layers, 2, num_blocks + 1, heads, block_size, head_dim]``, which
    it updates in place. ``next_tokens`` is ``[num_slots + 1]`` int32;
    the last element is the logits-finite sentinel. All operands are
    tensors on the pool's device:

    * ``token_ids``/``qpos``/``write_block``/``write_off`` ``[q_rows]``
      int32 — the flattened padded ragged batch: each row's token,
      virtual cache position, and physical write block/offset (pad rows
      write the scratch block); every row's K/V land in the pool BEFORE
      the kernel runs, so a chunk row attends causally to its own chunk
      prefix;
    * ``blk_seq [q_rows / BLOCK_Q]``, ``seq_qstart``/``seq_pos0``/``lo``/
      ``kv_len [num_slots]``, ``tables [num_slots, table_len]`` int32 —
      the kernel's metadata;
    * ``last_row [num_slots]`` int32 — the row of each slot's LAST real
      token this launch, whose hidden state gives the slot's next token;
    * ``sample_mask [num_slots]`` bool, ``temperature [num_slots]`` f32.

    ``quantized=True`` serves a quantized pool (int8 or float8_e4m3fn
    codes, ``qmax`` the largest code): the function takes the pool's
    scales right after it, ``fn(pool, scales, token_ids, ...)``, rows
    land through :func:`_quant_append`, and the kernel dequantizes each
    block as it reads it. Both are updated in place.

    The step enters ``torch.inference_mode()`` itself: grad mode is
    thread-local, and the engine calls the step from its scheduler
    thread. ``probe`` (a ``framework.trace_probe`` site) records the
    step's signature once, when it is built.
    """
    gpt = model.gpt if hasattr(model, "gpt") else model
    S, Q, T = int(num_slots), int(q_rows), int(table_len)
    if S < 1:
        raise ValueError(f"num_slots must be >= 1, got {S}")
    if Q < BLOCK_Q or Q % BLOCK_Q:
        raise ValueError(
            f"q_rows must be a positive multiple of {BLOCK_Q}, got {Q}")
    if T < 1:
        raise ValueError(f"table_len must be >= 1, got {T}")
    if int(block_size) < 1:
        raise ValueError(f"block_size must be >= 1, got {block_size}")
    _probe_build(probe, [_pool_sig(gpt, quantized, qmax, int(block_size)),
                         ((Q,), "int32"), ((S, T), "int32")],
                 {"q": Q, "table": T})
    top_k = min(int(top_k), gpt.cfg.vocab_size)

    def fn(pool, *rest):
        (scales, token_ids, qpos, write_block, write_off, blk_seq,
         seq_qstart, seq_pos0, tables, lo, kv_len, last_row, sample_mask,
         temperature, generator) = rest if quantized else (None,) + rest
        if token_ids.shape != (Q,) or tables.shape != (S, T):
            raise ValueError(
                f"step built for q_rows={Q}, tables [{S}, {T}]; got "
                f"{tuple(token_ids.shape)} and {tuple(tables.shape)}")
        with torch.inference_mode():
            x = gpt.wte(token_ids[None, :]) + gpt.wpe(qpos[None, :])
            x = _fused_tower(gpt, x, pool, scales, write_block, write_off,
                             blk_seq, seq_qstart, seq_pos0, tables, lo,
                             kv_len, qmax)
            last = x[0, last_row.long()]                       # [S, E]
            return _next_tokens(gpt, last[:, None, :], generator,
                                sample_mask, temperature, top_k, top_p)

    return fn


# -- the gather engines' steps --------------------------------------------

def _first_token(gpt, hidden, generator, sample, temperature, top_k, top_p):
    """A prefill's first token ``[1]`` int32 from ``hidden [1, 1, E]``:
    the argmax, or a draw when ``sample``."""
    logits = gpt.logits(hidden)[:, 0].float()
    temp = torch.full((), float(temperature), device=logits.device)
    return _pick_token(logits, generator, bool(sample), top_k, top_p, temp)


def _next_tokens(gpt, x, generator, sample_mask, temperature, top_k, top_p):
    """A decode step's ``[num_slots + 1]`` tokens from ``x [S, 1, E]``
    (after ``ln_f``): greedy and sampled rows mixed by ``sample_mask``,
    and the logits-finite sentinel last."""
    return _tokens_of(gpt.logits(x)[:, 0].float(), generator, sample_mask,
                      temperature, top_k, top_p)


def _tokens_of(logits, generator, sample_mask, temperature, top_k, top_p):
    """:func:`_next_tokens` from the f32 logits ``[S, vocab]``."""
    greedy = _pick_token(logits, generator, False, top_k, top_p, None)
    sampled = _pick_token(logits, generator, True, top_k, top_p,
                          temperature[:, None])
    return _append_nonfinite_flag(torch.where(sample_mask, sampled, greedy),
                                  logits)


def _check_len(gpt, what, n):
    if n > gpt.cfg.max_position_embeddings:
        raise ValueError(
            f"{what} {n} exceeds max_position_embeddings="
            f"{gpt.cfg.max_position_embeddings}")


def _pool_sig(gpt, quantized=False, qmax=127.0, *dims):
    """The KV pool operand of a step's trace-probe signature: the layer,
    K/V, head and head-width axes with the builder's own ``dims``, in the
    dtype the pool will have (the model's, or the quantized code's)."""
    H = gpt.cfg.num_attention_heads
    dtype = ("int8" if float(qmax) == 127.0 else "float8_e4m3fn") \
        if quantized else next(gpt.parameters()).dtype
    return ((gpt.cfg.num_hidden_layers, 2, H, *dims,
             gpt.cfg.hidden_size // H), dtype)


def _probe_build(probe, operands, static) -> None:
    """Record a step's signature at its trace-probe site when it is built
    (the JAX package records it when jit traces the step: once per
    bucket, as here). ``operands`` are ``(shape, dtype)`` pairs."""
    if probe is not None:
        probe.record(_probe.sig_of(operands), static)


def build_slot_prefill_fn(model, bucket_len, max_len, top_k=0, top_p=1.0,
                          probe=None):
    """Build the prefill step of the dense slot engine for one capacity
    bucket.

    Returns ``fn(pool, ids, key_valid, slot, sample, temperature,
    generator) -> first_token [1]`` over the dense pool ``[layers, 2,
    slots, heads, max_len, head_dim]``: ``ids [1, bucket_len]`` is the
    prompt LEFT-padded to the bucket, ``key_valid [1, bucket_len]`` bool
    marks its real tokens (the ragged-prompt contract of
    :func:`generate`), and the K/V land in row ``slot`` at cache indices
    ``[0, bucket_len)``, in place: the per-layer cache the prefill fills
    is a view of that row. ``sample`` (bool) and ``temperature`` pick the
    first token. ``probe`` (a ``framework.trace_probe`` site) records the
    step's signature once, when it is built.
    """
    gpt = model.gpt if hasattr(model, "gpt") else model
    Lb = int(bucket_len)
    if Lb < 1:
        raise ValueError(f"bucket_len must be >= 1, got {Lb}")
    if Lb > int(max_len):
        raise ValueError(f"bucket_len {Lb} exceeds pool max_len {max_len}")
    _check_len(gpt, "bucket_len", Lb)
    top_k = min(int(top_k), gpt.cfg.vocab_size)
    _probe_build(probe, [_pool_sig(gpt, False, 127.0, int(max_len)),
                         ((1, Lb), "int64"), ((1, Lb), "bool")],
                 {"bucket": Lb})

    def fn(pool, ids, key_valid, slot, sample, temperature, generator):
        if tuple(ids.shape) != (1, Lb):
            raise ValueError(f"prefill built for [1, {Lb}], got "
                             f"{tuple(ids.shape)}")
        with torch.inference_mode():
            # the slot's [H, Lb, Dh] rows, seen as the [1, Lb, H, Dh]
            # cache that GPTBlock.prefill writes
            caches = tuple(
                tuple(pool[li, kv, slot, :, :Lb].transpose(0, 1)[None]
                      for kv in range(2))
                for li in range(pool.shape[0]))
            hidden, _ = gpt.prefill(ids, caches, key_valid=key_valid)
            return _first_token(gpt, hidden, generator, sample, temperature,
                                top_k, top_p)

    return fn


def build_slot_decode_fn(model, num_slots, max_len, top_k=0, top_p=1.0,
                         probe=None):
    """Build THE decode step of the dense slot engine: every slot
    advances one token a call.

    Returns ``fn(pool, tokens, pos, lo, sample_mask, temperature,
    generator) -> next_tokens [num_slots + 1]`` (the logits-finite
    sentinel last), all operands tensors on the pool's device:

    * ``tokens [S]`` int32, each slot's last token; its K/V land at
      cache index ``pos[slot]`` (a per-slot scatter: slots at different
      positions decode together);
    * ``lo [S]`` int32, each slot's first valid index (its bucket's
      left pad): attention sees ``[lo, pos]`` through the masked plain
      composition, and position embeddings count ``pos - lo``;
    * ``sample_mask [S]`` bool, ``temperature [S]`` f32: greedy and
      sampled rows share the step. Free slots compute garbage that the
      scheduler ignores and the next prefill overwrites.

    ``probe`` records the step's signature once, when it is built.
    """
    gpt = model.gpt if hasattr(model, "gpt") else model
    S, L = int(num_slots), int(max_len)
    if S < 1:
        raise ValueError(f"num_slots must be >= 1, got {S}")
    _check_len(gpt, "max_len", L)
    top_k = min(int(top_k), gpt.cfg.vocab_size)
    _probe_build(probe, [_pool_sig(gpt, False, 127.0, S, L),
                         ((S,), "int32"), ((S,), "int32"), ((S,), "int32"),
                         ((S,), "float32")], {"slots": S})

    def fn(pool, tokens, pos, lo, sample_mask, temperature, generator):
        with torch.inference_mode():
            x = gpt._embed(tokens[:, None], (pos - lo)[:, None])
            r = torch.arange(L, device=pos.device)
            key_valid = (r[None, :] >= lo[:, None]) \
                & (r[None, :] <= pos[:, None])
            mask = key_valid[:, None, None, :]
            sl = torch.arange(S, device=pos.device)
            p = pos.long()
            for li, block in enumerate(gpt.blocks):
                q, k, v = block._qkv(x)                  # [S, 1, H, Dh]
                # advanced indices apart (a slice between): [S, H, Dh]
                pool[li, 0, sl, :, p, :] = k[:, 0].to(pool.dtype)
                pool[li, 1, sl, :, p, :] = v[:, 0].to(pool.dtype)
                a = F.scaled_dot_product_attention(
                    q, pool[li, 0].transpose(1, 2),
                    pool[li, 1].transpose(1, 2), attn_mask=mask,
                    training=False)
                x = block._tail(x, a)
            return _next_tokens(gpt, gpt.ln_f(x), generator, sample_mask,
                                temperature, top_k, top_p)

    return fn


def build_paged_prefill_fn(model, bucket_len, block_size, top_k=0,
                           top_p=1.0, probe=None, quantized=False,
                           qmax=127.0):
    """Build the prefill step of the paged gather engine for one
    capacity bucket.

    Returns ``fn(pool, ids, key_valid, table, plen, sample, temperature,
    generator) -> first_token [1]`` over the block pool ``[layers, 2,
    num_blocks + 1, heads, block_size, head_dim]``: ``ids [1,
    bucket_len]`` is the feed RIGHT-padded to the bucket (paged
    sequences start at virtual index 0, which makes blocks shareable),
    ``key_valid`` marks its real tokens, and each layer's K/V land as
    whole blocks through ``table [bucket_len // block_size]`` (0, the
    scratch block, past the allocation). ``plen`` is the real length:
    the first token comes from position ``plen - 1``.

    ``quantized=True`` takes the pool's scales right after it
    (``fn(pool, scales, ids, ...)``): the K/V are computed in the model's
    dtype and written through :func:`_quant_write_blocks`. ``probe``
    records the step's signature once, when it is built.
    """
    gpt = model.gpt if hasattr(model, "gpt") else model
    Lb, bs = int(bucket_len), int(block_size)
    if Lb < 1:
        raise ValueError(f"bucket_len must be >= 1, got {Lb}")
    if bs < 1 or Lb % bs:
        raise ValueError(
            f"bucket_len {Lb} must be a positive multiple of "
            f"block_size {bs}")
    _check_len(gpt, "bucket_len", Lb)
    Tp = Lb // bs
    _probe_build(probe, [_pool_sig(gpt, quantized, qmax, bs),
                         ((1, Lb), "int64"), ((1, Lb), "bool"),
                         ((Tp,), "int32")], {"bucket": Lb, "table": Tp})
    H = gpt.cfg.num_attention_heads
    Dh = gpt.cfg.hidden_size // H
    top_k = min(int(top_k), gpt.cfg.vocab_size)

    def fn(pool, *rest):
        (scales, ids, key_valid, table, plen, sample, temperature,
         generator) = rest if quantized else (None,) + rest
        if tuple(ids.shape) != (1, Lb):
            raise ValueError(f"prefill built for [1, {Lb}], got "
                             f"{tuple(ids.shape)}")
        with torch.inference_mode():
            # right-padded: reals count 0, 1, 2, ...; pads repeat the
            # last real position (their K/V are masked garbage that lands
            # in the scratch block or is overwritten by later decodes)
            pos_ids = torch.clamp(
                torch.cumsum(key_valid.to(torch.int32), dim=1) - 1, min=0)
            x = gpt._embed(ids, pos_ids)
            # a quantized pool keeps the layer's K/V in the model dtype
            # until the block write quantizes them
            cdt = x.dtype if quantized else pool.dtype
            tab = table.long()
            for li, block in enumerate(gpt.blocks):
                ck = torch.zeros((1, Lb, H, Dh), dtype=cdt, device=x.device)
                cv = torch.zeros_like(ck)
                x = block.prefill(x, ck, cv, key_valid=key_valid)
                # [1, Lb, H, Dh] -> per-block [Tp, H, bs, Dh]
                for kv, c in ((0, ck), (1, cv)):
                    vals = c[0].reshape(Tp, bs, H, Dh).transpose(1, 2)
                    if quantized:
                        _quant_write_blocks(pool, scales, li, kv, tab, vals,
                                            qmax)
                    else:
                        pool[li, kv, tab] = vals
            x = gpt.ln_f(x)
            p = int(plen)
            return _first_token(gpt, x[:, p - 1:p], generator, sample,
                                temperature, top_k, top_p)

    return fn


def build_paged_decode_fn(model, num_slots, table_len, block_size, top_k=0,
                          top_p=1.0, probe=None, quantized=False, qmax=127.0,
                          debug_logits=False):
    """Build the decode step of the paged gather engine for one pow2
    table bucket: attention over the virtual cache GATHERED through the
    page tables.

    Returns ``fn(pool, tokens, pos, lo, tables, sample_mask, temperature,
    generator) -> next_tokens [num_slots + 1]`` (the sentinel last):

    * ``tables [S, table_len]`` int32, each slot's page table padded
      with 0 (the scratch block); the new token's K/V land at block
      ``tables[s, pos[s] // block_size]``, offset ``pos[s] %
      block_size``. Free slots all write the scratch block at offset 0,
      as duplicates whose winner is unspecified: nothing reads it
      unmasked;
    * attention runs over ``pool[li, kv][tables]`` reshaped to ``[S,
      table_len * block_size, H, Dh]`` with the ``[lo, pos]`` mask and
      positions ``pos - lo`` of the dense step, through the masked plain
      composition (never the ragged paged kernel);
    * ``quantized=True`` takes the pool's scales right after it: appends
      go through :func:`_quant_append` and the gathered cache is
      dequantized by :func:`_dequant_gather`;
    * ``debug_logits=True`` returns ``(next_tokens, logits)``, the
      step's f32 logits ``[S, vocab]`` beside its tokens;
    * ``probe`` records the step's signature once, when it is built.
    """
    gpt = model.gpt if hasattr(model, "gpt") else model
    S, T, bs = int(num_slots), int(table_len), int(block_size)
    if S < 1:
        raise ValueError(f"num_slots must be >= 1, got {S}")
    if T < 1:
        raise ValueError(f"table_len must be >= 1, got {T}")
    H = gpt.cfg.num_attention_heads
    Dh = gpt.cfg.hidden_size // H
    top_k = min(int(top_k), gpt.cfg.vocab_size)
    _probe_build(probe, [_pool_sig(gpt, quantized, qmax, bs),
                         ((S,), "int32"), ((S,), "int32"), ((S,), "int32"),
                         ((S, T), "int32"), ((S,), "float32")],
                 {"slots": S, "table": T})

    def fn(pool, *rest):
        (scales, tokens, pos, lo, tables, sample_mask, temperature,
         generator) = rest if quantized else (None,) + rest
        if tuple(tables.shape) != (S, T):
            raise ValueError(f"step built for tables [{S}, {T}], got "
                             f"{tuple(tables.shape)}")
        with torch.inference_mode():
            x = gpt._embed(tokens[:, None], (pos - lo)[:, None])
            r = torch.arange(T * bs, device=pos.device)
            key_valid = (r[None, :] >= lo[:, None]) \
                & (r[None, :] <= pos[:, None])
            mask = key_valid[:, None, None, :]
            tab = tables.long()
            sl = torch.arange(S, device=pos.device)
            wb = tab[sl, (pos // bs).long()]          # write block per slot
            off = (pos % bs).long()
            for li, block in enumerate(gpt.blocks):
                q, k, v = block._qkv(x)
                if quantized:
                    _quant_append(pool, scales, li, 0, wb, off, k[:, 0], qmax)
                    _quant_append(pool, scales, li, 1, wb, off, v[:, 0], qmax)
                    kg = _dequant_gather(pool, scales, li, 0, tab).to(k.dtype)
                    vg = _dequant_gather(pool, scales, li, 1, tab).to(v.dtype)
                else:
                    pool[li, 0, wb, :, off, :] = k[:, 0].to(pool.dtype)
                    pool[li, 1, wb, :, off, :] = v[:, 0].to(pool.dtype)
                    kg, vg = pool[li, 0][tab], pool[li, 1][tab]
                # [S, T, H, bs, Dh] -> [S, T * bs, H, Dh]
                kf = kg.transpose(2, 3).reshape(S, T * bs, H, Dh)
                vf = vg.transpose(2, 3).reshape(S, T * bs, H, Dh)
                a = F.scaled_dot_product_attention(q, kf, vf, attn_mask=mask,
                                                   training=False)
                x = block._tail(x, a)
            logits = gpt.logits(gpt.ln_f(x))[:, 0].float()
            nxt = _tokens_of(logits, generator, sample_mask, temperature,
                             top_k, top_p)
            return (nxt, logits) if debug_logits else nxt

    return fn


# -- speculative decoding ---------------------------------------------------


def build_spec_verify_fn(model, num_slots, q_rows, spec_k, table_len,
                         block_size, top_k=0, top_p=1.0, probe=None,
                         quantized=False, qmax=127.0):
    """The VERIFY launch of speculative decoding: the multi-row twin of
    :func:`build_fused_step_fn`, one fused ragged launch in which each
    speculating slot feeds its candidate rows ``[last_token, d_1, ...,
    d_{n-1}]`` (extra ragged rows, as a prefill chunk's) and the rows'
    logits drive :func:`_spec_accept`. Slots mid-prefill keep chunking
    through the same launch (``n_spec == 0``).

    Returns ``fn(pool, [scales,] token_ids, qpos, write_block, write_off,
    blk_seq, seq_qstart, seq_pos0, tables, lo, kv_len, last_row, n_spec,
    draft_toks, draft_probs, sample_mask, temperature, generator) ->
    out``, the pool (and scales) updated in place, where

    * ``n_spec [S]`` int32: candidates verified per slot (0 = plain feed
      or decode rows);
    * ``draft_toks [S, spec_k]`` int32 / ``draft_probs [S, spec_k, V]``
      f32: the draft's proposals, which never left the device; row
      ``seq_qstart + 1 + j`` of ``token_ids`` takes ``draft_toks[:, j]``
      here, on the device;
    * ``out [2S + S*spec_k + 1]`` int32: ``[accepted (S) | corrected
      token (S) | draft tokens echoed (S*spec_k) | logits-finite
      sentinel]``, all the scheduler's one fetch needs.

    Only the ``S*spec_k`` candidate rows and each slot's last row go
    through the LM head. ``probe`` records the step's signature once,
    when it is built.
    """
    gpt = model.gpt if hasattr(model, "gpt") else model
    S, Q, K, T = int(num_slots), int(q_rows), int(spec_k), int(table_len)
    if S < 1:
        raise ValueError(f"num_slots must be >= 1, got {S}")
    if K < 1:
        raise ValueError(f"spec_k must be >= 1, got {K}")
    if Q < BLOCK_Q or Q % BLOCK_Q:
        raise ValueError(
            f"q_rows must be a positive multiple of {BLOCK_Q}, got {Q}")
    if T < 1:
        raise ValueError(f"table_len must be >= 1, got {T}")
    _probe_build(probe, [_pool_sig(gpt, quantized, qmax, int(block_size)),
                         ((Q,), "int32"), ((S, T), "int32"),
                         ((S, K), "int32")], {"q": Q, "table": T, "k": K})
    top_k = min(int(top_k), gpt.cfg.vocab_size)

    def fn(pool, *rest):
        (scales, token_ids, qpos, write_block, write_off, blk_seq,
         seq_qstart, seq_pos0, tables, lo, kv_len, last_row, n_spec,
         draft_toks, draft_probs, sample_mask, temperature,
         generator) = rest if quantized else (None,) + rest
        if token_ids.shape != (Q,) or tables.shape != (S, T) \
                or draft_toks.shape != (S, K):
            raise ValueError(
                f"verify built for q_rows={Q}, tables [{S}, {T}], drafts "
                f"[{S}, {K}]; got {tuple(token_ids.shape)}, "
                f"{tuple(tables.shape)}, {tuple(draft_toks.shape)}")
        with torch.inference_mode():
            dev = token_ids.device
            j = torch.arange(K, device=dev)
            qstart = seq_qstart.long()
            # the fed token of verify row j + 1 is draft_toks[:, j]; rows
            # past a slot's candidates go to a sink row Q, dropped
            rows = qstart[:, None] + 1 + j[None, :]
            ok = j[None, :] < (n_spec.long()[:, None] - 1)
            sink = torch.cat([token_ids, token_ids.new_zeros(1)])
            sink.scatter_(0, torch.where(ok, rows, Q).reshape(-1),
                          draft_toks.reshape(-1).to(sink.dtype))
            token_ids = sink[:Q]
            x = gpt.wte(token_ids[None, :]) + gpt.wpe(qpos[None, :])
            x = _fused_tower(gpt, x, pool, scales, write_block, write_off,
                             blk_seq, seq_qstart, seq_pos0, tables, lo,
                             kv_len, qmax)
            # the LM head only over the rows whose logits are read
            vrows = (qstart[:, None] + j[None, :]).clamp(0, Q - 1)
            sel = x[0][torch.cat([vrows.reshape(-1), last_row.long()])]
            logits = gpt.logits(sel[:, None, :])[:, 0].float()
            p = _sample_probs(logits[:S * K],
                              sample_mask.repeat_interleave(K), top_k,
                              top_p, temperature.repeat_interleave(K)
                              ).reshape(S, K, -1)
            base = _sample_probs(logits[S * K:], sample_mask, top_k, top_p,
                                 temperature)
            accepted, token = _spec_accept(p, draft_probs, draft_toks,
                                           n_spec, base, generator)
            bad = (~torch.isfinite(logits)).any().to(torch.int32)
            return torch.cat([accepted, token,
                              draft_toks.to(torch.int32).reshape(-1),
                              bad[None]])

    return fn


def build_draft_prefill_fn(model, bucket_len, max_len, probe=None):
    """The DRAFT model's context prefill into its dense slot pool: when a
    slot starts speculating, the draft's cache must cover the target's
    context ``[0, pos)``. The context is RIGHT-padded into the bucket
    (virtual index 0, ``lo == 0``), so draft positions equal target
    positions token for token.

    Returns ``fn(pool, ids, key_valid, slot) -> pool`` over the draft
    pool ``[draft_layers, 2, slots, draft_heads, max_len, head_dim]``,
    written in place at row ``slot``, indices ``[0, bucket_len)``; no
    token is drawn. ``probe`` records the step's signature once, when it
    is built.
    """
    gpt = model.gpt if hasattr(model, "gpt") else model
    Lb = int(bucket_len)
    if Lb < 1:
        raise ValueError(f"bucket_len must be >= 1, got {Lb}")
    if Lb > int(max_len):
        raise ValueError(f"bucket_len {Lb} exceeds pool max_len {max_len}")
    _check_len(gpt, "bucket_len", Lb)
    _probe_build(probe, [_pool_sig(gpt, False, 127.0, int(max_len)),
                         ((1, Lb), "int64"), ((1, Lb), "bool")],
                 {"bucket": Lb})

    def fn(pool, ids, key_valid, slot):
        if tuple(ids.shape) != (1, Lb):
            raise ValueError(f"draft prefill built for [1, {Lb}], got "
                             f"{tuple(ids.shape)}")
        with torch.inference_mode():
            # the slot's [H, Lb, Dh] rows, seen as the [1, Lb, H, Dh]
            # cache that GPTBlock.prefill writes
            caches = tuple(
                tuple(pool[li, kv, slot, :, :Lb].transpose(0, 1)[None]
                      for kv in range(2))
                for li in range(pool.shape[0]))
            gpt.prefill(ids, caches, key_valid=key_valid)
        return pool

    return fn


def _draft_step(gpt, pool, feed, pj, lo, sample_mask, temperature,
                generator, top_k, top_p):
    """One draft token a slot: feed ``feed [S]`` at position ``pj [S]``
    of the dense draft pool (written in place), attend over ``[lo, pj]``
    through the masked plain composition, and draw the proposal from the
    draft's sampling distribution. Returns ``(proposal [S] int32, probs
    [S, V] f32)``."""
    S, L = pool.shape[2], pool.shape[4]
    r = torch.arange(L, device=pool.device)
    sl = torch.arange(S, device=pool.device)
    x = gpt._embed(feed[:, None], (pj - lo)[:, None])
    key_valid = (r[None, :] >= lo[:, None]) & (r[None, :] <= pj[:, None])
    mask = key_valid[:, None, None, :]
    p = pj.long()
    for li, block in enumerate(gpt.blocks):
        q, k, v = block._qkv(x)                        # [S, 1, H, Dh]
        pool[li, 0, sl, :, p, :] = k[:, 0].to(pool.dtype)
        pool[li, 1, sl, :, p, :] = v[:, 0].to(pool.dtype)
        a = F.scaled_dot_product_attention(
            q, pool[li, 0].transpose(1, 2), pool[li, 1].transpose(1, 2),
            attn_mask=mask, training=False)
        x = block._tail(x, a)
    logits = gpt.logits(gpt.ln_f(x))[:, 0].float()
    probs = _sample_probs(logits, sample_mask, top_k, top_p, temperature)
    return _categorical_probs(generator, probs), probs


def _draft_checks(gpt, num_slots, max_len):
    S, L = int(num_slots), int(max_len)
    if S < 1:
        raise ValueError(f"num_slots must be >= 1, got {S}")
    _check_len(gpt, "max_len", L)
    return S, L


def build_draft_propose_fn(model, num_slots, max_len, top_k=0, top_p=1.0,
                           probe=None):
    """ONE draft proposal step of speculative decoding.

    Returns ``fn(pool, feed_tok, pos, lo, sample_mask, temperature,
    generator) -> (proposal [S] int32, probs [S, V] f32)``: each slot
    feeds ``feed_tok`` at ``pos`` of the dense draft pool (in place) and
    draws its proposal from the draft's sampling distribution ``probs``
    (one-hot for greedy slots), which the verify's rejection sampling
    takes as ``q``. ``probe`` records the step's signature once, when it
    is built.
    """
    gpt = model.gpt if hasattr(model, "gpt") else model
    S, L = _draft_checks(gpt, num_slots, max_len)
    top_k = min(int(top_k), gpt.cfg.vocab_size)
    _probe_build(probe, [_pool_sig(gpt, False, 127.0, S, L),
                         ((S,), "int32"), ((S,), "int32"), ((S,), "int32"),
                         ((S,), "float32")], {"slots": S})

    def fn(pool, feed_tok, pos, lo, sample_mask, temperature, generator):
        with torch.inference_mode():
            return _draft_step(gpt, pool, feed_tok, pos, lo, sample_mask,
                               temperature, generator, top_k, top_p)

    return fn


def build_draft_propose_scan_fn(model, num_slots, max_len, spec_k, top_k=0,
                                top_p=1.0, probe=None):
    """The WHOLE draft proposal chain as one call: ``spec_k`` steps of
    :func:`build_draft_propose_fn`, each feeding the previous step's
    proposal, which stays on the device (the chain reads nothing back to
    the host).

    Returns ``fn(pool, feed_tok, pos, lo, sample_mask, temperature,
    generator) -> (proposals [S, spec_k] int32, probs [S, spec_k, V]
    f32)``: ``feed_tok [S]`` is each slot's last accepted token, and
    step ``j`` writes at position ``min(pos + j, max_len - 1)``.
    ``probe`` records the step's signature once, when it is built.
    """
    gpt = model.gpt if hasattr(model, "gpt") else model
    S, L = _draft_checks(gpt, num_slots, max_len)
    K = int(spec_k)
    if K < 1:
        raise ValueError(f"spec_k must be >= 1, got {K}")
    _probe_build(probe, [_pool_sig(gpt, False, 127.0, S, L),
                         ((S,), "int32"), ((S,), "int32"), ((S,), "int32"),
                         ((S,), "float32")], {"slots": S, "k": K})
    top_k = min(int(top_k), gpt.cfg.vocab_size)

    def fn(pool, feed_tok, pos, lo, sample_mask, temperature, generator):
        with torch.inference_mode():
            feed, props, probs = feed_tok, [], []
            for j in range(K):
                feed, pr = _draft_step(
                    gpt, pool, feed, torch.clamp(pos + j, max=L - 1), lo,
                    sample_mask, temperature, generator, top_k, top_p)
                props.append(feed)
                probs.append(pr)
            return torch.stack(props, dim=1), torch.stack(probs, dim=1)

    return fn


def make_draft_model(model, num_layers=2):
    """The default speculative draft: a GPT of the target's config cut to
    ``num_layers`` blocks that SHARES the target's token and position
    embeddings (the same modules: no extra embedding memory, and the
    tied LM head keeps the target's vocabulary) and whose blocks and
    final LayerNorm start as copies of the target's first
    ``num_layers`` blocks and ``ln_f``, on the target's device and in
    its dtype."""
    from dataclasses import replace

    from .gpt import GPTModel

    gpt = model.gpt if hasattr(model, "gpt") else model
    n = int(num_layers)
    if not 1 <= n <= gpt.cfg.num_hidden_layers:
        raise ValueError(
            f"num_layers must be in [1, {gpt.cfg.num_hidden_layers}], "
            f"got {num_layers}")
    draft = GPTModel(replace(gpt.cfg, num_hidden_layers=n))
    draft.wte = gpt.wte            # SHARED modules, not copies
    draft.wpe = gpt.wpe
    ref = gpt.wte.weight
    for mine, theirs in [(draft.blocks[i], gpt.blocks[i])
                         for i in range(n)] + [(draft.ln_f, gpt.ln_f)]:
        mine.to(device=ref.device, dtype=ref.dtype)
        mine.load_state_dict(theirs.state_dict())
    draft.eval()
    return draft


# -- static-cache generate ------------------------------------------------

def _mask_preamble(attn_mask, batch, max_new):
    """``(key_valid [B, total_len] bool over the prompt, real_len [B, 1])``
    for a left-padded prompt mask."""
    key_valid = call_op("concat", [
        attn_mask.to(torch.bool),
        torch.zeros((batch, max_new), dtype=torch.bool,
                    device=attn_mask.device)], axis=1)
    real_len = attn_mask.to(torch.int32).sum(dim=1, keepdim=True,
                                             dtype=torch.int32)
    return key_valid, real_len


def _step_mask(key_valid, real_len, prompt_len, total_len, pos, tile=1):
    """Key validity of decode step ``pos`` (the prompt mask, and the
    generated rows up to ``pos``) and each row's logical position;
    ``tile > 1`` repeats each row for flattened beams."""
    r = call_op("arange", total_len, device=key_valid.device)
    kv = key_valid | ((r >= prompt_len) & (r <= pos))[None, :]
    positions = real_len + (pos - prompt_len)
    if tile > 1:
        kv = kv.repeat_interleave(tile, dim=0)
        positions = positions.repeat_interleave(tile, dim=0)
    return kv, positions


def _decode(model, ids, mask, max_new, do_sample, top_k, top_p,
            temperature, eos, pad, generator):
    """The greedy/sampling loop of ``_build_generate_fn``, run eagerly:
    prefill, the first token, then one ``decode_step`` a token until the
    budget is spent or every row has emitted ``eos``."""
    gpt = model.gpt if hasattr(model, "gpt") else model
    batch, prompt_len = ids.shape
    total_len = prompt_len + max_new
    device = ids.device
    caches = gpt.init_cache(batch, total_len,
                            next(model.parameters()).dtype, device)
    if mask is not None:
        # ragged (left-padded) prompts: pads are masked out of attention
        # forever; logical positions count only real tokens, so each row
        # decodes at real_len + t
        key_valid, real_len = _mask_preamble(mask, batch, max_new)
    else:
        key_valid = real_len = None
    temp = torch.full((), float(temperature), device=device)

    def pick(hidden):
        logits = gpt.logits(hidden)[:, 0].float()
        return _pick_token(logits, generator, do_sample, top_k, top_p, temp)

    hidden, caches = gpt.prefill(
        ids, caches,
        key_valid=None if key_valid is None else key_valid[:, :prompt_len])
    first = pick(hidden)
    tokens = call_op("concat", [
        ids.to(torch.int32),
        call_op("full", (batch, max_new), pad, dtype=torch.int32,
                device=device)], axis=1)
    tokens[:, prompt_len] = first
    finished = None if eos is None else first == eos
    for pos in range(prompt_len, total_len - 1):
        # the host reads `finished` only when an eos can end the loop
        if finished is not None and bool(finished.all()):
            break
        if key_valid is not None:
            kv, positions = _step_mask(key_valid, real_len, prompt_len,
                                       total_len, pos)
        else:
            kv = positions = None
        hidden, caches = gpt.decode_step(tokens[:, pos:pos + 1], caches,
                                         pos, key_valid=kv,
                                         positions=positions)
        nxt = pick(hidden)
        if finished is not None:
            nxt = torch.where(finished, pad, nxt)
            finished = finished | (nxt == eos)
        tokens[:, pos + 1] = nxt
    return tokens


_MASK32 = 0xFFFFFFFF


def _mix32(x):
    """A 32-bit integer hash (xor-shift-multiply rounds) of ``x``, an
    int64 tensor of values in ``[0, 2**32)``. Both multipliers are below
    ``2**31``, so no product leaves int64."""
    x = x ^ (x >> 16)
    x = (x * 0x7FEB352D) & _MASK32
    x = x ^ (x >> 15)
    x = (x * 0x346CA68B) & _MASK32
    return x ^ (x >> 16)


def _keyed_uniform(key, step, shape, device):
    """Uniforms in ``(0, 1)`` of ``shape``, a pure function of ``key``
    (``[2]`` int64, 32-bit words), ``step`` (an int, or a 0-d int64
    tensor in a traced loop) and each element's flat index: tensor ops
    only, so an exported graph takes the key as an input and draws the
    same on any device."""
    s = _mix32((key[1] + (step * 0x9E3779B9)) & _MASK32)
    s = _mix32(key[0] ^ s)
    idx = torch.arange(int(np.prod(shape)), dtype=torch.int64,
                       device=device).reshape(shape)
    h = _mix32((idx * 0x27D4EB2F + s) & _MASK32)
    h = _mix32(h ^ key[1])
    return ((h >> 8).to(torch.float32) + 0.5) * (1.0 / (1 << 24))


def _keyed_pick(logits, key, step, top_k, top_p, temperature):
    """A draw from the filtered distribution of ``logits [B, V]`` by the
    Gumbel-max rule over :func:`_keyed_uniform`'s uniforms: the same
    ``(key, step)`` gives the same tokens, and each is a draw from
    ``softmax(_filter_logits(...))``."""
    u = _keyed_uniform(key, step, tuple(logits.shape), logits.device)
    gumbel = -torch.log(-torch.log(u))
    filtered = _filter_logits(logits, top_k, top_p, temperature)
    return torch.argmax(filtered + gumbel, dim=-1).to(torch.int32)


_SORT_BITS = {torch.float32: torch.int32, torch.float64: torch.int64}


def _beam_topk(cand, k):
    """The ``k`` largest of ``cand [B, N]`` along the last axis in the
    order of ``lax.top_k``: equal values lowest index first (``torch.topk``
    promises no order among ties, and its CUDA order differs from its
    CPU order), over the floats' total order (-0.0 below +0.0, NaN
    above +inf), read from their bits. Returns ``(values, indices)``."""
    ibits = _SORT_BITS[cand.dtype]
    bits = cand.contiguous().view(ibits)
    # negative floats: larger magnitude, smaller key
    key = torch.where(bits < 0, bits ^ torch.iinfo(ibits).max, bits)
    idx = torch.sort(key, dim=-1, descending=True, stable=True)[1][:, :k]
    return cand.gather(-1, idx), idx


def _length_penalty(gen_len, alpha):
    """GNMT ``((5 + len) / 6) ** alpha``; ``alpha`` 0 -> 1."""
    if alpha == 0.0:
        return torch.ones_like(gen_len, dtype=torch.float32)
    return ((5.0 + gen_len.float()) / 6.0) ** alpha


def _beam_search(model, ids, mask, max_new, num_beams, eos, pad,
                 length_penalty):
    """``_build_beam_fn``'s loop, run eagerly: beams live as a flattened
    ``[B * K]`` batch of the same ``decode_step``; the prompt prefills
    once at ``[B]`` and its cache repeats to ``[B * K]``; each step takes
    the ``K`` best of ``[B, K * vocab]`` candidates and reorders the
    cache by parent, gathering into a second buffer that then takes the
    first's place (a gather in place would read rows it already
    overwrote). A finished beam may only continue with ``pad``, at
    log-probability 0. Returns ``(tokens [B, S + max_new], score [B])``:
    the best beam by ``score / length_penalty`` and its summed
    log-probability."""
    gpt = model.gpt if hasattr(model, "gpt") else model
    K, vocab = num_beams, gpt.cfg.vocab_size
    batch, prompt_len = ids.shape
    total_len = prompt_len + max_new
    device = ids.device
    if mask is not None:
        key_valid, real_len = _mask_preamble(mask, batch, max_new)
    else:
        key_valid = real_len = None
    caches = gpt.init_cache(batch, total_len,
                            next(model.parameters()).dtype, device)
    hidden, caches = gpt.prefill(
        ids, caches,
        key_valid=None if key_valid is None else key_valid[:, :prompt_len])
    logp0 = torch.log_softmax(gpt.logits(hidden)[:, 0].float(), dim=-1)
    scores, first = _beam_topk(logp0, K)                       # [B, K]
    caches = tuple(tuple(c.repeat_interleave(K, dim=0) for c in kv)
                   for kv in caches)
    spare = tuple(tuple(torch.empty_like(c) for c in kv) for kv in caches)
    tokens = call_op("concat", [
        ids.to(torch.int32),
        call_op("full", (batch, max_new), pad, dtype=torch.int32,
                device=device)], axis=1)
    tokens = tokens[:, None, :].repeat(1, K, 1)                # [B, K, T]
    tokens[:, :, prompt_len] = first.to(torch.int32)
    finished = (first == eos) if eos is not None else torch.zeros(
        (batch, K), dtype=torch.bool, device=device)
    gen_len = torch.ones((batch, K), dtype=torch.int32, device=device)
    # the only continuation of a finished beam: pad, at log-probability 0
    pad_row = torch.full((vocab,), float("-inf"), device=device)
    pad_row[pad] = 0.0
    base = torch.arange(batch, device=device)[:, None] * K
    for pos in range(prompt_len, total_len - 1):
        # the host reads `finished` only when an eos can end the loop
        if eos is not None and bool(finished.all()):
            break
        tok = tokens[:, :, pos].reshape(batch * K, 1)
        if key_valid is not None:
            kv, positions = _step_mask(key_valid, real_len, prompt_len,
                                       total_len, pos, tile=K)
        else:
            kv = positions = None
        hidden, caches = gpt.decode_step(tok, caches, pos, key_valid=kv,
                                         positions=positions)
        logp = torch.log_softmax(gpt.logits(hidden)[:, 0].float(),
                                 dim=-1).reshape(batch, K, vocab)
        allowed = torch.where(finished[:, :, None], pad_row, logp)
        cand = (scores[:, :, None] + allowed).reshape(batch, K * vocab)
        scores, idx = _beam_topk(cand, K)
        parent = idx // vocab
        nxt = (idx % vocab).to(torch.int32)
        tokens = torch.take_along_dim(tokens, parent[:, :, None], dim=1)
        finished = torch.take_along_dim(finished, parent, dim=1)
        gen_len = torch.take_along_dim(gen_len, parent, dim=1)
        rows = (base + parent).reshape(-1)
        for kv_pair, spare_pair in zip(caches, spare):
            for c, out in zip(kv_pair, spare_pair):
                torch.index_select(c, 0, rows, out=out)
        caches, spare = spare, caches
        tokens[:, :, pos + 1] = nxt
        gen_len = gen_len + (~finished).to(torch.int32)
        if eos is not None:
            finished = finished | (nxt == eos)
    best = torch.argmax(scores / _length_penalty(gen_len, length_penalty),
                        dim=1)                                 # first max
    rows = torch.arange(batch, device=device)
    return tokens[rows, best], scores[rows, best]


class _UnsetType:
    """Per-kwarg sentinel of :func:`generate`: tells 'not passed' from
    'explicitly passed its default', so an explicit kwarg always
    conflicts with ``config=``."""

    def __repr__(self):
        return "<unset>"


_UNSET = _UnsetType()

# signature defaults of generate(), applied when neither the kwarg nor a
# config supplies a value
_GEN_DEFAULTS = {
    "max_new_tokens": 32, "do_sample": False, "temperature": 1.0,
    "top_k": 0, "top_p": 1.0, "eos_token_id": None, "pad_token_id": 0,
    "seed": None, "num_beams": 1, "length_penalty": 0.0,
}


def _check_mask(attention_mask, shape):
    """The left-padded ``attention_mask`` as numpy, or None when it masks
    nothing; raises on a misshapen, right-padded or all-pad mask."""
    m = attention_mask
    if isinstance(m, torch.Tensor):
        m = m.detach().cpu().numpy()
    m = np.asarray(m)
    if m.shape != shape:
        raise ValueError(f"attention_mask shape {m.shape} != input_ids "
                         f"shape {shape}")
    # decode logits come from the LAST prompt column, so real tokens
    # must be right-aligned (left padding, the batched-serve layout)
    if (np.diff(m.astype(np.int8), axis=1) < 0).any():
        raise ValueError(
            "attention_mask must be left-padded (0s then 1s per row)")
    if (m.sum(axis=1) < 1).any():
        raise ValueError("attention_mask has an all-pad row")
    return None if m.all() else m      # all ones: the uniform path


def _resolve(model, passed, config):
    """:func:`generate`'s settings from its keyword arguments ``passed``
    (``_UNSET`` where not given) or ``config``, checked and normalised:
    ``num_beams``, ``max_new``, ``top_k`` (at most the vocabulary),
    ``top_p``, ``temperature``, ``do_sample``, ``seed``, ``eos`` (None or
    an int), ``pad`` and ``length_penalty``."""
    explicit = sorted(k for k, v in passed.items() if v is not _UNSET)
    if config is not None:
        if explicit:
            raise ValueError(
                f"pass either config= or individual kwargs, not both "
                f"(got config plus {explicit})")
        r = {k: getattr(config, k) for k in passed}
    else:
        r = {k: (_GEN_DEFAULTS[k] if v is _UNSET else v)
             for k, v in passed.items()}
    num_beams = int(r["num_beams"])
    if num_beams < 1:
        raise ValueError(f"num_beams must be >= 1, got {num_beams}")
    if num_beams > 1:
        if r["do_sample"]:
            raise ValueError("num_beams > 1 requires do_sample=False "
                             "(deterministic beam search)")
        ignored = [n for n, c in (("temperature", r["temperature"] != 1.0),
                                  ("top_k", r["top_k"] != 0),
                                  ("top_p", r["top_p"] != 1.0),
                                  ("seed", r["seed"] is not None)) if c]
        if ignored:
            raise ValueError(f"{ignored} have no effect with "
                             f"num_beams > 1 (beam search is deterministic)")
    elif r["length_penalty"] != 0.0:
        raise ValueError("length_penalty requires num_beams > 1")
    gpt = model.gpt if hasattr(model, "gpt") else model
    max_new, top_p = int(r["max_new_tokens"]), float(r["top_p"])
    if max_new < 1:
        raise ValueError(f"max_new_tokens must be >= 1, got {max_new}")
    if num_beams > 1 and not 2 <= num_beams <= gpt.cfg.vocab_size:
        raise ValueError(f"num_beams must be in [2, vocab], got {num_beams}")
    if not 0.0 < top_p <= 1.0:
        # top_p=0 would mask EVERY logit and every draw would be token 0
        raise ValueError(f"top_p must be in (0, 1], got {top_p}")
    if int(r["top_k"]) < 0:
        raise ValueError(f"top_k must be >= 0, got {r['top_k']}")
    eos = r["eos_token_id"]
    return dict(num_beams=num_beams, max_new=max_new,
                top_k=min(int(r["top_k"]), gpt.cfg.vocab_size), top_p=top_p,
                temperature=float(r["temperature"]),
                do_sample=bool(r["do_sample"]), seed=r["seed"],
                eos=None if eos is None else int(eos),
                pad=int(r["pad_token_id"]),
                length_penalty=float(r["length_penalty"]))


def _check_total(gpt, total_len):
    if total_len > gpt.cfg.max_position_embeddings:
        raise ValueError(
            f"prompt_len+max_new_tokens={total_len} exceeds "
            f"max_position_embeddings={gpt.cfg.max_position_embeddings}")


def generate(model, input_ids, max_new_tokens=_UNSET, do_sample=_UNSET,
             temperature=_UNSET, top_k=_UNSET, top_p=_UNSET,
             eos_token_id=_UNSET, pad_token_id=_UNSET, seed=_UNSET,
             num_beams=_UNSET, length_penalty=_UNSET,
             attention_mask=None, config=None):
    """Generate ``max_new_tokens`` continuations of ``input_ids [B, S]``.

    Returns an int32 tensor ``[B, S + max_new_tokens]`` on the model's
    device; positions after an ``eos_token_id`` hold ``pad_token_id``.
    Ragged prompts take ``attention_mask [B, S]`` (1 = real token, 0 =
    pad): prompts must be LEFT-padded, so the last column is each row's
    final real token; pads are invisible to attention and to position
    embeddings. A ``GenerationConfig`` may be passed as ``config=``
    instead of the keyword arguments.

    Greedy decoding draws no random number. Sampling draws from a
    ``torch.Generator`` on the model's device, seeded from ``seed``, or,
    without one, the port's generator of that device
    (``paddle_tpu_torch.seed``). ``num_beams > 1`` selects beam search:
    deterministic (no sampling knob may be set), ``length_penalty`` the
    GNMT alpha of the final pick; ragged masks compose with beams.
    """
    r = _resolve(model, {
        "max_new_tokens": max_new_tokens, "do_sample": do_sample,
        "temperature": temperature, "top_k": top_k, "top_p": top_p,
        "eos_token_id": eos_token_id, "pad_token_id": pad_token_id,
        "seed": seed, "num_beams": num_beams,
        "length_penalty": length_penalty,
    }, config)
    gpt = model.gpt if hasattr(model, "gpt") else model
    device = next(model.parameters()).device
    ids = input_ids.detach() if isinstance(input_ids, torch.Tensor) \
        else torch.from_numpy(np.asarray(input_ids))
    ids = ids.to(device=device, dtype=torch.int64)
    if ids.dim() == 1:
        ids = ids[None, :]
    _check_total(gpt, ids.shape[1] + r["max_new"])
    mask = None
    if attention_mask is not None:
        m = _check_mask(attention_mask, tuple(ids.shape))
        if m is not None:
            mask = torch.from_numpy(m.astype(np.int32)).to(device)
    generator = None
    if r["do_sample"]:
        if r["seed"] is None:
            generator = get_generator(device)
        else:
            generator = torch.Generator(device=device)
            generator.manual_seed(int(r["seed"]))
    was_training = model.training
    model.eval()
    try:
        with torch.no_grad():
            if r["num_beams"] > 1:
                return _beam_search(model, ids, mask, r["max_new"],
                                    r["num_beams"], r["eos"], r["pad"],
                                    r["length_penalty"])[0]
            return _decode(model, ids, mask, r["max_new"], r["do_sample"],
                           r["top_k"], r["top_p"], r["temperature"],
                           r["eos"], r["pad"], generator)
    finally:
        if was_training:
            model.train()


# -- the exported serving artifact -----------------------------------------

def _key_words(seed):
    """The two 32-bit words of a non-negative int ``seed``."""
    seed = int(seed)
    if seed < 0:
        raise ValueError(f"seed must be >= 0, got {seed}")
    return [seed & _MASK32, (seed >> 32) & _MASK32]


class _ServedGenerate(Layer):
    """What :func:`save_for_serving` exports: ``model``'s whole decode
    loop at fixed settings, ``ids [B, S] int32 (, key [2]) -> tokens``.
    Its ``training`` flag mirrors the model's, so that ``jit.save`` gives
    the model back in the mode it found it in."""

    def __init__(self, model, settings, key_words):
        super().__init__()
        self.model = model
        self.training = model.training
        self._settings = settings
        self._key_words = key_words

    def forward(self, ids, key=None):
        return _serve_tokens(self.model, ids, key, self._settings,
                             self._key_words)


def _serve_tokens(model, ids, key, r, key_words):
    """The traced body of :class:`_ServedGenerate`: the prompt as ``int64``;
    a sampled loop's key (the runtime input's words kept to 32 bits, or
    the constant ``key_words``)."""
    ids = ids.to(torch.int64)
    if key is not None:
        key = key.to(torch.int64) & _MASK32
    elif r["do_sample"]:
        key = torch.tensor(key_words, dtype=torch.int64, device=ids.device)
    with torch.no_grad():
        if r["num_beams"] > 1:
            return _served_beams(model, ids, r)
        return _served_decode(model, ids, key, r)


def _while(cond, body, carried, state):
    """``torch.while_loop`` traced without TorchDynamo: the loop op
    itself, whose bodies ``torch.export`` records by running them on its
    proxies. ``state`` (the model's parameters and buffers, the key) is
    handed to ``cond`` and ``body`` after the carried tensors, since a
    body may capture no tensor."""
    from torch._higher_order_ops.while_loop import while_loop_op
    return while_loop_op(cond, body, tuple(carried), tuple(state))


def _functional(gpt, step):
    """``(state, run)``: ``gpt``'s parameters and buffers as a tuple, and
    ``run(state, *args)``, which calls ``step(*args)`` with those tensors
    in ``gpt``'s place (``torch.func.functional_call``)."""
    from torch.func import functional_call

    class _Step(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.gpt = gpt

        def forward(self, *args):
            return step(self.gpt, *args)

    mod = _Step()
    named = dict(mod.named_parameters())
    named.update(mod.named_buffers())
    names = tuple(named)

    def run(state, *args):
        return functional_call(mod, dict(zip(names, state)), args,
                               tie_weights=False, strict=True)

    return tuple(named.values()), run


def _served_decode(model, ids, key, r):
    """:func:`_decode` as one ``while_loop`` over the decode steps
    (:meth:`GPTModel.decode_step_at`), with the position, the tokens,
    the finished rows and the caches carried: the prefill and the first
    token, then a step a token while a row is unfinished and the budget
    lasts. Sampled tokens are :func:`_keyed_pick`'s."""
    gpt = model.gpt if hasattr(model, "gpt") else model
    batch, prompt_len = ids.shape
    total_len = prompt_len + r["max_new"]
    device, n_cache = ids.device, 2 * gpt.cfg.num_hidden_layers
    eos, pad = r["eos"], r["pad"]
    caches = gpt.init_cache(batch, total_len,
                            next(model.parameters()).dtype, device)

    def pick(g, hidden, step, key):
        logits = g.logits(hidden)[:, 0].float()
        if not r["do_sample"]:
            return torch.argmax(logits, dim=-1).to(torch.int32)
        temp = torch.full((), r["temperature"], device=logits.device)
        return _keyed_pick(logits, key, step, r["top_k"], r["top_p"], temp)

    hidden, caches = gpt.prefill(ids, caches)
    first = pick(gpt, hidden, prompt_len, key)
    tokens = torch.cat([ids.to(torch.int32), torch.full(
        (batch, r["max_new"]), pad, dtype=torch.int32, device=device)], 1)
    tokens[:, prompt_len] = first
    finished = first == eos if eos is not None else torch.zeros(
        batch, dtype=torch.bool, device=device)
    if r["max_new"] == 1:
        return tokens
    keyed = () if key is None else (key,)

    def step(g, pos, tokens, finished, flat, key):
        caches = tuple(zip(flat[0::2], flat[1::2]))
        tok = tokens.index_select(1, pos.reshape(1)).to(torch.int64)
        hidden, caches = g.decode_step_at(tok, caches, pos)
        nxt = pick(g, hidden, pos + 1, key)
        if eos is not None:
            nxt = torch.where(finished, pad, nxt)
            finished = finished | (nxt == eos)
        tokens = tokens.index_copy(1, (pos + 1).reshape(1), nxt[:, None])
        return (pos + 1, tokens, finished) + tuple(
            c for kv in caches for c in kv)

    state, run = _functional(gpt, step)

    def cond(pos, tokens, finished, *rest):
        going = pos < total_len - 1
        return going & ~finished.all() if eos is not None else going

    def body(pos, tokens, finished, *rest):
        flat, extra = rest[:n_cache], rest[n_cache:]
        key = extra[0] if keyed else None
        return run(extra[len(keyed):], pos, tokens, finished, flat, key)

    pos = torch.full((), prompt_len, dtype=torch.int64, device=device)
    out = _while(cond, body, (pos, tokens, finished) + tuple(
        c for kv in caches for c in kv), keyed + state)
    return out[1]


def _served_beams(model, ids, r):
    """:func:`_beam_search` as one ``while_loop`` (no mask): the prefill
    at ``[B]`` and the first ``K`` beams, then a step over the flattened
    ``[B * K]`` rows while a beam is unfinished and the budget lasts,
    the caches reordered by parent out of place. Returns the best beam's
    tokens."""
    gpt = model.gpt if hasattr(model, "gpt") else model
    K, vocab = r["num_beams"], gpt.cfg.vocab_size
    batch, prompt_len = ids.shape
    total_len = prompt_len + r["max_new"]
    device, n_cache = ids.device, 2 * gpt.cfg.num_hidden_layers
    eos, pad = r["eos"], r["pad"]
    caches = gpt.init_cache(batch, total_len,
                            next(model.parameters()).dtype, device)
    hidden, caches = gpt.prefill(ids, caches)
    logp0 = torch.log_softmax(gpt.logits(hidden)[:, 0].float(), dim=-1)
    scores, first = _beam_topk(logp0, K)                       # [B, K]
    tokens = torch.cat([ids.to(torch.int32), torch.full(
        (batch, r["max_new"]), pad, dtype=torch.int32, device=device)], 1)
    tokens = tokens[:, None, :].repeat(1, K, 1)                # [B, K, T]
    tokens[:, :, prompt_len] = first.to(torch.int32)
    finished = (first == eos) if eos is not None else torch.zeros(
        (batch, K), dtype=torch.bool, device=device)
    gen_len = torch.ones((batch, K), dtype=torch.int32, device=device)
    flat = tuple(c.repeat_interleave(K, dim=0) for kv in caches for c in kv)

    def step(g, pos, tokens, scores, finished, gen_len, flat):
        caches = tuple(zip(flat[0::2], flat[1::2]))
        tok = tokens.index_select(2, pos.reshape(1)).reshape(
            batch * K, 1).to(torch.int64)
        hidden, caches = g.decode_step_at(tok, caches, pos)
        logp = torch.log_softmax(g.logits(hidden)[:, 0].float(),
                                 dim=-1).reshape(batch, K, vocab)
        # the only continuation of a finished beam: pad, at log-prob 0
        pad_row = torch.where(
            torch.arange(vocab, device=logp.device) == pad, 0.0,
            float("-inf"))
        allowed = torch.where(finished[:, :, None], pad_row, logp)
        cand = (scores[:, :, None] + allowed).reshape(batch, K * vocab)
        scores, idx = _beam_topk(cand, K)
        parent = idx // vocab
        nxt = (idx % vocab).to(torch.int32)
        tokens = torch.take_along_dim(tokens, parent[:, :, None], dim=1)
        finished = torch.take_along_dim(finished, parent, dim=1)
        gen_len = torch.take_along_dim(gen_len, parent, dim=1)
        base = torch.arange(batch, device=logp.device)[:, None] * K
        rows = (base + parent).reshape(-1)
        tokens = tokens.index_copy(2, (pos + 1).reshape(1), nxt[:, :, None])
        gen_len = gen_len + (~finished).to(torch.int32)
        if eos is not None:
            finished = finished | (nxt == eos)
        return (pos + 1, tokens, scores, finished, gen_len) + tuple(
            c.index_select(0, rows) for kv in caches for c in kv)

    state, run = _functional(gpt, step)

    def cond(pos, tokens, scores, finished, gen_len, *rest):
        going = pos < total_len - 1
        return going & ~finished.all() if eos is not None else going

    def body(pos, tokens, scores, finished, gen_len, *rest):
        return run(rest[n_cache:], pos, tokens, scores, finished, gen_len,
                   rest[:n_cache])

    pos = torch.full((), prompt_len, dtype=torch.int64, device=device)
    _, tokens, scores, finished, gen_len, *_ = _while(
        cond, body, (pos, tokens, scores, finished, gen_len) + flat, state)
    best = torch.argmax(
        scores / _length_penalty(gen_len, r["length_penalty"]), dim=1)
    return tokens[torch.arange(batch, device=device), best]


def save_for_serving(model, path, batch, prompt_len, runtime_key=False,
                     **generate_kwargs):
    """Export the whole :func:`generate` loop of ``model`` as a
    ``jit.save`` artifact serving ``ids [batch, prompt_len] int32 ->
    tokens [batch, prompt_len + max_new_tokens] int32``, loaded by
    ``jit.load`` and ``inference.create_predictor`` with no model code.
    The settings (``generate``'s keyword arguments, or ``config=``) are
    fixed in the artifact, and so are the shapes.

    The graph holds the prefill and one ``while_loop`` whose body is one
    decode step, with the position, the tokens, the finished rows and
    the caches carried (each step writes its cache rows into new
    tensors); it stops when the budget is spent or, with
    ``eos_token_id``, every row has finished, as :func:`generate` does,
    so greedy and beam artifacts give ``generate``'s tokens. The
    LayerNorm and flash attention kernels are in the graph as their
    custom ops, so the loaded program launches them on the card.

    Sampling draws by the Gumbel-max rule over a counter-based hash
    (:func:`_keyed_pick`) computed inside the graph. With
    ``runtime_key=True`` the key is a second input, ``key [2]``: two
    32-bit words (a uint32 array, cast to int64 by the loader);
    the same key gives the same tokens, another key other tokens. This
    requires ``do_sample=True``, no ``seed`` and ``num_beams == 1``, and
    takes only ``generate``'s settings. Without it a sampled export needs
    an explicit ``seed``, whose two 32-bit words become the constant key:
    the artifact then draws the same tokens for a prompt on every call
    (not the tokens of ``generate(seed=)``, whose draws come from a
    ``torch.Generator``)."""
    from .. import jit
    from ..static import InputSpec

    if runtime_key:
        unknown = sorted(set(generate_kwargs) - set(_GEN_DEFAULTS))
        if unknown:
            raise ValueError(
                f"runtime_key export got unsupported kwargs: {unknown}")
        resolved = dict(_GEN_DEFAULTS)
        resolved.update(generate_kwargs)
        if not resolved["do_sample"]:
            raise ValueError(
                "runtime_key=True requires do_sample=True: a greedy "
                "export never consumes the key, so a key input would "
                "be dead weight in the artifact's signature")
        if resolved["seed"] is not None:
            raise ValueError(
                "runtime_key=True replaces seed=: the key arrives per "
                "call at serve time")
        if resolved["num_beams"] != 1:
            raise ValueError("runtime_key=True requires num_beams=1 "
                             "(beam search is deterministic)")
    elif generate_kwargs.get("do_sample") and \
            generate_kwargs.get("seed") is None:
        raise ValueError(
            "save_for_serving(do_sample=True) requires an explicit seed "
            "(or runtime_key=True for per-request draws): the key is "
            "baked into the artifact as a constant, so the export "
            "freezes ONE draw per prompt; make that choice explicit")
    config = generate_kwargs.pop("config", None)
    unknown = sorted(set(generate_kwargs) - set(_GEN_DEFAULTS))
    if unknown:
        raise TypeError(f"save_for_serving() got unexpected keyword "
                        f"arguments {unknown} (the artifact takes no mask: "
                        f"its prompts are all {prompt_len} tokens)")
    passed = dict.fromkeys(_GEN_DEFAULTS, _UNSET)
    passed.update(generate_kwargs)
    r = _resolve(model, passed, config)
    if config is not None and config.do_sample and config.seed is None:
        raise ValueError(
            "save_for_serving(config=) with do_sample requires an "
            "explicit seed (or runtime_key=True for per-request draws)")
    gpt = model.gpt if hasattr(model, "gpt") else model
    batch, prompt_len = int(batch), int(prompt_len)
    _check_total(gpt, prompt_len + r["max_new"])
    key_words = None if runtime_key or not r["do_sample"] \
        else _key_words(r["seed"])
    specs = [InputSpec([batch, prompt_len], "int32")]
    if runtime_key:
        # the key's two uint32 words arrive as int64 (the loader casts a
        # uint32 array): not every torch.export serializer takes uint32
        specs.append(InputSpec([2], "int64"))
    return jit.save(_ServedGenerate(model, r, key_words), path,
                    input_spec=specs)


#: the JAX module's names the port has not taken yet, by ROADMAP Queue 1
#: item: tensor-parallel serving (4)
_DEFERRED = {"shard_params_megatron": 4,
             "megatron_param_specs": 4, "build_sharded_paged_prefill_fn": 4,
             "build_sharded_paged_decode_fn": 4,
             "build_sharded_fused_step_fn": 4}


def __getattr__(name):
    if name in _DEFERRED:
        from ..ops.registry import not_ported
        raise not_ported(f"models.generation.{name}", _DEFERRED[name])
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
