"""The fused ragged serving step (counterpart of the fused path of
``paddle_tpu/models/generation.py``): one launch advances a RAGGED batch
of mixed prefill-chunk and decode rows through every layer, with the
ragged paged attention kernel walking each sequence's page table in the
block pool.

There is no jit and no donation: :func:`build_fused_step_fn` returns a
plain function that runs eagerly and updates the pool (and a quantized
pool's scales) IN PLACE, where the JAX step donated the buffers and
returned new ones. Sampling draws from an explicit ``torch.Generator`` in
place of ``jax.random`` keys.
"""
from __future__ import annotations

import torch

from ..ops.ragged_paged_attention import BLOCK_Q, ragged_paged_attention

__all__ = ["build_fused_step_fn"]


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
                        top_k=0, top_p=1.0, quantized=False, qmax=127.0):
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
    thread.
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
            logits = gpt.logits(last[:, None, :])[:, 0].float()
            greedy = _pick_token(logits, generator, False, top_k, top_p,
                                 None)
            sampled = _pick_token(logits, generator, True, top_k, top_p,
                                  temperature[:, None])
            nxt = torch.where(sample_mask, sampled, greedy)
            return _append_nonfinite_flag(nxt, logits)

    return fn
