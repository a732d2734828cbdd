"""Decoding (counterpart of ``paddle_tpu/models/generation.py``): the
static-cache :func:`generate` and the fused ragged serving step.

:func:`generate` decodes a batch of prompts through ``GPTModel.prefill``
and ``decode_step`` over a fixed per-layer K/V cache, greedily or by
sampling. The JAX package compiles that loop into one program
(``lax.while_loop``) and caches it per shape; here it is a Python loop
that runs eagerly and stops when every row is finished, with no compile
cache.

The fused step (:func:`build_fused_step_fn`) advances a RAGGED batch of
mixed prefill-chunk and decode rows through every layer in one call, with
the ragged paged attention kernel walking each sequence's page table in
the block pool. There is no jit and no donation: it runs eagerly and
updates the pool (and a quantized pool's scales) IN PLACE, where the JAX
step donated the buffers and returned new ones.

Sampling draws from an explicit ``torch.Generator`` in place of
``jax.random`` keys.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..framework.dispatch import call_op
from ..framework.random import get_generator
from ..ops.ragged_paged_attention import BLOCK_Q, ragged_paged_attention

__all__ = ["GenerationConfig", "generate", "build_fused_step_fn"]


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
    num_beams: int = 1        # >1 = beam search (not ported yet)
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


def _step_mask(key_valid, real_len, prompt_len, total_len, pos):
    """Key validity of decode step ``pos`` (the prompt mask, and the
    generated rows up to ``pos``) and each row's logical position."""
    r = call_op("arange", total_len, device=key_valid.device)
    kv = key_valid | ((r >= prompt_len) & (r <= pos))[None, :]
    return kv, real_len + (pos - prompt_len)


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
    (``paddle_tpu_torch.seed``). ``num_beams > 1`` (beam search) is not
    ported yet and raises.
    """
    passed = {
        "max_new_tokens": max_new_tokens, "do_sample": do_sample,
        "temperature": temperature, "top_k": top_k, "top_p": top_p,
        "eos_token_id": eos_token_id, "pad_token_id": pad_token_id,
        "seed": seed, "num_beams": num_beams,
        "length_penalty": length_penalty,
    }
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
    if r["num_beams"] < 1:
        raise ValueError(f"num_beams must be >= 1, got {r['num_beams']}")
    if r["num_beams"] > 1:
        raise NotImplementedError(
            "beam search (num_beams > 1) is not ported yet: ROADMAP.md "
            "Queue 1 item 2")
    if r["length_penalty"] != 0.0:
        raise ValueError("length_penalty requires num_beams > 1")
    gpt = model.gpt if hasattr(model, "gpt") else model
    max_new, top_p = int(r["max_new_tokens"]), float(r["top_p"])
    if max_new < 1:
        raise ValueError(f"max_new_tokens must be >= 1, got {max_new}")
    if not 0.0 < top_p <= 1.0:
        # top_p=0 would mask EVERY logit and every draw would be token 0
        raise ValueError(f"top_p must be in (0, 1], got {top_p}")
    if int(r["top_k"]) < 0:
        raise ValueError(f"top_k must be >= 0, got {r['top_k']}")
    top_k = min(int(r["top_k"]), gpt.cfg.vocab_size)

    device = next(model.parameters()).device
    ids = input_ids.detach() if isinstance(input_ids, torch.Tensor) \
        else torch.from_numpy(np.asarray(input_ids))
    ids = ids.to(device=device, dtype=torch.int64)
    if ids.dim() == 1:
        ids = ids[None, :]
    total_len = ids.shape[1] + max_new
    if total_len > gpt.cfg.max_position_embeddings:
        raise ValueError(
            f"prompt_len+max_new_tokens={total_len} exceeds "
            f"max_position_embeddings={gpt.cfg.max_position_embeddings}")
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
    eos = r["eos_token_id"]
    was_training = model.training
    model.eval()
    try:
        with torch.no_grad():
            return _decode(model, ids, mask, max_new, bool(r["do_sample"]),
                           top_k, top_p, float(r["temperature"]),
                           None if eos is None else int(eos),
                           int(r["pad_token_id"]), generator)
    finally:
        if was_training:
            model.train()
