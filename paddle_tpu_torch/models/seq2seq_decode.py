"""The decode loops of ``TransformerModel`` (counterpart of
``paddle_tpu/models/seq2seq_decode.py``), greedy and flattened-beam.

The JAX package compiles one program around a ``lax.while_loop``; here
the same recurrence runs as an eager loop on the model's device: the
encoder once, the cross-attention keys and values once a layer, fixed
``[B, max_len, H, D]`` self-attention caches written in place, decode
from BOS. The masks and every per-step index are made on the device, so
the one host read a step is the loop's test that every row (beam) has
finished, the test the JAX ``while_loop`` makes. Beams are a ``[B * K]``
batch; ties among the candidates are broken as ``lax.top_k`` breaks them
(lowest index first), and the best beam by ``scores / ((5 + len) / 6)
** length_penalty``.
"""
from __future__ import annotations

import torch

from .generation import _beam_topk, _length_penalty

__all__ = ["run_generate"]


def _encode(model, src):
    smask = model._src_key_mask(src, model.pad_id)
    mem = model.transformer.encoder(
        model._embed(model.src_embed, src), src_mask=smask)
    return mem, smask


def _logits(model, hidden):
    return model.out_proj(hidden)[:, 0].float()


def _greedy(model, src, max_len):
    batch = src.shape[0]
    bos, eos, pad = model.bos_id, model.eos_id, model.pad_id
    mem, smask = _encode(model, src)
    caches, mem_kv = model._decoder_prefill(mem, batch, max_len, mem.dtype)
    tokens = torch.full((batch, max_len), pad, dtype=torch.int32,
                        device=src.device)
    tokens[:, 0] = bos
    finished = torch.zeros((batch,), dtype=torch.bool, device=src.device)
    pos = 0
    while pos < max_len - 1 and not bool(finished.all()):
        x = model._embed(model.tgt_embed, tokens[:, pos:pos + 1],
                         pos_offset=pos)
        hidden = model._decoder_step(x, caches, mem_kv, pos, smask)
        nxt = torch.argmax(_logits(model, hidden), dim=-1).to(torch.int32)
        nxt = torch.where(finished, torch.full_like(nxt, pad), nxt)
        finished = finished | (nxt == eos)
        tokens[:, pos + 1] = nxt
        pos += 1
    return tokens


def _beam(model, src, max_len, k, alpha):
    batch = src.shape[0]
    bos, eos, pad = model.bos_id, model.eos_id, model.pad_id
    dev = src.device
    mem, smask = _encode(model, src)
    caches, mem_kv = model._decoder_prefill(mem, batch, max_len, mem.dtype)
    # beams flattened into the batch: the memory's K/V and the source mask
    # repeat once and never reorder; the self-attention caches follow
    # their beam's parent every step
    caches = [(ck.repeat_interleave(k, 0), cv.repeat_interleave(k, 0))
              for ck, cv in caches]
    mem_kv = [(mk.repeat_interleave(k, 0), mv.repeat_interleave(k, 0))
              for mk, mv in mem_kv]
    smask = smask.repeat_interleave(k, 0)
    vocab = model.out_proj.weight.shape[0]
    tokens = torch.full((batch, k, max_len), pad, dtype=torch.int32,
                        device=dev)
    tokens[:, :, 0] = bos
    # beam 0 live, the rest at -inf so the first expansion draws K
    # distinct tokens from beam 0
    scores = torch.full((batch, k), -float("inf"), dtype=torch.float32,
                        device=dev)
    scores[:, 0] = 0.0
    finished = torch.zeros((batch, k), dtype=torch.bool, device=dev)
    gen_len = torch.zeros((batch, k), dtype=torch.int32, device=dev)
    pad_row = torch.full((vocab,), -float("inf"), dtype=torch.float32,
                         device=dev)
    pad_row[pad] = 0.0
    base = torch.arange(batch, device=dev)[:, None] * k
    pos = 0
    while pos < max_len - 1 and not bool(finished.all()):
        tok = tokens[:, :, pos].reshape(batch * k, 1)
        x = model._embed(model.tgt_embed, tok, pos_offset=pos)
        hidden = model._decoder_step(x, caches, mem_kv, pos, smask)
        logp = torch.log_softmax(_logits(model, hidden), dim=-1).reshape(
            batch, k, vocab)
        allowed = torch.where(finished[:, :, None], pad_row, logp)
        scores, idx = _beam_topk(
            (scores[:, :, None] + allowed).reshape(batch, k * vocab), k)
        parent = idx // vocab
        nxt = (idx % vocab).to(torch.int32)
        tokens = torch.gather(tokens, 1,
                              parent[:, :, None].expand(-1, -1, max_len))
        finished = torch.gather(finished, 1, parent)
        gen_len = torch.gather(gen_len, 1, parent)
        fp = (base + parent).reshape(-1)
        caches = [(ck.index_select(0, fp), cv.index_select(0, fp))
                  for ck, cv in caches]
        tokens[:, :, pos + 1] = nxt
        gen_len = gen_len + (~finished).to(torch.int32)
        finished = finished | (nxt == eos)
        pos += 1
    best = torch.argmax(scores / _length_penalty(gen_len, alpha), dim=1)
    return torch.gather(
        tokens, 1, best[:, None, None].expand(-1, 1, max_len))[:, 0]


def run_generate(model, src, max_length=None, num_beams=1,
                 length_penalty=0.0):
    """``model.generate``: ``src [B, S]`` (or ``[S]``) ids to ``[B,
    max_length]`` int32 tokens on the model's device, in eval mode
    without grad."""
    if num_beams < 1:
        raise ValueError(f"num_beams must be >= 1, got {num_beams}")
    ids = model._as_ids(src)
    if ids.dim() == 1:
        ids = ids[None, :]
    max_len = int(max_length if max_length is not None else
                  model.max_length)
    if num_beams == 1 and length_penalty != 0.0:
        raise ValueError("length_penalty requires num_beams > 1")
    if max_len < 2:
        raise ValueError(f"max_length must be >= 2, got {max_len}")
    if max_len > model.max_length:
        raise ValueError(
            f"max_length={max_len} exceeds the model's positional table "
            f"({model.max_length})")
    was_training = model.training
    model.eval()
    try:
        with torch.no_grad():
            if num_beams == 1:
                return _greedy(model, ids, max_len)
            return _beam(model, ids, max_len, int(num_beams),
                         float(length_penalty))
    finally:
        if was_training:
            model.train()
