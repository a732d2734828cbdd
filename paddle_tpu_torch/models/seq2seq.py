"""The encoder-decoder translation model (counterpart of
``paddle_tpu/models/seq2seq.py``): ``TransformerModel``, token
embeddings scaled by sqrt(d_model), a sinusoid position table kept as a
buffer, ``nn.Transformer`` and an output projection.

Teacher forcing masks the source pads (a ``[B, 1, 1, S]`` boolean mask,
True keeps) and the target causally, so every attention carries a mask
and runs the op's plain body; the LayerNorms run the fused LayerNorm
kernels on the card. ``generate`` decodes greedily or with beams
(:mod:`.seq2seq_decode`): the encoder once, the cross-attention keys and
values once a layer, and fixed ``[B, max_len, H, D]`` self-attention
caches written in place a step.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import nn
from ..framework.dispatch import call_op
from ..nn import functional as F

__all__ = ["TransformerModel"]


def _sinusoid_table(max_len, d_model):
    pos = np.arange(max_len)[:, None].astype("float32")
    dim = np.arange(0, d_model, 2).astype("float32")
    angle = pos / np.power(10000.0, dim / d_model)
    table = np.zeros((max_len, d_model), "float32")
    table[:, 0::2] = np.sin(angle)
    table[:, 1::2] = np.cos(angle)
    return table


class TransformerModel(nn.Layer):
    """A Transformer MT model: embeddings scaled by sqrt(d_model),
    sinusoidal positions, ``nn.Transformer``, an output ``Linear``."""

    def __init__(self, src_vocab_size, tgt_vocab_size, d_model=512,
                 nhead=8, num_encoder_layers=6, num_decoder_layers=6,
                 dim_feedforward=2048, dropout=0.1, max_length=256,
                 bos_id=0, eos_id=1, pad_id=0):
        super().__init__()
        self.d_model = d_model
        self.max_length = max_length
        self.bos_id, self.eos_id, self.pad_id = bos_id, eos_id, pad_id
        self.src_embed = nn.Embedding(src_vocab_size, d_model)
        self.tgt_embed = nn.Embedding(tgt_vocab_size, d_model)
        self.register_buffer(
            "pos_table", torch.from_numpy(_sinusoid_table(max_length,
                                                          d_model)))
        self.transformer = nn.Transformer(
            d_model=d_model, nhead=nhead,
            num_encoder_layers=num_encoder_layers,
            num_decoder_layers=num_decoder_layers,
            dim_feedforward=dim_feedforward, dropout=dropout)
        self.out_proj = nn.Linear(d_model, tgt_vocab_size)

    def _embed(self, table, ids, pos_offset=0):
        """``table(ids) * sqrt(d_model)`` plus the positions from
        ``pos_offset`` on."""
        seq = ids.shape[1]
        if pos_offset + seq > self.max_length:
            raise ValueError(
                f"sequence length {pos_offset + seq} exceeds the model's "
                f"positional table (max_length={self.max_length})")
        x = table(ids) * (self.d_model ** 0.5)
        pe = self.pos_table[pos_offset:pos_offset + seq]
        return x + pe[None].to(x.dtype)

    @staticmethod
    def _src_key_mask(src, pad_id):
        """``[B, 1, 1, S]`` bool: True where the source token is no
        pad."""
        return (src != pad_id)[:, None, None, :]

    def _as_ids(self, ids):
        return torch.as_tensor(ids, device=self.pos_table.device)

    def forward(self, src, tgt):
        """Teacher-forcing logits ``[B, T, V]``: source pads masked, the
        target causal."""
        src, tgt = self._as_ids(src), self._as_ids(tgt)
        smask = self._src_key_mask(src, self.pad_id)
        steps = tgt.shape[1]
        causal = torch.ones((steps, steps), dtype=torch.bool,
                            device=tgt.device).tril()[None, None]
        mem = self.transformer.encoder(
            self._embed(self.src_embed, src), src_mask=smask)
        out = self.transformer.decoder(
            self._embed(self.tgt_embed, tgt), mem, tgt_mask=causal,
            memory_mask=smask)
        return self.out_proj(out)

    # -- the decode steps (seq2seq_decode.py) -------------------------------
    def _decoder_prefill(self, mem, batch, max_len, dtype):
        """Per decoder layer: the zeroed self-attention K/V caches ``[B,
        max_len, H, D]`` and the cross-attention K/V of the memory,
        computed once. Only the caches are reordered between beams."""
        caches, mem_kv = [], []
        for layer in self.transformer.decoder.layers:
            a = layer.self_attn
            shape = (batch, max_len, a.num_heads, a.head_dim)
            caches.append((torch.zeros(shape, dtype=dtype, device=mem.device),
                           torch.zeros(shape, dtype=dtype, device=mem.device)))
            c = layer.cross_attn
            mem_kv.append((c._split_heads(c.k_proj(mem)),
                           c._split_heads(c.v_proj(mem))))
        return caches, mem_kv

    def _decoder_step(self, x, caches, mem_kv, pos, smask):
        """One target token ``x [B, 1, E]`` at slot ``pos`` through every
        decoder layer (pre- or post-norm as the layer is built), its keys
        and values written into the caches in place. Returns the hidden
        state ``[B, 1, E]``."""
        dec = self.transformer.decoder
        valid = (torch.arange(caches[0][0].shape[1], device=x.device)
                 <= pos)[None, None, None, :]
        out = x
        for layer, (ck, cv), (mk, mv) in zip(dec.layers, caches, mem_kv):
            residual = out
            h = layer.norm1(out) if layer.normalize_before else out
            a = layer.self_attn
            q = a._split_heads(a.q_proj(h))
            ck[:, pos] = a._split_heads(a.k_proj(h))[:, 0].to(ck.dtype)
            cv[:, pos] = a._split_heads(a.v_proj(h))[:, 0].to(cv.dtype)
            sa = F.scaled_dot_product_attention(q, ck, cv, attn_mask=valid)
            out = residual + a.out_proj(a._merge_heads(sa))
            if not layer.normalize_before:
                out = layer.norm1(out)
            residual = out
            h = layer.norm2(out) if layer.normalize_before else out
            c = layer.cross_attn
            ca = F.scaled_dot_product_attention(
                c._split_heads(c.q_proj(h)), mk, mv, attn_mask=smask)
            out = residual + c.out_proj(c._merge_heads(ca))
            if not layer.normalize_before:
                out = layer.norm2(out)
            residual = out
            h = layer.norm3(out) if layer.normalize_before else out
            out = residual + layer.linear2(
                call_op(layer.activation, layer.linear1(h)))
            if not layer.normalize_before:
                out = layer.norm3(out)
        if dec.norm is not None:
            out = dec.norm(out)
        return out

    def generate(self, src, max_length=None, num_beams=1,
                 length_penalty=0.0):
        """Translate ``src``: the encoder once, then a decode from
        ``bos_id`` until ``eos_id`` or the length budget, greedy
        (``num_beams=1``) or beam search. Returns ``[B, max_length]``
        int32 tokens, pads after EOS."""
        from .seq2seq_decode import run_generate
        return run_generate(self, src, max_length, num_beams,
                            length_penalty)
