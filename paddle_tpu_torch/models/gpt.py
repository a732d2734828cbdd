"""GPT-2 decoder-only language model (counterpart of
``paddle_tpu/models/gpt.py``): pre-LN blocks, GELU with the tanh
approximation, the LM head tied to the token embedding.

Module and parameter names are the JAX package's (``gpt.wte``,
``gpt.blocks.<i>.attn.q_proj``, ``gpt.blocks.<i>.mlp_fc``, ...), so a
JAX parameter tree maps onto ``state_dict()`` key for key
(``paddle_tpu_torch.convert``). Weights are initialised like the JAX
model's (normal embeddings at ``initializer_range``, Xavier-uniform
linear weights, zero biases) from PyTorch's global generator, so
``torch.manual_seed`` makes a model reproducible.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn
from torch.nn import functional as F

from ..nn.layer.norm import LayerNorm
from ..nn.layer.transformer import MultiHeadAttention, causal_attention

__all__ = ["GPTConfig", "GPTBlock", "GPTModel", "GPTForPretraining"]


@dataclass
class GPTConfig:
    vocab_size: int = 50304          # 50257 padded to a multiple of 128
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 1024
    hidden_dropout_prob: float = 0.1
    attention_dropout_prob: float = 0.1
    initializer_range: float = 0.02

    @classmethod
    def gpt2_small(cls):  # 124M
        return cls()

    @classmethod
    def tiny(cls):  # for tests
        return cls(vocab_size=256, hidden_size=64, num_hidden_layers=2,
                   num_attention_heads=4, intermediate_size=128,
                   max_position_embeddings=64, hidden_dropout_prob=0.0,
                   attention_dropout_prob=0.0)


class GPTBlock(nn.Module):
    def __init__(self, cfg: GPTConfig):
        super().__init__()
        h = cfg.hidden_size
        self.ln_1 = LayerNorm(h)
        self.attn = MultiHeadAttention(h, cfg.num_attention_heads,
                                       dropout=cfg.attention_dropout_prob)
        self.ln_2 = LayerNorm(h)
        self.mlp_fc = nn.Linear(h, cfg.intermediate_size)
        self.mlp_proj = nn.Linear(cfg.intermediate_size, h)
        self.dropout = nn.Dropout(cfg.hidden_dropout_prob)

    def _qkv(self, x):
        """ln_1 + split-head q/k/v projections, each ``[B, L, H, D]``
        (shared by the forward and the serving step)."""
        h = self.ln_1(x)
        q = self.attn._split_heads(self.attn.q_proj(h))
        k = self.attn._split_heads(self.attn.k_proj(h))
        v = self.attn._split_heads(self.attn.v_proj(h))
        return q, k, v

    def _tail(self, x, a):
        """out-proj + residual + MLP half of the block (shared)."""
        a = self.attn.out_proj(self.attn._merge_heads(a))
        x = x + self.dropout(a)
        m = self.mlp_proj(F.gelu(self.mlp_fc(self.ln_2(x)),
                                 approximate="tanh"))
        return x + self.dropout(m)

    def forward(self, x):
        q, k, v = self._qkv(x)
        return self._tail(x, causal_attention(q, k, v))


class GPTModel(nn.Module):
    def __init__(self, cfg: GPTConfig):
        super().__init__()
        self.cfg = cfg
        self.wte = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.wpe = nn.Embedding(cfg.max_position_embeddings, cfg.hidden_size)
        self.drop = nn.Dropout(cfg.hidden_dropout_prob)
        self.blocks = nn.ModuleList(
            [GPTBlock(cfg) for _ in range(cfg.num_hidden_layers)])
        self.ln_f = LayerNorm(cfg.hidden_size)
        self._init_weights()

    @torch.no_grad()
    def _init_weights(self):
        for emb in (self.wte, self.wpe):
            emb.weight.normal_(0.0, self.cfg.initializer_range)
        for mod in self.blocks.modules():
            if isinstance(mod, nn.Linear):
                nn.init.xavier_uniform_(mod.weight)
                mod.bias.zero_()

    def forward(self, input_ids, position_ids=None):
        if position_ids is None:
            position_ids = torch.arange(input_ids.shape[1],
                                        device=input_ids.device)[None, :]
        x = self.drop(self.wte(input_ids) + self.wpe(position_ids))
        for block in self.blocks:
            x = block(x)
        return self.ln_f(x)

    def logits(self, hidden):
        """LM head tied to wte (a plain product with the embedding
        table)."""
        return torch.matmul(hidden, self.wte.weight.t())


class GPTForPretraining(nn.Module):
    """GPT with the tied-embedding LM head. ``forward`` returns the
    logits ``[B, S, V]``; the loss path belongs to the training slice,
    which ROADMAP.md queues."""

    def __init__(self, cfg: GPTConfig):
        super().__init__()
        self.gpt = GPTModel(cfg)

    def forward(self, input_ids, labels=None, position_ids=None):
        if labels is not None:
            raise NotImplementedError(
                "the LM loss is part of the training slice of the port "
                "(ROADMAP.md, queued): call without labels for logits")
        return self.gpt.logits(self.gpt(input_ids, position_ids))
