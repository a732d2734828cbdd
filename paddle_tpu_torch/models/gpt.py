"""GPT-2 decoder-only language model (counterpart of
``paddle_tpu/models/gpt.py``): pre-LN blocks, GELU with the tanh
approximation, the LM head tied to the token embedding.

Module and parameter names are the JAX package's (``gpt.wte``,
``gpt.blocks.<i>.attn.q_proj``, ``gpt.blocks.<i>.mlp_fc``, ...), so a
JAX parameter tree maps onto ``state_dict()`` key for key
(``paddle_tpu_torch.convert``). Weights are initialised like the JAX
model's (normal embeddings at ``initializer_range``, Xavier-uniform
linear weights, zero biases) from the port's CPU generator, so
``paddle_tpu_torch.seed`` makes a model reproducible.

Attention is ``nn.functional.scaled_dot_product_attention`` (causal):
the flash attention kernels with dropout off, the plain composition
with attention dropout on, as the JAX package routes it.
``GPTForPretraining`` carries the causal-LM loss, dense or chunked over
the sequence (:func:`chunked_lm_loss`).
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn
from torch.nn import functional as TF
from torch.utils.checkpoint import checkpoint

from .. import amp
from ..framework.random import get_generator
from ..nn import functional as F
from ..nn.layer.common import Dropout, Linear
from ..nn.layer.norm import LayerNorm
from ..nn.layer.transformer import MultiHeadAttention

__all__ = ["GPTConfig", "GPTBlock", "GPTModel", "GPTForPretraining",
           "chunked_lm_loss"]


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
        self.mlp_fc = Linear(h, cfg.intermediate_size)
        self.mlp_proj = Linear(cfg.intermediate_size, h)
        self.dropout = Dropout(cfg.hidden_dropout_prob)

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
        m = self.mlp_proj(TF.gelu(self.mlp_fc(self.ln_2(x)),
                                  approximate="tanh"))
        return x + self.dropout(m)

    def forward(self, x):
        q, k, v = self._qkv(x)
        a = F.scaled_dot_product_attention(
            q, k, v, is_causal=True,
            dropout_p=self.attn.dropout if self.training else 0.0,
            training=self.training)
        return self._tail(x, a)


class GPTModel(nn.Module):
    def __init__(self, cfg: GPTConfig):
        super().__init__()
        self.cfg = cfg
        self.wte = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.wpe = nn.Embedding(cfg.max_position_embeddings, cfg.hidden_size)
        self.drop = Dropout(cfg.hidden_dropout_prob)
        self.blocks = nn.ModuleList(
            [GPTBlock(cfg) for _ in range(cfg.num_hidden_layers)])
        self.ln_f = LayerNorm(cfg.hidden_size)
        self._init_weights()

    @torch.no_grad()
    def _init_weights(self):
        gen = get_generator("cpu")
        for emb in (self.wte, self.wpe):
            emb.weight.normal_(0.0, self.cfg.initializer_range,
                               generator=gen)
        for mod in self.blocks.modules():
            if isinstance(mod, nn.Linear):
                nn.init.xavier_uniform_(mod.weight, generator=gen)
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
        """LM head tied to wte (the ``matmul`` op against the embedding
        table)."""
        hidden, table = amp.cast_inputs("matmul", hidden, self.wte.weight)
        return torch.matmul(hidden, table.t())


def _chunk_nll(h_c, y_c, table):
    """Summed NLL and valid-label count of one sequence chunk: f32 logits
    of the tied head, ``ignore_index`` -100."""
    logits = torch.matmul(h_c.float(), table.t())
    lse = torch.logsumexp(logits, dim=-1)
    valid = y_c != -100
    safe = torch.where(valid, y_c, torch.zeros_like(y_c)).long()
    gold = logits.gather(-1, safe[..., None])[..., 0]
    nll = torch.where(valid, lse - gold, torch.zeros_like(lse))
    return nll.sum(), valid.sum()


def chunked_lm_loss(hidden, labels, table, n_chunks):
    """Tied-head softmax cross-entropy without the full ``[B, S, V]``
    logits (``_chunked_lm_loss``): the sequence is cut into ``n_chunks``
    chunks, each chunk's logits are made in f32 and dropped, and
    recomputed in backward (``torch.utils.checkpoint``, the port of
    ``jax.checkpoint``), so the peak holds one ``[B, S/n, V]`` block. The
    mean is over labels other than -100."""
    b, s, _ = hidden.shape
    c = s // n_chunks
    table = table.float()            # promoted once, as jnp promotes it
    total = hidden.new_zeros((), dtype=torch.float32)
    count = torch.zeros((), dtype=torch.int64, device=hidden.device)
    for i in range(n_chunks):
        nll, n = checkpoint(_chunk_nll, hidden[:, i * c:(i + 1) * c],
                            labels[:, i * c:(i + 1) * c], table,
                            use_reentrant=False)
        total = total + nll
        count = count + n
    return total / count.clamp_min(1).float()


class GPTForPretraining(nn.Module):
    """GPT with the tied-embedding LM head and the causal-LM loss.

    ``forward`` returns:

    * ``labels is None`` — the logits ``[B, S, V]``;
    * ``labels`` given, ``lm_loss_chunks == 1`` — ``(loss, logits)``, the
      mean cross-entropy over the dense logits;
    * ``labels`` given, ``lm_loss_chunks > 1`` — ``(loss, None)``: the
      chunked loss never makes the whole logits tensor, so there are none
      to return.

    ``S`` must be divisible by ``lm_loss_chunks``: a silent dense
    fallback would defeat the memory bound, so another length raises.
    """

    def __init__(self, cfg: GPTConfig, lm_loss_chunks: int = 1):
        super().__init__()
        self.gpt = GPTModel(cfg)
        if lm_loss_chunks < 1:
            raise ValueError(f"lm_loss_chunks must be >= 1, "
                             f"got {lm_loss_chunks}")
        self.lm_loss_chunks = int(lm_loss_chunks)

    def forward(self, input_ids, labels=None, position_ids=None):
        hidden = self.gpt(input_ids, position_ids)
        if labels is None:
            return self.gpt.logits(hidden)
        if self.lm_loss_chunks > 1:
            if hidden.shape[1] % self.lm_loss_chunks:
                raise ValueError(
                    f"sequence length {hidden.shape[1]} is not divisible "
                    f"by lm_loss_chunks={self.lm_loss_chunks}")
            return chunked_lm_loss(hidden, labels, self.gpt.wte.weight,
                                   self.lm_loss_chunks), None
        logits = self.gpt.logits(hidden)
        loss = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                               labels.reshape(-1))
        return loss, logits
