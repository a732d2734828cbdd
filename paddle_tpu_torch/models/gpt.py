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
the sequence (:func:`chunked_lm_loss`), and ``generate``.

The static-cache decode path (``init_cache``, ``prefill``,
``decode_step``) keeps one fixed ``[B, total_len, H, D]`` K/V pair per
layer and writes into it in place (``cache[:, pos] = k``), where the JAX
package returns a new array from ``dynamic_update_slice``. An unmasked
prefill is causal with ``Sq == Sk``, so it reaches the flash kernel; a
left-padded (masked) prefill and every decode step run the masked plain
composition over the cache, as in the JAX package.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..framework.dispatch import call_op
from ..framework.random import get_generator
from ..nn import functional as F
from ..nn.initializer import Constant
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
        # the weights are drawn in GPTModel._init_weights, from the
        # port's generator; a constant start draws nothing before it
        start = Constant(0.0)
        self.attn = MultiHeadAttention(h, cfg.num_attention_heads,
                                       dropout=cfg.attention_dropout_prob,
                                       weight_attr=start)
        self.ln_2 = LayerNorm(h)
        self.mlp_fc = Linear(h, cfg.intermediate_size, start)
        self.mlp_proj = Linear(cfg.intermediate_size, h, start)
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
        m = self.mlp_proj(call_op("gelu", self.mlp_fc(self.ln_2(x)),
                                  approximate=True))
        return x + self.dropout(m)

    def forward(self, x, cache=None):
        """The block over ``x [B, S, E]``; with ``cache`` (a
        ``MultiHeadAttention.Cache`` of earlier keys and values) the
        new K/V are appended to it, causal attention aligns the rows to
        the end, and ``(x, new cache)`` is returned, as in the JAX
        block."""
        q, k, v = self._qkv(x)
        if cache is not None:
            k = call_op("concat", [cache.k, k], axis=1)
            v = call_op("concat", [cache.v, v], axis=1)
            cache = MultiHeadAttention.Cache(k, v)
        a = F.scaled_dot_product_attention(
            q, k, v, is_causal=True,
            dropout_p=self.attn.dropout if self.training else 0.0,
            training=self.training)
        x = self._tail(x, a)
        return x if cache is None else (x, cache)

    def prefill(self, x, cache_k, cache_v, key_valid=None):
        """The whole prompt ``x [B, S, E]``: write its K/V into the cache's
        rows ``[0, S)`` in place and return the block's output.
        ``key_valid`` (bool ``[B, S]``) marks real tokens: False keys
        (left pads) are invisible to every query."""
        q, k, v = self._qkv(x)
        s = x.shape[1]
        cache_k[:, :s] = k
        cache_v[:, :s] = v
        mask = None if key_valid is None else key_valid[:, None, None, :]
        a = F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                           is_causal=True, training=False)
        return self._tail(x, a)

    def decode_step(self, x, cache_k, cache_v, pos, key_valid=None):
        """One token a row, ``x [B, 1, E]``: write its K/V at cache row
        ``pos`` in place and attend over the cache rows that
        ``key_valid`` (bool ``[B or 1, total_len]``) marks, by default
        rows ``[0, pos]``."""
        q, k, v = self._qkv(x)
        cache_k[:, pos] = k[:, 0]
        cache_v[:, pos] = v[:, 0]
        if key_valid is None:
            key_valid = (torch.arange(cache_k.shape[1], device=x.device)
                         <= pos)[None]
        a = F.scaled_dot_product_attention(
            q, cache_k, cache_v, attn_mask=key_valid[:, None, None, :],
            training=False)
        return self._tail(x, a)


    def decode_step_at(self, x, cache_k, cache_v, pos, key_valid):
        """:meth:`decode_step` at a tensor ``pos`` (int64, 0-d), for a
        traced loop: the K/V row goes into new cache tensors, which are
        returned with the block's output."""
        q, k, v = self._qkv(x)
        row = pos.reshape(1)
        cache_k = cache_k.index_copy(1, row, k)
        cache_v = cache_v.index_copy(1, row, v)
        a = F.scaled_dot_product_attention(
            q, cache_k, cache_v, attn_mask=key_valid[:, None, None, :],
            training=False)
        return self._tail(x, a), cache_k, cache_v


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
            if isinstance(mod, Linear):
                nn.init.xavier_uniform_(mod.weight, generator=gen)
                mod.bias.zero_()

    def _embed(self, input_ids, position_ids):
        return (call_op("embedding", input_ids, self.wte.weight)
                + call_op("embedding", position_ids, self.wpe.weight))

    def forward(self, input_ids, position_ids=None):
        if position_ids is None:
            position_ids = torch.arange(input_ids.shape[1],
                                        device=input_ids.device)[None, :]
        x = self.drop(self._embed(input_ids, position_ids))
        for block in self.blocks:
            x = block(x)
        return self.ln_f(x)

    def logits(self, hidden):
        """LM head tied to wte (the ``matmul`` op against the embedding
        table)."""
        return call_op("matmul", hidden, self.wte.weight, transpose_y=True)

    # -- static-cache decode path --------------------------------------
    def init_cache(self, batch, max_len, dtype, device=None):
        """Per-layer ``(k, v)`` buffers of zeros, each ``[batch, max_len,
        num_heads, head_dim]``, on ``device`` (the parameters' by
        default)."""
        cfg = self.cfg
        if device is None:
            device = self.wte.weight.device
        shape = (batch, max_len, cfg.num_attention_heads,
                 cfg.hidden_size // cfg.num_attention_heads)
        return tuple(
            tuple(call_op("zeros", shape, dtype=dtype, device=device)
                  for _ in range(2))
            for _ in range(cfg.num_hidden_layers))

    def prefill(self, input_ids, caches, key_valid=None):
        """Run the prompt ``input_ids [B, S]`` through every block,
        filling ``caches`` in place. ``key_valid`` (bool ``[B, S]``) marks
        the real tokens of left-padded prompts: pads take position 0 and
        the real tokens count 0, 1, 2, ... Returns the last position's
        hidden state ``[B, 1, E]`` and ``caches``."""
        seq = input_ids.shape[1]
        if key_valid is None:
            position_ids = call_op("arange", seq,
                                   device=input_ids.device)[None, :]
        else:
            position_ids = call_op("maximum", call_op(
                "cumsum", key_valid.to(torch.int32), axis=1) - 1,
                torch.zeros((), dtype=torch.int32, device=input_ids.device))
        x = self._embed(input_ids, position_ids)
        for block, (ck, cv) in zip(self.blocks, caches):
            x = block.prefill(x, ck, cv, key_valid=key_valid)
        x = self.ln_f(x)
        return call_op("slice", x, axes=[1], starts=[seq - 1],
                       ends=[seq]), caches

    def decode_step(self, token_ids, caches, pos, key_valid=None,
                    positions=None):
        """One decode step: ``token_ids [B, 1]`` at cache row ``pos`` (a
        Python int). ``key_valid`` (bool ``[B, total_len]``) marks the
        cache rows each row attends over, by default rows ``[0, pos]``;
        ``positions`` (``[B, 1]``) are the rows' logical positions for
        ragged prompts, by default ``pos``. Returns the hidden state
        ``[B, 1, E]`` and ``caches``, updated in place."""
        device = token_ids.device
        if positions is None:
            positions = call_op("full", (1, 1), pos, dtype=torch.int32,
                                device=device)
        if key_valid is None:
            key_valid = call_op("arange", caches[0][0].shape[1],
                                device=device)[None, :] <= pos
        x = self._embed(token_ids, positions)
        for block, (ck, cv) in zip(self.blocks, caches):
            x = block.decode_step(x, ck, cv, pos, key_valid)
        return self.ln_f(x), caches


    def decode_step_at(self, token_ids, caches, pos):
        """:meth:`decode_step` at a tensor ``pos`` (int64, 0-d) with no
        mask, out of place: returns the hidden state ``[B, 1, E]`` and
        the new caches. The values are :meth:`decode_step`'s."""
        positions = pos.to(torch.int32).reshape(1, 1)
        key_valid = call_op("arange", caches[0][0].shape[1],
                            device=token_ids.device)[None, :] <= pos
        x = self._embed(token_ids, positions)
        out = []
        for block, (ck, cv) in zip(self.blocks, caches):
            x, ck, cv = block.decode_step_at(x, ck, cv, pos, key_valid)
            out.append((ck, cv))
        return self.ln_f(x), tuple(out)


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

    def generate(self, input_ids, **kwargs):
        """Static-cache autoregressive decode; see
        ``models.generation.generate``."""
        from .generation import generate
        return generate(self, input_ids, **kwargs)
