"""Multi-head attention projections (counterpart of
``paddle_tpu/nn/layer/transformer.py``'s ``MultiHeadAttention``).

The projections are ``torch.nn.Linear`` (weights ``[out, in]``; the JAX
package's ``[in, out]`` weights are transposed when they are carried
across, see ``paddle_tpu_torch.convert``). Heads stay in the JAX
layout ``[B, L, H, D]``.
"""
from __future__ import annotations

import math

import torch
from torch import nn

__all__ = ["MultiHeadAttention", "causal_attention"]


def causal_attention(q, k, v):
    """Causal softmax attention over ``[B, L, H, D]`` q/k/v, in f32, as a
    plain composition. The model's full-sequence forward uses it; the
    serving path never does (it runs the ragged paged attention
    kernel), and the flash-attention kernel that will replace it is
    queued in ROADMAP.md."""
    b, l, h, d = q.shape
    qf = q.float().transpose(1, 2)                      # [B, H, L, D]
    kf = k.float().transpose(1, 2)
    vf = v.float().transpose(1, 2)
    s = torch.matmul(qf, kf.transpose(-1, -2)) / math.sqrt(d)
    keep = torch.ones(l, k.shape[1], dtype=torch.bool,
                      device=q.device).tril()
    s = s.masked_fill(~keep, float("-inf"))
    out = torch.matmul(torch.softmax(s, dim=-1), vf)
    return out.transpose(1, 2).to(q.dtype)


class MultiHeadAttention(nn.Module):
    """The q/k/v/out projections of the reference ``MultiHeadAttention``
    and its head split/merge; the GPT block drives attention itself."""

    def __init__(self, embed_dim: int, num_heads: int, dropout: float = 0.0,
                 device=None, dtype=None):
        super().__init__()
        if embed_dim % num_heads != 0:
            raise ValueError("embed_dim must be divisible by num_heads")
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.head_dim = embed_dim // num_heads
        self.dropout = dropout
        kw = {"device": device, "dtype": dtype}
        self.q_proj = nn.Linear(embed_dim, embed_dim, **kw)
        self.k_proj = nn.Linear(embed_dim, embed_dim, **kw)
        self.v_proj = nn.Linear(embed_dim, embed_dim, **kw)
        self.out_proj = nn.Linear(embed_dim, embed_dim, **kw)

    def _split_heads(self, x):
        # [B, L, E] -> [B, L, H, D]
        b, l = x.shape[0], x.shape[1]
        return x.reshape(b, l, self.num_heads, self.head_dim)

    def _merge_heads(self, x):
        b, l, h, d = x.shape
        return x.reshape(b, l, h * d)
