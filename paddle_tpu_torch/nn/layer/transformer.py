"""Multi-head attention projections (counterpart of
``paddle_tpu/nn/layer/transformer.py``'s ``MultiHeadAttention``).

The projections are the port's ``Linear`` (``torch.nn.Linear`` with the
AMP cast; weights ``[out, in]``: the JAX package's ``[in, out]`` weights
are transposed when they are carried across, see
``paddle_tpu_torch.convert``). Heads stay in the JAX layout
``[B, L, H, D]``; attention itself is
``paddle_tpu_torch.nn.functional.scaled_dot_product_attention``.
"""
from __future__ import annotations

from torch import nn

from .common import Linear

__all__ = ["MultiHeadAttention"]


class MultiHeadAttention(nn.Module):
    """The q/k/v/out projections of the reference ``MultiHeadAttention``
    (k from ``kdim``, v from ``vdim`` features; ``weight_attr``/
    ``bias_attr`` on every projection) and its head split/merge; the GPT
    block drives attention itself. The layer's own forward, and with it
    ``need_weights=True``, is not ported yet (ROADMAP Queue 1 item 6)."""

    class Cache:
        """Keys and values of the steps so far (``GPTBlock.forward``'s
        ``cache``)."""

        def __init__(self, k, v):
            self.k, self.v = k, v

    def __init__(self, embed_dim, num_heads, dropout=0.0, kdim=None,
                 vdim=None, need_weights=False, weight_attr=None,
                 bias_attr=None, *, device=None, dtype=None):
        super().__init__()
        if embed_dim % num_heads != 0:
            raise ValueError("embed_dim must be divisible by num_heads")
        if need_weights:
            raise NotImplementedError(
                "MultiHeadAttention's forward (need_weights=True) is not "
                "ported yet (ROADMAP Queue 1 item 6)")
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.head_dim = embed_dim // num_heads
        self.kdim = kdim or embed_dim
        self.vdim = vdim or embed_dim
        self.dropout = dropout
        kw = {"device": device, "dtype": dtype}
        self.q_proj = Linear(embed_dim, embed_dim, weight_attr, bias_attr,
                             **kw)
        self.k_proj = Linear(self.kdim, embed_dim, weight_attr, bias_attr,
                             **kw)
        self.v_proj = Linear(self.vdim, embed_dim, weight_attr, bias_attr,
                             **kw)
        self.out_proj = Linear(embed_dim, embed_dim, weight_attr, bias_attr,
                               **kw)

    def _split_heads(self, x):
        # [B, L, E] -> [B, L, H, D]
        b, l = x.shape[0], x.shape[1]
        return x.reshape(b, l, self.num_heads, self.head_dim)

    def _merge_heads(self, x):
        b, l, h, d = x.shape
        return x.reshape(b, l, h * d)
