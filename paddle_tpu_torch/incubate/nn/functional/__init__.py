"""``incubate.nn.functional`` (counterpart of
``paddle_tpu/incubate/nn/functional/__init__.py``): the functional forms
of the fused transformer ops, the weights passed explicitly.

Each one composes the port's ops through ``call_op``, so ``layer_norm``
takes the LayerNorm kernel (K2/K3) and unmasked attention without
dropout the flash kernels (K4-K7) on the card, as the layers of
``incubate.nn`` do; the bias, dropout and residual epilogues are plain
torch. ``qkv_weight`` is ``[3, num_heads, head_dim, embed_dim]`` and
``linear_weight`` ``[embed_dim, embed_dim]`` (``x @ linear_weight``), the
JAX layouts.
"""
from __future__ import annotations

from ....framework.dispatch import call_op as _op
from ....nn import functional as F
from ....ops.registry import not_ported

__all__ = ["fused_matmul_bias", "fused_linear",
           "fused_bias_dropout_residual_layer_norm",
           "fused_multi_head_attention", "fused_feedforward"]


def _one_rank(ring_id):
    """``ring_id`` names a tensor-parallel group; the port runs on one
    device (the JAX package ignores it)."""
    if ring_id != -1:
        raise not_ported(f"ring_id={ring_id}", 4)


def _layer_norm(x, scale, bias, epsilon):
    return _op("layer_norm", x, scale, bias, epsilon=epsilon,
               begin_norm_axis=x.dim() - 1)


def fused_matmul_bias(x, y, bias=None, transpose_x=False, transpose_y=False,
                      name=None):
    """``matmul(x, y) + bias``."""
    out = _op("matmul", x, y, transpose_x=transpose_x,
              transpose_y=transpose_y)
    if bias is not None:
        out = _op("add", out, bias)
    return out


def fused_linear(x, weight, bias=None, transpose_weight=False, name=None):
    return fused_matmul_bias(x, weight, bias,
                             transpose_y=transpose_weight)


def fused_bias_dropout_residual_layer_norm(
        x, residual, bias=None, ln_scale=None, ln_bias=None,
        dropout_rate=0.5, ln_epsilon=1e-5, training=True,
        mode="upscale_in_train", name=None):
    """``layer_norm(residual + dropout(x + bias))``."""
    if bias is not None:
        x = _op("add", x, bias)
    if dropout_rate and training:
        x = F.dropout(x, p=dropout_rate, training=True, mode=mode)
    return _layer_norm(_op("add", residual, x), ln_scale, ln_bias,
                       ln_epsilon)


def fused_multi_head_attention(
        x, qkv_weight, linear_weight, pre_layer_norm=False,
        pre_ln_scale=None, pre_ln_bias=None, ln_scale=None, ln_bias=None,
        pre_ln_epsilon=1e-5, qkv_bias=None, linear_bias=None,
        cache_kv=None, attn_mask=None, dropout_rate=0.5,
        attn_dropout_rate=0.5, ln_epsilon=1e-5, training=True,
        mode="upscale_in_train", ring_id=-1, add_residual=True, name=None):
    """Attention with its residual and a pre or post LayerNorm;
    ``qkv_weight`` ``[3, H, Dh, D]``, ``linear_weight`` ``[D, D]``.
    ``cache_kv`` raises, as in the JAX package (the layers take a cache);
    a ``ring_id`` other than -1 (a tensor-parallel group) raises naming
    ROADMAP Queue 1 item 4."""
    _one_rank(ring_id)
    if cache_kv is not None:
        raise NotImplementedError(
            "cache_kv (incremental decode) is not supported by the fused "
            "attention path; use nn.MultiHeadAttention with its cache")
    b, s, d = x.shape
    n_heads, head_dim = qkv_weight.shape[1], qkv_weight.shape[2]
    width = 3 * n_heads * head_dim
    residual = x
    if pre_layer_norm:
        x = _layer_norm(x, pre_ln_scale, pre_ln_bias, pre_ln_epsilon)
    w = _op("reshape", qkv_weight, shape=(width, d))
    qkv = _op("matmul", x, w, transpose_y=True)            # [B, S, 3HDh]
    if qkv_bias is not None:
        qkv = _op("add", qkv, _op("reshape", qkv_bias, shape=(width,)))
    qkv = _op("reshape", qkv, shape=(b, s, 3, n_heads, head_dim))
    out = F.scaled_dot_product_attention(
        qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2], attn_mask=attn_mask,
        dropout_p=attn_dropout_rate if training else 0.0,
        training=training)
    out = _op("reshape", out, shape=(b, s, n_heads * head_dim))
    out = _op("matmul", out, linear_weight)
    if linear_bias is not None:
        out = _op("add", out, linear_bias)
    if dropout_rate and training:
        out = F.dropout(out, p=dropout_rate, training=True, mode=mode)
    if add_residual:
        out = _op("add", residual, out)
    if not pre_layer_norm:
        out = _layer_norm(out, ln_scale, ln_bias, ln_epsilon)
    return out


def fused_feedforward(x, linear1_weight, linear2_weight, linear1_bias=None,
                      linear2_bias=None, ln1_scale=None, ln1_bias=None,
                      ln2_scale=None, ln2_bias=None, dropout1_rate=0.5,
                      dropout2_rate=0.5, activation="relu",
                      ln1_epsilon=1e-5, ln2_epsilon=1e-5,
                      pre_layer_norm=False, training=True,
                      mode="upscale_in_train", ring_id=-1, name=None):
    """``residual + dropout2(linear2(dropout1(act(linear1(LN(x))))))``,
    the LayerNorm before (``pre_layer_norm``) or after the residual."""
    _one_rank(ring_id)
    residual = x
    if pre_layer_norm:
        x = _layer_norm(x, ln1_scale, ln1_bias, ln1_epsilon)
    h = getattr(F, activation)(fused_matmul_bias(x, linear1_weight,
                                                 linear1_bias))
    if dropout1_rate and training:
        h = F.dropout(h, p=dropout1_rate, training=True, mode=mode)
    h = fused_matmul_bias(h, linear2_weight, linear2_bias)
    if dropout2_rate and training:
        h = F.dropout(h, p=dropout2_rate, training=True, mode=mode)
    out = _op("add", residual, h)
    if not pre_layer_norm:
        out = _layer_norm(out, ln2_scale, ln2_bias, ln2_epsilon)
    return out
