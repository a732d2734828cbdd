"""``nn.functional`` (counterpart of ``paddle_tpu/nn/functional``): the
functional neural-net API over the op library. Every function runs its op
through ``call_op`` (``framework/dispatch.py``), so the AMP policy and the
kernel overrides apply as in the JAX package.

:func:`scaled_dot_product_attention` runs the
``scaled_dot_product_attention`` op. Its plain body is the composition of
``ops/nn_ops.py`` (:func:`sdpa_reference`); the override registered here
sends it to the flash attention kernels (K4-K7) whenever
:func:`flash_supported`, the structural half of the JAX override's
``_fa_supported``, holds (no mask, no dropout, causal only with ``Sq ==
Sk``, ``D <= 256``), whatever the dtypes and the device: on the card a
dtype the kernels do not take raises there; on the CPU the kernel wrapper
runs its plain version. A mask or attention dropout runs the op's plain
body, where the JAX override refuses too. The TPU's length threshold
(``FLASH_MIN_SEQ``, measured on v5e) and its autotune cache are not
carried over: on the card every supported shape goes to the kernel.

The random functions (``dropout``, ``alpha_dropout``, ``rrelu``,
``gumbel_softmax``) draw from the port's generator of the input's device.
The ten ``sequence_*`` functions run the ``sequence_ops`` over the dense
(padded, lengths) encoding.
"""
from __future__ import annotations

import numpy as np
import torch

from ...framework.dispatch import call_op as _op
from ...ops.flash_attention import MAX_HEAD_DIM, flash_attention
from ...ops.nn_ops import sdpa_reference
from ...ops.registry import not_ported, register_override

__all__ = ["sdpa_reference", "flash_supported"]

def _export(fn):
    __all__.append(fn.__name__)
    return fn


# -- attention --------------------------------------------------------------------

def flash_supported(q, k, mask, dropout_p, is_causal) -> bool:
    """The structural half of ``_fa_supported``."""
    if q.dim() != 4 or mask is not None or dropout_p > 0.0:
        return False
    if is_causal and q.shape[1] != k.shape[1]:
        return False
    return q.shape[-1] <= MAX_HEAD_DIM


def _sdpa_flash(q, k, v, mask=None, dropout_p=0.0, is_causal=False,
                scale=None):
    return flash_attention(q, k, v, is_causal=is_causal, scale=scale)


register_override(
    "scaled_dot_product_attention",
    lambda args, attrs: flash_supported(
        args[0], args[1], args[3] if len(args) > 3 else attrs.get("mask"),
        attrs.get("dropout_p", 0.0), attrs.get("is_causal", False)),
)(_sdpa_flash)


@_export
def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p=0.0, is_causal=False,
                                 training=True, name=None):
    """Attention over ``[batch, seq, num_heads, head_dim]`` inputs."""
    p = float(dropout_p) if training else 0.0
    return _op("scaled_dot_product_attention", query, key, value,
               mask=attn_mask, dropout_p=p, is_causal=is_causal)


# -- activations --------------------------------------------------------------

def _simple(opname, fname=None):
    def fn(x, name=None):
        return _op(opname, x)
    fn.__name__ = fn.__qualname__ = fname or opname
    return _export(fn)


relu = _simple("relu")
relu6 = _simple("relu6")
sigmoid = _simple("sigmoid")
tanh = _simple("tanh")
silu = _simple("silu")
swish = _simple("silu", "swish")
mish = _simple("mish")
tanhshrink = _simple("tanhshrink")
log_sigmoid = _simple("log_sigmoid")
hardswish = _simple("hardswish")
softsign = _simple("softsign")


@_export
def gelu(x, approximate=False, name=None):
    return _op("gelu", x, approximate=approximate)


@_export
def leaky_relu(x, negative_slope=0.01, name=None):
    return _op("leaky_relu", x, negative_slope=negative_slope)


@_export
def elu(x, alpha=1.0, name=None):
    return _op("elu", x, alpha=alpha)


@_export
def celu(x, alpha=1.0, name=None):
    return _op("celu", x, alpha=alpha)


@_export
def selu(x, scale=1.0507009873554805, alpha=1.6732632423543772, name=None):
    return _op("selu", x, scale=scale, alpha=alpha)


@_export
def hardsigmoid(x, slope=0.1666667, offset=0.5, name=None):
    return _op("hardsigmoid", x, slope=slope, offset=offset)


@_export
def hardtanh(x, min=-1.0, max=1.0, name=None):
    return _op("hardtanh", x, min=min, max=max)


@_export
def hardshrink(x, threshold=0.5, name=None):
    return _op("hardshrink", x, threshold=threshold)


@_export
def softshrink(x, threshold=0.5, name=None):
    return _op("softshrink", x, threshold=threshold)


@_export
def softplus(x, beta=1.0, threshold=20.0, name=None):
    return _op("softplus", x, beta=beta, threshold=threshold)


@_export
def thresholded_relu(x, threshold=1.0, name=None):
    return _op("thresholded_relu", x, threshold=threshold)


@_export
def prelu(x, weight, data_format="NCHW", name=None):
    return _op("prelu", x, weight)


@_export
def rrelu(x, lower=1. / 8., upper=1. / 3., training=True, name=None):
    return _op("rrelu", x, None, lower=lower, upper=upper,
               training=training)


@_export
def softmax(x, axis=-1, dtype=None, name=None):
    out = _op("softmax", x, axis=axis)
    if dtype is not None:
        out = _op("cast", out, dtype=dtype)
    return out


@_export
def log_softmax(x, axis=-1, dtype=None, name=None):
    out = _op("log_softmax", x, axis=axis)
    if dtype is not None:
        out = _op("cast", out, dtype=dtype)
    return out


@_export
def gumbel_softmax(x, temperature=1.0, hard=False, axis=-1, name=None):
    return _op("gumbel_softmax", x, None, temperature=temperature,
               hard=hard, axis=axis)


@_export
def maxout(x, groups, axis=1, name=None):
    return _op("maxout", x, groups=groups, axis=axis)


@_export
def glu(x, axis=-1, name=None):
    return _op("glu", x, axis=axis)


# -- common --------------------------------------------------------------------

@_export
def linear(x, weight, bias=None, name=None):
    """``x @ weight + bias`` with ``weight`` ``[in, out]`` (the JAX
    package's layout)."""
    return _op("linear", x, weight, bias)


@_export
def dropout(x, p=0.5, axis=None, training=True, mode="upscale_in_train",
            name=None):
    """Dropout as the JAX package's: keep each element with probability
    ``1 - p``; ``mode="upscale_in_train"`` scales the kept ones by ``1 /
    (1 - p)`` in training, and ``"downscale_in_infer"`` keeps them as
    they are and scales by ``1 - p`` in eval. With ``axis`` (an int or a
    list) the mask is drawn over those axes and broadcast over the rest
    (the ``dropout_raw`` op, drawing from the port's generator of ``x``'s
    device)."""
    if mode not in ("upscale_in_train", "downscale_in_infer"):
        raise ValueError(f"dropout mode must be 'upscale_in_train' or "
                         f"'downscale_in_infer', got {mode!r}")
    if not training or p == 0.0:
        if not training and mode == "downscale_in_infer" and p > 0.0:
            return _op("scale", x, scale=1.0 - float(p))
        return x
    axis_attr = None if axis is None else (
        (axis,) if isinstance(axis, int) else tuple(int(a) for a in axis))
    return _op("dropout_raw", x, None, p=float(p), axis=axis_attr,
               mode=mode)


@_export
def dropout2d(x, p=0.5, training=True, data_format="NCHW", name=None):
    axis = [0, 1] if data_format == "NCHW" else [0, 3]
    return dropout(x, p=p, axis=axis, training=training)


@_export
def dropout3d(x, p=0.5, training=True, data_format="NCDHW", name=None):
    axis = [0, 1] if data_format == "NCDHW" else [0, 4]
    return dropout(x, p=p, axis=axis, training=training)


@_export
def alpha_dropout(x, p=0.5, training=True, name=None):
    if not training or p == 0.0:
        return x
    return _op("alpha_dropout", x, None, p=float(p))


@_export
def pad(x, pad, mode="constant", value=0.0, data_format="NCHW", name=None):
    if not isinstance(pad, (list, tuple)):
        pad = np.asarray(pad.cpu() if torch.is_tensor(pad) else pad).tolist()
    return _op("pad", x, pad=tuple(int(p) for p in pad), mode=mode,
               value=value, data_format=data_format)


@_export
def interpolate(x, size=None, scale_factor=None, mode="nearest",
                align_corners=False, align_mode=0, data_format="NCHW",
                name=None):
    if torch.is_tensor(size):
        size = [int(v) for v in size.tolist()]
    elif size is not None and not isinstance(size, (list, tuple)):
        size = [int(size)]
    elif size is not None:
        size = [int(s) for s in size]
    return _op("interpolate", x, size=tuple(size) if size else None,
               scale_factor=tuple(scale_factor)
               if isinstance(scale_factor, (list, tuple)) else scale_factor,
               mode=mode, align_corners=align_corners,
               data_format=data_format)


@_export
def upsample(x, size=None, scale_factor=None, mode="nearest",
             align_corners=False, align_mode=0, data_format="NCHW",
             name=None):
    return interpolate(x, size, scale_factor, mode, align_corners,
                       align_mode, data_format)


@_export
def embedding(x, weight, padding_idx=None, sparse=False, name=None):
    return _op("embedding", x, weight, padding_idx=padding_idx)


@_export
def one_hot(x, num_classes, name=None):
    return _op("one_hot", x, num_classes=num_classes)


@_export
def label_smooth(label, prior_dist=None, epsilon=0.1, name=None):
    return _op("label_smooth", label, prior_dist, epsilon=epsilon)


@_export
def unfold(x, kernel_sizes, strides=1, paddings=0, dilations=1, name=None):
    return _op("unfold", x, kernel_sizes=kernel_sizes, strides=strides,
               paddings=paddings, dilations=dilations)


@_export
def cosine_similarity(x1, x2, axis=1, eps=1e-8):
    return _op("cosine_similarity", x1, x2, axis=axis, eps=eps)


@_export
def pixel_shuffle(x, upscale_factor, data_format="NCHW", name=None):
    return _op("pixel_shuffle", x, upscale_factor=upscale_factor,
               data_format=data_format)


@_export
def normalize(x, p=2, axis=1, epsilon=1e-12, name=None):
    return _op("normalize_l2", x, p=float(p), axis=axis, epsilon=epsilon)


@_export
def sequence_mask(x, maxlen=None, dtype="int64", name=None):
    return _op("sequence_mask", x, maxlen=maxlen, dtype=dtype)


@_export
def zeropad2d(x, padding, data_format="NCHW", name=None):
    if isinstance(padding, int):
        padding = [padding] * 4
    return pad(x, padding, mode="constant", value=0.0,
               data_format=data_format)


@_export
def bilinear(x1, x2, weight, bias=None, name=None):
    return _op("bilinear", x1, x2, weight, bias)


@_export
def diag_embed(x, offset=0, dim1=-2, dim2=-1, name=None):
    return _op("diag_embed", x, offset=offset, dim1=dim1, dim2=dim2)


@_export
def pixel_unshuffle(x, downscale_factor, data_format="NCHW", name=None):
    return _op("pixel_unshuffle", x, downscale_factor=downscale_factor,
               data_format=data_format)


@_export
def channel_shuffle(x, groups, data_format="NCHW", name=None):
    return _op("channel_shuffle", x, groups=groups, data_format=data_format)


@_export
def fold(x, output_sizes, kernel_sizes, strides=1, paddings=0, dilations=1,
         name=None):
    return _op("fold", x, output_sizes=output_sizes,
               kernel_sizes=kernel_sizes, strides=strides, paddings=paddings,
               dilations=dilations)


@_export
def temporal_shift(x, seg_num, shift_ratio=0.25, data_format="NCHW",
                   name=None):
    return _op("temporal_shift", x, seg_num=seg_num, shift_ratio=shift_ratio,
               data_format=data_format)


@_export
def grid_sample(x, grid, mode="bilinear", padding_mode="zeros",
                align_corners=True, name=None):
    return _op("grid_sample", x, grid, mode=mode, padding_mode=padding_mode,
               align_corners=align_corners)


@_export
def affine_grid(theta, out_shape, align_corners=True, name=None):
    """``out_shape``: four ints, or a tensor of them (read to the host)."""
    if isinstance(out_shape, torch.Tensor):
        out_shape = out_shape.tolist()
    return _op("affine_grid", theta, out_shape=tuple(
        int(v) for v in out_shape), align_corners=align_corners)


@_export
def gather_tree(ids, parents):
    return _op("gather_tree", ids, parents)


# -- variable-length sequences over the dense (padded, lengths) encoding ---------------

@_export
def sequence_pad(x, lengths, pad_value=0.0, maxlen=None, name=None):
    return _op("sequence_pad", x, lengths, pad_value=pad_value,
               maxlen=maxlen)


@_export
def sequence_unpad(x, lengths, total_length=None, name=None):
    return _op("sequence_unpad", x, lengths, total_length=total_length)


@_export
def sequence_pool(x, lengths, pool_type="sum", name=None):
    return _op("sequence_pool", x, lengths, pool_type=pool_type)


@_export
def sequence_softmax(x, lengths, name=None):
    return _op("sequence_softmax", x, lengths)


@_export
def sequence_reverse(x, lengths, name=None):
    return _op("sequence_reverse", x, lengths)


@_export
def sequence_expand(x, ref_lengths, maxlen=None, name=None):
    return _op("sequence_expand", x, ref_lengths, maxlen=maxlen)


@_export
def sequence_slice(x, lengths, offset, length, maxlen=None, name=None):
    return _op("sequence_slice", x, lengths, offset, length, maxlen=maxlen)


@_export
def sequence_enumerate(ids, lengths, win_size, pad_value=0, name=None):
    return _op("sequence_enumerate", ids, lengths, win_size=win_size,
               pad_value=pad_value)


@_export
def sequence_concat(xs, lengths_list, maxlen=None, name=None):
    return _op("sequence_concat", xs, lengths_list, maxlen=maxlen)


@_export
def sequence_conv(x, lengths, weight, bias=None, context_length=3,
                  context_start=None, pad_value=0.0, name=None):
    return _op("sequence_conv", x, lengths, weight, bias,
               context_length=context_length, context_start=context_start,
               pad_value=pad_value)


# -- conv / pooling --------------------------------------------------------------

@_export
def conv1d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCL", name=None):
    return _op("conv1d", x, weight, bias, stride=stride, padding=padding,
               dilation=dilation, groups=groups, data_format=data_format)


@_export
def conv2d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCHW", name=None):
    return _op("conv2d", x, weight, bias, stride=stride, padding=padding,
               dilation=dilation, groups=groups, data_format=data_format)


@_export
def conv3d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCDHW", name=None):
    return _op("conv3d", x, weight, bias, stride=stride, padding=padding,
               dilation=dilation, groups=groups, data_format=data_format)


def _opad_from_output_size(x, weight, stride, padding, dilation,
                           output_size, nd, data_format="NC"):
    """``output_size`` as the ``output_padding`` that gives it (the JAX
    helper's rule)."""
    def tup(v):
        return (int(v),) * nd if isinstance(v, int) else \
            tuple(int(i) for i in v)
    st, dl = tup(stride), tup(dilation)
    if isinstance(padding, (list, tuple)) and not all(
            isinstance(p, int) for p in padding):
        raise ValueError("output_size with per-side padding is unsupported")
    pd = tup(padding)
    target = [int(v) for v in output_size][-nd:]
    in_sp = x.shape[2:2 + nd] if data_format.startswith("NC") \
        else x.shape[1:1 + nd]
    ks = weight.shape[2:2 + nd]
    opad = []
    for d in range(nd):
        base = (in_sp[d] - 1) * st[d] - 2 * pd[d] + dl[d] * (ks[d] - 1) + 1
        op = target[d] - base
        if not 0 <= op < st[d] + dl[d]:
            raise ValueError(
                f"invalid output_size {target[d]} for dim {d}: base {base}")
        opad.append(op)
    return tuple(opad)


@_export
def conv2d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, groups=1, dilation=1,
                     output_size=None, data_format="NCHW", name=None):
    if output_size is not None:
        output_padding = _opad_from_output_size(
            x, weight, stride, padding, dilation, output_size, 2,
            data_format)
    return _op("conv2d_transpose", x, weight, bias, stride=stride,
               padding=padding, output_padding=output_padding, groups=groups,
               dilation=dilation, output_size=output_size,
               data_format=data_format)


@_export
def conv1d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, groups=1, dilation=1,
                     output_size=None, data_format="NCL", name=None):
    if output_size is not None:
        output_padding = _opad_from_output_size(
            x, weight, stride, padding, dilation, output_size, 1,
            data_format)
    return _op("conv1d_transpose", x, weight, bias, stride=stride,
               padding=padding, output_padding=output_padding, groups=groups,
               dilation=dilation, data_format=data_format)


@_export
def conv3d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, groups=1, dilation=1,
                     output_size=None, data_format="NCDHW", name=None):
    if output_size is not None:
        output_padding = _opad_from_output_size(
            x, weight, stride, padding, dilation, output_size, 3,
            data_format)
    return _op("conv3d_transpose", x, weight, bias, stride=stride,
               padding=padding, output_padding=output_padding, groups=groups,
               dilation=dilation, data_format=data_format)


@_export
def max_pool1d(x, kernel_size, stride=None, padding=0, return_mask=False,
               ceil_mode=False, name=None):
    if return_mask:
        return _op("max_pool1d_with_mask", x, kernel_size=kernel_size,
                   stride=stride, padding=padding, ceil_mode=ceil_mode)
    return _op("max_pool1d", x, kernel_size=kernel_size, stride=stride,
               padding=padding, ceil_mode=ceil_mode)


@_export
def avg_pool1d(x, kernel_size, stride=None, padding=0, exclusive=True,
               ceil_mode=False, name=None):
    return _op("avg_pool1d", x, kernel_size=kernel_size, stride=stride,
               padding=padding, ceil_mode=ceil_mode, exclusive=exclusive)


@_export
def max_pool2d(x, kernel_size, stride=None, padding=0, return_mask=False,
               ceil_mode=False, data_format="NCHW", name=None):
    if return_mask:
        if not data_format.startswith("NC"):
            raise ValueError(
                "return_mask=True requires NCHW (reference restriction)")
        return _op("max_pool2d_with_mask", x, kernel_size=kernel_size,
                   stride=stride, padding=padding, ceil_mode=ceil_mode)
    return _op("max_pool2d", x, kernel_size=kernel_size, stride=stride,
               padding=padding, ceil_mode=ceil_mode, data_format=data_format)


@_export
def avg_pool2d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               exclusive=True, divisor_override=None, data_format="NCHW",
               name=None):
    return _op("avg_pool2d", x, kernel_size=kernel_size, stride=stride,
               padding=padding, ceil_mode=ceil_mode, exclusive=exclusive,
               data_format=data_format)


@_export
def max_pool3d(x, kernel_size, stride=None, padding=0, return_mask=False,
               ceil_mode=False, data_format="NCDHW", name=None):
    if return_mask:
        if not data_format.startswith("NC"):
            raise ValueError(
                "return_mask=True requires NCDHW (reference restriction)")
        return _op("max_pool3d_with_mask", x, kernel_size=kernel_size,
                   stride=stride, padding=padding, ceil_mode=ceil_mode)
    return _op("max_pool3d", x, kernel_size=kernel_size, stride=stride,
               padding=padding, ceil_mode=ceil_mode, data_format=data_format)


@_export
def avg_pool3d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               exclusive=True, divisor_override=None, data_format="NCDHW",
               name=None):
    return _op("avg_pool3d", x, kernel_size=kernel_size, stride=stride,
               padding=padding, ceil_mode=ceil_mode, exclusive=exclusive,
               data_format=data_format)


@_export
def adaptive_avg_pool1d(x, output_size, name=None):
    return _op("adaptive_avg_pool1d", x, output_size=output_size)


@_export
def adaptive_max_pool1d(x, output_size, return_mask=False, name=None):
    if return_mask:
        return _adaptive_max_with_mask(x, output_size, 1)
    return _op("adaptive_max_pool1d", x, output_size=output_size)


@_export
def adaptive_avg_pool2d(x, output_size, data_format="NCHW", name=None):
    return _op("adaptive_avg_pool2d", x, output_size=output_size,
               data_format=data_format)


@_export
def adaptive_max_pool2d(x, output_size, return_mask=False, name=None):
    if return_mask:
        return _adaptive_max_with_mask(x, output_size, 2)
    return _op("adaptive_max_pool2d", x, output_size=output_size)


@_export
def adaptive_avg_pool3d(x, output_size, data_format="NCDHW", name=None):
    return _op("adaptive_avg_pool3d", x, output_size=output_size,
               data_format=data_format)


@_export
def adaptive_max_pool3d(x, output_size, return_mask=False, name=None):
    if return_mask:
        return _adaptive_max_with_mask(x, output_size, 3)
    return _op("adaptive_max_pool3d", x, output_size=output_size)


def _adaptive_max_with_mask(x, output_size, nd):
    """An adaptive max pool's mask, where the windows tile the input:
    the max pool with the window as kernel and stride (the JAX rule)."""
    out = (output_size,) * nd if isinstance(output_size, int) \
        else tuple(output_size)
    spatial = x.shape[2:2 + nd]
    if any(s % o != 0 for s, o in zip(spatial, out)):
        raise NotImplementedError(
            "return_mask=True needs output_size dividing the input size")
    ks = tuple(s // o for s, o in zip(spatial, out))
    return _op(f"max_pool{nd}d_with_mask", x, kernel_size=ks, stride=ks,
               padding=0)


@_export
def max_unpool1d(x, indices, kernel_size, stride=None, padding=0,
                 data_format="NCL", output_size=None, name=None):
    _channel_first(data_format, "max_unpool1d")
    return _op("max_unpool1d", x, indices, kernel_size=kernel_size,
               stride=stride, padding=padding, output_size=output_size)


@_export
def max_unpool2d(x, indices, kernel_size, stride=None, padding=0,
                 data_format="NCHW", output_size=None, name=None):
    _channel_first(data_format, "max_unpool2d")
    return _op("max_unpool2d", x, indices, kernel_size=kernel_size,
               stride=stride, padding=padding, output_size=output_size)


@_export
def max_unpool3d(x, indices, kernel_size, stride=None, padding=0,
                 data_format="NCDHW", output_size=None, name=None):
    _channel_first(data_format, "max_unpool3d")
    return _op("max_unpool3d", x, indices, kernel_size=kernel_size,
               stride=stride, padding=padding, output_size=output_size)


def _channel_first(data_format, what):
    if not data_format.startswith("NC"):
        raise ValueError(f"{what} supports channel-first only (reference "
                         f"restriction)")


# -- norms ------------------------------------------------------------------------

@_export
def layer_norm(x, normalized_shape, weight=None, bias=None, epsilon=1e-5,
               name=None):
    n_norm = len(normalized_shape) if isinstance(
        normalized_shape, (list, tuple)) else 1
    return _op("layer_norm", x, weight, bias, epsilon=epsilon,
               begin_norm_axis=x.dim() - n_norm)


@_export
def batch_norm(x, running_mean, running_var, weight=None, bias=None,
               training=False, momentum=0.9, epsilon=1e-5,
               data_format="NCHW", use_global_stats=None, name=None):
    """``(y, new_mean, new_var)``: the running statistics' update is
    returned, as the JAX function returns it."""
    return _op("batch_norm", x, running_mean, running_var, weight, bias,
               training=training if use_global_stats is None
               else not use_global_stats,
               momentum=momentum, epsilon=epsilon, data_format=data_format)


@_export
def instance_norm(x, running_mean=None, running_var=None, weight=None,
                  bias=None, use_input_stats=True, momentum=0.9,
                  eps=1e-5, data_format="NCHW", name=None):
    return _op("instance_norm", x, weight, bias, epsilon=eps)


@_export
def group_norm(x, num_groups, epsilon=1e-5, weight=None, bias=None,
               data_format="NCHW", name=None):
    return _op("group_norm", x, weight, bias, epsilon=epsilon,
               num_groups=num_groups, data_format=data_format)


@_export
def rms_norm(x, weight=None, epsilon=1e-6, name=None):
    return _op("rms_norm", x, weight, epsilon=epsilon)


@_export
def local_response_norm(x, size, alpha=1e-4, beta=0.75, k=1.0,
                        data_format="NCHW", name=None):
    return _op("local_response_norm", x, size=size, alpha=alpha, beta=beta,
               k=k)


# -- losses ------------------------------------------------------------------------

@_export
def cross_entropy(input, label, weight=None, ignore_index=-100,
                  reduction="mean", soft_label=False, axis=-1,
                  use_softmax=True, label_smoothing=0.0, name=None):
    """Softmax cross-entropy over ``axis`` in f32 (the ``cross_entropy``
    op: hard or ``soft_label`` labels, ``label_smoothing``, per-class
    ``weight``, ``ignore_index``); ``reduction`` ``"mean"`` (over the valid
    rows, or the summed weights), ``"sum"`` or ``"none"``."""
    if reduction not in ("mean", "sum", "none"):
        raise ValueError(f"reduction must be 'mean', 'sum' or 'none', got "
                         f"{reduction!r}")
    return _op("cross_entropy", input, label, weight,
               soft_label=soft_label, axis=axis, ignore_index=ignore_index,
               reduction=reduction, use_softmax=use_softmax,
               label_smoothing=label_smoothing)


@_export
def softmax_with_cross_entropy(logits, label, soft_label=False,
                               ignore_index=-100, numeric_stable_mode=True,
                               return_softmax=False, axis=-1):
    return _op("softmax_with_cross_entropy", logits, label,
               soft_label=soft_label, axis=axis, ignore_index=ignore_index,
               return_softmax=return_softmax)


@_export
def mse_loss(input, label, reduction="mean", name=None):
    return _op("mse_loss", input, label, reduction=reduction)


@_export
def l1_loss(input, label, reduction="mean", name=None):
    return _op("l1_loss", input, label, reduction=reduction)


@_export
def smooth_l1_loss(input, label, reduction="mean", delta=1.0, name=None):
    return _op("smooth_l1_loss", input, label, reduction=reduction,
               delta=delta)


@_export
def nll_loss(input, label, weight=None, ignore_index=-100, reduction="mean",
             name=None):
    return _op("nll_loss", input, label, weight, ignore_index=ignore_index,
               reduction=reduction)


@_export
def binary_cross_entropy(input, label, weight=None, reduction="mean",
                         name=None):
    return _op("bce_loss", input, label, weight, reduction=reduction)


@_export
def binary_cross_entropy_with_logits(logit, label, weight=None,
                                     reduction="mean", pos_weight=None,
                                     name=None):
    return _op("bce_with_logits", logit, label, weight, pos_weight,
               reduction=reduction)


@_export
def kl_div(input, label, reduction="mean", name=None):
    return _op("kl_div", input, label, reduction=reduction)


@_export
def hinge_embedding_loss(input, label, margin=1.0, reduction="mean",
                         name=None):
    return _op("hinge_embedding_loss", input, label, margin=margin,
               reduction=reduction)


@_export
def margin_ranking_loss(input, other, label, margin=0.0, reduction="mean",
                        name=None):
    return _op("margin_ranking_loss", input, other, label, margin=margin,
               reduction=reduction)


@_export
def sigmoid_focal_loss(logit, label, normalizer=None, alpha=0.25, gamma=2.0,
                       reduction="sum", name=None):
    return _op("sigmoid_focal_loss", logit, label, normalizer, alpha=alpha,
               gamma=gamma, reduction=reduction)


@_export
def huber_loss(input, label, delta=1.0, reduction="mean", name=None):
    return _op("huber_loss", input, label, delta=delta, reduction=reduction)


@_export
def square_error_cost(input, label):
    d = _op("subtract", input, label)
    return _op("multiply", d, d)


def _reduce(loss, reduction):
    if reduction == "mean":
        return _op("mean", loss)
    if reduction == "sum":
        return _op("sum", loss)
    return loss


@_export
def pairwise_distance(x, y, p=2.0, epsilon=1e-6, keepdim=False, name=None):
    d = _op("subtract", x, y)
    d = _op("add", d, _op("full_like", d, fill_value=float(epsilon)))
    return _op("p_norm", d, porder=float(p), axis=-1, keepdim=keepdim)


@_export
def cosine_embedding_loss(input1, input2, label, margin=0.0,
                          reduction="mean", name=None):
    cos = _op("cosine_similarity", input1, input2, axis=-1, eps=1e-8)
    one = _op("full_like", cos, fill_value=1.0)
    zero = _op("full_like", cos, fill_value=0.0)
    pos = _op("subtract", one, cos)
    neg = _op("maximum", _op("subtract", cos,
                             _op("scale", one, scale=float(margin))), zero)
    lab = _op("cast", label, dtype=cos.dtype)
    is_pos = _op("cast", _op("equal", lab, one), cos.dtype)
    is_neg = _op("cast", _op("equal", lab, _op("scale", one, scale=-1.0)),
                 cos.dtype)
    loss = _op("add", _op("multiply", is_pos, pos),
               _op("multiply", is_neg, neg))
    return _reduce(loss, reduction)


def _triplet(dp, dn, margin, reduction):
    marg = _op("full_like", dp, fill_value=float(margin))
    loss = _op("maximum", _op("add", _op("subtract", dp, dn), marg),
               _op("full_like", dp, fill_value=0.0))
    return _reduce(loss, reduction)


@_export
def triplet_margin_loss(input, positive, negative, margin=1.0, p=2.0,
                        epsilon=1e-6, swap=False, reduction="mean",
                        name=None):
    dp = pairwise_distance(input, positive, p, epsilon)
    dn = pairwise_distance(input, negative, p, epsilon)
    if swap:
        dn = _op("minimum", dn, pairwise_distance(positive, negative, p,
                                                  epsilon))
    return _triplet(dp, dn, margin, reduction)


@_export
def triplet_margin_with_distance_loss(input, positive, negative,
                                      distance_function=None, margin=1.0,
                                      swap=False, reduction="mean",
                                      name=None):
    dist = distance_function if distance_function is not None else \
        (lambda a, b: pairwise_distance(a, b, 2.0))
    dp, dn = dist(input, positive), dist(input, negative)
    if swap:
        dn = _op("minimum", dn, dist(positive, negative))
    return _triplet(dp, dn, margin, reduction)


@_export
def multi_label_soft_margin_loss(input, label, weight=None,
                                 reduction="mean", name=None):
    lab = _op("cast", label, dtype=input.dtype)
    pos = _op("log_sigmoid", input)
    neg = _op("log_sigmoid", _op("scale", input, scale=-1.0))
    one = _op("full_like", lab, fill_value=1.0)
    per = _op("add", _op("multiply", lab, pos),
              _op("multiply", _op("subtract", one, lab), neg))
    if weight is not None:
        per = _op("multiply", per, weight)
    loss = _op("scale", _op("mean", per, axis=-1), scale=-1.0)
    return _reduce(loss, reduction)


@_export
def dice_loss(input, label, epsilon=1e-5, name=None):
    """``input [N, ..., C]`` probabilities, ``label [N, ..., 1]`` ints."""
    nc = input.shape[-1]
    oh = _op("one_hot", _op("squeeze", label, axis=-1), num_classes=nc)
    ohf = _op("cast", oh, dtype=input.dtype)
    axes = tuple(range(1, input.dim()))
    inter = _op("sum", _op("multiply", input, ohf), axis=axes)
    union = _op("add", _op("sum", input, axis=axes),
                _op("sum", ohf, axis=axes))
    num = _op("scale", inter, scale=2.0)
    eps = _op("full_like", union, fill_value=float(epsilon))
    dice = _op("divide", num, _op("add", union, eps))
    one = _op("full_like", dice, fill_value=1.0)
    return _op("mean", _op("subtract", one, dice))


@_export
def log_loss(input, label, epsilon=1e-4, name=None):
    eps = _op("full_like", input, fill_value=float(epsilon))
    one = _op("full_like", input, fill_value=1.0)
    t1 = _op("multiply", label, _op("log", _op("add", input, eps)))
    t2 = _op("multiply", _op("subtract", one, label),
             _op("log", _op("add", _op("subtract", one, input), eps)))
    return _op("scale", _op("add", t1, t2), scale=-1.0)


@_export
def npair_loss(anchor, positive, labels, l2_reg=0.002):
    """Softmax cross-entropy over anchor-positive similarities with
    same-label targets, plus an L2 term."""
    sim = _op("matmul", anchor, positive, transpose_y=True)
    lab = _op("cast", labels, dtype=sim.dtype)
    n = lab.shape[0]
    li = _op("reshape", lab, shape=(n, 1))
    eq = _op("cast", _op("equal", li, _op("reshape", lab, shape=(1, n))),
             sim.dtype)
    row = _op("sum", eq, axis=1, keepdim=True)
    tgt = _op("divide", eq, row)
    ce = _op("softmax_with_cross_entropy", sim, tgt, soft_label=True)
    l2 = _op("scale", _op("add", _op("sum", _op("multiply", anchor, anchor)),
                          _op("sum", _op("multiply", positive, positive))),
             scale=float(l2_reg) * 0.25 / int(n))
    return _op("add", _op("mean", ce), l2)


@_export
def ctc_loss(log_probs, labels, input_lengths, label_lengths, blank=0,
             reduction="mean", norm_by_times=False):
    """Each sample's negative log-likelihood (``ctc_loss`` op);
    ``norm_by_times`` divides it by the sample's input length first;
    ``"mean"`` divides each by its label length (at least 1) and averages,
    ``"sum"`` adds them, ``"none"`` returns them (the JAX function's
    rules)."""
    loss = _op("ctc_loss", log_probs, labels, input_lengths, label_lengths,
               blank=blank)
    if norm_by_times:
        il = _op("cast", input_lengths, dtype="float32")
        loss = _op("divide", loss, _op("maximum", il, _op(
            "full_like", il, fill_value=1.0)))
    if reduction == "mean":
        ll = _op("cast", label_lengths, dtype="float32")
        return _op("mean", _op("divide", loss, _op("maximum", ll, _op(
            "full_like", ll, fill_value=1.0))))
    return _reduce(loss, reduction)


@_export
def hsigmoid_loss(input, label, num_classes, weight, bias=None,
                  path_table=None, path_code=None, is_sparse=False,
                  name=None):
    return _op("hsigmoid_loss", input, label, weight, bias, path_table,
               path_code, num_classes=num_classes)


@_export
def margin_cross_entropy(logits, label, margin1=1.0, margin2=0.5,
                         margin3=0.0, scale=64.0, group=None,
                         return_softmax=False, reduction="mean"):
    if group is not None:
        raise not_ported("nn.functional.margin_cross_entropy(group=...)", 4)
    out = _op("margin_cross_entropy", logits, label, margin1=margin1,
              margin2=margin2, margin3=margin3, scale=scale,
              return_softmax=return_softmax)
    if return_softmax:
        loss, softmax_out = out
        return _reduce(loss, reduction), softmax_out
    return _reduce(out, reduction)


@_export
def class_center_sample(label, num_classes, num_samples, group=None):
    if group is not None:
        raise not_ported("nn.functional.class_center_sample(group=...)", 4)
    return _op("class_center_sample", label, num_classes=num_classes,
               num_samples=num_samples)


@_export
def sparse_attention(query, key, value, sparse_csr_offset, sparse_csr_columns,
                     key_padding_mask=None, attn_mask=None, name=None):
    """Attention over ``[B, H, L, D]`` restricted to a CSR pattern: the
    pattern as a dense mask, then a masked softmax (the JAX function's
    form, and its plain body on the card too)."""
    return _op("sparse_attention", query, key, value, sparse_csr_offset,
               sparse_csr_columns, key_padding_mask, attn_mask)


# -- in-place variants --------------------------------------------------------

def _inplace(fn, name):
    def f(x, *args, **kwargs):
        out = fn(x, *args, **kwargs)
        with torch.no_grad():
            x.copy_(out)
        return x
    f.__name__ = f.__qualname__ = name
    return _export(f)


relu_ = _inplace(relu, "relu_")
elu_ = _inplace(elu, "elu_")
tanh_ = _inplace(tanh, "tanh_")
softmax_ = _inplace(softmax, "softmax_")
