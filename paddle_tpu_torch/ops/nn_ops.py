"""Neural-network ops (counterpart of ``paddle_tpu/ops/nn_ops.py``):
activations, linear and embedding, convolutions and pooling,
normalization, losses, resizing and attention, each op's plain body.
The hand-written kernels shadow two of them as overrides:
``layer_norm`` (K2/K3, registered in ``nn/layer/norm.py``) and
``scaled_dot_product_attention`` (K4-K7, registered in
``nn/functional``).

The ops that draw random numbers (``alpha_dropout``, ``rrelu``,
``gumbel_softmax``) take a ``torch.Generator`` where the JAX ops take a
key (``None``: the port's generator of the input's device). Activations
stay in channel-first layouts inside (a channel-last ``data_format`` is
moved there and back); weights are the reference's ``[out, in, *k]``
(``[in, out / groups, *k]`` for the transposed convolution)."""
from __future__ import annotations

import math

import torch
from torch.nn import functional as TF

from ..framework.random import get_generator
from .creation_ops import _dropout
from ..framework.dtypes import convert_dtype
from .registry import register_op

__all__ = ["sdpa_reference"]

_NEG_INF = -1e30


@register_op("embedding")
def _embedding(ids, weight, padding_idx=None):
    out = TF.embedding(ids, weight)
    if padding_idx is not None:
        if padding_idx < 0:           # counts back from the vocab size
            padding_idx += weight.shape[0]
        out = torch.where((ids == padding_idx)[..., None], 0.0,
                          out).to(weight.dtype)
    return out


@register_op("linear")
def _linear(x, w, b=None):
    """``x @ w + b`` with ``w`` ``[in, out]``, the JAX package's layout."""
    return TF.linear(x, w.t(), b)


@register_op("gelu")
def _gelu(x, approximate=False):
    return TF.gelu(x, approximate="tanh" if approximate else "none")


@register_op("softmax")
def _softmax(x, axis=-1):
    return torch.softmax(x, dim=int(axis))


@register_op("layer_norm")
def _layer_norm(x, weight=None, bias=None, epsilon=1e-5,
                begin_norm_axis=None):
    """Normalize in f32 over the axes from ``begin_norm_axis`` (the last
    by default), cast back to x's dtype, then scale and shift."""
    dims = tuple(range(x.dim() - 1 if begin_norm_axis is None
                       else begin_norm_axis, x.dim()))
    xf = x.float()
    mean = xf.mean(dim=dims, keepdim=True)
    xc = xf - mean
    var = (xc * xc).mean(dim=dims, keepdim=True)
    out = (xc * torch.rsqrt(var + epsilon)).to(x.dtype)
    if weight is not None:
        out = out * weight
    if bias is not None:
        out = out + bias
    return out


@register_op("scaled_dot_product_attention")
def sdpa_reference(q, k, v, mask=None, dropout_p=0.0, is_causal=False,
                   scale=None):
    """Softmax attention over ``[B, S, H, D]`` as a plain composition
    (``_sdpa``): f32 scores scaled by ``scale`` (``1 / sqrt(D)`` by
    default), a causal mask aligned bottom-right (``tril(k=Sk-Sq)``), a
    bool mask (keep where True) or an additive one, dropout on the
    probabilities, P in V's dtype against V."""
    s = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * s
    if is_causal:
        ql, kl = logits.shape[-2], logits.shape[-1]
        keep = torch.ones(ql, kl, dtype=torch.bool,
                          device=q.device).tril(diagonal=kl - ql)
        logits = logits.masked_fill(~keep, _NEG_INF)
    if mask is not None:
        if mask.dtype == torch.bool:
            logits = logits.masked_fill(~mask, _NEG_INF)
        else:
            logits = logits + mask.float()
    probs = torch.softmax(logits, dim=-1)
    if dropout_p > 0.0:
        probs = _dropout(probs, None, dropout_p)
    out = torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype).float(),
                       v.float())
    return out.to(q.dtype)


def _gen(generator, device):
    return generator if generator is not None else get_generator(device)


# -- activations ----------------------------------------------------------------

def _relu6(x):
    return torch.clamp(x, 0.0, 6.0)


def _mish(x):
    return x * torch.tanh(TF.softplus(x))


def _hardswish(x):
    return x * torch.clamp(x + 3.0, 0.0, 6.0) / 6.0


def _tanhshrink(x):
    return x - torch.tanh(x)


def _softsign(x):
    return x / (1 + x.abs())


for _name, _fn in {
    "relu": torch.relu, "relu6": _relu6, "silu": TF.silu, "swish": TF.silu,
    "softplus_raw": lambda x: torch.logaddexp(x, torch.zeros_like(x)),
    "softsign": _softsign, "mish": _mish, "hardswish": _hardswish,
    "tanhshrink": _tanhshrink, "log_sigmoid": TF.logsigmoid,
}.items():
    register_op(_name)(_fn)

_SELU_ALPHA = 1.6732632423543772
_SELU_SCALE = 1.0507009873554805


@register_op("alpha_dropout")
def _alpha_dropout(x, generator=None, p=0.5):
    # SELU-preserving dropout: dropped units take alpha' and the output is
    # rescaled so that mean and variance are kept
    alpha = _SELU_ALPHA * _SELU_SCALE
    keep = torch.rand(x.shape, generator=_gen(generator, x.device),
                      device=x.device) < 1.0 - p
    a = 1.0 / ((1.0 - p) * (1.0 + p * alpha ** 2)) ** 0.5
    b = -a * alpha * p
    return (torch.where(keep, x, torch.full_like(x, -alpha)) * a
            + b).to(x.dtype)


@register_op("leaky_relu")
def _leaky_relu(x, negative_slope=0.01):
    return TF.leaky_relu(x, negative_slope)


@register_op("elu")
def _elu(x, alpha=1.0):
    return torch.where(x > 0, x, alpha * torch.expm1(x))


@register_op("celu")
def _celu(x, alpha=1.0):
    return torch.where(x > 0, x, alpha * torch.expm1(x / alpha))


@register_op("selu")
def _selu(x, scale=_SELU_SCALE, alpha=_SELU_ALPHA):
    return scale * torch.where(x > 0, x, alpha * torch.expm1(x))


@register_op("hardsigmoid")
def _hardsigmoid(x, slope=0.1666667, offset=0.5):
    return torch.clamp(slope * x + offset, 0.0, 1.0)


@register_op("hardtanh")
def _hardtanh(x, min=-1.0, max=1.0):
    return torch.clamp(x, min, max)


@register_op("hardshrink")
def _hardshrink(x, threshold=0.5):
    return torch.where(x.abs() > threshold, x, torch.zeros_like(x))


@register_op("softshrink")
def _softshrink(x, threshold=0.5):
    zero = torch.zeros_like(x)
    return torch.where(x > threshold, x - threshold,
                       torch.where(x < -threshold, x + threshold, zero))


@register_op("softplus")
def _softplus(x, beta=1.0, threshold=20.0):
    bx = beta * x
    return torch.where(bx > threshold, x,
                       torch.logaddexp(bx, torch.zeros_like(bx)) / beta)


@register_op("thresholded_relu")
def _thresholded_relu(x, threshold=1.0):
    return torch.where(x > threshold, x, torch.zeros_like(x))


@register_op("prelu")
def _prelu(x, alpha):
    a = alpha
    if a.dim() == 1 and x.dim() > 1 and a.shape[0] == x.shape[1]:
        a = a.reshape((1, -1) + (1,) * (x.dim() - 2))
    return torch.where(x > 0, x, a * x)


@register_op("rrelu")
def _rrelu(x, generator=None, lower=0.125, upper=0.333333, training=True):
    if training:
        a = torch.empty_like(x).uniform_(
            lower, upper, generator=_gen(generator, x.device))
    else:
        a = torch.as_tensor((lower + upper) / 2, dtype=x.dtype,
                            device=x.device)
    return torch.where(x >= 0, x, a * x)


@register_op("log_softmax")
def _log_softmax(x, axis=-1):
    return torch.log_softmax(x, dim=int(axis))


@register_op("gumbel_softmax")
def _gumbel_softmax(x, generator=None, temperature=1.0, hard=False, axis=-1):
    u = torch.empty_like(x).uniform_(generator=_gen(generator, x.device))
    tiny = torch.finfo(x.dtype).tiny
    g = -torch.log(-torch.log(u.clamp_min(tiny)))
    y = torch.softmax((x + g) / temperature, dim=axis)
    if hard:
        idx = y.argmax(dim=axis, keepdim=True)
        hard_y = torch.zeros_like(y).scatter(axis, idx, 1.0)
        y = (hard_y - y).detach() + y
    return y


@register_op("maxout")
def _maxout(x, groups, axis=1):
    axis = axis % x.dim()
    c = x.shape[axis]
    shape = x.shape[:axis] + (c // groups, groups) + x.shape[axis + 1:]
    return x.reshape(shape).amax(dim=axis + 1)


@register_op("glu")
def _glu(x, axis=-1):
    a, b = torch.chunk(x, 2, dim=axis)
    return a * torch.sigmoid(b)


# -- linear ------------------------------------------------------------------

@register_op("spectral_norm")
@torch.no_grad()
def _spectral_norm(weight, u, v, dim=0, power_iters=1, eps=1e-12):
    # outside autograd, as the JAX op (registered nondiff)
    w = weight.movedim(dim, 0).reshape(weight.shape[dim], -1)
    for _ in range(max(1, int(power_iters))):
        v = w.t() @ u
        v = v / (torch.linalg.vector_norm(v) + eps)
        u = w @ v
        u = u / (torch.linalg.vector_norm(u) + eps)
    sigma = u @ w @ v
    return weight / sigma


@register_op("bilinear")
def _bilinear(x1, x2, weight, bias=None):
    out = torch.einsum("bi,kij,bj->bk", x1, weight, x2)
    if bias is not None:
        out = out + bias
    return out


# -- conv / pool ---------------------------------------------------------------

def _ntuple(v, nd):
    if isinstance(v, int):
        return (v,) * nd
    return tuple(int(i) for i in v)


def _conv_padding(padding, nd):
    """A padding spec as the JAX ``_conv_padding`` reads it: ``"SAME"`` /
    ``"VALID"``, or a (low, high) pair a spatial dim."""
    if isinstance(padding, str):
        return padding.upper()
    if isinstance(padding, int):
        return [(padding, padding)] * nd
    padding = list(padding)
    if len(padding) == nd and all(isinstance(p, int) for p in padding):
        return [(p, p) for p in padding]
    if len(padding) == 2 * nd:
        return [(padding[2 * i], padding[2 * i + 1]) for i in range(nd)]
    return [tuple(p) for p in padding]


def _same_pads(sizes, ksizes, strides, dilations):
    """XLA's ``SAME`` padding: the output is ``ceil(in / stride)`` long,
    the extra split low-light."""
    pads = []
    for L, k, s, d in zip(sizes, ksizes, strides, dilations):
        out = -(-L // s)
        total = max((out - 1) * s + (k - 1) * d + 1 - L, 0)
        pads.append((total // 2, total - total // 2))
    return pads


def _explicit(pads, sizes, ksizes, strides, dilations):
    if pads == "VALID":
        return [(0, 0)] * len(sizes)
    if pads == "SAME":
        return _same_pads(sizes, ksizes, strides, dilations)
    return pads


def _flat_pads(pads):
    """(low, high) pairs a dim as ``F.pad``'s flat list, the last dim
    first."""
    return [w for lo_hi in reversed(pads) for w in lo_hi]


_CONV = {1: TF.conv1d, 2: TF.conv2d, 3: TF.conv3d}


def _convnd(x, w, bias, stride, padding, dilation, groups, data_format, nd):
    channel_last = not data_format.startswith("NC")
    if channel_last:
        x = x.movedim(-1, 1)
    strides, dil = _ntuple(stride, nd), _ntuple(dilation, nd)
    pads = _explicit(_conv_padding(padding, nd), x.shape[2:], w.shape[2:],
                     strides, dil)
    # float16 computes through float32, as the JAX op does
    fp16 = x.dtype == torch.float16
    if fp16:
        x, w = x.float(), w.float()
    if all(lo == hi for lo, hi in pads):
        out = _CONV[nd](x, w, None, strides, [lo for lo, _ in pads], dil,
                        int(groups))
    else:
        out = _CONV[nd](TF.pad(x, _flat_pads(pads)), w, None, strides, 0,
                        dil, int(groups))
    if fp16:
        out = out.half()
    if bias is not None:
        out = out + bias.reshape((1, -1) + (1,) * nd)
    return out.movedim(1, -1) if channel_last else out


@register_op("conv2d")
def _conv2d(x, w, bias=None, stride=1, padding=0, dilation=1, groups=1,
            data_format="NCHW"):
    return _convnd(x, w, bias, stride, padding, dilation, groups,
                   data_format, nd=2)


@register_op("conv1d")
def _conv1d(x, w, bias=None, stride=1, padding=0, dilation=1, groups=1,
            data_format="NCL"):
    return _convnd(x, w, bias, stride, padding, dilation, groups,
                   data_format, nd=1)


@register_op("conv3d")
def _conv3d(x, w, bias=None, stride=1, padding=0, dilation=1, groups=1,
            data_format="NCDHW"):
    return _convnd(x, w, bias, stride, padding, dilation, groups,
                   data_format, nd=3)


def _transpose_str_pads(s, in_sizes, ksizes, strides):
    """Explicit pads for a transposed convolution's string padding (the
    reference's ``UpdatePaddingAndDilation``): ``VALID`` none; ``SAME``
    ``max((ceil(in / stride) - 1) * stride + k - in, 0)`` from the input
    size, split low-light."""
    if s == "VALID":
        return [(0, 0)] * len(ksizes)
    pads = []
    for L, k, st in zip(in_sizes, ksizes, strides):
        total = max((-(-L // st) - 1) * st + k - L, 0)
        pads.append((total // 2, total - total // 2))
    return pads


_CONV_T = {1: TF.conv_transpose1d, 2: TF.conv_transpose2d,
           3: TF.conv_transpose3d}


def _conv_transpose_nd(x, w, bias, stride, padding, output_padding,
                       dilation, groups, channel_last, nd):
    """The gradient of a convolution, ``w`` ``[in, out / groups, *k]``:
    the full transposed convolution, then each dim cut by its low pad and
    by its high pad less ``output_padding`` (a negative cut is a zero
    extension, as the JAX op's padded form gives)."""
    if channel_last:
        x = x.movedim(-1, 1)
    strides = _ntuple(stride, nd)
    dil = _ntuple(dilation, nd)
    opad = _ntuple(output_padding, nd)
    pads = _conv_padding(padding, nd)
    if isinstance(pads, str):
        if pads == "SAME":
            dil = (1,) * nd            # the reference forces dilation 1
        pads = _transpose_str_pads(pads, x.shape[2:], w.shape[2:], strides)
    out = _CONV_T[nd](x, w, None, strides, 0, 0, int(groups), dil)
    cut = [(-lo, op - hi) for (lo, hi), op in zip(pads, opad)]
    out = TF.pad(out, _flat_pads(cut))
    if bias is not None:
        out = out + bias.reshape((1, -1) + (1,) * nd)
    return out.movedim(1, -1) if channel_last else out


@register_op("conv2d_transpose")
def _conv2d_transpose(x, w, bias=None, stride=1, padding=0,
                      output_padding=0, dilation=1, groups=1,
                      data_format="NCHW", output_size=None):
    return _conv_transpose_nd(x, w, bias, stride, padding, output_padding,
                              dilation, groups, data_format != "NCHW", 2)


_AVG = {1: TF.avg_pool1d, 2: TF.avg_pool2d, 3: TF.avg_pool3d}
_MAX = {1: TF.max_pool1d, 2: TF.max_pool2d, 3: TF.max_pool3d}


def _pool(x, ksize, stride, padding, nd, data_format, mode,
          ceil_mode=False, exclusive=True):
    """``lax.reduce_window`` pooling as the JAX ``_pool``: explicit pads
    hold the reduction's identity (-inf for max, 0 for the sum), so they
    never win a max nor count in an exclusive average; ``ceil_mode``
    extends each dim's high pad so a trailing partial window gives one
    more output."""
    channel_last = not data_format.startswith("NC")
    if channel_last:
        x = x.movedim(-1, 1)
    ksize = _ntuple(ksize, nd)
    stride = _ntuple(stride if stride is not None else ksize, nd)
    spatial = x.shape[2:]
    pads = _conv_padding(padding, nd)
    if isinstance(pads, str):
        pads = _explicit(pads, spatial, ksize, stride, (1,) * nd)
    elif ceil_mode:
        pads = [(p0, p1 + (-(L + p0 + p1 - k)) % s)
                for (p0, p1), L, k, s in zip(pads, spatial, ksize, stride)]
    flat = _flat_pads(pads)
    if mode == "max":
        low = float("-inf") if x.is_floating_point() \
            else torch.iinfo(x.dtype).min
        out = _MAX[nd](TF.pad(x, flat, value=low), ksize, stride)
    else:
        window = math.prod(ksize)
        s = _AVG[nd](TF.pad(x, flat), ksize, stride) * window
        if exclusive:
            ones = torch.ones((1, 1) + tuple(spatial), dtype=x.dtype,
                              device=x.device)
            cnt = _AVG[nd](TF.pad(ones, flat), ksize, stride) * window
        else:
            cnt = window
        out = s / cnt
    return out.movedim(1, -1) if channel_last else out


@register_op("max_pool2d")
def _max_pool2d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
                data_format="NCHW"):
    return _pool(x, kernel_size, stride, padding, 2, data_format, "max",
                 ceil_mode)


@register_op("avg_pool2d")
def _avg_pool2d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
                exclusive=True, data_format="NCHW"):
    return _pool(x, kernel_size, stride, padding, 2, data_format, "avg",
                 ceil_mode, exclusive)


@register_op("max_pool1d")
def _max_pool1d(x, kernel_size, stride=None, padding=0, ceil_mode=False):
    return _pool(x, kernel_size, stride, padding, 1, "NCL", "max", ceil_mode)


@register_op("avg_pool1d")
def _avg_pool1d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
                exclusive=True):
    return _pool(x, kernel_size, stride, padding, 1, "NCL", "avg",
                 ceil_mode, exclusive)


@register_op("max_pool3d")
def _max_pool3d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
                data_format="NCDHW"):
    return _pool(x, kernel_size, stride, padding, 3, data_format, "max",
                 ceil_mode)


@register_op("avg_pool3d")
def _avg_pool3d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
                exclusive=True, data_format="NCDHW"):
    return _pool(x, kernel_size, stride, padding, 3, data_format, "avg",
                 ceil_mode, exclusive)


_ADAPTIVE = {("avg", 1): TF.adaptive_avg_pool1d,
             ("avg", 2): TF.adaptive_avg_pool2d,
             ("avg", 3): TF.adaptive_avg_pool3d,
             ("max", 1): TF.adaptive_max_pool1d,
             ("max", 2): TF.adaptive_max_pool2d,
             ("max", 3): TF.adaptive_max_pool3d}


def _adaptive_pool(x, output_size, nd, data_format, mode):
    """Window i of a dim of ``in`` values over ``[floor(i * in / out),
    ceil((i + 1) * in / out))``, the JAX op's (and torch's) windows."""
    channel_last = not data_format.startswith("NC")
    if channel_last:
        x = x.movedim(-1, 1)
    sizes = _ntuple(output_size, nd) if not isinstance(output_size, (
        list, tuple)) else tuple(output_size)
    sizes = tuple(x.shape[2 + d] if s is None else int(s)
                  for d, s in enumerate(sizes))
    out = _ADAPTIVE[(mode, nd)](x, sizes)
    return out.movedim(1, -1) if channel_last else out


@register_op("adaptive_avg_pool2d")
def _adaptive_avg_pool2d(x, output_size, data_format="NCHW"):
    return _adaptive_pool(x, output_size, 2, data_format, "avg")


@register_op("adaptive_max_pool2d")
def _adaptive_max_pool2d(x, output_size, data_format="NCHW"):
    return _adaptive_pool(x, output_size, 2, data_format, "max")


@register_op("adaptive_avg_pool1d")
def _adaptive_avg_pool1d(x, output_size):
    return _adaptive_pool(x, output_size, 1, "NCL", "avg")


@register_op("adaptive_max_pool1d")
def _adaptive_max_pool1d(x, output_size):
    return _adaptive_pool(x, output_size, 1, "NCL", "max")


# -- normalization ------------------------------------------------------------

@register_op("batch_norm")
def _batch_norm(x, running_mean, running_var, weight=None, bias=None,
                training=False, momentum=0.9, epsilon=1e-5,
                data_format="NCHW"):
    """``(y, new_mean, new_var)``: the running statistics' update is an
    output, as in the JAX op; in training the batch's biased variance
    normalizes and its unbiased one goes into the running average
    ``momentum * running + (1 - momentum) * batch``."""
    c_axis = 1 if data_format.startswith("NC") else x.dim() - 1
    axes = tuple(i for i in range(x.dim()) if i != c_axis)
    bshape = tuple(-1 if i == c_axis else 1 for i in range(x.dim()))
    xf = x.float()
    if training:
        mean = xf.mean(dim=axes)
        var = xf.var(dim=axes, correction=0)
        n = x.numel() // x.shape[c_axis]
        unbiased = var * (n / max(n - 1, 1))
        new_mean = momentum * running_mean + (1 - momentum) * mean
        new_var = momentum * running_var + (1 - momentum) * unbiased
    else:
        mean, var = running_mean.float(), running_var.float()
        new_mean, new_var = running_mean, running_var
    out = (xf - mean.reshape(bshape)) * torch.rsqrt(
        var.reshape(bshape) + epsilon)
    out = out.to(x.dtype)
    if weight is not None:
        out = out * weight.reshape(bshape)
    if bias is not None:
        out = out + bias.reshape(bshape)
    return out, new_mean.to(running_mean.dtype), \
        new_var.to(running_var.dtype)


def _affine_nc(out, weight, bias):
    bshape = (1, -1) + (1,) * (out.dim() - 2)
    if weight is not None:
        out = out * weight.reshape(bshape)
    if bias is not None:
        out = out + bias.reshape(bshape)
    return out


@register_op("instance_norm")
def _instance_norm(x, weight=None, bias=None, epsilon=1e-5):
    axes = tuple(range(2, x.dim()))
    xf = x.float()
    mean = xf.mean(dim=axes, keepdim=True)
    var = xf.var(dim=axes, correction=0, keepdim=True)
    out = ((xf - mean) * torch.rsqrt(var + epsilon)).to(x.dtype)
    return _affine_nc(out, weight, bias)


@register_op("group_norm")
def _group_norm(x, weight=None, bias=None, epsilon=1e-5, num_groups=1,
                data_format="NCHW"):
    if not data_format.startswith("NC"):
        out = _group_norm(x.movedim(-1, 1), weight, bias, epsilon,
                          num_groups, "NCHW")
        return out.movedim(1, -1)
    n, c = x.shape[0], x.shape[1]
    g = int(num_groups)
    xf = x.float().reshape((n, g, c // g) + tuple(x.shape[2:]))
    axes = tuple(range(2, xf.dim()))
    mean = xf.mean(dim=axes, keepdim=True)
    var = xf.var(dim=axes, correction=0, keepdim=True)
    out = ((xf - mean) * torch.rsqrt(var + epsilon)).reshape(x.shape) \
        .to(x.dtype)
    return _affine_nc(out, weight, bias)


@register_op("rms_norm")
def _rms_norm(x, weight=None, epsilon=1e-6):
    xf = x.float()
    ms = (xf * xf).mean(dim=-1, keepdim=True)
    out = (xf * torch.rsqrt(ms + epsilon)).to(x.dtype)
    return out * weight if weight is not None else out


@register_op("local_response_norm")
def _lrn(x, size=5, alpha=1e-4, beta=0.75, k=1.0):
    # the JAX op's window sum over channels (alpha not divided by size)
    sq = x * x
    half = size // 2
    pad = [0, 0] * (x.dim() - 2) + [half, size - 1 - half]
    padded = TF.pad(sq, pad)
    acc = torch.zeros_like(x)
    for i in range(size):
        acc = acc + padded.narrow(1, i, x.shape[1])
    return x / torch.pow(k + alpha * acc, beta)


@register_op("normalize_l2")
def _normalize(x, p=2.0, axis=1, epsilon=1e-12):
    norm = torch.pow(torch.pow(x.abs(), p).sum(dim=axis, keepdim=True),
                     1.0 / p)
    return x / torch.clamp_min(norm, epsilon)


# -- losses ---------------------------------------------------------------------

def _reduce_loss(loss, reduction):
    if reduction == "mean":
        return loss.mean()
    if reduction == "sum":
        return loss.sum()
    return loss


@register_op("softmax_with_cross_entropy")
def _softmax_ce(logits, label, soft_label=False, axis=-1,
                ignore_index=-100, return_softmax=False):
    axis = axis % logits.dim()
    logp = torch.log_softmax(logits.float(), dim=axis)
    if soft_label:
        loss = -(label * logp).sum(dim=axis, keepdim=True)
    else:
        lbl = label.squeeze(axis) if label.dim() == logits.dim() else label
        ignored = (lbl == ignore_index).unsqueeze(axis)
        safe = torch.where(lbl == ignore_index, torch.zeros_like(lbl), lbl)
        gathered = logp.gather(axis, safe.long().unsqueeze(axis))
        loss = -torch.where(ignored, torch.zeros_like(gathered), gathered)
    loss = loss.to(logits.dtype)
    if return_softmax:
        return loss, torch.exp(logp).to(logits.dtype)
    return loss


@register_op("cross_entropy")
def _cross_entropy(logits, label, weight=None, soft_label=False, axis=-1,
                   ignore_index=-100, reduction="mean", use_softmax=True,
                   label_smoothing=0.0):
    """Softmax cross-entropy over ``axis`` in f32: hard labels (an int a
    row, or a size-1 ``axis``) or ``soft_label`` distributions;
    ``use_softmax=False`` takes ``logits`` as probabilities;
    ``label_smoothing`` mixes in the uniform distribution; ``weight
    [classes]`` weighs each row by its label's class. Hard labels equal to
    ``ignore_index`` count nothing. ``reduction="mean"`` divides by the
    valid rows, or by the summed weights when there are weights."""
    axis = axis % logits.dim()
    lf = logits.float()
    logp = torch.log_softmax(lf, dim=axis) if use_softmax \
        else torch.log(lf.clamp_min(1e-30))
    n_cls = logits.shape[axis]
    w = None
    if soft_label:
        sl = label.float()
        if label_smoothing > 0:
            sl = sl * (1 - label_smoothing) + label_smoothing / n_cls
        loss = -(sl * logp).sum(dim=axis)
        valid = torch.ones_like(loss, dtype=torch.bool)
        if weight is not None:
            w = (sl * weight.float().reshape((1,) * axis + (-1,))).sum(
                dim=axis)
    else:
        lbl = label
        if lbl.dim() == logits.dim() and lbl.shape[axis] == 1:
            lbl = lbl.squeeze(axis)
        valid = lbl != ignore_index
        safe = torch.where(valid, lbl, torch.zeros_like(lbl)).long()
        nll = -logp.gather(axis, safe.unsqueeze(axis)).squeeze(axis)
        if label_smoothing > 0:
            nll = (1 - label_smoothing) * nll \
                + label_smoothing * -logp.mean(dim=axis)
        loss = torch.where(valid, nll, torch.zeros_like(nll))
        if weight is not None:
            w = torch.where(valid, weight.float()[safe],
                            torch.zeros_like(nll))
    if w is not None:
        loss = loss * w
    if reduction == "mean":
        denom = w.sum().clamp_min(1e-12) if w is not None \
            else valid.sum().float().clamp_min(1.0)
        return (loss.sum() / denom).to(logits.dtype)
    if reduction == "sum":
        return loss.sum().to(logits.dtype)
    return loss.to(logits.dtype)


@register_op("mse_loss")
def _mse_loss(x, y, reduction="mean"):
    return _reduce_loss(torch.square(x - y), reduction)


@register_op("l1_loss")
def _l1_loss(x, y, reduction="mean"):
    return _reduce_loss((x - y).abs(), reduction)


@register_op("smooth_l1_loss")
def _smooth_l1(x, y, reduction="mean", delta=1.0):
    d = (x - y).abs()
    loss = torch.where(d < delta, 0.5 * d * d / delta, d - 0.5 * delta)
    return _reduce_loss(loss, reduction)


@register_op("huber_loss")
def _huber(x, y, reduction="mean", delta=1.0):
    d = (x - y).abs()
    loss = torch.where(d <= delta, 0.5 * d * d, delta * (d - 0.5 * delta))
    return _reduce_loss(loss, reduction)


@register_op("nll_loss")
def _nll_loss(logp, label, weight=None, ignore_index=-100, reduction="mean"):
    lbl = label.long()
    valid = lbl != ignore_index
    safe = torch.where(valid, lbl, torch.zeros_like(lbl))
    moved = logp.movedim(1, -1) if logp.dim() > 2 else logp
    picked = moved.gather(-1, safe[..., None])[..., 0]
    zero = torch.zeros_like(picked)
    loss = -torch.where(valid, picked, zero)
    if weight is not None:
        w = torch.where(valid, weight[safe], zero)
        loss = loss * weight[safe]
    else:
        w = valid.to(logp.dtype)
    loss = torch.where(valid, loss, zero)
    if reduction == "mean":
        return loss.sum() / w.sum().clamp_min(1e-12)
    if reduction == "sum":
        return loss.sum()
    return loss


@register_op("bce_loss")
def _bce(x, label, weight=None, reduction="mean"):
    eps = 1e-12
    loss = -(label * torch.log(x.clamp_min(eps))
             + (1 - label) * torch.log((1 - x).clamp_min(eps)))
    if weight is not None:
        loss = loss * weight
    return _reduce_loss(loss, reduction)


@register_op("bce_with_logits")
def _bce_logits(x, label, weight=None, pos_weight=None, reduction="mean"):
    softplus_neg_abs = torch.log1p(torch.exp(-x.abs()))
    if pos_weight is not None:
        log_w = (pos_weight - 1) * label + 1
        loss = (1 - label) * x + log_w * (softplus_neg_abs
                                          + torch.clamp_min(-x, 0.0))
    else:
        loss = torch.clamp_min(x, 0) - x * label + softplus_neg_abs
    if weight is not None:
        loss = loss * weight
    return _reduce_loss(loss, reduction)


@register_op("kl_div")
def _kl_div(x, target, reduction="mean"):
    loss = target * (torch.log(target.clamp_min(1e-12)) - x)
    loss = torch.where(target > 0, loss, torch.zeros_like(loss))
    if reduction == "batchmean":
        return loss.sum() / x.shape[0]
    return _reduce_loss(loss, reduction)


@register_op("margin_ranking_loss")
def _margin_ranking(x, y, label, margin=0.0, reduction="mean"):
    return _reduce_loss(torch.clamp_min(-label * (x - y) + margin, 0.0),
                        reduction)


@register_op("hinge_embedding_loss")
def _hinge_embedding(x, label, margin=1.0, reduction="mean"):
    loss = torch.where(label == 1, x, torch.clamp_min(margin - x, 0.0))
    return _reduce_loss(loss, reduction)


@register_op("cosine_similarity")
def _cosine_similarity(x, y, axis=1, eps=1e-8):
    dot = (x * y).sum(dim=axis)
    nx = torch.sqrt((x * x).sum(dim=axis))
    ny = torch.sqrt((y * y).sum(dim=axis))
    return dot / torch.clamp_min(nx * ny, eps)


@register_op("label_smooth")
def _label_smooth(label, prior_dist=None, epsilon=0.1):
    if prior_dist is not None:
        return (1 - epsilon) * label + epsilon * prior_dist
    return (1 - epsilon) * label + epsilon / label.shape[-1]


@register_op("sigmoid_focal_loss")
def _sigmoid_focal_loss(logit, label, normalizer=None, alpha=0.25,
                        gamma=2.0, reduction="sum"):
    p = torch.sigmoid(logit)
    ce = torch.clamp_min(logit, 0) - logit * label \
        + torch.log1p(torch.exp(-logit.abs()))
    p_t = p * label + (1 - p) * (1 - label)
    loss = ce * ((1 - p_t) ** gamma)
    if alpha >= 0:
        loss = (alpha * label + (1 - alpha) * (1 - label)) * loss
    if normalizer is not None:
        loss = loss / normalizer
    return _reduce_loss(loss, reduction)


# -- resizing and rearrangement -------------------------------------------------

def _keys_cubic(t):
    out = ((1.5 * t - 2.5) * t) * t + 1.0
    out = torch.where(t >= 1.0, ((-0.5 * t + 2.5) * t - 4.0) * t + 2.0, out)
    return torch.where(t >= 2.0, torch.zeros_like(t), out)


def _triangle(t):
    return torch.clamp_min(1 - t.abs(), 0)


def _resize_weights(n_in, n_out, kernel, device):
    """``jax.image``'s weight matrix ``[n_in, n_out]`` for resizing one
    dim (half-pixel centres, the kernel widened by the downscale factor,
    columns normalised; a sample outside the input gets none)."""
    inv = n_in / n_out
    kscale = max(inv, 1.0)
    f64 = torch.float64
    sample = (torch.arange(n_out, dtype=f64, device=device) + 0.5) * inv \
        - 0.5
    src = torch.arange(n_in, dtype=f64, device=device)
    w = kernel((sample[None, :] - src[:, None]).abs() / kscale)
    total = w.sum(0, keepdim=True)
    eps = 1000.0 * torch.finfo(torch.float32).eps
    w = torch.where(total.abs() > eps,
                    w / torch.where(total != 0, total,
                                    torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w))


def _interp_align_corners(x, size, method, axes):
    """``map_coordinates`` at ``linspace(0, in - 1, out)`` along each
    resized dim: linear (order 1) or nearest, rounding halves up."""
    out = x
    for ax, n_out in zip(axes, size):
        n_in = out.shape[ax]
        c = torch.zeros(1, dtype=torch.float64, device=x.device) \
            if n_out == 1 else torch.linspace(0, n_in - 1, n_out,
                                              dtype=torch.float64,
                                              device=x.device)
        moved = out.movedim(ax, -1)
        if method == "linear":
            lo = torch.floor(c).long().clamp(0, n_in - 1)
            hi = (lo + 1).clamp(max=n_in - 1)
            w = (c - lo).to(x.dtype)
            res = moved[..., lo] * (1 - w) + moved[..., hi] * w
        else:
            res = moved[..., torch.floor(c + 0.5).long()]
        out = res.movedim(-1, ax)
    return out


@register_op("interpolate")
def _interpolate(x, size=None, scale_factor=None, mode="nearest",
                 align_corners=False, data_format="NCHW"):
    """``jax.image.resize`` over the spatial dims (antialiased when a dim
    shrinks; ``"bicubic"`` is Keys' cubic, ``"area"`` the triangle);
    ``align_corners`` samples at the corner-aligned grid through
    ``map_coordinates``, linear for the linear modes and nearest
    otherwise, as the JAX op does."""
    nchw = data_format.startswith("NC")
    axes = list(range(2, x.dim())) if nchw else list(range(1, x.dim() - 1))
    spatial = [x.shape[a] for a in axes]
    nd = len(spatial)
    if size is None:
        sf = (scale_factor,) * nd if isinstance(scale_factor, (int, float)) \
            else tuple(scale_factor)
        size = tuple(int(s * f) for s, f in zip(spatial, sf))
    else:
        size = _ntuple(size, nd)
    method = {"nearest": "nearest", "bilinear": "linear",
              "linear": "linear", "trilinear": "linear",
              "bicubic": "cubic", "area": "linear"}[mode]
    if align_corners and method != "nearest":
        return _interp_align_corners(x, size, method, axes).to(x.dtype)
    out = x
    for ax, n_in, n_out in zip(axes, spatial, size):
        if n_in == n_out:
            continue
        if method == "nearest":
            pos = (torch.arange(n_out, dtype=torch.float32,
                                device=x.device) + 0.5) * n_in / n_out
            out = out.index_select(ax, torch.floor(pos).long())
            continue
        kernel = _triangle if method == "linear" else _keys_cubic
        w = _resize_weights(n_in, n_out, kernel, x.device).to(x.dtype)
        out = (out.movedim(ax, -1) @ w).movedim(-1, ax)
    return out.to(x.dtype)


@register_op("pixel_shuffle")
def _pixel_shuffle(x, upscale_factor, data_format="NCHW"):
    r = int(upscale_factor)
    if data_format == "NCHW":
        return TF.pixel_shuffle(x, r)
    return TF.pixel_shuffle(x.movedim(-1, 1), r).movedim(1, -1)


@register_op("unfold")
def _unfold(x, kernel_sizes, strides=1, paddings=0, dilations=1):
    ks, st = _ntuple(kernel_sizes, 2), _ntuple(strides, 2)
    dl = _ntuple(dilations, 2)
    pads = _explicit(_conv_padding(paddings, 2), x.shape[2:], ks, st, dl)
    return TF.unfold(TF.pad(x, _flat_pads(pads)), ks, dl, 0, st)


@register_op("sequence_mask")
def _sequence_mask(lengths, maxlen=None, dtype="int64"):
    if maxlen is None:
        raise ValueError("maxlen must be provided under jit")
    r = torch.arange(int(maxlen), device=lengths.device)
    return (r < lengths[..., None]).to(convert_dtype(dtype))
