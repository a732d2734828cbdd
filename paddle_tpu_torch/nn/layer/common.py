"""Common layers (counterpart of ``paddle_tpu/nn/layer/common.py``):
``Linear``, ``Embedding``, the dropouts, ``Flatten``, padding,
upsampling, ``Bilinear`` and the distances.

``Linear`` keeps torch's ``[out, in]`` weight and runs the ``linear`` op
on its transpose (the JAX package's ``[in, out]``); its weight is drawn
in the JAX layout by the initializer (``XavierUniform`` by default, so
the fans are the JAX layer's) and stored transposed. The weight carries
the mark ``_jax_perm = (1, 0)``, the permutation that gives its JAX
layout (``Layer._jax_perms``); ``jax_view`` and ``port_axis``
(``layers.py``) read it, so the code that reads axes off a weight
(``nn.utils``, ``quantization``, ``convert``) takes the JAX package's
axis numbers, and this is the one place that knows the layouts differ.
``weight_attr`` and ``bias_attr`` (``nn.ParamAttr``, an initializer, a
name, or ``bias_attr=False`` for no bias) go onto its parameters as in
the JAX layer. ``device``/``dtype`` (keyword-only) place a ``Linear``'s
parameters.
"""
from __future__ import annotations

import torch

from ...framework.dispatch import call_op
from .. import functional as F
from ..initializer import Normal, XavierUniform
from .layers import Layer, ParamAttr, make_parameter

__all__ = [
    "ZeroPad2D", "PairwiseDistance",
    "Identity", "Linear", "Embedding", "Dropout", "Dropout2D", "Dropout3D",
    "AlphaDropout", "Flatten", "Pad1D", "Pad2D", "Pad3D", "Upsample",
    "UpsamplingBilinear2D", "UpsamplingNearest2D", "CosineSimilarity",
    "PixelShuffle", "Unfold", "Bilinear", "Fold", "PixelUnshuffle",
    "ChannelShuffle",
]


class Identity(Layer):
    def forward(self, x):
        return x


class Linear(Layer):
    """``y = x W^T + b`` through the ``linear`` op (which takes ``W^T``,
    the JAX package's ``[in, out]`` layout); under ``amp.auto_cast`` x, W
    and b run in the AMP dtype (``linear`` is on the white list)."""

    _jax_perms = {"weight": (1, 0)}

    def __init__(self, in_features, out_features, weight_attr=None,
                 bias_attr=None, name=None, *, device=None, dtype=None):
        super().__init__(dtype=dtype)
        if ParamAttr._to_attr(weight_attr) is False:
            raise ValueError("Linear needs its weight: weight_attr=False")
        self.in_features = self._in_features = in_features
        self.out_features = self._out_features = out_features
        self.weight = make_parameter(
            [in_features, out_features], weight_attr, self._dtype,
            default_initializer=XavierUniform(), device=device)
        self.weight.data = self.weight.data.t().contiguous()
        self._mark_layouts()
        self.bias = make_parameter([out_features], bias_attr, self._dtype,
                                   is_bias=True, device=device)

    def forward(self, x):
        return call_op("linear", x, self.weight.t(), self.bias)

    def extra_repr(self):
        return f"in_features={self._in_features}, " \
               f"out_features={self._out_features}"


class Embedding(Layer):
    """A lookup table ``[num_embeddings, embedding_dim]`` (``Normal(0,
    1)`` by default; the ``padding_idx`` row zero, and its lookups zero)
    through the ``embedding`` op. ``sparse`` is taken and has no effect:
    the gradient is dense, as in the JAX package."""

    def __init__(self, num_embeddings, embedding_dim, padding_idx=None,
                 sparse=False, weight_attr=None, name=None):
        super().__init__()
        self._num_embeddings = num_embeddings
        self._embedding_dim = embedding_dim
        self._padding_idx = padding_idx
        self.weight = self.create_parameter(
            [num_embeddings, embedding_dim], attr=weight_attr,
            default_initializer=Normal(0.0, 1.0))
        if padding_idx is not None:
            idx = padding_idx if padding_idx >= 0 \
                else num_embeddings + padding_idx
            with torch.no_grad():
                self.weight[idx] = 0.0

    def forward(self, x):
        return F.embedding(x, self.weight, padding_idx=self._padding_idx)

    def extra_repr(self):
        return f"{self._num_embeddings}, {self._embedding_dim}"


class Dropout(Layer):
    """Dropout with probability ``p`` (``functional.dropout``: ``axis``
    and ``mode`` as in the JAX layer); the identity in eval mode or at
    ``p == 0``, except that ``"downscale_in_infer"`` scales by ``1 - p``
    in eval."""

    def __init__(self, p=0.5, axis=None, mode="upscale_in_train",
                 name=None):
        super().__init__()
        self.p = float(p)
        self.axis = axis
        self.mode = mode

    def forward(self, x):
        return F.dropout(x, p=self.p, axis=self.axis, training=self.training,
                         mode=self.mode)

    def extra_repr(self):
        return f"p={self.p}"


class Dropout2D(Layer):
    def __init__(self, p=0.5, data_format="NCHW", name=None):
        super().__init__()
        self.p = p
        self.data_format = data_format

    def forward(self, x):
        return F.dropout2d(x, p=self.p, training=self.training,
                           data_format=self.data_format)


class Dropout3D(Layer):
    def __init__(self, p=0.5, data_format="NCDHW", name=None):
        super().__init__()
        self.p = p
        self.data_format = data_format

    def forward(self, x):
        return F.dropout3d(x, p=self.p, training=self.training,
                           data_format=self.data_format)


class AlphaDropout(Layer):
    def __init__(self, p=0.5, name=None):
        super().__init__()
        self.p = p

    def forward(self, x):
        return F.alpha_dropout(x, p=self.p, training=self.training)


class Flatten(Layer):
    def __init__(self, start_axis=1, stop_axis=-1):
        super().__init__()
        self.start_axis = start_axis
        self.stop_axis = stop_axis

    def forward(self, x):
        return call_op("flatten", x, start_axis=self.start_axis,
                       stop_axis=self.stop_axis)


class _PadND(Layer):
    def __init__(self, padding, mode="constant", value=0.0, data_format=None):
        super().__init__()
        self.padding = padding
        self.mode = mode
        self.value = value
        self.data_format = data_format

    def forward(self, x):
        return F.pad(x, self.padding, mode=self.mode, value=self.value,
                     data_format=self.data_format)


class Pad1D(_PadND):
    def __init__(self, padding, mode="constant", value=0.0,
                 data_format="NCL", name=None):
        super().__init__(padding, mode, value, data_format)


class Pad2D(_PadND):
    def __init__(self, padding, mode="constant", value=0.0,
                 data_format="NCHW", name=None):
        super().__init__(padding, mode, value, data_format)


class Pad3D(_PadND):
    def __init__(self, padding, mode="constant", value=0.0,
                 data_format="NCDHW", name=None):
        super().__init__(padding, mode, value, data_format)


class Upsample(Layer):
    def __init__(self, size=None, scale_factor=None, mode="nearest",
                 align_corners=False, align_mode=0, data_format="NCHW",
                 name=None):
        super().__init__()
        self.size = size
        self.scale_factor = scale_factor
        self.mode = mode
        self.align_corners = align_corners
        self.align_mode = align_mode
        self.data_format = data_format

    def forward(self, x):
        return F.interpolate(x, size=self.size,
                             scale_factor=self.scale_factor, mode=self.mode,
                             align_corners=self.align_corners,
                             data_format=self.data_format)


class UpsamplingNearest2D(Upsample):
    def __init__(self, size=None, scale_factor=None, data_format="NCHW",
                 name=None):
        super().__init__(size, scale_factor, "nearest", False, 0, data_format)


class UpsamplingBilinear2D(Upsample):
    def __init__(self, size=None, scale_factor=None, data_format="NCHW",
                 name=None):
        super().__init__(size, scale_factor, "bilinear", True, 0, data_format)


class CosineSimilarity(Layer):
    def __init__(self, axis=1, eps=1e-8):
        super().__init__()
        self.axis = axis
        self.eps = eps

    def forward(self, x1, x2):
        return F.cosine_similarity(x1, x2, axis=self.axis, eps=self.eps)


class PixelShuffle(Layer):
    def __init__(self, upscale_factor, data_format="NCHW", name=None):
        super().__init__()
        self.upscale_factor = upscale_factor
        self.data_format = data_format

    def forward(self, x):
        return F.pixel_shuffle(x, self.upscale_factor, self.data_format)


class Unfold(Layer):
    def __init__(self, kernel_sizes, strides=1, paddings=0, dilations=1,
                 name=None):
        super().__init__()
        self.kernel_sizes = kernel_sizes
        self.strides = strides
        self.paddings = paddings
        self.dilations = dilations

    def forward(self, x):
        return F.unfold(x, self.kernel_sizes, self.strides, self.paddings,
                        self.dilations)


class Bilinear(Layer):
    """``out[b, k] = x1[b] @ W[k] @ x2[b] + bias`` (weight ``[out, in1,
    in2]``, bias ``[1, out]``, as in the JAX layer)."""

    def __init__(self, in1_features, in2_features, out_features,
                 weight_attr=None, bias_attr=None, name=None):
        super().__init__()
        self.weight = self.create_parameter(
            [out_features, in1_features, in2_features], attr=weight_attr)
        self.bias = self.create_parameter([1, out_features], attr=bias_attr,
                                          is_bias=True)

    def forward(self, x1, x2):
        return call_op("bilinear", x1, x2, self.weight, self.bias)


class Fold(Layer):
    """col2im, the adjoint of ``Unfold``."""

    def __init__(self, output_sizes, kernel_sizes, strides=1, paddings=0,
                 dilations=1, name=None):
        super().__init__()
        self._a = (output_sizes, kernel_sizes, strides, paddings, dilations)

    def forward(self, x):
        o, k, s, p, d = self._a
        return F.fold(x, o, k, s, p, d)


class PixelUnshuffle(Layer):
    def __init__(self, downscale_factor, data_format="NCHW", name=None):
        super().__init__()
        self._r = downscale_factor
        self._df = data_format

    def forward(self, x):
        return F.pixel_unshuffle(x, self._r, self._df)


class ChannelShuffle(Layer):
    def __init__(self, groups, data_format="NCHW", name=None):
        super().__init__()
        self._g = groups
        self._df = data_format

    def forward(self, x):
        return F.channel_shuffle(x, self._g, self._df)


class ZeroPad2D(Layer):
    def __init__(self, padding, data_format="NCHW", name=None):
        super().__init__()
        self._p = padding
        self._df = data_format

    def forward(self, x):
        return F.zeropad2d(x, self._p, self._df)


class PairwiseDistance(Layer):
    def __init__(self, p=2.0, epsilon=1e-6, keepdim=False, name=None):
        super().__init__()
        self._p, self._eps, self._keepdim = p, epsilon, keepdim

    def forward(self, x, y):
        return F.pairwise_distance(x, y, self._p, self._eps, self._keepdim)
