"""Parameter initializers (counterpart of ``paddle_tpu/nn/initializer``):
``Constant`` through ``Bilinear``, ``calculate_gain`` and
``set_global_initializer``.

An initializer is a callable ``(shape, dtype) -> tensor``, as in the JAX
package, with a keyword-only ``generator=`` (a ``torch.Generator``; by
default the port's CPU generator, ``framework.random.get_generator``, so
a layer's weights do not depend on where it is moved afterwards) and
``device=`` for the result (the CPU by default). The shape is the JAX
package's: a ``Linear`` weight is ``[in_features, out_features]`` there,
and the fans come from that shape (:func:`_fan_in_out`, the port's copy of
the JAX helper), so a port ``Linear`` draws its ``[in, out]`` weight and
stores its transpose. Sampling runs in float32 and casts to ``dtype``. The
same seed does not give the JAX package's numbers: the two generators
differ.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ...framework.dtypes import convert_dtype
from ...framework.random import get_generator

__all__ = [
    "Bilinear", "set_global_initializer",
    "Initializer", "Constant", "Uniform", "Normal", "TruncatedNormal",
    "XavierNormal", "XavierUniform", "KaimingNormal", "KaimingUniform",
    "Assign", "Orthogonal", "Dirac", "calculate_gain",
]


def calculate_gain(nonlinearity, param=None):
    recommended = {
        "sigmoid": 1.0,
        "linear": 1.0,
        "conv1d": 1.0, "conv2d": 1.0, "conv3d": 1.0,
        "conv1d_transpose": 1.0, "conv2d_transpose": 1.0,
        "conv3d_transpose": 1.0,
        "tanh": 5.0 / 3.0,
        "relu": math.sqrt(2.0),
        "leaky_relu": math.sqrt(2.0 / (1 + (param if param is not None
                                             else 0.01) ** 2)),
        "selu": 3.0 / 4.0,
    }
    if nonlinearity not in recommended:
        raise ValueError(f"unsupported nonlinearity: {nonlinearity}")
    return recommended[nonlinearity]


def _fan_in_out(shape):
    """The fans of the reference's Xavier/MSRA initializers: a 2-D weight
    is ``[in, out]``; for a conv weight (``OIHW``) the receptive field
    multiplies the channel fans."""
    shape = tuple(int(s) for s in shape)
    if len(shape) == 0:
        return 1, 1
    if len(shape) == 1:
        return shape[0], shape[0]
    if len(shape) == 2:
        return shape[0], shape[1]
    receptive = int(np.prod(shape[2:]))
    return shape[1] * receptive, shape[0] * receptive


def _empty(shape, generator, device):
    device = torch.device(device or "cpu")
    gen = generator if generator is not None else get_generator(device)
    return torch.empty(tuple(int(s) for s in shape), dtype=torch.float32,
                       device=device), gen


class Initializer:
    def __call__(self, shape, dtype, *, generator=None, device=None):
        raise NotImplementedError


class Constant(Initializer):
    def __init__(self, value=0.0):
        self.value = value

    def __call__(self, shape, dtype, *, generator=None, device=None):
        return torch.full(tuple(int(s) for s in shape), self.value,
                          dtype=convert_dtype(dtype), device=device)


class Uniform(Initializer):
    def __init__(self, low=-1.0, high=1.0, name=None):
        self.low, self.high = low, high

    def __call__(self, shape, dtype, *, generator=None, device=None):
        out, gen = _empty(shape, generator, device)
        return out.uniform_(self.low, self.high, generator=gen).to(
            convert_dtype(dtype))


class Normal(Initializer):
    def __init__(self, mean=0.0, std=1.0, name=None):
        self.mean, self.std = mean, std

    def __call__(self, shape, dtype, *, generator=None, device=None):
        out, gen = _empty(shape, generator, device)
        return out.normal_(self.mean, self.std, generator=gen).to(
            convert_dtype(dtype))


class TruncatedNormal(Initializer):
    """A normal truncated at 2 standard deviations (the reference's
    ``truncated_gaussian_random``)."""

    def __init__(self, mean=0.0, std=1.0, name=None):
        self.mean, self.std = mean, std

    def __call__(self, shape, dtype, *, generator=None, device=None):
        out, gen = _empty(shape, generator, device)
        # the inverse CDF of a uniform over [Phi(-2), Phi(2)]
        lo, hi = (1 + math.erf(-2 / math.sqrt(2))) / 2, \
            (1 + math.erf(2 / math.sqrt(2))) / 2
        u = out.uniform_(lo, hi, generator=gen)
        a = torch.erfinv(2 * u - 1) * math.sqrt(2)
        return (a.clamp(-2.0, 2.0) * self.std + self.mean).to(
            convert_dtype(dtype))


class XavierUniform(Initializer):
    def __init__(self, fan_in=None, fan_out=None, gain=1.0, name=None):
        self._fan_in, self._fan_out, self._gain = fan_in, fan_out, gain

    def __call__(self, shape, dtype, *, generator=None, device=None):
        fi, fo = _fan_in_out(shape)
        fi = self._fan_in if self._fan_in is not None else fi
        fo = self._fan_out if self._fan_out is not None else fo
        limit = self._gain * math.sqrt(6.0 / (fi + fo))
        out, gen = _empty(shape, generator, device)
        return out.uniform_(-limit, limit, generator=gen).to(
            convert_dtype(dtype))


class XavierNormal(Initializer):
    def __init__(self, fan_in=None, fan_out=None, gain=1.0, name=None):
        self._fan_in, self._fan_out, self._gain = fan_in, fan_out, gain

    def __call__(self, shape, dtype, *, generator=None, device=None):
        fi, fo = _fan_in_out(shape)
        fi = self._fan_in if self._fan_in is not None else fi
        fo = self._fan_out if self._fan_out is not None else fo
        std = self._gain * math.sqrt(2.0 / (fi + fo))
        out, gen = _empty(shape, generator, device)
        return out.normal_(0.0, std, generator=gen).to(convert_dtype(dtype))


class KaimingUniform(Initializer):
    def __init__(self, fan_in=None, negative_slope=0.0, nonlinearity="relu",
                 name=None):
        self._fan_in = fan_in
        self._gain = calculate_gain(nonlinearity, negative_slope)

    def __call__(self, shape, dtype, *, generator=None, device=None):
        fi, _ = _fan_in_out(shape)
        fi = self._fan_in if self._fan_in is not None else fi
        limit = self._gain * math.sqrt(3.0 / fi)
        out, gen = _empty(shape, generator, device)
        return out.uniform_(-limit, limit, generator=gen).to(
            convert_dtype(dtype))


class KaimingNormal(Initializer):
    def __init__(self, fan_in=None, negative_slope=0.0, nonlinearity="relu",
                 name=None):
        self._fan_in = fan_in
        self._gain = calculate_gain(nonlinearity, negative_slope)

    def __call__(self, shape, dtype, *, generator=None, device=None):
        fi, _ = _fan_in_out(shape)
        fi = self._fan_in if self._fan_in is not None else fi
        std = self._gain / math.sqrt(fi)
        out, gen = _empty(shape, generator, device)
        return out.normal_(0.0, std, generator=gen).to(convert_dtype(dtype))


class Assign(Initializer):
    def __init__(self, value, name=None):
        self.value = value

    def __call__(self, shape, dtype, *, generator=None, device=None):
        v = self.value
        arr = v.detach().clone() if isinstance(v, torch.Tensor) \
            else torch.as_tensor(np.asarray(v))
        arr = arr.to(dtype=convert_dtype(dtype), device=device)
        if tuple(arr.shape) != tuple(shape):
            arr = arr.reshape(tuple(shape))
        return arr


class Orthogonal(Initializer):
    def __init__(self, gain=1.0, name=None):
        self.gain = gain

    def __call__(self, shape, dtype, *, generator=None, device=None):
        shape = tuple(int(s) for s in shape)
        rows = shape[0]
        cols = int(np.prod(shape[1:])) if len(shape) > 1 else 1
        a, gen = _empty((max(rows, cols), min(rows, cols)), generator,
                        device)
        q, r = torch.linalg.qr(a.normal_(generator=gen))
        q = q * torch.sign(torch.diagonal(r))
        if rows < cols:
            q = q.t()
        return (self.gain * q[:rows, :cols]).reshape(shape).to(
            convert_dtype(dtype))


class Dirac(Initializer):
    """The identity-preserving conv initializer (the reference's
    ``nn/initializer/dirac.py``)."""

    def __init__(self, groups=1, name=None):
        self.groups = groups

    def __call__(self, shape, dtype, *, generator=None, device=None):
        shape = tuple(int(s) for s in shape)
        out_c, in_c = shape[0], shape[1]
        w = torch.zeros(shape, dtype=torch.float32)
        centre = tuple(s // 2 for s in shape[2:])
        per_group = out_c // self.groups
        for g in range(self.groups):
            for i in range(min(per_group, in_c)):
                w[(g * per_group + i, i) + centre] = 1.0
        return w.to(dtype=convert_dtype(dtype), device=device)


class Bilinear(Initializer):
    """The bilinear-upsampling kernel of a transposed convolution (the
    reference's ``BilinearInitializer``)."""

    def __call__(self, shape, dtype, *, generator=None, device=None):
        shape = tuple(int(s) for s in shape)
        if len(shape) != 4:
            raise ValueError("Bilinear initializer needs a 4-D weight")
        kh, kw = shape[2], shape[3]
        f_h, f_w = (kh + 1) // 2, (kw + 1) // 2
        c_h = (2 * f_h - 1 - f_h % 2) / (2.0 * f_h)
        c_w = (2 * f_w - 1 - f_w % 2) / (2.0 * f_w)
        og = np.ogrid[:kh, :kw]
        filt = (1 - abs(og[0] / f_h - c_h)) * (1 - abs(og[1] / f_w - c_w))
        w = np.broadcast_to(filt.astype(np.float32), shape).copy()
        return torch.from_numpy(w).to(dtype=convert_dtype(dtype),
                                      device=device)


_GLOBAL_INIT = {"weight": None, "bias": None}


def set_global_initializer(weight_init, bias_init=None):
    """The initializers ``create_parameter`` uses when neither the
    ``ParamAttr`` nor the layer gives one; ``(None, None)`` resets."""
    _GLOBAL_INIT["weight"] = weight_init
    _GLOBAL_INIT["bias"] = bias_init


def _global_initializer(is_bias: bool):
    return _GLOBAL_INIT["bias" if is_bias else "weight"]
