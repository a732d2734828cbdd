"""``distribution`` transforms (counterpart of ``paddle_tpu/distribution/
transform.py``): the ``Transform`` base and its twelve subclasses, with
closed-form log-det-Jacobians, over float32 torch tensors.

A transform's parameters (``AffineTransform``'s ``loc``/``scale``,
``PowerTransform``'s ``power``) are moved to the device of the value
they meet.
"""
from __future__ import annotations

import enum
import functools
import math
import operator
from typing import Sequence

import torch
import torch.nn.functional as TF

__all__ = ["Transform", "AbsTransform", "AffineTransform", "ChainTransform",
           "ExpTransform", "IndependentTransform", "PowerTransform",
           "ReshapeTransform", "SigmoidTransform", "SoftmaxTransform",
           "StackTransform", "StickBreakingTransform", "TanhTransform"]


def _a(x):
    if isinstance(x, torch.Tensor):
        return x.float()
    return torch.as_tensor(x, dtype=torch.float32)


def _on(p, x):
    return p.to(x.device)


class Type(enum.Enum):
    """The mapping type of a transform."""
    BIJECTION = "bijection"
    INJECTION = "injection"
    SURJECTION = "surjection"
    OTHER = "other"

    @classmethod
    def is_injective(cls, t):
        return t in (cls.BIJECTION, cls.INJECTION)


class Transform:
    """``y = f(x)`` with its log |det J|. ``_domain_event_rank`` and
    ``_codomain_event_rank`` are the event ranks it consumes and
    produces."""

    _type = Type.INJECTION
    _domain_event_rank = 0
    _codomain_event_rank = 0

    @classmethod
    def _is_injective(cls):
        return Type.is_injective(cls._type)

    def __call__(self, x):
        from . import Distribution, TransformedDistribution
        if isinstance(x, Distribution):
            return TransformedDistribution(x, [self])
        if isinstance(x, Transform):
            return ChainTransform([self, x])
        return self.forward(x)

    def forward(self, x):
        return self._forward(_a(x))

    def inverse(self, y):
        return self._inverse(_a(y))

    def forward_log_det_jacobian(self, x):
        x = _a(x)
        if hasattr(self, "_forward_log_det_jacobian"):
            return self._forward_log_det_jacobian(x)
        if hasattr(self, "_inverse_log_det_jacobian"):
            return -self._inverse_log_det_jacobian(self._forward(x))
        raise NotImplementedError(
            f"{type(self).__name__} has no log det jacobian")

    def inverse_log_det_jacobian(self, y):
        y = _a(y)
        if hasattr(self, "_inverse_log_det_jacobian"):
            return self._inverse_log_det_jacobian(y)
        if hasattr(self, "_forward_log_det_jacobian"):
            return -self._forward_log_det_jacobian(self._inverse(y))
        raise NotImplementedError(
            f"{type(self).__name__} has no log det jacobian")

    def forward_shape(self, shape):
        return tuple(shape)

    def inverse_shape(self, shape):
        return tuple(shape)


class AbsTransform(Transform):
    """``y = |x|``: a surjection; ``inverse`` returns the positive
    branch."""

    _type = Type.SURJECTION

    def _forward(self, x):
        return torch.abs(x)

    def _inverse(self, y):
        return y


class AffineTransform(Transform):
    """``y = loc + scale * x``."""

    _type = Type.BIJECTION

    def __init__(self, loc, scale):
        self.loc = _a(loc)
        self.scale = _a(scale)

    def _forward(self, x):
        return _on(self.loc, x) + _on(self.scale, x) * x

    def _inverse(self, y):
        return (y - _on(self.loc, y)) / _on(self.scale, y)

    def _forward_log_det_jacobian(self, x):
        return torch.broadcast_to(torch.log(torch.abs(_on(self.scale, x))),
                                  x.shape)


class ChainTransform(Transform):
    """The composition ``t_n o ... o t_1``."""

    def __init__(self, transforms: Sequence[Transform]):
        self.transforms = list(transforms)
        self._type = (Type.BIJECTION if all(
            t._is_injective() for t in self.transforms)
            else Type.OTHER)

    def _is_injective(self):
        return all(t._is_injective() for t in self.transforms)

    @property
    def _domain_event_rank(self):
        return max((t._domain_event_rank for t in self.transforms),
                   default=0)

    @property
    def _codomain_event_rank(self):
        return max((t._codomain_event_rank for t in self.transforms),
                   default=0)

    def _forward(self, x):
        for t in self.transforms:
            x = t._forward(x)
        return x

    def _inverse(self, y):
        for t in reversed(self.transforms):
            y = t._inverse(y)
        return y

    def _forward_log_det_jacobian(self, x):
        ldj = torch.zeros((), device=x.device)
        for t in self.transforms:
            ldj = ldj + t.forward_log_det_jacobian(x)
            x = t._forward(x)
        return ldj

    def forward_shape(self, shape):
        for t in self.transforms:
            shape = t.forward_shape(shape)
        return tuple(shape)

    def inverse_shape(self, shape):
        for t in reversed(self.transforms):
            shape = t.inverse_shape(shape)
        return tuple(shape)


class ExpTransform(Transform):
    """``y = exp(x)``."""

    _type = Type.BIJECTION

    def _forward(self, x):
        return torch.exp(x)

    def _inverse(self, y):
        return torch.log(y)

    def _forward_log_det_jacobian(self, x):
        return x


class IndependentTransform(Transform):
    """``base`` with its rightmost ``reinterpreted_batch_rank`` batch
    dimensions taken as event dimensions: the Jacobians sum over
    them."""

    def __init__(self, base: Transform, reinterpreted_batch_rank: int):
        if reinterpreted_batch_rank <= 0:
            raise ValueError("reinterpreted_batch_rank must be positive")
        self.base = base
        self.reinterpreted_batch_rank = int(reinterpreted_batch_rank)
        self._type = base._type

    @property
    def _domain_event_rank(self):
        return self.base._domain_event_rank + self.reinterpreted_batch_rank

    @property
    def _codomain_event_rank(self):
        return (self.base._codomain_event_rank
                + self.reinterpreted_batch_rank)

    def _is_injective(self):
        return self.base._is_injective()

    def _forward(self, x):
        return self.base._forward(x)

    def _inverse(self, y):
        return self.base._inverse(y)

    def _forward_log_det_jacobian(self, x):
        ldj = self.base.forward_log_det_jacobian(x)
        return ldj.sum(tuple(range(-self.reinterpreted_batch_rank, 0)))

    def forward_shape(self, shape):
        return self.base.forward_shape(shape)

    def inverse_shape(self, shape):
        return self.base.inverse_shape(shape)


class PowerTransform(Transform):
    """``y = x ** power`` on the positive reals."""

    _type = Type.BIJECTION

    def __init__(self, power):
        self.power = _a(power)

    def _forward(self, x):
        return torch.pow(x, _on(self.power, x))

    def _inverse(self, y):
        return torch.pow(y, 1.0 / _on(self.power, y))

    def _forward_log_det_jacobian(self, x):
        p = _on(self.power, x)
        return torch.log(torch.abs(p * torch.pow(x, p - 1)))


class ReshapeTransform(Transform):
    """Reshape the event part."""

    _type = Type.BIJECTION

    def __init__(self, in_event_shape, out_event_shape):
        self.in_event_shape = tuple(in_event_shape)
        self.out_event_shape = tuple(out_event_shape)
        if functools.reduce(operator.mul, self.in_event_shape, 1) != \
                functools.reduce(operator.mul, self.out_event_shape, 1):
            raise ValueError(
                "in_event_shape and out_event_shape must have the same "
                "number of elements")

    @property
    def _domain_event_rank(self):
        return len(self.in_event_shape)

    @property
    def _codomain_event_rank(self):
        return len(self.out_event_shape)

    def _batch(self, shape, event):
        n = len(event)
        if n and tuple(shape[-n:]) != tuple(event):
            raise ValueError(
                f"trailing dims of {tuple(shape)} do not match {event}")
        return tuple(shape[:len(shape) - n]) if n else tuple(shape)

    def _forward(self, x):
        batch = self._batch(x.shape, self.in_event_shape)
        return x.reshape(batch + self.out_event_shape)

    def _inverse(self, y):
        batch = self._batch(y.shape, self.out_event_shape)
        return y.reshape(batch + self.in_event_shape)

    def _forward_log_det_jacobian(self, x):
        batch = self._batch(x.shape, self.in_event_shape)
        return torch.zeros(batch, dtype=x.dtype, device=x.device)

    def forward_shape(self, shape):
        return self._batch(tuple(shape), self.in_event_shape) \
            + self.out_event_shape

    def inverse_shape(self, shape):
        return self._batch(tuple(shape), self.out_event_shape) \
            + self.in_event_shape


class SigmoidTransform(Transform):
    """``y = sigmoid(x)``."""

    _type = Type.BIJECTION

    def _forward(self, x):
        return torch.sigmoid(x)

    def _inverse(self, y):
        return torch.log(y) - torch.log1p(-y)

    def _forward_log_det_jacobian(self, x):
        return -TF.softplus(-x) - TF.softplus(x)


class SoftmaxTransform(Transform):
    """``y = softmax(x)``: onto the simplex, with no density."""

    _type = Type.OTHER
    _domain_event_rank = 1
    _codomain_event_rank = 1

    def _forward(self, x):
        z = x - x.amax(-1, keepdim=True)
        ez = torch.exp(z)
        return ez / ez.sum(-1, keepdim=True)

    def _inverse(self, y):
        return torch.log(y)


class StackTransform(Transform):
    """One transform per slice along ``axis``."""

    def __init__(self, transforms: Sequence[Transform], axis: int = 0):
        if not transforms:
            raise ValueError("transforms must not be empty")
        self.transforms = list(transforms)
        self.axis = int(axis)

    def _is_injective(self):
        return all(t._is_injective() for t in self.transforms)

    def _map(self, method, v):
        parts = [getattr(t, method)(v.select(self.axis, i))
                 for i, t in enumerate(self.transforms)]
        return torch.stack(parts, dim=self.axis)

    def _forward(self, x):
        return self._map("_forward", x)

    def _inverse(self, y):
        return self._map("_inverse", y)

    def _forward_log_det_jacobian(self, x):
        return self._map("forward_log_det_jacobian", x)


def _offset(k, x):
    return torch.log(torch.arange(k, 0, -1, dtype=x.dtype, device=x.device))


class StickBreakingTransform(Transform):
    """``R^(K-1)`` onto the K-simplex by stick breaking."""

    _type = Type.BIJECTION
    _domain_event_rank = 1
    _codomain_event_rank = 1

    def _forward(self, x):
        z = torch.sigmoid(x - _offset(x.shape[-1], x))
        zc = torch.cumprod(1 - z, dim=-1)
        one = torch.ones(*x.shape[:-1], 1, dtype=x.dtype, device=x.device)
        return torch.cat([one, zc], -1) * torch.cat([z, one], -1)

    def _inverse(self, y):
        k = y.shape[-1] - 1
        zc = 1 - torch.cumsum(y[..., :-1], dim=-1)
        one = torch.ones(*y.shape[:-1], 1, dtype=y.dtype, device=y.device)
        z = y[..., :-1] / torch.cat([one, zc[..., :-1]], -1)
        return torch.log(z) - torch.log1p(-z) + _offset(k, y)

    def _forward_log_det_jacobian(self, x):
        z = x - _offset(x.shape[-1], x)
        # dy_i / dx_i: sigmoid'(z_i) * prod_{j<i} (1 - sigmoid(z_j))
        zc_log = torch.cumsum(TF.logsigmoid(-z), dim=-1)
        zero = torch.zeros(*x.shape[:-1], 1, dtype=x.dtype, device=x.device)
        lead = torch.cat([zero, zc_log[..., :-1]], -1)
        return (TF.logsigmoid(z) + TF.logsigmoid(-z) + lead).sum(-1)

    def forward_shape(self, shape):
        return tuple(shape[:-1]) + (shape[-1] + 1,)

    def inverse_shape(self, shape):
        return tuple(shape[:-1]) + (shape[-1] - 1,)


class TanhTransform(Transform):
    """``y = tanh(x)``."""

    _type = Type.BIJECTION

    def _forward(self, x):
        return torch.tanh(x)

    def _inverse(self, y):
        return torch.atanh(y)

    def _forward_log_det_jacobian(self, x):
        # 2 (log 2 - x - softplus(-2x)), stable for large |x|
        return 2.0 * (math.log(2.0) - x - TF.softplus(-2.0 * x))
