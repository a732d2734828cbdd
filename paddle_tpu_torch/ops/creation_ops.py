"""Creation and random ops (counterpart of
``paddle_tpu/ops/creation_ops.py``).

``device=None`` is the current place: the card, unless
``set_device("cpu")``; the model code passes its parameters' device. An
op over a tensor (``full_like``, ``bernoulli``, ...) makes its result on
that tensor's device.

The JAX random ops take an explicit PRNG key as their first argument;
here that argument is a ``torch.Generator`` (``None``: the port's
generator of the result's device, ``framework.random.get_generator``).
The names and the other attributes are the JAX ops'. The same seed does
not give the JAX package's numbers: the two generators differ.
"""
from __future__ import annotations

import torch

from ..framework.dtypes import convert_dtype
from ..framework.place import to_torch_device
from ..framework.random import get_generator
from .registry import register_op


def _dtype(dtype):
    return None if dtype is None else convert_dtype(dtype)


def _gen(generator, device):
    return generator if generator is not None else get_generator(device)


@register_op("full")
def _full(shape=(), fill_value=0.0, dtype=None, device=None):
    return torch.full(tuple(shape), fill_value, dtype=_dtype(dtype),
                      device=to_torch_device(device))


@register_op("zeros")
def _zeros(shape=(), dtype=None, device=None):
    return torch.zeros(tuple(shape), dtype=convert_dtype(dtype),
                       device=to_torch_device(device))


@register_op("arange")
def _arange(start=0, end=None, step=1, dtype=None, device=None):
    if end is None:
        start, end = 0, start
    return torch.arange(start, end, step, dtype=_dtype(dtype),
                        device=to_torch_device(device))


@register_op("linspace")
def _linspace(start, stop, num, dtype=None, device=None):
    return torch.linspace(start, stop, int(num), dtype=_dtype(dtype),
                          device=to_torch_device(device))


@register_op("logspace")
def _logspace(start, stop, num, base=10.0, dtype=None, device=None):
    return torch.logspace(start, stop, int(num), base=base,
                          dtype=_dtype(dtype), device=to_torch_device(device))


@register_op("eye")
def _eye(num_rows, num_columns=None, dtype=None, device=None):
    m = int(num_columns) if num_columns is not None else int(num_rows)
    return torch.eye(int(num_rows), m, dtype=_dtype(dtype),
                     device=to_torch_device(device))


@register_op("full_like")
def _full_like(x, fill_value, dtype=None):
    return torch.full_like(x, fill_value, dtype=_dtype(dtype))


@register_op("tril")
def _tril(x, diagonal=0):
    return torch.tril(x, diagonal)


@register_op("triu")
def _triu(x, diagonal=0):
    return torch.triu(x, diagonal)


@register_op("diag")
def _diag(x, offset=0, padding_value=0):
    d = torch.diag(x, offset)
    if x.dim() == 1 and padding_value != 0:
        keep = torch.diag(torch.ones(x.shape[0], dtype=torch.bool,
                                     device=x.device), offset)
        return torch.where(keep, d, torch.full_like(d, padding_value))
    return d


@register_op("diagflat")
def _diagflat(x, offset=0):
    return torch.diagflat(x, offset)


@register_op("diag_embed")
def _diag_embed(x, offset=0, dim1=-2, dim2=-1):
    return torch.diag_embed(x, offset, dim1, dim2)


@register_op("diagonal")
def _diagonal(x, offset=0, axis1=0, axis2=1):
    return torch.diagonal(x, offset, axis1, axis2)


@register_op("meshgrid")
def _meshgrid(xs):
    return tuple(torch.meshgrid(*xs, indexing="ij"))


@register_op("assign")
def _assign(x):
    # a fresh tensor, never an alias (the JAX op's arrays are immutable)
    if isinstance(x, torch.Tensor):
        return x.clone()
    return torch.as_tensor(x)


@register_op("cast")
def _cast(x, dtype):
    return x.to(convert_dtype(dtype))


# -- random -------------------------------------------------------------------

@register_op("uniform_random")
def _uniform(generator=None, shape=(), dtype="float32", min=-1.0, max=1.0,
             device=None):
    device = to_torch_device(device)
    out = torch.empty(tuple(shape), dtype=convert_dtype(dtype), device=device)
    return out.uniform_(min, max, generator=_gen(generator, device))


@register_op("gaussian_random")
def _gaussian(generator=None, shape=(), dtype="float32", mean=0.0, std=1.0,
              device=None):
    device = to_torch_device(device)
    out = torch.empty(tuple(shape), dtype=convert_dtype(dtype), device=device)
    return mean + std * out.normal_(generator=_gen(generator, device))


@register_op("randint")
def _randint(generator=None, low=0, high=None, shape=(), dtype="int64",
             device=None):
    if high is None:
        low, high = 0, low
    device = to_torch_device(device)
    return torch.randint(int(low), int(high), tuple(shape),
                         generator=_gen(generator, device), device=device,
                         dtype=convert_dtype(dtype))


@register_op("randperm")
def _randperm(generator=None, n=1, dtype="int64", device=None):
    device = to_torch_device(device)
    return torch.randperm(int(n), generator=_gen(generator, device),
                          device=device).to(convert_dtype(dtype))


@register_op("bernoulli")
def _bernoulli(generator=None, p=None):
    return torch.bernoulli(p, generator=_gen(generator, p.device)).to(p.dtype)


@register_op("multinomial")
def _multinomial(generator=None, x=None, num_samples=1, replacement=False):
    gen = _gen(generator, x.device)
    flat = x.reshape(-1, x.shape[-1]).float()
    out = torch.multinomial(flat, int(num_samples), bool(replacement),
                            generator=gen)
    return out.reshape(*x.shape[:-1], int(num_samples))


@register_op("standard_gamma")
def _standard_gamma(generator=None, alpha=None):
    return torch._standard_gamma(alpha, generator=_gen(generator,
                                                       alpha.device))


@register_op("poisson")
def _poisson(generator=None, x=None):
    return torch.poisson(x.float(), generator=_gen(generator,
                                                   x.device)).to(x.dtype)


@register_op("exponential")
def _exponential(generator=None, x=None, lam=1.0):
    out = torch.empty_like(x)
    return out.exponential_(1.0, generator=_gen(generator, x.device)) / lam


@register_op("dropout_raw")
def _dropout(x, generator=None, p=0.5, axis=None, training=True,
             mode="upscale_in_train"):
    """The JAX ``dropout_raw``: a mask over ``axis`` (all the axes by
    default) broadcast over the rest; kept elements divided by ``1 - p``
    with ``"upscale_in_train"``."""
    if not training or p == 0.0:
        return x
    if p == 1.0:
        return torch.zeros_like(x)
    keep = 1.0 - p
    if axis is None:
        shape = x.shape
    else:
        axes = {a % x.dim() for a in ((axis,) if isinstance(axis, int)
                                      else axis)}
        shape = tuple(d if i in axes else 1 for i, d in enumerate(x.shape))
    mask = torch.rand(shape, generator=_gen(generator, x.device),
                      device=x.device) < keep
    kept = x / keep if mode == "upscale_in_train" else x
    return torch.where(mask, kept, torch.zeros_like(x)).to(x.dtype)

