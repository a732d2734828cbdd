"""``nn.utils`` (counterpart of ``paddle_tpu/nn/utils/__init__.py``):
weight norm, spectral norm and the parameter/vector transforms.

Every axis these take is an axis of the JAX package's layout, and what
they build keeps it: on a ``Linear`` (whose weight the port stores
``[out, in]``, marked ``_jax_perm``; ``nn/layer/layers.py``) ``weight_norm
(dim=0)`` normalises over the JAX ``[in, out]`` axes, its ``g`` is
``[1, in]`` here and the JAX ``[in, 1]`` through ``convert``;
``spectral_norm`` reads the JAX ``[in, out]`` matrix (``h`` its
``dim``-th size, ``u`` drawn from ``RandomState(0)`` as there); and
``parameters_to_vector`` flattens each parameter in its JAX layout, so
the vector is the JAX package's element for element.
"""
from __future__ import annotations

import numpy as np
import torch

from ..layer.layers import (from_jax_view, jax_perm, jax_view,
                            mark_jax_perm, port_axis)

__all__ = ["weight_norm", "remove_weight_norm", "spectral_norm",
           "parameters_to_vector", "vector_to_parameters"]


def _norm_except(v, dim):
    if dim is None:
        return torch.sqrt(torch.sum(v * v))
    axes = tuple(i for i in range(v.dim()) if i != dim)
    if not axes:
        return torch.sqrt(v * v)
    return torch.sqrt(torch.sum(v * v, dim=axes, keepdim=True))


def _param(value, like):
    """A new parameter holding ``value`` with ``like``'s layout mark."""
    return mark_jax_perm(torch.nn.Parameter(value), jax_perm(like))


def weight_norm(layer, name="weight", dim=0):
    """Reparameterise ``layer.<name>`` as ``g * v / ||v||``: registers the
    parameters ``<name>_g`` and ``<name>_v`` and a forward pre-hook that
    rebuilds the weight at each call. ``dim`` is an axis of the JAX
    layout (``None``: one norm over the whole tensor)."""
    w = layer._parameters.get(name)
    if not isinstance(w, torch.Tensor):
        raise ValueError(f"layer has no parameter {name!r}")
    pdim = None if dim is None else port_axis(w, dim)
    with torch.no_grad():
        v = _param(w.detach().clone(), w)
        g = _param(_norm_except(w.detach(), pdim).clone(), w)
    del layer._parameters[name]
    layer.register_parameter(f"{name}_v", v)
    layer.register_parameter(f"{name}_g", g)
    perm = jax_perm(w)
    if perm is not None:
        layer._jax_perms = {**layer._jax_perms, f"{name}_v": perm,
                            f"{name}_g": perm}

    def hook(lyr, inputs):
        vv = lyr._parameters[f"{name}_v"]
        gg = lyr._parameters[f"{name}_g"]
        built = gg * vv / torch.clamp_min(_norm_except(vv, pdim), 1e-12)
        object.__setattr__(lyr, name, built)
        return None

    handle = layer.register_forward_pre_hook(hook)
    layer._weight_norm_handle = (handle, name, pdim)
    hook(layer, ())          # so that .weight exists now
    return layer


def remove_weight_norm(layer, name="weight"):
    """Bake the current normalised weight back into a plain parameter."""
    handle, nm, pdim = getattr(layer, "_weight_norm_handle",
                               (None, name, 0))
    if handle is None:
        raise ValueError("layer has no weight norm applied")
    handle.remove()
    v = layer._parameters.pop(f"{nm}_v")
    g = layer._parameters.pop(f"{nm}_g")
    layer._jax_perms = {k: p for k, p in layer._jax_perms.items()
                        if k not in (f"{nm}_v", f"{nm}_g")}
    with torch.no_grad():
        w = _param(g * v / torch.clamp_min(_norm_except(v, pdim), 1e-12), v)
    layer.__dict__.pop(nm, None)
    layer.register_parameter(nm, w)
    del layer._weight_norm_handle
    return layer


def spectral_norm(layer, name="weight", n_power_iterations=1, eps=1e-12,
                  dim=None):
    """Divide ``layer.<name>`` by its leading singular value, estimated
    by power iteration refreshed at each forward (ten iterations at
    apply time, so that it starts converged). The matrix is the weight
    in the JAX layout with axis ``dim`` (default 0) first; ``u`` starts
    from ``RandomState(0)``."""
    w = layer._parameters[name]
    if dim is None:
        dim = 0
    wj = jax_view(w)
    h = wj.shape[dim]
    rest = int(np.prod(tuple(wj.shape))) // h
    rng = np.random.RandomState(0)
    layer._sn_u = torch.as_tensor(rng.randn(h).astype(np.float32),
                                  device=w.device)
    layer._sn_state = (name, dim, int(n_power_iterations), float(eps))

    def hook(lyr, inputs):
        nm, d, iters, e = lyr._sn_state
        ww = lyr._parameters[nm + "_orig"]
        with torch.no_grad():
            m = torch.movedim(jax_view(ww), d, 0).reshape(h, rest)
            u = lyr._sn_u.to(m.dtype)
            # v is derived once from the stored u, so that iters=0
            # (reusing the converged estimate) still defines sigma
            v = m.t() @ u
            v = v / torch.clamp_min(torch.linalg.norm(v), e)
            for _ in range(iters):
                u = m @ v
                u = u / torch.clamp_min(torch.linalg.norm(u), e)
                v = m.t() @ u
                v = v / torch.clamp_min(torch.linalg.norm(v), e)
            lyr._sn_u = u
            sigma = u @ m @ v
        object.__setattr__(lyr, nm, ww / torch.clamp_min(sigma, e))
        return None

    orig = _param(w.detach().clone(), w)
    del layer._parameters[name]
    layer.register_parameter(name + "_orig", orig)
    perm = jax_perm(w)
    if perm is not None:
        layer._jax_perms = {**layer._jax_perms, name + "_orig": perm}
    layer.register_forward_pre_hook(hook)
    layer._sn_state = (name, dim, max(10, int(n_power_iterations)),
                       float(eps))
    hook(layer, ())
    layer._sn_state = (name, dim, int(n_power_iterations), float(eps))
    return layer


def parameters_to_vector(parameters, name=None):
    """Flatten and concatenate the parameters, each in its JAX layout."""
    return torch.cat([jax_view(p).reshape(-1) for p in parameters])


def vector_to_parameters(vec, parameters, name=None) -> None:
    """Write a flat vector back into the parameters, in order (the
    inverse of :func:`parameters_to_vector`)."""
    arr = vec if isinstance(vec, torch.Tensor) else torch.as_tensor(vec)
    parameters = list(parameters)
    total = sum(p.numel() for p in parameters)
    if total != arr.shape[0]:
        raise ValueError(
            f"vector has {arr.shape[0]} elements but parameters hold "
            f"{total}")
    offset = 0
    with torch.no_grad():
        for p in parameters:
            n = p.numel()
            piece = arr[offset:offset + n].reshape(tuple(jax_view(p).shape))
            p.copy_(from_jax_view(piece, jax_perm(p)))
            offset += n
