"""Gradient clipping (counterpart of ``paddle_tpu/nn/clip.py``).

A clip maps a ``[(param, grad), ...]`` list to a new one; the optimizer's
``step()`` runs it on every parameter with a gradient before anything
else (``Optimizer(grad_clip=...)``). A parameter whose ``need_clip`` is
``False`` (``nn.layer.ParamAttr(need_clip=False)``) keeps its gradient
and, under the global-norm clip, adds nothing to the norm.

Norms are reduced in float32 whatever the gradients' dtype, as the JAX
package squares f32-cast gradients: a bf16 norm of 124M bf16 values would
be too coarse to clip the same steps. The global norm is one device
scalar and the scale ``clip_norm / max(norm, clip_norm)`` multiplies every
gradient on the device, so clipping reads nothing back to the host.
"""
from __future__ import annotations

import torch

__all__ = ["ClipGradBase", "ClipGradByValue", "ClipGradByNorm",
           "ClipGradByGlobalNorm", "clip_by_norm", "clip_by_global_norm"]


def _clipped(p) -> bool:
    return getattr(p, "need_clip", True) is not False


def _scaled(grads, scale):
    """Each gradient times the float32 device scalar ``scale``, the
    product in float32 and rounded once to the gradient's dtype, as
    ``(g * scale).astype(g.dtype)`` computes it in the JAX package. A
    16-bit gradient is widened first: the card's fused product of a
    bf16 list and an f32 scalar would round the scale to bf16 (2**-9 of
    the clip)."""
    if all(g.dtype == torch.float32 for g in grads):
        return torch._foreach_mul(grads, scale)
    wide = [torch.empty_like(g, dtype=torch.float32) for g in grads]
    torch._foreach_copy_(wide, grads)
    torch._foreach_mul_(wide, scale)
    out = [torch.empty_like(g) for g in grads]
    torch._foreach_copy_(out, wide)
    return out


class ClipGradBase:
    def __call__(self, params_grads):
        raise NotImplementedError


class ClipGradByValue(ClipGradBase):
    """Each gradient element into ``[min, max]`` (``min`` defaults to
    ``-max``)."""

    def __init__(self, max, min=None):
        self.max = float(max)
        self.min = float(min) if min is not None else -self.max

    def __call__(self, params_grads):
        return [(p, g.clamp(self.min, self.max)) for p, g in params_grads]


class ClipGradByNorm(ClipGradBase):
    """Each gradient scaled to an L2 norm of at most ``clip_norm``; the
    norm is floored at 1e-12 before the division."""

    def __init__(self, clip_norm):
        self.clip_norm = float(clip_norm)

    def __call__(self, params_grads):
        out = []
        for p, g in params_grads:
            norm = torch.linalg.vector_norm(g, dtype=torch.float32)
            scale = (self.clip_norm / norm.clamp_min(1e-12)).clamp_max(1.0)
            out.append((p, (g.float() * scale).to(g.dtype)))
        return out


class ClipGradByGlobalNorm(ClipGradBase):
    """Every gradient scaled by ``clip_norm / max(global_norm,
    clip_norm)``, where ``global_norm`` is the L2 norm of all the
    gradients that take part (no epsilon)."""

    def __init__(self, clip_norm, group_name="default_group",
                 auto_skip_clip=False):
        self.clip_norm = float(clip_norm)

    def __call__(self, params_grads):
        return self.clip_with_norm(params_grads)[0]

    def clip_with_norm(self, params_grads):
        """``(clipped pairs, the pre-clip global norm)``, the norm a
        float32 device scalar."""
        if not params_grads:
            return params_grads, torch.zeros((), dtype=torch.float32)
        grads = [g for p, g in params_grads if _clipped(p)]
        if not grads:
            return list(params_grads), torch.zeros(
                (), dtype=torch.float32, device=params_grads[0][1].device)
        norms = torch._foreach_norm(grads, 2, dtype=torch.float32)
        global_norm = torch.linalg.vector_norm(torch.stack(norms))
        scale = self.clip_norm / global_norm.clamp_min(self.clip_norm)
        scaled = iter(_scaled(grads, scale))
        return [(p, next(scaled) if _clipped(p) else g)
                for p, g in params_grads], global_norm


def clip_by_norm(x, max_norm):
    """``x`` scaled to an L2 norm of at most ``max_norm``."""
    norm = torch.linalg.vector_norm(x)
    return x * (max_norm / norm.clamp_min(1e-12)).clamp_max(1.0)


def clip_by_global_norm(t_list, clip_norm):
    """The tensors of ``t_list`` scaled together to a global L2 norm of at
    most ``clip_norm``."""
    pairs = ClipGradByGlobalNorm(clip_norm)([(t, t) for t in t_list])
    return [g for _, g in pairs]
