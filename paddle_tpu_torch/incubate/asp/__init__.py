"""``incubate.asp`` (counterpart of ``paddle_tpu/incubate/asp``):
automatic n:m structured sparsity. ``prune_model`` computes a mask for
each supported ``Linear``/convolution weight and zeroes the pruned
entries in place; ``decorate`` wraps an optimizer so that the masks are
applied again after every step.

The n:m groups run along the last axis of the JAX package's layout of
each weight: the JAX ``Linear`` weight is ``[in, out]``, the port's
``[out, in]``, so masks are computed and checked on the JAX view
(``nn.layer.layers.jax_view``, the weight's layout mark) and the same
entries are pruned in both packages; ``check_sparsity`` of a marked
parameter reads the same view. The ``mask_2d_*`` algorithms compute the
1-D mask, as in the JAX package. Each mask is kept on its weight
(``_asp_mask``), on the weight's device: two models of one structure
keep their own masks, and a mask goes with its model. ``prune_model``
returns them by the parameter's name: its ``ParamAttr`` name, else its
structured name in the pruned model.

After a masked step the float32 master of a ``multi_precision``
parameter is masked too, so master and parameter agree. (The JAX step
masks the parameter only: its master keeps training the pruned entries,
which never reach the parameter, so the two packages' parameters agree.)
"""
from __future__ import annotations

from typing import List

import numpy as np
import torch

from ...nn.layer.layers import from_jax_view, jax_perm, jax_view

__all__ = ["decorate", "prune_model", "set_excluded_layers",
           "reset_excluded_layers", "calculate_density", "check_sparsity"]

_EXCLUDED: set = set()


def set_excluded_layers(model=None, param_names: List[str] = None):
    for n in (param_names or []):
        _EXCLUDED.add(n)


def reset_excluded_layers(model=None):
    _EXCLUDED.clear()


def _jax_array(x) -> np.ndarray:
    """``x`` (a tensor, read in its JAX layout, or an array) as numpy."""
    if isinstance(x, torch.Tensor):
        return jax_view(x).detach().float().cpu().numpy()
    return np.asarray(x)


def calculate_density(x) -> float:
    arr = _jax_array(x)
    return float((arr != 0).sum() / arr.size)


def _mask_1d_nm(w: torch.Tensor, n: int, m: int) -> torch.Tensor:
    """Keep the ``n`` largest-|w| entries of every group of ``m``
    consecutive elements along the last axis (ties to the lower index,
    as numpy's ``argsort`` orders them)."""
    shape = w.shape
    flat = w.reshape(-1, shape[-1])
    cols = shape[-1]
    pad = (-cols) % m
    if pad:
        flat = torch.cat([flat, flat.new_zeros(flat.shape[0], pad)], dim=1)
    groups = flat.abs().float().reshape(flat.shape[0], -1, m)
    order = torch.sort(groups, dim=-1, descending=True, stable=True)[1]
    mask = torch.zeros_like(groups).scatter_(-1, order[..., :n], 1.0)
    mask = mask.reshape(flat.shape)[:, :cols]
    return mask.reshape(shape).to(w.dtype)


def check_sparsity(x, n=2, m=4) -> bool:
    arr = _jax_array(x)
    flat = np.abs(arr.reshape(-1, arr.shape[-1]))
    cols = flat.shape[1]
    pad = (-cols) % m
    if pad:
        flat = np.concatenate(
            [flat, np.zeros((flat.shape[0], pad))], axis=1)
    groups = (flat.reshape(flat.shape[0], -1, m) != 0).sum(axis=-1)
    return bool((groups <= n).all())


def _supported(param) -> bool:
    return param.dim() >= 2 and min(param.shape) >= 4


def _prunable_params(model):
    """``(name, weight)`` of the ``Linear``/convolution layers only: the
    reference never prunes embeddings, norms or biases."""
    from ... import nn
    prunable_types = (nn.Linear, nn.Conv1D, nn.Conv2D, nn.Conv3D,
                      nn.Conv1DTranspose, nn.Conv2DTranspose,
                      nn.Conv3DTranspose)
    seen = set()
    for path, layer in model.named_sublayers(include_self=True):
        if not isinstance(layer, prunable_types):
            continue
        w = getattr(layer, "weight", None)
        if w is not None and id(w) not in seen:
            seen.add(id(w))
            name = getattr(w, "_paddle_name", None) or \
                (f"{path}.weight" if path else "weight")
            yield name, w


def prune_model(model, n=2, m=4, mask_algo="mask_1d", with_mask=True):
    """Compute masks for every supported parameter of ``model`` and zero
    the pruned entries in place. Returns {param_name: mask}."""
    if mask_algo not in ("mask_1d", "mask_2d_greedy", "mask_2d_best"):
        raise ValueError(f"unknown mask_algo {mask_algo!r}")
    out = {}
    for name, param in _prunable_params(model):
        if name in _EXCLUDED or not _supported(param):
            continue
        mask = from_jax_view(_mask_1d_nm(jax_view(param).detach(), n, m),
                             jax_perm(param)).contiguous()
        with torch.no_grad():
            param.mul_(mask)
        if with_mask:
            param._asp_mask = mask
            out[name] = mask
    return out


class OptimizerWithSparsityGuarantee:
    """Applies the pruning masks again after every optimizer step (to the
    float32 masters too), so pruned weights stay zero through training."""

    def __init__(self, optimizer):
        self._optimizer = optimizer

    def __getattr__(self, item):
        return getattr(self._optimizer, item)

    def step(self):
        self._optimizer.step()
        self._apply_masks()

    def minimize(self, loss, startup_program=None, parameters=None,
                 no_grad_set=None):
        loss.backward()
        self.step()  # masked step, not the raw optimizer's
        self.clear_grad()
        return None, None

    @torch.no_grad()
    def _apply_masks(self):
        masters = self._optimizer._master_weights()
        for _, p in self._optimizer._params or ():
            mask = getattr(p, "_asp_mask", None)
            if mask is None:
                continue
            p.mul_(mask)
            master = masters.get(id(p))
            if master is not None:
                master.mul_(mask)

    def clear_grad(self, set_to_zero=False):
        self._optimizer.clear_grad(set_to_zero)


def decorate(optimizer):
    return OptimizerWithSparsityGuarantee(optimizer)
