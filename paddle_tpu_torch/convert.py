"""Carry GPT weights between the JAX package and the port.

The input is the JAX model's parameter tree as numpy
(``{name: np.asarray(a) for name, a in
paddle_tpu.nn.layer.layers.get_params_tree(model).items()}``), keyed
like ``gpt.blocks.0.attn.q_proj.weight``. The port's ``state_dict()``
has the same keys. Linear weights are ``[in, out]`` in the JAX package
and ``[out, in]`` in ``torch.nn.Linear``, so they are transposed;
embeddings and LayerNorm parameters are copied as they are.
:func:`gpt_to_numpy_params` is the inverse: a port model's parameters in
the JAX tree's keys and layouts, so trained parameters compare key by
key.
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch
from torch import nn

from ._device import resolve_device
from .models.gpt import GPTConfig, GPTForPretraining

__all__ = ["gpt_from_jax_params", "gpt_to_numpy_params"]


def _linear_keys(model) -> set:
    return {f"{name}.weight" for name, mod in model.named_modules()
            if isinstance(mod, nn.Linear)}


def gpt_from_jax_params(params: Mapping[str, np.ndarray], cfg: GPTConfig,
                        device=None, dtype=None,
                        lm_loss_chunks: int = 1) -> GPTForPretraining:
    """A port ``GPTForPretraining(cfg, lm_loss_chunks)`` holding ``params``
    on ``device`` (``None`` = the card). Raises ``KeyError`` on a missing
    or unexpected key and ``ValueError`` on a misshapen array."""
    device = resolve_device(device)
    model = GPTForPretraining(cfg, lm_loss_chunks=lm_loss_chunks)
    linear = _linear_keys(model)
    own = model.state_dict()
    missing = sorted(set(own) - set(params))
    unexpected = sorted(set(params) - set(own))
    if missing or unexpected:
        raise KeyError(f"JAX parameter tree does not match the port's "
                       f"model: missing {missing}, unexpected {unexpected}")
    state = {}
    for key, ref in own.items():
        arr = np.asarray(params[key], np.float32)
        if key in linear:
            arr = arr.T
        if tuple(arr.shape) != tuple(ref.shape):
            raise ValueError(
                f"{key}: JAX array {tuple(np.shape(params[key]))} does "
                f"not fit the port's {tuple(ref.shape)}"
                + (" (after the [in, out] -> [out, in] transpose)"
                   if key in linear else ""))
        state[key] = torch.tensor(arr)       # a copy: JAX's may be read-only
    model.load_state_dict(state)
    return model.to(device=device, dtype=dtype)


def gpt_to_numpy_params(model: GPTForPretraining) -> Dict[str, np.ndarray]:
    """``model``'s parameters as float32 numpy arrays under the JAX tree's
    keys, Linear weights transposed back to ``[in, out]``."""
    linear = _linear_keys(model)
    out = {}
    for key, t in model.state_dict().items():
        arr = t.detach().float().cpu().numpy()
        out[key] = arr.T.copy() if key in linear else arr
    return out
