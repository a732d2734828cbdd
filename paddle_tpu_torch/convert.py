"""Carry weights between the JAX package and the port.

:func:`layer_from_jax` loads a JAX ``Layer.state_dict()`` (as numpy) into
any ported layer by structured name, and :func:`layer_to_numpy` is its
inverse. The key sets must be equal: a missing or extra key raises. Only
the weights of ``Linear`` layers are transposed (``[in, out]`` in the JAX
package, ``[out, in]`` in the port), with what is derived from them: the
weight-norm and spectral-norm parameters, and the int8 inference layers'
``weight_int8`` (``[in, out]``) and ``weight_scale`` (``[1, out]``
there, ``[out, 1]`` here); every other parameter and buffer keeps its
layout, QAT observers' ``scale_state`` among them. So it carries BERT
(the masked-LM decoder tied to the word table: one key), every
recurrent layer (the cells' ``weight_ih``/``weight_hh`` keep the JAX
``[gates * hidden, in]`` layout) and ``TransformerModel`` (its
``pos_table`` buffer too).

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

:func:`opt_state_from_jax` carries the optimizer across too: the JAX
optimizer's ``state_dict()`` (or a ``.pdopt`` file read with
``paddle_tpu_torch.load``) becomes a state the port's optimizer takes
with ``set_state_dict``. So a JAX checkpoint (``.pdparams`` +
``.pdopt``) resumes in the port; :func:`opt_state_to_jax` is the
inverse.

:func:`program_from_jax` carries a static program's parameters: the JAX
``Program._params`` as numpy into the port's ``static.Program``, by name
where the names agree (``ParamAttr`` names), else by position, the
order in which each program first used its parameters (the builders'
unnamed parameters are ``generated_tensor_<n>`` in the JAX package and
``param_<i>`` in the port). :func:`program_to_numpy` is its inverse.
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch
from torch import nn

from ._device import resolve_device
from .models.gpt import GPTConfig, GPTForPretraining
from .nn.layer.common import Linear
from .nn.layer.layers import jax_perm

__all__ = ["gpt_from_jax_params", "gpt_to_numpy_params",
           "opt_state_from_jax", "opt_state_to_jax", "layer_from_jax",
           "layer_to_numpy", "program_from_jax", "program_to_numpy"]

#: the optimizer state keys that are not a parameter's slot
_GLOBAL_KEYS = ("@step", "LR_Scheduler")


def _np32(value) -> np.ndarray:
    """A numpy or torch array (any float dtype) as float32 numpy."""
    if isinstance(value, torch.Tensor):
        return value.detach().float().cpu().numpy()
    return np.asarray(value, np.float32)


def _linear_keys(model) -> set:
    """The keys stored transposed: torch ``nn.Linear`` weights and every
    parameter with the port ``Linear``'s layout mark (its weight, the
    ``weight_v``/``weight_g``/``weight_orig`` of ``nn.utils`` built from
    it, and the int8 layers' ``weight_int8``/``weight_scale``)."""
    keys = {f"{name}.weight" if name else "weight"
            for name, mod in model.named_modules()
            if isinstance(mod, (Linear, nn.Linear))}
    keys.update(k for k, p in model.named_parameters()
                if jax_perm(p) == (1, 0))
    return keys


def layer_from_jax(layer, jax_state: Mapping) -> None:
    """Load ``jax_state`` (a JAX ``Layer.state_dict()``: numpy arrays or
    CPU tensors by structured name) into the port ``layer``, each value
    cast to its parameter's or buffer's dtype and device; ``Linear``
    weights are transposed. Raises ``KeyError`` when the key sets differ
    and ``ValueError`` on a misshapen array."""
    own = layer.state_dict(keep_vars=True)
    missing = sorted(set(own) - set(jax_state))
    unexpected = sorted(set(jax_state) - set(own))
    if missing or unexpected:
        raise KeyError(f"the JAX state does not match the port's layer: "
                       f"missing {missing}, unexpected {unexpected}")
    linear = _linear_keys(layer)
    with torch.no_grad():
        for key, target in own.items():
            value = jax_state[key]
            arr = value.detach().cpu().numpy() if isinstance(
                value, torch.Tensor) else np.asarray(value)
            if key in linear:
                arr = arr.T
            if tuple(arr.shape) != tuple(target.shape):
                raise ValueError(
                    f"{key}: JAX array {tuple(np.shape(value))} does not fit "
                    f"the port's {tuple(target.shape)}"
                    + (" (after the [in, out] -> [out, in] transpose)"
                       if key in linear else ""))
            target.copy_(torch.from_numpy(np.ascontiguousarray(arr)).to(
                target.dtype))


def layer_to_numpy(layer) -> Dict[str, np.ndarray]:
    """The port ``layer``'s state as numpy under the JAX keys and
    layouts (``Linear`` weights back to ``[in, out]``); floating values
    as float32."""
    linear = _linear_keys(layer)
    out = {}
    for key, t in layer.state_dict().items():
        t = t.detach().cpu()
        # a copy: a float32 CPU tensor's numpy() shares the live storage
        arr = (t.float() if t.is_floating_point() else t).numpy()
        out[key] = arr.T.copy() if key in linear else arr.copy()
    return out


def gpt_from_jax_params(params: Mapping[str, np.ndarray], cfg: GPTConfig,
                        device=None, dtype=None,
                        lm_loss_chunks: int = 1) -> GPTForPretraining:
    """A port ``GPTForPretraining(cfg, lm_loss_chunks)`` holding ``params``
    (numpy arrays or CPU tensors) on ``device`` (``None`` = the card).
    Raises ``KeyError`` on a missing or unexpected key and ``ValueError``
    on a misshapen array."""
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
        arr = _np32(params[key])
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


def _slot_keys(model, optimizer):
    """``(JAX tree name, port optimizer name, transposed)`` of every
    parameter ``optimizer`` holds, and the slot names it keeps."""
    port_name = {id(p): name for name, p in optimizer._params}
    linear = _linear_keys(model)
    rows = [(tree, port_name[id(p)], tree in linear)
            for tree, p in model.named_parameters() if id(p) in port_name]
    return rows, list(optimizer._slot_names) + ["master_weight", "_t0"]


def _convert_slots(state, rows, slots, src, dst):
    out = {k: state[k] for k in _GLOBAL_KEYS if k in state}
    for row in rows:
        for sname in slots:
            key = f"{row[src]}_{sname}"
            if key not in state:
                continue
            if sname == "_t0":
                out[f"{row[dst]}_{sname}"] = int(state[key])
                continue
            arr = _np32(state[key])
            out[f"{row[dst]}_{sname}"] = arr.T.copy() if row[2] else arr
    return out


def opt_state_from_jax(state: Mapping, model: GPTForPretraining,
                       optimizer) -> Dict:
    """The JAX optimizer's state (a ``state_dict()`` as numpy, keyed by
    the JAX tree names as ``Model.fit`` and ``Model.save`` key it) as a
    state for ``optimizer``, which updates ``model``'s parameters: each
    slot (``moment1``, ``moment2``, ``master_weight``, ...; ``_t0``)
    under the port optimizer's name for the parameter, Linear weights'
    slots transposed as the weights are, float32; ``@step`` and
    ``LR_Scheduler`` as they are. Slots of parameters ``optimizer`` does
    not hold are left out."""
    rows, slots = _slot_keys(model, optimizer)
    return _convert_slots(state, rows, slots, 0, 1)


def opt_state_to_jax(state: Mapping, model: GPTForPretraining,
                     optimizer) -> Dict:
    """The inverse of :func:`opt_state_from_jax`: ``optimizer``'s
    ``state_dict()`` in the JAX tree's keys and layouts, as numpy."""
    rows, slots = _slot_keys(model, optimizer)
    return _convert_slots(state, rows, slots, 1, 0)


def program_from_jax(program, jax_params: Mapping) -> None:
    """Set the port ``program``'s parameters from ``jax_params`` (the JAX
    program's ``_params`` as numpy, in its order): by name when the key
    sets are equal, else by position when the counts are. Each value is
    in the JAX layout (``Linear`` weights ``[in, out]``) and is cast to
    its parameter's dtype; a misshapen one raises ``ValueError``, a
    count that differs ``KeyError``."""
    from .static.extras import _assign
    own = list(program._params.items())
    if set(jax_params) == set(program._params):
        pairs = [(name, p, jax_params[name]) for name, p in own]
    elif len(jax_params) == len(own):
        pairs = [(name, p, v) for (name, p), v in
                 zip(own, jax_params.values())]
    else:
        raise KeyError(f"the JAX program has {len(jax_params)} parameters, "
                       f"the port's {len(own)}")
    tr = program._transposed()
    for name, p, value in pairs:
        _assign(p, value, name, id(p) in tr)


def program_to_numpy(program) -> Dict[str, np.ndarray]:
    """The port ``program``'s parameters as float32 numpy in the JAX
    layout, under the program's names, in its order."""
    from .static.extras import _files_state
    return {name: np.array(_np32(t))    # a copy, never a view
            for name, t in _files_state(program).items()}
