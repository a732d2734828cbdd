"""Optimizer base, Adam and AdamW (counterparts of
``paddle_tpu/optimizer/optimizer.py``).

The eager ``step()`` walks the parameters with a gradient and updates
each one with the fused AdamW kernel (``ops/fused_adamw.py``), one
launch per parameter, as the JAX package's eager step launches its
Pallas kernel per parameter. Per parameter, as there:

* the gradient is cast to the parameter's dtype first (bf16 under AMP
  O2), then, for Adam with a float ``weight_decay``, the L2 term
  ``coeff * p`` is added to it;
* with ``multi_precision=True`` a bf16 parameter keeps a float32 master
  copy in its slots: the rule runs on the master and the parameter is
  the master rounded down, written by the same kernel pass;
* AdamW's decoupled decay is skipped for a parameter whose name
  ``apply_decay_param_fun(name)`` rejects.

The update is in place: the parameter tensor, its master and its
moments are rewritten where they lie (the JAX step built new arrays).

``parameters`` may be the tensors (``model.parameters()``, named
``param_<i>`` by position) or ``(name, tensor)`` pairs
(``model.named_parameters()``); the names key ``state_dict`` and reach
``apply_decay_param_fun``. The learning rate is a float: the schedulers
of ``optimizer/lr.py`` are not ported yet, nor are gradient clipping and
the other optimizers.
"""
from __future__ import annotations

from typing import Dict, List

import torch

from ..ops.fused_adamw import fused_adamw_

__all__ = ["Optimizer", "Adam", "AdamW", "L2Decay"]


class L2Decay:
    def __init__(self, coeff=0.0):
        self.coeff = float(coeff)


def _named(parameters):
    named = []
    for i, item in enumerate(parameters):
        if isinstance(item, tuple):
            named.append((str(item[0]), item[1]))
        else:
            named.append((f"param_{i}", item))
    return named


class Optimizer:
    _slot_names: List[str] = []

    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, multi_precision=False):
        self._lr = float(learning_rate)
        self._params = None if parameters is None else _named(parameters)
        if isinstance(weight_decay, (int, float)):
            weight_decay = L2Decay(weight_decay)
        self._weight_decay = weight_decay
        self._multi_precision = bool(multi_precision)
        self._slots: Dict[str, Dict[str, torch.Tensor]] = {}
        self._step_count = 0

    # -- lr -----------------------------------------------------------------
    def get_lr(self) -> float:
        return self._lr

    def set_lr(self, value):
        self._lr = float(value)

    # -- state --------------------------------------------------------------
    def _needs_master(self, p) -> bool:
        return self._multi_precision and p.dtype in (torch.bfloat16,
                                                     torch.float16)

    def _ensure_slots(self, name, p):
        if name not in self._slots:
            slots = {s: torch.zeros(p.shape, dtype=torch.float32,
                                    device=p.device)
                     for s in self._slot_names}
            if self._needs_master(p):
                slots["master_weight"] = p.detach().float().clone()
            self._slots[name] = slots
        return self._slots[name]

    def state_dict(self) -> dict:
        out = {f"{pname}_{sname}": t for pname, slots in self._slots.items()
               for sname, t in slots.items()}
        out["@step"] = self._step_count
        return out

    def set_state_dict(self, state: dict):
        self._step_count = int(state.get("@step", 0))
        devices = {name: p.device for name, p in self._params or ()}
        for key, value in state.items():
            if key == "@step":
                continue
            for sname in list(self._slot_names) + ["master_weight"]:
                if key.endswith("_" + sname):
                    pname = key[:-len(sname) - 1]
                    t = torch.as_tensor(value, dtype=torch.float32)
                    self._slots.setdefault(pname, {})[sname] = t.to(
                        devices.get(pname, t.device)).clone()
                    break

    # -- update -------------------------------------------------------------
    def _decay_grad(self, p, g):
        if isinstance(self._weight_decay, L2Decay) and \
                self._weight_decay.coeff:
            return g + self._weight_decay.coeff * p
        return g

    def _update(self, name, p, g, slots, lr, step):
        raise NotImplementedError

    @torch.no_grad()
    def step(self):
        if self._params is None:
            raise ValueError(
                "optimizer was created without a parameter list; pass "
                "parameters=model.parameters()")
        self._step_count += 1
        lr = self.get_lr()
        for name, p in self._params:
            if p.grad is None or not p.requires_grad:
                continue
            g = self._decay_grad(p, p.grad.to(p.dtype))
            self._update(name, p, g, self._ensure_slots(name, p), lr,
                         self._step_count)

    def clear_grad(self, set_to_zero=False):
        for _, p in self._params or ():
            if set_to_zero and p.grad is not None:
                p.grad.zero_()
            else:
                p.grad = None

    clear_gradients = clear_grad

    def minimize(self, loss):
        loss.backward()
        self.step()
        self.clear_grad()


class Adam(Optimizer):
    _slot_names = ["moment1", "moment2"]

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 multi_precision=False):
        super().__init__(learning_rate, parameters, weight_decay,
                         multi_precision)
        self._beta1, self._beta2, self._eps = beta1, beta2, epsilon

    def _decay_coeff(self, name) -> float:
        return 0.0

    def _update(self, name, p, g, slots, lr, step):
        master = slots.get("master_weight")
        target, low = (p.data, None) if master is None else (master, p.data)
        fused_adamw_(target, g.contiguous(), slots["moment1"],
                     slots["moment2"], lr, self._beta1, self._beta2,
                     self._eps, self._decay_coeff(name), step, low=low)


class AdamW(Adam):
    """Adam with decoupled weight decay ``wd * p`` inside the update."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=0.01,
                 apply_decay_param_fun=None, multi_precision=False):
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         None, multi_precision)
        self._wd_coeff = weight_decay.coeff if isinstance(
            weight_decay, L2Decay) else float(weight_decay)
        self._apply_decay_param_fun = apply_decay_param_fun

    def _decay_coeff(self, name) -> float:
        if self._apply_decay_param_fun is not None and \
                not self._apply_decay_param_fun(name):
            return 0.0
        return self._wd_coeff
