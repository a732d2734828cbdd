"""Optimizers (counterparts of ``paddle_tpu/optimizer/optimizer.py``): the
base, SGD, Momentum, Adam, AdamW, Adamax, Adagrad, Adadelta, RMSProp and
Lamb.

The eager ``step()`` follows the JAX package's (:172-208), in its order:

1. the ``(param, grad)`` list of the parameters with a gradient goes
   through ``grad_clip`` first (``nn/clip.py``);
2. per parameter, the learning rate is ``get_lr()`` (a float, or the
   value of an ``LRScheduler``) times the parameter's
   ``optimize_attr["learning_rate"]`` (``nn.layer.ParamAttr``, 1.0 when
   absent);
3. the gradient is cast to the parameter's dtype (bf16 or f16 under AMP
   O2), then the global ``L2Decay`` adds ``coeff * p`` or ``L1Decay``
   adds ``coeff * sign(p)`` (Adam-style decoupled decay stays inside
   AdamW's and Lamb's rules);
4. the rule runs at the parameter's own step: the global step less its
   birth step ``_t0`` when its slots carry one (restored by
   ``set_state_dict``), so Adam's bias correction starts from the
   parameter's own t = 0.

With ``multi_precision=True`` a bf16 or f16 parameter keeps a float32
master copy in its slots: the rule runs on the master and the parameter
is the master rounded down. Adam and AdamW gather steps 2-4 for every
parameter in one pass and update them all with one call of the fused
AdamW kernel (``ops/fused_adamw.py``, K8), a few launches a step where
the JAX package's eager step launches its Pallas kernel once per
parameter; on a master it writes the rounded copy in the same pass. The
other rules are plain torch, one parameter at a time: the JAX package
runs them as ``jnp`` expressions and has no kernel for them. Updates are in place: the parameter, its master and
its slots are rewritten where they lie (the JAX step built new arrays).

``parameters`` may be the tensors (``model.parameters()``, named
``param_<i>`` by position) or ``(name, tensor)`` pairs
(``model.named_parameters()``); the names key ``state_dict`` and reach
``apply_decay_param_fun``.
"""
from __future__ import annotations

from typing import Dict, List

import torch

from ..ops.fused_adamw import fused_adamw_group_
from .lr import LRScheduler

__all__ = ["Optimizer", "SGD", "Momentum", "Adam", "AdamW", "Adamax",
           "Adagrad", "Adadelta", "RMSProp", "Lamb", "L1Decay", "L2Decay"]


class L2Decay:
    def __init__(self, coeff=0.0):
        self.coeff = float(coeff)


class L1Decay:
    def __init__(self, coeff=0.0):
        self.coeff = float(coeff)


def _weak(x: float, t: torch.Tensor) -> float:
    """The Python scalar ``x`` as ``jnp`` takes it beside ``t``: rounded
    to ``t``'s dtype (a bf16 tensor times 0.1 multiplies by bf16(0.1),
    where torch would keep 0.1 in float32 and round only the product).
    The rounding runs on the host and gives a Python number, so a step
    copies nothing to the card."""
    return torch.tensor(x, dtype=t.dtype).item()


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
                 weight_decay=None, grad_clip=None, name=None,
                 multi_precision=False):
        if not isinstance(learning_rate, LRScheduler):
            learning_rate = float(learning_rate)
        self._lr = learning_rate
        self._params = None if parameters is None else _named(parameters)
        if isinstance(weight_decay, (int, float)):
            weight_decay = L2Decay(weight_decay)
        self._weight_decay = weight_decay
        self._grad_clip = grad_clip
        self._multi_precision = bool(multi_precision)
        self._slots: Dict[str, Dict[str, torch.Tensor]] = {}
        self._step_count = 0
        # the parameter being updated, for the per-parameter hooks
        # (AdamW's apply_decay_param_fun, Lamb's exclusion)
        self._current_param_name = None
        self._current_param = None

    # -- lr -----------------------------------------------------------------
    def get_lr(self) -> float:
        if isinstance(self._lr, LRScheduler):
            return float(self._lr())
        return self._lr

    def set_lr(self, value):
        if isinstance(self._lr, LRScheduler):
            raise RuntimeError(
                "set_lr is not allowed when the lr is an LRScheduler; call "
                "scheduler.step() instead")
        self._lr = float(value)

    @property
    def _learning_rate(self):
        return self._lr

    # -- state --------------------------------------------------------------
    def _needs_master(self, p) -> bool:
        return self._multi_precision and p.dtype in (torch.bfloat16,
                                                     torch.float16)

    def _new_slot(self, sname, p):
        return torch.zeros_like(p, memory_format=torch.contiguous_format)

    def _ensure_slots(self, name, p):
        slots = self._slots.setdefault(name, {})
        for s in self._slot_names:
            if s not in slots:
                slots[s] = self._new_slot(s, p)
        if self._needs_master(p) and "master_weight" not in slots:
            slots["master_weight"] = p.detach().float().clone()
        return slots

    def state_dict(self) -> dict:
        out = {f"{pname}_{sname}": t for pname, slots in self._slots.items()
               for sname, t in slots.items()}
        out["@step"] = self._step_count
        if isinstance(self._lr, LRScheduler):
            out["LR_Scheduler"] = self._lr.state_dict()
        return out

    def set_state_dict(self, state: dict):
        self._step_count = int(state.get("@step", 0))
        if isinstance(self._lr, LRScheduler) and "LR_Scheduler" in state:
            self._lr.set_state_dict(state["LR_Scheduler"])
        devices = {name: p.device for name, p in self._params or ()}
        for key, value in state.items():
            if key in ("@step", "LR_Scheduler"):
                continue
            # "_t0" is a parameter's birth step: its slots were (re)born at
            # that global step, and it survives a checkpoint like a slot
            for sname in list(self._slot_names) + ["master_weight", "_t0"]:
                if key.endswith("_" + sname):
                    pname = key[:-len(sname) - 1]
                    if sname == "_t0":
                        t = int(value)
                    else:
                        t = torch.as_tensor(value)
                        t = t.to(devices.get(pname, t.device)).clone()
                    self._slots.setdefault(pname, {})[sname] = t
                    break

    # -- update -------------------------------------------------------------
    def _decay_grad(self, p, g):
        if isinstance(self._weight_decay, L2Decay) and \
                self._weight_decay.coeff:
            return g + _weak(self._weight_decay.coeff, p) * p
        if isinstance(self._weight_decay, L1Decay) and \
                self._weight_decay.coeff:
            return g + _weak(self._weight_decay.coeff, p) * torch.sign(p)
        return g

    def _rule(self, p, g, slots, lr, step):
        """The update of one parameter value ``p`` (the master under
        multi-precision): returns the new value, the slots updated in
        place."""
        raise NotImplementedError

    def _update(self, name, p, g, slots, lr, step):
        master = slots.get("master_weight")
        target = p.data if master is None else master
        new = self._rule(target, g, slots, lr, step)
        target.copy_(new)
        if master is not None:
            p.data.copy_(new)

    @torch.no_grad()
    def step(self, _params=None):
        """One update of every parameter with a gradient (of ``_params``,
        ``(name, param)`` pairs, when ``minimize`` limits the step)."""
        params = self._params if _params is None else _params
        if params is None:
            raise ValueError(
                "optimizer was created without a parameter list; pass "
                "parameters=model.parameters()")
        live = [(name, p) for name, p in params
                if p.grad is not None and p.requires_grad]
        pairs = [(p, p.grad) for _, p in live]
        self._clip_norms = None
        if self._grad_clip is not None:
            pairs = self._clip(pairs)
        self._step_count += 1
        try:
            self._apply_updates(live, [g for _, g in pairs], self.get_lr())
        finally:
            self._current_param_name = self._current_param = None

    def _prepare(self, name, p, g, base_lr):
        """Steps 2-4 of ``step()`` for one parameter, with the hooks
        pointed at it: returns its lr, its gradient (cast and decayed),
        its slots and its own step."""
        self._current_param_name, self._current_param = name, p
        lr = base_lr * getattr(p, "optimize_attr", {}).get(
            "learning_rate", 1.0)
        g = self._decay_grad(p, g.to(p.dtype))
        slots = self._ensure_slots(name, p)
        t0 = slots.get("_t0")
        step = self._step_count if t0 is None else \
            self._step_count - int(t0)
        return lr, g, slots, step

    def _apply_updates(self, live, grads, base_lr):
        """Update every ``(name, param)`` of ``live`` with its gradient,
        one parameter at a time."""
        for (name, p), g in zip(live, grads):
            lr, g, slots, step = self._prepare(name, p, g, base_lr)
            self._update(name, p, g, slots, lr, step)

    def _clip(self, pairs):
        """The gradient clip, keeping ``_clip_norms`` = (the pre-clip
        global norm, the clipped one) as f32 device scalars for the
        numerics audit (``Model.fit(numerics=...)``): the global-norm
        clip's own norm, reused, never computed twice; after any other
        clip, only when ``_audit_clip`` asks, the clipped gradients'
        global norm (the pre-clip one is then the audit's to take)."""
        from ..nn.clip import ClipGradByGlobalNorm
        clip = self._grad_clip
        if isinstance(clip, ClipGradByGlobalNorm):
            pairs, norm = clip.clip_with_norm(pairs)
            self._clip_norms = (norm, torch.clamp(norm, max=clip.clip_norm))
            return pairs
        pairs = clip(pairs)
        if getattr(self, "_audit_clip", False):
            from ..profiler.numerics import global_grad_norm
            self._clip_norms = (None, global_grad_norm(
                [g for _, g in pairs]))
        return pairs

    def clear_grad(self, set_to_zero=False):
        for _, p in self._params or ():
            if set_to_zero and p.grad is not None:
                p.grad.zero_()
            else:
                p.grad = None

    clear_gradients = clear_grad

    def minimize(self, loss, startup_program=None, parameters=None,
                 no_grad_set=None):
        """``loss.backward()``, one step and ``clear_grad()``; returns
        ``(None, None)`` as the JAX package's eager ``minimize`` does.
        ``parameters`` (tensors, or the optimizer's names for them) limits
        the step, and its gradient clip, to those parameters, and
        ``no_grad_set`` (tensors or names) takes parameters out of it, as
        the reference means (the JAX package ignores both);
        ``startup_program`` is taken and changes nothing, as there. In
        static mode (a ``static.Program`` recording) it attaches ``loss``
        and this optimizer to the program instead, whose ``Executor.run``
        then takes the step, and returns ``([], [])``; an optimizer built
        without ``parameters`` then updates the program's, under the
        program's names for them. ``parameters`` and ``no_grad_set`` are
        recorded on the program there: each run steps only that subset,
        as in eager mode (the JAX package ignores both in static mode
        too)."""
        from ..framework import static_capture
        prog = static_capture.current
        if prog is not None:
            prog._loss = loss
            prog._optimizer = self
            if self._params is None:
                self._params = list(prog._params.items())
            prog._opt_chosen = None
            if parameters is not None or no_grad_set:
                prog._opt_chosen = _select(self._params, parameters,
                                           no_grad_set)
            return [], []
        loss.backward()
        chosen = None
        if parameters is not None or no_grad_set:
            own = self._params
            chosen = _select(own if own is not None else _named(parameters),
                             parameters, no_grad_set)
        self.step(chosen)
        for _, p in self._params or chosen:
            p.grad = None
        return None, None


def _select(named, parameters, no_grad_set):
    """The ``(name, param)`` pairs of ``named`` that ``parameters`` names
    (all without it) and ``no_grad_set`` does not; each entry is a tensor
    or the optimizer's name for one."""
    def keys(entries):
        entries = list(entries or ())
        return ({id(e) for e in entries if not isinstance(e, str)},
                {e for e in entries if isinstance(e, str)})

    def hit(name, p, ids, names):
        return id(p) in ids or name in names

    want = keys(parameters) if parameters is not None else None
    drop = keys(no_grad_set)
    return [(n, p) for n, p in named
            if (want is None or hit(n, p, *want)) and not hit(n, p, *drop)]


class SGD(Optimizer):
    def _rule(self, p, g, slots, lr, step):
        return p - _weak(lr, g) * g


class Momentum(Optimizer):
    _slot_names = ["velocity"]

    def __init__(self, learning_rate=0.001, momentum=0.9, parameters=None,
                 use_nesterov=False, weight_decay=None, grad_clip=None,
                 name=None, multi_precision=False, rescale_grad=1.0):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, multi_precision)
        self._momentum = momentum
        self._nesterov = use_nesterov

    def _rule(self, p, g, slots, lr, step):
        v = slots["velocity"]
        v.copy_(_weak(self._momentum, v) * v + g)
        d = g + _weak(self._momentum, v) * v if self._nesterov else v
        return p - _weak(lr, d) * d


class Adam(Optimizer):
    """Adam on the fused AdamW kernel (K8) with no decoupled decay; m and
    v are float32."""

    _slot_names = ["moment1", "moment2"]

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, lazy_mode=False, multi_precision=False,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, multi_precision)
        self._beta1, self._beta2, self._eps = beta1, beta2, epsilon

    def _new_slot(self, sname, p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    def _decay_coeff(self, name) -> float:
        return 0.0

    def _apply_updates(self, live, grads, base_lr):
        """One pass gathers every parameter's operands (the master and
        the parameter as its rounded copy under multi-precision), lr,
        decay and step, in the loop's order and with the hooks pointed
        at each in turn; then one fused call updates them all."""
        ps, gs, ms, vs, lows, lrs, wds, steps = ([] for _ in range(8))
        for (name, p), g in zip(live, grads):
            lr, g, slots, step = self._prepare(name, p, g, base_lr)
            master = slots.get("master_weight")
            ps.append(p.data if master is None else master)
            lows.append(None if master is None else p.data)
            gs.append(g.contiguous())
            ms.append(slots["moment1"])
            vs.append(slots["moment2"])
            lrs.append(lr)
            wds.append(self._decay_coeff(name))
            steps.append(step)
        fused_adamw_group_(ps, gs, ms, vs, lows, lrs, wds, steps,
                           self._beta1, self._beta2, self._eps)


class AdamW(Adam):
    """Adam with decoupled weight decay ``wd * p`` inside the update.
    ``weight_decay`` may be a float, ``L2Decay`` or ``L1Decay``: either
    decay's coefficient is the decoupled one. ``lr_ratio`` and
    ``lazy_mode`` are taken for the signature's sake and change nothing,
    as in the JAX package."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=0.01,
                 lr_ratio=None, apply_decay_param_fun=None, grad_clip=None,
                 lazy_mode=False, multi_precision=False, name=None):
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         None, grad_clip, lazy_mode, multi_precision, name)
        self._wd_coeff = weight_decay.coeff if isinstance(
            weight_decay, (L2Decay, L1Decay)) else float(weight_decay)
        self._apply_decay_param_fun = apply_decay_param_fun

    def _decay_coeff(self, name) -> float:
        if self._apply_decay_param_fun is not None and \
                not self._apply_decay_param_fun(name):
            return 0.0
        return self._wd_coeff


class Adamax(Optimizer):
    _slot_names = ["moment", "inf_norm"]

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._beta1, self._beta2, self._eps = beta1, beta2, epsilon

    def _rule(self, p, g, slots, lr, step):
        gf = g.float()
        m, u = slots["moment"], slots["inf_norm"]
        m.copy_(self._beta1 * m + (1 - self._beta1) * gf)
        u.copy_(torch.maximum(self._beta2 * u, gf.abs()))
        return p.float() - (lr / (1 - self._beta1 ** step)) * m / (
            u + self._eps)


class Adagrad(Optimizer):
    _slot_names = ["moment"]

    def __init__(self, learning_rate, epsilon=1e-6, parameters=None,
                 weight_decay=None, grad_clip=None, name=None,
                 initial_accumulator_value=0.0):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._eps = epsilon
        self._init_acc = initial_accumulator_value

    def _new_slot(self, sname, p):
        return torch.full(p.shape, float(self._init_acc),
                          dtype=torch.float32, device=p.device)

    def _rule(self, p, g, slots, lr, step):
        gf = g.float()
        acc = slots["moment"]
        acc.add_(gf * gf)
        return p.float() - lr * gf / (acc.sqrt() + self._eps)


class Adadelta(Optimizer):
    _slot_names = ["avg_squared_grad", "avg_squared_update"]

    def __init__(self, learning_rate=0.001, epsilon=1e-6, rho=0.95,
                 parameters=None, weight_decay=None, grad_clip=None,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._eps, self._rho = epsilon, rho

    def _rule(self, p, g, slots, lr, step):
        gf = g.float()
        eg, eu = slots["avg_squared_grad"], slots["avg_squared_update"]
        eg.copy_(self._rho * eg + (1 - self._rho) * gf * gf)
        update = -torch.sqrt((eu + self._eps) / (eg + self._eps)) * gf
        eu.copy_(self._rho * eu + (1 - self._rho) * update * update)
        return p.float() + lr * update


class RMSProp(Optimizer):
    _slot_names = ["mean_square", "mean_grad", "momentum"]

    def __init__(self, learning_rate, rho=0.95, epsilon=1e-6, momentum=0.0,
                 centered=False, parameters=None, weight_decay=None,
                 grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._rho, self._eps = rho, epsilon
        self._momentum = momentum
        self._centered = centered

    def _rule(self, p, g, slots, lr, step):
        gf = g.float()
        ms, mg, mom = (slots[s] for s in self._slot_names)
        ms.copy_(self._rho * ms + (1 - self._rho) * gf * gf)
        if self._centered:
            mg.copy_(self._rho * mg + (1 - self._rho) * gf)
            denom = torch.sqrt(ms - mg * mg + self._eps)
        else:
            denom = torch.sqrt(ms + self._eps)
        mom.copy_(self._momentum * mom + lr * gf / denom)
        return p.float() - mom


class Lamb(Optimizer):
    """Layer-wise adaptive moments: the Adam direction plus decoupled
    decay, scaled by the trust ratio ``|p| / |r|`` of the whole
    parameter. ``exclude_from_weight_decay_fn`` receives the parameter
    itself (the torch ``Parameter``)."""

    _slot_names = ["moment1", "moment2"]

    def __init__(self, learning_rate=0.001, lamb_weight_decay=0.01,
                 beta1=0.9, beta2=0.999, epsilon=1e-6, parameters=None,
                 grad_clip=None, exclude_from_weight_decay_fn=None,
                 name=None):
        super().__init__(learning_rate, parameters, None, grad_clip, name)
        self._wd = lamb_weight_decay
        self._beta1, self._beta2, self._eps = beta1, beta2, epsilon
        self._exclude_fn = exclude_from_weight_decay_fn

    def _rule(self, p, g, slots, lr, step):
        gf, pf = g.float(), p.float()
        m, v = slots["moment1"], slots["moment2"]
        m.copy_(self._beta1 * m + (1 - self._beta1) * gf)
        v.copy_(self._beta2 * v + (1 - self._beta2) * gf * gf)
        mhat = m / (1 - self._beta1 ** step)
        vhat = v / (1 - self._beta2 ** step)
        wd = self._wd
        if self._exclude_fn is not None and \
                self._current_param is not None and \
                self._exclude_fn(self._current_param):
            wd = 0.0
        r = mhat / (vhat.sqrt() + self._eps) + wd * pf
        w_norm, r_norm = torch.linalg.vector_norm(pf), \
            torch.linalg.vector_norm(r)
        trust = torch.where((w_norm > 0) & (r_norm > 0), w_norm / r_norm,
                            torch.ones_like(w_norm))
        return pf - lr * trust * r
