"""``incubate.optimizer`` (counterpart of
``paddle_tpu/incubate/optimizer/__init__.py``): ``LookAhead`` and
``ModelAverage``, wrappers that keep extra copies of the parameters on
their device, keyed by the optimizer's names for the parameters.

Both update in place. ``LookAhead``'s sync reaches the value the inner
optimizer steps: under ``multi_precision`` the float32 master as well as
the parameter (its slow copy is float32 there). The JAX ``LookAhead``
writes the slow weights into the parameter only, so the inner
optimizer's next step starts from the master's fast weights again and
the sync is lost (ROADMAP Queue 3, "Defects of the reference"); without
masters the two agree.
"""
from __future__ import annotations

import contextlib

import torch

from ...optimizer.optimizer import Optimizer, _weak

__all__ = ["LookAhead", "ModelAverage"]


class LookAhead(Optimizer):
    """k-step lookahead: every ``k`` inner steps, ``slow <- slow + alpha *
    (fast - slow)`` and the fast weights (and their masters) take the
    slow ones. The slow weights start as the weights at construction."""

    def __init__(self, inner_optimizer, alpha=0.5, k=5, name=None):
        if inner_optimizer is None:
            raise ValueError("inner optimizer cannot be None")
        params = inner_optimizer._params
        super().__init__(learning_rate=inner_optimizer._lr,
                         parameters=params)
        self.inner_optimizer = inner_optimizer
        self.alpha = float(alpha)
        self.k = int(k)
        masters = inner_optimizer._master_weights()
        self._slow = {}
        for name, p in params or ():
            fast = masters.get(id(p), p).detach()
            if inner_optimizer._needs_master(p):
                fast = fast.float()
            self._slow[name] = fast.clone()

    def _master_weights(self):
        return self.inner_optimizer._master_weights()

    @torch.no_grad()
    def step(self, _params=None):
        self.inner_optimizer.step(_params)
        self._step_count += 1
        if self._step_count % self.k != 0:
            return
        masters = self.inner_optimizer._master_weights()
        for name, p in self.inner_optimizer._params or ():
            fast = masters.get(id(p), p)
            slow = self._slow.get(name)
            if slow is None:
                slow = fast.detach().clone()
            slow = slow + _weak(self.alpha, slow) * (fast - slow)
            self._slow[name] = slow
            fast.copy_(slow)
            if fast is not p:
                p.copy_(slow)

    def clear_grad(self, set_to_zero=False):
        self.inner_optimizer.clear_grad(set_to_zero)

    def state_dict(self):
        out = self.inner_optimizer.state_dict()
        out["@lookahead_step"] = self._step_count
        for name, t in self._slow.items():
            out[f"{name}_slow"] = t
        return out

    def set_state_dict(self, state):
        state = dict(state)
        self._step_count = int(state.pop("@lookahead_step", 0))
        devices = {name: p.device for name, p in self._params or ()}
        for key in [k for k in state if k.endswith("_slow")]:
            name = key[:-5]
            t = torch.as_tensor(state.pop(key))
            self._slow[name] = t.to(devices.get(name, t.device)).clone()
        self.inner_optimizer.set_state_dict(state)


class ModelAverage(Optimizer):
    """A running average of the parameters: ``step()`` adds each one to
    its sum (in its own dtype), rescaling the sum to the window once the
    count outgrows it; ``with apply():`` swaps the averages in and, unless
    ``need_restore=False``, the live weights back at its end;
    ``restore()`` swaps them back."""

    def __init__(self, average_window_rate, parameters=None,
                 min_average_window=10000, max_average_window=10000,
                 name=None):
        super().__init__(learning_rate=0.0, parameters=parameters)
        self.avg_rate = float(average_window_rate)
        self.min_avg = int(min_average_window)
        self.max_avg = int(max_average_window)
        self._sum = {}
        self._num = {}
        self._backup = None

    @torch.no_grad()
    def step(self, _params=None):
        for name, p in self._params or ():
            if name not in self._sum:
                self._sum[name] = torch.zeros_like(p)
                self._num[name] = 0
            self._sum[name] = self._sum[name] + p
            self._num[name] += 1
            window = max(self.min_avg,
                         min(self.max_avg,
                             int(self._num[name] * self.avg_rate)))
            if self._num[name] > window:
                self._sum[name] = self._sum[name] * _weak(
                    window / self._num[name], p)
                self._num[name] = window
        self._step_count += 1

    @contextlib.contextmanager
    def apply(self, executor=None, need_restore=True):
        """The averages in the parameters for the block; the live weights
        back at its end (bit for bit) unless ``need_restore=False``."""
        self._backup = {name: p.detach().clone()
                        for name, p in self._params or ()}
        with torch.no_grad():
            for name, p in self._params or ():
                n = self._num.get(name, 0)
                if n > 0:
                    p.copy_(self._sum[name] / n)
        try:
            yield
        finally:
            if need_restore:
                self.restore()
            else:
                self._backup = None

    @torch.no_grad()
    def restore(self, executor=None):
        if self._backup is None:
            return
        for name, p in self._params or ():
            if name in self._backup:
                p.copy_(self._backup[name])
        self._backup = None
