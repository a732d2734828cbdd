"""Automatic mixed precision (counterpart of ``paddle_tpu/amp``): levels
``"O1"`` and ``"O2"`` in bfloat16 or float16, and dynamic loss scaling.

:func:`auto_cast` sets a per-op dtype policy (the JAX package's
``amp_cast_inputs``), which ``framework.dispatch.call_op`` applies to
every op routed through it (:func:`cast_inputs`); the cross-entropy,
which does not go through ``call_op``, applies it itself. Inside
``auto_cast``, for a floating operand:

* an op on the black list (``black_list`` less ``custom_white_list``,
  plus ``custom_black_list``) runs on float32;
* an op on the white list (``white_list`` plus ``custom_white_list``)
  runs on the AMP dtype;
* any other op runs on the AMP dtype at O2, and on what it was given at
  O1.

:func:`decorate` casts a model's parameters to the AMP dtype once (O2);
optimizers created with ``multi_precision=True`` keep float32 master
weights. Per op of the GPT path:

==================================  =====  =============  ============
op (module)                         list   O1             O2
==================================  =====  =============  ============
``embedding`` (``nn.Embedding``)    no     as given       AMP (weights)
``layer_norm`` (``nn.LayerNorm``)   black  f32            f32
``linear`` (``nn.Linear``)          white  AMP            AMP
``scaled_dot_product_attention``    white  AMP            AMP
``gelu``, ``dropout``, residual +   no     as given       AMP
``matmul`` (tied LM head, logits)   white  AMP            AMP
``cross_entropy`` (dense loss)      black  f32            f32
chunked LM loss                     --     f32 (``ln_f``'s output is
                                           f32; the table is promoted)
==================================  =====  =============  ============

So under O2 the residual stream is in the AMP dtype and every LayerNorm
returns f32, which the next Linear casts down; the LayerNorm kernels run
in float32 on both levels. Under O1 the parameters stay float32 and
only the white-list ops run in the AMP dtype.

bfloat16 has float32's exponent range and needs no loss scaling.
float16 does: :class:`GradScaler` multiplies the loss by a scale,
unscales the gradients before the step, skips the step when a gradient
is not finite, and adapts the scale (the JAX package's state machine).
Its finite check is one device flag for all the gradients, read back
once a step (the JAX package reads one flag per parameter).
"""
from __future__ import annotations

import contextlib
import threading

import torch

__all__ = ["auto_cast", "decorate", "GradScaler", "cast_inputs",
           "is_auto_cast_enabled", "get_amp_dtype", "get_amp_level",
           "white_list", "black_list"]

white_list = {
    "matmul", "bmm", "mv", "linear", "conv1d", "conv2d", "conv3d",
    "conv2d_transpose", "einsum", "addmm",
    "scaled_dot_product_attention",
}
black_list = {
    "softmax", "log_softmax", "layer_norm", "batch_norm", "group_norm",
    "instance_norm", "rms_norm", "cross_entropy",
    "softmax_with_cross_entropy", "nll_loss", "bce_loss", "bce_with_logits",
    "mean", "sum", "p_norm", "frobenius_norm", "logsumexp", "exp", "log",
    "cumsum", "prod",
}

LEVELS = ("O1", "O2")
_DTYPES = {"bfloat16": torch.bfloat16, "bf16": torch.bfloat16,
           torch.bfloat16: torch.bfloat16, "float16": torch.float16,
           "fp16": torch.float16, torch.float16: torch.float16}

_state = threading.local()


def _amp_dtype(level, dtype) -> torch.dtype:
    if level not in LEVELS:
        raise ValueError(f"AMP level {level!r} is not one of {LEVELS}")
    if dtype not in _DTYPES:
        raise ValueError(f"AMP dtype {dtype!r} is not bfloat16 or float16")
    return _DTYPES[dtype]


@contextlib.contextmanager
def auto_cast(enable=True, custom_white_list=None, custom_black_list=None,
              level="O1", dtype="bfloat16"):
    """Apply the AMP cast policy of ``level`` and ``dtype`` to the ops
    called inside; ``enable=False`` turns it off for the block."""
    amp_dtype = _amp_dtype(level, dtype)
    white = set(custom_white_list or ())
    policy = (amp_dtype, level, white_list | white,
              (black_list - white) | set(custom_black_list or ()))
    old = getattr(_state, "policy", None)
    _state.policy = policy if enable else None
    try:
        yield
    finally:
        _state.policy = old


def is_auto_cast_enabled() -> bool:
    return getattr(_state, "policy", None) is not None


def get_amp_dtype():
    """The AMP dtype inside ``auto_cast``, else ``None``."""
    policy = getattr(_state, "policy", None)
    return None if policy is None else policy[0]


def get_amp_level() -> str:
    """``"O1"`` or ``"O2"`` inside ``auto_cast``, else ``"O0"``."""
    policy = getattr(_state, "policy", None)
    return "O0" if policy is None else policy[1]


def cast_inputs(op_name: str, *tensors):
    """The tensors ``op_name`` runs on under the active policy (see the
    module's docstring); non-float tensors, ``None``, and everything
    outside ``auto_cast`` pass as they are."""
    policy = getattr(_state, "policy", None)
    if policy is None:
        return tensors
    amp_dtype, level, white, black = policy
    if op_name in black:
        target = torch.float32
    elif op_name in white or level == "O2":
        target = amp_dtype
    else:
        return tensors
    return tuple(t.to(target) if t is not None and t.is_floating_point()
                 and t.dtype != target else t for t in tensors)


def decorate(models, optimizers=None, level="O2", dtype="bfloat16",
             master_weight=None, save_dtype=None):
    """At O2, cast each model's parameters and buffers to the AMP dtype in
    place (the same ``Parameter`` objects, so an optimizer built earlier
    still holds them); at O1 leave them float32. ``master_weight`` and
    ``save_dtype`` change nothing, as in the JAX package: float32 masters
    are the optimizer's (``multi_precision=True``), and a checkpoint
    keeps each parameter's dtype."""
    amp_dtype = _amp_dtype(level, dtype)
    single = not isinstance(models, (list, tuple))
    model_list = [models] if single else list(models)
    if level == "O2":
        for m in model_list:
            m.to(dtype=amp_dtype)
    out = models if single else model_list
    return out if optimizers is None else (out, optimizers)


class GradScaler:
    """Dynamic loss scaling (the JAX package's ``GradScaler``).

    ``scale(loss)`` multiplies the loss by the scale; ``step(optimizer)``
    unscales the gradients in place (``unscale_``, once between
    ``update()``s) and steps the optimizer only if every gradient is
    finite, so a skipped step leaves the parameters, the slots and the
    optimizer's step count as they were; ``update()`` adapts the scale:
    times ``incr_ratio`` after ``incr_every_n_steps`` finite steps in a
    row, times ``decr_ratio`` (floored at 1.0) after
    ``decr_every_n_nan_or_inf`` non-finite ones. ``enable=False`` passes
    the loss and the step through.
    """

    def __init__(self, enable=True, init_loss_scaling=2. ** 15,
                 incr_ratio=2.0, decr_ratio=0.5, incr_every_n_steps=1000,
                 decr_every_n_nan_or_inf=2, use_dynamic_loss_scaling=True):
        self._enable = enable
        self._scale = float(init_loss_scaling) if enable else 1.0
        self._incr_ratio = incr_ratio
        self._decr_ratio = decr_ratio
        self._incr_every = incr_every_n_steps
        self._decr_every = decr_every_n_nan_or_inf
        self._dynamic = use_dynamic_loss_scaling
        self._good_steps = 0
        self._bad_steps = 0
        self._found_inf = False
        self._stage = "INIT"        # -> UNSCALED -> STEPPED, reset by update

    def is_enable(self):
        return self._enable

    def is_use_dynamic_loss_scaling(self):
        return self._enable and self._dynamic

    def get_loss_scaling(self):
        return self._scale

    def scale(self, loss):
        if not self._enable:
            return loss
        return loss * self._scale

    @torch.no_grad()
    def unscale_(self, optimizer):
        """Divide every gradient by the scale in place and record whether
        any is not finite: one fused pass per device and dtype, and one
        read of the flag."""
        if not self._enable:
            return
        if self._stage != "INIT":
            raise RuntimeError(
                "unscale_() may only be called once between update()s, "
                "and not after step().")
        groups = {}
        for _, p in optimizer._params or ():
            if p.grad is not None:
                groups.setdefault((p.grad.device, p.grad.dtype),
                                  []).append(p.grad)
        found = False
        for (device, _), grads in groups.items():
            flag = torch.zeros(1, dtype=torch.float32, device=device)
            inv = torch.full((1,), 1.0 / self._scale, dtype=torch.float32,
                             device=device)
            torch._amp_foreach_non_finite_check_and_unscale_(grads, flag,
                                                             inv)
            found = found or bool(flag.item())
        self._found_inf = found
        self._stage = "UNSCALED"

    def step(self, optimizer):
        if not self._enable:
            optimizer.step()
            return
        if self._stage == "STEPPED":
            raise RuntimeError(
                "step() has already been called since the last update().")
        if self._stage != "UNSCALED":
            self.unscale_(optimizer)
        if not self._found_inf:
            optimizer.step()
        self._stage = "STEPPED"

    def minimize(self, optimizer, scaled_loss):
        scaled_loss.backward()
        self.step(optimizer)
        self.update()

    def update(self):
        self._stage = "INIT"
        if not (self._enable and self._dynamic):
            return
        if self._found_inf:
            self._bad_steps += 1
            self._good_steps = 0
            if self._bad_steps >= self._decr_every:
                self._scale = max(self._scale * self._decr_ratio, 1.0)
                self._bad_steps = 0
        else:
            self._good_steps += 1
            self._bad_steps = 0
            if self._good_steps >= self._incr_every:
                self._scale *= self._incr_ratio
                self._good_steps = 0
        self._found_inf = False

    def state(self) -> dict:
        """The scale, the good/bad-step streaks and the pending verdict."""
        return {"scale": self._scale, "good_steps": self._good_steps,
                "bad_steps": self._bad_steps,
                "found_inf": self._found_inf, "enabled": self._enable}

    def state_dict(self):
        return {"scale": self._scale, "incr_ratio": self._incr_ratio,
                "decr_ratio": self._decr_ratio,
                "incr_count": self._good_steps,
                "decr_count": self._bad_steps,
                "use_dynamic_loss_scaling": self._dynamic}

    def load_state_dict(self, state):
        self._scale = state.get("scale", self._scale)
        self._good_steps = state.get("incr_count", 0)
        self._bad_steps = state.get("decr_count", 0)
