"""Automatic mixed precision (counterpart of ``paddle_tpu/amp``): bf16
AMP at level ``"O2"``, the level the GPT training path uses.

bf16 has float32's exponent range, so bf16 AMP needs no loss scaling:
:func:`auto_cast` is a per-op dtype policy and :class:`GradScaler` is a
pass-through. :func:`decorate` casts a model's parameters to bf16 once;
optimizers created with ``multi_precision=True`` keep float32 master
weights. Level ``"O1"``, float16 (which needs dynamic loss scaling) and
the custom op lists are not ported: asking for them raises.

The policy is the JAX package's ``amp_cast_inputs`` at O2: inside
``auto_cast``, an op on the black list runs on float32 inputs and every
other float op on bf16 inputs. The port has no op dispatcher, so each
module of the GPT training path applies it where the JAX package's
dispatcher would (:func:`cast_inputs`), per op:

==================================  =====  ============================
op (module)                         list   at O2
==================================  =====  ============================
``embedding`` (``nn.Embedding``)    no     bf16 (weights already)
``layer_norm`` (``nn.LayerNorm``)   black  x, weight, bias -> f32
``linear`` (``nn.Linear``)          no     x, weight, bias -> bf16
``scaled_dot_product_attention``    no     q, k, v -> bf16
``gelu``, ``dropout``, residual +   no     bf16 (inputs already)
``matmul`` (tied LM head, logits)   no     hidden, table -> bf16
``cross_entropy`` (dense loss)      black  logits -> f32
chunked LM loss                     --     f32 (hidden is f32 from
                                           ``ln_f``; the table is
                                           promoted, as ``jnp``
                                           promotes it)
==================================  =====  ============================

So the residual stream is bf16 and every LayerNorm returns f32, which
the next Linear casts down; the LayerNorm kernels run in float32.
"""
from __future__ import annotations

import contextlib
import threading

import torch

__all__ = ["auto_cast", "decorate", "GradScaler", "cast_inputs",
           "black_list"]

black_list = {
    "softmax", "log_softmax", "layer_norm", "batch_norm", "group_norm",
    "instance_norm", "rms_norm", "cross_entropy",
    "softmax_with_cross_entropy", "nll_loss", "bce_loss", "bce_with_logits",
    "mean", "sum", "p_norm", "frobenius_norm", "logsumexp", "exp", "log",
    "cumsum", "prod",
}

_state = threading.local()


def _check(level, dtype):
    if level != "O2":
        raise NotImplementedError(
            f"AMP level {level!r} is not ported: only 'O2' is")
    if dtype not in ("bfloat16", "bf16", torch.bfloat16):
        raise NotImplementedError(
            f"AMP dtype {dtype!r} is not ported: only bfloat16 is (float16 "
            f"needs dynamic loss scaling)")


@contextlib.contextmanager
def auto_cast(enable=True, level="O2", dtype="bfloat16"):
    """Enable the O2 bf16 cast policy for the modules called inside."""
    _check(level, dtype)
    old = getattr(_state, "dtype", None)
    _state.dtype = torch.bfloat16 if enable else None
    try:
        yield
    finally:
        _state.dtype = old


def cast_inputs(op_name: str, *tensors):
    """The tensors ``op_name`` runs on under the active policy: floating
    tensors cast to f32 (black list) or to bf16 (any other op); others,
    and everything outside ``auto_cast``, as they are. ``None`` passes
    through."""
    amp_dtype = getattr(_state, "dtype", None)
    if amp_dtype is None:
        return tensors
    target = torch.float32 if op_name in black_list else amp_dtype
    return tuple(t.to(target) if t is not None and t.is_floating_point()
                 and t.dtype != target else t for t in tensors)


def decorate(models, optimizers=None, level="O2", dtype="bfloat16"):
    """Cast each model's parameters and buffers to bf16 in place (the same
    ``Parameter`` objects, so an optimizer built earlier still holds
    them)."""
    _check(level, dtype)
    single = not isinstance(models, (list, tuple))
    model_list = [models] if single else list(models)
    for m in model_list:
        m.to(dtype=torch.bfloat16)
    out = models if single else model_list
    return out if optimizers is None else (out, optimizers)


class GradScaler:
    """Loss scaling; only the bf16 pass-through is ported
    (``enable=False``): ``scale`` returns the loss, ``step`` steps the
    optimizer, ``update`` does nothing. Dynamic float16 loss scaling
    waits (ROADMAP)."""

    def __init__(self, enable=False):
        if enable:
            raise NotImplementedError(
                "dynamic loss scaling (float16 AMP) is not ported: use "
                "bfloat16 with GradScaler(enable=False)")

    def scale(self, loss):
        return loss

    def step(self, optimizer):
        optimizer.step()

    def update(self):
        return None

    def minimize(self, optimizer, scaled_loss):
        scaled_loss.backward()
        self.step(optimizer)
        self.update()
