"""paddle_tpu_torch — the PyTorch/CUDA port of paddle_tpu.

A package beside ``paddle_tpu`` (the JAX reference, which it never
imports). It serves GPT-2 through the fused paged engine and trains it
through ``hapi.Model.fit`` or an eager loop. Its kernels are
hand-written CUDA for Hopper (``csrc/``), built with ``nvcc`` at first
use:

* :mod:`.ops.ragged_paged_attention` — ragged paged attention (serving);
* :mod:`.ops.layer_norm` — fused LayerNorm, forward and backward;
* :mod:`.ops.flash_attention` — flash attention, forward and backward;
* :mod:`.ops.fused_adamw` — the fused AdamW update.

Entry points run on the card unless the caller passes ``device="cpu"``;
on CPU tensors each kernel wrapper runs its plain PyTorch version.
``to_tensor`` and the creation ops default to the card too
(``set_device("cpu")`` makes the CPU the default). Ops run through
``call_op`` (:mod:`.framework.dispatch`), which picks a kernel where one
is registered for the operands (``layer_norm``,
``scaled_dot_product_attention``) and the op's plain body otherwise.
The tensor is ``torch.Tensor`` itself.

::

    import paddle_tpu_torch as pt
    from paddle_tpu_torch.hapi import Model
    from paddle_tpu_torch.models import GPTConfig, GPTForPretraining
    from paddle_tpu_torch.optimizer import AdamW

    pt.seed(0)
    net = GPTForPretraining(GPTConfig.gpt2_small(), lm_loss_chunks=8)
    model = Model(net, inputs=["ids", "labels"])      # moves net to the card
    model.prepare(AdamW(1e-4, parameters=net.parameters(),
                        multi_precision=True),
                  loss=lambda loss, logits: loss,
                  amp_configs={"level": "O2", "dtype": "bfloat16"})
    model.fit(pt.io.TensorDataset([ids, labels]), batch_size=8)

    from paddle_tpu_torch.serving import GenerationEngine
    engine = GenerationEngine(net, kv_layout="paged", attention="fused")
    print(engine.submit(prompt_ids, max_new_tokens=32).result())

    out = net.generate(pt.to_tensor(ids), max_new_tokens=64)   # greedy
"""
from . import (amp, callbacks, io, metric, nn, ops, optimizer,
               regularizer)
from .framework.dispatch import call_op
from .framework.io import load, save
from .framework.dtypes import NAMES as _DTYPES
from .framework.place import get_device, set_device
from .framework.random import seed
from .framework.tensor import (Parameter, grad_enabled_guard,
                               is_grad_enabled, no_grad, to_tensor)
from .ops.registry import op_names as _op_names

__all__ = ["seed", "amp", "callbacks", "io", "metric", "nn", "ops",
           "optimizer", "regularizer", "save", "load", "call_op",
           "get_device", "set_device",
           "Parameter", "grad_enabled_guard", "is_grad_enabled", "no_grad",
           "to_tensor"]

# the dtype names (pt.float32, pt.bfloat16, ...) as torch dtypes
globals().update(_DTYPES)
__all__ += list(_DTYPES)


def _op_function(name):
    def fn(*args, **attrs):
        return call_op(name, *args, **attrs)

    fn.__name__ = fn.__qualname__ = name
    fn.__doc__ = f"The ``{name}`` op through ``call_op``."
    return fn


# every registered op as a function (pt.matmul, pt.concat, ...), as the
# JAX package exports its ops
for _name in _op_names():
    globals()[_name] = _op_function(_name)
    __all__.append(_name)


# the ops the JAX package exports under its own public signatures
# (``name`` is taken and unused there too; ``device`` places a new tensor)
def add(x, y, name=None):
    return call_op("add", x, y)


def multiply(x, y, name=None):
    return call_op("multiply", x, y)


def maximum(x, y, name=None):
    return call_op("maximum", x, y)


def matmul(x, y, transpose_x=False, transpose_y=False, name=None):
    return call_op("matmul", x, y, transpose_x=transpose_x,
                   transpose_y=transpose_y)


def cumsum(x, axis=None, name=None):
    return call_op("cumsum", x, axis=axis)


def concat(x, axis=0, name=None):
    return call_op("concat", x, axis=axis)


def reshape(x, shape, name=None):
    return call_op("reshape", x, shape)


def transpose(x, perm, name=None):
    return call_op("transpose", x, perm)


def slice(input, axes, starts, ends):
    return call_op("slice", input, axes, starts, ends)


def full(shape, fill_value, dtype=None, name=None, *, device=None):
    return call_op("full", shape, fill_value, dtype=dtype, device=device)


def zeros(shape, dtype=None, name=None, *, device=None):
    return call_op("zeros", shape, dtype=dtype, device=device)


def arange(start=0, end=None, step=1, dtype=None, name=None, *,
           device=None):
    return call_op("arange", start, end, step, dtype=dtype, device=device)
del _name
