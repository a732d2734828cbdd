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
from . import io, nn, ops
from .framework.dispatch import call_op
from .framework.dtypes import NAMES as _DTYPES
from .framework.place import get_device, set_device
from .framework.random import seed
from .framework.tensor import (Parameter, grad_enabled_guard,
                               is_grad_enabled, no_grad, to_tensor)
from .ops.registry import op_names as _op_names

__all__ = ["seed", "io", "nn", "ops", "call_op", "get_device", "set_device",
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
del _name
