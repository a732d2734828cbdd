"""paddle_tpu_torch — the PyTorch/CUDA port of paddle_tpu.

A package beside ``paddle_tpu`` (the JAX reference, which it never
imports). It serves GPT-2 through the fused paged engine and trains it
through ``hapi.Model.fit`` or an eager loop; the op library, the
``paddle.*`` functions (:mod:`.tensor`, re-exported here), ``nn``
(``Layer``, ``functional``, ``initializer`` and the layers through
``nn.Transformer``, the conv, pooling and recurrent layers), the BERT
and seq2seq ``TransformerModel`` models, ``text`` and ``vision.models``'
ResNet family build other networks the same way. Every other public
name of the JAX package's top level is here too, or raises
``NotImplementedError`` naming the ROADMAP Queue 1 item that ports it. Its kernels are
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
import torch as _torch

from . import (amp, autograd, callbacks, compat, device, hapi, inference, io,
               jit, metric, nn, ops, optimizer, profiler, regularizer, static,
               sysconfig, text, utils, version)
from .autograd import grad
from .batch import batch
from .hapi.model_summary import flops, summary
from .nn.layer.layers import ParamAttr
from .framework import metrics
from .framework.dispatch import call_op
from .framework.flags import get_flags, set_flags
from .framework.io import load, save
from .framework.dtypes import NAMES as _DTYPES
from .framework.dtypes import get_default_dtype, set_default_dtype
from .framework.metrics import statusz
from .framework.place import (CPUPlace, CUDAPinnedPlace, CUDAPlace, NPUPlace,
                              Place, TPUPlace, current_place, get_device,
                              is_compiled_with_tpu, set_device)
from .framework.random import get_rng_state as get_cuda_rng_state
from .framework.random import seed
from .framework.random import set_rng_state as set_cuda_rng_state
from .framework.tensor import (Parameter, Tensor, grad_enabled_guard,
                               is_grad_enabled, no_grad, to_tensor)
from .hapi.model import Model
from .static import disable_static, enable_static, in_dynamic_mode
from .ops.registry import not_ported as _not_ported
from .ops.registry import op_names as _op_names

#: a tensor's dtype is a ``torch.dtype``
dtype = _torch.dtype
bool_ = _torch.bool
#: a context manager (and decorator) setting grad recording to ``mode``
set_grad_enabled = grad_enabled_guard

__all__ = ["seed", "amp", "autograd", "callbacks", "compat", "device", "hapi",
           "inference", "io", "jit", "metric", "metrics", "models", "nn",
           "ops", "optimizer", "profiler", "regularizer", "serving",
           "static", "sysconfig", "text", "utils", "version", "vision",
           "grad", "batch", "summary", "flops", "enable_static",
           "disable_static", "in_dynamic_mode", "save", "load", "call_op",
           "ParamAttr", "tensor", "get_device", "set_device", "Model",
           "Place", "CPUPlace", "CUDAPlace", "CUDAPinnedPlace", "NPUPlace",
           "TPUPlace", "current_place",
           "is_compiled_with_tpu", "get_flags", "set_flags", "statusz",
           "Tensor", "dtype", "bool_", "get_default_dtype",
           "set_default_dtype", "get_cuda_rng_state", "set_cuda_rng_state",
           "set_grad_enabled", "Parameter", "grad_enabled_guard",
           "is_grad_enabled", "no_grad", "to_tensor"]

#: the JAX package's top-level names not ported yet, by ROADMAP Queue 1
#: item: multi-device (4) and API breadth (5)
_DEFERRED = dict.fromkeys(("DataParallel", "distributed", "parallel"), 4)
_DEFERRED.update(dict.fromkeys((
    "analysis", "cost_model", "incubate", "reader"), 5))

#: imported at first use: loading a ``jit.save`` artifact (``jit.load``,
#: ``inference``) needs the op library and no model code, and the 1.x
#: namespace, the ONNX exporter, quantization, the datasets, hub and the
#: numerics libraries are for the callers that ask
_LAZY = ("models", "serving", "vision", "fluid", "onnx", "quantization",
         "dataset", "hub", "linalg", "fft", "signal", "distribution",
         "sparse")


def __getattr__(name):
    if name in _LAZY:
        import importlib
        return importlib.import_module(f".{name}", __name__)
    if name in _DEFERRED:
        raise _not_ported(name, _DEFERRED[name])
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


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


# the JAX package's ``paddle.*`` functions under their own signatures (the
# ops that have one there), over the generic functions above
from . import tensor  # noqa: E402
from .tensor import *  # noqa: E402,F401,F403
__all__ += [n for n in tensor.__all__ if n not in __all__]
del _name
