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
"""
from . import io
from .framework.random import seed

__all__ = ["seed", "io"]
