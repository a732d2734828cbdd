"""paddle_tpu_torch — the PyTorch/CUDA port of paddle_tpu.

A package beside ``paddle_tpu`` (the JAX reference, which it never
imports). This slice serves GPT-2 through the fused paged engine; its
two kernels are hand-written CUDA for Hopper (``csrc/``), built with
``nvcc`` at first use:

* :mod:`.ops.ragged_paged_attention` — ragged paged attention;
* :mod:`.ops.layer_norm` — fused LayerNorm forward.

Entry points run on the card unless the caller passes ``device="cpu"``;
on CPU tensors each kernel wrapper runs its plain PyTorch version.

::

    from paddle_tpu_torch.models import GPTConfig, GPTForPretraining
    from paddle_tpu_torch.serving import GenerationEngine

    model = GPTForPretraining(GPTConfig.gpt2_small()).cuda()
    engine = GenerationEngine(model, kv_layout="paged", attention="fused")
    print(engine.submit(prompt_ids, max_new_tokens=32).result())
"""
