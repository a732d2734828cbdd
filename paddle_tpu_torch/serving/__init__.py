"""``paddle_tpu_torch.serving`` — continuous-batching GPT serving: the
dense slot engine (the default), the paged gather engine, and the fused
ragged paged engine::

    from paddle_tpu_torch.serving import GenerationEngine

    engine = GenerationEngine(model, kv_layout="paged", attention="fused",
                              num_slots=8, block_size=16,
                              prefill_budget=256)       # device="cuda"
    handle = engine.submit(prompt_ids, max_new_tokens=64)
    for token in handle.stream():   # tokens as they are produced
        ...
    engine.close()                  # drains in-flight work

Modules: :mod:`.kv_pool` (slot bookkeeping, the dense pool),
:mod:`.paging` (the paged block pool: allocator, page tables,
refcounts/copy-on-write, prefix trie + LRU), :mod:`.scheduler`
(admission queue, bucketed prefills or the chunk plan, preemption, the
loop), :mod:`.tracing` (per-request TTFT/TPOT traces), :mod:`.engine`
(the user surface).
"""
from .engine import GenerationEngine
from .paging import (BlockError, PagedKVPool, PoolCapacityError,
                     PoolExhaustedError)
from .scheduler import (DeadlineExceeded, GenerationRequest, QueueFullError,
                        RequestCancelled)
from .tracing import RequestTrace

__all__ = ["GenerationEngine", "GenerationRequest", "PagedKVPool",
           "PoolCapacityError", "PoolExhaustedError", "BlockError",
           "QueueFullError", "DeadlineExceeded", "RequestCancelled",
           "RequestTrace"]
