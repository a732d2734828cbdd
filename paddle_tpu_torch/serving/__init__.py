"""``paddle_tpu_torch.serving`` — continuous-batching GPT serving: the
dense slot engine (the default), the paged gather engine, and the fused
ragged paged engine::

    from paddle_tpu_torch.serving import GenerationEngine

    engine = GenerationEngine(model, kv_layout="paged", attention="fused",
                              num_slots=8, block_size=16,
                              prefill_budget=256,       # device="cuda"
                              spec_draft="auto", spec_k=4)  # optional
    handle = engine.submit(prompt_ids, max_new_tokens=64)
    for token in handle.stream():   # tokens as they are produced
        ...
    engine.stats()                  # spec_accept_rate, ttft_ms, ...
    engine.dump_flight_recorder("serving.json")
    engine.close()                  # drains in-flight work

Modules: :mod:`.kv_pool` (slot bookkeeping, the dense pool),
:mod:`.paging` (the paged block pool: allocator, page tables,
refcounts/copy-on-write, prefix trie + LRU), :mod:`.scheduler`
(admission queue, bucketed prefills or the chunk plan, preemption, the
loop, speculative cycles), :mod:`.tracing` (per-request TTFT/TPOT
traces), :mod:`.flight_recorder` (the always-on cycle and event rings,
latency percentiles, postmortem dumps), :mod:`.engine` (the user
surface, speculative decoding, telemetry).
"""
from .engine import GenerationEngine
from .flight_recorder import FlightRecorder
from .kv_pool import KVCachePool
from .paging import (BlockError, PagedKVPool, PoolCapacityError,
                     PoolExhaustedError)
from .scheduler import (DeadlineExceeded, GenerationRequest, QueueFullError,
                        RequestCancelled, Scheduler)
from .tracing import RequestTrace

__all__ = ["GenerationEngine", "KVCachePool", "PagedKVPool",
           "GenerationRequest", "Scheduler", "QueueFullError",
           "DeadlineExceeded", "RequestCancelled", "PoolCapacityError",
           "PoolExhaustedError", "BlockError", "RequestTrace",
           "FlightRecorder"]
