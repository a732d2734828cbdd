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

The serving periphery: ``GenerationEngine(..., host_tier_bytes=...)``
spills evicted prefix blocks to a host-DRAM :class:`HostBlockPool` and
promotes them back asynchronously; ``submit(tenant=, lane=)`` rides the
scheduler's weighted-fair admission; :class:`EngineFleet` puts replicas
behind one submit; :class:`SLOTracker` scores retired requests against
objectives; :class:`OpsServer` serves ``/metrics``, ``/statusz``,
``/healthz``, ``/readyz``, ``/tracez`` on 127.0.0.1, and
:class:`FrontDoor` mounts ``/v1/completions`` there::

    fleet = EngineFleet([GenerationEngine(model, kv_layout="paged",
                                          attention="fused")
                         for _ in range(2)])
    slo = SLOTracker()
    slo.add_objective("ttft", "ttft_ms", 400.0, 0.99)
    fleet.attach_slo(slo)
    ops = OpsServer(target=fleet, slo=slo)
    FrontDoor(fleet, tenant_limits={"free": (200, 800)}).mount(ops)
    print(ops.start().url)

Modules: :mod:`.kv_pool` (slot bookkeeping, the dense pool),
:mod:`.paging` (the paged block pool: allocator, page tables,
refcounts/copy-on-write, prefix trie + LRU), :mod:`.scheduler`
(admission queue, bucketed prefills or the chunk plan, preemption, the
loop, speculative cycles, weighted-fair admission, promotions),
:mod:`.tracing` (per-request TTFT/TPOT traces), :mod:`.flight_recorder`
(the always-on cycle and event rings, latency percentiles, postmortem
dumps), :mod:`.engine` (the user surface, speculative decoding,
telemetry), :mod:`.host_tier` (the host-DRAM KV tier), :mod:`.slo`,
:mod:`.opsserver`, :mod:`.frontdoor`, :mod:`.fleet`.
"""
from .engine import GenerationEngine
from .fleet import EngineFleet
from .flight_recorder import FlightRecorder
from .frontdoor import FrontDoor, TokenBucket
from .host_tier import (HostBlockPool, HostTierError, HostTierFullError,
                        PromotionTicket)
from .kv_pool import KVCachePool
from .opsserver import OpsServer
from .paging import (BlockError, PagedKVPool, PoolCapacityError,
                     PoolExhaustedError)
from .scheduler import (DeadlineExceeded, GenerationRequest, QueueFullError,
                        RequestCancelled, Scheduler)
from .slo import SLOObjective, SLOTracker, attainment_from_buckets
from .tracing import RequestTrace

__all__ = ["GenerationEngine", "EngineFleet", "KVCachePool", "PagedKVPool",
           "GenerationRequest", "Scheduler", "QueueFullError",
           "DeadlineExceeded", "RequestCancelled", "PoolCapacityError",
           "PoolExhaustedError", "BlockError", "RequestTrace",
           "FlightRecorder", "OpsServer", "FrontDoor", "TokenBucket",
           "HostBlockPool", "HostTierError", "HostTierFullError",
           "PromotionTicket", "SLOTracker", "SLOObjective",
           "attainment_from_buckets"]


def __getattr__(name):
    # the JAX engine raises PlanError from its static HBM plan
    # (hbm_budget_bytes=), which comes with analysis/ (ROADMAP Queue 1
    # item 5, step 7)
    if name == "PlanError":
        from ..ops.registry import not_ported
        raise not_ported("serving.PlanError", 5)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
