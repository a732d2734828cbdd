"""Weighted-fair admission of the port's scheduler against the JAX
scheduler's, on the CPU.

The same queued requests, tagged with (lane, tenant) classes and given
the same prompt lengths, go through both schedulers over a one-slot
pool whose first prefill holds on a gate until the whole queue is staged;
the order in which requests are then admitted must be the same, request
for request. Cases: one class (FCFS), an interactive pair behind a batch
backlog (the default 4 : 1 weights), three tenants over two lanes with
mixed lengths, custom ``lane_weights`` with a lane of its own, and a
queue with long heads whose feeds exceed a rotation's credit. The
lane-weight validation raises the same error in both. Exact; no
tolerance.
"""
import threading

import numpy as np
import pytest

from paddle_tpu.serving.kv_pool import KVCachePool as JaxPool
from paddle_tpu.serving.scheduler import GenerationRequest as JaxRequest
from paddle_tpu.serving.scheduler import Scheduler as JaxScheduler
from paddle_tpu_torch.serving.kv_pool import KVCachePool
from paddle_tpu_torch.serving.scheduler import (GenerationRequest,
                                                Scheduler)

PACKAGES = {
    "jax": (JaxScheduler, JaxRequest,
            lambda: JaxPool(num_layers=1, num_slots=1, num_heads=1,
                            max_len=256, head_dim=1, min_bucket=8)),
    "torch": (Scheduler, GenerationRequest,
              lambda: KVCachePool(1, 1, 1, 256, 1, min_bucket=8,
                                  device="cpu")),
}


class _GatedDevice:
    """The first prefill holds on ``gate`` so the queue can be staged
    before any admission decision; the order of prefills is recorded."""

    def __init__(self, num_slots):
        self.num_slots = num_slots
        self.gate = threading.Event()
        self.entered = threading.Event()
        self._first = True
        self.prefills = []

    def do_prefill(self, req, slot, bucket):
        if self._first:
            self._first = False
            self.entered.set()
            assert self.gate.wait(timeout=30)
        self.prefills.append(req.id)
        return 1

    def do_decode(self, slot_requests):
        return np.full(self.num_slots + 1, 2, np.int32)


def _admission_order(package, queued, lane_weights=None):
    """Indices of ``queued`` ((prompt length, lane, tenant) triples) in
    the order ``package``'s scheduler admits them behind a gated head."""
    sched_cls, req_cls, make_pool = PACKAGES[package]
    pool = make_pool()
    dev = _GatedDevice(pool.num_slots)
    kw = {} if lane_weights is None else {"lane_weights": lane_weights}
    sched = sched_cls(pool, dev.do_prefill, dev.do_decode, **kw)
    try:
        head = sched.submit(req_cls(np.ones(4, np.int32), 1))
        assert dev.entered.wait(timeout=30)     # the head left the queue
        reqs = [sched.submit(req_cls(np.ones(n, np.int32), 1, lane=lane,
                                     tenant=tenant))
                for n, lane, tenant in queued]
        dev.gate.set()
        for r in [head] + reqs:
            r.result(timeout=30)
    finally:
        dev.gate.set()
        sched.close()
    index = {r.id: i for i, r in enumerate(reqs)}
    return [index[rid] for rid in dev.prefills[1:]]


def _mixed(seed, n=14):
    rng = np.random.RandomState(seed)
    lanes = ("interactive", "batch")
    tenants = ("acme", "zoo", "bulk")
    return [(int(rng.randint(2, 40)), lanes[int(rng.randint(2))],
             tenants[int(rng.randint(3))]) for _ in range(n)]


CASES = {
    "one class": ([(4, "interactive", "default")] * 6, None),
    "interactive behind batch": (
        [(24, "batch", "bulk")] * 6 + [(24, "interactive", "alice")] * 2,
        None),
    "three tenants, two lanes": (_mixed(3), None),
    "custom weights, own lane": (
        _mixed(5) + [(12, "bulk", "acme"), (30, "bulk", "zoo")],
        {"batch": 2.5, "bulk": 0.5}),
    "heads past one credit": (
        [(60, "batch", "a"), (60, "interactive", "b"), (9, "batch", "a"),
         (60, "interactive", "c"), (3, "batch", "d")], None),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_admission_order_matches_jax_scheduler(case):
    queued, weights = CASES[case]
    want = _admission_order("jax", queued, weights)
    got = _admission_order("torch", queued, weights)
    assert got == want
    assert sorted(got) == list(range(len(queued)))     # nothing starves
    if case == "interactive behind batch":
        # both interactive requests land in the first three admissions
        assert max(got.index(6), got.index(7)) <= 2, got


@pytest.mark.parametrize("weights", [{"batch": 0}, {"interactive": -1.5}])
def test_lane_weight_validation_matches_jax(weights):
    errors = []
    for package in ("jax", "torch"):
        sched_cls, _, make_pool = PACKAGES[package]
        with pytest.raises(ValueError) as e:
            sched_cls(make_pool(), lambda *a: 1, lambda *a: None,
                      lane_weights=weights)
        errors.append(str(e.value))
    assert errors[0] == errors[1]


def test_untagged_requests_share_the_default_class():
    for _, req_cls, _ in PACKAGES.values():
        r = req_cls(np.ones(3, np.int32), 1)
        assert (r.lane, r.tenant) == ("interactive", "default")
        assert (r.trace.lane, r.trace.tenant) == ("interactive", "default")
