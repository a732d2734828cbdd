"""``cost_model`` of the PyTorch port against the JAX package's, on the
CPU, and the repaired ``FLAGS_benchmark`` timing under it.

``FLAGS_benchmark`` puts each op's time into the ``op_time_ms/<op>``
distribution of ``framework.monitor`` (count, sum, percentiles), as the
JAX dispatch does (``stat_observe``); the port added it to a counter, so
``monitor.stat_histogram`` gave None and ``CostModel`` would have found
no op. ``CostModel.profile_measure`` over the same function of ops gives
the same ops and call counts in both packages; the times are each
machine's own and are only held to be positive.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import cost_model as jcost
from paddle_tpu.framework import monitor as jmonitor
import paddle_tpu_torch as pt
from paddle_tpu_torch import cost_model as tcost
from paddle_tpu_torch.framework import monitor as tmonitor


@pytest.fixture(autouse=True)
def cpu_default():
    old = pt.get_device()
    pt.set_device("cpu")
    yield
    pt.set_device(old)


def _work(mod, x, w):
    h = mod.nn.functional.relu(mod.matmul(x, w))
    return mod.sum(mod.add(h, h))


def test_benchmark_flag_keeps_a_distribution_per_op():
    x = np.ones((2, 3), np.float32)
    for mod, monitor, arr in ((paddle, jmonitor, paddle.to_tensor),
                              (pt, tmonitor, torch.tensor)):
        monitor.stat_reset()
        mod.set_flags({"FLAGS_benchmark": True})
        try:
            mod.add(arr(x), arr(x))
            mod.add(arr(x), arr(x))
        finally:
            mod.set_flags({"FLAGS_benchmark": False})
        h = monitor.stat_histogram("op_time_ms/add")
        assert h is not None and h["count"] == 2 and h["sum"] > 0, mod
        assert monitor.stat_get("op_time_ms/add") == h["sum"]


def test_profile_measure_sees_the_jax_ops_and_calls():
    rs = np.random.RandomState(0)
    x, w = rs.randn(4, 8).astype(np.float32), rs.randn(8, 5).astype(
        np.float32)
    jcm, tcm = jcost.CostModel(), tcost.CostModel()
    jt = jcm.profile_measure(_work, paddle, paddle.to_tensor(x),
                             paddle.to_tensor(w), repeat=2)
    tt = tcm.profile_measure(_work, pt, torch.tensor(x), torch.tensor(w),
                             repeat=2)
    assert {k: v["calls"] for k, v in tt.items()} == \
        {k: v["calls"] for k, v in jt.items()}
    assert set(tt) == {"matmul", "relu", "add", "sum"}
    for op, row in tt.items():
        assert row["time"] > 0 and row["calls"] == 2
        assert set(row) == {"time", "calls", "p95_ms", "p99_ms"}
    assert tcm.static_cost_data() is tt
    assert tcm.get_static_op_time("matmul") is tt["matmul"]
    with pytest.raises(ValueError, match="'matmul_grad' has no measured"):
        tcm.get_static_op_time("matmul", forward=False)
    assert not pt.get_flags("FLAGS_benchmark")["FLAGS_benchmark"]


def test_estimate_flops_waits_on_step_7():
    with pytest.raises(NotImplementedError, match="Queue 1 item 5, step 7"):
        tcost.estimate_flops(lambda a: a, torch.ones(2))
