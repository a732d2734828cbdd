"""``inference.BatchingEngine`` of the port, on the CPU.

The JAX suite's engine cases (``tests/test_inference_serving.py``) over a
stand-in predictor: a single round trip, concurrent requests gathered
into power-of-two buckets, padding rows dropped, oversize batches in
power-of-two buckets, errors reaching their caller, a malformed request
failing alone, a poisoned request failing without its co-riders, a
graceful close. Then the real path: LeNet saved by ``jit.save`` with
``InputSpec([None, 1, 28, 28])`` (``bench.py``'s ``bench_serve``
configuration), served through ``create_predictor`` and the engine by
concurrent clients, each of which gets back its own rows, equal to a
single-request run of the JAX package's predictor from the same weights
within 1e-5 (float32). A stress run with more client threads than cores
and a shortened switch interval checks that no request is lost or
answered with another's rows.
"""
import sys
import threading
import time

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.vision.models import LeNet as JLeNet
import paddle_tpu_torch as pt
from paddle_tpu_torch import inference, jit
from paddle_tpu_torch.convert import layer_from_jax
from paddle_tpu_torch.inference import BatchingEngine
from paddle_tpu_torch.static import InputSpec
from paddle_tpu_torch.vision.models import LeNet

TOL = 1e-5
JOIN_S = 60


class _EchoPredictor:
    """Predictor stand-in recording the batch sizes it was run with."""

    def __init__(self):
        self.batches = []
        self.lock = threading.Lock()

    def run(self, feeds):
        with self.lock:
            self.batches.append(feeds[0].shape[0])
        return [feeds[0] * 2.0]


def _join(threads):
    for t in threads:
        t.join(JOIN_S)
    assert not any(t.is_alive() for t in threads)


def test_single_request_roundtrip():
    eng = BatchingEngine(_EchoPredictor(), max_delay_ms=0)
    x = np.arange(6, dtype="float32").reshape(2, 3)
    (out,) = eng.infer(x)
    np.testing.assert_allclose(out, x * 2)
    eng.close()


def test_concurrent_requests_are_batched():
    pred = _EchoPredictor()
    eng = BatchingEngine(pred, max_batch_size=16, max_delay_ms=50)
    results = {}
    barrier = threading.Barrier(8)

    def client(i):
        x = np.full((1, 4), float(i), "float32")
        barrier.wait()
        (out,) = eng.infer(x)
        results[i] = out

    threads = [threading.Thread(target=client, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    _join(threads)
    eng.close()
    for i in range(8):
        np.testing.assert_allclose(results[i], 2.0 * i)
    assert max(pred.batches) > 1, pred.batches
    assert all(b & (b - 1) == 0 for b in pred.batches), pred.batches


def test_padding_rows_are_dropped():
    pred = _EchoPredictor()
    eng = BatchingEngine(pred, max_batch_size=8, max_delay_ms=0)
    (out,) = eng.infer(np.ones((3, 2), "float32"))    # pads to bucket 4
    assert out.shape == (3, 2)
    assert pred.batches == [4]
    eng.close()


def test_oversize_batches_use_pow2_buckets():
    pred = _EchoPredictor()
    eng = BatchingEngine(pred, max_batch_size=8, max_delay_ms=0)
    for n in (33, 47):
        eng.infer(np.ones((n, 2), "float32"))
    eng.close()
    assert pred.batches == [64, 64]


def test_error_propagates_and_a_closed_engine_rejects():
    class _Boom:
        def run(self, feeds):
            raise RuntimeError("kaboom")

    eng = BatchingEngine(_Boom(), max_delay_ms=0)
    with pytest.raises(RuntimeError, match="kaboom"):
        eng.infer(np.ones((1, 2), "float32"))
    eng.close()
    with pytest.raises(RuntimeError, match="closed"):
        eng.infer(np.ones((1, 1), "float32"))


def test_malformed_request_fails_cleanly_engine_survives():
    eng = BatchingEngine(_EchoPredictor(), max_delay_ms=0)
    with pytest.raises(ValueError, match="batch dimension"):
        eng.infer(np.float32(1.0))
    (out,) = eng.infer(np.ones((2, 2), "float32"))
    np.testing.assert_allclose(out, 2.0)
    eng.close()


def test_poisoned_request_does_not_fail_its_batch():
    class _NaNAllergic:
        def run(self, feeds):
            if np.isnan(feeds[0]).any():
                raise RuntimeError("poisoned input")
            return [feeds[0] * 2.0]

    eng = BatchingEngine(_NaNAllergic(), max_batch_size=16,
                         max_delay_ms=100)
    results, errors = {}, {}
    barrier = threading.Barrier(4)

    def client(i):
        x = np.full((1, 4), float(i), "float32")
        if i == 2:
            x[:] = np.nan
        barrier.wait()
        try:
            (out,) = eng.infer(x)
            results[i] = out
        except RuntimeError as e:
            errors[i] = e

    threads = [threading.Thread(target=client, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    _join(threads)
    eng.close()
    assert set(errors) == {2} and "poisoned" in str(errors[2])
    for i in (0, 1, 3):
        np.testing.assert_allclose(results[i], 2.0 * i)


def test_close_drains_in_flight_requests():
    class _Slow:
        def run(self, feeds):
            time.sleep(0.1)
            return [feeds[0] * 2.0]

    eng = BatchingEngine(_Slow(), max_batch_size=1, max_delay_ms=0)
    results = {}

    def client(i):
        (out,) = eng.infer(np.full((1, 2), float(i), "float32"))
        results[i] = out

    threads = [threading.Thread(target=client, args=(i,)) for i in range(3)]
    for t in threads:
        t.start()
    time.sleep(0.05)
    eng.close()
    _join(threads)
    assert sorted(results) == [0, 1, 2]
    for i in range(3):
        np.testing.assert_allclose(results[i], 2.0 * i)


@pytest.fixture(scope="module")
def lenet_artifacts(tmp_path_factory):
    """The same LeNet weights saved by both packages with ``bench_serve``'s
    spec."""
    d = tmp_path_factory.mktemp("lenet")
    paddle.seed(0)
    jnet = JLeNet()
    jnet.eval()
    old = pt.get_device()
    pt.set_device("cpu")
    try:
        tnet = LeNet().eval()
        layer_from_jax(tnet, jnet.state_dict())
        jit.save(tnet, str(d / "t"),
                 input_spec=[InputSpec([None, 1, 28, 28], "float32")])
    finally:
        pt.set_device(old)
    paddle.jit.save(jnet, str(d / "j"), input_spec=[
        paddle.static.InputSpec([None, 1, 28, 28], "float32")])
    cfg = inference.Config(str(d / "t.pdmodel"))
    cfg.disable_gpu()
    from paddle_tpu.inference import Config, create_predictor
    return (inference.create_predictor(cfg),
            create_predictor(Config(str(d / "j.pdmodel"))))


def test_clients_get_their_own_rows_equal_to_single_jax_runs(
        lenet_artifacts):
    pred, jpred = lenet_artifacts
    rs = np.random.RandomState(3)
    requests = [rs.randn(1, 1, 28, 28).astype("float32") for _ in range(8)]
    want = [jpred.run([x])[0] for x in requests]
    eng = BatchingEngine(pred, max_batch_size=64, max_delay_ms=30)
    results = {}
    barrier = threading.Barrier(len(requests))

    def client(i):
        barrier.wait()
        results[i] = eng.infer(requests[i])[0]

    threads = [threading.Thread(target=client, args=(i,))
               for i in range(len(requests))]
    for t in threads:
        t.start()
    _join(threads)
    eng.close()
    for i, w in enumerate(want):
        assert results[i].shape == (1, 10)
        np.testing.assert_allclose(results[i], w, rtol=0,
                                   atol=TOL * np.abs(w).max())


def test_stress_more_clients_than_cores(lenet_artifacts):
    pred, _ = lenet_artifacts
    rs = np.random.RandomState(4)
    n = 24
    requests = [rs.randn(1 + i % 3, 1, 28, 28).astype("float32")
                for i in range(n)]
    with torch.no_grad():
        want = [pred.run([x])[0] for x in requests]
    eng = BatchingEngine(pred, max_batch_size=16, max_delay_ms=2)
    results = {}
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(
            target=lambda i=i: results.__setitem__(
                i, eng.infer(requests[i])[0])) for i in range(n)]
        for t in threads:
            t.start()
        _join(threads)
    finally:
        sys.setswitchinterval(old)
        eng.close()
    assert sorted(results) == list(range(n))
    for i in range(n):
        assert results[i].shape == want[i].shape
        np.testing.assert_allclose(results[i], want[i], rtol=0,
                                   atol=TOL * np.abs(want[i]).max())
