"""The port's ``io`` against the JAX package's, on the CPU.

Mirrors ``tests/test_io_samplers.py``, ``test_io_prefetch.py`` and
``test_native_dataio.py``:

* the samplers give the JAX package's indices where both draw from an
  explicitly seeded ``np.random.RandomState`` (``DistributedBatchSampler``
  by its epoch, ``BucketedBatchSampler``, ``RandomSampler`` and
  ``random_split`` with a generator); where the JAX sampler draws from
  numpy's global state (the port from its seeded generator) the tests
  hold properties: a permutation, the batch count, the weighted
  sampler's frequencies (within 0.05 of the weights over 4000 draws);
* ``default_collate_fn`` and ``pad_sequence_collate_fn`` give the JAX
  arrays' values and dtypes, as CPU tensors;
* ``DataLoader`` is a class with ``len()``; 0 and 2 worker processes
  give the same batches in the same order; a worker's error reaches the
  caller with its message, a dead worker raises, ``timeout`` raises
  ``TimeoutError``, ``use_shared_memory=False`` runs the thread pool,
  ``get_worker_info`` answers inside a worker (process or thread);
* ``device_prefetch`` keeps the order, runs ahead by at most its buffer,
  hands the producer's error to the consumer, stops the producer when
  the consumer leaves early, and counts its monitor samples; ``fit`` and
  ``evaluate`` route through it under ``FLAGS_hapi_prefetch``.
"""
import multiprocessing
import os
import threading
import time

import numpy as np
import pytest
import torch

import paddle_tpu_torch as pt
from paddle_tpu import io as jio
from paddle_tpu_torch import io
from paddle_tpu_torch.framework import monitor


class _Range(io.Dataset):
    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return np.float32(i)


class _JRange(jio.Dataset):
    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return np.float32(i)


class _Stream(io.IterableDataset):
    def __init__(self, items):
        self.items = list(items)

    def __iter__(self):
        return iter(self.items)


class _Rows(io.Dataset):
    """``(x, y)`` rows of a seeded array, as the JAX tests' datasets."""

    def __init__(self, n=20, sleep=0.0, bad=None, die=None):
        rng = np.random.RandomState(0)
        self.x = rng.randn(n, 3).astype(np.float32)
        self.y = np.arange(n, dtype=np.int64)
        self.sleep, self.bad, self.die = sleep, bad, die

    def __len__(self):
        return len(self.x)

    def __getitem__(self, i):
        if i == self.bad:
            raise RuntimeError(f"poison item {i}")
        if i == self.die:
            os._exit(137)               # a worker killed mid-epoch
        if self.sleep:
            time.sleep(self.sleep)
        return self.x[i], self.y[i]


class _WhoAmI(io.Dataset):
    def __len__(self):
        return 8

    def __getitem__(self, i):
        info = io.get_worker_info()
        return np.int64(-1 if info is None else
                        100 * info.num_workers + info.id)


#: the worker tests' bound on a batch's wait: a worker stuck for any
#: reason fails its test instead of stalling the suite
_HANG = 60


def _gen(seed):
    return torch.Generator().manual_seed(seed)


# -- samplers -------------------------------------------------------------------

def test_every_reference_name_is_here():
    assert set(jio.__all__) <= set(io.__all__)
    for name in jio.__all__:
        assert getattr(io, name) is not None


@pytest.mark.parametrize("seed", [0, 7])
def test_seeded_random_sampler_gives_the_jax_indices(seed):
    ds = _Range(13)
    got = list(io.RandomSampler(ds, generator=_gen(seed)))
    assert got == list(jio.RandomSampler(_JRange(13), generator=_gen(seed)))
    assert sorted(got) == list(range(13))
    got = list(io.RandomSampler(ds, replacement=True, num_samples=30,
                                generator=_gen(seed)))
    assert got == list(jio.RandomSampler(_JRange(13), replacement=True,
                                         num_samples=30,
                                         generator=_gen(seed)))
    assert len(got) == 30 and all(0 <= i < 13 for i in got)


def test_unseeded_random_sampler_is_a_permutation_fixed_by_the_port_seed():
    ds = _Range(9)
    pt.seed(3)
    a = list(io.RandomSampler(ds))
    pt.seed(3)
    assert list(io.RandomSampler(ds)) == a
    assert sorted(a) == list(range(9)) and len(io.RandomSampler(ds)) == 9
    assert list(io.SequenceSampler(ds)) == list(range(9))


def test_weighted_random_sampler_frequencies():
    w = [0.0, 0.0, 1.0, 3.0]
    for mod in (io, jio):
        picks = np.asarray(list(mod.WeightedRandomSampler(
            w, num_samples=4000, replacement=True)))
        assert len(picks) == 4000 and set(picks.tolist()) <= {2, 3}
        assert abs((picks == 3).mean() - 0.75) < 0.05
    without = list(io.WeightedRandomSampler([1, 1, 1, 1], 4,
                                            replacement=False))
    assert sorted(without) == [0, 1, 2, 3]


@pytest.mark.parametrize("drop_last", [False, True])
def test_batch_sampler_matches_the_jax_one(drop_last):
    got = list(io.BatchSampler(_Range(10), batch_size=4,
                               drop_last=drop_last))
    want = list(jio.BatchSampler(_JRange(10), batch_size=4,
                                 drop_last=drop_last))
    assert got == want
    assert len(io.BatchSampler(_Range(10), batch_size=4,
                               drop_last=drop_last)) == len(want)
    via = list(io.BatchSampler(sampler=io.SequenceSampler(_Range(10)),
                               batch_size=5))
    assert via == [[0, 1, 2, 3, 4], [5, 6, 7, 8, 9]]
    shuffled = list(io.BatchSampler(_Range(10), shuffle=True, batch_size=3))
    assert sorted(sum(shuffled, [])) == list(range(10))


@pytest.mark.parametrize("shuffle,drop_last", [(True, False), (True, True),
                                               (False, False)])
def test_distributed_batch_sampler_gives_the_jax_indices(shuffle,
                                                         drop_last):
    for epoch in (0, 1):
        for rank in range(3):
            got = io.DistributedBatchSampler(
                _Range(23), 4, num_replicas=3, rank=rank, shuffle=shuffle,
                drop_last=drop_last)
            want = jio.DistributedBatchSampler(
                _JRange(23), 4, num_replicas=3, rank=rank, shuffle=shuffle,
                drop_last=drop_last)
            got.set_epoch(epoch)
            want.set_epoch(epoch)
            assert list(got) == list(want)
            assert len(got) == len(want)


def test_distributed_batch_sampler_defaults_to_one_replica():
    s = io.DistributedBatchSampler(_Range(10), 4)
    assert (s.nranks, s.local_rank) == (1, 0)
    assert list(s) == list(jio.DistributedBatchSampler(_JRange(10), 4))


@pytest.mark.parametrize("shuffle,drop_last,yb", [
    (True, False, False), (True, True, True), (False, False, False)])
def test_bucketed_batch_sampler_gives_the_jax_batches(shuffle, drop_last,
                                                      yb):
    lengths = np.random.RandomState(4).randint(1, 40, 50)
    kw = dict(batch_size=4, bucket_boundaries=[8, 16, 32],
              lengths=lengths, shuffle=shuffle, drop_last=drop_last,
              seed=3, yield_boundary=yb)
    got = io.BucketedBatchSampler(_Range(50), **kw)
    want = jio.BucketedBatchSampler(_JRange(50), **kw)
    for epoch in (0, 2):
        got.set_epoch(epoch)
        want.set_epoch(epoch)
        assert list(got) == list(want)
    assert len(got) == len(want) and got.n_dropped == want.n_dropped > 0


def test_random_split_and_subset():
    a, b = io.random_split(_Range(10), [6, 4], generator=_gen(5))
    ja, jb = jio.random_split(_JRange(10), [6, 4], generator=_gen(5))
    assert a.indices == ja.indices and b.indices == jb.indices
    c, d = io.random_split(_Range(10), [3, 7])
    assert sorted(c.indices + d.indices) == list(range(10))
    with pytest.raises(ValueError):
        io.random_split(_Range(10), [3, 3])
    sub = io.Subset(_Range(10), [2, 5, 7])
    assert len(sub) == 3 and float(sub[1]) == 5.0


def test_chain_and_compose_datasets():
    chained = io.ChainDataset([_Stream([1, 2]), _Stream([3])])
    assert [x for x in chained] == [1, 2, 3]
    with pytest.raises(RuntimeError, match="len"):
        len(chained)
    with pytest.raises(RuntimeError, match="indexable"):
        chained[0]
    comp = io.ComposeDataset([_Range(4), _Rows(4)])
    assert len(comp) == 4 and len(comp[1]) == 3
    with pytest.raises(ValueError):
        io.ComposeDataset([_Range(4), _Range(5)])


# -- collate --------------------------------------------------------------------

def _same(got, want):
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            _same(got[k], want[k])
    elif isinstance(want, (list, tuple)):
        assert type(got) is type(want) and len(got) == len(want)
        for g, w in zip(got, want):
            _same(g, w)
    else:
        assert torch.is_tensor(got) and got.device.type == "cpu"
        w = np.asarray(want)
        assert got.numpy().dtype == w.dtype
        np.testing.assert_array_equal(got.numpy(), w)


def test_default_collate_gives_the_jax_arrays_as_tensors():
    rng = np.random.RandomState(1)
    batch = [(rng.randn(2, 3).astype(np.float32), int(i), float(i) / 2,
              {"m": rng.randint(0, 9, 4), "s": np.float32(i)})
             for i in range(5)]
    _same(io.default_collate_fn(batch), jio.default_collate_fn(batch))
    ts = [torch.full((2,), float(i)) for i in range(3)]
    assert torch.equal(io.default_collate_fn(ts), torch.stack(ts))


@pytest.mark.parametrize("kw", [dict(boundary=6),
                                dict(boundaries=[4, 8], pad_value=-1)])
def test_pad_sequence_collate_gives_the_jax_arrays(kw):
    rng = np.random.RandomState(2)
    batch = [(rng.randint(1, 9, n), np.float32(n)) for n in (3, 1, 4)]
    _same(io.pad_sequence_collate_fn(**kw)(batch),
          jio.pad_sequence_collate_fn(**kw)(batch))
    long = [(np.arange(9), np.float32(0))]
    with pytest.raises(ValueError):
        io.pad_sequence_collate_fn(**kw)(long)
    with pytest.raises(ValueError):
        io.pad_sequence_collate_fn()


# -- DataLoader -----------------------------------------------------------------

def _batches(loader):
    return [tuple(t.numpy() for t in b) for b in loader]


def test_data_loader_is_a_class_with_the_jax_batches():
    ds = _Rows(10)
    loader = io.DataLoader(ds, batch_size=4)
    assert isinstance(loader, io.DataLoader) and len(loader) == 3
    want = [tuple(np.asarray(a) for a in b) for b in jio.DataLoader(
        jio.TensorDataset([ds.x, ds.y]), batch_size=4)]
    got = _batches(loader)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a, b)
    sampler = io.BatchSampler(ds, batch_size=3)
    assert io.DataLoader(ds, batch_sampler=sampler).batch_sampler is sampler


def test_iterable_dataset_batches_in_process():
    loader = io.DataLoader(_Stream(range(7)), batch_size=3)
    assert [b.tolist() for b in loader] == [[0, 1, 2], [3, 4, 5], [6]]
    loader = io.DataLoader(_Stream(range(7)), batch_size=3, drop_last=True)
    assert [b.tolist() for b in loader] == [[0, 1, 2], [3, 4, 5]]
    with pytest.raises(TypeError):
        len(loader)


@pytest.mark.parametrize("kw", [dict(num_workers=2),
                                dict(num_workers=2, use_shared_memory=False),
                                dict(num_workers=2, persistent_workers=True)])
def test_workers_give_the_in_process_batches_in_order(kw):
    ds = _Rows(37)
    single = _batches(io.DataLoader(ds, batch_size=5))
    loader = io.DataLoader(ds, batch_size=5, timeout=_HANG, **kw)
    for _ in range(2):                  # two epochs
        multi = _batches(loader)
        assert len(multi) == len(single) == 8
        for a, b in zip(single, multi):
            for u, v in zip(a, b):
                np.testing.assert_array_equal(u, v)


@pytest.mark.parametrize("shared", [True, False])
def test_a_worker_error_reaches_the_caller(shared):
    loader = io.DataLoader(_Rows(16, bad=9), batch_size=4, num_workers=2,
                           use_shared_memory=shared, timeout=_HANG)
    with pytest.raises(RuntimeError, match="poison item 9"):
        _batches(loader)


def test_a_dead_worker_raises_instead_of_hanging():
    loader = io.DataLoader(_Rows(8, die=5), batch_size=2, num_workers=1,
                           timeout=_HANG)
    with pytest.raises(RuntimeError, match="exited unexpectedly|died"):
        _batches(loader)


@pytest.mark.parametrize("shared", [True, False])
def test_timeout_bounds_the_wait_for_a_batch(shared):
    loader = io.DataLoader(_Rows(4, sleep=3.0), batch_size=2, num_workers=1,
                           timeout=0.5, use_shared_memory=shared)
    t0 = time.perf_counter()
    with pytest.raises(TimeoutError):
        _batches(loader)
    assert time.perf_counter() - t0 < 3.0


@pytest.mark.parametrize("shared", [True, False])
def test_get_worker_info_inside_a_worker(shared):
    assert io.get_worker_info() is None
    inits = []
    loader = io.DataLoader(_WhoAmI(), batch_size=1, num_workers=2,
                           use_shared_memory=shared, timeout=_HANG,
                           worker_init_fn=inits.append)
    seen = {int(b) for b in loader}
    assert seen <= {200, 201} and seen
    if not shared:                      # threads: the parent sees the calls
        assert sorted(inits) == [0, 1]
    assert io.get_worker_info() is None


# -- device_prefetch ------------------------------------------------------------

def test_device_prefetch_keeps_the_order_and_the_values():
    ds = _Rows(32)
    loader = io.DataLoader(ds, batch_size=8)
    n0 = monitor.stat_get("prefetch_batches")
    w0 = len(monitor.histogram_samples("prefetch_wait_ms"))
    seen = list(io.device_prefetch(loader, device="cpu"))
    assert len(seen) == 4
    for i, (x, y) in enumerate(seen):
        np.testing.assert_array_equal(x.numpy(), ds.x[8 * i:8 * i + 8])
        np.testing.assert_array_equal(y.numpy(), ds.y[8 * i:8 * i + 8])
    assert monitor.stat_get("prefetch_batches") - n0 == 4
    assert len(monitor.histogram_samples("prefetch_wait_ms")) - w0 == 4
    assert monitor.stat_histogram("prefetch_put_ms")["count"] >= 4
    arrays = list(io.device_prefetch([np.ones(3)], device="cpu"))
    assert torch.is_tensor(arrays[0]) and arrays[0].tolist() == [1.0] * 3


def test_a_batch_already_on_the_device_passes_through():
    x = torch.ones(3)
    (got,) = list(io.device_prefetch([(x, "tag")], device="cpu"))
    assert got[0] is x and got[1] == "tag"


def test_device_prefetch_runs_ahead_by_its_buffer_at_most():
    produced = []

    def source():
        for i in range(10):
            produced.append(i)
            yield [torch.full((2,), float(i))]

    it = io.device_prefetch(source(), buffer_size=2, device="cpu")
    first = next(it)
    time.sleep(0.3)
    # one in the consumer's hand, two in the buffer, one the producer holds
    assert first[0].tolist() == [0.0, 0.0] and len(produced) == 4
    rest = [b[0][0].item() for b in it]
    assert rest == [float(i) for i in range(1, 10)]


def test_the_producer_runs_ahead_of_a_slow_consumer():
    made, taken = [], []

    def source():
        for i in range(4):
            made.append(time.perf_counter())
            yield [torch.full((2, 2), float(i))]

    for _ in io.device_prefetch(source(), buffer_size=2, device="cpu"):
        taken.append(time.perf_counter())
        time.sleep(0.05)
    assert made[2] < taken[1]


def test_a_producer_error_reaches_the_consumer():
    def bad():
        yield [torch.zeros(2)]
        raise RuntimeError("boom")

    it = io.device_prefetch(bad(), device="cpu")
    next(it)
    with pytest.raises(RuntimeError, match="boom"):
        next(it)


def test_an_early_break_stops_the_producer():
    produced = []

    def source():
        for i in range(1000):
            produced.append(i)
            yield [torch.zeros(1)]

    before = threading.active_count()
    for i, _ in enumerate(io.device_prefetch(source(), buffer_size=2,
                                             device="cpu")):
        if i == 1:
            break
    time.sleep(0.3)
    n = len(produced)
    time.sleep(0.3)
    assert len(produced) == n < 10
    assert threading.active_count() == before


def test_leaving_the_loop_waits_for_the_producer_and_closes_the_source():
    closed = []

    def source():                       # the producer is mid-fetch at close
        try:
            for _ in range(1000):
                time.sleep(0.05)
                yield [torch.zeros(1)]
        finally:
            closed.append(True)

    it = io.device_prefetch(source(), buffer_size=2, device="cpu")
    next(it)
    it.close()
    assert closed == [True]
    assert not [t for t in threading.enumerate()
                if "device_prefetch" in t.name]


def test_an_early_break_over_workers_leaves_no_worker():
    loader = io.DataLoader(_Rows(40), batch_size=2, num_workers=2,
                           timeout=_HANG)
    it = io.device_prefetch(loader, buffer_size=2, device="cpu")
    next(it)
    it.close()
    assert multiprocessing.active_children() == []


def test_device_prefetch_arguments():
    with pytest.raises(NotImplementedError, match="Queue 1 item 4"):
        io.device_prefetch([], sharding=object())
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            io.device_prefetch([])


def test_device_data_loader_delegates_to_its_loader():
    inner = io.DataLoader(_Rows(32), batch_size=8)
    dl = io.DeviceDataLoader(inner, device="cpu")
    assert len(dl) == 4 and dl.batch_sampler.batch_size == 8
    assert len(list(dl)) == 4


# -- Model.fit / evaluate prefetch -----------------------------------------------

def _classifier():
    from paddle_tpu_torch.hapi import Model
    from paddle_tpu_torch.optimizer import SGD
    pt.seed(0)
    net = pt.nn.Linear(3, 4)
    model = Model(net, device="cpu")
    model.prepare(SGD(0.1, parameters=net.parameters()),
                  loss=pt.nn.CrossEntropyLoss())
    ds = _Rows(16)
    ds.y = ds.y % 4
    return model, ds


@pytest.mark.parametrize("prefetch,flag,routed", [
    (None, True, True), (None, False, False), (True, False, True),
    (False, True, False)])
def test_fit_and_evaluate_route_through_device_prefetch(prefetch, flag,
                                                        routed):
    old = pt.get_flags("FLAGS_hapi_prefetch")
    pt.set_flags({"FLAGS_hapi_prefetch": flag})
    try:
        model, ds = _classifier()
        n0 = monitor.stat_get("prefetch_batches")
        model.fit(ds, batch_size=4, epochs=2, verbose=0, prefetch=prefetch,
                  eval_data=ds)
        loss = model.evaluate(ds, batch_size=8, verbose=0,
                              prefetch=prefetch)["loss"]
    finally:
        pt.set_flags(old)
    assert monitor.stat_get("prefetch_batches") - n0 == \
        (2 * (4 + 4) + 2 if routed else 0)
    assert np.isfinite(loss)


def test_prefetch_changes_no_number_of_a_fit():
    losses = []
    for prefetch in (False, True):
        model, ds = _classifier()
        model.fit(ds, batch_size=4, epochs=2, verbose=0, shuffle=False,
                  prefetch=prefetch)
        losses.append([p.detach().clone() for p in model.parameters()])
    for a, b in zip(*losses):
        assert torch.equal(a, b)


def test_to_device_leaves_a_batch_on_the_device_as_it_is():
    model, _ = _classifier()
    x = torch.ones(2, 3)
    assert model._to_device([x])[0] is x


def test_threads_and_prefetch_under_stress_keep_every_batch_in_order():
    """More loader threads than cores, a shortened switch interval, the
    prefetch producer on top: every batch arrives once, in order."""
    import sys
    ds = _Rows(400)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        loader = io.DataLoader(ds, batch_size=3, num_workers=16,
                               use_shared_memory=False, prefetch_factor=1,
                               timeout=_HANG)
        got = [y.tolist() for _, y in io.device_prefetch(
            loader, buffer_size=1, device="cpu")]
    finally:
        sys.setswitchinterval(old)
    assert sum(got, []) == list(range(400))
