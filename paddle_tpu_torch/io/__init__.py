"""Datasets, samplers and batching (counterpart of ``paddle_tpu/io``).

The samplers make index lists on the host exactly as the JAX package's
do: where one draws from an explicitly seeded ``np.random.RandomState``
(``DistributedBatchSampler`` by its epoch, ``BucketedBatchSampler`` by
its seed and epoch, ``RandomSampler`` and ``random_split`` with a
``generator``), the port draws the same numbers. Where the JAX sampler
draws its seed from numpy's global state, the port draws it from its
own seeded CPU generator, so ``paddle_tpu_torch.seed`` fixes the order.

``default_collate_fn`` stacks samples into CPU ``torch.Tensor``s (the
JAX one into numpy arrays). ``DataLoader`` batches in three ways: an
``IterableDataset`` in-process; ``num_workers=0`` in-process; with
workers, torch's multiprocessing loader over this loader's batch sampler
and collate function (the workers send their batches through shared
memory), or with ``use_shared_memory=False`` the JAX package's ordered
thread pool. Workers touch no CUDA tensor.

``device_prefetch`` moves batches to the card ahead of their use: a
producer thread pins each CPU batch and copies it on a dedicated CUDA
stream, and the consumer's stream waits on that copy's event.
``Model.fit`` and ``evaluate`` run their batches through it unless
``prefetch=False`` or ``FLAGS_hapi_prefetch`` is off.
"""
from __future__ import annotations

import functools
import math
import queue as _queue
import threading
import time as _time
from typing import Sequence

import numpy as np
import torch
from torch.utils import data as _data

from .._device import resolve_device
from ..framework.monitor import stat_add, stat_observe
from ..framework.random import get_generator
from ..profiler import span as _prof

__all__ = ["Dataset", "IterableDataset", "TensorDataset", "ComposeDataset",
           "ChainDataset", "Subset", "random_split", "Sampler",
           "SequenceSampler", "RandomSampler", "WeightedRandomSampler",
           "BatchSampler", "DistributedBatchSampler", "DataLoader",
           "get_worker_info", "default_collate_fn", "device_prefetch",
           "DeviceDataLoader", "BucketedBatchSampler",
           "pad_sequence_collate_fn"]


class Dataset(_data.Dataset):
    def __getitem__(self, idx):
        raise NotImplementedError

    def __len__(self):
        raise NotImplementedError


class IterableDataset(Dataset):
    def __iter__(self):
        raise NotImplementedError

    def __getitem__(self, idx):
        raise RuntimeError("IterableDataset is not indexable")

    def __len__(self):
        raise RuntimeError("IterableDataset has no len()")


class TensorDataset(Dataset):
    """Samples ``tuple(t[i] for t in tensors)`` over arrays or tensors
    that share axis 0."""

    def __init__(self, tensors: Sequence):
        self.tensors = [t if torch.is_tensor(t) else
                        torch.from_numpy(np.ascontiguousarray(t))
                        for t in tensors]
        n = self.tensors[0].shape[0]
        if any(t.shape[0] != n for t in self.tensors):
            raise ValueError("all tensors must share dim 0")

    def __getitem__(self, idx):
        return tuple(t[idx] for t in self.tensors)

    def __len__(self):
        return self.tensors[0].shape[0]


class ComposeDataset(Dataset):
    """The fields of several equally long datasets, side by side."""

    def __init__(self, datasets):
        self.datasets = list(datasets)
        if not self.datasets:
            raise ValueError("datasets must not be empty")
        n = len(self.datasets[0])
        if any(len(d) != n for d in self.datasets):
            raise ValueError("datasets must share length")

    def __len__(self):
        return len(self.datasets[0])

    def __getitem__(self, idx):
        out = []
        for d in self.datasets:
            item = d[idx]
            out.extend(item if isinstance(item, tuple) else (item,))
        return tuple(out)


class ChainDataset(IterableDataset):
    """Iterable datasets one after another."""

    def __init__(self, datasets):
        self.datasets = list(datasets)

    def __iter__(self):
        for d in self.datasets:
            yield from d


class Subset(Dataset):
    def __init__(self, dataset, indices):
        self.dataset = dataset
        self.indices = list(indices)

    def __getitem__(self, idx):
        return self.dataset[self.indices[idx]]

    def __len__(self):
        return len(self.indices)


def _host_seed(generator=None) -> int:
    """A sampler's seed: ``generator``'s initial seed, as in the JAX
    package, else a draw from the port's seeded CPU generator (the JAX
    package draws from numpy's global state)."""
    if generator is not None:
        return int(generator.initial_seed())
    return int(torch.randint(0, 2 ** 31 - 1, (1,),
                             generator=get_generator("cpu")))


def random_split(dataset, lengths, generator=None):
    if sum(lengths) != len(dataset):
        raise ValueError("sum of lengths must equal dataset length")
    perm = np.random.RandomState(_host_seed(generator)).permutation(
        len(dataset))
    out, off = [], 0
    for n in lengths:
        out.append(Subset(dataset, perm[off:off + n].tolist()))
        off += n
    return out


class Sampler:
    def __init__(self, data_source=None):
        self.data_source = data_source

    def __iter__(self):
        raise NotImplementedError

    def __len__(self):
        return len(self.data_source)


class SequenceSampler(Sampler):
    def __iter__(self):
        return iter(range(len(self.data_source)))


class RandomSampler(Sampler):
    def __init__(self, data_source, replacement=False, num_samples=None,
                 generator=None):
        super().__init__(data_source)
        self.replacement = replacement
        self._num_samples = num_samples
        self.generator = generator

    @property
    def num_samples(self):
        return self._num_samples or len(self.data_source)

    def __iter__(self):
        n = len(self.data_source)
        g = np.random.RandomState(_host_seed(self.generator))
        if self.replacement:
            return iter(g.randint(0, n, self.num_samples).tolist())
        return iter(g.permutation(n)[:self.num_samples].tolist())

    def __len__(self):
        return self.num_samples


class WeightedRandomSampler(Sampler):
    def __init__(self, weights, num_samples, replacement=True):
        self.weights = np.asarray(weights, np.float64)
        self.num_samples = num_samples
        self.replacement = replacement

    def __iter__(self):
        p = self.weights / self.weights.sum()
        g = np.random.RandomState(_host_seed())
        idx = g.choice(len(self.weights), self.num_samples,
                       replace=self.replacement, p=p)
        return iter(idx.tolist())

    def __len__(self):
        return self.num_samples


def _batched(indices, batch_size, drop_last):
    batch = []
    for idx in indices:
        batch.append(idx)
        if len(batch) == batch_size:
            yield batch
            batch = []
    if batch and not drop_last:
        yield batch


class BatchSampler(Sampler):
    def __init__(self, dataset=None, sampler=None, shuffle=False,
                 batch_size=1, drop_last=False):
        if sampler is None:
            sampler = RandomSampler(dataset) if shuffle else \
                SequenceSampler(dataset)
        self.sampler = sampler
        self.batch_size = batch_size
        self.drop_last = drop_last

    def __iter__(self):
        return _batched(self.sampler, self.batch_size, self.drop_last)

    def __len__(self):
        n = len(self.sampler)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size


def _distributed_world():
    """(world size, rank) of an initialised ``torch.distributed`` group,
    else one replica of rank 0."""
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


class DistributedBatchSampler(BatchSampler):
    """Splits the sample space across data-parallel ranks: the order is
    ``RandomState(epoch)``'s permutation when shuffling, padded to a
    multiple of the ranks (or cut, with ``drop_last``), then every
    ``num_replicas``-th index from ``rank``. Without ``num_replicas`` or
    ``rank`` they are read from an initialised ``torch.distributed``."""

    def __init__(self, dataset, batch_size, num_replicas=None, rank=None,
                 shuffle=False, drop_last=False):
        if num_replicas is None or rank is None:
            world, own = _distributed_world()
            num_replicas = world if num_replicas is None else num_replicas
            rank = own if rank is None else rank
        self.dataset = dataset
        self.batch_size = batch_size
        self.nranks = num_replicas
        self.local_rank = rank
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.epoch = 0
        self.num_samples = int(
            math.ceil(len(dataset) / self.nranks)) if not drop_last else \
            len(dataset) // self.nranks
        self.total_size = self.num_samples * self.nranks

    def set_epoch(self, epoch):
        self.epoch = epoch

    def __iter__(self):
        n = len(self.dataset)
        if self.shuffle:
            indices = np.random.RandomState(self.epoch).permutation(
                n).tolist()
        else:
            indices = list(range(n))
        if not self.drop_last:
            indices += indices[: self.total_size - len(indices)]
        else:
            indices = indices[: self.total_size]
        indices = indices[self.local_rank:self.total_size:self.nranks]
        return _batched(indices, self.batch_size, self.drop_last)

    def __len__(self):
        if self.drop_last:
            return self.num_samples // self.batch_size
        return (self.num_samples + self.batch_size - 1) // self.batch_size


class BucketedBatchSampler(BatchSampler):
    """Length-bucketed batches for variable-length samples: each sample
    goes to the smallest of ``bucket_boundaries`` that holds its length
    (longer ones are dropped and counted in ``n_dropped``), each batch
    comes from one bucket, and with ``shuffle`` the buckets' members and
    then the batches are shuffled by ``RandomState(seed + epoch)``.
    Lengths come from ``lengths`` or ``length_fn(dataset[i])`` (default
    ``len(sample[0])``). Pair it with ``pad_sequence_collate_fn(
    boundaries=...)``, which pads a batch to its bucket's boundary;
    ``yield_boundary=True`` yields ``(indices, boundary)`` pairs for
    hand-written loops instead."""

    def __init__(self, dataset, batch_size, bucket_boundaries,
                 length_fn=None, lengths=None, shuffle=True,
                 drop_last=False, seed=0, yield_boundary=False):
        self.dataset = dataset
        self.batch_size = batch_size
        self.bucket_boundaries = sorted(int(b) for b in bucket_boundaries)
        self.length_fn = length_fn or (lambda s: len(s[0]))
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.epoch = 0
        self.yield_boundary = yield_boundary
        self._buckets = {b: [] for b in self.bucket_boundaries}
        self.n_dropped = 0
        for i in range(len(dataset)):
            ln = int(lengths[i]) if lengths is not None \
                else self.length_fn(dataset[i])
            for b in self.bucket_boundaries:
                if ln <= b:
                    self._buckets[b].append(i)
                    break
            else:
                self.n_dropped += 1

    def set_epoch(self, epoch):
        self.epoch = epoch

    def __iter__(self):
        g = np.random.RandomState(self.seed + self.epoch)
        batches = []
        for b, idxs in self._buckets.items():
            idxs = list(idxs)
            if self.shuffle:
                g.shuffle(idxs)
            for k in range(0, len(idxs), self.batch_size):
                chunk = idxs[k:k + self.batch_size]
                if self.drop_last and len(chunk) < self.batch_size:
                    continue
                batches.append((chunk, b))
        if self.shuffle:
            g.shuffle(batches)
        for chunk, b in batches:
            yield (chunk, b) if self.yield_boundary else chunk

    def __len__(self):
        n = 0
        for idxs in self._buckets.values():
            if self.drop_last:
                n += len(idxs) // self.batch_size
            else:
                n += (len(idxs) + self.batch_size - 1) // self.batch_size
        return n


def pad_sequence_collate_fn(boundary=None, pad_value=0,
                            length_dtype="int64", boundaries=None):
    """A collate function padding each sample's first field (a sequence)
    to a dense ``[batch, length, ...]`` tensor beside the lengths; the
    other fields are stacked. The length is ``boundary``, or with
    ``boundaries`` the smallest one that holds the batch's longest
    sequence; a longer sequence raises instead of being cut."""
    if (boundary is None) == (boundaries is None):
        raise ValueError("pass exactly one of boundary= or boundaries=")
    if boundaries is not None and not list(boundaries):
        raise ValueError("boundaries= must be a non-empty list")
    bset = sorted(int(b) for b in boundaries) if boundaries else None

    def collate(batch):
        seqs = [np.asarray(s[0]) for s in batch]
        mx = max(len(s) for s in seqs)
        if bset is not None:
            pad_to = next((b for b in bset if mx <= b), None)
            if pad_to is None:
                raise ValueError(
                    f"batch max length {mx} exceeds the largest boundary "
                    f"{bset[-1]}; add a boundary or filter long samples "
                    f"(truncating silently would corrupt training data)")
        else:
            pad_to = boundary
            if mx > pad_to:
                raise ValueError(
                    f"batch max length {mx} exceeds boundary={pad_to}; "
                    f"raise boundary= or pre-truncate in the dataset")
        out = np.full((len(batch), pad_to) + seqs[0].shape[1:], pad_value,
                      dtype=seqs[0].dtype)
        lengths = np.zeros((len(batch),), dtype=length_dtype)
        for i, seq in enumerate(seqs):
            out[i, :len(seq)] = seq
            lengths[i] = len(seq)
        rest = [np.stack([np.asarray(s[j]) for s in batch])
                for j in range(1, len(batch[0]))]
        return tuple(torch.from_numpy(a) for a in (out, lengths, *rest))

    return collate


def default_collate_fn(batch):
    """Stack samples into batched CPU tensors (a tensor's device is
    kept): arrays and tensors stacked, Python and numpy integers to
    int64, floats to float32, tuples, lists and dicts field by field."""
    sample = batch[0]
    if torch.is_tensor(sample):
        return torch.stack(batch)
    if isinstance(sample, np.ndarray):
        return torch.from_numpy(np.stack(batch))
    if isinstance(sample, (int, np.integer)):
        return torch.as_tensor(np.asarray(batch, np.int64))
    if isinstance(sample, (float, np.floating)):
        return torch.as_tensor(np.asarray(batch, np.float32))
    if isinstance(sample, (list, tuple)):
        return type(sample)(default_collate_fn(list(x))
                            for x in zip(*batch))
    if isinstance(sample, dict):
        return {k: default_collate_fn([d[k] for d in batch]) for k in sample}
    return batch


class WorkerInfo:
    def __init__(self, id, num_workers, dataset, seed):
        self.id = id
        self.num_workers = num_workers
        self.dataset = dataset
        self.seed = seed


_worker_tls = threading.local()


def get_worker_info():
    """The ``WorkerInfo`` of the loader worker (process or thread) this
    runs in; ``None`` outside one."""
    return getattr(_worker_tls, "info", None)


def _start_worker(user_init, wid):
    """A torch worker process's init: the port's ``WorkerInfo``, then the
    user's ``worker_init_fn``."""
    info = _data.get_worker_info()
    _worker_tls.info = WorkerInfo(info.id, info.num_workers, info.dataset,
                                  info.seed)
    if user_init is not None:
        user_init(wid)


class DataLoader:
    """Batches of ``dataset`` by ``batch_sampler`` (by default a
    ``BatchSampler`` over ``batch_size``, ``shuffle`` and ``drop_last``),
    collated by ``collate_fn`` (``default_collate_fn``).

    ``num_workers > 0`` fetches and collates in worker processes
    (torch's multiprocessing loader, started as torch starts them: forked
    on Linux, so the dataset needs no pickling; ``prefetch_factor``
    batches ahead a worker, ``persistent_workers`` kept across epochs):
    batches arrive in order, a worker's exception reaches the caller with
    its message, a worker that dies raises instead of hanging, and
    ``timeout`` (seconds, 0 for none) bounds the wait for a batch
    (``TimeoutError``). With
    ``use_shared_memory=False`` worker threads fetch instead, in order,
    ``prefetch_factor`` batches ahead a thread. An ``IterableDataset`` is
    batched in-process. ``use_buffer_reader`` and the static-mode
    ``feed_list``, ``places`` and ``return_list`` are taken and change no
    batch, as in the JAX package: a static ``Model`` feeds each batch by
    the names of its ``InputSpec``s."""

    def __init__(self, dataset, feed_list=None, places=None,
                 return_list=True, batch_sampler=None, batch_size=1,
                 shuffle=False, drop_last=False, collate_fn=None,
                 num_workers=0, use_buffer_reader=True, prefetch_factor=2,
                 use_shared_memory=True, timeout=0, worker_init_fn=None,
                 persistent_workers=False):
        self.dataset = dataset
        self.return_list = return_list
        self.collate_fn = collate_fn or default_collate_fn
        self.num_workers = max(0, int(num_workers))
        self.prefetch_factor = max(1, int(prefetch_factor))
        self.use_shared_memory = bool(use_shared_memory)
        self.timeout = timeout
        self.worker_init_fn = worker_init_fn
        self.persistent_workers = bool(persistent_workers)
        self._workers = None
        self._iterable_mode = isinstance(dataset, IterableDataset)
        if self._iterable_mode:
            self.batch_sampler = None
            self.batch_size = batch_size
            self.drop_last = drop_last
        elif batch_sampler is not None:
            self.batch_sampler = batch_sampler
        else:
            self.batch_sampler = BatchSampler(
                dataset, shuffle=shuffle, batch_size=batch_size,
                drop_last=drop_last)

    def __len__(self):
        if self._iterable_mode:
            raise TypeError("length of IterableDataset DataLoader unknown")
        return len(self.batch_sampler)

    def _fetch(self, indices):
        return self.collate_fn([self.dataset[i] for i in indices])

    def _iter_iterable(self):
        for batch in _batched(self.dataset, self.batch_size,
                              self.drop_last):
            yield self.collate_fn(batch)

    def __iter__(self):
        if self._iterable_mode:
            return self._iter_iterable()
        if self.num_workers == 0:
            return (self._fetch(indices) for indices in self.batch_sampler)
        if self.use_shared_memory:
            return self._iter_workers()
        return self._iter_threaded()

    def _torch_loader(self):
        """torch's multiprocessing loader over this loader's batch sampler
        and collate function (kept across epochs with
        ``persistent_workers``)."""
        if self._workers is not None:
            return self._workers
        loader = _data.DataLoader(
            self.dataset, batch_sampler=self.batch_sampler,
            collate_fn=self.collate_fn, num_workers=self.num_workers,
            prefetch_factor=self.prefetch_factor, timeout=self.timeout,
            worker_init_fn=functools.partial(_start_worker,
                                             self.worker_init_fn),
            persistent_workers=self.persistent_workers)
        if self.persistent_workers:
            self._workers = loader
        return loader

    def _iter_workers(self):
        it = iter(self._torch_loader())
        try:
            while True:
                t0 = _time.monotonic()
                try:
                    batch = next(it)
                except StopIteration:
                    return
                except (ConnectionError, EOFError) as e:
                    # a worker that dies while its batch is in transfer
                    # breaks the connection before torch sees it dead
                    self._workers = None
                    dead = _dead_worker(it._workers)
                    if dead is None:
                        raise
                    raise RuntimeError(
                        f"DataLoader worker (pid {dead.pid}) exited "
                        f"unexpectedly with exit code {dead.exitcode}") from e
                except RuntimeError as e:
                    self._workers = None
                    # torch's own timeout (a plain RuntimeError once the
                    # wait ran out) becomes TimeoutError, as in the JAX
                    # package; the workers are stuck in the dataset, so they
                    # are stopped rather than waited out
                    if self.timeout and e.__cause__ is None and \
                            _time.monotonic() - t0 >= self.timeout:
                        for w in it._workers:
                            w.terminate()
                        raise TimeoutError(str(e)) from e
                    raise
                yield batch
        finally:
            if not self.persistent_workers or self._workers is None:
                it._shutdown_workers()

    def _iter_threaded(self):
        """Worker threads pull index batches from a task queue; results
        are released strictly in order, at most ``num_workers *
        prefetch_factor`` ahead of the consumer."""
        task_q: _queue.Queue = _queue.Queue()
        done: dict = {}
        done_cv = threading.Condition(threading.Lock())
        stop = threading.Event()
        batches = list(self.batch_sampler)
        for i, b in enumerate(batches):
            task_q.put((i, b))
        inflight_limit = self.num_workers * self.prefetch_factor
        next_out = 0

        def worker(wid):
            _worker_tls.info = WorkerInfo(wid, self.num_workers,
                                          self.dataset, wid)
            if self.worker_init_fn is not None:
                self.worker_init_fn(wid)
            while not stop.is_set():
                try:
                    i, idxs = task_q.get_nowait()
                except _queue.Empty:
                    return
                with done_cv:
                    while i - next_out >= inflight_limit and \
                            not stop.is_set():
                        done_cv.wait(0.05)
                try:
                    result, err = self._fetch(idxs), None
                except Exception as e:  # reaches the consumer
                    result, err = None, e
                with done_cv:
                    done[i] = (result, err)
                    done_cv.notify_all()

        threads = [threading.Thread(target=worker, args=(w,), daemon=True)
                   for w in range(self.num_workers)]
        for t in threads:
            t.start()
        try:
            for i in range(len(batches)):
                with done_cv:
                    if not done_cv.wait_for(lambda: i in done,
                                            self.timeout or None):
                        raise TimeoutError(
                            f"DataLoader timed out after {self.timeout} s "
                            f"waiting for batch {i}")
                    result, err = done.pop(i)
                    next_out = i + 1
                    done_cv.notify_all()
                if err is not None:
                    raise err
                yield result
        finally:
            stop.set()
            with done_cv:
                done_cv.notify_all()
            for t in threads:
                t.join(timeout=1.0)


# ---------------------------------------------------------------------------
# device prefetch: the copy to the card overlaps the step before
# ---------------------------------------------------------------------------

def _dead_worker(workers, wait_s=1.0):
    """The first of ``workers`` that has exited with a failure, waiting up
    to ``wait_s`` for one to be reaped; ``None`` if none has."""
    deadline = _time.monotonic() + wait_s
    while True:
        for w in workers:
            if not w.is_alive() and w.exitcode != 0:
                return w
        if _time.monotonic() >= deadline:
            return None
        _time.sleep(0.01)


def _map_tensors(fn, batch):
    if isinstance(batch, (list, tuple)):
        return type(batch)(_map_tensors(fn, b) for b in batch)
    if isinstance(batch, dict):
        return {k: _map_tensors(fn, v) for k, v in batch.items()}
    return fn(batch)


def device_prefetch(iterable, sharding=None, buffer_size=2, *, device=None):
    """Iterate ``iterable`` (typically a ``DataLoader``) with its batches
    already on ``device`` (``None``: the card): a producer thread copies
    batch N+1 while the caller computes on batch N, at most
    ``buffer_size`` batches ahead.

    On the card the producer pins each CPU tensor and copies it with
    ``non_blocking=True`` on a dedicated ``torch.cuda.Stream``, then
    records an event; the consumer makes its current stream wait on that
    event and marks each copied tensor as used by that stream
    (``record_stream``), so the allocator never hands its memory out
    early. Neither side waits for the card. A tensor already on
    ``device`` passes through uncopied, a numpy array is copied like a
    tensor, anything else passes through. The producer's errors reach
    the consumer; leaving the loop early stops the producer, and the
    loop's end waits until it has stopped.

    Monitor samples: ``prefetch_put_ms`` (the producer's host time to
    queue a batch's copies, span ``io/device_put``), ``prefetch_wait_ms``
    (the consumer's wait for a batch, span ``io/queue_wait``) and the
    count ``prefetch_batches``. A ``sharding`` (the JAX package's batch
    sharding across a mesh) is not ported yet (ROADMAP Queue 1 item 4)."""
    if sharding is not None:
        from ..ops.registry import not_ported
        raise not_ported("device_prefetch(sharding=...)", 4)
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return _prefetch(iterable, dev, max(1, int(buffer_size)))


def _prefetch(iterable, dev, buffer_size):
    on_card = dev.type == "cuda"
    stream = torch.cuda.Stream(dev) if on_card else None

    def one(a, copied):
        if isinstance(a, np.ndarray):
            a = torch.from_numpy(a)
        if not torch.is_tensor(a) or a.device == dev:
            return a
        if on_card and a.device.type == "cpu" and not a.is_pinned():
            a = a.pin_memory()
        out = a.to(dev, non_blocking=on_card)
        copied.append(out)
        return out

    def put(batch):
        copied = []
        if not on_card:
            return _map_tensors(lambda a: one(a, copied), batch), None, ()
        with torch.cuda.device(dev), torch.cuda.stream(stream):
            out = _map_tensors(lambda a: one(a, copied), batch)
            event = torch.cuda.Event()
            event.record(stream)
        return out, event, copied

    q: _queue.Queue = _queue.Queue(maxsize=buffer_size)
    end = object()
    stop = threading.Event()

    def offer(item):
        # a bounded put that gives up once the consumer has left, so an
        # early break does not leave the producer blocked for ever
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except _queue.Full:
                continue
        return False

    def producer():
        it = iter(iterable)
        try:
            for batch in it:
                if stop.is_set():
                    return
                t0 = _time.perf_counter()
                with _prof.record("io/device_put", "io"):
                    item = put(batch)
                stat_observe("prefetch_put_ms",
                             (_time.perf_counter() - t0) * 1e3)
                if not offer(item):
                    return
            offer(end)
        except Exception as e:  # reaches the consumer
            offer(e)
        finally:
            # the source's own clean-up (a loader's workers) runs here,
            # before the thread ends, not whenever it is collected
            close = getattr(it, "close", None)
            if close is not None:
                close()

    thread = threading.Thread(target=producer, daemon=True,
                              name="paddle_tpu_torch-device_prefetch")
    thread.start()
    try:
        while True:
            t0 = _time.perf_counter()
            with _prof.record("io/queue_wait", "io"):
                item = q.get()
            if item is end:
                return
            if isinstance(item, Exception):
                raise item
            batch, event, copied = item
            if event is not None:
                consumer = torch.cuda.current_stream(dev)
                consumer.wait_event(event)
                for t in copied:
                    t.record_stream(consumer)
            # real batches only: the end and an error skew nothing
            stat_observe("prefetch_wait_ms",
                         (_time.perf_counter() - t0) * 1e3)
            stat_add("prefetch_batches")
            yield batch
    finally:
        # the producer stops after the batch it is fetching, if any: wait
        # for it, so no thread of ours is left working on the card
        stop.set()
        if thread is not threading.current_thread():
            thread.join()


class DeviceDataLoader:
    """A loader whose batches arrive on the device through
    ``device_prefetch`` (``len()`` and attributes are the inner
    loader's)."""

    def __init__(self, loader, sharding=None, buffer_size=2, *,
                 device=None):
        self._loader = loader
        self._sharding = sharding
        self._buffer_size = buffer_size
        self._device = device

    def __iter__(self):
        return device_prefetch(self._loader, self._sharding,
                               self._buffer_size, device=self._device)

    def __len__(self):
        return len(self._loader)

    def __getattr__(self, item):
        return getattr(self._loader, item)
