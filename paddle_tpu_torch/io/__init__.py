"""Datasets and batching (counterpart of ``paddle_tpu/io``): ``Dataset``,
``TensorDataset`` and the ``DataLoader`` that ``Model.fit`` batches with.

``DataLoader`` is ``torch.utils.data.DataLoader`` underneath; shuffling
draws from the port's seeded CPU generator, so ``paddle_tpu_torch.seed``
fixes the order. Samples collate into tensors on the CPU; ``Model.fit``
moves each batch to the model's device.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
from torch.utils import data as _data

from ..framework.random import get_generator

__all__ = ["Dataset", "TensorDataset", "DataLoader"]


class Dataset(_data.Dataset):
    def __getitem__(self, idx):
        raise NotImplementedError

    def __len__(self):
        raise NotImplementedError


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


def DataLoader(dataset, feed_list=None, places=None, return_list=True,
               batch_sampler=None, batch_size=1, shuffle=False,
               drop_last=False, collate_fn=None, num_workers=0,
               use_buffer_reader=True, prefetch_factor=2,
               use_shared_memory=True, timeout=0, worker_init_fn=None,
               persistent_workers=False):
    """A ``torch.utils.data.DataLoader`` over ``dataset`` with the JAX
    package's parameters; a shuffled one draws its order from the port's
    CPU generator. ``batch_sampler`` (which then fixes the batches),
    ``collate_fn``, ``num_workers`` and, with workers, ``prefetch_factor``,
    ``timeout``, ``worker_init_fn`` and ``persistent_workers`` pass to
    torch's loader; ``use_buffer_reader`` and ``use_shared_memory`` are
    hints that change no batch. The static-mode ``feed_list``, ``places``
    and ``return_list`` are taken and change no batch either, as in the
    JAX package: a static ``Model`` feeds each batch by the names of its
    ``InputSpec``s."""
    workers = dict(prefetch_factor=prefetch_factor, timeout=timeout,
                   worker_init_fn=worker_init_fn,
                   persistent_workers=persistent_workers) \
        if num_workers > 0 else {}
    if batch_sampler is not None:
        return _data.DataLoader(dataset, batch_sampler=batch_sampler,
                                collate_fn=collate_fn,
                                num_workers=num_workers, **workers)
    return _data.DataLoader(
        dataset, batch_size=batch_size, shuffle=shuffle, drop_last=drop_last,
        collate_fn=collate_fn, num_workers=num_workers,
        generator=get_generator("cpu") if shuffle else None, **workers)
