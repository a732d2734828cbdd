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


def DataLoader(dataset, batch_size=1, shuffle=False, drop_last=False,
               num_workers=0):
    """A ``torch.utils.data.DataLoader`` over ``dataset``; a shuffled one
    draws its order from the port's CPU generator."""
    return _data.DataLoader(
        dataset, batch_size=batch_size, shuffle=shuffle, drop_last=drop_last,
        num_workers=num_workers,
        generator=get_generator("cpu") if shuffle else None)
