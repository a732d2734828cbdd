"""``dataset.cifar`` (counterpart of ``paddle_tpu/dataset/cifar.py``)."""
from __future__ import annotations

import os

import numpy as np

from . import common

__all__ = ["train10", "test10", "train100", "test100"]


def _reader(cls_name, data_file, mode, cycle=False):
    from ..vision import datasets as V

    def reader():
        ds = getattr(V, cls_name)(data_file=data_file, mode=mode)
        while True:
            for i in range(len(ds)):
                img, lab = ds[i]
                yield (np.asarray(img, np.float32).reshape(-1) / 255.0,
                       int(np.asarray(lab)))
            if not cycle:
                return

    return reader


def train10(cycle=False):
    path = os.path.join(common.DATA_HOME, "cifar",
                        "cifar-10-python.tar.gz")
    return _reader("Cifar10", path, "train", cycle)


def test10(cycle=False):
    path = os.path.join(common.DATA_HOME, "cifar",
                        "cifar-10-python.tar.gz")
    return _reader("Cifar10", path, "test", cycle)


def train100():
    path = os.path.join(common.DATA_HOME, "cifar",
                        "cifar-100-python.tar.gz")
    return _reader("Cifar100", path, "train")


def test100():
    path = os.path.join(common.DATA_HOME, "cifar",
                        "cifar-100-python.tar.gz")
    return _reader("Cifar100", path, "test")
