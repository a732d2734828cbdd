"""``dataset.mnist`` (counterpart of ``paddle_tpu/dataset/mnist.py``)."""
from __future__ import annotations

import os

import numpy as np

from . import common

__all__ = ["train", "test"]


def _reader_creator(image_path, label_path, buffer_size=100):
    from ..vision.datasets import MNIST

    def reader():
        ds = MNIST(image_path=image_path, label_path=label_path)
        for i in range(len(ds)):
            img, lab = ds[i]
            yield (np.asarray(img, np.float32).reshape(-1) / 127.5 - 1.0,
                   int(np.asarray(lab)))

    return reader


def _paths(split):
    base = os.path.join(common.DATA_HOME, "mnist")
    return (os.path.join(base, f"{split}-images-idx3-ubyte.gz"),
            os.path.join(base, f"{split}-labels-idx1-ubyte.gz"))


def train():
    """Reader over normalized [-1,1] flattened images, label int."""
    img, lab = _paths("train")
    return _reader_creator(img, lab)


def test():
    img, lab = _paths("t10k")
    return _reader_creator(img, lab)
