"""``dataset.flowers`` (counterpart of ``paddle_tpu/dataset/flowers.py``) —
Oxford-102 readers over local tarballs."""
from __future__ import annotations

import os

from . import common

__all__ = ["train", "test", "valid"]


def _reader(mode):
    def reader():
        base = os.path.join(common.DATA_HOME, "flowers")
        img = os.path.join(base, "102flowers.tgz")
        lab = os.path.join(base, "imagelabels.mat")
        setid = os.path.join(base, "setid.mat")
        for p in (img, lab, setid):
            if not os.path.exists(p):
                raise RuntimeError(
                    f"place {os.path.basename(p)} at {p} (nothing is fetched)")
        import scipy.io as sio
        import tarfile
        import numpy as np
        labels = sio.loadmat(lab)["labels"][0]
        ids = sio.loadmat(setid)
        key = {"train": "trnid", "test": "tstid", "valid": "valid"}[mode]
        wanted = set(int(i) for i in ids[key][0])
        from PIL import Image
        import io
        with tarfile.open(img) as tarf:
            for tf in tarf:
                if not tf.name.endswith(".jpg"):
                    continue
                idx = int(tf.name[-9:-4])
                if idx not in wanted:
                    continue
                data = tarf.extractfile(tf).read()
                arr = np.asarray(Image.open(io.BytesIO(data)), np.float32)
                yield arr.transpose(2, 0, 1) / 255.0, int(labels[idx - 1]) - 1

    return reader


def _wrap(base, mapper, cycle):
    def reader():
        while True:
            for sample in base():
                yield mapper(sample) if mapper is not None else sample
            if not cycle:
                return

    return reader


def train(mapper=None, buffered_size=1024, use_xmap=True, cycle=False):
    return _wrap(_reader("train"), mapper, cycle)


def test(mapper=None, buffered_size=1024, use_xmap=True, cycle=False):
    return _wrap(_reader("test"), mapper, cycle)


def valid(mapper=None, buffered_size=1024, use_xmap=True, cycle=False):
    return _wrap(_reader("valid"), mapper, cycle)
