"""``dataset.voc2012`` (counterpart of ``paddle_tpu/dataset/voc2012.py``) —
Pascal VOC2012 segmentation readers yielding (image, label) HWC arrays.
"""
from __future__ import annotations

import io
import os
import tarfile

import numpy as np

from . import common

__all__ = ["train", "test", "val"]

_SET_FILE = "VOCdevkit/VOC2012/ImageSets/Segmentation/{}.txt"
_DATA_FILE = "VOCdevkit/VOC2012/JPEGImages/{}.jpg"
_LABEL_FILE = "VOCdevkit/VOC2012/SegmentationClass/{}.png"


def _tar_path():
    return os.path.join(common.DATA_HOME, "voc2012",
                        "VOCtrainval_11-May-2012.tar")


def _reader_creator(sub_name):
    path = _tar_path()
    if not os.path.exists(path):
        raise RuntimeError(
            f"place the VOC2012 tarball at {path} (nothing is fetched)")

    def reader():
        try:
            from PIL import Image
        except ImportError as e:  # pillow is optional in this image
            raise RuntimeError(
                "voc2012 readers need pillow to decode jpg/png") from e
        with tarfile.open(path) as tar:
            members = {m.name: m for m in tar.getmembers()}
            sets = tar.extractfile(members[_SET_FILE.format(sub_name)])
            for line in sets:
                stem = line.decode().strip()
                img = Image.open(io.BytesIO(tar.extractfile(
                    members[_DATA_FILE.format(stem)]).read()))
                lbl = Image.open(io.BytesIO(tar.extractfile(
                    members[_LABEL_FILE.format(stem)]).read()))
                yield np.array(img), np.array(lbl)

    return reader


def train():
    """2913 trainval images, HWC uint8."""
    return _reader_creator("trainval")


def test():
    """1464 train images (reference quirk: test() reads 'train')."""
    return _reader_creator("train")


def val():
    """1449 val images."""
    return _reader_creator("val")
