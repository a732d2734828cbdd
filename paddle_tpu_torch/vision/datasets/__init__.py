"""Vision datasets (counterpart of ``paddle_tpu/vision/datasets``;
reference: python/paddle/vision/datasets/ — MNIST, FashionMNIST,
Cifar10/100, Flowers, VOC2012, the folder datasets).

The constructors read local files only (a dataset without its files
raises with instructions, whatever ``download`` says); ``FakeData`` is a
deterministic synthetic stand-in with the same sample shapes. Samples
are numpy arrays on the host; the CIFAR pickles are read with the
restricted unpickler of ``framework/io.py`` (numpy arrays and builtin
containers only).
"""
from __future__ import annotations

import gzip
import os
import struct
import tarfile

import numpy as np

from ...framework.io import RestrictedUnpickler
from ...io import Dataset

__all__ = ["MNIST", "FashionMNIST", "Cifar10", "Cifar100", "FakeData",
           "DatasetFolder", "ImageFolder", "Flowers", "VOC2012"]


class FakeData(Dataset):
    """Deterministic synthetic dataset: gaussian images + uniform labels."""

    def __init__(self, size=1000, image_shape=(1, 28, 28), num_classes=10,
                 transform=None, seed=0, dtype="float32"):
        self.size = size
        self.image_shape = tuple(image_shape)
        self.num_classes = num_classes
        self.transform = transform
        self.dtype = dtype
        self._seed = seed

    def __getitem__(self, idx):
        g = np.random.RandomState(self._seed + idx)
        img = g.randn(*self.image_shape).astype(self.dtype)
        label = np.array(g.randint(0, self.num_classes), np.int64)
        if self.transform is not None:
            img = self.transform(img)
        return img, label


    def __len__(self):
        return self.size


def _no_download(name, url_hint):
    raise RuntimeError(
        f"{name}: automatic download is unavailable in this environment "
        f"(no network egress). Place the original files locally and pass "
        f"their path ({url_hint}), or use vision.datasets.FakeData for "
        f"synthetic data.")


class MNIST(Dataset):
    """IDX-format MNIST reader (reference vision/datasets/mnist.py)."""

    NAME = "mnist"

    def __init__(self, image_path=None, label_path=None, mode="train",
                 transform=None, download=False, backend=None):
        self.mode = mode
        self.transform = transform
        if image_path is None or label_path is None:
            _no_download(type(self).__name__,
                         "image_path=/path/train-images-idx3-ubyte.gz, "
                         "label_path=/path/train-labels-idx1-ubyte.gz")
        self.images = self._read_images(image_path)
        self.labels = self._read_labels(label_path)

    @staticmethod
    def _open(path):
        return gzip.open(path, "rb") if path.endswith(".gz") else \
            open(path, "rb")

    def _read_images(self, path):
        with self._open(path) as f:
            magic, n, rows, cols = struct.unpack(">IIII", f.read(16))
            data = np.frombuffer(f.read(), dtype=np.uint8)
        return data.reshape(n, 1, rows, cols)

    def _read_labels(self, path):
        with self._open(path) as f:
            magic, n = struct.unpack(">II", f.read(8))
            data = np.frombuffer(f.read(), dtype=np.uint8)
        return data.astype(np.int64)

    def __getitem__(self, idx):
        img = self.images[idx].astype(np.float32)
        if self.transform is not None:
            img = self.transform(img)
        return img, self.labels[idx]

    def __len__(self):
        return len(self.labels)


class FashionMNIST(MNIST):
    NAME = "fashion-mnist"


class Cifar10(Dataset):
    """CIFAR python-pickle reader (reference vision/datasets/cifar.py)."""

    def __init__(self, data_file=None, mode="train", transform=None,
                 download=False, backend=None):
        if data_file is None:
            _no_download("Cifar10", "data_file=/path/cifar-10-python.tar.gz")
        self.transform = transform
        self.data = []
        self.labels = []
        names = [f"data_batch_{i}" for i in range(1, 6)] \
            if mode == "train" else ["test_batch"]
        with tarfile.open(data_file, "r:*") as tar:
            for member in tar.getmembers():
                base = os.path.basename(member.name)
                if base in names:
                    d = RestrictedUnpickler(tar.extractfile(member),
                                            encoding="bytes").load()
                    self.data.append(d[b"data"])
                    self.labels.extend(d.get(b"labels",
                                             d.get(b"fine_labels")))
        self.data = np.concatenate(self.data).reshape(-1, 3, 32, 32)
        self.labels = np.asarray(self.labels, np.int64)

    def __getitem__(self, idx):
        img = self.data[idx].astype(np.float32)
        if self.transform is not None:
            img = self.transform(img)
        return img, self.labels[idx]

    def __len__(self):
        return len(self.labels)


class Cifar100(Cifar10):
    def __init__(self, data_file=None, mode="train", transform=None,
                 download=False, backend=None):
        if data_file is None:
            _no_download("Cifar100",
                         "data_file=/path/cifar-100-python.tar.gz")
        self.transform = transform
        names = ["train"] if mode == "train" else ["test"]
        self.data, self.labels = [], []
        with tarfile.open(data_file, "r:*") as tar:
            for member in tar.getmembers():
                if os.path.basename(member.name) in names:
                    d = RestrictedUnpickler(tar.extractfile(member),
                                            encoding="bytes").load()
                    self.data.append(d[b"data"])
                    self.labels.extend(d[b"fine_labels"])
        self.data = np.concatenate(self.data).reshape(-1, 3, 32, 32)
        self.labels = np.asarray(self.labels, np.int64)


_IMG_EXTENSIONS = (".jpg", ".jpeg", ".png", ".ppm", ".bmp", ".pgm",
                   ".tif", ".tiff", ".webp")


def _scan_files(root, extensions, is_valid_file):
    """Sorted recursive file scan shared by DatasetFolder/ImageFolder."""
    exts = tuple(e.lower() for e in (extensions or _IMG_EXTENSIONS))
    out = []
    for dirpath, _, files in sorted(os.walk(root)):
        for fname in sorted(files):
            path = os.path.join(dirpath, fname)
            ok = is_valid_file(path) if is_valid_file else \
                fname.lower().endswith(exts)
            if ok:
                out.append(path)
    return out


class DatasetFolder(Dataset):
    """Directory-of-class-folders dataset (reference
    vision/datasets/folder.py DatasetFolder): root/<class>/<file>."""

    def __init__(self, root, loader=None, extensions=None, transform=None,
                 is_valid_file=None):
        from .. import image_load
        self.root = root
        self.transform = transform
        self.loader = loader or image_load
        classes = sorted(d for d in os.listdir(root)
                         if os.path.isdir(os.path.join(root, d)))
        if not classes:
            raise RuntimeError(f"no class folders under {root}")
        self.classes = classes
        self.class_to_idx = {c: i for i, c in enumerate(classes)}
        self.samples = [
            (path, self.class_to_idx[c])
            for c in classes
            for path in _scan_files(os.path.join(root, c), extensions,
                                    is_valid_file)]
        if not self.samples:
            raise RuntimeError(f"no valid files under {root}")

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, idx):
        path, target = self.samples[idx]
        img = self.loader(path)
        if self.transform is not None:
            img = self.transform(img)
        return img, target


class ImageFolder(Dataset):
    """Flat/recursive image listing without labels (reference
    vision/datasets/folder.py ImageFolder)."""

    def __init__(self, root, loader=None, extensions=None, transform=None,
                 is_valid_file=None):
        from .. import image_load
        self.root = root
        self.transform = transform
        self.loader = loader or image_load
        self.samples = _scan_files(root, extensions, is_valid_file)
        if not self.samples:
            raise RuntimeError(f"no valid files under {root}")

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, idx):
        img = self.loader(self.samples[idx])
        if self.transform is not None:
            img = self.transform(img)
        return [img]


class Flowers(Dataset):
    """Flowers-102 (reference vision/datasets/flowers.py). Offline env:
    pass the three local archive paths; a missing file raises with
    placement instructions like the other datasets. Samples load lazily
    from the tar per __getitem__."""

    def __init__(self, data_file=None, label_file=None, setid_file=None,
                 mode="train", transform=None, download=False,
                 backend=None):
        if data_file is None or label_file is None or setid_file is None:
            _no_download("Flowers",
                         ["102flowers.tgz", "imagelabels.mat",
                          "setid.mat"])
        import scipy.io as sio
        labels = sio.loadmat(label_file)["labels"][0]
        key = {"train": "trnid", "test": "tstid",
               "valid": "valid"}[mode]
        wanted = [int(i) for i in sio.loadmat(setid_file)[key][0]]
        self._data_file = data_file
        self._items = [(f"jpg/image_{i:05d}.jpg", int(labels[i - 1]) - 1)
                       for i in wanted]
        self._tf = None        # opened lazily, once per worker process
        self.transform = transform

    def _tar(self):
        if self._tf is None:
            self._tf = tarfile.open(self._data_file)
        return self._tf

    def __getstate__(self):
        d = dict(self.__dict__)
        d["_tf"] = None        # handles don't pickle to loader workers
        return d

    def __len__(self):
        return len(self._items)

    def __getitem__(self, idx):
        import io as _io
        from PIL import Image
        name, label = self._items[idx]
        data = self._tar().extractfile(name).read()
        img = np.asarray(Image.open(_io.BytesIO(data)),
                         np.float32).transpose(2, 0, 1) / 255.0
        if self.transform is not None:
            img = self.transform(img)
        return img, label


class VOC2012(Dataset):
    """VOC2012 segmentation (reference vision/datasets/voc2012.py):
    (image, label-mask) pairs from the trainval tarball."""

    _SET = "VOCdevkit/VOC2012/ImageSets/Segmentation/{}.txt"
    _IMG = "VOCdevkit/VOC2012/JPEGImages/{}.jpg"
    _LBL = "VOCdevkit/VOC2012/SegmentationClass/{}.png"

    def __init__(self, data_file=None, mode="train", transform=None,
                 download=False, backend=None):
        if data_file is None:
            _no_download("VOC2012", ["VOCtrainval_11-May-2012.tar"])
        self._data_file = data_file
        sub = {"train": "train", "valid": "val", "test": "val",
               "trainval": "trainval"}[mode]
        self._tf = None        # opened lazily, once per worker process
        lines = self._tar().extractfile(self._SET.format(sub)).read()
        self._stems = [ln.strip() for ln in lines.decode().splitlines()
                       if ln.strip()]
        self.transform = transform

    def _tar(self):
        if self._tf is None:
            self._tf = tarfile.open(self._data_file)
        return self._tf

    def __getstate__(self):
        d = dict(self.__dict__)
        d["_tf"] = None
        return d

    def __len__(self):
        return len(self._stems)

    def __getitem__(self, idx):
        import io as _io
        from PIL import Image
        stem = self._stems[idx]
        tf = self._tar()
        img_b = tf.extractfile(self._IMG.format(stem)).read()
        lbl_b = tf.extractfile(self._LBL.format(stem)).read()
        img = np.array(Image.open(_io.BytesIO(img_b)))
        lbl = np.array(Image.open(_io.BytesIO(lbl_b)))
        if self.transform is not None:
            img = self.transform(img)
        return img, lbl
