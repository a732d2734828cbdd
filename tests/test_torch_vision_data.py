"""The port's vision data side against the JAX package's, on the CPU:
``vision.transforms`` (+ ``functional``), ``vision.datasets``, the image
backend and ``utils.pretrained``.

- Transforms are numpy on the host in both packages: every class of the
  JAX ``__all__`` and every functional form gives the JAX result exactly
  (float32 arrays, the same arithmetic); the random ones draw from one
  ``RandomState`` a process in the port and from numpy's global one in
  JAX, so with both seeded alike they draw alike, and every draw is
  compared. A forked worker draws its own stream.
- Datasets read files the test writes into ``tmp_path`` (MNIST's IDX,
  CIFAR's pickled tarballs, class folders, Flowers' tarball and ``.mat``
  files, VOC2012's tarball): every sample equals the JAX dataset's;
  ``download=True`` without files raises as in JAX.
- ``load_pdparams`` reads a reference-format file as the JAX one does
  and refuses a pickle that would run code; ``pretrained=<path>`` loads
  a JAX network's state into the port's ``resnet18`` and
  ``mobilenet_v1`` (``Linear`` weights transposed).
"""
import gzip
import io
import os
import pickle
import struct
import tarfile

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import vision as jv
from paddle_tpu.utils import pretrained as jax_pretrained
from paddle_tpu.vision import datasets as jds
from paddle_tpu.vision import transforms as jT
from paddle_tpu.vision.transforms import functional as jF
from paddle_tpu_torch import vision as tv
from paddle_tpu_torch.convert import layer_to_numpy
from paddle_tpu_torch.utils import pretrained
from paddle_tpu_torch.vision import datasets as tds
from paddle_tpu_torch.vision import transforms as T
from paddle_tpu_torch.vision.transforms import functional as F


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.numpy()
    if hasattr(x, "_data"):
        return np.asarray(x._data)
    return np.asarray(x)


def _same(got, want):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_array_equal(got, want)


IMG = np.random.RandomState(0).randint(0, 256, (20, 24, 3)).astype(np.uint8)
CHW = np.random.RandomState(1).rand(3, 20, 24).astype(np.float32)

FUNCTIONAL = [
    ("to_tensor", (IMG,), {}),
    ("to_tensor", (IMG,), {"data_format": "HWC"}),
    ("resize", (CHW, 11), {}),
    ("resize", (IMG, (9, 13)), {"interpolation": "nearest"}),
    ("crop", (CHW, 2, 3, 10, 12), {}),
    ("center_crop", (CHW, 9), {}),
    ("hflip", (IMG,), {}),
    ("vflip", (CHW,), {}),
    ("pad", (CHW, 2), {}),
    ("pad", (CHW, (1, 2, 3, 4)), {"fill": 0.5}),
    ("pad", (CHW, (2, 1)), {"padding_mode": "reflect"}),
    ("normalize", (CHW, [0.4, 0.5, 0.6], [0.2, 0.3, 0.25]), {}),
    ("normalize", (CHW.transpose(1, 2, 0), [0.4, 0.5, 0.6],
                   [0.2, 0.3, 0.25]), {"data_format": "HWC"}),
    ("rotate", (CHW, 30), {}),
    ("rotate", (CHW, -45), {"expand": True, "fill": 0.2}),
    ("affine", (CHW, 15, (2, -1), 1.1, (5.0, 0.0)), {}),
    ("perspective", (CHW, [[0, 0], [23, 0], [23, 19], [0, 19]],
                     [[2, 1], [21, 0], [22, 18], [1, 17]]), {}),
    ("erase", (CHW, 2, 3, 5, 6, 0.0), {}),
    ("to_grayscale", (CHW,), {}),
    ("to_grayscale", (CHW,), {"num_output_channels": 3}),
    ("adjust_brightness", (CHW, 1.3), {}),
    ("adjust_contrast", (CHW, 0.7), {}),
    ("adjust_saturation", (CHW, 1.4), {}),
    ("adjust_hue", (CHW, 0.1), {}),
]


@pytest.mark.parametrize("name, args, kw", FUNCTIONAL,
                         ids=[f"{c[0]}_{i}" for i, c in enumerate(FUNCTIONAL)])
def test_functional_matches_jax(name, args, kw):
    got = getattr(F, name)(*[a.copy() if isinstance(a, np.ndarray) else a
                             for a in args], **kw)
    want = getattr(jF, name)(*[a.copy() if isinstance(a, np.ndarray) else a
                               for a in args], **kw)
    _same(got, want)
    if name == "to_tensor":
        assert isinstance(got, torch.Tensor) and got.device.type == "cpu"


def test_functional_forms_are_the_jax_ones():
    assert set(F.__all__) == set(jF.__all__)
    assert set(T.__all__) == set(jT.__all__)
    assert all(getattr(T, n) is getattr(F, n) for n in F.__all__)


def _classes():
    """(name, factory(module)) for each class of the JAX ``__all__``."""
    return [
        ("Compose", lambda m: m.Compose([m.Resize(12), m.CenterCrop(10)])),
        ("BaseTransform", None),
        ("ToTensor", lambda m: m.ToTensor()),
        ("Normalize", lambda m: m.Normalize([0.5] * 3, [0.25] * 3)),
        ("Resize", lambda m: m.Resize((10, 14))),
        ("CenterCrop", lambda m: m.CenterCrop((8, 9))),
        ("RandomCrop", lambda m: m.RandomCrop(9, padding=2)),
        ("RandomHorizontalFlip", lambda m: m.RandomHorizontalFlip(0.5)),
        ("RandomVerticalFlip", lambda m: m.RandomVerticalFlip(0.5)),
        ("Transpose", lambda m: m.Transpose((1, 2, 0))),
        ("BrightnessTransform", lambda m: m.BrightnessTransform(0.4)),
        ("ContrastTransform", lambda m: m.ContrastTransform(0.4)),
        ("SaturationTransform", lambda m: m.SaturationTransform(0.4)),
        ("HueTransform", lambda m: m.HueTransform(0.2)),
        ("ColorJitter", lambda m: m.ColorJitter(0.3, 0.3, 0.3, 0.1)),
        ("Grayscale", lambda m: m.Grayscale(3)),
        ("Pad", lambda m: m.Pad((1, 2), 0.5)),
        ("RandomRotation", lambda m: m.RandomRotation(40)),
        ("RandomAffine", lambda m: m.RandomAffine(
            20, translate=(0.1, 0.2), scale=(0.8, 1.2), shear=10)),
        ("RandomPerspective", lambda m: m.RandomPerspective(0.7, 0.4)),
        ("RandomErasing", lambda m: m.RandomErasing(0.8, value="random")),
        ("RandomResizedCrop", lambda m: m.RandomResizedCrop(12)),
    ]


@pytest.mark.parametrize("name, factory", _classes(),
                         ids=[c[0] for c in _classes()])
def test_transform_class_matches_jax(name, factory):
    """Each class, seeded alike, over five draws."""
    assert name in jT.__all__
    if factory is None:
        class Twice(T.BaseTransform):
            def _apply_image(self, img):
                return img * 2
        out = Twice(keys=("image", "label"))((CHW, 5))
        _same(out[0], CHW * 2)
        assert out[1] == 5
        return
    mine, theirs = factory(T), factory(jT)
    T.seed(11)
    np.random.seed(11)
    for i in range(5):
        src = CHW if name not in ("ToTensor",) else IMG
        _same(mine(src.copy()), theirs(src.copy()))


def test_the_transform_generator_is_per_process():
    T.seed(3)
    first = T.rng().rand()
    T.seed(3)
    assert T.rng().rand() == first
    read, write = os.pipe()
    pid = os.fork()
    if pid == 0:                       # a loader worker: its own stream
        os.close(read)
        torch.manual_seed(1234)
        os.write(write, repr(T.rng().rand()).encode())
        os._exit(0)
    os.close(write)
    child = float(os.read(read, 64).decode())
    os.close(read)
    os.waitpid(pid, 0)
    assert child == np.random.RandomState(1234).rand()
    assert T.rng().rand() != child


def test_the_image_backend_matches_jax(tmp_path):
    from PIL import Image
    path = str(tmp_path / "a.png")
    Image.fromarray(IMG).save(path)
    assert tv.get_image_backend() == jv.get_image_backend() == "pil"
    assert isinstance(tv.image_load(path), Image.Image)
    _same(tv.image_load(path, backend="tensor"),
          jv.image_load(path, backend="tensor"))
    try:
        tv.set_image_backend("tensor")
        assert tv.get_image_backend() == "tensor"
        _same(tv.image_load(path), IMG)
        for bad, err in (("cv2", RuntimeError), ("opencv", ValueError)):
            with pytest.raises(err):
                tv.set_image_backend(bad)
            with pytest.raises(err):
                jv.set_image_backend(bad)
    finally:
        tv.set_image_backend("pil")


def _write_idx(path, images, labels):
    with gzip.open(path + "-images.gz", "wb") as f:
        f.write(struct.pack(">IIII", 2051, *images.shape) + images.tobytes())
    with gzip.open(path + "-labels.gz", "wb") as f:
        f.write(struct.pack(">II", 2049, len(labels)) + labels.tobytes())
    return path + "-images.gz", path + "-labels.gz"


def _tar(path, members):
    with tarfile.open(path, "w:gz") as tar:
        for name, data in members.items():
            info = tarfile.TarInfo(name)
            info.size = len(data)
            tar.addfile(info, io.BytesIO(data))
    return path


def _jpeg(arr, fmt="JPEG"):
    from PIL import Image
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format=fmt)
    return buf.getvalue()


def _pairs(mine, theirs):
    assert len(mine) == len(theirs) > 0
    for i in range(len(mine)):
        for a, b in zip(mine[i], theirs[i]):
            _same(a, b)


def test_datasets_read_the_files_as_the_jax_ones(tmp_path):
    rs = np.random.RandomState(7)
    ims = rs.randint(0, 256, (5, 28, 28)).astype(np.uint8)
    labs = rs.randint(0, 10, 5).astype(np.uint8)
    ip, lp = _write_idx(str(tmp_path / "mnist"), ims, labs)
    tf = T.Normalize(0.5, 0.5)
    for cls in ("MNIST", "FashionMNIST"):
        _pairs(getattr(tds, cls)(ip, lp, transform=tf),
               getattr(jds, cls)(ip, lp, transform=jT.Normalize(0.5, 0.5)))
    batch = {b"data": rs.randint(0, 256, (4, 3072)).astype(np.uint8),
             b"labels": list(rs.randint(0, 10, 4)),
             b"fine_labels": list(rs.randint(0, 100, 4))}
    blob = pickle.dumps(batch)
    c10 = _tar(str(tmp_path / "c10.tar.gz"),
               {"cifar-10-batches-py/data_batch_1": blob,
                "cifar-10-batches-py/test_batch": blob})
    c100 = _tar(str(tmp_path / "c100.tar.gz"),
                {"cifar-100-python/train": blob,
                 "cifar-100-python/test": blob})
    for mode in ("train", "test"):
        _pairs(tds.Cifar10(c10, mode=mode), jds.Cifar10(c10, mode=mode))
        _pairs(tds.Cifar100(c100, mode=mode), jds.Cifar100(c100, mode=mode))
    _pairs(tds.FakeData(4, (3, 8, 8), 5, seed=2),
           jds.FakeData(4, (3, 8, 8), 5, seed=2))
    for cls in ("MNIST", "Cifar10", "Cifar100", "Flowers", "VOC2012"):
        with pytest.raises(RuntimeError, match="download"):
            getattr(tds, cls)(download=True)


def test_folder_datasets_match_jax(tmp_path):
    from PIL import Image
    rs = np.random.RandomState(8)
    root = tmp_path / "folders"
    for c in ("b_cls", "a_cls"):
        (root / c / "sub").mkdir(parents=True)
        for i in range(2):
            np.save(root / c / f"{i}.npy",
                    rs.randint(0, 256, (6, 5, 3)).astype(np.uint8))
            Image.fromarray(rs.randint(0, 256, (6, 5, 3)).astype(
                np.uint8)).save(root / c / "sub" / f"{i}.png")
    mine = tds.DatasetFolder(str(root), loader=np.load,
                             extensions=(".npy",))
    theirs = jds.DatasetFolder(str(root), loader=np.load,
                               extensions=(".npy",))
    assert mine.classes == theirs.classes == ["a_cls", "b_cls"]
    assert mine.samples == theirs.samples
    _pairs(mine, theirs)
    both = [tds.ImageFolder(str(root), loader=lambda p: tv.image_load(
        p, backend="tensor")), jds.ImageFolder(str(root), loader=lambda p:
                                              jv.image_load(p, "tensor"))]
    assert both[0].samples == both[1].samples and len(both[0]) == 4
    _pairs(*both)
    with pytest.raises(RuntimeError, match="no class folders"):
        tds.DatasetFolder(str(root / "a_cls" / "sub"))


def test_flowers_and_voc_match_jax(tmp_path):
    import scipy.io as sio
    rs = np.random.RandomState(9)
    imgs = {f"jpg/image_{i:05d}.jpg": _jpeg(rs.randint(
        0, 256, (8, 7, 3)).astype(np.uint8)) for i in range(1, 5)}
    data = _tar(str(tmp_path / "102flowers.tgz"), imgs)
    sio.savemat(tmp_path / "labels.mat",
                {"labels": np.array([[3, 1, 2, 3]])})
    sio.savemat(tmp_path / "setid.mat",
                {"trnid": np.array([[1, 3]]), "tstid": np.array([[2]]),
                 "valid": np.array([[4]])})
    for mode in ("train", "test", "valid"):
        args = (data, str(tmp_path / "labels.mat"),
                str(tmp_path / "setid.mat"), mode)
        mine, theirs = tds.Flowers(*args), jds.Flowers(*args)
        _pairs(mine, theirs)
        assert pickle.loads(pickle.dumps(mine))._tf is None
    stems = ["2007_000001", "2007_000002"]
    members = {"VOCdevkit/VOC2012/ImageSets/Segmentation/train.txt":
               "\n".join(stems).encode()}
    for s in stems:
        members[f"VOCdevkit/VOC2012/JPEGImages/{s}.jpg"] = _jpeg(
            rs.randint(0, 256, (6, 9, 3)).astype(np.uint8))
        members[f"VOCdevkit/VOC2012/SegmentationClass/{s}.png"] = _jpeg(
            rs.randint(0, 21, (6, 9)).astype(np.uint8), "PNG")
    voc = _tar(str(tmp_path / "voc.tar"), members)
    _pairs(tds.VOC2012(voc), jds.VOC2012(voc))


class _Evil:
    def __reduce__(self):
        return (os.system, ("echo pwned",))


def test_load_pdparams_reads_the_format_and_refuses_code(tmp_path):
    rs = np.random.RandomState(10)
    state = {"a.weight": rs.randn(3, 4).astype(np.float32),
             "a.bias": rs.randn(4).astype(np.float32),
             "StructuredToParameterName@@": {"a.weight": "linear_0.w_0"},
             "opt": {"beta1_pow": rs.rand(1).astype(np.float32)},
             "step": np.int64(3)}
    path = str(tmp_path / "m.pdparams")
    with open(path, "wb") as f:
        pickle.dump(state, f, protocol=2)
    mine, theirs = pretrained.load_pdparams(path), \
        jax_pretrained.load_pdparams(path)
    assert sorted(mine) == sorted(theirs)
    for k in theirs:
        _same(mine[k], theirs[k])
    evil = str(tmp_path / "evil.pdparams")
    with open(evil, "wb") as f:
        pickle.dump({"w": _Evil()}, f)
    for load in (pretrained.load_pdparams, jax_pretrained.load_pdparams):
        with pytest.raises(pickle.UnpicklingError, match="refusing"):
            load(evil)


@pytest.mark.parametrize("name", ["resnet18", "mobilenet_v1"])
def test_pretrained_path_loads_a_jax_networks_state(tmp_path, name):
    paddle.seed(4)
    jax_net = getattr(jv.models, name)(num_classes=6)
    path = str(tmp_path / f"{name}.pdparams")
    with open(path, "wb") as f:
        pickle.dump({k: np.asarray(v._data)
                     for k, v in jax_net.state_dict().items()}, f)
    net = getattr(tv.models, name)(pretrained=path, num_classes=6)
    got = layer_to_numpy(net)
    for k, v in jax_net.state_dict().items():
        np.testing.assert_array_equal(got[k], np.asarray(v._data), k)
    with pytest.raises(ValueError, match="missing"):
        tv.models.resnet34(pretrained=path, num_classes=6)
