"""``dataset`` and ``hub`` of the PyTorch port against the JAX package's,
on the CPU.

The test writes a tiny archive in each dataset's layout under one
``DATA_HOME`` (both packages' ``common.DATA_HOME`` point at it): MNIST's
gzipped idx files, CIFAR-10/100's pickled tarballs, UCI housing's text
table, IMDB's and PTB's tarballs, MovieLens' zip, Flowers' tarball and
``.mat`` files, WMT14's and WMT16's tarballs, CoNLL-05's tarball and
dictionaries, VOC2012's tarball. Every reader of the port yields the
same samples as the JAX reader, element for element (numpy arrays equal
exactly, as both read the same bytes); a missing archive raises
``RuntimeError`` naming where to place it, and ``common.download``
raises for a missing file. ``hub`` lists, documents and loads the entry
points of a local ``hubconf.py`` as the JAX ``hub`` does; ``"github"``
raises, and a missing dependency is named.
"""
import gzip
import io
import pickle
import struct
import tarfile
import zipfile

import numpy as np
import pytest

import paddle_tpu.dataset as jds
import paddle_tpu.hub as jhub
import paddle_tpu_torch as pt
import paddle_tpu_torch.dataset as tds
import paddle_tpu_torch.hub as thub


def _tar(path, members, mode="w:gz"):
    with tarfile.open(path, mode) as tar:
        for name, data in members.items():
            info = tarfile.TarInfo(name)
            info.size = len(data)
            tar.addfile(info, io.BytesIO(data))


def _image(arr, fmt):
    from PIL import Image
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format=fmt)
    return buf.getvalue()


def _write_all(home):
    rs = np.random.RandomState(0)
    d = home / "mnist"
    d.mkdir()
    for split, n in (("train", 4), ("t10k", 3)):
        ims = rs.randint(0, 256, (n, 28, 28)).astype(np.uint8)
        labs = rs.randint(0, 10, n).astype(np.uint8)
        with gzip.open(d / f"{split}-images-idx3-ubyte.gz", "wb") as f:
            f.write(struct.pack(">IIII", 2051, *ims.shape) + ims.tobytes())
        with gzip.open(d / f"{split}-labels-idx1-ubyte.gz", "wb") as f:
            f.write(struct.pack(">II", 2049, n) + labs.tobytes())
    d = home / "cifar"
    d.mkdir()
    blob = pickle.dumps({b"data": rs.randint(0, 256, (3, 3072)).astype(
        np.uint8), b"labels": [1, 0, 2], b"fine_labels": [5, 9, 7]})
    _tar(d / "cifar-10-python.tar.gz",
         {"cifar-10-batches-py/data_batch_1": blob,
          "cifar-10-batches-py/test_batch": blob})
    _tar(d / "cifar-100-python.tar.gz",
         {"cifar-100-python/train": blob, "cifar-100-python/test": blob})
    d = home / "uci_housing"
    d.mkdir()
    np.savetxt(d / "housing.data", rs.rand(10, 14) * 50)
    d = home / "imdb"
    d.mkdir()
    reviews = {}
    for split in ("train", "test"):
        for lab in ("pos", "neg"):
            for i in range(2):
                words = rs.choice(["good", "bad", "film", "plot", "the",
                                   "Great!", "awful,"], 6)
                reviews[f"aclImdb/{split}/{lab}/{i}_7.txt"] = \
                    " ".join(words).encode()
    _tar(d / "aclImdb_v1.tar.gz", reviews)
    d = home / "imikolov"
    d.mkdir()
    text = {f"./simple-examples/data/ptb.{s}.txt":
            b"the cat sat on the mat\n a dog saw the cat <unk>\n"
            for s in ("train", "valid", "test")}
    _tar(d / "simple-examples.tgz", text)
    d = home / "movielens"
    d.mkdir()
    with zipfile.ZipFile(d / "ml-1m.zip", "w") as z:
        z.writestr("ml-1m/movies.dat",
                   "1::Toy Story (1995)::Animation|Comedy\n"
                   "2::Heat (1995)::Action|Crime\n")
        z.writestr("ml-1m/users.dat", "1::F::1::10::48067\n"
                   "2::M::56::16::70072\n")
        z.writestr("ml-1m/ratings.dat", "\n".join(
            f"{1 + i % 2}::{1 + (i // 2) % 2}::{1 + i % 5}::9783{i}"
            for i in range(12)) + "\n")
    d = home / "flowers"
    d.mkdir()
    import scipy.io as sio
    _tar(d / "102flowers.tgz", {
        f"jpg/image_{i:05d}.jpg": _image(rs.randint(0, 256, (8, 7, 3))
                                         .astype(np.uint8), "JPEG")
        for i in range(1, 5)})
    sio.savemat(d / "imagelabels.mat", {"labels": np.array([[3, 1, 2, 3]])})
    sio.savemat(d / "setid.mat", {"trnid": np.array([[1, 3]]),
                                  "tstid": np.array([[2]]),
                                  "valid": np.array([[4]])})
    d = home / "wmt14"
    d.mkdir()
    _tar(d / "wmt14.tgz", {
        "data/src.dict": b"<s>\n<e>\n<unk>\nhello\nworld\n",
        "data/trg.dict": b"<s>\n<e>\n<unk>\nbonjour\nmonde\n",
        "data/train/train": b"hello world\tbonjour monde\n"
                            b"hello novel\tbonjour nouveau\n",
        "data/test/test": b"world\tmonde\n"})
    d = home / "wmt16"
    d.mkdir()
    _tar(d / "wmt16.tar.gz", {"wmt16/train": b"a b a\tx y\nb a\ty x z\n",
                              "wmt16/test": b"a\tx\n",
                              "wmt16/val": b"b\ty\n"})
    d = home / "conll05st"
    d.mkdir()
    _tar(d / "conll05st-tests.tar.gz", {
        "conll05st-release/test.wsj/words/test.wsj.words.gz":
            gzip.compress(b"The\ncat\nsat\n\n"),
        "conll05st-release/test.wsj/props/test.wsj.props.gz":
            gzip.compress(b"-\t(A0*\n-\t*)\nsat\t(V*)\n\n")})
    (d / "wordDict.txt").write_text("The\ncat\nsat\n")
    (d / "verbDict.txt").write_text("sat\n")
    (d / "targetDict.txt").write_text("B-A0\nB-V\nO\n")
    d = home / "voc2012"
    d.mkdir()
    members = {f"VOCdevkit/VOC2012/ImageSets/Segmentation/{s}.txt":
               b"img0\n" for s in ("trainval", "val", "train")}
    members["VOCdevkit/VOC2012/JPEGImages/img0.jpg"] = _image(
        rs.randint(0, 255, (8, 8, 3)).astype(np.uint8), "JPEG")
    members["VOCdevkit/VOC2012/SegmentationClass/img0.png"] = _image(
        rs.randint(0, 20, (8, 8)).astype(np.uint8), "PNG")
    _tar(d / "VOCtrainval_11-May-2012.tar", members, mode="w")


@pytest.fixture(scope="module")
def data_home(tmp_path_factory):
    home = tmp_path_factory.mktemp("data_home")
    _write_all(home)
    return home


@pytest.fixture
def homes(data_home, monkeypatch):
    for mod in (jds.common, tds.common):
        monkeypatch.setattr(mod, "DATA_HOME", str(data_home))
    for mod in (jds.movielens, tds.movielens):
        monkeypatch.setattr(mod, "MOVIE_INFO", None)
    return data_home


def _same(a, b):
    if isinstance(a, (list, tuple)):
        assert isinstance(b, (list, tuple)) and len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    elif isinstance(a, dict):
        assert a == b
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape and a.dtype == b.dtype
        assert np.array_equal(a, b)
    else:
        assert a == b and type(a) is type(b), (a, b)


def _imdb(mod, name):
    return getattr(mod.imdb, name)(mod.imdb.word_dict(cutoff=0))


def _imikolov(mod, name, kind):
    d = mod.imikolov.build_dict(min_word_freq=0)
    return getattr(mod.imikolov, name)(d, 3, kind)


READERS = {
    "mnist.train": lambda m: m.mnist.train(),
    "mnist.test": lambda m: m.mnist.test(),
    "cifar.train10": lambda m: m.cifar.train10(),
    "cifar.test10": lambda m: m.cifar.test10(),
    "cifar.train100": lambda m: m.cifar.train100(),
    "cifar.test100": lambda m: m.cifar.test100(),
    "uci_housing.train": lambda m: m.uci_housing.train(),
    "uci_housing.test": lambda m: m.uci_housing.test(),
    "imdb.train": lambda m: _imdb(m, "train"),
    "imdb.test": lambda m: _imdb(m, "test"),
    "imikolov.train.ngram": lambda m: _imikolov(m, "train", "ngram"),
    "imikolov.test.seq": lambda m: _imikolov(m, "test", "seq"),
    "movielens.train": lambda m: m.movielens.train(),
    "movielens.test": lambda m: m.movielens.test(),
    "flowers.train": lambda m: m.flowers.train(),
    "flowers.valid": lambda m: m.flowers.valid(),
    "wmt14.train": lambda m: m.wmt14.train(5),
    "wmt14.test": lambda m: m.wmt14.test(5),
    "wmt16.train.de": lambda m: m.wmt16.train(10, 10, src_lang="de"),
    "wmt16.validation": lambda m: m.wmt16.validation(10, 10),
    "conll05.test": lambda m: m.conll05.test(),
    "voc2012.train": lambda m: m.voc2012.train(),
    "voc2012.val": lambda m: m.voc2012.val(),
}


@pytest.mark.parametrize("name", sorted(READERS))
def test_every_reader_yields_the_jax_samples(homes, name):
    mine = list(READERS[name](tds)())
    theirs = list(READERS[name](jds)())
    assert len(mine) == len(theirs) > 0
    _same(mine, theirs)


def test_the_dictionaries_and_metadata_match_jax(homes):
    for mod in (jds, tds):
        mod.movielens.train()
        next(iter(mod.movielens.train()()))
    for fn in ("get_movie_title_dict", "max_movie_id", "max_user_id",
               "max_job_id", "movie_categories"):
        _same(getattr(tds.movielens, fn)(), getattr(jds.movielens, fn)())
    _same(tds.wmt14.get_dict(5), jds.wmt14.get_dict(5))
    _same(tds.wmt16.get_dict("en", 10), jds.wmt16.get_dict("en", 10))
    _same(tds.conll05.get_dict(), jds.conll05.get_dict())
    _same(tds.imdb.word_dict(cutoff=0), jds.imdb.word_dict(cutoff=0))
    _same(tds.uci_housing.feature_names, jds.uci_housing.feature_names)
    assert sorted(tds.__all__) == sorted(jds.__all__)


def test_missing_files_raise_naming_the_place(tmp_path, monkeypatch):
    monkeypatch.setattr(tds.common, "DATA_HOME", str(tmp_path))
    monkeypatch.setattr(tds.movielens, "MOVIE_INFO", None)
    for make in (lambda: tds.uci_housing.train(), lambda: tds.wmt14.train(5),
                 lambda: tds.movielens.train(), lambda: tds.flowers.train(),
                 lambda: tds.imikolov.train({"<unk>": 0}, 2)):
        with pytest.raises(RuntimeError, match=str(tmp_path)):
            list(make()())
    with pytest.raises(RuntimeError, match="place the file at"):
        tds.common.download("http://example.invalid/x.tgz", "mod", "")
    (tmp_path / "mod").mkdir()
    (tmp_path / "mod" / "x.tgz").write_bytes(b"abc")
    assert tds.common.download("http://example.invalid/x.tgz", "mod",
                               tds.common.md5file(
                                   str(tmp_path / "mod" / "x.tgz")))
    with pytest.raises(RuntimeError, match="md5"):
        tds.common.download("http://example.invalid/x.tgz", "mod", "00")
    files = []
    for i in range(4):
        (tmp_path / f"part{i}").write_bytes(bytes([i]))
    for mod in (jds, tds):
        files.append(list(mod.common.cluster_files_reader(
            str(tmp_path / "part*"), 2, 1)()))
    assert files[0] == files[1] == [b"\x01", b"\x03"]
    assert tds.common.DATA_HOME and pt.dataset is tds


HUBCONF = '''
"""A local hub."""
dependencies = ["numpy"]


def tiny(scale=1.0):
    """A tiny model: returns its scale."""
    return {"scale": scale}


def _private():
    return None
'''


def test_hub_over_a_local_hubconf(tmp_path):
    (tmp_path / "hubconf.py").write_text(HUBCONF)
    repo = str(tmp_path)
    for source in ("local", "file"):
        assert thub.list(repo, source=source) == jhub.list(repo,
                                                           source=source)
        assert thub.help(repo, "tiny", source=source) == jhub.help(
            repo, "tiny", source=source)
        assert thub.load(repo, "tiny", source=source, scale=2.0) == \
            jhub.load(repo, "tiny", source=source, scale=2.0)
    with pytest.raises(RuntimeError, match="network"):
        thub.load(repo, "tiny", source="github")
    with pytest.raises(ValueError, match="not found"):
        thub.load(repo, "nothing", source="local")
    with pytest.raises(ValueError, match="unknown source"):
        thub.list(repo, source="svn")
    (tmp_path / "hubconf.py").write_text(
        HUBCONF.replace('["numpy"]', '["numpy", "no_such_package_xyz"]'))
    with pytest.raises(RuntimeError, match="no_such_package_xyz"):
        thub.list(repo, source="local")
    with pytest.raises(FileNotFoundError):
        thub.list(str(tmp_path / "empty"), source="local")
