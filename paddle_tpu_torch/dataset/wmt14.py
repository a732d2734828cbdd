"""``dataset.wmt14`` (counterpart of ``paddle_tpu/dataset/wmt14.py``) —
EN→FR translation readers over the preprocessed wmt14 tarball.

Sample format (reference parity): (src_ids, trg_ids, trg_ids_next) with
<s>/<e> wrapping on the source, <s>-prefixed target input and <e>-suffixed
target output; training pairs longer than 80 tokens are dropped.
"""
from __future__ import annotations

import os
import tarfile

from . import common

__all__ = ["train", "test", "get_dict", "START", "END", "UNK", "UNK_IDX"]

START = "<s>"
END = "<e>"
UNK = "<unk>"
UNK_IDX = 2

_MAX_LEN = 80


def _tar_path():
    return os.path.join(common.DATA_HOME, "wmt14", "wmt14.tgz")


def _open_tar():
    path = _tar_path()
    if not os.path.exists(path):
        raise RuntimeError(
            f"place the preprocessed wmt14 tarball at {path} "
            "(nothing is fetched)")
    return tarfile.open(path)


def _dict_from_member(tar, suffix, dict_size):
    names = [m.name for m in tar if m.name.endswith(suffix)]
    assert len(names) == 1, f"expected one {suffix} in the archive"
    out = {}
    for i, line in enumerate(tar.extractfile(names[0])):
        if i >= dict_size:
            break
        out[line.decode().strip()] = i
    return out


def _load_dicts(dict_size):
    with _open_tar() as tar:
        return (_dict_from_member(tar, "src.dict", dict_size),
                _dict_from_member(tar, "trg.dict", dict_size))


def _reader_creator(file_suffix, dict_size):
    def reader():
        src_dict, trg_dict = _load_dicts(dict_size)
        with _open_tar() as tar:
            names = [m.name for m in tar if m.name.endswith(file_suffix)]
            for name in names:
                for raw in tar.extractfile(name):
                    cols = raw.decode().strip().split("\t")
                    if len(cols) != 2:
                        continue
                    src_ids = [src_dict.get(w, UNK_IDX)
                               for w in [START] + cols[0].split() + [END]]
                    trg = [trg_dict.get(w, UNK_IDX)
                           for w in cols[1].split()]
                    if len(src_ids) > _MAX_LEN or len(trg) > _MAX_LEN:
                        continue
                    yield (src_ids, [trg_dict[START]] + trg,
                           trg + [trg_dict[END]])

    return reader


def train(dict_size):
    return _reader_creator("train/train", dict_size)


def test(dict_size):
    return _reader_creator("test/test", dict_size)


def gen(dict_size):
    return _reader_creator("gen/gen", dict_size)


def get_dict(dict_size, reverse=True):
    """Returns (src, trg) dicts; ``reverse`` gives idx->word maps."""
    src_dict, trg_dict = _load_dicts(dict_size)
    if reverse:
        src_dict = {v: k for k, v in src_dict.items()}
        trg_dict = {v: k for k, v in trg_dict.items()}
    return src_dict, trg_dict
