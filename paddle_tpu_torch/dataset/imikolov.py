"""``dataset.imikolov`` (counterpart of ``paddle_tpu/dataset/imikolov.py``) —
PTB language-model n-gram readers over a local simple-examples tarball."""
from __future__ import annotations

import os
import tarfile

from . import common

__all__ = ["build_dict", "train", "test", "NGRAM", "SEQ"]

NGRAM = "ngram"
SEQ = "seq"


def _tar_path():
    return os.path.join(common.DATA_HOME, "imikolov",
                        "simple-examples.tgz")


def _lines(split):
    path = _tar_path()
    if not os.path.exists(path):
        raise RuntimeError(
            f"place simple-examples.tgz at {path} (nothing is fetched)")
    name = f"./simple-examples/data/ptb.{split}.txt"
    with tarfile.open(path) as tarf:
        f = tarf.extractfile(name)
        for line in f:
            yield line.decode().strip().split()


def build_dict(min_word_freq=50):
    freq = {}
    for words in _lines("train"):
        for w in words:
            freq[w] = freq.get(w, 0) + 1
    freq.pop("<unk>", None)
    freq = {w: f for w, f in freq.items() if f > min_word_freq}
    items = sorted(freq.items(), key=lambda x: (-x[1], x[0]))
    word_idx = {w: i for i, (w, _) in enumerate(items)}
    word_idx["<unk>"] = len(word_idx)
    return word_idx


def _reader_creator(split, word_idx, n, data_type):
    def reader():
        unk = word_idx["<unk>"]
        for words in _lines(split):
            if data_type == NGRAM:
                assert n > -1, "Invalid gram length"
                toks = ["<s>"] + words + ["<e>"]
                ids = [word_idx.get(w, unk) for w in toks]
                for i in range(n, len(ids) + 1):
                    yield tuple(ids[i - n:i])
            else:
                ids = [word_idx.get(w, unk)
                       for w in ["<s>"] + words + ["<e>"]]
                yield ids[:-1], ids[1:]

    return reader


def train(word_idx, n, data_type=NGRAM):
    return _reader_creator("train", word_idx, n, data_type)


def test(word_idx, n, data_type=NGRAM):
    return _reader_creator("test", word_idx, n, data_type)
