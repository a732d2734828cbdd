"""``dataset.imdb`` (counterpart of ``paddle_tpu/dataset/imdb.py``) —
tokenized IMDB sentiment readers over a local aclImdb tarball."""
from __future__ import annotations

import os
import re
import string
import tarfile

from . import common

__all__ = ["build_dict", "train", "test", "word_dict"]


def _tar_path():
    return os.path.join(common.DATA_HOME, "imdb", "aclImdb_v1.tar.gz")


def tokenize(pattern):
    path = _tar_path()
    if not os.path.exists(path):
        raise RuntimeError(
            f"place aclImdb_v1.tar.gz at {path} (nothing is fetched)")
    with tarfile.open(path) as tarf:
        tf = tarf.next()
        while tf is not None:
            if bool(pattern.match(tf.name)):
                data = tarf.extractfile(tf).read().decode("latin-1")
                yield data.lower().translate(
                    str.maketrans("", "", string.punctuation)).split()
            tf = tarf.next()


def build_dict(pattern, cutoff):
    word_freq = {}
    for doc in tokenize(pattern):
        for w in doc:
            word_freq[w] = word_freq.get(w, 0) + 1
    word_freq = {w: f for w, f in word_freq.items() if f > cutoff}
    dictionary = sorted(word_freq.items(), key=lambda x: (-x[1], x[0]))
    words, _ = list(zip(*dictionary)) if dictionary else ((), ())
    word_idx = dict(zip(words, range(len(words))))
    word_idx["<unk>"] = len(words)
    return word_idx


def _reader_creator(re_pos, re_neg, word_idx):
    unk = word_idx["<unk>"]

    def reader():
        for doc in tokenize(re_pos):
            yield [word_idx.get(w, unk) for w in doc], 0
        for doc in tokenize(re_neg):
            yield [word_idx.get(w, unk) for w in doc], 1

    return reader


def train(word_idx):
    return _reader_creator(
        re.compile(r"aclImdb/train/pos/.*\.txt$"),
        re.compile(r"aclImdb/train/neg/.*\.txt$"), word_idx)


def test(word_idx):
    return _reader_creator(
        re.compile(r"aclImdb/test/pos/.*\.txt$"),
        re.compile(r"aclImdb/test/neg/.*\.txt$"), word_idx)


def word_dict(cutoff=150):
    return build_dict(re.compile(r"aclImdb/((train)|(test))/((pos)|(neg))/.*\.txt$"),
                      cutoff)
