"""``dataset.wmt16`` (counterpart of ``paddle_tpu/dataset/wmt16.py``) —
EN↔DE ACL2016 multimodal translation readers with on-demand vocab builds.

Dictionaries are built from the training split on first use and cached at
``DATA_HOME/wmt16/{lang}_{size}.dict``; samples are
(src_ids, trg_ids, trg_ids_next) with shared <s>/<e>/<unk> index layout.
"""
from __future__ import annotations

import os
import tarfile
from collections import defaultdict

from . import common

__all__ = ["train", "test", "validation", "get_dict", "fetch",
           "TOTAL_EN_WORDS", "TOTAL_DE_WORDS"]

START_MARK = "<s>"
END_MARK = "<e>"
UNK_MARK = "<unk>"

TOTAL_EN_WORDS = 11250
TOTAL_DE_WORDS = 19220


def _tar_path():
    return os.path.join(common.DATA_HOME, "wmt16", "wmt16.tar.gz")


def _open_tar():
    path = _tar_path()
    if not os.path.exists(path):
        raise RuntimeError(
            f"place the wmt16 tarball at {path} (nothing is fetched)")
    return tarfile.open(path)


def _build_dict(dict_size, save_path, lang):
    freq = defaultdict(int)
    col = 0 if lang == "en" else 1
    with _open_tar() as tar:
        for raw in tar.extractfile("wmt16/train"):
            cols = raw.decode().strip().split("\t")
            if len(cols) != 2:
                continue
            for w in cols[col].split():
                freq[w] += 1
    with open(save_path, "w") as f:
        f.write(f"{START_MARK}\n{END_MARK}\n{UNK_MARK}\n")
        for i, (word, _) in enumerate(
                sorted(freq.items(), key=lambda kv: kv[1], reverse=True)):
            if i + 3 == dict_size:
                break
            f.write(word + "\n")


def _load_dict(dict_size, lang, reverse=False):
    path = os.path.join(common.DATA_HOME, "wmt16",
                        f"{lang}_{dict_size}.dict")
    if not os.path.exists(path) or \
            sum(1 for _ in open(path, "rb")) != dict_size:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        _build_dict(dict_size, path, lang)
    out = {}
    with open(path) as f:
        for i, line in enumerate(f):
            if reverse:
                out[i] = line.strip()
            else:
                out[line.strip()] = i
    return out


def _clip_sizes(src_dict_size, trg_dict_size, src_lang):
    src_total = TOTAL_EN_WORDS if src_lang == "en" else TOTAL_DE_WORDS
    trg_total = TOTAL_DE_WORDS if src_lang == "en" else TOTAL_EN_WORDS
    return min(src_dict_size, src_total), min(trg_dict_size, trg_total)


def _reader_creator(file_name, src_dict_size, trg_dict_size, src_lang):
    if src_lang not in ("en", "de"):
        raise ValueError("src_lang must be 'en' or 'de'")
    src_dict_size, trg_dict_size = _clip_sizes(
        src_dict_size, trg_dict_size, src_lang)

    def reader():
        src_dict = _load_dict(src_dict_size, src_lang)
        trg_dict = _load_dict(trg_dict_size,
                              "de" if src_lang == "en" else "en")
        start_id, end_id, unk_id = (src_dict[START_MARK],
                                    src_dict[END_MARK],
                                    src_dict[UNK_MARK])
        src_col = 0 if src_lang == "en" else 1
        with _open_tar() as tar:
            for raw in tar.extractfile(file_name):
                cols = raw.decode().strip().split("\t")
                if len(cols) != 2:
                    continue
                src_ids = ([start_id]
                           + [src_dict.get(w, unk_id)
                              for w in cols[src_col].split()]
                           + [end_id])
                trg = [trg_dict.get(w, unk_id)
                       for w in cols[1 - src_col].split()]
                yield src_ids, [start_id] + trg, trg + [end_id]

    return reader


def train(src_dict_size, trg_dict_size, src_lang="en"):
    return _reader_creator("wmt16/train", src_dict_size, trg_dict_size,
                           src_lang)


def test(src_dict_size, trg_dict_size, src_lang="en"):
    return _reader_creator("wmt16/test", src_dict_size, trg_dict_size,
                           src_lang)


def validation(src_dict_size, trg_dict_size, src_lang="en"):
    return _reader_creator("wmt16/val", src_dict_size, trg_dict_size,
                           src_lang)


def get_dict(lang, dict_size, reverse=False):
    total = TOTAL_EN_WORDS if lang == "en" else TOTAL_DE_WORDS
    return _load_dict(min(dict_size, total), lang, reverse)


def fetch():
    """Parity shim: verify the tarball is in place (the reference
    pre-downloads here)."""
    _open_tar().close()
