"""``dataset.conll05`` (counterpart of ``paddle_tpu/dataset/conll05.py``) —
CoNLL-2005 semantic-role-labeling test-split readers.

Sample format (reference parity): 9 parallel sequences
(word, ctx_n2, ctx_n1, ctx_0, ctx_p1, ctx_p2, predicate, mark, label) —
the five ctx features are the predicate's +/-2 context window broadcast
over the sentence, ``mark`` flags the window positions.
"""
from __future__ import annotations

import gzip
import os
import tarfile

from . import common

__all__ = ["get_dict", "get_embedding", "test", "UNK_IDX"]

UNK_IDX = 0

_WORDDICT = "conll05st-release/test.wsj/words/test.wsj.words.gz"
_PROPS = "conll05st-release/test.wsj/props/test.wsj.props.gz"


def _tar_path():
    return os.path.join(common.DATA_HOME, "conll05st",
                        "conll05st-tests.tar.gz")


def _aux_path(name):
    return os.path.join(common.DATA_HOME, "conll05st", name)


def _open_tar():
    path = _tar_path()
    if not os.path.exists(path):
        raise RuntimeError(
            f"place conll05st-tests.tar.gz at {path} (nothing is fetched)")
    return tarfile.open(path)


def _load_dict_file(path):
    if not os.path.exists(path):
        raise RuntimeError(
            f"place the conll05 dict file at {path} (nothing is fetched)")
    out = {}
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        for i, line in enumerate(f):
            out[line.strip()] = i
    return out


def load_label_dict(filename):
    """Expand the B-/I- tag inventory from the label list file."""
    out = {}
    idx = 0
    with open(filename) as f:
        for line in f:
            tag = line.strip()
            if tag.startswith("B-"):
                out[tag] = idx
                out["I-" + tag[2:]] = idx + 1
                idx += 2
            elif tag == "O":
                out[tag] = idx
                idx += 1
    return out


def load_dict(filename):
    return _load_dict_file(filename)


def _sentences():
    """Yield (words, per-predicate prop columns) per sentence."""
    with _open_tar() as tar:
        wf = gzip.GzipFile(fileobj=tar.extractfile(_WORDDICT))
        pf = gzip.GzipFile(fileobj=tar.extractfile(_PROPS))
        words, rows = [], []
        for wline, pline in zip(wf, pf):
            word = wline.decode().strip()
            cols = pline.decode().strip().split()
            if not cols:  # blank line = sentence boundary
                if words:
                    yield words, rows
                words, rows = [], []
            else:
                words.append(word)
                rows.append(cols)
        if words:
            yield words, rows


def _spans_to_bio(col):
    """One props column ('(A0*', '*', '*)', '(V*)', …) -> BIO tags."""
    tags = []
    cur, inside = "O", False
    for cell in col:
        if cell == "*":
            tags.append("I-" + cur if inside else "O")
        elif cell == "*)":
            tags.append("I-" + cur)
            inside = False
        elif "(" in cell and ")" in cell:
            cur = cell[1:cell.index("*")]
            tags.append("B-" + cur)
            inside = False
        elif "(" in cell:
            cur = cell[1:cell.index("*")]
            tags.append("B-" + cur)
            inside = True
        else:
            raise RuntimeError(f"unexpected props cell {cell!r}")
    return tags


def corpus_reader(data_path=None, words_name=None, props_name=None):
    """Yield (sentence_words, predicate, bio_labels) per predicate."""

    def reader():
        for words, rows in _sentences():
            n_preds = len(rows[0]) - 1
            verbs = [r[0] for r in rows if r[0] != "-"]
            for k in range(n_preds):
                col = [r[k + 1] for r in rows]
                yield words, verbs[k], _spans_to_bio(col)

    return reader


def reader_creator(corpus_rdr, word_dict=None, predicate_dict=None,
                   label_dict=None):
    def reader():
        for sentence, predicate, labels in corpus_rdr():
            n = len(sentence)
            v = labels.index("B-V")
            mark = [0] * n

            def ctx(offset, fallback):
                i = v + offset
                if 0 <= i < n:
                    mark[i] = 1
                    return sentence[i]
                return fallback

            ctx_n2 = ctx(-2, "bos")
            ctx_n1 = ctx(-1, "bos")
            ctx_0 = ctx(0, "bos")
            ctx_p1 = ctx(1, "eos")
            ctx_p2 = ctx(2, "eos")

            word_idx = [word_dict.get(w, UNK_IDX) for w in sentence]
            broadcast = [
                [word_dict.get(c, UNK_IDX)] * n
                for c in (ctx_n2, ctx_n1, ctx_0, ctx_p1, ctx_p2)]
            pred_idx = [predicate_dict[predicate]] * n
            label_idx = [label_dict[t] for t in labels]
            yield (word_idx, *broadcast, pred_idx, mark, label_idx)

    return reader


def get_dict():
    """(word_dict, verb_dict, label_dict) from the companion dict files
    placed next to the test tarball."""
    word_dict = _load_dict_file(_aux_path("wordDict.txt"))
    verb_dict = _load_dict_file(_aux_path("verbDict.txt"))
    label_dict = load_label_dict(_aux_path("targetDict.txt"))
    return word_dict, verb_dict, label_dict


def get_embedding():
    """Path of the pre-trained word-embedding file (reference returns the
    downloaded emb file)."""
    path = _aux_path("emb")
    if not os.path.exists(path):
        raise RuntimeError(
            f"place the conll05 embedding file at {path} "
            "(nothing is fetched)")
    return path


def test():
    word_dict, verb_dict, label_dict = get_dict()
    return reader_creator(corpus_reader(), word_dict, verb_dict,
                          label_dict)
