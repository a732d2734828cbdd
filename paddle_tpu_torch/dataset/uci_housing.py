"""``dataset.uci_housing`` (counterpart of
``paddle_tpu/dataset/uci_housing.py``) — 13-feature Boston housing
regression; the canonical fit_a_line smoke dataset."""
from __future__ import annotations

import os

import numpy as np

from . import common

__all__ = ["train", "test", "feature_names"]

feature_names = ["CRIM", "ZN", "INDUS", "CHAS", "NOX", "RM", "AGE", "DIS",
                 "RAD", "TAX", "PTRATIO", "B", "LSTAT"]

_TRAIN_RATIO = 0.8


def _load():
    path = os.path.join(common.DATA_HOME, "uci_housing", "housing.data")
    if not os.path.exists(path):
        raise RuntimeError(
            f"place the UCI housing data at {path} (nothing is fetched)")
    data = np.loadtxt(path)
    feats = data[:, :-1]
    # per-feature max/min normalization against train stats (reference)
    n_train = int(len(data) * _TRAIN_RATIO)
    mx = feats[:n_train].max(axis=0)
    mn = feats[:n_train].min(axis=0)
    avg = feats[:n_train].mean(axis=0)
    feats = (feats - avg) / np.maximum(mx - mn, 1e-6)
    return np.concatenate([feats, data[:, -1:]], axis=1), n_train


def train():
    def reader():
        data, n_train = _load()
        for row in data[:n_train]:
            yield row[:-1].astype(np.float32), row[-1:].astype(np.float32)

    return reader


def test():
    def reader():
        data, n_train = _load()
        for row in data[n_train:]:
            yield row[:-1].astype(np.float32), row[-1:].astype(np.float32)

    return reader
