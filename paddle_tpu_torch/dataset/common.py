"""Shared dataset plumbing (counterpart of
``paddle_tpu/dataset/common.py``)."""
from __future__ import annotations

import hashlib
import os

__all__ = ["DATA_HOME", "md5file", "download", "cluster_files_reader"]

DATA_HOME = os.path.expanduser(
    os.environ.get("PADDLE_DATA_HOME", "~/.cache/paddle/dataset"))


def md5file(fname):
    h = hashlib.md5()
    with open(fname, "rb") as f:
        for chunk in iter(lambda: f.read(4096), b""):
            h.update(chunk)
    return h.hexdigest()


def download(url, module_name, md5sum, save_name=None):
    """The file under ``DATA_HOME/module_name`` (checked against
    ``md5sum`` when one is given); the package fetches nothing, so a
    missing file raises, naming the path to place it at."""
    dirname = os.path.join(DATA_HOME, module_name)
    filename = os.path.join(
        dirname, save_name if save_name else url.split("/")[-1])
    if os.path.exists(filename):
        if not md5sum or md5file(filename) == md5sum:
            return filename
        raise RuntimeError(f"{filename} exists but fails md5 check")
    raise RuntimeError(
        f"cannot download {url}: nothing is fetched; place the file at "
        f"{filename}")


def cluster_files_reader(files_pattern, trainer_count, trainer_id,
                         loader=None):
    import glob

    def reader():
        flist = sorted(glob.glob(files_pattern))
        my = flist[trainer_id::trainer_count]
        for fn in my:
            if loader is None:
                with open(fn, "rb") as f:
                    yield f.read()
            else:
                yield from loader(fn)

    return reader
