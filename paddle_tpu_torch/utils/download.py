"""Local resolution of the reference's download paths (counterpart of
``paddle_tpu/utils/download.py``). Nothing downloads: a URL resolves to
its file name in the cache directory, and a missing file raises with
where to put it. Archives there (``.tar.gz``, ``.tgz``, ``.zip``) are
unpacked beside themselves, once."""
from __future__ import annotations

import hashlib
import os
import os.path as osp

__all__ = ["get_weights_path_from_url", "get_path_from_url"]

WEIGHTS_HOME = osp.expanduser(
    os.environ.get("PADDLE_WEIGHTS_HOME", "~/.cache/paddle/hapi/weights"))


def _md5file(fname):
    h = hashlib.md5()
    with open(fname, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 16), b""):
            h.update(chunk)
    return h.hexdigest()


def _resolve(url: str, root_dir: str, md5sum=None):
    fname = osp.join(root_dir, url.split("/")[-1])
    if osp.exists(fname):
        if md5sum and _md5file(fname) != md5sum:
            raise RuntimeError(f"{fname} exists but fails md5 check")
        return fname
    raise RuntimeError(
        f"cannot download {url} (no network egress); place the file at "
        f"{fname}")


def get_weights_path_from_url(url: str, md5sum=None) -> str:
    return _resolve(url, WEIGHTS_HOME, md5sum)


def _safe_extract_zip(path, dst):
    import zipfile
    base = osp.realpath(dst)
    with zipfile.ZipFile(path) as z:
        for name in z.namelist():   # no member may leave the directory
            target = osp.realpath(osp.join(dst, name))
            if not (target == base or target.startswith(base + os.sep)):
                raise RuntimeError(f"unsafe zip member path: {name!r}")
        z.extractall(dst)


def get_path_from_url(url: str, root_dir: str, md5sum=None,
                      check_exist: bool = True, decompress: bool = True,
                      method: str = "get") -> str:
    path = _resolve(url, root_dir, md5sum)
    for suffix in (".tar.gz", ".tgz", ".zip"):
        if not (decompress and path.endswith(suffix)):
            continue
        extracted = path[: -len(suffix)]
        # a marker written after extraction says the tree is current
        # (members keep the archive's mtimes)
        marker = path + ".extracted"
        if check_exist and osp.exists(extracted) and osp.exists(marker) \
                and osp.getmtime(marker) >= osp.getmtime(path):
            return extracted
        dst = osp.dirname(path)
        if suffix == ".zip":
            _safe_extract_zip(path, dst)
        else:
            import tarfile
            with tarfile.open(path) as t:
                t.extractall(dst, filter="data")
        with open(marker, "w") as f:
            f.write("ok")
        return extracted if osp.exists(extracted) else path
    return path
