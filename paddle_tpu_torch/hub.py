"""``hub`` (counterpart of ``paddle_tpu/hub.py``): list, document and
load the entry points of a ``hubconf.py``. ``source="local"`` and
``"file"`` read a directory; ``"github"`` raises, as in the JAX package,
since the package fetches nothing.
"""
from __future__ import annotations

import importlib.util
import os
import sys

__all__ = ["list", "help", "load"]

_HUBCONF = "hubconf.py"


def _check_dependencies(mod):
    """A hubconf may declare ``dependencies = ["pkg", ...]``; fail fast
    with the full missing list before any entrypoint runs (reference
    hapi/hub.py:158)."""
    deps = getattr(mod, "dependencies", None)
    if not deps:
        return
    missing = []
    for pkg in deps:
        try:
            found = importlib.util.find_spec(pkg) is not None
        except (ModuleNotFoundError, ValueError):
            # dotted names raise when the parent is absent; a stale
            # sys.modules entry with __spec__=None raises ValueError —
            # both mean "not usable", which is what we are reporting
            found = False
        if not found:
            missing.append(pkg)
    if missing:
        raise RuntimeError("Missing dependencies: " + ", ".join(missing))


def _load_hubconf(repo_dir):
    path = os.path.join(repo_dir, _HUBCONF)
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no {_HUBCONF} found under {repo_dir}")
    spec = importlib.util.spec_from_file_location(
        "paddle_tpu_torch_hubconf", path)
    mod = importlib.util.module_from_spec(spec)
    sys.path.insert(0, repo_dir)
    try:
        spec.loader.exec_module(mod)
    finally:
        sys.path.remove(repo_dir)
    _check_dependencies(mod)
    return mod


def _resolve(repo_dir, source):
    if source in ("local", "file"):
        return repo_dir
    if source == "github":
        raise RuntimeError(
            "paddle.hub github source requires network access; clone the "
            "repo and use source='local'")
    raise ValueError(f"unknown source {source!r} (local/file/github)")


def list(repo_dir, source="github", force_reload=False):
    mod = _load_hubconf(_resolve(repo_dir, source))
    return [n for n in dir(mod)
            if callable(getattr(mod, n)) and not n.startswith("_")]


def help(repo_dir, model, source="github", force_reload=False):
    mod = _load_hubconf(_resolve(repo_dir, source))
    fn = getattr(mod, model, None)
    if fn is None:
        raise ValueError(f"model {model!r} not found in {_HUBCONF}")
    return fn.__doc__


def load(repo_dir, model, source="github", force_reload=False, **kwargs):
    mod = _load_hubconf(_resolve(repo_dir, source))
    fn = getattr(mod, model, None)
    if fn is None:
        raise ValueError(f"model {model!r} not found in {_HUBCONF}")
    return fn(**kwargs)
