"""``incubate.autotune`` (counterpart of
``paddle_tpu/incubate/autotune.py``): the kernel, layout and dataloader
autotuning switches.

The port has one route to each kernel on the card and no switch that
sends the card to the plain versions, so ``{"kernel": {"enable":
False}}`` raises, and ``stats()``/``tune_attention``, which read the
JAX package's shape-class cache of measured kernel choices
(``ops/autotune_cache``), raise too: both wait on ROADMAP Queue 1 item 5,
step 8. The other settings are recorded, as the JAX package records its
layout switch.
"""
from __future__ import annotations

import json

from ..ops.registry import not_ported

__all__ = ["set_config", "stats", "tune_attention"]

_CONFIG = {
    "kernel": {"enable": True, "tuning_range": [1, 10]},
    "layout": {"enable": False},
    "dataloader": {"enable": False, "tuning_steps": 500},
}

_STEP_8 = "5, step 8"


def set_config(config=None):
    """Takes a dict or a path to a JSON file; returns the settings."""
    if config is None:
        config = {}
    if isinstance(config, str):
        with open(config) as f:
            config = json.load(f)
    bad = [k for k in config if k not in _CONFIG]
    if bad:
        raise ValueError(f"unknown autotune domain(s) {bad} "
                         f"(kernel/layout/dataloader)")
    if not config.get("kernel", {}).get("enable", True):
        raise not_ported("autotune kernel.enable=False (the card has no "
                         "switch to the plain versions)", _STEP_8)
    for key, val in config.items():
        _CONFIG[key].update(val)
    return dict(_CONFIG)


def stats():
    raise not_ported("autotune.stats (ops/autotune_cache)", _STEP_8)


def tune_attention(q, k, v, is_causal=False, **kwargs):
    raise not_ported("autotune.tune_attention (ops/autotune_cache)",
                     _STEP_8)
