"""Seeded random streams (counterpart of ``paddle_tpu/framework/random.py``).

The JAX package keeps a process-wide PRNG key that :func:`seed` resets;
random ops split keys from it. The port keeps explicit
``torch.Generator`` objects instead, one per device, all seeded from the
same :func:`seed`: parameter initialisation draws from the CPU generator
(so a model's weights do not depend on where it is moved afterwards),
dropout draws from the generator of the tensor's device. Neither touches
PyTorch's global generator.

The same seed does not give the JAX package's numbers: the two
frameworks' generators differ. Tests hand both the same weights.
"""
from __future__ import annotations

import threading

import numpy as np
import torch

__all__ = ["seed", "get_generator", "initial_seed"]

_lock = threading.Lock()
_seed = int(np.random.randint(0, 2 ** 31 - 1))
_generators = {}


def _key(device: torch.device):
    if device.type == "cuda" and device.index is None:
        return ("cuda", torch.cuda.current_device())
    return (device.type, device.index)


def seed(value: int) -> None:
    """Reseed every stream of the port: the next draw of each device's
    generator starts from ``value``."""
    global _seed
    with _lock:
        _seed = int(value) % (2 ** 63)
        _generators.clear()


def initial_seed() -> int:
    return _seed


def get_generator(device="cpu") -> torch.Generator:
    """The port's generator on ``device``, created at first use from the
    current seed."""
    device = torch.device(device)
    key = _key(device)
    with _lock:
        gen = _generators.get(key)
        if gen is None:
            gen = torch.Generator(device=device)
            gen.manual_seed(_seed)
            _generators[key] = gen
    return gen
