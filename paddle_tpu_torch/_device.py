"""Device resolution shared by the port's entry points: they run on the
card unless the caller asks for the CPU."""
from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device=None) -> torch.device:
    """``None`` means ``"cuda"``; without a CUDA device that raises
    instead of quietly running on the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available: paddle_tpu_torch runs on the "
                "card by default; pass device=\"cpu\" to run on the CPU")
        return torch.device("cuda")
    return torch.device(device)
