"""Fused AdamW update: the hand-written CUDA kernel and its plain PyTorch
version.

Replaces the Pallas TPU kernel ``paddle_tpu/ops/pallas_kernels.py``
(``_adamw_kernel`` via ``_fused_adamw_callable.run``/``fused_adamw``),
which the eager optimizer step launches once per parameter
(``Adam._maybe_fused``). The kernel is ``csrc/adamw.cu``: one
elementwise pass that updates p, m and v in place and may write the bf16
or f16 copy of an f32 master in the same pass; it is memory-bound. The source
says more.

:func:`fused_adamw_` takes the plain version only for tensors on the
CPU. A CUDA tensor goes to the kernel, or the call raises: there is no
fallback. ``fused_adamw_.launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

__all__ = ["fused_adamw_", "adamw_plain_", "bias_corrections"]

def bias_corrections(beta1, beta2, step):
    """``(1 - beta1**step, 1 - beta2**step)``, on the host as the TPU
    wrapper computes them."""
    return 1.0 - beta1 ** step, 1.0 - beta2 ** step


def adamw_plain_(p, g, m, v, lr, beta1, beta2, eps, weight_decay, step,
                 low=None):
    """The kernel's update as a plain composition with float32 scalars,
    in place on ``p``, ``m``, ``v`` (and ``low`` when given)."""
    bc1, bc2 = bias_corrections(beta1, beta2, step)
    lr, b1, b2, eps, wd, bc1, bc2 = torch.tensor(
        [lr, beta1, beta2, eps, weight_decay, bc1, bc2],
        dtype=torch.float32, device=p.device)
    gf = g.float()
    mi = b1 * m + (1.0 - b1) * gf
    vi = b2 * v + (1.0 - b2) * gf * gf
    pf = p.float()
    new_p = pf - lr * ((mi / bc1) / (torch.sqrt(vi / bc2) + eps) + wd * pf)
    m.copy_(mi)
    v.copy_(vi)
    p.copy_(new_p)
    if low is not None:
        low.copy_(new_p)


_ARGS = [ctypes.c_int] * 3 + [ctypes.c_void_p] * 5 + [
    ctypes.c_int64] + [ctypes.c_float] * 7 + [ctypes.c_void_p]

_LOW_DTYPES = (torch.bfloat16, torch.float16)


def fused_adamw_(p, g, m, v, lr, beta1, beta2, eps, weight_decay, step,
                 low=None):
    """AdamW on one parameter, in place: ``p`` (f32 master or parameter,
    or a bf16/f16 parameter), gradient ``g`` (f32, bf16 or f16 beside an
    f32 ``p``; of ``p``'s dtype beside a bf16 or f16 one), moments ``m``,
    ``v`` (f32), and ``low`` (bf16 or f16, optional, only with an f32
    ``p``) set to the updated ``p`` rounded down."""
    if p.device.type == "cpu":
        adamw_plain_(p, g, m, v, lr, beta1, beta2, eps, weight_decay, step,
                     low)
        return
    tensors = [p, g, m, v] + ([low] if low is not None else [])
    if p.device.type != "cuda":
        raise ValueError(f"fused_adamw_ runs on cuda or cpu tensors, got "
                         f"{p.device}")
    if any(t.device != p.device for t in tensors):
        raise ValueError("AdamW operands must share a device")
    if any(t.numel() != p.numel() for t in tensors):
        raise ValueError(f"AdamW operands differ in size: "
                         f"{[tuple(t.shape) for t in tensors]}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("fused_adamw_ needs contiguous tensors")
    if p.dtype not in _build.DTYPE_CODE or g.dtype not in _build.DTYPE_CODE:
        raise TypeError(f"the AdamW kernel takes float32, bfloat16 or "
                        f"float16 p and g, got {p.dtype} and {g.dtype}")
    if p.dtype != torch.float32 and g.dtype != p.dtype:
        name = str(p.dtype).removeprefix("torch.")
        raise TypeError(f"a {name} p takes a {name} g (the step casts the "
                        f"gradient to the parameter's dtype)")
    if m.dtype != torch.float32 or v.dtype != torch.float32:
        raise TypeError("the AdamW moments must be float32")
    if low is not None and (low.dtype not in _LOW_DTYPES
                            or p.dtype != torch.float32):
        raise TypeError("the low-precision copy must be bfloat16 or "
                        "float16, beside a float32 p")
    bc1, bc2 = bias_corrections(beta1, beta2, step)
    rc = _build.function("adamw", "adamw_launch", _ARGS)(
        _build.DTYPE_CODE[p.dtype], _build.DTYPE_CODE[g.dtype],
        0 if low is None else _build.DTYPE_CODE[low.dtype], p.data_ptr(),
        g.data_ptr(), m.data_ptr(), v.data_ptr(),
        None if low is None else low.data_ptr(), p.numel(), float(lr),
        float(beta1), float(beta2), float(eps), float(weight_decay),
        float(bc1), float(bc2),
        torch.cuda.current_stream(p.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"AdamW kernel launch failed: CUDA error {rc}")
    fused_adamw_.launches += 1


fused_adamw_.launches = 0
