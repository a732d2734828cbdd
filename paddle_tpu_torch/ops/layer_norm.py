"""Fused LayerNorm forward: the hand-written CUDA kernel and its plain
PyTorch version.

Replaces the Pallas TPU kernel ``paddle_tpu/ops/pallas_kernels.py``
(``_ln_fwd_kernel`` via ``_fused_layer_norm_2d``/``fused_layer_norm``),
which shadows the ``layer_norm`` op at ``ln_1``, ``ln_2`` and ``ln_f`` of
every GPT block on the serving path. The kernel is
``csrc/layer_norm.cu``: one CTA per row, the row held in registers, f32
statistics; it is memory-bound (``2 * rows * D + 2 * D`` elements
moved). The source says more.

:func:`fused_layer_norm` takes the plain version only for tensors on the
CPU. A CUDA tensor goes to the kernel, or the call raises: there is no
fallback. ``fused_layer_norm.launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

__all__ = ["fused_layer_norm", "layer_norm_plain", "MAX_D"]

#: widest row the kernel holds in registers (1024 threads x 16 values)
MAX_D = 16384

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def layer_norm_plain(x, weight, bias, epsilon: float = 1e-5):
    """LayerNorm over the last axis in f32, cast back to ``x``'s dtype —
    the arithmetic of ``_ln_fwd_kernel``, as a plain composition."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    xc = xf - mean
    var = (xc * xc).mean(dim=-1, keepdim=True)
    y = xc * torch.rsqrt(var + epsilon) * weight.float() + bias.float()
    return y.to(x.dtype)


def _lib():
    lib = _build.load("layer_norm")
    fn = lib.ln_fwd_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 4 + [
            ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def fused_layer_norm(x, weight, bias, epsilon: float = 1e-5):
    """LayerNorm over the last axis of ``x`` with affine ``weight`` and
    ``bias`` (both ``[D]``). Any number of rows; output in ``x``'s
    dtype."""
    d = x.shape[-1]
    if tuple(weight.shape) != (d,) or tuple(bias.shape) != (d,):
        raise ValueError(
            f"weight {tuple(weight.shape)} / bias {tuple(bias.shape)} must "
            f"be [{d}] to normalize the last axis of x {tuple(x.shape)}")
    if x.device.type == "cpu":
        return layer_norm_plain(x, weight, bias, epsilon)
    if x.device.type != "cuda":
        raise ValueError(f"fused_layer_norm runs on cuda or cpu tensors, "
                         f"got {x.device}")
    if weight.device != x.device or bias.device != x.device:
        raise ValueError("x, weight and bias must be on the same device")
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"the LayerNorm kernel takes float32 or bfloat16, "
                        f"got {x.dtype}")
    if weight.dtype != x.dtype or bias.dtype != x.dtype:
        raise TypeError(f"weight/bias dtype {weight.dtype}/{bias.dtype} "
                        f"must match x's {x.dtype}")
    if not (x.is_contiguous() and weight.is_contiguous()
            and bias.is_contiguous()):
        raise ValueError("fused_layer_norm needs contiguous tensors")
    if not 1 <= d <= MAX_D:
        raise ValueError(f"last axis {d} outside the kernel's [1, {MAX_D}]")
    out = torch.empty_like(x)
    rows = x.numel() // d
    if rows == 0:
        return out
    rc = _lib()(_DTYPE_CODE[x.dtype], x.data_ptr(), weight.data_ptr(),
                bias.data_ptr(), out.data_ptr(), rows, d, float(epsilon),
                torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"LayerNorm kernel launch failed: CUDA error {rc}")
    fused_layer_norm.launches += 1
    return out


fused_layer_norm.launches = 0
