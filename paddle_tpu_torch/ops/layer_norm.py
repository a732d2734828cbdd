"""Fused LayerNorm, forward and backward: the hand-written CUDA kernels,
their plain PyTorch versions, and the ``torch.autograd.Function`` that
joins them.

Replaces the Pallas TPU kernels of ``paddle_tpu/ops/pallas_kernels.py``:
``_ln_fwd_kernel`` (via ``_fused_layer_norm_2d``/``fused_layer_norm``),
which shadows the ``layer_norm`` op at ``ln_1``, ``ln_2`` and ``ln_f`` of
every GPT block, and ``_ln_bwd_kernel`` (via ``_ln_bwd_rule``), its
gradient with recomputed statistics. Both kernels have two routes in
``csrc/layer_norm.cu``, chosen by :func:`ln_route` before the launch:

- ``"warp"``: D <= :data:`WARP_MAX_D` that fills whole 16-byte vectors,
  with 16-byte-aligned bases. One warp owns a row, 16-byte loads and
  stores, warp-shuffle reductions; the backward keeps the next row's
  loads in flight while it reduces the current one, and a second kernel
  sums its CTAs' dw/db partials in an order fixed by the shapes;
- ``"row"``: everything else up to :data:`MAX_D` (odd widths, unaligned
  bases, wide rows). One CTA per row in the forward; per-CTA dw/db
  partials and a second, fixed-order reduction in the backward.

A contiguous view one element past its storage's start
(``buf[1:].view(shape)``) forces the row route on the card. The source
says what bounds each kernel and what its design does about it.

:func:`fused_layer_norm` and :func:`fused_layer_norm_bwd` take the plain
versions only for tensors on the CPU. A CUDA tensor goes to a kernel, or
the call raises: there is no fallback. ``.launches`` on each counts its
kernel launches, and ``.warp_launches``/``.row_launches`` count them by
route. :func:`layer_norm` is the differentiable entry: under autograd it
runs both kernels through ``_LayerNorm``; without it (the serving path)
it launches the forward alone.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

__all__ = ["layer_norm", "fused_layer_norm", "fused_layer_norm_bwd",
           "layer_norm_plain", "layer_norm_bwd_plain", "ln_route",
           "warp_bwd_grid", "MAX_D", "WARP_MAX_D"]

#: widest row the kernel holds in registers (1024 threads x 16 values)
MAX_D = 16384

#: most CTAs of the backward kernel, each with a [D] pair of dw/db
#: partials; fixed, so the reduction order depends on the shapes alone
BWD_MAX_PARTS = 512

#: widest row of the warp-row route (one warp holds it)
WARP_MAX_D = 2048

#: most CTAs of the warp-row backward
WARP_BWD_MAX_CTAS = 128

#: fewest rows a warp-row backward CTA takes, until the cap is reached
WARP_BWD_MIN_ROWS = 16


def ln_route(x, *operands):
    """The route of a LayerNorm kernel over ``x`` ``[..., D]`` and its other
    operands (weight, bias or grad, output): ``"warp"`` when D is at most
    :data:`WARP_MAX_D` and fills whole 16-byte vectors and every base
    pointer is 16-byte aligned, else ``"row"``."""
    d = x.shape[-1]
    if (d <= WARP_MAX_D and d * x.element_size() % 16 == 0
            and all(t.data_ptr() % 16 == 0 for t in (x,) + operands)):
        return "warp"
    return "row"


def warp_bwd_grid(rows: int):
    """``(ctas, rows_per_cta)`` of the warp-row backward: runs of
    ``rows_per_cta`` consecutive rows, the last one shorter, at most
    :data:`WARP_BWD_MAX_CTAS` of them. A function of the row count alone
    (never of the card), so the order of the dw/db sums is fixed by the
    shapes."""
    ctas = min(WARP_BWD_MAX_CTAS, -(-rows // WARP_BWD_MIN_ROWS))
    per = -(-rows // ctas)
    return -(-rows // per), per


def _count(wrapper, route):
    wrapper.launches += 1
    if route == "warp":
        wrapper.warp_launches += 1
    else:
        wrapper.row_launches += 1


def layer_norm_plain(x, weight, bias, epsilon: float = 1e-5):
    """LayerNorm over the last axis in f32, cast back to ``x``'s dtype —
    the arithmetic of ``_ln_fwd_kernel``, as a plain composition."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    xc = xf - mean
    var = (xc * xc).mean(dim=-1, keepdim=True)
    y = xc * torch.rsqrt(var + epsilon) * weight.float() + bias.float()
    return y.to(x.dtype)


def layer_norm_bwd_plain(x, weight, grad, epsilon: float = 1e-5):
    """``(dx, dw, db)`` of LayerNorm from ``x``, ``weight`` and the output
    gradient, with mean and rstd recomputed in f32 — the arithmetic of
    ``_ln_bwd_kernel``. dx in ``x``'s dtype, dw/db in ``weight``'s."""
    d = x.shape[-1]
    xf = x.float().reshape(-1, d)
    gf = grad.float().reshape(-1, d)
    mean = xf.mean(dim=-1, keepdim=True)
    xc = xf - mean
    rstd = torch.rsqrt((xc * xc).mean(dim=-1, keepdim=True) + epsilon)
    xhat = xc * rstd
    gw = gf * weight.float()
    m1 = gw.mean(dim=-1, keepdim=True)
    m2 = (gw * xhat).mean(dim=-1, keepdim=True)
    dx = (gw - m1 - xhat * m2) * rstd
    return (dx.reshape(x.shape).to(x.dtype),
            (gf * xhat).sum(dim=0).to(weight.dtype),
            gf.sum(dim=0).to(weight.dtype))


_FWD_ARGS = [ctypes.c_int] + [ctypes.c_void_p] * 4 + [
    ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p]
_BWD_ARGS = [ctypes.c_int] + [ctypes.c_void_p] * 7 + [
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
    ctypes.c_void_p]
_BWD_WARP_ARGS = [ctypes.c_int] + [ctypes.c_void_p] * 7 + [
    ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_void_p]


def _check(x, weight, *others):
    """Device, dtype, shape and contiguity checks of both kernels."""
    d = x.shape[-1]
    if x.device.type != "cuda":
        raise ValueError(f"the LayerNorm kernels run on cuda or cpu "
                         f"tensors, got {x.device}")
    if any(t.device != x.device for t in (weight,) + others):
        raise ValueError("LayerNorm operands must be on the same device")
    if x.dtype not in _build.DTYPE_CODE:
        raise TypeError(f"the LayerNorm kernels take float32, bfloat16 "
                        f"or float16, got {x.dtype}")
    if any(t.dtype != x.dtype for t in (weight,) + others):
        raise TypeError(f"weight/bias/grad dtypes "
                        f"{[t.dtype for t in (weight,) + others]} must "
                        f"match x's {x.dtype}")
    if not all(t.is_contiguous() for t in (x, weight) + others):
        raise ValueError("the LayerNorm kernels need contiguous tensors")
    if not 1 <= d <= MAX_D:
        raise ValueError(f"last axis {d} outside the kernel's [1, {MAX_D}]")


def _check_affine(x, weight, bias):
    d = x.shape[-1]
    if tuple(weight.shape) != (d,) or (bias is not None
                                       and tuple(bias.shape) != (d,)):
        raise ValueError(
            f"weight {tuple(weight.shape)} / bias "
            f"{None if bias is None else tuple(bias.shape)} must be [{d}] "
            f"to normalize the last axis of x {tuple(x.shape)}")


def fused_layer_norm(x, weight, bias, epsilon: float = 1e-5):
    """LayerNorm over the last axis of ``x`` with affine ``weight`` and
    ``bias`` (both ``[D]``). Any number of rows; output in ``x``'s
    dtype."""
    _check_affine(x, weight, bias)
    if x.device.type == "cpu":
        return layer_norm_plain(x, weight, bias, epsilon)
    _check(x, weight, bias)
    d = x.shape[-1]
    out = torch.empty_like(x)
    rows = x.numel() // d
    if rows == 0:
        return out
    route = ln_route(x, weight, bias, out)
    symbol = "ln_fwd_warp_launch" if route == "warp" else "ln_fwd_launch"
    rc = _build.function("layer_norm", symbol, _FWD_ARGS)(
        _build.DTYPE_CODE[x.dtype], x.data_ptr(), weight.data_ptr(),
        bias.data_ptr(), out.data_ptr(), rows, d, float(epsilon),
        torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"LayerNorm kernel launch failed ({route} route): "
                           f"CUDA error {rc}")
    _count(fused_layer_norm, route)
    return out


fused_layer_norm.launches = 0
fused_layer_norm.warp_launches = 0
fused_layer_norm.row_launches = 0


def fused_layer_norm_bwd(x, weight, grad, epsilon: float = 1e-5):
    """LayerNorm backward: ``(dx, dw, db)`` from ``x``, ``weight`` and the
    output gradient ``grad`` (like ``x``). dw/db are deterministic: the
    per-CTA partials are summed in an order fixed by the shapes, never
    atomically."""
    _check_affine(x, weight, None)
    if tuple(grad.shape) != tuple(x.shape):
        raise ValueError(f"grad {tuple(grad.shape)} must be shaped like x "
                         f"{tuple(x.shape)}")
    if x.device.type == "cpu":
        return layer_norm_bwd_plain(x, weight, grad, epsilon)
    _check(x, weight, grad)
    d = x.shape[-1]
    rows = x.numel() // d
    dx = torch.empty_like(x)
    dw, db = torch.empty_like(weight), torch.empty_like(weight)
    if rows == 0:
        return dx, dw.zero_(), db.zero_()
    route = ln_route(x, weight, grad, dx)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    code, ptrs = _build.DTYPE_CODE[x.dtype], (
        x.data_ptr(), weight.data_ptr(), grad.data_ptr(), dx.data_ptr(),
        dw.data_ptr(), db.data_ptr())
    if route == "warp":
        grid = warp_bwd_grid(rows)
        fn = _build.function("layer_norm", "ln_bwd_warp_launch",
                             _BWD_WARP_ARGS)
    else:
        grid = (min(rows, BWD_MAX_PARTS),)
        fn = _build.function("layer_norm", "ln_bwd_launch", _BWD_ARGS)
    work = torch.empty(2 * grid[0] * d, dtype=torch.float32, device=x.device)
    rc = fn(code, *ptrs, work.data_ptr(), rows, d, *grid, float(epsilon),
            stream)
    if rc != 0:
        raise RuntimeError(f"LayerNorm backward kernel launch failed "
                           f"({route} route): CUDA error {rc}")
    _count(fused_layer_norm_bwd, route)
    return dx, dw, db


fused_layer_norm_bwd.launches = 0
fused_layer_norm_bwd.warp_launches = 0
fused_layer_norm_bwd.row_launches = 0


class _LayerNorm(torch.autograd.Function):
    """Forward kernel with the backward kernel as its gradient (the
    ``jax.custom_vjp`` of ``_fused_layer_norm_2d``)."""

    @staticmethod
    def forward(ctx, x, weight, bias, epsilon):
        ctx.save_for_backward(x, weight)
        ctx.epsilon = epsilon
        return fused_layer_norm(x, weight, bias, epsilon)

    @staticmethod
    def backward(ctx, grad):
        x, weight = ctx.saved_tensors
        dx, dw, db = fused_layer_norm_bwd(x, weight, grad.contiguous(),
                                          ctx.epsilon)
        return dx, dw, db, None


def layer_norm(x, weight, bias, epsilon: float = 1e-5):
    """Differentiable fused LayerNorm over the last axis: the forward
    kernel, and the backward kernel as its gradient when autograd
    records the call."""
    x = x.contiguous()
    if torch.is_grad_enabled() and (x.requires_grad or weight.requires_grad
                                    or bias.requires_grad):
        return _LayerNorm.apply(x, weight, bias, float(epsilon))
    return fused_layer_norm(x, weight, bias, epsilon)
