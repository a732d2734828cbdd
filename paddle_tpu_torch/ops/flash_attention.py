"""Flash attention, forward and backward: the hand-written CUDA kernels,
their plain PyTorch versions, and the ``torch.autograd.Function`` that
joins them.

Replaces the Pallas TPU kernels of ``paddle_tpu/ops/pallas_kernels.py``:
the streaming forward ``_fa_fwd_kernel`` (``_fa_call_fwd``) and its
VMEM-resident twin (``_fa_call_fwd_resident``), and the backward pairs
``_fa_dq_kernel``/``_fa_dkv_kernel`` (``_fa_call_bwd``,
``_fa_call_bwd_resident``). Two routes, each a forward kernel and a
backward pair (a dQ kernel and a dK/dV kernel), both hand-written:

- ``"tc"``, ``csrc/flash_attention_sm90.cu``: bfloat16 or float16 at
  head width 64 or 128 with 16-byte-aligned base pointers; products on
  the tensor cores (``wgmma``), tiles loaded by TMA;
- ``"cuda_core"``, ``csrc/flash_attention.cu``: everything else the
  wrappers take (float32; bfloat16 or float16 at any other width up to
  256 or an unaligned base); products on CUDA cores in f32.

:func:`flash_route` chooses from the operands, before the launch; a
failed launch raises and is never retried on the other route. The
sources say how the kernels are built and what bounds them.

Layout ``[B, S, H, D]`` (the framework's attention layout), read in
place by the kernels; the row log-sum-exp is ``[B, H, Sq]`` f32. Any
sequence length: ragged tails are masked, where the TPU kernels demanded
``S % block == 0``. ``D <= 256``.

:func:`flash_attention_fwd` and :func:`flash_attention_bwd` take the
plain versions only for tensors on the CPU. A CUDA tensor goes to a
kernel, or the call raises: there is no fallback. The forward is the
``torch.library`` custom op ``paddle_tpu_torch::flash_attention_fwd``
(its CPU kernel the plain version, its CUDA kernel the launch, a fake
giving ``o`` and the ``[B, H, Sq]`` float32 ``lse``), so that
``torch.export`` records it and a loaded graph launches it. Each counts its
kernel launches in ``.launches`` and, by route, in ``.tc_launches`` and
``.core_launches`` (the backward wrapper launches the dQ and dK/dV
kernels together and counts one).
"""
from __future__ import annotations

import ctypes
import math
from typing import Tuple

import torch

from . import _build

__all__ = ["flash_attention", "flash_attention_fwd", "flash_attention_bwd",
           "flash_attention_fwd_plain", "flash_attention_bwd_plain",
           "attention_delta", "flash_route", "flash_route_of", "MAX_HEAD_DIM",
           "TC_HEAD_DIMS", "TC_DTYPES"]

_NEG_INF = -1e30

#: widest head the kernels tile (their shared-memory budget)
MAX_HEAD_DIM = 256
#: head widths of the tensor-core route (one or two 128-byte column blocks)
TC_HEAD_DIMS = (64, 128)
#: operand dtypes of the tensor-core route (wgmma's 16-bit inputs)
TC_DTYPES = (torch.bfloat16, torch.float16)

def _scale(q, scale):
    return float(scale) if scale is not None else 1.0 / math.sqrt(q.shape[-1])


def _scores(q, k, causal, scale):
    """``(q . k) * scale`` in f32 as ``[B, H, Sq, Sk]``, masked to -1e30
    above the diagonal (``row >= col``, top-left aligned) when causal."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        sq, sk = s.shape[-2:]
        keep = torch.ones(sq, sk, dtype=torch.bool, device=s.device).tril()
        s = s.masked_fill(~keep, _NEG_INF)
    return s


def attention_delta(o, do):
    """``delta = rowsum(dO * O)`` in f32, ``[B, H, Sq]`` — the backward's
    per-row term (``_fa_call_bwd``'s ``delta``, without its lane
    replication)."""
    return (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()


def flash_attention_fwd_plain(q, k, v, causal=False, scale=None):
    """``(o, lse)`` of the forward kernel as a plain composition over the
    whole score matrix: P is rounded to V's dtype before the PV product
    and the normaliser is ``max(l, 1e-30)``, as in ``_fa_fwd_kernel``."""
    scale = _scale(q, scale)
    s = _scores(q, k, causal, scale)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l_safe = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    o = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), v.float())
    o = o / l_safe.transpose(1, 2)
    lse = (m + torch.log(l_safe))[..., 0]
    return o.to(q.dtype).contiguous(), lse


def flash_attention_bwd_plain(q, k, v, o, lse, do, causal=False, scale=None):
    """``(dq, dk, dv)`` of the backward pair as a plain composition: P is
    recomputed from the forward's ``lse``, dS is rounded to K's dtype for
    dQ and to Q's for dK, and P to dO's for dV (``_fa_dq_kernel``,
    ``_fa_dkv_kernel``)."""
    scale = _scale(q, scale)
    delta = attention_delta(o, do)
    p = torch.exp(_scores(q, k, causal, scale) - lse[..., None])
    dof = do.float()
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(do.dtype).float(), dof)
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, v.float())
    ds = p * (dp - delta[..., None]) * scale
    dq = torch.einsum("bhqk,bkhd->bqhd", ds.to(k.dtype).float(), k.float())
    dk = torch.einsum("bhqk,bqhd->bkhd", ds.to(q.dtype).float(), q.float())
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _check(q, k, v, *more):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash attention takes [B, S, H, D] q, k and v")
    b, _, h, d = q.shape
    if tuple(k.shape) != tuple(v.shape) or (k.shape[0], k.shape[2],
                                            k.shape[3]) != (b, h, d):
        raise ValueError(f"k {tuple(k.shape)} / v {tuple(v.shape)} do not "
                         f"fit q {tuple(q.shape)}")
    tensors = (q, k, v) + more
    if q.device.type != "cuda":
        raise ValueError(f"flash attention runs on cuda or cpu tensors, "
                         f"got {q.device}")
    if any(t.device != q.device for t in tensors):
        raise ValueError("flash attention operands must share a device")
    if q.dtype not in _build.DTYPE_CODE or any(t.dtype != q.dtype
                                         for t in (k, v) + more):
        raise TypeError(f"the flash attention kernels take float32, "
                        f"bfloat16 or float16 q, k, v (and dO) of one "
                        f"dtype, got "
                        f"{[t.dtype for t in (q, k, v) + more]}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("flash attention needs contiguous tensors")
    if not 1 <= d <= MAX_HEAD_DIM:
        raise ValueError(f"head_dim {d} outside the kernels' "
                         f"[1, {MAX_HEAD_DIM}]")
    if b * h > 65535:
        raise ValueError(f"batch * heads {b * h} exceeds the grid's 65535")


def flash_route(dtype, head_dim, aligned):
    """The route for operands of ``dtype`` and ``head_dim``, ``aligned``
    when every base pointer is 16-byte aligned: ``"tc"`` (the tensor-core
    kernels: bfloat16 or float16 at a width in ``TC_HEAD_DIMS``, tiles TMA
    can read) or ``"cuda_core"`` (everything else that ``_check``
    accepts)."""
    if dtype in TC_DTYPES and head_dim in TC_HEAD_DIMS and aligned:
        return "tc"
    return "cuda_core"


def flash_route_of(q, *operands):
    """:func:`flash_route` of q and the other operands a kernel reads
    through tensor maps (k, v, and dO for the backward)."""
    return flash_route(q.dtype, q.shape[-1],
                       all(t.data_ptr() % 16 == 0 for t in (q,) + operands))


def _count(wrapper, route):
    wrapper.launches += 1
    if route == "tc":
        wrapper.tc_launches += 1
    else:
        wrapper.core_launches += 1


_I, _P, _F = ctypes.c_int, ctypes.c_void_p, ctypes.c_float
# both routes' C entries: the dtype code, the pointers, the shapes, the
# scale, the causal flag and the stream
_FWD_ARGS = [_I] + [_P] * 5 + [_I] * 5 + [_F, _I, _P]
_BWD_ARGS = [_I] + [_P] * 9 + [_I] * 5 + [_F, _I, _P]


def flash_attention_fwd(q, k, v, causal=False, scale=None):
    """Forward kernel: ``(o [B, Sq, H, D] in q's dtype, lse [B, H, Sq]
    f32)``. The custom op ``paddle_tpu_torch::flash_attention_fwd``: a
    trace records the op and runs its fake, which launches nothing."""
    return torch.ops.paddle_tpu_torch.flash_attention_fwd(
        q, k, v, bool(causal), _scale(q, scale))


@torch.library.custom_op("paddle_tpu_torch::flash_attention_fwd",
                         mutates_args=(), device_types="cpu")
def _fwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
            scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    return flash_attention_fwd_plain(q, k, v, causal, scale)


@_fwd_op.register_kernel("cuda")
def _fwd_launch(q, k, v, causal, scale):
    _check(q, k, v)
    b, sq, h, d = q.shape
    o = torch.empty_like(q)
    lse = torch.empty(b, h, sq, dtype=torch.float32, device=q.device)
    if o.numel() == 0 or k.shape[1] == 0:
        return o.zero_(), lse.fill_(_NEG_INF)
    route = flash_route_of(q, k, v)
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), b, h, sq, k.shape[1], d, scale,
            int(causal), torch.cuda.current_stream(q.device).cuda_stream)
    lib, entry = (("flash_attention_sm90", "fa_tc_fwd_launch")
                  if route == "tc" else ("flash_attention", "fa_fwd_launch"))
    rc = _build.function(lib, entry, _FWD_ARGS)(_build.DTYPE_CODE[q.dtype],
                                                *args)
    if rc != 0:
        raise RuntimeError(f"flash attention forward kernel ({route} route) "
                           f"launch failed: CUDA error {rc}")
    _count(flash_attention_fwd, route)
    return o, lse


@_fwd_op.register_fake
def _fwd_fake(q, k, v, causal, scale):
    b, sq, h, _ = q.shape
    return (torch.empty_like(q),
            q.new_empty((b, h, sq), dtype=torch.float32))


def flash_attention_bwd(q, k, v, o, lse, do, causal=False, scale=None):
    """Backward kernel pair: ``(dq, dk, dv)`` in the dtypes of q, k, v.
    ``delta`` is a torch expression ahead of the launch."""
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, o, lse, do, causal, scale)
    _check(q, k, v, o, do)
    b, sq, h, d = q.shape
    if tuple(lse.shape) != (b, h, sq) or lse.dtype != torch.float32 \
            or not lse.is_contiguous():
        raise ValueError(f"lse must be contiguous f32 [{b}, {h}, {sq}]")
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    if dq.numel() == 0 or dk.numel() == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    delta = attention_delta(o, do)
    route = flash_route_of(q, k, v, do)
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), b, h, sq, k.shape[1], d, _scale(q, scale),
            int(bool(causal)), torch.cuda.current_stream(q.device).cuda_stream)
    lib, entry = (("flash_attention_sm90", "fa_tc_bwd_launch")
                  if route == "tc" else ("flash_attention", "fa_bwd_launch"))
    rc = _build.function(lib, entry, _BWD_ARGS)(_build.DTYPE_CODE[q.dtype],
                                                *args)
    if rc != 0:
        raise RuntimeError(f"flash attention backward kernels ({route} "
                           f"route) launch failed: CUDA error {rc}")
    _count(flash_attention_bwd, route)
    return dq, dk, dv


for _wrapper in (flash_attention_fwd, flash_attention_bwd):
    _wrapper.launches = _wrapper.tc_launches = _wrapper.core_launches = 0


class _FlashAttention(torch.autograd.Function):
    """Forward kernel with the backward pair as its gradient (the
    ``jax.custom_vjp`` of ``_flash_attention_bhsd``)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale):
        o, lse = flash_attention_fwd(q, k, v, causal, scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.scale = causal, scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do.contiguous(),
                                         ctx.causal, ctx.scale)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, is_causal=False, scale=None):
    """Flash attention on ``[B, S, H, D]`` q, k, v; differentiable through
    the backward kernels. ``scale`` defaults to ``1 / sqrt(D)``."""
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _FlashAttention.apply(q, k, v, bool(is_causal), scale)
    return flash_attention_fwd(q, k, v, bool(is_causal), scale)[0]
