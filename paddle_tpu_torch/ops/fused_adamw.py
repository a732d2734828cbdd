"""Fused AdamW update: the hand-written CUDA kernel and its plain PyTorch
version.

Replaces the Pallas TPU kernel ``paddle_tpu/ops/pallas_kernels.py``
(``_adamw_kernel`` via ``_fused_adamw_callable.run``/``fused_adamw``),
which the JAX package's eager optimizer step launches once per parameter
(``Adam._maybe_fused``). The kernel is ``csrc/adamw.cu``: one
elementwise pass over many tensors at once that updates p, m and v in
place and may write the bf16 or f16 copy of an f32 master in the same
pass; it is memory-bound. The source says more.

:func:`fused_adamw_group_` updates a list of parameters: :func:`adamw_plan`
groups them by dtype combination and cuts each into chunks of
:data:`ADAMW_CHUNK` elements, and every launch carries up to
:data:`ADAMW_MAX_TENSORS` tensors and :data:`ADAMW_MAX_CHUNKS` chunks. GPT-2 small's 196 parameter tensors (124,475,904 elements,
one dtype combination) take 7 launches. The plan and the operands'
checks are cached per tensor list, keyed by each operand's
``data_ptr``, element count, dtype and contiguity, so a steady-state
step builds and checks nothing; a reallocated tensor misses the cache.
:func:`fused_adamw_` is the group of one.

Both take the plain version only for tensors on the CPU. A CUDA tensor
goes to the kernel, or the call raises: there is no fallback.
``fused_adamw_.launches`` counts kernel launches of either entry and
``fused_adamw_.tensors`` the tensors they updated.
"""
from __future__ import annotations

import ctypes
import threading
from typing import NamedTuple, Sequence, Tuple

import numpy as np
import torch

from . import _build

__all__ = ["fused_adamw_", "fused_adamw_group_", "adamw_plain_",
           "adamw_group_plain_", "adamw_plan", "bias_corrections",
           "AdamwLaunch", "ADAMW_CHUNK", "ADAMW_MAX_TENSORS",
           "ADAMW_MAX_CHUNKS"]

#: elements a chunk entry (32 units of 2048 that the launch's CTAs
#: share); kChunk of ``csrc/adamw.cu``
ADAMW_CHUNK = 65536
#: tensor descriptors a launch carries; kMaxTensors
ADAMW_MAX_TENSORS = 36
#: chunk entries a launch carries; kMaxChunks
ADAMW_MAX_CHUNKS = 440
# a chunk entry packs its tensor's slot above bit 24 (kSlotShift)
_SLOT_SHIFT = 24


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


def adamw_group_plain_(ps, gs, ms, vs, lows, lrs, wds, steps, beta1, beta2,
                       eps):
    """:func:`adamw_plain_` over the list, tensor by tensor."""
    for p, g, m, v, low, lr, wd, step in zip(ps, gs, ms, vs, lows, lrs, wds,
                                              steps):
        adamw_plain_(p, g, m, v, lr, beta1, beta2, eps, wd, step, low)


class AdamwLaunch(NamedTuple):
    """One kernel launch of a plan: its dtype combination, the list
    positions of its tensors, and its chunks as ``(slot, chunk)`` pairs,
    ``slot`` indexing ``tensors``."""
    kind: object
    tensors: Tuple[int, ...]
    chunks: Tuple[Tuple[int, int], ...]


def adamw_plan(numels: Sequence[int], kinds: Sequence,
               chunk: int = ADAMW_CHUNK,
               max_tensors: int = ADAMW_MAX_TENSORS,
               max_chunks: int = ADAMW_MAX_CHUNKS) -> Tuple[AdamwLaunch, ...]:
    """The launches that update tensors of ``numels`` elements whose dtype
    combinations are ``kinds`` (any hashable, equal for tensors one
    launch may share). Tensors are grouped by kind in order of first
    appearance and keep their order within a group; each is cut into
    ``ceil(n / chunk)`` chunks, and a launch is closed when it holds
    ``max_chunks`` chunks, or ``max_tensors`` tensors and the next chunk
    is another tensor's. A tensor may span launches; an empty one takes
    no chunk and no launch."""
    groups = {}
    for i, kind in enumerate(kinds):
        groups.setdefault(kind, []).append(i)
    launches = []
    for kind, members in groups.items():
        tensors, chunks = [], []
        for i in members:
            count = -(-int(numels[i]) // chunk)
            if count >> _SLOT_SHIFT:
                raise ValueError(f"a tensor of {numels[i]} elements takes "
                                 f"{count} chunks, over 2**{_SLOT_SHIFT}")
            for c in range(count):
                new = not tensors or tensors[-1] != i
                if len(chunks) == max_chunks or (
                        new and len(tensors) == max_tensors):
                    launches.append(AdamwLaunch(kind, tuple(tensors),
                                                tuple(chunks)))
                    tensors, chunks, new = [], [], True
                if new:
                    tensors.append(i)
                chunks.append((len(tensors) - 1, c))
        if chunks:
            launches.append(AdamwLaunch(kind, tuple(tensors), tuple(chunks)))
    return tuple(launches)


_ARGS = [ctypes.c_int] + [ctypes.c_void_p] * 8 + [ctypes.c_float] * 3 + [
    ctypes.c_void_p]

_LOW_DTYPES = (torch.bfloat16, torch.float16)
_CACHE_SIZE = 8     # tensor lists kept; a training run steps one or two


class _Plan:
    """A plan flattened into the arrays ``adamw_group_launch`` reads."""

    def __init__(self, launches):
        self.launches = len(launches)
        self.kinds = np.array([k for l in launches for k in l.kind],
                              np.int32)
        self.tensor_off = np.cumsum(
            [0] + [len(l.tensors) for l in launches]).astype(np.int32)
        self.tensors = np.array([i for l in launches for i in l.tensors],
                                np.int32)
        self.chunk_off = np.cumsum(
            [0] + [len(l.chunks) for l in launches]).astype(np.int32)
        self.chunks = np.array(
            [(s << _SLOT_SHIFT) | c for l in launches for s, c in l.chunks],
            np.uint32)


class _Operands:
    """A checked tensor list: its plan and its operands' pointers."""

    def __init__(self, plan, ptrs, numels):
        self.plan = plan
        self.ptrs = np.array(ptrs, np.uint64)
        self.numels = np.array(numels, np.int64)


_plans = {}       # (numels, kinds) -> _Plan
_operands = {}    # the operands' signature -> _Operands
_cache_lock = threading.Lock()


def _remember(cache, key, value):
    if len(cache) >= _CACHE_SIZE:
        cache.pop(next(iter(cache)))
    cache[key] = value
    return value


def _check(p, g, m, v, low):
    """Raise on operands the kernel does not take; return the launch's
    dtype codes ``(p, g, low or -1)``."""
    tensors = [p, g, m, v] + ([low] if low is not None else [])
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
    return (_build.DTYPE_CODE[p.dtype], _build.DTYPE_CODE[g.dtype],
            -1 if low is None else _build.DTYPE_CODE[low.dtype])


def _operands_of(operands):
    """The cached plan and pointers of ``operands`` (a list of ``(p, g,
    m, v, low)``), checked and built at the first sight of their
    signature."""
    key = tuple((t.data_ptr(), t.numel(), t.dtype, t.is_contiguous())
                if t is not None else None
                for group in operands for t in group)
    found = _operands.get(key)
    if found is not None:
        return found
    kinds = [_check(*group) for group in operands]
    numels = tuple(group[0].numel() for group in operands)
    plan_key = (numels, tuple(kinds))
    ptrs = [0 if t is None else t.data_ptr()
            for group in operands for t in group]
    with _cache_lock:
        plan = _plans.get(plan_key)
        if plan is None:
            plan = _remember(_plans, plan_key,
                             _Plan(adamw_plan(numels, kinds)))
        return _remember(_operands, key, _Operands(plan, ptrs, numels))


def _launch(device, operands, scalars, beta1, beta2, eps):
    found = _operands_of(operands)
    plan = found.plan
    if plan.launches:
        scal = np.array(scalars, np.float32)
        rc = _build.function("adamw", "adamw_group_launch", _ARGS)(
            plan.launches, plan.kinds.ctypes.data,
            plan.tensor_off.ctypes.data, plan.tensors.ctypes.data,
            plan.chunk_off.ctypes.data, plan.chunks.ctypes.data,
            found.ptrs.ctypes.data, found.numels.ctypes.data,
            scal.ctypes.data, float(beta1), float(beta2), float(eps),
            torch.cuda.current_stream(device).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"AdamW kernel launch failed: CUDA error "
                               f"{rc}")
    fused_adamw_.launches += plan.launches
    fused_adamw_.tensors += len(operands)


def fused_adamw_group_(ps, gs, ms, vs, lows, lrs, wds, steps, beta1, beta2,
                       eps):
    """AdamW on a list of parameters, in place: for each i, ``ps[i]`` (f32
    master or parameter, or a bf16/f16 parameter), gradient ``gs[i]``
    (f32, bf16 or f16 beside an f32 p; of p's dtype beside a bf16 or f16
    one), moments ``ms[i]``, ``vs[i]`` (f32), ``lows[i]`` (bf16 or f16
    or None, only with an f32 p) set to the updated p rounded down, at
    learning rate ``lrs[i]``, decoupled decay ``wds[i]`` and step
    ``steps[i]`` (the bias corrections' t). A tensor on the CPU takes
    the plain version; the CUDA tensors of each device are updated by
    the plan's launches on its current stream."""
    card = {}
    for i, p in enumerate(ps):
        if p.device.type == "cpu":
            adamw_plain_(p, gs[i], ms[i], vs[i], lrs[i], beta1, beta2, eps,
                         wds[i], steps[i], lows[i])
        elif p.device.type == "cuda":
            card.setdefault(p.device, []).append(i)
        else:
            raise ValueError(f"fused_adamw_ runs on cuda or cpu tensors, "
                             f"got {p.device}")
    for device, members in card.items():
        scalars = []
        for i in members:
            scalars.extend((lrs[i], wds[i],
                            *bias_corrections(beta1, beta2, steps[i])))
        _launch(device, [(ps[i], gs[i], ms[i], vs[i], lows[i])
                         for i in members], scalars, beta1, beta2, eps)


def fused_adamw_(p, g, m, v, lr, beta1, beta2, eps, weight_decay, step,
                 low=None):
    """AdamW on one parameter, in place: :func:`fused_adamw_group_` over
    a list of one."""
    fused_adamw_group_([p], [g], [m], [v], [low], [lr], [weight_decay],
                       [step], beta1, beta2, eps)


fused_adamw_.launches = 0
fused_adamw_.tensors = 0
