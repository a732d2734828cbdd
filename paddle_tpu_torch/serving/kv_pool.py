"""Slot bookkeeping shared by the KV pool layouts, and the dense slot
pool (counterpart of ``paddle_tpu/serving/kv_pool.py``).

:class:`SlotPoolBase` is host-side only: the free list of request slots,
per-slot position tracking (``pos`` = cache index where the slot's next
token lands, ``lo`` = first valid index) and the pow2 capacity buckets
of the prefill steps. :class:`KVCachePool` is the dense layout: one
``[heads, max_len, head_dim]`` stripe per slot and per layer/kv plane.
The pool is owned by the scheduler thread; ``alloc``/``free``/
``set_slot`` are only called from it.

Every pool publishes its bytes in the memory ledger
(``profiler/memory.py``) under ``serving/kv_pool#<n>/capacity`` and
``.../in_use`` — host dict stores at each slot or block change, never a
device poll — and stamps ``kv/alloc`` and ``kv/free`` marks on the
memory timeline.
"""
from __future__ import annotations

import itertools
import weakref
from typing import Dict, List, Optional

import numpy as np
import torch

from .._device import resolve_device
from ..profiler import memory as _memory

__all__ = ["SlotPoolBase", "KVCachePool"]

# process-wide pool numbering for the ledger keys (two engines in one
# process must not alias each other's entries)
_pool_ids = itertools.count(1)


def _drop_pool_ledger(ledger_key: str) -> None:
    """weakref.finalize target for a pool's ledger entries — a module
    function so the finalizer holds no reference to the pool."""
    _memory.ledger_drop(f"{ledger_key}/capacity")
    _memory.ledger_drop(f"{ledger_key}/in_use")


def _storage_dtype(dtype) -> torch.dtype:
    """A torch dtype, or its name as the JAX pool takes it."""
    if isinstance(dtype, str):
        dtype = getattr(torch, dtype, None)
    if not isinstance(dtype, torch.dtype):
        raise ValueError(f"pool dtype must be a torch dtype or its name, "
                         f"got {dtype!r}")
    return dtype


class _Slot:
    """Position state of one allocated slot (host ints, scheduler-owned)."""

    __slots__ = ("pos", "lo")

    def __init__(self, pos: int = 0, lo: int = 0):
        self.pos = pos
        self.lo = lo


class SlotPoolBase:
    """Slot/position bookkeeping shared by every KV pool layout.

    Subclasses set ``num_slots``, ``max_len``, ``min_bucket``,
    ``shape``, ``dtype``, ``device`` and ``data`` in their constructors,
    then call :meth:`_init_slots`; they pick the per-slot record via
    ``_slot_cls`` and hook ``_slot_freed`` for layout-specific teardown.
    """

    _slot_cls = _Slot
    _capacity_noun = "cache capacity"
    _admission_law = "bucket + max_new <= max_len"

    def _init_slots(self) -> None:
        # lowest-index-first keeps slot assignment deterministic
        self._free_slots: List[int] = list(range(self.num_slots))
        self._slots: Dict[int, _Slot] = {}
        self.ledger_key = f"serving/kv_pool#{next(_pool_ids)}"
        # a pool dropped without engine.close() must not haunt
        # crosscheck() or an OOM postmortem with phantom KV bytes
        weakref.finalize(self, _drop_pool_ledger, self.ledger_key)
        self._update_ledger()

    # -- memory ledger (profiler/memory.py) ----------------------------------
    def _update_ledger(self) -> None:
        """Publish capacity + in-use bytes into the process ledger (the
        'what we think is live' side of ``crosscheck()``). Host dict
        stores only — called from alloc/free and the paged block hooks,
        all on the scheduler thread, none synchronizing."""
        _memory.ledger_set(f"{self.ledger_key}/capacity",
                           self.capacity_bytes)
        _memory.ledger_set(f"{self.ledger_key}/in_use", self.bytes_in_use)

    def drop_ledger(self) -> None:
        """Remove this pool's ledger entries (engine close): a closed
        engine's pool is no longer an accounted owner."""
        _memory.ledger_drop(f"{self.ledger_key}/capacity")
        _memory.ledger_drop(f"{self.ledger_key}/in_use")

    @property
    def capacity_bytes(self) -> int:
        """Device bytes of the whole pool tensor (host arithmetic)."""
        return int(np.prod(self.shape)) * self.dtype.itemsize

    @property
    def bytes_in_use(self) -> int:
        return self.n_active * (self.capacity_bytes // self.num_slots)

    # -- slot allocation ---------------------------------------------------
    def alloc(self) -> Optional[int]:
        """Claim the lowest free slot, or None when the pool is full."""
        if not self._free_slots:
            return None
        slot = min(self._free_slots)
        self._free_slots.remove(slot)
        self._slots[slot] = self._slot_cls()
        self._update_ledger()
        _memory.mark("kv/alloc", pool=self.ledger_key, slot=slot,
                     in_use=self.bytes_in_use)
        return slot

    def free(self, slot: int) -> None:
        """Return ``slot`` to the free list (``_slot_freed`` runs the
        layout's teardown first). Its device rows are not cleared: the
        attention mask never looks past ``pos``, so stale K/V are
        unreachable."""
        if slot not in self._slots:
            raise ValueError(f"slot {slot} is not allocated")
        st = self._slots.pop(slot)
        self._slot_freed(st)
        self._free_slots.append(slot)
        self._update_ledger()
        _memory.mark("kv/free", pool=self.ledger_key, slot=slot,
                     in_use=self.bytes_in_use)

    def _slot_freed(self, st) -> None:
        """Layout hook: called by :meth:`free` with the popped slot
        state, before the slot rejoins the free list."""

    def is_allocated(self, slot: int) -> bool:
        return slot in self._slots

    def reset_data(self) -> None:
        """Zero the device pool after a failed step (only live slots
        carry meaningful rows, and none survive the failure)."""
        self.data = torch.zeros(self.shape, dtype=self.dtype,
                                device=self.device)

    @property
    def n_active(self) -> int:
        return len(self._slots)

    def active_slots(self) -> List[int]:
        return sorted(self._slots)

    # -- per-slot position tracking ---------------------------------------
    def set_slot(self, slot: int, *, pos: int, lo: int) -> None:
        st = self._slots[slot]
        if not 0 <= lo <= pos < self.max_len:
            raise ValueError(
                f"slot {slot}: bad position state lo={lo} pos={pos} "
                f"(max_len={self.max_len})")
        st.pos = int(pos)
        st.lo = int(lo)

    def advance(self, slot: int, n: int = 1) -> int:
        """``n`` tokens landed (one decode row, or one prefill chunk):
        the slot's write position moves ``n`` cache indices later. ``n``
        is a SIGNED delta: the speculative scheduler rolls back the rows
        of rejected draft tokens with a negative ``n`` (paged tables
        address by ``pos``, so the stale K/V past the new ``pos`` are
        masked out and overwritten by the next append). Returns the new
        ``pos``."""
        if n == 0:
            raise ValueError("advance needs n != 0")
        st = self._slots[slot]
        new_pos = st.pos + int(n)        # validate BEFORE mutating
        if new_pos >= self.max_len:
            raise RuntimeError(
                f"slot {slot} overran the {self._capacity_noun} "
                f"{self.max_len} — the admission check "
                f"({self._admission_law}) is broken")
        if new_pos < st.lo:
            raise RuntimeError(
                f"slot {slot}: rollback below the slot's floor "
                f"(pos={new_pos} < lo={st.lo}) — a speculative rollback "
                f"may only unwind rows written this cycle")
        st.pos = new_pos
        return st.pos

    def slot_pos(self, slot: int) -> int:
        return self._slots[slot].pos

    def slot_lo(self, slot: int) -> int:
        return self._slots[slot].lo

    def position_arrays(self):
        """Dense ``pos``/``lo`` int32 arrays over ALL slots for the decode
        step; free slots read 0: they compute garbage that the scheduler
        ignores and the next prefill overwrites."""
        pos = np.zeros(self.num_slots, np.int32)
        lo = np.zeros(self.num_slots, np.int32)
        for slot, st in self._slots.items():
            pos[slot] = st.pos
            lo[slot] = st.lo
        return pos, lo

    # -- capacity buckets --------------------------------------------------
    def bucket_for(self, prompt_len: int) -> int:
        """The capacity bucket of a prompt: the next power of two >=
        ``prompt_len``, floored at ``min_bucket``: one built prefill
        step per bucket."""
        if prompt_len < 1:
            raise ValueError(f"prompt_len must be >= 1, got {prompt_len}")
        b = self.min_bucket
        while b < prompt_len:
            b *= 2
        return b

    def buckets(self) -> List[int]:
        """Every admissible bucket (pow2 from ``min_bucket`` to
        ``max_len``)."""
        out, b = [], self.min_bucket
        while b <= self.max_len:
            out.append(b)
            b *= 2
        return out


class KVCachePool(SlotPoolBase):
    """Fixed-capacity dense KV cache + slot allocator.

    ``data`` is the tensor ``[layers, 2, slots, heads, max_len,
    head_dim]`` on ``device`` (``None`` = the card); the prefill and
    decode steps write it in place. Everything else is host bookkeeping:
    which slots are live, where each slot's sequence starts (``lo``, the
    left pad of its capacity bucket) and currently ends (``pos``).
    """

    is_paged = False

    def __init__(self, num_layers: int, num_slots: int, num_heads: int,
                 max_len: int, head_dim: int, dtype=torch.float32,
                 min_bucket: int = 8, device=None):
        if num_slots < 1:
            raise ValueError(f"num_slots must be >= 1, got {num_slots}")
        if min_bucket < 1:
            raise ValueError(f"min_bucket must be >= 1, got {min_bucket}")
        if max_len < min_bucket:
            raise ValueError(
                f"max_len={max_len} is below min_bucket={min_bucket}: no "
                f"prompt could ever be admitted")
        self.num_layers = int(num_layers)
        self.num_slots = int(num_slots)
        self.num_heads = int(num_heads)
        self.max_len = int(max_len)
        self.head_dim = int(head_dim)
        self.min_bucket = int(min_bucket)
        self.shape = (self.num_layers, 2, self.num_slots, self.num_heads,
                      self.max_len, self.head_dim)
        self.dtype = _storage_dtype(dtype)
        self.dtype_name = str(self.dtype).removeprefix("torch.")
        self.device = resolve_device(device)
        self.data = torch.zeros(self.shape, dtype=self.dtype,
                                device=self.device)
        self._init_slots()

    def __repr__(self):
        return (f"<KVCachePool {self.shape} {self.dtype_name} "
                f"active={self.n_active}/{self.num_slots}>")

