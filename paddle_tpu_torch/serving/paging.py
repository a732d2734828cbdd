"""Paged KV-cache memory manager: block-granular pooling + prefix cache
(counterpart of ``paddle_tpu/serving/paging.py``).

The device pool is ``[layers, 2, num_blocks + 1, heads, block_size,
head_dim]``: a request owns only the blocks covering its tokens so far,
addressed through a per-request page table that maps virtual cache index
``i`` to ``(table[i // block_size], i % block_size)``. Physical block 0
is a reserved SCRATCH block: page-table padding points at it, pad rows
write into it, and nothing ever reads it.

Host-side manager (scheduler-thread-owned, the JAX package's logic):

* **free-list block allocator** — a min-heap, so allocation order is
  deterministic (lowest id first) and matches the JAX pool's;
* **page tables in pow2 buckets** (``table_bucket``/``table_array``);
* **refcounts + copy-on-write** — a block reachable from several page
  tables is never written through; ``ensure_writable_range`` hands the
  engine ``(dst, src)`` copy orders and swaps the table entry;
* **prefix-cache trie** — full token blocks registered under their exact
  token-prefix key; a later request starting with the same full blocks
  adopts them. Released cached blocks wait in an LRU that allocation
  pressure evicts.

Paged sequences are aligned at virtual index 0 (``lo == 0``), so block
contents depend only on the token prefix.

**Quantized blocks** (``dtype="int8"`` or ``"float8_e4m3fn"``): the pool
holds codes, and ``scales [layers, 2, num_blocks + 1, heads]`` float32
holds each (block, head)'s max-abs scale, so a value is ``code * scale``.
Scale 0 marks an untouched block, which reads as the zeros a fresh float
pool holds. The byte accounting counts the scales, so pools of different
storage types compare at the same budget.

**Host tier** (``attach_host_tier``, :mod:`.host_tier`): a cached block
that goes refcount-0 is queued for demotion, and the scheduler's
once-a-cycle :meth:`PagedKVPool.tier_tick` gathers every such block that
is still evictable into one fresh device tensor for the tier's spiller
thread. :meth:`PagedKVPool.tier_match` continues a prefix match into the
tier, and :meth:`PagedKVPool.adopt_promotion` lands a promoted chain in
freshly allocated blocks, republished as if never evicted. Every write
path copies on write or unregisters the key first, so a published key's
block content is a function of the key alone: a host copy can be adopted
at any later time. Each admission is classed ``hbm`` (a device trie hit),
``host`` (a hit through a promotion) or ``miss`` in ``tier_hits``.
"""
from __future__ import annotations

import heapq
from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .._device import resolve_device
from ..framework.monitor import stat_add
from .kv_pool import SlotPoolBase, _storage_dtype

__all__ = ["PagedKVPool", "PoolCapacityError", "PoolExhaustedError",
           "BlockError"]


class PoolCapacityError(ValueError):
    """The request can NEVER fit this pool — raised at ``submit()``."""


class PoolExhaustedError(RuntimeError):
    """No free and no evictable block right now — a transient pressure
    signal; the scheduler answers it by preempting the youngest active
    request."""


class BlockError(ValueError):
    """Block bookkeeping misuse (double free, a second page table)."""


class _PagedSlot:
    """Per-request decode state: virtual positions + the page table."""

    __slots__ = ("pos", "lo", "table")

    def __init__(self):
        self.pos = 0
        self.lo = 0
        self.table: List[int] = []      # physical block ids, virtual order


class _TrieNode:
    """One cached full block, keyed in ``_trie`` by the exact token
    prefix tuple it encodes (root..this block, inclusive)."""

    __slots__ = ("key", "block", "children")

    def __init__(self, key: Tuple[int, ...], block: int):
        self.key = key
        self.block = block
        self.children: set = set()      # child keys (one block longer)


class PagedKVPool(SlotPoolBase):
    """Block-pooled KV cache + page-table/prefix-cache manager.

    ``data`` is the tensor ``[layers, 2, num_blocks + 1, heads,
    block_size, head_dim]`` on ``device`` (``None`` = the card; index 0 =
    scratch). The serving step writes it in place. ``num_slots`` bounds
    concurrent requests, ``num_blocks`` their total KV footprint.
    ``dtype`` is a torch dtype or its name; ``"int8"`` and
    ``"float8_e4m3fn"`` make a quantized pool with ``scales``.
    ``min_bucket`` (a whole number of blocks, 8 as in the JAX pool, so
    a pool of larger blocks names it) floors the gather engine's prefill
    buckets. ``mesh``/``mp_axis`` (a head-sharded pool) raise
    ``NotImplementedError`` unless ``mesh`` is None.
    """

    _slot_cls = _PagedSlot
    is_paged = True
    _capacity_noun = "virtual capacity"
    _admission_law = "prompt + max_new <= max_len"

    #: largest code of each quantized storage type (its max-abs scale
    #: maps a block's largest magnitude there)
    _QUANT_QMAX = {"int8": 127.0, "float8_e4m3fn": 448.0}

    def __init__(self, num_layers: int, num_slots: int, num_heads: int,
                 max_len: int, head_dim: int, *, block_size: int = 16,
                 num_blocks: Optional[int] = None, dtype=torch.float32,
                 min_bucket: int = 8, mesh=None, mp_axis: str = "mp",
                 device=None):
        if mesh is not None:
            raise NotImplementedError(
                "mesh= (a head-sharded pool) is not ported yet: ROADMAP.md "
                "Queue 1 item 4")
        if num_slots < 1:
            raise ValueError(f"num_slots must be >= 1, got {num_slots}")
        if block_size < 1 or (block_size & (block_size - 1)):
            raise ValueError(
                f"block_size must be a power of two, got {block_size}")
        if min_bucket < block_size or min_bucket % block_size:
            raise ValueError(
                f"min_bucket={min_bucket} must be a multiple of "
                f"block_size={block_size} (prefill buckets scatter whole "
                f"blocks)")
        if max_len < min_bucket:
            raise ValueError(
                f"max_len={max_len} is below min_bucket={min_bucket}: no "
                f"prompt could ever be admitted")
        self.num_layers = int(num_layers)
        self.num_slots = int(num_slots)
        self.num_heads = int(num_heads)
        self.max_len = int(max_len)
        self.head_dim = int(head_dim)
        self.block_size = int(block_size)
        self.min_bucket = int(min_bucket)
        # blocks a single request can ever hold (covers [0, max_len))
        self.max_table_len = -(-self.max_len // self.block_size)
        if num_blocks is None:
            # dense-equivalent budget: every slot could go the full max_len
            num_blocks = self.num_slots * self.max_table_len
        self.num_blocks = int(num_blocks)
        if self.num_blocks < self.max_table_len:
            raise ValueError(
                f"num_blocks={self.num_blocks} cannot hold even one "
                f"max-length request ({self.max_table_len} blocks)")
        # +1: physical block 0 is the reserved scratch block
        self.shape = (self.num_layers, 2, self.num_blocks + 1,
                      self.num_heads, self.block_size, self.head_dim)
        self.dtype = _storage_dtype(dtype)
        self.dtype_name = str(self.dtype).removeprefix("torch.")
        self.device = resolve_device(device)
        self.data = torch.zeros(self.shape, dtype=self.dtype,
                                device=self.device)
        self.quantized = self.dtype_name in self._QUANT_QMAX
        self.qmax = self._QUANT_QMAX.get(self.dtype_name)
        self.scales_shape = (self.num_layers, 2, self.num_blocks + 1,
                             self.num_heads)
        self.scales = (torch.zeros(self.scales_shape, dtype=torch.float32,
                                   device=self.device)
                       if self.quantized else None)
        self._free: List[int] = list(range(1, self.num_blocks + 1))
        self._ref: Dict[int, int] = {}            # block -> request refs
        self._trie: Dict[Tuple[int, ...], _TrieNode] = {}
        self._block_key: Dict[int, Tuple[int, ...]] = {}
        self._lru: "OrderedDict[Tuple[int, ...], _TrieNode]" = OrderedDict()
        self._init_slots()
        self.prefix_hits = 0
        self.prefix_misses = 0
        self.tokens_saved = 0
        self.evictions = 0
        # the host tier, when attached: keys that went refcount-0 wait in
        # _tier_pending for the next tier_tick's batched demotion
        self.host_tier = None
        self._tier_pending: set = set()
        self.tier_hits = {"hbm": 0, "host": 0, "miss": 0}
        self.tier_degraded = 0

    # -- request slots -----------------------------------------------------
    def _slot_freed(self, st: _PagedSlot) -> None:
        """free() teardown: unref every block in the slot's page table.
        Refcount-0 cached blocks stay in the prefix cache (LRU,
        evictable); uncached ones return to the free list."""
        for b in st.table:
            self._unref(b)

    def reset_data(self) -> None:
        """Zero the device pool AND drop every cached block: zeroed rows
        no longer match any trie key. Called by the scheduler's failure
        path after every in-flight slot has been failed and freed."""
        if self._slots:
            raise RuntimeError(
                "reset_data with live slots: fail and free them first")
        super().reset_data()
        if self.quantized:
            self.scales = torch.zeros(self.scales_shape,
                                      dtype=torch.float32,
                                      device=self.device)
        self._trie.clear()
        self._block_key.clear()
        self._lru.clear()
        self._ref.clear()
        self._free = list(range(1, self.num_blocks + 1))
        # pending demotions name blocks of the old contents; copies
        # already in the tier stay valid (a function of their key)
        self._tier_pending.clear()
        self._update_ledger()

    # -- block bookkeeping -------------------------------------------------
    def blocks_for(self, n_tokens: int) -> int:
        """Blocks covering virtual indices [0, n_tokens)."""
        return -(-int(n_tokens) // self.block_size)

    @property
    def blocks_in_use(self) -> int:
        """Blocks referenced by at least one page table."""
        return self.num_blocks - len(self._free) - len(self._lru)

    @property
    def blocks_available(self) -> int:
        """Free plus evictable (released cached) blocks."""
        return len(self._free) + len(self._lru)

    @property
    def cached_blocks(self) -> int:
        """Blocks registered in the prefix cache (referenced or not)."""
        return len(self._trie)

    @property
    def block_storage_bytes(self) -> int:
        """Device bytes of the block array alone."""
        return int(np.prod(self.shape)) * self.dtype.itemsize

    @property
    def scales_bytes(self) -> int:
        """Device bytes of the per-block scale array (0 for float
        pools)."""
        return int(np.prod(self.scales_shape)) * 4 if self.quantized else 0

    @property
    def capacity_bytes(self) -> int:
        """Device bytes of the whole pool: the blocks plus, for a
        quantized pool, their scales."""
        return self.block_storage_bytes + self.scales_bytes

    @property
    def block_bytes(self) -> int:
        """Device bytes of ONE block across every layer/kv plane, its
        scales included."""
        return self.capacity_bytes // (self.num_blocks + 1)

    @classmethod
    def blocks_within_budget(cls, budget_bytes: int, *, num_layers: int,
                             num_heads: int, block_size: int,
                             head_dim: int, dtype="float32") -> int:
        """Largest ``num_blocks`` whose pool (the scratch block and, for
        a quantized type, the scale array included) fits
        ``budget_bytes``: the same-budget sizing rule."""
        dtype = _storage_dtype(dtype)
        per_block = num_layers * 2 * num_heads * block_size * head_dim \
            * dtype.itemsize
        if str(dtype).removeprefix("torch.") in cls._QUANT_QMAX:
            per_block += num_layers * 2 * num_heads * 4
        # num_blocks + 1 physical blocks (scratch) must fit
        return max(0, int(budget_bytes) // per_block - 1)

    @property
    def bytes_in_use(self) -> int:
        return self.blocks_in_use * self.block_bytes

    def can_admit(self, n_tokens: int) -> bool:
        """Admission gate: enough free + evictable blocks for the
        request's first ``n_tokens`` tokens (growth past that is the
        preemption policy's problem)."""
        return self.blocks_available >= self.blocks_for(n_tokens)

    def _alloc_block(self) -> int:
        if not self._free:
            self._evict_one()            # raises PoolExhaustedError
        b = heapq.heappop(self._free)
        self._ref[b] = 1
        self._update_ledger()
        if self.quantized:
            # a recycled block keeps its last tenant's scale, and appends
            # only grow scales: a stale coarse scale would crush the new
            # tenant's rows to few codes. Blocks adopted from the prefix
            # cache never pass here and keep theirs.
            self.scales[:, :, b] = 0.0
        return b

    def _unref(self, b: int) -> None:
        rc = self._ref.get(b, 0)
        if rc <= 0:
            raise BlockError(
                f"block {b} is not referenced (double free would corrupt "
                f"the free list)")
        self._ref[b] = rc - 1
        self._update_ledger()
        if rc == 1:
            key = self._block_key.get(b)
            if key is not None and key in self._trie:
                # released but cached: reusable until evicted, and with a
                # host tier demoted at the next tier_tick if still
                # evictable then
                self._lru[key] = self._trie[key]
                if self.host_tier is not None:
                    self._tier_pending.add(key)
            else:
                heapq.heappush(self._free, b)

    def _evict_one(self) -> None:
        """Reclaim the least-recently-released cached block (and drop
        its now-unreachable cached descendants)."""
        if not self._lru:
            raise PoolExhaustedError(
                f"all {self.num_blocks} blocks are referenced and the "
                f"prefix cache has nothing to evict")
        key = next(iter(self._lru))
        self._drop_node(key)
        self.evictions += 1

    def _drop_node(self, key: Tuple[int, ...]) -> None:
        """Unregister the cached block at ``key`` and its subtree. A
        refcount-0 block returns to the free list; a block still held by
        a request merely loses its cache membership."""
        node = self._trie.pop(key, None)
        if node is None:
            return
        self._lru.pop(key, None)
        self._block_key.pop(node.block, None)
        if self._ref.get(node.block, 0) == 0:
            heapq.heappush(self._free, node.block)
        parent = self._trie.get(key[:-self.block_size])
        if parent is not None:
            parent.children.discard(key)
        for child in list(node.children):
            self._drop_node(child)

    # -- the host tier (host_tier.py) ---------------------------------------
    @property
    def host_block_nbytes(self) -> int:
        """Host bytes of one demoted block (every layer and K/V plane, no
        scale)."""
        return (self.num_layers * 2 * self.num_heads * self.block_size
                * self.head_dim * self.dtype.itemsize)

    @property
    def host_scale_nbytes(self) -> int:
        """Host bytes of one demoted block's scale row (0 for float
        pools)."""
        return self.num_layers * 2 * self.num_heads * 4 \
            if self.quantized else 0

    def attach_host_tier(self, tier) -> None:
        """Bind a :class:`~.host_tier.HostBlockPool` as the spill target
        of LRU-released cached blocks (the engine's ``host_tier_bytes=``).
        The JAX pool compiles the tier's gather and scatter for every
        pow2 width here; eager torch has nothing to compile."""
        self.host_tier = tier

    def tier_tick(self) -> None:
        """Once-a-cycle demotion pump (scheduler thread): every key that
        went refcount-0 since the last tick and is still evictable goes
        to the tier in ONE gather into a fresh ``[n, L, 2, H, bs, Dh]``
        tensor (with its ``[n, L, 2, H]`` scales), enqueued on the
        current stream, where the steps' kernels launch too: the gather
        is ordered before the next step's in-place writes. The blocks are
        picked by integer index, so no index tensor crosses to the device
        (a copy from pageable host memory would synchronise), and nothing
        is padded to pow2 widths (the JAX pool does so only to reuse
        compiled shapes). Dispatch only: no host sync."""
        tier = self.host_tier
        if tier is None or not self._tier_pending:
            return
        pending, self._tier_pending = self._tier_pending, set()
        keys = [k for k in pending if k in self._lru and not tier.has(k)]
        if not keys:
            return
        ids = [self._trie[k].block for k in keys]
        blk = torch.stack([self.data[:, :, b] for b in ids])
        sca = torch.stack([self.scales[:, :, b] for b in ids]) \
            if self.quantized else None
        tier.spill(keys, blk, sca)

    def tier_match(self, tokens) -> Tuple[List[Tuple[int, ...]], int]:
        """Continue :meth:`match_prefix`'s walk into the host tier: the
        chain of demoted full blocks extending the device-cached prefix
        of ``tokens`` (the same proper-prefix cap), as ``(host_keys,
        covered_tokens)`` with the device and host coverage together.
        Read-only."""
        tier = self.host_tier
        if tier is None:
            return [], 0
        toks = tuple(int(t) for t in tokens)
        bs = self.block_size
        host_keys: List[Tuple[int, ...]] = []
        covered = 0
        for i in range(1, (len(toks) - 1) // bs + 1):
            key = toks[:i * bs]
            if key in self._trie:
                covered = i * bs
            elif tier.has(key):
                host_keys.append(key)
                covered = i * bs
            else:
                break
        return host_keys, covered

    def adopt_promotion(self, ticket) -> bool:
        """Land a promotion whose copy has landed (scheduler thread):
        allocate device blocks, copy the staged blocks (and scales) in,
        and republish each key as a refcount-0 cached node, as if never
        evicted. Keys republished on the device meanwhile are skipped
        (the same bytes), and exhaustion adopts the prefix of the chain
        that fits, or degrades to a plain miss, never an error. On the
        card the current stream waits on the copy's event (the ticket
        is ready only once it fired) and the staged tensors are marked
        as used on it, so the allocator keeps them until the copies ran;
        nothing synchronises the host."""
        tier = self.host_tier
        if tier is None or ticket is None:
            return False
        if ticket.adopted:
            return True
        if ticket.failed or not ticket.staged_keys:
            tier.ticket_done(ticket)
            return False
        keep = [i for i, k in enumerate(ticket.staged_keys)
                if k not in self._trie]
        if not keep:
            # the whole chain came back on the device while it staged
            ticket.adopted = True
            tier.ticket_done(ticket)
            return True
        ids: List[int] = []
        try:
            for _ in keep:
                ids.append(self._alloc_block())
        except PoolExhaustedError:
            pass                          # adopt the prefix that fits
        keep = keep[:len(ids)]
        if not keep:
            self.tier_degraded += 1
            stat_add("serving/tier_degraded")
            tier.ticket_done(ticket)
            return False
        staged, sca = ticket.staged, ticket.staged_scales
        if ticket.event is not None:
            cur = torch.cuda.current_stream(self.device)
            cur.wait_event(ticket.event)
            for t in (staged, sca):
                if t is not None:
                    t.record_stream(cur)
        with torch.inference_mode():
            for i, b in zip(keep, ids):
                self.data[:, :, b].copy_(staged[i])
                if self.quantized and sca is not None:
                    # the original scales over _alloc_block's zeros
                    self.scales[:, :, b].copy_(sca[i])
        for i, b in zip(keep, ids):
            key = ticket.staged_keys[i]
            self._ref[b] = 0              # cached, unreferenced
            node = _TrieNode(key, b)
            self._trie[key] = node
            self._block_key[b] = key
            parent = self._trie.get(key[:-self.block_size])
            if parent is not None:
                parent.children.add(key)
            self._lru[key] = node         # evictable until admitted
        self._update_ledger()
        ticket.adopted = True
        tier.note_promoted(ticket, len(keep))
        tier.ticket_done(ticket)
        return True

    def note_tier_hit(self, kind: str) -> None:
        """Class one paged admission: ``hbm``, ``host`` or ``miss``."""
        self.tier_hits[kind] = self.tier_hits.get(kind, 0) + 1
        stat_add(f"serving/tier_hit_{kind}")

    # -- admission: prefix matching + table setup --------------------------
    def match_prefix(self, tokens) -> List[int]:
        """Longest chain of cached full blocks covering a PROPER prefix
        of ``tokens`` (capped at ``(len - 1) // block_size`` blocks, so
        at least one token is always recomputed and every write lands
        past the shared region). Returns the physical block ids.
        Read-only."""
        toks = tuple(int(t) for t in tokens)
        bs = self.block_size
        blocks: List[int] = []
        for i in range(1, (len(toks) - 1) // bs + 1):
            node = self._trie.get(toks[:i * bs])
            if node is None:
                break
            blocks.append(node.block)
        return blocks

    def admit_cached(self, slot: int, blocks: List[int]) -> None:
        """Seed the slot's page table with matched prefix blocks
        (refcount++ each; a block leaves the LRU while referenced)."""
        st = self._require(slot)
        if st.table:
            raise BlockError(f"slot {slot} already has a page table")
        for b in blocks:
            rc = self._ref.get(b, 0)
            self._ref[b] = rc + 1
            if rc == 0:
                self._lru.pop(self._block_key.get(b), None)
        st.table = list(blocks)
        self.prefix_hits += 1
        self.tokens_saved += len(blocks) * self.block_size
        self._update_ledger()

    def admit_fresh(self, slot: int, n_tokens: int) -> List[int]:
        """Allocate the page table covering ``[0, n_tokens)``.
        All-or-nothing: on exhaustion the partial allocation is rolled
        back and :class:`PoolExhaustedError` propagates."""
        st = self._require(slot)
        if st.table:
            raise BlockError(f"slot {slot} already has a page table")
        got: List[int] = []
        try:
            for _ in range(self.blocks_for(n_tokens)):
                got.append(self._alloc_block())
        except PoolExhaustedError:
            for b in got:
                self._unref(b)
            raise
        st.table = got
        self.prefix_misses += 1
        return list(got)

    def register_prefix(self, slot: int, tokens) -> None:
        """Publish the slot's full token blocks into the prefix cache
        (after they were written). An existing entry for the same prefix
        stays canonical."""
        st = self._require(slot)
        toks = tuple(int(t) for t in tokens)
        bs = self.block_size
        for i in range(len(toks) // bs):
            key = toks[:(i + 1) * bs]
            if key in self._trie:
                continue
            block = st.table[i]
            if block in self._block_key:
                continue                  # already published elsewhere
            self._trie[key] = _TrieNode(key, block)
            self._block_key[block] = key
            parent = self._trie.get(key[:-bs])
            if parent is not None:
                parent.children.add(key)

    # -- growth + copy-on-write --------------------------------------------
    def unpublish_from(self, slot: int, pos: int) -> None:
        """Drop the prefix-cache registration of the slot's blocks from
        virtual index ``pos`` on: after a speculative rollback, rows of
        rejected draft tokens must not leave a published block whose
        contents no longer match its token key."""
        st = self._require(slot)
        for vb in range(int(pos) // self.block_size, len(st.table)):
            key = self._block_key.get(st.table[vb])
            if key is not None:
                self._drop_node(key)

    def ensure_writable(self, slot: int) -> Optional[Tuple[int, int]]:
        """Guarantee the block holding virtual index ``pos`` exists and
        is exclusively owned before a decode step writes into it.
        Returns the ``(dst, src)`` copy-on-write order, else None. May
        raise :class:`PoolExhaustedError`: the scheduler then preempts."""
        st = self._require(slot)
        return self._ensure_block(slot, st, st.pos // self.block_size)

    def ensure_writable_range(self, slot: int,
                              last_pos: int) -> List[Tuple[int, int]]:
        """Guarantee EVERY block covering virtual indices ``[pos,
        last_pos]`` exists and is exclusively owned (a chunk scatters a
        run of positions in one launch). Returns the copy-on-write
        ``(dst, src)`` orders. On :class:`PoolExhaustedError` mid-growth,
        granted blocks stay on the table and the COW orders collected
        before the failure ride on the exception as ``partial_cows``:
        their table swaps already happened, so the caller must still
        perform those copies."""
        st = self._require(slot)
        if last_pos < st.pos:
            raise ValueError(
                f"slot {slot}: range end {last_pos} precedes pos {st.pos}")
        cows: List[Tuple[int, int]] = []
        for vb in range(st.pos // self.block_size,
                        last_pos // self.block_size + 1):
            try:
                cow = self._ensure_block(slot, st, vb)
            except PoolExhaustedError as e:
                e.partial_cows = list(cows)
                raise
            if cow is not None:
                cows.append(cow)
        return cows

    def _ensure_block(self, slot: int, st: _PagedSlot,
                      vb: int) -> Optional[Tuple[int, int]]:
        if vb > len(st.table):
            raise RuntimeError(
                f"slot {slot}: page table has {len(st.table)} blocks but "
                f"virtual block {vb} is needed — positions outran "
                f"allocation")
        if vb == len(st.table):
            st.table.append(self._alloc_block())
            return None
        b = st.table[vb]
        if self._ref.get(b, 0) > 1:
            nb = self._alloc_block()      # may raise: caller preempts
            st.table[vb] = nb
            self._unref(b)
            return (nb, b)
        key = self._block_key.get(b)
        if key is not None:
            # about to write into a cached block in place: its content
            # will no longer match its key, so unregister it
            self._drop_node(key)
        return None

    def table_bucket(self, slot: int) -> int:
        """Next pow2 over the slot's page-table length, capped at
        ``max_table_len``."""
        n = max(1, len(self._require(slot).table))
        t = 1
        while t < n:
            t *= 2
        return min(t, self.max_table_len)

    def table_array(self, bucket: int, slots) -> np.ndarray:
        """Dense int32 ``[num_slots, bucket]`` page-table operand. Rows
        of slots outside ``slots`` (and padding past a member's table)
        read 0, the scratch block."""
        out = np.zeros((self.num_slots, int(bucket)), np.int32)
        for slot in slots:
            table = self._require(slot).table
            if len(table) > bucket:
                raise RuntimeError(
                    f"slot {slot}: table length {len(table)} exceeds its "
                    f"bucket {bucket}")
            out[slot, :len(table)] = table
        return out

    def slot_table(self, slot: int) -> List[int]:
        return list(self._require(slot).table)

    def _require(self, slot: int) -> _PagedSlot:
        st = self._slots.get(slot)
        if st is None:
            raise ValueError(f"slot {slot} is not allocated")
        return st

    def __repr__(self):
        return (f"<PagedKVPool blocks={self.blocks_in_use}/"
                f"{self.num_blocks} x{self.block_size} "
                f"active={self.n_active}/{self.num_slots} "
                f"cached={len(self._trie)}>")
