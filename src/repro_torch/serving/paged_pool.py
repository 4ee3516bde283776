"""Block-paged KV-cache pool for continuous batching with ragged prompts.

Counterpart of `repro.serving.paged_pool` (see its docstring for the full
design). The cache is stored in fixed-size **blocks** of `block_size`
tokens shared by all slots:

  * every cache leaf is ``[L, n_blocks + 1, block_size, ...]`` (GQA
    ``k``/``v`` end in ``[KV, hd]``, MLA ``ckv``/``kr`` in ``[kv_lora]`` /
    ``[rope_dim]``);
    physical block 0 is a shared **trash block** that is never allocated
    (unmapped page-table entries and writes from inactive decode rows land
    there harmlessly);
  * each slot owns a row of the **page table** ``[n_slots, M]`` mapping
    its logical block ``m`` to a physical block id, 0 meaning unmapped;
  * blocks are mapped on demand and returned at retirement.

Admission is **reservation-based**: admitting a request reserves its
worst-case block count, blocks are mapped lazily, and ``free >= reserved``
guarantees `ensure_mapped` never fails mid-flight. **Oversubscription**
(``oversubscribe > 1``) admits against a virtual budget of
``round(n_blocks * oversubscribe)`` blocks; the invariant becomes
``physical_in_use + reserved_total <= virtual_blocks``, and physical
exhaustion mid-flight raises the typed `BlockPressure`, which the engine's
pressure policy answers (`serving.pressure`). **Host swap tier**
(``swap_blocks > 0``): a cached prefix block evicted for reuse is first
copied to a bounded host store (LRU over chain keys), and `share_prefix`
swaps it back in after a registry miss. **Prefix sharing**:
blocks carry reference counts; a prefix registry keyed on the hash chain
of each full prompt block's tokens lets a new request map already
resident blocks instead of prefilling them. Shared blocks are read-only:
`ensure_writable` copy-on-write clones a shared block before any write,
and `check_write_disjoint` asserts per dispatch that no physical block is
writable from two rows (the paged write kernel's contract).

Differences from the JAX pool: the cache is mutated IN PLACE (a CoW clone
copies block ``old`` to ``new`` in every layer at once, before the next
write dispatch), and `tables_device` is an int32 tensor on the model's
device. Host copies (swapped blocks, `save_block_span` snapshots) are
pinned CPU tensors, one per cache leaf of a block, copied on the current
stream of the cache's device: the stream every cache write is issued on,
so a restore is ordered before the next step reads the block, and a
snapshot after the writes it copies. They may be read on the host only
after that stream has been synchronised (the engine never reads them; it
copies them back).

Invariants (as in the JAX pool, checked by `check_invariants`):
  * per-slot table rows never repeat a block and never map block 0;
  * every block's refcount equals the number of table rows of in-use
    slots that map it; blocks with refcount 0 are exactly the free set;
  * refcounted + free is always exactly {1..n_blocks};
  * physical_in_use + total outstanding reservation <= virtual_blocks
    (len(free) >= reservation at oversubscribe 1);
  * the swap store holds at most `swap_blocks` keys, none of them also in
    the device registry;
  * registry entries point at blocks that are mapped or cached-free,
    bijectively with the reverse map;
  * a slot's table row is all-zero whenever the slot is free.
"""
from __future__ import annotations

import hashlib
import heapq
import math
from collections import OrderedDict
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs import ModelConfig
from repro_torch.models import transformer as tfm
from repro_torch.serving.cache_pool import cache_bytes


class BlockPressure(RuntimeError):
    """Physical block exhaustion under oversubscription.

    Raised by allocation paths (`ensure_mapped` -> `_take_free_block`,
    `cow_clone`, swap-in) when the pool is oversubscribed and no physical
    block is free — an expected, recoverable condition the engine answers
    with its pressure policy (preempt / defer-on-OOM / shed a victim, then
    retry). Never raised at ``oversubscribe == 1``, where the reservation
    invariant makes allocation infallible and exhaustion stays a hard
    RuntimeError."""


def next_pow2(n: int) -> int:
    """Smallest power of two >= max(n, 1) — the shared bucketing policy
    for active-prefix table slicing and batched prefill width."""
    p = 1
    while p < n:
        p *= 2
    return p


def prefix_block_keys(tokens: np.ndarray, block_size: int) -> List[bytes]:
    """Hash-chain keys of every FULL block of `tokens`: key m digests
    (key of block m-1, tokens of block m), so equal keys mean equal whole
    prefixes."""
    out: List[bytes] = []
    prev = b""
    toks = np.ascontiguousarray(tokens, np.int32)
    for m in range(len(toks) // block_size):
        h = hashlib.blake2b(prev, digest_size=16)
        h.update(toks[m * block_size:(m + 1) * block_size].tobytes())
        prev = h.digest()
        out.append(prev)
    return out


def validate_pageable(cfg: ModelConfig, max_len: int) -> None:
    """Raise NotImplementedError unless every cache leaf of `cfg` is a
    full-length attention cache, as the JAX pool's check does: recurrent
    state (RWKV6, and the Mamba2 hybrid's) and windowed ring caches go to
    the slot backend. A window no shorter than `max_len` leaves a linear
    cache, which JAX's check passes and its paged attention then refuses
    (it asserts no window); the port refuses it here."""
    if cfg.recurrent:
        raise NotImplementedError(
            f"paged KV cache requires attention caches only; family "
            f"{cfg.family!r} keeps a recurrent state, which cannot be paged "
            f"— use the slot backend")
    if cfg.sliding_window is not None:
        raise NotImplementedError(
            f"paged KV cache takes no sliding window (window "
            f"{cfg.sliding_window}): windowed/ring caches go to the slot "
            f"backend")
    tfm.attn_config(cfg)            # the port's attention caches


class PagedCachePool:
    """Block-paged per-slot cache + slot/block/reservation bookkeeping.

    The **slot** API (`alloc`/`release`/`n_free`/`in_use`) matches
    `SlotCachePool`, so `SlotScheduler` drives either pool; the **block**
    API (`can_reserve`/`reserve`/`ensure_mapped`) makes admission
    ragged-aware; the **sharing** API (`share_prefix`/`register_prefix`/
    `ensure_writable`/`cow_clone`/`check_write_disjoint`) lets slots alias
    read-only prompt blocks safely."""

    def __init__(self, cfg: ModelConfig, n_slots: int, n_blocks: int,
                 block_size: int, max_len: int, device,
                 dtype: Optional[torch.dtype] = None,
                 oversubscribe: float = 1.0, swap_blocks: int = 0):
        if n_slots < 1:
            raise ValueError("n_slots must be >= 1")
        if block_size < 1 or n_blocks < 1:
            raise ValueError("block_size and n_blocks must be >= 1")
        if oversubscribe < 1.0:
            raise ValueError(f"oversubscribe must be >= 1.0, "
                             f"got {oversubscribe}")
        if swap_blocks < 0:
            raise ValueError(f"swap_blocks must be >= 0, got {swap_blocks}")
        validate_pageable(cfg, max_len)
        self.cfg = cfg
        self.n_slots = n_slots
        self.n_blocks = n_blocks
        self.block_size = block_size
        self.max_len = max_len
        self.device = torch.device(device)
        # logical blocks a slot may address (max_len plus one block of
        # slack for padded-chunk clamping)
        self.max_blocks = math.ceil(max_len / block_size) + 1
        # batch = blocks gives exactly the paged layout (block 0 = trash)
        self.cache = tfm.init_cache(cfg, n_blocks + 1, block_size,
                                    dtype=dtype or cfg.cdtype(), device=device)

        # host bookkeeping
        self.tables = np.zeros((n_slots, self.max_blocks), np.int32)
        self.n_mapped = np.zeros(n_slots, np.int64)
        self.ref = np.zeros(n_blocks + 1, np.int64)  # per-block refcount
        self._owed = np.zeros(n_slots, np.int64)     # reserved, not yet mapped
        self._reserved_total = 0
        # free blocks: plain (never registered) preferred over cached
        # (registered prefix, content intact); lowest id first in each
        self._free_plain: List[int] = list(range(1, n_blocks + 1))
        self._free_cached: List[int] = []
        self._free_set: set = set(self._free_plain)
        self._free_slots: List[int] = list(range(n_slots))  # min-heap
        self._in_use: set = set()
        # prefix registry: chain key -> physical block, plus reverse map
        self._prefix_registry: Dict[bytes, int] = {}
        self._registered_key: Dict[int, bytes] = {}
        self.generations = [0] * n_slots
        self.peak_mapped = 0           # high-water physical blocks in use
        self.shared_blocks_total = 0   # lifetime blocks mapped via sharing
        self.cow_clones = 0            # lifetime copy-on-write clones
        # oversubscription: virtual reservation budget (== n_blocks at
        # factor 1, where the classic free >= reserved invariant holds)
        self.oversubscribe = float(oversubscribe)
        self.virtual_blocks = int(round(n_blocks * self.oversubscribe))
        # host swap tier: chain key -> host copy of the block's leaves
        # (insertion-ordered for LRU eviction), bounded capacity
        self.swap_blocks = int(swap_blocks)
        self._swap: "OrderedDict[bytes, dict]" = OrderedDict()
        self.swap_outs = 0             # lifetime device -> host spills
        self.swap_ins = 0              # lifetime host -> device restores
        self._tables_cache: Dict[Optional[int], torch.Tensor] = {}

    # -- capacity / accounting --------------------------------------------
    def blocks_for(self, n_tokens: int) -> int:
        """Physical blocks needed to store `n_tokens` cache entries."""
        return max(0, math.ceil(n_tokens / self.block_size))

    @property
    def n_free_blocks(self) -> int:
        return len(self._free_set)

    @property
    def n_physical_in_use(self) -> int:
        """Physical blocks allocated (refcount > 0); shared blocks once."""
        return self.n_blocks - len(self._free_set)

    def footprint_bytes(self) -> int:
        """Device bytes held by the paged cache (all physical blocks)."""
        return cache_bytes(self.cache)

    # -- slot bookkeeping (SlotCachePool-compatible) ----------------------
    @property
    def n_free(self) -> int:
        return len(self._free_slots)

    @property
    def in_use(self) -> frozenset:
        return frozenset(self._in_use)

    def alloc(self) -> int:
        """Lowest-numbered free slot (deterministic placement)."""
        if not self._free_slots:
            raise RuntimeError("cache pool exhausted")
        slot = heapq.heappop(self._free_slots)
        self._in_use.add(slot)
        self.generations[slot] += 1
        return slot

    def release(self, slot: int,
                expected_generation: Optional[int] = None) -> None:
        """Free the slot: drop its blocks' refcounts (zero-ref blocks go
        back to the free heaps, registered ones as cached), its
        reservation, and its table row. Double or stale release raises."""
        if slot not in self._in_use:
            raise RuntimeError(
                f"double release of slot {slot}: slot is not in use "
                f"(already released or never allocated)")
        if (expected_generation is not None
                and expected_generation != self.generations[slot]):
            raise RuntimeError(
                f"stale release of slot {slot}: caller holds generation "
                f"{expected_generation} but the slot was re-allocated "
                f"(now generation {self.generations[slot]})")
        self._in_use.remove(slot)
        heapq.heappush(self._free_slots, slot)
        for m in range(int(self.n_mapped[slot])):
            blk = int(self.tables[slot, m])
            self.ref[blk] -= 1
            if self.ref[blk] == 0:
                self._push_free(blk)
        self._reserved_total -= int(self._owed[slot])
        self._owed[slot] = 0
        self.n_mapped[slot] = 0
        self.tables[slot] = 0
        self._tables_cache.clear()

    # -- free-block heaps (lazy deletion) ----------------------------------
    def _push_free(self, blk: int) -> None:
        heap = (self._free_cached if blk in self._registered_key
                else self._free_plain)
        heapq.heappush(heap, blk)
        self._free_set.add(blk)

    def _pop_free(self) -> int:
        """Lowest-id unregistered free block, else evict (deregister) the
        lowest-id cached one, spilling it to the host swap store first
        when there is one. Caller owns the block (ref set to 1).
        Exhaustion raises `BlockPressure` when oversubscribed, a hard
        RuntimeError otherwise (a bookkeeping bug)."""
        for heap in (self._free_plain, self._free_cached):
            while heap:
                blk = heapq.heappop(heap)
                if blk not in self._free_set:
                    continue                    # stale lazy-deleted entry
                self._free_set.remove(blk)
                key = self._registered_key.pop(blk, None)
                if key is not None:             # evict the cached prefix
                    del self._prefix_registry[key]
                    if self.swap_blocks > 0:
                        self._swap_out(blk, key)
                self.ref[blk] = 1
                return blk
        if self.virtual_blocks > self.n_blocks:
            raise BlockPressure(
                f"paged pool out of physical blocks ({self.n_blocks} "
                f"in use, {self._reserved_total} still reserved) under "
                f"oversubscription x{self.oversubscribe:g}")
        raise RuntimeError("paged pool out of blocks — reservation "
                           "invariant violated")

    def _take_free_block(self, slot: int) -> int:
        """Allocate one fresh block for `slot`, charged against its
        reservation — or, beyond it, against unreserved virtual headroom.
        The reservation is charged only after the pop succeeds, so a
        `BlockPressure` leaves the books untouched for a retry."""
        charged = self._owed[slot] > 0
        if not charged and (self.n_physical_in_use + 1
                            + self._reserved_total > self.virtual_blocks):
            raise RuntimeError(
                f"slot {slot} mapping beyond its reservation would leave "
                f"free ({len(self._free_set) - 1}) < reserved "
                f"({self._reserved_total}) — raise n_blocks or reserve "
                f"the slack explicitly")
        blk = self._pop_free()
        if charged:
            self._owed[slot] -= 1
            self._reserved_total -= 1
        self.peak_mapped = max(self.peak_mapped, self.n_physical_in_use)
        return blk

    # -- block reservation / mapping --------------------------------------
    def can_reserve(self, n_tokens: int) -> bool:
        """True if a request needing `n_tokens` cache entries fits the
        (possibly oversubscribed) reservation budget: ``physical_in_use +
        reserved_total + need <= virtual_blocks``, at oversubscribe 1
        exactly ``free - reserved >= need``."""
        return (self.n_physical_in_use + self._reserved_total
                + self.blocks_for(n_tokens) <= self.virtual_blocks)

    def reserve(self, slot: int, n_tokens: int) -> None:
        """Reserve the slot's worst-case block count (after
        `can_reserve`)."""
        need = self.blocks_for(n_tokens)
        if (self.n_physical_in_use + self._reserved_total + need
                > self.virtual_blocks):
            raise RuntimeError("paged pool over-reserved: admission must "
                               "check can_reserve() first")
        self._owed[slot] = need
        self._reserved_total += need

    def ensure_mapped(self, slot: int, n_tokens: int) -> int:
        """Map blocks until the slot covers `n_tokens` logical entries.
        An oversubscribed pool may raise `BlockPressure` mid-way; progress
        is kept and the call is idempotent, so the caller retries the same
        demand after relieving pressure. Returns the number of newly
        mapped blocks."""
        need = self.blocks_for(n_tokens)
        newly = 0
        while int(self.n_mapped[slot]) < need:
            blk = self._take_free_block(slot)
            self.tables[slot, int(self.n_mapped[slot])] = blk
            self.n_mapped[slot] += 1
            newly += 1
        if newly:
            self._tables_cache.clear()
        return newly

    # -- host copies: swap tier and preemption snapshots ---------------------
    def _block_to_host(self, blk: int) -> dict:
        """Host copy of physical block `blk`: {kind: {leaf: [L, bs, ...]}},
        pinned when the cache is on a GPU, copied on its current stream."""
        out = {}
        for kind, leaves in self.cache.items():
            out[kind] = {}
            for name, leaf in leaves.items():
                src = leaf[:, blk]
                if leaf.is_cuda:
                    buf = torch.empty(src.shape, dtype=src.dtype,
                                      pin_memory=True)
                    buf.copy_(src, non_blocking=True)
                else:
                    buf = src.clone()
                out[kind][name] = buf
        return out

    def _block_from_host(self, blk: int, host: dict) -> None:
        """Write a `_block_to_host` copy over physical block `blk`."""
        for kind, leaves in self.cache.items():
            for name, leaf in leaves.items():
                leaf[:, blk].copy_(host[kind][name], non_blocking=True)

    def _swap_out(self, blk: int, key: bytes) -> None:
        """Spill an evicted cached block to the host store before its
        device block goes to a new owner (LRU over chain keys, bounded
        by `swap_blocks`)."""
        self._swap[key] = self._block_to_host(blk)
        self._swap.move_to_end(key)
        self.swap_outs += 1
        while len(self._swap) > self.swap_blocks:
            self._swap.popitem(last=False)      # LRU: drop the coldest

    def _swap_in(self, slot: int, key: bytes) -> int:
        """Restore a swapped-out prefix block: allocate a device block
        (charged to `slot` like a fresh mapping — may raise
        `BlockPressure`), copy the host contents back, and re-register the
        chain key. Returns the new physical id with ref set to 1."""
        blk = self._take_free_block(slot)        # BlockPressure-able
        self._block_from_host(blk, self._swap.pop(key))
        self._prefix_registry[key] = blk
        self._registered_key[blk] = key
        self.swap_ins += 1
        return blk

    def save_block_span(self, slot: int, lo: int, hi: int) -> list:
        """Host snapshot of the physical blocks covering token span [lo,
        hi) of `slot` (whole blocks; `lo` rounds down to a block
        boundary), one `{kind: {leaf: [L, bs, ...]}}` per block. The
        preemption path keeps the DECODE-written region of a victim this
        way: decode-written K/V is not bit-identical to a prefill
        recompute of the same positions, so it must survive preemption
        verbatim. Every cache leaf the config holds is copied (GQA k/v,
        MLA ckv/kr)."""
        if hi <= lo:
            return []
        return [self._block_to_host(int(self.tables[slot, m]))
                for m in range(lo // self.block_size,
                               (hi - 1) // self.block_size + 1)]

    def restore_block_span(self, slot: int, lo: int, hi: int,
                           saved: list) -> None:
        """Write a `save_block_span` snapshot back over the SAME token
        span of `slot`'s (re-mapped) table. The span's blocks must be
        mapped and write-private (the resume path maps them fresh);
        restoring over a shared or registered block would corrupt another
        reader."""
        if hi <= lo:
            return
        ms = range(lo // self.block_size, (hi - 1) // self.block_size + 1)
        for m, host in zip(ms, saved):
            blk = int(self.tables[slot, m])
            assert blk > 0 and self.ref[blk] == 1 \
                and blk not in self._registered_key, \
                (f"restore_block_span: slot {slot} block {m} (phys {blk}) "
                 f"is not a private mapped block")
            self._block_from_host(blk, host)

    # -- prefix sharing / copy-on-write ------------------------------------
    def share_prefix(self, slot: int, tokens: np.ndarray) -> int:
        """Map the longest registered prefix of `tokens` into `slot`'s
        (empty) table row without prefilling it; returns the prompt tokens
        covered (a multiple of `block_size`). Keys missing from the device
        registry but held by the host swap store are swapped back in (on
        `BlockPressure` matching stops at the blocks recovered). Aliased
        blocks give their reservation back — minus one block of slack when
        the whole prompt is shared with an aliased tail, so its worst-case
        `cow_clone` (the final prompt token is recomputed in place) cannot
        fail."""
        assert int(self.n_mapped[slot]) == 0, \
            "share_prefix needs an empty table row"
        shared = 0
        aliased = 0
        for m, key in enumerate(prefix_block_keys(tokens, self.block_size)):
            blk = self._prefix_registry.get(key)
            if blk is None:
                if self.swap_blocks <= 0 or key not in self._swap:
                    break
                try:
                    blk = self._swap_in(slot, key)
                except BlockPressure:
                    break        # keep what was recovered; caller prefills
            elif self.ref[blk] == 0:
                # cached free block: resurrect, charged like a fresh
                # mapping (or, past the reservation, only within headroom)
                if self._owed[slot] <= 0 and (
                        self.n_physical_in_use + 1 + self._reserved_total
                        > self.virtual_blocks):
                    break
                self._free_set.remove(blk)
                if self._owed[slot] > 0:
                    self._owed[slot] -= 1
                    self._reserved_total -= 1
                self.ref[blk] = 1
            else:
                self.ref[blk] += 1
                aliased += 1
            self.tables[slot, m] = blk
            self.n_mapped[slot] += 1
            shared += 1
        if shared:
            give = aliased
            if (shared * self.block_size >= len(tokens)
                    and self.ref[int(self.tables[slot, shared - 1])] > 1):
                give -= 1
            give = min(max(give, 0), int(self._owed[slot]))
            self._owed[slot] -= give
            self._reserved_total -= give
            self.shared_blocks_total += shared
            self._tables_cache.clear()
            self.peak_mapped = max(self.peak_mapped, self.n_physical_in_use)
        return shared * self.block_size

    def register_prefix(self, slot: int, tokens: np.ndarray) -> int:
        """Publish `slot`'s fully-prefilled prompt blocks for later
        `share_prefix` calls; first registration of a key wins. `tokens`
        may be a cut prompt (a victim preempted mid-prefill publishes the
        chunks it wrote). Returns how many entries were added."""
        n = 0
        for m, key in enumerate(prefix_block_keys(tokens, self.block_size)):
            if m >= int(self.n_mapped[slot]):
                break
            blk = int(self.tables[slot, m])
            if key in self._prefix_registry or blk in self._registered_key:
                continue
            self._prefix_registry[key] = blk
            self._registered_key[blk] = key
            # a device registration supersedes any stale host copy (swap
            # keys and registry keys stay disjoint)
            self._swap.pop(key, None)
            n += 1
        return n

    def cow_clone(self, slot: int, m: int) -> int:
        """Copy-on-write: give `slot` a private copy of its logical block
        `m` (currently aliased by another slot). The copy is made in
        place, in every layer at once. Returns the new physical id."""
        old = int(self.tables[slot, m])
        assert old > 0 and self.ref[old] > 1, \
            f"cow_clone: slot {slot} block {m} (phys {old}) is not shared"
        new = self._take_free_block(slot)
        self.ref[old] -= 1
        self.tables[slot, m] = new
        self._tables_cache.clear()
        self.cow_clones += 1
        for leaves in self.cache.values():
            for leaf in leaves.values():
                leaf[:, new] = leaf[:, old]        # [L, bs, ...] copy
        return new

    def ensure_writable(self, slot: int, lo: int, hi: int) -> int:
        """CoW-clone every mapped block of `slot` holding a position in
        [lo, hi) whose refcount exceeds one. Returns the clone count."""
        if hi <= lo:
            return 0
        m_hi = min((hi - 1) // self.block_size, int(self.n_mapped[slot]) - 1)
        n = 0
        for m in range(lo // self.block_size, m_hi + 1):
            blk = int(self.tables[slot, m])
            if blk > 0 and self.ref[blk] > 1:
                self.cow_clone(slot, m)
                n += 1
        return n

    def check_write_disjoint(self,
                             ranges: Iterable[Tuple[int, int, int]]) -> None:
        """Raise unless the physical blocks writable by one dispatch —
        (slot, lo, hi) token spans, one per row — are pairwise disjoint
        across rows. Trash-block targets are exempt."""
        owner: Dict[int, int] = {}
        for slot, lo, hi in ranges:
            if hi <= lo:
                continue
            m_hi = min((hi - 1) // self.block_size,
                       int(self.n_mapped[slot]) - 1)
            for m in range(lo // self.block_size, m_hi + 1):
                blk = int(self.tables[slot, m])
                if blk == 0:
                    continue
                prev = owner.get(blk)
                if prev is not None and prev != slot:
                    raise RuntimeError(
                        f"paged write aliasing: block {blk} is writable "
                        f"from slots {prev} and {slot} in one dispatch — "
                        f"CoW guard failed (ensure_writable not called?)")
                owner[blk] = slot

    # -- observability ------------------------------------------------------
    @property
    def n_shared_blocks(self) -> int:
        """Physical blocks currently aliased by more than one slot."""
        return int((self.ref > 1).sum())

    @property
    def n_cached_blocks(self) -> int:
        """Zero-ref blocks still holding a registered prefix."""
        return sum(1 for b in self._registered_key if b in self._free_set)

    @property
    def n_swapped_blocks(self) -> int:
        """Prefix blocks currently living only in the host swap store."""
        return len(self._swap)

    def register_metrics(self, reg) -> None:
        """Expose pool occupancy as pull-mode gauges on a registry."""
        g = reg.gauge("serving_pool_blocks",
                      "paged KV pool physical blocks by state", ("kind",))
        g.labels(kind="total").set_fn(lambda: self.n_blocks)
        g.labels(kind="free").set_fn(lambda: len(self._free_set))
        g.labels(kind="reserved").set_fn(lambda: self._reserved_total)
        g.labels(kind="in_use").set_fn(lambda: self.n_physical_in_use)
        g.labels(kind="refcounted").set_fn(lambda: self.n_shared_blocks)
        g.labels(kind="cached").set_fn(lambda: self.n_cached_blocks)
        g.labels(kind="peak").set_fn(lambda: self.peak_mapped)
        g.labels(kind="virtual").set_fn(lambda: self.virtual_blocks)
        g.labels(kind="swapped").set_fn(lambda: self.n_swapped_blocks)
        reg.gauge("serving_pool_cow_clones_total",
                  "lifetime copy-on-write block clones",
                  fn=lambda: self.cow_clones)
        reg.gauge("serving_pool_shared_blocks_total",
                  "lifetime blocks mapped via prefix sharing",
                  fn=lambda: self.shared_blocks_total)
        s = reg.gauge("serving_pool_swap_total",
                      "lifetime host swap-tier transfers", ("dir",))
        s.labels(dir="out").set_fn(lambda: self.swap_outs)
        s.labels(dir="in").set_fn(lambda: self.swap_ins)

    def active_prefix_blocks(self, n_tokens: int) -> int:
        """Logical blocks covering `n_tokens` entries, bucketed up to a
        power of two and clamped to `max_blocks`: decode walks only this
        table prefix."""
        return min(next_pow2(self.blocks_for(n_tokens)), self.max_blocks)

    def tables_device(self, prefix: Optional[int] = None) -> torch.Tensor:
        """The page table (or its first `prefix` columns) as a contiguous
        int32 tensor on the cache's device, rebuilt only after the host
        table changed."""
        if prefix is not None and prefix >= self.max_blocks:
            prefix = None
        got = self._tables_cache.get(prefix)
        if got is None:
            host = self.tables if prefix is None else self.tables[:, :prefix]
            got = torch.from_numpy(np.ascontiguousarray(host)).to(self.device)
            self._tables_cache[prefix] = got
        return got

    # -- invariants (tests) ------------------------------------------------
    def check_invariants(self) -> None:
        counts = np.zeros(self.n_blocks + 1, np.int64)
        for s in range(self.n_slots):
            row = [int(self.tables[s, m])
                   for m in range(int(self.n_mapped[s]))]
            assert 0 not in row, "trash block mapped"
            assert len(row) == len(set(row)), \
                f"slot {s} maps a block twice in its own row"
            for b in row:
                counts[b] += 1
        assert (counts[1:] == self.ref[1:]).all(), \
            "refcount drift: ref[] != table-row mapping counts"
        mapped = {b for b in range(1, self.n_blocks + 1) if self.ref[b] > 0}
        free = set(self._free_set)
        assert mapped.isdisjoint(free), "free block still referenced"
        assert mapped | free == set(range(1, self.n_blocks + 1)), \
            "blocks leaked"
        if self.virtual_blocks == self.n_blocks:
            assert len(free) >= self._reserved_total >= 0, \
                "reservation exceeds free blocks"
        else:
            assert self._reserved_total >= 0
        # the oversubscription-aware reservation invariant; the classic
        # free >= reserved at factor 1
        assert (self.n_physical_in_use + self._reserved_total
                <= self.virtual_blocks), \
            "physical_in_use + reserved exceeds the virtual budget"
        for key, blk in self._prefix_registry.items():
            assert self._registered_key.get(blk) == key, \
                "registry / reverse-map mismatch"
        assert len(self._registered_key) == len(self._prefix_registry)
        # swap tier: bounded, key-disjoint from the device registry; a
        # swapped-out prefix owns no physical block, so no table row can
        # reach one
        assert len(self._swap) <= max(self.swap_blocks, 0), \
            "swap store exceeds its capacity"
        assert not (set(self._swap) & set(self._prefix_registry)), \
            "chain key registered on device AND swapped to host"
        for s in range(self.n_slots):
            if s not in self._in_use:
                assert (self.tables[s] == 0).all(), \
                    f"free slot {s} holds mapped blocks"
        assert len(self._in_use) + len(self._free_slots) == self.n_slots
