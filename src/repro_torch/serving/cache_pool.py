"""Slot-based KV-cache pool for continuous batching.

Counterpart of `repro.serving.cache_pool`. One cache tree is allocated ONCE
with batch = n_slots and lives for the engine's lifetime; requests borrow
a slot (one batch row of every leaf) and return it on retirement.
Admission overwrites the whole row with a freshly prefilled cache, so
stale K/V or recurrent state from the previous tenant never leaks. Every
leaf has its batch axis at 1: GQA ``[L, batch, kv_len, KV, hd]`` (kv_len
= max_len, or a sliding window's ring), MLA ``[L, batch, max_len,
kv_lora | rope_dim]``, RWKV ``shift1``/``shift2`` ``[L, batch, d]`` and
``S`` ``[L, batch, H, hd, hd]``, Mamba2 ``conv`` ``[L, batch, W-1,
d_inner + 2 d_state]`` and ``S`` ``[L, batch, H, d_state, head_dim]``, and
the hybrid's shared block ``k``/``v`` ``[calls, batch, min(kv_len,
4096), KV, hd]`` (absent when the trunk never calls it). The recurrent
states ``S`` stay fp32 in the pool whatever the cache type.
"""
from __future__ import annotations

from typing import List, Optional

import torch

from repro_torch.configs import ModelConfig
from repro_torch.models import transformer as tfm


def scatter_rows(pool_cache: dict, row_cache: dict,
                 slots: torch.Tensor) -> dict:
    """Write `row_cache` (batch = k) into rows `slots` [k] of `pool_cache`
    (batch = n_slots), in place, along axis 1 of every leaf; each row is
    cast to its pool leaf's type (the recurrent ``S`` leaves are fp32 in
    both)."""
    for kind, leaves in row_cache.items():
        for name, rows in leaves.items():
            pool_cache[kind][name][:, slots] = rows.to(
                pool_cache[kind][name].dtype)
    return pool_cache


def cache_bytes(cache: dict) -> int:
    return sum(t.numel() * t.element_size()
               for leaves in cache.values() for t in leaves.values())


class SlotCachePool:
    """Preallocated per-slot KV cache + free-slot bookkeeping. `.cache` is
    updated in place by the engine; `alloc`/`release` manage slot ids."""

    def __init__(self, cfg: ModelConfig, n_slots: int, max_len: int,
                 device, dtype: Optional[torch.dtype] = None):
        if n_slots < 1:
            raise ValueError("n_slots must be >= 1")
        self.cfg = cfg
        self.n_slots = n_slots
        self.max_len = max_len
        self.cache = tfm.init_cache(cfg, n_slots, max_len,
                                    dtype=dtype or cfg.cdtype(), device=device)
        self._free: List[int] = list(range(n_slots - 1, -1, -1))
        self._in_use: set = set()
        # lifetime counters: how many requests each slot has hosted
        self.generations = [0] * n_slots

    def footprint_bytes(self) -> int:
        """Device bytes held by the pool: every slot reserves a full
        `max_len` row regardless of its tenant's length."""
        return cache_bytes(self.cache)

    @property
    def n_free(self) -> int:
        return len(self._free)

    @property
    def in_use(self) -> frozenset:
        return frozenset(self._in_use)

    def alloc(self) -> int:
        """Lowest-numbered free slot (deterministic placement)."""
        if not self._free:
            raise RuntimeError("cache pool exhausted")
        slot = self._free.pop()
        self._in_use.add(slot)
        self.generations[slot] += 1
        return slot

    def release(self, slot: int,
                expected_generation: Optional[int] = None) -> None:
        """Return `slot` to the free list; a double or stale release
        raises instead of corrupting the free list."""
        if slot not in self._in_use:
            raise RuntimeError(
                f"double release of slot {slot}: slot is not in use "
                "(already released or never allocated)")
        if (expected_generation is not None
                and expected_generation != self.generations[slot]):
            raise RuntimeError(
                f"stale release of slot {slot}: caller holds generation "
                f"{expected_generation} but the slot was re-allocated "
                f"(now generation {self.generations[slot]})")
        self._in_use.remove(slot)
        self._free.append(slot)
        self._free.sort(reverse=True)
