"""Copy of `repro.serving.scheduler` for the port.

Admission/retirement scheduler for the continuous-batching engine.

Each engine step the scheduler:
  1. releases newly arrived requests into the ready FIFO,
  2. admits ready requests into free cache-pool slots (strict FIFO — a
     request never overtakes an earlier arrival, even when a later,
     smaller request would fit: head-of-line blocking is the price of
     deterministic admission order),
  3. after the decode step, retires finished or in-flight-deferred
     requests and returns their slots to the pool.

The scheduler drives either pool flavor: `SlotCachePool` (admission
gated on free slots only) or `PagedCachePool` (the engine additionally
passes `can_admit`, gating the FIFO head on block-reservation capacity).

Under oversubscription the engine may also *preempt* a running slot
(`preempt`: the request leaves RUNNING with its state saved and re-enters
the arrival queue age-first) or *drop* one (`drop`: overload shed — the
caller marks the terminal state). Retirement/preemption release the slot
with the pool generation captured at admission, so a stale double release
of a re-allocated slot fails loudly instead of corrupting the free heap.

Invariants (pinned by tests/test_serving_continuous.py and
tests/test_serving_paged.py in the JAX package, and by
tests/test_torch_pressure.py for the port):
  * a slot hosts at most one request at a time;
  * admitted set + free set is always exactly {0..n_slots-1};
  * admission order equals arrival order (preempted requests re-enter
    at their original arrival position).
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

from repro_torch.serving.request import (DEFERRED, DONE, PENDING, PREEMPTED,
                                   RUNNING, ArrivalQueue, Request)


class SlotScheduler:
    """FIFO admission into free pool slots + retirement bookkeeping.
    `pool` is a SlotCachePool or PagedCachePool (anything with
    alloc/release/n_free/in_use)."""

    def __init__(self, pool):
        self.pool = pool
        self.running: Dict[int, Request] = {}     # slot -> request
        # pool generation captured at admission; passed back on release so
        # a stale release of a re-allocated slot raises instead of
        # corrupting the free heap
        self._admit_gen: Dict[int, int] = {}
        # lifetime counters (observability gauges read these; plain ints
        # so the admission/retire paths pay nothing extra)
        self.n_admitted = 0
        self.n_retired = 0
        self.n_preempted = 0

    # -- admission ---------------------------------------------------------
    def admit_ready(self, queue: ArrivalQueue, now: float,
                    limit: Optional[int] = None,
                    can_admit: Optional[Callable[[Request], bool]] = None
                    ) -> List[Tuple[int, Request]]:
        """Admit FIFO-ready requests into free slots. Returns
        [(slot, request), ...] in admission order.

        `can_admit(req)` (paged backend) vetoes admission of the FIFO
        head when the pool cannot reserve its worst-case block count;
        admission then stops entirely — strict FIFO means no later
        request may overtake the blocked head."""
        queue.release(now)
        admitted: List[Tuple[int, Request]] = []
        budget = self.pool.n_free if limit is None else min(limit,
                                                            self.pool.n_free)
        while budget > 0 and queue.n_ready > 0:
            if can_admit is not None and not can_admit(queue.peek_ready()):
                break
            req = queue.pop_ready()
            assert req is not None and req.state in (PENDING, PREEMPTED)
            slot = self.pool.alloc()
            req.slot = slot
            req.state = RUNNING
            if req.t_admit != req.t_admit:   # nan: first admission only
                req.t_admit = now
            req.admit_seq = self.n_admitted
            self.running[slot] = req
            self._admit_gen[slot] = self.pool.generations[slot]
            admitted.append((slot, req))
            self.n_admitted += 1
            budget -= 1
        return admitted

    # -- retirement --------------------------------------------------------
    def retire(self, slot: int, now: float, deferred: bool,
               early: bool = False) -> Request:
        """Remove the request in `slot` from M_S and free the slot.
        `deferred` routes it to the M_L queue; `early` marks an in-flight
        eviction (saved M_S steps)."""
        req = self.running.pop(slot)
        req.slot = None
        req.t_retire = now
        req.deferred = deferred
        req.early_exited = early
        if deferred:
            req.state = DEFERRED
        else:
            req.state = DONE
            req.t_done = now
        self.pool.release(slot, self._admit_gen.pop(slot))
        self.n_retired += 1
        return req

    def preempt(self, slot: int, now: float) -> Request:
        """Evict the request in `slot` under block pressure WITHOUT
        retiring it: the request leaves RUNNING as PREEMPTED (caller has
        already saved its resume state) and must be re-queued by the
        caller. Frees the slot and its blocks."""
        req = self.running.pop(slot)
        req.slot = None
        req.state = PREEMPTED
        req.n_preempted += 1
        self.pool.release(slot, self._admit_gen.pop(slot))
        self.n_preempted += 1
        return req

    def drop(self, slot: int, now: float) -> Request:
        """Remove the request in `slot` without completing it (overload
        shed of an in-flight victim). The caller sets the terminal state
        and telemetry; this only unwinds the slot accounting."""
        req = self.running.pop(slot)
        req.slot = None
        req.t_retire = now
        self.pool.release(slot, self._admit_gen.pop(slot))
        self.n_retired += 1
        return req

    # -- views -------------------------------------------------------------
    @property
    def active_slots(self) -> List[int]:
        return sorted(self.running)

    @property
    def n_active(self) -> int:
        return len(self.running)

    def check_invariants(self) -> None:
        """Assert slot accounting is consistent (used by tests)."""
        in_use = self.pool.in_use
        assert set(self.running) == in_use, (self.running, in_use)
        assert set(self._admit_gen) == in_use, (self._admit_gen, in_use)
        assert len(in_use) + self.pool.n_free == self.pool.n_slots
