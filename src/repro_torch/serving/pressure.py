"""Copy of `repro.serving.pressure` for the port.

Pressure policies: what the engine does when the oversubscribed paged
pool runs out of PHYSICAL blocks.

Reservation-only admission (`oversubscribe == 1.0`) never gets here — the
invariant guarantees every admitted request can map its worst case. With
`oversubscribe > 1.0` the pool admits against a *virtual* budget and
`BlockPressure` can fire mid-prefill or mid-decode. The engine then asks
its `PressurePolicy` to pick a victim among the running slots and an
action for it:

  "preempt" — save the victim's decode state (device rows + generated
              tokens), register its context in the prefix registry so
              re-establishing the KV is mostly a registry walk, release
              the slot, and requeue the request age-first. Bounded by
              `max_preemptions` per request, after which the policy
              escalates to "defer" so a request cannot thrash forever.
  "defer"   — the cascade-unique escape hatch: hand the victim straight
              to M_L (`deferred_reason="oom"`) through the existing M_L
              backend. Its M_S work is discarded but the
              request still completes, on M_L.
  "shed"    — drop the victim (REJECTED terminal state, empty tokens).
              Load shedding for deployments that prefer fast failure.

Victim selection is deterministic: the YOUNGEST running slot — max
`admit_seq`, ties broken by max rid — loses. Youngest-victim maximizes
the work preserved (older requests are closer to completion) and matches
vLLM-style last-in preemption, which composes with age-first requeueing
into FIFO-like completion order.
"""
from __future__ import annotations

from typing import Dict, Iterable, Optional, Tuple

from repro_torch.serving.request import Request

# actions a policy may return
PREEMPT = "preempt"
DEFER = "defer"
SHED = "shed"


def select_victim(running: Dict[int, Request],
                  exclude: Iterable[int] = ()) -> Optional[int]:
    """Deterministic victim slot: youngest admission (max admit_seq, tie
    max rid) among `running` minus `exclude`. None if no candidate."""
    ex = set(exclude)
    cands = [(r.admit_seq, r.rid, s) for s, r in running.items()
             if s not in ex]
    if not cands:
        return None
    return max(cands)[2]


class PressurePolicy:
    """Base policy: subclasses set `kind` and override `action_for`."""
    kind = "abstract"

    def __init__(self, max_preemptions: int = 2):
        self.max_preemptions = max_preemptions

    def select(self, running: Dict[int, Request],
               exclude: Iterable[int] = ()
               ) -> Optional[Tuple[int, str]]:
        """(victim_slot, action) or None when there is nothing to evict
        (pressure must then surface as a hard error)."""
        slot = select_victim(running, exclude)
        if slot is None:
            return None
        return slot, self.action_for(running[slot])

    def action_for(self, victim: Request) -> str:
        raise NotImplementedError


class PreemptPolicy(PressurePolicy):
    """Preempt-and-requeue, escalating to defer-on-OOM once a request has
    been preempted `max_preemptions` times (anti-thrash bound)."""
    kind = "preempt"

    def action_for(self, victim: Request) -> str:
        if victim.n_preempted >= self.max_preemptions:
            return DEFER
        return PREEMPT


class DeferOnOomPolicy(PressurePolicy):
    """Always defer the victim up the cascade ladder."""
    kind = "defer"

    def action_for(self, victim: Request) -> str:
        return DEFER


class ShedPolicy(PressurePolicy):
    """Always drop the victim (REJECTED)."""
    kind = "shed"

    def action_for(self, victim: Request) -> str:
        return SHED


_POLICIES = {
    "preempt": PreemptPolicy,
    "defer": DeferOnOomPolicy,
    "shed": ShedPolicy,
}


def make_pressure_policy(kind: str,
                         max_preemptions: int = 2) -> PressurePolicy:
    if kind not in _POLICIES:
        raise ValueError(f"unknown pressure policy {kind!r}; "
                         f"expected one of {sorted(_POLICIES)}")
    return _POLICIES[kind](max_preemptions=max_preemptions)
