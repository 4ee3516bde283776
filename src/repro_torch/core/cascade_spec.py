"""JAX-free copy of `repro.core.cascade_spec`.

Cascade ladder specification: an ordered chain of model tiers joined
by per-edge deferral gates.

The paper's deployment (Fig. 1) is the two-tier special case: M_S local,
M_L remote, one confidence gate g with one calibrated tau. A production
cascade wants a *ladder* — e.g. the 1.8B -> 32B -> 405B shape the
configs/ directory already describes — where each adjacent pair of tiers
has its own deferral signal and threshold, and traffic deferred at edge
i becomes arrival traffic for edge i+1.

`CascadeSpec` is the declarative description the serving engine (and the
offline calibration surface `core.calibration.calibrate_edges`) consume:

    spec = CascadeSpec(
        tiers=[CascadeTier("1.8b", runner=small, cost=0.2),
               CascadeTier("32b",  runner=mid,   cost=0.5),
               CascadeTier("405b", runner=large, cost=1.0)],
        edges=[DeferralEdge(signal="mean_confidence", tau=-2.1),
               DeferralEdge(signal="mean_confidence", tau=-1.7)])

Tier 0 is the slot-resident model the continuous engine decodes in
place; every later tier executes behind a `LargeBackend` (local sync /
thread, or the distributed socket / replica-pool backends — `backend`
takes the same name-or-factory the engine's M_L plumbing always took).
Every edge keeps the repo-wide convention ``deferred = conf < tau``.

`CascadeSpec.two_tier(...)` reproduces today's (small, large, tau)
engine exactly — the parity invariant tests pin it bit-exact.
"""
from __future__ import annotations

import dataclasses
from typing import Any, List, Optional

from repro_torch.core import deferral as deferral_lib


@dataclasses.dataclass
class CascadeTier:
    """One rung of the ladder.

    `runner` is the tier's local `ModelRunner` (required for tier 0 and
    for any tier that calibrates offline or uses a sampling signal);
    `backend` overrides how tiers >= 1 execute — a `LargeBackend` name
    ("sync" | "thread" | "stub") or a callable factory (the socket /
    replica-pool path), defaulting to the engine config's ml.kind.
    `cost` is the tier's relative compute cost (paper Fig. 1 units:
    M_L = 1.0)."""
    name: str
    runner: Any = None
    backend: Any = None
    cost: float = 1.0


@dataclasses.dataclass
class DeferralEdge:
    """The gate between tier i and tier i+1.

    `signal` is a serving-signal name or instance
    (`core.deferral.SERVING_SIGNALS`); `tau` the acceptance threshold
    (``deferred = conf < tau``); `margin`/`min_tokens` shape in-flight
    early exit on edges whose signal supports a running form (evict once
    the running confidence drops below ``tau - margin`` after
    `min_tokens` generated tokens) — they are only meaningful on edge 0,
    the slot-resident tier's gate."""
    signal: Any = "mean_confidence"
    tau: float = -1.0
    margin: float = 0.0
    min_tokens: int = 2

    def __post_init__(self):
        self.signal = deferral_lib.resolve_signal(self.signal)
        self.min_tokens = max(1, int(self.min_tokens))


@dataclasses.dataclass
class CascadeSpec:
    """Ordered ladder of tiers + the deferral edges joining them.

    Invariant: ``len(edges) == len(tiers) - 1``; tier 0 must carry a
    local runner (it lives in the engine's decode slots)."""
    tiers: List[CascadeTier]
    edges: List[DeferralEdge]

    def __post_init__(self):
        if len(self.tiers) < 2:
            raise ValueError(f"a cascade needs at least 2 tiers, "
                             f"got {len(self.tiers)}")
        if len(self.edges) != len(self.tiers) - 1:
            raise ValueError(
                f"a {len(self.tiers)}-tier ladder needs exactly "
                f"{len(self.tiers) - 1} deferral edges, "
                f"got {len(self.edges)}")
        if self.tiers[0].runner is None:
            raise ValueError("tier 0 needs a local ModelRunner: it is "
                             "the slot-resident model the engine decodes")
        for i, t in enumerate(self.tiers[1:], start=1):
            if t.runner is None and t.backend is None:
                raise ValueError(
                    f"tier {i} ({t.name!r}) needs a runner or a backend "
                    f"factory — it has neither")
        for i, e in enumerate(self.edges[1:], start=1):
            if (not e.signal.supports_running
                    and self.tiers[i].runner is None):
                raise ValueError(
                    f"edge {i} uses the {e.signal.name!r} signal, which "
                    f"needs tier {i}'s local runner to draw samples, but "
                    f"tier {i} only has a remote backend")

    @property
    def n_tiers(self) -> int:
        return len(self.tiers)

    @property
    def taus(self) -> List[float]:
        return [e.tau for e in self.edges]

    @property
    def costs(self) -> List[float]:
        return [t.cost for t in self.tiers]

    @classmethod
    def two_tier(cls, small, large, tau: float = -1.0,
                 margin: float = 0.0, min_tokens: int = 2,
                 cost_small: float = 0.2, cost_large: float = 1.0,
                 signal: Any = "mean_confidence",
                 large_backend: Any = None,
                 names: Optional[List[str]] = None) -> "CascadeSpec":
        """The legacy (M_S, M_L, tau) engine shape as a spec — the
        bit-exact-parity construction the deprecation shim maps old
        constructor kwargs onto."""
        names = names or ["small", "large"]
        return cls(
            tiers=[CascadeTier(names[0], runner=small, cost=cost_small),
                   CascadeTier(names[1], runner=large, cost=cost_large,
                               backend=large_backend)],
            edges=[DeferralEdge(signal=signal, tau=tau, margin=margin,
                                min_tokens=min_tokens)])
