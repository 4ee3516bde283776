"""Typed engine configuration for the port's `ContinuousCascadeEngine`.

Copy of `repro.serving.config` for the features the port serves:

    engine = ContinuousCascadeEngine(spec, EngineConfig(
        n_slots=8,
        backend="paged",
        paged=PagedConfig(block_size=8, prefill_chunk=8),
        ml=MLBackendConfig(kind="thread", large_batch=4)))

The old flat-kwargs constructor still works through a back-compat shim
that maps every legacy name onto these fields (`LEGACY_KWARG_MAP` below
is the table) and emits one `DeprecationWarning` with the migration
hint.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

from repro_torch.core.recalibration import RecalibConfig


@dataclasses.dataclass
class PressureConfig:
    """Memory-oversubscription policy for the paged backend.

    oversubscribe   — admit up to `round(n_blocks * oversubscribe)`
                      virtual blocks of reservations (1.0: the classic
                      reservation invariant, physical exhaustion is
                      impossible).
    policy          — what to do when a mapped block is needed but the
                      physical pool is empty:
                      "preempt" — evict the youngest running slot, save
                        its decode state, requeue it age-first (bit-exact
                        resume via the prefix registry);
                      "defer"   — defer the youngest victim to M_L
                        (`deferred_reason="oom"`);
                      "shed"    — drop the youngest victim (REJECTED).
    max_preemptions — preemption bound per request; a victim past the
                      bound escalates to defer-on-OOM so it cannot
                      thrash forever ("preempt" policy only).
    swap_blocks     — host-RAM swap-tier capacity in blocks: cold cached
                      prefix blocks spill here on eviction instead of
                      being dropped, and swap back in on a registry hit
                      (0: no swap tier).
    """
    oversubscribe: float = 1.0
    policy: str = "preempt"
    max_preemptions: int = 2
    swap_blocks: int = 0

    def __post_init__(self):
        if self.oversubscribe < 1.0:
            raise ValueError(f"oversubscribe must be >= 1.0, "
                             f"got {self.oversubscribe}")
        if self.policy not in ("preempt", "defer", "shed"):
            raise ValueError(f"policy must be 'preempt', 'defer' or "
                             f"'shed', got {self.policy!r}")
        if self.max_preemptions < 0:
            raise ValueError("max_preemptions must be >= 0")
        if self.swap_blocks < 0:
            raise ValueError("swap_blocks must be >= 0")


@dataclasses.dataclass
class PagedConfig:
    """Block-paged KV-cache backend knobs (`backend="paged"`).

    block_size     — tokens per cache block.
    n_blocks       — physical block budget (None: worst case, always fits).
    prefill_chunk  — prefill chunk tokens (None: whole prompt in one chunk).
    paged_kernel   — True: the CUDA kernels of the serving path (paged
                     decode and write, the deferral signal, flash prefill
                     attention); False: their plain versions; None:
                     REPRO_PAGED_KERNEL, else on exactly when the model
                     lives on CUDA. The slot backend reads it too, for the
                     kernels it runs (signal, prefill attention and the
                     RWKV6 / Mamba2 recurrence).
    batch_prefill  — pack same-offset prefill chunks of all mid-prefill
                     requests into one dispatch.
    prefix_sharing — copy-on-write prompt-prefix sharing through the
                     pool's prefix registry.
    pressure       — `PressureConfig` enabling oversubscription and the
                     swap tier (None: reservation-only, the default).
    """
    block_size: int = 16
    n_blocks: Optional[int] = None
    prefill_chunk: Optional[int] = None
    paged_kernel: Optional[bool] = None
    batch_prefill: bool = True
    prefix_sharing: bool = True
    pressure: Optional[PressureConfig] = None


@dataclasses.dataclass
class MLBackendConfig:
    """Default execution backend for tiers >= 1 (a tier's own
    `CascadeTier.backend` overrides `kind` per tier).

    kind         — "sync" | "thread" | "stub", or a callable factory
                   (the socket / replica-pool path).
    large_batch  — regeneration batch size per prompt-length group
                   (None: one exact-size batch at drain).
    max_wait     — seconds a partial batch may wait before flushing padded
                   (None: wait for a full batch).
    stub_latency — injected per-batch RPC latency (kind="stub").
    """
    kind: Any = "sync"
    large_batch: Optional[int] = None
    max_wait: Optional[float] = None
    stub_latency: float = 0.0


@dataclasses.dataclass
class EngineConfig:
    """How the continuous engine executes a `CascadeSpec`.

    n_slots        — tier-0 decode slots.
    early_exit     — in-flight deferral on edges whose signal supports a
                     running confidence.
    steps_per_sync — decode steps per host sync (multi-step scheduling).
    backend        — tier-0 KV-cache backend: "slot" | "paged".
    paged          — `PagedConfig` (used when backend="paged").
    ml             — `MLBackendConfig` defaults for tiers >= 1.
    recalibration  — `RecalibConfig` to recalibrate each edge's tau
                     online toward `recalib_target` (None: taus are
                     fixed, the parity-pinned default).
    recalib_target — target deferral ratio(s) the online controller
                     holds: a float for every edge or a per-edge list.
    max_queue      — admission overload control: bound on the READY
                     arrival queue; overflow is shed newest-first as
                     REJECTED (None: unbounded, the default).
    deadline_s     — per-request queueing deadline in seconds from
                     arrival; requests still queued past it are shed as
                     EXPIRED (None: no deadlines). A deadline set on the
                     `Request` itself takes precedence.
    """
    n_slots: int = 8
    early_exit: bool = True
    steps_per_sync: int = 1
    backend: str = "slot"
    paged: PagedConfig = dataclasses.field(default_factory=PagedConfig)
    ml: MLBackendConfig = dataclasses.field(default_factory=MLBackendConfig)
    recalibration: Optional[RecalibConfig] = None
    recalib_target: Any = 0.2
    max_queue: Optional[int] = None
    deadline_s: Optional[float] = None

    def __post_init__(self):
        if self.backend not in ("slot", "paged"):
            raise ValueError(f"backend must be 'slot' or 'paged', "
                             f"got {self.backend!r}")
        if self.n_slots < 1:
            raise ValueError("n_slots must be >= 1")
        if self.paged.pressure is not None and self.backend != "paged":
            raise ValueError("paged.pressure requires backend='paged'")
        if self.max_queue is not None and self.max_queue < 1:
            raise ValueError(f"max_queue must be >= 1, got {self.max_queue}")
        if self.deadline_s is not None and self.deadline_s <= 0:
            raise ValueError(f"deadline_s must be > 0, got {self.deadline_s}")
        self.steps_per_sync = max(1, self.steps_per_sync)


# legacy constructor kwarg -> (object path, field): the shim in
# `ContinuousCascadeEngine.__init__` consumes this table
LEGACY_KWARG_MAP = {
    "n_slots":        ("config", "n_slots"),
    "tau":            ("spec.edges[0]", "tau"),
    "margin":         ("spec.edges[0]", "margin"),
    "min_tokens":     ("spec.edges[0]", "min_tokens"),
    "early_exit":     ("config", "early_exit"),
    "large_batch":    ("config.ml", "large_batch"),
    "large_backend":  ("config.ml", "kind"),
    "large_max_wait": ("config.ml", "max_wait"),
    "stub_latency":   ("config.ml", "stub_latency"),
    "steps_per_sync": ("config", "steps_per_sync"),
    "backend":        ("config", "backend"),
    "block_size":     ("config.paged", "block_size"),
    "n_blocks":       ("config.paged", "n_blocks"),
    "prefill_chunk":  ("config.paged", "prefill_chunk"),
    "paged_kernel":   ("config.paged", "paged_kernel"),
    "batch_prefill":  ("config.paged", "batch_prefill"),
    "prefix_sharing": ("config.paged", "prefix_sharing"),
    "cost_small":     ("spec.tiers[0]", "cost"),
    "cost_large":     ("spec.tiers[1]", "cost"),
}

MIGRATION_HINT = (
    "ContinuousCascadeEngine(small, large, **kwargs) is deprecated: "
    "build a CascadeSpec + EngineConfig instead — "
    "ContinuousCascadeEngine(CascadeSpec.two_tier(small, large, "
    "tau=...), EngineConfig(n_slots=..., "
    "ml=MLBackendConfig(kind=...), paged=PagedConfig(...))). "
    "See docs/serving.md for the full old-kwarg -> config-field table.")
