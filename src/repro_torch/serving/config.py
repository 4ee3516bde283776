"""Typed engine configuration for the port's `ContinuousCascadeEngine`.

Copy of `repro.serving.config` for the features the port serves. Not
ported yet (see ROADMAP.md): the memory-pressure config (oversubscription,
preemption, swap tier), online recalibration, admission overload control
(max_queue / deadlines), the thread/stub/socket/pool M_L backends, and the
legacy flat-kwargs constructor shim.
"""
from __future__ import annotations

import dataclasses
from typing import Optional


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
    """
    block_size: int = 16
    n_blocks: Optional[int] = None
    prefill_chunk: Optional[int] = None
    paged_kernel: Optional[bool] = None
    batch_prefill: bool = True
    prefix_sharing: bool = True


@dataclasses.dataclass
class MLBackendConfig:
    """Batching of tier 1 (M_L), which runs on the sync backend.

    large_batch  — regeneration batch size per prompt-length group
                   (None: one exact-size batch at drain).
    max_wait     — seconds a partial batch may wait before flushing padded
                   (None: wait for a full batch).
    """
    large_batch: Optional[int] = None
    max_wait: Optional[float] = None


@dataclasses.dataclass
class EngineConfig:
    """How the continuous engine executes a `CascadeSpec`.

    n_slots        — tier-0 decode slots.
    early_exit     — in-flight deferral on edges whose signal supports a
                     running confidence.
    steps_per_sync — decode steps per host sync (multi-step scheduling).
    backend        — tier-0 KV-cache backend: "slot" | "paged".
    paged          — `PagedConfig` (used when backend="paged").
    ml             — `MLBackendConfig` for tier 1.
    """
    n_slots: int = 8
    early_exit: bool = True
    steps_per_sync: int = 1
    backend: str = "slot"
    paged: PagedConfig = dataclasses.field(default_factory=PagedConfig)
    ml: MLBackendConfig = dataclasses.field(default_factory=MLBackendConfig)

    def __post_init__(self):
        if self.backend not in ("slot", "paged"):
            raise ValueError(f"backend must be 'slot' or 'paged', "
                             f"got {self.backend!r}")
        if self.n_slots < 1:
            raise ValueError("n_slots must be >= 1")
        self.steps_per_sync = max(1, self.steps_per_sync)
