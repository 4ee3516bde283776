"""M_L regeneration backend for the port's continuous cascade engine.

Copy of the synchronous path of `repro.serving.large_backend`: the
submit/poll/flush/drain protocol, the shared `BatchPolicy`, and
`SyncLocalBackend`, which runs each released batch inline on the
caller's thread through `ModelRunner.generate`. The threaded, stub and
remote backends are not ported yet (see ROADMAP.md).
"""
from __future__ import annotations

import dataclasses
import functools
import math
import time
from typing import Any, Callable, Dict, List, Optional, Protocol, Tuple

import numpy as np

from repro_torch.serving.request import Request

# flush reasons recorded per batch (telemetry / no-starvation tests)
FLUSH_FULL = "full"          # a prompt-length group reached large_batch
FLUSH_MAX_WAIT = "max_wait"  # oldest pending exceeded max_wait
FLUSH_DRAIN = "drain"        # end-of-run drain

# batch occupancy is a fraction in (0, 1]: fixed fine-grained buckets
OCCUPANCY_BUCKETS = (0.125, 0.25, 0.375, 0.5, 0.625, 0.75, 0.875, 1.0)


class _BackendMetrics:
    """Optional metrics hooks shared by every backend. Built from a
    `MetricsRegistry` (observability layer) or as a no-op; the worker
    thread records through it, the engine thread scrapes — the registry
    primitives are lock-protected."""

    def __init__(self, registry=None, backend=None):
        self.enabled = registry is not None
        if not self.enabled:
            return
        self._batches = registry.counter(
            "serving_ml_batches_total",
            "M_L regeneration batches by flush reason", ("reason",))
        self._occupancy = registry.histogram(
            "serving_ml_batch_occupancy",
            "real rows / dispatched rows per M_L batch",
            buckets=OCCUPANCY_BUCKETS)
        if backend is not None:
            registry.gauge("serving_ml_queue_depth",
                           "requests submitted to the M_L backend and "
                           "not yet returned",
                           fn=lambda: backend.n_pending)

    def record_batch(self, n_real: int, pad_to: int, reason: str) -> None:
        if self.enabled:
            self._batches.labels(reason=reason).inc()
            self._occupancy.observe(n_real / max(pad_to, 1))


@dataclasses.dataclass
class LargeResult:
    """One completed M_L regeneration, as returned by `poll`/`drain`."""
    rid: int
    tokens: np.ndarray           # [max_new] int32 final tokens
    batch_id: int
    n_real: int                  # real rows in the regeneration batch
    pad_to: int                  # rows actually dispatched (>= n_real)
    reason: str                  # FLUSH_FULL | FLUSH_MAX_WAIT | FLUSH_DRAIN
    prompt_len: int
    confidence: float = math.nan  # eq.-8 mean confidence of this row
    # (nan when the backend predates the field — cascade ladders gate
    # intermediate tiers on it, the last tier ignores it)


@dataclasses.dataclass
class _Pending:
    """Backend-internal view of one submitted request (the stub backend
    reconstructs these from serialized payloads — no shared objects)."""
    rid: int
    prompt: np.ndarray
    t_submit: float              # backend-internal monotonic clock


class BatchPolicy:
    """Batch *shape* policy shared by every backend (and both the
    mid-run and end-of-run flush paths — they used to diverge).

    Pending requests group by prompt length (ragged deferrals can't
    share one prefill shape).  A group flushes when:

      * it reaches `large_batch` rows (FLUSH_FULL, no padding needed);
      * its oldest member has waited `max_wait` seconds (FLUSH_MAX_WAIT,
        padded up to `large_batch` so the compiled shape is reused by
        later partial flushes of the same hot length);
      * the run drains (FLUSH_DRAIN — padded only when the drain is a
        SINGLE length group: uniform leftovers then reuse the mid-run
        compiled shape, while multi-length ragged drains go exact-size,
        since padding every length group would just multiply M_L
        compute on shapes that are never reused again).

    `large_batch=None` means batch only at drain, exact-size (the
    bit-identical-to-static reference path).  Padding duplicates the
    group's first row; pad rows are discarded on return.
    """

    def __init__(self, large_batch: Optional[int],
                 max_wait: Optional[float] = None):
        self.large_batch = large_batch
        self.max_wait = max_wait
        self._groups: Dict[int, List[_Pending]] = {}

    def add(self, item: _Pending) -> None:
        self._groups.setdefault(int(item.prompt.shape[0]), []).append(item)

    @property
    def n_pending(self) -> int:
        return sum(len(g) for g in self._groups.values())

    def next_deadline(self) -> Optional[float]:
        """Monotonic time at which the oldest pending group times out
        (None when no timer applies)."""
        if self.max_wait is None or not self._groups:
            return None
        oldest = min(g[0].t_submit for g in self._groups.values() if g)
        return oldest + self.max_wait

    def take(self, now: float, drain: bool = False
             ) -> List[Tuple[List[_Pending], int, str]]:
        """Pop every group ready to flush. Returns
        [(rid-sorted group, pad_to, reason)] — pad_to == len(group) when
        no padding applies."""
        out: List[Tuple[List[_Pending], int, str]] = []
        drain_multi_len = drain and sum(
            1 for g in self._groups.values()
            if g and (self.large_batch is None
                      or len(g) % self.large_batch)) > 1
        for plen in sorted(self._groups):
            group = self._groups[plen]
            while (self.large_batch is not None
                   and len(group) >= self.large_batch):
                take, self._groups[plen] = (group[:self.large_batch],
                                            group[self.large_batch:])
                group = self._groups[plen]
                out.append((sorted(take, key=lambda p: p.rid),
                            self.large_batch, FLUSH_FULL))
            if not group:
                continue
            timed_out = (self.max_wait is not None
                         and now - group[0].t_submit >= self.max_wait)
            if drain or timed_out:
                pad = (self.large_batch
                       if self.large_batch is not None else len(group))
                if drain_multi_len:
                    pad = len(group)
                out.append((sorted(group, key=lambda p: p.rid), pad,
                            FLUSH_DRAIN if drain else FLUSH_MAX_WAIT))
                self._groups[plen] = []
        self._groups = {p: g for p, g in self._groups.items() if g}
        return out


def _generate_batch(generate: Callable, group: List[_Pending], pad_to: int,
                    max_new: int) -> Tuple[np.ndarray, np.ndarray]:
    """Run one rid-sorted, uniform-length group through M_L, padded to
    `pad_to` rows by duplicating the first row (the compiled shape is
    then reused across partial flushes). Returns
    ([len(group), max_new] tokens, [len(group)] mean confidences)."""
    prompts = np.stack([p.prompt for p in group])
    b = len(group)
    if pad_to > b:
        prompts = np.concatenate(
            [prompts, np.repeat(prompts[:1], pad_to - b, axis=0)])
    tokens, conf = generate(prompts, int(prompts.shape[1]), max_new)
    # runners may report no confidence (conf=None) — nan rows then, the
    # LargeResult default, so only ladder-gated tiers require the signal
    conf = (np.full(b, math.nan) if conf is None
            else np.asarray(conf, np.float64))
    return tokens[:b], conf[:b]


class LargeBackend(Protocol):
    """Protocol every M_L backend implements (see module docstring).

    `poll` takes an optional `timeout`: None/0 returns whatever has
    completed without blocking; a positive value may block up to that
    long waiting for the FIRST result (the engine's drain loop uses it
    to avoid busy-waiting). Every implementation must accept the kwarg,
    even ones that never block — the engine can't know which it holds.
    """

    def submit(self, requests: List[Request]) -> int: ...
    def poll(self, timeout: Optional[float] = None) -> List[LargeResult]: ...
    def flush(self) -> None: ...
    def drain(self) -> List[LargeResult]: ...
    def close(self) -> None: ...
    @property
    def n_pending(self) -> int: ...


class SyncLocalBackend:
    """Inline M_L regeneration on the caller's thread (the engine's old
    `flush_large` behavior, extracted).  `submit` runs any batch the
    policy releases immediately — blocking M_S decode — and `drain`
    flushes the leftovers.  Zero concurrency, maximal determinism: the
    parity reference for the other backends. `paged_kernel` goes to the
    runner's `generate` (the engine's kernel switch)."""

    name = "sync"

    def __init__(self, runner, max_new: int,
                 large_batch: Optional[int] = None,
                 max_wait: Optional[float] = None,
                 registry=None, paged_kernel: Optional[bool] = None):
        self._generate = functools.partial(runner.generate,
                                           paged_kernel=paged_kernel)
        self.max_new = max_new
        self._policy = BatchPolicy(large_batch, max_wait)
        self._results: List[LargeResult] = []
        self._n_tickets = 0
        self._n_open = 0
        self._n_batches = 0
        self.batch_log: List[Dict[str, Any]] = []
        self._metrics = _BackendMetrics(registry, self)

    def submit(self, requests: List[Request]) -> int:
        for r in requests:
            self._policy.add(_Pending(r.rid, r.prompt, time.perf_counter()))
            self._n_open += 1
        self._run_ready()
        self._n_tickets += 1
        return self._n_tickets

    def _run_ready(self, drain: bool = False) -> None:
        for group, pad_to, reason in self._policy.take(
                time.perf_counter(), drain=drain):
            tokens, conf = _generate_batch(self._generate, group, pad_to,
                                           self.max_new)
            bid = self._n_batches
            self._n_batches += 1
            self.batch_log.append({
                "batch_id": bid, "n_real": len(group), "pad_to": pad_to,
                "reason": reason,
                "prompt_len": int(group[0].prompt.shape[0])})
            self._metrics.record_batch(len(group), pad_to, reason)
            for i, p in enumerate(group):
                self._results.append(LargeResult(
                    rid=p.rid, tokens=tokens[i].copy(), batch_id=bid,
                    n_real=len(group), pad_to=pad_to, reason=reason,
                    prompt_len=int(p.prompt.shape[0]),
                    confidence=float(conf[i])))
            self._n_open -= len(group)

    def poll(self, timeout: Optional[float] = None) -> List[LargeResult]:
        # timeout is accepted for protocol conformance but meaningless
        # here: batches run inline, so results exist before poll is
        # called — there is never anything to wait for
        self._run_ready()          # max-wait timer also fires on poll
        out, self._results = self._results, []
        return out

    def flush(self) -> None:
        self._run_ready(drain=True)

    def drain(self) -> List[LargeResult]:
        self.flush()
        return self.poll()

    def close(self) -> None:
        pass

    @property
    def n_pending(self) -> int:
        return self._n_open
