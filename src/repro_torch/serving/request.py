"""Copy of `repro.serving.request` for the port.

Request lifecycle + arrival queue for the continuous-batching cascade.

A `Request` moves through:

    PENDING  — arrived (visible once `now >= arrival_time`), waiting in the
               FIFO `ArrivalQueue` for a free M_S slot
    RUNNING  — admitted into a KV-pool slot; decoding on M_S with the
               per-step eq.-8 negative-entropy confidence accumulated on
               device
    PREEMPTED — evicted from its slot under block pressure (oversubscribed
               paged pool) with its decode state saved for bit-exact
               resume; back in the `ArrivalQueue`, where its ORIGINAL
               arrival time puts it ahead of every never-admitted arrival
               (age-priority pop — repeated preemption cannot starve it)
    DEFERRED — evicted from M_S (in-flight, when the running mean
               confidence drops below tau - margin after `min_tokens`; at
               end of decode when the final mean is below tau; or under
               block pressure with the defer-on-OOM policy,
               `deferred_reason == "oom"`); about to be handed to the M_L
               backend
    DEFERRED_PENDING — submitted to the M_L backend (see
               `serving.large_backend`); regeneration is in flight —
               possibly concurrently with M_S decode — until the engine
               polls the completed tokens back
    DONE     — final tokens attached (M_S output for kept requests, M_L
               output for deferred ones)

Two terminal states exist for requests the engine SHEDS instead of
serving (admission overload control — they end with an EMPTY token
vector and surface in telemetry, metrics, and the audit log):

    REJECTED — shed because the bounded ready queue (`max_queue`)
               overflowed (newest-first) or the shed pressure policy
               victimized it mid-flight
    EXPIRED  — shed because its deadline passed while still queued

Timestamps are seconds relative to the engine's run start so telemetry can
derive queueing delay, service time, and end-to-end latency per request.
"""
from __future__ import annotations

import dataclasses
import heapq
from typing import Any, Dict, List, Optional

import numpy as np

PENDING = "pending"
RUNNING = "running"
PREEMPTED = "preempted"
DEFERRED = "deferred"
DEFERRED_PENDING = "deferred_pending"
DONE = "done"
REJECTED = "rejected"
EXPIRED = "expired"

# terminal states a request can end a run in
TERMINAL_STATES = (DONE, REJECTED, EXPIRED)


@dataclasses.dataclass
class Request:
    """One serving request. `prompt` is the request's own token vector —
    requests in the same run may carry different lengths (ragged
    admission); the engine reads `prompt_len` per request rather than
    taking a run-wide length argument."""
    rid: int
    prompt: np.ndarray                 # [prompt_len] int32 (per-request len)
    max_new: int
    arrival_time: float = 0.0          # seconds from run start
    state: str = PENDING
    slot: Optional[int] = None
    tier: int = 0                      # cascade tier that owns (and, at
                                       # DONE, served) this request

    # admission overload control
    deadline: Optional[float] = None   # absolute (run-relative) seconds;
                                       # queued past it -> EXPIRED
    # pressure bookkeeping
    n_preempted: int = 0               # times evicted under block pressure
    admit_seq: int = -1                # global admission sequence number
                                       # (victim selection: youngest first)
    deferred_reason: Optional[str] = None  # "oom" when deferred by block
                                       # pressure; None for the confidence
                                       # gate
    resume: Optional[Dict[str, Any]] = None  # saved decode state of a
                                       # preempted request (device rows +
                                       # the token context whose KV must
                                       # be re-established); None once
                                       # consumed by re-admission

    # outputs
    tokens: Optional[np.ndarray] = None        # final (post-cascade) tokens
    small_tokens: Optional[np.ndarray] = None  # M_S tokens actually decoded
    confidence: float = float("nan")   # running mean neg-entropy at retire
    n_small_steps: int = 0             # M_S tokens decoded before retire
    deferred: bool = False
    early_exited: bool = False         # evicted before max_new (in-flight)
    shared_prefix_tokens: int = 0      # prompt tokens mapped from the
                                       # prefix registry (never prefilled)
    conf_trace: Optional[List[float]] = None  # per-token (per-sync-chunk)
                                       # eq.-8 confidence record; populated
                                       # only when span tracing is on and
                                       # attached to the decode span
    # lifecycle timestamps (seconds from run start; nan until reached)
    t_admit: float = float("nan")
    t_prefill_done: float = float("nan")  # decode seeded (prefill span end)
    t_retire: float = float("nan")     # left M_S (finished or evicted)
    t_submit_large: float = float("nan")  # handed to the M_L backend
    t_done: float = float("nan")       # final tokens available

    @property
    def deferral_wait_ms(self) -> float:
        """Milliseconds from M_S retirement to final M_L tokens (nan for
        requests that never deferred)."""
        if not self.deferred:
            return float("nan")
        return (self.t_done - self.t_retire) * 1e3

    @property
    def prompt_len(self) -> int:
        """This request's own prompt length (ragged workloads: differs
        per request)."""
        return int(self.prompt.shape[0])

    @property
    def saved_steps(self) -> int:
        """M_S decode steps skipped by in-flight deferral."""
        return self.max_new - self.n_small_steps if self.early_exited else 0

    @property
    def shed(self) -> bool:
        """True when overload control dropped this request (it ends with
        an empty token vector instead of a generation)."""
        return self.state in (REJECTED, EXPIRED)


class ArrivalQueue:
    """Arrival-ordered queue with delayed visibility, age-priority
    re-entry, and optional overload control.

    Requests sit in a min-heap keyed on `arrival_time` until the virtual
    clock passes them, then move to the READY heap of admissible
    requests — also keyed ``(arrival_time, rid)``, so pop order equals
    arrival order exactly as with the old FIFO. The heap (rather than a
    deque) is what makes `requeue` correct: a preempted request
    re-enters with its ORIGINAL arrival time, which is older than every
    never-admitted arrival still waiting, so it pops first and repeated
    preemption can never starve it behind fresh traffic.

    Overload control (both optional):
      * ``max_queue`` bounds the ready set; `shed_overflow` returns the
        NEWEST overflowing requests for the engine to reject.
      * per-request ``deadline`` + `expire(now)` returns ready requests
        whose deadline passed while queued.
    The queue only *selects* shed requests — marking them
    REJECTED/EXPIRED and surfacing telemetry is the engine's job.
    """

    def __init__(self, requests: Optional[List[Request]] = None,
                 max_queue: Optional[int] = None):
        if max_queue is not None and max_queue < 1:
            raise ValueError(f"max_queue must be >= 1, got {max_queue}")
        self.max_queue = max_queue
        self._future: list = []
        self._ready: list = []          # min-heap of (arrival_time, rid, req)
        for r in requests or ():
            self.push(r)

    def push(self, req: Request) -> None:
        heapq.heappush(self._future, (req.arrival_time, req.rid, req))

    def requeue(self, req: Request) -> None:
        """Re-enter a preempted request, keyed on its ORIGINAL arrival
        time (age-priority): it is older than anything still waiting, so
        it is next out."""
        heapq.heappush(self._ready, (req.arrival_time, req.rid, req))

    def release(self, now: float) -> int:
        """Move every request with arrival_time <= now into the ready
        heap. Returns how many became visible."""
        n = 0
        while self._future and self._future[0][0] <= now:
            heapq.heappush(self._ready, heapq.heappop(self._future))
            n += 1
        return n

    def pop_ready(self) -> Optional[Request]:
        return heapq.heappop(self._ready)[2] if self._ready else None

    def peek_ready(self) -> Optional[Request]:
        """Head of the ready heap without removing it (admission gating:
        the scheduler checks block capacity before committing a pop)."""
        return self._ready[0][2] if self._ready else None

    def shed_overflow(self) -> List[Request]:
        """Trim the ready set down to `max_queue` by removing the NEWEST
        entries (largest arrival key — the requests that would wait
        longest anyway). Returns the removed requests, oldest first."""
        if self.max_queue is None or len(self._ready) <= self.max_queue:
            return []
        keep = heapq.nsmallest(self.max_queue, self._ready)
        shed = sorted(set(map(id, self._ready)) - set(map(id, keep)))
        shed_entries = [e for e in self._ready if id(e) in shed]
        self._ready = keep
        heapq.heapify(self._ready)
        return [e[2] for e in sorted(shed_entries)]

    def expire(self, now: float) -> List[Request]:
        """Remove ready requests whose deadline passed while queued.
        Returns them oldest-first. Requests already admitted to a slot
        are never expired — work in flight is finished, not wasted."""
        dead = [e for e in self._ready
                if e[2].deadline is not None and e[2].deadline < now]
        if dead:
            alive = [e for e in self._ready
                     if not (e[2].deadline is not None
                             and e[2].deadline < now)]
            self._ready = alive
            heapq.heapify(self._ready)
        return [e[2] for e in sorted(dead)]

    @property
    def n_ready(self) -> int:
        return len(self._ready)

    @property
    def next_arrival(self) -> Optional[float]:
        return self._future[0][0] if self._future else None

    def __len__(self) -> int:
        return len(self._future) + len(self._ready)


def make_requests(prompts, max_new: int,
                  arrivals: Optional[np.ndarray] = None,
                  deadline_s: Optional[float] = None) -> List[Request]:
    """One Request per prompt. `prompts` is either a uniform [N, T] int
    matrix or a sequence of 1-D token vectors with *different* lengths
    (ragged workloads). `arrivals` are per-request offsets in seconds from
    run start (default: all arrive at t=0). `deadline_s` gives every
    request an absolute deadline of ``arrival_time + deadline_s``."""
    n = len(prompts)
    if arrivals is None:
        arrivals = np.zeros(n)
    return [Request(rid=i, prompt=np.asarray(prompts[i], np.int32),
                    max_new=max_new, arrival_time=float(arrivals[i]),
                    deadline=(float(arrivals[i]) + deadline_s
                              if deadline_s is not None else None))
            for i in range(n)]


def poisson_arrivals(n: int, rate: float, seed: int = 0) -> np.ndarray:
    """Cumulative arrival offsets (seconds) of a Poisson process with
    `rate` requests/s."""
    rng = np.random.default_rng(seed)
    return np.cumsum(rng.exponential(1.0 / rate, size=n))
