"""Pluggable M_L regeneration backends for the port's continuous cascade
engine (counterpart of `repro.serving.large_backend`; see its docstring
for the design).

    ``LargeBackend`` protocol
        submit(requests) -> ticket   enqueue deferred requests
        poll(timeout=None) -> finished   completed work so far; blocks up
                                     to `timeout` s for the first result
        flush()                      no more submissions; release partials
        drain()          -> finished block until every ticket completes
        close()                      stop worker resources

All share one batching policy (`BatchPolicy`):

``SyncLocalBackend``
    Batches run inline in `submit`/`flush` on the caller's thread (M_S
    decode blocks while M_L runs). The parity reference.

``ThreadedBackend``
    A worker thread runs `ModelRunner.generate` per prompt-length group
    off a queue, `large_batch` rows or `max_wait` seconds, whichever
    first. On the card the worker enters a CUDA stream of its own for
    its whole life: PyTorch's streams do not synchronise with the legacy
    default stream that the engine's loop launches on, so M_L's kernels
    can run beside M_S's. The stream first waits for what the creating
    thread had queued (the weights' init); results reach the host
    through `ModelRunner.generate`'s one copy, on the worker's stream.
    Only the C++ parts release the GIL (torch ops and the kernels'
    ctypes calls), so how much the host loops overlap is measured, not
    assumed (`chip_smoke.py` phase 14). For the same reason an idle
    worker blocks on its queue until there is work, instead of waking on
    a 2 ms timer as JAX's does: each wake-up takes the GIL from the
    engine's loop, whose every op hands it back and forth.

``RemoteStubBackend``
    The shape of a real RPC: requests and responses cross the worker
    boundary as serialized JSON payloads, with injectable per-batch
    latency. `serving.remote` puts a socket there.

Every backend passes the engine's kernel switch (`paged_kernel`) to the
runner's `generate`. A worker's exception surfaces on the engine's
thread at its next poll and fails the run.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import json
import math
import queue
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Protocol, Tuple

import numpy as np
import torch

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

    def cancel(self, rids: List[int]) -> List[int]:
        """Remove still-pending requests by rid (an engine shutting down
        mid-run withdraws its in-flight deferrals). Returns the rids
        actually removed — anything already taken into a batch keeps
        running and completes normally."""
        wanted = set(rids)
        removed: List[int] = []
        for plen, group in list(self._groups.items()):
            keep = [p for p in group if p.rid not in wanted]
            if len(keep) != len(group):
                removed.extend(p.rid for p in group if p.rid in wanted)
                self._groups[plen] = keep
        self._groups = {p: g for p, g in self._groups.items() if g}
        return removed


def bind_generate(runner, paged_kernel: Optional[bool] = None) -> Callable:
    """`runner.generate` with the engine's kernel switch bound (left
    unbound when None, the runner's own default, so a stand-in runner
    need not take the keyword)."""
    if paged_kernel is None:
        return runner.generate
    return functools.partial(runner.generate, paged_kernel=paged_kernel)


def worker_stream(runner) -> Optional["torch.cuda.Stream"]:
    """A CUDA stream of its own for a worker thread's `generate` calls
    when the runner's weights live on CUDA (None otherwise). Made on the
    creating thread, it first waits for what that thread has queued on
    its current stream, so the weights' init is complete before a worker
    kernel reads them."""
    dev = getattr(runner, "device", None)
    if dev is None or torch.device(dev).type != "cuda":
        return None
    stream = torch.cuda.Stream(device=dev)
    stream.wait_stream(torch.cuda.current_stream(dev))
    return stream


def on_stream(stream: Optional["torch.cuda.Stream"]):
    """Context entering `stream` for the calling thread (a no-op for
    None): kernels the thread launches inside it go to that stream."""
    return (contextlib.nullcontext() if stream is None
            else torch.cuda.stream(stream))


# queued by `flush` and `close`: wakes a worker blocked on an empty queue
_WAKE = object()


def idle_timeout(policy: BatchPolicy) -> Optional[float]:
    """How long a worker may block waiting for submissions: until the
    policy's oldest group times out; None (block until woken) when
    nothing can time out. An idle worker that woke on a timer would take
    the GIL from the engine's loop, whose every PyTorch op hands the GIL
    back and forth."""
    deadline = policy.next_deadline()
    if deadline is None:
        return None
    return max(deadline - time.perf_counter(), 1e-4)


def take_queued(inq: "queue.Queue", timeout: Optional[float]) -> List[Any]:
    """Everything queued on `inq`, waiting up to `timeout` seconds (None:
    until something arrives) for the first item."""
    items: List[Any] = []
    try:
        items.append(inq.get(timeout=timeout))
        while True:
            items.append(inq.get_nowait())
    except queue.Empty:
        pass
    return items


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
        self._generate = bind_generate(runner, paged_kernel)
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


class _WorkerBackend:
    """Shared machinery for backends whose `ModelRunner.generate` loop
    runs on a worker thread: a submission channel in, a completion
    channel out, the `BatchPolicy` owned by the worker. Subclasses
    define the channel encoding (`_encode_submit`/`_decode_submit`,
    `_encode_result`/`_decode_result`) and any injected latency. On the
    card the worker runs under its own CUDA stream (`worker_stream`);
    `close` joins the worker and synchronises that stream.

    An idle worker blocks on its queue until a submission, a `flush` or
    `close` arrives, or its oldest group's `max_wait` runs out
    (`idle_timeout`); JAX's worker wakes every 2 ms instead."""

    name = "worker"

    # seconds `close` waits for the worker to finish its current batch
    join_timeout = 60.0

    def __init__(self, runner, max_new: int,
                 large_batch: Optional[int] = None,
                 max_wait: Optional[float] = None,
                 registry=None, paged_kernel: Optional[bool] = None):
        self._generate = bind_generate(runner, paged_kernel)
        self.max_new = max_new
        self._metrics = _BackendMetrics(registry, self)
        self._policy = BatchPolicy(large_batch, max_wait)
        self._inq: "queue.Queue" = queue.Queue()
        self._outq: "queue.Queue" = queue.Queue()
        self._drain_flag = threading.Event()
        self._stop_flag = threading.Event()
        self._n_tickets = 0
        self.stream = worker_stream(runner)
        # _lock covers the worker<->main shared state: batch stats are
        # written mid-_loop while metrics gauges scrape, _error crosses
        # from the worker's except to _check_error, and _n_open is read
        # by the queue-depth gauge off the engine thread
        self._lock = threading.Lock()
        # submitted - returned
        self._n_open = 0            # guarded_by: self._lock
        self._n_batches = 0         # guarded_by: self._lock
        self.batch_log: List[Dict[str, Any]] = []  # guarded_by: self._lock
        self._error: Optional[BaseException] = None  # guarded_by: self._lock
        self._worker = threading.Thread(target=self._run_worker,
                                        daemon=True,
                                        name=f"large-{self.name}")
        self._worker.start()

    # -- channel encoding (identity for ThreadedBackend) -------------------
    def _encode_submit(self, req: Request) -> Any:
        return _Pending(req.rid, req.prompt, time.perf_counter())

    def _decode_submit(self, payload: Any) -> _Pending:
        return payload

    def _encode_result(self, res: LargeResult) -> Any:
        return res

    def _decode_result(self, payload: Any) -> LargeResult:
        return payload

    def _sleep_latency(self) -> None:
        """Injected per-batch response latency (stub backend)."""

    # -- worker thread ------------------------------------------------------
    def _run_worker(self) -> None:
        """Thread target: a worker death must surface on the caller's
        thread (via `_check_error` in poll/drain), never hang it."""
        try:
            with on_stream(self.stream):
                self._loop()
        except BaseException as e:              # noqa: BLE001
            with self._lock:
                self._error = e

    def _check_error(self) -> None:
        with self._lock:
            error, n_open = self._error, self._n_open
        if error is not None:
            raise RuntimeError(
                f"M_L {self.name} backend worker died: "
                f"{error!r}") from error
        if not self._worker.is_alive() and n_open > 0 \
                and not self._stop_flag.is_set():
            raise RuntimeError(f"M_L {self.name} backend worker exited "
                               f"with {n_open} requests pending")

    def _loop(self) -> None:
        while not self._stop_flag.is_set():
            # pull everything queued before cutting a batch
            for payload in take_queued(self._inq,
                                       idle_timeout(self._policy)):
                if payload is not _WAKE:
                    self._policy.add(self._decode_submit(payload))
            drain = self._drain_flag.is_set() and self._inq.empty()
            for group, pad_to, reason in self._policy.take(
                    time.perf_counter(), drain=drain):
                tokens, conf = _generate_batch(self._generate, group, pad_to,
                                               self.max_new)
                self._sleep_latency()
                with self._lock:
                    bid = self._n_batches
                    self._n_batches += 1
                    self.batch_log.append({
                        "batch_id": bid, "n_real": len(group),
                        "pad_to": pad_to, "reason": reason,
                        "prompt_len": int(group[0].prompt.shape[0])})
                self._metrics.record_batch(len(group), pad_to, reason)
                for i, p in enumerate(group):
                    self._outq.put(self._encode_result(LargeResult(
                        rid=p.rid, tokens=tokens[i].copy(), batch_id=bid,
                        n_real=len(group), pad_to=pad_to, reason=reason,
                        prompt_len=int(p.prompt.shape[0]),
                        confidence=float(conf[i]))))

    # -- main-thread API ----------------------------------------------------
    def submit(self, requests: List[Request]) -> int:
        if self._stop_flag.is_set():
            raise RuntimeError("backend is closed")
        for r in requests:
            self._inq.put(self._encode_submit(r))
            with self._lock:
                self._n_open += 1
        self._n_tickets += 1
        return self._n_tickets

    def poll(self, timeout: Optional[float] = None) -> List[LargeResult]:
        """Completed regenerations so far (non-blocking by default;
        `timeout` blocks up to that long for the FIRST result)."""
        self._check_error()
        out: List[LargeResult] = []
        try:
            if timeout:
                out.append(self._decode_result(
                    self._outq.get(timeout=timeout)))
            while True:
                out.append(self._decode_result(self._outq.get_nowait()))
        except queue.Empty:
            pass
        with self._lock:
            self._n_open -= len(out)
        return out

    def flush(self) -> None:
        """No more submissions are coming: release partial groups."""
        if not self._drain_flag.is_set():
            self._drain_flag.set()
            self._inq.put(_WAKE)

    def drain(self) -> List[LargeResult]:
        """Block until every submitted request has completed."""
        self.flush()
        out: List[LargeResult] = []
        while self.n_pending > 0:
            out.extend(self.poll(timeout=0.05))
        return out

    def close(self) -> None:
        """Stop the worker after its current batch, join it, and wait for
        what it queued on its stream. Raises if the worker is still
        running after `join_timeout` seconds."""
        self._stop_flag.set()
        self._inq.put(_WAKE)
        self._worker.join(timeout=self.join_timeout)
        if self._worker.is_alive():
            raise RuntimeError(
                f"M_L {self.name} backend worker still running "
                f"{self.join_timeout} s after close")
        if self.stream is not None:
            self.stream.synchronize()

    @property
    def n_pending(self) -> int:
        with self._lock:
            return self._n_open


class ThreadedBackend(_WorkerBackend):
    """Worker-thread M_L backend: deferrals stream into a queue, the
    worker batches them by prompt-length group (`large_batch` rows, or
    `max_wait` seconds, whichever first) and runs `ModelRunner.generate`
    concurrently with the engine's M_S decode loop, on a CUDA stream of
    its own on the card."""

    name = "thread"


class RemoteStubBackend(_WorkerBackend):
    """RPC-shaped M_L backend: every request and response crosses the
    worker boundary as a serialized JSON payload (rid + token lists —
    no shared Python objects), with `latency` seconds of injected
    response delay per batch. Functionally identical to
    `ThreadedBackend`; pins the serialization contract that the socket
    server speaks."""

    name = "stub"

    def __init__(self, runner, max_new: int,
                 large_batch: Optional[int] = None,
                 max_wait: Optional[float] = None,
                 latency: float = 0.0,
                 registry=None, paged_kernel: Optional[bool] = None):
        self.latency = latency
        super().__init__(runner, max_new, large_batch, max_wait,
                         registry, paged_kernel)

    def _encode_submit(self, req: Request) -> bytes:
        return json.dumps({"rid": req.rid,
                           "prompt": req.prompt.tolist()}).encode()

    def _decode_submit(self, payload: bytes) -> _Pending:
        msg = json.loads(payload.decode())
        return _Pending(int(msg["rid"]),
                        np.asarray(msg["prompt"], np.int32),
                        time.perf_counter())

    def _encode_result(self, res: LargeResult) -> bytes:
        msg = {
            "rid": res.rid, "tokens": res.tokens.tolist(),
            "batch_id": res.batch_id, "n_real": res.n_real,
            "pad_to": res.pad_to, "reason": res.reason,
            "prompt_len": res.prompt_len}
        # optional field, present only when finite: JSON has no nan, and
        # pre-ladder payloads stay byte-identical
        if math.isfinite(res.confidence):
            msg["confidence"] = res.confidence
        return json.dumps(msg).encode()

    def _decode_result(self, payload: bytes) -> LargeResult:
        msg = json.loads(payload.decode())
        return LargeResult(
            rid=int(msg["rid"]),
            tokens=np.asarray(msg["tokens"], np.int32),
            batch_id=int(msg["batch_id"]), n_real=int(msg["n_real"]),
            pad_to=int(msg["pad_to"]), reason=msg["reason"],
            prompt_len=int(msg["prompt_len"]),
            confidence=float(msg.get("confidence", math.nan)))

    def _sleep_latency(self) -> None:
        if self.latency > 0:
            time.sleep(self.latency)


BACKENDS = ("sync", "thread", "stub")


def make_large_backend(kind, runner, max_new: int,
                       large_batch: Optional[int] = None,
                       max_wait: Optional[float] = None,
                       stub_latency: float = 0.0,
                       registry=None,
                       paged_kernel: Optional[bool] = None) -> LargeBackend:
    """Factory used by the engine/CLI: `kind` in {sync, thread, stub},
    or a callable `(runner=, max_new=, large_batch=, max_wait=,
    stub_latency=, registry=) -> LargeBackend` for backends that need
    extra construction context (the socket/replica-pool backends close
    over their server addresses this way — see launch/serve.py; their
    kernel switch is the server's). `registry` (a `MetricsRegistry`)
    turns on per-batch metrics and the queue-depth gauge; `paged_kernel`
    is the engine's kernel switch for the runner's `generate`."""
    if callable(kind):
        return kind(runner=runner, max_new=max_new,
                    large_batch=large_batch, max_wait=max_wait,
                    stub_latency=stub_latency, registry=registry)
    if kind == "sync":
        return SyncLocalBackend(runner, max_new, large_batch, max_wait,
                                registry=registry, paged_kernel=paged_kernel)
    if kind == "thread":
        return ThreadedBackend(runner, max_new, large_batch, max_wait,
                               registry=registry, paged_kernel=paged_kernel)
    if kind == "stub":
        return RemoteStubBackend(runner, max_new, large_batch, max_wait,
                                 latency=stub_latency, registry=registry,
                                 paged_kernel=paged_kernel)
    raise ValueError(f"large backend must be one of {BACKENDS}, "
                     f"got {kind!r}")
