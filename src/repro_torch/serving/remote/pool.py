"""`ReplicaPool`: N M_L replicas behind one `LargeBackend` (the port's
copy of `repro.serving.remote.pool`).

Each replica is a `SocketBackend` talking to its own `MLServer` process;
the pool presents the same `submit/poll/flush/drain/close` surface the
engine already speaks, adding:

  * **load balancing** — batch-aware: when `large_batch` is known, a
    prompt-length group *sticks* to one replica until `large_batch`
    requests have been routed there, then the next group opens on the
    least-loaded healthy replica. Sticky routing matters: the engine
    streams deferrals one at a time, and spreading them least-loaded
    would mean no replica's server-side group ever fills — every batch
    would wait out `max_wait` and 2 replicas would have *worse*
    deferral-wait tails than 1. With sticky routing each replica's
    group fills at the single-server rate and consecutive batches
    land on different replicas, overlapping their `generate` calls.
    Without `large_batch` the pool falls back to pure least-loaded.
    Either way batch shapes are cut server-side by each replica's
    `BatchPolicy`, exactly as with one server, so greedy outputs stay
    bit-exact.
  * **health checks + ejection** — every `health_interval` seconds a
    poll cycle health-probes all live replicas; a replica that fails
    its probe (or any RPC) is ejected and never contacted again.
  * **re-dispatch** — an ejected replica's in-flight requests
    (`SocketBackend.take_inflight`) are resubmitted to the survivors,
    so a replica dying mid-batch delays its deferrals instead of
    dropping them. Because an ejected replica is never polled again, a
    spuriously-ejected (alive) replica can waste work but can never
    deliver a duplicate result.

When the last replica dies with work still in flight the pool raises
`RemoteBackendError` — loud failure, not a silent hang; the engine's
drain watchdog turns that into a run abort with the pending count.
"""
from __future__ import annotations

import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.serving.large_backend import LargeResult
from repro_torch.serving.remote.client import (RemoteBackendError, SocketBackend,
                                         parse_address)
from repro_torch.serving.request import Request

_RPC_ERRORS = (RemoteBackendError, ConnectionError, OSError)


class ReplicaPool:
    """`LargeBackend` that load-balances across N `MLServer` replicas."""

    name = "pool"

    drain_stall_timeout = 60.0

    def __init__(self, addresses: Sequence[Any], *,
                 connect_timeout: float = 2.0,
                 request_timeout: float = 30.0,
                 retries: int = 3,
                 backoff: float = 0.05,
                 backoff_max: float = 1.0,
                 health_interval: float = 2.0,
                 max_new: Optional[int] = None,
                 large_batch: Optional[int] = None,
                 registry=None):
        if not addresses:
            raise ValueError("ReplicaPool needs at least one address")
        self.health_interval = health_interval
        self.max_new = max_new or 0        # for re-dispatched Requests
        self.large_batch = large_batch
        # prompt_len -> (replica idx, requests routed into the open
        # group); the sticky state behind batch-aware routing
        self._route: Dict[int, Tuple[int, int]] = {}  # guarded_by: self._lock
        self._lock = threading.RLock()
        self._flushed = False              # guarded_by: self._lock
        self._closed = False
        self._n_tickets = 0                # guarded_by: self._lock
        self._last_health = time.perf_counter()  # guarded_by: self._lock
        # replicas hold their own retry/timeout machinery; metrics are
        # registered pool-level (per-client registration would collide
        # on the single-backend gauge names)
        self.replicas: List[SocketBackend] = [
            SocketBackend(parse_address(a),
                          connect_timeout=connect_timeout,
                          request_timeout=request_timeout,
                          retries=retries, backoff=backoff,
                          backoff_max=backoff_max)
            for a in addresses]
        self._alive = [True] * len(self.replicas)  # guarded_by: self._lock

        self._m_ejections = self._m_health = self._m_redispatch = None
        if registry is not None:
            self._m_ejections = registry.counter(
                "serving_ml_replica_ejections_total",
                "M_L replicas ejected from the pool after a failed RPC "
                "or health check")
            self._m_health = registry.counter(
                "serving_ml_health_checks_total",
                "periodic M_L replica health probes issued")
            self._m_redispatch = registry.counter(
                "serving_ml_redispatched_requests_total",
                "in-flight requests re-dispatched off a dead replica")
            registry.gauge("serving_ml_queue_depth",
                           "requests submitted to the M_L backend and "
                           "not yet returned",
                           fn=lambda: self.n_pending)
            depth = registry.gauge(
                "serving_ml_replica_queue_depth",
                "per-replica requests in flight", labels=("replica",))
            for i, r in enumerate(self.replicas):
                depth.labels(replica=str(i)).set_fn(
                    lambda r=r: r.n_pending)

    # -- replica management --------------------------------------------------
    # (every helper below runs with the pool lock held by its caller)
    def _alive_replicas(self):  # guarded_by: self._lock
        return [(i, r) for i, r in enumerate(self.replicas)
                if self._alive[i]]

    def _eject(self, idx: int, why: str) -> None:  # guarded_by: self._lock
        """Remove a replica and re-dispatch its in-flight requests to the
        survivors. Raises when it held work and no survivor remains."""
        if not self._alive[idx]:
            return
        self._alive[idx] = False
        if self._m_ejections is not None:
            self._m_ejections.inc()
        replica = self.replicas[idx]
        orphans = replica.take_inflight()
        try:
            replica.close()
        except _RPC_ERRORS:
            pass
        if not orphans:
            return
        if self._m_redispatch is not None:
            self._m_redispatch.inc(len(orphans))
        redo = [Request(rid=rid, prompt=np.asarray(prompt, np.int32),
                        max_new=self.max_new)
                for rid, prompt in orphans]
        self._submit_balanced(redo)     # raises if nobody is left
        if self._flushed:
            # the dead replica may have been mid-drain; survivors must
            # cut the re-dispatched work immediately, not wait for more
            self._flush_alive()

    def _pick_replica(self, plen, n):  # guarded_by: self._lock
        """Choose a live replica for `n` requests of prompt length
        `plen`: sticky while the current group has room (batch-aware),
        least-loaded when a new group opens or `large_batch` is unset."""
        alive = self._alive_replicas()
        if not alive:
            raise RemoteBackendError(
                f"all {len(self.replicas)} M_L replicas are dead "
                f"with {n} request(s) unplaced")
        lb = self.large_batch
        if not lb:
            return min(alive, key=lambda ir: ir[1].n_pending)
        ent = self._route.get(plen)
        if ent is not None and self._alive[ent[0]] and ent[1] + n <= lb:
            idx, count = ent[0], ent[1] + n
        else:
            idx, _ = min(alive, key=lambda ir: ir[1].n_pending)
            count = min(n, lb)
        if count >= lb:      # group full: next submit opens a new one
            self._route.pop(plen, None)
        else:
            self._route[plen] = (idx, count)
        return idx, self.replicas[idx]

    def _submit_balanced(self, requests):  # guarded_by: self._lock
        """Place requests on live replicas (grouped by prompt length so
        sticky routing can fill server-side batches), ejecting and
        retrying on failure until someone accepts them or nobody is
        left."""
        groups: Dict[int, List[Request]] = {}
        for r in requests:
            groups.setdefault(int(r.prompt_len), []).append(r)
        for plen, group in groups.items():
            while True:
                idx, replica = self._pick_replica(plen, len(group))
                try:
                    replica.submit(group)
                    break
                except _RPC_ERRORS:
                    self._eject(idx, "submit failed")

    def _flush_alive(self) -> None:  # guarded_by: self._lock
        for idx, replica in self._alive_replicas():
            try:
                replica.flush()
            except _RPC_ERRORS:
                self._eject(idx, "flush failed")

    def _health_check(self) -> None:  # guarded_by: self._lock
        for idx, replica in self._alive_replicas():
            if self._m_health is not None:
                self._m_health.inc()
            if not replica.healthy():
                self._eject(idx, "health check failed")

    # -- LargeBackend protocol ----------------------------------------------
    def submit(self, requests: List[Request]) -> int:
        if self._closed:
            raise RuntimeError("backend is closed")
        with self._lock:
            self._submit_balanced(list(requests))
            self._n_tickets += 1
            return self._n_tickets

    def poll(self, timeout: Optional[float] = None) -> List[LargeResult]:
        with self._lock:
            now = time.perf_counter()
            if now - self._last_health >= self.health_interval:
                self._last_health = now
                self._health_check()
            out: List[LargeResult] = []
            budget = timeout
            for idx, replica in self._alive_replicas():
                if not replica.n_pending:
                    continue
                try:
                    got = replica.poll(timeout=budget)
                except _RPC_ERRORS:
                    self._eject(idx, "poll failed")
                    continue
                out.extend(got)
                budget = None   # only the first busy replica blocks
            if not out and self.n_pending and not self._alive_replicas():
                raise RemoteBackendError(
                    f"all M_L replicas are dead with {self.n_pending} "
                    f"request(s) in flight")
            return out

    def flush(self) -> None:
        with self._lock:
            self._flushed = True
            self._route.clear()   # open groups are being cut server-side
            self._flush_alive()

    def drain(self) -> List[LargeResult]:
        self.flush()
        out: List[LargeResult] = []
        t_last = time.perf_counter()
        while self.n_pending:
            got = self.poll(timeout=0.05)
            out.extend(got)
            if got:
                t_last = time.perf_counter()
            elif time.perf_counter() - t_last > self.drain_stall_timeout:
                raise RemoteBackendError(
                    f"M_L pool drain stalled: {self.n_pending} requests "
                    f"pending, no progress for {self.drain_stall_timeout}s")
        return out

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        with self._lock:
            for _idx, replica in self._alive_replicas():
                try:
                    replica.close()
                except _RPC_ERRORS:
                    pass

    @property
    def n_pending(self) -> int:
        # metrics gauges read this off-thread; _alive must be read under
        # the lock (RLock, so the poll/drain paths can re-enter)
        with self._lock:
            return sum(r.n_pending for i, r in enumerate(self.replicas)
                       if self._alive[i])

    @property
    def batch_log(self) -> List[Dict[str, Any]]:
        """Merged per-replica batch logs (batch ids are per-replica;
        engine stats only aggregate counts/occupancy, never join on id)."""
        out: List[Dict[str, Any]] = []
        for r in self.replicas:
            out.extend(r.batch_log)
        return out

    @property
    def n_alive(self) -> int:
        with self._lock:
            return sum(self._alive)
