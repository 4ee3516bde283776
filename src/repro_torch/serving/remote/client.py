"""`SocketBackend`: the `LargeBackend` protocol over a real socket (the
port's copy of `repro.serving.remote.client`).

The engine-facing contract is identical to the in-process backends
(`submit/poll/flush/drain/close`, `n_pending`, `batch_log`); transport
is the length-prefixed JSON RPC of `remote.wire` against one
`remote.server.MLServer`. Reliability machinery on top of the raw RPC:

  * **connect/request timeouts** — `connect_timeout` bounds the TCP
    connect + hello handshake, `request_timeout` bounds every RPC; a
    server that stops answering turns into a retry, not a hang.
  * **bounded exponential-backoff retry** — a failed RPC reconnects and
    resends up to `retries` times (`backoff * 2**attempt`, capped at
    `backoff_max`), then raises with the full context. Retried submits
    are deduplicated server-side by rid (the session id survives
    reconnects); retried polls are safe because results stay buffered
    server-side until acknowledged by the NEXT poll.
  * **per-request cancellation** — `close()` (the engine's shutdown
    path, including mid-run exceptions) best-effort cancels every
    in-flight rid on the server before saying goodbye, so an aborted
    run doesn't leave the server generating for nobody.

`batch_log` is reconstructed from result metadata (batches are cut
server-side), so engine stats (`ml_batches`, `ml_batch_occupancy`) work
unchanged. Retry/reconnect counters land in the metrics registry
(`serving_ml_rpc_retries_total`, `serving_ml_reconnects_total`).
"""
from __future__ import annotations

import os
import socket
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.serving.large_backend import LargeResult
from repro_torch.serving.remote import wire
from repro_torch.serving.request import Request


class RemoteBackendError(RuntimeError):
    """The remote M_L tier failed in a way retry can't fix (protocol
    rejection, retries exhausted, all replicas dead)."""


def parse_address(addr: Any) -> Tuple[str, int]:
    """Accept ('host', port) tuples or 'host:port' strings."""
    if isinstance(addr, str):
        host, _, port = addr.rpartition(":")
        if not host or not port.isdigit():
            raise ValueError(f"address must be 'host:port', got {addr!r}")
        return host, int(port)
    host, port = addr
    return str(host), int(port)


class SocketBackend:
    """`LargeBackend` over a socket RPC connection to one `MLServer`."""

    name = "socket"

    # the engine's final-drain watchdog: no progress for this long while
    # deferrals are pending is a hard error, not an infinite spin
    drain_stall_timeout = 60.0

    def __init__(self, address, *,
                 connect_timeout: float = 2.0,
                 request_timeout: float = 30.0,
                 retries: int = 3,
                 backoff: float = 0.05,
                 backoff_max: float = 1.0,
                 registry=None):
        self.address = parse_address(address)
        self.connect_timeout = connect_timeout
        self.request_timeout = request_timeout
        self.retries = retries
        self.backoff = backoff
        self.backoff_max = backoff_max
        self._session = os.urandom(8).hex()
        self._lock = threading.RLock()
        self._sock: Optional[socket.socket] = None
        self._closed = False
        self._n_tickets = 0                # guarded_by: self._lock
        # rid -> prompt of every submitted-but-unreturned request (the
        # replica pool re-dispatches from this on ejection)
        self._inflight: Dict[int, np.ndarray] = {}  # guarded_by: self._lock
        # delivered-not-yet-acked / ever-delivered (dup guard)
        self._unacked: List[int] = []      # guarded_by: self._lock
        self._returned: set = set()        # guarded_by: self._lock
        self.batch_log: List[Dict[str, Any]] = []   # guarded_by: self._lock
        self._batches_seen: set = set()    # guarded_by: self._lock

        self._m_retries = self._m_reconnects = None
        if registry is not None:
            self._m_retries = registry.counter(
                "serving_ml_rpc_retries_total",
                "M_L socket RPCs retried after timeout/connection error")
            self._m_reconnects = registry.counter(
                "serving_ml_reconnects_total",
                "M_L socket reconnects (incl. the initial connect)")
            registry.gauge("serving_ml_queue_depth",
                           "requests submitted to the M_L backend and "
                           "not yet returned",
                           fn=lambda: self.n_pending)
        self._connect()

    # -- connection management ---------------------------------------------
    def _connect(self) -> None:
        """(Re)connect + hello handshake, with bounded backoff. The
        session id is stable across reconnects, so server state (rid
        dedupe, undelivered results) survives a flaky link."""
        last: Optional[BaseException] = None
        for attempt in range(self.retries + 1):
            try:
                s = socket.create_connection(self.address,
                                             timeout=self.connect_timeout)
                s.settimeout(self.request_timeout)
                wire.send_frame(s, wire.envelope("hello",
                                                 session=self._session))
                reply = wire.recv_frame(s)
                if reply is None:
                    raise wire.WireError("server closed during hello")
                wire.check_schema(reply)
                if reply["kind"] == "error":
                    raise RemoteBackendError(
                        f"M_L server at {self.address[0]}:"
                        f"{self.address[1]} rejected hello: "
                        f"{reply.get('error')}")
                self._sock = s
                if self._m_reconnects is not None:
                    self._m_reconnects.inc()
                return
            except RemoteBackendError:
                raise
            except (OSError, wire.WireError) as e:
                last = e
                self._drop_socket()
                if attempt < self.retries:
                    time.sleep(min(self.backoff * (2 ** attempt),
                                   self.backoff_max))
        raise ConnectionError(
            f"cannot reach M_L server at {self.address[0]}:"
            f"{self.address[1]} after {self.retries + 1} attempts "
            f"({last!r}) — is it running? Start one with: "
            f"python -m repro_torch.launch.ml_server --port {self.address[1]}")

    def _drop_socket(self) -> None:
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None

    def _rpc(self, msg: Dict[str, Any], timeout: Optional[float] = None,
             attempts: Optional[int] = None) -> Dict[str, Any]:
        """One request/response exchange with reconnect-and-resend retry.
        Identical resends are safe: submits dedupe by rid server-side,
        polls re-deliver unacknowledged results. A server-sent `error`
        frame raises RemoteBackendError immediately (retry can't fix a
        protocol rejection)."""
        attempts = (self.retries + 1) if attempts is None else attempts
        last: Optional[BaseException] = None
        with self._lock:
            for attempt in range(attempts):
                try:
                    if self._sock is None:
                        self._connect()
                    self._sock.settimeout(timeout or self.request_timeout)
                    wire.send_frame(self._sock, msg)
                    reply = wire.recv_frame(self._sock)
                    if reply is None:
                        raise wire.WireError(
                            "server closed the connection mid-RPC")
                    wire.check_schema(reply)
                    if reply["kind"] == "error":
                        raise RemoteBackendError(
                            f"M_L server rejected {msg['kind']} "
                            f"(rid={reply.get('rid')}): "
                            f"{reply.get('error')}")
                    return reply
                except (RemoteBackendError, ConnectionError):
                    raise
                except (OSError, wire.WireError) as e:
                    last = e
                    self._drop_socket()
                    if self._m_retries is not None:
                        self._m_retries.inc()
                    if attempt < attempts - 1:
                        time.sleep(min(self.backoff * (2 ** attempt),
                                       self.backoff_max))
        raise RemoteBackendError(
            f"M_L RPC {msg.get('kind')!r} to {self.address[0]}:"
            f"{self.address[1]} failed after {attempts} attempts: {last!r}")

    # -- LargeBackend protocol ----------------------------------------------
    def submit(self, requests: List[Request]) -> int:
        if self._closed:
            raise RuntimeError("backend is closed")
        payload = [wire.encode_request(r.rid, r.prompt) for r in requests]
        with self._lock:
            for r in requests:
                self._inflight[r.rid] = np.asarray(r.prompt, np.int32)
            self._rpc(wire.envelope("submit", reqs=payload))
            self._n_tickets += 1
            return self._n_tickets

    def poll(self, timeout: Optional[float] = None) -> List[LargeResult]:
        """Completed regenerations so far. `timeout` asks the server to
        hold the poll open up to that long for the first result (one
        round trip either way)."""
        with self._lock:
            if not self._inflight:
                return []
            msg = wire.envelope("poll", ack=list(self._unacked),
                                wait=float(timeout or 0.0))
            reply = self._rpc(msg,
                              timeout=self.request_timeout
                              + float(timeout or 0.0))
            self._unacked = []
            out: List[LargeResult] = []
            for d in reply.get("results", ()):
                res = wire.decode_result(d)
                self._unacked.append(res.rid)
                if res.rid in self._returned or \
                        res.rid not in self._inflight:
                    continue                  # duplicate delivery
                self._returned.add(res.rid)
                del self._inflight[res.rid]
                self._log_batch(res)
                out.append(res)
            return out

    def flush(self) -> None:
        self._rpc(wire.envelope("flush"))

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
                    f"M_L drain stalled: {self.n_pending} requests "
                    f"pending at {self.address[0]}:{self.address[1]} "
                    f"with no progress for {self.drain_stall_timeout}s")
        return out

    def close(self) -> None:
        """Engine shutdown: cancel whatever is still in flight on the
        server (best-effort — the server may already be gone), then
        close the connection."""
        if self._closed:
            return
        self._closed = True
        with self._lock:
            try:
                if self._inflight:
                    self._rpc(wire.envelope(
                        "cancel", rids=[int(r) for r in self._inflight]),
                        attempts=1)
                if self._sock is not None:
                    self._rpc(wire.envelope("bye"), attempts=1)
            except (RemoteBackendError, ConnectionError, OSError):
                pass
            self._drop_socket()

    @property
    def n_pending(self) -> int:
        # read from the pool's health/metrics paths while poll() mutates
        # _inflight on the engine thread — must snapshot under the lock
        with self._lock:
            return len(self._inflight)

    # -- replica-pool hooks --------------------------------------------------
    def healthy(self) -> bool:
        """One cheap health RPC, no retries — the pool's ejection
        decision wants fast failure, not patience."""
        try:
            reply = self._rpc(wire.envelope("health"), timeout=1.0,
                              attempts=1)
            return reply["kind"] == "ok"
        except (RemoteBackendError, ConnectionError, OSError):
            return False

    def take_inflight(self) -> List[Tuple[int, np.ndarray]]:
        """Hand back (and forget) every in-flight request — the pool
        re-dispatches these to surviving replicas on ejection."""
        with self._lock:
            out = [(rid, prompt) for rid, prompt in self._inflight.items()]
            self._inflight = {}
            return out

    def _log_batch(self, res: LargeResult) -> None:  # guarded_by: self._lock
        if res.batch_id not in self._batches_seen:
            self._batches_seen.add(res.batch_id)
            self.batch_log.append({
                "batch_id": res.batch_id, "n_real": res.n_real,
                "pad_to": res.pad_to, "reason": res.reason,
                "prompt_len": res.prompt_len})
