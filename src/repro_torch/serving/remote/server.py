"""The M_L server process: a socket RPC service owning its own
`ModelRunner.generate` loop (the port's copy of
`repro.serving.remote.server`). On the card its worker thread runs under
a CUDA stream of its own, as `ThreadedBackend`'s does; in a process of
its own (`launch/ml_server.py`) it holds its own CUDA context.

One `MLServer` is the out-of-process half of the distributed M_L tier
(`launch/ml_server.py` is its process entrypoint; tests and the bench
run it in-thread against a real localhost TCP socket — the transport is
identical either way). Structure:

    accept thread ──> one handler thread per connection (frame RPC)
                              │ submit / poll / flush / cancel / health
                              ▼
    worker thread ──  BatchPolicy (large_backend's, unchanged) +
                      `ModelRunner.generate` per prompt-length group

The server is single-tenant by design: one logical client (a
`SocketBackend`, possibly reconnecting through retries) owns it at a
time. Sessions make that safe:

  * the client opens every connection with ``hello(session=...)``; a
    RECONNECT with the same session id preserves all server state, so a
    retried submit after a lost ack deduplicates by rid instead of
    regenerating;
  * a NEW session id resets the server — pending requests are
    cancelled, undelivered results dropped, the drain flag cleared — so
    one server can back many consecutive engine runs (which reuse the
    same rid space) without cross-run contamination. In-flight batches
    from the old session are epoch-tagged and discarded on completion.

Delivery is at-least-once with explicit acks: ``poll`` responses stay
buffered server-side until the client acknowledges them in its next
``poll`` (a lost response is re-fetched, a duplicate is dropped
client-side by rid), so no deferral is ever silently lost to a flaky
connection.

Fault-injection hooks (`fault_delay_next`/`fault_delay_s`, `kill()`)
exist so tests/test_serving_remote.py can force the timeout-retry and
replica-death paths deterministically.
"""
from __future__ import annotations

import math
import queue
import socket
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from repro_torch.serving.large_backend import (BatchPolicy, _BackendMetrics,
                                               _generate_batch, _Pending,
                                               bind_generate, idle_timeout,
                                               on_stream, take_queued,
                                               worker_stream)
from repro_torch.serving.remote import wire

# server-internal rid mangling: results of a superseded session must not
# collide with the next session's rid space (engine runs restart at 0)
_EPOCH_SHIFT = 32
_RID_SPAN = 1 << _EPOCH_SHIFT


class MLServer:
    """Socket RPC server for batched M_L regeneration.

    `runner` is the large `ModelRunner`; batching policy knobs
    (`large_batch`, `max_wait`) mirror `make_large_backend` — the policy
    object itself IS `large_backend.BatchPolicy`, so batch shapes (and
    greedy parity) are identical to the in-process backends. `latency`
    injects per-batch response delay (the stub backend's knob, kept for
    benches). `port=0` binds an ephemeral port; read `.address` after
    construction. `paged_kernel` is the kernel switch passed to the
    runner's `generate` (None: the runner's default, on for CUDA). The
    idle worker blocks until an operation arrives or its oldest group's
    `max_wait` runs out; JAX's wakes every 2 ms instead.
    """

    def __init__(self, runner, max_new: int,
                 large_batch: Optional[int] = None,
                 max_wait: Optional[float] = None,
                 host: str = "127.0.0.1", port: int = 0,
                 latency: float = 0.0,
                 registry=None, paged_kernel: Optional[bool] = None):
        self._generate = bind_generate(runner, paged_kernel)
        self.stream = worker_stream(runner)
        self.max_new = max_new
        self.latency = latency
        self._policy = BatchPolicy(large_batch, max_wait)
        self._inq: "queue.Queue" = queue.Queue()
        self._outq: "queue.Queue" = queue.Queue()
        self._drain_flag = threading.Event()
        self._stop_flag = threading.Event()
        self._killed = False
        self._error: Optional[BaseException] = None

        # session + delivery state (under _lock; worker only sees srids)
        self._lock = threading.Lock()
        self._session: Optional[str] = None  # guarded_by: self._lock
        self._epoch = 0                    # guarded_by: self._lock
        # rids accepted this session
        self._seen: set = set()            # guarded_by: self._lock
        # rid -> undelivered result
        self._done: Dict[int, Dict[str, Any]] = {}  # guarded_by: self._lock
        # accepted - completed/cancelled
        self._n_open = 0                   # guarded_by: self._lock
        self._results_ready = threading.Event()

        # written by the worker thread, read by metrics gauges
        self._n_batches = 0                # guarded_by: self._lock
        self.batch_log: List[Dict[str, Any]] = []   # guarded_by: self._lock
        self._metrics = _BackendMetrics(registry, self)
        self._t_start = time.perf_counter()

        # fault injection (tests): delay the next N RPC responses by
        # fault_delay_s seconds each — forces client request timeouts
        self.fault_delay_next = 0
        self.fault_delay_s = 0.0

        self._lsock = socket.create_server((host, port))
        self._lsock.settimeout(0.2)
        self.host, self.port = self._lsock.getsockname()[:2]
        self._conns: List[socket.socket] = []
        self._threads: List[threading.Thread] = []
        self._worker = threading.Thread(target=self._run_worker,
                                        daemon=True, name="ml-server-gen")
        self._acceptor = threading.Thread(target=self._accept_loop,
                                          daemon=True, name="ml-server-acc")
        self._started = False

    # -- lifecycle ----------------------------------------------------------
    @property
    def address(self) -> Tuple[str, int]:
        return (self.host, self.port)

    @property
    def running(self) -> bool:
        return self._started and not self._stop_flag.is_set()

    @property
    def n_pending(self) -> int:
        """Requests accepted this session and not yet completed (the
        per-replica queue-depth number health responses report).
        Absorbs finished/cancelled work first — completions must be
        visible without waiting for the next client poll."""
        with self._lock:
            self._absorb_outq()
            return self._n_open

    def start(self) -> "MLServer":
        self._worker.start()
        self._acceptor.start()
        self._started = True
        return self

    def stop(self, timeout: float = 5.0) -> None:
        """Graceful stop: no new connections, worker + handlers join, and
        the worker's stream drains. Raises if the worker is still running
        after `timeout` seconds, unless the server was killed: a killed
        server's worker finishes its batch on its own, for nobody."""
        self._stop_flag.set()
        self._inq.put(("wake", None))
        for t in (self._acceptor, self._worker, *self._threads):
            if t.is_alive():
                t.join(timeout=timeout)
        self._close_all()
        if self._worker.is_alive():
            if self._killed:
                return
            raise RuntimeError(f"M_L server {self.host}:{self.port}: worker "
                               f"still running {timeout} s after stop")
        if self.stream is not None:
            self.stream.synchronize()

    def kill(self) -> None:
        """Abrupt death (fault injection): drop the listening socket and
        every live connection mid-whatever, stop the worker without
        draining. Clients observe connection reset / refused."""
        self._killed = True
        self._stop_flag.set()
        self._inq.put(("wake", None))
        self._close_all()

    def _close_all(self) -> None:
        for s in [self._lsock, *self._conns]:
            try:
                s.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                s.close()
            except OSError:
                pass
        self._conns.clear()

    def __enter__(self) -> "MLServer":
        return self if self._started else self.start()

    def __exit__(self, exc_type, exc, tb) -> None:
        self.stop()

    # -- worker: the batching + generate loop -------------------------------
    def _run_worker(self) -> None:
        try:
            with on_stream(self.stream):
                self._loop()
        except BaseException as e:              # noqa: BLE001
            self._error = e

    def _loop(self) -> None:
        while not self._stop_flag.is_set():
            # pull every queued operation before cutting a batch
            for op, payload in take_queued(self._inq,
                                           idle_timeout(self._policy)):
                if op == "submit":
                    self._policy.add(payload)
                elif op == "cancel":
                    removed = self._policy.cancel(payload)
                    self._outq.put(("cancelled", removed))
                    self._results_ready.set()
            drain = self._drain_flag.is_set() and self._inq.empty()
            for group, pad_to, reason in self._policy.take(
                    time.perf_counter(), drain=drain):
                tokens, conf = _generate_batch(self._generate, group, pad_to,
                                               self.max_new)
                if self.latency > 0:
                    time.sleep(self.latency)
                with self._lock:
                    bid = self._n_batches
                    self._n_batches += 1
                    self.batch_log.append({
                        "batch_id": bid, "n_real": len(group),
                        "pad_to": pad_to, "reason": reason,
                        "prompt_len": int(group[0].prompt.shape[0])})
                self._metrics.record_batch(len(group), pad_to, reason)
                for i, p in enumerate(group):
                    epoch, rid = divmod(p.rid, _RID_SPAN)
                    res = {
                        "rid": rid, "tokens": tokens[i].tolist(),
                        "batch_id": bid, "n_real": len(group),
                        "pad_to": pad_to, "reason": reason,
                        "prompt_len": int(p.prompt.shape[0])}
                    # optional field: present only when finite (same
                    # rule as wire.encode_result — JSON has no nan)
                    if math.isfinite(float(conf[i])):
                        res["confidence"] = float(conf[i])
                    self._outq.put(("result", (epoch, res)))
                self._results_ready.set()

    # -- session / delivery bookkeeping (handler side, under _lock) ---------
    def _hello(self, session: str) -> None:
        with self._lock:
            if session == self._session:
                return                        # reconnect: keep everything
            # new logical client: cancel the old session's pending work,
            # drop its undelivered results, rearm the drain flag
            self._session = session
            self._epoch += 1
            if self._seen:
                stale = [(self._epoch - 1) * _RID_SPAN + r
                         for r in self._seen]
                self._inq.put(("cancel", stale))
            self._seen = set()
            self._done = {}
            self._n_open = 0
            self._drain_flag.clear()

    def _absorb_outq(self) -> None:  # guarded_by: self._lock
        """Move completed work from the worker into the undelivered
        buffer, dropping anything from a superseded session."""
        while True:
            try:
                op, payload = self._outq.get_nowait()
            except queue.Empty:
                return
            if op == "result":
                epoch, res = payload
                if epoch != self._epoch:
                    continue                  # stale session: discard
                if res["rid"] in self._seen and res["rid"] not in self._done:
                    self._done[res["rid"]] = res
                    self._n_open -= 1
            elif op == "cancelled":
                for srid in payload:
                    epoch, rid = divmod(srid, _RID_SPAN)
                    if epoch == self._epoch and rid in self._seen:
                        self._seen.discard(rid)
                        self._n_open -= 1

    def _handle_submit(self, msg: Dict[str, Any]) -> Dict[str, Any]:
        reqs = msg.get("reqs")
        if not isinstance(reqs, list):
            raise wire.WireError("submit needs a 'reqs' list")
        decoded = [wire.decode_request(d) for d in reqs]  # validate first
        accepted = dup = 0
        with self._lock:
            for rid, prompt in decoded:
                if rid in self._seen:
                    dup += 1                  # retried submit: dedupe
                    continue
                self._seen.add(rid)
                self._n_open += 1
                srid = self._epoch * _RID_SPAN + rid
                self._inq.put(("submit", _Pending(srid, prompt,
                                                  time.perf_counter())))
                accepted += 1
        return wire.envelope("ok", accepted=accepted, dup=dup)

    def _handle_poll(self, msg: Dict[str, Any]) -> Dict[str, Any]:
        ack = msg.get("ack") or []
        wait = min(float(msg.get("wait") or 0.0), 5.0)
        deadline = time.perf_counter() + wait
        with self._lock:
            for rid in ack:
                self._done.pop(rid, None)
            self._absorb_outq()
            results = list(self._done.values())
        while not results and time.perf_counter() < deadline:
            self._results_ready.clear()
            self._results_ready.wait(
                max(min(deadline - time.perf_counter(), 0.05), 1e-4))
            with self._lock:
                self._absorb_outq()
                results = list(self._done.values())
        with self._lock:
            pending = self._n_open
        return wire.envelope("results", results=results, pending=pending)

    def _handle_cancel(self, msg: Dict[str, Any]) -> Dict[str, Any]:
        rids = msg.get("rids") or []
        with self._lock:
            todo = [self._epoch * _RID_SPAN + r for r in rids
                    if r in self._seen and r not in self._done]
        if todo:
            self._inq.put(("cancel", todo))
        return wire.envelope("ok", cancelling=len(todo))

    # -- connection handling ------------------------------------------------
    def _accept_loop(self) -> None:
        while not self._stop_flag.is_set():
            try:
                conn, _addr = self._lsock.accept()
            except socket.timeout:
                continue
            except OSError:
                return                        # listening socket closed
            conn.settimeout(0.2)
            self._conns.append(conn)
            t = threading.Thread(target=self._serve_conn, args=(conn,),
                                 daemon=True, name="ml-server-conn")
            self._threads.append(t)
            t.start()

    def _reply(self, conn: socket.socket, msg: Dict[str, Any]) -> None:
        if self.fault_delay_next > 0:
            self.fault_delay_next -= 1
            time.sleep(self.fault_delay_s)
        wire.send_frame(conn, msg)

    def _serve_conn(self, conn: socket.socket) -> None:
        try:
            while not self._stop_flag.is_set():
                try:
                    msg = wire.recv_frame(conn)
                except socket.timeout:
                    continue
                except OSError:
                    return                    # socket yanked (kill())
                except wire.WireError as e:
                    # framing is lost: report and drop the connection
                    # (the session survives — a reconnect resumes it)
                    try:
                        self._reply(conn, wire.envelope(
                            "error", error=str(e), rid=e.rid))
                    except OSError:
                        pass
                    return
                if msg is None:
                    return                    # clean EOF
                try:
                    wire.check_schema(msg)
                except wire.WireError as e:
                    self._reply(conn, wire.envelope("error", error=str(e),
                                                    rid=None))
                    return                    # can't talk to this peer
                kind = msg["kind"]
                try:
                    if kind == "hello":
                        self._hello(str(msg.get("session")))
                        reply = wire.envelope("ok", server="ml_server",
                                              pending=self.n_pending)
                    elif kind == "submit":
                        reply = self._handle_submit(msg)
                    elif kind == "poll":
                        reply = self._handle_poll(msg)
                    elif kind == "flush":
                        if not self._drain_flag.is_set():
                            self._drain_flag.set()
                            self._inq.put(("wake", None))
                        reply = wire.envelope("ok")
                    elif kind == "cancel":
                        reply = self._handle_cancel(msg)
                    elif kind == "health":
                        if self._error is not None:
                            reply = wire.envelope(
                                "error", rid=None,
                                error=f"M_L worker died: {self._error!r}")
                        else:
                            reply = wire.envelope(
                                "ok", pending=self.n_pending,
                                uptime_s=round(time.perf_counter()
                                               - self._t_start, 3))
                    elif kind == "bye":
                        self._reply(conn, wire.envelope("ok"))
                        return
                    elif kind == "shutdown":
                        self._reply(conn, wire.envelope("ok"))
                        self._stop_flag.set()
                        self._inq.put(("wake", None))
                        return
                    else:
                        reply = wire.envelope(
                            "error", error=f"unknown kind {kind!r}",
                            rid=None)
                except wire.WireError as e:
                    # a well-framed but invalid payload rejects only the
                    # offending request — rid echoed, connection kept
                    reply = wire.envelope("error", error=str(e), rid=e.rid)
                try:
                    self._reply(conn, reply)
                except OSError:
                    return                    # client went away mid-reply
        finally:
            try:
                conn.close()
            except OSError:
                pass
