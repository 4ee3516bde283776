"""The port's distributed M_L tier on the CPU against the JAX package:
every test of tests/test_serving_remote.py run on the port (wire goldens,
the socket server/client contract, the fault-injection suite and the
engine's parity across sync, socket and a 2-replica pool, the real-model
ones on JAX's weights converted by `convert.params_from_jax` and held to
JAX's tokens); the port's frames against tests/golden/wire_v1.json byte
for byte; a port client against a JAX server and a JAX client against a
port server; the kernels' launch counters under eight threads; the serve
CLI's M_L flags and the `ml_server` entry point. Every wait (poll, join,
socket, process) has its own bound."""
import json
import os
import socket
import subprocess
import sys
import threading
import time
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config, reduced
from repro.models import transformer as jtfm
from repro.serving import ContinuousCascadeEngine as JEngine
from repro.serving import make_requests as j_make_requests
from repro.serving.engine import ModelRunner as JModelRunner
from repro.serving.remote import MLServer as JMLServer
from repro.serving.remote import SocketBackend as JSocketBackend
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs import reduced as t_reduced
from repro_torch.convert import params_from_jax
from repro_torch.serving import (ContinuousCascadeEngine, ModelRunner,
                                 Request, make_requests, poisson_arrivals)
from repro_torch.serving.large_backend import (BatchPolicy, LargeResult,
                                               _Pending)
from repro_torch.serving.obs import MetricsRegistry
from repro_torch.serving.remote import (MLServer, ReplicaPool,
                                        RemoteBackendError, SocketBackend,
                                        wire)
from repro_torch.serving.request import DONE

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parents[1]
GOLDEN = REPO / "tests" / "golden" / "wire_v1.json"
pytestmark = pytest.mark.filterwarnings("ignore::DeprecationWarning")


class FakeRunner:
    """Deterministic stand-in for a ModelRunner: token i of row r is
    prompt[r][0] + i. Lets protocol/fault tests run at socket speed;
    parity tests use the real models (see `runners`)."""

    def __init__(self, delay: float = 0.0):
        self.delay = delay

    def generate(self, prompts, plen, max_new):
        if self.delay:
            time.sleep(self.delay)
        out = (prompts[:, :1]
               + np.arange(max_new, dtype=np.int32)[None, :]).astype(np.int32)
        return out, None


def fake_server(**kw) -> MLServer:
    kw.setdefault("max_new", 4)
    kw.setdefault("large_batch", 2)
    kw.setdefault("max_wait", 0.01)
    return MLServer(FakeRunner(kw.pop("gen_delay", 0.0)), **kw).start()


def reqs_for(prompts, max_new=4):
    return [Request(rid=i, prompt=np.asarray(p, np.int32), max_new=max_new)
            for i, p in enumerate(prompts)]


def expected_tokens(prompt, max_new=4):
    return int(prompt[0]) + np.arange(max_new, dtype=np.int32)


def counter(scrape: str, name: str) -> float:
    lines = [ln for ln in scrape.splitlines() if ln.startswith(name)]
    assert lines, name
    return float(lines[0].split()[-1])


@pytest.fixture(scope="module")
def runners():
    """(JAX pair, port pair on JAX's weights): the JAX test's models."""
    key = jax.random.PRNGKey(0)
    s_cfg = reduced(get_config("internlm2-1.8b"))
    l_cfg = s_cfg.replace(name="large", n_layers=3, d_ff=768)
    js = jtfm.init_params(s_cfg, key)
    jl = jtfm.init_params(l_cfg, jax.random.fold_in(key, 1))
    ts_cfg = t_reduced(t_get_config("internlm2-1.8b"))
    tl_cfg = ts_cfg.replace(name="large", n_layers=3, d_ff=768)
    return ((JModelRunner(s_cfg, js), JModelRunner(l_cfg, jl)),
            (ModelRunner(ts_cfg, params_from_jax(jax.device_get(js), "cpu")),
             ModelRunner(tl_cfg, params_from_jax(jax.device_get(jl),
                                                 "cpu"))))


def ragged_prompts(key, lens, vocab):
    return [np.asarray(jax.random.randint(jax.random.fold_in(key, i),
                                          (n,), 0, vocab), np.int32)
            for i, n in enumerate(lens)]


def jax_tokens(jlarge, prompts, max_new=4):
    """JAX's M_L generate of each prompt alone."""
    return np.stack([np.asarray(jlarge.generate(p[None, :], p.shape[0],
                                                max_new)[0][0])
                     for p in prompts])


# ---------------------------------------------------------------------------
# Wire format: goldens + framing limits
# ---------------------------------------------------------------------------

def test_golden_wire_format_pinned():
    """The serialized request/result payloads and their exact frame bytes
    match the committed fixture (the escape hatch for a change is bumping
    SCHEMA_VERSION and adding wire_v2.json)."""
    fix = json.loads(GOLDEN.read_text())
    assert fix["schema"] == wire.SCHEMA_VERSION, \
        "schema bumped: pin a new golden fixture for the new version"
    req = wire.encode_request(fix["request"]["rid"],
                              np.asarray(fix["request"]["prompt"], np.int32))
    assert req == fix["request"]
    assert wire.frame_bytes(req).hex() == fix["request_frame_hex"]
    res = LargeResult(rid=fix["result"]["rid"],
                      tokens=np.asarray(fix["result"]["tokens"], np.int32),
                      batch_id=fix["result"]["batch_id"],
                      n_real=fix["result"]["n_real"],
                      pad_to=fix["result"]["pad_to"],
                      reason=fix["result"]["reason"],
                      prompt_len=fix["result"]["prompt_len"])
    assert wire.encode_result(res) == fix["result"]
    assert wire.frame_bytes(fix["result"]).hex() == fix["result_frame_hex"]
    assert wire.frame_bytes(
        wire.envelope("submit", reqs=[req])).hex() \
        == fix["submit_envelope_frame_hex"]
    assert wire.frame_bytes(
        wire.envelope("results", results=[fix["result"]], pending=0)).hex() \
        == fix["results_envelope_frame_hex"]
    # and the pinned bytes decode back to the same payloads
    rid, prompt = wire.decode_request(fix["request"])
    assert rid == fix["request"]["rid"]
    np.testing.assert_array_equal(prompt, fix["request"]["prompt"])
    back = wire.decode_result(fix["result"])
    np.testing.assert_array_equal(back.tokens, fix["result"]["tokens"])


def test_port_frames_equal_the_golden_bytes():
    """`wire.frame_bytes` of the port equals the fixture's frames byte for
    byte (each frame decoded from the fixture's hex and encoded again),
    and JAX's `frame_bytes` gives the same bytes for the same messages."""
    from repro.serving.remote import wire as jwire
    fix = json.loads(GOLDEN.read_text())
    for key in ("request_frame_hex", "result_frame_hex",
                "submit_envelope_frame_hex", "results_envelope_frame_hex"):
        frame = bytes.fromhex(fix[key])
        msg = json.loads(frame[4:].decode("utf-8"))
        assert int.from_bytes(frame[:4], "big") == len(frame) - 4
        assert wire.frame_bytes(msg) == frame, key
        assert jwire.frame_bytes(msg) == frame, key


def test_frame_roundtrip_and_limits():
    a, b = socket.socketpair()
    try:
        wire.send_frame(a, wire.envelope("ping", n=1))
        msg = wire.recv_frame(b)
        wire.check_schema(msg)
        assert msg["kind"] == "ping" and msg["n"] == 1
        # oversize length prefix rejected before allocation
        a.sendall((wire.MAX_FRAME + 1).to_bytes(4, "big"))
        with pytest.raises(wire.WireError, match="MAX_FRAME"):
            wire.recv_frame(b)
    finally:
        a.close()
        b.close()
    # truncated frame: peer closes mid-body
    a, b = socket.socketpair()
    try:
        a.sendall((100).to_bytes(4, "big") + b"only-a-few-bytes")
        a.close()
        with pytest.raises(wire.WireError, match="truncated"):
            wire.recv_frame(b)
    finally:
        b.close()
    # schema mismatch rejected loudly
    with pytest.raises(wire.WireError, match="schema mismatch"):
        wire.check_schema({"schema": wire.SCHEMA_VERSION + 1, "kind": "x"})


def test_decode_request_echoes_rid():
    with pytest.raises(wire.WireError, match="rid must be"):
        wire.decode_request({"rid": -1, "prompt": [1]})
    with pytest.raises(wire.WireError, match="prompt must be") as ei:
        wire.decode_request({"rid": 42, "prompt": []})
    assert ei.value.rid == 42
    with pytest.raises(wire.WireError) as ei:
        wire.decode_request({"rid": 7, "prompt": [1, "x"]})
    assert ei.value.rid == 7


# ---------------------------------------------------------------------------
# BatchPolicy: cancellation (server-side shutdown path)
# ---------------------------------------------------------------------------

def test_batch_policy_cancel():
    pol = BatchPolicy(large_batch=4, max_wait=None)
    for i in range(5):
        pol.add(_Pending(i, np.full(8 if i < 3 else 6, i, np.int32), 0.0))
    removed = pol.cancel([1, 3, 99])
    assert sorted(removed) == [1, 3]
    assert pol.n_pending == 3
    out = pol.take(now=0.0, drain=True)
    assert sorted(p.rid for g, _, _ in out for p in g) == [0, 2, 4]
    # cancelling everything leaves no empty groups behind
    pol.add(_Pending(9, np.full(8, 9, np.int32), 0.0))
    assert pol.cancel([9]) == [9]
    assert pol.n_pending == 0 and pol.next_deadline() is None


# ---------------------------------------------------------------------------
# Server/client contract (fake runner: protocol speed)
# ---------------------------------------------------------------------------

def test_socket_backend_submit_poll_drain():
    """JAX's test with `max_wait` None, so the clock cannot cut the
    leftover of the first submit before the second arrives (the JAX
    test's 0.01 s timer makes its batch reasons depend on scheduling):
    batches are then fixed by submission order."""
    srv = fake_server(max_wait=None)
    try:
        be = SocketBackend(srv.address, request_timeout=5.0)
        reqs = reqs_for([np.full(5, 10 + i, np.int32) for i in range(5)])
        be.submit(reqs[:3])
        be.submit(reqs[3:])
        out = be.drain()
        assert be.n_pending == 0
        assert sorted(r.rid for r in out) == [0, 1, 2, 3, 4]
        for r in out:
            np.testing.assert_array_equal(
                r.tokens, expected_tokens(reqs[r.rid].prompt))
        # batch metadata survives the wire: 2 full batches + 1 drain
        assert len(be.batch_log) == 3
        assert sorted(b["reason"] for b in be.batch_log) \
            == ["drain", "full", "full"]
        be.close()
    finally:
        srv.stop()


def test_server_stop_raises_while_the_worker_runs():
    """A worker still in its batch after `stop`'s timeout makes stop
    raise; a killed server's worker is left to finish for nobody, and its
    stop returns."""
    started, release = threading.Event(), threading.Event()

    class Stuck(FakeRunner):
        def generate(self, prompts, plen, max_new):
            started.set()
            release.wait(timeout=30.0)
            return super().generate(prompts, plen, max_new)

    live = MLServer(Stuck(), max_new=4, large_batch=1).start()
    killed = MLServer(Stuck(), max_new=4, large_batch=1).start()
    clients = []
    try:
        for srv in (live, killed):
            started.clear()
            be = SocketBackend(srv.address, request_timeout=5.0)
            clients.append(be)
            be.submit(reqs_for([np.full(5, 10, np.int32)]))
            assert started.wait(timeout=10.0)
        with pytest.raises(RuntimeError, match="still running"):
            live.stop(timeout=0.2)
        killed.kill()
        killed.stop(timeout=0.2)
    finally:
        release.set()
        for be in clients:
            be.close()
        live.stop()
        killed.stop()
    assert not live._worker.is_alive()


def test_server_session_reset_between_runs():
    """Consecutive engine runs reuse rid 0..N; a new client session
    resets server state so run 2 isn't served run 1's stale results."""
    srv = fake_server()
    try:
        p1 = [np.full(5, 10 + i, np.int32) for i in range(3)]
        be1 = SocketBackend(srv.address, request_timeout=5.0)
        be1.submit(reqs_for(p1))
        out1 = be1.drain()
        be1.close()
        # same rids, DIFFERENT prompts: stale delivery would be wrong
        p2 = [np.full(5, 50 + i, np.int32) for i in range(3)]
        be2 = SocketBackend(srv.address, request_timeout=5.0)
        be2.submit(reqs_for(p2))
        out2 = be2.drain()
        be2.close()
        assert sorted(r.rid for r in out1) == [0, 1, 2]
        assert sorted(r.rid for r in out2) == [0, 1, 2]
        for r in out2:
            np.testing.assert_array_equal(r.tokens,
                                          expected_tokens(p2[r.rid]))
    finally:
        srv.stop()


def test_connection_refused_is_loud_and_fast():
    """No server listening: a clear ConnectionError naming the address
    and the server entrypoint, quickly."""
    probe = socket.socket()
    probe.bind(("127.0.0.1", 0))
    port = probe.getsockname()[1]
    probe.close()                      # port now refuses connections
    t0 = time.perf_counter()
    with pytest.raises(ConnectionError, match="repro_torch.launch.ml_server"):
        SocketBackend(("127.0.0.1", port), connect_timeout=0.2,
                      retries=1, backoff=0.01)
    assert time.perf_counter() - t0 < 5.0


def test_corrupt_payload_rejected_with_rid_echoed():
    """A well-framed but invalid request is rejected with the offending
    rid echoed — and the server keeps serving."""
    srv = fake_server()
    try:
        s = socket.create_connection(srv.address, timeout=2.0)
        s.settimeout(2.0)
        wire.send_frame(s, wire.envelope("hello", session="bad-client"))
        assert wire.recv_frame(s)["kind"] == "ok"
        wire.send_frame(s, wire.envelope(
            "submit", reqs=[{"rid": 42, "prompt": "not-a-token-list"}]))
        reply = wire.recv_frame(s)
        assert reply["kind"] == "error" and reply["rid"] == 42
        assert "42" in reply["error"]
        # connection survives a payload error: the next RPC still works
        wire.send_frame(s, wire.envelope("health"))
        assert wire.recv_frame(s)["kind"] == "ok"
        s.close()

        # undecodable frame (truncated mid-body): connection dropped,
        # server survives, a fresh client is served normally
        s2 = socket.create_connection(srv.address, timeout=2.0)
        s2.sendall((1000).to_bytes(4, "big") + b"garbage")
        s2.close()
        be = SocketBackend(srv.address, request_timeout=5.0)
        be.submit(reqs_for([np.full(5, 10, np.int32)]))
        assert [r.rid for r in be.drain()] == [0]
        be.close()
    finally:
        srv.stop()


def test_slow_replica_timeout_then_retry_succeeds():
    """The server delays its next response past the client's request
    timeout; the RPC retries (counter increments), the retried submit
    dedupes server-side, and every result arrives exactly once."""
    srv = fake_server()
    try:
        reg = MetricsRegistry()
        be = SocketBackend(srv.address, request_timeout=0.15,
                           retries=4, backoff=0.01, registry=reg)
        srv.fault_delay_next = 1
        srv.fault_delay_s = 0.5       # > request_timeout: forces a retry
        be.submit(reqs_for([np.full(5, 10 + i, np.int32)
                            for i in range(3)]))
        out = be.drain()
        assert sorted(r.rid for r in out) == [0, 1, 2]   # exactly once
        assert be.n_pending == 0
        assert counter(reg.render(), "serving_ml_rpc_retries_total") >= 1
        be.close()
    finally:
        srv.stop()


def test_cancel_on_close_withdraws_inflight():
    """close() cancels the backend's in-flight rids server-side (pending
    drops to zero) and the server goes on to serve the next client."""
    srv = fake_server(large_batch=64, max_wait=None)   # nothing flushes
    try:
        be = SocketBackend(srv.address, request_timeout=5.0)
        be.submit(reqs_for([np.full(5, 10 + i, np.int32)
                            for i in range(4)]))
        deadline = time.perf_counter() + 2.0
        while srv.n_pending < 4 and time.perf_counter() < deadline:
            time.sleep(0.01)
        assert srv.n_pending == 4
        be.close()                    # cancels rids 0..3
        deadline = time.perf_counter() + 2.0
        while srv.n_pending and time.perf_counter() < deadline:
            time.sleep(0.01)
        assert srv.n_pending == 0
        be2 = SocketBackend(srv.address, request_timeout=5.0)
        be2.submit(reqs_for([np.full(5, 30, np.int32)]))
        assert [r.rid for r in be2.drain()] == [0]
        be2.close()
    finally:
        srv.stop()


# ---------------------------------------------------------------------------
# Replica pool: ejection + re-dispatch (fault injection)
# ---------------------------------------------------------------------------

def test_pool_kill_replica_mid_batch_redispatches():
    """Kill the replica holding in-flight work mid-batch: the pool ejects
    it, re-dispatches the orphans to the survivor, and completes the
    drain with every rid exactly once."""
    slow = fake_server(large_batch=8, max_wait=None, gen_delay=30.0)
    healthy = fake_server()
    reg = MetricsRegistry()
    pool = ReplicaPool([slow.address, healthy.address],
                       request_timeout=1.0, retries=1, backoff=0.01,
                       health_interval=0.05, max_new=4, registry=reg)
    try:
        prompts = [np.full(5, 10 + i, np.int32) for i in range(5)]
        pool.submit(reqs_for(prompts))    # least-loaded tie -> slow (idx 0)
        deadline = time.perf_counter() + 2.0
        while slow.n_pending < 5 and time.perf_counter() < deadline:
            time.sleep(0.01)
        assert slow.n_pending == 5
        slow.kill()                       # abrupt: connections reset
        out = pool.drain()
        assert sorted(r.rid for r in out) == [0, 1, 2, 3, 4]
        assert len(out) == len({r.rid for r in out})     # no duplicates
        for r in out:
            np.testing.assert_array_equal(r.tokens,
                                          expected_tokens(prompts[r.rid]))
        assert pool.n_alive == 1 and pool.n_pending == 0
        scrape = reg.render()
        assert counter(scrape, "serving_ml_replica_ejections_total") == 1
        assert counter(scrape,
                       "serving_ml_redispatched_requests_total") == 5
    finally:
        pool.close()
        healthy.stop()
        slow.stop()


def test_pool_batch_aware_routing_fills_batches():
    """With `large_batch` known, streamed single-request submits stick to
    one replica until its group fills, then move on: every server batch
    flushes full and both replicas get work."""
    a = fake_server(large_batch=2, max_wait=None, gen_delay=0.25)
    b = fake_server(large_batch=2, max_wait=None, gen_delay=0.25)
    pool = ReplicaPool([a.address, b.address], request_timeout=5.0,
                       health_interval=10.0, max_new=4, large_batch=2)
    try:
        prompts = [np.full(5, 10 + i, np.int32) for i in range(4)]
        for r in reqs_for(prompts):       # streamed, like the engine
            pool.submit([r])
        got = pool.drain()
        assert sorted(r.rid for r in got) == [0, 1, 2, 3]
        for srv in (a, b):                # work landed on BOTH replicas
            batches = srv.batch_log
            assert len(batches) == 1
            assert batches[0]["n_real"] == 2
            assert batches[0]["reason"] == "full"
    finally:
        pool.close()
        a.stop()
        b.stop()


def test_pool_all_replicas_dead_raises():
    srv = fake_server(large_batch=8, max_wait=None, gen_delay=30.0)
    pool = ReplicaPool([srv.address], request_timeout=0.5, retries=0,
                       backoff=0.01, health_interval=0.02, max_new=4)
    try:
        pool.submit(reqs_for([np.full(5, 10, np.int32)]))
        srv.kill()
        with pytest.raises(RemoteBackendError, match="dead"):
            for _ in range(200):          # bounded, must raise not hang
                pool.poll(timeout=0.05)
                time.sleep(0.01)
    finally:
        pool.close()
        srv.stop()


def test_pool_health_check_ejects_silently_dead_replica():
    """A replica that dies holding no work is ejected by the periodic
    health probe; the pool keeps serving on the survivor."""
    a = fake_server()
    b = fake_server()
    pool = ReplicaPool([a.address, b.address], request_timeout=1.0,
                       retries=1, backoff=0.01, health_interval=0.05,
                       max_new=4)
    try:
        a.kill()
        time.sleep(0.1)                   # > health_interval
        pool.poll()
        assert pool.n_alive == 1
        prompts = [np.full(5, 10 + i, np.int32) for i in range(4)]
        pool.submit(reqs_for(prompts))
        out = pool.drain()
        assert sorted(r.rid for r in out) == [0, 1, 2, 3]
        assert pool.n_alive == 1
    finally:
        pool.close()
        b.stop()
        a.stop()


# ---------------------------------------------------------------------------
# Engine integration: parity + drain-through-death (real models)
# ---------------------------------------------------------------------------

def _remote_factory(kind, addresses, backend=None):
    def factory(runner=None, max_new=0, large_batch=None, max_wait=None,
                stub_latency=0.0, registry=None):
        if kind == "socket":
            return (backend or SocketBackend)(
                addresses[0], request_timeout=30.0, registry=registry)
        return ReplicaPool(addresses, request_timeout=30.0,
                           health_interval=0.1, max_new=max_new,
                           large_batch=large_batch, registry=registry)
    return factory


def test_engine_parity_sync_socket_pool(runners):
    """Bit-exact greedy outputs across sync (in-process reference),
    socket (one remote replica) and a 2-replica pool on a ragged Poisson
    workload, each equal to JAX's M_L generate of every prompt."""
    (_, jlarge), (small, large) = runners
    key = jax.random.PRNGKey(5)
    lens = [6, 10] * 6
    prompts = ragged_prompts(key, lens, small.cfg.vocab_size)
    arrivals = poisson_arrivals(len(prompts), rate=400.0, seed=1)
    servers = [MLServer(large, max_new=4, large_batch=4,
                        max_wait=0.02).start() for _ in range(2)]
    try:
        backends = {
            "sync": "sync",
            "socket": _remote_factory("socket", [servers[0].address]),
            "pool": _remote_factory("pool",
                                    [s.address for s in servers]),
        }
        outs = {}
        for name, backend in backends.items():
            eng = ContinuousCascadeEngine(
                small, large, n_slots=4, tau=1e9, min_tokens=2,
                early_exit=True, large_batch=4, large_backend=backend,
                large_max_wait=0.02)
            res = eng.run(make_requests(prompts, 4, arrivals), 4)
            assert all(r.state == DONE for r in res.requests)
            assert res.deferred.all()
            assert res.stats["ml_backend"] == name
            outs[name] = res
        np.testing.assert_array_equal(outs["sync"].tokens,
                                      jax_tokens(jlarge, prompts))
        np.testing.assert_array_equal(outs["sync"].tokens,
                                      outs["socket"].tokens)
        np.testing.assert_array_equal(outs["sync"].tokens,
                                      outs["pool"].tokens)
        np.testing.assert_array_equal(outs["sync"].deferred,
                                      outs["pool"].deferred)
    finally:
        for s in servers:
            s.stop()


def test_engine_drain_survives_replica_death(runners):
    """A replica dies while the engine drains: the pool re-dispatches its
    in-flight deferrals and the run completes with every request DONE and
    tokens equal to a direct M_L regeneration (the port's and JAX's)."""
    (_, jlarge), (small, large) = runners
    key = jax.random.PRNGKey(7)
    prompts = ragged_prompts(key, [6] * 8, small.cfg.vocab_size)
    # doomed hoards work (big batch, huge injected latency per batch);
    # survivor is responsive
    doomed = MLServer(FakeRunner(delay=30.0), max_new=4, large_batch=8,
                      max_wait=None).start()
    survivor = MLServer(large, max_new=4, large_batch=4,
                        max_wait=0.02).start()

    killer_done = threading.Event()

    def kill_when_loaded():
        deadline = time.perf_counter() + 30.0
        while time.perf_counter() < deadline:
            if doomed.n_pending > 0:
                doomed.kill()
                break
            time.sleep(0.005)
        killer_done.set()

    killer = threading.Thread(target=kill_when_loaded, daemon=True)
    killer.start()
    try:
        eng = ContinuousCascadeEngine(
            small, large, n_slots=4, tau=1e9, min_tokens=2,
            early_exit=True, large_batch=8,
            large_backend=_remote_factory(
                "pool", [doomed.address, survivor.address]),
            large_max_wait=None)
        res = eng.run(make_requests(prompts, 4), 4)
        assert killer_done.wait(timeout=30.0)
        assert all(r.state == DONE for r in res.requests)
        assert res.deferred.all()
        want, _ = large.generate(np.stack(prompts), 6, 4)
        np.testing.assert_array_equal(res.tokens, want)
        np.testing.assert_array_equal(res.tokens, jax_tokens(jlarge, prompts))
    finally:
        survivor.stop()
        doomed.stop()


# ---------------------------------------------------------------------------
# Across the two packages: one side's client against the other's server
# ---------------------------------------------------------------------------

def _cross_prompts(vocab):
    return ragged_prompts(jax.random.PRNGKey(9), [6, 10] * 4, vocab)


def test_port_socket_backend_against_jax_server(runners):
    """The port's engine, through its `SocketBackend`, against JAX's
    `MLServer` on JAX's M_L: tokens equal to the port's sync run."""
    (_, jlarge), (small, large) = runners
    prompts = _cross_prompts(small.cfg.vocab_size)
    srv = JMLServer(jlarge, max_new=4, large_batch=4, max_wait=0.02).start()
    try:
        outs = {}
        for name, backend in (("sync", "sync"), ("socket", _remote_factory(
                "socket", [srv.address]))):
            eng = ContinuousCascadeEngine(small, large, n_slots=4, tau=1e9,
                                          large_batch=4, large_max_wait=0.02,
                                          large_backend=backend)
            outs[name] = eng.run(make_requests(prompts, 4), 4)
            assert all(r.state == DONE for r in outs[name].requests)
        assert outs["socket"].stats["ml_backend"] == "socket"
        np.testing.assert_array_equal(outs["socket"].tokens,
                                      outs["sync"].tokens)
        assert len(srv.batch_log) >= 2
    finally:
        srv.stop()


def test_jax_socket_backend_against_port_server(runners):
    """JAX's engine, through its `SocketBackend`, against the port's
    `MLServer` on the port's M_L: tokens equal to JAX's sync run."""
    (jsmall, jlarge), (small, large) = runners
    prompts = _cross_prompts(small.cfg.vocab_size)
    srv = MLServer(large, max_new=4, large_batch=4, max_wait=0.02).start()
    try:
        outs = {}
        for name, backend in (("sync", "sync"), ("socket", _remote_factory(
                "socket", [srv.address], backend=JSocketBackend))):
            eng = JEngine(jsmall, jlarge, n_slots=4, tau=1e9, large_batch=4,
                          large_max_wait=0.02, large_backend=backend)
            outs[name] = eng.run(j_make_requests(prompts, 4), 4)
            assert all(r.state == DONE for r in outs[name].requests)
        assert outs["socket"].stats["ml_backend"] == "socket"
        np.testing.assert_array_equal(np.asarray(outs["socket"].tokens),
                                      np.asarray(outs["sync"].tokens))
        assert len(srv.batch_log) >= 2
    finally:
        srv.stop()


# ---------------------------------------------------------------------------
# Launch counters under concurrent launches
# ---------------------------------------------------------------------------

def test_launch_counters_lose_no_count_across_eight_threads():
    """Eight threads bump every wrapper's counter through `_build.count`,
    the hook each wrapper calls where it launches, with the interpreter
    switching threads as often as it can: every count is exact."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import deferral_entropy as de
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import gatekeeper_loss as gk
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import wkv_scan as wk
    fns = [de.deferral_entropy, fa.flash_attention, gk.gatekeeper_loss_tokens,
           pa.paged_flash_decode_gqa, pa.paged_flash_decode_mla,
           pa.paged_write_token, wk.wkv_scan]
    saved = [(fn.launches, getattr(fn, "launches_chunked", None))
             for fn in fns]
    n_threads, n_each = 8, 2000
    switch = sys.getswitchinterval()
    try:
        for fn in fns:
            fn.launches = 0
        wk.wkv_scan.launches_chunked = 0
        sys.setswitchinterval(1e-6)
        start = threading.Barrier(n_threads)

        def launch_all():
            start.wait(timeout=30)
            for i in range(n_each):
                for fn in fns[:-1]:
                    _build.count(fn, launches=1)
                _build.count(wk.wkv_scan, launches=1,
                             launches_chunked=i % 2 == 0)
        threads = [threading.Thread(target=launch_all)
                   for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        assert [fn.launches for fn in fns] == [n_threads * n_each] * len(fns)
        assert wk.wkv_scan.launches_chunked == n_threads * n_each // 2
    finally:
        sys.setswitchinterval(switch)
        for fn, (n, nc) in zip(fns, saved):
            fn.launches = n
            if nc is not None:
                fn.launches_chunked = nc


def test_deferral_ticket_counters_are_keyed_by_stream():
    """Distinct streams get distinct zeroed ticket counters; one key
    grows in place of its smaller tensor and never shrinks."""
    from repro_torch.kernels import deferral_entropy as de
    dev = torch.device("cpu")
    saved = dict(de._counters)
    try:
        a = de._row_counters(dev, 11, 4)
        b = de._row_counters(dev, 22, 4)
        assert a is not b and a.numel() == b.numel() == 4
        assert de._row_counters(dev, 11, 3) is a
        grown = de._row_counters(dev, 11, 9)
        assert grown.numel() == 9 and not grown.any()
        assert de._row_counters(dev, 11, 4) is grown
    finally:
        de._counters.clear()
        de._counters.update(saved)


# ---------------------------------------------------------------------------
# The serve CLI's M_L flags and the ml_server entry point
# ---------------------------------------------------------------------------

CLI = ["--device", "cpu", "--requests", "8", "--max-new", "4",
       "--deferral-ratio", "0.5", "--no-early-exit", "--large-batch", "2",
       "--large-max-wait", "0.01"]


@pytest.fixture(scope="module")
def cli_sync():
    from repro_torch.launch import serve
    res = serve.main(CLI)
    assert res.deferred.any()
    return res


@pytest.mark.parametrize("argv", [
    ["--large-backend", "thread"],
    ["--large-backend", "stub", "--stub-latency", "0.001"],
    ["--large-backend", "socket", "--ml-spawn", "1"],
    ["--large-backend", "pool", "--ml-spawn", "2",
     "--ml-health-interval", "0.5", "--ml-retries", "2"],
], ids=lambda a: a[1])
def test_cli_serves_through_each_ml_backend(argv, cli_sync):
    from repro_torch.launch import serve
    res = serve.main(CLI + argv)
    assert all(r.state == DONE for r in res.requests)
    assert res.stats["ml_backend"] == argv[1]
    np.testing.assert_array_equal(res.tokens, cli_sync.tokens)
    np.testing.assert_array_equal(res.deferred, cli_sync.deferred)


@pytest.mark.parametrize("argv, msg", [
    (["--ml-address", "127.0.0.1:1"], "needs --large-backend socket|pool"),
    (["--large-backend", "thread", "--ml-retries", "1"],
     "needs --large-backend socket|pool"),
    (["--large-backend", "thread", "--stub-latency", "0.1"],
     "--stub-latency needs --large-backend stub"),
    (["--large-backend", "socket"], "needs --ml-address"),
    (["--large-backend", "socket", "--ml-address", "a:1,b:2"],
     "exactly one --ml-address"),
    (["--large-backend", "pool", "--ml-spawn", "2", "--tiers", "3"],
     "2-tier cascade"),
    (["--tiers", "3", "--large-backend", "thread"], None),
], ids=["address-sync", "retries-thread", "latency-thread",
        "socket-no-address", "socket-two-addresses", "pool-tiers",
        "tiers-thread"])
def test_cli_rejects_contradictory_ml_flags(argv, msg, capsys):
    """JAX's argparse-time validations of the M_L flags. A local worker
    backend under a 3-tier ladder is no contradiction: it is served, one
    thread backend per edge (msg None)."""
    from repro_torch.launch import serve
    if msg is None:
        res = serve.main(["--device", "cpu", "--requests", "6",
                          "--max-new", "3", "--deferral-ratio", "0.5"]
                         + argv)
        assert all(r.state == DONE for r in res.requests)
        assert res.stats["n_tiers"] == 3
        assert res.stats["ml_backends"] == ["thread", "thread"]
        return
    with pytest.raises(SystemExit) as exc:
        serve.main(["--device", "cpu"] + argv)
    assert exc.value.code == 2
    assert msg in capsys.readouterr().err


def test_ml_server_parser_matches_jax():
    """The port's ml_server takes JAX's flags with JAX's defaults, and
    --device."""
    from repro_torch.launch import ml_server
    args = vars(ml_server.build_parser().parse_args([]))
    assert args == {"arch": "internlm2-1.8b", "seed": 0, "device": None,
                    "host": "127.0.0.1", "port": 0, "max_new": 8,
                    "large_batch": 0, "max_wait": 0.0, "latency": 0.0}
    args = ml_server.build_parser().parse_args(
        ["--device", "cpu", "--port", "7070", "--large-batch", "4",
         "--max-wait", "0.02", "--max-new", "6"])
    assert (args.device, args.port, args.large_batch, args.max_wait,
            args.max_new) == ("cpu", 7070, 4, 0.02, 6)


def test_ml_server_process_serves_the_cli(cli_sync):
    """`python -m repro_torch.launch.ml_server` in a process of its own,
    the serve CLI connected with --large-backend socket --ml-address:
    tokens equal to --large-backend sync; a shutdown frame stops it."""
    from repro_torch.launch import serve
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.ml_server", "--device",
         "cpu", "--max-new", "4", "--large-batch", "2", "--max-wait",
         "0.01"], cwd=REPO, env=dict(os.environ,
                                     PYTHONPATH=str(REPO / "src")),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        line = ""
        ready = threading.Event()

        def read_first():
            nonlocal line
            line = proc.stdout.readline()
            ready.set()
        threading.Thread(target=read_first, daemon=True).start()
        assert ready.wait(timeout=120), "ml_server did not start"
        assert "listening on" in line, (line, proc.stderr.read())
        address = line.split("--ml-address ")[1].strip()
        res = serve.main(CLI + ["--large-backend", "socket",
                                "--ml-address", address])
        np.testing.assert_array_equal(res.tokens, cli_sync.tokens)
        np.testing.assert_array_equal(res.deferred, cli_sync.deferred)
        host, port = address.rsplit(":", 1)
        with socket.create_connection((host, int(port)), timeout=5.0) as s:
            s.settimeout(5.0)
            wire.send_frame(s, wire.envelope("shutdown"))
            assert wire.recv_frame(s)["kind"] == "ok"
        out, _ = proc.communicate(timeout=30)
        assert proc.returncode == 0
        assert "served" in out
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate(timeout=30)
