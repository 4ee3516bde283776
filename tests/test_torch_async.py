"""The port's non-blocking M_L backends on the CPU against the JAX
package: every test of tests/test_serving_async.py, run on the port with
JAX's weights (converted by `convert.params_from_jax`) and JAX's prompts.
The batch-shape policy is driven in lockstep with JAX's `BatchPolicy`;
backend and engine outputs are held to JAX's (its `ModelRunner.generate`
or its engine on the same requests): tokens and deferral masks exact,
confidences within 1e-5. Every wait has its own bound."""
import json
import threading
import time

import jax
import numpy as np
import pytest
import torch

from _hypothesis_shim import given, settings, st
from repro.configs import get_config, reduced
from repro.data.synthetic import make_lm_stream
from repro.models import transformer as jtfm
from repro.serving import CascadeEngine as JCascadeEngine
from repro.serving import ContinuousCascadeEngine as JEngine
from repro.serving import make_requests as j_make_requests
from repro.serving.engine import ModelRunner as JModelRunner
from repro.serving.large_backend import BatchPolicy as JBatchPolicy
from repro.serving.large_backend import _Pending as JPending
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs import reduced as t_reduced
from repro_torch.convert import params_from_jax
from repro_torch.serving import (CascadeEngine, ContinuousCascadeEngine,
                                 ModelRunner, RemoteStubBackend, Request,
                                 ThreadedBackend, make_requests,
                                 poisson_arrivals)
from repro_torch.serving.large_backend import (FLUSH_DRAIN, FLUSH_FULL,
                                               FLUSH_MAX_WAIT, BatchPolicy,
                                               _Pending, make_large_backend)
from repro_torch.serving.request import DONE

torch.set_num_threads(1)
CONF_ATOL = 1e-5      # mean eq.-8 confidence, fp32 on both sides
pytestmark = pytest.mark.filterwarnings("ignore::DeprecationWarning")


@pytest.fixture(scope="module")
def runners():
    """tests/test_serving_async.py's fixture: the JAX pair, the port's
    pair on JAX's weights, and JAX's 16 prompts of 8 tokens."""
    key = jax.random.PRNGKey(0)
    s_cfg = reduced(get_config("internlm2-1.8b"))
    l_cfg = s_cfg.replace(name="large", n_layers=3, d_ff=768)
    js = jtfm.init_params(s_cfg, key)
    jl = jtfm.init_params(l_cfg, jax.random.fold_in(key, 1))
    ts_cfg = t_reduced(t_get_config("internlm2-1.8b"))
    tl_cfg = ts_cfg.replace(name="large", n_layers=3, d_ff=768)
    small = ModelRunner(ts_cfg, params_from_jax(jax.device_get(js), "cpu"))
    large = ModelRunner(tl_cfg, params_from_jax(jax.device_get(jl), "cpu"))
    prompts = np.asarray(make_lm_stream(jax.random.fold_in(key, 2), 16, 8,
                                        s_cfg.vocab_size))
    return (JModelRunner(s_cfg, js), JModelRunner(l_cfg, jl)), \
        (small, large), prompts


def bounded(fn, seconds: float = 120.0):
    """fn() on a helper thread; fails the test if it has not returned
    within `seconds` (a hung worker must not hang the suite)."""
    out, err = [], []

    def target():
        try:
            out.append(fn())
        except BaseException as e:              # noqa: BLE001
            err.append(e)
    t = threading.Thread(target=target, daemon=True)
    t.start()
    t.join(seconds)
    assert not t.is_alive(), f"did not return within {seconds} s"
    if err:
        raise err[0]
    return out[0]


def ragged_prompts(key, lens, vocab):
    return [np.asarray(jax.random.randint(jax.random.fold_in(key, i),
                                          (n,), 0, vocab), np.int32)
            for i, n in enumerate(lens)]


def jax_tokens(jlarge, prompts, plen, max_new):
    return np.asarray(jlarge.generate(np.asarray(prompts), plen,
                                      max_new)[0])


def assert_same_run(res, ref):
    """Port engine result against JAX's: tokens and masks exact,
    confidences within CONF_ATOL."""
    np.testing.assert_array_equal(res.tokens, np.asarray(ref.tokens))
    np.testing.assert_array_equal(res.deferred, np.asarray(ref.deferred))
    np.testing.assert_allclose(res.confidence, np.asarray(ref.confidence),
                               atol=CONF_ATOL, rtol=0)


# ---------------------------------------------------------------------------
# Batch-shape policy (unit level), in lockstep with JAX's
# ---------------------------------------------------------------------------

def _pend(rid, plen, t=0.0):
    return _Pending(rid, np.full((plen,), rid, np.int32), t)


def _jpend(rid, plen, t=0.0):
    return JPending(rid, np.full((plen,), rid, np.int32), t)


def _shape(flushes):
    return [([p.rid for p in g], pad, reason) for g, pad, reason in flushes]


def test_batch_policy_full_then_max_wait_then_drain():
    pol = BatchPolicy(large_batch=3, max_wait=1.0)
    for i in range(4):
        pol.add(_pend(i, 8, t=float(i)))
    # one full batch pops immediately, remainder waits
    out = pol.take(now=0.0)
    assert len(out) == 1
    group, pad_to, reason = out[0]
    assert [p.rid for p in group] == [0, 1, 2]
    assert pad_to == 3 and reason == FLUSH_FULL
    assert pol.n_pending == 1
    # not timed out yet
    assert pol.take(now=3.5) == []
    # max-wait fires: partial group padded to large_batch
    (group, pad_to, reason), = pol.take(now=4.1)
    assert [p.rid for p in group] == [3]
    assert pad_to == 3 and reason == FLUSH_MAX_WAIT
    # drain flushes whatever remains, per length group, rid-sorted
    pol.add(_pend(9, 4))
    pol.add(_pend(7, 4))
    pol.add(_pend(8, 6))
    out = pol.take(now=0.0, drain=True)
    assert [(sorted(p.rid for p in g), r) for g, _, r in out] == [
        ([7, 9], FLUSH_DRAIN), ([8], FLUSH_DRAIN)]
    assert pol.n_pending == 0


def test_batch_policy_drain_padding():
    """Drain pads a single-length leftover up to large_batch but flushes
    multi-length ragged leftovers exact-size, as JAX's policy does."""
    pol = BatchPolicy(large_batch=4, max_wait=None)
    jpol = JBatchPolicy(large_batch=4, max_wait=None)
    for p, mk in ((pol, _pend), (jpol, _jpend)):
        p.add(mk(0, 8)); p.add(mk(1, 8))
    (_, pad_to, _), = pol.take(now=0.0, drain=True)
    assert pad_to == 4                              # uniform: padded
    assert jpol.take(now=0.0, drain=True)[0][1] == 4
    for p, mk in ((pol, _pend), (jpol, _jpend)):
        p.add(mk(2, 8)); p.add(mk(3, 6))
    out = pol.take(now=0.0, drain=True)
    assert [(len(g), p) for g, p, _ in out] == [(1, 1), (1, 1)]  # exact
    assert _shape(out) == _shape(jpol.take(now=0.0, drain=True))


def test_batch_policy_none_batches_only_at_drain():
    pol = BatchPolicy(large_batch=None, max_wait=None)
    for i in range(5):
        pol.add(_pend(i, 8))
    assert pol.take(now=1e9) == []
    (group, pad_to, _), = pol.take(now=0.0, drain=True)
    assert len(group) == 5 and pad_to == 5          # exact size, no pad
    assert pol.next_deadline() is None


# op encoding for the property test: ("add", plen) | ("take",) | ("drain",)
_OPS = st.lists(
    st.one_of(
        st.tuples(st.just("add"), st.sampled_from([4, 6, 8])),
        st.tuples(st.just("take")),
        st.tuples(st.just("drain"))),
    min_size=1, max_size=40)


@given(ops=_OPS,
       large_batch=st.one_of(st.none(), st.integers(1, 5)),
       max_wait=st.one_of(st.none(), st.just(0.5)))
@settings(max_examples=200, deadline=None)
def test_batch_policy_interleavings_conserve_requests(ops, large_batch,
                                                      max_wait):
    """Property: under arbitrary submit/take/drain interleavings every
    submitted rid comes back exactly once, every emitted group is uniform
    in prompt length, rid-sorted and padded to >= its size — and each
    take returns what JAX's policy returns on the same ops."""
    pol = BatchPolicy(large_batch, max_wait)
    jpol = JBatchPolicy(large_batch, max_wait)
    submitted, returned = [], []
    now = 0.0
    rid = 0

    def absorb(flushes, jflushes, drain):
        assert _shape(flushes) == _shape(jflushes)
        for group, pad_to, reason in flushes:
            plens = {int(p.prompt.shape[0]) for p in group}
            assert len(plens) == 1                  # uniform-length group
            rids = [p.rid for p in group]
            assert rids == sorted(rids)             # rid-sorted
            assert pad_to >= len(group)
            if large_batch is not None and not drain:
                assert pad_to == large_batch
            returned.extend(rids)

    for op in ops:
        now += 0.3                  # fixed clock steps: max_wait can fire
        if op[0] == "add":
            pol.add(_pend(rid, op[1], t=now))
            jpol.add(_jpend(rid, op[1], t=now))
            submitted.append(rid)
            rid += 1
        else:
            drain = op[0] == "drain"
            absorb(pol.take(now=now, drain=drain),
                   jpol.take(now=now, drain=drain), drain)
    absorb(pol.take(now=now, drain=True), jpol.take(now=now, drain=True),
           True)
    assert pol.n_pending == 0
    assert sorted(returned) == sorted(submitted)    # exactly-once
    assert len(returned) == len(set(returned))


@given(ops=_OPS)
@settings(max_examples=100, deadline=None)
def test_batch_policy_cancel_interleaved(ops):
    """Property: cancelling a random half of the still-pending rids at
    the end removes exactly those rids (as JAX's `cancel` does)."""
    pol = BatchPolicy(large_batch=3, max_wait=None)
    jpol = JBatchPolicy(large_batch=3, max_wait=None)
    submitted, returned = [], []
    rid = 0
    for op in ops:
        if op[0] == "add":
            pol.add(_pend(rid, op[1]))
            jpol.add(_jpend(rid, op[1]))
            submitted.append(rid)
            rid += 1
        else:
            got = pol.take(now=0.0, drain=(op[0] == "drain"))
            assert _shape(got) == _shape(
                jpol.take(now=0.0, drain=(op[0] == "drain")))
            for g, _, _ in got:
                returned.extend(p.rid for p in g)
    pending = [r for r in submitted if r not in returned]
    victims = pending[::2]
    assert sorted(pol.cancel(victims)) == sorted(victims)
    assert sorted(jpol.cancel(victims)) == sorted(victims)
    for g, _, _ in pol.take(now=0.0, drain=True):
        returned.extend(p.rid for p in g)
    assert sorted(returned) == sorted(set(submitted) - set(victims))


# ---------------------------------------------------------------------------
# Backends standalone: submit / poll / drain contract
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["sync", "thread", "stub"])
def test_backend_drain_completes_all_pending(runners, kind):
    """drain() returns every submitted request's tokens, equal to a
    direct M_L generate of the same prompts — the port's and JAX's."""
    (_, jlarge), (small, large), prompts = runners
    be = make_large_backend(kind, large, max_new=4, large_batch=3)
    reqs = [Request(rid=i, prompt=prompts[i], max_new=4) for i in range(7)]
    try:
        for r in reqs:
            be.submit([r])
        results = list(be.poll())
        results += bounded(be.drain)
    finally:
        be.close()
    assert be.n_pending == 0
    assert sorted(r.rid for r in results) == list(range(7))
    want, _ = large.generate(prompts[:7], 8, 4)
    np.testing.assert_array_equal(want, jax_tokens(jlarge, prompts[:7], 8, 4))
    for res in results:
        np.testing.assert_array_equal(res.tokens, want[res.rid])
    # 2 full batches of 3 + a drained leftover of 1 (padded to 3)
    reasons = sorted(r.reason for r in results)
    assert reasons.count(FLUSH_FULL) == 6 and reasons.count(FLUSH_DRAIN) == 1
    leftover = next(r for r in results if r.reason == FLUSH_DRAIN)
    assert leftover.n_real == 1 and leftover.pad_to == 3


@pytest.mark.parametrize("kind", ["sync", "thread", "stub"])
def test_poll_accepts_timeout_kwarg(runners, kind):
    """Protocol conformance: every backend accepts `poll(timeout=...)`,
    including ones that never block."""
    _, (small, large), prompts = runners
    be = make_large_backend(kind, large, max_new=4, large_batch=2)
    try:
        assert be.poll(timeout=0.01) == []      # idle: empty either way
        assert be.poll() == []
        be.submit([Request(rid=0, prompt=prompts[0], max_new=4)])
        be.flush()
        got = []
        deadline = time.perf_counter() + 10.0
        while not got and time.perf_counter() < deadline:
            got = be.poll(timeout=0.05)
    finally:
        be.close()
    assert [r.rid for r in got] == [0]


def test_threaded_max_wait_fires_partial_batch(runners):
    """A batch that never fills still flushes after max_wait."""
    _, (small, large), prompts = runners
    be = ThreadedBackend(large, max_new=4, large_batch=64, max_wait=0.05)
    reqs = [Request(rid=i, prompt=prompts[i], max_new=4) for i in range(3)]
    try:
        be.submit(reqs)
        got = []
        deadline = 100  # x 50ms poll
        while len(got) < 3 and deadline:
            got += be.poll(timeout=0.05)
            deadline -= 1
    finally:
        be.close()
    assert len(got) == 3
    assert all(r.reason == FLUSH_MAX_WAIT for r in got)
    assert got[0].n_real == 3 and got[0].pad_to == 64


def test_stub_backend_serializes_roundtrip(runners):
    """The RPC-shaped backend produces identical tokens through its
    serialized byte pipe, with injected latency."""
    (_, jlarge), (small, large), prompts = runners
    be = RemoteStubBackend(large, max_new=4, large_batch=None,
                           latency=0.01)
    reqs = [Request(rid=i, prompt=prompts[i], max_new=4) for i in range(4)]
    try:
        be.submit(reqs)
        results = bounded(be.drain)
    finally:
        be.close()
    want = jax_tokens(jlarge, prompts[:4], 8, 4)
    assert sorted(r.rid for r in results) == [0, 1, 2, 3]
    for res in results:
        assert res.tokens.dtype == np.int32
        np.testing.assert_array_equal(res.tokens, want[res.rid])


def test_idle_worker_blocks_until_woken():
    """An idle worker waits on its queue and wakes only for a submission,
    a flush or close (each wake-up would take the GIL from the engine's
    loop; JAX's worker wakes every 2 ms). A flush cuts the pending group
    and close ends the worker."""
    class Echo:
        def generate(self, prompts, plen, max_new, **kw):
            return np.repeat(prompts[:, :1], max_new, 1), None

    be = ThreadedBackend(Echo(), max_new=2, large_batch=4)
    cuts = []
    take = be._policy.take
    be._policy.take = lambda *a, **k: cuts.append(k) or take(*a, **k)
    be.submit([Request(rid=0, prompt=np.full(3, 7, np.int32), max_new=2)])
    time.sleep(0.3)
    assert len(cuts) == 1                       # the submission's wake-up
    be.flush()
    got = []
    deadline = time.perf_counter() + 10.0
    while not got and time.perf_counter() < deadline:
        got = be.poll(timeout=0.05)
    be.close()
    assert [r.rid for r in got] == [0] and got[0].reason == FLUSH_DRAIN
    assert not be._worker.is_alive()


def test_close_raises_while_the_worker_runs():
    """A worker still in its batch after `join_timeout` makes close raise
    instead of returning with the worker alive; once the batch ends the
    worker exits."""
    started, release = threading.Event(), threading.Event()

    class Stuck:
        def generate(self, prompts, plen, max_new, **kw):
            started.set()
            release.wait(timeout=30.0)
            return np.repeat(prompts[:, :1], max_new, 1), None

    be = ThreadedBackend(Stuck(), max_new=2, large_batch=1)
    be.join_timeout = 0.2
    be.submit([Request(rid=0, prompt=np.full(3, 7, np.int32), max_new=2)])
    try:
        assert started.wait(timeout=10.0)
        with pytest.raises(RuntimeError, match="still running"):
            be.close()
    finally:
        release.set()
    be._worker.join(timeout=10.0)
    assert not be._worker.is_alive()


def test_worker_death_surfaces_instead_of_hanging():
    """An M_L exception on the worker thread raises on the caller's next
    poll, not hang drain forever."""
    class Boom:
        def generate(self, *a, **k):
            raise ValueError("boom")

    be = ThreadedBackend(Boom(), max_new=4, large_batch=1)
    be.submit([Request(rid=0, prompt=np.zeros(4, np.int32), max_new=4)])
    with pytest.raises(RuntimeError, match="worker died"):
        for _ in range(100):                    # bounded, not forever
            be.poll(timeout=0.05)
    be.close()


def test_worker_death_fails_the_engine_run(runners):
    """The engine does not catch a worker's failure: the run raises."""
    _, (small, _large), prompts = runners

    class Boom:
        device = small.device

        def generate(self, *a, **k):
            raise ValueError("boom")

    eng = ContinuousCascadeEngine(small, Boom(), n_slots=8, tau=1e9,
                                  large_backend="thread", large_batch=2)
    with pytest.raises(RuntimeError, match="worker died"):
        bounded(lambda: eng.run(make_requests(prompts[:4], 4), 4))


# ---------------------------------------------------------------------------
# Engine integration: parity across backends and with JAX's engine
# ---------------------------------------------------------------------------

def test_engine_parity_sync_thread_stub(runners):
    """Per-request greedy outputs are bit-exact across the three M_L
    backends (results come back rid-sorted whatever their completion
    order) and equal JAX's engine on the same settings."""
    (jsmall, jlarge), (small, large), prompts = runners
    jcont = JEngine(jsmall, jlarge, n_slots=8, min_tokens=2)
    tau = jcont.calibrate(prompts, 8, 4, deferral_ratio=0.5)
    cont = ContinuousCascadeEngine(small, large, n_slots=8, min_tokens=2)
    assert abs(cont.calibrate(prompts, 8, 4, deferral_ratio=0.5) - tau) \
        <= CONF_ATOL
    common = dict(n_slots=8, tau=tau, min_tokens=2, early_exit=True,
                  large_batch=4, large_max_wait=0.02)
    ref = JEngine(jsmall, jlarge, large_backend="sync", **common).run(
        j_make_requests(prompts, 4), 4)
    outs = {}
    for kind, kw in (("sync", {}), ("thread", {}),
                     ("stub", dict(stub_latency=0.002))):
        eng = ContinuousCascadeEngine(small, large, large_backend=kind,
                                      **common, **kw)
        res = bounded(lambda: eng.run(make_requests(prompts, 4), 4))
        assert all(r.state == DONE for r in res.requests)
        assert [r.rid for r in res.requests] == list(range(16))
        assert res.stats["ml_backend"] == kind
        outs[kind] = res
    assert 0 < outs["sync"].deferred.sum() < 16
    for kind in ("sync", "thread", "stub"):
        assert_same_run(outs[kind], ref)
    np.testing.assert_array_equal(outs["sync"].tokens,
                                  outs["thread"].tokens)
    np.testing.assert_array_equal(outs["sync"].tokens, outs["stub"].tokens)


def test_mixed_flush_paths_identical_tokens(runners):
    """Mid-run full-batch flushes + max-wait partials + end-of-run drain
    leftovers give the same per-request tokens as one exact-size drain
    batch (and as JAX's engine)."""
    (jsmall, jlarge), (small, large), prompts = runners
    base = ContinuousCascadeEngine(small, large, n_slots=8, tau=1e9,
                                   min_tokens=2, early_exit=True,
                                   large_batch=None, large_backend="sync")
    want = base.run(make_requests(prompts, 4), 4)
    assert want.deferred.all()
    np.testing.assert_array_equal(want.tokens,
                                  jax_tokens(jlarge, prompts, 8, 4))
    for kind in ("sync", "thread"):
        eng = ContinuousCascadeEngine(
            small, large, n_slots=8, tau=1e9, min_tokens=2,
            early_exit=True, large_batch=3, large_backend=kind,
            large_max_wait=0.01)
        res = bounded(lambda: eng.run(make_requests(prompts, 4), 4))
        np.testing.assert_array_equal(res.tokens, want.tokens)
        # 16 deferrals in batches of 3 -> at least one partial flush
        # (padded) and several full ones; tokens unaffected either way
        assert res.stats["ml_batches"] >= 6
        assert res.stats["ml_batch_occupancy"] < 1.0


def test_threaded_steps_interleave_with_large_regeneration(runners,
                                                           tmp_path):
    """With the ThreadedBackend on a ragged Poisson workload the audit
    log shows M_S `step` events between a `large_submit` and its
    `large_complete` — M_S decode went on while M_L regenerated — and
    nonzero M_L queue-depth samples."""
    (_, jlarge), (small, large), _ = runners
    key = jax.random.PRNGKey(5)
    lens = [6, 10] * 8
    prompts = ragged_prompts(key, lens, small.cfg.vocab_size)
    arrivals = poisson_arrivals(len(prompts), rate=400.0, seed=1)
    audit = str(tmp_path / "audit.jsonl")
    eng = ContinuousCascadeEngine(small, large, n_slots=4, tau=1e9,
                                  min_tokens=2, early_exit=True,
                                  large_batch=4, large_backend="thread",
                                  large_max_wait=0.05)
    res = bounded(lambda: eng.run(make_requests(prompts, 6, arrivals), 6,
                                  audit_path=audit))
    assert res.deferred.all()
    # per-request parity against standalone M_L runs, the port's and
    # JAX's (ragged workloads have no static reference)
    for r in res.requests:
        t, _ = large.generate(r.prompt[None, :], r.prompt_len, 6)
        np.testing.assert_array_equal(r.tokens, t[0])
        np.testing.assert_array_equal(
            r.tokens, jax_tokens(jlarge, r.prompt[None, :], r.prompt_len,
                                 6)[0])

    events = [json.loads(line) for line in open(audit)]
    submits = {e["rid"]: i for i, e in enumerate(events)
               if e["event"] == "large_submit"}
    completes = {e["rid"]: i for i, e in enumerate(events)
                 if e["event"] == "large_complete"}
    assert set(submits) == set(completes) == set(range(16))
    interleaved = 0
    for rid, i in submits.items():
        j = completes[rid]
        interleaved += sum(1 for e in events[i + 1:j]
                           if e["event"] == "step")
    assert interleaved > 0, "no M_S steps overlapped M_L regeneration"
    # telemetry saw the M_L queue genuinely backed up mid-run
    assert res.stats["ml_queue_depth_peak"] > 0
    assert any(e.get("ml_pending", 0) > 0 for e in events
               if e["event"] == "step")


def test_sync_backend_unchanged_reference(runners):
    """The sync backend with large_batch=None stays bit-identical to the
    static engine, the port's and JAX's."""
    (jsmall, jlarge), (small, large), prompts = runners
    static = CascadeEngine(small, large)
    jstatic = JCascadeEngine(jsmall, jlarge)
    tau = jstatic.calibrate(prompts, 8, 4, deferral_ratio=0.5)
    static.tau = tau
    sres = static.serve(prompts, 8, 4)
    jres = jstatic.serve(prompts, 8, 4)
    np.testing.assert_array_equal(sres.tokens, np.asarray(jres.tokens))
    np.testing.assert_array_equal(sres.deferred, np.asarray(jres.deferred))
    cont = ContinuousCascadeEngine(small, large, n_slots=8, tau=tau,
                                   early_exit=False, large_backend="sync")
    cres = cont.run(make_requests(prompts, 4), 4)
    np.testing.assert_array_equal(cres.tokens, sres.tokens)
    np.testing.assert_array_equal(cres.deferred, sres.deferred)
    assert cres.stats["ml_backend"] == "sync"
    # large_batch=None: one exact-size drain batch per prompt length
    assert cres.stats["ml_batches"] == 1
    assert cres.stats["ml_batch_occupancy"] == 1.0


# ---------------------------------------------------------------------------
# The legacy flat-kwargs constructor and its attribute surface
# ---------------------------------------------------------------------------

def test_legacy_constructor_maps_onto_spec_and_config(runners):
    """Every legacy kwarg lands on the field LEGACY_KWARG_MAP names, with
    one DeprecationWarning, as JAX's shim does; the attributes read (and
    tau / margin / min_tokens / early_exit write) through."""
    from repro.serving.config import LEGACY_KWARG_MAP as J_MAP
    from repro_torch.serving.config import LEGACY_KWARG_MAP, MIGRATION_HINT
    (jsmall, jlarge), (small, large), _ = runners
    assert LEGACY_KWARG_MAP == J_MAP
    kw = dict(n_slots=3, tau=-2.5, margin=0.25, min_tokens=3,
              early_exit=False, large_batch=5, large_backend="stub",
              large_max_wait=0.5, stub_latency=0.01, steps_per_sync=2,
              backend="paged", block_size=8, n_blocks=40, prefill_chunk=4,
              paged_kernel=False, batch_prefill=False, prefix_sharing=False,
              cost_small=0.3, cost_large=2.0)
    with pytest.warns(DeprecationWarning) as rec:
        eng = ContinuousCascadeEngine(small, large, **kw)
    assert [str(w.message) for w in rec] == [MIGRATION_HINT]
    jeng = JEngine(jsmall, jlarge, **kw)
    for name in kw:
        assert getattr(eng, name) == getattr(jeng, name) == kw[name], name
    assert eng.small is small and eng.large is large
    eng.tau, eng.margin, eng.min_tokens, eng.early_exit = 1.5, 0.5, 0, True
    assert (eng.spec.edges[0].tau, eng.spec.edges[0].margin,
            eng.spec.edges[0].min_tokens, eng.config.early_exit) == \
        (1.5, 0.5, 1, True)
    with pytest.raises(TypeError, match="unknown"):
        ContinuousCascadeEngine(small, large, n_slot=3)
    with pytest.raises(TypeError, match="takes no extra kwargs"):
        ContinuousCascadeEngine(eng.spec, n_slots=3)
    with pytest.raises(TypeError, match="CascadeSpec"):
        ContinuousCascadeEngine(object(), object())
