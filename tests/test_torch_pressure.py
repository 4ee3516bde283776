"""Port memory-pressure and overload serving on the CPU against the JAX
package: the 14 tests of tests/test_serving_pressure.py, each run on the
port and on JAX with the same weights (JAX's init carried over by
`convert.py`) and prompts, and held equal where the outcome does not
depend on the wall clock — tokens, per-request states, the counts of
preemptions, OOM deferrals, rejections and swaps, and the order in which
victims are chosen (read from both audit logs). The deadline test keeps
JAX's own assertions. Added: a reduced DeepSeek-V2 (MLA + MoE) preempt
run against its unconstrained run (the snapshots cover the MLA leaves),
the pool's host copies on the MLA leaves, and the CLI's validations of
the six pressure and overload flags."""
import json

import numpy as np
import pytest

import jax
import torch

from _hypothesis_shim import given, settings, st
from repro.configs import get_config, reduced
from repro.data.synthetic import make_lm_stream
from repro.models import transformer as jtfm
from repro.serving import BlockPressure as JBlockPressure
from repro.serving import CascadeSpec as JCascadeSpec
from repro.serving import ContinuousCascadeEngine as JEngine
from repro.serving import EngineConfig as JEngineConfig
from repro.serving import MLBackendConfig as JMLBackendConfig
from repro.serving import PagedCachePool as JPagedCachePool
from repro.serving import PagedConfig as JPagedConfig
from repro.serving import PressureConfig as JPressureConfig
from repro.serving import SlotScheduler as JSlotScheduler
from repro.serving import engine as jeng
from repro.serving import make_requests as j_make_requests
from repro.serving.request import ArrivalQueue as JArrivalQueue
from repro.serving.request import Request as JRequest
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs import reduced as t_reduced
from repro_torch.convert import params_from_jax
from repro_torch.serving import (BlockPressure, CascadeSpec,
                                 ContinuousCascadeEngine, EngineConfig,
                                 MLBackendConfig, ModelRunner,
                                 PagedCachePool, PagedConfig, PressureConfig,
                                 SlotScheduler, make_requests)
from repro_torch.serving.request import (DONE, EXPIRED, REJECTED,
                                         ArrivalQueue, Request)

torch.set_num_threads(1)
CONF_ATOL = 1e-5      # mean eq.-8 confidence, fp32 on both sides
MAX_NEW = 10
BS = 4
SLOTS = 4
TIGHT = 16        # demand of a full slot set is 8 blocks/req = 2x this
GENEROUS = 64     # no pressure possible
VICTIM_EVENTS = ("preempt", "defer_oom", "shed", "resume")


@pytest.fixture(scope="module")
def runners():
    """(JAX pair, port pair, prompts): tests/test_serving_pressure.py's
    fixture, the port's runners on JAX's weights."""
    key = jax.random.PRNGKey(0)
    s_cfg = reduced(get_config("internlm2-1.8b"))
    l_cfg = s_cfg.replace(name="large", n_layers=3, d_ff=768)
    js = jtfm.init_params(s_cfg, key)
    jl = jtfm.init_params(l_cfg, jax.random.fold_in(key, 1))
    ts_cfg = t_reduced(t_get_config("internlm2-1.8b"))
    tl_cfg = ts_cfg.replace(name="large", n_layers=3, d_ff=768)
    jax_pair = (jeng.ModelRunner(s_cfg, js), jeng.ModelRunner(l_cfg, jl))
    torch_pair = (
        ModelRunner(ts_cfg, params_from_jax(jax.device_get(js), "cpu")),
        ModelRunner(tl_cfg, params_from_jax(jax.device_get(jl), "cpu")))
    rng = np.random.default_rng(7)
    lens = rng.integers(6, 21, size=10)
    base = make_lm_stream(jax.random.fold_in(key, 2), 10, 20,
                          s_cfg.vocab_size)
    prompts = [np.asarray(base[i, :n]).astype(np.int32)
               for i, n in enumerate(lens)]
    return jax_pair, torch_pair, prompts


@pytest.fixture(scope="module")
def tiny_cfgs():
    return (reduced(get_config("internlm2-1.8b")),
            t_reduced(t_get_config("internlm2-1.8b")))


def _engines(runners, *, n_blocks, pressure=None, slots=SLOTS,
             max_queue=None, deadline_s=None):
    """(JAX engine, port engine) with the JAX test's settings."""
    jax_pair, torch_pair, _ = runners
    jpress = JPressureConfig(**pressure) if pressure else None
    tpress = PressureConfig(**pressure) if pressure else None
    jeng_ = JEngine(
        JCascadeSpec.two_tier(*jax_pair, tau=-1e9),
        JEngineConfig(n_slots=slots, early_exit=False, steps_per_sync=4,
                      backend="paged", max_queue=max_queue,
                      deadline_s=deadline_s,
                      ml=JMLBackendConfig(kind="sync", large_batch=slots),
                      paged=JPagedConfig(block_size=BS, n_blocks=n_blocks,
                                         prefill_chunk=4, pressure=jpress)))
    teng = ContinuousCascadeEngine(
        CascadeSpec.two_tier(*torch_pair, tau=-1e9),
        EngineConfig(n_slots=slots, early_exit=False, steps_per_sync=4,
                     backend="paged", max_queue=max_queue,
                     deadline_s=deadline_s,
                     ml=MLBackendConfig(large_batch=slots),
                     paged=PagedConfig(block_size=BS, n_blocks=n_blocks,
                                       prefill_chunk=4, pressure=tpress)))
    return jeng_, teng


def _victims(path):
    """[(event, rid)] of the pressure events in an audit log, in order."""
    with open(path) as f:
        return [(e["event"], e["rid"]) for e in map(json.loads, f)
                if e["event"] in VICTIM_EVENTS]


def serve_both(runners, tmp_path, prompts=None, **kw):
    """Run the same workload on JAX's engine and the port's; returns
    (JAX result, port result, JAX victims, port victims, port engine)."""
    prompts = runners[2] if prompts is None else prompts
    jeng_, teng = _engines(runners, **kw)
    jres = jeng_.run(j_make_requests(prompts, MAX_NEW), MAX_NEW,
                     audit_path=str(tmp_path / "jax.jsonl"))
    tres = teng.run(make_requests(prompts, MAX_NEW), MAX_NEW,
                    audit_path=str(tmp_path / "port.jsonl"))
    teng.pool.check_invariants()
    return (jres, tres, _victims(tmp_path / "jax.jsonl"),
            _victims(tmp_path / "port.jsonl"), teng)


COUNTS = ("n_completed", "n_rejected", "n_expired", "n_preemptions",
          "oom_deferrals", "pressure_reliefs", "swap_outs", "swap_ins",
          "swapped_blocks", "prefill_dispatches", "prefill_chunks",
          "peak_blocks", "shared_tokens", "cow_clones")


def assert_same_as_jax(jres, tres, jvict, tvict):
    """Tokens, states and counts equal to JAX's; victims in JAX's order."""
    np.testing.assert_array_equal(tres.tokens, jres.tokens)
    for jr, tr in zip(jres.requests, tres.requests):
        assert tr.rid == jr.rid
        assert (tr.state, tr.tier, tr.deferred, tr.deferred_reason,
                tr.n_preempted, tr.n_small_steps) == (
            jr.state, jr.tier, jr.deferred, jr.deferred_reason,
            jr.n_preempted, jr.n_small_steps)
        np.testing.assert_array_equal(tr.tokens, jr.tokens)
    np.testing.assert_allclose(tres.confidence, jres.confidence,
                               atol=CONF_ATOL, equal_nan=True)
    for k in COUNTS:
        assert tres.stats.get(k) == jres.stats.get(k), k
    assert tvict == jvict


def assert_terminal_exactly_once(res, n):
    """Every request reaches exactly one terminal state; DONE requests
    carry a full generation, shed requests an empty one."""
    assert len(res.requests) == n
    assert len({r.rid for r in res.requests}) == n
    s = res.stats
    assert s["n_completed"] + s["n_rejected"] + s["n_expired"] == n
    for r in res.requests:
        if r.state == DONE:
            assert r.tokens is not None and len(r.tokens) == r.max_new
        else:
            assert r.shed and len(r.tokens) == 0


@pytest.fixture(scope="module")
def unconstrained(runners, tmp_path_factory):
    """Reference runs with a generous budget, JAX's and the port's."""
    jres, tres, _, _, _ = serve_both(runners, tmp_path_factory.mktemp("u"),
                                     n_blocks=GENEROUS)
    np.testing.assert_array_equal(tres.tokens, jres.tokens)
    return jres, tres


# ---------------------------------------------------------------------------
# Oversubscription + the preempt policy, bit-exact under pressure
# ---------------------------------------------------------------------------

def test_oversubscribed_preempt_completes_bit_exact(runners, unconstrained,
                                                    tmp_path):
    """2x+ reservation demand on a tight budget: every request completes
    with the unconstrained run's tokens, on the port as on JAX, with the
    same preemptions, swaps and victims."""
    jres, tres, jv, tv, _ = serve_both(
        runners, tmp_path, n_blocks=TIGHT,
        pressure=dict(oversubscribe=4.0, policy="preempt",
                      max_preemptions=50, swap_blocks=8))
    assert tres.stats["n_preemptions"] > 0
    assert tres.stats["n_completed"] == len(runners[2])
    assert_terminal_exactly_once(tres, len(runners[2]))
    assert all(r.state == DONE and r.tier == 0 for r in tres.requests)
    assert any(e == "resume" for e, _ in tv)
    np.testing.assert_array_equal(tres.tokens, unconstrained[1].tokens)
    np.testing.assert_array_equal(tres.tokens, unconstrained[0].tokens)
    np.testing.assert_array_equal(tres.confidence,
                                  unconstrained[1].confidence)
    assert_same_as_jax(jres, tres, jv, tv)


def test_preemption_bound_escalates_to_oom_deferral(runners, unconstrained,
                                                    tmp_path):
    """max_preemptions=1: victims past the bound go to M_L
    (deferred_reason "oom"); everything completes; requests that stayed
    on M_S keep the unconstrained tokens."""
    jres, tres, jv, tv, _ = serve_both(
        runners, tmp_path, n_blocks=TIGHT,
        pressure=dict(oversubscribe=4.0, policy="preempt",
                      max_preemptions=1))
    assert tres.stats["n_completed"] == len(runners[2])
    assert all(r.n_preempted <= 1 for r in tres.requests)
    oom = [r for r in tres.requests if r.deferred_reason == "oom"]
    assert tres.stats["oom_deferrals"] == len(oom) > 0
    assert all(r.deferred and r.state == DONE for r in oom)
    for i, r in enumerate(tres.requests):
        if not r.deferred:
            np.testing.assert_array_equal(
                r.tokens, unconstrained[1].requests[i].tokens)
    assert_same_as_jax(jres, tres, jv, tv)


def test_defer_on_oom_policy(runners, unconstrained, tmp_path):
    """The defer policy never resumes a victim: every eviction goes to
    M_L at once, tagged as an OOM deferral."""
    jres, tres, jv, tv, _ = serve_both(
        runners, tmp_path, n_blocks=TIGHT,
        pressure=dict(oversubscribe=4.0, policy="defer"))
    assert tres.stats["n_completed"] == len(runners[2])
    assert tres.stats["n_preemptions"] == 0
    assert tres.stats["oom_deferrals"] > 0
    for i, r in enumerate(tres.requests):
        assert r.state == DONE
        if not r.deferred:
            np.testing.assert_array_equal(
                r.tokens, unconstrained[1].requests[i].tokens)
    assert_same_as_jax(jres, tres, jv, tv)


def test_shed_policy_rejects_deterministically(runners, unconstrained,
                                               tmp_path):
    """The shed policy: pressure victims end REJECTED with empty outputs;
    survivors keep the unconstrained tokens."""
    jres, tres, jv, tv, _ = serve_both(
        runners, tmp_path, n_blocks=TIGHT,
        pressure=dict(oversubscribe=4.0, policy="shed"))
    s = tres.stats
    n = len(runners[2])
    assert s["n_rejected"] > 0
    assert s["n_completed"] + s["n_rejected"] == n
    assert s["shed_ratio"] == pytest.approx(s["n_rejected"] / n)
    assert_terminal_exactly_once(tres, n)
    for i, r in enumerate(tres.requests):
        if r.state == REJECTED:
            assert r.shed and len(r.tokens) == 0
        else:
            np.testing.assert_array_equal(
                r.tokens, unconstrained[1].requests[i].tokens)
    assert_same_as_jax(jres, tres, jv, tv)


def test_hostile_trace_no_starvation(runners, tmp_path):
    """Uniform prompts cross block boundaries in lockstep, so pressure
    recurs every few steps: age-priority requeue plus the preemption
    bound still complete every request within the bound."""
    vocab = runners[1][0].cfg.vocab_size
    prompts = [np.full(12, (i * 17) % vocab, dtype=np.int32)
               for i in range(8)]
    jres, tres, jv, tv, _ = serve_both(
        runners, tmp_path, prompts=prompts, n_blocks=12,
        pressure=dict(oversubscribe=4.0, policy="preempt",
                      max_preemptions=3))
    assert tres.stats["n_completed"] == len(prompts)
    assert tres.stats["n_preemptions"] > 0
    assert all(r.n_preempted <= 3 for r in tres.requests)
    assert_same_as_jax(jres, tres, jv, tv)


# ---------------------------------------------------------------------------
# Admission overload control: bounded queue + deadlines
# ---------------------------------------------------------------------------

def test_queue_bound_sheds_newest(runners, unconstrained, tmp_path):
    """max_queue keeps the OLDEST ready entries; the shed ones end
    REJECTED with empty outputs and the survivors drain normally."""
    jres, tres, jv, tv, _ = serve_both(runners, tmp_path,
                                       n_blocks=GENEROUS, max_queue=2)
    s = tres.stats
    n = len(runners[2])
    assert s["n_completed"] == 2 and s["n_rejected"] == n - 2
    assert_terminal_exactly_once(tres, n)
    assert sorted(r.rid for r in tres.requests if r.state == DONE) == [0, 1]
    assert all(r.state == REJECTED for r in tres.requests if r.rid >= 2)
    for r in tres.requests[:2]:
        np.testing.assert_array_equal(
            r.tokens, unconstrained[0].requests[r.rid].tokens)
    assert_same_as_jax(jres, tres, jv, tv)


def test_deadline_expires_queued_requests(runners, unconstrained):
    """A deadline far shorter than the service time expires requests
    stuck behind one slot; admitted requests are finished, never killed
    in flight. The split depends on the wall clock, so no count is held
    against JAX's; completed requests keep the unconstrained tokens."""
    _, teng = _engines(runners, n_blocks=GENEROUS, slots=1,
                       deadline_s=0.01)
    res = teng.run(make_requests(runners[2][:6], MAX_NEW), MAX_NEW)
    s = res.stats
    assert s["n_expired"] >= 1 and s["n_completed"] >= 1
    assert s["n_completed"] + s["n_expired"] == 6
    assert_terminal_exactly_once(res, 6)
    done = [r for r in res.requests if r.state == DONE]
    assert all(r.state == EXPIRED for r in res.requests if r not in done)
    for r in done:
        np.testing.assert_array_equal(
            r.tokens, unconstrained[0].requests[r.rid].tokens)


def test_requeue_age_priority_unit():
    """A preempted request re-enters keyed on its ORIGINAL arrival time
    and pops before every never-admitted arrival; overflow shedding keeps
    the oldest entries — the same orders as JAX's queue."""
    def orders(queue_cls, request_cls):
        mk = lambda rid, t: request_cls(
            rid=rid, prompt=np.arange(4, dtype=np.int32), max_new=4,
            arrival_time=t)
        old, mid, new = mk(0, 0.0), mk(1, 1.0), mk(2, 2.0)
        q = queue_cls([mid, new])
        q.release(5.0)
        q.requeue(old)                  # preempted at t=4, arrived at t=0
        popped = [q.pop_ready().rid for _ in range(3)]
        q = queue_cls([mk(i, float(i)) for i in range(5)], max_queue=2)
        q.release(10.0)
        shed = [r.rid for r in q.shed_overflow()]
        return popped, shed, q.pop_ready().rid

    got = orders(ArrivalQueue, Request)
    assert got == ([0, 1, 2], [2, 3, 4], 0)
    assert got == orders(JArrivalQueue, JRequest)


# ---------------------------------------------------------------------------
# Pool: oversubscription accounting, loud release, swap tier, snapshots
# ---------------------------------------------------------------------------

def _pools(cfgs, **kw):
    jcfg, tcfg = cfgs
    return (JPagedCachePool(jcfg, **kw),
            PagedCachePool(tcfg, device="cpu", **kw))


def _same_books(jpool, tpool):
    np.testing.assert_array_equal(tpool.tables, jpool.tables)
    np.testing.assert_array_equal(tpool.ref, jpool.ref)
    assert tpool.n_free_blocks == jpool.n_free_blocks
    assert (tpool.swap_outs, tpool.swap_ins, tpool.n_swapped_blocks) == (
        jpool.swap_outs, jpool.swap_ins, jpool.n_swapped_blocks)


def _fill(pool, seed=0):
    """Random contents in every cache leaf (zeros would hide a copy that
    never happened)."""
    g = torch.Generator().manual_seed(seed)
    for leaves in pool.cache.values():
        for leaf in leaves.values():
            leaf.copy_(torch.randn(leaf.shape, generator=g))


def test_pool_oversubscription_accounting(tiny_cfgs):
    jpool, pool = _pools(tiny_cfgs, n_slots=3, n_blocks=8, block_size=4,
                         max_len=40, oversubscribe=2.0)
    assert pool.virtual_blocks == jpool.virtual_blocks == 16
    for p in (jpool, pool):
        a, b, c = p.alloc(), p.alloc(), p.alloc()
        for s in (a, b, c):
            p.reserve(s, 20)            # 5 blocks each: 15 <= 16 virtual
        p.check_invariants()
        # physical exhaustion raises BlockPressure instead of the
        # reservation-invariant RuntimeError
        p.ensure_mapped(a, 20)
        p.ensure_mapped(b, 12)          # 8 physical blocks now mapped
        with pytest.raises((BlockPressure, JBlockPressure)) as exc:
            p.ensure_mapped(c, 4)
        assert isinstance(exc.value, BlockPressure if p is pool
                          else JBlockPressure)
        p.check_invariants()            # failed map left the books sound
        assert p.n_mapped[c] == 0
        p.release(a)                    # relief: the retry succeeds
        p.ensure_mapped(c, 4)
        p.check_invariants()
    _same_books(jpool, pool)

    # a non-oversubscribed pool can never reach BlockPressure: the same
    # over-demand is refused at reservation time
    flat = PagedCachePool(tiny_cfgs[1], n_slots=3, n_blocks=8, block_size=4,
                          max_len=40, device="cpu")
    s0 = flat.alloc()
    flat.reserve(s0, 20)
    assert not flat.can_reserve(20)     # 10 > 8 physical


def test_pool_release_is_loudly_idempotent(tiny_cfgs):
    pool = PagedCachePool(tiny_cfgs[1], n_slots=2, n_blocks=8, block_size=4,
                          max_len=16, device="cpu")
    a = pool.alloc()
    gen = pool.generations[a]
    pool.reserve(a, 8)
    pool.ensure_mapped(a, 8)
    pool.release(a, expected_generation=gen)
    with pytest.raises(RuntimeError, match="double release"):
        pool.release(a)
    # stale release: slot re-allocated to a new tenant since the caller
    # captured its generation
    b = pool.alloc()
    assert b == a
    with pytest.raises(RuntimeError, match="stale release"):
        pool.release(b, expected_generation=gen)
    pool.release(b, expected_generation=pool.generations[b])
    pool.check_invariants()


def _assert_snapshots_equal(s0, s1):
    assert len(s0) == len(s1)
    for b0, b1 in zip(s0, s1):
        assert b0.keys() == b1.keys()
        for kind in b0:
            for name in b0[kind]:
                torch.testing.assert_close(b1[kind][name], b0[kind][name],
                                           atol=0, rtol=0)


@pytest.mark.parametrize("arch", ["internlm2-1.8b", "deepseek-v2-236b"])
def test_pool_save_restore_span_round_trip(arch):
    """Snapshot, clobber, restore: every leaf of the config's cache (GQA
    k/v; MLA ckv/kr) comes back bit for bit, block by block."""
    pool = PagedCachePool(t_reduced(t_get_config(arch)), n_slots=1,
                          n_blocks=4, block_size=4, max_len=16, device="cpu")
    _fill(pool)
    a = pool.alloc()
    pool.reserve(a, 8)
    pool.ensure_mapped(a, 8)
    saved = pool.save_block_span(a, 0, 8)
    assert len(saved) == 2
    assert {(k, n) for k, v in saved[0].items() for n in v} == {
        (k, n) for k, v in pool.cache.items() for n in v}
    blks = [int(pool.tables[a, m]) for m in range(2)]
    for leaves in pool.cache.values():
        for leaf in leaves.values():
            leaf[:, blks] = 0
    pool.restore_block_span(a, 0, 8, saved)
    _assert_snapshots_equal(saved, pool.save_block_span(a, 0, 8))
    assert pool.save_block_span(a, 8, 8) == []


def test_pool_swap_tier_round_trip(tiny_cfgs):
    """Cold registered prefix blocks spill to host RAM on eviction and
    come back bit-identical on the next same-prefix share; the pool's
    books follow JAX's pool step for step."""
    jpool, pool = _pools(tiny_cfgs, n_slots=2, n_blocks=4, block_size=4,
                         max_len=16, swap_blocks=4)
    _fill(pool)
    toks = np.arange(8, dtype=np.int32)
    for p in (jpool, pool):
        a = p.alloc()
        p.reserve(a, 8)
        p.ensure_mapped(a, 8)
        p.register_prefix(a, toks)
        if p is pool:
            before = p.save_block_span(a, 0, 8)
        p.release(a)                    # zero-ref registered -> cached
        p.check_invariants()
        b = p.alloc()                   # evict the cached blocks: they
        p.reserve(b, 16)                # swap out instead of vanishing
        p.ensure_mapped(b, 16)
        assert p.swap_outs == 2 and p.n_swapped_blocks == 2
        p.check_invariants()
        if p is pool:                   # the new owner overwrites them
            for leaves in p.cache.values():
                for leaf in leaves.values():
                    leaf[:, 1:] = -1
        p.release(b)
        c = p.alloc()
        p.reserve(c, 8)
        assert p.share_prefix(c, toks) == 8
        assert p.swap_ins == 2 and p.n_swapped_blocks == 0
        p.check_invariants()
    _same_books(jpool, pool)
    _assert_snapshots_equal(before, pool.save_block_span(c, 0, 8))


# ---------------------------------------------------------------------------
# Property suites: pool churn + scheduling exactly-once
# ---------------------------------------------------------------------------

@settings(max_examples=25, deadline=None)
@given(st.lists(st.tuples(st.integers(0, 3), st.integers(1, 32)),
                min_size=1, max_size=50))
def test_pool_churn_invariants(ops):
    """Random alloc/reserve/grow/register/release churn on a small
    oversubscribed pool with a swap tier, on the port's pool and JAX's in
    lockstep: the invariants hold after every operation, BlockPressure
    strikes both at the same step and corrupts neither, release stays
    loud, and the books (tables, refcounts, swaps) stay equal."""
    cfgs = (reduced(get_config("internlm2-1.8b")),
            t_reduced(t_get_config("internlm2-1.8b")))
    jpool, pool = _pools(cfgs, n_slots=3, n_blocks=6, block_size=4,
                         max_len=32, oversubscribe=2.0, swap_blocks=4)
    live = {}                           # slot -> (gen, reserved_tokens, base)
    for op, arg in ops:
        if op == 0 and pool.n_free > 0:          # admit
            n_tok = 4 * (arg % 8) + 4            # 4..32
            assert pool.can_reserve(n_tok) == jpool.can_reserve(n_tok)
            if pool.can_reserve(n_tok):
                s = pool.alloc()
                assert jpool.alloc() == s
                pool.reserve(s, n_tok)
                jpool.reserve(s, n_tok)
                live[s] = (pool.generations[s], n_tok, arg)
        elif op == 1 and live:                   # grow mapping
            s = sorted(live)[arg % len(live)]
            hit = []
            for p, exc in ((pool, BlockPressure), (jpool, JBlockPressure)):
                try:
                    p.ensure_mapped(s, min(arg, live[s][1]))
                    hit.append(False)
                except exc:
                    hit.append(True)             # books stay sound
            assert hit[0] == hit[1]
        elif op == 2 and live:                   # release (loud)
            s = sorted(live)[arg % len(live)]
            gen, _, _ = live.pop(s)
            for p in (pool, jpool):
                p.release(s, expected_generation=gen)
                with pytest.raises(RuntimeError):
                    p.release(s)
        elif op == 3 and live:                   # register + release
            s = sorted(live)[arg % len(live)]
            gen, n_tok, base = live.pop(s)
            n_map = int(pool.n_mapped[s]) * 4
            for p in (pool, jpool):
                if n_map:
                    p.register_prefix(
                        s, (np.arange(n_map, dtype=np.int32) + base))
                p.release(s, expected_generation=gen)
        pool.check_invariants()
        _same_books(jpool, pool)
    for s in list(live):
        gen = live.pop(s)[0]
        pool.release(s, expected_generation=gen)
        jpool.release(s, expected_generation=gen)
    pool.check_invariants()
    _same_books(jpool, pool)
    # full drain: every non-trash block is free again
    assert pool.n_physical_in_use == 0


class _NullPool:
    """The slot surface the scheduler uses, with no device cache."""

    def __init__(self, n_slots):
        self.n_slots = n_slots
        self._free = sorted(range(n_slots), reverse=True)
        self._in_use = set()
        self.generations = [0] * n_slots

    n_free = property(lambda self: len(self._free))
    in_use = property(lambda self: frozenset(self._in_use))

    def alloc(self):
        slot = self._free.pop()
        self._in_use.add(slot)
        self.generations[slot] += 1
        return slot

    def release(self, slot, expected_generation=None):
        assert slot in self._in_use
        assert expected_generation == self.generations[slot]
        self._in_use.remove(slot)
        self._free.append(slot)
        self._free.sort(reverse=True)


@settings(max_examples=40, deadline=None)
@given(st.lists(st.integers(0, 2), min_size=1, max_size=60),
       st.integers(2, 10))
def test_scheduler_queue_exactly_once(ops, n):
    """Random admit/preempt/complete churn through the port's
    SlotScheduler + ArrivalQueue, with JAX's driven in lockstep: every
    request completes exactly once, preempted requests re-enter with age
    priority, no fresh arrival overtakes a preempted one, and every
    admission and completion matches JAX's."""
    sides = []
    for sched_cls, queue_cls, req_cls in (
            (SlotScheduler, ArrivalQueue, Request),
            (JSlotScheduler, JArrivalQueue, JRequest)):
        reqs = [req_cls(rid=i, prompt=np.arange(4, dtype=np.int32),
                        max_new=4, arrival_time=float(i)) for i in range(n)]
        sides.append((sched_cls(_NullPool(2)), queue_cls(list(reqs)), []))
    clock = float(n)
    for op in ops:
        clock += 1.0
        trace = []
        for sched, queue, completed in sides:
            got = []
            if op == 0:
                for slot, req in sched.admit_ready(queue, clock):
                    # age priority: nothing ready is older than an admit
                    head = queue.peek_ready()
                    assert head is None or (head.arrival_time, head.rid) \
                        >= (req.arrival_time, req.rid)
                    got.append((slot, req.rid))
            elif op == 1 and sched.running:
                slot = max(sched.running,
                           key=lambda s: sched.running[s].admit_seq)
                queue.requeue(sched.preempt(slot, clock))
                got.append(slot)
            elif op == 2 and sched.running:
                slot = min(sched.running)
                completed.append(sched.retire(slot, clock, deferred=False))
                got.append(completed[-1].rid)
            sched.check_invariants()
            trace.append(got)
        assert trace[0] == trace[1]
    sched, queue, completed = sides[0]
    while len(completed) < n:          # drain
        clock += 1.0
        sched.admit_ready(queue, clock)
        slot = min(sched.running)
        completed.append(sched.retire(slot, clock, deferred=False))
    assert sorted(r.rid for r in completed) == list(range(n))
    assert all(r.state == DONE for r in completed)
    assert len(queue) == 0 and not sched.running


# ---------------------------------------------------------------------------
# The port's own: MLA caches under preemption, the CLI's validations
# ---------------------------------------------------------------------------

def test_mla_preempt_matches_unconstrained(tmp_path):
    """Reduced DeepSeek-V2 (MLA + MoE) under the preempt policy with a
    swap tier: the snapshots and swapped blocks carry the latent and
    rope leaves, so every request completes with the unconstrained run's
    tokens and confidences."""
    from repro_torch.launch import serve
    small, large = serve.build_ladder("deepseek-v2-236b", 0, 2,
                                      reduce=True, device="cpu")
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, small.cfg.vocab_size, n).astype(np.int32)
               for n in rng.integers(6, 21, size=8)]
    out = {}
    for name, n_blocks, pressure in (
            ("free", GENEROUS, None),
            ("tight", TIGHT, PressureConfig(oversubscribe=4.0,
                                            policy="preempt",
                                            max_preemptions=50,
                                            swap_blocks=8))):
        eng = ContinuousCascadeEngine(
            CascadeSpec.two_tier(small, large, tau=-1e9),
            EngineConfig(n_slots=SLOTS, early_exit=False, steps_per_sync=4,
                         backend="paged",
                         paged=PagedConfig(block_size=BS, n_blocks=n_blocks,
                                           prefill_chunk=4,
                                           pressure=pressure)))
        out[name] = eng.run(make_requests(prompts, MAX_NEW), MAX_NEW,
                            audit_path=str(tmp_path / f"{name}.jsonl"))
        eng.pool.check_invariants()
    with open(tmp_path / "tight.jsonl") as f:
        restored = [e["restored_blocks"] for e in map(json.loads, f)
                    if e["event"] == "resume"]
    assert out["tight"].stats["n_preemptions"] > 0 and sum(restored) > 0
    assert all(r.state == DONE for r in out["tight"].requests)
    np.testing.assert_array_equal(out["tight"].tokens, out["free"].tokens)
    np.testing.assert_array_equal(out["tight"].confidence,
                                  out["free"].confidence)


@pytest.mark.parametrize("argv,msg", [
    (["--backend", "paged", "--blocks", "8", "--oversubscribe", "0.5"],
     "--oversubscribe must be >= 1.0"),
    (["--backend", "paged", "--pressure-policy", "shed"],
     "--pressure-policy needs --oversubscribe > 1.0"),
    (["--backend", "paged", "--max-preemptions", "3"],
     "--max-preemptions needs --oversubscribe > 1.0"),
    (["--backend", "paged", "--blocks", "8", "--oversubscribe", "2",
      "--pressure-policy", "defer", "--max-preemptions", "3"],
     "--max-preemptions needs --pressure-policy preempt"),
    (["--backend", "paged", "--oversubscribe", "2"],
     "--oversubscribe > 1.0 needs an explicit --blocks"),
    (["--swap-blocks", "4"], "--swap-blocks needs --backend paged"),
    (["--oversubscribe", "2"], "--oversubscribe needs --backend paged"),
    (["--max-queue", "-1"], "--max-queue must be >= 0"),
    (["--deadline-ms", "-5"], "--deadline-ms must be >= 0"),
], ids=["oversubscribe-below-1", "policy-without-oversubscribe",
        "bound-without-oversubscribe", "bound-without-preempt",
        "oversubscribe-without-blocks", "swap-on-slot-backend",
        "oversubscribe-on-slot-backend", "negative-queue",
        "negative-deadline"])
def test_cli_validates_pressure_and_overload_flags(argv, msg, capsys):
    from repro_torch.launch import serve
    with pytest.raises(SystemExit) as exc:
        serve.main(["--device", "cpu"] + argv)
    assert exc.value.code == 2
    assert msg in capsys.readouterr().err


def test_cli_serves_under_pressure_and_overload(capsys):
    """The six flags reach the engine: an oversubscribed preempt run with
    a swap tier completes every request and reports its counts, and a
    bounded queue sheds the newest arrivals."""
    from repro_torch.launch import serve
    base = ["--device", "cpu", "--requests", "8", "--max-new", "6",
            "--backend", "paged", "--ragged-min", "6", "--ragged-max", "20",
            "--block-size", "4", "--prefill-chunk", "4"]
    res = serve.main(base + ["--blocks", "12", "--oversubscribe", "4",
                             "--pressure-policy", "preempt",
                             "--max-preemptions", "50", "--swap-blocks",
                             "8"])
    st_ = res.stats
    assert all(r.state == DONE for r in res.requests)
    assert st_["n_preemptions"] > 0 and st_["oversubscribe"] == 4.0
    assert st_["swap_blocks"] == 8
    assert "pressure/overload: preemptions=" in capsys.readouterr().out
    res = serve.main(base + ["--max-queue", "3", "--deadline-ms", "60000"])
    assert res.stats["n_rejected"] == 5 and res.stats["n_completed"] == 3
