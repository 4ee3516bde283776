"""Port paged pool and continuous engine on the CPU: the mirrors of the
JAX package's pool tests (tests/test_serving_paged.py,
tests/test_serving_prefix.py) and engine tests
(tests/test_serving_continuous.py, tests/test_serving_paged.py) that the
port lacked. Pool tests run the same operations on the port's pool and
JAX's and hold the books (tables, refcounts, free counts) equal besides
JAX's own assertions; engine tests hold the port's tokens against JAX's
engine or JAX's standalone generation on the same weights (JAX's init
carried over by `convert.py`)."""
import json
import math

import numpy as np
import pytest

import jax
import torch

from _hypothesis_shim import given, settings, st
from repro.configs import get_config, reduced
from repro.data.synthetic import make_lm_stream
from repro.models import transformer as jtfm
from repro.serving import CascadeSpec as JCascadeSpec
from repro.serving import ContinuousCascadeEngine as JEngine
from repro.serving import EngineConfig as JEngineConfig
from repro.serving import PagedCachePool as JPagedCachePool
from repro.serving import engine as jeng
from repro.serving import make_requests as j_make_requests
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs import reduced as t_reduced
from repro_torch.convert import params_from_jax
from repro_torch.serving import (CascadeEngine, CascadeSpec,
                                 ContinuousCascadeEngine, EngineConfig,
                                 ModelRunner, PagedCachePool, PagedConfig,
                                 SlotCachePool, make_requests,
                                 poisson_arrivals)
from repro_torch.serving.request import DONE

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def runners():
    """(JAX pair, port pair, uniform prompts [16, 8]): the fixture of
    tests/test_serving_continuous.py and tests/test_serving_paged.py."""
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
    prompts = make_lm_stream(jax.random.fold_in(key, 2), 16, 8,
                             s_cfg.vocab_size)
    return jax_pair, torch_pair, prompts


@pytest.fixture(scope="module")
def tiny_cfgs():
    return (reduced(get_config("internlm2-1.8b")),
            t_reduced(t_get_config("internlm2-1.8b")))


def ragged_prompts(key, lens, vocab):
    base = make_lm_stream(key, len(lens), max(lens), vocab)
    return [base[i, :n].astype(np.int32) for i, n in enumerate(lens)]


def _engine(pair, tau=-1e9, **kw):
    paged = {k: kw.pop(k) for k in list(kw) if k in (
        "block_size", "n_blocks", "prefill_chunk")}
    return ContinuousCascadeEngine(
        CascadeSpec.two_tier(pair[0], pair[1], tau=tau),
        EngineConfig(paged=PagedConfig(**paged), **kw))


def _pools(cfgs, **kw):
    jcfg, tcfg = cfgs
    return (JPagedCachePool(jcfg, **kw),
            PagedCachePool(tcfg, device="cpu", **kw))


def _same_books(jpool, tpool):
    np.testing.assert_array_equal(tpool.tables, jpool.tables)
    np.testing.assert_array_equal(tpool.ref, jpool.ref)
    np.testing.assert_array_equal(tpool.n_mapped, jpool.n_mapped)
    assert tpool.n_free_blocks == jpool.n_free_blocks
    assert tpool._reserved_total == jpool._reserved_total


# ---------------------------------------------------------------------------
# Pool: alloc/free, reservation, free-list order, over-map, churn
# ---------------------------------------------------------------------------

def test_paged_pool_alloc_free_invariants(tiny_cfgs):
    jpool, tpool = _pools(tiny_cfgs, n_slots=3, n_blocks=8, block_size=4,
                          max_len=20)
    for pool in (jpool, tpool):
        pool.check_invariants()
        assert pool.blocks_for(1) == 1 and pool.blocks_for(4) == 1
        assert pool.blocks_for(5) == 2 and pool.blocks_for(0) == 0

        # admit two requests: reserve worst case, map prompts lazily
        a = pool.alloc()
        pool.reserve(a, 11)                    # 3 blocks owed
        pool.ensure_mapped(a, 6)               # 2 mapped, 1 still owed
        b = pool.alloc()
        pool.reserve(b, 8)                     # 2 blocks owed
        pool.check_invariants()
        assert pool.n_mapped[a] == 2 and pool.n_mapped[b] == 0
        assert pool.n_free_blocks == 6
        # trash block 0 never handed out; mapped ids unique and nonzero
        assert (pool.tables[a, :2] > 0).all()

        # remaining capacity: 6 free - 3 outstanding reserved = 3 blocks
        assert pool.can_reserve(12) and not pool.can_reserve(13)

        # mapping inside the reservation can never fail
        pool.ensure_mapped(a, 11)
        pool.ensure_mapped(b, 8)
        pool.check_invariants()
        assert pool.n_mapped[a] == 3 and pool.n_mapped[b] == 2

        # release returns blocks AND zeroes the table row
        pool.release(a)
        assert (pool.tables[a] == 0).all()
        assert pool.n_free_blocks == 6
        pool.check_invariants()

        # slot ids recycle lowest-first with generation counters
        c = pool.alloc()
        assert c == a and pool.generations[a] == 2
        with pytest.raises(RuntimeError):
            pool.release(2)                    # slot that is not in use
        pool.release(b)
        pool.release(c)
        pool.check_invariants()
        assert pool.n_free == 3 and pool.n_free_blocks == 8
    _same_books(jpool, tpool)


def test_overmap_beyond_reservation_raises(tiny_cfgs):
    """ensure_mapped beyond a slot's own reservation must raise when the
    over-map would break free >= reserved, and leave the victim's
    reservation servable; with real headroom it is allowed."""
    for n_blocks in (4, 6):
        jpool, tpool = _pools(tiny_cfgs, n_slots=2, n_blocks=n_blocks,
                              block_size=4, max_len=16)
        for pool in (jpool, tpool):
            a = pool.alloc()
            pool.reserve(a, 8)
            pool.ensure_mapped(a, 8)              # A's reservation mapped
            b = pool.alloc()
            pool.reserve(b, 8)
            if n_blocks == 4:                     # free=2 == reserved=2
                with pytest.raises(RuntimeError,
                                   match="beyond its reservation"):
                    pool.ensure_mapped(a, 12)
            else:                                 # 3 free > 2 reserved
                pool.ensure_mapped(a, 12)
            pool.check_invariants()
            pool.ensure_mapped(b, 8)              # the victim maps fine
            pool.check_invariants()
        _same_books(jpool, tpool)


def test_free_lists_stay_lowest_id_first(tiny_cfgs):
    """Lowest-id-first allocation across out-of-order releases, and
    unregistered blocks evicted before cached prefixes."""
    jpool, tpool = _pools(tiny_cfgs, n_slots=3, n_blocks=9, block_size=4,
                          max_len=12)
    for pool in (jpool, tpool):
        slots = [pool.alloc() for _ in range(3)]
        assert slots == [0, 1, 2]
        for s in slots:
            pool.reserve(s, 11)
            pool.ensure_mapped(s, 11)             # 3 blocks each, in order
        assert pool.tables[0, :3].tolist() == [1, 2, 3]
        pool.release(slots[2])
        pool.release(slots[0])
        assert pool.alloc() == 0
        pool.reserve(0, 11)
        pool.ensure_mapped(0, 11)
        assert pool.tables[0, :3].tolist() == [1, 2, 3]
        pool.check_invariants()

        toks = np.arange(8, dtype=np.int32)
        pool.release(0)
        pool.release(1)
        s = pool.alloc()
        pool.reserve(s, 8)
        pool.ensure_mapped(s, 8)                  # blocks 1, 2
        pool.register_prefix(s, toks)
        pool.release(s)                           # 1, 2 cached; rest plain
        t = pool.alloc()
        pool.reserve(t, 12)
        pool.ensure_mapped(t, 12)
        assert pool.tables[t, :3].tolist() == [3, 4, 5]   # skipped 1, 2
        s2 = pool.alloc()
        pool.reserve(s2, 8)
        assert pool.share_prefix(s2, toks) == 8           # cache intact
        assert pool.tables[s2, :2].tolist() == [1, 2]
        pool.check_invariants()
    _same_books(jpool, tpool)


@given(st.lists(st.tuples(st.integers(0, 4),     # op
                          st.integers(0, 5),     # slot / prompt selector
                          st.integers(1, 24)),   # length / position
                min_size=1, max_size=60),
       st.integers(0, 3))
@settings(max_examples=25, deadline=None)
def test_refcount_invariants_under_churn(ops, pick):
    """Random admit/share/map/write/release churn on the port's pool and
    JAX's in lockstep: refcount conservation, registry consistency and
    reservation bounds hold after every operation (the port's pool
    checks them), and the two pools' books stay equal."""
    cfgs = (reduced(get_config("internlm2-1.8b")),
            t_reduced(t_get_config("internlm2-1.8b")))
    jpool, pool = _pools(cfgs, n_slots=4, n_blocks=14, block_size=4,
                         max_len=28)
    base = np.arange(64, dtype=np.int32)
    prompts = [base[:16],
               base[:16].copy(),
               np.concatenate([base[:12], base[40:44]]).astype(np.int32),
               np.concatenate([base[:8], base[48:56]]).astype(np.int32)]
    live = {}                                  # slot -> (prompt, total, start)
    for op, sel, ln in ops:
        if op == 0 and pool.n_free:            # admit
            prompt = prompts[(sel + pick) % len(prompts)]
            total = prompt.shape[0] + (ln % 8)
            assert pool.can_reserve(total) == jpool.can_reserve(total)
            if not pool.can_reserve(total):
                continue
            slot = pool.alloc()
            assert jpool.alloc() == slot
            shares = []
            for p in (pool, jpool):
                p.reserve(slot, total)
                shares.append(p.share_prefix(slot, prompt))
                p.ensure_mapped(slot, prompt.shape[0])
            shared = shares[0]
            assert shared == shares[1]
            assert shared % pool.block_size == 0
            assert shared <= prompt.shape[0]
            live[slot] = (prompt, total, min(shared, prompt.shape[0] - 1))
        elif op == 1 and live:                 # map further (decode)
            slot = sorted(live)[sel % len(live)]
            prompt, total, _ = live[slot]
            for p in (pool, jpool):
                p.ensure_mapped(slot, min(prompt.shape[0] + ln, total))
        elif op == 2 and live:                 # write at/after the frontier
            slot = sorted(live)[sel % len(live)]
            prompt, total, start = live[slot]
            lo = start + ln % max(total - start, 1)
            assert pool.ensure_writable(slot, lo, min(lo + 4, total)) == \
                jpool.ensure_writable(slot, lo, min(lo + 4, total))
        elif op == 3 and live:                 # publish prefix
            slot = sorted(live)[sel % len(live)]
            for p in (pool, jpool):
                p.register_prefix(slot, live[slot][0])
        elif op == 4 and live:                 # retire
            slot = sorted(live)[sel % len(live)]
            for p in (pool, jpool):
                p.release(slot)
            del live[slot]
        pool.check_invariants()
        # every live slot must still be able to map its full reservation
        assert pool.n_free_blocks >= pool._reserved_total
        _same_books(jpool, pool)
    for slot in sorted(live):
        pool.release(slot)
        jpool.release(slot)
        pool.check_invariants()
    assert pool.n_free_blocks == pool.n_blocks
    assert pool.cow_clones == jpool.cow_clones


# ---------------------------------------------------------------------------
# Engine
# ---------------------------------------------------------------------------

def test_parity_with_multi_step_scheduling(runners):
    """steps_per_sync > 1 must not change greedy outputs (finished slots
    self-deactivate on the device): the port equals its static cascade
    and JAX's continuous engine at the same setting."""
    jax_pair, pair, prompts = runners
    static = CascadeEngine(*pair)
    tau = static.calibrate(prompts, 8, 4, deferral_ratio=0.5)
    sres = static.serve(prompts, 8, 4)
    cres = _engine(pair, tau, n_slots=4, early_exit=False,
                   steps_per_sync=3).run(make_requests(prompts, 4), 4)
    np.testing.assert_array_equal(cres.tokens, sres.tokens)
    np.testing.assert_array_equal(cres.deferred, sres.deferred)
    jres = JEngine(JCascadeSpec.two_tier(*jax_pair, tau=tau),
                   JEngineConfig(n_slots=4, early_exit=False,
                                 steps_per_sync=3)).run(
        j_make_requests(prompts, 4), 4)
    np.testing.assert_array_equal(cres.tokens, jres.tokens)
    np.testing.assert_array_equal(cres.deferred, jres.deferred)
    assert cres.steps == jres.steps


@pytest.mark.parametrize("backend", ["slot", "paged"])
def test_max_new_one(runners, backend):
    """Degenerate budget: the prefill token is the whole generation."""
    jax_pair, pair, prompts = runners
    kw = dict(block_size=4) if backend == "paged" else {}
    res = _engine(pair, n_slots=8, early_exit=True, backend=backend,
                  **kw).run(make_requests(prompts, 1), 1)
    j_tokens, _ = jax_pair[0].generate(prompts, 8, 1)
    np.testing.assert_array_equal(res.tokens, j_tokens)
    assert not res.deferred.any()
    assert all(r.state == DONE for r in res.requests)


def test_heterogeneous_max_new_clamped(runners):
    """A request whose max_new exceeds the run budget must still retire
    (clamped); a smaller one stops early on the device."""
    jax_pair, pair, prompts = runners
    reqs = make_requests(prompts[:4], 4)
    reqs[0].max_new = 99                    # larger than the run's budget
    reqs[1].max_new = 2                     # smaller: early device stop
    res = _engine(pair, n_slots=4, early_exit=False).run(reqs, 4)
    assert all(r.state == DONE for r in res.requests)
    assert res.requests[0].n_small_steps == 4
    assert res.requests[1].n_small_steps == 2
    j_tokens, _ = jax_pair[0].generate(prompts[:4], 8, 4)
    np.testing.assert_array_equal(res.requests[0].tokens, j_tokens[0])
    np.testing.assert_array_equal(res.requests[1].small_tokens,
                                  j_tokens[1, :2])


def test_chunked_prefill_does_not_perturb_residents(runners, tmp_path):
    """A long prompt prefilled in chunks while two residents decode leaves
    every request's tokens equal to JAX's standalone generation, and the
    audit log shows the chunked prefill interleaved with decoding."""
    jax_pair, pair, _ = runners
    prompts = ragged_prompts(jax.random.PRNGKey(11), [6, 6, 14],
                             pair[0].cfg.vocab_size)
    reqs = make_requests(prompts, 10)
    reqs[0].max_new = 4          # retires early, freeing a slot for rid 2
    audit = str(tmp_path / "audit.jsonl")
    res = _engine(pair, n_slots=2, early_exit=False, backend="paged",
                  block_size=4, prefill_chunk=3).run(reqs, 10,
                                                     audit_path=audit)
    for r in res.requests:
        t, c = jax_pair[0].generate(r.prompt[None, :], r.prompt_len,
                                    r.max_new)
        np.testing.assert_array_equal(r.tokens[:r.max_new], t[0])
        np.testing.assert_allclose(r.confidence, c[0], rtol=1e-5)
    assert res.stats["prefill_chunks"] >= math.ceil(14 / 3) + 2
    with open(audit) as f:
        kinds = [(e["event"], e.get("rid")) for e in map(json.loads, f)]
    # rid 2 was admitted only after rid 0 retired, and its chunked
    # prefill finished BEFORE resident rid 1 retired -> interleaved
    assert kinds.index(("retire", 0)) < kinds.index(("prefill_done", 2))
    assert kinds.index(("prefill_done", 2)) < kinds.index(("retire", 1))


def test_paged_serves_budget_slot_cannot_fit(runners):
    """A ragged Poisson workload served inside a block budget below the
    slot pool's worst-case footprint, with more requests resident at once
    than a dense pool of the same token budget holds rows for; tokens
    equal JAX's standalone generation."""
    jax_pair, pair, _ = runners
    lens = [4, 4, 4, 4, 4, 4, 4, 4, 10, 4, 4, 4]      # mostly short
    prompts = ragged_prompts(jax.random.PRNGKey(13), lens,
                             pair[0].cfg.vocab_size)
    max_new, bs, n_blocks, n_slots = 4, 4, 12, 6
    max_len = max(lens) + max_new                       # 14
    arrivals = poisson_arrivals(len(prompts), rate=500.0, seed=13)
    res = _engine(pair, n_slots=n_slots, early_exit=False, backend="paged",
                  block_size=bs, n_blocks=n_blocks, prefill_chunk=4).run(
        make_requests(prompts, max_new, arrivals), max_new)
    assert all(r.state == DONE for r in res.requests)
    for r in res.requests:
        t, _ = jax_pair[0].generate(r.prompt[None, :], r.prompt_len, max_new)
        np.testing.assert_array_equal(r.tokens, t[0])
    slot_pool = SlotCachePool(pair[0].cfg, n_slots, max_len, "cpu")
    assert res.stats["cache_bytes"] < slot_pool.footprint_bytes()
    # a dense pool squeezed into the same token budget affords only
    # 48 // 14 = 3 worst-case rows; the paged run sustained more
    assert res.stats["peak_active"] > (n_blocks * bs) // max_len
    assert res.stats["peak_blocks"] <= n_blocks


def test_oversized_request_rejected(runners):
    jax_pair, pair, _ = runners
    prompts = ragged_prompts(jax.random.PRNGKey(17), [16], 64)
    eng = _engine(pair, n_slots=2, backend="paged", block_size=4,
                  n_blocks=2)
    with pytest.raises(ValueError, match="largest request"):
        eng.run(make_requests(prompts, 4), 4)
    jeng_ = JEngine(JCascadeSpec.two_tier(*jax_pair, tau=-1e9),
                    JEngineConfig(n_slots=2, backend="paged"))
    jeng_.config.paged.block_size, jeng_.config.paged.n_blocks = 4, 2
    with pytest.raises(ValueError, match="largest request"):
        jeng_.run(j_make_requests(prompts, 4), 4)
