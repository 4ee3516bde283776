"""Port serving stack on the CPU: `ModelRunner.generate`, the static
cascade and the continuous paged engine against the JAX package on the
fixtures of tests/test_serving.py and tests/test_serving_paged.py (JAX
weights carried over by `convert.py`, prompts from the JAX data helpers),
plus the port's own greedy equivalences: slot against paged, shared
against unshared prefix, kernel path against plain path, and
early_exit=False continuous against static."""
import numpy as np
import pytest

import jax
import torch

from repro.configs import get_config, reduced
from repro.data.synthetic import make_lm_stream
from repro.models import transformer as jtfm
from repro.serving import CascadeSpec as JCascadeSpec
from repro.serving import EngineConfig as JEngineConfig
from repro.serving import PagedConfig as JPagedConfig
from repro.serving import engine as jeng
from repro.serving import make_requests as j_make_requests
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs import reduced as t_reduced
from repro_torch.convert import params_from_jax
from repro_torch.data import synthetic as tsyn
from repro_torch.serving import (CascadeEngine, CascadeSpec,
                                 ContinuousCascadeEngine, EngineConfig,
                                 ModelRunner, PagedConfig, make_requests)
from repro_torch.serving.paged_pool import PagedCachePool
from repro_torch.serving.request import DONE

torch.set_num_threads(1)
CONF_ATOL = 1e-5      # mean eq.-8 confidence, fp32 on both sides
LENS = [5, 9, 4, 12, 7, 6, 10, 4]


@pytest.fixture(scope="module")
def runners():
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
    base = make_lm_stream(jax.random.PRNGKey(7), len(LENS), max(LENS),
                          s_cfg.vocab_size)
    ragged = [base[i, :n].astype(np.int32) for i, n in enumerate(LENS)]
    return jax_pair, torch_pair, prompts, ragged


@pytest.fixture(scope="module")
def static_jax(runners):
    (js, jl), _, prompts, _ = runners
    eng = jeng.CascadeEngine(js, jl)
    tau = eng.calibrate(prompts, 8, 4, deferral_ratio=0.5)
    return tau, eng.serve(prompts, 8, 4)


def _engine(pair, tau, **kw):
    paged = {k: kw.pop(k) for k in list(kw) if k in (
        "block_size", "prefill_chunk", "paged_kernel", "prefix_sharing",
        "batch_prefill")}
    return ContinuousCascadeEngine(
        CascadeSpec.two_tier(pair[0], pair[1], tau=tau),
        EngineConfig(paged=PagedConfig(**paged), **kw))


def test_generate_matches_jax(runners):
    (js, _), (ts, _), prompts, _ = runners
    jt, jc = js.generate(prompts, 8, 4)
    tt, tc = ts.generate(prompts, 8, 4)
    np.testing.assert_array_equal(tt, jt)
    np.testing.assert_allclose(tc, jc, atol=CONF_ATOL)
    assert (tc <= 1e-6).all()        # neg entropy <= 0


def test_static_cascade_matches_jax(runners, static_jax):
    _, (ts, tl), prompts, _ = runners
    jtau, jres = static_jax
    eng = CascadeEngine(ts, tl)
    tau = eng.calibrate(prompts, 8, 4, deferral_ratio=0.5)
    res = eng.serve(prompts, 8, 4)
    assert tau == pytest.approx(jtau, abs=CONF_ATOL)
    np.testing.assert_array_equal(res.deferred, jres.deferred)
    np.testing.assert_array_equal(res.tokens, jres.tokens)
    np.testing.assert_allclose(res.confidence, jres.confidence,
                               atol=CONF_ATOL)
    assert res.compute_cost == pytest.approx(jres.compute_cost)


def test_continuous_paged_matches_jax(runners, static_jax):
    """Ragged prompts over the paged backend (block 4, chunk 4) with
    in-flight early exit: per-rid tokens, deferral and early-exit flags
    equal the JAX engine's."""
    jax_pair, torch_pair, _, ragged = runners
    tau = static_jax[0]
    jres = jeng.ContinuousCascadeEngine(
        JCascadeSpec.two_tier(*jax_pair, tau=tau),
        JEngineConfig(n_slots=3, backend="paged", paged=JPagedConfig(
            block_size=4, prefill_chunk=4, paged_kernel=False))).run(
        j_make_requests(ragged, 5), 5)
    # the comparison covers both gate outcomes and in-flight exits
    assert 0 < sum(r.deferred for r in jres.requests) < len(LENS)
    assert any(r.early_exited for r in jres.requests)
    res = _engine(torch_pair, tau, n_slots=3, backend="paged", block_size=4,
                  prefill_chunk=4).run(make_requests(ragged, 5), 5)
    assert all(r.state == DONE for r in res.requests)
    for jr, tr in zip(jres.requests, res.requests):
        assert tr.rid == jr.rid
        np.testing.assert_array_equal(tr.tokens, jr.tokens)
        assert (tr.deferred, tr.early_exited) == (jr.deferred, jr.early_exited)
        np.testing.assert_allclose(tr.confidence, jr.confidence,
                                   atol=CONF_ATOL)
    for k in ("prefill_chunks", "prefill_dispatches", "peak_blocks",
              "shared_tokens", "saved_steps"):
        assert res.stats[k] == jres.stats[k], k


@pytest.mark.parametrize("workload", ["uniform", "ragged"])
def test_slot_and_paged_backends_agree(runners, static_jax, workload):
    _, pair, prompts, ragged = runners
    reqs = prompts if workload == "uniform" else ragged
    tau = static_jax[0]
    slot = _engine(pair, tau, n_slots=3, early_exit=False).run(
        make_requests(reqs, 5), 5)
    paged = _engine(pair, tau, n_slots=3, early_exit=False, backend="paged",
                    block_size=4, prefill_chunk=4).run(
        make_requests(reqs, 5), 5)
    np.testing.assert_array_equal(paged.tokens, slot.tokens)
    np.testing.assert_array_equal(paged.deferred, slot.deferred)
    np.testing.assert_allclose(paged.confidence, slot.confidence, rtol=1e-5)
    assert paged.stats["peak_blocks"] <= paged.stats["n_blocks"]


def test_continuous_without_early_exit_matches_static(runners, static_jax):
    _, pair, prompts, _ = runners
    tau = static_jax[0]
    static = CascadeEngine(*pair, tau=tau).serve(prompts, 8, 4)
    for backend in ("slot", "paged"):
        res = _engine(pair, tau, n_slots=8, early_exit=False,
                      backend=backend, block_size=4).run(
            make_requests(prompts, 4), 4)
        np.testing.assert_array_equal(res.tokens, static.tokens)
        np.testing.assert_array_equal(res.deferred, static.deferred)


def test_kernel_path_matches_plain_path_in_engine(runners):
    """paged_kernel=True (the kernel wrappers; their plain versions on
    CPU tensors) against the gather path, on a ragged Poisson stream;
    both equal standalone generation per request."""
    _, pair, _, ragged = runners
    from repro_torch.serving import poisson_arrivals
    arrivals = poisson_arrivals(len(ragged), rate=300.0, seed=3)
    out = {}
    for kernel in (False, True):
        out[kernel] = _engine(
            pair, -1e9, n_slots=3, early_exit=False, backend="paged",
            block_size=4, prefill_chunk=4, paged_kernel=kernel).run(
            make_requests(ragged, 5, arrivals), 5)
    assert out[True].stats["paged_kernel"]
    assert not out[False].stats["paged_kernel"]
    np.testing.assert_array_equal(out[True].tokens, out[False].tokens)
    np.testing.assert_allclose(out[True].confidence, out[False].confidence,
                               rtol=1e-4)
    for r in out[True].requests:
        t, _ = pair[0].generate(r.prompt[None, :], r.prompt_len, 5)
        np.testing.assert_array_equal(r.tokens, t[0])


def test_prefix_sharing_is_bit_exact(runners):
    """Requests sharing a 12-token prompt prefix: with sharing on, prompt
    blocks are mapped from the registry (and the shared tail cloned on
    write) instead of prefilled, and every token equals the unshared run."""
    _, pair, _, ragged = runners
    rng = np.random.default_rng(5)
    prefix = ragged[3][:12]
    prompts = [np.concatenate([prefix, rng.integers(0, 512, n)]).astype(
        np.int32) for n in (0, 3, 5, 0)]
    arrivals = np.array([0.0, 0.0, 0.0, 0.0])
    out = {}
    for share in (False, True):
        out[share] = _engine(
            pair, -1e9, n_slots=2, early_exit=False, backend="paged",
            block_size=4, prefill_chunk=4, prefix_sharing=share).run(
            make_requests(prompts, 4, arrivals), 4)
    np.testing.assert_array_equal(out[True].tokens, out[False].tokens)
    assert out[True].stats["shared_tokens"] > 0
    assert out[False].stats["shared_tokens"] == 0
    assert out[True].stats["prefill_tokens"] < out[False].stats[
        "prefill_tokens"]


def test_paged_pool_cow_clone_copies_every_layer(runners):
    _, pair, _, _ = runners
    cfg = pair[0].cfg
    pool = PagedCachePool(cfg, n_slots=2, n_blocks=6, block_size=4,
                          max_len=12, device="cpu")
    prompt = np.arange(8, dtype=np.int32)
    a = pool.alloc()
    pool.reserve(a, 11)
    pool.ensure_mapped(a, 8)
    for leaf in pool.cache["dense"].values():
        leaf.normal_()
    pool.register_prefix(a, prompt)
    b = pool.alloc()
    pool.reserve(b, 11)
    assert pool.share_prefix(b, prompt) == 8
    pool.check_invariants()
    with pytest.raises(RuntimeError, match="aliasing"):
        pool.check_write_disjoint([(a, 4, 8), (b, 4, 8)])
    old = int(pool.tables[b, 1])
    assert pool.ensure_writable(b, 7, 8) == 1
    new = int(pool.tables[b, 1])
    assert new != old and pool.cow_clones == 1
    for leaf in pool.cache["dense"].values():
        torch.testing.assert_close(leaf[:, new], leaf[:, old], atol=0, rtol=0)
    pool.check_write_disjoint([(a, 4, 8), (b, 4, 8)])
    pool.check_invariants()
    pool.release(a)
    pool.release(b)
    pool.check_invariants()
    assert (pool.tables == 0).all()


def test_make_lm_stream_matches_jax_helper():
    """Same numpy seed, same stream: the port takes the integer seed the
    JAX helper draws from its key."""
    key = jax.random.PRNGKey(3)
    seed = int(jax.random.randint(key, (), 0, 2**31 - 1))
    np.testing.assert_array_equal(tsyn.make_lm_stream(seed, 4, 9, 512),
                                  make_lm_stream(key, 4, 9, 512))
    ragged = tsyn.make_ragged_lm_stream(seed, 6, 3, 7, 512)
    assert all(3 <= len(r) <= 7 for r in ragged)
    assert all(np.array_equal(a, b) for a, b in zip(
        ragged, tsyn.make_ragged_lm_stream(seed, 6, 3, 7, 512)))
