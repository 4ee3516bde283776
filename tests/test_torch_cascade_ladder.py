"""The port's N-tier cascade ladders on the CPU against the JAX package:
every case of tests/test_cascade_ladder.py, run on the port with JAX's
weights (converted by `convert.params_from_jax`) and JAX's prompts, and
held to JAX's own run of the case: 2-tier spec against the legacy
constructor, 3-tier ladders on both KV backends against JAX's engine and
a sequential reference (tokens, tiers and masks exact, confidences
within 1e-5), per-edge calibration, the online tau controllers' traces
bit for bit, the engine's recalibration stats, the sampling draw
(`core.prng`) against `jax.random`, `ModelRunner.sample` and the
semantic-agreement signal against JAX's, and the serve CLI's new flags
and rejections."""
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config, reduced
from repro.core.calibration import calibrate_edges as j_calibrate_edges
from repro.core.deferral import SemanticAgreementSignal as JSemantic
from repro.core.deferral import SignalObservation as JObservation
from repro.core.recalibration import EdgeRecalibrator as JEdgeRecalibrator
from repro.core.recalibration import RecalibConfig as JRecalibConfig
from repro.core.recalibration import TauController as JTauController
from repro.data.synthetic import make_lm_stream
from repro.models import transformer as jtfm
from repro.serving import CascadeSpec as JCascadeSpec
from repro.serving import CascadeTier as JCascadeTier
from repro.serving import ContinuousCascadeEngine as JEngine
from repro.serving import DeferralEdge as JDeferralEdge
from repro.serving import EngineConfig as JEngineConfig
from repro.serving import PagedConfig as JPagedConfig
from repro.serving import make_requests as j_make_requests
from repro.serving.engine import ModelRunner as JModelRunner
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs import reduced as t_reduced
from repro_torch.convert import params_from_jax
from repro_torch.core import prng
from repro_torch.core.calibration import (calibrate_edges,
                                          expected_compute_cost,
                                          ladder_compute_cost)
from repro_torch.core.deferral import (SERVING_SIGNALS,
                                       SemanticAgreementSignal,
                                       SignalObservation, pairwise_agreement,
                                       resolve_signal)
from repro_torch.core.recalibration import (EdgeRecalibrator, RecalibConfig,
                                            TauController)
from repro_torch.serving import (CascadeSpec, CascadeTier,
                                 ContinuousCascadeEngine, DeferralEdge,
                                 EngineConfig, ModelRunner, PagedConfig,
                                 make_requests)

torch.set_num_threads(1)
PROMPT_LEN, MAX_NEW, N_REQ = 8, 4, 12
CONF_ATOL = 1e-5      # mean eq.-8 confidence, fp32 on both sides
# the gumbel noise: bits and uniforms are exact; each library rounds its
# own fp32 log, and -log(-log(u)) then differs by up to 4 ulp of values
# below 17 (measured 4.8e-7)
GUMBEL_ATOL = 2e-6
NAMES = ("small", "mid", "large")
COSTS = (0.2, 0.5, 1.0)
pytestmark = pytest.mark.filterwarnings("ignore::DeprecationWarning")


@pytest.fixture(scope="module")
def ladder():
    """tests/test_cascade_ladder.py's fixture: three tiny JAX runners
    (small < mid < large), the port's three on their weights, and JAX's
    calibration and live prompt batches."""
    key = jax.random.PRNGKey(0)
    s_cfg = reduced(get_config("internlm2-1.8b"))
    cfgs = [s_cfg, s_cfg.replace(name="mid", n_layers=3),
            s_cfg.replace(name="large", n_layers=3, d_ff=768)]
    params = [jtfm.init_params(cfgs[0], key),
              jtfm.init_params(cfgs[1], jax.random.fold_in(key, 1)),
              jtfm.init_params(cfgs[2], jax.random.fold_in(key, 2))]
    t_cfg = t_reduced(t_get_config("internlm2-1.8b"))
    t_cfgs = [t_cfg, t_cfg.replace(name="mid", n_layers=3),
              t_cfg.replace(name="large", n_layers=3, d_ff=768)]
    jrun = [JModelRunner(c, p) for c, p in zip(cfgs, params)]
    trun = [ModelRunner(c, params_from_jax(jax.device_get(p), "cpu"))
            for c, p in zip(t_cfgs, params)]
    cal = np.asarray(make_lm_stream(jax.random.fold_in(key, 3), N_REQ,
                                    PROMPT_LEN, s_cfg.vocab_size))
    live = np.asarray(make_lm_stream(jax.random.fold_in(key, 4), N_REQ,
                                     PROMPT_LEN, s_cfg.vocab_size))
    return jrun, trun, cal, live


def _three_tier(runners, spec_cls, tier_cls, edge_cls, signals=None):
    signals = signals or ("mean_confidence", "mean_confidence")
    return spec_cls(
        tiers=[tier_cls(n, runner=r, cost=c)
               for n, r, c in zip(NAMES, runners, COSTS)],
        edges=[edge_cls(signal=s) for s in signals])


def _paged_kw(backend):
    return dict(block_size=4, prefill_chunk=4) if backend == "paged" else {}


def assert_same_run(res, ref):
    """Port engine result against JAX's: tokens, tiers and masks exact,
    confidences within CONF_ATOL, the ladder stats equal."""
    np.testing.assert_array_equal(res.tokens, np.asarray(ref.tokens))
    np.testing.assert_array_equal(res.deferred, np.asarray(ref.deferred))
    np.testing.assert_array_equal(res.early_exited,
                                  np.asarray(ref.early_exited))
    assert [r.tier for r in res.requests] == [r.tier for r in ref.requests]
    np.testing.assert_allclose(res.confidence, np.asarray(ref.confidence),
                               atol=CONF_ATOL, rtol=0)
    for k in ("n_tiers", "tier_served", "tier_reach", "compute_cost",
              "edge_deferrals", "edge_signal"):
        assert res.stats[k] == ref.stats[k], k


def _legacy_engine(small, large, **kw):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        return ContinuousCascadeEngine(small, large, **kw)


# ---------------------------------------------------------------------------
# A 2-tier CascadeSpec reproduces the legacy engine bit-exactly, on both KV
# backends, and both match JAX's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", ["slot", "paged"])
def test_two_tier_spec_matches_legacy(ladder, backend):
    jrun, (small, _, large), cal, live = ladder
    kw = _paged_kw(backend)
    legacy = _legacy_engine(small, large, n_slots=4, backend=backend, **kw)
    tau = legacy.calibrate(cal, PROMPT_LEN, MAX_NEW, deferral_ratio=0.4)
    ref = legacy.run(make_requests(live, MAX_NEW), MAX_NEW)

    spec = CascadeSpec.two_tier(small, large, tau=tau)
    cfg = EngineConfig(n_slots=4, backend=backend, paged=PagedConfig(**kw))
    new = ContinuousCascadeEngine(spec, cfg).run(
        make_requests(live, MAX_NEW), MAX_NEW)

    assert np.array_equal(ref.tokens, new.tokens)
    assert np.array_equal(ref.confidence, new.confidence)
    assert np.array_equal(ref.deferred, new.deferred)
    assert np.array_equal(ref.early_exited, new.early_exited)
    assert ref.stats["compute_cost"] == new.stats["compute_cost"]
    assert new.stats["compute_cost"] == expected_compute_cost(
        new.deferral_ratio, 0.2, 1.0)
    assert new.stats["n_tiers"] == 2 and "ml_backends" not in new.stats
    # and JAX's engine at the same tau
    jspec = JCascadeSpec.two_tier(jrun[0], jrun[2], tau=tau)
    jres = JEngine(jspec, JEngineConfig(
        n_slots=4, backend=backend, paged=JPagedConfig(**kw))).run(
        j_make_requests(live, MAX_NEW), MAX_NEW)
    assert_same_run(new, jres)


def test_deprecation_shim_equivalence(ladder):
    _, (small, _, large), _, _ = ladder
    with pytest.warns(DeprecationWarning, match="CascadeSpec"):
        eng = ContinuousCascadeEngine(small, large, n_slots=3, tau=-1.5,
                                      margin=0.1, min_tokens=3,
                                      backend="paged", block_size=4,
                                      large_backend="thread", large_batch=2,
                                      cost_small=0.3)
    assert eng.spec.n_tiers == 2
    assert eng.tau == -1.5 and eng.margin == 0.1 and eng.min_tokens == 3
    assert eng.config.backend == "paged"
    assert eng.config.paged.block_size == 4
    assert eng.config.ml.kind == "thread" and eng.config.ml.large_batch == 2
    assert eng.spec.tiers[0].cost == 0.3
    with pytest.raises(TypeError, match="unknown"):
        _legacy_engine(small, large, not_a_kwarg=1)
    with warnings.catch_warnings():
        warnings.simplefilter("error", DeprecationWarning)
        ContinuousCascadeEngine(CascadeSpec.two_tier(small, large),
                                EngineConfig(n_slots=2))


# ---------------------------------------------------------------------------
# 3-tier ladder against JAX's engine and the sequential reference
# ---------------------------------------------------------------------------

def _sequential_reference(runners, taus, prompts, max_new):
    """Greedy N-tier cascade, one tier at a time over the whole batch
    (tests/test_cascade_ladder.py's): tier i generates for everything that
    reached it; rows with conf < taus[i] move on."""
    n = prompts.shape[0]
    final = np.zeros((n, max_new), np.int64)
    served = np.zeros(n, np.int64)
    reach = np.arange(n)
    for i, r in enumerate(runners):
        tokens, conf = r.generate(prompts[reach], PROMPT_LEN, max_new)
        final[reach] = tokens
        served[reach] = i
        if i == len(runners) - 1:
            break
        reach = reach[conf < taus[i]]
        if reach.size == 0:
            break
    return final, served


@pytest.mark.parametrize("ratios", [(0.5, 0.5), (0.6, 0.8)],
                         ids=["jax-case", "every-tier-served"])
@pytest.mark.parametrize("backend", ["slot", "paged"])
def test_three_tier_matches_jax_and_sequential_reference(ladder, backend,
                                                         ratios):
    jrun, trun, cal, live = ladder
    jspec = _three_tier(jrun, JCascadeSpec, JCascadeTier, JDeferralEdge)
    jtaus = j_calibrate_edges(jspec, cal, max_new=MAX_NEW,
                              deferral_ratio=list(ratios))
    spec = _three_tier(trun, CascadeSpec, CascadeTier, DeferralEdge)
    taus = calibrate_edges(spec, cal, max_new=MAX_NEW,
                           deferral_ratio=list(ratios))
    assert taus == spec.taus and len(taus) == 2
    np.testing.assert_allclose(taus, jtaus, atol=CONF_ATOL, rtol=0)
    # both engines gate on JAX's taus, so the masks compare exactly
    for edge, t in zip(spec.edges, jtaus):
        edge.tau = t
    kw = _paged_kw(backend)
    res = ContinuousCascadeEngine(spec, EngineConfig(
        n_slots=4, early_exit=False, backend=backend,
        paged=PagedConfig(**kw))).run(make_requests(live, MAX_NEW), MAX_NEW)
    jres = JEngine(jspec, JEngineConfig(
        n_slots=4, early_exit=False, backend=backend,
        paged=JPagedConfig(**kw))).run(j_make_requests(live, MAX_NEW),
                                       MAX_NEW)
    assert_same_run(res, jres)

    ref_tokens, ref_served = _sequential_reference(trun, jtaus, live,
                                                   MAX_NEW)
    assert np.array_equal(res.tokens, ref_tokens)
    assert [r.tier for r in res.requests] == ref_served.tolist()
    assert res.stats["n_tiers"] == 3
    assert res.stats["tier_served"] == np.bincount(
        ref_served, minlength=3).tolist()
    reach = res.stats["tier_reach"]
    assert reach[0] == 1.0 and reach[1] >= reach[2]
    assert res.stats["compute_cost"] == ladder_compute_cost(reach, COSTS)
    assert res.stats["ml_backends"] == ["sync", "sync"]
    assert res.stats["edge_tau"] == list(jtaus)
    if ratios == (0.6, 0.8):
        assert all(n > 0 for n in res.stats["tier_served"])


def test_calibrate_edges_sentinels_and_unification(ladder):
    jrun, (small, _, large), cal, _ = ladder
    spec = CascadeSpec.two_tier(small, large)
    tau = calibrate_edges(spec, cal, max_new=MAX_NEW,
                          deferral_ratio=0.4)[0]
    jtau = j_calibrate_edges(JCascadeSpec.two_tier(jrun[0], jrun[2]), cal,
                             max_new=MAX_NEW, deferral_ratio=0.4)[0]
    assert abs(tau - jtau) <= CONF_ATOL
    eng = ContinuousCascadeEngine(CascadeSpec.two_tier(small, large),
                                  EngineConfig(n_slots=4))
    assert eng.calibrate(cal, PROMPT_LEN, MAX_NEW,
                         deferral_ratio=0.4) == tau
    lo = calibrate_edges(CascadeSpec.two_tier(small, large), cal,
                         max_new=MAX_NEW, deferral_ratio=0.0)[0]
    hi = calibrate_edges(CascadeSpec.two_tier(small, large), cal,
                         max_new=MAX_NEW, deferral_ratio=1.0)[0]
    assert lo < tau < hi
    with pytest.raises(ValueError, match="deferral ratios"):
        calibrate_edges(CascadeSpec.two_tier(small, large), cal,
                        max_new=MAX_NEW, deferral_ratio=[0.2, 0.3])
    # a 3-tier engine's calibrate returns the per-edge list
    eng3 = ContinuousCascadeEngine(_three_tier(
        [small, ladder[1][1], large], CascadeSpec, CascadeTier,
        DeferralEdge), EngineConfig(n_slots=4))
    taus = eng3.calibrate(cal, PROMPT_LEN, MAX_NEW, deferral_ratio=0.5)
    assert isinstance(taus, list) and len(taus) == 2


# ---------------------------------------------------------------------------
# Online tau recalibration: the controllers' traces bit for bit
# ---------------------------------------------------------------------------

def _run_pair(stream, tau0, target, cfg_kw=None):
    cfg_kw = cfg_kw or {}
    ctl = TauController(tau0, target, RecalibConfig(**cfg_kw))
    jctl = JTauController(tau0, target, JRecalibConfig(**cfg_kw))
    for c in stream:
        assert ctl.observe(float(c)) == jctl.observe(float(c))
    assert ctl.trace == jctl.trace
    assert (ctl.tau, ctl.n_updates, ctl.correcting, ctl.ewma_ratio) == \
        (jctl.tau, jctl.n_updates, jctl.correcting, jctl.ewma_ratio)
    return ctl


def test_recalibration_converges_under_drift():
    rng = np.random.default_rng(0)
    base = rng.normal(-2.0, 1.0, size=4000)
    tau0 = float(np.quantile(base, 0.2))
    stream = rng.normal(-3.5, 1.0, size=8000)
    ctl = _run_pair(stream, tau0, 0.2, dict(ewma_alpha=0.02, deadband=0.04,
                                            rearm=0.01))
    fresh = rng.normal(-3.5, 1.0, size=4000)
    assert ctl.n_updates > 0
    assert abs(float((fresh < ctl.tau).mean()) - 0.2) < 0.05
    assert ctl.trace[0] == (0, tau0) and len(ctl.trace) > 1


def test_recalibration_stationary_hysteresis():
    rng = np.random.default_rng(1)
    tau0 = -2.0 + 1.0 * -0.8416212335729143
    ctl = _run_pair(rng.normal(-2.0, 1.0, size=6000), tau0, 0.2)
    assert ctl.n_updates == 0 and ctl.tau == tau0


def test_recalibrator_validation_and_summary():
    with pytest.raises(ValueError, match="rearm"):
        RecalibConfig(deadband=0.05, rearm=0.1)
    with pytest.raises(ValueError, match="target_ratio"):
        RecalibConfig(target_ratio=1.5)
    with pytest.raises(ValueError, match="target_ratio"):
        TauController(0.0, 1.5)
    with pytest.raises(ValueError, match="target ratios"):
        EdgeRecalibrator([0.0, 0.0], [0.2])
    rec = EdgeRecalibrator([-1.0, -2.0], 0.2)
    assert rec.tau(0) == -1.0 and rec.tau(1) == -2.0
    s = rec.summary()
    assert s["tau_final"] == [-1.0, -2.0] and s["tau_updates"] == [0, 0]
    # a long drifting two-edge stream: the summaries (downsampled traces
    # included) equal JAX's
    rng = np.random.default_rng(2)
    cfg = dict(warmup=8, deadband=0.05, rearm=0.01, ewma_alpha=0.05,
               tau_min=-4.0)
    rec = EdgeRecalibrator([-2.5, -1.0], [0.3, 0.5], RecalibConfig(**cfg))
    jrec = JEdgeRecalibrator([-2.5, -1.0], [0.3, 0.5],
                             JRecalibConfig(**cfg))
    for i, c in enumerate(rng.normal(-3.0, 0.7, size=3000)):
        e = i % 2
        assert rec.observe(e, float(c)) == jrec.observe(e, float(c))
    assert rec.summary() == jrec.summary()
    assert len(rec.controllers[0].trace) > 64


def test_engine_recalibration_stats(ladder, tmp_path):
    """The engine's recalibration against JAX's on the same requests:
    the same decisions, and the stats' taus and traces within the
    confidences' tolerance; the live tau is the controller's, and a host
    replay over the audit log's `recalibrate` events gives its summary
    exactly."""
    import json
    jrun, (small, _, large), cal, live = ladder
    jspec = JCascadeSpec.two_tier(jrun[0], jrun[2])
    j_calibrate_edges(jspec, cal, max_new=MAX_NEW, deferral_ratio=0.4)
    spec = CascadeSpec.two_tier(small, large, tau=jspec.edges[0].tau)
    cfg = EngineConfig(n_slots=4,
                       recalibration=RecalibConfig(warmup=4, deadband=0.1),
                       recalib_target=0.4)
    audit = tmp_path / "audit.jsonl"
    res = ContinuousCascadeEngine(spec, cfg).run(
        make_requests(live, MAX_NEW), MAX_NEW, audit_path=str(audit))
    jres = JEngine(jspec, JEngineConfig(
        n_slots=4, recalibration=JRecalibConfig(warmup=4, deadband=0.1),
        recalib_target=0.4)).run(j_make_requests(live, MAX_NEW), MAX_NEW)
    assert_same_run(res, jres)
    rc, jrc = res.stats["recalibration"], jres.stats["recalibration"]
    assert set(rc) == {"tau_final", "tau_updates", "ewma_ratio",
                       "tau_trace"}
    assert len(rc["tau_final"]) == 1
    assert res.stats["edge_tau"] == rc["tau_final"]
    assert rc["tau_updates"] == jrc["tau_updates"]
    assert rc["ewma_ratio"] == jrc["ewma_ratio"]
    np.testing.assert_allclose(rc["tau_final"], jrc["tau_final"],
                               atol=CONF_ATOL, rtol=0)
    assert len(rc["tau_trace"][0]) == len(jrc["tau_trace"][0])
    events = [json.loads(line) for line in audit.read_text().splitlines()]
    obs = [e for e in events if e["event"] == "recalibrate"]
    assert len(obs) == N_REQ
    assert sorted(e["confidence"] for e in obs) == sorted(
        r.confidence for r in res.requests)
    replay = EdgeRecalibrator([jspec.edges[0].tau], 0.4,
                              RecalibConfig(warmup=4, deadband=0.1))
    for e in obs:
        assert replay.observe(e["edge"], e["confidence"]) == e["tau"]
    assert replay.summary() == rc


# ---------------------------------------------------------------------------
# The sampling draw against jax.random
# ---------------------------------------------------------------------------

SEEDS = (0, 1, 7, 123456789, 2 ** 31, 2 ** 31 + 12345, 2 ** 32 - 1)


@pytest.mark.parametrize("seed", SEEDS)
def test_prng_key_and_fold_in_match_jax(seed):
    key = jax.random.PRNGKey(jnp.uint32(seed))
    tkey = prng.prng_key(seed)
    assert tkey == tuple(int(v) for v in np.asarray(key))
    for d in (0, 1, 2, 31, 2 ** 31 + 5):
        got = prng.fold_in(tkey, d)
        want = jax.random.fold_in(key, jnp.uint32(d))
        assert got == tuple(int(v) for v in np.asarray(want))
    assert prng.prng_key(2 ** 40 + 3) == (2 ** 8, 3)
    with pytest.raises(ValueError, match="seed"):
        prng.prng_key(-1)


@pytest.mark.parametrize("shape", [(4, 511), (3, 7), (1, 1), (5,),
                                   (2, 3, 97)], ids=str)
@pytest.mark.parametrize("seed", SEEDS)
def test_prng_bits_uniform_gumbel_match_jax(seed, shape):
    key = jax.random.PRNGKey(jnp.uint32(seed))
    tkey = prng.prng_key(seed)
    for step in (0, 3):
        jk, tk = jax.random.fold_in(key, step), prng.fold_in(tkey, step)
        bits = np.asarray(jax.random.bits(jk, shape, jnp.uint32))
        np.testing.assert_array_equal(prng.random_bits(tk, shape).numpy(),
                                      bits)
        np.testing.assert_array_equal(prng.random_bits_np(tk, shape), bits)
        u = np.asarray(jax.random.uniform(
            jk, shape, jnp.float32, minval=np.finfo(np.float32).tiny,
            maxval=1.0))
        np.testing.assert_array_equal(prng.uniform(tk, shape).numpy(), u)
        np.testing.assert_array_equal(prng.uniform_np(tk, shape), u)
        g = np.asarray(jax.random.gumbel(jk, shape, jnp.float32))
        np.testing.assert_allclose(prng.gumbel(tk, shape).numpy(), g,
                                   atol=GUMBEL_ATOL, rtol=0)
        np.testing.assert_allclose(prng.gumbel_np(tk, shape), g,
                                   atol=GUMBEL_ATOL, rtol=0)


@pytest.mark.parametrize("vocab", [2, 97, 512, 1021])
@pytest.mark.parametrize("seed", SEEDS)
def test_prng_categorical_matches_jax(seed, vocab):
    key = jax.random.PRNGKey(jnp.uint32(seed))
    tkey = prng.prng_key(seed)
    logits = (np.random.default_rng(seed % 997 + vocab).normal(
        size=(6, vocab)) * 3).astype(np.float32)
    for step in (0, 1, 9):
        want = np.asarray(jax.random.categorical(
            jax.random.fold_in(key, step), jnp.asarray(logits), axis=-1))
        tk = prng.fold_in(tkey, step)
        np.testing.assert_array_equal(
            prng.categorical(tk, torch.from_numpy(logits)).numpy(), want)
        np.testing.assert_array_equal(prng.categorical_np(tk, logits), want)


# ---------------------------------------------------------------------------
# Deferral signals, sample
# ---------------------------------------------------------------------------

def test_pairwise_agreement_values():
    same = np.tile(np.arange(5), (3, 1))
    assert pairwise_agreement(same) == 1.0
    disjoint = np.stack([np.zeros(4), np.ones(4)])
    assert pairwise_agreement(disjoint) == 0.0
    m = np.array([[1, 2], [1, 2], [1, 9]])
    assert pairwise_agreement(m) == pytest.approx(2.0 / 3.0)
    assert pairwise_agreement(np.zeros((1, 3))) == 1.0


@pytest.mark.parametrize("seed", [7, 2 ** 31 + 3])
def test_runner_sample_matches_jax(ladder, seed):
    jrun, trun, cal, _ = ladder
    prompts = cal[:3]
    for jr, tr, temp in ((jrun[0], trun[0], 0.8), (jrun[2], trun[2], 1.3)):
        a = tr.sample(prompts, PROMPT_LEN, MAX_NEW + 2, seed=seed,
                      temperature=temp)
        assert a.shape == (3, MAX_NEW + 2) and a.dtype == np.int32
        want = np.asarray(jr.sample(prompts, PROMPT_LEN, MAX_NEW + 2,
                                    seed=seed, temperature=temp))
        np.testing.assert_array_equal(a, want)
    small = trun[0]
    a = small.sample(prompts, PROMPT_LEN, MAX_NEW, seed=seed,
                     temperature=0.8)
    b = small.sample(prompts, PROMPT_LEN, MAX_NEW, seed=seed,
                     temperature=0.8)
    c = small.sample(prompts, PROMPT_LEN, MAX_NEW, seed=seed + 1,
                     temperature=0.8)
    assert np.array_equal(a, b) and not np.array_equal(a, c)
    # the kernel switch forced on runs the same draw through the wrappers
    d = small.sample(prompts, PROMPT_LEN, MAX_NEW, seed=seed,
                     temperature=0.8, paged_kernel=True)
    assert np.array_equal(a, d)
    with pytest.raises(ValueError, match="temperature"):
        small.sample(prompts, PROMPT_LEN, MAX_NEW, temperature=0.0)


def test_semantic_agreement_signal_matches_jax(ladder):
    jrun, trun, cal, live = ladder
    sig = SemanticAgreementSignal(k=3, temperature=0.8)
    assert not sig.supports_running and sig.running(-1.0, 2) is None
    for s, (k, temp) in ((0, (3, 0.8)), (5, (4, 2.5))):
        tsig = SemanticAgreementSignal(k=k, temperature=temp, seed=s)
        jsig = JSemantic(k=k, temperature=temp, seed=s)
        for prompt in list(cal[:4]) + list(live[:2]):
            got = tsig.finalize(SignalObservation(
                prompt=prompt, mean_confidence=-1.0, runner=trun[1],
                max_new=MAX_NEW))
            want = jsig.finalize(JObservation(
                prompt=prompt, mean_confidence=-1.0, runner=jrun[1],
                max_new=MAX_NEW))
            assert got == want and 0.0 <= got <= 1.0
    obs = SignalObservation(prompt=cal[0], mean_confidence=-1.0,
                            runner=trun[0], max_new=MAX_NEW)
    assert sig.finalize(obs) == sig.finalize(obs)
    with pytest.raises(ValueError, match="remote"):
        sig.finalize(SignalObservation(prompt=cal[0], mean_confidence=-1.0,
                                       runner=None))
    with pytest.raises(ValueError, match="k >= 2"):
        SemanticAgreementSignal(k=1)
    assert set(SERVING_SIGNALS) == {"mean_confidence", "semantic_agreement"}
    assert isinstance(resolve_signal("semantic_agreement"),
                      SemanticAgreementSignal)
    with pytest.raises(ValueError, match="unknown"):
        resolve_signal("no_such_signal")


@pytest.mark.parametrize("backend", ["slot", "paged"])
def test_three_tier_semantic_agreement_matches_jax(ladder, backend):
    """Edge 1 gates on semantic agreement: its confidence is the score of
    samples from the mid tier's runner, so its deferrals equal JAX's only
    if the draws do."""
    jrun, trun, cal, live = ladder
    sig = ("mean_confidence", SemanticAgreementSignal(k=3, temperature=2.0))
    jsig = ("mean_confidence", JSemantic(k=3, temperature=2.0))
    jspec = _three_tier(jrun, JCascadeSpec, JCascadeTier, JDeferralEdge,
                        jsig)
    jtaus = j_calibrate_edges(jspec, cal, max_new=MAX_NEW,
                              deferral_ratio=[0.6, 0.5])
    spec = _three_tier(trun, CascadeSpec, CascadeTier, DeferralEdge, sig)
    taus = calibrate_edges(spec, cal, max_new=MAX_NEW,
                           deferral_ratio=[0.6, 0.5])
    np.testing.assert_allclose(taus[0], jtaus[0], atol=CONF_ATOL, rtol=0)
    assert taus[1] == jtaus[1]          # agreement scores are exact
    for edge, t in zip(spec.edges, jtaus):
        edge.tau = t
    kw = _paged_kw(backend)
    res = ContinuousCascadeEngine(spec, EngineConfig(
        n_slots=4, backend=backend, paged=PagedConfig(**kw))).run(
        make_requests(live, MAX_NEW), MAX_NEW)
    jres = JEngine(jspec, JEngineConfig(
        n_slots=4, backend=backend, paged=JPagedConfig(**kw))).run(
        j_make_requests(live, MAX_NEW), MAX_NEW)
    assert_same_run(res, jres)
    assert res.stats["edge_signal"] == ["mean_confidence",
                                        "semantic_agreement"]
    assert res.stats["tier_served"][1] > 0


def test_spec_validation():
    with pytest.raises(ValueError, match="at least 2 tiers"):
        CascadeSpec(tiers=[CascadeTier("only", runner=object())], edges=[])
    with pytest.raises(ValueError, match="deferral edges"):
        CascadeSpec(tiers=[CascadeTier("a", runner=object()),
                           CascadeTier("b", runner=object())], edges=[])
    with pytest.raises(ValueError, match="tier 0"):
        CascadeSpec(tiers=[CascadeTier("a"),
                           CascadeTier("b", runner=object())],
                    edges=[DeferralEdge()])
    with pytest.raises(ValueError, match="runner or a backend"):
        CascadeSpec(tiers=[CascadeTier("a", runner=object()),
                           CascadeTier("b")],
                    edges=[DeferralEdge()])
    with pytest.raises(ValueError, match="samples"):
        CascadeSpec(
            tiers=[CascadeTier("a", runner=object()),
                   CascadeTier("b", backend="sync"),
                   CascadeTier("c", runner=object())],
            edges=[DeferralEdge(),
                   DeferralEdge(signal="semantic_agreement")])


# ---------------------------------------------------------------------------
# The serve CLI: the ladder's builder, its flags, its rejections
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_tiers", [2, 3, 4])
def test_build_ladder_configs_equal_jax(n_tiers):
    """The reduced ladder's configs equal JAX's `build_ladder(arch, 0,
    n)` tier by tier, and a 2-tier ladder's tiers keep their seeds (its
    weights) in the deeper ladders."""
    from repro.launch import serve as jserve
    from repro_torch.launch import serve
    jcfgs = [r.cfg for r in jserve.build_ladder("internlm2-1.8b", 0,
                                                n_tiers)]
    runners = serve.build_ladder("internlm2-1.8b", 0, n_tiers,
                                 device="cpu")
    assert [r.cfg for r in runners] == [
        serve.tier_config(runners[0].cfg, i, n_tiers)
        for i in range(n_tiers)]
    for r, j in zip(runners, jcfgs):
        assert r.cfg.name == j.name
        assert (r.cfg.n_layers, r.cfg.d_ff, r.cfg.d_model, r.cfg.n_heads,
                r.cfg.n_kv_heads) == (j.n_layers, j.d_ff, j.d_model,
                                      j.n_heads, j.n_kv_heads)
    two = serve.build_ladder("internlm2-1.8b", 0, 2, device="cpu")
    for a, b in ((two[0], runners[0]),):
        assert torch.equal(a.params["embedding"], b.params["embedding"])
    big = serve.tier_runner(two[0].cfg, 0, 1, "cpu")
    assert torch.equal(big.params["embedding"], two[1].params["embedding"])
    with pytest.raises(ValueError, match="at least 2"):
        serve.build_ladder("internlm2-1.8b", 0, 1, device="cpu")


def test_full_width_mid_tier_from_shapes():
    """Phase 16's full-width three-tier ladder, from shapes alone: the
    mid tier is 14 layers with d_ff 12288 over internlm2-1.8b's widths."""
    from repro_torch.launch import serve
    from repro_torch.models import transformer as tfm
    small = t_get_config("internlm2-1.8b")
    mid = serve.tier_config(small, 1, 3)
    assert (mid.n_layers, mid.d_ff, mid.d_model, mid.n_heads,
            mid.n_kv_heads) == (14, 12288, 2048, 16, 8)
    assert serve.tier_config(small, 2, 3) == serve.large_tier_config(small)
    n = sum(t.numel() for t in _leaves(tfm.init_params(mid, 0, "meta")))
    assert n == MID_PARAMS
    jmid = get_config("internlm2-1.8b").replace(n_layers=14, d_ff=12288)
    jtree = jtfm.init_params(jmid, jax.random.PRNGKey(0), abstract=True)
    assert sum(int(np.prod(x.shape))
               for x in jax.tree_util.tree_leaves(jtree)) == MID_PARAMS


MID_PARAMS = 1_612_244_992


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


CLI = ["--device", "cpu", "--requests", "6", "--max-new", "3",
       "--prompt-len", "8"]


@pytest.mark.parametrize("argv", [
    ["--tiers", "3"],
    ["--tiers", "3", "--backend", "paged", "--block-size", "4",
     "--prefill-chunk", "4", "--large-backend", "thread"],
    ["--signal", "semantic_agreement", "--signal-k", "3",
     "--signal-temperature", "1.5"],
    ["--recalibrate", "--recalib-target", "0.5", "--recalib-step", "0.1",
     "--recalib-deadband", "0.2", "--recalib-warmup", "2"],
    ["--tiers", "3", "--signal", "semantic_agreement", "--recalibrate",
     "--recalib-warmup", "2"],
], ids=["tiers", "tiers-paged-thread", "semantic", "recalibrate", "all"])
def test_cli_serves_the_ladder_flags(argv, capsys):
    from repro_torch.launch import serve
    from repro_torch.serving.request import DONE
    res = serve.main(CLI + argv)
    out = capsys.readouterr().out
    assert all(r.state == DONE for r in res.requests)
    n_tiers = int(argv[argv.index("--tiers") + 1]) if "--tiers" in argv \
        else 2
    assert res.stats["n_tiers"] == n_tiers
    assert sum(res.stats["tier_served"]) == 6
    if "--signal" in argv:
        assert set(res.stats["edge_signal"]) == {"semantic_agreement"}
    if "--recalibrate" in argv:
        assert "online recalibration" in out
        assert res.stats["edge_tau"] == \
            res.stats["recalibration"]["tau_final"]
    if n_tiers > 2:
        assert "tier_served=" in out


@pytest.mark.parametrize("argv", [
    ["--large-backend", "sync", "--ml-address", "h:1"],
    ["--large-backend", "thread", "--ml-spawn", "2"],
    ["--large-backend", "stub", "--ml-retries", "5"],
    ["--large-backend", "sync", "--stub-latency", "0.1"],
    ["--backend", "slot", "--block-size", "4"],
    ["--backend", "slot", "--paged-kernel", "on"],
    ["--backend", "slot", "--no-prefix-sharing"],
    ["--recalib-step", "0.2"],
    ["--signal-k", "8"],
    ["--engine", "static", "--tiers", "3"],
    ["--engine", "static", "--recalibrate"],
    ["--engine", "static", "--signal", "semantic_agreement"],
    ["--engine", "static", "--metrics-port", "0"],
    ["--tiers", "1"],
    ["--tiers", "3", "--large-backend", "socket", "--ml-address", "h:1"],
    ["--tiers", "3", "--large-backend", "pool", "--ml-spawn", "2"],
    ["--large-backend", "socket"],
])
def test_serve_rejects_contradictory_flags(argv):
    """tests/test_cascade_ladder.py's rejections (and the static engine's
    and --ml-spawn's with --tiers > 2): each exits 2 at argparse time,
    as JAX's CLI does."""
    from repro.launch import serve as jserve
    from repro_torch.launch import serve
    with pytest.raises(SystemExit) as exc:
        serve.main(["--device", "cpu"] + argv)
    assert exc.value.code == 2
    with pytest.raises(SystemExit) as jexc:
        jserve.main(argv)
    assert jexc.value.code == 2
