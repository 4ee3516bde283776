"""Port's cascade evaluation on the CPU against the JAX package: every case
of tests/test_cascade.py (`Cascade` dense and sparse, calibration, the
eq.-6 selection, the sequence signal, the baselines) and of
tests/test_metrics.py (s_o, s_d, the deferral curves, AUROC, Pearson), run
through both packages on the same numpy-seeded inputs. Metrics are numpy
on both sides and must agree exactly; predictions and deferral masks
exactly; confidences and losses within 1e-5 (fp32)."""
import numpy as np
import pytest

import jax.numpy as jnp
import torch

from repro.core import baselines as jbase
from repro.core import calibration as jcal
from repro.core import deferral as jdef
from repro.core import metrics as jmet
from repro.core.cascade import Cascade as JCascade
from repro_torch.core import baselines as tbase
from repro_torch.core import calibration as tcal
from repro_torch.core import deferral as tdef
from repro_torch.core import metrics as tmet
from repro_torch.core.cascade import Cascade

torch.set_num_threads(1)
ATOL = 1e-5


def _pair(seed=0, n_classes=5, d=8):
    """The JAX test's weak/strong linear pair, weights from numpy."""
    rng = np.random.default_rng(seed)
    ws = (rng.standard_normal((d, n_classes)) * 0.3).astype(np.float32)
    wl = rng.standard_normal((d, n_classes)).astype(np.float32)
    jc = JCascade(small_apply=lambda p, x: x @ p, large_apply=lambda p, x: x @ p,
                  small_params=jnp.asarray(ws), large_params=jnp.asarray(wl),
                  signal="max_softmax", tau=0.5)
    tc = Cascade(small_apply=lambda p, x: x @ p, large_apply=lambda p, x: x @ p,
                 small_params=torch.from_numpy(ws),
                 large_params=torch.from_numpy(wl), signal="max_softmax",
                 tau=0.5)
    return jc, tc


def _x(seed, n, d=8):
    return np.random.default_rng(seed).standard_normal((n, d)).astype(
        np.float32)


def _same_result(t, j):
    np.testing.assert_array_equal(t.predictions, np.asarray(j.predictions))
    np.testing.assert_array_equal(t.deferred, np.asarray(j.deferred))
    np.testing.assert_array_equal(t.small_predictions,
                                  np.asarray(j.small_predictions))
    np.testing.assert_allclose(t.confidence, np.asarray(j.confidence),
                               atol=ATOL, rtol=0)
    assert t.deferral_ratio == j.deferral_ratio
    assert t.compute_cost == pytest.approx(j.compute_cost)


# ---------------------------------------------------------------------------
# tests/test_cascade.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("signal", ["max_softmax", "neg_entropy", "margin"])
def test_dense_sparse_equivalent(signal):
    jc, tc = _pair()
    jc.signal = tc.signal = signal
    if signal != "max_softmax":     # a tau inside each signal's range
        conf = np.asarray(jc.confidence(jnp.asarray(_x(2, 64)) @ jc.small_params))
        jc.tau = tc.tau = float(np.median(conf) + 1e-3)
    x = _x(2, 64)
    td, ts = tc.predict_dense(torch.from_numpy(x)), tc.predict_sparse(
        torch.from_numpy(x))
    np.testing.assert_array_equal(td.predictions, ts.predictions)
    np.testing.assert_array_equal(td.deferred, ts.deferred)
    assert td.compute_cost == pytest.approx(ts.compute_cost)
    _same_result(td, jc.predict_dense(jnp.asarray(x)))
    _same_result(ts, jc.predict_sparse(jnp.asarray(x)))
    np.testing.assert_array_equal(ts.large_predictions, np.asarray(
        jc.predict_sparse(jnp.asarray(x)).large_predictions))


def test_tau_extremes():
    jc, tc = _pair()
    x = _x(3, 32)
    for tau, ratio in ((-1e9, 0.0), (1e9, 1.0)):
        jc.tau = tc.tau = tau
        t = tc.predict_dense(torch.from_numpy(x))
        assert t.deferral_ratio == ratio
        _same_result(t, jc.predict_dense(jnp.asarray(x)))
    tc.tau = -1e9
    assert tc.predict_sparse(torch.from_numpy(x)).large_predictions is None


def test_calibrate_ratio():
    jc, tc = _pair()
    x = _x(4, 500)
    jtau = jc.calibrate_tau(jnp.asarray(x), deferral_ratio=0.25)
    ttau = tc.calibrate_tau(torch.from_numpy(x), deferral_ratio=0.25)
    assert ttau == pytest.approx(jtau, abs=ATOL)
    r = tc.predict_dense(torch.from_numpy(x)).deferral_ratio
    assert abs(r - 0.25) < 0.05
    assert r == jc.predict_dense(jnp.asarray(x)).deferral_ratio


def test_calibrate_target_accuracy_matches_jax():
    jc, tc = _pair()
    x = _x(5, 400)
    labels = np.argmax(x @ np.asarray(jc.large_params), axis=-1)
    labels[::3] = 0
    jtau = jc.calibrate_tau(jnp.asarray(x), target_accuracy=0.8,
                            val_labels=labels)
    ttau = tc.calibrate_tau(torch.from_numpy(x), target_accuracy=0.8,
                            val_labels=labels)
    assert ttau == pytest.approx(jtau, abs=ATOL)
    with pytest.raises(ValueError, match="deferral_ratio or target"):
        tc.calibrate_tau(torch.from_numpy(x))


def test_calibrate_sequence_signal_with_mask():
    """Token cascade (logits [N, T, V]) on seq_neg_entropy with a valid
    mask, through calibrate_edges' Cascade branch."""
    rng = np.random.default_rng(6)
    ws = rng.standard_normal((8, 11)).astype(np.float32)
    x = rng.standard_normal((40, 6, 8)).astype(np.float32)
    mask = (rng.random((40, 6)) < 0.8).astype(np.float32)
    jc = JCascade(lambda p, a: a @ p, lambda p, a: a @ p, jnp.asarray(ws),
                  jnp.asarray(ws), signal="seq_neg_entropy")
    tc = Cascade(lambda p, a: a @ p, lambda p, a: a @ p,
                 torch.from_numpy(ws), torch.from_numpy(ws),
                 signal="seq_neg_entropy")
    jtau = jcal.calibrate_edges(jc, jnp.asarray(x), deferral_ratio=0.4,
                                valid_mask=jnp.asarray(mask))[0]
    ttau = tcal.calibrate_edges(tc, torch.from_numpy(x), deferral_ratio=0.4,
                                valid_mask=torch.from_numpy(mask))[0]
    assert ttau == pytest.approx(jtau, abs=ATOL) and tc.tau == ttau
    t = tc.predict_dense(torch.from_numpy(x), torch.from_numpy(mask))
    j = jc.predict_dense(jnp.asarray(x), jnp.asarray(mask))
    _same_result(t, j)
    assert t.predictions.shape == (40, 6)


def test_threshold_for_accuracy_monotone():
    rng = np.random.default_rng(0)
    n = 1000
    sc = (rng.random(n) < 0.6).astype(float)
    lc = np.maximum(sc, (rng.random(n) < 0.9).astype(float))
    conf = sc + rng.random(n) * 0.1
    for target in (0.7, 0.85, 0.999, 0.0):
        assert tcal.threshold_for_accuracy(conf, sc, lc, target) == \
            jcal.threshold_for_accuracy(conf, sc, lc, target)
    tau_low = tcal.threshold_for_accuracy(conf, sc, lc, 0.7)
    tau_high = tcal.threshold_for_accuracy(conf, sc, lc, 0.85)
    assert tau_low is not None and tau_high is not None
    assert tau_high >= tau_low
    assert tcal.threshold_for_accuracy(conf, sc, lc, 0.999) is None


def test_compute_cost_formula():
    for r in (0.0, 0.3, 1.0):
        assert tcal.expected_compute_cost(r, 0.2) == \
            jcal.expected_compute_cost(r, 0.2)
    assert tcal.expected_compute_cost(0.0, 0.2) == pytest.approx(0.2)
    assert tcal.expected_compute_cost(1.0, 0.2) == pytest.approx(1.2)


def test_selective_predict_tokens():
    small = np.zeros((4, 6), np.int32)
    large = np.ones((4, 6), np.int32)
    conf = np.array([0.9, 0.1, 0.9, 0.1], np.float32)
    ref = np.asarray(jdef.selective_predict(jnp.asarray(small),
                                            jnp.asarray(large),
                                            jnp.asarray(conf), 0.5))
    out = tdef.selective_predict(torch.from_numpy(small),
                                 torch.from_numpy(large),
                                 torch.from_numpy(conf), 0.5).numpy()
    np.testing.assert_array_equal(out, ref)
    np.testing.assert_array_equal(out[0], np.zeros(6))
    np.testing.assert_array_equal(out[1], np.ones(6))
    np.testing.assert_array_equal(
        tdef.defer_mask(torch.from_numpy(conf), 0.5).numpy(),
        np.asarray(jdef.defer_mask(jnp.asarray(conf), 0.5)))


def test_sequence_neg_entropy_mask():
    logits = np.random.default_rng(0).standard_normal((3, 10, 7)).astype(
        np.float32)
    mask = np.zeros((3, 10), np.float32)
    mask[:, :4] = 1.0
    g1 = tdef.sequence_negative_entropy(torch.from_numpy(logits),
                                        torch.from_numpy(mask)).numpy()
    g2 = tdef.sequence_negative_entropy(torch.from_numpy(logits[:, :4])).numpy()
    np.testing.assert_allclose(g1, g2, rtol=1e-5)
    ref = np.asarray(jdef.sequence_negative_entropy(jnp.asarray(logits),
                                                    jnp.asarray(mask)))
    np.testing.assert_allclose(g1, ref, atol=ATOL, rtol=0)


@pytest.mark.parametrize("masked", [False, True], ids=["all-valid", "valid"])
def test_static_partition_baseline(masked):
    rng = np.random.default_rng(1)
    logits = rng.standard_normal((32, 5)).astype(np.float32)
    targets = rng.integers(0, 5, 32).astype(np.int32)
    ref_logits = rng.standard_normal((32, 5)).astype(np.float32)
    valid = (rng.random(32) < 0.7).astype(np.float32) if masked else None
    jeasy = jbase.compute_static_partition(jnp.asarray(ref_logits),
                                           jnp.asarray(targets))
    teasy = tbase.compute_static_partition(torch.from_numpy(ref_logits),
                                           torch.from_numpy(targets))
    np.testing.assert_array_equal(teasy.numpy(), np.asarray(jeasy))
    jl, jaux = jbase.static_partition_loss(
        jnp.asarray(logits), jnp.asarray(targets), jeasy, alpha=0.3,
        valid_mask=None if valid is None else jnp.asarray(valid))
    tl, taux = tbase.static_partition_loss(
        torch.from_numpy(logits), torch.from_numpy(targets), teasy, alpha=0.3,
        valid_mask=None if valid is None else torch.from_numpy(valid))
    assert np.isfinite(float(tl))
    for key in ("loss", "l_easy", "l_hard"):
        assert float(taux[key]) == pytest.approx(float(jaux[key]), abs=ATOL)


@pytest.mark.parametrize("kind", ["answer_n", "reduce_confidence"])
def test_prompting_baseline_prepends(kind):
    jpb, tpb = jbase.PromptingBaseline(kind), tbase.PromptingBaseline(kind)
    toks = np.arange(10, dtype=np.int32)[None, :]
    out = tpb.modify_inputs(torch.from_numpy(toks))
    assert out.shape == toks.shape
    np.testing.assert_array_equal(out.numpy(),
                                  np.asarray(jpb.modify_inputs(
                                      jnp.asarray(toks))))
    assert int(out[0, 0]) == (2 if kind == "answer_n" else 1)
    logits = np.random.default_rng(0).standard_normal((4, 16)).astype(
        np.float32)
    conf = tpb.confidence_from_logits(torch.from_numpy(logits))
    assert conf.shape == (4,)
    np.testing.assert_allclose(conf.numpy(), np.asarray(
        jpb.confidence_from_logits(jnp.asarray(logits))), atol=ATOL, rtol=0)


# ---------------------------------------------------------------------------
# tests/test_metrics.py
# ---------------------------------------------------------------------------

def _equal(got, want):
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            _equal(got[k], want[k])
    elif isinstance(want, tuple):
        for g, w in zip(got, want):
            _equal(g, w)
    else:
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def test_ideal_curve_piecewise():
    r = np.linspace(0, 1, 101)
    c = tmet.ideal_deferral_curve(r, 0.6, 0.9)
    _equal(c, jmet.ideal_deferral_curve(r, 0.6, 0.9))
    assert c[0] == pytest.approx(0.6)
    assert c[r <= 0.4][-1] == pytest.approx(0.9, abs=0.02)
    assert np.all(c[r > 0.4] == pytest.approx(0.9))
    assert np.all(np.diff(c) >= -1e-12)
    _equal(tmet.ideal_deferral_curve(r, 1.0, 0.9),
           jmet.ideal_deferral_curve(r, 1.0, 0.9))


def test_ideal_dominates_random():
    r = np.linspace(0, 1, 101)
    _equal(tmet.random_deferral_curve(r, 0.5, 0.9),
           jmet.random_deferral_curve(r, 0.5, 0.9))
    assert np.all(tmet.ideal_deferral_curve(r, 0.5, 0.9)
                  >= tmet.random_deferral_curve(r, 0.5, 0.9) - 1e-12)


@pytest.mark.parametrize("case", ["oracle", "random", "anti-oracle"])
def test_sd_cases(case):
    rng = np.random.default_rng({"oracle": 0, "random": 1,
                                 "anti-oracle": 2}[case])
    n = 4000 if case == "random" else 2000
    sc = (rng.random(n) < 0.7).astype(float)
    lc = (np.ones(n) if case == "anti-oracle"
          else (rng.random(n) < 0.95).astype(float))
    conf = {"oracle": sc + rng.random(n) * 0.01,
            "random": rng.random(n),
            "anti-oracle": -sc + rng.random(n) * 0.01}[case]
    res = tmet.deferral_performance(conf, sc, lc)
    _equal(res, jmet.deferral_performance(conf, sc, lc))
    if case == "oracle":
        assert res["s_d"] > 0.97
    elif case == "random":
        assert abs(res["s_d"]) < 0.1
    else:
        assert res["s_d"] < -0.5


def test_realized_curve_endpoints():
    rng = np.random.default_rng(3)
    n = 500
    sc = (rng.random(n) < 0.6).astype(float)
    lc = (rng.random(n) < 0.9).astype(float)
    conf = rng.random(n)
    r, acc = tmet.realized_deferral_curve(conf, sc, lc)
    _equal((r, acc), jmet.realized_deferral_curve(conf, sc, lc))
    assert acc[0] == pytest.approx(sc.mean())
    assert acc[-1] == pytest.approx(lc.mean())


def test_auroc_perfect_and_random():
    pos = np.linspace(0.6, 1.0, 100)
    neg = np.linspace(0.0, 0.4, 100)
    assert tmet.auroc(pos, neg) == pytest.approx(1.0)
    assert tmet.auroc(neg, pos) == pytest.approx(0.0)
    rng = np.random.default_rng(4)
    a, b = rng.random(3000), rng.random(3000)
    assert tmet.auroc(a, b) == jmet.auroc(a, b)
    assert tmet.auroc(a, b) == pytest.approx(0.5, abs=0.03)
    assert np.isnan(tmet.auroc(a, []))


def test_auroc_matches_bruteforce():
    rng = np.random.default_rng(5)
    pos = np.round(rng.normal(1, 1, 80), 1)       # ties get half credit
    neg = np.round(rng.normal(0, 1, 60), 1)
    brute = np.mean([(p > n) + 0.5 * (p == n) for p in pos for n in neg])
    assert tmet.auroc(pos, neg) == pytest.approx(brute, abs=1e-9)
    assert tmet.auroc(pos, neg) == jmet.auroc(pos, neg)


def test_overlap_bounds_and_separation():
    rng = np.random.default_rng(6)
    same_a, same_b = rng.normal(0, 1, 2000), rng.normal(0, 1, 2000)
    far_b = rng.normal(10, 1, 2000)
    s_same = tmet.distributional_overlap(same_a, same_b)
    s_far = tmet.distributional_overlap(same_a, far_b)
    assert s_same == jmet.distributional_overlap(same_a, same_b)
    assert s_far == jmet.distributional_overlap(same_a, far_b)
    assert 0.8 < s_same <= 1.05
    assert s_far < 0.02


def test_pearson_and_ece():
    x = np.arange(100, dtype=float)
    assert tmet.pearson_correlation(x, 2 * x + 1) == pytest.approx(1.0)
    assert tmet.pearson_correlation(x, -x) == pytest.approx(-1.0)
    rng = np.random.default_rng(8)
    y = rng.random(100)
    assert tmet.pearson_correlation(x, y) == jmet.pearson_correlation(x, y)
    corr = (rng.random(100) < y).astype(float)
    assert tmet.expected_calibration_error(y, corr) == \
        jmet.expected_calibration_error(y, corr)


@pytest.mark.parametrize("seed", [0, 17, 4242])
def test_realized_below_empirical_oracle(seed):
    """tests/test_metrics.py's property at three fixed draws: for every
    deferral count the realized joint accuracy is at most the empirical
    oracle's, and s_d agrees with JAX's."""
    rng = np.random.default_rng(seed)
    n = 800
    ps = float(rng.uniform(0.2, 0.9))
    pl_ = min(ps + float(rng.uniform(0.0, 0.3)), 1.0)
    sc = (rng.random(n) < ps).astype(float)
    lc = np.maximum(sc, (rng.random(n) < pl_).astype(float))
    conf = sc * rng.random(n) + rng.random(n) * 0.5
    order = np.argsort(conf)
    gain = lc - sc
    real_acc = sc.sum() + np.concatenate([[0.0], np.cumsum(gain[order])])
    orac_acc = sc.sum() + np.concatenate([[0.0],
                                          np.cumsum(np.sort(gain)[::-1])])
    assert np.all(real_acc <= orac_acc + 1e-9)
    res = tmet.deferral_performance(conf, sc, lc)
    _equal(res, jmet.deferral_performance(conf, sc, lc))
    if np.isfinite(res["s_d"]) and res["p_l"] - res["p_s"] > 0.1:
        assert -1.0 <= res["s_d"] <= 1.5


def test_summarize_keys():
    rng = np.random.default_rng(7)
    args = (rng.random(300), (rng.random(300) < 0.6).astype(float),
            (rng.random(300) < 0.9).astype(float))
    res = tmet.summarize_deferral(*args)
    _equal(res, jmet.summarize_deferral(*args))
    for k in ("s_d", "s_o", "auroc", "acc_small", "acc_large"):
        assert k in res
