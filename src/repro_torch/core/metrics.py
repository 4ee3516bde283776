"""Evaluation metrics for cascade deferral (paper §4.1 + appendices).

JAX-free copy of `repro.core.metrics` (numpy only, host side):

  * s_o  — distributional overlap of correct/incorrect confidences (eq. 9),
           KDE-based min-overlap integral.
  * s_d  — deferral performance (eq. 10): realized area over random,
           normalized by ideal area over random.
  * ideal_deferral_curve — piecewise-linear oracle curve (App. A.2, eq. 11).
  * AUROC (App. B.3, eq. 12).
  * Pearson correlation for non-binary factuality scores (§4.3).
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

# numpy >= 2 names the trapezoid rule `trapezoid`; older releases `trapz`
_trapezoid = getattr(np, "trapezoid", None) or np.trapz


# ---------------------------------------------------------------------------
# Distributional overlap s_o (eq. 9)
# ---------------------------------------------------------------------------

def _gaussian_kde(samples: np.ndarray, grid: np.ndarray,
                  bandwidth: Optional[float] = None) -> np.ndarray:
    """Minimal Gaussian KDE (Scott's rule) evaluated on `grid`."""
    samples = np.asarray(samples, dtype=np.float64).ravel()
    n = samples.size
    if n == 0:
        return np.zeros_like(grid)
    if bandwidth is None:
        std = samples.std()
        if std <= 1e-12:
            std = 1e-3
        bandwidth = 1.06 * std * n ** (-1 / 5)
        bandwidth = max(bandwidth, 1e-4)
    z = (grid[:, None] - samples[None, :]) / bandwidth
    dens = np.exp(-0.5 * z * z).sum(axis=1)
    dens /= n * bandwidth * np.sqrt(2 * np.pi)
    return dens


def distributional_overlap(conf_correct: np.ndarray,
                           conf_incorrect: np.ndarray,
                           num_grid: int = 512,
                           bandwidth: Optional[float] = None) -> float:
    """s_o = integral of min(p_corr(c), p_incorr(c)) dc  (eq. 9).

    1.0 = indistinguishable, 0.0 = perfectly separable. Grid spans the union
    support of both samples (confidences need not live in [0,1] — negative
    entropy is unbounded below).
    """
    a = np.asarray(conf_correct, np.float64).ravel()
    b = np.asarray(conf_incorrect, np.float64).ravel()
    if a.size == 0 or b.size == 0:
        return float("nan")
    lo = min(a.min(), b.min())
    hi = max(a.max(), b.max())
    span = max(hi - lo, 1e-6)
    grid = np.linspace(lo - 0.05 * span, hi + 0.05 * span, num_grid)
    pa = _gaussian_kde(a, grid, bandwidth)
    pb = _gaussian_kde(b, grid, bandwidth)
    return float(_trapezoid(np.minimum(pa, pb), grid))


# ---------------------------------------------------------------------------
# Deferral curves and s_d (eq. 10, App. A.2)
# ---------------------------------------------------------------------------

def ideal_deferral_curve(r: np.ndarray, p_s: float, p_l: float) -> np.ndarray:
    """acc_ideal(r), eq. (11): linear from p_s to p_l over [0, 1-p_s], then flat."""
    r = np.asarray(r, np.float64)
    knee = 1.0 - p_s
    if knee <= 1e-12:
        return np.full_like(r, p_l)
    rising = p_s + (p_l - p_s) / knee * r
    return np.where(r <= knee, rising, p_l)


def random_deferral_curve(r: np.ndarray, p_s: float, p_l: float) -> np.ndarray:
    """acc_rand(r) = (1-r) p_s + r p_l — linear interpolation."""
    r = np.asarray(r, np.float64)
    return (1.0 - r) * p_s + r * p_l


def realized_deferral_curve(confidence: np.ndarray,
                            small_correct: np.ndarray,
                            large_correct: np.ndarray,
                            ratios: Optional[np.ndarray] = None
                            ) -> Tuple[np.ndarray, np.ndarray]:
    """acc_real(r) under the learned deferral strategy g.

    For each deferral ratio r, defer the r-fraction of LEAST confident
    examples to M_L and measure joint accuracy.

    Args:
      confidence: [N] deferral signal g(x_i) (higher = keep on M_S).
      small_correct / large_correct: [N] {0,1} per-example correctness
        (or graded scores in [0,1] for the factuality variant of §4.3).
      ratios: deferral ratios to evaluate (default 0..1 in 1/N steps,
        capped at 201 points).

    Returns (ratios, joint_accuracy).
    """
    conf = np.asarray(confidence, np.float64).ravel()
    sc = np.asarray(small_correct, np.float64).ravel()
    lc = np.asarray(large_correct, np.float64).ravel()
    n = conf.size
    order = np.argsort(conf)          # ascending: least confident first
    sc_sorted = sc[order]
    lc_sorted = lc[order]
    # prefix[k] = sum of lc over the k least-confident (deferred),
    # suffix      = sum of sc over the rest (kept on M_S).
    prefix_lc = np.concatenate([[0.0], np.cumsum(lc_sorted)])
    prefix_sc = np.concatenate([[0.0], np.cumsum(sc_sorted)])
    total_sc = prefix_sc[-1]
    if ratios is None:
        m = min(n, 200)
        ratios = np.linspace(0.0, 1.0, m + 1)
    accs = np.empty_like(ratios)
    for i, r in enumerate(ratios):
        k = int(round(r * n))
        accs[i] = (prefix_lc[k] + (total_sc - prefix_sc[k])) / n
    return np.asarray(ratios), accs


def deferral_performance(confidence: np.ndarray,
                         small_correct: np.ndarray,
                         large_correct: np.ndarray,
                         num_ratios: int = 200) -> dict:
    """s_d of eq. (10) plus the underlying curves.

    s_d = ∫(acc_real - acc_rand) dr / ∫(acc_ideal - acc_rand) dr.
    1.0 = ideal deferral, 0.0 = no better than random.
    """
    sc = np.asarray(small_correct, np.float64).ravel()
    lc = np.asarray(large_correct, np.float64).ravel()
    p_s = float(sc.mean())
    p_l = float(lc.mean())
    ratios = np.linspace(0.0, 1.0, num_ratios + 1)
    _, acc_real = realized_deferral_curve(confidence, sc, lc, ratios)
    acc_rand = random_deferral_curve(ratios, p_s, p_l)
    acc_ideal = ideal_deferral_curve(ratios, p_s, p_l)
    num = _trapezoid(acc_real - acc_rand, ratios)
    den = _trapezoid(acc_ideal - acc_rand, ratios)
    s_d = float(num / den) if abs(den) > 1e-12 else float("nan")
    return {
        "s_d": s_d,
        "p_s": p_s,
        "p_l": p_l,
        "ratios": ratios,
        "acc_real": acc_real,
        "acc_rand": acc_rand,
        "acc_ideal": acc_ideal,
        "area_realized": float(num),
        "area_useful": float(den),
    }


# ---------------------------------------------------------------------------
# AUROC (App. B.3, eq. 12)
# ---------------------------------------------------------------------------

def auroc(conf_correct: np.ndarray, conf_incorrect: np.ndarray) -> float:
    """Area under the ROC of separating correct (positive) from incorrect
    (negative) by confidence. Computed exactly via the rank statistic
    (equivalent to eq. 12's threshold integral); ties get half credit."""
    pos = np.asarray(conf_correct, np.float64).ravel()
    neg = np.asarray(conf_incorrect, np.float64).ravel()
    if pos.size == 0 or neg.size == 0:
        return float("nan")
    all_scores = np.concatenate([pos, neg])
    order = np.argsort(all_scores, kind="mergesort")
    ranks = np.empty_like(order, dtype=np.float64)
    ranks[order] = np.arange(1, all_scores.size + 1)
    # average ranks for ties
    sorted_scores = all_scores[order]
    i = 0
    while i < sorted_scores.size:
        j = i
        while j + 1 < sorted_scores.size and sorted_scores[j + 1] == sorted_scores[i]:
            j += 1
        if j > i:
            avg = (i + j + 2) / 2.0
            ranks[order[i:j + 1]] = avg
        i = j + 1
    r_pos = ranks[:pos.size].sum()
    u = r_pos - pos.size * (pos.size + 1) / 2.0
    return float(u / (pos.size * neg.size))


# ---------------------------------------------------------------------------
# Factuality-score variant (paper §4.3)
# ---------------------------------------------------------------------------

def pearson_correlation(x: np.ndarray, y: np.ndarray) -> float:
    """rho(g_NENT(x_i), s_Fac(y_hat_i, y_i)) — §4.3 replacement for s_o when
    correctness is graded rather than binary."""
    x = np.asarray(x, np.float64).ravel()
    y = np.asarray(y, np.float64).ravel()
    if x.size < 2:
        return float("nan")
    xs = x - x.mean()
    ys = y - y.mean()
    denom = np.sqrt((xs * xs).sum() * (ys * ys).sum())
    if denom < 1e-12:
        return float("nan")
    return float((xs * ys).sum() / denom)


def expected_calibration_error(confidence: np.ndarray, correct: np.ndarray,
                               num_bins: int = 15) -> float:
    """Beyond-paper: standard ECE, useful to report alongside s_o."""
    conf = np.asarray(confidence, np.float64).ravel()
    corr = np.asarray(correct, np.float64).ravel()
    bins = np.linspace(conf.min(), conf.max() + 1e-9, num_bins + 1)
    ece = 0.0
    for lo, hi in zip(bins[:-1], bins[1:]):
        m = (conf >= lo) & (conf < hi)
        if m.sum() == 0:
            continue
        ece += m.mean() * abs(conf[m].mean() - corr[m].mean())
    return float(ece)


def summarize_deferral(confidence: np.ndarray,
                       small_correct: np.ndarray,
                       large_correct: np.ndarray) -> dict:
    """One-call summary used by benchmarks: s_o, s_d, AUROC, acc(M_S)."""
    conf = np.asarray(confidence, np.float64).ravel()
    sc = np.asarray(small_correct, np.float64).ravel()
    res = deferral_performance(conf, sc, large_correct)
    c_corr = conf[sc > 0.5]
    c_inc = conf[sc <= 0.5]
    res["s_o"] = distributional_overlap(c_corr, c_inc)
    res["auroc"] = auroc(c_corr, c_inc)
    res["acc_small"] = res["p_s"]
    res["acc_large"] = res["p_l"]
    return res
