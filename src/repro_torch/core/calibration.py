"""Threshold calibration for the cascade gate (paper Stage 3).

JAX-free copy of `repro.core.calibration`: tau for a target deferral
ratio or a target joint accuracy. `calibrate_edges` is the one
calibration surface for the classifier `core.cascade.Cascade` and for
generation ladders: it picks each edge's tau as the target quantile of
the validation confidences, with the repo-wide ``deferred = conf < tau``
convention (ratio<=0 -> below-min tau, never defer; ratio>=1 ->
above-max tau, always defer).
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Union

import numpy as np

from repro_torch.core.deferral import SignalObservation


def threshold_for_deferral_ratio(confidence: np.ndarray, ratio: float) -> float:
    """tau s.t. the fraction of examples with g(x) < tau is ~`ratio`."""
    conf = np.asarray(confidence, np.float64).ravel()
    if ratio <= 0.0:
        return float(conf.min() - 1.0)
    if ratio >= 1.0:
        return float(conf.max() + 1.0)
    return float(np.quantile(conf, ratio))


def threshold_for_accuracy(confidence: np.ndarray,
                           small_correct: np.ndarray,
                           large_correct: np.ndarray,
                           target_accuracy: float) -> Optional[float]:
    """Smallest-deferral tau whose joint accuracy >= target on validation.

    Returns None when the target exceeds what full deferral achieves.
    """
    conf = np.asarray(confidence, np.float64).ravel()
    sc = np.asarray(small_correct, np.float64).ravel()
    lc = np.asarray(large_correct, np.float64).ravel()
    n = conf.size
    order = np.argsort(conf)                       # least confident first
    sc_s, lc_s = sc[order], lc[order]
    prefix_lc = np.concatenate([[0.0], np.cumsum(lc_s)])
    prefix_sc = np.concatenate([[0.0], np.cumsum(sc_s)])
    total_sc = prefix_sc[-1]
    joint = (prefix_lc + (total_sc - prefix_sc)) / n   # joint acc deferring k
    ok = np.nonzero(joint >= target_accuracy)[0]
    if ok.size == 0:
        return None
    k = int(ok[0])
    if k == 0:
        return float(conf.min() - 1.0)
    if k >= n:
        return float(conf.max() + 1.0)
    sorted_conf = conf[order]
    return float(0.5 * (sorted_conf[k - 1] + sorted_conf[k]))


def expected_compute_cost(deferral_ratio: float,
                          cost_small: float = 0.2,
                          cost_large: float = 1.0) -> float:
    """Compute budget of the cascade (paper Fig. 1): every request pays
    cost_small; deferred requests additionally pay cost_large."""
    return cost_small + deferral_ratio * cost_large


def ladder_compute_cost(reach_fractions: Sequence[float],
                        costs: Sequence[float]) -> float:
    """Tier i costs `costs[i]` and is paid by the `reach_fractions[i]`
    fraction of traffic that reaches it."""
    if len(reach_fractions) != len(costs):
        raise ValueError(f"{len(reach_fractions)} reach fractions but "
                         f"{len(costs)} tier costs")
    return float(sum(r * c for r, c in zip(reach_fractions, costs)))


def _per_edge_ratios(n_edges: int,
                     deferral_ratio: Union[float, Sequence[float]]
                     ) -> List[float]:
    if hasattr(deferral_ratio, "__len__"):
        ratios = [float(r) for r in deferral_ratio]
        if len(ratios) != n_edges:
            raise ValueError(f"{n_edges} edges but {len(ratios)} "
                             f"deferral ratios")
        return ratios
    return [float(deferral_ratio)] * n_edges


def calibrate_edges(spec, val_prompts, *, max_new: Optional[int] = None,
                    deferral_ratio: Union[float, Sequence[float]] = 0.2,
                    prompt_len: Optional[int] = None,
                    valid_mask=None,
                    paged_kernel: Optional[bool] = None) -> List[float]:
    """Calibrate every edge threshold of a cascade from one validation
    batch; sets the taus in place and returns them (edge order).

    `spec` is a `CascadeSpec` (tier i's runner generates on the prompts
    the edges before it would defer that far; needs `max_new`;
    `paged_kernel` goes to each runner's `generate`) or a
    `core.cascade.Cascade` (classifier: the configured logit signal on
    the small model, one edge; `valid_mask` feeds its signal)."""
    if hasattr(spec, "small_apply"):
        ratios = _per_edge_ratios(1, deferral_ratio)
        logits = spec.small_apply(spec.small_params, val_prompts)
        conf = spec.confidence(logits, valid_mask)
        spec.tau = threshold_for_deferral_ratio(
            conf.detach().cpu().numpy(), ratios[0])
        return [spec.tau]
    if max_new is None:
        raise ValueError("calibrate_edges needs max_new for a generation "
                         "ladder")
    ratios = _per_edge_ratios(len(spec.edges), deferral_ratio)
    prompts = np.asarray(val_prompts, np.int32)
    if prompt_len is None:
        prompt_len = int(prompts.shape[1])
    reach = np.arange(prompts.shape[0])          # rows reaching edge i
    taus: List[float] = []
    for i, (edge, ratio) in enumerate(zip(spec.edges, ratios)):
        if reach.size == 0:
            taus.append(edge.tau)
            continue
        runner = spec.tiers[i].runner
        if runner is None:
            raise ValueError(
                f"cannot calibrate edge {i}: tier {i} "
                f"({spec.tiers[i].name!r}) has no local runner")
        sub = prompts[reach]
        tokens, mean_conf = runner.generate(sub, prompt_len, max_new,
                                            paged_kernel=paged_kernel)
        sig = edge.signal
        if sig.supports_running:
            conf = np.asarray(mean_conf, np.float64)
        else:
            conf = np.array([
                sig.finalize(SignalObservation(
                    prompt=sub[j], mean_confidence=float(mean_conf[j]),
                    tokens=tokens[j], runner=runner, max_new=max_new))
                for j in range(sub.shape[0])], np.float64)
        edge.tau = threshold_for_deferral_ratio(conf, ratio)
        taus.append(edge.tau)
        reach = reach[conf < edge.tau]
    return taus
