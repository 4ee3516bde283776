"""Threshold calibration for the cascade gate (paper Stage 3).

JAX-free copy of `repro.core.calibration` for generation ladders:
`calibrate_edges` picks each edge's tau as the target quantile of the
validation confidences, with the repo-wide ``deferred = conf < tau``
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


def calibrate_edges(spec, val_prompts, *, max_new: int,
                    deferral_ratio: Union[float, Sequence[float]] = 0.2,
                    prompt_len: Optional[int] = None) -> List[float]:
    """Calibrate every edge threshold of a `CascadeSpec` from one
    validation batch; sets the taus in place and returns them. Edge i
    calibrates on the prompts the edges before it would defer that far."""
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
        tokens, mean_conf = runner.generate(sub, prompt_len, max_new)
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
