"""Deferral signals (paper §3.2 Stage 3, eq. 8) for the serving cascade.

JAX-free copy of the parts of `repro.core.deferral` the port's serving
path uses: the eq.-8 negative entropy on logits, the `SignalObservation`
an edge sees at its decision point, the mean-confidence serving signal,
and `resolve_signal`. The k-sample semantic-agreement signal is not
ported yet (see ROADMAP.md).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch


def negative_entropy(logits: torch.Tensor) -> torch.Tensor:
    """-H(p) per position, stable from logits, in fp32. Higher = more
    confident."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    return (torch.exp(logp) * logp).sum(dim=-1)


@dataclasses.dataclass
class SignalObservation:
    """Everything a serving edge knows about one request at its deferral
    decision point (see `repro.core.deferral.SignalObservation`)."""
    prompt: np.ndarray
    mean_confidence: float
    tokens: Optional[np.ndarray] = None
    runner: Any = None
    max_new: int = 0
    rid: int = 0


class MeanConfidenceSignal:
    """Eq.-8 mean negative predictive entropy — the paper's signal. The
    confidence is accumulated on device by the tier's decode loop, and a
    running mean exists every step, so in-flight early exit works."""

    name = "mean_confidence"
    supports_running = True

    def running(self, mean_confidence: float, n_gen: int) -> float:
        return mean_confidence

    def finalize(self, obs: SignalObservation) -> float:
        return float(obs.mean_confidence)


SERVING_SIGNALS = {"mean_confidence": MeanConfidenceSignal}


def resolve_signal(signal: Any) -> Any:
    """Accept a serving-signal name or an instance; return the instance."""
    if isinstance(signal, str):
        if signal == "semantic_agreement":
            raise NotImplementedError(
                "the semantic_agreement signal is not ported yet (see "
                "ROADMAP.md); use mean_confidence")
        try:
            return SERVING_SIGNALS[signal]()
        except KeyError:
            raise ValueError(
                f"unknown deferral signal {signal!r}; known: "
                f"{sorted(SERVING_SIGNALS)}") from None
    if not hasattr(signal, "finalize") or not hasattr(signal, "running"):
        raise TypeError(f"deferral signal must implement "
                        f"running()/finalize(), got {type(signal).__name__}")
    return signal
