"""Deferral signals and selective prediction (paper §3.2 Stage 3, eqs.
6-8).

JAX-free copy of `repro.core.deferral`:

  * Array-level signals (`SIGNALS`): logits [..., V] -> confidence, used
    by the classifier `core.cascade.Cascade` and evaluation sweeps, plus
    `defer_mask` and `selective_predict` (eq. 6). `max_softmax`,
    `negative_entropy` and `sequence_negative_entropy` take one
    `kernels.ops.deferral_signal` pass over the logits (the CUDA
    `deferral_entropy` kernel on CUDA tensors, its plain version on CPU
    tensors); `margin_confidence` stays plain `topk` (no TPU kernel
    computes it).
  * Serving-level signals: the `SignalObservation` an edge sees at its
    decision point, the mean-confidence signal, and `resolve_signal`. The
    k-sample semantic-agreement signal is not ported yet (see
    ROADMAP.md).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.kernels import ops as kernel_ops


def max_softmax(logits: torch.Tensor) -> torch.Tensor:
    """g_CL(x) = max_c p(y=c|x) (eq. 7). logits [..., C] -> fp32 [...]."""
    return kernel_ops.deferral_signal(logits)[1]


def negative_entropy(logits: torch.Tensor) -> torch.Tensor:
    """-H(p) per position, stable from logits, in fp32. Higher = more
    confident."""
    return kernel_ops.deferral_signal(logits)[0]


def masked_sequence_mean(per_token: torch.Tensor,
                         valid_mask: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """Mean of [..., T] over valid positions (all of them without a mask)."""
    if valid_mask is None:
        return per_token.mean(dim=-1)
    m = valid_mask.float()
    return (per_token * m).sum(dim=-1) / torch.clamp(m.sum(dim=-1), min=1.0)


def sequence_negative_entropy(logits: torch.Tensor,
                              valid_mask: Optional[torch.Tensor] = None
                              ) -> torch.Tensor:
    """g_NENT(x) = 1/T sum_t sum_c p log p (eq. 8): logits [..., T, V],
    valid_mask [..., T] (1 = real token) -> the mean negative predictive
    entropy over valid positions [...]."""
    return masked_sequence_mean(negative_entropy(logits), valid_mask)


def margin_confidence(logits: torch.Tensor) -> torch.Tensor:
    """Beyond-paper signal: top-1/top-2 probability margin."""
    p = torch.softmax(logits.float(), dim=-1)
    top2 = torch.topk(p, 2, dim=-1).values
    return top2[..., 0] - top2[..., 1]


SIGNALS = {
    "max_softmax": max_softmax,
    "neg_entropy": negative_entropy,
    "seq_neg_entropy": sequence_negative_entropy,
    "margin": margin_confidence,
}


def defer_mask(confidence, tau):
    """True where the cascade DEFERS to M_L (confidence < tau), eq. 6."""
    return confidence < tau


def selective_predict(small_preds: torch.Tensor, large_preds: torch.Tensor,
                      confidence: torch.Tensor, tau) -> torch.Tensor:
    """(M_S, M_L, g)(x) of eq. 6 over a batch: class ids [N] or token
    arrays [N, T] from each model, confidence [N]."""
    mask = defer_mask(confidence, tau)
    while mask.dim() < small_preds.dim():
        mask = mask[..., None]
    return torch.where(mask, large_preds, small_preds)


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
