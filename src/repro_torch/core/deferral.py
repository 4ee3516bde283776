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
  * Serving-level signals (`SERVING_SIGNALS`): the `SignalObservation`
    an edge sees at its decision point, the eq.-8 mean-confidence signal
    (running form: in-flight early exit works under it) and the k-sample
    semantic-agreement signal (arXiv 2509.21837: k stochastic
    continuations from the tier's own runner, `ModelRunner.sample`, which
    draws JAX's categorical noise through `core.prng`; scored by their
    mean pairwise token agreement; no running form), and
    `resolve_signal`.
"""
from __future__ import annotations

import dataclasses
import zlib
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
    decision point (see `repro.core.deferral.SignalObservation`).
    `paged_kernel` is the engine's kernel switch, which a sampling signal
    hands to the runner (None: resolved from the runner's device)."""
    prompt: np.ndarray
    mean_confidence: float
    tokens: Optional[np.ndarray] = None
    runner: Any = None
    max_new: int = 0
    rid: int = 0
    paged_kernel: Optional[bool] = None


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


class SemanticAgreementSignal:
    """k-sample semantic-agreement voting (arXiv 2509.21837): sample k
    stochastic continuations of the prompt from the tier's own model and
    return the mean pairwise per-token agreement in [0, 1]. Costs k
    sampled generations per gated request, paid once at the decision
    point: there is no running form, so an edge using it never
    early-exits. The sampling seed is ``crc32(prompt bytes) ^ seed``, as
    in JAX, so a score depends on the prompt alone, not on the batch or
    the decision order."""

    name = "semantic_agreement"
    supports_running = False

    def __init__(self, k: int = 4, temperature: float = 0.8,
                 seed: int = 0):
        if k < 2:
            raise ValueError(f"semantic agreement needs k >= 2 samples, "
                             f"got {k}")
        self.k = k
        self.temperature = temperature
        self.seed = seed

    def running(self, mean_confidence: float, n_gen: int) -> None:
        return None

    def finalize(self, obs: SignalObservation) -> float:
        if obs.runner is None:
            raise ValueError(
                "semantic_agreement needs the tier's local ModelRunner "
                "to draw samples; this tier only has a remote backend")
        prompt = np.asarray(obs.prompt, np.int32)
        seed = zlib.crc32(prompt.tobytes()) ^ self.seed
        max_new = obs.max_new or (len(obs.tokens)
                                  if obs.tokens is not None else 1)
        samples = obs.runner.sample(
            np.tile(prompt, (self.k, 1)), int(prompt.shape[0]),
            int(max_new), seed=seed, temperature=self.temperature,
            paged_kernel=obs.paged_kernel)
        return float(pairwise_agreement(samples))


def pairwise_agreement(samples: np.ndarray) -> float:
    """Mean pairwise per-token agreement of a [k, T] sample matrix, in
    [0, 1]: 1.0 when all k samples are identical token for token."""
    s = np.asarray(samples)
    k = s.shape[0]
    if k < 2:
        return 1.0
    total, pairs = 0.0, 0
    for i in range(k):
        for j in range(i + 1, k):
            total += float((s[i] == s[j]).mean())
            pairs += 1
    return total / pairs


SERVING_SIGNALS = {
    "mean_confidence": MeanConfidenceSignal,
    "semantic_agreement": SemanticAgreementSignal,
}


def resolve_signal(signal: Any) -> Any:
    """Accept a serving-signal name or an instance; return the instance.
    Names construct with defaults; pass an instance for custom knobs."""
    if isinstance(signal, str):
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
