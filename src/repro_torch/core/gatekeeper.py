"""Gatekeeper loss (Rabanser et al. 2025), the paper's core contribution.

Counterpart of `repro.core.gatekeeper`: the correctness-aware hybrid loss
of eqs. (1)-(3) for classifiers and its token-level form, eqs. (4)-(5):

    L        = alpha * L_corr + (1 - alpha) * L_incorr
    L_corr   = CE(p, y) summed over CORRECT positions / #valid positions
    L_incorr = KL(p || Uniform) summed over INCORRECT positions / #valid

Correct/incorrect comes from the model's current argmax, detached from
the graph. Functions take logits of any type and compute in fp32.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class GatekeeperConfig:
    """Configuration of the Gatekeeper fine-tuning loss.

    Attributes:
      alpha: trade-off in (0, 1); low alpha pushes incorrect predictions
        toward uniform, high alpha sharpens correct ones (paper §3.2).
      soft_targets: targets are a probability distribution [..., C] (e.g.
        M_L's softened outputs) instead of integer labels.
      label_smoothing: smoothing applied to hard targets in L_corr.
      mask_pad: integer id treated as padding and excluded from the loss
        (-1 disables).
      stop_grad_partition: the correct/incorrect indicator is detached
        (it has no gradient anyway; kept for parity with the JAX config).
    """

    alpha: float = 0.5
    soft_targets: bool = False
    label_smoothing: float = 0.0
    mask_pad: int = -1
    stop_grad_partition: bool = True


def _log_softmax(logits: torch.Tensor) -> torch.Tensor:
    return torch.log_softmax(logits.float(), dim=-1)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  label_smoothing: float = 0.0) -> torch.Tensor:
    """Per-example -log p_y with optional label smoothing. logits [..., C],
    integer labels [...] -> fp32 [...]."""
    logp = _log_softmax(logits)
    nll = -torch.gather(logp, -1, labels.long()[..., None])[..., 0]
    if label_smoothing > 0.0:
        smooth = -logp.mean(dim=-1)
        nll = (1.0 - label_smoothing) * nll + label_smoothing * smooth
    return nll


def soft_cross_entropy(logits: torch.Tensor,
                       target_probs: torch.Tensor) -> torch.Tensor:
    """CE against soft targets (e.g. M_L teacher probabilities)."""
    return -(target_probs.float() * _log_softmax(logits)).sum(dim=-1)


def predictive_entropy(logits: torch.Tensor) -> torch.Tensor:
    """H(p) per example in nats, fp32."""
    logp = _log_softmax(logits)
    return -(torch.exp(logp) * logp).sum(dim=-1)


def kl_to_uniform(logits: torch.Tensor) -> torch.Tensor:
    """KL(p || U) = log C - H(p) per example."""
    return math.log(float(logits.shape[-1])) - predictive_entropy(logits)


def _masked_mean(values: torch.Tensor, mask: torch.Tensor,
                 denom_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Sum of values*mask over denom_mask.sum() (default: mask.sum()),
    the denominator at least 1. Both loss terms pass denom_mask=valid:
    eqs. (2)-(3) normalise by all valid positions, not by the count of
    correct or incorrect ones."""
    denom = mask if denom_mask is None else denom_mask
    return (values * mask).sum() / torch.clamp(denom.sum(), min=1.0)


def gatekeeper_loss(logits: torch.Tensor, targets: torch.Tensor,
                    cfg: GatekeeperConfig = GatekeeperConfig(),
                    valid_mask: Optional[torch.Tensor] = None):
    """The Gatekeeper hybrid loss, eqs. (1)-(5), for classifiers (logits
    [N, C], targets [N]) and token models (logits [N, T, V], targets
    [N, T]) alike. Returns (loss, aux) with the JAX package's aux keys:
    loss, l_corr, l_incorr, frac_correct, mean_entropy,
    mean_entropy_correct, mean_entropy_incorrect."""
    hard = targets.argmax(-1) if cfg.soft_targets else targets
    correct = (logits.argmax(-1) == hard).float().detach()
    valid = (torch.ones_like(correct) if valid_mask is None
             else valid_mask.float())
    if cfg.mask_pad >= 0 and not cfg.soft_targets:
        valid = valid * (targets != cfg.mask_pad).float()
    if cfg.soft_targets:
        ce = soft_cross_entropy(logits, targets)
    else:
        ce = cross_entropy(logits, hard, cfg.label_smoothing)
    ent = predictive_entropy(logits)
    kl = math.log(float(logits.shape[-1])) - ent

    l_corr = _masked_mean(ce, correct * valid, valid)            # eq. (2)/(4)
    l_incorr = _masked_mean(kl, (1.0 - correct) * valid, valid)  # eq. (3)/(5)
    loss = cfg.alpha * l_corr + (1.0 - cfg.alpha) * l_incorr     # eq. (1)
    aux = {
        "loss": loss,
        "l_corr": l_corr,
        "l_incorr": l_incorr,
        "frac_correct": _masked_mean(correct, valid),
        "mean_entropy": _masked_mean(ent, valid),
        "mean_entropy_correct": _masked_mean(ent, correct * valid),
        "mean_entropy_incorrect": _masked_mean(ent, (1.0 - correct) * valid),
    }
    return loss, aux


def gatekeeper_token_loss(logits: torch.Tensor, targets: torch.Tensor,
                          cfg: GatekeeperConfig = GatekeeperConfig(),
                          valid_mask: Optional[torch.Tensor] = None):
    """Token-level Gatekeeper (eqs. 4-5): the generic loss already works
    per position; kept for API parity at LM call sites."""
    return gatekeeper_loss(logits, targets, cfg, valid_mask)


def standard_ce_loss(logits: torch.Tensor, targets: torch.Tensor,
                     valid_mask: Optional[torch.Tensor] = None):
    """Stage-1 objective (perplexity minimisation). Returns (loss,
    {"loss", "accuracy"})."""
    ce = cross_entropy(logits, targets)
    valid = (torch.ones_like(ce) if valid_mask is None
             else valid_mask.float())
    loss = _masked_mean(ce, valid)
    acc = _masked_mean((logits.argmax(-1) == targets).float(), valid)
    return loss, {"loss": loss, "accuracy": acc}
