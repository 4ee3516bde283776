"""Prior-work deferral baselines the paper compares against (or cites).

Counterpart of `repro.core.baselines`:

  * Static partition (Rawat et al. 2021) — the training data is split into
    easy/hard ONCE, by a frozen reference model's correctness, and trained
    with the Gatekeeper loss's two branches on that fixed split. The paper
    improves on it by taking the split from M_S's live argmax.
  * Prompting baselines (App. B.2): "Reduce Confidence" and "Answer N",
    realized as an instruction token prepended to the request (a
    black-box prompt change; the paper shows they do not help).

The untuned baseline (the Stage-1 model's confidence without the
Gatekeeper fine-tune) needs no code of its own. Functions take logits of
any type and compute in fp32.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.core.gatekeeper import (_masked_mean, cross_entropy,
                                         kl_to_uniform)


def static_partition_loss(logits: torch.Tensor, targets: torch.Tensor,
                          easy_mask: torch.Tensor, alpha: float = 0.5,
                          valid_mask: Optional[torch.Tensor] = None):
    """Rawat'21-style loss: the easy/hard partition `easy_mask` is FIXED
    (computed once, before training, e.g. from M_L's correctness) instead
    of taken from M_S's live argmax. CE on easy positions, KL to uniform
    on hard ones, both over the count of valid positions. Returns (loss,
    {"loss", "l_easy", "l_hard"})."""
    easy = easy_mask.float()
    valid = torch.ones_like(easy) if valid_mask is None else valid_mask.float()
    ce = cross_entropy(logits, targets)
    kl = kl_to_uniform(logits)
    l_easy = _masked_mean(ce, easy * valid, valid)
    l_hard = _masked_mean(kl, (1.0 - easy) * valid, valid)
    loss = alpha * l_easy + (1.0 - alpha) * l_hard
    return loss, {"loss": loss, "l_easy": l_easy, "l_hard": l_hard}


def compute_static_partition(ref_logits: torch.Tensor,
                             targets: torch.Tensor) -> torch.Tensor:
    """Easy = the frozen reference model (M_L or the pre-finetune M_S)
    already answers correctly: a {0, 1} fp32 mask shaped like `targets`."""
    preds = torch.argmax(ref_logits, dim=-1)
    return (preds == targets).float()


# ---------------------------------------------------------------------------
# Prompting baselines (App. B.2) — black-box prompt modifications. For the
# synthetic LM tasks, "prompting" prepends a reserved instruction token the
# model was never trained to use, as a deployed LLM receives a novel
# instruction string.
# ---------------------------------------------------------------------------

REDUCE_CONFIDENCE_TOKEN = 1   # reserved ids in the synthetic vocabularies
ANSWER_N_TOKEN = 2
UNCERTAIN_ANSWER_ID = 3       # the "N" answer token


@dataclasses.dataclass(frozen=True)
class PromptingBaseline:
    """Prepends an uncertainty instruction token to each request."""
    kind: str   # "reduce_confidence" | "answer_n"

    def modify_inputs(self, tokens: torch.Tensor) -> torch.Tensor:
        """Instruction token first, the last position dropped to keep the
        length."""
        tok = {"reduce_confidence": REDUCE_CONFIDENCE_TOKEN,
               "answer_n": ANSWER_N_TOKEN}[self.kind]
        instr = torch.full(tokens.shape[:-1] + (1,), tok, dtype=tokens.dtype,
                           device=tokens.device)
        return torch.cat([instr, tokens[..., :-1]], dim=-1)

    def confidence_from_logits(self, logits: torch.Tensor) -> torch.Tensor:
        """answer_n: 1 - p("N"); reduce_confidence: the max softmax."""
        p = torch.softmax(logits.float(), dim=-1)
        if self.kind == "answer_n":
            return 1.0 - p[..., UNCERTAIN_ANSWER_ID]
        return p.amax(dim=-1)
