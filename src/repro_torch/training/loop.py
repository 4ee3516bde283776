"""Training loops: Stage-1 standard training and Stage-2 Gatekeeper
fine-tuning (the paper's two-stage recipe, §3.2) on full logits, for
classifiers and token models alike, and the classifier evaluation.

Counterpart of `repro.training.loop`. Batches may hold numpy arrays: the
loss moves them to the parameters' device, as the JAX step's `jit` places
them.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from repro_torch.core.baselines import static_partition_loss
from repro_torch.core.gatekeeper import (GatekeeperConfig, gatekeeper_loss,
                                         standard_ce_loss)
from repro_torch.kernels import ops as kernel_ops
from repro_torch.training import optim


@dataclasses.dataclass
class TrainResult:
    params: Any
    history: Dict[str, list]


def make_loss_fn(apply_fn: Callable, loss_kind: str = "ce",
                 gk_cfg: Optional[GatekeeperConfig] = None,
                 aux_weight: float = 0.0):
    """loss_fn(params, batch) -> (loss + aux_weight * model aux, aux).

    apply_fn(params, batch) returns logits or (logits, aux_loss); batch
    holds "inputs", "targets", optionally "loss_mask", and "easy_mask"
    for the static partition; its numpy arrays go to the parameters'
    device. loss_kind: "ce" (Stage 1) | "gatekeeper" (Stage 2) |
    "static_partition" (`core.baselines`, alpha from `gk_cfg`, else 0.5)."""
    if loss_kind not in ("ce", "gatekeeper", "static_partition"):
        raise ValueError(loss_kind)

    def loss_fn(params, batch):
        dev = next(optim.tree_leaves(params)).device
        batch = {k: torch.as_tensor(v, device=dev)
                 if isinstance(v, np.ndarray) else v
                 for k, v in batch.items()}
        out = apply_fn(params, batch)
        if isinstance(out, tuple):
            logits, model_aux = out
        else:
            logits = out
            model_aux = torch.zeros((), dtype=torch.float32,
                                    device=logits.device)
        mask = batch.get("loss_mask")
        if loss_kind == "ce":
            loss, aux = standard_ce_loss(logits, batch["targets"], mask)
        elif loss_kind == "gatekeeper":
            loss, aux = gatekeeper_loss(logits, batch["targets"], gk_cfg, mask)
        else:
            loss, aux = static_partition_loss(
                logits, batch["targets"], batch["easy_mask"],
                alpha=gk_cfg.alpha if gk_cfg else 0.5, valid_mask=mask)
        aux = dict(aux)
        aux["model_aux"] = model_aux
        return loss + aux_weight * model_aux, aux

    return loss_fn


def make_train_step(apply_fn: Callable, opt_cfg: optim.AdamWConfig,
                    loss_kind: str = "ce",
                    gk_cfg: Optional[GatekeeperConfig] = None,
                    aux_weight: float = 0.0):
    """(params, opt_state, batch) -> (params, opt_state, metrics) for the
    loss of `make_loss_fn`, the parameters and moments updated in place."""
    loss_fn = make_loss_fn(apply_fn, loss_kind, gk_cfg, aux_weight)

    def step(params, opt_state, batch):
        (loss, aux), grads = optim.value_and_grad(loss_fn, params, batch)
        params, opt_state, om = optim.adamw_update(opt_cfg, grads, opt_state,
                                                   params)
        return params, opt_state, {**aux, **om, "total_loss": loss}

    return step


def train(params, step_fn, batches, n_steps: int, log_every: int = 50,
          log_fn=None) -> TrainResult:
    """Generic loop over an (infinite) batch iterator; logs the scalar
    metrics of step 1 and of every `log_every`-th step."""
    opt_state = optim.adamw_init(params)
    history: Dict[str, list] = {}
    it = iter(batches)
    for i in range(n_steps):
        params, opt_state, metrics = step_fn(params, opt_state, next(it))
        if (i + 1) % log_every == 0 or i == 0:
            m = {k: float(v) for k, v in metrics.items()
                 if torch.as_tensor(v).dim() == 0}
            for k, v in m.items():
                history.setdefault(k, []).append(v)
            history.setdefault("step", []).append(i + 1)
            if log_fn:
                log_fn(i + 1, m)
    return TrainResult(params=params, history=history)


@torch.no_grad()
def evaluate_classifier(apply_fn, params, x, y, batch: int = 4096):
    """Returns numpy (predictions, max-softmax confidence, correctness as
    float64). Rows go to the parameters' device `batch` at a time, and
    each batch's (max_prob, argmax) come from one
    `kernels.ops.deferral_signal` pass over its logits (the CUDA
    `deferral_entropy` kernel on CUDA)."""
    dev = next(optim.tree_leaves(params)).device
    preds, confs = [], []
    for i in range(0, len(x), batch):
        xb = torch.tensor(np.asarray(x[i:i + batch]), device=dev)
        _, mprob, amax = kernel_ops.deferral_signal(apply_fn(params, xb))
        preds.append(amax.cpu().numpy())
        confs.append(mprob.cpu().numpy())
    preds = np.concatenate(preds)
    confs = np.concatenate(confs)
    return preds, confs, (preds == np.asarray(y)).astype(np.float64)
