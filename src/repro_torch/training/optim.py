"""Optimizers over nested-dict parameter trees: AdamW and SGD.

Counterpart of `repro.training.optim`, with JAX's arithmetic: AdamW with
decoupled weight decay added to the update, global-norm clipping with
``+1e-9``, bias-corrected moments kept in fp32 whatever the parameter
type, and constant / cosine / linear schedules with linear warmup.

Unlike JAX, the updates are IN PLACE: `adamw_update` and `sgd_update`
write the new parameters into the given tensors (and the new moments
into the state) under `torch.no_grad()` and return the same trees, so a
full-width step holds one copy of the parameters, not two.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Iterator, NamedTuple, Optional

import torch


class AdamWState(NamedTuple):
    step: torch.Tensor          # int32 scalar, on the parameters' device
    mu: Any
    nu: Any


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.01
    clip_norm: Optional[float] = 1.0
    schedule: str = "cosine"        # constant | cosine | linear
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_ratio: float = 0.1


def tree_leaves(tree: Any) -> Iterator[torch.Tensor]:
    """Leaves of a nested dict in JAX's flatten order (sorted keys)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_leaves(tree[k])
    else:
        yield tree


def tree_map(fn, tree: Any, *rest: Any) -> Any:
    """`fn` over the leaves of nested dicts of one structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def schedule_lr(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Learning rate at `step` (a scalar tensor), fp32."""
    step = torch.as_tensor(step).float()
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    span = max(cfg.total_steps - cfg.warmup_steps, 1)
    frac = torch.clamp((step - cfg.warmup_steps) / span, 0.0, 1.0)
    if cfg.schedule == "constant":
        decay = torch.ones_like(step)
    elif cfg.schedule == "cosine":
        decay = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (
            1 + torch.cos(math.pi * frac))
    elif cfg.schedule == "linear":
        decay = 1.0 - (1 - cfg.min_lr_ratio) * frac
    else:
        raise ValueError(cfg.schedule)
    return cfg.lr * warm * decay


def adamw_init(params: Any) -> AdamWState:
    """Zero fp32 moments over the parameter tree; step 0."""
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,  # noqa: E731
                                  device=p.device)
    dev = next(tree_leaves(params)).device
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=dev),
                      mu=tree_map(zeros, params), nu=tree_map(zeros, params))


def global_norm(tree: Any) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(g.float()))
                          for g in tree_leaves(tree)))


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, grads: Any, state: AdamWState,
                 params: Any):
    """One AdamW step, in place. Returns (params, new state, {"lr",
    "grad_norm"}); `params` and the state's moments are the trees given,
    updated."""
    step = state.step + 1
    lr = schedule_lr(cfg, step)
    gnorm = global_norm(grads)
    scale = (torch.clamp(cfg.clip_norm / (gnorm + 1e-9), max=1.0)
             if cfg.clip_norm is not None else None)
    t = step.float()
    bc1 = 1 - cfg.b1 ** t
    bc2 = 1 - cfg.b2 ** t
    for g, m, v, p in zip(tree_leaves(grads), tree_leaves(state.mu),
                          tree_leaves(state.nu), tree_leaves(params)):
        g32 = g.float()
        if scale is not None:
            g32 = g32 * scale
        m.mul_(cfg.b1).add_((1 - cfg.b1) * g32)
        v.mul_(cfg.b2).add_((1 - cfg.b2) * g32 * g32)
        delta = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
        if cfg.weight_decay:
            delta = delta + cfg.weight_decay * p.float()
        p.copy_((p.float() - lr * delta).to(p.dtype))
    return (params, AdamWState(step, state.mu, state.nu),
            {"lr": lr, "grad_norm": gnorm})


@dataclasses.dataclass(frozen=True)
class SGDConfig:
    lr: float = 0.1
    momentum: float = 0.9
    weight_decay: float = 0.0


def sgd_init(params: Any) -> Any:
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


@torch.no_grad()
def sgd_update(cfg: SGDConfig, grads: Any, vel: Any, params: Any):
    """Heavy-ball SGD with L2 weight decay in the gradient, in place.
    Returns (params, vel), the trees given."""
    for g, v, p in zip(tree_leaves(grads), tree_leaves(vel),
                       tree_leaves(params)):
        g32 = g.float() + cfg.weight_decay * p.float()
        v.mul_(cfg.momentum).add_(g32)
        p.copy_((p.float() - cfg.lr * v).to(p.dtype))
    return params, vel


def value_and_grad(loss_fn, params: Any, *args) -> tuple:
    """((loss, aux), grads) of ``loss_fn(params, *args) -> (loss, aux)``.

    The loss runs on detached aliases of the parameters that require
    grad, so the caller's tensors are neither flagged nor recorded; grads
    have the parameter tree's structure. `aux` comes back detached."""
    flat: Dict[int, torch.Tensor] = {}

    def alias(p):
        a = p.detach().requires_grad_(True)
        flat[len(flat)] = a
        return a
    live = tree_map(alias, params)
    with torch.enable_grad():
        loss, aux = loss_fn(live, *args)
        leaves = list(flat.values())
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    it = iter(g if g is not None else torch.zeros_like(p)
              for g, p in zip(grads, leaves))
    grads_tree = tree_map(lambda _: next(it), params)
    aux = {k: v.detach() for k, v in aux.items()}
    return (loss.detach(), aux), grads_tree
