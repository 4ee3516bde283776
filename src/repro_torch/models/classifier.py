"""Small classifiers for the paper's encoder-only experiments (§4.1).

Counterpart of `repro.models.classifier`. The paper's M_S / M_L are a
CNN / MobileNet and ResNets on images; on the synthetic feature-vector
task (`data.synthetic.make_classification`) they are MLPs of different
capacity. Parameters are a flat dict ``w{i} [a, b]`` / ``b{i} [b]`` in
the JAX layout (``x @ w + b``), so converted JAX weights drop straight
in (`repro_torch.convert.params_from_jax`).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from repro_torch import resolve_device
from repro_torch.models.common import ParamInit


@dataclasses.dataclass(frozen=True)
class MLPClassifierConfig:
    d_in: int
    n_classes: int
    hidden: Tuple[int, ...] = (128, 128)
    dropout: float = 0.0


def init_classifier(cfg: MLPClassifierConfig, seed: int = 0,
                    device=None) -> dict:
    """fp32 weights, normal with std 1/sqrt(fan_in), and zero biases, drawn
    from `seed` on `device` (CUDA unless given)."""
    init = ParamInit(seed, torch.float32, resolve_device(device))
    dims = (cfg.d_in,) + cfg.hidden + (cfg.n_classes,)
    params = {}
    for i, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
        params[f"w{i}"] = init.normal((a, b), fan_in=a, axes=("embed", "ffn"))
        params[f"b{i}"] = init.zeros((b,), ("ffn",))
    return params


def classifier_forward(params: dict, cfg: MLPClassifierConfig,
                       x: torch.Tensor, *,
                       generator: Optional[torch.Generator] = None
                       ) -> torch.Tensor:
    """Logits [N, n_classes] of inputs [N, d_in]. With a `generator` (on
    the inputs' device) and ``cfg.dropout > 0``, each hidden activation is
    kept with probability 1 - dropout and scaled by 1 / (1 - dropout);
    without one there is no dropout, as with ``key=None`` in JAX."""
    n = len(cfg.hidden) + 1
    for i in range(n):
        x = x @ params[f"w{i}"] + params[f"b{i}"]
        if i < n - 1:
            x = torch.relu(x)
            if cfg.dropout > 0 and generator is not None:
                keep = torch.rand(x.shape, generator=generator,
                                  device=x.device) < 1 - cfg.dropout
                x = torch.where(keep, x / (1 - cfg.dropout),
                                torch.zeros_like(x))
    return x


def make_apply(cfg: MLPClassifierConfig):
    """(params, x) -> logits, without dropout."""
    def apply(params, x):
        return classifier_forward(params, cfg, x)
    return apply
