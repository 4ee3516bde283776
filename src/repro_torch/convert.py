"""Carry a JAX parameter tree over to the port.

`params_from_jax` takes the `repro.models.transformer.init_params` tree
with its leaves already turned into numpy arrays (``jax.device_get``) and
returns the same nested dict of torch tensors, leaf by leaf: the stacked
``[L, ...]`` layer axis and the JAX layouts (``wq [L, d, H, hd]``,
``wo [L, H, hd, d]``, ``unembed [V, d]``) are kept as they are. This
module never imports JAX.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch import resolve_device


def _leaf(a: Any, device: torch.device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":       # ml_dtypes bfloat16: reinterpret
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.uint16).copy())
        return t.view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def params_from_jax(tree: Any, device=None) -> Any:
    """Nested dict of numpy arrays -> the same nested dict of tensors."""
    device = resolve_device(device)
    if isinstance(tree, dict):
        return {k: params_from_jax(v, device) for k, v in tree.items()}
    return _leaf(tree, device)
