"""Feed-forward block: the dense SwiGLU MLP.

Counterpart of `repro.models.ffn.mlp_forward` for ``activation="swiglu"``
(the GELU MLP and Mixture-of-Experts are not ported; see ROADMAP.md).
"""
from __future__ import annotations

import torch

from repro_torch.models.common import einsum, swiglu


def mlp_forward(params: dict, x: torch.Tensor) -> torch.Tensor:
    h = swiglu(einsum("btd,df->btf", x, params["w_gate"]),
               einsum("btd,df->btf", x, params["w_up"]))
    return einsum("btf,fd->btd", h, params["w_down"]).to(x.dtype)
