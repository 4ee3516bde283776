"""Feed-forward blocks: the dense MLP (SwiGLU or GELU) and
Mixture-of-Experts.

Counterpart of `repro.models.ffn`'s dense MLP and single-device MoE path
(`_moe_local_math`): router in fp32, top-k gates renormalised to sum 1,
every assignment computed (no token is dropped), plus the shared experts.
The GELU MLP (whisper's) has biases and takes JAX's default GELU, the
tanh approximation (`jax.nn.gelu(approximate=True)`). The GShard capacity
buffer and the `shard_map` expert-parallel paths are not ported (see
ROADMAP.md).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.common import einsum, swiglu


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    d_model: int
    d_ff: int                      # per-expert hidden dim
    n_experts: int
    top_k: int
    n_shared_experts: int = 0
    shared_d_ff: Optional[int] = None   # defaults to d_ff * n_shared


def mlp_forward(params: dict, x: torch.Tensor,
                activation: str = "swiglu") -> torch.Tensor:
    """x [B, T, d] -> [B, T, d] in x's type. "swiglu": w_gate, w_up,
    w_down; "gelu": w_up, b_up, w_down, b_down, the tanh-approximate GELU
    (JAX's default, which the exact erf GELU misses by up to 5e-4)."""
    if activation == "swiglu":
        h = swiglu(einsum("btd,df->btf", x, params["w_gate"]),
                   einsum("btd,df->btf", x, params["w_up"]))
        return einsum("btf,fd->btd", h, params["w_down"]).to(x.dtype)
    if activation != "gelu":
        raise ValueError(f"activation {activation!r}: swiglu or gelu")
    h = F.gelu(einsum("btd,df->btf", x, params["w_up"]) + params["b_up"],
               approximate="tanh")
    y = einsum("btf,fd->btd", h, params["w_down"]).to(x.dtype)
    return y + params["b_down"].to(y.dtype)


def _route(router_w: torch.Tensor, x2d: torch.Tensor, cfg: MoEConfig):
    """Router in fp32: returns (gates [T,k] fp32 renormalised to sum 1,
    expert_idx [T,k] int64, the switch-style load-balance aux loss,
    assignments per expert [E] int64)."""
    logits = x2d.float() @ router_w.float()
    probs = torch.softmax(logits, dim=-1)
    gates, idx = torch.topk(probs, cfg.top_k, dim=-1)
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    E = cfg.n_experts
    counts = torch.bincount(idx.reshape(-1), minlength=E)
    frac_tokens = counts.float() / torch.clamp(counts.sum().float(), min=1.0)
    aux = E * torch.sum(frac_tokens * probs.mean(dim=0))
    return gates, idx, aux, counts


def _moe_local_math(x2d: torch.Tensor, router_w: torch.Tensor,
                    w_gate: torch.Tensor, w_up: torch.Tensor,
                    w_down: torch.Tensor, cfg: MoEConfig):
    """Every assignment through its expert's SwiGLU, weighted by its gate.
    Assignments are sorted by expert and each expert that received any runs
    once on its contiguous group (the JAX package's sort + `ragged_dot`).
    The per-expert counts cross to the host once per call, to size the
    groups."""
    T, d = x2d.shape
    gates, idx, aux, counts = _route(router_w, x2d, cfg)
    order = torch.argsort(idx.reshape(-1), stable=True)
    tok = torch.div(order, cfg.top_k, rounding_mode="floor")
    xs = x2d[tok]
    counts = counts.tolist()
    out = torch.empty((xs.shape[0], d), dtype=torch.promote_types(
        x2d.dtype, w_down.dtype), device=x2d.device)
    start = 0
    for e, n in enumerate(counts):
        if n:
            seg = xs[start:start + n]
            h = swiglu(einsum("td,df->tf", seg, w_gate[e]),
                       einsum("td,df->tf", seg, w_up[e]))
            out[start:start + n] = einsum("tf,fd->td", h, w_down[e])
            start += n
    weighted = out * gates.reshape(-1)[order][:, None].to(out.dtype)
    y = torch.zeros((T, d), dtype=out.dtype, device=x2d.device)
    y.index_add_(0, tok, weighted)
    return y.to(x2d.dtype), aux


def moe_forward(params: dict, cfg: MoEConfig, x: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """MoE block. x [B, T, d] -> (y, aux_loss): routed experts plus the
    shared experts' dense SwiGLU."""
    B, T, d = x.shape
    shared_y = 0.0
    if cfg.n_shared_experts > 0:
        shared_y = mlp_forward(params["shared"], x)
    y, aux = _moe_local_math(x.reshape(B * T, d), params["router"],
                             params["w_gate"], params["w_up"],
                             params["w_down"], cfg)
    return shared_y + y.reshape(B, T, d), aux
