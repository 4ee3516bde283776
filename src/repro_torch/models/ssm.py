"""Attention-free sequence mixers: the RWKV6 ("Finch") block, the Mamba2
(SSD) block, and their states.

Counterpart of `repro.models.ssm`. Both blocks are a linear recurrence
over a per-head fp32 state S in R^{K x V},

    S_t = diag(w_t) S_{t-1} + k_t v_t^T
    RWKV6:  y_t = r_t^T (S_{t-1} + diag(u) k_t v_t^T), per-channel decay w_t
    Mamba2: y_t = C_t^T S_t, a scalar decay per head, B_t / C_t shared by
            the heads

The recurrence is the `wkv_scan` kernel's function; its plain versions
(`linear_attention_scan`, `linear_attention_chunked`,
`linear_attention_step`, the JAX package's linear-attention core) live
beside the kernel in `kernels/wkv_scan.py` and are re-exported here. Each
block's `paged_kernel=True` runs the recurrence through `wkv_scan` (the
CUDA kernel on CUDA tensors), otherwise through `wkv_scan_plain` by the
JAX block's own rule (chunked when the block's chunk, 32 for RWKV6 and 64
for Mamba2, divides T, else the per-step scan). When autograd records
(training), `paged_kernel=True` takes `wkv_scan_fused`: the kernel
forward, and a backward through `wkv_scan_plain` by that same rule.
Without a state nothing is written in place.

RWKV6 types follow the JAX block as JAX's unscanned layer loop runs it
(its scanned loop refuses a bf16 RWKV model): r/k/v/g/logw are fp32 from
the fp32 weights, the time-mix output returns to x's type before its
residual add, the channel-mix residual add promotes x to fp32, and the
shift states come out in the type of the normed input they were taken
from. Mamba2 types follow the JAX block too: the input projection, the
convolution and the recurrence run in fp32 from the fp32 weights, and the
output returns to x's type before its residual add; the convolution's
carry comes out fp32 (the model writes it into its cache's type).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.wkv_scan import (linear_attention_chunked,
                                          linear_attention_scan,
                                          linear_attention_step, wkv_scan,
                                          wkv_scan_fused, wkv_scan_plain)
from repro_torch.models.common import ParamInit, buffer, rms_norm

__all__ = ["Mamba2Config", "RWKVConfig", "init_mamba2_block",
           "init_mamba2_state", "init_rwkv_block", "init_rwkv_state",
           "linear_attention_chunked", "linear_attention_scan",
           "linear_attention_step", "mamba2_block_forward",
           "rwkv_block_forward"]


@dataclasses.dataclass(frozen=True)
class RWKVConfig:
    d_model: int
    d_ff: int
    head_dim: int = 64
    lora_mix: int = 32
    lora_decay: int = 64
    chunk: int = 32

    @property
    def n_heads(self) -> int:
        return self.d_model // self.head_dim


def init_rwkv_block(pi: ParamInit, cfg: RWKVConfig, L: int) -> dict:
    """Seeded weights of `L` stacked RWKV6 blocks, with the JAX package's
    names, shapes, layouts, init rules and logical axes."""
    d, H, hd, r = cfg.d_model, cfg.n_heads, cfg.head_dim, cfg.lora_mix
    LA = ("layers",)
    proj = LA + ("embed", "heads", "head_dim")
    return {
        # data-dependent lerp (ddlerp) mixing: 5 streams (r, k, v, g, w)
        "mu_base": pi.uniform((L, 5, d), 0.5, LA + (None, "act_embed")),
        "mix_A": pi.normal((L, d, 5 * r), fan_in=d, axes=LA + ("embed", None)),
        "mix_B": pi.normal((L, 5, r, d), fan_in=r,
                           axes=LA + (None, None, "embed")),
        "wr": pi.normal((L, d, H, hd), fan_in=d, axes=proj),
        "wk": pi.normal((L, d, H, hd), fan_in=d, axes=proj),
        "wv": pi.normal((L, d, H, hd), fan_in=d, axes=proj),
        "wg": pi.normal((L, d, H, hd), fan_in=d, axes=proj),
        "wo": pi.normal((L, H, hd, d), fan_in=H * hd,
                        axes=LA + ("heads", "head_dim", "embed")),
        # data-dependent decay: logw = -exp(w0 + tanh(x A_w) B_w)
        "w0": pi.full((L, H, hd), -0.6, LA + ("heads", "head_dim")),
        "decay_A": pi.normal((L, d, cfg.lora_decay), fan_in=d,
                             axes=LA + ("embed", None)),
        "decay_B": pi.normal((L, cfg.lora_decay, H, hd),
                             fan_in=cfg.lora_decay,
                             axes=LA + (None, "heads", "head_dim")),
        "u": pi.uniform((L, H, hd), 0.5, LA + ("heads", "head_dim")),
        "ln_x": pi.zeros((L, H, hd), LA + ("heads", "head_dim")),
        # channel mix
        "cm_mu": pi.uniform((L, 2, d), 0.5, LA + (None, "act_embed")),
        "cm_wk": pi.normal((L, d, cfg.d_ff), fan_in=d,
                           axes=LA + ("embed", "ffn")),
        "cm_wr": pi.normal((L, d, d), fan_in=d, axes=LA + ("embed", "embed")),
        "cm_wv": pi.normal((L, cfg.d_ff, d), fan_in=cfg.d_ff,
                           axes=LA + ("ffn", "embed")),
        "norm1": pi.zeros((L, d), LA + ("act_embed",)),
        "norm2": pi.zeros((L, d), LA + ("act_embed",)),
    }


def init_rwkv_state(cfg: RWKVConfig, batch: int, dtype: torch.dtype, L: int,
                    device, abstract: bool = False) -> dict:
    """Zeroed stacked state: shift1, shift2 [L, batch, d] in `dtype`; S
    [L, batch, H, K, V] in fp32 whatever `dtype` is (`abstract`: their
    AbstractParams, with JAX's logical axes)."""
    d, H, hd = cfg.d_model, cfg.n_heads, cfg.head_dim
    kw = dict(dtype=dtype, device=device)
    shift = ("layers", "batch", "act_embed")
    return {"shift1": buffer((L, batch, d), shift, abstract, **kw),
            "shift2": buffer((L, batch, d), shift, abstract, **kw),
            "S": buffer((L, batch, H, hd, hd),
                        ("layers", "batch", "heads", "head_dim", "state"),
                        abstract, dtype=torch.float32, device=device)}


def _mm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x [..., n] @ w [n, ...] -> [..., *w.shape[1:]] in the promoted type
    of the two, as `jnp.einsum` computes it."""
    dt = torch.promote_types(x.dtype, w.dtype)
    out = x.to(dt) @ w.to(dt).reshape(w.shape[0], -1)
    return out.reshape(*x.shape[:-1], *w.shape[1:])


def _recording(*tensors: Optional[torch.Tensor]) -> bool:
    """Autograd records an op on these inputs."""
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


def _recurrence(q, k, v, logw, u, S0, mode: str, chunk: int,
                paged_kernel: bool, out: Optional[torch.Tensor]):
    """A block's recurrence: `wkv_scan_fused` when `paged_kernel` and
    autograd records, else `wkv_scan` (`paged_kernel`) or
    `wkv_scan_plain` with the block's chunk; `out` takes the final
    state in place (a carried state's "S")."""
    if paged_kernel and _recording(q, k, v, logw, u, S0):
        if out is not None:
            raise ValueError("a recorded recurrence writes no state in "
                             "place: train without a cache")
        return wkv_scan_fused(q, k, v, logw, u, S0, mode=mode, chunk=chunk)
    if paged_kernel:
        return wkv_scan(q, k, v, logw, u, S0, mode=mode, out=out)
    return wkv_scan_plain(q, k, v, logw, u, S0, mode=mode, chunk=chunk,
                          out=out)


def _token_shift(x: torch.Tensor, last: torch.Tensor) -> torch.Tensor:
    """shifted[t] = x[t-1]; shifted[0] = last (carry from the previous
    segment)."""
    return torch.cat([last[:, None, :], x[:, :-1, :]], dim=1)


def _rwkv_mix_streams(p: dict, x: torch.Tensor,
                      shifted: torch.Tensor) -> torch.Tensor:
    """ddlerp: per-stream mixing coefficients with a low-rank data path.
    Returns [B, T, 5, d]."""
    r = p["mix_B"].shape[1]
    base = torch.tanh(_mm(x, p["mix_A"]))                       # [B,T,5r]
    base = base.reshape(*base.shape[:-1], 5, r)
    dt = torch.promote_types(base.dtype, p["mix_B"].dtype)
    delta = torch.einsum("btsr,srd->btsd", base.to(dt), p["mix_B"].to(dt))
    mu = p["mu_base"][None, None] + delta                       # [B,T,5,d]
    xx = shifted - x
    return x[:, :, None, :] + xx[:, :, None, :] * torch.sigmoid(mu)


def _rwkv_time_mix_inputs(p: dict, cfg: RWKVConfig, x: torch.Tensor,
                          shifted: torch.Tensor):
    """(r, k, v, g [B,T,H,hd], logw [B,T,H,hd] fp32 and < 0)."""
    mixed = _rwkv_mix_streams(p, x, shifted)
    xr, xk, xv, xg, xw = (mixed[:, :, i, :] for i in range(5))
    rr = _mm(xr, p["wr"])
    kk = _mm(xk, p["wk"])
    vv = _mm(xv, p["wv"])
    gg = F.silu(_mm(xg, p["wg"]))
    dec = _mm(torch.tanh(_mm(xw, p["decay_A"])), p["decay_B"])
    logw = -torch.exp(p["w0"][None, None].float() + dec.float())
    return rr, kk, vv, gg, logw


def rwkv_block_forward(p: dict, cfg: RWKVConfig, x: torch.Tensor,
                       state: Optional[dict] = None,
                       paged_kernel: bool = False
                       ) -> Tuple[torch.Tensor, dict]:
    """Full-sequence RWKV6 block (time mix, then channel mix), pre-norm
    residual. `state` ({"shift1", "shift2" [B, d], "S" [B, H, K, V] fp32})
    carries a previous segment; its "S" receives the final state in
    place. `paged_kernel` runs the recurrence through `wkv_scan` (through
    `wkv_scan_fused` when autograd records). Returns (x, {"shift1",
    "shift2", "S"})."""
    B, T, d = x.shape
    H, hd = cfg.n_heads, cfg.head_dim
    h = rms_norm(x, p["norm1"])
    last1 = (state["shift1"] if state is not None
             else torch.zeros((B, d), dtype=x.dtype, device=x.device))
    shifted = _token_shift(h, last1.to(h.dtype))
    rr, kk, vv, gg, logw = _rwkv_time_mix_inputs(p, cfg, h, shifted)
    if state is not None:
        S0 = out = state["S"]
    else:
        S0 = torch.zeros((B, H, hd, hd), dtype=torch.float32, device=x.device)
        out = None
    y, S = _recurrence(rr, kk, vv, logw, p["u"], S0, "rwkv", cfg.chunk,
                       paged_kernel, out)
    # per-head group norm, gate, project out
    y = rms_norm(y.to(x.dtype), p["ln_x"]) * gg
    x = x + _mm(y.reshape(B, T, H * hd).float(),
                p["wo"].float().reshape(H * hd, d)).to(x.dtype)

    # channel mix
    h2 = rms_norm(x, p["norm2"])
    last2 = (state["shift2"] if state is not None
             else torch.zeros((B, d), dtype=x.dtype, device=x.device))
    sh2 = _token_shift(h2, last2.to(h2.dtype))
    mu = torch.sigmoid(p["cm_mu"])
    xk2 = h2 + (sh2 - h2) * mu[0]
    xr2 = h2 + (sh2 - h2) * mu[1]
    kk2 = torch.square(torch.relu(_mm(xk2, p["cm_wk"])))
    vv2 = _mm(kk2.float(), p["cm_wv"].float()).to(x.dtype)
    x = x + torch.sigmoid(_mm(xr2, p["cm_wr"])) * vv2
    return x, {"shift1": h[:, -1, :], "shift2": h2[:, -1, :], "S": S}


# ---------------------------------------------------------------------------
# Mamba2 (SSD) block
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Mamba2Config:
    d_model: int
    d_state: int = 64
    head_dim: int = 64
    expand: int = 2
    conv_width: int = 4
    chunk: int = 64

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def n_heads(self) -> int:
        return self.d_inner // self.head_dim


def init_mamba2_block(pi: ParamInit, cfg: Mamba2Config, L: int) -> dict:
    """Seeded weights of `L` stacked Mamba2 blocks, with the JAX package's
    names, shapes, init rules and logical axes."""
    d, di, N, H = cfg.d_model, cfg.d_inner, cfg.d_state, cfg.n_heads
    conv_ch = di + 2 * N
    LA = ("layers",)
    return {
        "norm": pi.zeros((L, d), LA + ("act_embed",)),
        "in_proj": pi.normal((L, d, 2 * di + 2 * N + H), fan_in=d,
                             axes=LA + ("embed", "d_inner")),
        "conv_w": pi.normal((L, cfg.conv_width, conv_ch),
                            fan_in=cfg.conv_width,
                            axes=LA + ("conv", "d_inner")),
        "conv_b": pi.zeros((L, conv_ch), LA + ("d_inner",)),
        "A_log": pi.full((L, H), 0.0, LA + ("heads",)),
        "dt_bias": pi.full((L, H), -1.0, LA + ("heads",)),
        "D": pi.full((L, H), 1.0, LA + ("heads",)),
        "out_norm": pi.zeros((L, di), LA + ("d_inner",)),
        "out_proj": pi.normal((L, di, d), fan_in=di,
                              axes=LA + ("d_inner", "embed")),
    }


def init_mamba2_state(cfg: Mamba2Config, batch: int, dtype: torch.dtype,
                      L: int, device, abstract: bool = False) -> dict:
    """Zeroed stacked state: the convolution's history conv [L, batch,
    W-1, d_inner + 2 d_state] in `dtype`; S [L, batch, H, d_state,
    head_dim] in fp32 whatever `dtype` is (`abstract`: their
    AbstractParams, with JAX's logical axes)."""
    C = cfg.d_inner + 2 * cfg.d_state
    return {"conv": buffer((L, batch, cfg.conv_width - 1, C),
                           ("layers", "batch", "conv", "d_inner"), abstract,
                           dtype=dtype, device=device),
            "S": buffer((L, batch, cfg.n_heads, cfg.d_state, cfg.head_dim),
                        ("layers", "batch", "heads", "state", "head_dim"),
                        abstract, dtype=torch.float32, device=device)}


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 carry: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal convolution. x [B,T,C]; w [W,C]; carry [B,W-1,C],
    the inputs before x (zeros without one). Returns (y [B,T,C], the new
    carry: the last W-1 inputs, in x's type)."""
    W = w.shape[0]
    B, T, C = x.shape
    if carry is None:
        carry = torch.zeros((B, W - 1, C), dtype=x.dtype, device=x.device)
    xp = torch.cat([carry.to(x.dtype), x], dim=1)
    y = sum(xp[:, i:i + T, :] * w[i][None, None, :] for i in range(W))
    return y + b[None, None, :], xp[:, -(W - 1):, :]


def mamba2_block_forward(p: dict, cfg: Mamba2Config, x: torch.Tensor,
                         state: Optional[dict] = None,
                         paged_kernel: bool = False
                         ) -> Tuple[torch.Tensor, dict]:
    """Full-sequence Mamba2 block, pre-norm residual. `state` ({"conv"
    [B, W-1, C], "S" [B, H, N, P] fp32}) carries a previous segment; its
    "S" receives the final state in place. `paged_kernel` runs the
    recurrence through `wkv_scan` (mode "mamba": q = C and k = B
    broadcast over the heads, v = x dt, logw = dt A a scalar per head;
    `wkv_scan_fused` when autograd records). Returns (x, {"conv",
    "S"})."""
    B, T, d = x.shape
    di, N, H, P = cfg.d_inner, cfg.d_state, cfg.n_heads, cfg.head_dim
    h = rms_norm(x, p["norm"])
    zxbcdt = _mm(h, p["in_proj"])
    z, xc, Bc, Cc, dt = torch.split(zxbcdt, [di, di, N, N, H], dim=-1)
    conv_in = torch.cat([xc, Bc, Cc], dim=-1)
    conv_out, new_conv = _causal_conv(
        conv_in, p["conv_w"], p["conv_b"],
        state["conv"] if state is not None else None)
    conv_out = F.silu(conv_out)
    xc, Bc, Cc = torch.split(conv_out, [di, N, N], dim=-1)

    dt = F.softplus(dt.float() + p["dt_bias"][None, None].float())
    A = -torch.exp(p["A_log"].float())                    # [H] negative
    logw = (dt * A[None, None, :])[..., None]             # [B,T,H,1]
    xh = xc.reshape(B, T, H, P)
    v = xh * dt[..., None]
    q = Cc[:, :, None, :].expand(B, T, H, N)
    k = Bc[:, :, None, :].expand(B, T, H, N)
    if state is not None:
        S0 = out = state["S"]
    else:
        S0 = torch.zeros((B, H, N, P), dtype=torch.float32, device=x.device)
        out = None
    y, S = _recurrence(q, k, v, logw, None, S0, "mamba", cfg.chunk,
                       paged_kernel, out)
    y = y + p["D"][None, None, :, None].float() * xh.float()
    y = y.reshape(B, T, di).to(x.dtype)
    y = rms_norm(y * F.silu(z), p["out_norm"])
    y = _mm(y.float(), p["out_proj"].float()).to(x.dtype)
    return x + y, {"conv": new_conv, "S": S}
