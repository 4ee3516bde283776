"""Fused Gatekeeper-loss statistics: CUDA launch wrapper, plain version,
and the loss as an autograd function.

Counterpart of `repro.kernels.gatekeeper_loss.gatekeeper_loss_tokens`
(Pallas, TPU) and of `repro.kernels.ops.gatekeeper_loss_fused`. The
kernel is CUDA C++ for Hopper in `csrc/gatekeeper_loss.cu`; its source
note says what bounds it and what its design does about that.

  * `gatekeeper_loss_tokens` — per token (ce, kl, correct, entropy) of
    the logits ``x @ table.T`` in one streaming pass over the
    vocabulary, without the [T, V] logits in memory; x is taken in its
    own type (fp32, or bf16, which the kernel reads as it is and
    multiplies in two TF32 products instead of three), the table in fp32
    (cast if it comes as bf16), targets int32. The argmax keeps the first
    index of the maximum.
  * `gatekeeper_loss_fused` — the scalar loss alpha*L_corr +
    (1-alpha)*L_incorr over valid tokens and the per-token aux of
    `repro.kernels.ops.gatekeeper_loss_fused`, differentiable in x and
    the table. Its backward is plain PyTorch, as the JAX trainer's is XLA:
    it recomputes the logits one vocabulary chunk at a time with
    `torch.matmul` (no [T, V] buffer) and launches no kernel.

The wrapper takes the plain version only for CPU tensors; for a CUDA
tensor it launches the kernel or raises. `gatekeeper_loss_tokens.launches`
counts kernel launches (never plain calls).
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import torch

from repro_torch.kernels import _build

_VB = 128                     # vocabulary columns per tile of the kernel
_CTA_START = 0.5              # a CTA's start and end, in tiles of work
BACKWARD_CHUNK = 8192         # vocabulary columns per backward chunk


def gatekeeper_loss_tokens_plain(x: torch.Tensor, table: torch.Tensor,
                                 targets: torch.Tensor, *,
                                 return_lse: bool = False):
    """The kernel's function from full fp32 logits, as
    `repro.kernels.ref.gatekeeper_loss_ref` computes it."""
    logits = x.float() @ table.float().t()
    lse = torch.logsumexp(logits, dim=-1)
    logp = logits - lse[:, None]
    tgt = targets.long()
    ce = -logp.gather(1, tgt[:, None])[:, 0]
    ent = -(torch.exp(logp) * logp).sum(-1)
    kl = math.log(float(table.shape[0])) - ent
    correct = (logits.argmax(-1) == tgt).float()
    out = (ce, kl, correct, ent)
    return out + (lse,) if return_lse else out


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("gatekeeper_loss")
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.gatekeeper_loss_tokens.argtypes = ([vp, ci] + [vp] * 8 + [ci] * 6
                                           + [vp])
    lib.gatekeeper_loss_tokens.restype = ci
    return lib


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def token_tile(T: int) -> int:
    """Tokens per CTA: 128 (the warpgroup kernel), or 32 / 64 for T <= 32
    / 64 (the mma.sync kernel), so that few rows (the VLM's 24 loss rows)
    are not mostly padding."""
    return 32 if T <= 32 else 64 if T <= 64 else 128


@functools.lru_cache(maxsize=256)
def vocab_split(T: int, V: int, n_sms: int):
    """(tiles per split, splits), each split a whole number of 128-column
    tiles: the split that finishes first when every CTA slot (one an SM at
    128 tokens a CTA, else two) takes waves of (token block, split) CTAs,
    a CTA costing its tiles plus `_CTA_START`; of equal costs the fewest
    CTAs."""
    n_tiles = -(-V // _VB)
    bm = token_tile(T)
    slots = n_sms * (1 if bm == 128 else 2)
    n_blocks = -(-T // bm)
    best = None
    for per in range(1, n_tiles + 1):
        n = -(-n_tiles // per)
        cost = -(-n_blocks * n // slots) * (per + _CTA_START)
        if best is None or cost <= best[0]:
            best = (cost, per, n)
    return best[1], best[2]


def _aligned(t: torch.Tensor, n_bytes: int) -> torch.Tensor:
    """t, or a copy of it if its data does not start n_bytes-aligned."""
    return t if t.data_ptr() % n_bytes == 0 else t.clone()


def gatekeeper_loss_tokens(x: torch.Tensor, table: torch.Tensor,
                           targets: torch.Tensor, *,
                           return_lse: bool = False):
    """x [T, d] fp32 or bf16 (read in its own type), table [V, d] fp32 or
    bf16 (computed in fp32), targets [T] int32. Returns fp32 (ce, kl,
    correct, entropy) [T] each, and the log-sum-exp [T] with
    `return_lse`."""
    if not x.is_cuda:
        return gatekeeper_loss_tokens_plain(x, table, targets,
                                            return_lse=return_lse)
    _require(x.dim() == 2 and table.dim() == 2 and x.shape[1] == table.shape[1],
             f"x must be [T, d] and table [V, d]; got {tuple(x.shape)} and "
             f"{tuple(table.shape)}")
    T, d = x.shape
    V = table.shape[0]
    _require(T > 0 and V > 0, "empty x or table")
    _require(d % 4 == 0, f"d={d}: the kernel copies 4 elements at a time")
    for name, t in (("x", x), ("table", table)):
        _require(t.device == x.device, f"{name} must be on {x.device}")
        _require(t.dtype in (torch.float32, torch.bfloat16),
                 f"{name} must be fp32 or bf16")
    _require(targets.device == x.device and targets.dtype == torch.int32
             and targets.shape == (T,) and targets.is_contiguous(),
             f"targets must be a contiguous int32 [T={T}] on {x.device}")
    _require(V * d < 2 ** 31, "table too large for int32 offsets")
    x_bf16 = x.dtype == torch.bfloat16
    xk = _aligned(x.contiguous(), 8 if x_bf16 else 16)
    tbl = _aligned(table.float().contiguous(), 16)
    bm = token_tile(T)
    per, n_splits = vocab_split(T, V, _build.sm_count(x.device.index))
    outs = torch.empty((5, T), dtype=torch.float32, device=x.device)
    scratch = torch.empty((5, T, n_splits), dtype=torch.float32,
                          device=x.device)
    err = _lib().gatekeeper_loss_tokens(
        xk.data_ptr(), int(x_bf16), tbl.data_ptr(), targets.data_ptr(),
        *(outs[i].data_ptr() for i in range(5)), scratch.data_ptr(),
        T, V, d, bm, per, n_splits,
        torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"gatekeeper_loss_tokens launch failed: CUDA "
                           f"error {err}")
    _build.count(gatekeeper_loss_tokens, launches=1)
    ce, kl, corr, ent, lse = outs
    return (ce, kl, corr, ent, lse) if return_lse else (ce, kl, corr, ent)


gatekeeper_loss_tokens.launches = 0


class _GatekeeperLoss(torch.autograd.Function):
    """loss = alpha*L_corr + (1-alpha)*L_incorr from the fused statistics;
    the per-token outputs carry no gradient."""

    @staticmethod
    def forward(ctx, x, table, targets, valid, alpha: float):
        ce, kl, corr, ent, lse = gatekeeper_loss_tokens(
            x, table, targets, return_lse=True)
        denom = torch.clamp(valid.sum(), min=1.0)
        l_corr = (ce * corr * valid).sum() / denom
        l_incorr = (kl * (1 - corr) * valid).sum() / denom
        loss = alpha * l_corr + (1 - alpha) * l_incorr
        ctx.save_for_backward(x, table, targets, valid, corr, ent, lse, denom)
        ctx.alpha = alpha
        ctx.mark_non_differentiable(ce, kl, corr, ent, l_corr, l_incorr)
        return loss, ce, kl, corr, ent, l_corr, l_incorr

    @staticmethod
    def backward(ctx, g_loss, *_):
        x, table, targets, valid, corr, ent, lse, denom = ctx.saved_tensors
        a = ctx.alpha
        g_ce = g_loss * a * corr * valid / denom
        g_kl = g_loss * (1 - a) * (1 - corr) * valid / denom
        x32 = x.float()
        tgt = targets.long()
        rows = torch.arange(x.shape[0], device=x.device)
        want_x, want_t = ctx.needs_input_grad[0], ctx.needs_input_grad[1]
        dx = torch.zeros_like(x32) if want_x else None
        dtable = torch.empty_like(table) if want_t else None
        V = table.shape[0]
        for c0 in range(0, V, BACKWARD_CHUNK):
            c1 = min(V, c0 + BACKWARD_CHUNK)
            tb = table[c0:c1].float()
            zc = x32 @ tb.t() - lse[:, None]             # log p
            p = torch.exp(zc)
            # d ce/dz = p - onehot; d kl/dz = p * (log p + H)
            dz = p * (g_ce[:, None] + g_kl[:, None] * (zc + ent[:, None]))
            hit = (tgt >= c0) & (tgt < c1)
            dz[rows[hit], tgt[hit] - c0] -= g_ce[hit]
            if want_x:
                dx += dz @ tb
            if want_t:
                dtable[c0:c1] = (dz.t() @ x32).to(table.dtype)
        return (dx.to(x.dtype) if want_x else None, dtable, None, None, None)


def gatekeeper_loss_fused(x: torch.Tensor, table: torch.Tensor,
                          targets: torch.Tensor,
                          valid: Optional[torch.Tensor] = None, *,
                          alpha: float = 0.5):
    """Scalar Gatekeeper loss and per-token aux from final hidden states:
    x [T, d], table [V, d], targets [T], valid [T] in {0, 1} (None: all).
    Returns (loss, {"ce", "kl", "correct", "entropy", "l_corr",
    "l_incorr"}); the loss is differentiable in x and the table."""
    targets = targets.to(torch.int32).contiguous()
    v = (torch.ones(x.shape[0], dtype=torch.float32, device=x.device)
         if valid is None else valid.float())
    loss, ce, kl, corr, ent, l_corr, l_incorr = _GatekeeperLoss.apply(
        x, table, targets, v, float(alpha))
    return loss, {"ce": ce, "kl": kl, "correct": corr, "entropy": ent,
                  "l_corr": l_corr, "l_incorr": l_incorr}
