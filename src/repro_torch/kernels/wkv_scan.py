"""Linear recurrence (RWKV6 WKV / Mamba2 SSD): CUDA launch wrapper and the
plain versions.

Counterpart of `repro.kernels.wkv_scan.wkv_scan` (Pallas, TPU) and of the
linear-attention core of `repro.models.ssm` (`linear_attention_scan`,
`linear_attention_chunked`, `_expand`, `linear_attention_step`), which are
the kernel's plain versions and live here beside it; `models.ssm`
re-exports them. Per (batch, head) stream, with an fp32 [K, V] state:

    S_t = diag(w_t) S_{t-1} + k_t v_t^T,   w_t = exp(logw_t), logw_t <= 0
    mode="rwkv":  y_t = q_t^T (S_{t-1} + diag(u) k_t v_t^T)   (RWKV6)
    mode="mamba": y_t = q_t^T S_t                              (Mamba2 / SSD)

  * `wkv_scan` — the CUDA kernel `csrc/wkv_scan.cu` on CUDA tensors (one
    CTA per stream and block of value columns walks the tokens in order
    with the state on chip; K <= 512, any V), the plain version on CPU
    tensors. `out` takes the final state in place.
  * `wkv_scan_plain` — the JAX package's own algorithms, chosen by the
    JAX RWKV block's rule: `linear_attention_chunked` when `chunk` divides
    T, else `linear_attention_scan`.

The wrapper takes the plain version only for CPU tensors; for a CUDA
tensor it launches the kernel or raises, on any shape it refuses too.
`wkv_scan.launches` counts kernel launches (never plain calls).
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build

MAX_K = 512            # largest K the kernel takes (any V)
MODES = ("rwkv", "mamba")


# ---------------------------------------------------------------------------
# Plain versions: the JAX package's linear-attention core
# ---------------------------------------------------------------------------

def _expand(cum: torch.Tensor, K: int) -> torch.Tensor:
    """Broadcast a [..., Kw] decay (Kw in {1, K}) to [..., K]."""
    if cum.shape[-1] == 1:
        return cum.expand(*cum.shape[:-1], K)
    return cum


def linear_attention_scan(q, k, v, logw, state0, *, mode="mamba", u=None):
    """Naive per-step scan, the oracle. q, k [B,T,H,K]; v [B,T,H,V]; logw
    broadcastable to [B,T,H,K]; state0 [B,H,K,V]. Returns fp32 (y
    [B,T,H,V], state [B,H,K,V])."""
    B, T, H, K = q.shape
    logw = torch.broadcast_to(logw, (B, T, H, K)).float()
    q, k, v = q.float(), k.float(), v.float()
    S = state0.float()
    ys = []
    for t in range(T):
        qt, kt, vt = q[:, t], k[:, t], v[:, t]
        w = torch.exp(logw[:, t])
        kv = kt[..., :, None] * vt[..., None, :]
        if mode == "mamba":
            S = w[..., None] * S + kv
            y = torch.einsum("bhk,bhkv->bhv", qt, S)
        else:
            Su = S + u[None, :, :, None] * kv
            y = torch.einsum("bhk,bhkv->bhv", qt, Su)
            S = w[..., None] * S + kv
        ys.append(y)
    return torch.stack(ys, dim=1), S


def linear_attention_chunked(q, k, v, logw, state0, *, mode="mamba", u=None,
                             chunk: int = 64):
    """Chunk-parallel evaluation of the same recurrence (shapes as in
    `linear_attention_scan`; logw [B,T,H,1] scalar or [B,T,H,K] per-channel
    decay). T must be divisible by `chunk`. Every decay is exp(cum_t -
    cum_s) with t >= s: nothing is exponentiated positively."""
    B, T, H, K = q.shape
    V = v.shape[-1]
    assert T % chunk == 0, (T, chunk)
    NC, c = T // chunk, chunk
    scalar_decay = logw.shape[-1] == 1

    def reshape(x):                      # [NC, B, c, H, *]
        return x.float().reshape(B, NC, c, H, x.shape[-1]).transpose(0, 1)

    qc, kc, vc = reshape(q), reshape(k), reshape(v)
    lw = reshape(torch.broadcast_to(logw, (B, T, H, logw.shape[-1])))
    ones = torch.ones((c, c), dtype=torch.bool, device=q.device)
    tri = torch.tril(ones) if mode == "mamba" else torch.tril(ones, -1)
    S = state0.float()
    ys = []
    for i in range(NC):
        qt, kt, vt, lwt = qc[i], kc[i], vc[i], lw[i]   # [B, c, H, *]
        cum = torch.cumsum(lwt, dim=1)                 # inclusive
        last = cum[:, -1:]                             # [B, 1, H, Kw]
        out_cum = cum if mode == "mamba" else cum - lwt
        # inter-chunk: q decayed from the chunk start against the state
        y = torch.einsum("bthk,bhkv->bthv",
                         qt * torch.exp(_expand(out_cum, K)), S)
        if scalar_decay:                               # A [B, c, c, H]
            diff = out_cum[:, :, None, :, 0] - cum[:, None, :, :, 0]
            amat = torch.where(tri[None, :, :, None], torch.exp(diff), 0.0)
            scores = torch.einsum("bthk,bshk->btsh", qt, kt) * amat
        else:                                          # A [B, c, c, H, K]
            diff = out_cum[:, :, None] - cum[:, None]
            amat = torch.where(tri[None, :, :, None, None], torch.exp(diff),
                               0.0)
            scores = (qt[:, :, None] * kt[:, None] * amat).sum(-1)
        y = y + torch.einsum("btsh,bshv->bthv", scores, vt)
        if mode == "rwkv":
            y = y + (qt * u[None, None] * kt).sum(-1, keepdim=True) * vt
        # S' = exp(cum_last) S + sum_s exp(cum_last - cum_s) k_s v_s^T
        kdec = kt * torch.exp(_expand(last - cum, K))
        S = (torch.exp(_expand(last, K))[:, 0, :, :, None] * S
             + torch.einsum("bshk,bshv->bhkv", kdec, vt))
        ys.append(y)
    return torch.stack(ys, dim=1).reshape(B, T, H, V), S


def linear_attention_step(qt, kt, vt, logw_t, S, *, mode="mamba", u=None):
    """One decode step. qt, kt [B,H,K]; vt [B,H,V]; logw_t [B,H,Kw]; S
    [B,H,K,V] fp32. Returns (y [B,H,V], S')."""
    K = qt.shape[-1]
    w = torch.exp(_expand(logw_t.float(), K))
    kv = kt.float()[..., :, None] * vt.float()[..., None, :]
    if mode == "mamba":
        S = w[..., None] * S + kv
        y = torch.einsum("bhk,bhkv->bhv", qt.float(), S)
    else:
        Su = S + u[None, :, :, None] * kv
        y = torch.einsum("bhk,bhkv->bhv", qt.float(), Su)
        S = w[..., None] * S + kv
    return y, S


def wkv_scan_plain(q, k, v, logw, u, state0, *, mode: str = "rwkv",
                   chunk: int = 32, out: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's function by the JAX RWKV block's rule: chunked when
    `chunk` divides T, else the per-step scan. `u` is ignored for
    mode="mamba"; `out` receives the final state in place."""
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    uf = u.float() if mode == "rwkv" else None
    if q.shape[1] % chunk == 0:
        y, S = linear_attention_chunked(q, k, v, logw, state0, mode=mode,
                                        u=uf, chunk=chunk)
    else:
        y, S = linear_attention_scan(q, k, v, logw, state0, mode=mode, u=uf)
    if out is not None:
        S = out.copy_(S)
    return y, S


# ---------------------------------------------------------------------------
# The CUDA kernel
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("wkv_scan")
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.wkv_scan.argtypes = [vp] * 8 + [ci] * 7 + [vp]
    lib.wkv_scan.restype = ci
    return lib


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def _fp32(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.float32).contiguous()


def wkv_scan(q, k, v, logw, u, state0, *, mode: str = "rwkv",
             out: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """q, k [B,T,H,K]; v [B,T,H,V]; logw [B,T,H,K] or [B,T,H,1] (a scalar
    decay per head), or broadcastable to one of them; u [H,K] (ignored
    for mode="mamba"); state0 [B,H,K,V]. Any float input type. Returns
    fp32 (y [B,T,H,V], final state [B,H,K,V]); the state is written into
    `out` when given (fp32, contiguous, [B,H,K,V]; may be `state0`)."""
    _require(mode in MODES, f"mode must be one of {MODES}, got {mode!r}")
    if not q.is_cuda:
        return wkv_scan_plain(q, k, v, logw, u, state0, mode=mode, out=out)
    _require(q.dim() == 4 and k.shape == q.shape,
             f"q, k must be [B,T,H,K], got {tuple(q.shape)}, "
             f"{tuple(k.shape)}")
    B, T, H, K = q.shape
    V = v.shape[-1]
    _require(v.shape == (B, T, H, V), f"v must be [B,T,H,V], got "
                                      f"{tuple(v.shape)}")
    _require(B >= 1 and T >= 1 and H >= 1, f"empty input {tuple(q.shape)}")
    _require(1 <= K <= MAX_K and V >= 1,
             f"the kernel takes K <= {MAX_K}, got K {K}, V {V}")
    _require(logw.dim() == 4 and logw.shape[-1] in (1, K),
             f"logw must be [..., K] or [..., 1], got {tuple(logw.shape)}")
    _require(state0.shape == (B, H, K, V), f"state0 must be [B,H,K,V], got "
                                           f"{tuple(state0.shape)}")
    rwkv = mode == "rwkv"
    if rwkv:
        _require(u is not None and u.shape == (H, K),
                 f"mode 'rwkv' needs u [H,K], got "
                 f"{None if u is None else tuple(u.shape)}")
    dev = q.device
    tensors = [k, v, logw, state0] + ([u] if rwkv else [])
    _require(all(t.device == dev for t in tensors),
             "every input must lie on q's CUDA device")
    scalar = logw.shape[-1] == 1
    qf, kf, vf = _fp32(q), _fp32(k), _fp32(v)
    lw = _fp32(logw.expand(B, T, H, 1 if scalar else K))
    uf = _fp32(u) if rwkv else None
    s0 = _fp32(state0)
    if out is None:
        out = torch.empty((B, H, K, V), dtype=torch.float32, device=dev)
    _require(out.shape == (B, H, K, V) and out.dtype == torch.float32
             and out.is_contiguous() and out.device == dev,
             "out must be a contiguous fp32 [B,H,K,V] tensor on q's device")
    y = torch.empty((B, T, H, V), dtype=torch.float32, device=dev)
    err = _lib().wkv_scan(
        qf.data_ptr(), kf.data_ptr(), vf.data_ptr(), lw.data_ptr(),
        uf.data_ptr() if rwkv else None, s0.data_ptr(), y.data_ptr(),
        out.data_ptr(), B, T, H, K, V, int(scalar), int(rwkv),
        torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"wkv_scan launch failed: CUDA error {err}")
    wkv_scan.launches += 1
    return y, out


wkv_scan.launches = 0
