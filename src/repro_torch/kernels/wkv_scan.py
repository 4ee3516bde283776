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

  * `wkv_scan` — the CUDA kernels of `csrc/wkv_scan.cu` on CUDA tensors,
    the plain version on CPU tensors; K <= 512, any V; `out` takes the
    final state in place. T alone picks the kernel: T < CHUNKED_MIN_T
    (decode, T = 1, and short segments) runs the per-token kernel (one CTA
    per stream and block of 32 value columns streams its slice of the
    state as 16-byte vectors and walks the tokens with it in registers),
    longer T (prefill) the chunk-parallel kernels (chunk
    states, their carry, then the outputs, with the matrix products on
    the tensor cores as three-product TF32 splits), over a workspace this
    wrapper allocates.
  * `wkv_scan_path` — either of those paths at any T, CUDA only: the two
    are timed and checked side by side with it.
  * `wkv_scan_plain` — the JAX package's own algorithms, chosen by the
    JAX RWKV block's rule: `linear_attention_chunked` when `chunk` divides
    T, else `linear_attention_scan`.
  * `wkv_scan_fused` — the recurrence under autograd (training): its
    forward is `wkv_scan` (the kernel, on CUDA tensors), and its backward
    recomputes `wkv_scan_plain` by the JAX block's chunk rule and
    differentiates that. The JAX package has no backward kernel for
    `wkv_scan` (its models differentiate the XLA recurrence), so that
    recompute is the only plain use of the recurrence on the card. On
    CPU tensors it is `wkv_scan_plain` under ordinary autograd.

The wrapper takes the plain version only for CPU tensors; for a CUDA
tensor it launches a kernel or raises, on any shape it refuses too.
`wkv_scan.launches` counts calls that launched (never plain calls), one
per call whichever path ran; `wkv_scan.launches_chunked` counts those that
took the chunked path (the rest took the per-token kernel). A
`wkv_scan_fused` call counts once there, for its forward (a remat
recompute of the layer launches, and counts, again).
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build

MAX_K = 512            # largest K the kernel takes (any V)
CHUNKED_MIN_T = 48     # T from which wkv_scan takes the chunked kernels
                       # (csrc kChunkedMinT: the two paths meet near it)
CHUNK, SUB_CHUNK = 64, 16   # the chunked kernels' tokens per chunk and
                            # per diagonal block (csrc/wkv_scan.cu)
MODES = ("rwkv", "mamba")


# ---------------------------------------------------------------------------
# Plain versions: the JAX package's linear-attention core
# ---------------------------------------------------------------------------

def _wide(t: torch.Tensor) -> torch.Tensor:
    """fp32, as the JAX package computes the recurrence, or float64 kept
    as it is (gradient checks in float64)."""
    return t if t.dtype == torch.float64 else t.float()


def _expand(cum: torch.Tensor, K: int) -> torch.Tensor:
    """Broadcast a [..., Kw] decay (Kw in {1, K}) to [..., K]."""
    if cum.shape[-1] == 1:
        return cum.expand(*cum.shape[:-1], K)
    return cum


def linear_attention_scan(q, k, v, logw, state0, *, mode="mamba", u=None):
    """Naive per-step scan, the oracle. q, k [B,T,H,K]; v [B,T,H,V]; logw
    broadcastable to [B,T,H,K]; state0 [B,H,K,V]. Returns fp32 (y
    [B,T,H,V], state [B,H,K,V]); float64 for float64 inputs."""
    B, T, H, K = q.shape
    logw = _wide(torch.broadcast_to(logw, (B, T, H, K)))
    q, k, v = _wide(q), _wide(k), _wide(v)
    S = _wide(state0)
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
    cum_s) with t >= s: nothing is exponentiated positively. The pairs
    the causal mask drops (t < s, whose differences are positive) take
    exp(-inf) = 0 where JAX's takes exp of the difference and selects 0:
    the same values, but JAX's gradient there is 0 * inf = NaN once a
    chunk's decays sum past fp32's exp range (about 88 nats), as
    rwkv6-3b's strongest channels do at full width; this one's is 0."""
    B, T, H, K = q.shape
    V = v.shape[-1]
    assert T % chunk == 0, (T, chunk)
    NC, c = T // chunk, chunk
    scalar_decay = logw.shape[-1] == 1

    def reshape(x):                      # [NC, B, c, H, *]
        return _wide(x).reshape(B, NC, c, H, x.shape[-1]).transpose(0, 1)

    qc, kc, vc = reshape(q), reshape(k), reshape(v)
    lw = reshape(torch.broadcast_to(logw, (B, T, H, logw.shape[-1])))
    ones = torch.ones((c, c), dtype=torch.bool, device=q.device)
    tri = torch.tril(ones) if mode == "mamba" else torch.tril(ones, -1)
    neg = float("-inf")
    S = _wide(state0)
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
            amat = torch.exp(torch.where(tri[None, :, :, None], diff, neg))
            scores = torch.einsum("bthk,bshk->btsh", qt, kt) * amat
        else:                                          # A [B, c, c, H, K]
            diff = out_cum[:, :, None] - cum[:, None]
            amat = torch.exp(torch.where(tri[None, :, :, None, None], diff,
                                         neg))
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
    uf = _wide(u) if mode == "rwkv" else None
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
    lib.wkv_scan.argtypes = [vp] * 10 + [ci] * 7 + [vp]
    lib.wkv_scan.restype = ci
    lib.wkv_scan_path.argtypes = [vp] * 10 + [ci] * 8 + [vp]
    lib.wkv_scan_path.restype = ci
    return lib


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def _fp32(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.float32).contiguous()


def _kernel_args(q, k, v, logw, u, state0, mode, out):
    """Checks a CUDA call's shapes; returns the kernels' fp32 contiguous
    operands (q, k, v, logw, u or None, s0, y, out) and (B, T, H, K, V,
    scalar decay, rwkv)."""
    _require(mode in MODES, f"mode must be one of {MODES}, got {mode!r}")
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
    if out is None:
        out = torch.empty((B, H, K, V), dtype=torch.float32, device=dev)
    _require(out.shape == (B, H, K, V) and out.dtype == torch.float32
             and out.is_contiguous() and out.device == dev,
             "out must be a contiguous fp32 [B,H,K,V] tensor on q's device")
    y = torch.empty((B, T, H, V), dtype=torch.float32, device=dev)
    ops = (_fp32(q), _fp32(k), _fp32(v),
           _fp32(logw.expand(B, T, H, 1 if scalar else K)),
           _fp32(u) if rwkv else None, _fp32(state0), y, out)
    return ops, (B, T, H, K, V, int(scalar), int(rwkv))


def _workspace(dims, device):
    """The chunked path's workspace: each chunk's state (then its starting
    state) [B,H,NC,K,V] and in-chunk decay sums [B,H,NC,CHUNK,Kw]."""
    B, T, H, K, V, scalar, _ = dims
    nc = -(-T // CHUNK)
    return (torch.empty((B, H, nc, K, V), dtype=torch.float32, device=device),
            torch.empty((B, H, nc, CHUNK, 1 if scalar else K),
                        dtype=torch.float32, device=device))


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _raise_on(err: int, name: str) -> None:
    if err:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")


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
    ops, dims = _kernel_args(q, k, v, logw, u, state0, mode, out)
    chunked = dims[1] >= CHUNKED_MIN_T
    ws, wc = _workspace(dims, q.device) if chunked else (None, None)
    *ins, y, out = ops
    err = _lib().wkv_scan(
        *(_ptr(t) for t in ins), y.data_ptr(), out.data_ptr(), _ptr(ws),
        _ptr(wc), *dims, torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on(err, "wkv_scan")
    _build.count(wkv_scan, launches=1, launches_chunked=chunked)
    return y, out


wkv_scan.launches = 0
wkv_scan.launches_chunked = 0


def wkv_scan_path(q, k, v, logw, u, state0, *, chunked: bool,
                  mode: str = "rwkv", out: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One of `wkv_scan`'s kernel paths, the chunked one or the per-token
    one, at any T, on CUDA tensors only, with `wkv_scan`'s arguments and
    results: the two paths are timed and checked side by side with it.
    Counts its own launches, never `wkv_scan`'s."""
    _require(q.is_cuda, "wkv_scan_path runs on CUDA tensors only")
    ops, dims = _kernel_args(q, k, v, logw, u, state0, mode, out)
    ws, wc = _workspace(dims, q.device) if chunked else (None, None)
    *ins, y, out = ops
    err = _lib().wkv_scan_path(
        *(_ptr(t) for t in ins), y.data_ptr(), out.data_ptr(), _ptr(ws),
        _ptr(wc), *dims, int(chunked),
        torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on(err, "wkv_scan_path")
    _build.count(wkv_scan_path, launches=1)
    return y, out


wkv_scan_path.launches = 0


class _WKVScanFused(torch.autograd.Function):
    """y, S = wkv_scan(...) forward; backward through the plain recurrence
    recomputed from the saved inputs (no backward kernel exists)."""

    @staticmethod
    def forward(ctx, q, k, v, logw, u, state0, mode: str, chunk: int):
        ctx.save_for_backward(q, k, v, logw, u, state0)
        ctx.mode, ctx.chunk = mode, chunk
        return wkv_scan(q, k, v, logw, u, state0, mode=mode)

    @staticmethod
    def backward(ctx, g_y, g_state):
        want = ctx.needs_input_grad[:6]
        with torch.enable_grad():
            ins = [None if t is None else t.detach().requires_grad_(w)
                   for t, w in zip(ctx.saved_tensors, want)]
            outs = wkv_scan_plain(*ins, mode=ctx.mode, chunk=ctx.chunk)
            pairs = [(o, g) for o, g in zip(outs, (g_y, g_state))
                     if o.requires_grad]
            need = [t for t in ins if t is not None and t.requires_grad]
            got = iter(torch.autograd.grad(
                [o for o, _ in pairs], need, [g for _, g in pairs],
                allow_unused=True) if need else ())
        grads = [next(got) if t is not None and t.requires_grad else None
                 for t in ins]
        return (*grads, None, None)


def wkv_scan_fused(q, k, v, logw, u, state0, *, mode: str = "rwkv",
                   chunk: int = 32) -> Tuple[torch.Tensor, torch.Tensor]:
    """`wkv_scan`'s function, differentiable in q, k, v, logw, u and
    state0: the kernel forward on CUDA tensors (saving only the inputs)
    and a backward through `wkv_scan_plain` with `chunk` (the block's:
    32 for RWKV6, 64 for Mamba2) recomputed; on CPU tensors
    `wkv_scan_plain` itself. Writes nothing in place. Returns fp32 (y
    [B,T,H,V], final state [B,H,K,V])."""
    _require(mode in MODES, f"mode must be one of {MODES}, got {mode!r}")
    if not q.is_cuda:
        return wkv_scan_plain(q, k, v, logw, u, state0, mode=mode,
                              chunk=chunk)
    return _WKVScanFused.apply(q, k, v, logw, u, state0, mode, chunk)
