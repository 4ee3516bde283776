"""Flash attention for prefill: CUDA launch wrapper and plain version.

Counterpart of `repro.kernels.flash_attention.flash_attention` (Pallas,
TPU). The kernels are CUDA C++ for Hopper in `csrc/flash_attention.cu`,
one C entry point that picks by the inputs' type, both on the tensor
cores with fp32 accumulation. fp32 inputs, which every main path gives it
(the models' fp32 weights promote the bf16 activations), take each
product as three TF32 products of the operands' high and low halves, and
split the keys over several CTAs where the grid is under one wave
(`kv_split`). bf16 inputs take P @ V as two bf16 products of P's high and
low halves. Its source note says what bounds each and what the design
does about that.

  * `flash_attention` — causal (optionally sliding-window) or non-causal
    GQA attention, q [B,T,H,hd] over k, v [B,S,KV,hd] (kv head = q head
    // (H / KV)), fp32 scores and online softmax, P @ V accumulated in
    fp32; the output has q's type. Query t sits at position
    ``q_offset + t``: key s is visible when s < S and, if causal,
    s <= q_offset + t, and, with ``window`` w > 0, s > q_offset + t - w.
    With q_offset = 0 this is the TPU kernel's function; a prefill chunk
    at absolute offset q_offset over a cache view of S positions passes
    q_offset. Key tiles the mask hides from a whole query tile are
    skipped.
  * `flash_attention_plain` — the same function as
    `repro.kernels.ref.flash_attention_ref` (fp32 scores, probabilities
    and P @ V), with the output in q's type and zeros for a query that
    sees no key (the kernels' contract; the reference never has one).
  * `kv_split` — the fp32 launch's key split: how many CTAs share a
    query tile's keys, where the first starts and how many keys each
    takes; only the keys some query sees are split.

The wrapper takes the plain version only for CPU tensors; for a CUDA
tensor it launches the kernel or raises. `flash_attention.launches`
counts calls that launched (one per call, also where a split call runs a
merge kernel after the split kernel; never plain calls). There is no
backward: the trainer keeps the plain attention of
`models.attention._attend`.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.models.common import make_causal_mask

NEG = -1e30
MAX_HEAD_DIM = 256     # the widest tile the kernel is built for
SMALL_T = 16           # T <= SMALL_T: one warp's 16 queries a CTA, else 64
# CTAs an SM a key split aims for, by CTA: 4 of one warp, 2 of four warps
# (the counts `tools/flash_split_sweep.py` found best on the H100)
SPLIT_CTAS_PER_SM = {True: 4, False: 2}
SPLIT_MIN_BYTES = 1 << 16  # fewest K/V bytes a split reads
SPLIT_ALIGN = 64       # a span is whole key tiles of every tile width
MAX_SPLITS = 64


def visible_mask(T: int, S: int, *, causal: bool = True, window: int = 0,
                 q_offset: int = 0, device=None) -> torch.Tensor:
    """[T, S] bool: True where query t (at position q_offset + t) sees
    key s: `make_causal_mask` when causal, and only keys less than
    `window` positions back."""
    mask = (make_causal_mask(T, S, q_offset, device=device) if causal
            else torch.ones((T, S), dtype=torch.bool, device=device))
    if window:
        mask &= ~make_causal_mask(T, S, q_offset - window, device=device)
    return mask


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True, window: int = 0,
                          scale: Optional[float] = None,
                          q_offset: int = 0) -> torch.Tensor:
    """The kernel's function in one fp32 softmax: q [B,T,H,hd]; k, v
    [B,S,KV,hd]. Returns [B,T,H,hd] in q's type."""
    B, T, H, hd = q.shape
    S, KV = k.shape[1], k.shape[2]
    scale = scale or 1.0 / math.sqrt(hd)
    qg = q.float().reshape(B, T, KV, H // KV, hd)
    scores = torch.einsum("btkgh,bskh->bkgts", qg, k.float()) * scale
    mask = visible_mask(T, S, causal=causal, window=window,
                        q_offset=q_offset, device=q.device)
    probs = torch.softmax(torch.where(mask, scores, NEG), dim=-1)
    probs = torch.where(mask.any(dim=-1)[:, None], probs, 0.0)
    out = torch.einsum("bkgts,bskh->btkgh", probs, v.float())
    return out.reshape(B, T, H, hd).to(q.dtype)


def split_span(n_keys: int, want: int) -> Tuple[int, int]:
    """(span, splits) for n_keys keys cut into about `want` splits: span
    is a multiple of SPLIT_ALIGN, split s takes keys [s * span, (s + 1) *
    span) from the first, and every split starts below n_keys."""
    span = -(-n_keys // max(1, want))
    span = -(-span // SPLIT_ALIGN) * SPLIT_ALIGN
    return span, -(-n_keys // span)


def seen_keys(T: int, S: int, *, causal: bool, window: int,
              q_offset: int) -> Tuple[int, int]:
    """[first, last): the keys some query sees (`visible_mask`'s columns
    with a True), first aligned down to SPLIT_ALIGN; empty when no query
    sees a key."""
    first = max(0, q_offset - window + 1) if window else 0
    last = min(S, q_offset + T) if causal else S
    return first // SPLIT_ALIGN * SPLIT_ALIGN, last


def kv_split(B: int, T: int, S: int, H: int, hd: int, n_sms: int, *,
             causal: bool, window: int,
             q_offset: int) -> Tuple[int, int, int]:
    """(begin, span, splits) of an fp32 launch: split s takes keys [begin +
    s * span, begin + (s + 1) * span). One split, (0, S, 1), when the
    grid's ceil(T / query tile) * H * B CTAs fill the card's n_sms SMs;
    under one wave, the keys some query sees (`seen_keys`: a causal
    chunk's end, a window's start) are cut into enough splits for about
    SPLIT_CTAS_PER_SM CTAs an SM, each reading at least SPLIT_MIN_BYTES of
    K and V (hd fp32 each a key), at most MAX_SPLITS."""
    small = T <= SMALL_T
    ctas = -(-T // (16 if small else 64)) * H * B
    first, last = seen_keys(T, S, causal=causal, window=window,
                            q_offset=q_offset)
    if ctas >= n_sms or last <= first:
        return 0, S, 1
    want = min(-(-SPLIT_CTAS_PER_SM[small] * n_sms // ctas),
               (last - first) // -(-SPLIT_MIN_BYTES // (8 * hd)), MAX_SPLITS)
    span, splits = split_span(last - first, want)
    return (first, span, splits) if splits > 1 else (0, S, 1)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("flash_attention")
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.flash_attention.argtypes = [vp] * 4 + [ci] * 6 + [
        ctypes.c_float] + [ci] * 7 + [vp] * 2
    lib.flash_attention.restype = ci
    return lib


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """`t` contiguous with its data on a 16-byte boundary (the kernel's
    vector loads), copied if it is not."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    scale: Optional[float] = None,
                    q_offset: int = 0) -> torch.Tensor:
    """q [B,T,H,hd]; k, v [B,S,KV,hd], all fp32 or all bf16 (hd <=
    MAX_HEAD_DIM, H a multiple of KV). Returns [B,T,H,hd] in q's type.
    fp32 splits the keys as `kv_split` says; bf16 never splits."""
    if not q.is_cuda:
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     scale=scale, q_offset=q_offset)
    _require(q.dim() == 4 and k.dim() == 4 and v.shape == k.shape,
             f"q must be [B,T,H,hd] and k, v [B,S,KV,hd]; got "
             f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, T, H, hd = q.shape
    S, KV = k.shape[1], k.shape[2]
    _require(k.shape[0] == B and k.shape[3] == hd and KV > 0 and H % KV == 0,
             f"q heads {H}x{hd} do not fit k/v KV={KV} hd={k.shape[3]}")
    _require(1 <= hd <= MAX_HEAD_DIM,
             f"hd={hd}: the kernel takes hd <= {MAX_HEAD_DIM}")
    _require(T > 0 and S > 0, "empty q or k")
    _require(q_offset >= 0 and window >= 0,
             f"q_offset {q_offset} and window {window} must be >= 0")
    for name, t in (("q", q), ("k", k), ("v", v)):
        _require(t.device == q.device, f"{name} must be on {q.device}")
        _require(t.dtype in (torch.float32, torch.bfloat16),
                 f"{name} must be fp32 or bf16")
        _require(t.dtype == q.dtype, "q, k and v must share one type")
    bf16 = q.dtype == torch.bfloat16
    qc, kc, vc = (_aligned(t) for t in (q, k, v))
    scale = scale or 1.0 / math.sqrt(hd)
    begin, span, splits = ((0, S, 1) if bf16 else kv_split(
        B, T, S, H, hd, _build.sm_count(q.device.index), causal=causal,
        window=window, q_offset=q_offset))
    out = torch.empty_like(qc)
    ws = (torch.empty(B * splits * T * H * (hd + 2), dtype=torch.float32,
                      device=q.device) if splits > 1 else None)
    err = _lib().flash_attention(
        qc.data_ptr(), kc.data_ptr(), vc.data_ptr(), out.data_ptr(),
        B, T, S, H, KV, hd, float(scale), int(bool(causal)), int(window),
        int(q_offset), int(bf16), splits, begin, span,
        None if ws is None else ws.data_ptr(),
        torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"flash_attention launch failed: CUDA error {err}")
    _build.count(flash_attention, launches=1)
    return out


flash_attention.launches = 0
