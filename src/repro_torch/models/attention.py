"""GQA attention with dense and block-paged KV caches.

Counterpart of the GQA half of `repro.models.attention` (MLA, cross- and
sliding-window attention are not ported; see ROADMAP.md). Functions take
ONE layer's parameters; the caller slices the stacked layer axis.

Cache layouts (per layer):
  * dense — [batch, max_len, KV, hd]: writes go to absolute positions,
    reads mask ``idx <= position``.
  * paged — [n_blocks + 1, block_size, KV, hd] plus a page table `pages`
    [B, M] mapping each row's logical block to a physical block (0 is the
    shared trash block). Writes scatter to
    ``(pages[b, pos // block_size], pos % block_size)``.

Unlike the JAX package, caches are updated IN PLACE: the functions write
into the tensors they are given (views of the stacked cache) and return
them, so no copy of a cache leaf is made per step.

Paged decode has two implementations of the same masked softmax: the
plain path (`_paged_write` + `gather_blocks` + `_attend`) and the kernel
path (`kernels.ops.paged_write_token` + `paged_flash_decode_gqa`, CUDA on
the card). `paged_kernel` picks one; None defers to
`kernels.ops.paged_kernel_enabled` (on exactly for CUDA tensors).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple, Union

import torch

from repro_torch.kernels import ops as kernel_ops
from repro_torch.models.common import apply_rope, einsum, make_causal_mask

NEG_INF = -1e30


@dataclasses.dataclass(frozen=True)
class AttnConfig:
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    qkv_bias: bool = False
    rope_theta: float = 10000.0


# ---------------------------------------------------------------------------
# Paged-cache primitives
# ---------------------------------------------------------------------------

def gather_blocks(leaf: torch.Tensor, pages: torch.Tensor) -> torch.Tensor:
    """leaf [n_blocks, block_size, ...], pages [B, M] -> [B, M*block_size,
    ...]: each row's logical sequence, blocks in logical order."""
    B, M = pages.shape
    g = leaf[pages.reshape(-1).long()]
    return g.reshape((B, M * leaf.shape[1]) + tuple(leaf.shape[2:]))


def _paged_write(leaf: torch.Tensor, pages: torch.Tensor, tpos: torch.Tensor,
                 values: torch.Tensor) -> torch.Tensor:
    """Write `values` [B, T, ...] at absolute positions `tpos` ([T] shared
    by all rows, or [B, T]) through the page table, in place. Positions in
    an unmapped block (table entry 0) land in the trash block."""
    bs = leaf.shape[1]
    B, M = pages.shape
    tpos = tpos.long()
    if tpos.dim() == 1:
        tpos = tpos[None, :].expand(B, tpos.shape[0])
    blk_idx = torch.clamp(torch.div(tpos, bs, rounding_mode="floor"), 0, M - 1)
    blk = pages.long().gather(1, blk_idx)
    leaf[blk, torch.remainder(tpos, bs)] = values.to(leaf.dtype)
    return leaf


# ---------------------------------------------------------------------------
# GQA
# ---------------------------------------------------------------------------

def _attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            mask: torch.Tensor, scale: float) -> torch.Tensor:
    """q [B,Tq,H,hd]; k,v [B,Tk,KV,hd]; mask [Tq,Tk] or [B,Tq,Tk] bool.
    Scores and softmax in fp32."""
    B, Tq, H, hd = q.shape
    KV = k.shape[2]
    qg = q.reshape(B, Tq, KV, H // KV, hd)
    scores = torch.einsum("btkgh,bskh->bkgts", qg.float(), k.float()) * scale
    m = mask[None, None, None] if mask.dim() == 2 else mask[:, None, None]
    probs = torch.softmax(torch.where(m, scores, NEG_INF), dim=-1)
    out = torch.einsum("bkgts,bskh->btkgh", probs.to(v.dtype), v)
    return out.reshape(B, Tq, H, v.shape[-1]).to(q.dtype)


def _qkv(params: dict, cfg: AttnConfig, x: torch.Tensor):
    q = einsum("btd,dhk->bthk", x, params["wq"])
    k = einsum("btd,dhk->bthk", x, params["wk"])
    v = einsum("btd,dhk->bthk", x, params["wv"])
    if cfg.qkv_bias:
        q = q + params["bq"]
        k = k + params["bk"]
        v = v + params["bv"]
    return q, k, v


def _out_proj(params: dict, out: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return einsum("bthk,hkd->btd", out, params["wo"]).to(x.dtype)


def gqa_forward(params: dict, cfg: AttnConfig, x: torch.Tensor,
                positions: torch.Tensor, cache: Optional[dict] = None,
                cache_offset: int = 0, pages: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Optional[dict]]:
    """Full-sequence self-attention (training / prefill).

    With `cache`, writes K/V at [cache_offset, cache_offset+T) and attends
    over the cache (prefill, possibly one chunk of it); with `pages` the
    cache is block-paged and attention runs over the gathered view."""
    B, T, _ = x.shape
    q, k, v = _qkv(params, cfg, x)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    scale = 1.0 / math.sqrt(cfg.head_dim)
    if pages is not None:
        tpos = cache_offset + torch.arange(T, device=x.device)
        ck = _paged_write(cache["k"], pages, tpos, k)
        cv = _paged_write(cache["v"], pages, tpos, v)
        kk, vv = gather_blocks(ck, pages), gather_blocks(cv, pages)
        mask = make_causal_mask(T, kk.shape[1], cache_offset, x.device)
        out = _attend(q, kk.to(q.dtype), vv.to(q.dtype), mask, scale)
        new_cache = {"k": ck, "v": cv}
    elif cache is not None:
        ck, cv = cache["k"], cache["v"]
        ck[:, cache_offset:cache_offset + T] = k.to(ck.dtype)
        cv[:, cache_offset:cache_offset + T] = v.to(cv.dtype)
        mask = make_causal_mask(T, ck.shape[1], cache_offset, x.device)
        out = _attend(q, ck.to(q.dtype), cv.to(q.dtype), mask, scale)
        new_cache = {"k": ck, "v": cv}
    else:
        mask = make_causal_mask(T, T, 0, x.device)
        out = _attend(q, k, v, mask, scale)
        new_cache = None
    return _out_proj(params, out, x), new_cache


def gqa_decode(params: dict, cfg: AttnConfig, x: torch.Tensor,
               position: Union[int, torch.Tensor], cache: dict,
               pages: Optional[torch.Tensor] = None,
               paged_kernel: Optional[bool] = None
               ) -> Tuple[torch.Tensor, dict]:
    """One-token decode. x [B,1,d]; `position` is a scalar (the whole batch
    at one depth) or an int vector [B] of per-row depths. With `pages`
    [B, M] (needs per-row positions) the cache is block-paged and
    `paged_kernel` picks the kernel path over the plain gather path."""
    B, T, _ = x.shape
    assert T == 1
    q, k, v = _qkv(params, cfg, x)
    pos = torch.as_tensor(position, device=x.device)
    per_row = pos.dim() == 1
    pos_bt = pos[:, None] if per_row else pos.reshape(1, 1)
    q = apply_rope(q, pos_bt, cfg.rope_theta)
    k = apply_rope(k, pos_bt, cfg.rope_theta)
    scale = 1.0 / math.sqrt(cfg.head_dim)
    if pages is not None:
        assert per_row, "paged decode needs per-row positions"
        if kernel_ops.paged_kernel_enabled(paged_kernel, x.device):
            # kernel path: in-place paged write + flash-decode walking the
            # page table, no dense [B, M*bs, ...] view
            tables = pages.to(torch.int32).contiguous()
            pos32 = pos.to(torch.int32).contiguous()
            ck = kernel_ops.paged_write_token(cache["k"], tables, pos32, k[:, 0])
            cv = kernel_ops.paged_write_token(cache["v"], tables, pos32, v[:, 0])
            out = kernel_ops.paged_flash_decode_gqa(q, ck, cv, tables, pos32,
                                                    scale=scale)
        else:
            ck = _paged_write(cache["k"], pages, pos[:, None], k[:, 0:1])
            cv = _paged_write(cache["v"], pages, pos[:, None], v[:, 0:1])
            kk, vv = gather_blocks(ck, pages), gather_blocks(cv, pages)
            idx = torch.arange(kk.shape[1], device=x.device)
            mask = (idx[None, :] <= pos[:, None])[:, None, :]
            out = _attend(q, kk.to(q.dtype), vv.to(q.dtype), mask, scale)
        return _out_proj(params, out, x), {"k": ck, "v": cv}
    ck, cv = cache["k"], cache["v"]
    idx = torch.arange(ck.shape[1], device=x.device)
    if per_row:
        rows = torch.arange(B, device=x.device)
        ck[rows, pos.long()] = k[:, 0].to(ck.dtype)
        cv[rows, pos.long()] = v[:, 0].to(cv.dtype)
        mask = (idx[None, :] <= pos[:, None])[:, None, :]      # [B, 1, S]
    else:
        p = int(position)
        ck[:, p] = k[:, 0].to(ck.dtype)
        cv[:, p] = v[:, 0].to(cv.dtype)
        mask = (idx <= p)[None, :]                             # [1, S]
    out = _attend(q, ck.to(q.dtype), cv.to(q.dtype), mask, scale)
    return _out_proj(params, out, x), {"k": ck, "v": cv}
