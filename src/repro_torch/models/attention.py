"""Attention blocks: GQA (optionally sliding-window, or bidirectional
for an encoder), cross-attention over encoder states, and DeepSeek-style
MLA (multi-head latent attention: kv_lora compression, decoupled RoPE,
weight-absorbed decode), each with dense and block-paged caches.

Counterpart of `repro.models.attention`. Functions take ONE layer's
parameters; the caller slices the stacked layer axis.

Cache layouts (per layer; GQA leaves end in ``[KV, hd]``, MLA's two
leaves ``ckv``/``kr`` in ``[kv_lora]``/``[rope_dim]``):
  * dense — [batch, max_len, ...]: writes go to absolute positions,
    reads mask ``idx <= position`` (and, with a sliding window w,
    ``idx > position - w``).
  * ring (GQA with a sliding window w and a cache of S <= w positions) —
    [batch, S, ...]: position p lives in slot p % S; a prompt longer than
    S attends in-sequence under the sliding mask and keeps its last S
    tokens at their slots; decode masks the slots whose absolute
    position would be negative.
  * paged — [n_blocks + 1, block_size, ...] plus a page table `pages`
    [B, M] mapping each row's logical block to a physical block (0 is the
    shared trash block). Writes scatter to
    ``(pages[b, pos // block_size], pos % block_size)``. Ring caches do
    not page (`serving.paged_pool.validate_pageable` refuses them).

Unlike the JAX package, caches are updated IN PLACE: the functions write
into the tensors they are given (views of the stacked cache) and return
them, so no copy of a cache leaf is made per step.

Paged decode has two implementations of the same masked softmax: the
plain path (`_paged_write` + `gather_blocks` + `_attend`) and the kernel
path (`kernels.ops.paged_write_token_pair`, which writes the layer's two
cache leaves in one launch, + `paged_flash_decode_gqa` or
`paged_flash_decode_mla`, CUDA on the card; both decodes split each row's
cache across CTAs, and the MLA decode takes its products on the tensor
cores with bf16 hi + lo operands). GQA prefill likewise: the
plain `_attend` over the causal mask, or the `kernels.ops.flash_attention`
kernel with ``q_offset = cache_offset`` (the same mask), on the slot
cache, the gathered paged view, and, when autograd records nothing, the
cacheless in-sequence branch, each with the sliding window when the
config has one (the ring branch too); an encoder's cacheless
self-attention (``causal=False``) and cross-attention, in prefill and at
the decode step, take the kernel with ``causal=False`` or `_attend` over
an all-true mask; training keeps `_attend`, since the kernel has no
backward. Slot decode, over a dense or ring cache, stays
the plain `_attend`, as JAX's slot decode stays XLA. `paged_kernel` picks the path; None defers to
`kernels.ops.paged_kernel_enabled` (on exactly for CUDA tensors). The
kernel path keeps the probabilities at fp32 precision in effect (for bf16
inputs its tensor-core P @ V takes P as two bf16 halves, hi + lo, 16 bits
in all) where `_attend` rounds them to v's type before P @ V, so with bf16
activations the two paths differ by about one bf16 rounding. MLA prefill
stays plain: its value width (128)
differs from its query/key width (192), and the kernel takes one head
width.

``AttnConfig.attn_chunk`` (the config's `attn_chunk`) is JAX's
online-softmax KV-chunked schedule for the plain attention: `_attend`
with a chunk walks the keys a chunk at a time (`_attend_chunked`), so
the [Tq, Tk] scores are never live in full. Every plain branch of
`gqa_forward` passes it, and `mla_forward` with a chunk scores its
nope and rope halves as one concatenated head (JAX's branch, which
rounds differently from the two-term score even when no chunking
happens). The flash kernel is online-softmax already and takes none;
decode and cross-attention take none, as in JAX.

Under a `sharding.ParallelContext` whose rules shard the slot cache's
sequence (``cache_seq``), a decode at one position for the whole batch
runs `_flash_decode_sharded` (JAX's sequence-sharded flash decode): each
rank scores its block of the cache, and the row max and the softmax sums
combine over the sequence axes; where the KV heads are sharded too, each
rank takes its KV heads' query groups (JAX's body does not, and is wrong
there: ROADMAP.md §3). Per-row positions and the paged cache keep the
dense path, as in JAX.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple, Union

import torch

from repro_torch.kernels import ops as kernel_ops
from repro_torch.models.common import (ParamInit, apply_rope, einsum,
                                       make_causal_mask, make_sliding_mask,
                                       rms_norm)
from repro_torch.sharding import (ParallelContext, Spec, all_reduce, assemble,
                                  axes_of, take_block)

NEG_INF = -1e30


@dataclasses.dataclass(frozen=True)
class AttnConfig:
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    sliding_window: Optional[int] = None     # None = full causal
    causal: bool = True                      # False for encoder self-attn
    # MLA fields (used only by the mla_* functions)
    q_lora: int = 0
    kv_lora: int = 0
    rope_dim: int = 64
    v_head_dim: int = 0
    attn_chunk: int = 0                      # >0: KV-chunked `_attend`


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
            mask: torch.Tensor, scale: float,
            chunk: Optional[int] = None) -> torch.Tensor:
    """q [B,Tq,H,hd]; k,v [B,Tk,KV,hd]; mask [Tq,Tk] or [B,Tq,Tk] bool.
    Scores and softmax in fp32. With `chunk`, JAX's rule: the chunk is
    halved until it divides Tk, and the online-softmax schedule
    (`_attend_chunked`) runs when it is still >= 128 and below Tk."""
    B, Tq, H, hd = q.shape
    KV = k.shape[2]
    qg = q.reshape(B, Tq, KV, H // KV, hd)
    if chunk:
        while k.shape[1] % chunk:
            chunk //= 2
    if chunk and chunk >= 128 and k.shape[1] > chunk:
        out = _attend_chunked(qg, k, v, mask, scale, chunk)
        return out.reshape(B, Tq, H, v.shape[-1]).to(q.dtype)
    scores = torch.einsum("btkgh,bskh->bkgts", qg.float(), k.float()) * scale
    m = mask[None, None, None] if mask.dim() == 2 else mask[:, None, None]
    probs = torch.softmax(torch.where(m, scores, NEG_INF), dim=-1)
    out = torch.einsum("bkgts,bskh->btkgh", probs.to(v.dtype), v)
    return out.reshape(B, Tq, H, v.shape[-1]).to(q.dtype)


def _attend_chunked(qg: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    mask: torch.Tensor, scale: float,
                    chunk: int) -> torch.Tensor:
    """Online softmax over KV chunks of `chunk` keys (which divides Tk):
    a running max, sum and fp32 accumulator, one [Tq, chunk] score tile
    live at a time. qg [B,Tq,KV,g,hd]; returns [B,Tq,KV,g,hd] fp32. A
    row with no visible key so far keeps weight 0 (JAX's guards: a fully
    masked row comes out 0); its exponents are taken of -inf, never of
    -inf minus -inf, so the backward stays finite too."""
    B, Tq, KV, g, _ = qg.shape
    nc = k.shape[1] // chunk
    neg = float("-inf")
    m = torch.full((B, KV, g, Tq), neg, dtype=torch.float32, device=qg.device)
    l = torch.zeros((B, KV, g, Tq), dtype=torch.float32, device=qg.device)
    acc = torch.zeros((B, KV, g, Tq, v.shape[-1]), dtype=torch.float32,
                      device=qg.device)
    for i in range(nc):
        sl = slice(i * chunk, (i + 1) * chunk)
        ks, vs, mk = k[:, sl], v[:, sl], mask[..., sl]
        s = torch.einsum("btkgh,bskh->bkgts", qg.float(), ks.float()) * scale
        mb = mk[None, None, None] if mk.dim() == 2 else mk[:, None, None]
        s = torch.where(mb, s, neg)
        nm = torch.maximum(m, s.amax(-1))                 # [B,KV,g,Tq]
        safe = torch.isfinite(nm)
        nm0 = torch.where(safe, nm, 0.0)
        p = torch.exp(torch.where(safe[..., None], s - nm0[..., None], neg))
        live = safe & torch.isfinite(m)
        alpha = torch.exp(torch.where(live, torch.clamp(m - nm0, max=0.0),
                                      neg))
        l = l * alpha + p.sum(-1)
        pv = torch.einsum("bkgts,bskh->bkgth", p.to(vs.dtype).float(),
                          vs.float())
        acc = acc * alpha[..., None] + pv
        m = nm
    out = acc / torch.clamp(l, min=1e-30)[..., None]     # [B,KV,g,Tq,hd]
    return out.permute(0, 3, 1, 2, 4)


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


def _prefill_attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    q_offset: int, scale: float, kernel: bool,
                    window: Optional[int] = None,
                    causal: bool = True, chunk: int = 0) -> torch.Tensor:
    """Attention of q [B,T,H,hd] (query t at position q_offset + t) over
    k, v [B,S,KV,hd] (key s at position s), both in q's type: causal,
    each query seeing only keys less than `window` positions back when
    one is given, or every key when not `causal`. The flash kernel, or
    `_attend` over the same mask (`make_causal_mask`,
    `make_sliding_mask` or all true) with the KV `chunk`."""
    k, v = k.to(q.dtype), v.to(q.dtype)
    if kernel:
        return kernel_ops.flash_attention(q, k, v, causal=causal,
                                          window=window or 0, scale=scale,
                                          q_offset=q_offset)
    T, S = q.shape[1], k.shape[1]
    if not causal:
        mask = torch.ones((T, S), dtype=torch.bool, device=q.device)
    elif window:
        mask = make_sliding_mask(T, S, q_offset, window, q.device)
    else:
        mask = make_causal_mask(T, S, q_offset, q.device)
    return _attend(q, k, v, mask, scale, chunk)


def gqa_forward(params: dict, cfg: AttnConfig, x: torch.Tensor,
                positions: torch.Tensor, cache: Optional[dict] = None,
                cache_offset: int = 0, pages: Optional[torch.Tensor] = None,
                paged_kernel: Optional[bool] = None
                ) -> Tuple[torch.Tensor, Optional[dict]]:
    """Full-sequence self-attention (training / prefill).

    With `cache`, writes K/V at [cache_offset, cache_offset+T) and attends
    over the cache (prefill, possibly one chunk of it); with `pages` the
    cache is block-paged and attention runs over the gathered view. A
    ring cache shorter than the prompt keeps the prompt's last S tokens
    at their slots (position p at p % S) and the prompt attends
    in-sequence under the sliding mask. Without a cache, attention runs
    in-sequence, bidirectional when ``cfg.causal`` is False (an encoder).
    `paged_kernel` picks the flash kernel over `_attend` (None: on for
    CUDA); without a cache it is taken only when autograd records
    nothing."""
    B, T, _ = x.shape
    q, k, v = _qkv(params, cfg, x)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    scale = 1.0 / math.sqrt(cfg.head_dim)
    kernel = kernel_ops.paged_kernel_enabled(paged_kernel, x.device)
    window = cfg.sliding_window
    if pages is not None:
        assert window is None, "paged caches take no sliding window"
        tpos = cache_offset + torch.arange(T, device=x.device)
        ck = _paged_write(cache["k"], pages, tpos, k)
        cv = _paged_write(cache["v"], pages, tpos, v)
        out = _prefill_attend(q, gather_blocks(ck, pages),
                              gather_blocks(cv, pages), cache_offset, scale,
                              kernel, chunk=cfg.attn_chunk)
        new_cache = {"k": ck, "v": cv}
    elif cache is not None and cache["k"].shape[1] < T:
        # ring cache shorter than the prompt: the last S tokens, rolled so
        # that position p sits at slot p % S
        ck, cv = cache["k"], cache["v"]
        S = ck.shape[1]
        shift = (T - S) % S
        ck.copy_(torch.roll(k[:, T - S:].to(ck.dtype), shift, dims=1))
        cv.copy_(torch.roll(v[:, T - S:].to(cv.dtype), shift, dims=1))
        out = _prefill_attend(q, k, v, cache_offset, scale, kernel,
                              window or S, chunk=cfg.attn_chunk)
        new_cache = {"k": ck, "v": cv}
    elif cache is not None:
        ck, cv = cache["k"], cache["v"]
        ck[:, cache_offset:cache_offset + T] = k.to(ck.dtype)
        cv[:, cache_offset:cache_offset + T] = v.to(cv.dtype)
        out = _prefill_attend(q, ck, cv, cache_offset, scale, kernel, window,
                              chunk=cfg.attn_chunk)
        new_cache = {"k": ck, "v": cv}
    else:
        recording = torch.is_grad_enabled() and (
            q.requires_grad or k.requires_grad or v.requires_grad)
        out = _prefill_attend(q, k, v, 0, scale, kernel and not recording,
                              window, cfg.causal, cfg.attn_chunk)
        new_cache = None
    return _out_proj(params, out, x), new_cache


def _seq_sharded_spec(cache_shape, mask: torch.Tensor,
                      ctx: Optional[ParallelContext]) -> Optional[Spec]:
    """The cache's spec when the sequence-sharded decode runs (JAX's
    rule: the spec shards ``cache_seq`` and the mask is 2-D, i.e. one
    position for the whole batch), else None. A sequence split into one
    block is the whole cache: the dense path computes it."""
    if ctx is None or ctx.mesh is None or mask.dim() != 2:
        return None
    spec = ctx.spec(("batch", "cache_seq", "kv_heads", None), cache_shape)
    if ctx.n_blocks(axes_of(spec[1])) == 1:
        return None
    return spec


def _flash_decode_sharded(q: torch.Tensor, k: torch.Tensor,
                          v: torch.Tensor, ck: torch.Tensor,
                          cv: torch.Tensor, slot: int, mask: torch.Tensor,
                          scale: float, spec: Spec,
                          ctx: ParallelContext) -> torch.Tensor:
    """Decode attention over a sequence-sharded KV cache without gathering
    it (flash decode): each rank writes the new token's K/V if it owns
    cache slot `slot` (at slot minus its block's offset), scores q against
    its block, and the row max (all-reduce max), the softmax sums and P @
    V (all-reduce sums) combine over the sequence axes. Where the spec
    also shards the KV heads, the rank takes the query heads of its KV
    heads' groups and the output's head groups are gathered (JAX's body
    pairs every query head with the rank's KV heads there). A row that
    sees no key gives 0 (JAX's `safe` guard). q, k, v [B, 1, H | KV, hd];
    ck, cv the global [B, S, KV, hd] cache, of which the rank reads and
    writes only its block; mask [1, S]. Returns [B, 1, H, hd] in q's
    type on every rank."""
    seq_axes = axes_of(spec[1])
    head_spec = Spec(spec[0], None, spec[2], None)
    kb, vb = take_block(ck, spec, ctx), take_block(cv, spec, ctx)
    S_loc = kb.shape[1]
    off = ctx.coord(seq_axes) * S_loc
    if off <= slot < off + S_loc:
        kb[:, slot - off] = take_block(k, head_spec, ctx)[:, 0].to(kb.dtype)
        vb[:, slot - off] = take_block(v, head_spec, ctx)[:, 0].to(vb.dtype)
    qb = take_block(q, head_spec, ctx)
    mb = take_block(mask, Spec(None, spec[1]), ctx)
    B, Tq, H, hd = qb.shape
    KV = kb.shape[2]
    qg = qb.reshape(B, Tq, KV, H // KV, hd).float()
    s = torch.einsum("btkgh,bskh->bkgts", qg,
                     kb.to(q.dtype).float()) * scale
    s = torch.where(mb[None, None, None], s, float("-inf"))
    M = all_reduce(s.amax(-1), seq_axes, ctx, "max")        # global row max
    safe = torch.isfinite(M)
    p = torch.where(safe[..., None], torch.exp(s - M[..., None]), 0.0)
    l = all_reduce(p.sum(-1), seq_axes, ctx, "sum")
    pv = torch.einsum("bkgts,bskh->bkgth", p.to(q.dtype).float(),
                      vb.to(q.dtype).float())
    pv = all_reduce(pv, seq_axes, ctx, "sum")
    out = pv / torch.clamp(l, min=1e-30)[..., None]
    out = out.permute(0, 3, 1, 2, 4).reshape(B, Tq, H, hd).to(q.dtype)
    return assemble(out, head_spec, ctx)


def gqa_decode(params: dict, cfg: AttnConfig, x: torch.Tensor,
               position: Union[int, torch.Tensor], cache: dict,
               pages: Optional[torch.Tensor] = None,
               paged_kernel: Optional[bool] = None,
               ctx: Optional[ParallelContext] = None
               ) -> Tuple[torch.Tensor, dict]:
    """One-token decode. x [B,1,d]; `position` is a scalar (the whole batch
    at one depth) or an int vector [B] of per-row depths. With `pages`
    [B, M] (needs per-row positions) the cache is block-paged and
    `paged_kernel` picks the kernel path over the plain gather path. With
    a sliding window w, a cache of S <= w positions is a ring (the token
    goes to slot position % S; a slot is valid when its absolute position
    is >= 0) and a longer one masks keys w or more positions back. With a
    `ctx` whose rules shard the cache's sequence (scalar positions), the
    slot cache decodes through `_flash_decode_sharded`; the paged path
    has no mesh path, as in JAX."""
    B, T, _ = x.shape
    assert T == 1
    q, k, v = _qkv(params, cfg, x)
    pos = torch.as_tensor(position, device=x.device)
    per_row = pos.dim() == 1
    pos_bt = pos[:, None] if per_row else pos.reshape(1, 1)
    q = apply_rope(q, pos_bt, cfg.rope_theta)
    k = apply_rope(k, pos_bt, cfg.rope_theta)
    scale = 1.0 / math.sqrt(cfg.head_dim)
    window = cfg.sliding_window
    if pages is not None:
        assert per_row and window is None, \
            "paged decode needs per-row positions and no sliding window"
        if kernel_ops.paged_kernel_enabled(paged_kernel, x.device):
            # kernel path: in-place paged write + flash-decode walking the
            # page table, no dense [B, M*bs, ...] view
            tables = pages.to(torch.int32).contiguous()
            pos32 = pos.to(torch.int32).contiguous()
            ck, cv = kernel_ops.paged_write_token_pair(
                cache["k"], cache["v"], tables, pos32, k[:, 0], v[:, 0])
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
    S = ck.shape[1]
    ring = window is not None and S <= window
    idx = torch.arange(S, device=x.device)
    if per_row:
        slot = torch.remainder(pos, S).long() if ring else pos.long()
        p = pos[:, None]                                       # [B, 1]
    else:
        p = int(position)
        slot = p % S if ring else p
    if ring:
        # slot s holds absolute position p - ((p - s) mod S), valid when
        # it is >= 0
        mask = p - torch.remainder(p - idx, S) >= 0
    else:
        mask = idx <= p
        if window:
            mask = mask & (idx > p - window)
    mask = mask[:, None, :] if per_row else mask[None, :]   # [B,1,S] / [1,S]
    spec = _seq_sharded_spec(ck.shape, mask, ctx)
    if spec is not None:
        out = _flash_decode_sharded(q, k, v, ck, cv, slot, mask, scale, spec,
                                    ctx)
        return _out_proj(params, out, x), {"k": ck, "v": cv}
    if per_row:
        rows = torch.arange(B, device=x.device)
        ck[rows, slot] = k[:, 0].to(ck.dtype)
        cv[rows, slot] = v[:, 0].to(cv.dtype)
    else:
        ck[:, slot] = k[:, 0].to(ck.dtype)
        cv[:, slot] = v[:, 0].to(cv.dtype)
    out = _attend(q, ck.to(q.dtype), cv.to(q.dtype), mask, scale)
    return _out_proj(params, out, x), {"k": ck, "v": cv}


# ---------------------------------------------------------------------------
# Cross-attention (enc-dec): K/V computed once from the encoder's output
# ---------------------------------------------------------------------------

def init_cross_attn(pi: ParamInit, cfg: AttnConfig, L: int) -> dict:
    """Cross-attention weights stacked over `L` decoder layers, JAX's
    layout: wq/wk/wv [L, d, H, hd], wo [L, H, hd, d] (H heads, no
    grouping)."""
    d, H, hd = cfg.d_model, cfg.n_heads, cfg.head_dim
    proj = ("layers", "embed", "heads", "head_dim")
    return {"wq": pi.normal((L, d, H, hd), fan_in=d, axes=proj),
            "wk": pi.normal((L, d, H, hd), fan_in=d, axes=proj),
            "wv": pi.normal((L, d, H, hd), fan_in=d, axes=proj),
            "wo": pi.normal((L, H, hd, d), fan_in=H * hd,
                            axes=("layers", "heads", "head_dim", "embed"))}


def cross_attn_kv(params: dict, enc_out: torch.Tensor) -> dict:
    """One layer's cross K/V of the encoder states [B, S, d]:
    {"k", "v"} of [B, S, H, hd] (H heads, no grouping)."""
    return {"k": einsum("bsd,dhk->bshk", enc_out, params["wk"]),
            "v": einsum("bsd,dhk->bshk", enc_out, params["wv"])}


def cross_attn_forward(params: dict, cfg: AttnConfig, x: torch.Tensor,
                       kv: dict, paged_kernel: Optional[bool] = None
                       ) -> torch.Tensor:
    """x [B, T, d] attends over every encoder position of `kv` (no RoPE,
    an all-true mask), T = 1 at a decode step. K/V are cast to q's type.
    `paged_kernel` picks the flash kernel with ``causal=False`` over
    `_attend` (None: on for CUDA), taken only when autograd records
    nothing."""
    q = einsum("btd,dhk->bthk", x, params["wq"])
    kernel = kernel_ops.paged_kernel_enabled(paged_kernel, x.device)
    recording = torch.is_grad_enabled() and (
        q.requires_grad or kv["k"].requires_grad or kv["v"].requires_grad)
    out = _prefill_attend(q, kv["k"], kv["v"], 0,
                          1.0 / math.sqrt(cfg.head_dim),
                          kernel and not recording, causal=False)
    return _out_proj(params, out, x)


# ---------------------------------------------------------------------------
# MLA — multi-head latent attention (DeepSeek-V2)
# ---------------------------------------------------------------------------

def _mla_qkr(params: dict, cfg: AttnConfig, x: torch.Tensor,
             positions: torch.Tensor):
    cq = rms_norm(einsum("btd,dr->btr", x, params["wdq"]), params["q_norm"])
    q = einsum("btr,rhk->bthk", cq, params["wuq"])
    dn = cfg.head_dim
    return q[..., :dn], apply_rope(q[..., dn:], positions, cfg.rope_theta)


def _mla_latent(params: dict, cfg: AttnConfig, x: torch.Tensor,
                positions: torch.Tensor):
    """The token's compressed kv [B,T,kv_lora] and roped shared key
    [B,T,rope_dim] — what the MLA cache stores."""
    ckv = einsum("btd,dr->btr", x, params["wdkv"])
    kr = apply_rope(einsum("btd,dk->btk", x, params["wkr"])[:, :, None, :],
                    positions, cfg.rope_theta)[:, :, 0, :]
    return ckv, kr


def mla_forward(params: dict, cfg: AttnConfig, x: torch.Tensor,
                positions: torch.Tensor, cache: Optional[dict] = None,
                cache_offset: int = 0, pages: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Optional[dict]]:
    """Training / prefill: materializes per-head K/V from the latent; the
    cache stores only (ckv, kr). With `cache`, writes them at
    [cache_offset, cache_offset+T) (through the page table with `pages`)
    and attends over the cache. Always plain (see the module docstring)."""
    B, T, _ = x.shape
    q_nope, q_rope = _mla_qkr(params, cfg, x, positions)
    ckv, kr = _mla_latent(params, cfg, x, positions)
    new_cache = None
    if pages is not None:
        tpos = cache_offset + torch.arange(T, device=x.device)
        cckv = _paged_write(cache["ckv"], pages, tpos, ckv)
        ckr = _paged_write(cache["kr"], pages, tpos, kr)
        new_cache = {"ckv": cckv, "kr": ckr}
        ckv_all = gather_blocks(cckv, pages).to(x.dtype)
        kr_all = gather_blocks(ckr, pages).to(x.dtype)
        mask = make_causal_mask(T, ckv_all.shape[1], cache_offset, x.device)
    elif cache is not None:
        cckv, ckr = cache["ckv"], cache["kr"]
        cckv[:, cache_offset:cache_offset + T] = ckv.to(cckv.dtype)
        ckr[:, cache_offset:cache_offset + T] = kr.to(ckr.dtype)
        new_cache = {"ckv": cckv, "kr": ckr}
        ckv_all, kr_all = cckv.to(x.dtype), ckr.to(x.dtype)
        mask = make_causal_mask(T, ckv_all.shape[1], cache_offset, x.device)
    else:
        ckv_all, kr_all = ckv, kr
        mask = make_causal_mask(T, T, 0, x.device)
    ckv_n = rms_norm(ckv_all, params["kv_norm"])
    k_nope = einsum("bsr,rhk->bshk", ckv_n, params["wuk"])
    v = einsum("bsr,rhk->bshk", ckv_n, params["wuv"])
    scale = 1.0 / math.sqrt(cfg.head_dim + cfg.rope_dim)
    if cfg.attn_chunk:
        # JAX's chunked branch: one GQA score over the concatenated
        # (nope || rope) head dims, through `_attend` with the chunk
        qt = torch.promote_types(q_nope.dtype, q_rope.dtype)
        kt = torch.promote_types(k_nope.dtype, kr_all.dtype)
        q_cat = torch.cat([q_nope.to(qt), q_rope.to(qt)], dim=-1)
        k_cat = torch.cat([k_nope.to(kt), kr_all[:, :, None, :].to(kt)
                           .expand(*k_nope.shape[:3], cfg.rope_dim)], dim=-1)
        out = _attend(q_cat, k_cat, v, mask, scale,
                      cfg.attn_chunk).to(x.dtype)
        return _out_proj(params, out, x), new_cache
    scores = (torch.einsum("bthk,bshk->bhts", q_nope.float(), k_nope.float())
              + torch.einsum("bthk,bsk->bhts", q_rope.float(),
                             kr_all.float())) * scale
    probs = torch.softmax(torch.where(mask, scores, NEG_INF), dim=-1)
    out = torch.einsum("bhts,bshk->bthk", probs.to(v.dtype), v).to(x.dtype)
    return _out_proj(params, out, x), new_cache


def mla_decode(params: dict, cfg: AttnConfig, x: torch.Tensor,
               position: Union[int, torch.Tensor], cache: dict,
               pages: Optional[torch.Tensor] = None,
               paged_kernel: Optional[bool] = None
               ) -> Tuple[torch.Tensor, dict]:
    """Weight-absorbed decode: W_uk is folded into the query, so scores
    and values are computed against the compressed cache, O(kv_lora) per
    position. `position` is a scalar or an int vector [B]; `pages` [B, M]
    (needs per-row positions) selects the paged cache and `paged_kernel`
    the kernel path (the CUDA MLA flash-decode, which rms-norms each ckv
    block in fp32 and returns the fp32 latent context) over the plain
    gather path."""
    B, T, _ = x.shape
    assert T == 1
    pos = torch.as_tensor(position, device=x.device)
    per_row = pos.dim() == 1
    pos_bt = pos[:, None] if per_row else pos.reshape(1, 1)
    q_nope, q_rope = _mla_qkr(params, cfg, x, pos_bt)
    ckv_new, kr_new = _mla_latent(params, cfg, x, pos_bt)
    scale = 1.0 / math.sqrt(cfg.head_dim + cfg.rope_dim)
    if pages is not None and kernel_ops.paged_kernel_enabled(paged_kernel,
                                                             x.device):
        assert per_row, "paged decode needs per-row positions"
        tables = pages.to(torch.int32).contiguous()
        pos32 = pos.to(torch.int32).contiguous()
        cckv, ckr = kernel_ops.paged_write_token_pair(
            cache["ckv"], cache["kr"], tables, pos32, ckv_new[:, 0],
            kr_new[:, 0])
        q_abs = einsum("bthk,rhk->bthr", q_nope, params["wuk"])
        ctx_lat = kernel_ops.paged_flash_decode_mla(
            q_abs.contiguous(), q_rope.contiguous(), cckv, ckr,
            params["kv_norm"].contiguous(), tables, pos32,
            scale=scale).to(x.dtype)
        out = einsum("bthr,rhk->bthk", ctx_lat, params["wuv"])
        return _out_proj(params, out, x), {"ckv": cckv, "kr": ckr}
    if pages is not None:
        assert per_row, "paged decode needs per-row positions"
        cckv = _paged_write(cache["ckv"], pages, pos[:, None], ckv_new)
        ckr = _paged_write(cache["kr"], pages, pos[:, None], kr_new)
        ckv_seq, kr_seq = gather_blocks(cckv, pages), gather_blocks(ckr, pages)
    else:
        cckv, ckr = cache["ckv"], cache["kr"]
        if per_row:
            rows = torch.arange(B, device=x.device)
            cckv[rows, pos.long()] = ckv_new[:, 0].to(cckv.dtype)
            ckr[rows, pos.long()] = kr_new[:, 0].to(ckr.dtype)
        else:
            cckv[:, int(position)] = ckv_new[:, 0].to(cckv.dtype)
            ckr[:, int(position)] = kr_new[:, 0].to(ckr.dtype)
        ckv_seq, kr_seq = cckv, ckr
    idx = torch.arange(ckv_seq.shape[1], device=x.device)
    mask = ((idx[None, :] <= pos[:, None]) if per_row
            else (idx <= pos)[None, :])[:, None, None, :]
    ckv_n = rms_norm(ckv_seq.to(x.dtype), params["kv_norm"])
    q_abs = einsum("bthk,rhk->bthr", q_nope, params["wuk"])
    scores = (torch.einsum("bthr,bsr->bhts", q_abs.float(), ckv_n.float())
              + torch.einsum("bthk,bsk->bhts", q_rope.float(),
                             kr_seq.to(x.dtype).float())) * scale
    probs = torch.softmax(torch.where(mask, scores, NEG_INF), dim=-1)
    ctx_lat = torch.einsum("bhts,bsr->bthr", probs.to(x.dtype),
                           ckv_n).to(x.dtype)
    out = einsum("bthr,rhk->bthk", ctx_lat, params["wuv"])
    return _out_proj(params, out, x), {"ckv": cckv, "kr": ckr}
