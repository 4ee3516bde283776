"""Paged decode kernels: CUDA launch wrappers and their plain versions.

Counterpart of `repro.kernels.paged_attention` (Pallas, TPU). The kernels
are CUDA C++ for Hopper in `csrc/paged_attention.cu` and
`csrc/mla_attention.cu`; the source notes there say which TPU kernel each
replaces, what bounds it and what its design does about that.

  * `paged_flash_decode_gqa` — one-token GQA attention over each row's
    valid prefix ``idx <= pos``, read straight from the block-paged cache
    through the page table: no dense ``[B, M*bs, ...]`` view is built.
    Pages with id 0 (the trash block) and pages wholly past ``pos`` are
    skipped; a row whose table is all zeros returns exact zeros. Any group
    (H / KV) and head_dim; the kernel splits each row's tokens at fixed
    token indices (`split_span`) and merges the splits in a fixed order.
  * `paged_flash_decode_mla` — weight-absorbed MLA decode over the
    compressed cache: each valid ckv page block is rms-normed in fp32 with
    ``(1 + kv_norm)``; the score is ``(q_abs . ckv_n + q_rope . kr) *
    scale`` and the value ``ckv_n``. Returns the fp32 latent context
    ``[B, 1, H, kv_lora]``, with the same page-skipping and all-trash
    contract as the GQA decode, and like it split at `split_span` and
    merged in a fixed order.
  * `paged_write_token` — writes one token per row into block
    ``tables[b, clip(pos // bs, 0, M-1)]`` at offset ``pos % bs``, in
    place. Unmapped targets land in the trash block 0.
    `paged_write_token_pair` does the same for a decode layer's two leaves
    (K and V, or ckv and kr) in one launch.

Each wrapper takes its plain PyTorch version only for CPU tensors; for a
CUDA tensor it launches the kernel or raises. `<wrapper>.launches` counts
the calls that launched (never plain calls; a decode's split and merge
kernels count once; the pair counts into `paged_write_token.launches`, one
a launch).
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build

NEG = -1e30
_FLOAT_TYPES = (torch.float32, torch.bfloat16)
SPLIT_TOKENS = 64      # a decode split spans about this many tokens
# limits of csrc/mla_attention.cu (kMaxR, kMaxDr, kMaxBs)
_MLA_MAX_R, _MLA_MAX_DR, _MLA_MAX_BS = 512, 64, 32
MLA_MAX_SPLITS = 32    # an MLA decode row takes at most this many splits


# ---------------------------------------------------------------------------
# Plain versions (the CPU path, and the kernels' oracle on the card)
# ---------------------------------------------------------------------------

def paged_flash_decode_gqa_plain(q: torch.Tensor, k_pages: torch.Tensor,
                                 v_pages: torch.Tensor, tables: torch.Tensor,
                                 positions: torch.Tensor, *,
                                 scale: Optional[float] = None) -> torch.Tensor:
    """The kernel's function on gathered pages, in fp32: softmax over the
    positions ``idx <= pos`` whose page id is nonzero; zeros for a row
    with no such position."""
    B, T, H, hd = q.shape
    bs, KV = k_pages.shape[1], k_pages.shape[2]
    M = tables.shape[1]
    group = H // KV
    scale = scale or 1.0 / math.sqrt(hd)
    tbl = tables.long()
    kk = k_pages[tbl.reshape(-1)].reshape(B, M * bs, KV, hd).float()
    vv = v_pages[tbl.reshape(-1)].reshape(B, M * bs, KV, hd).float()
    idx = torch.arange(M * bs, device=q.device)
    valid = ((idx[None, :] <= positions.long()[:, None])
             & (tbl.repeat_interleave(bs, dim=1) > 0))[:, None, None, :]
    qg = q.float().reshape(B, KV, group, hd)
    s = torch.einsum("bkgh,bskh->bkgs", qg, kk) * scale
    s = torch.where(valid, s, NEG)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(valid, torch.exp(s - m), 0.0)
    denom = torch.clamp(p.sum(dim=-1), min=1e-30)[..., None]
    out = torch.einsum("bkgs,bskh->bkgh", p, vv) / denom
    return out.reshape(B, 1, H, hd).to(q.dtype)


def paged_flash_decode_mla_plain(q_abs: torch.Tensor, q_rope: torch.Tensor,
                                 ckv_pages: torch.Tensor,
                                 kr_pages: torch.Tensor,
                                 kv_norm: torch.Tensor, tables: torch.Tensor,
                                 positions: torch.Tensor, *, scale: float,
                                 eps: float = 1e-6) -> torch.Tensor:
    """The MLA kernel's function on gathered pages, in fp32. Positions
    that do not count (past ``pos`` or in page 0) get weight exactly 0 and
    their latent is never read into the sum."""
    B, T, H, r = q_abs.shape
    bs, dr = ckv_pages.shape[1], kr_pages.shape[-1]
    M = tables.shape[1]
    tbl = tables.long()
    ckv = ckv_pages[tbl.reshape(-1)].reshape(B, M * bs, r).float()
    kr = kr_pages[tbl.reshape(-1)].reshape(B, M * bs, dr).float()
    var = torch.mean(ckv * ckv, dim=-1, keepdim=True)
    ckv_n = ckv * torch.rsqrt(var + eps) * (1.0 + kv_norm.float())
    idx = torch.arange(M * bs, device=q_abs.device)
    valid = ((idx[None, :] <= positions.long()[:, None])
             & (tbl.repeat_interleave(bs, dim=1) > 0))        # [B, S]
    ckv_n = torch.where(valid[..., None], ckv_n, 0.0)
    s = (torch.einsum("bhr,bsr->bhs", q_abs.float()[:, 0], ckv_n)
         + torch.einsum("bhk,bsk->bhs", q_rope.float()[:, 0], kr)) * scale
    s = torch.where(valid[:, None], s, NEG)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(valid[:, None], torch.exp(s - m), 0.0)
    denom = torch.clamp(p.sum(dim=-1), min=1e-30)[..., None]
    out = torch.einsum("bhs,bsr->bhr", p, ckv_n) / denom
    return out[:, None]


def paged_write_token_plain(leaf: torch.Tensor, tables: torch.Tensor,
                            positions: torch.Tensor,
                            values: torch.Tensor) -> torch.Tensor:
    """Write `values` [B, ...] into `leaf` [N+1, bs, ...] in place through
    the page table; returns `leaf`."""
    bs = leaf.shape[1]
    B, M = tables.shape
    pos = positions.long()
    blk = torch.clamp(torch.div(pos, bs, rounding_mode="floor"), 0, M - 1)
    phys = tables.long().gather(1, blk[:, None])[:, 0]
    off = torch.remainder(pos, bs)
    leaf[phys, off] = values.reshape((B,) + tuple(leaf.shape[2:])).to(leaf.dtype)
    return leaf


# ---------------------------------------------------------------------------
# CUDA launch wrappers
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("paged_attention")
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.paged_flash_decode_gqa.argtypes = [vp] * 8 + [ci] * 6 + [
        ctypes.c_float] + [ci] * 3 + [vp]
    lib.paged_flash_decode_gqa.restype = ci
    leaf = [vp, vp, ctypes.c_int64, ci, ci, ci]
    lib.paged_write_tokens.argtypes = leaf * 2 + [vp, vp, ci, ci, ci, vp]
    lib.paged_write_tokens.restype = ci
    return lib


@functools.lru_cache(maxsize=None)
def _mla_lib() -> ctypes.CDLL:
    lib = _build.load("mla_attention")
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.paged_flash_decode_mla.argtypes = [vp] * 10 + [ci] * 7 + [cf, cf] + [
        ci] * 5 + [vp]
    lib.paged_flash_decode_mla.restype = ci
    return lib


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def _check_index(tables: torch.Tensor, positions: torch.Tensor, B: int,
                 device: torch.device) -> None:
    for name, t in (("tables", tables), ("positions", positions)):
        _require(t.device == device, f"{name} must be on {device}")
        _require(t.dtype == torch.int32, f"{name} must be int32")
        _require(t.is_contiguous(), f"{name} must be contiguous")
    _require(tables.dim() == 2 and tables.shape[0] == B,
             f"tables must be [B={B}, M], got {tuple(tables.shape)}")
    _require(positions.shape == (B,),
             f"positions must be [B={B}], got {tuple(positions.shape)}")


def _bf16(t: torch.Tensor) -> int:
    return int(t.dtype == torch.bfloat16)


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def split_span(bs: int) -> int:
    """Tokens per decode split: whole pages, about SPLIT_TOKENS of them.
    Split s of a row covers tokens [s * span, (s + 1) * span), so where a
    split starts and ends depends on the block size and the token index
    only, never on the table's width."""
    return bs * max(1, SPLIT_TOKENS // bs)


def mla_split_count(M: int, bs: int) -> int:
    """Splits of an MLA decode launch over a table M blocks wide: one a
    `split_span(bs)`, at most MLA_MAX_SPLITS. The kernel cuts a row of
    more spans than that into MLA_MAX_SPLITS longer splits, by the row's
    own position (`row_span` in `csrc/mla_attention.cu`)."""
    return min(MLA_MAX_SPLITS, -(-M * bs // split_span(bs)))


def paged_flash_decode_gqa(q: torch.Tensor, k_pages: torch.Tensor,
                           v_pages: torch.Tensor, tables: torch.Tensor,
                           positions: torch.Tensor, *,
                           scale: Optional[float] = None) -> torch.Tensor:
    """q [B,1,H,hd]; k/v_pages [N+1, bs, KV, hd]; tables [B, M] int32
    (0 = unmapped); positions [B] int32. Returns [B,1,H,hd] in q's type.
    q and the pages may each be float32 or bfloat16; any H a multiple of
    KV. A row's tokens are cut into splits of `split_span(bs)` tokens,
    whose partials a second launch merges in a fixed order; the kernel
    plans the rest of the launch itself and refuses (RuntimeError) a shape
    it cannot take: more than 4,096 splits in a table, or a head_dim so
    wide that one 32-token stage of one head overflows shared memory."""
    if not q.is_cuda:
        return paged_flash_decode_gqa_plain(q, k_pages, v_pages, tables,
                                            positions, scale=scale)
    B, T, H, hd = q.shape
    _require(T == 1, f"one query token per row, got T={T}")
    _require(k_pages.dim() == 4 and v_pages.shape == k_pages.shape,
             "k/v pages must both be [N+1, bs, KV, hd]")
    _, bs, KV, hd_k = k_pages.shape
    _require(hd_k == hd and KV > 0 and H % KV == 0,
             f"q heads {H}x{hd} do not fit pages KV={KV} hd={hd_k}")
    for name, t in (("q", q), ("k_pages", k_pages), ("v_pages", v_pages)):
        _require(t.device == q.device, f"{name} must be on {q.device}")
        _require(t.dtype in _FLOAT_TYPES, f"{name} must be fp32 or bf16")
        _require(t.is_contiguous(), f"{name} must be contiguous")
    _require(k_pages.dtype == v_pages.dtype, "k/v pages differ in type")
    _check_index(tables, positions, B, q.device)
    M = tables.shape[1]
    _require(M >= 1, "tables must have at least one column")
    group = H // KV
    span = split_span(bs)
    n_split = -(-M * bs // span)
    scale = scale or 1.0 / math.sqrt(hd)
    out = torch.empty_like(q)
    ws_acc = ws_ml = None
    if n_split > 1:
        ws_acc = torch.empty((B, KV, n_split, group, hd),
                             dtype=torch.float32, device=q.device)
        ws_ml = torch.empty((B, KV, n_split, group, 2),
                            dtype=torch.float32, device=q.device)
    err = _lib().paged_flash_decode_gqa(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        tables.data_ptr(), positions.data_ptr(), out.data_ptr(),
        None if ws_acc is None else ws_acc.data_ptr(),
        None if ws_ml is None else ws_ml.data_ptr(),
        B, M, bs, KV, group, hd, float(scale), span, _bf16(q),
        _bf16(k_pages), _stream(q.device))
    if err:
        raise RuntimeError(f"paged_flash_decode_gqa launch failed: CUDA "
                           f"error {err}")
    paged_flash_decode_gqa.launches += 1
    return out


paged_flash_decode_gqa.launches = 0


def paged_flash_decode_mla(q_abs: torch.Tensor, q_rope: torch.Tensor,
                           ckv_pages: torch.Tensor, kr_pages: torch.Tensor,
                           kv_norm: torch.Tensor, tables: torch.Tensor,
                           positions: torch.Tensor, *, scale: float,
                           eps: float = 1e-6) -> torch.Tensor:
    """q_abs [B,1,H,r] (q_nope absorbed through W_uk); q_rope [B,1,H,dr];
    ckv_pages [N+1, bs, r]; kr_pages [N+1, bs, dr]; kv_norm [r]; tables
    [B, M] int32 (0 = unmapped); positions [B] int32. Returns the latent
    context [B,1,H,r] in float32. q_abs, q_rope, the pages and kv_norm may
    each be float32 or bfloat16 (both page leaves of one type). A row's
    tokens are cut into splits of `split_span(bs)` tokens, or into
    MLA_MAX_SPLITS longer splits where the row's position reaches past
    that many; a second launch merges their partials in a fixed order.
    Their fp32 workspace, B x mla_split_count(M, bs) x H x (r + 2) floats,
    is allocated here: at most 8.4 MB a row at H 128, r 512, whatever the
    cache's length. The kernel plans the rest of the launch itself and
    refuses (RuntimeError) a shape it cannot take."""
    if not q_abs.is_cuda:
        return paged_flash_decode_mla_plain(q_abs, q_rope, ckv_pages,
                                            kr_pages, kv_norm, tables,
                                            positions, scale=scale, eps=eps)
    B, T, H, r = q_abs.shape
    _require(T == 1, f"one query token per row, got T={T}")
    _require(ckv_pages.dim() == 3 and kr_pages.dim() == 3
             and kr_pages.shape[:2] == ckv_pages.shape[:2],
             "pages must be ckv [N+1, bs, r] and kr [N+1, bs, dr]")
    _, bs, r_p = ckv_pages.shape
    dr = kr_pages.shape[2]
    _require(r_p == r and q_rope.shape == (B, 1, H, dr)
             and kv_norm.shape == (r,),
             f"q_abs {tuple(q_abs.shape)} / q_rope {tuple(q_rope.shape)} / "
             f"kv_norm {tuple(kv_norm.shape)} do not fit pages r={r_p} "
             f"dr={dr}")
    for name, t in (("q_abs", q_abs), ("q_rope", q_rope),
                    ("ckv_pages", ckv_pages), ("kr_pages", kr_pages),
                    ("kv_norm", kv_norm)):
        _require(t.device == q_abs.device, f"{name} must be on {q_abs.device}")
        _require(t.dtype in _FLOAT_TYPES, f"{name} must be fp32 or bf16")
        _require(t.is_contiguous(), f"{name} must be contiguous")
    _require(ckv_pages.dtype == kr_pages.dtype, "ckv/kr pages differ in type")
    _require(r <= _MLA_MAX_R and dr <= _MLA_MAX_DR and bs <= _MLA_MAX_BS,
             f"the kernel takes r <= {_MLA_MAX_R}, dr <= {_MLA_MAX_DR}, "
             f"block <= {_MLA_MAX_BS}; got {r}, {dr}, {bs}")
    _check_index(tables, positions, B, q_abs.device)
    M = tables.shape[1]
    _require(M >= 1, "tables must have at least one column")
    n_split = mla_split_count(M, bs)
    out = torch.empty((B, 1, H, r), dtype=torch.float32, device=q_abs.device)
    ws_acc = ws_ml = None
    if n_split > 1:
        ws_acc = torch.empty((B, n_split, H, r), dtype=torch.float32,
                             device=q_abs.device)
        ws_ml = torch.empty((B, n_split, H, 2), dtype=torch.float32,
                            device=q_abs.device)
    err = _mla_lib().paged_flash_decode_mla(
        q_abs.data_ptr(), q_rope.data_ptr(), ckv_pages.data_ptr(),
        kr_pages.data_ptr(), kv_norm.data_ptr(), tables.data_ptr(),
        positions.data_ptr(), out.data_ptr(),
        None if ws_acc is None else ws_acc.data_ptr(),
        None if ws_ml is None else ws_ml.data_ptr(), n_split, B, H, M, bs, r,
        dr, float(scale), float(eps), split_span(bs), _bf16(q_abs),
        _bf16(q_rope), _bf16(ckv_pages), _bf16(kv_norm),
        _stream(q_abs.device))
    if err:
        raise RuntimeError(f"paged_flash_decode_mla launch failed: CUDA "
                           f"error {err}")
    paged_flash_decode_mla.launches += 1
    return out


paged_flash_decode_mla.launches = 0


def _write(leaves, tables: torch.Tensor, positions: torch.Tensor,
           name: str) -> None:
    """One launch writing each (leaf, values) of `leaves` (one or two) in
    place; counts into `paged_write_token.launches`."""
    B, M = tables.shape
    device = leaves[0][0].device
    args, kept = [], []          # `kept` holds the values until the launch
    for leaf, values in leaves:
        F = math.prod(leaf.shape[2:])
        _require(values.numel() == B * F,
                 f"values {tuple(values.shape)} do not hold {B} rows of {F}")
        for what, t in (("leaf", leaf), ("values", values)):
            _require(t.device == device, f"{what} must be on {device}")
            _require(t.dtype in _FLOAT_TYPES, f"{what} must be fp32 or bf16")
        _require(leaf.dim() >= 2 and leaf.is_contiguous(),
                 "leaf must be [N+1, block_size, ...] and contiguous "
                 "(written in place)")
        values = values.contiguous()
        kept.append(values)
        args += [leaf.data_ptr(), values.data_ptr(), F, leaf.shape[1],
                 _bf16(leaf), _bf16(values)]
    _check_index(tables, positions, B, device)
    _require(M >= 1, "tables must have at least one column")
    if len(leaves) == 1:
        args += args                        # leaf b is not launched
    err = _lib().paged_write_tokens(*args, tables.data_ptr(),
                                    positions.data_ptr(), B, M, len(leaves),
                                    _stream(device))
    if err:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")
    paged_write_token.launches += 1


def paged_write_token(leaf: torch.Tensor, tables: torch.Tensor,
                      positions: torch.Tensor,
                      values: torch.Tensor) -> torch.Tensor:
    """Scatter one token per row through the page table, in place.
    leaf [N+1, block_size, ...]; tables [B, M] int32; positions [B] int32;
    values [B, ...] (cast to the leaf's type). Returns `leaf`."""
    if not leaf.is_cuda:
        return paged_write_token_plain(leaf, tables, positions, values)
    _write([(leaf, values)], tables, positions, "paged_write_token")
    return leaf


paged_write_token.launches = 0


def paged_write_token_pair(leaf_a: torch.Tensor, leaf_b: torch.Tensor,
                           tables: torch.Tensor, positions: torch.Tensor,
                           values_a: torch.Tensor, values_b: torch.Tensor
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """`paged_write_token` of a decode layer's two leaves (K and V, or ckv
    and kr) through one table and one set of positions, in one launch.
    Each leaf keeps its own width and types. Returns (leaf_a, leaf_b)."""
    if not leaf_a.is_cuda:
        return (paged_write_token_plain(leaf_a, tables, positions, values_a),
                paged_write_token_plain(leaf_b, tables, positions, values_b))
    _require(leaf_a.data_ptr() != leaf_b.data_ptr(),
             "the two leaves must be distinct tensors")
    _write([(leaf_a, values_a), (leaf_b, values_b)], tables, positions,
           "paged_write_token_pair")
    return leaf_a, leaf_b
