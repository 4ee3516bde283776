"""Decoder LM for ``family="dense"``: init, caches, prefill, one-token decode.

Counterpart of `repro.models.transformer` for dense GQA decoders. The
parameter tree has the JAX package's layout — layers stacked on a leading
``[L, ...]`` axis under ``params["blocks"]["dense"]`` — and the layers run
as a Python loop over that axis (the JAX package folds it with
`lax.scan`). Caches are stacked the same way, ``[L, batch, ...]``, and are
written in place.

API:
    init_params(cfg, seed, device)              -> params
    forward(params, cfg, tokens)                -> logits [B, T, V]
    init_cache(cfg, batch, max_len, dtype, device) -> cache
    prefill(params, cfg, tokens, cache, ...)    -> (logits, cache)
    decode_step(params, cfg, token, position, cache, ...) -> (logits, cache)
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch import resolve_device
from repro_torch.configs import ModelConfig
from repro_torch.models import attention as attn_lib
from repro_torch.models.common import (ParamInit, embed_tokens, rms_norm,
                                       unembed)
from repro_torch.models.ffn import mlp_forward


def attn_config(cfg: ModelConfig) -> attn_lib.AttnConfig:
    if cfg.family != "dense" or cfg.sliding_window is not None:
        raise NotImplementedError(
            f"family {cfg.family!r} (sliding_window={cfg.sliding_window}) is "
            f"not ported: the port runs dense full-causal GQA decoders only "
            f"(MLA, MoE and SSM families are queued in ROADMAP.md)")
    return attn_lib.AttnConfig(
        d_model=cfg.d_model, n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
        head_dim=cfg.head_dim, qkv_bias=cfg.qkv_bias,
        rope_theta=cfg.rope_theta)


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

def init_params(cfg: ModelConfig, seed: int = 0, device=None) -> dict:
    """Seeded random weights with the JAX package's shapes and layout."""
    attn_config(cfg)
    pi = ParamInit(seed, cfg.pdtype(), resolve_device(device))
    L, d, H, KV = cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads
    hd, f, V = cfg.head_dim, cfg.d_ff, cfg.vocab_size
    params: Dict[str, Any] = {
        "embedding": pi.normal((V, d), fan_in=d),
        "final_norm": pi.zeros((d,)),
    }
    if not cfg.tie_embeddings:
        params["unembed"] = pi.normal((V, d), fan_in=d)
    attn = {"wq": pi.normal((L, d, H, hd), fan_in=d),
            "wk": pi.normal((L, d, KV, hd), fan_in=d),
            "wv": pi.normal((L, d, KV, hd), fan_in=d),
            "wo": pi.normal((L, H, hd, d), fan_in=H * hd)}
    if cfg.qkv_bias:
        attn.update(bq=pi.zeros((L, H, hd)), bk=pi.zeros((L, KV, hd)),
                    bv=pi.zeros((L, KV, hd)))
    params["blocks"] = {"dense": {
        "norm1": pi.zeros((L, d)),
        "attn": attn,
        "norm2": pi.zeros((L, d)),
        "mlp": {"w_up": pi.normal((L, d, f), fan_in=d),
                "w_down": pi.normal((L, f, d), fan_in=f),
                "w_gate": pi.normal((L, d, f), fan_in=d)},
    }}
    return params


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype: Optional[torch.dtype] = None, device=None) -> dict:
    """Zeroed K/V cache {"dense": {"k", "v"}}, each [L, batch, max_len,
    KV, hd]. With batch = n_blocks + 1 and max_len = block_size this is
    exactly the paged layout (block 0 = trash)."""
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    kw = dict(dtype=dtype or cfg.cdtype(), device=resolve_device(device))
    return {"dense": {"k": torch.zeros(shape, **kw),
                      "v": torch.zeros(shape, **kw)}}


def param_device(params: dict) -> torch.device:
    return params["embedding"].device


# ---------------------------------------------------------------------------
# Trunk
# ---------------------------------------------------------------------------

def _layer(tree: dict, i: int) -> dict:
    return {k: (_layer(v, i) if isinstance(v, dict) else v[i])
            for k, v in tree.items()}


def _trunk(params, cfg: ModelConfig, x, positions, cache=None,
           cache_offset: int = 0, decode: bool = False, position=None,
           pages=None, paged_kernel=None):
    """Pre-norm blocks over the stacked layer axis. Returns (x, cache)."""
    ac = attn_config(cfg)
    blocks = params["blocks"]["dense"]
    stacked = cache["dense"] if cache is not None else None
    for i in range(cfg.n_layers):
        p = _layer(blocks, i)
        c = (None if stacked is None
             else {"k": stacked["k"][i], "v": stacked["v"][i]})
        h = rms_norm(x, p["norm1"], cfg.norm_eps)
        if decode:
            y, _ = attn_lib.gqa_decode(p["attn"], ac, h, position, c,
                                       pages=pages, paged_kernel=paged_kernel)
        else:
            y, _ = attn_lib.gqa_forward(p["attn"], ac, h, positions, c,
                                        cache_offset, pages=pages)
        x = x + y
        x = x + mlp_forward(p["mlp"], rms_norm(x, p["norm2"], cfg.norm_eps))
    return x, cache


def _embed(params, cfg: ModelConfig, tokens):
    return embed_tokens(params["embedding"], tokens).to(cfg.cdtype())


def _logits(params, cfg: ModelConfig, x):
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return unembed(x, params.get("unembed", params["embedding"]))


# ---------------------------------------------------------------------------
# Public entry points
# ---------------------------------------------------------------------------

@torch.inference_mode()
def forward(params, cfg: ModelConfig, tokens: torch.Tensor) -> torch.Tensor:
    """Full-sequence forward. tokens [B, T] -> fp32 logits [B, T, V]."""
    x = _embed(params, cfg, tokens)
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    x, _ = _trunk(params, cfg, x, positions)
    return _logits(params, cfg, x)


@torch.inference_mode()
def prefill(params, cfg: ModelConfig, tokens: torch.Tensor, cache: dict,
            last_only: bool = False, cache_offset: int = 0,
            pages: Optional[torch.Tensor] = None,
            last_index: Optional[torch.Tensor] = None):
    """Process a prompt (or one chunk of it at absolute offset
    `cache_offset`), filling `cache` in place. `pages` [B, M] routes the
    cache through a page table; `last_index` ([B]) unembeds that position
    instead of the last one; `last_only` unembeds only the last position.
    Returns (logits, cache)."""
    x = _embed(params, cfg, tokens)
    B, T, _ = x.shape
    positions = torch.arange(T, device=x.device)[None, :] + cache_offset
    x, cache = _trunk(params, cfg, x, positions, cache=cache,
                      cache_offset=cache_offset, pages=pages)
    if last_index is not None:
        idx = torch.as_tensor(last_index, device=x.device).long()
        x = x[torch.arange(B, device=x.device), idx.expand(B)][:, None, :]
    elif last_only:
        x = x[:, -1:, :]
    return _logits(params, cfg, x), cache


@torch.inference_mode()
def decode_step(params, cfg: ModelConfig, token: torch.Tensor, position,
                cache: dict, pages: Optional[torch.Tensor] = None,
                paged_kernel: Optional[bool] = None):
    """One-token decode. token [B] or [B,1]; `position` a scalar or an int
    vector [B] of per-row depths; `pages` [B, M] routes the cache through
    a page table (needs vector positions); `paged_kernel` picks the
    paged kernels over the plain gather path (None: on for CUDA).
    Returns (fp32 logits [B, V], cache)."""
    if token.dim() == 1:
        token = token[:, None]
    x = _embed(params, cfg, token)
    x, cache = _trunk(params, cfg, x, None, cache=cache, decode=True,
                      position=position, pages=pages,
                      paged_kernel=paged_kernel)
    return _logits(params, cfg, x)[:, 0, :], cache
