"""Encoder-decoder model (whisper-small). The audio frontend (mel + conv)
is a stub: callers provide precomputed frame embeddings [B, n_frames,
d_model]; sinusoidal positions are added and the encoder stack runs over
them. Decoder layers: causal self-attention, cross-attention over the
encoder's states, GELU MLP.

Counterpart of `repro.models.encdec`, with its parameter tree
(`models.transformer.init_params`: the decoder's blocks under
``params["blocks"]["dense"]``, the encoder stack, its final norm and the
per-decoder-layer cross-attention under ``params["encoder"]``). As in
JAX, the decoder uses RoPE instead of Whisper's learned positions, and
the encoder's self-attention applies RoPE to q and k at positions
0..n_frames-1 on top of the sinusoidal positions (JAX's `encode` calls
`gqa_forward`, whose q and k always take RoPE).

Kernels: with `paged_kernel` on (None: on for CUDA tensors), the
encoder's bidirectional self-attention and every cross-attention, in
prefill and at the decode step, run `flash_attention` with
``causal=False``; the decoder's prefill self-attention runs it causal
over the slot cache; the decoder's decode self-attention stays the plain
`_attend` over the slot cache, as every slot decode of the port does.
Training records autograd and stays plain (the kernel has no backward).

The cache is the decoder's dense slot cache (`transformer.init_cache`)
plus ``"cross_kv"``: {"k", "v"} of [L, B, n_frames, H, hd] in the cache
type, filled once by `prefill`. Caches are written in place.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import torch

from repro_torch import resolve_device
from repro_torch.configs import ModelConfig
from repro_torch.models import attention as attn_lib
from repro_torch.models import ffn as ffn_lib
from repro_torch.models import transformer as tfm
from repro_torch.models.common import (buffer, rms_norm,
                                       sinusoidal_positions, unembed)


def encode(params, cfg: ModelConfig, frames: torch.Tensor,
           paged_kernel: Optional[bool] = None) -> torch.Tensor:
    """frames [B, n_frames, d] (the stub frontend's output) -> the
    encoder's final-normed states [B, n_frames, d] in the compute type;
    each encoder layer under `tfm._maybe_remat` (JAX `encdec.py:53`)."""
    enc = params["encoder"]
    x = frames.to(cfg.cdtype())
    T, d = x.shape[1], x.shape[2]
    x = x + sinusoidal_positions(T, d, x.device).to(x.dtype)
    ac = dataclasses.replace(tfm.attn_config(cfg), causal=False)
    positions = torch.arange(T, device=x.device)[None, :]

    def block(p, x):
        h = rms_norm(x, p["norm1"], cfg.norm_eps)
        y, _ = attn_lib.gqa_forward(p["attn"], ac, h, positions,
                                    paged_kernel=paged_kernel)
        x = x + y
        h = rms_norm(x, p["norm2"], cfg.norm_eps)
        return x + ffn_lib.mlp_forward(p["mlp"], h, "gelu")
    blk = tfm._maybe_remat(block, cfg)
    for p in tfm._layers(enc["stack"], cfg.encoder.n_layers):
        x = blk(p, x)
    return rms_norm(x, enc["final_norm"], cfg.norm_eps)


def _cross_kv_layers(params, cfg: ModelConfig,
                     enc_out: torch.Tensor) -> List[dict]:
    """Each decoder layer's cross K/V of the encoder states: a list of L
    {"k", "v"} of [B, S, H, hd]."""
    return [attn_lib.cross_attn_kv(p, enc_out)
            for p in tfm._layers(params["encoder"]["cross"], cfg.n_layers)]


def cross_kv(params, cfg: ModelConfig, enc_out: torch.Tensor) -> dict:
    """Every decoder layer's cross K/V, computed once per request:
    {"k", "v"} of [L, B, S, H, hd]."""
    kv = _cross_kv_layers(params, cfg, enc_out)
    return {n: torch.stack([layer[n] for layer in kv]) for n in ("k", "v")}


def _decoder_trunk(params, cfg: ModelConfig, x, positions, kv: List[dict],
                   cache: Optional[dict] = None, cache_offset: int = 0,
                   decode: bool = False, position=None,
                   paged_kernel: Optional[bool] = None,
                   ctx=None) -> torch.Tensor:
    """The decoder's layers over x [B, T, d]: self-attention (in-sequence
    without a cache; over the slot cache `cache` {"k", "v"} of [L, ...]
    written in place, at a prefill or, with `decode`, a one-token step at
    `position`), cross-attention over layer i's `kv[i]` after its
    cross_norm, GELU MLP, each layer under `tfm._maybe_remat` (as the
    encoder's); `ctx` reaches the decode's self-attention (its
    sequence-sharded path). Returns x before the final norm."""
    ac = tfm.attn_config(cfg)
    L = cfg.n_layers
    blocks = tfm._layers(params["blocks"]["dense"], L)
    cross = tfm._layers(params["encoder"]["cross"], L)
    cross_norm = torch.unbind(params["encoder"]["cross_norm"])

    def block(p, cp, cn, kv_l, x, c):
        h = rms_norm(x, p["norm1"], cfg.norm_eps)
        if decode:
            y, _ = attn_lib.gqa_decode(p["attn"], ac, h, position, c,
                                       ctx=ctx)
        else:
            y, _ = attn_lib.gqa_forward(p["attn"], ac, h, positions, c,
                                        cache_offset,
                                        paged_kernel=paged_kernel)
        x = x + y
        h = rms_norm(x, cn, cfg.norm_eps)
        x = x + attn_lib.cross_attn_forward(cp, ac, h, kv_l, paged_kernel)
        h = rms_norm(x, p["norm2"], cfg.norm_eps)
        return x + ffn_lib.mlp_forward(p["mlp"], h, "gelu")
    blk = tfm._maybe_remat(block, cfg)
    for i in range(L):
        c = None if cache is None else {n: leaf[i] for n, leaf in
                                        cache.items()}
        x = blk(blocks[i], cross[i], cross_norm[i], kv[i], x, c)
    return x


def final_hidden(params, cfg: ModelConfig, frames: torch.Tensor,
                 tokens: torch.Tensor) -> torch.Tensor:
    """Training trunk: encoder, teacher-forced decoder over tokens
    [B, T] and the final norm, without the unembedding -> [B, T, d] in
    the compute type. Records autograd when the parameters require
    grad."""
    kv = _cross_kv_layers(params, cfg, encode(params, cfg, frames))
    x = tfm._embed(params, cfg, tokens)
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    x = _decoder_trunk(params, cfg, x, positions, kv)
    return rms_norm(x, params["final_norm"], cfg.norm_eps)


def forward(params, cfg: ModelConfig, frames: torch.Tensor,
            tokens: torch.Tensor) -> torch.Tensor:
    """Training forward: encoder + teacher-forced decoder -> fp32 logits
    [B, T, V]."""
    x = final_hidden(params, cfg, frames, tokens)
    return unembed(x, params.get("unembed", params["embedding"]))


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype: Optional[torch.dtype] = None, device=None,
               abstract: bool = False) -> dict:
    """The decoder's zeroed slot cache (`transformer.init_cache`) plus
    "cross_kv" {"k", "v"} of [L, batch, n_frames, H, hd], all in `dtype`
    (default: the compute type). With `abstract` the leaves are
    AbstractParams with JAX's logical axes (the cross leaves'
    ("layers", "batch", "seq", "heads", "head_dim")) and nothing is
    allocated."""
    dtype = dtype or cfg.cdtype()
    device = None if abstract else resolve_device(device)
    cache = tfm.init_cache(cfg, batch, max_len, dtype=dtype, device=device,
                           abstract=abstract)
    shape = (cfg.n_layers, batch, cfg.encoder.n_frames, cfg.n_heads,
             cfg.head_dim)
    axes = ("layers", "batch", "seq", "heads", "head_dim")
    cache["cross_kv"] = {n: buffer(shape, axes, abstract, dtype=dtype,
                                   device=device) for n in ("k", "v")}
    return cache


def _layer_views(kv: dict, L: int) -> List[dict]:
    return [{n: leaf[i] for n, leaf in kv.items()} for i in range(L)]


@torch.inference_mode()
def prefill(params, cfg: ModelConfig, frames: torch.Tensor,
            tokens: torch.Tensor, cache: dict, last_only: bool = False,
            paged_kernel: Optional[bool] = None):
    """Encode the frames, write each layer's cross K/V into
    ``cache["cross_kv"]`` (cast to the cache type) and prefill the
    decoder prompt tokens [B, T] into the self-attention cache, in place.
    The decoder attends over the cache-typed cross K/V, as JAX's prefill
    does. Returns (fp32 logits [B, T or 1, V], cache)."""
    enc_out = encode(params, cfg, frames, paged_kernel)
    kv = _layer_views(cache["cross_kv"], cfg.n_layers)
    for dst, src in zip(kv, _cross_kv_layers(params, cfg, enc_out)):
        dst["k"].copy_(src["k"])
        dst["v"].copy_(src["v"])
    x = tfm._embed(params, cfg, tokens)
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    x = _decoder_trunk(params, cfg, x, positions, kv, cache["dense"],
                       paged_kernel=paged_kernel)
    if last_only:
        x = x[:, -1:, :]
    return tfm._logits(params, cfg, x), cache


def decode_hidden(params, cfg: ModelConfig, token: torch.Tensor, position,
                  cache: dict, paged_kernel: Optional[bool] = None,
                  ctx=None) -> torch.Tensor:
    """One decoder step's final hidden states [B, 1, d] (before the final
    norm) at `position` (a scalar or an int vector [B]), the
    self-attention cache written in place. The cross K/V are read in the
    compute type, as JAX's decode step casts them."""
    if token.dim() == 1:
        token = token[:, None]
    x = tfm._embed(params, cfg, token)
    kv = [{n: t.to(cfg.cdtype()) for n, t in layer.items()}
          for layer in _layer_views(cache["cross_kv"], cfg.n_layers)]
    return _decoder_trunk(params, cfg, x, None, kv, cache["dense"],
                          decode=True, position=position,
                          paged_kernel=paged_kernel, ctx=ctx)


@torch.inference_mode()
def decode_step(params, cfg: ModelConfig, token: torch.Tensor, position,
                cache: dict, paged_kernel: Optional[bool] = None,
                ctx=None):
    """One-token decode: token [B] or [B, 1] at `position`. Returns (fp32
    logits [B, V], cache)."""
    x = decode_hidden(params, cfg, token, position, cache, paged_kernel,
                      ctx)
    return tfm._logits(params, cfg, x)[:, 0, :], cache
