"""Decoder LM for ``family="dense"``, ``"moe"``, ``"ssm_rwkv"``,
``"hybrid"`` and ``"vlm"``: init, caches, prefill, one-token decode; and
the parameters of the ``"encdec"`` family, whose model is
`models.encdec`.

Counterpart of `repro.models.transformer` for dense and MoE decoders with
GQA or MLA attention, for the attention-free RWKV6, for the Mamba2
hybrid (zamba2) and for the VLM decoder, whose stub frontend's patch
embeddings [B, P, d] (`extra_embeds`) are prepended to the token
embeddings. The parameter tree has the JAX package's layout —
homogeneous layer groups stacked on a leading ``[L, ...]`` axis under
``params["blocks"]["dense"]`` and ``["moe"]`` (the MoE family's leading
dense layers, then its MoE layers), ``["rwkv"]`` or ``["mamba"]``, the
hybrid's ONE shared attention + MLP block under ``["shared_attn"]`` with
no layer axis — and the layers run as a Python loop over each group (the
JAX package folds them with `lax.scan` unless ``scan_layers=False``; the
loop computes what that unscanned path computes, the only one JAX defines
for a bf16 RWKV model, so the port accepts either value of `scan_layers`
and refuses no bf16 RWKV model). Caches are stacked the same way,
``[L, batch, ...]``, and are written in place: GQA / MLA K/V, the RWKV
state (token-shift rows in the cache type, the recurrence state S in
fp32), or the Mamba2 state (the convolution's history in the cache type,
S in fp32) and the shared block's K/V, one entry per call of the block,
``[n_calls, batch, ...]``.
An encoder-decoder's decoder layers sit under ``["dense"]`` with GELU
MLPs, and its encoder under ``params["encoder"]``: ``"stack"`` (its
``[E, ...]`` self-attention + GELU MLP blocks), ``"final_norm"``, and
``"cross"`` / ``"cross_norm"``, stacked over the decoder's layers.

A sliding window bounds a GQA cache at ``min(max_len, window)``
positions, a ring when the window is the shorter (`models.attention`);
the hybrid's shared block attends over a cache of ``min(kv_len, 4096)``
positions with that length as its window, as in JAX.

API:
    init_params(cfg, seed, device)              -> params
    forward(params, cfg, tokens, return_aux, extra_embeds)
                                                -> logits [B, T, V] (, aux)
    final_hidden(params, cfg, tokens, extra_embeds) -> (x [B, T, d], aux)
    init_cache(cfg, batch, max_len, dtype, device) -> cache
    prefill(params, cfg, tokens, cache, ...)    -> (logits, cache)
    decode_step(params, cfg, token, position, cache, ...) -> (logits, cache)

`forward` and `final_hidden` are the training entry points: they record
autograd's graph when the parameters require grad, and then apply the
config's `remat` to every layer of a group loop (`_maybe_remat`; not to
the hybrid's shared block, as in JAX). `prefill` and `decode_step`
serve, under `torch.inference_mode()`.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Dict, Optional

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch import resolve_device
from repro_torch.configs import ModelConfig
from repro_torch.kernels import ops as kernel_ops
from repro_torch.models import attention as attn_lib
from repro_torch.models import ffn as ffn_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.models.common import (ParamInit, buffer, embed_tokens,
                                       lead, lead_axes, rms_norm, unembed)

_ATTN_FAMILIES = ("dense", "moe")
_SERVED_FAMILIES = _ATTN_FAMILIES + ("ssm_rwkv", "hybrid")
_STEP_FAMILIES = ("encdec", "vlm")   # frames / patches: launch.steps only
SHARED_ATTN_MAX_LEN = 4096    # the hybrid's shared block: its longest cache


def check_ported(cfg: ModelConfig, training: bool = False,
                 engine: bool = False) -> None:
    """Raise NotImplementedError, naming ROADMAP.md, unless the port runs
    `cfg`: dense and MoE decoders (GQA or MLA), RWKV6 and the Mamba2
    hybrid, for serving (slot backend for the recurrent ones) and for
    training alike, a sliding window on GQA included. A window on MLA is
    refused either way: JAX's `mla_forward` has none. The
    encoder-decoder and VLM families take frames or patches, which only
    `launch.steps`' builders take: they pass for serving and training
    there, and fail with `engine` (the serving engine and the serve and
    train CLIs, which take token prompts, as the JAX package's do).
    Raise ValueError for an encdec config without its EncoderSpec or a
    vlm one without its VisionSpec. (`training` is kept for callers that
    name the path; every family passes both ways.)"""
    if cfg.family == "encdec" and cfg.encoder is None:
        raise ValueError(f"{cfg.name}: an encdec config needs an EncoderSpec")
    if cfg.family == "vlm" and cfg.vision is None:
        raise ValueError(f"{cfg.name}: a vlm config needs a VisionSpec")
    if engine and cfg.family in _STEP_FAMILIES:
        raise NotImplementedError(
            f"family {cfg.family!r} takes "
            f"{'frames' if cfg.family == 'encdec' else 'patches'}, which "
            f"the serving engine and the serve and train CLIs do not take "
            f"(nor do the JAX package's): it runs through launch.steps' "
            f"make_prefill, make_serve_step and make_train_step (see "
            f"ROADMAP.md)")
    families = _SERVED_FAMILIES + _STEP_FAMILIES
    if cfg.family not in families or (cfg.sliding_window is not None
                                      and cfg.mla is not None):
        raise NotImplementedError(
            f"family {cfg.family!r} (sliding_window={cfg.sliding_window}"
            f"{', MLA' if cfg.mla else ''}) is not ported for "
            f"{'training' if training else 'serving'}: the port runs "
            f"families {families}, a sliding window on GQA only (JAX's "
            f"MLA has no window; see ROADMAP.md)")


def attn_config(cfg: ModelConfig) -> attn_lib.AttnConfig:
    """The attention of a dense, MoE, VLM or encoder-decoder decoder (the
    encoder's with ``causal=False``), or the hybrid's shared block (an
    RWKV model has none)."""
    check_ported(cfg)
    if cfg.attention_free:
        raise NotImplementedError(f"family {cfg.family!r} has no attention")
    mla = cfg.mla
    return attn_lib.AttnConfig(
        d_model=cfg.d_model, n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
        head_dim=cfg.head_dim, qkv_bias=cfg.qkv_bias,
        rope_theta=cfg.rope_theta, sliding_window=cfg.sliding_window,
        q_lora=mla.q_lora if mla else 0,
        kv_lora=mla.kv_lora if mla else 0,
        rope_dim=mla.rope_dim if mla else 64,
        v_head_dim=mla.v_head_dim if mla else 0,
        attn_chunk=cfg.attn_chunk)


def rwkv_config(cfg: ModelConfig) -> ssm_lib.RWKVConfig:
    return ssm_lib.RWKVConfig(cfg.d_model, cfg.d_ff, head_dim=cfg.head_dim
                              if cfg.head_dim <= cfg.d_model else 64)


def mamba_config(cfg: ModelConfig) -> ssm_lib.Mamba2Config:
    return ssm_lib.Mamba2Config(cfg.d_model, d_state=cfg.ssm_state,
                                head_dim=cfg.ssm_head_dim)


def moe_config(cfg: ModelConfig) -> ffn_lib.MoEConfig:
    m = cfg.moe
    return ffn_lib.MoEConfig(
        d_model=cfg.d_model, d_ff=m.d_ff_expert, n_experts=m.n_experts,
        top_k=m.top_k, n_shared_experts=m.n_shared_experts,
        shared_d_ff=m.shared_d_ff, capacity_factor=m.capacity_factor)


def _group_sizes(cfg: ModelConfig) -> Dict[str, int]:
    """Stacked layer-group sizes, in trunk order (dense, VLM and enc-dec:
    one dense group of n_layers)."""
    if cfg.family == "moe":
        nd = cfg.moe.n_dense_layers
        return {"dense": nd, "moe": cfg.n_layers - nd}
    if cfg.family == "ssm_rwkv":
        return {"rwkv": cfg.n_layers}
    if cfg.family == "hybrid":
        return {"mamba": cfg.n_layers}
    return {"dense": cfg.n_layers}


def shared_attn_calls(cfg: ModelConfig) -> int:
    """How many times the hybrid's trunk calls its shared block: once
    after every `shared_attn_every` Mamba2 layers (0 for other families,
    and for a hybrid shallower than its period)."""
    every = cfg.shared_attn_every if cfg.family == "hybrid" else 0
    return cfg.n_layers // every if every else 0


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

def _init_attn(pi: ParamInit, cfg: ModelConfig, L: int) -> dict:
    d, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    ld, LA = lead(L), lead_axes(L)
    if cfg.mla:
        m = cfg.mla
        dr, dv = m.rope_dim, m.v_head_dim or hd
        up = LA + ("kv_lora", "heads", "head_dim")
        return {"wdq": pi.normal(ld + (d, m.q_lora), fan_in=d,
                                 axes=LA + ("embed", "q_lora")),
                "q_norm": pi.zeros(ld + (m.q_lora,), LA + ("q_lora",)),
                "wuq": pi.normal(ld + (m.q_lora, H, hd + dr), fan_in=m.q_lora,
                                 axes=LA + ("q_lora", "heads", "head_dim")),
                "wdkv": pi.normal(ld + (d, m.kv_lora), fan_in=d,
                                  axes=LA + ("embed", "kv_lora")),
                "kv_norm": pi.zeros(ld + (m.kv_lora,), LA + ("kv_lora",)),
                "wkr": pi.normal(ld + (d, dr), fan_in=d,
                                 axes=LA + ("embed", "head_dim")),
                "wuk": pi.normal(ld + (m.kv_lora, H, hd), fan_in=m.kv_lora,
                                 axes=up),
                "wuv": pi.normal(ld + (m.kv_lora, H, dv), fan_in=m.kv_lora,
                                 axes=up),
                "wo": pi.normal(ld + (H, dv, d), fan_in=H * dv,
                                axes=LA + ("heads", "head_dim", "embed"))}
    kv = LA + ("embed", "kv_heads", "head_dim")
    attn = {"wq": pi.normal(ld + (d, H, hd), fan_in=d,
                            axes=LA + ("embed", "heads", "head_dim")),
            "wk": pi.normal(ld + (d, KV, hd), fan_in=d, axes=kv),
            "wv": pi.normal(ld + (d, KV, hd), fan_in=d, axes=kv),
            "wo": pi.normal(ld + (H, hd, d), fan_in=H * hd,
                            axes=LA + ("heads", "head_dim", "embed"))}
    if cfg.qkv_bias:
        attn.update(bq=pi.zeros(ld + (H, hd), LA + ("heads", "head_dim")),
                    bk=pi.zeros(ld + (KV, hd), LA + ("kv_heads", "head_dim")),
                    bv=pi.zeros(ld + (KV, hd), LA + ("kv_heads", "head_dim")))
    return attn


def _init_mlp(pi: ParamInit, L: int, d: int, f: int,
              activation: str = "swiglu") -> dict:
    """SwiGLU (w_gate, w_up, w_down) or GELU (w_up, w_down and the
    zero-initialised biases b_up, b_down) weights."""
    ld, LA = lead(L), lead_axes(L)
    mlp = {"w_up": pi.normal(ld + (d, f), fan_in=d, axes=LA + ("embed", "ffn")),
           "w_down": pi.normal(ld + (f, d), fan_in=f,
                               axes=LA + ("ffn", "embed"))}
    if activation == "swiglu":
        mlp["w_gate"] = pi.normal(ld + (d, f), fan_in=d,
                                  axes=LA + ("embed", "ffn"))
    else:
        mlp.update(b_up=pi.zeros(ld + (f,), LA + ("ffn",)),
                   b_down=pi.zeros(ld + (d,), LA + ("act_embed",)))
    return mlp


def _norm(pi: ParamInit, L: int, d: int):
    return pi.zeros(lead(L) + (d,), lead_axes(L) + ("act_embed",))


def _init_attn_mlp_block(pi: ParamInit, cfg: ModelConfig, L: int,
                         activation: str = "swiglu") -> dict:
    return {"norm1": _norm(pi, L, cfg.d_model),
            "attn": _init_attn(pi, cfg, L),
            "norm2": _norm(pi, L, cfg.d_model),
            "mlp": _init_mlp(pi, L, cfg.d_model, cfg.d_ff, activation)}


def _init_encoder(pi: ParamInit, cfg: ModelConfig) -> dict:
    """The encoder stack (bidirectional self-attention + GELU MLP, E
    layers), its final norm, and the decoder's cross-attention and its
    norm, stacked over the decoder's layers — JAX's `_init_encoder`."""
    L, d = cfg.n_layers, cfg.d_model
    return {"stack": _init_attn_mlp_block(pi, cfg, cfg.encoder.n_layers,
                                          "gelu"),
            "final_norm": _norm(pi, 0, d),
            "cross": attn_lib.init_cross_attn(pi, attn_config(cfg), L),
            "cross_norm": _norm(pi, L, d)}


def init_params(cfg: ModelConfig, seed: int = 0, device=None,
                abstract: bool = False) -> dict:
    """Seeded random weights with the JAX package's shapes and layout (the
    MoE router in fp32 whatever the parameter type, as in JAX; the
    hybrid's shared block built whenever its period is set, as in JAX,
    even when the trunk is too shallow to call it; an encoder-decoder's
    GELU decoder blocks and its "encoder" subtree). With `abstract` the
    tree's leaves are `sharding.AbstractParam`s carrying JAX's logical
    axes (the port's sharding plan), and nothing is drawn or allocated."""
    check_ported(cfg)
    pi = ParamInit(seed, cfg.pdtype(),
                   None if abstract else resolve_device(device), abstract)
    d, V = cfg.d_model, cfg.vocab_size
    params: Dict[str, Any] = {
        "embedding": pi.normal((V, d), fan_in=d, axes=("vocab", "embed")),
        "final_norm": _norm(pi, 0, d),
    }
    if not cfg.tie_embeddings:
        params["unembed"] = pi.normal((V, d), fan_in=d,
                                      axes=("vocab", "embed"))
    blocks: Dict[str, Any] = {}
    for kind, L in _group_sizes(cfg).items():
        if not L:
            continue
        if kind == "rwkv":
            blocks[kind] = ssm_lib.init_rwkv_block(pi, rwkv_config(cfg), L)
            continue
        if kind == "mamba":
            blocks[kind] = ssm_lib.init_mamba2_block(pi, mamba_config(cfg),
                                                     L)
            if cfg.shared_attn_every:
                blocks["shared_attn"] = _init_attn_mlp_block(pi, cfg, 0)
            continue
        if kind == "dense":
            act = "gelu" if cfg.family == "encdec" else "swiglu"
            blocks[kind] = _init_attn_mlp_block(pi, cfg, L, act)
            continue
        b = {"norm1": _norm(pi, L, d), "attn": _init_attn(pi, cfg, L),
             "norm2": _norm(pi, L, d)}
        m = cfg.moe
        E, f = m.n_experts, m.d_ff_expert
        ex = ("layers", "experts", "expert_embed", "expert_ffn")
        b["moe"] = {
            "router": pi.normal((L, d, E), fan_in=d, dtype=torch.float32,
                                axes=("layers", "embed", "experts")),
            "w_gate": pi.normal((L, E, d, f), fan_in=d, axes=ex),
            "w_up": pi.normal((L, E, d, f), fan_in=d, axes=ex),
            "w_down": pi.normal((L, E, f, d), fan_in=f,
                                axes=("layers", "experts", "expert_ffn",
                                      "expert_embed"))}
        if m.n_shared_experts > 0:
            b["moe"]["shared"] = _init_mlp(
                pi, L, d, m.shared_d_ff or f * m.n_shared_experts)
        blocks[kind] = b
    params["blocks"] = blocks
    if cfg.encoder is not None:
        params["encoder"] = _init_encoder(pi, cfg)
    return params


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype: Optional[torch.dtype] = None, device=None,
               abstract: bool = False) -> dict:
    """Zeroed caches, one per layer group: GQA {"k", "v"} of [L, batch,
    kv_len, KV, hd] (kv_len = max_len, or min(max_len, sliding window));
    MLA {"ckv", "kr"} of [L, batch, max_len, kv_lora | rope_dim]; RWKV
    {"shift1", "shift2"} of [L, batch, d] and fp32 {"S"} of [L, batch, H,
    hd, hd]; Mamba2 {"conv"} of [L, batch, W-1, d_inner + 2 d_state] and
    fp32 {"S"} of [L, batch, H, d_state, head_dim], whatever `max_len`;
    the hybrid's shared block {"k", "v"} of [calls, batch, min(kv_len,
    4096), KV, hd], and no such leaf when the trunk never calls the block
    (JAX makes one without the calls axis, which no trunk reads). `dtype`
    types every leaf but the fp32 S. With batch = n_blocks + 1 and
    max_len = block_size the attention caches are exactly the paged
    layout (block 0 = trash). Every leaf has its batch at axis 1. With
    `abstract` the leaves are AbstractParams with JAX's logical axes
    (``cache_seq`` on the sequence dim) and nothing is allocated."""
    kw = dict(dtype=dtype or cfg.cdtype(),
              device=None if abstract else resolve_device(device))
    kv_len = (min(max_len, cfg.sliding_window) if cfg.sliding_window
              else max_len)
    kv_axes = ("layers", "batch", "cache_seq", "kv_heads", "head_dim")
    cache = {}
    for kind, L in _group_sizes(cfg).items():
        if not L:
            continue
        if kind == "rwkv":
            cache[kind] = ssm_lib.init_rwkv_state(rwkv_config(cfg), batch,
                                                  L=L, abstract=abstract,
                                                  **kw)
            continue
        if kind == "mamba":
            cache[kind] = ssm_lib.init_mamba2_state(
                mamba_config(cfg), batch, L=L, abstract=abstract, **kw)
            n_calls = shared_attn_calls(cfg)
            if n_calls:
                shape = (n_calls, batch, min(kv_len, SHARED_ATTN_MAX_LEN),
                         cfg.n_kv_heads, cfg.head_dim)
                cache["shared_attn"] = {
                    n: buffer(shape, kv_axes, abstract, **kw)
                    for n in ("k", "v")}
            continue
        ld = (L, batch, kv_len)
        if cfg.mla:
            la = ("layers", "batch", "cache_seq")
            cache[kind] = {
                "ckv": buffer(ld + (cfg.mla.kv_lora,), la + ("kv_lora",),
                              abstract, **kw),
                "kr": buffer(ld + (cfg.mla.rope_dim,), la + ("head_dim",),
                             abstract, **kw)}
        else:
            shape = ld + (cfg.n_kv_heads, cfg.head_dim)
            cache[kind] = {n: buffer(shape, kv_axes, abstract, **kw)
                           for n in ("k", "v")}
    return cache


def param_device(params: dict) -> torch.device:
    return params["embedding"].device


# ---------------------------------------------------------------------------
# Remat
# ---------------------------------------------------------------------------

REMAT_MODES = ("none", "full", "dots")
_MATMULS = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
            torch.ops.aten.addmm.default)


def _is_param(t) -> bool:
    """A parameter (a leaf that requires grad) or a view of one."""
    if not isinstance(t, torch.Tensor):
        return False
    base = t._base if t._base is not None else t
    return base.is_leaf and base.requires_grad


def _dots_policy(ctx, op, *args, **kwargs):
    """JAX's `checkpoint_dots_with_no_batch_dims` for the port's ops: keep
    the output of a weight product with no batch dimension, recompute
    everything else. At the aten level `torch.einsum` lowers a projection
    ("btd,dhk->bthk") and an attention score ("btkgh,bskh->bkgts") alike
    to `bmm`, so the rule goes by the operands: a product is kept when
    one operand is a parameter or a view of one (what `models.common.
    einsum` and `models.ssm._mm` pass for every weight: its stacked
    layer's `unbind` view, reshaped) and it has no batch, i.e. it is an
    `mm` / `addmm`, or a `bmm` of batch 1 (an einsum without batch
    dimensions folds every free one into the matrices). Scores, P @ V and
    the recurrence multiply activations only; RWKV6's per-stream mixing
    ("btsr,srd->btsd", batch 5) has a batch dimension, as in JAX. The MoE
    experts' products are kept here (JAX's `ragged_dot` is no
    `dot_general`, so JAX recomputes them): a memory choice, not a change
    of value."""
    if (op in _MATMULS and any(_is_param(a) for a in args)
            and (op is not torch.ops.aten.bmm.default
                 or args[0].shape[0] == 1)):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _dots_contexts():
    return create_selective_checkpoint_contexts(_dots_policy)


def _maybe_remat(fn: Callable, cfg: ModelConfig) -> Callable:
    """`fn` (one layer) under the config's `remat`, JAX's `_maybe_remat`:
    "none" is `fn`; "full" keeps only the layer's inputs and recomputes
    the rest in the backward (`torch.utils.checkpoint`, non-reentrant);
    "dots" also keeps the weight products' outputs (`_dots_policy`). Any
    other value raises ValueError, as JAX does. Applied only when autograd
    records: under inference mode or `no_grad` it is `fn`. A kernel the
    recompute reaches (`wkv_scan` through `wkv_scan_fused`) launches
    again, writing a buffer it allocates then."""
    if cfg.remat not in REMAT_MODES:
        raise ValueError(cfg.remat)
    if cfg.remat == "none" or not torch.is_grad_enabled():
        return fn
    kw = {"context_fn": _dots_contexts} if cfg.remat == "dots" else {}
    return functools.partial(checkpoint, fn, use_reentrant=False, **kw)


# ---------------------------------------------------------------------------
# Trunk
# ---------------------------------------------------------------------------

def _layers(tree: dict, n: int) -> list:
    """The `n` per-layer views of a stacked group, one `torch.unbind` per
    leaf: autograd then stacks each leaf's per-layer gradients once,
    where indexing ``w[i]`` layer by layer would add a zero-filled
    full-size gradient per layer."""
    split = {k: (_layers(v, n) if isinstance(v, dict) else torch.unbind(v))
             for k, v in tree.items()}
    return [{k: v[i] for k, v in split.items()} for i in range(n)]


def _attn_ffn_block(p, cfg: ModelConfig, ac: attn_lib.AttnConfig, x,
                    positions, c, cache_offset, decode, position, pages,
                    paged_kernel, mc=None, ctx=None):
    """One pre-norm block: attention or MLA, then the dense MLP (`p`
    holds "mlp") or the MoE FFN (`mc`). `ctx` reaches the GQA decode
    (its sequence-sharded path) and the MoE (its expert-parallel paths;
    `decode` picks the decode path). Returns (x, MoE aux loss or
    None)."""
    if cfg.mla:          # MLA prefill has no kernel, its decode no mesh path
        fwd, dec = attn_lib.mla_forward, attn_lib.mla_decode
        fwd_kw, dec_kw = {}, {}
    else:
        fwd, dec = attn_lib.gqa_forward, attn_lib.gqa_decode
        fwd_kw, dec_kw = {"paged_kernel": paged_kernel}, {"ctx": ctx}
    h = rms_norm(x, p["norm1"], cfg.norm_eps)
    if decode:
        y, _ = dec(p["attn"], ac, h, position, c, pages=pages,
                   paged_kernel=paged_kernel, **dec_kw)
    else:
        y, _ = fwd(p["attn"], ac, h, positions, c, cache_offset, pages=pages,
                   **fwd_kw)
    x = x + y
    h = rms_norm(x, p["norm2"], cfg.norm_eps)
    if mc is not None:
        y, aux = ffn_lib.moe_forward(p["moe"], mc, h, ctx, decode)
        return x + y, aux
    return x + ffn_lib.mlp_forward(p["mlp"], h), None


def _trunk(params, cfg: ModelConfig, x, positions, cache=None,
           cache_offset: int = 0, decode: bool = False, position=None,
           pages=None, paged_kernel=None, ctx=None):
    """Pre-norm blocks over each stacked layer group in order (attention or
    MLA, then the dense MLP or the MoE FFN; or RWKV6 blocks; or Mamba2
    blocks with the shared block between them), each layer under
    `_maybe_remat`. Returns (x, cache, aux):
    aux is the fp32 sum of the MoE layers' load-balance losses (0 for the
    other families)."""
    if cfg.family == "encdec":
        raise ValueError(f"{cfg.name}: an encoder-decoder runs through "
                         f"models.encdec")
    if cfg.family == "ssm_rwkv":
        return _rwkv_trunk(params, cfg, x, cache, pages, paged_kernel)
    if cfg.family == "hybrid":
        return _hybrid_trunk(params, cfg, x, positions, cache, cache_offset,
                             decode, position, pages, paged_kernel, ctx)
    ac = attn_config(cfg)
    mc = moe_config(cfg) if cfg.moe else None
    aux_sum = torch.zeros((), dtype=torch.float32, device=x.device)
    for kind, L in _group_sizes(cfg).items():
        if not L:
            continue
        stacked = cache[kind] if cache is not None else None

        def block(p, x, c, _mc=mc if kind == "moe" else None):
            return _attn_ffn_block(p, cfg, ac, x, positions, c, cache_offset,
                                   decode, position, pages, paged_kernel, _mc,
                                   ctx)
        blk = _maybe_remat(block, cfg)
        for i, p in enumerate(_layers(params["blocks"][kind], L)):
            c = (None if stacked is None
                 else {name: leaf[i] for name, leaf in stacked.items()})
            x, aux = blk(p, x, c)
            if aux is not None:
                aux_sum = aux_sum + aux
    return x, cache, aux_sum


def _recurrent_rows(cache, kind: str, i: int, pages):
    """Layer `i`'s rows of a recurrent state group (None without a
    cache); a page table is refused: a state cannot be paged."""
    if pages is not None:
        raise NotImplementedError(
            f"a {kind!r} model keeps a recurrent state, which cannot be "
            f"paged: serve it on the slot backend")
    if cache is None:
        return None
    return {name: leaf[i] for name, leaf in cache[kind].items()}


def _rwkv_trunk(params, cfg: ModelConfig, x, cache, pages, paged_kernel):
    """The RWKV6 layer loop, each layer under `_maybe_remat`. A cache's
    rows are this call's carried state, written back in place (the shift
    rows cast to the cache's type); no cache means a fresh zero state.
    `paged_kernel` (None: on for CUDA) runs the recurrence through the
    `wkv_scan` kernel."""
    rc = rwkv_config(cfg)
    use_kernel = kernel_ops.paged_kernel_enabled(paged_kernel, x.device)
    L = _group_sizes(cfg)["rwkv"]
    blk = _maybe_remat(functools.partial(ssm_lib.rwkv_block_forward,
                                         cfg=rc, paged_kernel=use_kernel),
                       cfg)
    for i, p in enumerate(_layers(params["blocks"]["rwkv"], L)):
        st = _recurrent_rows(cache, "rwkv", i, pages)
        x, new = blk(p, x=x, state=st)
        if st is not None:
            st["shift1"].copy_(new["shift1"])
            st["shift2"].copy_(new["shift2"])
    return x, cache, torch.zeros((), dtype=torch.float32, device=x.device)


def _hybrid_trunk(params, cfg: ModelConfig, x, positions, cache,
                  cache_offset, decode, position, pages, paged_kernel,
                  ctx=None):
    """The Mamba2 layer loop, each Mamba2 layer under `_maybe_remat`, with
    the ONE shared attention + MLP block (not remat'd, as in JAX) after
    every `shared_attn_every` layers (zamba2's super-blocks; none when
    the period is 0). A cache's Mamba2 rows are this call's carried
    state, written back in place (the convolution's history cast to the
    cache's type); the shared block's g-th call reads and writes entry g
    of the "shared_attn" cache, a window of its length (4096 positions
    without a cache). `paged_kernel` (None: on for CUDA) runs the
    recurrence through `wkv_scan` and the shared block's prefill through
    `flash_attention`."""
    mc = mamba_config(cfg)
    use_kernel = kernel_ops.paged_kernel_enabled(paged_kernel, x.device)
    every = cfg.shared_attn_every
    sa_cache = cache.get("shared_attn") if cache is not None else None
    if every:
        window = (sa_cache["k"].shape[2] if sa_cache is not None
                  else SHARED_ATTN_MAX_LEN)
        ac = dataclasses.replace(attn_config(cfg), sliding_window=window)
    L = _group_sizes(cfg)["mamba"]
    blk = _maybe_remat(functools.partial(ssm_lib.mamba2_block_forward,
                                         cfg=mc, paged_kernel=use_kernel),
                       cfg)
    for i, p in enumerate(_layers(params["blocks"]["mamba"], L)):
        st = _recurrent_rows(cache, "mamba", i, pages)
        x, new = blk(p, x=x, state=st)
        if st is not None:
            st["conv"].copy_(new["conv"])
        if every and (i + 1) % every == 0:
            g = (i + 1) // every - 1
            c = (None if sa_cache is None
                 else {name: leaf[g] for name, leaf in sa_cache.items()})
            x, _ = _attn_ffn_block(params["blocks"]["shared_attn"], cfg, ac,
                                   x, positions, c, cache_offset, decode,
                                   position, None, use_kernel, ctx=ctx)
    return x, cache, torch.zeros((), dtype=torch.float32, device=x.device)


def _embed(params, cfg: ModelConfig, tokens, extra_embeds=None):
    """Token embeddings in the compute type, with `extra_embeds` [B, P, d]
    (the VLM's stub patch embeddings), cast likewise, in front."""
    x = embed_tokens(params["embedding"], tokens).to(cfg.cdtype())
    if extra_embeds is not None:
        x = torch.cat([extra_embeds.to(x.dtype), x], dim=1)
    return x


def _logits(params, cfg: ModelConfig, x):
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return unembed(x, params.get("unembed", params["embedding"]))


# ---------------------------------------------------------------------------
# Public entry points
# ---------------------------------------------------------------------------

def forward(params, cfg: ModelConfig, tokens: torch.Tensor,
            return_aux: bool = False, extra_embeds=None, ctx=None):
    """Full-sequence forward (training). tokens [B, T] (after
    `extra_embeds` [B, P, d] when given) -> fp32 logits [B, P + T, V],
    and with `return_aux` also the MoE aux-loss sum. `ctx` (a
    `sharding.ParallelContext`) runs the MoE layers expert-parallel."""
    x = _embed(params, cfg, tokens, extra_embeds)
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    x, _, aux = _trunk(params, cfg, x, positions, ctx=ctx)
    logits = _logits(params, cfg, x)
    return (logits, aux) if return_aux else logits


def final_hidden(params, cfg: ModelConfig, tokens: torch.Tensor,
                 extra_embeds=None, ctx=None):
    """The trunk and the final norm, without the unembedding: tokens
    [B, T] (after `extra_embeds` [B, P, d] when given) -> (x [B, P + T, d]
    in the compute type, MoE aux-loss sum). The Stage-2 loss fuses the
    unembedding with its reductions."""
    x = _embed(params, cfg, tokens, extra_embeds)
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    x, _, aux = _trunk(params, cfg, x, positions, ctx=ctx)
    return rms_norm(x, params["final_norm"], cfg.norm_eps), aux


@torch.inference_mode()
def prefill(params, cfg: ModelConfig, tokens: torch.Tensor, cache: dict,
            last_only: bool = False, cache_offset: int = 0,
            pages: Optional[torch.Tensor] = None,
            last_index: Optional[torch.Tensor] = None,
            paged_kernel: Optional[bool] = None, extra_embeds=None,
            ctx=None):
    """Process a prompt (or one chunk of it at absolute offset
    `cache_offset`), filling `cache` in place; `extra_embeds` [B, P, d]
    (the VLM's patches) go in front of the tokens and take positions
    0..P-1. `pages` [B, M] routes the cache through a page table;
    `last_index` ([B]) unembeds that position instead of the last one;
    `last_only` unembeds only the last position; `paged_kernel` picks the
    flash-attention kernel for GQA layers over the plain attention (None:
    on for CUDA); `ctx` runs the MoE layers expert-parallel. Returns
    (logits, cache)."""
    x = _embed(params, cfg, tokens, extra_embeds)
    B, T, _ = x.shape
    positions = torch.arange(T, device=x.device)[None, :] + cache_offset
    x, cache, _ = _trunk(params, cfg, x, positions, cache=cache,
                      cache_offset=cache_offset, pages=pages,
                      paged_kernel=paged_kernel, ctx=ctx)
    if last_index is not None:
        idx = torch.as_tensor(last_index, device=x.device).long()
        x = x[torch.arange(B, device=x.device), idx.expand(B)][:, None, :]
    elif last_only:
        x = x[:, -1:, :]
    return _logits(params, cfg, x), cache


@torch.inference_mode()
def decode_step(params, cfg: ModelConfig, token: torch.Tensor, position,
                cache: dict, pages: Optional[torch.Tensor] = None,
                paged_kernel: Optional[bool] = None, ctx=None):
    """One-token decode. token [B] or [B,1]; `position` a scalar or an int
    vector [B] of per-row depths; `pages` [B, M] routes the cache through
    a page table (needs vector positions); `paged_kernel` picks the
    paged kernels over the plain gather path (None: on for CUDA); `ctx`
    runs the sequence-sharded GQA decode and the MoE decode path.
    Returns (fp32 logits [B, V], cache)."""
    if token.dim() == 1:
        token = token[:, None]
    x = _embed(params, cfg, token)
    x, cache, _ = _trunk(params, cfg, x, None, cache=cache, decode=True,
                      position=position, pages=pages,
                      paged_kernel=paged_kernel, ctx=ctx)
    return _logits(params, cfg, x)[:, 0, :], cache
