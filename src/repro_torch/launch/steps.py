"""Step builders shared by the trainer and the server.

Counterpart of `repro.launch.steps`:

  * `make_train_step` — the Stage-2 Gatekeeper fine-tune step (token loss
    fused with the unembedding, AdamW, gradient accumulation).
  * `make_prefill` — prompt processing; returns the last position's greedy
    token and eq.-8 confidence with the filled cache.
  * `make_serve_step` — one-token decode returning (next token,
    confidence, defer mask, cache); the confidence is the paper's negative
    predictive entropy computed with the step (eq. 8).

Every builder takes the JAX builders' batches: ``batch["tokens"]``, and
``batch["frames"]`` [B, n_frames, d] for an encoder-decoder (whisper's
stub frontend) or ``batch["patches"]`` [B, P, d] for a VLM, prepended to
the tokens (the loss then skips the P patch positions: its targets are
padded in front and its mask zeroes them).

The loss over the vocabulary comes in two implementations of the same
function:

  * `chunked_gatekeeper_loss` — plain PyTorch, the JAX package's
    two-pass vocabulary-chunked algorithm (pass 1: max, log-sum-exp and
    argmax; pass 2: entropy and target logit), differentiated by
    autograd. The CPU path, and the yardstick on the card.
  * `kernels.ops.gatekeeper_loss_fused` — the CUDA kernel
    `gatekeeper_loss_tokens` in the forward, a chunked plain backward.

`make_train_step(loss_kernel=None)` takes the kernel exactly when the
parameters live on CUDA; True or False force one.

The serving signal likewise: `fused_confidence` is the JAX package's
plain vocabulary-chunked (neg_entropy, max_prob, argmax) of the final
hidden states, which never holds [T, V] logits; on the kernel path
(`kernels.ops.paged_kernel_enabled`: an explicit `paged_kernel`, then
REPRO_PAGED_KERNEL, then on for CUDA) `make_serve_step` unembeds the
[B, d] decode states and takes the triple from one `deferral_signal`
launch, and `make_prefill` does the same for the prompts' last tokens
(their prefill attention through the flash kernel).

Every builder takes `ctx` (a `sharding.ParallelContext`, None for one
device), as JAX's do: it reaches the MoE's expert-parallel paths, the
sequence-sharded decode and, under the `unembed_d` rule, the d-sharded
signal (`unembed_logits`: partial logits summed over the d axes, then
the one `deferral_signal` launch or `fused_confidence`'s chunks).
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.configs import ModelConfig
from repro_torch.core.gatekeeper import GatekeeperConfig
from repro_torch.kernels import ops as kernel_ops
from repro_torch.kernels.deferral_entropy import deferral_entropy_plain
from repro_torch.models import encdec as encdec_lib
from repro_torch.models import transformer as tfm
from repro_torch.models.common import rms_norm, unembed
from repro_torch.sharding import (ParallelContext, Spec, all_reduce, axes_of,
                                  take_block)
from repro_torch.training import optim


def chunked_gatekeeper_loss(x_final: torch.Tensor, table: torch.Tensor,
                            targets: torch.Tensor, gk: GatekeeperConfig,
                            valid_mask: Optional[torch.Tensor] = None,
                            n_chunks: int = 16):
    """Gatekeeper token loss fused with the unembedding, two passes over
    vocabulary chunks. x_final [B, S, d]; table [V, d]; targets [B, S].
    `n_chunks` halves until it divides V. Returns (loss, {"l_corr",
    "l_incorr", "frac_correct", "mean_entropy"})."""
    B, S, d = x_final.shape
    V = table.shape[0]
    while V % n_chunks != 0:
        n_chunks //= 2
    Vc = V // n_chunks
    x2 = x_final.reshape(B * S, d).float()     # fp32 logits, as JAX's
    tgt = targets.reshape(B * S).long()        # preferred_element_type
    n = B * S

    def chunk_logits(i):
        return x2 @ table[i * Vc:(i + 1) * Vc].float().t()

    m = torch.full((n,), -math.inf, device=x2.device)
    lse_acc = torch.zeros(n, device=x2.device)
    amax_val = torch.full((n,), -math.inf, device=x2.device)
    preds = torch.zeros(n, dtype=torch.long, device=x2.device)
    for i in range(n_chunks):                    # pass 1
        logits = chunk_logits(i)
        cmax = logits.amax(-1)
        new_m = torch.maximum(m, cmax)
        lse_acc = lse_acc * torch.exp(m - new_m) + torch.exp(
            torch.logsumexp(logits, dim=-1) - new_m)
        m = new_m
        better = cmax > amax_val
        amax_val = torch.where(better, cmax, amax_val)
        preds = torch.where(better, logits.argmax(-1) + i * Vc, preds)
    lse = m + torch.log(lse_acc)

    entropy = torch.zeros(n, device=x2.device)
    tgt_logit = torch.zeros(n, device=x2.device)
    for i in range(n_chunks):                    # pass 2
        logits = chunk_logits(i)
        logp = logits - lse[:, None]
        entropy = entropy - torch.sum(torch.exp(logp) * logp, dim=-1)
        loc = tgt - i * Vc
        in_chunk = (loc >= 0) & (loc < Vc)
        got = logits.gather(1, torch.clamp(loc, 0, Vc - 1)[:, None])[:, 0]
        tgt_logit = torch.where(in_chunk, got, tgt_logit)

    ce = lse - tgt_logit
    kl = math.log(float(V)) - entropy
    correct = (preds == tgt).float().detach()
    valid = (torch.ones_like(correct) if valid_mask is None
             else valid_mask.reshape(n).float())
    return _reduce(ce, kl, correct, entropy, valid, gk.alpha)


def _reduce(ce, kl, correct, entropy, valid, alpha: float):
    denom = torch.clamp(valid.sum(), min=1.0)
    l_corr = (ce * correct * valid).sum() / denom
    l_incorr = (kl * (1 - correct) * valid).sum() / denom
    loss = alpha * l_corr + (1 - alpha) * l_incorr
    aux = {"l_corr": l_corr, "l_incorr": l_incorr,
           "frac_correct": (correct * valid).sum() / denom,
           "mean_entropy": (entropy * valid).sum() / denom}
    return loss, aux


def fused_gatekeeper_loss(x_final: torch.Tensor, table: torch.Tensor,
                          targets: torch.Tensor, gk: GatekeeperConfig,
                          valid_mask: Optional[torch.Tensor] = None):
    """`chunked_gatekeeper_loss`'s function and outputs through
    `kernels.ops.gatekeeper_loss_fused` (one kernel launch on CUDA).

    With a `valid_mask`, only the rows of non-zero weight reach the kernel
    and the backward (one host read of their count): the others add
    nothing to the loss or its denominator, and indexing gives them
    exactly zero gradient, as JAX's gradient does. With no such row the
    loss and its terms are 0 with zero gradients, as JAX's clamped
    denominator gives, and nothing is launched."""
    B, S, d = x_final.shape
    x = x_final.reshape(B * S, d)
    tgt = targets.reshape(B * S)
    v = None
    if valid_mask is not None:
        v = valid_mask.reshape(B * S).float()
        rows = torch.nonzero(v).squeeze(1)
        if rows.numel() == 0:
            zero = (x[:0].sum() + table[:0].sum()).float()
            return zero, {k: zero.detach() for k in (
                "l_corr", "l_incorr", "frac_correct", "mean_entropy")}
        x, tgt, v = x[rows], tgt[rows], v[rows]
    loss, a = kernel_ops.gatekeeper_loss_fused(x, table, tgt, v,
                                               alpha=gk.alpha)
    v = torch.ones_like(a["ce"]) if v is None else v
    denom = torch.clamp(v.sum(), min=1.0)
    return loss, {"l_corr": a["l_corr"], "l_incorr": a["l_incorr"],
                  "frac_correct": (a["correct"] * v).sum() / denom,
                  "mean_entropy": (a["entropy"] * v).sum() / denom}


def _unembed_d_spec(x_final: torch.Tensor,
                    ctx: Optional[ParallelContext]) -> Optional[Spec]:
    """x_final's spec when the `unembed_d` rule splits its d dim into more
    than one block, else None."""
    if ctx is None or ctx.mesh is None:
        return None
    spec = ctx.spec((None, "unembed_d"), x_final.shape)
    return spec if ctx.n_blocks(axes_of(spec[1])) > 1 else None


def unembed_logits(x_final: torch.Tensor, table: torch.Tensor,
                   ctx: Optional[ParallelContext] = None) -> torch.Tensor:
    """fp32 logits [T, V] of x_final [T, d]. Where the `unembed_d` rule
    shards d, each rank contracts its d-slice of x_final with its d-slice
    of the table and the partial logits are summed over those axes."""
    spec = _unembed_d_spec(x_final, ctx)
    if spec is None:
        return unembed(x_final, table)
    part = unembed(take_block(x_final, spec, ctx), take_block(table, spec,
                                                                 ctx))
    return all_reduce(part, axes_of(spec[1]), ctx, "sum")


def decode_signal(x_final: torch.Tensor, table: torch.Tensor,
                  use_kernel: bool, ctx: Optional[ParallelContext] = None):
    """The serve step's (neg_entropy, max_prob, argmax) of x_final [B, d]:
    one `deferral_signal` launch on the (summed, under `unembed_d`)
    logits on the kernel path, `fused_confidence` on the plain one."""
    if use_kernel:
        return kernel_ops.deferral_signal(unembed_logits(x_final, table, ctx))
    return fused_confidence(x_final, table, ctx=ctx)


def fused_confidence(x_final: torch.Tensor, table: torch.Tensor,
                     n_chunks: int = 8,
                     ctx: Optional[ParallelContext] = None):
    """Deferral signal at decode from final hidden states, vocabulary-
    chunked (eqs. 7-8 fused with the unembedding; plain PyTorch): x_final
    [T, d], table [V, d] -> (neg_entropy fp32 [T], max_prob fp32 [T],
    argmax int32 [T]). `n_chunks` halves until it divides V. Two passes:
    max, log-sum-exp and first-index argmax, then the entropy. Where
    `ctx`'s `unembed_d` rule shards d, each chunk's logits are the sum
    over those axes of the ranks' d-slice products (JAX's partial-logit
    psums)."""
    T, d = x_final.shape
    V = table.shape[0]
    while V % n_chunks != 0:
        n_chunks //= 2
    Vc = V // n_chunks
    x2 = x_final.float()
    spec = _unembed_d_spec(x_final, ctx)
    if spec is not None:
        x2, table = take_block(x2, spec, ctx), take_block(table, spec, ctx)

    def chunk_logits(i):
        logits = x2 @ table[i * Vc:(i + 1) * Vc].float().t()
        if spec is None:
            return logits
        return all_reduce(logits, axes_of(spec[1]), ctx, "sum")

    m = torch.full((T,), -math.inf, device=x2.device)
    lse_acc = torch.zeros(T, device=x2.device)
    amax_val = torch.full((T,), -math.inf, device=x2.device)
    amax_idx = torch.zeros(T, dtype=torch.int32, device=x2.device)
    for i in range(n_chunks):                    # pass 1
        logits = chunk_logits(i)
        cmax = logits.amax(-1)
        new_m = torch.maximum(m, cmax)
        lse_acc = lse_acc * torch.exp(m - new_m) + torch.exp(
            torch.logsumexp(logits, dim=-1) - new_m)
        m = new_m
        better = cmax > amax_val
        amax_val = torch.where(better, cmax, amax_val)
        amax_idx = torch.where(
            better, logits.argmax(-1).to(torch.int32) + i * Vc, amax_idx)
    lse = m + torch.log(lse_acc)
    entropy = torch.zeros(T, device=x2.device)
    for i in range(n_chunks):                    # pass 2
        logp = chunk_logits(i) - lse[:, None]
        entropy = entropy - torch.sum(torch.exp(logp) * logp, dim=-1)
    return -entropy, torch.exp(amax_val - lse), amax_idx


def _final_hidden(params, cfg: ModelConfig, batch, ctx=None):
    """(x_final [B, T, d], MoE aux-loss sum, loss mask or None). With
    patches [B, P, d] the sequence is P + T long and the mask is 0 on the
    P patch positions (times any ``batch["loss_mask"]``)."""
    tfm.check_ported(cfg, training=True)
    mask = batch.get("loss_mask")
    if cfg.family == "encdec":
        x = encdec_lib.final_hidden(params, cfg, batch["frames"],
                                    batch["tokens"])
        return x, torch.zeros((), dtype=torch.float32, device=x.device), mask
    extra = batch.get("patches")
    x, aux = tfm.final_hidden(params, cfg, batch["tokens"], extra, ctx)
    if extra is not None:
        P = extra.shape[1]
        m = torch.ones(x.shape[:2], dtype=torch.float32, device=x.device)
        m[:, :P] = 0.0
        mask = m if mask is None else mask * m
    return x, aux, mask


def _pad_targets(cfg: ModelConfig, batch, T: int):
    """Targets aligned with the (possibly patch-extended) sequence: zeros
    in front for prepended positions."""
    tgt = batch["targets"]
    if tgt.shape[1] < T:
        pad = torch.zeros((tgt.shape[0], T - tgt.shape[1]), dtype=tgt.dtype,
                          device=tgt.device)
        tgt = torch.cat([pad, tgt], dim=1)
    return tgt


def make_loss_fn(cfg: ModelConfig, gk: GatekeeperConfig,
                 aux_weight: float = 0.01,
                 loss_kernel: Optional[bool] = None, ctx=None):
    """loss_fn(params, batch) -> (loss + aux_weight * MoE aux, aux)."""

    def loss_fn(params, batch):
        x, model_aux, mask = _final_hidden(params, cfg, batch, ctx)
        table = params.get("unembed", params["embedding"])
        tgt = _pad_targets(cfg, batch, x.shape[1])
        use_kernel = (x.is_cuda if loss_kernel is None else loss_kernel)
        fn = fused_gatekeeper_loss if use_kernel else chunked_gatekeeper_loss
        loss, aux = fn(x, table, tgt, gk, mask)
        return loss + aux_weight * model_aux, aux

    return loss_fn


def make_train_step(cfg: ModelConfig,
                    gk: GatekeeperConfig = GatekeeperConfig(alpha=0.5),
                    opt_cfg: optim.AdamWConfig = optim.AdamWConfig(),
                    aux_weight: float = 0.01, microbatches: int = 1,
                    loss_kernel: Optional[bool] = None, ctx=None):
    """Gatekeeper fine-tune step (paper Stage 2):
    (params, opt_state, batch) -> (params, opt_state, metrics), with the
    parameters and moments updated in place. `microbatches` > 1
    accumulates gradients over equal splits of the batch's first axis.
    `ctx` (a `sharding.ParallelContext`) runs the MoE layers through the
    expert-parallel scatter path; every rank takes the same step."""
    loss_fn = make_loss_fn(cfg, gk, aux_weight, loss_kernel, ctx)

    def train_step(params, opt_state, batch):
        if microbatches > 1:
            B = next(iter(batch.values())).shape[0]
            if B % microbatches:
                raise ValueError(f"batch {B} does not split into "
                                 f"{microbatches} microbatches")
            n = B // microbatches
            loss, aux, grads = 0.0, None, None
            for i in range(microbatches):
                mb = {k: v[i * n:(i + 1) * n] for k, v in batch.items()}
                (l_i, a_i), g_i = optim.value_and_grad(loss_fn, params, mb)
                loss = loss + l_i
                aux = a_i if aux is None else {k: aux[k] + a_i[k] for k in aux}
                grads = g_i if grads is None else optim.tree_map(
                    torch.add, grads, g_i)
            inv = 1.0 / microbatches
            loss = loss * inv
            aux = {k: v * inv for k, v in aux.items()}
            grads = optim.tree_map(lambda g: g * inv, grads)
        else:
            (loss, aux), grads = optim.value_and_grad(loss_fn, params, batch)
        params, opt_state, om = optim.adamw_update(opt_cfg, grads, opt_state,
                                                   params)
        return params, opt_state, {**aux, **om, "loss": loss}

    return train_step


def make_prefill(cfg: ModelConfig, paged_kernel: Optional[bool] = None,
                 ctx=None):
    """prefill_fn(params, cache, batch) -> (greedy token int32 [B], eq.-8
    negative entropy fp32 [B] of the last prompt position, cache).
    `batch["tokens"]` [B, T] (after `batch["patches"]` for a VLM, or
    with `batch["frames"]` for an encoder-decoder) fills `cache` (from
    `tfm.init_cache`, or `encdec.init_cache`) in place; `paged_kernel`
    picks the kernel path (None: on for CUDA); `ctx` runs the MoE layers
    expert-parallel."""
    tfm.check_ported(cfg)

    def prefill_fn(params, cache, batch):
        use_kernel = kernel_ops.paged_kernel_enabled(
            paged_kernel, tfm.param_device(params))
        if cfg.family == "encdec":
            logits, cache = encdec_lib.prefill(
                params, cfg, batch["frames"], batch["tokens"], cache,
                last_only=True, paged_kernel=use_kernel)
        else:
            logits, cache = tfm.prefill(
                params, cfg, batch["tokens"], cache, last_only=True,
                paged_kernel=use_kernel, extra_embeds=batch.get("patches"),
                ctx=ctx)
        signal = (kernel_ops.deferral_signal if use_kernel
                  else deferral_entropy_plain)
        neg_ent, _, tok = signal(logits[:, -1, :])
        return tok, neg_ent, cache

    return prefill_fn


def make_serve_step(cfg: ModelConfig, tau: float = -1.0,
                    paged_kernel: Optional[bool] = None, ctx=None):
    """One-token decode with the deferral signal:
    serve_step(params, cache, token, position) -> (next token int32 [B],
    confidence fp32 [B], defer [B] bool, cache). The plain path is
    `fused_confidence`; the kernel path unembeds and takes one
    `deferral_signal` launch (None: on for CUDA) (`decode_signal`). An
    encoder-decoder's cache holds the cross K/V its prefill wrote. `ctx`
    runs the sequence-sharded decode, the MoE decode path and the
    `unembed_d`-sharded signal."""
    tfm.check_ported(cfg)

    @torch.inference_mode()
    def serve_step(params, cache, token, position):
        use_kernel = kernel_ops.paged_kernel_enabled(
            paged_kernel, tfm.param_device(params))
        x, cache = _decode_hidden(params, cfg, token, position, cache,
                                  paged_kernel=use_kernel, ctx=ctx)
        table = params.get("unembed", params["embedding"])
        neg_ent, _, nxt = decode_signal(x, table, use_kernel, ctx)
        defer = neg_ent < tau          # eq. (6): route to M_L
        return nxt, neg_ent, defer, cache

    return serve_step


def _decode_hidden(params, cfg: ModelConfig, token, position, cache,
                   paged_kernel: Optional[bool] = None, ctx=None):
    """One decode step's final hidden states [B, d] (after the final norm,
    before the unembedding), the cache written in place."""
    if cfg.family == "encdec":
        x = encdec_lib.decode_hidden(params, cfg, token, position, cache,
                                     paged_kernel=paged_kernel, ctx=ctx)
    else:
        if token.dim() == 1:
            token = token[:, None]
        x = tfm._embed(params, cfg, token)
        x, cache, _ = tfm._trunk(params, cfg, x, None, cache=cache,
                                 decode=True, position=position,
                                 paged_kernel=paged_kernel, ctx=ctx)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return x[:, 0, :], cache
