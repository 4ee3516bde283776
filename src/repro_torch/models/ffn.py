"""Feed-forward blocks: the dense MLP (SwiGLU or GELU) and
Mixture-of-Experts, single-device and expert-parallel.

Counterpart of `repro.models.ffn`. The router runs in fp32 and
renormalises the top-k gates to sum 1; the shared
experts are a dense SwiGLU every rank computes whole. The GELU MLP
(whisper's) has biases and takes JAX's default GELU, the tanh
approximation (`jax.nn.gelu(approximate=True)`).

`moe_forward` dispatches as JAX's does:
  * local (`_moe_local_math`; no mesh, one model shard, or experts that
    do not split over it): every assignment through its expert, sorted
    by expert, nothing dropped. The oracle of the other two.
  * scatter (training / prefill; T divisible by the model axis): tokens
    split over the batch axes and the model axis; each rank routes its
    tokens, packs a per-destination capacity buffer
    (`_pack_by_destination`), exchanges it with `all_to_all` over the
    model axis, runs its local experts on a per-expert capacity buffer
    (`_expert_ffn_capacity`, GShard's [E+1, cap, d] with the sentinel
    bucket last) and sends the results back. Overflow is dropped, gates
    not renormalised; the aux loss and the dropped share are averaged
    over every rank.
  * decode: tokens replicated over the model axis; each rank computes
    the assignments that hit its experts and the partial outputs are
    summed over the model axis.
Expert weights take one of JAX's two layouts, by the rules: the default
`expert_embed` -> data all-gathers each rank's d-slices per layer
(ZeRO-3); `expert_embed` -> (), `expert_ffn` -> data keeps the weight
slices where they are and gathers the tokens instead ("gather tokens,
not weights"), summing partial outputs over the ffn axis. The rank's
weight blocks are views of the global weights (`sharding.shard_map`).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch import sharding
from repro_torch.models.common import einsum, swiglu
from repro_torch.sharding import ParallelContext, Spec


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    d_model: int
    d_ff: int                      # per-expert hidden dim
    n_experts: int
    top_k: int
    n_shared_experts: int = 0
    shared_d_ff: Optional[int] = None   # defaults to d_ff * n_shared
    capacity_factor: float = 1.25


def mlp_forward(params: dict, x: torch.Tensor,
                activation: str = "swiglu") -> torch.Tensor:
    """x [B, T, d] -> [B, T, d] in x's type. "swiglu": w_gate, w_up,
    w_down; "gelu": w_up, b_up, w_down, b_down, the tanh-approximate GELU
    (JAX's default, which the exact erf GELU misses by up to 5e-4)."""
    if activation == "swiglu":
        h = swiglu(einsum("btd,df->btf", x, params["w_gate"]),
                   einsum("btd,df->btf", x, params["w_up"]))
        return einsum("btf,fd->btd", h, params["w_down"]).to(x.dtype)
    if activation != "gelu":
        raise ValueError(f"activation {activation!r}: swiglu or gelu")
    h = F.gelu(einsum("btd,df->btf", x, params["w_up"]) + params["b_up"],
               approximate="tanh")
    y = einsum("btf,fd->btd", h, params["w_down"]).to(x.dtype)
    return y + params["b_down"].to(y.dtype)


def _route(router_w: torch.Tensor, x2d: torch.Tensor, cfg: MoEConfig):
    """Router in fp32: returns (gates [T,k] fp32 renormalised to sum 1,
    expert_idx [T,k] int64, the switch-style load-balance aux loss,
    assignments per expert [E] int64)."""
    logits = x2d.float() @ router_w.float()
    probs = torch.softmax(logits, dim=-1)
    gates, idx = torch.topk(probs, cfg.top_k, dim=-1)
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    E = cfg.n_experts
    flat = idx.reshape(-1)
    # a fixed-size count (bincount's integers): meta tensors can take it
    counts = torch.zeros(E, dtype=torch.long, device=idx.device).index_add_(
        0, flat, torch.ones_like(flat))
    frac_tokens = counts.float() / torch.clamp(counts.sum().float(), min=1.0)
    aux = E * torch.sum(frac_tokens * probs.mean(dim=0))
    return gates, idx, aux, counts


def _moe_local_math(x2d: torch.Tensor, router_w: torch.Tensor,
                    w_gate: torch.Tensor, w_up: torch.Tensor,
                    w_down: torch.Tensor, cfg: MoEConfig):
    """Every assignment through its expert's SwiGLU, weighted by its gate.
    Assignments are sorted by expert and each expert that received any runs
    once on its contiguous group (the JAX package's sort + `ragged_dot`).
    The per-expert counts cross to the host once per call, to size the
    groups."""
    T, d = x2d.shape
    gates, idx, aux, counts = _route(router_w, x2d, cfg)
    order = torch.argsort(idx.reshape(-1), stable=True)
    tok = torch.div(order, cfg.top_k, rounding_mode="floor")
    xs = x2d[tok]
    if counts.is_meta:
        raise RuntimeError(
            "the local MoE path sizes each expert's group by its routed "
            "count, which depends on the data: a meta tensor has none. The "
            "dry-run reaches the capacity-buffer paths only (a mesh whose "
            "model axis splits the experts)")
    counts = counts.tolist()
    out = torch.empty((xs.shape[0], d), dtype=torch.promote_types(
        x2d.dtype, w_down.dtype), device=x2d.device)
    start = 0
    for e, n in enumerate(counts):
        if n:
            seg = xs[start:start + n]
            h = swiglu(einsum("td,df->tf", seg, w_gate[e]),
                       einsum("td,df->tf", seg, w_up[e]))
            out[start:start + n] = einsum("tf,fd->td", h, w_down[e])
            start += n
    weighted = out * gates.reshape(-1)[order][:, None].to(out.dtype)
    y = torch.zeros((T, d), dtype=out.dtype, device=x2d.device)
    y.index_add_(0, tok, weighted)
    return y.to(x2d.dtype), aux


def _round_cap(n: float) -> int:
    """JAX's capacity: the ceiling, up to a multiple of 8, at least 8."""
    return max(8, int(math.ceil(int(math.ceil(n)) / 8)) * 8)


def _scatter_rows(src: torch.Tensor, dest: torch.Tensor, n: int,
                  fill=0) -> torch.Tensor:
    """An [n, ...] buffer of `fill` holding src's rows at `dest`. A row
    whose dest is n (dropped) lands in a trash row past the end, which is
    cut off: fixed shapes and no boolean mask, so meta tensors take it."""
    buf = src.new_full((n + 1,) + tuple(src.shape[1:]), fill)
    return buf.index_put_((dest,), src)[:n]


def _expert_ffn_capacity(xflat: torch.Tensor, eflat: torch.Tensor,
                         w_gate: torch.Tensor, w_up: torch.Tensor,
                         w_down: torch.Tensor, n_experts: int,
                         capacity_factor: float = 2.0) -> torch.Tensor:
    """Per-expert-capacity batched SwiGLU (GShard's block-diagonal form).

    xflat [A, d] assignment rows; eflat [A] LOCAL expert ids, the sentinel
    `n_experts` marking padding rows. Rows go to their expert's bucket of
    an [E+1, cap, d] buffer in arrival order (the sentinel bucket last;
    padding rows, and rows past an expert's `cap`, are dropped), each
    expert's bucket runs through its SwiGLU with batched products over
    the E local experts, and the rows come back out. The sentinel bucket
    never holds a row (its rows are dropped), so its zero weights are
    not materialised: its output is zero. Returns [A, d] with dropped and
    padding rows zero."""
    A, d = xflat.shape
    cap = _round_cap(A / n_experts * capacity_factor)
    e = eflat.long()
    onehot = F.one_hot(e, n_experts + 1)
    slot = ((torch.cumsum(onehot, 0) - onehot) * onehot).sum(-1)
    slot = torch.where(e < n_experts, slot, cap)
    keep = slot < cap
    trash = n_experts * cap
    buf = _scatter_rows(xflat, torch.where(keep, e * cap + slot, trash),
                        trash).view(n_experts, cap, d)
    h = swiglu(torch.einsum("ecd,edf->ecf", buf, w_gate),
               torch.einsum("ecd,edf->ecf", buf, w_up))
    out = torch.einsum("ecf,efd->ecd", h, w_down)
    out = torch.cat([out, out.new_zeros((1,) + out.shape[1:])])
    res = out[torch.clamp(e, max=n_experts), torch.clamp(slot, max=cap - 1)]
    return res * keep[:, None].to(res.dtype)


def _pack_by_destination(x2d: torch.Tensor, tok: torch.Tensor,
                         dst: torch.Tensor, valid: torch.Tensor, n_dst: int,
                         capacity: int):
    """Scatter assignment rows x2d[tok] into per-destination capacity
    buffers in arrival order. Returns (buffer [n_dst, capacity, d], slot
    [A]: the position used, >= capacity when dropped)."""
    onehot = F.one_hot(dst.long(), n_dst) * valid[:, None].long()
    slot = ((torch.cumsum(onehot, 0) - onehot) * onehot).sum(-1)
    slot = torch.where(valid.bool(), slot, capacity)
    keep = slot < capacity
    trash = n_dst * capacity
    buf = _scatter_rows(x2d[tok],
                        torch.where(keep, dst.long() * capacity + slot, trash),
                        trash)
    return buf.view(n_dst, capacity, x2d.shape[-1]), slot


def _combine(res: torch.Tensor, tok: torch.Tensor, gates: torch.Tensor,
             T: int) -> torch.Tensor:
    """Sum each token's gated assignment rows: [A, d] -> [T, d]."""
    y = res.new_zeros((T, res.shape[-1]))
    return y.index_add(0, tok, res * gates[:, None].to(res.dtype))


def _moe_scatter_shard(x_loc, router_w, w_gate_loc, w_up_loc, w_down_loc,
                       cfg: MoEConfig, ctx: ParallelContext, mp: int):
    """One rank's training / prefill MoE (the body of the scatter path).

    x_loc [T_loc, d]: the rank's tokens (split over the batch axes and
    the model axis). Expert weights: the rank's [E_loc, d, f] experts.
    Returns (y [T_loc, d], aux, dropped share), aux and the share the
    rank's own."""
    T_loc, d = x_loc.shape
    E_loc = cfg.n_experts // mp
    gates, idx, aux, _ = _route(router_w, x_loc, cfg)
    A = T_loc * cfg.top_k
    flat_e = idx.reshape(A)
    flat_g = gates.reshape(A)
    tok = torch.arange(A, device=x_loc.device) // cfg.top_k
    dst = flat_e // E_loc                                # owner shard
    cap = _round_cap(A / mp * cfg.capacity_factor)
    valid = torch.ones((A,), dtype=torch.long, device=x_loc.device)
    xsend, slot = _pack_by_destination(x_loc, tok, dst, valid, mp, cap)
    keep = slot < cap
    esend = _scatter_rows(flat_e % E_loc,
                          torch.where(keep, dst * cap + slot, mp * cap),
                          mp * cap, fill=E_loc).view(mp, cap)
    # after the exchange block m holds what model shard m sent here
    xrecv = sharding.all_to_all(xsend, ctx.model_axis, ctx)
    erecv = sharding.all_to_all(esend, ctx.model_axis, ctx)
    out = _expert_ffn_capacity(xrecv.reshape(mp * cap, d),
                               erecv.reshape(mp * cap), w_gate_loc, w_up_loc,
                               w_down_loc, E_loc,
                               capacity_factor=2.0 * cfg.capacity_factor)
    yrecv = out.reshape(mp, cap, d).to(x_loc.dtype)
    ysend = sharding.all_to_all(yrecv, ctx.model_axis, ctx)
    res = ysend[dst, torch.clamp(slot, max=cap - 1)]
    res = res * keep[:, None].to(res.dtype)
    y = _combine(res, tok, flat_g, T_loc)
    dropped = (~keep).float().mean()
    return y.to(x_loc.dtype), aux, dropped


def _moe_decode_shard(x_loc, router_w, w_gate_loc, w_up_loc, w_down_loc,
                      cfg: MoEConfig, ctx: ParallelContext, mp: int):
    """One rank's decode MoE: x_loc [T, d] is the same on every rank of
    the model axis; the rank computes the assignments to its experts in a
    small capacity buffer and the outputs are summed over the model
    axis."""
    T, d = x_loc.shape
    E_loc = cfg.n_experts // mp
    gates, idx, aux, _ = _route(router_w, x_loc, cfg)
    A = T * cfg.top_k
    flat_e = idx.reshape(A)
    flat_g = gates.reshape(A)
    tok = torch.arange(A, device=x_loc.device) // cfg.top_k
    base = ctx.coord((ctx.model_axis,)) * E_loc
    local = (flat_e >= base) & (flat_e < base + E_loc)
    e_loc = torch.clamp(flat_e - base, 0, E_loc - 1)
    cap = _round_cap(A / mp * 2.0)
    li = local.long()
    slot = torch.where(local, torch.cumsum(li, 0) - li, cap)
    keep = slot < cap
    dest = torch.clamp(slot, max=cap)
    xbuf = _scatter_rows(x_loc[tok], dest, cap)
    ebuf = _scatter_rows(e_loc, dest, cap, fill=E_loc)
    out = _expert_ffn_capacity(xbuf, ebuf, w_gate_loc, w_up_loc, w_down_loc,
                               E_loc, capacity_factor=2.0)
    res = out[torch.clamp(slot, max=cap - 1)]
    res = res * (keep & local)[:, None].to(res.dtype)
    y = _combine(res, tok, flat_g, T)
    y = sharding.all_reduce(y, (ctx.model_axis,), ctx, "sum")
    aux = sharding.all_reduce(aux, (ctx.model_axis,), ctx, "mean")
    return y.to(x_loc.dtype), aux


def _gather_dim(w: torch.Tensor, axes, dim: int, ctx: ParallelContext):
    """ZeRO-3 all-gather of a weight's `dim` over the mesh `axes`."""
    return sharding.all_gather(w, axes, ctx, dim)


def _expert_specs(cfg: MoEConfig, ctx: ParallelContext, d: int):
    """The rules' specs of the router and the expert weights."""
    E, f = cfg.n_experts, cfg.d_ff
    return {"router": ctx.spec(("embed", "experts"), (d, E)),
            "w_gate": ctx.spec(("experts", "expert_embed", "expert_ffn"),
                               (E, d, f)),
            "w_up": ctx.spec(("experts", "expert_embed", "expert_ffn"),
                             (E, d, f)),
            "w_down": ctx.spec(("experts", "expert_ffn", "expert_embed"),
                               (E, f, d))}


def _prep_weights(ws: dict, ctx: ParallelContext, rw, wg, wu, wd):
    """A body's weights: the whole router (it must see every expert) and
    the experts' d dims gathered (ZeRO-3); the f dims stay the rank's."""
    ax = sharding.axes_of
    rw = _gather_dim(_gather_dim(rw, ax(ws["router"][0]), 0, ctx),
                     ax(ws["router"][1]), 1, ctx)
    d_axes = ax(ws["w_gate"][1])
    return (rw, _gather_dim(wg, d_axes, 1, ctx),
            _gather_dim(wu, d_axes, 1, ctx), _gather_dim(wd, d_axes, 2, ctx))


def moe_scatter(params: dict, cfg: MoEConfig, x: torch.Tensor,
                ctx: ParallelContext):
    """The scatter path of `moe_forward` without the shared experts:
    (y [B, T, d], aux, dropped share), every rank's the same."""
    B, T, d = x.shape
    mp = ctx.model_parallel_size
    ws = _expert_specs(cfg, ctx, d)
    f_axes = sharding.axes_of(ws["w_gate"][2])
    xspec = Spec(_batch_axes(ctx, B) or None, ctx.model_axis, None)

    def body(xl, rw, wg, wu, wd):
        Bl, Tl, _ = xl.shape
        rw, wg, wu, wd = _prep_weights(ws, ctx, rw, wg, wu, wd)
        # the scatter path computes against whole experts
        wg = _gather_dim(wg, f_axes, 2, ctx)
        wu = _gather_dim(wu, f_axes, 2, ctx)
        wd = _gather_dim(wd, f_axes, 1, ctx)
        y, aux, dropped = _moe_scatter_shard(xl.reshape(Bl * Tl, d), rw, wg,
                                             wu, wd, cfg, ctx, mp)
        everyone = ctx.axis_names
        return (y.reshape(Bl, Tl, d),
                sharding.all_reduce(aux, everyone, ctx, "mean"),
                sharding.all_reduce(dropped, everyone, ctx, "mean"))

    return sharding.shard_map(
        body, ctx=ctx,
        in_specs=(xspec, ws["router"], ws["w_gate"], ws["w_up"],
                  ws["w_down"]),
        out_specs=(xspec, Spec(), Spec()),
    )(x, params["router"], params["w_gate"], params["w_up"], params["w_down"])


def _moe_decode(params: dict, cfg: MoEConfig, x: torch.Tensor,
                ctx: ParallelContext):
    """The decode path of `moe_forward` without the shared experts."""
    B, T, d = x.shape
    mp = ctx.model_parallel_size
    ws = _expert_specs(cfg, ctx, d)
    f_axes = sharding.axes_of(ws["w_gate"][2])
    if len(f_axes) > 1:
        raise ValueError(f"expert_ffn over {f_axes}: one ffn axis supported")
    batch_axes = _batch_axes(ctx, B)
    tok_axes = tuple(a for a in f_axes if a in batch_axes)
    xspec = Spec(batch_axes or None, None, None)

    def body(xl, rw, wg, wu, wd):
        Bl, Tl, _ = xl.shape
        rw, wg, wu, wd = _prep_weights(ws, ctx, rw, wg, wu, wd)
        # "gather tokens, not weights": every rank of the ffn axis brings
        # its tokens, computes against its (expert, f-slice) block, the
        # partial outputs are summed and the rank keeps its own rows
        x2 = sharding.all_gather(xl.reshape(Bl * Tl, d), tok_axes, ctx, 0)
        y, aux = _moe_decode_shard(x2, rw, wg, wu, wd, cfg, ctx, mp)
        for a in f_axes:
            y = sharding.all_reduce(y, (a,), ctx, "sum")
            if a in tok_axes:
                y = y.narrow(0, ctx.coord((a,)) * Bl * Tl, Bl * Tl)
        others = tuple(a for a in ctx.axis_names if a != ctx.model_axis)
        aux = sharding.all_reduce(aux, others, ctx, "mean")
        return y.reshape(Bl, Tl, d), aux

    return sharding.shard_map(
        body, ctx=ctx,
        in_specs=(xspec, ws["router"], ws["w_gate"], ws["w_up"],
                  ws["w_down"]),
        out_specs=(xspec, Spec()),
    )(x, params["router"], params["w_gate"], params["w_up"], params["w_down"])


def _batch_axes(ctx: ParallelContext, B: int) -> tuple:
    return tuple(a for a in (ctx.pod_axis, ctx.data_axis)
                 if a is not None and B % ctx.axis_size(a) == 0)


def moe_forward(params: dict, cfg: MoEConfig, x: torch.Tensor,
                ctx: Optional[ParallelContext] = None, decode: bool = False
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """MoE block. x [B, T, d] -> (y, aux_loss): routed experts plus the
    shared experts' dense SwiGLU. With a mesh of more than one model shard
    over which the experts split, the scatter path (not `decode`, T
    divisible by the model axis) or the decode path; else the local
    path."""
    B, T, d = x.shape
    shared_y = 0.0
    if cfg.n_shared_experts > 0:
        shared_y = mlp_forward(params["shared"], x)
    mp = 1 if ctx is None or ctx.mesh is None else ctx.model_parallel_size
    if mp == 1 or cfg.n_experts % mp != 0:
        y, aux = _moe_local_math(x.reshape(B * T, d), params["router"],
                                 params["w_gate"], params["w_up"],
                                 params["w_down"], cfg)
        return shared_y + y.reshape(B, T, d), aux
    if not decode and T % mp == 0:
        y, aux, _ = moe_scatter(params, cfg, x, ctx)
    else:
        y, aux = _moe_decode(params, cfg, x, ctx)
    return shared_y + y, aux
