"""Dry-run of every (architecture x input shape) on the production layouts,
with no card: trace each step on "meta" tensors in a fake world of 256
or 512 ranks and report its roofline terms on the H100's constants.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch internlm2-1.8b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all              # single-pod, 40 combos
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --multi-pod  # on 2 x 16 x 16

Results are appended as JSON lines to `--out` (build/dryrun_torch.jsonl).

Counterpart of `repro.launch.dryrun`, with JAX's CLI, `lower_combo`'s
arguments and its result's keys, but no XLA: nothing is lowered or
compiled. How it works:

  * The world. `lower_combo` initialises a fake process group (torch's
    "fake" backend: collectives return at once and move nothing) of 256
    ranks for (16, 16), or 512 for (2, 16, 16), as rank 0; builds
    `launch.mesh.make_context` on a CPU `DeviceMesh` over it; and
    destroys the group when done. It refuses a process that already has
    a world: a process group is global to the process, so run it in a
    process of its own (the CLI, a subprocess).
  * The trace. Parameters, moments, cache and batch are meta tensors at
    the global shapes (`launch.specs`); the step is the port's own
    `make_train_step` / `make_prefill` / `make_serve_step` with `ctx` and
    the kernel switches off, so the plain versions, which the dispatcher
    sees, are what is counted. The layer loop is unrolled, so one trace at
    full depth counts every layer: no depth extrapolation is needed, and
    no `scan_body_flops` or `t_compile_s` exists; `t_trace_s` takes
    `t_lower_s`'s place. (`extrapolated_costs` is kept for JAX's callers;
    `skip_extrapolation` changes nothing.)
  * The counts, per rank, as the port runs the step: FLOPs by
    `FlopCounterMode`; bytes by `TrafficMode` (each non-view aten op's
    inputs and outputs: eager PyTorch's traffic, unfused, where XLA's is
    after fusion); collectives by `sharding.record_collectives` (the
    port's explicit collectives only); the peak as the arguments plus
    the largest live set of distinct storages made during the step.
  * What a rank holds. The port computes the dense layers whole on every
    rank (`sharding.py`), so the per-rank figures are the dense layers'
    whole, plus the rank's block of the explicit paths (MoE, sequence-
    sharded decode, d-sharded signal): `useful_flops_ratio` and
    `fits_hbm` say so. `sharded_state_bytes` is the rank's blocks of
    parameters, moments and cache under the specs: what a partitioned
    run would hold, the figure comparable with JAX's `memory_analysis`.
  * MLA has no window in either package (JAX's `mla_forward` ignores the
    one `adapt_for_shape` sets at long_500k). Its cache is cut to the
    window all the same, so the port's step runs without the window over
    that cache, as JAX's traced step does.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import time
import traceback
import weakref
from typing import Any, Dict, Optional

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import SHAPES, InputShape, get_config, list_configs
from repro_torch.launch import roofline as rf
from repro_torch.launch import specs
from repro_torch.launch.mesh import make_context
from repro_torch.launch.steps import (make_prefill, make_serve_step,
                                      make_train_step)
from repro_torch.sharding import make_mesh, record_collectives, rules_dict
from repro_torch.training import optim

DEFAULT_OUT = os.path.join("build", "dryrun_torch.jsonl")
GiB = 2 ** 30

# tests/test_launch.py's three §Perf configurations (JAX's winning rule and
# config combinations), at full depth: gather-tokens MoE decode, chunked
# and sequence-parallel prefill, remat + microbatches + ZeRO-1 training
PERF_VARIANTS = (
    dict(arch="kimi-k2-1t-a32b", shape_name="decode_32k",
         rule_overrides={"expert_embed": (), "expert_ffn": ("data",),
                         "cache_seq": ("data", "model"),
                         "unembed_d": ("data",)},
         label="perf: gather-tokens MoE decode"),
    dict(arch="qwen1.5-32b", shape_name="prefill_32k",
         rule_overrides={"seq": ("model",)},
         cfg_overrides={"attn_chunk": 1024, "scan_layers": False},
         label="perf: chunked + seq-parallel prefill"),
    dict(arch="llama3-405b", shape_name="train_4k", remat="full",
         opt_rule_overrides={"embed": ("data", "model")},
         cfg_overrides={"scan_layers": False, "microbatches": 4},
         label="perf: remat + microbatches + ZeRO-1 train"),
)


# ---------------------------------------------------------------------------
# The world
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def fake_world(n: int):
    """This process as rank 0 of a fake world of `n` ranks."""
    if dist.is_initialized():
        raise RuntimeError(
            f"this process already has a world of "
            f"{dist.get_world_size()} ranks: the dry-run builds a fake "
            f"world of its own, so run it in a process of its own")
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", rank=0, world_size=n, store=FakeStore())
    try:
        yield
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# Traffic and live storages
# ---------------------------------------------------------------------------

_FREE = {"empty", "empty_like", "empty_strided", "new_empty",
         "new_empty_strided", "detach", "alias", "lift_fresh",
         "_unsafe_view", "_local_scalar_dense", "set_", "resize_"}
_GATHERS = {"embedding", "index", "index_select", "gather"}
_SCATTERS = {"index_put_", "index_add_", "index_copy_", "index_fill_",
             "scatter_", "scatter_add_", "scatter_reduce_"}


def span_bytes(t: torch.Tensor) -> int:
    """Bytes of the memory `t` covers (a broadcast dim counts once)."""
    if t.numel() == 0:
        return 0
    return t.element_size() * math.prod(
        s for s, st in zip(t.shape, t.stride()) if st != 0)


class TrafficMode(TorchDispatchMode):
    """Counts the bytes of each aten op as eager PyTorch moves them: every
    input read once and every output written once, views, allocations
    and collectives moving nothing; a gather (embedding, indexing) reads
    the rows it takes, a scatter into a tensor in place writes the rows it
    puts, `copy_` and `fill_` do not read their destination. Tracks the
    live set of distinct storages made while active: `peak` is its
    largest size. `adopt` registers storages that exist before (the
    step's arguments) so that they never count as made."""

    def __init__(self):
        super().__init__()
        self.bytes = 0
        self.live = 0
        self.peak = 0
        self.made: Dict[int, int] = {}       # storage key -> nbytes
        self._known: set = set()

    def adopt(self, tree: Any) -> int:
        """Register the storages of `tree`'s tensors; their bytes, each
        storage once."""
        total = 0
        for t in tree_flatten(tree)[0]:
            if isinstance(t, torch.Tensor):
                st = t.untyped_storage()
                if st._cdata not in self._known:
                    self._known.add(st._cdata)
                    total += st.nbytes()
        return total

    def _freed(self, key: int, nbytes: int) -> None:
        self._known.discard(key)
        if self.made.pop(key, None) is not None:
            self.live -= nbytes

    def _track(self, outs) -> None:
        for t in outs:
            st = t.untyped_storage()
            key = st._cdata
            if key in self._known:
                continue
            n = st.nbytes()
            self._known.add(key)
            self.made[key] = n
            self.live += n
            weakref.finalize(st, self._freed, key, n)
        self.peak = max(self.peak, self.live)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        outs = [t for t in tree_flatten(out)[0]
                if isinstance(t, torch.Tensor)]
        self._track(outs)
        name = func._schema.name.split("::")[-1]
        if (func.namespace != "aten" or func.is_view or name in _FREE):
            return out
        ins = [t for t in tree_flatten((args, kwargs or {}))[0]
               if isinstance(t, torch.Tensor)]
        out_b = sum(span_bytes(t) for t in outs)
        if name.startswith("new_") or name.endswith("_like"):
            in_b = 0
        elif name in _GATHERS:
            in_b = sum(span_bytes(t) for t in ins[1:]) + out_b
        elif name in _SCATTERS:
            in_b = sum(span_bytes(t) for t in ins[1:])
            out_b = span_bytes(ins[-1])
        elif name == "copy_":
            in_b = span_bytes(ins[1])
        elif name.endswith("fill_") or name == "zero_":
            in_b = sum(span_bytes(t) for t in ins[1:])
        else:
            in_b = sum(span_bytes(t) for t in ins)
        self.bytes += in_b + out_b
        return out


# ---------------------------------------------------------------------------
# The step and its inputs
# ---------------------------------------------------------------------------

def _mla_window(cfg) -> bool:
    return cfg.mla is not None and cfg.sliding_window is not None


def step_and_inputs(cfg, shape: InputShape, mesh, ctx=None, rules=None,
                    opt_rules=None, kernels: bool = False):
    """(step, args, state) of `shape.kind`'s step: args are meta tensors
    at the global shapes, and state holds a (tensors, shardings) pair of
    trees for each of the args' "params", "opt" (the moments) and
    "cache" that the step takes. `kernels` turns every kernel switch
    on."""
    step_cfg = cfg.replace(sliding_window=None) if _mla_window(cfg) else cfg
    (params, opt), (params_sh, opt_sh) = specs.model_state_specs(
        step_cfg, mesh, with_opt=shape.kind == "train", rules=rules,
        opt_rules=opt_rules)
    state = {"params": (params, params_sh)}
    if shape.kind == "train":
        batch, _ = specs.batch_specs(cfg, shape, mesh, rules)
        state["opt"] = ({"mu": opt.mu, "nu": opt.nu},
                        {"mu": opt_sh.mu, "nu": opt_sh.nu})
        step = make_train_step(step_cfg, microbatches=cfg.microbatches,
                               loss_kernel=kernels, ctx=ctx)
        return step, (params, opt, batch), state
    cache, cache_sh = specs.cache_specs(cfg, shape, mesh, rules)
    state["cache"] = (cache, cache_sh)
    if shape.kind == "prefill":
        batch, _ = specs.batch_specs(cfg, shape, mesh, rules)
        return (make_prefill(step_cfg, paged_kernel=kernels, ctx=ctx),
                (params, cache, batch), state)
    (token, position), _ = specs.decode_specs(cfg, shape, mesh, rules)
    if _mla_window(cfg):
        position = min(position, cfg.sliding_window - 1)
    return (make_serve_step(step_cfg, paged_kernel=kernels, ctx=ctx),
            (params, cache, token, position), state)


def materialize(tree: Any, device, generator: torch.Generator,
                vocab: int) -> Any:
    """Real tensors on `device` for the meta tensors of `tree` (dicts,
    tuples, AdamWState), drawn from `generator`: integer leaves (tokens)
    in [0, vocab), AdamW's moments >= 0 and its step 0, floating leaves
    N(0, 0.02). Other leaves pass through."""
    if isinstance(tree, dict):
        return {k: materialize(v, device, generator, vocab)
                for k, v in tree.items()}
    if isinstance(tree, optim.AdamWState):
        def mom(t):
            return materialize(t, device, generator, vocab).abs_()
        return optim.AdamWState(
            torch.zeros((), dtype=torch.int32, device=device),
            optim.tree_map(mom, tree.mu), optim.tree_map(mom, tree.nu))
    if isinstance(tree, tuple):
        return tuple(materialize(v, device, generator, vocab) for v in tree)
    if not isinstance(tree, torch.Tensor):
        return tree
    if not tree.dtype.is_floating_point:
        return torch.randint(0, vocab, tree.shape, dtype=tree.dtype,
                             device=device, generator=generator)
    return torch.empty(tree.shape, dtype=tree.dtype, device=device).normal_(
        0.0, 0.02, generator=generator)


def trace_step(step, args) -> Dict[str, Any]:
    """Run `step(*args)` on meta tensors under the three counters:
    {"flops", "bytes", "events", "peak_bytes", "arg_bytes", "out_bytes",
    "temp_bytes"}."""
    traffic = TrafficMode()
    arg_bytes = traffic.adopt(args)
    with record_collectives() as events, \
            FlopCounterMode(display=False) as flops, traffic:
        out = step(*args)
    out_keys = {t.untyped_storage()._cdata for t in tree_flatten(out)[0]
                if isinstance(t, torch.Tensor)}
    out_bytes = sum(traffic.made.get(k, 0) for k in out_keys)
    peak = arg_bytes + traffic.peak
    return {"flops": int(flops.get_total_flops()), "bytes": traffic.bytes,
            "events": list(events), "peak_bytes": peak,
            "arg_bytes": arg_bytes, "out_bytes": out_bytes,
            "temp_bytes": max(peak - arg_bytes - out_bytes, 0)}


def _measured_costs(cfg, shape, mesh, ctx, rules=None, opt_rules=None):
    """(flops, bytes, collective breakdown) per rank from one trace."""
    step, args, _ = step_and_inputs(cfg, shape, mesh, ctx, rules, opt_rules)
    t = trace_step(step, args)
    return float(t["flops"]), float(t["bytes"]), rf.collective_bytes(
        t["events"])


def _depth_points(cfg):
    """Two shallow depths whose costs extrapolate linearly to L, JAX's
    (exact where every period of layers costs the same: a hybrid's
    shared block is called once a period, so its figure is exact at
    depths that are whole periods)."""
    if cfg.family == "moe":
        return 2, 3            # 1 dense + 1/2 moe layers
    if cfg.family == "hybrid":
        return cfg.shared_attn_every, 2 * cfg.shared_attn_every
    return 1, 2


def _shallow_cfg(cfg, d):
    kw = dict(n_layers=d, scan_layers=False)
    if cfg.encoder is not None:
        kw["encoder"] = dataclasses.replace(cfg.encoder, n_layers=d)
    return cfg.replace(**kw)


def extrapolated_costs(cfg, shape, mesh, ctx, rules=None, opt_rules=None):
    """Depth-extrapolated per-rank (flops, bytes, coll_breakdown), JAX's
    method on two shallow traces. The port's full trace already counts
    every layer; this is kept for JAX's callers and held against it."""
    d1, d2 = _depth_points(cfg)
    f1 = _measured_costs(_shallow_cfg(cfg, d1), shape, mesh, ctx, rules,
                         opt_rules)
    f2 = _measured_costs(_shallow_cfg(cfg, d2), shape, mesh, ctx, rules,
                         opt_rules)
    k = (cfg.n_layers - d1) / (d2 - d1)
    flops = f1[0] + k * (f2[0] - f1[0])
    byts = f1[1] + k * (f2[1] - f1[1])
    coll = {key: f1[2][key] + k * (f2[2][key] - f1[2][key]) for key in f1[2]}
    return flops, byts, coll


# ---------------------------------------------------------------------------
# One combo
# ---------------------------------------------------------------------------

def _mesh_shape(multi_pod: bool):
    return (((2, 16, 16), ("pod", "data", "model")) if multi_pod
            else ((16, 16), ("data", "model")))


def lower_combo(arch: str, shape_name: str, multi_pod: bool,
                remat: str = "none", verbose: bool = True,
                skip_extrapolation: bool = False,
                rule_overrides: Optional[dict] = None,
                label: Optional[str] = None,
                cfg_overrides: Optional[dict] = None,
                opt_rule_overrides: Optional[dict] = None):
    """Trace one (arch, shape, mesh) in a fake world. Returns JAX's result
    dict (with `t_trace_s` for `t_lower_s`, no `t_compile_s` or
    `scan_body_flops`) plus `sharded_state_bytes` and `link_bytes`.

    rule_overrides: logical-axis -> mesh-axes overrides.
    cfg_overrides:  ModelConfig.replace(**...) applied after shape adapt.
    skip_extrapolation: kept for JAX's callers; the trace is at full
    depth either way."""
    shape = SHAPES[shape_name]
    cfg = specs.adapt_for_shape(get_config(arch), shape)
    if remat != "none":
        cfg = cfg.replace(remat=remat)
    if cfg_overrides:
        cfg = cfg.replace(**cfg_overrides)
    rules = rules_dict(rule_overrides) if rule_overrides else None
    opt_rules = (rules_dict({**(rule_overrides or {}), **opt_rule_overrides})
                 if opt_rule_overrides else None)
    dims, axes = _mesh_shape(multi_pod)
    n_dev = math.prod(dims)
    mesh_name = "x".join(map(str, dims))
    with fake_world(n_dev):
        mesh = make_mesh(dims, axes, "cpu")
        ctx = make_context(mesh, rules)
        t0 = time.time()
        step, args, state = step_and_inputs(cfg, shape, mesh, ctx, rules,
                                            opt_rules)
        t = trace_step(step, args)
        t_trace = time.time() - t0
        sharded = sum(specs.shard_bytes(*state[k]) for k in state)
    report = rf.make_report(
        arch, shape_name, mesh_name, n_dev,
        {"flops": t["flops"], "bytes accessed": t["bytes"]}, t["events"],
        rf.analytic_model_flops(cfg, shape), t["peak_bytes"])
    result = dataclasses.asdict(report)
    result.update({
        "t_trace_s": round(t_trace, 2), "remat": remat, "label": label,
        "rule_overrides": rule_overrides, "cfg_overrides": cfg_overrides,
        "arg_bytes": int(t["arg_bytes"]), "temp_bytes": int(t["temp_bytes"]),
        "out_bytes": int(t["out_bytes"]),
        "sharded_state_bytes": int(sharded),
        "link_bytes": rf.link_bytes(t["events"]),
    })
    if verbose:
        print(format_line(result), flush=True)
    return result


def format_line(r: dict) -> str:
    coll = ", ".join(f"{op} {r['collectives'][op] / GiB:.4g}"
                     for op in rf.OPS if r["collectives"][op])
    return (f"{r['arch']} x {r['shape']} x {r['mesh']}"
            f"{' [' + r['label'] + ']' if r.get('label') else ''}: "
            f"{r['dominant']}; compute {r['compute_s']:.4g} s, memory "
            f"{r['memory_s']:.4g} s, collective {r['collective_s']:.4g} s; "
            f"fits_hbm {r['fits_hbm']}, peak "
            f"{r['peak_memory_bytes'] / GiB:.4g} GiB/rank, sharded state "
            f"{r['sharded_state_bytes'] / GiB:.4g} GiB/rank; collective GiB "
            f"{{{coll}}}; traced in {r['t_trace_s']} s")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(SHAPES) + [None])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--remat", default="none")
    ap.add_argument("--skip-extrapolation", action="store_true",
                    help="kept for the JAX CLI's callers: the trace is at "
                         "full depth either way")
    ap.add_argument("--out", default=DEFAULT_OUT)
    args = ap.parse_args(argv)

    archs = ([get_config(a).name for a in list_configs()]
             if (args.all or args.arch is None) else [args.arch])
    shapes = list(SHAPES) if (args.all or args.shape is None) else [args.shape]
    combos = [(a, s) for a in archs for s in shapes]

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    failures = []
    with open(args.out, "a") as f:
        for arch, shape in combos:
            try:
                res = lower_combo(arch, shape, args.multi_pod,
                                  remat=args.remat,
                                  skip_extrapolation=args.skip_extrapolation)
                f.write(json.dumps(res) + "\n")
                f.flush()
            except Exception as e:      # report every combo, then fail
                traceback.print_exc()
                failures.append((arch, shape, repr(e)[:200]))
    if failures:
        print("FAILURES:")
        for fa in failures:
            print(" ", fa)
        raise SystemExit(1)
    print(f"all {len(combos)} combos traced OK "
          f"({'multi-pod 2x16x16' if args.multi_pod else 'single-pod 16x16'})")


if __name__ == "__main__":
    main()
