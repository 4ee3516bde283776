"""A world of CPU processes over gloo for the port's sharded paths.

`run_world(job, inputs, tmp_path)` starts `n` processes of this file,
which meet through a file under `tmp_path` (no TCP port, so parallel test
workers cannot collide), build a (2, 4) ("data", "model") DeviceMesh,
run `job` on the arrays of `inputs` and write each rank's outputs to an
.npz; it returns the ranks' outputs, rank by rank. The processes import
torch and the port only.
"""
from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
MESH = (2, 4)
AXES = ("data", "model")


def run_world(job: str, inputs: dict, tmp_path: Path, n: int = 8,
              timeout: float = 120.0) -> list:
    tmp_path = Path(tmp_path)
    np.savez(tmp_path / f"{job}_in.npz", **inputs)
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), OMP_NUM_THREADS="1",
               MKL_NUM_THREADS="1")
    env.pop("JAX_PLATFORMS", None)
    procs = [subprocess.Popen(
        [sys.executable, __file__, job, str(r), str(n), str(tmp_path)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(n)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    bad = [(r, p.returncode, logs[r][-3000:] if r < len(logs) else "")
           for r, p in enumerate(procs) if p.returncode != 0]
    assert not bad, bad[0]
    return [dict(np.load(tmp_path / f"{job}_out{r}.npz")) for r in range(n)]


# ---------------------------------------------------------------------------
# In the world's processes
# ---------------------------------------------------------------------------

def _t(a, torch):
    return torch.from_numpy(np.array(a))


def _tree(inp, prefix, torch):
    """{"p/a/b": array} entries under `prefix` -> a nested dict of
    tensors."""
    tree = {}
    for k, v in inp.items():
        if k.startswith(prefix + "/"):
            node = tree
            *path, leaf = k[len(prefix) + 1:].split("/")
            for p in path:
                node = node.setdefault(p, {})
            node[leaf] = _t(v, torch)
    return tree


def _ctx(mesh, rules):
    from repro_torch.sharding import ParallelContext, rules_dict
    return ParallelContext(mesh=mesh, rules=rules_dict(rules))


def job_decode(inp, mesh, torch):
    """The sequence-sharded `gqa_decode` of each case: the output (every
    rank's global one) and the rank's block of the written cache with its
    offsets."""
    from repro_torch.models.attention import AttnConfig, gqa_decode
    out = {}
    for case in [str(c) for c in inp["cases"]]:
        H, KV, hd, d = (int(v) for v in inp[f"{case}:dims"])
        cfg = AttnConfig(d_model=d, n_heads=H, n_kv_heads=KV, head_dim=hd)
        rules = ({"cache_seq": ("data", "model")}
                 if int(inp[f"{case}:seq_over_both"]) else None)
        ctx = _ctx(mesh, rules)
        params = _tree(inp, f"{case}:p", torch)
        cache = {n: _t(inp[f"{case}:{n}"], torch) for n in ("k", "v")}
        with torch.inference_mode():
            y, c = gqa_decode(params, cfg, _t(inp[f"{case}:x"], torch),
                              int(inp[f"{case}:pos"]), cache, ctx=ctx)
        spec = ctx.spec(("batch", "cache_seq", "kv_heads", None),
                        cache["k"].shape)
        from repro_torch.sharding import axes_of, take_block
        offs = []
        for dim, e in enumerate(spec[:3]):
            axes = axes_of(e)
            size = cache["k"].shape[dim] // ctx.n_blocks(axes)
            offs.append(ctx.coord(axes) * size)
        out[f"{case}:y"] = y.numpy()
        out[f"{case}:spec"] = np.array([repr(spec)])
        for n in ("k", "v"):
            out[f"{case}:{n}_blk"] = take_block(c[n], spec, ctx).numpy()
        out[f"{case}:offs"] = np.array(offs)
    return out


def job_moe(inp, mesh, torch):
    """The MoE paths on the (2, 4) mesh: scatter and decode under the
    default rules and under expert_ffn -> data, the scatter path's
    gradients, the scatter path at capacity factor 1.25, and the
    d-sharded confidence."""
    from repro_torch.launch import steps
    from repro_torch.models.ffn import MoEConfig, moe_forward, moe_scatter
    out = {}
    d, f, E, k = (int(v) for v in inp["moe:dims"])
    params = _tree(inp, "moe:p", torch)
    x = _t(inp["moe:x"], torch)
    cfg = MoEConfig(d_model=d, d_ff=f, n_experts=E, top_k=k,
                    capacity_factor=8.0)
    layouts = {"": None, "ffn_": {"expert_embed": (),
                                  "expert_ffn": ("data",)}}
    for tag, rules in layouts.items():
        ctx = _ctx(mesh, rules)
        for path, dec in (("scatter", False), ("decode", True)):
            with torch.no_grad():
                y, aux = moe_forward(params, cfg, x, ctx, decode=dec)
            out[f"{tag}{path}:y"] = y.numpy()
            out[f"{tag}{path}:aux"] = aux.numpy()
    # gradients through the scatter path: the same global loss on every
    # rank, (y * w).sum() + 0.5 aux
    ctx = _ctx(mesh, None)
    leaves = {n: params[n].clone().requires_grad_(True)
              for n in ("router", "w_gate", "w_up", "w_down")}
    xg = x.clone().requires_grad_(True)
    y, aux = moe_forward(leaves, cfg, xg, ctx)
    ((y * _t(inp["moe:w"], torch)).sum() + 0.5 * aux).backward()
    for n, t in leaves.items():
        out[f"grad:{n}"] = t.grad.numpy()
    out["grad:x"] = xg.grad.numpy()
    # capacity factor 1.25: overflow dropped
    cfg_d = MoEConfig(d_model=d, d_ff=f, n_experts=E, top_k=k,
                      capacity_factor=1.25)
    p125 = _tree(inp, "moe125:p", torch)
    with torch.no_grad():
        y, aux, dropped = moe_scatter(p125, cfg_d, _t(inp["moe125:x"], torch),
                                      ctx)
    out["drop:y"], out["drop:aux"] = y.numpy(), aux.numpy()
    out["drop:dropped"] = dropped.numpy()
    # the d-sharded confidence
    cctx = _ctx(mesh, {"unembed_d": ("data",)})
    xc, table = _t(inp["conf:x"], torch), _t(inp["conf:table"], torch)
    res = steps.fused_confidence(xc, table, ctx=cctx)
    for i, part in enumerate(("neg_ent", "max_prob", "argmax")):
        out[f"conf:{part}"] = res[i].numpy()
    # the kernel path's input: the summed partial logits
    out["conf:logits"] = steps.unembed_logits(xc, table, cctx).numpy()
    return out


MOE_SHAPES = (("prefill", 16, 4), ("decode", 16, 4), ("train", 16, 4))


def moe_flops(torch, mesh, meta: bool) -> dict:
    """FlopCounterMode's count of the reduced kimi-k2-1t-a32b's prefill,
    decode and train steps (bf16, `launch.dryrun`'s steps and inputs) on
    the rank's context over `mesh`: on meta tensors (`meta`), or on real
    CPU tensors drawn from seed 0."""
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.configs import InputShape, get_config, reduced
    from repro_torch.launch import dryrun, specs
    from repro_torch.launch.mesh import make_context
    out = {}
    for kind, S, B in MOE_SHAPES:
        shape = InputShape(kind, S, B, kind)
        cfg = specs.adapt_for_shape(reduced(get_config("kimi-k2-1t-a32b")),
                                    shape)
        step, args, _ = dryrun.step_and_inputs(cfg, shape, mesh,
                                               make_context(mesh))
        if meta:
            out[kind] = dryrun.trace_step(step, args)["flops"]
            continue
        args = dryrun.materialize(args, "cpu", torch.Generator().manual_seed(0),
                                  cfg.vocab_size)
        with FlopCounterMode(display=False) as fc:
            step(*args)
        out[kind] = int(fc.get_total_flops())
    return out


def job_flops(inp, mesh, torch):
    """`moe_flops` on real tensors, rank by rank."""
    return {k: np.array(v) for k, v in moe_flops(torch, mesh, False).items()}


def main(job: str, rank: int, n: int, tmp: str):
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/{job}_init",
                            rank=rank, world_size=n)
    try:
        from repro_torch.sharding import make_mesh
        mesh = make_mesh(MESH, AXES, "cpu")
        inp = dict(np.load(f"{tmp}/{job}_in.npz"))
        out = {"decode": job_decode, "moe": job_moe,
               "flops": job_flops}[job](inp, mesh, torch)
        np.savez(f"{tmp}/{job}_out{rank}.npz", **out)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
