"""The port's dry-run (`repro_torch.launch.dryrun`): `lower_combo` in a
fake world of 256 ranks at shallow depth (the port's
tests/test_launch.py::test_dryrun_lowering_smoke), the three §Perf
variants, the CLI, the meta trace's FLOP count against the same step on
real CPU tensors for every family (MoE on a (2, 4) world), JAX's depth
extrapolation against the full trace, the refusal of a process that has
a world, and the collective recorder off. A fake world is global to its
process, so each dry-run runs in a subprocess."""
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch
import torch.distributed as dist
from torch.utils.flop_counter import FlopCounterMode

from _torch_world import run_world
import repro_torch.configs as tconfigs
from repro_torch import sharding
from repro_torch.launch import dryrun, specs
from repro_torch.sharding import MeshLayout

REPO = Path(__file__).resolve().parents[1]


def _run(code: str, timeout: float = 300.0) -> str:
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"),
               OMP_NUM_THREADS="1")
    res = subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                         capture_output=True, text=True, timeout=timeout,
                         cwd=REPO / "tests", env=env)
    assert res.returncode == 0, res.stderr[-4000:]
    return res.stdout


def _json_lines(out: str) -> list:
    return [json.loads(line[5:]) for line in out.splitlines()
            if line.startswith("JSON ")]


def test_dryrun_lowering_smoke():
    """internlm2-1.8b and kimi-k2-1t-a32b train_4k at 2 layers on
    (16, 16): JAX's result keys, per-rank counts, kimi's expert-parallel
    collectives forward and backward, all charged to InfiniBand."""
    out = _run("""
        import json
        from repro_torch.launch.dryrun import lower_combo
        for arch in ("internlm2-1.8b", "kimi-k2-1t-a32b"):
            r = lower_combo(arch, "train_4k", multi_pod=False, verbose=False,
                            skip_extrapolation=True,
                            cfg_overrides={"n_layers": 2})
            print("JSON " + json.dumps(r))
    """)
    dense, moe = _json_lines(out)
    for r in (dense, moe):
        assert r["mesh"] == "16x16" and r["t_trace_s"] >= 0
        assert "t_compile_s" not in r and "scan_body_flops" not in r
        for k in ("flops_per_device", "bytes_per_device", "compute_s",
                  "memory_s", "model_flops_global", "arg_bytes",
                  "temp_bytes", "sharded_state_bytes"):
            assert r[k] > 0, k
        assert r["peak_memory_bytes"] >= r["arg_bytes"] + r["temp_bytes"]
        assert r["dominant"] in ("compute", "memory", "collective")
        assert r["fits_hbm"] is False     # dense layers whole on every rank
        assert 0 < r["useful_flops_ratio"] < 1.0 / 200
    assert dense["collectives"]["count"] == 0 and dense["collective_s"] == 0
    c = moe["collectives"]
    assert c["all-to-all"] > 0 and c["all-gather"] > 0 and c["all-reduce"] > 0
    assert moe["link_bytes"]["nvlink"] == 0
    assert moe["link_bytes"]["ib"] == pytest.approx(c["total"])
    assert moe["collective_s"] == pytest.approx(c["total"] / 50e9)


def test_perf_variants_trace():
    """The three §Perf variants at JAX's shallow depths; the gather-tokens
    MoE decode moves tokens, not weights: the recorded ("data",)
    all-gathers of B x d bf16 rows are exactly two a MoE layer (the
    body's token gather and the output's rebuild) and one a layer (the
    sequence-sharded attention rebuilds its [B, 1, 64, 112] output over
    the batch blocks), and no expert weight is gathered (JAX's test:
    all-gather < 5e9)."""
    out = _run("""
        import json
        from repro_torch.launch import dryrun
        depth = {"kimi-k2-1t-a32b": 3, "qwen1.5-32b": 2, "llama3-405b": 2}
        for v in dryrun.PERF_VARIANTS:
            kw = dict(v, cfg_overrides={**v.get("cfg_overrides", {}),
                                        "n_layers": depth[v["arch"]]})
            r = dryrun.lower_combo(multi_pod=False, verbose=False, **kw)
            print("JSON " + json.dumps(r))
        from repro_torch.configs import SHAPES, get_config
        from repro_torch.launch import specs
        from repro_torch.launch.mesh import make_context
        from repro_torch.sharding import make_mesh, rules_dict
        v = dryrun.PERF_VARIANTS[0]
        shape = SHAPES["decode_32k"]
        cfg = specs.adapt_for_shape(get_config(v["arch"]), shape).replace(
            n_layers=3)
        rules = rules_dict(v["rule_overrides"])
        with dryrun.fake_world(256):
            mesh = make_mesh((16, 16), ("data", "model"), "cpu")
            step, args, _ = dryrun.step_and_inputs(
                cfg, shape, mesh, make_context(mesh, rules), rules)
            ev = dryrun.trace_step(step, args)["events"]
        print("JSON " + json.dumps([[e.op, e.nbytes, list(e.axes)]
                                    for e in ev]))
    """)
    kimi, qwen, llama, events = _json_lines(out)
    assert kimi["collectives"]["all-gather"] < 5e9, kimi["collectives"]
    assert qwen["label"].startswith("perf") and llama["remat"] == "full"
    assert llama["cfg_overrides"]["microbatches"] == 4
    cfg = tconfigs.get_config("kimi-k2-1t-a32b")
    n_moe = 3 - cfg.moe.n_dense_layers
    rows = 128 * cfg.d_model * 2                 # B x d bf16 rows
    tokens = [e for e in events if e[0] == "all-gather"
              and e[2] == ["data"] and e[1] == rows]
    assert len(tokens) == 2 * n_moe + 3
    # a rank's experts with their d dim gathered (ZeRO-3's all-gather)
    expert = cfg.moe.n_experts // 16 * cfg.d_model * cfg.moe.d_ff_expert * 2
    assert all(e[1] < expert for e in events if e[0] == "all-gather")


def test_dryrun_cli_appends_a_line(tmp_path):
    """`python -m repro_torch.launch.dryrun` at full depth for one combo:
    one JSON line appended to --out, and its summary."""
    out_file = tmp_path / "d.jsonl"
    out_file.write_text('{"earlier": 1}\n')
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), OMP_NUM_THREADS="1")
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "internlm2-1.8b", "--shape", "long_500k", "--out", str(out_file)],
        capture_output=True, text=True, timeout=300, env=env, cwd=tmp_path)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "all 1 combos traced OK (single-pod 16x16)" in res.stdout
    earlier, line = [json.loads(l) for l in out_file.read_text().splitlines()]
    assert earlier == {"earlier": 1}
    assert line["shape"] == "long_500k" and line["mesh"] == "16x16"
    assert line["fits_hbm"] is True and line["flops_per_device"] > 0


# ---------------------------------------------------------------------------
# The meta count against real tensors
# ---------------------------------------------------------------------------

FAMILIES = {"dense": "internlm2-1.8b", "ssm_rwkv": "rwkv6-3b",
            "hybrid": "zamba2-1.2b", "encdec": "whisper-small",
            "vlm": "phi-3-vision-4.2b"}
KINDS = (("prefill", 24, 2), ("decode", 24, 2), ("train", 24, 2))


@pytest.mark.parametrize("family", FAMILIES)
def test_meta_count_equals_real_count(family):
    """Each family's reduced config in bf16, one device: the dry-run's
    trace on meta tensors counts exactly the FLOPs FlopCounterMode counts
    for the same step on real CPU tensors; the traced peak covers the
    arguments."""
    cfg0 = tconfigs.reduced(tconfigs.get_config(FAMILIES[family]))
    mesh = MeshLayout((1, 1), ("data", "model"))
    for kind, S, B in KINDS:
        shape = tconfigs.InputShape(kind, S, B, kind)
        cfg = specs.adapt_for_shape(cfg0, shape)
        step, args, _ = dryrun.step_and_inputs(cfg, shape, mesh)
        tr = dryrun.trace_step(step, args)
        real = dryrun.materialize(args, "cpu",
                                  torch.Generator().manual_seed(0),
                                  cfg.vocab_size)
        with FlopCounterMode(display=False) as fc:
            step(*real)
        assert tr["flops"] == fc.get_total_flops() > 0, kind
        assert tr["peak_bytes"] >= tr["arg_bytes"] > 0
        assert tr["bytes"] > tr["arg_bytes"] // 2 and tr["events"] == []


def test_moe_meta_count_equals_real_count(tmp_path):
    """The reduced kimi-k2 through the expert-parallel paths on a (2, 4)
    world: rank 0's meta trace in a fake world against every rank's count
    on real tensors in a world of 8 gloo processes."""
    out = _run("""
        import json, torch
        from _torch_world import MESH, AXES, moe_flops
        from repro_torch.launch import dryrun
        from repro_torch.sharding import make_mesh
        with dryrun.fake_world(8):
            mesh = make_mesh(MESH, AXES, "cpu")
            print("JSON " + json.dumps(moe_flops(torch, mesh, True)))
    """)
    meta = _json_lines(out)[0]
    ranks = run_world("flops", {"unused": [0]}, tmp_path, timeout=300)
    for r, got in enumerate(ranks):
        assert {k: int(v) for k, v in got.items()} == meta, r
    assert all(v > 0 for v in meta.values())


def test_extrapolated_costs_equal_full_trace():
    """JAX's depth extrapolation from two shallow traces equals the full
    trace where every period of layers costs the same: dense (4 layers)
    and MoE (1 dense + 3 MoE layers) train steps, the hybrid's decode at
    3 periods of its shared block; FLOPs, bytes and collectives."""
    out = _run("""
        import json
        from repro_torch.configs import SHAPES, get_config
        from repro_torch.launch import dryrun, specs
        from repro_torch.launch.mesh import make_context
        from repro_torch.sharding import make_mesh
        cases = (("internlm2-1.8b", "train_4k", 4),
                 ("kimi-k2-1t-a32b", "train_4k", 4),
                 ("zamba2-1.2b", "decode_32k", 18))
        with dryrun.fake_world(256):
            mesh = make_mesh((16, 16), ("data", "model"), "cpu")
            ctx = make_context(mesh)
            for arch, s, L in cases:
                cfg = specs.adapt_for_shape(get_config(arch), SHAPES[s])
                cfg = cfg.replace(n_layers=L)
                full = dryrun._measured_costs(cfg, SHAPES[s], mesh, ctx)
                ext = dryrun.extrapolated_costs(cfg, SHAPES[s], mesh, ctx)
                print("JSON " + json.dumps([arch, full, ext]))
    """)
    for arch, full, ext in _json_lines(out):
        assert ext[0] == full[0] and ext[1] == full[1], arch
        assert ext[2] == pytest.approx(full[2], rel=1e-12), arch
        assert full[0] > 0


def test_dryrun_refuses_a_process_with_a_world(tmp_path):
    _run(f"""
        import pytest, torch.distributed as dist
        from repro_torch.launch.dryrun import lower_combo
        dist.init_process_group("gloo", init_method="file://{tmp_path}/i",
                                rank=0, world_size=1)
        with pytest.raises(RuntimeError, match="already has a world"):
            lower_combo("internlm2-1.8b", "decode_32k", False,
                        cfg_overrides={{"n_layers": 1}})
        assert dist.get_world_size() == 1      # left as it was
        dist.destroy_process_group()
    """)


def test_recorder_records_nothing_when_off(tmp_path):
    """A world of one: the recorder takes each collective while active and
    nothing once closed."""
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/init",
                            rank=0, world_size=1)
    try:
        x = torch.ones(4, 3)
        with sharding.record_collectives() as events:
            sharding._sum(x, None)
            sharding._gather_cat(x, None, 1, 0, ("data",))
            sharding._all_to_all(x, None)
        assert [(e.op, e.nbytes, e.group_size, e.ranks) for e in events] == [
            ("all-reduce", 48, 1, (0,)), ("all-gather", 48, 1, (0,)),
            ("all-to-all", 48, 1, (0,))]
        assert events[1].axes == ("data",)
        sharding._sum(x, None)
        sharding._all_to_all(x, None)
        assert len(events) == 3 and sharding._EVENTS.get() is None
    finally:
        dist.destroy_process_group()
