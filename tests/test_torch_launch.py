"""The port's launch layer for the dry-run against the JAX package's:
`adapt_for_shape` field for field, the specs (shapes, dtypes and
partition specs, leaf for leaf, on the production layouts), the analytic
model FLOPs, the collective byte counts and the link rule; and the
repairs the dry-run needed (`_route`'s count on meta tensors, the MoE
local path's refusal there; whisper's abstract cache is held in
tests/test_torch_sharding.py beside the other archs')."""
import dataclasses
import types

import numpy as np
import pytest

import torch

import repro.configs as jconfigs
from repro.launch import roofline as jrf
from repro.launch import specs as jspecs
from repro.sharding import logical_to_spec as j_logical_to_spec
from repro.sharding import rules_dict as j_rules_dict
import repro_torch.configs as tconfigs
from repro_torch.launch import roofline as trf
from repro_torch.launch import specs as tspecs
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import ffn as tffn
from repro_torch.sharding import CollectiveEvent, rules_dict

ARCHS = tconfigs.ARCH_IDS
SHAPES = tuple(tconfigs.SHAPES)
LAYOUTS = {"16x16": ((16, 16), ("data", "model")),
           "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
# the §Perf variants' rule tables (tests/test_launch.py)
RULES = {"default": None,
         "gather-tokens": {"expert_embed": (), "expert_ffn": ("data",),
                           "cache_seq": ("data", "model"),
                           "unembed_d": ("data",)}}


def _jmesh(name):
    shape, axes = LAYOUTS[name]
    return types.SimpleNamespace(axis_names=axes, devices=np.empty(shape))


def _tmesh(name):
    return make_production_mesh(multi_pod=name == "2x16x16")


def _jsds(monkeypatch):
    """JAX's specs with `_sds` returning (shape, dtype name, spec) over a
    stand-in mesh: no 256 devices needed."""
    def sds(shape, dtype, axes, mesh, rules=None):
        return (tuple(shape), np.dtype(dtype).name,
                tuple(j_logical_to_spec(axes, shape, mesh, rules)))
    monkeypatch.setattr(jspecs, "_sds", sds)


def _named(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_named(tree[k], f"{prefix}/{k}"))
        return out
    return {prefix: tree}


def _same(port, port_sh, ref):
    """Port leaves (meta tensors and their shardings) against JAX's
    (shape, dtype, spec) leaves, leaf for leaf."""
    tp, ts, jp = _named(port), _named(port_sh), _named(ref)
    assert list(tp) == list(jp) == list(ts)
    for k in tp:
        t, sh, (shape, dtype, spec) = tp[k], ts[k], jp[k]
        assert t.device.type == "meta", k
        assert tuple(t.shape) == shape, k
        assert str(t.dtype).split(".")[-1] == dtype, k
        assert tuple(sh.spec) == spec, k


def _cfgs(arch, shape_name):
    return (tspecs.adapt_for_shape(tconfigs.get_config(arch),
                                   tconfigs.SHAPES[shape_name]),
            jspecs.adapt_for_shape(jconfigs.get_config(arch),
                                   jconfigs.SHAPES[shape_name]))


@pytest.mark.parametrize("shape_name", SHAPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_adapt_for_shape_matches_jax(arch, shape_name):
    t, j = _cfgs(arch, shape_name)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("arch", ARCHS)
def test_batch_specs_match_jax(arch, layout, monkeypatch):
    _jsds(monkeypatch)
    for shape_name in ("train_4k", "prefill_32k"):
        t, j = _cfgs(arch, shape_name)
        port, port_sh = tspecs.batch_specs(t, tconfigs.SHAPES[shape_name],
                                           _tmesh(layout))
        ref = jspecs.batch_specs(j, jconfigs.SHAPES[shape_name],
                                 _jmesh(layout))
        _same(port, port_sh, ref)


@pytest.mark.parametrize("rules", RULES)
@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("arch", ARCHS)
def test_model_state_specs_match_jax(arch, layout, rules, monkeypatch):
    """Parameters and AdamW's moments, with and without a ZeRO-1 rule
    table for the moments."""
    _jsds(monkeypatch)
    t, j = _cfgs(arch, "train_4k")
    over = RULES[rules]
    trl, jrl = ((rules_dict(over), j_rules_dict(over)) if over
                else (None, None))
    zero1 = {**(over or {}), "embed": ("data", "model")}
    for opt_t, opt_j in ((None, None),
                         (rules_dict(zero1), j_rules_dict(zero1))):
        (params, opt), (params_sh, opt_sh) = tspecs.model_state_specs(
            t, _tmesh(layout), with_opt=True, rules=trl, opt_rules=opt_t)
        jparams, jopt = jspecs.model_state_specs(
            j, _jmesh(layout), with_opt=True, rules=jrl, opt_rules=opt_j)
        _same(params, params_sh, jparams)
        _same(opt.mu, opt_sh.mu, jopt.mu)
        _same(opt.nu, opt_sh.nu, jopt.nu)
        assert opt.step.dtype == torch.int32 and opt.step.shape == ()
    (_, none), _ = tspecs.model_state_specs(t, _tmesh(layout), False)
    assert none is None


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_and_decode_specs_match_jax(arch, layout, monkeypatch):
    _jsds(monkeypatch)
    for shape_name in ("decode_32k", "long_500k"):
        t, j = _cfgs(arch, shape_name)
        shape = tconfigs.SHAPES[shape_name]
        cache, cache_sh = tspecs.cache_specs(t, shape, _tmesh(layout))
        _same(cache, cache_sh,
              jspecs.cache_specs(j, jconfigs.SHAPES[shape_name],
                                 _jmesh(layout)))
        (token, position), (token_sh, pos_sh) = tspecs.decode_specs(
            t, shape, _tmesh(layout))
        jtoken, jpos = jspecs.decode_specs(j, jconfigs.SHAPES[shape_name],
                                           _jmesh(layout))
        _same({"t": token}, {"t": token_sh}, {"t": jtoken})
        assert jpos.shape == () and position == shape.seq_len - 1
        assert tuple(pos_sh.spec) == ()


def test_shard_bytes_is_the_rank_block():
    """kimi-k2's parameters over (16, 16): the rank's blocks, leaf by
    leaf, sum to the spec-divided sizes."""
    cfg = tconfigs.get_config("kimi-k2-1t-a32b").replace(
        param_dtype="bfloat16")
    (params, _), (sh, _) = tspecs.model_state_specs(cfg, _tmesh("16x16"),
                                                    False)
    want = 0
    for t, s in zip(_named(params).values(), _named(sh).values()):
        blocks = 1
        for e in s.spec:
            for a in ((e,) if isinstance(e, str) else (e or ())):
                blocks *= 16
        want += t.numel() * t.element_size() // blocks
    assert tspecs.shard_bytes(params, sh) == want
    assert want < sum(t.numel() * t.element_size()
                      for t in _named(params).values()) / 100


@pytest.mark.parametrize("shape_name", SHAPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_model_flops_match_jax(arch, shape_name):
    t, j = _cfgs(arch, shape_name)
    assert trf.active_matmul_params(t) == pytest.approx(
        jrf.active_matmul_params(j), rel=1e-12)
    assert trf.analytic_model_flops(
        t, tconfigs.SHAPES[shape_name]) == pytest.approx(
        jrf.analytic_model_flops(j, jconfigs.SHAPES[shape_name]), rel=1e-12)


def test_analytic_model_flops_sane():
    cfg = tconfigs.get_config("internlm2-1.8b").replace(
        param_dtype="bfloat16")
    n = trf.active_matmul_params(cfg)
    assert 1.5e9 < n < 2.2e9
    f_train = trf.analytic_model_flops(cfg, tconfigs.SHAPES["train_4k"])
    assert f_train > 6 * n * 4096 * 256
    assert trf.analytic_model_flops(cfg, tconfigs.SHAPES["decode_32k"]) \
        < f_train


def test_moe_active_params():
    assert trf.active_matmul_params(
        tconfigs.get_config("kimi-k2-1t-a32b")) < 6e10


def test_collective_bytes_match_jax_parser():
    """tests/test_launch.py's two collectives as recorder events: an fp32
    [16, 512] all-reduce over a group of 16 and a bf16 [32, 128]
    all-gather over 4, against JAX's parse of their HLO."""
    hlo = """
  %all-reduce.1 = f32[16,512]{1,0} all-reduce(%dot), channel_id=1, replica_groups=[16,16]<=[256], use_global_device_ids=true
  %all-gather.2 = bf16[32,128]{1,0} all-gather(%x), replica_groups={{0,1,2,3}}, dimensions={0}
  %notacollective = f32[8]{0} add(%a, %b)
"""
    events = [CollectiveEvent("all-reduce", 16 * 512 * 4, 16, ("model",),
                              tuple(range(16))),
              CollectiveEvent("all-gather", 32 * 128 * 2, 4, ("model",),
                              (0, 1, 2, 3))]
    got, want = trf.collective_bytes(events), jrf.collective_bytes(hlo)
    assert got == pytest.approx(want)
    assert got["count"] == 2
    # the all-gather's four ranks share a node; the all-reduce's 16 do not
    assert trf.link_bytes(events) == {"nvlink": got["all-gather"],
                                      "ib": got["all-reduce"]}
    for op, g, size in (("reduce-scatter", 4, 100.0),
                        ("all-to-all", 8, 64.0),
                        ("collective-permute", 2, 10.0)):
        e = CollectiveEvent(op, int(size), g, (), tuple(range(g)))
        assert trf.collective_bytes([e])[op] == {
            "reduce-scatter": size * (g - 1), "all-to-all": size * (g - 1) / g,
            "collective-permute": size}[op]


def _group_ranks(shape, axis, rank):
    """The global ranks of `rank`'s group along `axis` of a row-major
    mesh of `shape` (the order `init_device_mesh` lays ranks out in)."""
    stride = int(np.prod(shape[axis + 1:]))
    base = rank - (rank // stride) % shape[axis] * stride
    return tuple(base + i * stride for i in range(shape[axis]))


def test_link_rule():
    """One node of 8 consecutive ranks is NVLink; the production layouts'
    axes all cross nodes, so every group is charged InfiniBand."""
    for shape in ((1, 1), (2, 4)):
        for axis in range(2):
            for rank in range(int(np.prod(shape))):
                assert trf.link_of(_group_ranks(shape, axis, rank)) \
                    == "nvlink"
    for shape in ((16, 16), (2, 16, 16)):
        for axis in range(len(shape)):
            for rank in (0, 7, 100, int(np.prod(shape)) - 1):
                g = _group_ranks(shape, axis, rank)
                assert rank in g and len(g) == shape[axis]
                assert trf.link_of(g) == "ib"
    assert _group_ranks((16, 16), 1, 17) == tuple(range(16, 32))
    assert _group_ranks((16, 16), 0, 17) == tuple(range(1, 256, 16))
    ev = CollectiveEvent("all-reduce", 1000, 8, ("model",), tuple(range(8)))
    links = trf.link_bytes([ev])
    assert links == {"nvlink": 1750.0, "ib": 0.0}
    assert trf.collective_seconds(links) == pytest.approx(1750.0 / 450e9)
    ib = trf.link_bytes([dataclasses.replace(ev, ranks=tuple(range(4, 12)))])
    assert trf.collective_seconds(ib) == pytest.approx(1750.0 / 50e9)


# ---------------------------------------------------------------------------
# The repairs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", range(4))
def test_route_counts_equal_bincount(seed):
    """`_route`'s fixed-size count gives bincount's integers; the gates,
    routes and aux loss are those of the same router."""
    g = torch.Generator().manual_seed(seed)
    E, d, T = (8, 16, 64) if seed % 2 else (384, 32, 37)
    cfg = tffn.MoEConfig(d_model=d, d_ff=8, n_experts=E, top_k=2 + seed % 3)
    x = torch.randn(T, d, generator=g)
    w = torch.randn(d, E, generator=g)
    gates, idx, aux, counts = tffn._route(w, x, cfg)
    want = torch.bincount(idx.reshape(-1), minlength=E)
    assert counts.dtype == want.dtype and torch.equal(counts, want)
    probs = torch.softmax(x @ w, -1)
    frac = want.float() / want.sum().float()
    assert torch.equal(aux, E * torch.sum(frac * probs.mean(0)))


def test_moe_local_path_on_meta_raises():
    cfg = tffn.MoEConfig(d_model=16, d_ff=8, n_experts=4, top_k=2)
    meta = lambda *s: torch.empty(s, device="meta")  # noqa: E731
    with pytest.raises(RuntimeError, match="depends on the data"):
        tffn._moe_local_math(meta(6, 16), meta(16, 4), meta(4, 16, 8),
                             meta(4, 16, 8), meta(4, 8, 16), cfg)
    # the route itself takes meta tensors
    _, idx, aux, counts = tffn._route(meta(16, 4), meta(6, 16), cfg)
    assert counts.shape == (4,) and idx.shape == (6, 2)
