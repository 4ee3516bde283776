"""The port's logical-axis sharding against the JAX package's: rule
resolution on the production layouts (every assertion of
tests/test_sharding.py's script, with no process group), `param_count`,
the abstract parameter and cache trees of all ten archs leaf for leaf
(shape, dtype, logical axes), the rank's blocks, and the sequence-sharded
`gqa_decode` in a world of 8 gloo processes on a (2, 4) mesh against
JAX's dense decode."""
import types

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from _torch_world import run_world
import repro.configs as jconfigs
from repro.models import attention as jattn
from repro.models import encdec as jencdec
from repro.models import transformer as jtfm
from repro.models.common import ParamFactory
from repro.sharding import AbstractParam as JAbstractParam
from repro.sharding import ParallelContext as JParallelContext
from repro.sharding import logical_to_spec as j_logical_to_spec
from repro.sharding import param_count as j_param_count
from repro.sharding import rules_dict as j_rules_dict
import repro_torch.configs as tconfigs
from repro_torch.launch.mesh import (make_context, make_host_mesh,
                                     make_production_mesh)
from repro_torch.models import encdec as tencdec
from repro_torch.models import transformer as ttfm
from repro_torch.sharding import (DEFAULT_RULES, AbstractParam,
                                  ParallelContext, Spec, logical_to_spec,
                                  make_mesh, param_count, rules_dict,
                                  shard_params, tree_shape_structs,
                                  tree_shardings)


# ---------------------------------------------------------------------------
# Rule resolution
# ---------------------------------------------------------------------------

MESH = make_production_mesh()                  # (16, 16) data, model
MESH2 = make_production_mesh(multi_pod=True)   # (2, 16, 16) pod, data, model

# (logical axes, shape, mesh, expected spec): tests/test_sharding.py's
# script, then batch 1 with 8 KV heads on the (2, 4) test mesh
SCRIPT_CASES = {
    "divisible": (("vocab", "embed"), (163840, 7168), MESH,
                  Spec("model", "data")),
    "non-divisible": (("heads", None), (40, 128), MESH, Spec(None, None)),
    "kv_heads-8-of-16": ((None, None, "kv_heads", None), (1, 5, 8, 128),
                         MESH, Spec(None, None, None, None)),
    "batch1-frees-data": (("batch", "cache_seq", "kv_heads", None),
                          (1, 524288, 8, 128), MESH,
                          Spec(None, "data", None, None)),
    "batch128-takes-data": (("batch", "cache_seq", "kv_heads", None),
                            (128, 32768, 8, 128), MESH,
                            Spec("data", None, None, None)),
    "multi-pod-batch": (("batch", None), (256, 7), MESH2,
                        Spec(("pod", "data"), None)),
}


def _layout(shape, axes):
    from repro_torch.sharding import MeshLayout
    return MeshLayout(shape, axes)


@pytest.mark.parametrize("case", list(SCRIPT_CASES))
def test_rules_resolve_as_the_jax_script_asserts(case):
    axes, shape, mesh, want = SCRIPT_CASES[case]
    got = logical_to_spec(axes, shape, mesh)
    assert got == want and isinstance(got, Spec), got
    if case == "kv_heads-8-of-16":
        assert got[2] is None


def test_batch1_on_the_test_mesh_shards_seq_over_data_and_kv_heads():
    """B = 1 on (2, 4): the sequence takes `data`, the 8 KV heads `model`
    (the layout of the B = 1 decode case below)."""
    s = logical_to_spec(("batch", "cache_seq", "kv_heads", None),
                        (1, 524288, 8, 128), _layout((2, 4),
                                                     ("data", "model")))
    assert s == Spec(None, "data", "model", None), s


def test_tree_shardings_placements():
    from torch.distributed.tensor import Replicate, Shard
    tree = {"w": AbstractParam((512, 256), torch.float32, ("embed", "ffn")),
            "n": AbstractParam((7,), torch.float32, ("act_embed",))}
    sh = tree_shardings(tree, MESH)
    assert sh["w"].spec == Spec("data", "model"), sh
    assert sh["w"].placements == (Shard(0), Shard(1))
    assert sh["n"].placements == (Replicate(), Replicate())
    sh2 = tree_shardings({"b": AbstractParam((256, 3), torch.float32,
                                             ("batch", None))}, MESH2)
    assert sh2["b"].placements == (Shard(0), Shard(0), Replicate())
    meta = tree_shape_structs(tree)
    assert meta["w"].device.type == "meta" and meta["w"].shape == (512, 256)


def test_rules_table_and_resolution_equal_jax():
    """The rule table is JAX's; over every logical axis, rule override
    and random dims on three layouts, the port resolves JAX's specs
    (JAX's `logical_to_spec` reads only the mesh's names and shape)."""
    assert rules_dict() == j_rules_dict()
    assert [k for k, _ in DEFAULT_RULES] == list(j_rules_dict())
    rng = np.random.default_rng(0)
    names = list(j_rules_dict()) + [None]
    layouts = [((16, 16), ("data", "model")), ((2, 4), ("data", "model")),
               ((2, 16, 16), ("pod", "data", "model"))]
    overrides = [None, {"cache_seq": ("data", "model")},
                 {"expert_embed": (), "expert_ffn": ("data",)},
                 {"unembed_d": ("data",)}]
    for trial in range(600):
        shape, axes = layouts[trial % 3]
        fake = types.SimpleNamespace(axis_names=axes,
                                     devices=np.empty(shape))
        rank = int(rng.integers(1, 5))
        logical = tuple(names[i] for i in rng.integers(0, len(names), rank))
        dims = tuple(int(rng.choice([1, 2, 3, 4, 8, 12, 16, 40, 64, 128,
                                     256, 512])) for _ in range(rank))
        ov = overrides[trial % 4]
        want = j_logical_to_spec(logical, dims, fake, j_rules_dict(ov))
        got = logical_to_spec(logical, dims, _layout(shape, axes),
                              rules_dict(ov))
        assert tuple(got) == tuple(want), (logical, dims, shape, ov)


def test_param_count():
    tree = {"a": AbstractParam((3, 4), torch.float32, (None, None)),
            "b": AbstractParam((5,), torch.float32, (None,))}
    assert param_count(tree) == 17
    assert param_count({"t": torch.zeros(2, 3)}) == 6


def test_meshes_and_contexts():
    assert MESH.shape == (16, 16) and MESH.axis_names == ("data", "model")
    assert MESH2.mesh_dim_names == ("pod", "data", "model")
    ctx = make_context(MESH2)
    assert ctx.pod_axis == "pod" and ctx.model_parallel_size == 16
    assert make_context(MESH).pod_axis is None
    assert ParallelContext().model_parallel_size == 1
    with pytest.raises(RuntimeError, match="world"):
        make_mesh((2, 4), ("data", "model"), "cpu")
    with pytest.raises(RuntimeError, match="world"):
        make_host_mesh("cpu")
    with pytest.raises(RuntimeError, match="DeviceMesh"):
        ctx.coord(("data",))
    from repro_torch.sharding import take_block
    with pytest.raises(ValueError, match="split"):
        take_block(torch.zeros(6, 3), Spec("model", None), _FakeCtx(0, 1))


def test_context_refuses_a_mesh_that_does_not_cover_the_world(tmp_path):
    """The transposes sum and count replicas over the whole world, so a
    context on a mesh of fewer ranks than the world is refused; the host
    mesh of a world of one is taken."""
    import torch.distributed as dist
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/init",
                            rank=0, world_size=1)
    try:
        make_context(make_host_mesh("cpu"))
        part = types.SimpleNamespace(size=lambda: 4,
                                     mesh_dim_names=("data", "model"))
        with pytest.raises(ValueError, match="cover the world"):
            ParallelContext(mesh=part)
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# Abstract trees
# ---------------------------------------------------------------------------

def _named(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_named(tree[k], f"{prefix}/{k}"))
        return out
    return {prefix: tree}


def _leaves(tree):
    return _named(jax.tree.map(lambda a: a, tree,
                               is_leaf=lambda a: isinstance(a, JAbstractParam)))


def _same_leaves(port, ref):
    tp, jp = _named(port), _leaves(ref)
    assert list(tp) == list(jp)
    for k in tp:
        t, j = tp[k], jp[k]
        assert isinstance(t, AbstractParam), k
        assert t.shape == tuple(j.shape), k
        assert str(t.dtype).split(".")[-1] == np.dtype(j.dtype).name, k
        assert t.logical_axes == tuple(j.logical_axes), k


@pytest.mark.parametrize("arch", tconfigs.ARCH_IDS)
def test_abstract_params_carry_jax_axes(arch):
    tcfg = tconfigs.reduced(tconfigs.get_config(arch))
    jcfg = jconfigs.reduced(jconfigs.get_config(arch))
    port = ttfm.init_params(tcfg, abstract=True)
    ref = jtfm.init_params(jcfg, None, abstract=True)
    _same_leaves(port, ref)
    assert param_count(port) == j_param_count(ref)


@pytest.mark.parametrize("arch", tconfigs.ARCH_IDS)
def test_abstract_cache_carries_jax_axes(arch):
    tcfg = tconfigs.reduced(tconfigs.get_config(arch))
    jcfg = jconfigs.reduced(jconfigs.get_config(arch))
    _same_leaves(ttfm.init_cache(tcfg, 2, 16, abstract=True),
                 jtfm.init_cache(jcfg, 2, 16, abstract=True))


@pytest.mark.parametrize("reduce", [True, False])
def test_abstract_encdec_cache_carries_jax_axes(reduce):
    """whisper-small's cache through `encdec.init_cache`, whose cross K/V
    leaves the test above never reaches; the meta tensors of its tree
    allocate nothing."""
    tcfg = tconfigs.get_config("whisper-small")
    jcfg = jconfigs.get_config("whisper-small")
    if reduce:
        tcfg, jcfg = tconfigs.reduced(tcfg), jconfigs.reduced(jcfg)
    port = tencdec.init_cache(tcfg, 2, 16, abstract=True)
    _same_leaves(port, jencdec.init_cache(jcfg, 2, 16, abstract=True))
    assert port["cross_kv"]["k"].logical_axes == (
        "layers", "batch", "seq", "heads", "head_dim")
    assert all(t.device.type == "meta"
               for t in _named(tree_shape_structs(port)).values())


def test_full_width_abstract_tree_is_jax_sharding_plan():
    """kimi-k2 at published width: leaf specs on the production mesh
    equal JAX's, and the tree never allocates."""
    tcfg = tconfigs.get_config("kimi-k2-1t-a32b")
    jcfg = jconfigs.get_config("kimi-k2-1t-a32b")
    port = _named(ttfm.init_params(tcfg, abstract=True))
    ref = _leaves(jtfm.init_params(jcfg, None, abstract=True))
    fake = types.SimpleNamespace(axis_names=("data", "model"),
                                 devices=np.empty((16, 16)))
    for k, leaf in port.items():
        want = j_logical_to_spec(ref[k].logical_axes, ref[k].shape, fake)
        got = logical_to_spec(leaf.logical_axes, leaf.shape, MESH)
        assert tuple(got) == tuple(want), k


def test_shard_params_gives_the_rank_its_blocks():
    """On a (2, 4) layout with the rank placed by hand, each rank's blocks
    tile the full tree: views where contiguous, copies where not."""
    cfg = tconfigs.reduced(tconfigs.get_config("kimi-k2-1t-a32b"))
    full = ttfm.init_params(cfg, 0, "cpu")
    abstract = ttfm.init_params(cfg, abstract=True)
    w = full["blocks"]["moe"]["moe"]["w_gate"]          # [L, E, d, f]
    got = torch.zeros_like(w)
    for r in range(8):
        ctx = _FakeCtx(r // 4, r % 4)
        blocks = shard_params(full, abstract, ctx)
        b = blocks["blocks"]["moe"]["moe"]["w_gate"]
        E, d = w.shape[1] // 4, w.shape[2] // 2
        assert b.shape == (w.shape[0], E, d, w.shape[3])
        got[:, (r % 4) * E:(r % 4 + 1) * E,
            (r // 4) * d:(r // 4 + 1) * d] = b
        # replicated leaves are the full tensors; a block over two dims
        # is a contiguous copy
        assert blocks["final_norm"].data_ptr() == full["final_norm"].data_ptr()
        assert all(t.is_contiguous() for t in _named(blocks).values())
    assert torch.equal(got, w)


class _FakeCtx(ParallelContext):
    """A (2, 4) context whose rank sits at (i, j), with no process group."""

    def __init__(self, i, j):
        super().__init__(mesh=_layout((2, 4), ("data", "model")))
        object.__setattr__(self, "_at", {"data": i, "model": j})

    def coord(self, axes):
        idx = 0
        for a in axes:
            idx = idx * self.axis_size(a) + self._at[a]
        return idx


# ---------------------------------------------------------------------------
# The sequence-sharded decode in a world of 8
# ---------------------------------------------------------------------------

# case: (B, H, KV, hd, d, S, position, cache_seq over (data, model))
DECODE_CASES = {
    # tests/test_sharding.py's inputs: batch over data, sequence over model
    "jax-test": (4, 4, 2, 16, 32, 64, 40, True),
    # batch 1 under the default rules: the sequence over data and the KV
    # heads over model. JAX's own sharded decode gives the wrong output
    # here (it pairs every query head with the rank's KV heads): it
    # differs from JAX's dense decode by 0.865 on outputs of scale 1.0
    "batch1-kv-heads-sharded": (1, 8, 4, 16, 32, 64, 40, False),
}
SPECS = {"jax-test": Spec("data", "model", None, None),
         "batch1-kv-heads-sharded": Spec(None, "data", "model", None)}


@pytest.fixture(scope="module")
def decode_world(tmp_path_factory):
    rng = np.random.default_rng(7)
    inputs, refs = {"cases": np.array(list(DECODE_CASES))}, {}
    for case, (B, H, KV, hd, d, S, pos, both) in DECODE_CASES.items():
        cfg = jattn.AttnConfig(d_model=d, n_heads=H, n_kv_heads=KV,
                               head_dim=hd)
        jp = jattn.init_gqa(ParamFactory(jax.random.PRNGKey(0), jnp.float32),
                            cfg)
        cache = {n: rng.standard_normal((B, S, KV, hd)).astype(np.float32)
                 for n in ("k", "v")}
        x = rng.standard_normal((B, 1, d)).astype(np.float32)
        y, c = jattn.gqa_decode(jp, cfg, jnp.asarray(x), jnp.int32(pos),
                                {n: jnp.asarray(a) for n, a in cache.items()},
                                JParallelContext())
        refs[case] = (np.asarray(y), {n: np.asarray(c[n]) for n in c})
        inputs.update({f"{case}:dims": np.array([H, KV, hd, d]),
                       f"{case}:seq_over_both": np.array(int(both)),
                       f"{case}:x": x, f"{case}:pos": np.array(pos),
                       f"{case}:k": cache["k"], f"{case}:v": cache["v"]})
        for n, a in jax.device_get(jp).items():
            inputs[f"{case}:p/{n}"] = np.asarray(a)
    outs = run_world("decode", inputs, tmp_path_factory.mktemp("decode"))
    return outs, refs


@pytest.mark.parametrize("case", list(DECODE_CASES))
def test_seq_sharded_decode_matches_jax_dense(decode_world, case):
    outs, refs = decode_world
    for o in outs:
        assert o[f"{case}:spec"][0] == repr(SPECS[case])
        np.testing.assert_allclose(o[f"{case}:y"], refs[case][0], atol=1e-5,
                                   rtol=1e-4)


@pytest.mark.parametrize("case", list(DECODE_CASES))
def test_seq_sharded_decode_writes_only_its_block(decode_world, case):
    """The ranks' cache blocks tile JAX's written cache: the new token's
    K/V at `position`, every other entry as it was."""
    outs, refs = decode_world
    for n in ("k", "v"):
        got = np.full_like(refs[case][1][n], np.nan)
        for o in outs:
            blk = o[f"{case}:{n}_blk"]
            b, s, h = (int(v) for v in o[f"{case}:offs"])
            got[b:b + blk.shape[0], s:s + blk.shape[1],
                h:h + blk.shape[2]] = blk
        np.testing.assert_allclose(got, refs[case][1][n], atol=2e-6,
                                   rtol=0)


def test_decode_ctx_none_and_unsplit_context_are_the_dense_path():
    """With no mesh, or a mesh whose rules leave the sequence whole, the
    dense path runs (no process group is touched)."""
    from repro_torch.models.attention import _seq_sharded_spec
    mask = torch.ones(1, 64, dtype=torch.bool)
    assert _seq_sharded_spec((4, 64, 2, 16), mask, None) is None
    ctx = ParallelContext(mesh=_layout((2, 4), ("data", "model")))
    assert _seq_sharded_spec((4, 64, 2, 16), mask, ctx) is None   # batch
    assert _seq_sharded_spec((1, 64, 2, 16), mask, ctx) == Spec(
        None, "data", None, None)
    assert _seq_sharded_spec((1, 64, 2, 16), mask[None], ctx) is None
    one = ParallelContext(mesh=_layout((1, 1), ("data", "model")))
    assert _seq_sharded_spec((1, 64, 2, 16), mask, one) is None
