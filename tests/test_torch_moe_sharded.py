"""The port's expert-parallel MoE and d-sharded confidence against the
JAX package: the GShard capacity buffer and the per-destination packing
(outputs and dropped rows), then, in a world of 8 gloo processes on a
(2, 4) mesh, the scatter (all_to_all) and decode (psum) paths under both
weight layouts against JAX's `_moe_local_math` (tests/test_moe.py's
config and tolerances), the scatter path's gradients against `jax.grad`
of the same loss through JAX's local path, the scatter path at capacity factor 1.25 against JAX's own
scatter path on 8 host devices with the same drops, and the d-sharded
`fused_confidence` against JAX's; finally a world of one, where every
path with a context is the path without one, bit for bit."""
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from _torch_world import run_world
from repro.launch import steps as jsteps
from repro.models import ffn as jffn
from repro.models.common import ParamFactory
import repro_torch.models.ffn as tffn
from repro_torch.launch import steps as tsteps

REPO = Path(__file__).resolve().parents[1]
D, F, E, K = 16, 8, 8, 2                  # tests/test_moe.py's MoE
B, T = 4, 8
B125, T125 = 4, 64                        # long enough to overflow at 1.25


def _t(a):
    return torch.from_numpy(np.array(a))


# ---------------------------------------------------------------------------
# The capacity buffer and the packing, in-process
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cf", [0.25, 1.25, 8.0])
def test_expert_ffn_capacity_matches_jax(cf):
    rng = np.random.default_rng(int(cf * 100))
    A, n_exp = 96, 6
    x = rng.standard_normal((A, D)).astype(np.float32)
    # a skewed draw over the experts and the sentinel (padding) id
    e = rng.choice(n_exp + 1, size=A, p=[.3, .2, .15, .1, .1, .05, .1])
    w = [rng.standard_normal(s).astype(np.float32) / 3
         for s in ((n_exp, D, F), (n_exp, D, F), (n_exp, F, D))]
    ref = np.asarray(jffn._expert_ffn_capacity(
        jnp.asarray(x), jnp.asarray(e, jnp.int32), *map(jnp.asarray, w),
        n_exp, capacity_factor=cf))
    got = tffn._expert_ffn_capacity(_t(x), _t(e), *map(_t, w), n_exp,
                                    capacity_factor=cf).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=1e-5)
    dropped = ~np.any(ref != 0, axis=1)
    assert np.array_equal(~np.any(got != 0, axis=1), dropped)
    assert dropped[e == n_exp].all()
    if cf < 1:
        assert dropped[e < n_exp].any()         # overflow happened


@pytest.mark.parametrize("cf", [0.25, 1.25, 8.0])
def test_pack_by_destination_matches_jax(cf):
    rng = np.random.default_rng(int(cf * 10))
    T_, A, n_dst = 40, 80, 4
    x = rng.standard_normal((T_, D)).astype(np.float32)
    tok = np.arange(A) // 2
    dst = rng.choice(n_dst, size=A, p=[.4, .3, .2, .1])
    valid = (rng.random(A) > 0.1).astype(np.int32)
    cap = tffn._round_cap(A / n_dst * cf)
    buf, slot = jffn._pack_by_destination(
        jnp.asarray(x), jnp.asarray(tok), jnp.asarray(dst, jnp.int32),
        jnp.asarray(valid), n_dst, cap)
    tbuf, tslot = tffn._pack_by_destination(_t(x), _t(tok), _t(dst),
                                            _t(valid), n_dst, cap)
    np.testing.assert_array_equal(tslot.numpy(), np.asarray(slot))
    np.testing.assert_array_equal(tbuf.numpy(), np.asarray(buf))
    assert (np.asarray(slot)[valid == 1] >= cap).any() == (cf < 1)


# ---------------------------------------------------------------------------
# The world of 8
# ---------------------------------------------------------------------------

_JAX_SCATTER = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    sys.path.insert(0, "src")
    import jax, jax.numpy as jnp, numpy as np
    from repro.models.ffn import MoEConfig, moe_forward
    from repro.sharding import ParallelContext, make_mesh
    inp = np.load(sys.argv[1])
    p = {n: jnp.asarray(inp[n]) for n in ("router", "w_gate", "w_up",
                                          "w_down")}
    cfg = MoEConfig(d_model=16, d_ff=8, n_experts=8, top_k=2,
                    capacity_factor=1.25)
    ctx = ParallelContext(mesh=make_mesh((2, 4), ("data", "model")))
    y, aux = jax.jit(lambda p, x: moe_forward(p, cfg, x, ctx))(
        p, jnp.asarray(inp["x"]))
    np.savez(sys.argv[2], y=np.asarray(y), aux=np.asarray(aux))
""")


def _jax_moe(seed, router_scale=1.0):
    cfg = jffn.MoEConfig(d_model=D, d_ff=F, n_experts=E, top_k=K,
                         capacity_factor=8.0)
    p = jax.device_get(jffn.init_moe(
        ParamFactory(jax.random.PRNGKey(seed), jnp.float32), cfg))
    p = {n: np.asarray(a) for n, a in p.items()}
    p["router"] = p["router"] * router_scale
    return cfg, p


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("moe")
    cfg, p = _jax_moe(0)
    x = np.asarray(jax.random.normal(jax.random.PRNGKey(1), (B, T, D)))
    rng = np.random.default_rng(5)
    _, p125 = _jax_moe(3, router_scale=4.0)     # skewed: overflow at 1.25
    x125 = rng.standard_normal((B125, T125, D)).astype(np.float32)
    inputs = {"moe:dims": np.array([D, F, E, K]), "moe:x": x,
              "moe:w": rng.standard_normal((B, T, D)).astype(np.float32),
              "moe125:x": x125,
              "conf:x": rng.standard_normal((6, 32)).astype(np.float32),
              "conf:table": (rng.standard_normal((96, 32)) * 0.5
                             ).astype(np.float32)}
    inputs.update({f"moe:p/{n}": a for n, a in p.items()})
    inputs.update({f"moe125:p/{n}": a for n, a in p125.items()})
    np.savez(tmp / "jax_in.npz", x=x125, **p125)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    jproc = subprocess.Popen(
        [sys.executable, "-c", _JAX_SCATTER, str(tmp / "jax_in.npz"),
         str(tmp / "jax_out.npz")], cwd=REPO, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        outs = run_world("moe", inputs, tmp)
        log = jproc.communicate(timeout=120)[0]
    finally:
        if jproc.poll() is None:
            jproc.kill()
            jproc.wait()
    assert jproc.returncode == 0, log[-3000:]
    jout = dict(np.load(tmp / "jax_out.npz"))
    return outs, inputs, cfg, p, jout


@pytest.mark.parametrize("path", ["scatter", "decode", "ffn_scatter",
                                  "ffn_decode"])
def test_distributed_path_matches_jax_local_oracle(world, path):
    """scatter (all_to_all) and decode (psum), under the default layout
    and under expert_embed -> (), expert_ffn -> data ("gather tokens, not
    weights"), on every rank == JAX's `_moe_local_math`."""
    outs, inputs, cfg, p, _ = world
    jp = {n: jnp.asarray(a) for n, a in p.items()}
    y_ref, _ = jffn._moe_local_math(
        jnp.asarray(inputs["moe:x"]).reshape(B * T, D), jp["router"],
        jp["w_gate"], jp["w_up"], jp["w_down"], cfg)
    y_ref = np.asarray(y_ref).reshape(B, T, D)
    for o in outs:
        np.testing.assert_allclose(o[f"{path}:y"], y_ref, atol=1e-4,
                                   rtol=1e-3)
        assert o[f"{path}:aux"] == outs[0][f"{path}:aux"]


def _blocks(x):
    """The (data, model) ranks' token blocks of x [B, T, d], rank order."""
    b, t = x.shape[0] // 2, x.shape[1] // 4
    return [x[i * b:(i + 1) * b, j * t:(j + 1) * t].reshape(-1, x.shape[-1])
            for i in range(2) for j in range(4)]


@pytest.mark.parametrize("leaf", ["router", "w_gate", "w_up", "w_down", "x"])
def test_scatter_path_gradients_match_jax(world, leaf):
    """(y * w).sum() + 0.5 aux through the scatter path, on every rank ==
    `jax.grad` of the same loss through JAX's `_moe_local_math`, whose aux
    is the mean of JAX's `_route` aux over the ranks' token blocks (the
    scatter path's pmean). A transpose that summed where it should slice
    would scale these by the world size."""
    outs, inputs, cfg, p, _ = world
    names = ("router", "w_gate", "w_up", "w_down")
    w = jnp.asarray(inputs["moe:w"])

    def loss(args):
        x, *ws = args
        y, _ = jffn._moe_local_math(x.reshape(B * T, D), *ws, cfg)
        aux = jnp.mean(jnp.stack([jffn._route(ws[0], blk, cfg)[2]
                                  for blk in _blocks(x)]))
        return (y.reshape(B, T, D) * w).sum() + 0.5 * aux

    grads = jax.grad(loss)([jnp.asarray(inputs["moe:x"])]
                           + [jnp.asarray(p[n]) for n in names])
    ref = np.asarray(grads[0 if leaf == "x" else 1 + names.index(leaf)])
    assert np.abs(ref).max() > 0
    for o in outs:
        np.testing.assert_allclose(o[f"grad:{leaf}"], ref, atol=1e-5,
                                   rtol=1e-4)


def test_scatter_path_at_capacity_1_25_drops_what_jax_drops(world):
    """The scatter path at the published capacity factor == JAX's scatter
    path (shard_map over 8 host devices) on the same weights and tokens,
    output and aux; the dropped share equals the one JAX's own routing
    and packing give for each rank's tokens, and is not zero."""
    outs, inputs, _, _, jout = world
    jcfg = jffn.MoEConfig(d_model=D, d_ff=F, n_experts=E, top_k=K,
                          capacity_factor=1.25)
    router = jnp.asarray(inputs["moe125:p/router"])
    shares = []
    for blk in _blocks(inputs["moe125:x"]):
        _, idx, _ = jffn._route(router, jnp.asarray(blk), jcfg)
        A = idx.size
        cap = tffn._round_cap(A / 4 * jcfg.capacity_factor)
        _, slot = jffn._pack_by_destination(
            jnp.asarray(blk), jnp.arange(A) // K, idx.reshape(A) // (E // 4),
            jnp.ones((A,), jnp.int32), 4, cap)
        shares.append(float((np.asarray(slot) >= cap).mean()))
    want = np.float32(np.mean(np.float32(shares)))
    for o in outs:
        np.testing.assert_allclose(o["drop:y"], jout["y"], atol=1e-5,
                                   rtol=1e-4)
        np.testing.assert_allclose(o["drop:aux"], jout["aux"], rtol=1e-5)
        np.testing.assert_allclose(o["drop:dropped"], want, rtol=1e-6)
    assert want > 0


def test_d_sharded_confidence_matches_jax(world):
    """unembed_d -> data: each rank contracts its d-slices and the
    partial logits are summed; (neg_entropy, max_prob) within 1e-5 of
    JAX's `fused_confidence`, argmax equal; the summed logits (the
    kernel path's input) within 1e-5 of the full product."""
    outs, inputs, *_ = world
    x, table = jnp.asarray(inputs["conf:x"]), jnp.asarray(inputs["conf:table"])
    ref = [np.asarray(a) for a in jsteps.fused_confidence(x, table)]
    logits = np.asarray(jnp.einsum("td,vd->tv", x, table,
                                   preferred_element_type=jnp.float32))
    for o in outs:
        np.testing.assert_allclose(o["conf:neg_ent"], ref[0], atol=1e-5)
        np.testing.assert_allclose(o["conf:max_prob"], ref[1], atol=1e-5)
        np.testing.assert_array_equal(o["conf:argmax"], ref[2])
        np.testing.assert_allclose(o["conf:logits"], logits, atol=1e-5)


# ---------------------------------------------------------------------------
# A world of one: the host mesh
# ---------------------------------------------------------------------------

def test_host_mesh_context_is_bit_equal_to_none(tmp_path):
    """moe_forward (both dispatches), the GQA decode and fused_confidence
    under `make_host_mesh`'s (1, 1) context, with unembed_d and cache_seq
    ruled onto its axes, equal their ctx=None results bit for bit."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_context, make_host_mesh
    from repro_torch.models.attention import AttnConfig, gqa_decode
    from repro_torch.sharding import rules_dict
    rng = np.random.default_rng(2)
    cfg = tffn.MoEConfig(d_model=D, d_ff=F, n_experts=E, top_k=K,
                         n_shared_experts=1, shared_d_ff=8)
    p = {"router": _t(rng.standard_normal((D, E)).astype(np.float32)),
         "w_gate": _t(rng.standard_normal((E, D, F)).astype(np.float32)),
         "w_up": _t(rng.standard_normal((E, D, F)).astype(np.float32)),
         "w_down": _t(rng.standard_normal((E, F, D)).astype(np.float32)),
         "shared": {n: _t(rng.standard_normal(s).astype(np.float32))
                    for n, s in (("w_gate", (D, 8)), ("w_up", (D, 8)),
                                 ("w_down", (8, D)))}}
    x = _t(rng.standard_normal((B, T, D)).astype(np.float32))
    acfg = AttnConfig(d_model=D, n_heads=4, n_kv_heads=2, head_dim=8)
    ap = {n: _t(rng.standard_normal(s).astype(np.float32) / 4)
          for n, s in (("wq", (D, 4, 8)), ("wk", (D, 2, 8)),
                       ("wv", (D, 2, 8)), ("wo", (4, 8, D)))}
    cache0 = rng.standard_normal((1, 32, 2, 8)).astype(np.float32)
    table = _t(rng.standard_normal((64, D)).astype(np.float32))

    def run(ctx):
        out = [t for dec in (False, True)
               for t in tffn.moe_forward(p, cfg, x, ctx, decode=dec)]
        cache = {"k": _t(cache0), "v": _t(cache0)}
        y, c = gqa_decode(ap, acfg, x[:1, :1], 20, cache, ctx=ctx)
        out += [y, c["k"]]
        out += list(tsteps.fused_confidence(x[:, 0], table, ctx=ctx))
        return out

    ref = run(None)
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/init",
                            rank=0, world_size=1)
    try:
        ctx = make_context(make_host_mesh("cpu"),
                           rules_dict({"unembed_d": ("data",),
                                       "cache_seq": ("data", "model")}))
        got = run(ctx)
        # constrain: the identity on a plain tensor, a redistribution of
        # a DTensor to the logical axes' placements
        from torch.distributed.tensor import DTensor, Replicate, Shard
        t = torch.ones(4, 8)
        assert ctx.constrain(t, ("embed", "ffn")) is t
        dt = DTensor.from_local(t, ctx.mesh, [Replicate(), Replicate()])
        c = ctx.constrain(dt, ("embed", "ffn"))
        assert c.placements == (Shard(0), Shard(1))
        assert torch.equal(c.full_tensor(), t)
    finally:
        dist.destroy_process_group()
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert torch.equal(g, r)
