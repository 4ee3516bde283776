"""Mamba2 and the zamba2 hybrid (zamba2-1.2b) in the port on the CPU
against the JAX package: the config, the converted weights (the shared
block's, which have no layer axis, among them), `_causal_conv`,
`mamba2_block_forward` with and without a carried state, `forward` /
`prefill` / `decode_step` (fp32, a pure-Mamba2 config, and bf16), the
full-width structure from shapes alone, the static and continuous slot
engines, the paged pool's refusal, the serving CLI and the training gate;
then the sliding-window ring caches the shared block runs over, on a
windowed internlm2 config. Weights are JAX's, carried over by
`convert.py`; the kernel switch is forced both ways (on CPU tensors
`wkv_scan` and `flash_attention` run their plain versions)."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from repro.configs import get_config, reduced
from repro.data.synthetic import make_lm_stream
from repro.models import ssm as jssm
from repro.models import transformer as jtfm
from repro.serving import CascadeSpec as JCascadeSpec
from repro.serving import EngineConfig as JEngineConfig
from repro.serving import engine as jeng
from repro.serving import make_requests as j_make_requests
from repro.sharding import ParallelContext
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs import reduced as t_reduced
from repro_torch.convert import params_from_jax
from repro_torch.launch import serve as tserve
from repro_torch.launch import steps as tsteps
from repro_torch.models import attention as tattn
from repro_torch.models import ssm as tssm
from repro_torch.models import transformer as ttfm
from repro_torch.serving import (CascadeEngine, CascadeSpec,
                                 ContinuousCascadeEngine, EngineConfig,
                                 ModelRunner, PagedConfig, make_requests)
from repro_torch.serving.paged_pool import PagedCachePool, validate_pageable
from repro_torch.serving.request import DONE
from repro_torch.training import optim as toptim

torch.set_num_threads(1)
CTX = ParallelContext()
ARCH = "zamba2-1.2b"
LOGIT_ATOL = 1e-4     # fp32 end to end; sums ordered differently
BLOCK_ATOL = 2e-5     # one fp32 block
CONF_ATOL = 1e-5      # mean eq.-8 confidence, fp32 on both sides
BF16_ATOL = 0.1       # bf16 config: the residual stream is bf16 through
                      # every layer on both sides, and each side rounds it
                      # to bf16 (2^-8 relative) at other points (the port
                      # also stores the carried conv history in the cache's
                      # bf16, where JAX carries it fp32), through six
                      # blocks. Readings on the reduced model over three
                      # prompt seeds were 0.030-0.041 (logit std 1.0); the
                      # bound is about 2.5x the largest
LENS = [5, 9, 4, 12, 7, 6, 10, 4]
FULL_PARAMS = 1_170_473_856           # M_S at published width (JAX's count)
FULL_LARGE_PARAMS = 891_518_976       # build_ladder's large tier at full width


@pytest.fixture(scope="module")
def model():
    cfg = reduced(get_config(ARCH))
    tcfg = t_reduced(t_get_config(ARCH))
    jparams = jtfm.init_params(cfg, jax.random.PRNGKey(2))
    tparams = params_from_jax(jax.device_get(jparams), "cpu")
    return cfg, tcfg, jparams, tparams


def _np(x):
    return np.asarray(x, dtype=np.float32)


def _tok(a):
    return torch.from_numpy(np.asarray(a).astype(np.int64))


def _shapes(tree):
    return jax.tree.map(lambda t: tuple(t.shape), tree)


# ---------------------------------------------------------------------------
# Config, weights, block
# ---------------------------------------------------------------------------

def test_config_and_reduced_match_jax(model):
    cfg, tcfg, _, _ = model
    for f in ("family", "n_layers", "d_model", "n_heads", "n_kv_heads",
              "head_dim", "d_ff", "vocab_size", "ssm_state", "ssm_head_dim",
              "shared_attn_every", "norm_eps", "param_dtype",
              "compute_dtype"):
        assert getattr(tcfg, f) == getattr(cfg, f), f
    assert (tcfg.n_layers, tcfg.shared_attn_every) == (4, 2)
    assert tcfg.recurrent and not tcfg.attention_free
    mc, tmc = jtfm.mamba_config(cfg), ttfm.mamba_config(tcfg)
    for f in ("d_model", "d_state", "head_dim", "expand", "conv_width",
              "chunk", "d_inner", "n_heads"):
        assert getattr(tmc, f) == getattr(mc, f), f
    assert (tmc.n_heads, tmc.chunk) == (8, 64)
    full, jfull = t_get_config(ARCH), get_config(ARCH)
    for f in ("n_layers", "d_model", "n_heads", "n_kv_heads", "head_dim",
              "d_ff", "vocab_size", "ssm_state", "ssm_head_dim",
              "shared_attn_every", "source"):
        assert getattr(full, f) == getattr(jfull, f), f
    assert full.source == "arXiv:2411.15242"
    assert ttfm.shared_attn_calls(full) == 6


def test_convert_carries_every_leaf_with_the_layerless_shared_block(model):
    _, tcfg, jparams, tparams = model
    for path, leaf in jax.tree_util.tree_leaves_with_path(jparams):
        t = tparams
        for p in path:
            t = t[p.key]
        assert tuple(t.shape) == leaf.shape, path
        np.testing.assert_array_equal(t.numpy(), np.asarray(leaf))
    sa = tparams["blocks"]["shared_attn"]
    d, H, hd = tcfg.d_model, tcfg.n_heads, tcfg.head_dim
    assert sa["norm1"].shape == sa["norm2"].shape == (d,)
    assert sa["attn"]["wq"].shape == (d, H, hd)
    assert sa["mlp"]["w_up"].shape == (d, tcfg.d_ff)
    m = tparams["blocks"]["mamba"]
    assert m["in_proj"].shape == (4, d, 2 * 512 + 2 * 64 + 8)
    assert m["conv_w"].shape == (4, 4, 512 + 2 * 64)


def test_init_params_follow_jax_init_rules(model):
    _, tcfg, jparams, _ = model
    own = ttfm.init_params(tcfg, seed=3, device="cpu")
    assert _shapes(own) == jax.tree.map(lambda a: a.shape, jparams)
    m = own["blocks"]["mamba"]
    assert bool((m["A_log"] == 0).all()) and bool((m["dt_bias"] == -1).all())
    assert bool((m["D"] == 1).all())
    for name in ("norm", "conv_b", "out_norm"):
        assert float(m[name].abs().sum()) == 0.0
    for name, fan_in in (("in_proj", tcfg.d_model), ("conv_w", 4),
                         ("out_proj", 2 * tcfg.d_model)):
        std = float(m[name].std())
        assert abs(std - fan_in ** -0.5) < 0.1 * fan_in ** -0.5, name


@pytest.mark.parametrize("carried", [False, True], ids=["fresh", "carried"])
def test_causal_conv_matches_jax(carried):
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 6, 10)).astype(np.float32)
    w = rng.standard_normal((4, 10)).astype(np.float32)
    b = rng.standard_normal((10,)).astype(np.float32)
    carry = rng.standard_normal((2, 3, 10)).astype(np.float32)
    jy, jc = jssm._causal_conv(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                               jnp.asarray(carry) if carried else None)
    ty, tc = tssm._causal_conv(torch.from_numpy(x), torch.from_numpy(w),
                               torch.from_numpy(b),
                               torch.from_numpy(carry) if carried else None)
    np.testing.assert_allclose(ty.numpy(), _np(jy), atol=1e-6)
    np.testing.assert_array_equal(tc.numpy(), _np(jc))
    np.testing.assert_array_equal(tc.numpy(), x[:, -3:])


def _layer(tree, i):
    return {k: v[i] for k, v in tree.items()}


@pytest.fixture(scope="module")
def jax_block(model):
    """JAX's layer-1 Mamba2 block on seeded inputs, once per (T, carried)."""
    cfg, _, jparams, _ = model
    done = {}

    def run(T, carried):
        if (T, carried) not in done:
            rng = np.random.default_rng(T + 10 * carried)
            B, d = 2, 256
            x = rng.standard_normal((B, T, d)).astype(np.float32)
            state = None
            if carried:
                state = {"conv": rng.standard_normal((B, 3, 640)),
                         "S": 0.3 * rng.standard_normal((B, 8, 64, 64))}
                state = {k: v.astype(np.float32) for k, v in state.items()}
            jx, jst = jssm.mamba2_block_forward(
                jax.tree.map(lambda a: a[1], jparams["blocks"]["mamba"]),
                jtfm.mamba_config(cfg), jnp.asarray(x), CTX,
                None if state is None else jax.tree.map(jnp.asarray, state))
            done[T, carried] = x, state, jx, jst
        return done[T, carried]
    return run


@pytest.mark.parametrize("kernel", [False, True], ids=["plain", "kernel"])
@pytest.mark.parametrize("carried", [False, True], ids=["fresh", "carried"])
@pytest.mark.parametrize("T", [5, 64, 96])
def test_block_matches_jax(model, jax_block, kernel, carried, T):
    """One Mamba2 block, fp32: output and new state (the carried S written
    in place); T = 64 takes JAX's chunked path, T = 5 and 96 its scan."""
    _, tcfg, _, tparams = model
    x, state, jx, jst = jax_block(T, carried)
    tstate = (None if state is None
              else {k: torch.from_numpy(v.copy()) for k, v in state.items()})
    tx, tst = tssm.mamba2_block_forward(
        _layer(tparams["blocks"]["mamba"], 1), ttfm.mamba_config(tcfg),
        torch.from_numpy(x), tstate, paged_kernel=kernel)
    np.testing.assert_allclose(tx.numpy(), _np(jx), atol=BLOCK_ATOL)
    for k in ("conv", "S"):
        np.testing.assert_allclose(tst[k].numpy(), _np(jst[k]),
                                   atol=BLOCK_ATOL, err_msg=k)
    if carried:
        assert tst["S"].data_ptr() == tstate["S"].data_ptr()


def test_plain_block_follows_jax_path_rule(model, monkeypatch):
    """The plain recurrence takes JAX's path: chunked (chunk 64) when 64
    divides T, else the per-step scan."""
    _, tcfg, _, tparams = model
    seen = []
    wk = tssm.wkv_scan_plain
    monkeypatch.setattr(tssm, "wkv_scan_plain", lambda *a, **kw: (
        seen.append(kw["chunk"] if a[0].shape[1] % kw["chunk"] == 0
                    else 1), wk(*a, **kw))[1])
    p = _layer(tparams["blocks"]["mamba"], 0)
    for T in (5, 64, 96, 128):
        tssm.mamba2_block_forward(p, ttfm.mamba_config(tcfg),
                                  torch.zeros((1, T, 256)))
    assert seen == [1, 64, 1, 64]


@pytest.fixture(scope="module")
def jax_prefill_decode(model):
    """JAX's test_prefill_decode_matches_forward[zamba2-1.2b] run: the
    full forward of 12 tokens, the prefill of 11 and the decode of the
    12th."""
    cfg, _, jparams, _ = model
    T = 12
    toks = np.asarray(jax.random.randint(jax.random.PRNGKey(3), (2, T), 0,
                                         cfg.vocab_size))
    full = _np(jtfm.forward(jparams, cfg, jnp.asarray(toks), CTX))
    jc = jtfm.init_cache(cfg, 2, T + 4, dtype=jnp.float32)
    jl, jc = jtfm.prefill(jparams, cfg, jnp.asarray(toks[:, :T - 1]), jc, CTX)
    jd, jc = jtfm.decode_step(jparams, cfg, jnp.asarray(toks[:, T - 1]),
                              T - 1, jc, CTX)
    return toks, full, jl, jd, jc


@pytest.mark.parametrize("kernel", [False, True], ids=["plain", "kernel"])
def test_forward_prefill_decode_match_jax(model, jax_prefill_decode, kernel):
    """JAX's test_prefill_decode_matches_forward[zamba2-1.2b] on both
    sides: forward, prefill 11 tokens, decode the 12th, each within 1e-4
    of JAX's, and every cache leaf (Mamba2 conv and S, the shared block's
    K/V per call) against JAX's."""
    _, tcfg, _, tparams = model
    toks, full, jl, jd, jc = jax_prefill_decode
    T = toks.shape[1]
    out = ttfm.forward(tparams, tcfg, _tok(toks)).numpy()
    np.testing.assert_allclose(out, full, atol=LOGIT_ATOL)
    tc = ttfm.init_cache(tcfg, 2, T + 4, dtype=torch.float32, device="cpu")
    assert _shapes(tc) == jax.tree.map(lambda a: a.shape, jc)
    tl, tc = ttfm.prefill(tparams, tcfg, _tok(toks[:, :T - 1]), tc,
                          paged_kernel=kernel)
    np.testing.assert_allclose(tl.numpy(), _np(jl), atol=LOGIT_ATOL)
    np.testing.assert_allclose(tl.numpy(), full[:, :T - 1], atol=1e-3,
                               rtol=1e-3)
    td, tc = ttfm.decode_step(tparams, tcfg, _tok(toks[:, T - 1]), T - 1, tc,
                              paged_kernel=kernel)
    np.testing.assert_allclose(td.numpy(), _np(jd), atol=LOGIT_ATOL)
    np.testing.assert_allclose(td.numpy(), full[:, -1], atol=1e-3, rtol=1e-3)
    for kind, leaves in jc.items():
        for k, leaf in leaves.items():
            np.testing.assert_allclose(tc[kind][k].numpy(), _np(leaf),
                                       atol=LOGIT_ATOL, err_msg=f"{kind}/{k}")


@pytest.mark.parametrize("T", [64, 80])
def test_long_prefill_then_decode_matches_jax(model, T):
    """A prompt of T tokens (T = 64: JAX's chunked recurrence; 80: its
    scan) then two decode steps, the kernel switch on, against JAX."""
    cfg, tcfg, jparams, tparams = model
    toks = np.random.default_rng(T).integers(0, cfg.vocab_size, (2, T + 2))
    jc = jtfm.init_cache(cfg, 2, T + 2, dtype=jnp.float32)
    tc = ttfm.init_cache(tcfg, 2, T + 2, dtype=torch.float32, device="cpu")
    jl, jc = jtfm.prefill(jparams, cfg, jnp.asarray(toks[:, :T]), jc, CTX,
                          last_only=True)
    tl, tc = ttfm.prefill(tparams, tcfg, _tok(toks[:, :T]), tc,
                          last_only=True, paged_kernel=True)
    np.testing.assert_allclose(tl.numpy(), _np(jl), atol=LOGIT_ATOL)
    for i in range(2):
        jd, jc = jtfm.decode_step(jparams, cfg, jnp.asarray(toks[:, T + i]),
                                  T + i, jc, CTX)
        td, tc = ttfm.decode_step(tparams, tcfg, _tok(toks[:, T + i]), T + i,
                                  tc, paged_kernel=True)
        np.testing.assert_allclose(td.numpy(), _np(jd), atol=LOGIT_ATOL)


def test_pure_mamba2_config_matches_jax():
    """shared_attn_every = 0: Mamba2 layers only, no shared block in the
    weights or the cache; forward, prefill and decode against JAX."""
    cfg = reduced(get_config(ARCH)).replace(shared_attn_every=0)
    tcfg = t_reduced(t_get_config(ARCH)).replace(shared_attn_every=0)
    jparams = jtfm.init_params(cfg, jax.random.PRNGKey(4))
    tparams = params_from_jax(jax.device_get(jparams), "cpu")
    assert set(tparams["blocks"]) == {"mamba"}
    toks = np.random.default_rng(4).integers(0, 512, (2, 10)).astype(np.int32)
    ref = _np(jtfm.forward(jparams, cfg, jnp.asarray(toks), CTX))
    np.testing.assert_allclose(ttfm.forward(tparams, tcfg, _tok(toks)).numpy(),
                               ref, atol=LOGIT_ATOL)
    jc = jtfm.init_cache(cfg, 2, 12, dtype=jnp.float32)
    tc = ttfm.init_cache(tcfg, 2, 12, dtype=torch.float32, device="cpu")
    assert set(tc) == {"mamba"} and set(jc) == {"mamba"}
    jl, jc = jtfm.prefill(jparams, cfg, jnp.asarray(toks[:, :9]), jc, CTX)
    jd, _ = jtfm.decode_step(jparams, cfg, jnp.asarray(toks[:, 9]), 9, jc, CTX)
    tl, tc = ttfm.prefill(tparams, tcfg, _tok(toks[:, :9]), tc)
    td, _ = ttfm.decode_step(tparams, tcfg, _tok(toks[:, 9]), 9, tc)
    np.testing.assert_allclose(tl.numpy(), _np(jl), atol=LOGIT_ATOL)
    np.testing.assert_allclose(td.numpy(), _np(jd), atol=LOGIT_ATOL)


def _large(cfg):
    return cfg.replace(name=cfg.name + "-large", n_layers=4,
                       d_model=cfg.d_model * 2, n_heads=8,
                       d_ff=cfg.d_ff * 2)


def test_full_width_structure_from_shapes():
    """At published width, from shapes alone (the "meta" device, JAX's
    abstract init): both tiers' parameter trees equal JAX's and count
    JAX's parameters; M_S's cache leaves are conv [38, B, 3, 4224], fp32
    S [38, B, 64, 64, 64] and the shared block's K/V [6, B, S, 32, 64].
    `build_ladder`'s large tier (4 Mamba2 layers, period 6) never calls
    the shared block: the port keeps no cache leaf for it, where JAX keeps
    one without the calls axis, its batch at axis 0, which the slot
    pool's row scatter along axis 1 would misplace. Every port leaf has
    its batch at axis 1."""
    key = jax.random.PRNGKey(0)
    B, S = 8, 288
    for tcfg, n_params in ((t_get_config(ARCH), FULL_PARAMS),
                           (_large(t_get_config(ARCH)), FULL_LARGE_PARAMS)):
        jcfg = get_config(ARCH).replace(
            n_layers=tcfg.n_layers, d_model=tcfg.d_model,
            n_heads=tcfg.n_heads, d_ff=tcfg.d_ff)
        tp = ttfm.init_params(tcfg, 0, "meta")
        jp = jtfm.init_params(jcfg, key, abstract=True)
        assert _shapes(tp) == jax.tree.map(lambda a: tuple(a.shape), jp,
                                           is_leaf=lambda a: hasattr(
                                               a, "logical_axes"))
        assert sum(t.numel() for t in jax.tree.leaves(tp)) == n_params
        tc = ttfm.init_cache(tcfg, B, S, device="meta")
        assert all(t.shape[1] == B for t in jax.tree.leaves(tc))
        assert tc["mamba"]["S"].dtype == torch.float32
        jc = jtfm.init_cache(jcfg, B, S, abstract=True)
        calls = ttfm.shared_attn_calls(tcfg)
        if calls:
            assert _shapes(tc) == {
                "mamba": {"conv": (38, B, 3, 4224), "S": (38, B, 64, 64, 64)},
                "shared_attn": {"k": (6, B, S, 32, 64),
                                "v": (6, B, S, 32, 64)}}
            assert jc["shared_attn"]["k"].shape == (6, B, S, 32, 64)
        else:
            assert "shared_attn" not in tc and "shared_attn" in tp["blocks"]
            assert tc["mamba"]["S"].shape == (4, B, 128, 64, 64)
            assert jc["shared_attn"]["k"].shape == (B, S, 32, 64)


def test_bf16_config_matches_jax(model):
    """The published types (fp32 weights, bf16 activations and cache):
    the caches start in JAX's leaf dtypes, the carried conv history stays
    bf16 in the port's cache (JAX returns it fp32), and forward / prefill
    / decode logits agree within BF16_ATOL, with equal argmax wherever
    JAX's top two logits lie more than 2 BF16_ATOL apart (closer ones may
    flip within the bound: readings had flips at gaps of 0.004-0.005)."""
    cfg0, tcfg0, jparams, tparams = model
    cfg = cfg0.replace(compute_dtype="bfloat16")
    tcfg = tcfg0.replace(compute_dtype="bfloat16")
    jc = jtfm.init_cache(cfg, 2, 16)
    tc = ttfm.init_cache(tcfg, 2, 16, device="cpu")
    assert jax.tree.map(lambda t: str(t.dtype).split(".")[-1], tc) == \
        jax.tree.map(lambda a: str(a.dtype), jc)
    toks = np.random.default_rng(0).integers(0, 512, (2, 12)).astype(np.int32)
    jl, jc = jtfm.prefill(jparams, cfg, jnp.asarray(toks[:, :11]), jc, CTX)
    assert jc["mamba"]["conv"].dtype == jnp.float32
    jd, _ = jtfm.decode_step(jparams, cfg, jnp.asarray(toks[:, 11]), 11, jc,
                             CTX)
    jf = jtfm.forward(jparams, cfg, jnp.asarray(toks[:, :11]), CTX)
    tl, tc = ttfm.prefill(tparams, tcfg, _tok(toks[:, :11]), tc)
    td, tc = ttfm.decode_step(tparams, tcfg, _tok(toks[:, 11]), 11, tc)
    assert tc["mamba"]["conv"].dtype == torch.bfloat16
    assert tc["mamba"]["S"].dtype == torch.float32
    out = ttfm.forward(tparams, tcfg, _tok(toks[:, :11])).numpy()
    for got, want in ((out, _np(jf)), (tl.numpy(), _np(jl)),
                      (td.numpy(), _np(jd))):
        np.testing.assert_allclose(got, want, atol=BF16_ATOL)
        top2 = np.sort(want, axis=-1)[..., -2:]
        clear = top2[..., 1] - top2[..., 0] > 2 * BF16_ATOL
        np.testing.assert_array_equal(got.argmax(-1)[clear],
                                      want.argmax(-1)[clear])


def test_prefill_refuses_pages(model):
    _, tcfg, _, tparams = model
    cache = ttfm.init_cache(tcfg, 2, 8, device="cpu")
    with pytest.raises(NotImplementedError, match="slot backend"):
        ttfm.prefill(tparams, tcfg, torch.zeros((2, 4), dtype=torch.long),
                     cache, pages=torch.ones((2, 2), dtype=torch.int32))


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def runners():
    """JAX's `build_ladder("zamba2-1.2b", 0, 2)` (reduced M_S, 4-layer
    double-width M_L, both calling the shared block twice) and the port's
    runners on the same weights."""
    from repro.launch.serve import build_ladder
    js, jl = build_ladder(ARCH, 0, 2)
    ts_cfg = t_reduced(t_get_config(ARCH))
    tl_cfg = _large(ts_cfg)
    assert (tl_cfg.d_model, tl_cfg.d_ff, tl_cfg.n_heads) == (
        jl.cfg.d_model, jl.cfg.d_ff, jl.cfg.n_heads)
    torch_pair = (
        ModelRunner(ts_cfg, params_from_jax(jax.device_get(js.params), "cpu")),
        ModelRunner(tl_cfg, params_from_jax(jax.device_get(jl.params), "cpu")))
    key = jax.random.PRNGKey(0)
    prompts = make_lm_stream(jax.random.fold_in(key, 2), 16, 8,
                             ts_cfg.vocab_size)
    base = make_lm_stream(jax.random.PRNGKey(7), len(LENS), max(LENS),
                          ts_cfg.vocab_size)
    ragged = [base[i, :n].astype(np.int32) for i, n in enumerate(LENS)]
    return (js, jl), torch_pair, prompts, ragged


@pytest.fixture(scope="module")
def static_jax(runners):
    (js, jl), _, prompts, _ = runners
    eng = jeng.CascadeEngine(js, jl)
    tau = eng.calibrate(prompts, 8, 4, deferral_ratio=0.5)
    return tau, eng.serve(prompts, 8, 4)


def test_generate_matches_jax(runners):
    (js, jl), (ts, tl), prompts, _ = runners
    for jr, tr in ((js, ts), (jl, tl)):
        jt, jc = jr.generate(prompts, 8, 4)
        for kernel in (False, True):
            tt, tc = tr.generate(prompts, 8, 4, paged_kernel=kernel)
            np.testing.assert_array_equal(tt, jt)
            np.testing.assert_allclose(tc, jc, atol=CONF_ATOL)


def test_static_cascade_matches_jax(runners, static_jax):
    _, (ts, tl), prompts, _ = runners
    jtau, jres = static_jax
    eng = CascadeEngine(ts, tl)
    tau = eng.calibrate(prompts, 8, 4, deferral_ratio=0.5)
    res = eng.serve(prompts, 8, 4)
    assert tau == pytest.approx(jtau, abs=CONF_ATOL)
    assert 0 < res.deferred.sum() < len(prompts)
    np.testing.assert_array_equal(res.deferred, jres.deferred)
    np.testing.assert_array_equal(res.tokens, jres.tokens)
    np.testing.assert_allclose(res.confidence, jres.confidence,
                               atol=CONF_ATOL)


@pytest.fixture(scope="module")
def continuous_jax(runners, static_jax):
    jax_pair, _, _, ragged = runners
    return jeng.ContinuousCascadeEngine(
        JCascadeSpec.two_tier(*jax_pair, tau=static_jax[0]),
        JEngineConfig(n_slots=3)).run(j_make_requests(ragged, 5), 5)


@pytest.mark.parametrize("kernel", [False, True], ids=["plain", "kernel"])
def test_continuous_slot_engine_matches_jax(runners, static_jax,
                                            continuous_jax, kernel):
    """Ragged prompts on the slot backend with in-flight early exit: per-rid
    tokens, deferral and early-exit flags equal the JAX engine's,
    confidences within 1e-5; one seeding dispatch per admitted
    prompt-length group, so no prompt is padded into a state."""
    _, torch_pair, _, ragged = runners
    tau, jres = static_jax[0], continuous_jax
    res = ContinuousCascadeEngine(
        CascadeSpec.two_tier(*torch_pair, tau=tau),
        EngineConfig(n_slots=3, paged=PagedConfig(paged_kernel=kernel))).run(
        make_requests(ragged, 5), 5)
    assert all(r.state == DONE for r in res.requests)
    assert any(r.deferred for r in jres.requests)
    for jr, tr in zip(jres.requests, res.requests):
        assert tr.rid == jr.rid
        np.testing.assert_array_equal(tr.tokens, jr.tokens)
        assert (tr.deferred, tr.early_exited) == (jr.deferred, jr.early_exited)
        np.testing.assert_allclose(tr.confidence, jr.confidence,
                                   atol=CONF_ATOL)
    assert res.stats["saved_steps"] == jres.stats["saved_steps"]
    assert res.steps == jres.steps
    assert len(LENS) <= res.stats["prefill_seed_dispatches"] + 2


def test_continuous_without_early_exit_equals_static(runners, static_jax):
    """The port's own greedy invariant on the hybrid: early_exit=False
    continuous on the slot backend serves the static engine's tokens and
    masks."""
    _, torch_pair, prompts, _ = runners
    tau, jres = static_jax
    res = ContinuousCascadeEngine(
        CascadeSpec.two_tier(*torch_pair, tau=tau),
        EngineConfig(n_slots=5, early_exit=False)).run(
        make_requests(prompts, 4), 4)
    np.testing.assert_array_equal(res.deferred, jres.deferred)
    np.testing.assert_array_equal(res.tokens, jres.tokens)


def test_paged_pool_refuses_the_hybrid_and_every_window(model):
    """The Mamba2 state refuses the paged pool as a recurrent state, as
    JAX's pool does; a window refuses it whether or not it is shorter
    than the pool's rows."""
    _, tcfg, _, _ = model
    with pytest.raises(NotImplementedError, match="recurrent state"):
        PagedCachePool(tcfg, 2, 8, 4, 16, "cpu")
    with pytest.raises(NotImplementedError, match="recurrent state"):
        validate_pageable(tcfg.replace(shared_attn_every=0), 16)
    windowed = t_reduced(t_get_config("internlm2-1.8b")).replace(
        sliding_window=32)
    with pytest.raises(NotImplementedError, match="sliding window"):
        validate_pageable(windowed, 16)
    with pytest.raises(NotImplementedError, match="sliding window"):
        validate_pageable(windowed, 64)


def test_paged_engine_refuses_the_hybrid(runners):
    _, torch_pair, _, ragged = runners
    eng = ContinuousCascadeEngine(CascadeSpec.two_tier(*torch_pair, tau=-1.0),
                                  EngineConfig(n_slots=2, backend="paged"))
    with pytest.raises(NotImplementedError, match="slot backend"):
        eng.run(make_requests(ragged[:2], 3), 3)


@pytest.mark.parametrize("engine", ["continuous", "static"])
def test_cli_serves_zamba2(engine, capsys):
    res = tserve.main(["--device", "cpu", "--arch", ARCH, "--engine", engine,
                       "--requests", "6", "--max-new", "3", "--slots", "3"])
    assert res.tokens.shape == (6, 3)
    if engine == "continuous":
        assert all(r.state == DONE for r in res.requests)
    assert "calibrated tau" in capsys.readouterr().out


def test_cli_rejects_paged_backend_for_zamba2(capsys):
    with pytest.raises(SystemExit) as exc:
        tserve.main(["--device", "cpu", "--arch", ARCH, "--backend", "paged"])
    assert exc.value.code == 2
    err = capsys.readouterr().err
    assert "--backend paged --arch zamba2-1.2b" in err
    assert "slot backend" in err


def test_training_gate_stays_closed_for_the_hybrid_and_windows():
    """The hybrid and a window on GQA now pass the training gate; a window
    on MLA stays refused for serving and training (JAX's `mla_forward`
    has none)."""
    ttfm.check_ported(t_get_config(ARCH), training=True)
    windowed = t_get_config("internlm2-1.8b").replace(sliding_window=64)
    ttfm.check_ported(windowed, training=True)
    mla_windowed = t_get_config("deepseek-v2-236b").replace(sliding_window=64)
    for training in (False, True):
        with pytest.raises(NotImplementedError, match="ROADMAP.md"):
            ttfm.check_ported(mla_windowed, training=training)
    ttfm.check_ported(t_get_config(ARCH))
    ttfm.check_ported(windowed)


@pytest.mark.parametrize("arch,window", [("internlm2-1.8b", 64),
                                         ("internlm2-1.8b", 2),
                                         (ARCH, None)])
def test_trainer_refuses_windows_and_the_hybrid(arch, window):
    """The trainer's own entry, which refused these before they were
    ported, now trains them: a train step on a windowed dense config (a
    window wider than the 4 tokens, and one of 2) or on the hybrid gives
    a finite loss and moves the parameters in place (against JAX:
    tests/test_torch_train_recurrent.py)."""
    tcfg = t_reduced(t_get_config(arch)).replace(sliding_window=window)
    params = ttfm.init_params(tcfg, 0, "cpu")
    before = [t.clone() for t in toptim.tree_leaves(params)]
    batch = {"tokens": torch.zeros((1, 4), dtype=torch.long),
             "targets": torch.zeros((1, 4), dtype=torch.long)}
    step = tsteps.make_train_step(tcfg)
    out, _, metrics = step(params, toptim.adamw_init(params), batch)
    assert out is params and torch.isfinite(metrics["loss"])
    assert any(not torch.equal(a, b)
               for a, b in zip(toptim.tree_leaves(params), before))


# ---------------------------------------------------------------------------
# Sliding-window ring caches (a windowed internlm2 config)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def dense():
    cfg = reduced(get_config("internlm2-1.8b"))
    tcfg = t_reduced(t_get_config("internlm2-1.8b"))
    jparams = jtfm.init_params(cfg, jax.random.PRNGKey(5))
    return cfg, tcfg, jparams, params_from_jax(jax.device_get(jparams), "cpu")


def test_sliding_window_variant_lowers_memory(dense):
    """Mirror of tests/test_models_smoke.py's case: the cache is bounded
    by the window, not by max_len."""
    _, tcfg, _, _ = dense
    cache = ttfm.init_cache(tcfg.replace(sliding_window=8), 2, 1024,
                            dtype=torch.float32, device="cpu")
    assert cache["dense"]["k"].shape[2] == 8


def test_sliding_window_decode_ring_buffer(dense):
    """Mirror of tests/test_models_smoke.py's case: ring-buffer decode
    equals full-cache decode when the window covers the history."""
    cfg, tcfg, jparams, tparams = dense
    T = 12
    toks = np.asarray(jax.random.randint(jax.random.PRNGKey(5), (1, T), 0,
                                         cfg.vocab_size))
    full = ttfm.forward(tparams, tcfg, _tok(toks)).numpy()
    tw = tcfg.replace(sliding_window=32)
    cache = ttfm.init_cache(tw, 1, 64, dtype=torch.float32, device="cpu")
    assert cache["dense"]["k"].shape[2] == 32
    _, cache = ttfm.prefill(tparams, tw, _tok(toks[:, :T - 1]), cache)
    step, _ = ttfm.decode_step(tparams, tw, _tok(toks[:, T - 1]), T - 1,
                               cache)
    np.testing.assert_allclose(step.numpy(), full[:, -1], atol=1e-3,
                               rtol=1e-3)


def _cat_rows(a, b, cat):
    return {kind: {k: cat([a[kind][k], b[kind][k]], 1) for k in a[kind]}
            for kind in a}


@pytest.mark.parametrize("kernel", [False, True], ids=["plain", "kernel"])
def test_ring_prefill_longer_than_window_then_decode_matches_jax(dense,
                                                                 kernel):
    """Window 8, a 12-token prompt: the prompt attends in-sequence under
    the sliding mask and the cache keeps its last 8 tokens at their ring
    slots; then decode past the ring's wrap, at a scalar position (both
    rows at one depth) and at per-row positions (row 0 after the 12-token
    prompt, row 1 after a 5-token one), every logit within 1e-4 of JAX's
    prefill + decode_step and the ring leaves equal to JAX's."""
    cfg, tcfg, jparams, tparams = dense
    cfg, tcfg = cfg.replace(sliding_window=8), tcfg.replace(sliding_window=8)
    toks = np.random.default_rng(8).integers(0, 512, (2, 20)).astype(np.int32)
    jc = jtfm.init_cache(cfg, 2, 24, dtype=jnp.float32)
    tc = ttfm.init_cache(tcfg, 2, 24, dtype=torch.float32, device="cpu")
    assert tc["dense"]["k"].shape[2] == 8
    jl, jc = jtfm.prefill(jparams, cfg, jnp.asarray(toks[:, :12]), jc, CTX)
    tl, tc = ttfm.prefill(tparams, tcfg, _tok(toks[:, :12]), tc,
                          paged_kernel=kernel)
    np.testing.assert_allclose(tl.numpy(), _np(jl), atol=LOGIT_ATOL)
    np.testing.assert_allclose(tc["dense"]["k"].numpy(),
                               _np(jc["dense"]["k"]), atol=LOGIT_ATOL)
    for t in range(12, 20):                    # scalar positions, wrapping
        jd, jc = jtfm.decode_step(jparams, cfg, jnp.asarray(toks[:, t]), t,
                                  jc, CTX)
        td, tc = ttfm.decode_step(tparams, tcfg, _tok(toks[:, t]), t, tc)
        np.testing.assert_allclose(td.numpy(), _np(jd), atol=LOGIT_ATOL)
    # per-row positions: rows prefilled to different depths
    short = toks[1:, :5]
    jcs, tcs = {}, {}
    for name, prompt in (("long", toks[:1, :12]), ("short", short)):
        jcs[name] = jtfm.init_cache(cfg, 1, 24, dtype=jnp.float32)
        _, jcs[name] = jtfm.prefill(jparams, cfg, jnp.asarray(prompt),
                                    jcs[name], CTX)
        tcs[name] = ttfm.init_cache(tcfg, 1, 24, dtype=torch.float32,
                                    device="cpu")
        _, tcs[name] = ttfm.prefill(tparams, tcfg, _tok(prompt), tcs[name],
                                    paged_kernel=kernel)
    jc = _cat_rows(jcs["long"], jcs["short"], jnp.concatenate)
    tc = _cat_rows(tcs["long"], tcs["short"], torch.cat)
    pos = np.array([12, 5], np.int32)
    for i in range(6):
        tok = np.array([toks[0, 12 + i], toks[1, 5 + i]], np.int32)
        jd, jc = jtfm.decode_step(jparams, cfg, jnp.asarray(tok),
                                  jnp.asarray(pos + i), jc, CTX)
        td, tc = ttfm.decode_step(tparams, tcfg, _tok(tok),
                                  torch.from_numpy(pos + i), tc)
        np.testing.assert_allclose(td.numpy(), _np(jd), atol=LOGIT_ATOL)


def test_window_on_a_linear_cache_matches_jax(dense):
    """A cache longer than the window (made for the unwindowed config):
    the prefill attends under the sliding mask over the linear cache, and
    decode cuts keys the window leaves behind, at scalar and per-row
    positions, against JAX."""
    cfg, tcfg, jparams, tparams = dense
    cw, tw = cfg.replace(sliding_window=6), tcfg.replace(sliding_window=6)
    toks = np.random.default_rng(9).integers(0, 512, (2, 14)).astype(np.int32)
    jc = jtfm.init_cache(cfg, 2, 16, dtype=jnp.float32)
    tc = ttfm.init_cache(tcfg, 2, 16, dtype=torch.float32, device="cpu")
    jl, jc = jtfm.prefill(jparams, cw, jnp.asarray(toks[:, :10]), jc, CTX)
    tl, tc = ttfm.prefill(tparams, tw, _tok(toks[:, :10]), tc)
    np.testing.assert_allclose(tl.numpy(), _np(jl), atol=LOGIT_ATOL)
    for t, per_row in ((10, False), (11, True), (12, False), (13, True)):
        p = np.array([t, t], np.int32) if per_row else t
        jd, jc = jtfm.decode_step(jparams, cw, jnp.asarray(toks[:, t]),
                                  jnp.asarray(p), jc, CTX)
        td, tc = ttfm.decode_step(tparams, tw, _tok(toks[:, t]),
                                  torch.from_numpy(p) if per_row else p, tc)
        np.testing.assert_allclose(td.numpy(), _np(jd), atol=LOGIT_ATOL)


@pytest.mark.parametrize("ring", [False, True], ids=["linear", "ring"])
def test_windowed_prefill_flash_path_matches_attend(dense, ring):
    """`gqa_forward` with a window 5: the flash path (its plain version on
    CPU) against `_attend` under `make_sliding_mask`, on a linear cache
    and on a ring shorter than the prompt, and without a cache."""
    _, tcfg, _, tparams = dense
    ac = ttfm.attn_config(tcfg.replace(sliding_window=5))
    p = {k: v[0] for k, v in tparams["blocks"]["dense"]["attn"].items()}
    x = torch.from_numpy(np.random.default_rng(10).standard_normal(
        (2, 11, tcfg.d_model)).astype(np.float32))
    pos = torch.arange(11)[None, :]
    S = 5 if ring else 16
    out = {}
    for kernel in (False, True):
        cache = {n: torch.zeros((2, S, 2, 32)) for n in ("k", "v")}
        y, new = tattn.gqa_forward(p, ac, x, pos, cache, paged_kernel=kernel)
        y0, _ = tattn.gqa_forward(p, ac, x, pos, None, paged_kernel=kernel)
        np.testing.assert_allclose(y0.numpy(), y.numpy(), atol=1e-6)
        out[kernel] = y, new
    np.testing.assert_allclose(out[True][0].numpy(), out[False][0].numpy(),
                               atol=1e-5)
    for n in ("k", "v"):
        assert torch.equal(out[True][1][n], out[False][1][n])
