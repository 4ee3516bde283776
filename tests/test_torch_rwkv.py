"""RWKV6 (rwkv6-3b) in the port on the CPU against the JAX package: the
config, the converted weights, `rwkv_block_forward` with and without a
carried state, `forward` / `prefill` / `decode_step` (fp32, and bf16
against JAX's unscanned layer loop), the `launch.steps` serve builders,
the static and continuous engines on the slot backend, the paged pool's
refusal of recurrent and windowed caches, and the serving CLI. Weights are
JAX's, carried over by `convert.py`; the kernel switch is forced both
ways (on CPU tensors `wkv_scan` runs its plain version)."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from repro.configs import get_config, reduced
from repro.data.synthetic import make_lm_stream
from repro.launch import steps as jsteps
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
from repro_torch.models import ssm as tssm
from repro_torch.models import transformer as ttfm
from repro_torch.serving import (CascadeEngine, CascadeSpec,
                                 ContinuousCascadeEngine, EngineConfig,
                                 ModelRunner, PagedConfig, make_requests)
from repro_torch.serving.paged_pool import PagedCachePool, validate_pageable
from repro_torch.serving.request import DONE

torch.set_num_threads(1)
CTX = ParallelContext()
ARCH = "rwkv6-3b"
LOGIT_ATOL = 1e-4     # fp32 end to end; sums ordered differently
BLOCK_ATOL = 2e-5     # one fp32 block
CONF_ATOL = 1e-5      # mean eq.-8 confidence, fp32 on both sides
BF16_ATOL = 2e-2      # bf16 config: the port stores the carried shift rows
                      # in the cache's bf16 (JAX's unscanned loop returns
                      # them in fp32) and layer 0 adds its residual in bf16:
                      # one bf16 rounding (2^-8 relative) of a unit-scale
                      # input; readings on the reduced model were 2.3e-3
                      # (forward) and 4.4e-3 (decode)
LENS = [5, 9, 4, 12, 7, 6, 10, 4]


@pytest.fixture(scope="module")
def model():
    cfg = reduced(get_config(ARCH))
    tcfg = t_reduced(t_get_config(ARCH))
    jparams = jtfm.init_params(cfg, jax.random.PRNGKey(0))
    tparams = params_from_jax(jax.device_get(jparams), "cpu")
    return cfg, tcfg, jparams, tparams


def _np(x):
    return np.asarray(x, dtype=np.float32)


def _tok(a):
    return torch.from_numpy(np.asarray(a).astype(np.int64))


# ---------------------------------------------------------------------------
# Config, weights, block
# ---------------------------------------------------------------------------

def test_config_and_reduced_match_jax(model):
    cfg, tcfg, _, _ = model
    for f in ("family", "n_layers", "d_model", "n_heads", "head_dim", "d_ff",
              "vocab_size", "norm_eps", "param_dtype", "compute_dtype"):
        assert getattr(tcfg, f) == getattr(cfg, f), f
    assert tcfg.attention_free and not t_reduced(
        t_get_config("internlm2-1.8b")).attention_free
    rc, trc = jtfm.rwkv_config(cfg), ttfm.rwkv_config(tcfg)
    assert (trc.n_heads, trc.head_dim, trc.chunk) == (rc.n_heads, rc.head_dim,
                                                      rc.chunk) == (4, 32, 32)
    full, jfull = t_get_config(ARCH), get_config(ARCH)
    assert (full.n_layers, full.d_model, full.d_ff, full.vocab_size,
            full.head_dim, ttfm.rwkv_config(full).n_heads, full.source) == (
        32, 2560, 8960, 65536, 64, 40, "arXiv:2404.05892")
    assert full.replace(source="") == t_get_config(ARCH).replace(source="")
    assert jfull.n_layers == full.n_layers and jfull.d_ff == full.d_ff


def test_convert_carries_every_rwkv_leaf(model):
    _, tcfg, jparams, tparams = model
    leaves = jax.tree_util.tree_leaves_with_path(jparams)
    for path, leaf in leaves:
        t = tparams
        for p in path:
            t = t[p.key]
        assert tuple(t.shape) == leaf.shape, path
        np.testing.assert_array_equal(t.numpy(), np.asarray(leaf))
    b = tparams["blocks"]["rwkv"]
    L, d, r = tcfg.n_layers, tcfg.d_model, 32
    H, hd = 4, 32
    assert b["mu_base"].shape == (L, 5, d)
    assert b["mix_B"].shape == (L, 5, r, d)
    assert b["u"].shape == b["w0"].shape == b["ln_x"].shape == (L, H, hd)


def test_init_params_follow_jax_init_rules(model):
    _, tcfg, jparams, _ = model
    own = ttfm.init_params(tcfg, seed=3, device="cpu")
    assert jax.tree.map(lambda t: tuple(t.shape), own) == jax.tree.map(
        lambda a: a.shape, jparams)
    b = own["blocks"]["rwkv"]
    assert bool((b["w0"] == -0.6).all())
    for name in ("mu_base", "u", "cm_mu"):
        assert float(b[name].abs().max()) <= 0.5 and float(b[name].std()) > 0.2
    for name in ("norm1", "norm2", "ln_x"):
        assert float(b[name].abs().sum()) == 0.0
    std = float(b["wr"].std())
    assert abs(std - 1 / np.sqrt(tcfg.d_model)) < 0.1 / np.sqrt(tcfg.d_model)


def _layer(tree, i):
    return {k: v[i] for k, v in tree.items()}


@pytest.fixture(scope="module")
def jax_block(model):
    """JAX's layer-1 block on seeded inputs, once per (T, carried)."""
    cfg, tcfg, jparams, _ = model
    done = {}

    def run(T, carried):
        if (T, carried) not in done:
            rng = np.random.default_rng(T + 10 * carried)
            B, d, H, hd = 2, tcfg.d_model, 4, 32
            x = rng.standard_normal((B, T, d)).astype(np.float32)
            state = None
            if carried:
                state = {"shift1": rng.standard_normal((B, d)),
                         "shift2": rng.standard_normal((B, d)),
                         "S": 0.3 * rng.standard_normal((B, H, hd, hd))}
                state = {k: v.astype(np.float32) for k, v in state.items()}
            jx, jst = jssm.rwkv_block_forward(
                jax.tree.map(lambda a: a[1], jparams["blocks"]["rwkv"]),
                jtfm.rwkv_config(cfg), jnp.asarray(x), CTX,
                None if state is None else jax.tree.map(jnp.asarray, state))
            done[T, carried] = x, state, jx, jst
        return done[T, carried]
    return run


@pytest.mark.parametrize("kernel", [False, True], ids=["plain", "kernel"])
@pytest.mark.parametrize("carried", [False, True], ids=["fresh", "carried"])
@pytest.mark.parametrize("T", [5, 32])
def test_block_matches_jax(model, jax_block, kernel, carried, T):
    """One RWKV6 block, fp32: output and new state (the carried S written
    in place), T = 32 taking JAX's chunked path and T = 5 its scan."""
    _, tcfg, _, tparams = model
    x, state, jx, jst = jax_block(T, carried)
    tstate = (None if state is None
              else {k: torch.from_numpy(v.copy()) for k, v in state.items()})
    tx, tst = tssm.rwkv_block_forward(
        _layer(tparams["blocks"]["rwkv"], 1), ttfm.rwkv_config(tcfg),
        torch.from_numpy(x), tstate, paged_kernel=kernel)
    np.testing.assert_allclose(tx.numpy(), _np(jx), atol=BLOCK_ATOL)
    for k in ("shift1", "shift2", "S"):
        np.testing.assert_allclose(tst[k].numpy(), _np(jst[k]),
                                   atol=BLOCK_ATOL, err_msg=k)
    if carried:
        assert tst["S"].data_ptr() == tstate["S"].data_ptr()


def test_forward_logits_match_jax(model):
    cfg, tcfg, jparams, tparams = model
    toks = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 40)).astype(np.int32)
    ref = _np(jtfm.forward(jparams, cfg, jnp.asarray(toks), CTX))
    out = ttfm.forward(tparams, tcfg, _tok(toks)).numpy()
    np.testing.assert_allclose(out, ref, atol=LOGIT_ATOL)


@pytest.fixture(scope="module")
def jax_prefill_decode(model):
    """JAX's test_prefill_decode_matches_forward[rwkv6-3b] run: the full
    forward of 12 tokens, the prefill of 11 and the decode of the 12th."""
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
def test_prefill_decode_match_jax(model, jax_prefill_decode, kernel):
    """JAX's test_prefill_decode_matches_forward[rwkv6-3b] on both sides:
    prefill 11 tokens then decode the 12th, against JAX's prefill, decode
    and full forward, and the cache leaves against JAX's."""
    _, tcfg, _, tparams = model
    toks, full, jl, jd, jc = jax_prefill_decode
    T = toks.shape[1]
    tc = ttfm.init_cache(tcfg, 2, T + 4, dtype=torch.float32, device="cpu")
    tl, tc = ttfm.prefill(tparams, tcfg, _tok(toks[:, :T - 1]), tc,
                          paged_kernel=kernel)
    np.testing.assert_allclose(tl.numpy(), _np(jl), atol=LOGIT_ATOL)
    np.testing.assert_allclose(tl.numpy(), full[:, :T - 1], atol=1e-3,
                               rtol=1e-3)
    td, tc = ttfm.decode_step(tparams, tcfg, _tok(toks[:, T - 1]), T - 1, tc,
                              paged_kernel=kernel)
    np.testing.assert_allclose(td.numpy(), _np(jd), atol=LOGIT_ATOL)
    np.testing.assert_allclose(td.numpy(), full[:, -1], atol=1e-3, rtol=1e-3)
    for k in ("shift1", "shift2", "S"):
        np.testing.assert_allclose(tc["rwkv"][k].numpy(), _np(jc["rwkv"][k]),
                                   atol=LOGIT_ATOL, err_msg=k)


def test_bf16_config_matches_jax_unscanned_loop(model):
    """The published types (fp32 weights, bf16 activations) against JAX's
    unscanned layer loop, the only one JAX defines for them: the block's
    output and state dtypes equal JAX's, the caches start in JAX's leaf
    dtypes, and forward / prefill / decode logits agree within BF16_ATOL
    with equal argmax (JAX's prefill logits of every position stand for
    its forward)."""
    _, _, jparams, tparams = model
    cfg = reduced(get_config(ARCH)).replace(compute_dtype="bfloat16",
                                            scan_layers=False)
    tcfg = t_reduced(t_get_config(ARCH)).replace(compute_dtype="bfloat16")
    x = np.random.default_rng(4).standard_normal((2, 5, 128))
    jx_in = jnp.asarray(x, jnp.bfloat16)
    jx, jst = jssm.rwkv_block_forward(
        jax.tree.map(lambda a: a[0], jparams["blocks"]["rwkv"]),
        jtfm.rwkv_config(cfg), jx_in, CTX, None)
    tx, tst = tssm.rwkv_block_forward(
        _layer(tparams["blocks"]["rwkv"], 0), ttfm.rwkv_config(tcfg),
        torch.from_numpy(_np(jx_in)).bfloat16())
    assert str(tx.dtype).split(".")[-1] == str(jx.dtype) == "float32"
    assert {k: str(v.dtype).split(".")[-1] for k, v in tst.items()} == {
        k: str(v.dtype) for k, v in jst.items()}
    jc0 = jtfm.init_cache(cfg, 2, 16)
    tc = ttfm.init_cache(tcfg, 2, 16, device="cpu")
    assert {k: str(v.dtype).split(".")[-1] for k, v in tc["rwkv"].items()} == {
        k: str(v.dtype) for k, v in jc0["rwkv"].items()}
    toks = np.random.default_rng(0).integers(0, 512, (2, 12)).astype(np.int32)
    jl, jc = jtfm.prefill(jparams, cfg, jnp.asarray(toks[:, :11]), jc0, CTX)
    jd, _ = jtfm.decode_step(jparams, cfg, jnp.asarray(toks[:, 11]), 11, jc,
                             CTX)
    tl, tc = ttfm.prefill(tparams, tcfg, _tok(toks[:, :11]), tc)
    td, tc = ttfm.decode_step(tparams, tcfg, _tok(toks[:, 11]), 11, tc)
    assert tc["rwkv"]["shift1"].dtype == torch.bfloat16
    assert tc["rwkv"]["S"].dtype == torch.float32
    out = ttfm.forward(tparams, tcfg, _tok(toks[:, :11])).numpy()
    for got, want in ((out, _np(jl)), (tl.numpy(), _np(jl)),
                      (td.numpy(), _np(jd))):
        np.testing.assert_allclose(got, want, atol=BF16_ATOL)
        np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


def test_prefill_refuses_pages(model):
    _, tcfg, _, tparams = model
    cache = ttfm.init_cache(tcfg, 2, 8, device="cpu")
    with pytest.raises(NotImplementedError, match="slot backend"):
        ttfm.prefill(tparams, tcfg, torch.zeros((2, 4), dtype=torch.long),
                     cache, pages=torch.ones((2, 2), dtype=torch.int32))


@pytest.fixture(scope="module")
def jax_steps(model):
    """JAX's make_prefill then three make_serve_step steps, with tau
    midway between two of its prefill confidences."""
    cfg, _, jparams, _ = model
    B, P, steps = 4, 7, 3
    prompts = np.random.default_rng(5).integers(
        0, cfg.vocab_size, (B, P)).astype(np.int32)
    jcache = jtfm.init_cache(cfg, B, P + steps)
    jtok, jnent, jcache = jsteps.make_prefill(cfg, CTX)(
        jparams, jcache, {"tokens": jnp.asarray(prompts)})
    conf0 = np.sort(_np(jnent))
    tau = float(0.5 * (conf0[1] + conf0[2]))
    jstep = jsteps.make_serve_step(cfg, CTX, tau=tau)
    jt, out = jtok.astype(jnp.int32), []
    for i in range(steps):
        jt, jc, jd, jcache = jstep(jparams, jcache, jt, P + i)
        out.append((np.asarray(jt), _np(jc), np.asarray(jd)))
    return prompts, jtok, jnent, tau, out


@pytest.mark.parametrize("kernel", [False, True], ids=["plain", "kernel"])
def test_prefill_and_serve_steps_match_jax(model, jax_steps, kernel):
    """launch.steps' make_prefill, then three make_serve_step steps, take
    the RWKV family through `tfm` unchanged: tokens and defer masks equal
    JAX's, confidences within 1e-5."""
    _, tcfg, _, tparams = model
    prompts, jtok, jnent, tau, jout = jax_steps
    B, P = prompts.shape
    tcache = ttfm.init_cache(tcfg, B, P + len(jout), device="cpu")
    ttok, tnent, tcache = tsteps.make_prefill(tcfg, paged_kernel=kernel)(
        tparams, tcache, {"tokens": _tok(prompts)})
    np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
    np.testing.assert_allclose(tnent.numpy(), _np(jnent), atol=CONF_ATOL)
    tstep = tsteps.make_serve_step(tcfg, tau=tau, paged_kernel=kernel)
    tt = ttok
    for i, (jt, jc, jd) in enumerate(jout):
        tt, tc, td, tcache = tstep(tparams, tcache, tt, P + i)
        np.testing.assert_array_equal(tt.numpy(), jt)
        np.testing.assert_allclose(tc.numpy(), jc, atol=CONF_ATOL)
        np.testing.assert_array_equal(td.numpy(), jd)


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def runners():
    """JAX's `build_ladder("rwkv6-3b", 0, 2)` (reduced M_S, 4-layer
    double-width M_L) and the port's runners on the same weights."""
    from repro.launch.serve import build_ladder
    js, jl = build_ladder(ARCH, 0, 2)
    ts_cfg = t_reduced(t_get_config(ARCH))
    tl_cfg = ts_cfg.replace(name=ts_cfg.name + "-large", n_layers=4,
                            d_model=ts_cfg.d_model * 2, n_heads=8,
                            d_ff=ts_cfg.d_ff * 2)
    assert (tl_cfg.d_model, tl_cfg.d_ff) == (jl.cfg.d_model, jl.cfg.d_ff)
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
    (js, _), (ts, _), prompts, _ = runners
    jt, jc = js.generate(prompts, 8, 4)
    for kernel in (False, True):
        tt, tc = ts.generate(prompts, 8, 4, paged_kernel=kernel)
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
    confidences within 1e-5; the slot backend counts one seeding dispatch
    per admitted prompt-length group."""
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
    """The port's own greedy invariant on RWKV: early_exit=False continuous
    on the slot backend serves the static engine's tokens and masks."""
    _, torch_pair, prompts, _ = runners
    tau, jres = static_jax
    res = ContinuousCascadeEngine(
        CascadeSpec.two_tier(*torch_pair, tau=tau),
        EngineConfig(n_slots=5, early_exit=False)).run(
        make_requests(prompts, 4), 4)
    np.testing.assert_array_equal(res.deferred, jres.deferred)
    np.testing.assert_array_equal(res.tokens, jres.tokens)


def test_paged_pool_rejects_unpageable_families(model):
    """As tests/test_serving_paged.py: a recurrent state and a windowed
    cache both refuse the paged pool (and the paged engine)."""
    _, tcfg, _, _ = model
    with pytest.raises(NotImplementedError, match="recurrent state"):
        PagedCachePool(tcfg, 2, 8, 4, 16, "cpu")
    windowed = t_reduced(t_get_config("internlm2-1.8b")).replace(
        sliding_window=8)
    with pytest.raises(NotImplementedError, match="windowed"):
        PagedCachePool(windowed, 2, 8, 4, 16, "cpu")
    validate_pageable(t_reduced(t_get_config("internlm2-1.8b")), 16)


def test_paged_engine_refuses_rwkv(runners):
    _, torch_pair, _, ragged = runners
    eng = ContinuousCascadeEngine(CascadeSpec.two_tier(*torch_pair, tau=-1.0),
                                  EngineConfig(n_slots=2, backend="paged"))
    with pytest.raises(NotImplementedError, match="slot backend"):
        eng.run(make_requests(ragged[:2], 3), 3)


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("engine", ["continuous", "static"])
def test_cli_serves_rwkv(engine, capsys):
    res = tserve.main(["--device", "cpu", "--arch", ARCH, "--engine", engine,
                       "--requests", "6", "--max-new", "3", "--slots", "3"])
    assert res.tokens.shape == (6, 3)
    if engine == "continuous":
        assert all(r.state == DONE for r in res.requests)
    assert "calibrated tau" in capsys.readouterr().out


def test_cli_rejects_paged_backend_for_rwkv(capsys):
    with pytest.raises(SystemExit) as exc:
        tserve.main(["--device", "cpu", "--arch", ARCH, "--backend", "paged"])
    assert exc.value.code == 2
    assert "slot backend" in capsys.readouterr().err


def test_training_gate_stays_closed_for_rwkv():
    """The gate that refused RWKV6 training now passes it, for serving and
    training alike (its training against JAX:
    tests/test_torch_train_recurrent.py)."""
    ttfm.check_ported(t_get_config(ARCH), training=True)
    ttfm.check_ported(t_get_config(ARCH), training=True, engine=True)
    ttfm.check_ported(t_get_config(ARCH))
