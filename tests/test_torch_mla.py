"""Port's DeepSeek-V2 slice on the CPU against the JAX package: the MLA
decode kernel's plain version, MLA attention (dense, per-row and paged
caches), the local MoE FFN with its shared expert, the trunk's logits for
the reduced moe-family config and the dense-MLA fixture
(``moe=None, family="dense"``), and the continuous engine on MLA caches.
Inputs come from numpy seeds; JAX weights come over through
`params_from_jax`. The JAX Pallas kernels run in interpret mode."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from repro.configs import get_config, reduced
from repro.kernels import ops as jops
from repro.models import attention as jattn
from repro.models import ffn as jffn
from repro.models import transformer as jtfm
from repro.models.common import ParamFactory
from repro.serving import CascadeEngine as JCascadeEngine
from repro.serving import engine as jeng
from repro.sharding import ParallelContext
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs import reduced as t_reduced
from repro_torch.convert import params_from_jax
from repro_torch.kernels import _build
from repro_torch.kernels import ops as tops
from repro_torch.kernels import paged_attention as tpa
from repro_torch.models import attention as tattn
from repro_torch.models import ffn as tffn
from repro_torch.models import transformer as ttfm
from repro_torch.serving import (CascadeEngine, CascadeSpec,
                                 ContinuousCascadeEngine, EngineConfig,
                                 ModelRunner, PagedConfig, make_requests)
from repro_torch.serving.request import DONE

torch.set_num_threads(1)
CTX = ParallelContext()
KERNEL_ATOL = 1e-5    # fp32 online softmax against a one-shot softmax
LAYER_ATOL = 1e-5     # one fp32 attention layer, sums in other orders
LOGIT_ATOL = 1e-4     # fp32 end to end through two layers
CONF_ATOL = 1e-5      # mean eq.-8 confidence, fp32 on both sides

ARCH = "deepseek-v2-236b"
# page tables with one all-trash row and ragged positions (the JAX
# package's tests/test_paged_kernel.py fixture)
TABLES = np.asarray([[1, 2, 3, 0], [4, 5, 0, 0], [6, 0, 0, 0],
                     [0, 0, 0, 0]], np.int32)
POS = np.asarray([9, 6, 2, 3], np.int32)


def _cfgs(kind):
    """(JAX cfg, port cfg): the reduced moe family, or the JAX tests'
    dense-MLA fixture."""
    cfg, tcfg = reduced(get_config(ARCH)), t_reduced(t_get_config(ARCH))
    if kind == "dense-mla":
        cfg = cfg.replace(moe=None, family="dense")
        tcfg = tcfg.replace(moe=None, family="dense")
    return cfg, tcfg


@pytest.fixture(scope="module", params=["moe", "dense-mla"])
def model(request):
    cfg, tcfg = _cfgs(request.param)
    jparams = jtfm.init_params(cfg, jax.random.PRNGKey(0))
    return cfg, tcfg, jparams, params_from_jax(jax.device_get(jparams), "cpu")


# ---------------------------------------------------------------------------
# Config and weights
# ---------------------------------------------------------------------------

def test_configs_match_jax():
    for t, j in ((t_get_config(ARCH), get_config(ARCH)),
                 (t_reduced(t_get_config(ARCH)), reduced(get_config(ARCH)))):
        for f in ("n_layers", "d_model", "n_heads", "n_kv_heads", "head_dim",
                  "d_ff", "vocab_size", "rope_theta", "norm_eps", "family",
                  "param_dtype", "compute_dtype"):
            assert getattr(t, f) == getattr(j, f), f
        # the port keeps MoESpec's fields that its dropless local path reads
        for f in ("n_experts", "top_k", "d_ff_expert", "n_shared_experts",
                  "shared_d_ff", "n_dense_layers"):
            assert getattr(t.moe, f) == getattr(j.moe, f), f
        assert vars(t.mla) == vars(j.mla)


def test_convert_keeps_mla_moe_trees_and_fp32_router():
    """bf16 parameters (the published config's type) carried over leaf by
    leaf, bit for bit; the router stays fp32."""
    cfg = reduced(get_config(ARCH)).replace(param_dtype="bfloat16")
    jparams = jax.device_get(jtfm.init_params(cfg, jax.random.PRNGKey(1)))
    tparams = params_from_jax(jparams, "cpu")
    for path, leaf in jax.tree_util.tree_leaves_with_path(jparams):
        t = tparams
        for p in path:
            t = t[p.key]
        assert tuple(t.shape) == leaf.shape, path
        np.testing.assert_array_equal(t.float().numpy(),
                                      np.asarray(leaf, np.float32))
    assert tparams["blocks"]["moe"]["moe"]["router"].dtype == torch.float32
    assert tparams["blocks"]["moe"]["attn"]["wuk"].dtype == torch.bfloat16


def test_init_params_shapes_match_jax(model):
    cfg, tcfg, jparams, _ = model
    own = ttfm.init_params(tcfg.replace(param_dtype="bfloat16"), seed=3,
                           device="cpu")
    assert (jax.tree.map(lambda t: tuple(t.shape), own)
            == jax.tree.map(lambda a: a.shape, jparams))
    if cfg.moe is not None:
        assert own["blocks"]["moe"]["moe"]["router"].dtype == torch.float32


# ---------------------------------------------------------------------------
# Kernel: plain version against the Pallas kernel (interpret mode)
# ---------------------------------------------------------------------------

def _mla_inputs(seed, B=4, H=4, r=8, dr=6, bs=4, N=8):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return (f(B, 1, H, r), f(B, 1, H, dr), f(N, bs, r), f(N, bs, dr),
            f(r) * 0.1)


@pytest.mark.parametrize("hole", [False, True], ids=["ragged", "hole"])
def test_plain_mla_decode_matches_jax_kernel(hole):
    """Ragged tables with an all-trash row (atol 1e-5; exact zeros for
    that row); with `hole`, a zero table entry inside row 0's valid
    prefix, which both kernels skip."""
    args = _mla_inputs(2)
    tables = TABLES.copy()
    if hole:
        tables[0, 1] = 0
    scale = 1.0 / np.sqrt(16 + 6)
    ref = np.asarray(jops.paged_flash_decode_mla(
        *map(jnp.asarray, args), jnp.asarray(tables), jnp.asarray(POS),
        scale=scale))
    out = tpa.paged_flash_decode_mla_plain(
        *map(torch.from_numpy, args), torch.from_numpy(tables),
        torch.from_numpy(POS), scale=scale)
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, atol=KERNEL_ATOL)
    np.testing.assert_array_equal(out[3].numpy(), np.zeros_like(ref[3]))


def test_mla_wrapper_takes_plain_version_on_cpu(monkeypatch):
    """CPU tensors never reach the CUDA path: no build, no launch count."""
    def no_build(name):
        raise AssertionError(f"tried to build {name} for CPU tensors")
    monkeypatch.setattr(_build, "load", no_build)
    args = [torch.from_numpy(a).to(torch.bfloat16) for a in _mla_inputs(3)]
    tables, pos = torch.from_numpy(TABLES), torch.from_numpy(POS)
    n = tpa.paged_flash_decode_mla.launches
    out = tops.paged_flash_decode_mla(*args, tables, pos, scale=0.2)
    torch.testing.assert_close(out, tpa.paged_flash_decode_mla_plain(
        *args, tables, pos, scale=0.2), atol=0, rtol=0)
    assert out.dtype == torch.float32
    assert tpa.paged_flash_decode_mla.launches == n


# ---------------------------------------------------------------------------
# MLA attention, one layer
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def mla_layer():
    cfg, tcfg = _cfgs("dense-mla")
    jp = jtfm.init_params(cfg, jax.random.PRNGKey(4))
    jl = jax.tree.map(lambda a: a[0], jp["blocks"]["dense"]["attn"])
    tl = params_from_jax(jax.device_get(jl), "cpu")
    x = np.random.default_rng(5).standard_normal(
        (4, 10, cfg.d_model)).astype(np.float32) * 0.5
    return jtfm.attn_config(cfg), ttfm.attn_config(tcfg), jl, tl, x


def test_mla_forward_without_cache_matches_jax(mla_layer):
    jac, tac, jl, tl, x = mla_layer
    pos = np.arange(10)[None, :]
    ref, _ = jattn.mla_forward(jl, jac, jnp.asarray(x), jnp.asarray(pos), CTX)
    out, cache = tattn.mla_forward(tl, tac, torch.from_numpy(x),
                                   torch.from_numpy(pos))
    assert cache is None
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=LAYER_ATOL)


def test_mla_dense_cache_prefill_and_decode_match_jax(mla_layer):
    """Prefill 6 tokens into a dense cache, then decode at a scalar
    position and at per-row positions: outputs and caches match JAX."""
    jac, tac, jl, tl, x = mla_layer
    B, L = x.shape[0], 12
    z = {"ckv": np.zeros((B, L, jac.kv_lora), np.float32),
         "kr": np.zeros((B, L, jac.rope_dim), np.float32)}
    pos = np.arange(6)[None, :]
    jy, jc = jattn.mla_forward(jl, jac, jnp.asarray(x[:, :6]),
                               jnp.asarray(pos), CTX,
                               {k: jnp.asarray(v) for k, v in z.items()})
    tc = {k: torch.from_numpy(v.copy()) for k, v in z.items()}
    ty, tc = tattn.mla_forward(tl, tac, torch.from_numpy(x[:, :6]),
                               torch.from_numpy(pos), tc)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=LAYER_ATOL)
    for position in (6, np.asarray([6, 7, 6, 9], np.int32)):
        step = x[:, 6:7] if np.ndim(position) == 0 else x[:, 7:8]
        jy, jc = jattn.mla_decode(jl, jac, jnp.asarray(step), position, jc,
                                  CTX)
        pos_t = (position if np.ndim(position) == 0
                 else torch.from_numpy(position))
        ty, tc = tattn.mla_decode(tl, tac, torch.from_numpy(step), pos_t, tc)
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy),
                                   atol=LAYER_ATOL)
        for k in ("ckv", "kr"):
            np.testing.assert_allclose(tc[k].numpy(), np.asarray(jc[k]),
                                       atol=LAYER_ATOL)


@pytest.mark.parametrize("paged_kernel", [False, True])
def test_mla_paged_prefill_and_decode_match_jax(mla_layer, paged_kernel):
    """Chunked paged prefill (block 4, chunks of 4 then 2) and one paged
    decode step, on both of the port's decode paths, against JAX's gather
    path (plain) and its Pallas kernel in interpret mode (kernel): outputs
    and every written block but the trash block match."""
    jac, tac, jl, tl, x = mla_layer
    tables = np.asarray([[3, 1, 0, 0], [2, 6, 0, 0], [5, 4, 0, 0],
                         [8, 7, 0, 0]], np.int32)
    pages = {"ckv": np.zeros((9, 4, jac.kv_lora), np.float32),
             "kr": np.zeros((9, 4, jac.rope_dim), np.float32)}
    jc = {k: jnp.asarray(v) for k, v in pages.items()}
    tc = {k: torch.from_numpy(v.copy()) for k, v in pages.items()}
    for off, n in ((0, 4), (4, 2)):
        pos = np.arange(off, off + n)[None, :]
        jy, jc = jattn.mla_forward(jl, jac, jnp.asarray(x[:, off:off + n]),
                                   jnp.asarray(pos), CTX, jc, off,
                                   pages=jnp.asarray(tables))
        ty, tc = tattn.mla_forward(tl, tac, torch.from_numpy(x[:, off:off + n]),
                                   torch.from_numpy(pos), tc, off,
                                   pages=torch.from_numpy(tables))
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=LAYER_ATOL)
    dpos = np.asarray([6, 7, 6, 6], np.int32)
    jy, jc = jattn.mla_decode(jl, jac, jnp.asarray(x[:, 6:7]), jnp.asarray(dpos),
                              jc, CTX, pages=jnp.asarray(tables),
                              paged_kernel=paged_kernel)
    ty, tc = tattn.mla_decode(tl, tac, torch.from_numpy(x[:, 6:7]),
                              torch.from_numpy(dpos), tc,
                              pages=torch.from_numpy(tables),
                              paged_kernel=paged_kernel)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=LAYER_ATOL)
    for k in ("ckv", "kr"):
        np.testing.assert_allclose(tc[k].numpy()[1:], np.asarray(jc[k])[1:],
                                   atol=LAYER_ATOL)


# ---------------------------------------------------------------------------
# MoE FFN, local path
# ---------------------------------------------------------------------------

def _moe_case(shared):
    jcfg = jffn.MoEConfig(d_model=16, d_ff=8, n_experts=4, top_k=2,
                          n_shared_experts=int(shared),
                          shared_d_ff=8 if shared else None)
    tcfg = tffn.MoEConfig(d_model=16, d_ff=8, n_experts=4, top_k=2,
                          n_shared_experts=int(shared),
                          shared_d_ff=8 if shared else None)
    jp = jffn.init_moe(ParamFactory(jax.random.PRNGKey(0), jnp.float32), jcfg)
    x = np.random.default_rng(1).standard_normal((2, 16, 16)).astype(
        np.float32)
    return jcfg, tcfg, jp, params_from_jax(jax.device_get(jp), "cpu"), x


def test_router_gates_sum_to_one_and_match_jax():
    jcfg, tcfg, jp, tp, x = _moe_case(False)
    x2d = x.reshape(-1, 16)
    jg, ji, jaux = jffn._route(jp["router"], jnp.asarray(x2d), jcfg)
    tg, ti, taux, tcounts = tffn._route(tp["router"], torch.from_numpy(x2d),
                                        tcfg)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), atol=1e-6)
    np.testing.assert_allclose(tg.sum(-1).numpy(), np.ones(32), atol=1e-6)
    assert float(taux) == pytest.approx(float(jaux), abs=1e-6)
    np.testing.assert_array_equal(
        tcounts.numpy(), np.bincount(np.asarray(ji).reshape(-1), minlength=4))


@pytest.mark.parametrize("shared", [False, True], ids=["routed", "shared"])
def test_moe_forward_matches_jax(shared):
    """Every assignment computed (no capacity drop): atol 1e-5 against
    JAX's sort + ragged_dot path, shared expert included."""
    jcfg, tcfg, jp, tp, x = _moe_case(shared)
    jy, jaux = jffn.moe_forward(jp, jcfg, jnp.asarray(x), CTX)
    ty, taux = tffn.moe_forward(tp, tcfg, torch.from_numpy(x))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=1e-5)
    assert float(taux) == pytest.approx(float(jaux), abs=1e-6)


# ---------------------------------------------------------------------------
# Trunk: logits for the moe family and the dense-MLA fixture
# ---------------------------------------------------------------------------

def test_forward_logits_match_jax(model):
    cfg, tcfg, jparams, tparams = model
    toks = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 12)).astype(np.int32)
    ref = np.asarray(jtfm.forward(jparams, cfg, jnp.asarray(toks), CTX))
    out = ttfm.forward(tparams, tcfg, torch.from_numpy(toks)).numpy()
    np.testing.assert_allclose(out, ref, atol=LOGIT_ATOL)


@pytest.mark.parametrize("paged_kernel", [False, True])
def test_paged_prefill_and_decode_logits_match_jax(model, paged_kernel):
    """Chunked paged prefill then 3 paged decode steps through the whole
    trunk: logits equal JAX's gather path at every step (atol 1e-4)."""
    cfg, tcfg, jparams, tparams = model
    tables = np.asarray([[3, 1, 5, 0], [2, 6, 4, 0]], np.int32)
    prompts = np.random.default_rng(2).integers(
        0, cfg.vocab_size, (2, 7)).astype(np.int32)
    jc = jtfm.init_cache(cfg, 9, 4, dtype=cfg.cdtype())
    tc = ttfm.init_cache(tcfg, 9, 4, device="cpu")
    assert set(tc) == set(jc) and all(
        set(tc[k]) == {"ckv", "kr"} for k in tc)
    for off in (0, 4):
        piece = prompts[:, off:off + 4]
        last = np.full((2,), piece.shape[1] - 1)
        jl, jc = jtfm.prefill(jparams, cfg, jnp.asarray(piece), jc, CTX,
                              cache_offset=off, pages=jnp.asarray(tables),
                              last_index=jnp.asarray(last))
        tl, tc = ttfm.prefill(tparams, tcfg,
                              torch.from_numpy(piece.astype(np.int64)), tc,
                              cache_offset=off, pages=torch.from_numpy(tables),
                              last_index=torch.from_numpy(last))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGIT_ATOL)
    tok = np.asarray(jnp.argmax(jl[:, 0], -1)).astype(np.int32)
    pos = np.full((2,), 7, np.int32)
    for _ in range(3):
        jl, jc = jtfm.decode_step(jparams, cfg, jnp.asarray(tok),
                                  jnp.asarray(pos), jc, CTX,
                                  pages=jnp.asarray(tables), paged_kernel=False)
        tl, tc = ttfm.decode_step(tparams, tcfg, torch.from_numpy(tok),
                                  torch.from_numpy(pos), tc,
                                  pages=torch.from_numpy(tables),
                                  paged_kernel=paged_kernel)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGIT_ATOL)
        tok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
        pos = pos + 1


# ---------------------------------------------------------------------------
# Serving on MLA caches
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=["moe", "dense-mla"])
def mla_runners(request):
    cfg, tcfg = _cfgs(request.param)
    key = jax.random.PRNGKey(3)
    js = jtfm.init_params(cfg, key)
    jl = jtfm.init_params(cfg, jax.random.fold_in(key, 1))
    jax_pair = (jeng.ModelRunner(cfg, js),
                jeng.ModelRunner(cfg.replace(name="l"), jl))
    torch_pair = (
        ModelRunner(tcfg, params_from_jax(jax.device_get(js), "cpu")),
        ModelRunner(tcfg.replace(name="l"),
                    params_from_jax(jax.device_get(jl), "cpu")))
    prompts = np.random.default_rng(4).integers(
        0, cfg.vocab_size, (4, 8)).astype(np.int32)
    return jax_pair, torch_pair, prompts


def _paged(pair, **paged):
    return ContinuousCascadeEngine(
        CascadeSpec.two_tier(pair[0], pair[1], tau=-1e9),
        EngineConfig(n_slots=2, early_exit=False, backend="paged",
                     paged=PagedConfig(block_size=4, **paged)))


def test_static_cascade_and_paged_engine_match_jax(mla_runners):
    """The static cascade matches JAX (tokens exact, confidence 1e-5), and
    the continuous paged engine (block 4, chunk 3) matches it token for
    token (tests/test_serving_paged.py::test_mla_paged_parity)."""
    jax_pair, pair, prompts = mla_runners
    jres = JCascadeEngine(*jax_pair, tau=-1e9).serve(prompts, 8, 3)
    sres = CascadeEngine(*pair, tau=-1e9).serve(prompts, 8, 3)
    np.testing.assert_array_equal(sres.tokens, jres.tokens)
    np.testing.assert_allclose(sres.confidence, jres.confidence,
                               atol=CONF_ATOL)
    cres = _paged(pair, prefill_chunk=3).run(make_requests(prompts, 3), 3)
    assert all(r.state == DONE for r in cres.requests)
    np.testing.assert_array_equal(cres.tokens, sres.tokens)


def test_engine_kernel_path_matches_plain_path(mla_runners):
    """paged_kernel=True (the MLA kernel's wrapper; its plain version on
    CPU tensors) against the gather path, on ragged prompts: identical
    tokens, confidence within 1e-5
    (tests/test_paged_kernel.py::test_mla_engine_kernel_parity)."""
    _, pair, prompts = mla_runners
    ragged = [prompts[i, :n] for i, n in enumerate((6, 8, 4, 7))]
    out = {k: _paged(pair, prefill_chunk=4, paged_kernel=k).run(
        make_requests(ragged, 3), 3) for k in (False, True)}
    assert out[True].stats["paged_kernel"]
    np.testing.assert_array_equal(out[True].tokens, out[False].tokens)
    np.testing.assert_allclose(out[True].confidence, out[False].confidence,
                               atol=CONF_ATOL)


def test_shared_prefix_with_cow_is_exact(mla_runners):
    """Prefix sharing with copy-on-write over the ckv/kr leaves gives the
    unshared run's tokens
    (tests/test_serving_prefix.py::test_shared_prefix_parity_mla)."""
    _, pair, prompts = mla_runners
    a, b = (np.concatenate([prompts[0], prompts[i, :4]]).astype(np.int32)
            for i in (0, 1))
    # wave 1: a, b prefill; wave 2: two concurrent sharers of all of a
    prompts = [a, b, a, a]
    out = {s: _paged(pair, prefill_chunk=4, prefix_sharing=s).run(
        make_requests(prompts, 3), 3) for s in (False, True)}
    np.testing.assert_array_equal(out[True].tokens, out[False].tokens)
    assert out[True].stats["shared_tokens"] > 0
    assert out[True].stats["cow_clones"] >= 1


def test_cli_serves_deepseek_on_cpu(capsys):
    """`--arch deepseek-v2-236b` (reduced by default, as in JAX) through
    the port's CLI on the paged backend with the kernel path forced on."""
    from repro_torch.launch import serve
    res = serve.main(["--arch", ARCH, "--device", "cpu", "--requests", "6",
                      "--max-new", "3", "--backend", "paged",
                      "--ragged-min", "4", "--ragged-max", "12",
                      "--block-size", "4", "--prefill-chunk", "4",
                      "--paged-kernel", "on"])
    assert all(r.state == DONE for r in res.requests)
    assert res.stats["paged_kernel"] and res.tokens.shape == (6, 3)
    assert "deepseek-v2-236b-reduced" in capsys.readouterr().out
