"""The four decoder configs that reach the port last, on the CPU against
the JAX package: qwen1.5-4b and qwen1.5-32b (dense MHA with a QKV bias),
llama3-405b (dense GQA) and kimi-k2-1t-a32b (GQA + MoE with a shared
expert). Configs full and reduced, the full-width trees from shapes
alone, the reduced models' forward, paged prefill and decode logits, the
continuous paged engine on the reduced two-tier ladder and the serve
CLI. The qwens' QKV biases are drawn non-zero from a numpy seed and set
in the JAX tree before converting (`_decoder_cases.set_biases`). The
training steps are in tests/test_torch_decoders_train.py, the ladders in
tests/test_torch_ladders.py."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from _decoder_cases import (ARCHS, BIASED, fields_equal, jshapes, named,
                            set_biases, shapes)
import repro.configs as jconfigs
from repro.configs import get_config, reduced
from repro.launch import serve as jserve
from repro.models import common as jcommon
from repro.models import transformer as jtfm
from repro.serving import CascadeSpec as JCascadeSpec
from repro.serving import EngineConfig as JEngineConfig
from repro.serving import PagedConfig as JPagedConfig
from repro.serving import engine as jeng
from repro.serving import make_requests as j_make_requests
from repro.sharding import ParallelContext
import repro_torch.configs as tconfigs
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs import reduced as t_reduced
from repro_torch.convert import params_from_jax
from repro_torch.launch import serve as tserve
from repro_torch.models import common as tcommon
from repro_torch.models import transformer as ttfm
from repro_torch.serving import (ContinuousCascadeEngine, CascadeSpec,
                                 EngineConfig, ModelRunner, PagedConfig,
                                 make_requests)
from repro_torch.serving.request import DONE
from repro_torch.training import optim as toptim

torch.set_num_threads(1)
CTX = ParallelContext()
LOGIT_ATOL = 1e-5     # fp32 end to end through two layers, sums in other
                      # orders (the kernel-vs-reference bar of ROADMAP.md)
ROPE_ATOL = 1e-6      # fp32 angles and products, positions < 16
CONF_ATOL = 1e-5      # mean eq.-8 confidence, fp32 on both sides

# parameters at published width (JAX's abstract init)
FULL_PARAMS = {"qwen1.5-4b": 3_950_369_280,
               "qwen1.5-32b": 35_197_096_960,
               "llama3-405b": 405_853_388_800,
               "kimi-k2-1t-a32b": 1_027_291_575_296}


# ---------------------------------------------------------------------------
# Configs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_configs_match_jax_field_by_field(arch):
    for t, j in ((t_get_config(arch), get_config(arch)),
                 (t_reduced(t_get_config(arch)), reduced(get_config(arch)))):
        fields_equal(t, j)
    r = t_reduced(t_get_config(arch))
    assert (r.n_heads, r.n_kv_heads, r.head_dim) == (
        (4, 4, 32) if arch in BIASED else (4, 2, 32))
    assert r.qkv_bias == (arch in BIASED)
    if arch == "kimi-k2-1t-a32b":
        assert (r.moe.n_experts, r.moe.top_k, r.moe.n_shared_experts,
                r.moe.shared_d_ff, r.moe.n_dense_layers) == (4, 2, 1, 64, 1)


def test_registry_lists_the_ten_archs_as_jax_does():
    assert tconfigs.list_configs() == jconfigs.list_configs()
    assert tconfigs.ARCH_IDS == jconfigs.ARCH_IDS
    assert tconfigs._ALIAS == jconfigs._ALIAS
    for name in list(jconfigs._ALIAS) + list(jconfigs.ARCH_IDS):
        fields_equal(t_get_config(name), get_config(name))
    with pytest.raises(ValueError) as exc:
        t_get_config("gpt-5")
    assert all(i in str(exc.value) for i in jconfigs.ARCH_IDS)


@pytest.mark.parametrize("arch", ARCHS)
def test_full_width_trees_fromshapes(arch):
    """At published width, from shapes alone (the "meta" device, JAX's
    abstract init): the trees are equal and count JAX's parameters; the
    Kimi router stays fp32 under bf16 weights."""
    tp = ttfm.init_params(t_get_config(arch), 0, "meta")
    jp = jtfm.init_params(get_config(arch), jax.random.PRNGKey(0),
                          abstract=True)
    assert shapes(tp) == jshapes(jp)
    assert sum(t.numel() for t in named(tp).values()) == FULL_PARAMS[arch]
    if arch == "kimi-k2-1t-a32b":
        moe = tp["blocks"]["moe"]["moe"]
        assert moe["router"].dtype == torch.float32
        assert tuple(moe["w_gate"].shape) == (60, 384, 7168, 2048)
        assert moe["w_gate"].dtype == torch.bfloat16


@pytest.mark.parametrize("arch", ARCHS)
def test_rope_at_the_configs_theta_matches_jax(arch):
    """RoPE in fp32 at each config's theta (5e6 for qwen1.5-4b): the
    frequencies within one fp32 step of JAX's (`theta ** e` rounds in
    each library's own pow), and the rotation at the positions the
    reduced tests reach within ROPE_ATOL. At position p a one-step
    frequency difference moves the angle by up to p * 2^-23 rad."""
    theta = t_get_config(arch).rope_theta
    freqs = tcommon.rope_frequencies(128, theta)
    assert freqs.dtype == torch.float32
    np.testing.assert_allclose(freqs.numpy(), np.asarray(
        jcommon.rope_frequencies(128, theta)), rtol=2 ** -23, atol=0)
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 9, 4, 128)).astype(np.float32)
    pos = rng.integers(0, 16, (2, 9)).astype(np.int32)
    ref = np.asarray(jcommon.apply_rope(jnp.asarray(x), jnp.asarray(pos),
                                        theta))
    out = tcommon.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                             theta)
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, atol=ROPE_ATOL)


# ---------------------------------------------------------------------------
# Reduced models on JAX's weights
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    arch = request.param
    cfg, tcfg = reduced(get_config(arch)), t_reduced(t_get_config(arch))
    jparams = jax.device_get(jtfm.init_params(cfg, jax.random.PRNGKey(0)))
    if cfg.qkv_bias:
        jparams = jax.device_get(set_biases(jparams, 11))
    return cfg, tcfg, jparams, params_from_jax(jparams, "cpu")


def test_params_from_jax_round_trips(model):
    """Leaf by leaf, bit for bit: the drawn biases, the MoE stacks and the
    fp32 router included."""
    cfg, _, jparams, tparams = model
    jn, tn = named(jparams), named(tparams)
    assert jn.keys() == tn.keys()
    for name, leaf in jn.items():
        assert tuple(tn[name].shape) == leaf.shape, name
        np.testing.assert_array_equal(tn[name].numpy(), np.asarray(leaf),
                                      err_msg=name)
    attn = tparams["blocks"]["dense"]["attn"]
    assert ({"bq", "bk", "bv"} <= set(attn)) == cfg.qkv_bias
    if cfg.qkv_bias:
        assert all(float(attn[k].abs().min()) > 0 for k in ("bq", "bk", "bv"))
    if cfg.moe is not None:
        assert tparams["blocks"]["moe"]["moe"]["router"].dtype == torch.float32
        assert "shared" in tparams["blocks"]["moe"]["moe"]


def test_forward_logits_match_jax(model):
    cfg, tcfg, jparams, tparams = model
    toks = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 12)).astype(np.int32)
    ref = np.asarray(jtfm.forward(jparams, cfg, jnp.asarray(toks), CTX))
    out = ttfm.forward(tparams, tcfg, torch.from_numpy(toks)).numpy()
    np.testing.assert_allclose(out, ref, atol=LOGIT_ATOL)


@pytest.mark.parametrize("arch", sorted(BIASED))
def test_the_bias_add_is_visible_to_the_parity_test(arch):
    """With the biases zeroed the logits move far past LOGIT_ATOL, so the
    forward parity above holds the bias add and its place (before RoPE)."""
    cfg, tcfg = reduced(get_config(arch)), t_reduced(t_get_config(arch))
    jparams = set_biases(jtfm.init_params(cfg, jax.random.PRNGKey(0)), 11)
    tparams = params_from_jax(jax.device_get(jparams), "cpu")
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 12)))
    zeroed = toptim.tree_map(torch.clone, tparams)
    for k in ("bq", "bk", "bv"):
        zeroed["blocks"]["dense"]["attn"][k].zero_()
    moved = (ttfm.forward(tparams, tcfg, toks)
             - ttfm.forward(zeroed, tcfg, toks)).abs().max()
    assert float(moved) > 1e3 * LOGIT_ATOL


@pytest.mark.parametrize("paged_kernel", [False, True])
def test_paged_prefill_and_decode_logits_match_jax(model, paged_kernel):
    """Chunked paged prefill (chunks of 4 over ragged last tokens) then 3
    paged decode steps through the whole trunk, on the port's gather path
    and its kernel path (the wrappers' plain versions on CPU tensors),
    against JAX's gather path: logits within LOGIT_ATOL at every step."""
    cfg, tcfg, jparams, tparams = model
    tables = np.asarray([[3, 1, 5, 0], [2, 6, 4, 0]], np.int32)
    prompts = np.random.default_rng(2).integers(
        0, cfg.vocab_size, (2, 8)).astype(np.int32)
    jc = jtfm.init_cache(cfg, 9, 4, dtype=cfg.cdtype())
    tc = ttfm.init_cache(tcfg, 9, 4, device="cpu")
    assert shapes(tc) == jshapes(jc)
    for off in (0, 4):
        piece = prompts[:, off:off + 4]
        last = np.asarray([3, 2 if off else 3])
        jl, jc = jtfm.prefill(jparams, cfg, jnp.asarray(piece), jc, CTX,
                              cache_offset=off, pages=jnp.asarray(tables),
                              last_index=jnp.asarray(last))
        tl, tc = ttfm.prefill(tparams, tcfg,
                              torch.from_numpy(piece.astype(np.int64)), tc,
                              cache_offset=off, pages=torch.from_numpy(tables),
                              last_index=torch.from_numpy(last),
                              paged_kernel=paged_kernel)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                   atol=LOGIT_ATOL)
    tok = np.asarray(jnp.argmax(jl[:, 0], -1)).astype(np.int32)
    pos = np.asarray([8, 7], np.int32)
    for _ in range(3):
        jl, jc = jtfm.decode_step(jparams, cfg, jnp.asarray(tok),
                                  jnp.asarray(pos), jc, CTX,
                                  pages=jnp.asarray(tables), paged_kernel=False)
        tl, tc = ttfm.decode_step(tparams, tcfg, torch.from_numpy(tok),
                                  torch.from_numpy(pos), tc,
                                  pages=torch.from_numpy(tables),
                                  paged_kernel=paged_kernel)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                   atol=LOGIT_ATOL)
        tok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
        pos = pos + 1


# ---------------------------------------------------------------------------
# The continuous paged engine on the reduced two-tier ladder
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=ARCHS)
def ladder(request):
    """JAX's reduced two-tier ladder (`build_ladder(arch, 0, 2)`, the
    qwens' zero biases redrawn non-zero in both tiers) and the port's
    runners on the same weights and configs, plus ragged prompts."""
    arch = request.param
    jrunners = jserve.build_ladder(arch, 0, 2)
    pairs = []
    for i, jr in enumerate(jrunners):
        jp = jax.device_get(jr.params)
        if jr.cfg.qkv_bias:
            jp = jax.device_get(set_biases(jp, 20 + i))
        tcfg = (t_reduced(t_get_config(arch)) if i == 0 else
                tserve.large_tier_config(t_reduced(t_get_config(arch))))
        fields_equal(tcfg, jr.cfg)
        pairs.append((jeng.ModelRunner(jr.cfg, jp),
                      ModelRunner(tcfg, params_from_jax(jp, "cpu"))))
    base = np.random.default_rng(9).integers(
        0, jrunners[0].cfg.vocab_size, (8, 12)).astype(np.int32)
    ragged = [base[i, :n] for i, n in enumerate((5, 9, 4, 12, 7, 6, 10, 4))]
    return arch, [p[0] for p in pairs], [p[1] for p in pairs], ragged


def test_continuous_paged_engine_matches_jax(ladder):
    """Ragged prompts over the paged backend (block 4, chunk 4) with
    in-flight early exit, at a tau between the 4th and 5th of JAX's
    undeferred confidences, on the gather and kernel paths: per-rid
    tokens, deferral and early-exit flags equal JAX's, confidences within
    CONF_ATOL, and the pool's counters equal."""
    _, jpair, tpair, ragged = ladder

    def jax_run(tau):
        return jeng.ContinuousCascadeEngine(
            JCascadeSpec.two_tier(*jpair, tau=tau),
            JEngineConfig(n_slots=3, backend="paged", paged=JPagedConfig(
                block_size=4, prefill_chunk=4, paged_kernel=False))).run(
            j_make_requests(ragged, 5), 5)
    conf = np.sort(jax_run(-1e9).confidence)
    tau = float(0.5 * (conf[3] + conf[4]))
    jres = jax_run(tau)
    assert 0 < sum(r.deferred for r in jres.requests) < len(ragged)
    for kernel in (False, True):
        res = ContinuousCascadeEngine(
            CascadeSpec.two_tier(*tpair, tau=tau),
            EngineConfig(n_slots=3, backend="paged", paged=PagedConfig(
                block_size=4, prefill_chunk=4, paged_kernel=kernel))).run(
            make_requests(ragged, 5), 5)
        assert res.stats["paged_kernel"] == kernel
        for jr, tr in zip(jres.requests, res.requests):
            assert tr.state == DONE and tr.rid == jr.rid
            np.testing.assert_array_equal(tr.tokens, jr.tokens)
            assert (tr.deferred, tr.early_exited) == (jr.deferred,
                                                      jr.early_exited)
            np.testing.assert_allclose(tr.confidence, jr.confidence,
                                       atol=CONF_ATOL)
        for k in ("prefill_chunks", "prefill_dispatches", "peak_blocks",
                  "saved_steps"):
            assert res.stats[k] == jres.stats[k], k


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_cli_runs_the_arch_on_cpu(arch, capsys):
    """`--arch X` (reduced by default, as in JAX) through the port's serve
    CLI on the paged backend with the kernel path forced on."""
    res = tserve.main(["--arch", arch, "--device", "cpu", "--requests", "6",
                       "--max-new", "3", "--backend", "paged",
                       "--ragged-min", "4", "--ragged-max", "12",
                       "--block-size", "4", "--prefill-chunk", "4",
                       "--paged-kernel", "on"])
    assert all(r.state == DONE for r in res.requests)
    assert res.stats["paged_kernel"] and res.tokens.shape == (6, 3)
    assert f"{arch}-reduced" in capsys.readouterr().out


