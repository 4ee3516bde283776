"""The port's encoder-decoder (whisper-small) on the CPU against the JAX
package, on the reduced fp32 config with JAX weights carried over by
`params_from_jax` and inputs from numpy seeds: the config, the sinusoidal
positions (bit-equal), the GELU MLP (1e-6; the exact erf GELU misses
it), `encode`, `cross_kv` and `forward`, prefill + decode against the
full forward (mirroring tests/test_models_smoke.py's
test_encdec_prefill_decode), `launch.steps`' make_prefill /
make_serve_step (greedy tokens and defer masks equal, confidences within
1e-5) and make_train_step's loss terms and gradients leaf by leaf, the
kernel switch forced both ways (on CPU tensors the kernels' wrappers run
their plain versions), and the full-width structure from shapes alone.

Tolerances: ATOL 1e-5 on hidden states, cross K/V, confidences and loss
terms (fp32 on both sides, sums in other orders); LOGIT_ATOL 1e-4 on
logits over the 512-token vocabulary; gradients within 1e-5 of each
leaf's largest entry plus rtol 1e-4.
"""
import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
import torch.nn.functional as F

from repro.configs import get_config, reduced
from repro.core.gatekeeper import GatekeeperConfig as JGK
from repro.launch import steps as jsteps
from repro.models import encdec as jenc
from repro.models import ffn as jffn
from repro.models import transformer as jtfm
from repro.models.encdec import sinusoidal_positions as j_sinusoidal
from repro.sharding import ParallelContext
from repro.training import optim as joptim
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs import reduced as t_reduced
from repro_torch.convert import params_from_jax
from repro_torch.core.gatekeeper import GatekeeperConfig as TGK
from repro_torch.launch import serve as tserve
from repro_torch.launch import steps as tsteps
from repro_torch.launch import train as ttrain
from repro_torch.models import encdec as tenc
from repro_torch.models import ffn as tffn
from repro_torch.models import transformer as ttfm
from repro_torch.models.common import sinusoidal_positions
from repro_torch.serving import ModelRunner
from repro_torch.training import optim as toptim

torch.set_num_threads(1)
CTX = ParallelContext()
ARCH = "whisper-small"
ATOL = 1e-5
LOGIT_ATOL = 1e-4
GRAD_RTOL = 1e-4
OPT = dict(lr=1e-3, warmup_steps=2, total_steps=10)
FULL_PARAMS = 277_985_280     # JAX's abstract init of whisper-small


def _named(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_named(tree[k], f"{prefix}/{k}"))
        return out
    return {prefix: tree}


def _shapes(tree):
    return {k: tuple(v.shape) for k, v in _named(tree).items()}


@pytest.fixture(scope="module")
def model():
    """(JAX cfg, port cfg, JAX params as numpy, port params, frames)."""
    cfg, tcfg = reduced(get_config(ARCH)), t_reduced(t_get_config(ARCH))
    jparams = jax.device_get(jtfm.init_params(cfg, jax.random.PRNGKey(0)))
    frames = np.random.default_rng(1).standard_normal(
        (4, cfg.encoder.n_frames, cfg.d_model)).astype(np.float32)
    return cfg, tcfg, jparams, params_from_jax(jparams, "cpu"), frames


@pytest.mark.parametrize("reduce", [False, True], ids=["full", "reduced"])
def test_config_matches_jax(reduce):
    """Every field the port's ModelConfig has equals JAX's, the encoder
    spec included, at published width and reduced (EncoderSpec(2, 16))."""
    cfg, tcfg = get_config(ARCH), t_get_config(ARCH)
    if reduce:
        cfg, tcfg = reduced(cfg), t_reduced(tcfg)
    for f in dataclasses.fields(tcfg):
        got, want = getattr(tcfg, f.name), getattr(cfg, f.name)
        if dataclasses.is_dataclass(want):
            got, want = dataclasses.asdict(got), dataclasses.asdict(want)
        assert got == want, f.name
    assert tcfg.encoder.n_frames == (16 if reduce else 1500)
    assert tcfg.family == "encdec" and tcfg.vision is None


@pytest.mark.parametrize("n,d", [(16, 256), (1500, 768), (7, 10)])
def test_sinusoidal_positions_bit_equal(n, d):
    got = sinusoidal_positions(n, d)
    assert got.dtype == torch.float32 and got.shape == (n, d)
    np.testing.assert_array_equal(got.numpy(), np.asarray(j_sinusoidal(n, d)))


def test_gelu_mlp_matches_jax_and_needs_the_tanh_form(model):
    """The decoder's GELU MLP (layer 0, random biases so both are read)
    within atol 1e-6 + rtol 1e-6 of JAX's `mlp_forward(activation="gelu")`
    (fp32 sums of 512 products in other orders); the exact erf GELU
    differs from it by more than 1e-4."""
    cfg, _, jparams, _, _ = model
    rng = np.random.default_rng(2)
    p = {k: np.array(v[0]) for k, v in
         jparams["blocks"]["dense"]["mlp"].items()}
    p["b_up"] = rng.standard_normal(p["b_up"].shape).astype(np.float32)
    p["b_down"] = rng.standard_normal(p["b_down"].shape).astype(np.float32)
    x = rng.standard_normal((2, 5, cfg.d_model)).astype(np.float32)
    want = np.asarray(jffn.mlp_forward(
        {k: jnp.asarray(v) for k, v in p.items()},
        jffn.MLPConfig(cfg.d_model, cfg.d_ff, "gelu"), jnp.asarray(x), CTX))
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    got = tffn.mlp_forward(tp, torch.from_numpy(x), "gelu").numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6)
    pre = torch.from_numpy(x) @ tp["w_up"] + tp["b_up"]
    erf = (F.gelu(pre) @ tp["w_down"] + tp["b_down"]).numpy()
    assert np.abs(erf - want).max() > 1e-4


@pytest.mark.parametrize("kernel", [False, True], ids=["plain", "kernel"])
def test_encode_and_cross_kv_match_jax(model, kernel):
    """`encode` (RoPE on top of the sinusoidal positions, as JAX's code
    does) and the stacked cross K/V [L, B, S, H, hd] within 1e-5."""
    cfg, tcfg, jparams, tparams, frames = model
    j_out = jenc.encode(jparams, cfg, jnp.asarray(frames), CTX)
    with torch.inference_mode():
        t_out = tenc.encode(tparams, tcfg, torch.from_numpy(frames),
                            paged_kernel=kernel)
    np.testing.assert_allclose(t_out.numpy(), np.asarray(j_out), atol=ATOL,
                               rtol=0)
    jkv = jenc.cross_kv(jparams, cfg, j_out)
    tkv = tenc.cross_kv(tparams, tcfg, t_out)
    for n in ("k", "v"):
        assert tkv[n].shape == (cfg.n_layers, 4, cfg.encoder.n_frames,
                                cfg.n_heads, cfg.head_dim)
        np.testing.assert_allclose(tkv[n].numpy(), np.asarray(jkv[n]),
                                   atol=ATOL, rtol=0)


def test_forward_matches_jax(model):
    cfg, tcfg, jparams, tparams, frames = model
    toks = np.random.default_rng(3).integers(
        0, cfg.vocab_size, (4, 9)).astype(np.int32)
    want = jenc.forward(jparams, cfg, jnp.asarray(frames), jnp.asarray(toks),
                        CTX)
    with torch.no_grad():
        got = tenc.forward(tparams, tcfg, torch.from_numpy(frames),
                           torch.from_numpy(toks))
    assert got.dtype == torch.float32 and got.shape == (4, 9, cfg.vocab_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=LOGIT_ATOL, rtol=0)


@pytest.mark.parametrize("kernel", [False, True], ids=["plain", "kernel"])
def test_prefill_and_decode_match_forward(model, kernel):
    """Prefill of T - 1 decoder tokens then one decode step, against the
    full forward's logits, the port's and JAX's (within LOGIT_ATOL; JAX's
    own test holds its prefill to 1e-3); the cache keeps the cross K/V in
    its type."""
    cfg, tcfg, jparams, tparams, frames = model
    T = 8
    toks = np.random.default_rng(4).integers(
        0, cfg.vocab_size, (4, T)).astype(np.int32)
    full = np.asarray(jenc.forward(jparams, cfg, jnp.asarray(frames),
                                   jnp.asarray(toks), CTX))
    with torch.no_grad():
        t_full = tenc.forward(tparams, tcfg, torch.from_numpy(frames),
                              torch.from_numpy(toks)).numpy()
    cache = tenc.init_cache(tcfg, 4, T + 2, device="cpu")
    assert cache["cross_kv"]["k"].shape == (cfg.n_layers, 4, 16, 4, 32)
    lg, cache = tenc.prefill(tparams, tcfg, torch.from_numpy(frames),
                             torch.from_numpy(toks[:, :T - 1]), cache,
                             paged_kernel=kernel)
    step, _ = tenc.decode_step(tparams, tcfg, torch.from_numpy(toks[:, T - 1]),
                               T - 1, cache, paged_kernel=kernel)
    for ref in (full, t_full):
        np.testing.assert_allclose(lg.numpy(), ref[:, :T - 1],
                                   atol=LOGIT_ATOL, rtol=0)
        np.testing.assert_allclose(step.numpy(), ref[:, -1],
                                   atol=LOGIT_ATOL, rtol=0)
    # a vector of per-row positions decodes the same as the scalar
    cache2 = tenc.init_cache(tcfg, 4, T + 2, device="cpu")
    tenc.prefill(tparams, tcfg, torch.from_numpy(frames),
                 torch.from_numpy(toks[:, :T - 1]), cache2)
    step2, _ = tenc.decode_step(tparams, tcfg,
                                torch.from_numpy(toks[:, T - 1]),
                                torch.full((4,), T - 1), cache2)
    np.testing.assert_allclose(step2.numpy(), step.numpy(), atol=1e-6,
                               rtol=0)


@pytest.mark.parametrize("kernel", [False, True], ids=["plain", "kernel"])
def test_prefill_and_serve_steps_match_jax(model, kernel):
    """make_prefill then three make_serve_step steps, against JAX's
    builders on the same weights, frames and prompts: greedy tokens and
    defer masks exact, confidences within 1e-5; tau midway between two of
    JAX's prefill confidences."""
    cfg, tcfg, jparams, tparams, frames = model
    B, P, steps = 4, 5, 3
    prompts = np.random.default_rng(5).integers(
        0, cfg.vocab_size, (B, P)).astype(np.int32)
    jcache = jenc.init_cache(cfg, B, P + steps)
    jtok, jnent, jcache = jsteps.make_prefill(cfg, CTX)(
        jparams, jcache, {"tokens": jnp.asarray(prompts),
                          "frames": jnp.asarray(frames)})
    tcache = tenc.init_cache(tcfg, B, P + steps, device="cpu")
    ttok, tnent, tcache = tsteps.make_prefill(tcfg, paged_kernel=kernel)(
        tparams, tcache, {"tokens": torch.from_numpy(prompts),
                          "frames": torch.from_numpy(frames)})
    np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
    np.testing.assert_allclose(tnent.numpy(), np.asarray(jnent), atol=ATOL,
                               rtol=0)
    conf0 = np.sort(np.asarray(jnent))
    tau = float(0.5 * (conf0[1] + conf0[2]))
    jstep = jsteps.make_serve_step(cfg, CTX, tau=tau)
    tstep = tsteps.make_serve_step(tcfg, tau=tau, paged_kernel=kernel)
    jt, tt = jtok.astype(jnp.int32), ttok
    defers = []
    for i in range(steps):
        jt, jc, jd, jcache = jstep(jparams, jcache, jt, P + i)
        tt, tc, td, tcache = tstep(tparams, tcache, tt, P + i)
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
        np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=ATOL,
                                   rtol=0)
        np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
        defers.append(td.numpy())
    assert tt.dtype == torch.int32 and td.dtype == torch.bool
    assert 0 < np.mean(defers) < 1            # both outcomes occur


def _assert_grads(gj, gt):
    nj = {k: np.asarray(v) for k, v in _named(gj).items()}
    nt = {k: v.numpy() for k, v in _named(gt).items()}
    assert nj.keys() == nt.keys()
    for name in nj:
        scale = float(np.abs(nj[name]).max())
        np.testing.assert_allclose(nt[name], nj[name], rtol=GRAD_RTOL,
                                   atol=ATOL * scale + 1e-12, err_msg=name)


@pytest.mark.parametrize("loss_kernel", [False, True],
                         ids=["chunked", "fused"])
def test_train_step_matches_jax(model, loss_kernel):
    """One Stage-2 `make_train_step` (frames, decoder tokens and targets,
    a loss mask): loss, aux and grad norm within 1e-5, and every gradient
    leaf of `make_loss_fn` against jax.grad of JAX's, the encoder subtree
    included. Parameters after the step are not compared (AdamW's
    first-step sign noise, ROADMAP.md §3)."""
    cfg, tcfg, jparams, _, frames = model
    rng = np.random.default_rng(6)
    B, S = 4, 6
    tokens = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    logits = np.asarray(jenc.forward(jparams, cfg, jnp.asarray(frames),
                                     jnp.asarray(tokens), CTX))
    targets = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    hit = rng.random((B, S)) < 0.5
    targets[hit] = logits.argmax(-1)[hit]
    batch = {"frames": frames, "tokens": tokens, "targets": targets,
             "loss_mask": (rng.random((B, S)) > 0.2).astype(np.float32)}
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    jstep = jsteps.make_train_step(cfg, CTX, JGK(alpha=0.3),
                                   joptim.AdamWConfig(**OPT))
    tstep = tsteps.make_train_step(tcfg, TGK(alpha=0.3),
                                   toptim.AdamWConfig(**OPT),
                                   loss_kernel=loss_kernel)
    _, _, mj = jstep(jparams, joptim.adamw_init(jparams), jb)
    tp = params_from_jax(jparams, "cpu")
    _, _, mt = tstep(tp, toptim.adamw_init(tp), tb)
    assert set(mt) == set(mj)
    for k in mj:
        assert abs(float(mt[k]) - float(mj[k])) <= ATOL * max(
            1.0, abs(float(mj[k]))), (k, float(mt[k]), float(mj[k]))
    assert 0.2 < float(mt["frac_correct"]) < 0.8

    def j_loss(params):
        x, model_aux, mask = jsteps._final_hidden(params, cfg, jb, CTX)
        table = params.get("unembed", params["embedding"])
        loss, _ = jsteps.chunked_gatekeeper_loss(
            x, table, jsteps._pad_targets(cfg, jb, x.shape[1]),
            JGK(alpha=0.3), mask)
        return loss + 0.01 * model_aux
    gj = jax.grad(j_loss)(jparams)
    t_loss = tsteps.make_loss_fn(tcfg, TGK(alpha=0.3), 0.01, loss_kernel)
    _, gt = toptim.value_and_grad(t_loss, params_from_jax(jparams, "cpu"),
                                  tb)
    _assert_grads(gj, gt)


def test_convert_carries_the_encoder_subtree(model):
    """`params_from_jax` is generic: the converted tree has the port's
    init layout (the encoder's stack, final norm, cross and cross_norm
    included), every leaf equal to JAX's with its dtype and shape."""
    cfg, tcfg, jparams, tparams, _ = model
    own = ttfm.init_params(tcfg, 0, "cpu")
    assert _shapes(own) == _shapes(tparams)
    assert set(tparams["encoder"]) == {"stack", "final_norm", "cross",
                                       "cross_norm"}
    assert set(tparams["encoder"]["stack"]["mlp"]) == {"w_up", "w_down",
                                                       "b_up", "b_down"}
    assert tparams["encoder"]["cross"]["wq"].shape == (
        cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.head_dim)
    assert tparams["encoder"]["cross_norm"].shape == (cfg.n_layers,
                                                      cfg.d_model)
    for name, leaf in _named(jparams).items():
        got = _named(tparams)[name]
        assert got.dtype == torch.float32 and tuple(got.shape) == leaf.shape
        np.testing.assert_array_equal(got.numpy(), np.asarray(leaf))


def test_full_width_structure_from_shapes():
    """At published width, from shapes alone (the "meta" device, JAX's
    abstract init): the parameter tree equals JAX's and counts its
    277,985,280 parameters (1.04 GiB in fp32); the cache is the decoder's
    K/V [12, B, S, 12, 64] and cross_kv [12, B, 1500, 12, 64]."""
    tcfg = t_get_config(ARCH)
    tp = ttfm.init_params(tcfg, 0, "meta")
    jp = jtfm.init_params(get_config(ARCH), jax.random.PRNGKey(0),
                          abstract=True)
    jshapes = jax.tree.map(lambda a: tuple(a.shape), jp,
                           is_leaf=lambda a: hasattr(a, "logical_axes"))
    assert _shapes(tp) == {k: v for k, v in _named(jshapes).items()}
    assert sum(t.numel() for t in _named(tp).values()) == FULL_PARAMS
    tc = tenc.init_cache(tcfg, 8, 32, device="meta")
    assert _shapes(tc) == {"/cross_kv/k": (12, 8, 1500, 12, 64),
                           "/cross_kv/v": (12, 8, 1500, 12, 64),
                           "/dense/k": (12, 8, 32, 12, 64),
                           "/dense/v": (12, 8, 32, 12, 64)}
    assert tc["cross_kv"]["k"].dtype == torch.bfloat16


def test_serve_engine_and_clis_refuse_the_family(capsys):
    """The serving engine, the serve CLI and the train CLI take token
    prompts only, as the JAX package's do: whisper-small is refused by
    name, pointing at launch.steps and ROADMAP.md."""
    tcfg = t_reduced(t_get_config(ARCH))
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        ModelRunner(tcfg, ttfm.init_params(tcfg, 0, "cpu"))
    for main in (tserve.main, ttrain.main):
        with pytest.raises(SystemExit) as exc:
            main(["--device", "cpu", "--arch", ARCH])
        assert exc.value.code == 2
        err = capsys.readouterr().err
        assert "launch.steps" in err and "ROADMAP.md" in err
    with pytest.raises(ValueError, match="models.encdec"):
        ttfm.prefill(ttfm.init_params(tcfg, 0, "cpu"), tcfg,
                     torch.zeros((1, 2), dtype=torch.long),
                     ttfm.init_cache(tcfg, 1, 2, device="cpu"))
