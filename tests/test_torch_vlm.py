"""The port's vision-language decoder (phi-3-vision-4.2b, stub frontend)
on the CPU against the JAX package, on the reduced fp32 config with JAX
weights carried over by `params_from_jax` and inputs from numpy seeds:
the config, `forward` and `prefill` + `decode_step` with patch
embeddings prepended, `launch.steps`' make_prefill / make_serve_step
(greedy tokens and defer masks equal, confidences within 1e-5) and
make_train_step's loss terms and gradients leaf by leaf with the patch
positions masked out of the loss, the kernel switch forced both ways (on
CPU tensors the kernels' wrappers run their plain versions); the caption
generator's layout and constants, and `caption_factuality` equal to
JAX's on JAX's arrays; the full-width structure from shapes alone.

Tolerances: ATOL 1e-5 on confidences and loss terms (fp32 on both
sides, sums in other orders); LOGIT_ATOL 1e-4 on logits over the
512-token vocabulary; gradients within 1e-5 of each leaf's largest entry
plus rtol 1e-4.
"""
import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from repro.configs import get_config, reduced
from repro.core.gatekeeper import GatekeeperConfig as JGK
from repro.data import synthetic as jsyn
from repro.launch import steps as jsteps
from repro.models import transformer as jtfm
from repro.sharding import ParallelContext
from repro.training import optim as joptim
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs import reduced as t_reduced
from repro_torch.convert import params_from_jax
from repro_torch.core.gatekeeper import GatekeeperConfig as TGK
from repro_torch.data import synthetic as tsyn
from repro_torch.launch import serve as tserve
from repro_torch.launch import steps as tsteps
from repro_torch.launch import train as ttrain
from repro_torch.models import transformer as ttfm
from repro_torch.serving import ModelRunner
from repro_torch.training import optim as toptim

torch.set_num_threads(1)
CTX = ParallelContext()
ARCH = "phi-3-vision-4.2b"
ATOL = 1e-5
LOGIT_ATOL = 1e-4
GRAD_RTOL = 1e-4
OPT = dict(lr=1e-3, warmup_steps=2, total_steps=10)
FULL_PARAMS = 3_821_079_552   # JAX's abstract init of phi-3-vision-4.2b


def _named(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_named(tree[k], f"{prefix}/{k}"))
        return out
    return {prefix: tree}


@pytest.fixture(scope="module")
def model():
    """(JAX cfg, port cfg, JAX params as numpy, port params, patches
    [4, 8, d] from the port's caption generator)."""
    cfg, tcfg = reduced(get_config(ARCH)), t_reduced(t_get_config(ARCH))
    jparams = jax.device_get(jtfm.init_params(cfg, jax.random.PRNGKey(0)))
    data = tsyn.make_captions(1, 4, n_patches=cfg.vision.n_patches,
                              d_model=cfg.d_model)
    return cfg, tcfg, jparams, params_from_jax(jparams, "cpu"), data.patches


@pytest.mark.parametrize("reduce", [False, True], ids=["full", "reduced"])
def test_config_matches_jax(reduce):
    """Every field the port's ModelConfig has equals JAX's, the vision
    spec included, at published width and reduced (VisionSpec(8))."""
    cfg, tcfg = get_config(ARCH), t_get_config(ARCH)
    if reduce:
        cfg, tcfg = reduced(cfg), t_reduced(tcfg)
    for f in dataclasses.fields(tcfg):
        got, want = getattr(tcfg, f.name), getattr(cfg, f.name)
        if dataclasses.is_dataclass(want):
            got, want = dataclasses.asdict(got), dataclasses.asdict(want)
        assert got == want, f.name
    assert tcfg.vision.n_patches == (8 if reduce else 576)
    assert tcfg.family == "vlm" and tcfg.encoder is None


def test_forward_with_patches_matches_jax(model):
    """Logits [B, P + T, V] of the patches prepended to the tokens."""
    cfg, tcfg, jparams, tparams, patches = model
    toks = np.random.default_rng(3).integers(
        0, cfg.vocab_size, (4, 5)).astype(np.int32)
    want = jtfm.forward(jparams, cfg, jnp.asarray(toks), CTX,
                        extra_embeds=jnp.asarray(patches))
    with torch.no_grad():
        got = ttfm.forward(tparams, tcfg, torch.from_numpy(toks),
                           extra_embeds=torch.from_numpy(patches))
    assert got.shape == (4, 8 + 5, cfg.vocab_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=LOGIT_ATOL, rtol=0)


@pytest.mark.parametrize("kernel", [False, True], ids=["plain", "kernel"])
def test_prefill_and_decode_match_forward(model, kernel):
    """Prefill of the patches and T - 1 tokens then one decode step at
    position P + T - 1, against the full forward's logits (JAX's and the
    port's) and JAX's own prefill."""
    cfg, tcfg, jparams, tparams, patches = model
    P, T = cfg.vision.n_patches, 6
    toks = np.random.default_rng(4).integers(
        0, cfg.vocab_size, (4, T)).astype(np.int32)
    full = np.asarray(jtfm.forward(jparams, cfg, jnp.asarray(toks), CTX,
                                   extra_embeds=jnp.asarray(patches)))
    jcache = jtfm.init_cache(cfg, 4, P + T + 1)
    jlg, _ = jtfm.prefill(jparams, cfg, jnp.asarray(toks[:, :T - 1]), jcache,
                          CTX, jnp.asarray(patches))
    cache = ttfm.init_cache(tcfg, 4, P + T + 1, device="cpu")
    lg, cache = ttfm.prefill(tparams, tcfg, torch.from_numpy(toks[:, :T - 1]),
                             cache, paged_kernel=kernel,
                             extra_embeds=torch.from_numpy(patches))
    step, _ = ttfm.decode_step(tparams, tcfg, torch.from_numpy(toks[:, T - 1]),
                               P + T - 1, cache, paged_kernel=kernel)
    np.testing.assert_allclose(lg.numpy(), np.asarray(jlg), atol=LOGIT_ATOL,
                               rtol=0)
    np.testing.assert_allclose(lg.numpy(), full[:, :P + T - 1],
                               atol=LOGIT_ATOL, rtol=0)
    np.testing.assert_allclose(step.numpy(), full[:, -1], atol=LOGIT_ATOL,
                               rtol=0)


@pytest.mark.parametrize("kernel", [False, True], ids=["plain", "kernel"])
def test_prefill_and_serve_steps_match_jax(model, kernel):
    """make_prefill of patches + a BOS prompt, then three make_serve_step
    steps, against JAX's builders: greedy tokens and defer masks exact,
    confidences within 1e-5; tau midway between two of JAX's prefill
    confidences."""
    cfg, tcfg, jparams, tparams, patches = model
    B, steps = 4, 3
    P = cfg.vision.n_patches
    prompts = np.full((B, 1), tsyn.BOS, np.int32)
    jcache = jtfm.init_cache(cfg, B, P + 1 + steps)
    jtok, jnent, jcache = jsteps.make_prefill(cfg, CTX)(
        jparams, jcache, {"tokens": jnp.asarray(prompts),
                          "patches": jnp.asarray(patches)})
    tcache = ttfm.init_cache(tcfg, B, P + 1 + steps, device="cpu")
    ttok, tnent, tcache = tsteps.make_prefill(tcfg, paged_kernel=kernel)(
        tparams, tcache, {"tokens": torch.from_numpy(prompts),
                          "patches": torch.from_numpy(patches)})
    np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
    np.testing.assert_allclose(tnent.numpy(), np.asarray(jnent), atol=ATOL,
                               rtol=0)
    conf0 = np.sort(np.asarray(jnent))
    tau = float(0.5 * (conf0[1] + conf0[2]))
    jstep = jsteps.make_serve_step(cfg, CTX, tau=tau)
    tstep = tsteps.make_serve_step(tcfg, tau=tau, paged_kernel=kernel)
    jt, tt = jtok.astype(jnp.int32), ttok
    for i in range(steps):
        jt, jc, jd, jcache = jstep(jparams, jcache, jt, P + 1 + i)
        tt, tc, td, tcache = tstep(tparams, tcache, tt, P + 1 + i)
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
        np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=ATOL,
                                   rtol=0)
        np.testing.assert_array_equal(td.numpy(), np.asarray(jd))


def _assert_grads(gj, gt):
    nj = {k: np.asarray(v) for k, v in _named(gj).items()}
    nt = {k: v.numpy() for k, v in _named(gt).items()}
    assert nj.keys() == nt.keys()
    for name in nj:
        scale = float(np.abs(nj[name]).max())
        np.testing.assert_allclose(nt[name], nj[name], rtol=GRAD_RTOL,
                                   atol=ATOL * scale + 1e-12, err_msg=name)


@pytest.mark.parametrize("loss_kernel,loss_mask",
                         [(False, False), (True, False), (True, True)],
                         ids=["chunked", "fused", "fused-loss-mask"])
def test_train_step_matches_jax(model, loss_kernel, loss_mask):
    """One Stage-2 `make_train_step` on caption batches (patches, inputs,
    targets padded in front; the patch positions out of the loss, times a
    [B, P + T] loss mask when given): loss, aux and grad norm within 1e-5,
    and every gradient leaf against jax.grad of JAX's loss. Parameters
    after the step are not compared (ROADMAP.md §3)."""
    cfg, tcfg, jparams, _, _ = model
    P = cfg.vision.n_patches
    data = tsyn.make_captions(2, 6, n_patches=P, d_model=cfg.d_model,
                              hard_frac=0.0)
    batch = {"patches": data.patches, "tokens": data.inputs,
             "targets": data.targets}
    if loss_mask:
        batch["loss_mask"] = (np.random.default_rng(7).random(
            (6, P + 3)) > 0.3).astype(np.float32)
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

    def j_loss(params):
        x, model_aux, mask = jsteps._final_hidden(params, cfg, jb, CTX)
        loss, _ = jsteps.chunked_gatekeeper_loss(
            x, params.get("unembed", params["embedding"]),
            jsteps._pad_targets(cfg, jb, x.shape[1]), JGK(alpha=0.3), mask)
        return loss + 0.01 * model_aux
    gj = jax.grad(j_loss)(jparams)
    t_loss = tsteps.make_loss_fn(tcfg, TGK(alpha=0.3), 0.01, loss_kernel)
    _, gt = toptim.value_and_grad(t_loss, params_from_jax(jparams, "cpu"),
                                  tb)
    _assert_grads(gj, gt)


def test_patch_positions_leave_the_loss():
    """`_final_hidden`'s mask: 0 on the P patch positions, 1 after (times
    a loss mask); the targets are padded with P zeros in front."""
    tcfg = t_reduced(t_get_config(ARCH))
    params = ttfm.init_params(tcfg, 0, "cpu")
    P = tcfg.vision.n_patches
    data = tsyn.make_captions(3, 2, n_patches=P, d_model=tcfg.d_model)
    batch = {"patches": torch.from_numpy(data.patches),
             "tokens": torch.from_numpy(data.inputs),
             "targets": torch.from_numpy(data.targets)}
    with torch.no_grad():
        x, _, mask = tsteps._final_hidden(params, tcfg, batch)
    assert x.shape == (2, P + 3, tcfg.d_model)
    assert mask[:, :P].sum() == 0 and bool((mask[:, P:] == 1).all())
    tgt = tsteps._pad_targets(tcfg, batch, x.shape[1])
    assert tgt.shape == (2, P + 3) and int(tgt[:, :P].abs().sum()) == 0
    lm = torch.ones((2, P + 3))
    lm[:, -1] = 0
    with torch.no_grad():
        _, _, mask2 = tsteps._final_hidden(params, tcfg,
                                           {**batch, "loss_mask": lm})
    assert mask2[:, :P].sum() == 0 and mask2[:, -1].sum() == 0
    assert bool((mask2[:, P:-1] == 1).all())


def test_make_captions_layout_and_constants():
    """JAX's layout and constants: 12 classes, 6 attributes, hard_frac 0.4,
    noise 5.0 / 0.3 about class + 0.5 x attribute embeddings, captions
    [BOS, 6 + cls, 6 + 12 + attr, SEP], vocab 24; task embeddings from
    task_seed alone, samples from the seed."""
    a = tsyn.make_captions(0, 4000, n_patches=4, d_model=16)
    b = tsyn.make_captions(1, 4000, n_patches=4, d_model=16)
    j = jsyn.make_captions(jax.random.PRNGKey(0), 8, n_patches=4, d_model=16)
    assert a.vocab == j.vocab == 24
    for d in (a, j):
        assert d.patches.shape[1:] == (4, 16) and d.patches.dtype == np.float32
        assert d.tokens.shape[1] == 4 and d.tokens.dtype == np.int32
        assert (d.tokens[:, 0] == tsyn.BOS).all()
        assert (d.tokens[:, 3] == tsyn.SEP).all()
        np.testing.assert_array_equal(d.tokens[:, 1], 6 + d.classes)
        np.testing.assert_array_equal(d.tokens[:, 2], 18 + d.attrs)
        np.testing.assert_array_equal(d.inputs, d.tokens[:, :-1])
        np.testing.assert_array_equal(d.targets, d.tokens[:, 1:])
    assert set(a.classes) == set(range(12)) and set(a.attrs) == set(range(6))
    # the class / attribute embeddings come from task_seed alone
    cls_emb = np.random.default_rng(1234).standard_normal((12, 16))
    attr_emb = np.random.default_rng([1234, 1]).standard_normal((6, 16))
    for d in (a, b):
        resid = (d.patches - cls_emb[d.classes][:, None]
                 - 0.5 * attr_emb[d.attrs][:, None])
        std = resid.std(axis=(1, 2))
        hard = std > 1.5
        assert abs(hard.mean() - 0.4) < 0.03
        assert abs(np.median(std[hard]) - 5.0) < 0.5
        assert abs(np.median(std[~hard]) - 0.3) < 0.05
    again = tsyn.make_captions(0, 4000, n_patches=4, d_model=16)
    np.testing.assert_array_equal(again.patches, a.patches)
    assert not np.array_equal(a.classes, b.classes)


@pytest.mark.parametrize("drop_top", [False, True],
                         ids=["all-classes", "no-top-class"])
def test_caption_factuality_matches_jax(drop_top):
    """On JAX's own arrays, equal to JAX's score, a split that lacks the
    top class included (its attribute base then shifts, in both)."""
    j = jsyn.make_captions(jax.random.PRNGKey(5), 64, n_patches=2,
                           d_model=8)
    if drop_top:
        keep = j.classes != j.classes.max()
        j = jsyn.CaptionData(j.patches[keep], j.tokens[keep],
                             j.classes[keep], j.attrs[keep], j.vocab)
    rng = np.random.default_rng(8)
    pred = j.tokens[:, 1:3].copy()
    flip = rng.random(pred.shape) < 0.3
    pred[flip] = rng.integers(0, j.vocab, flip.sum())
    t = tsyn.CaptionData(j.patches, j.tokens, j.classes, j.attrs, j.vocab)
    got = tsyn.caption_factuality(pred, t)
    np.testing.assert_array_equal(got, jsyn.caption_factuality(pred, j))
    assert 0 < got.mean() < 1


def test_full_width_structure_from_shapes():
    """At published width, from shapes alone (the "meta" device, JAX's
    abstract init): the parameter tree equals JAX's and counts its
    3,821,079,552 parameters (14.2 GiB in fp32)."""
    tp = ttfm.init_params(t_get_config(ARCH), 0, "meta")
    jp = jtfm.init_params(get_config(ARCH), jax.random.PRNGKey(0),
                          abstract=True)
    jshapes = jax.tree.map(lambda a: tuple(a.shape), jp,
                           is_leaf=lambda a: hasattr(a, "logical_axes"))
    assert {k: tuple(v.shape) for k, v in _named(tp).items()} == \
        _named(jshapes)
    assert sum(t.numel() for t in _named(tp).values()) == FULL_PARAMS


def test_serve_engine_and_clis_refuse_the_family(capsys):
    tcfg = t_reduced(t_get_config(ARCH))
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        ModelRunner(tcfg, ttfm.init_params(tcfg, 0, "cpu"))
    for main in (tserve.main, ttrain.main):
        with pytest.raises(SystemExit) as exc:
            main(["--device", "cpu", "--arch", ARCH])
        assert exc.value.code == 2
        err = capsys.readouterr().err
        assert "patches" in err and "ROADMAP.md" in err
