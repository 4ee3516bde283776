"""Training the recurrent and windowed models in the port on the CPU
against the JAX package.

One Stage-1 step (CE on full logits) and one Stage-2 step (the chunked
Gatekeeper loss, and the fused loss's autograd function) on reduced
rwkv6-3b and zamba2-1.2b, each at a T its block's chunk divides (the
chunked recurrence: 32 for RWKV6, 64 for Mamba2) and at a T it does not
(the per-step scan), and on reduced internlm2-1.8b with a sliding window
of 8 at T 16; JAX weights carried over by `params_from_jax`, the same
numpy batch. Loss, aux and grad norm within 1e-5, every gradient leaf
within ``1e-5 * max|g_leaf|`` plus rtol 1e-4 (as
tests/test_torch_training.py holds the dense models). Also: the training
gate, a mirror of JAX's `test_smoke_train_step` over all ten reduced
archs, `wkv_scan_fused`'s gradients (float64 `gradcheck`, and against
`jax.grad` of JAX's `linear_attention_chunked`), and the train CLI on
both recurrent archs.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from repro.configs import ARCH_IDS, get_config, reduced
from repro.core import gatekeeper as jgk_lib
from repro.core.gatekeeper import GatekeeperConfig as JGK
from repro.launch import steps as jsteps
from repro.models import ssm as jssm
from repro.models import transformer as jtfm
from repro.sharding import ParallelContext
from repro.training import loop as jloop
from repro.training import optim as joptim
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs import reduced as t_reduced
from repro_torch.convert import params_from_jax
from repro_torch.core.gatekeeper import GatekeeperConfig as TGK
from repro_torch.kernels import wkv_scan as wk
from repro_torch.launch import steps as tsteps
from repro_torch.launch import train as ttrain
from repro_torch.models import transformer as ttfm
from repro_torch.training import loop as tloop
from repro_torch.training import optim as toptim

torch.set_num_threads(1)
CTX = ParallelContext()
ATOL = 1e-5
GRAD_RTOL = 1e-4
OPT = dict(lr=1e-3, warmup_steps=2, total_steps=10)
WINDOW = 8
# (arch, T, sliding window): T 32 / 64 the chunk divides, T 12 it does not
CASES = [("rwkv6-3b", 32, None), ("rwkv6-3b", 12, None),
         ("zamba2-1.2b", 64, None), ("zamba2-1.2b", 12, None),
         ("internlm2-1.8b", 16, WINDOW)]
CASE_IDS = ["rwkv-chunked", "rwkv-scan", "zamba2-chunked", "zamba2-scan",
            "internlm2-window8"]


def _named(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_named(tree[k], f"{prefix}/{k}"))
        return out
    return {prefix: np.asarray(tree)}


@pytest.fixture(scope="module", params=CASES, ids=CASE_IDS)
def model(request):
    """(JAX cfg, port cfg, JAX params, a batch of B 4 x T whose targets
    hit the model's argmax at about half the positions, no near-ties)."""
    arch, T, window = request.param
    cfg = reduced(get_config(arch)).replace(sliding_window=window)
    tcfg = t_reduced(t_get_config(arch)).replace(sliding_window=window)
    jparams = jax.device_get(jtfm.init_params(cfg, jax.random.PRNGKey(0)))
    rng = np.random.default_rng(1)
    B = 4
    tokens = rng.integers(0, cfg.vocab_size, size=(B, T)).astype(np.int32)
    logits = np.asarray(jtfm.forward(jparams, cfg, jnp.asarray(tokens), CTX))
    top2 = np.sort(logits, axis=-1)[..., -2:]
    assert (top2[..., 1] - top2[..., 0]).min() > 1e-5, "near-tie: new seed"
    targets = rng.integers(0, cfg.vocab_size, size=(B, T)).astype(np.int32)
    hit = rng.random((B, T)) < 0.5
    targets[hit] = logits.argmax(-1)[hit]
    mask = (rng.random((B, T)) > 0.2).astype(np.float32)
    batch = {"tokens": tokens, "targets": targets, "loss_mask": mask}
    return cfg, tcfg, jparams, batch


def _tparams(jparams):
    return params_from_jax(jparams, device="cpu")


def _tbatch(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def _assert_grads(gj, gt):
    nj, nt = _named(gj), _named(toptim.tree_map(lambda g: g.numpy(), gt))
    assert nj.keys() == nt.keys()
    for name in nj:
        scale = float(np.abs(nj[name]).max())
        np.testing.assert_allclose(nt[name], nj[name], rtol=GRAD_RTOL,
                                   atol=ATOL * scale + 1e-12, err_msg=name)


def _assert_metrics(mj, mt, keys):
    for k in keys:
        assert abs(float(mt[k]) - float(mj[k])) <= ATOL * max(
            1.0, abs(float(mj[k]))), (k, float(mt[k]), float(mj[k]))


# ---------------------------------------------------------------------------
# The gate
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,window", [("rwkv6-3b", None),
                                         ("zamba2-1.2b", None),
                                         ("internlm2-1.8b", 64),
                                         ("qwen1.5-4b", 4096)])
def test_training_gate_passes_recurrent_and_windowed(arch, window):
    """RWKV6, the Mamba2 hybrid and a sliding window on GQA train, at
    published width and reduced; a window on MLA stays refused (JAX's
    `mla_forward` has none)."""
    cfg = t_get_config(arch).replace(sliding_window=window)
    ttfm.check_ported(cfg, training=True)
    ttfm.check_ported(t_reduced(cfg), training=True)
    ttfm.check_ported(cfg, training=True, engine=True)
    mla = t_get_config("deepseek-v2-236b").replace(sliding_window=window
                                                   or 64)
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        ttfm.check_ported(mla, training=True)


# ---------------------------------------------------------------------------
# Steps against JAX
# ---------------------------------------------------------------------------

def test_stage1_step_matches_jax(model):
    """`training.loop`'s CE step on full logits, the trainer's Stage 1:
    its metrics and every gradient leaf."""
    cfg, tcfg, jparams, batch = model
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jb["inputs"] = jb["tokens"]
    tb = _tbatch(batch)
    tb["inputs"] = tb["tokens"]
    j_apply = lambda p, b: jtfm.forward(p, cfg, b["inputs"], CTX,  # noqa: E731
                                        return_aux=True)
    t_apply = lambda p, b: ttfm.forward(p, tcfg, b["inputs"],  # noqa: E731
                                        return_aux=True)
    jstep = jloop.make_train_step(j_apply, joptim.AdamWConfig(**OPT),
                                  loss_kind="ce", aux_weight=0.01)
    tstep = tloop.make_train_step(t_apply, toptim.AdamWConfig(**OPT),
                                  loss_kind="ce", aux_weight=0.01)
    _, _, mj = jstep(jparams, joptim.adamw_init(jparams), jb)
    tp = _tparams(jparams)
    _, _, mt = tstep(tp, toptim.adamw_init(tp), tb)
    assert set(mt) == set(mj)
    _assert_metrics(mj, mt, mj)

    def j_loss(p):
        logits, aux = j_apply(p, jb)
        loss, _ = jgk_lib.standard_ce_loss(logits, jb["targets"],
                                           jb["loss_mask"])
        return loss + 0.01 * aux
    gj = jax.grad(j_loss)(jparams)
    t_loss = tloop.make_loss_fn(t_apply, "ce", aux_weight=0.01)
    _, gt = toptim.value_and_grad(t_loss, _tparams(jparams), tb)
    _assert_grads(gj, gt)


def _jax_stage2_grads(cfg, jparams, jb, alpha):
    def loss_fn(params):
        x, model_aux, mask = jsteps._final_hidden(params, cfg, jb, CTX)
        table = params.get("unembed", params["embedding"])
        loss, aux = jsteps.chunked_gatekeeper_loss(
            x, table, jsteps._pad_targets(cfg, jb, x.shape[1]),
            JGK(alpha=alpha), mask)
        return loss + 0.01 * model_aux, aux
    return jax.value_and_grad(loss_fn, has_aux=True)(jparams)


@pytest.fixture(scope="module")
def stage2_ref(model):
    """JAX's Stage-2 step metrics and loss gradients on `model`, once for
    both loss paths of the port."""
    cfg, _, jparams, batch = model
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jstep = jsteps.make_train_step(cfg, CTX, JGK(alpha=0.3),
                                   joptim.AdamWConfig(**OPT))
    _, _, mj = jstep(jparams, joptim.adamw_init(jparams), jb)
    (_, _), gj = _jax_stage2_grads(cfg, jparams, jb, 0.3)
    return jax.device_get(mj), jax.device_get(gj)


@pytest.mark.parametrize("loss_kernel", [False, True],
                         ids=["chunked", "fused"])
def test_stage2_step_matches_jax(model, stage2_ref, loss_kernel):
    """The Stage-2 step through the chunked loss and through the fused
    loss's autograd function (its plain forward on the CPU)."""
    _, tcfg, jparams, batch = model
    mj, gj = stage2_ref
    tb = _tbatch(batch)
    tstep = tsteps.make_train_step(tcfg, TGK(alpha=0.3),
                                   toptim.AdamWConfig(**OPT),
                                   loss_kernel=loss_kernel)
    tp = _tparams(jparams)
    _, _, mt = tstep(tp, toptim.adamw_init(tp), tb)
    assert set(mt) == set(mj)
    _assert_metrics(mj, mt, mj)
    assert 0.2 < float(mt["frac_correct"]) < 0.8      # both branches live
    t_loss = tsteps.make_loss_fn(tcfg, TGK(alpha=0.3), 0.01, loss_kernel)
    _, gt = toptim.value_and_grad(t_loss, _tparams(jparams), tb)
    _assert_grads(gj, gt)


# ---------------------------------------------------------------------------
# Mirror of tests/test_models_smoke.py::test_smoke_train_step
# ---------------------------------------------------------------------------

def _smoke_batch(cfg, key, B=2, T=16):
    """tests/test_models_smoke.py's `_batch_for`, as numpy."""
    b = {}
    if cfg.family == "vlm":
        P = cfg.vision.n_patches
        b["tokens"] = jax.random.randint(key, (B, T - P), 0, cfg.vocab_size)
        b["patches"] = jax.random.normal(key, (B, P, cfg.d_model))
    else:
        b["tokens"] = jax.random.randint(key, (B, T), 0, cfg.vocab_size)
    if cfg.family == "encdec":
        b["frames"] = jax.random.normal(key, (B, cfg.encoder.n_frames,
                                              cfg.d_model))
    b["targets"] = jax.random.randint(key, (B, T), 0, cfg.vocab_size)
    return {k: torch.from_numpy(np.array(v)) for k, v in b.items()}


@pytest.mark.parametrize("arch", [a.replace("_", "-") for a in ARCH_IDS])
def test_smoke_train_step(arch):
    """One Stage-2 step of every reduced arch from JAX's weights and
    batch (PRNGKey(1)): the loss is finite, the parameters move, and no
    parameter turns NaN."""
    cfg = reduced(get_config(arch))
    key = jax.random.PRNGKey(1)
    params = _tparams(jax.device_get(jtfm.init_params(cfg, key)))
    before = [t.clone() for t in toptim.tree_leaves(params)]
    step = tsteps.make_train_step(
        t_reduced(t_get_config(arch)), TGK(alpha=0.3),
        toptim.AdamWConfig(lr=1e-3, total_steps=10))
    new, _, metrics = step(params, toptim.adamw_init(params),
                           _smoke_batch(cfg, key))
    assert np.isfinite(float(metrics["loss"]))
    after = toptim.tree_leaves(new)
    assert sum(float((a - b).abs().sum()) for a, b in zip(after, before)) > 0
    assert all(not bool(torch.isnan(t).any()) for t in after)


# ---------------------------------------------------------------------------
# wkv_scan_fused: the recurrence under autograd
# ---------------------------------------------------------------------------

def _wkv_inputs(mode, B, T, H, K, V, dtype, seed):
    g = torch.Generator().manual_seed(seed)

    def rnd(*shape, scale=1.0):
        return torch.randn(shape, generator=g, dtype=torch.float64) * scale
    Kw = K if mode == "rwkv" else 1
    ins = {"q": rnd(B, T, H, K, scale=0.5), "k": rnd(B, T, H, K, scale=0.5),
           "v": rnd(B, T, H, V, scale=0.5),
           "logw": -(torch.rand((B, T, H, Kw), generator=g,
                                dtype=torch.float64) * 0.95 + 0.05),
           "u": rnd(H, K, scale=0.3) if mode == "rwkv" else None,
           "state0": rnd(B, H, K, V, scale=0.2)}
    return {k: None if v is None else v.to(dtype) for k, v in ins.items()}


@pytest.mark.parametrize("T", [8, 6], ids=["chunked", "scan"])
@pytest.mark.parametrize("mode", ["rwkv", "mamba"])
def test_wkv_scan_fused_gradcheck_float64(mode, T):
    """`gradcheck` in float64 at a tiny size: `wkv_scan_fused` on CPU
    tensors (the plain recurrence under autograd) and its autograd
    Function's recompute-and-differentiate backward (its forward through
    `wkv_scan`'s CPU path), chunk 4: T 8 chunked, T 6 the per-step
    scan."""
    ins = _wkv_inputs(mode, 1, T, 2, 4, 3, torch.float64, seed=T)
    names = [n for n in ("q", "k", "v", "logw", "u", "state0")
             if ins[n] is not None]
    args = tuple(ins[n].requires_grad_(True) for n in names)

    def call(fn):
        def f(*a):
            kw = dict(zip(names, a))
            return fn(kw["q"], kw["k"], kw["v"], kw["logw"], kw.get("u"),
                      kw["state0"])
        return f
    assert torch.autograd.gradcheck(call(
        lambda *a: wk.wkv_scan_fused(*a, mode=mode, chunk=4)), args)
    assert torch.autograd.gradcheck(call(
        lambda *a: wk._WKVScanFused.apply(*a, mode, 4)), args)


@pytest.mark.parametrize("mode", ["rwkv", "mamba"])
def test_wkv_scan_fused_grads_match_jax(mode):
    """Gradients of sum(y * gy) + sum(S * gS) through `wkv_scan_fused`
    (fp32, chunk 32, T 64) against `jax.grad` of JAX's
    `linear_attention_chunked`, within 1e-5 of each gradient's largest
    entry."""
    ins = _wkv_inputs(mode, 2, 64, 3, 16, 8, torch.float32, seed=5)
    g = torch.Generator().manual_seed(6)
    gy = torch.randn((2, 64, 3, 8), generator=g)
    gs = torch.randn((2, 3, 16, 8), generator=g)
    names = [n for n in ("q", "k", "v", "logw", "u", "state0")
             if ins[n] is not None]

    def j_obj(*a):
        kw = dict(zip(names, a))
        y, s = jssm.linear_attention_chunked(
            kw["q"], kw["k"], kw["v"], kw["logw"], kw["state0"], mode=mode,
            u=kw.get("u"), chunk=32)
        return jnp.sum(y * gy.numpy()) + jnp.sum(s * gs.numpy())
    gj = jax.grad(j_obj, argnums=tuple(range(len(names))))(
        *(jnp.asarray(ins[n].numpy()) for n in names))
    targs = [ins[n].clone().requires_grad_(True) for n in names]
    kw = dict(zip(names, targs))
    y, s = wk.wkv_scan_fused(kw["q"], kw["k"], kw["v"], kw["logw"],
                             kw.get("u"), kw["state0"], mode=mode, chunk=32)
    ((y * gy).sum() + (s * gs).sum()).backward()
    for n, t, want in zip(names, targs, gj):
        want = np.asarray(want)
        np.testing.assert_allclose(t.grad.numpy(), want, rtol=GRAD_RTOL,
                                   atol=ATOL * float(np.abs(want).max()),
                                   err_msg=n)


@pytest.mark.parametrize("mode", ["rwkv", "mamba"])
def test_chunked_gradient_finite_at_strong_decays(mode):
    """Decays of 5 to 60 nats a token sum past fp32's exp range inside a
    chunk of 32: the chunked recurrence's values still equal JAX's, and
    its gradients, which JAX's formula turns to NaN there (the masked
    pairs' exp overflows before the mask selects 0), are finite and equal
    the per-step scan's. Sums of decays near 1,900 nats keep about 1e-4
    absolute in fp32, so y is held to JAX's at tests/test_kernels.py's
    5e-4 and the gradients to 1e-4 of each one's largest entry (readings:
    y 1.1e-4 from JAX's chunked form, whose own scan differs by 9.2e-5;
    logw's gradient 2.7e-5 of its largest)."""
    ins = _wkv_inputs(mode, 2, 64, 3, 8, 4, torch.float32, seed=9)
    g = torch.Generator().manual_seed(10)
    ins["logw"] = -(5.0 + 55.0 * torch.rand(ins["logw"].shape, generator=g))
    names = [n for n in ("q", "k", "v", "logw", "u", "state0")
             if ins[n] is not None]
    gy = torch.randn((2, 64, 3, 4), generator=g)
    want_y, _ = jssm.linear_attention_chunked(
        *(jnp.asarray(ins[n].numpy()) for n in ("q", "k", "v", "logw",
                                                "state0")),
        mode=mode, u=None if ins["u"] is None else jnp.asarray(
            ins["u"].numpy()), chunk=32)
    grads = {}
    for chunk in (32, 7):               # 7 divides no T here: the scan
        leaves = {n: ins[n].clone().requires_grad_(True) for n in names}
        y, s = wk.wkv_scan_fused(leaves["q"], leaves["k"], leaves["v"],
                                 leaves["logw"], leaves.get("u"),
                                 leaves["state0"], mode=mode, chunk=chunk)
        if chunk == 32:
            np.testing.assert_allclose(y.detach().numpy(),
                                       np.asarray(want_y), atol=5e-4,
                                       rtol=5e-4)
        ((y * gy).sum() + s.sum()).backward()
        grads[chunk] = {n: leaves[n].grad.numpy() for n in names}
    for n in names:
        want = grads[7][n]
        assert np.isfinite(grads[32][n]).all(), n
        np.testing.assert_allclose(grads[32][n], want, rtol=1e-4,
                                   atol=1e-4 * float(np.abs(want).max()),
                                   err_msg=n)


# ---------------------------------------------------------------------------
# The train CLI
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["rwkv6-3b", "zamba2-1.2b"])
def test_cli_trains_recurrent_arch(arch, capsys):
    """`python -m repro_torch.launch.train --arch rwkv6-3b` (and zamba2):
    both stages run, every logged metric finite."""
    params, hist = ttrain.main(["--device", "cpu", "--reduced", "--arch",
                                arch, "--stage1-steps", "3",
                                "--stage2-steps", "2", "--seq-len", "32",
                                "--n-train", "64", "--batch", "4",
                                "--log-every", "1"])
    assert [r["step"] for r in hist[1]] == [1, 2, 3]
    assert [r["step"] for r in hist[2]] == [1, 2]
    for rec in hist[1] + hist[2]:
        assert all(np.isfinite(v) for v in rec.values()), rec
    assert f"config: {arch}-reduced" in capsys.readouterr().out
