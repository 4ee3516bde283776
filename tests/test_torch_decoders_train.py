"""One Stage-1 and one Stage-2 step of reduced qwen1.5-4b (with its QKV
biases drawn non-zero) and reduced kimi-k2-1t-a32b (GQA + MoE) on the
CPU against the JAX package, with JAX's weights carried over by
`params_from_jax` and the same numpy batch: metrics within 1e-5, every
gradient leaf (the bias and router leaves among them) to ``1e-5 *
max|g_leaf|`` plus rtol 1e-4, as tests/test_torch_training.py holds
internlm2-1.8b and DeepSeek-V2; and the train CLI on both archs."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from _decoder_cases import named, set_biases
from repro.configs import get_config, reduced
from repro.core import gatekeeper as jgk_lib
from repro.core.gatekeeper import GatekeeperConfig as JGK
from repro.launch import steps as jsteps
from repro.models import transformer as jtfm
from repro.sharding import ParallelContext
from repro.training import loop as jloop
from repro.training import optim as joptim
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs import reduced as t_reduced
from repro_torch.convert import params_from_jax
from repro_torch.core.gatekeeper import GatekeeperConfig as TGK
from repro_torch.launch import steps as tsteps
from repro_torch.launch import train as ttrain
from repro_torch.models import transformer as ttfm
from repro_torch.training import loop as tloop
from repro_torch.training import optim as toptim

torch.set_num_threads(1)
CTX = ParallelContext()
GRAD_ATOL = 1e-5      # gradient leaves: 1e-5 * max|g_leaf| plus rtol 1e-4,
GRAD_RTOL = 1e-4      # as tests/test_torch_training.py holds them
OPT = dict(lr=1e-3, warmup_steps=2, total_steps=10)
TRAIN_ARCHS = ["qwen1.5-4b", "kimi-k2-1t-a32b"]


@pytest.fixture(scope="module", params=TRAIN_ARCHS)
def train_model(request):
    """(JAX cfg, port cfg, JAX params with drawn biases where the config
    has them, a batch whose targets hit the model's argmax at about half
    the positions, no near-ties)."""
    cfg = reduced(get_config(request.param))
    tcfg = t_reduced(t_get_config(request.param))
    jparams = jax.device_get(jtfm.init_params(cfg, jax.random.PRNGKey(0)))
    if cfg.qkv_bias:
        jparams = jax.device_get(set_biases(jparams, 12))
    rng = np.random.default_rng(1)
    B, S = 4, 12
    tokens = rng.integers(0, cfg.vocab_size, size=(B, S)).astype(np.int32)
    logits = np.asarray(jtfm.forward(jparams, cfg, jnp.asarray(tokens), CTX))
    top2 = np.sort(logits, axis=-1)[..., -2:]
    assert (top2[..., 1] - top2[..., 0]).min() > 1e-4, "near-tie: new seed"
    targets = rng.integers(0, cfg.vocab_size, size=(B, S)).astype(np.int32)
    hit = rng.random((B, S)) < 0.5
    targets[hit] = logits.argmax(-1)[hit]
    mask = (rng.random((B, S)) > 0.2).astype(np.float32)
    return cfg, tcfg, jparams, {"tokens": tokens, "targets": targets,
                                "loss_mask": mask}


def _assert_grads(gj, gt):
    nj = {k: np.asarray(v) for k, v in named(gj).items()}
    nt = {k: v.numpy() for k, v in named(gt).items()}
    assert nj.keys() == nt.keys()
    for name in nj:
        scale = float(np.abs(nj[name]).max())
        np.testing.assert_allclose(nt[name], nj[name], rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL * scale + 1e-12,
                                   err_msg=name)
    return nt


def _assert_metrics(mj, mt):
    assert set(mt) == set(mj)
    for k in mj:
        assert abs(float(mt[k]) - float(mj[k])) <= GRAD_ATOL * max(
            1.0, abs(float(mj[k]))), (k, float(mt[k]), float(mj[k]))


def _checked_leaves(cfg, grads):
    """The bias and router gradients are among those compared, and live."""
    attn = grads["blocks"]["dense"]["attn"]
    if cfg.qkv_bias:
        assert all(float(attn[k].abs().max()) > 0 for k in ("bq", "bk", "bv"))
    if cfg.moe is not None:
        assert float(grads["blocks"]["moe"]["moe"]["router"].abs().max()) > 0


def test_stage1_step_matches_jax(train_model):
    """`training.loop`'s CE step on full logits (the trainer's Stage 1,
    MoE aux weight 0.01): metrics and every gradient leaf."""
    cfg, tcfg, jparams, batch = train_model
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}
    jb["inputs"], tb["inputs"] = jb["tokens"], tb["tokens"]
    j_apply = lambda p, b: jtfm.forward(p, cfg, b["inputs"], CTX,  # noqa: E731
                                        return_aux=True)
    t_apply = lambda p, b: ttfm.forward(p, tcfg, b["inputs"],  # noqa: E731
                                        return_aux=True)
    jstep = jloop.make_train_step(j_apply, joptim.AdamWConfig(**OPT),
                                  loss_kind="ce", aux_weight=0.01)
    tstep = tloop.make_train_step(t_apply, toptim.AdamWConfig(**OPT),
                                  loss_kind="ce", aux_weight=0.01)
    _, _, mj = jstep(jparams, joptim.adamw_init(jparams), jb)
    tp = params_from_jax(jparams, "cpu")
    _, _, mt = tstep(tp, toptim.adamw_init(tp), tb)
    _assert_metrics(mj, mt)

    def j_loss(p):
        logits, aux = j_apply(p, jb)
        loss, _ = jgk_lib.standard_ce_loss(logits, jb["targets"],
                                           jb["loss_mask"])
        return loss + 0.01 * aux
    gj = jax.grad(j_loss)(jparams)
    t_loss = tloop.make_loss_fn(t_apply, "ce", None, aux_weight=0.01)
    _, gt = toptim.value_and_grad(t_loss, params_from_jax(jparams, "cpu"), tb)
    _assert_grads(gj, gt)
    _checked_leaves(cfg, gt)


@pytest.mark.parametrize("loss_kernel", [False, True],
                         ids=["chunked", "fused"])
def test_stage2_step_matches_jax(train_model, loss_kernel):
    """The Stage-2 step (the Gatekeeper loss fused with the unembedding:
    the chunked loss, and the fused loss's autograd function with its
    plain forward on the CPU): metrics and every gradient leaf."""
    cfg, tcfg, jparams, batch = train_model
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}
    jstep = jsteps.make_train_step(cfg, CTX, JGK(alpha=0.3),
                                   joptim.AdamWConfig(**OPT))
    tstep = tsteps.make_train_step(tcfg, TGK(alpha=0.3),
                                   toptim.AdamWConfig(**OPT),
                                   loss_kernel=loss_kernel)
    _, _, mj = jstep(jparams, joptim.adamw_init(jparams), jb)
    tp = params_from_jax(jparams, "cpu")
    _, _, mt = tstep(tp, toptim.adamw_init(tp), tb)
    _assert_metrics(mj, mt)
    assert 0.2 < float(mt["frac_correct"]) < 0.8      # both branches live

    def j_loss(params):
        x, model_aux, mask = jsteps._final_hidden(params, cfg, jb, CTX)
        table = params.get("unembed", params["embedding"])
        loss, aux = jsteps.chunked_gatekeeper_loss(
            x, table, jsteps._pad_targets(cfg, jb, x.shape[1]),
            JGK(alpha=0.3), mask)
        return loss + 0.01 * model_aux
    gj = jax.grad(j_loss)(jparams)
    t_loss = tsteps.make_loss_fn(tcfg, TGK(alpha=0.3), 0.01, loss_kernel)
    _, gt = toptim.value_and_grad(t_loss, params_from_jax(jparams, "cpu"), tb)
    _assert_grads(gj, gt)
    _checked_leaves(cfg, gt)


@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_train_cli_runs_one_step_of_each_stage(arch):
    """`launch.train.main --arch X --reduced`: one Stage-1 and one Stage-2
    step, finite metrics."""
    params, hist = ttrain.main(["--device", "cpu", "--reduced", "--arch",
                                arch, "--stage1-steps", "1",
                                "--stage2-steps", "1", "--n-train", "32",
                                "--seq-len", "8", "--batch", "8",
                                "--log-every", "1"])
    assert [len(hist[1]), len(hist[2])] == [1, 1]
    assert all(np.isfinite(v) for rec in hist[1] + hist[2]
               for v in rec.values())
