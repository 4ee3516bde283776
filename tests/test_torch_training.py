"""The port's training path on the CPU against the JAX package.

One Stage-1 step (CE on full logits) and one Stage-2 step (the chunked
Gatekeeper loss, and the fused loss's autograd function) on reduced
internlm2-1.8b and reduced DeepSeek-V2, with JAX weights carried over by
`params_from_jax` and the same numpy batch: loss, aux and grad norm to
1e-5, and every gradient leaf to ``1e-5 * max|g_leaf|`` plus rtol 1e-4.
Parameters after a step are not compared: AdamW's first step moves each
parameter by about ±lr whatever its gradient's size, so an entry whose
gradient is rounding noise near 0 moves either way in the two frameworks.
Also: gradient accumulation, the batch iterator's order, `make_qa`,
checkpoints across the two packages, and a short two-stage run.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from repro.configs import get_config, reduced
from repro.core import gatekeeper as jgk_lib
from repro.core.gatekeeper import GatekeeperConfig as JGK
from repro.data.pipeline import BatchIterator as JBatchIterator
from repro.launch import steps as jsteps
from repro.models import transformer as jtfm
from repro.sharding import ParallelContext
from repro.training import checkpoint as jckpt
from repro.training import loop as jloop
from repro.training import optim as joptim
from repro_torch.configs import ModelConfig
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs import reduced as t_reduced
from repro_torch.convert import params_from_jax
from repro_torch.core.gatekeeper import GatekeeperConfig as TGK
from repro_torch.core.gatekeeper import gatekeeper_loss
from repro_torch.data import synthetic as tsyn
from repro_torch.data.pipeline import BatchIterator
from repro_torch.launch import steps as tsteps
from repro_torch.launch import train as ttrain
from repro_torch.models import transformer as ttfm
from repro_torch.training import checkpoint as tckpt
from repro_torch.training import loop as tloop
from repro_torch.training import optim as toptim

torch.set_num_threads(1)
CTX = ParallelContext()
ATOL = 1e-5
GRAD_RTOL = 1e-4
OPT = dict(lr=1e-3, warmup_steps=2, total_steps=10)
ARCHS = ["internlm2-1.8b", "deepseek-v2-236b"]


def _named(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_named(tree[k], f"{prefix}/{k}"))
        return out
    return {prefix: np.asarray(tree)}


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    """(JAX cfg, port cfg, JAX params, a batch whose targets hit the
    model's argmax at about half the positions, no near-ties)."""
    arch = request.param
    cfg, tcfg = reduced(get_config(arch)), t_reduced(t_get_config(arch))
    jparams = jax.device_get(jtfm.init_params(cfg, jax.random.PRNGKey(0)))
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


@pytest.mark.parametrize("loss_kind", ["ce", "gatekeeper"])
def test_stage1_step_matches_jax(model, loss_kind):
    """`training.loop`'s step on full logits: Stage-1 CE (the trainer's
    Stage 1) and its "gatekeeper" loss kind."""
    cfg, tcfg, jparams, batch = model
    gk = dict(alpha=0.3) if loss_kind == "gatekeeper" else None
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jb["inputs"] = jb["tokens"]
    tb = _tbatch(batch)
    tb["inputs"] = tb["tokens"]
    j_apply = lambda p, b: jtfm.forward(p, cfg, b["inputs"], CTX,  # noqa: E731
                                        return_aux=True)
    t_apply = lambda p, b: ttfm.forward(p, tcfg, b["inputs"],  # noqa: E731
                                        return_aux=True)
    jstep = jloop.make_train_step(j_apply, joptim.AdamWConfig(**OPT),
                                  loss_kind=loss_kind, aux_weight=0.01,
                                  gk_cfg=gk and JGK(**gk))
    tstep = tloop.make_train_step(t_apply, toptim.AdamWConfig(**OPT),
                                  loss_kind=loss_kind, aux_weight=0.01,
                                  gk_cfg=gk and TGK(**gk))
    _, _, mj = jstep(jparams, joptim.adamw_init(jparams), jb)
    tp = _tparams(jparams)
    _, _, mt = tstep(tp, toptim.adamw_init(tp), tb)
    assert set(mt) == set(mj)
    _assert_metrics(mj, mt, mj)

    def j_loss(p):
        logits, aux = j_apply(p, jb)
        if gk is None:
            loss, _ = jgk_lib.standard_ce_loss(logits, jb["targets"],
                                               jb["loss_mask"])
        else:
            loss, _ = jgk_lib.gatekeeper_loss(logits, jb["targets"],
                                              JGK(**gk), jb["loss_mask"])
        return loss + 0.01 * aux
    gj = jax.grad(j_loss)(jparams)
    t_loss = tloop.make_loss_fn(t_apply, loss_kind, gk and TGK(**gk),
                                aux_weight=0.01)
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


@pytest.mark.parametrize("loss_kernel", [False, True],
                         ids=["chunked", "fused"])
def test_stage2_step_matches_jax(model, loss_kernel):
    """The Stage-2 step through the chunked loss and through the fused
    loss's autograd function (its plain forward on the CPU)."""
    cfg, tcfg, jparams, batch = model
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = _tbatch(batch)
    jstep = jsteps.make_train_step(cfg, CTX, JGK(alpha=0.3),
                                   joptim.AdamWConfig(**OPT))
    tstep = tsteps.make_train_step(tcfg, TGK(alpha=0.3),
                                   toptim.AdamWConfig(**OPT),
                                   loss_kernel=loss_kernel)
    _, _, mj = jstep(jparams, joptim.adamw_init(jparams), jb)
    tp = _tparams(jparams)
    _, _, mt = tstep(tp, toptim.adamw_init(tp), tb)
    assert set(mt) == set(mj)
    _assert_metrics(mj, mt, mj)
    assert 0.2 < float(mt["frac_correct"]) < 0.8      # both branches live
    (_, _), gj = _jax_stage2_grads(cfg, jparams, jb, 0.3)
    t_loss = tsteps.make_loss_fn(tcfg, TGK(alpha=0.3), 0.01, loss_kernel)
    _, gt = toptim.value_and_grad(t_loss, _tparams(jparams), tb)
    _assert_grads(gj, gt)


def test_train_step_updates_params_in_place(model):
    _, tcfg, jparams, batch = model
    tp = _tparams(jparams)
    before = {k: v.clone() for k, v in _named_t(tp).items()}
    step = tsteps.make_train_step(tcfg)
    out, state, _ = step(tp, toptim.adamw_init(tp), _tbatch(batch))
    assert out is tp and int(state.step) == 1
    after = _named_t(tp)
    assert any(not torch.equal(before[k], after[k]) for k in before)
    assert all(not t.requires_grad for t in after.values())


def _named_t(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k in tree:
            out.update(_named_t(tree[k], f"{prefix}/{k}"))
        return out
    return {prefix: tree}


def test_microbatched_train_step_matches_full_batch():
    """Gradient accumulation (microbatches=2) == one full-batch step: same
    loss and, at the first step's warmup lr, the same updated params (the
    valid mask is all ones, so the microbatch means average exactly)."""
    cfg = ModelConfig(name="t", family="dense", n_layers=2, d_model=32,
                      n_heads=4, n_kv_heads=2, head_dim=8, d_ff=64,
                      vocab_size=64, tie_embeddings=True,
                      param_dtype="float32", compute_dtype="float32")
    params = ttfm.init_params(cfg, 0, "cpu")
    rng = np.random.default_rng(1)
    batch = {"tokens": torch.from_numpy(rng.integers(0, 64, (8, 12))),
             "targets": torch.from_numpy(rng.integers(0, 64, (8, 12)))}
    out = {}
    for mb in (1, 2):
        p = toptim.tree_map(torch.clone, params)
        step = tsteps.make_train_step(cfg, microbatches=mb)
        out[mb] = step(p, toptim.adamw_init(p), batch)
    assert abs(float(out[1][2]["loss"]) - float(out[2][2]["loss"])) < 1e-5
    for a, b in zip(toptim.tree_leaves(out[1][0]),
                    toptim.tree_leaves(out[2][0])):
        torch.testing.assert_close(a, b, atol=2e-5, rtol=2e-5)
    with pytest.raises(ValueError, match="microbatches"):
        tsteps.make_train_step(cfg, microbatches=3)(
            params, toptim.adamw_init(params), batch)


def test_loop_train_logs_history():
    """`training.loop.train` over batch iterator output: the history logs
    step 1 and every log_every-th step, and log_fn sees the same."""
    tcfg = t_reduced(t_get_config("internlm2-1.8b"))
    params = ttfm.init_params(tcfg, 0, "cpu")
    rng = np.random.default_rng(4)
    stream = rng.integers(0, tcfg.vocab_size, (64, 9))
    it = BatchIterator({"inputs": stream[:, :-1], "targets": stream[:, 1:]},
                       8)
    batches = ({k: torch.from_numpy(v) for k, v in b.items()}
               for b in it.forever())
    step = tloop.make_train_step(
        lambda p, b: ttfm.forward(p, tcfg, b["inputs"]),
        toptim.AdamWConfig(lr=3e-3, warmup_steps=0, total_steps=12), "ce")
    seen = []
    res = tloop.train(params, step, batches, 12, log_every=5,
                      log_fn=lambda i, m: seen.append((i, m["loss"])))
    assert res.params is params
    assert res.history["step"] == [1, 5, 10] == [i for i, _ in seen]
    assert res.history["loss"] == [m for _, m in seen]
    assert res.history["loss"][-1] < res.history["loss"][0]
    assert {"accuracy", "grad_norm", "lr", "total_loss", "model_aux"} <= set(
        res.history)


def test_batch_iterator_order_matches_jax():
    """seed 0 is JAX's key=None: the same shuffles epoch after epoch."""
    data = {"x": np.arange(103), "y": np.arange(103) * 2}
    jit_ = JBatchIterator(data, 10).forever()
    tit = BatchIterator(data, 10, seed=0).forever()
    for _ in range(25):                          # crosses two epochs
        bj, bt = next(jit_), next(tit)
        for k in data:
            np.testing.assert_array_equal(bt[k], np.asarray(bj[k]))
    assert len(BatchIterator(data, 10)) == 10
    assert len(BatchIterator(data, 10, drop_last=False)) == 11
    with pytest.raises(ValueError, match="misaligned"):
        BatchIterator({"a": np.arange(3), "b": np.arange(4)}, 2)


def test_make_qa_layout_and_mask():
    K = 16
    qa = tsyn.make_qa(3, 500, n_symbols=K)
    t = qa.tokens
    assert t.shape == (500, 8) and t.dtype == np.int32
    assert (t[:, 0] == tsyn.BOS).all() and (t[:, 5] == tsyn.SEP).all()
    assert (t[:, 7] == tsyn.PAD).all()
    assert qa.answer_pos == 6 and qa.vocab == tsyn.SYMBOL_BASE + K + 3
    np.testing.assert_array_equal(t[:, 1], tsyn.SYMBOL_BASE + K + qa.op)
    a, b, c = (t[:, i] - tsyn.SYMBOL_BASE for i in (2, 3, 4))
    ans = np.where(qa.op == 0, a, np.where(qa.op == 1, (a + b) % K,
                                           (a * b + c) % K))
    np.testing.assert_array_equal(t[:, 6], tsyn.SYMBOL_BASE + ans)
    assert qa.loss_mask.shape == (500, 7) and qa.loss_mask.sum() == 500
    assert (qa.loss_mask[:, 5] == 1).all()
    np.testing.assert_array_equal(qa.inputs, t[:, :-1])
    np.testing.assert_array_equal(qa.targets, t[:, 1:])
    freq = np.bincount(qa.op, minlength=3) / 500
    np.testing.assert_allclose(freq, (0.4, 0.3, 0.3), atol=0.07)
    np.testing.assert_array_equal(tsyn.make_qa(3, 500).tokens, t)


@pytest.mark.parametrize("arch", ARCHS)
def test_checkpoints_cross_between_packages(arch, tmp_path):
    """A JAX checkpoint restores in the port bit for bit, and a port
    checkpoint restores in JAX; both write the same names."""
    cfg = reduced(get_config(arch))
    jparams = jax.device_get(jtfm.init_params(cfg, jax.random.PRNGKey(2)))
    tp = _tparams(jparams)
    jckpt.save_checkpoint(str(tmp_path / "j"), jparams, step=7)
    got = tckpt.restore_checkpoint(str(tmp_path / "j"), tp)
    assert tckpt.checkpoint_step(str(tmp_path / "j")) == 7
    for a, b in zip(jax.tree.leaves(jparams), toptim.tree_leaves(got)):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    tckpt.save_checkpoint(str(tmp_path / "t"), tp, step=3)
    back = jckpt.restore_checkpoint(str(tmp_path / "t"), jparams)
    for a, b in zip(jax.tree.leaves(jparams), jax.tree.leaves(back)):
        np.testing.assert_array_equal(np.asarray(b), np.asarray(a))
    metas = [(tmp_path / d / "meta.json").read_text() for d in ("j", "t")]
    import json
    mj, mt = (json.loads(m) for m in metas)
    assert mj["names"] == mt["names"] and mj["dtypes"] == mt["dtypes"]
    assert "['blocks']['dense']['attn']['wo']" in mt["names"]
    with pytest.raises(ValueError, match="mismatch"):
        tckpt.restore_checkpoint(str(tmp_path / "t"), {"x": tp["embedding"]})
    assert tckpt.checkpoint_step(str(tmp_path / "none")) is None


def test_checkpoint_keeps_bfloat16_leaves(tmp_path):
    tree = {"a": torch.randn(3, 5).bfloat16(), "b": {"c": torch.arange(4)}}
    tckpt.save_checkpoint(str(tmp_path), tree)
    got = tckpt.restore_checkpoint(str(tmp_path), tree)
    assert got["a"].dtype == torch.bfloat16
    assert torch.equal(got["a"], tree["a"]) and torch.equal(got["b"]["c"],
                                                            tree["b"]["c"])


def _args(**kw):
    args = ttrain.build_parser().parse_args(["--device", "cpu", "--reduced"])
    for k, v in kw.items():
        setattr(args, k, v)
    return args


def test_two_stage_run_raises_entropy_on_incorrect_tokens(tmp_path):
    """Stage 1 (CE), then 30 Stage-2 steps at alpha 0.2 through
    `launch.train.run`: on a fixed batch, the mean predictive entropy of
    the incorrect tokens goes up from the Stage-1 checkpoint to the
    Stage-2 model (the analogue of the JAX classifier test)."""
    args = _args(stage1_steps=40, stage2_steps=30, alpha=0.2, lr=3e-3,
                 n_train=256, seq_len=16, batch=16, log_every=10,
                 ckpt=str(tmp_path))
    params, hist = ttrain.run(args)
    assert [r["step"] for r in hist[1]] == [1, 10, 20, 30, 40]
    assert [r["step"] for r in hist[2]] == [1, 10, 20, 30]
    for rec in hist[1] + hist[2]:
        assert all(np.isfinite(v) for v in rec.values())
    cfg = ttrain.build_cfg(args)
    stage1 = tckpt.restore_checkpoint(str(tmp_path / "stage1"), params)
    assert tckpt.checkpoint_step(str(tmp_path / "stage2")) == 30
    stage2 = tckpt.restore_checkpoint(str(tmp_path / "stage2"), params)
    for a, b in zip(toptim.tree_leaves(stage2), toptim.tree_leaves(params)):
        assert torch.equal(a, b)
    data = ttrain.make_data(cfg, args, [args.seed, 1])
    tok = torch.from_numpy(data["tokens"][:128])
    tgt = torch.from_numpy(data["targets"][:128])
    ent = {}
    for name, p in (("stage1", stage1), ("stage2", stage2)):
        logits = ttfm.forward(p, cfg, tok)
        _, aux = gatekeeper_loss(logits, tgt, TGK(alpha=0.2))
        ent[name] = float(aux["mean_entropy_incorrect"])
        assert 0.0 < float(aux["frac_correct"]) < 1.0
    assert ent["stage2"] > ent["stage1"], ent


def test_run_on_qa_task_uses_the_answer_mask():
    args = _args(task="qa", stage1_steps=2, stage2_steps=2, n_train=64,
                 batch=8, log_every=1)
    _, hist = ttrain.run(args)
    assert len(hist[1]) == 2 and len(hist[2]) == 2
    assert all(np.isfinite(r["loss"]) for r in hist[2])


def test_cli_rejects_unported_arch(capsys):
    """The train CLI refuses whisper-small by name: it takes frames, which
    the CLI (like JAX's) cannot feed; its training runs through
    `launch.steps` (tests/test_torch_encdec.py)."""
    with pytest.raises(SystemExit) as exc:
        ttrain.main(["--device", "cpu", "--arch", "whisper-small"])
    assert exc.value.code == 2
    err = capsys.readouterr().err
    assert "--arch whisper-small" in err and "frames" in err
    assert "ROADMAP.md" in err


def test_unported_training_branches_raise():
    """The Stage-2 loss of the recurrent families, refused before they
    were ported, now computes: a finite loss and a finite gradient for
    every leaf (against JAX: tests/test_torch_train_recurrent.py)."""
    batch = {"tokens": torch.zeros((1, 4), dtype=torch.long),
             "targets": torch.zeros((1, 4), dtype=torch.long)}
    for arch in ("rwkv6-3b", "zamba2-1.2b"):
        tcfg = t_reduced(t_get_config(arch))
        params = ttfm.init_params(tcfg, 0, "cpu")
        (loss, _), grads = toptim.value_and_grad(
            tsteps.make_loss_fn(tcfg, TGK()), params, batch)
        assert torch.isfinite(loss)
        assert all(bool(torch.isfinite(g).all())
                   for g in toptim.tree_leaves(grads))
