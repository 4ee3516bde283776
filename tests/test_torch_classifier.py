"""The port's classifier path on the CPU against the JAX package.

`models.classifier` (forward, dropout), the classifier losses of
`training.loop.make_loss_fn` ("ce", "gatekeeper" with hard and soft
targets, "static_partition" with and without a loss mask),
`training.loop.evaluate_classifier` and `data.synthetic.make_classification`.
JAX's weights are carried over with `params_from_jax` and JAX's arrays fed
to both packages: logits to 1e-5, every gradient leaf to 1e-5 of its
largest entry, predictions exactly. The port's generator draws its own
bits, so it is held by structure. Last, the classifier cases of
tests/test_training.py on JAX's arrays, weights and batch order.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from repro.core import baselines as jbase
from repro.core import gatekeeper as jgk
from repro.data.synthetic import make_classification as j_make_classification
from repro.models import classifier as jcls
from repro.training import loop as jloop
from repro.training import optim as joptim
from repro_torch.convert import params_from_jax
from repro_torch.core import baselines as tbase
from repro_torch.core.gatekeeper import GatekeeperConfig as TGK
from repro_torch.data.pipeline import BatchIterator
from repro_torch.data.synthetic import make_classification
from repro_torch.models import classifier as tcls
from repro_torch.training import loop as tloop
from repro_torch.training import optim as toptim

torch.set_num_threads(1)
ATOL = 1e-5
GRAD_ATOL_OF_MAX = 1e-5


def _jcfg(cfg):
    return jcls.MLPClassifierConfig(cfg.d_in, cfg.n_classes, cfg.hidden,
                                    cfg.dropout)


def _jinit(cfg, seed):
    """JAX's init of `cfg` from PRNGKey(seed): (numpy tree, port tree)."""
    jp = jax.device_get(jcls.init_classifier(_jcfg(cfg), jax.random.PRNGKey(
        seed)))
    return jp, params_from_jax(jp, device="cpu")


def _japply(cfg):
    return lambda p, x: jcls.classifier_forward(p, _jcfg(cfg), x)


def _tapply(cfg):
    return lambda p, x: tcls.classifier_forward(p, cfg, x)


def _clone(params):
    return {k: v.clone() for k, v in params.items()}


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("hidden", [(16,), (64, 64), (256, 256)],
                         ids=lambda h: "x".join(map(str, h)))
def test_forward_matches_jax(hidden):
    data = j_make_classification(jax.random.PRNGKey(3), 512, n_classes=8)
    cfg = tcls.MLPClassifierConfig(d_in=data.x.shape[1], n_classes=8,
                                   hidden=hidden)
    jp, tp = _jinit(cfg, 4)
    assert set(tp) == {f"{n}{i}" for i in range(len(hidden) + 1)
                       for n in "wb"}
    want = np.asarray(jcls.classifier_forward(jp, _jcfg(cfg),
                                              jnp.asarray(data.x)))
    got = tcls.make_apply(cfg)(tp, torch.from_numpy(np.array(data.x)))
    assert got.dtype == torch.float32 and got.shape == (512, 8)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)


def test_init_layout_and_scale():
    cfg = tcls.MLPClassifierConfig(d_in=25, n_classes=8, hidden=(256, 256))
    p = tcls.init_classifier(cfg, 0, device="cpu")
    assert {k: tuple(v.shape) for k, v in p.items()} == {
        "w0": (25, 256), "b0": (256,), "w1": (256, 256), "b1": (256,),
        "w2": (256, 8), "b2": (8,)}
    assert all(v.dtype == torch.float32 for v in p.values())
    assert all(not v.any() for k, v in p.items() if k[0] == "b")
    assert float(p["w1"].std()) == pytest.approx(1 / 16, rel=0.02)
    again = tcls.init_classifier(cfg, 0, device="cpu")
    assert all(torch.equal(p[k], again[k]) for k in p)
    assert not torch.equal(p["w0"], tcls.init_classifier(cfg, 1, "cpu")["w0"])


def test_init_classifier_runs_on_cuda_unless_told(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tcls.MLPClassifierConfig(d_in=4, n_classes=2, hidden=(3,))
    with pytest.raises(RuntimeError, match="CUDA"):
        tcls.init_classifier(cfg, 0)
    assert tcls.init_classifier(cfg, 0, "cpu")["w0"].device.type == "cpu"


# ---------------------------------------------------------------------------
# Dropout
# ---------------------------------------------------------------------------

def test_dropout_off_without_generator():
    cfg = tcls.MLPClassifierConfig(d_in=25, n_classes=8, hidden=(64, 64),
                                   dropout=0.5)
    plain = tcls.MLPClassifierConfig(d_in=25, n_classes=8, hidden=(64, 64))
    p = tcls.init_classifier(cfg, 0, "cpu")
    x = torch.randn(32, 25, generator=torch.Generator().manual_seed(0))
    assert torch.equal(tcls.classifier_forward(p, cfg, x),
                       tcls.classifier_forward(p, plain, x))


def test_dropout_with_generator_is_seeded_and_scaled():
    """One hidden layer read out through the identity: each output is the
    activation dropped (0) or kept and scaled by 1 / (1 - p)."""
    p_drop = 0.25
    cfg = tcls.MLPClassifierConfig(d_in=16, n_classes=64, hidden=(64,),
                                   dropout=p_drop)
    params = tcls.init_classifier(cfg, 0, "cpu")
    params["w1"] = torch.eye(64)
    x = torch.randn(256, 16, generator=torch.Generator().manual_seed(1))
    h = torch.relu(x @ params["w0"])
    out = tcls.classifier_forward(params, cfg, x,
                                  generator=torch.Generator().manual_seed(5))
    again = tcls.classifier_forward(params, cfg, x,
                                    generator=torch.Generator().manual_seed(5))
    other = tcls.classifier_forward(params, cfg, x,
                                    generator=torch.Generator().manual_seed(6))
    assert torch.equal(out, again) and not torch.equal(out, other)
    live = h > 0
    kept = live & (out != 0)
    torch.testing.assert_close(out[kept], h[kept] / (1 - p_drop), rtol=0,
                               atol=1e-6)
    frac = float(kept.sum()) / float(live.sum())
    n = float(live.sum())
    sd = (p_drop * (1 - p_drop) / n) ** 0.5
    assert abs(frac - (1 - p_drop)) < 4 * sd


# ---------------------------------------------------------------------------
# Losses and gradients
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def loss_case():
    """(cfg, JAX params, port params, numpy batch): 256 JAX-drawn rows,
    targets on the model's argmax for about half of them, soft targets,
    a loss mask, and the static partition by a (256, 256) reference."""
    data = j_make_classification(jax.random.PRNGKey(3), 256, n_classes=8)
    cfg = tcls.MLPClassifierConfig(d_in=data.x.shape[1], n_classes=8,
                                   hidden=(64, 64))
    jp, tp = _jinit(cfg, 1)
    logits = np.asarray(_japply(cfg)(jp, jnp.asarray(data.x)))
    top2 = np.sort(logits, axis=-1)[:, -2:]
    assert (top2[:, 1] - top2[:, 0]).min() > 1e-4, "near-tie in the case"
    rng = np.random.default_rng(0)
    targets = data.y.copy()
    hit = rng.random(256) < 0.5
    targets[hit] = logits.argmax(-1)[hit]
    soft = rng.standard_normal((256, 8)) + 3 * np.eye(8)[targets]
    soft = np.exp(soft) / np.exp(soft).sum(-1, keepdims=True)
    ref_cfg = tcls.MLPClassifierConfig(d_in=cfg.d_in, n_classes=8,
                                       hidden=(256, 256))
    jref, _ = _jinit(ref_cfg, 2)
    ref_logits = np.array(_japply(ref_cfg)(jref, jnp.asarray(data.x)))
    easy = tbase.compute_static_partition(torch.from_numpy(ref_logits),
                                          torch.from_numpy(targets)).numpy()
    np.testing.assert_array_equal(easy, np.asarray(
        jbase.compute_static_partition(jnp.asarray(ref_logits),
                                       jnp.asarray(targets))))
    assert 0 < easy.mean() < 1
    batch = {"inputs": data.x, "targets": targets.astype(np.int32),
             "soft": soft.astype(np.float32), "easy_mask": easy,
             "loss_mask": (rng.random(256) > 0.2).astype(np.float32)}
    return cfg, jp, tp, batch


LOSSES = {   # id: (loss_kind, Gatekeeper config kwargs, soft, masked)
    "ce": ("ce", None, False, True),
    "gatekeeper": ("gatekeeper", dict(alpha=0.3), False, True),
    "gatekeeper-soft": ("gatekeeper", dict(alpha=0.3, soft_targets=True),
                        True, True),
    "static_partition": ("static_partition", dict(alpha=0.3), False, False),
    "static_partition-masked": ("static_partition", dict(alpha=0.3), False,
                                True),
}


def _jax_loss(cfg, kind, gk, batch):
    """The loss of JAX's `make_train_step` for `kind` (training/loop.py)."""
    mask = batch.get("loss_mask")

    def loss_fn(p):
        logits = _japply(cfg)(p, batch["inputs"])
        if kind == "ce":
            return jgk.standard_ce_loss(logits, batch["targets"], mask)
        if kind == "gatekeeper":
            return jgk.gatekeeper_loss(logits, batch["targets"],
                                       jgk.GatekeeperConfig(**gk), mask)
        return jbase.static_partition_loss(
            logits, batch["targets"], batch["easy_mask"],
            alpha=gk["alpha"] if gk else 0.5, valid_mask=mask)
    return loss_fn


@pytest.mark.parametrize("case", list(LOSSES))
def test_loss_gradients_match_jax(loss_case, case):
    """Loss, aux and every gradient leaf of `make_loss_fn` against
    `jax.grad` of the same loss at JAX's weights; the port's batch is the
    numpy one, moved to the parameters' device by the loss."""
    cfg, jp, tp, full = loss_case
    kind, gk, soft, masked = LOSSES[case]
    batch = {"inputs": full["inputs"],
             "targets": full["soft"] if soft else full["targets"]}
    if kind == "static_partition":
        batch["easy_mask"] = full["easy_mask"]
    if masked:
        batch["loss_mask"] = full["loss_mask"]
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (jl, jaux), gj = jax.value_and_grad(_jax_loss(cfg, kind, gk, jb),
                                        has_aux=True)(jp)
    t_loss = tloop.make_loss_fn(lambda p, b: tcls.classifier_forward(
        p, cfg, b["inputs"]), kind, gk and TGK(**gk))
    (tl, taux), gt = toptim.value_and_grad(t_loss, tp, batch)
    assert abs(float(tl) - float(jl)) <= ATOL * max(1.0, abs(float(jl)))
    assert set(taux) == set(jaux) | {"model_aux"}
    for k in jaux:
        assert abs(float(taux[k]) - float(jaux[k])) <= ATOL * max(
            1.0, abs(float(jaux[k]))), (k, float(taux[k]), float(jaux[k]))
    if kind == "gatekeeper":
        assert 0.2 < float(taux["frac_correct"]) < 0.8   # both branches live
    assert set(gt) == set(gj)
    for name in gj:
        want = np.asarray(gj[name])
        scale = float(np.abs(want).max())
        assert scale > 0, name
        np.testing.assert_allclose(gt[name].numpy(), want, rtol=0,
                                   atol=GRAD_ATOL_OF_MAX * scale,
                                   err_msg=f"{case}: {name}")


def test_static_partition_alpha_defaults_to_half(loss_case):
    """Without a Gatekeeper config the static partition weighs its two
    terms equally, as JAX's loop does."""
    cfg, _, tp, full = loss_case
    batch = {k: full[k] for k in ("inputs", "targets", "easy_mask")}
    apply = lambda p, b: tcls.classifier_forward(p, cfg, b["inputs"])  # noqa: E731
    loss, aux = tloop.make_loss_fn(apply, "static_partition")(tp, batch)
    assert float(loss) == pytest.approx(
        0.5 * float(aux["l_easy"]) + 0.5 * float(aux["l_hard"]), abs=1e-6)
    with pytest.raises(ValueError):
        tloop.make_loss_fn(apply, "static")


def test_static_partition_trains():
    """The wired loss through `train`: numpy batches with an easy mask from
    the Stage-1 model's correctness; the hard rows' confidence falls."""
    data = make_classification(11, 3000, n_classes=8, hard_frac=0.5)
    cfg = tcls.MLPClassifierConfig(d_in=data.x.shape[1], n_classes=8,
                                   hidden=(16,))
    params = tcls.init_classifier(cfg, 0, "cpu")
    apply = lambda p, b: tcls.classifier_forward(p, cfg, b["inputs"])  # noqa: E731
    it = BatchIterator({"inputs": data.x, "targets": data.y}, 256, seed=0)
    params = tloop.train(params, tloop.make_train_step(
        apply, toptim.AdamWConfig(lr=1e-2, total_steps=150)),
        it.forever(), 150, log_every=1000).params
    preds, conf0, correct = tloop.evaluate_classifier(_tapply(cfg), params,
                                                      data.x, data.y)
    easy = correct.astype(np.float32)
    it = BatchIterator({"inputs": data.x, "targets": data.y,
                        "easy_mask": easy}, 256, seed=1)
    step = tloop.make_train_step(apply, toptim.AdamWConfig(
        lr=3e-3, total_steps=100), loss_kind="static_partition",
        gk_cfg=TGK(alpha=0.2))
    res = tloop.train(params, step, it.forever(), 100, log_every=50)
    assert res.history["step"] == [1, 50, 100]
    assert all(np.isfinite(res.history["loss"]))
    _, conf1, _ = tloop.evaluate_classifier(_tapply(cfg), res.params,
                                            data.x, data.y)
    hard = easy == 0
    assert conf1[hard].mean() < conf0[hard].mean()


# ---------------------------------------------------------------------------
# evaluate_classifier
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("hidden,batch", [((64, 64), 4096), ((256, 256), 1000)],
                         ids=["small", "large-3-batches"])
def test_evaluate_classifier_matches_jax(hidden, batch):
    """On test_system.py's JAX-drawn test split: predictions and
    correctness exactly JAX's (the port takes the first-index argmax of
    the logits, JAX the argmax of p: no row here has two probabilities
    that round equal), confidences to 1e-6."""
    test = j_make_classification(
        jax.random.fold_in(jax.random.PRNGKey(0), 1), 3000, n_classes=8,
        hard_frac=0.45)
    cfg = tcls.MLPClassifierConfig(d_in=test.x.shape[1], n_classes=8,
                                   hidden=hidden)
    jp, tp = _jinit(cfg, 1 if hidden == (64, 64) else 2)
    jpred, jconf, jcorr = jloop.evaluate_classifier(_japply(cfg), jp, test.x,
                                                    test.y, batch)
    tpred, tconf, tcorr = tloop.evaluate_classifier(_tapply(cfg), tp, test.x,
                                                    test.y, batch)
    assert tpred.shape == tconf.shape == tcorr.shape == (3000,)
    assert tcorr.dtype == np.float64 and tconf.dtype == np.float32
    np.testing.assert_array_equal(tpred, np.asarray(jpred))
    np.testing.assert_array_equal(tcorr, jcorr)
    np.testing.assert_allclose(tconf, jconf, rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# make_classification, by structure
# ---------------------------------------------------------------------------

def _class_from_signs(x_hard, n_bits, f):
    """The class a hard row encodes: bit j = the sign of the product of its
    j-th group of `f` factors."""
    s = np.sign(x_hard.reshape(len(x_hard), n_bits, f)).prod(-1)
    return ((s > 0).astype(np.int64) << np.arange(n_bits)).sum(-1)


@pytest.mark.parametrize("n_classes,f", [(16, 3), (8, 3), (10, 2)])
def test_make_classification_layout(n_classes, f):
    n = 4000
    d = make_classification([0, 5], n, n_classes=n_classes,
                            factors_per_bit=f)
    n_bits = int(np.ceil(np.log2(n_classes)))
    assert d.x.shape == (n, 16 + n_bits * f) and d.x.dtype == np.float32
    assert d.y.shape == (n,) and np.issubdtype(d.y.dtype, np.integer)
    assert d.is_hard.shape == (n,) and d.is_hard.dtype == np.bool_
    assert d.y.min() >= 0 and d.y.max() < n_classes
    sd = (0.45 * 0.55 / n) ** 0.5
    assert abs(d.is_hard.mean() - 0.45) < 3 * sd
    x_hard = d.x[:, 16:]
    h = d.is_hard
    np.testing.assert_array_equal(
        _class_from_signs(x_hard[h], n_bits, f), d.y[h])
    assert (np.abs(x_hard[h]) >= 0.5).all()
    # easy rows: the hard dims are plain N(0, 1), so about a third of them
    # lie under 0.5 in magnitude; hard rows' easy dims are pure noise
    assert (np.abs(x_hard[~h]) < 0.5).mean() > 0.3
    assert abs(d.x[h, :16].mean()) < 0.05
    assert d.x[h, :16].std() == pytest.approx(1.0, abs=0.05)


def test_make_classification_splits_share_the_task():
    """Two seeds: each class's easy rows centre on the same means; another
    task_seed moves them."""
    a = make_classification(0, 6000, n_classes=8)
    b = make_classification([0, 7], 6000, n_classes=8)
    c = make_classification(0, 6000, n_classes=8, task_seed=99)

    def means(d):
        e = ~d.is_hard
        return np.stack([d.x[e & (d.y == k), :16].mean(0) for k in range(8)])
    ma, mb, mc = means(a), means(b), means(c)
    assert np.abs(ma - mb).max() < 0.5
    assert np.abs(ma - mc).max() > 3.0
    assert not np.array_equal(a.x, b.x)


def test_make_classification_is_seeded():
    a = make_classification([3, 1], 500)
    b = make_classification([3, 1], 500)
    for f in ("x", "y", "is_hard"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    assert not np.array_equal(a.x, make_classification([3, 2], 500).x)
    assert not make_classification(0, 500, hard_frac=0.0).is_hard.any()


# ---------------------------------------------------------------------------
# tests/test_training.py's classifier cases, on JAX's arrays and weights
# ---------------------------------------------------------------------------

def test_classifier_trains_on_synthetic():
    key = jax.random.PRNGKey(0)
    data = j_make_classification(key, 2000, n_classes=4, hard_frac=0.0)
    cfg = tcls.MLPClassifierConfig(d_in=data.x.shape[1], n_classes=4,
                                   hidden=(32,))
    params = params_from_jax(jax.device_get(
        jcls.init_classifier(_jcfg(cfg), key)), device="cpu")
    step = tloop.make_train_step(
        lambda p, b: tcls.classifier_forward(p, cfg, b["inputs"]),
        toptim.AdamWConfig(lr=1e-2, total_steps=100), loss_kind="ce")
    it = BatchIterator({"inputs": data.x, "targets": data.y}, 128)
    res = tloop.train(params, step, it.forever(), 100, log_every=100)
    _, _, correct = tloop.evaluate_classifier(_tapply(cfg), res.params,
                                              data.x, data.y)
    assert correct.mean() > 0.9         # easy-only data is learnable


def test_gatekeeper_stage_reduces_incorrect_confidence():
    """Stage-2 fine-tuning raises entropy on incorrect predictions. The
    port's step updates its parameters in place, so each probe step runs
    on a copy (JAX's step returns new ones)."""
    key = jax.random.PRNGKey(1)
    data = j_make_classification(key, 3000, n_classes=8, hard_frac=0.5)
    cfg = tcls.MLPClassifierConfig(d_in=data.x.shape[1], n_classes=8,
                                   hidden=(16,))
    params = params_from_jax(jax.device_get(
        jcls.init_classifier(_jcfg(cfg), key)), device="cpu")
    apply_fn = lambda p, b: tcls.classifier_forward(p, cfg, b["inputs"])  # noqa: E731
    it = BatchIterator({"inputs": data.x, "targets": data.y}, 256)
    step1 = tloop.make_train_step(apply_fn, toptim.AdamWConfig(
        lr=1e-2, total_steps=150), loss_kind="ce")
    params = tloop.train(params, step1, it.forever(), 150,
                         log_every=200).params
    step2 = tloop.make_train_step(apply_fn, toptim.AdamWConfig(
        lr=3e-3, total_steps=100), loss_kind="gatekeeper",
        gk_cfg=TGK(alpha=0.2))
    batch = {"inputs": torch.from_numpy(np.array(data.x[:512])),
             "targets": torch.from_numpy(np.array(data.y[:512]))}
    probe = _clone(params)
    _, _, m0 = step2(probe, toptim.adamw_init(probe), batch)
    params2 = tloop.train(params, step2, it.forever(), 100,
                          log_every=200).params
    probe = _clone(params2)
    _, _, m1 = step2(probe, toptim.adamw_init(probe), batch)
    assert float(m1["mean_entropy_incorrect"]) > \
        float(m0["mean_entropy_incorrect"])


def test_jax_train_step_loss_is_the_mirrored_one(loss_case):
    """The JAX losses above are the ones JAX's `make_train_step` trains
    on: its step's metrics equal their aux at the same weights."""
    cfg, jp, _, full = loss_case
    batch = {k: jnp.asarray(full[k]) for k in ("inputs", "targets",
                                                "easy_mask", "loss_mask")}
    for kind, gk in (("gatekeeper", dict(alpha=0.3)),
                     ("static_partition", dict(alpha=0.3))):
        step = jloop.make_train_step(
            lambda p, b: _japply(cfg)(p, b["inputs"]), joptim.AdamWConfig(),
            loss_kind=kind, gk_cfg=jgk.GatekeeperConfig(**gk))
        _, _, m = step(jp, joptim.adamw_init(jp), batch)
        (loss, aux) = _jax_loss(cfg, kind, gk, batch)(jp)
        assert float(m["total_loss"]) == pytest.approx(float(loss), abs=1e-6)
        for k in aux:
            assert float(m[k]) == pytest.approx(float(aux[k]), abs=1e-6)
