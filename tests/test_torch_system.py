"""The paper's headline claim on the port, on the CPU.

Gatekeeper fine-tuning at low alpha raises deferral performance s_d and
the correct/incorrect separation (AUROC up, s_o down) over the untuned
M_S, and a cascade at a 30% deferral budget beats M_S alone for less than
always calling M_L (paper Figs. 4-6).

The first three tests mirror tests/test_system.py with its assertions
unchanged. Their margins are about 1% for s_d and AUROC, so the port
starts where JAX does: JAX's `make_classification` splits, JAX's
`init_classifier` weights (carried over by `params_from_jax`) and JAX's
batch order (the port's iterator seeded with the integer JAX's draws from
its key); the port trains and evaluates. The last test runs the same
flow on the port's own draw and init (seed 0) and holds the claims with
wide margins: the accuracy gap, s_o down, and the cascade.
"""
import jax
import numpy as np
import pytest
import torch

from repro.data.synthetic import make_classification as j_make_classification
from repro.models import classifier as jcls
from repro_torch.convert import params_from_jax
from repro_torch.core.cascade import Cascade
from repro_torch.core.gatekeeper import GatekeeperConfig
from repro_torch.core.metrics import summarize_deferral
from repro_torch.data.pipeline import BatchIterator
from repro_torch.data.synthetic import make_classification
from repro_torch.models.classifier import (MLPClassifierConfig,
                                           classifier_forward,
                                           init_classifier)
from repro_torch.training import optim
from repro_torch.training.loop import (evaluate_classifier, make_train_step,
                                       train)

torch.set_num_threads(1)
SPLITS = {"train": (None, 2000), "train_large": (5, 12000),
          "cal": (7, 3000), "test": (1, 3000)}   # name: (fold, rows)


def _jax_batch_seed(seed: int) -> int:
    """The numpy seed JAX's BatchIterator draws from PRNGKey(seed)."""
    return int(jax.random.randint(jax.random.PRNGKey(seed), (), 0,
                                  2**31 - 1))


def _configs(d_in):
    return (MLPClassifierConfig(d_in=d_in, n_classes=8, hidden=(64, 64)),
            MLPClassifierConfig(d_in=d_in, n_classes=8, hidden=(256, 256)))


def _fit(cfg, data, params, batch_seed, steps):
    it = BatchIterator({"inputs": data.x, "targets": data.y}, 256,
                       seed=batch_seed)
    step = make_train_step(lambda p, b: classifier_forward(p, cfg,
                                                           b["inputs"]),
                           optim.AdamWConfig(lr=3e-3, total_steps=steps),
                           loss_kind="ce")
    return train(params, step, it.forever(), steps, log_every=1000).params


def _setup(data, small0, large0, seeds):
    """M_S: small MLP trained to interpolation on few samples; M_L: larger
    MLP on more data."""
    s_cfg, l_cfg = _configs(data["train"].x.shape[1])
    small = _fit(s_cfg, data["train"], small0, seeds[1], 1500)
    large = _fit(l_cfg, data["train_large"], large0, seeds[2], 2500)
    return dict(cal=data["cal"], test=data["test"], s_cfg=s_cfg,
                l_cfg=l_cfg, small=small, large=large, seeds=seeds)


@pytest.fixture(scope="module")
def cascade_setup():
    """tests/test_system.py's setup from JAX's arrays, weights and batch
    order, trained by the port."""
    key = jax.random.PRNGKey(0)
    data = {name: j_make_classification(
        key if fold is None else jax.random.fold_in(key, fold), n,
        n_classes=8, hard_frac=0.45) for name, (fold, n) in SPLITS.items()}
    s_cfg, l_cfg = _configs(data["train"].x.shape[1])
    small0, large0 = (params_from_jax(jax.device_get(jcls.init_classifier(
        jcls.MLPClassifierConfig(cfg.d_in, cfg.n_classes, cfg.hidden),
        jax.random.PRNGKey(seed))), device="cpu")
        for cfg, seed in ((s_cfg, 1), (l_cfg, 2)))
    return _setup(data, small0, large0,
                  {s: _jax_batch_seed(s) for s in (1, 2, 7)})


@pytest.fixture(scope="module")
def own_setup():
    """The same flow on the port's own draw and init, seed 0: the splits
    from [0, fold], the weights and batch order from the seeds JAX's keys
    hold."""
    data = {name: make_classification(0 if fold is None else [0, fold], n,
                                      n_classes=8, hard_frac=0.45)
            for name, (fold, n) in SPLITS.items()}
    s_cfg, l_cfg = _configs(data["train"].x.shape[1])
    return _setup(data, init_classifier(s_cfg, 1, "cpu"),
                  init_classifier(l_cfg, 2, "cpu"), {1: 1, 2: 2, 7: 7})


def _tune(setup):
    """Stage 2 on a copy of M_S (the port's steps update in place)."""
    s_cfg = setup["s_cfg"]
    params = {k: v.clone() for k, v in setup["small"].items()}
    it = BatchIterator({"inputs": setup["cal"].x,
                        "targets": setup["cal"].y}, 256,
                       seed=setup["seeds"][7])
    step = make_train_step(lambda p, b: classifier_forward(p, s_cfg,
                                                           b["inputs"]),
                           optim.AdamWConfig(lr=5e-3, total_steps=1500),
                           loss_kind="gatekeeper",
                           gk_cfg=GatekeeperConfig(alpha=0.1))
    return train(params, step, it.forever(), 1500, log_every=10000).params


def _deferral_metrics(setup, small_params):
    s_cfg, l_cfg = setup["s_cfg"], setup["l_cfg"]
    test = setup["test"]
    _, sconf, scorr = evaluate_classifier(
        lambda p, x: classifier_forward(p, s_cfg, x), small_params,
        test.x, test.y)
    _, _, lcorr = evaluate_classifier(
        lambda p, x: classifier_forward(p, l_cfg, x), setup["large"],
        test.x, test.y)
    return summarize_deferral(sconf, scorr, lcorr)


def _run_cascade(setup):
    """Calibrate at 30% deferral on 1000 test rows, predict the other
    2000 sparsely: (joint accuracy, M_S accuracy, result)."""
    s_cfg, l_cfg = setup["s_cfg"], setup["l_cfg"]
    test = setup["test"]
    c = Cascade(
        small_apply=lambda p, x: classifier_forward(p, s_cfg, x),
        large_apply=lambda p, x: classifier_forward(p, l_cfg, x),
        small_params=setup["small"], large_params=setup["large"],
        signal="max_softmax", cost_small=0.2)
    c.calibrate_tau(torch.from_numpy(np.array(test.x[:1000])),
                    deferral_ratio=0.3)
    res = c.predict_sparse(torch.from_numpy(np.array(test.x[1000:])))
    y = test.y[1000:]
    return ((res.predictions == y).mean(),
            (res.small_predictions == y).mean(), res)


def _report(label, base, gk):
    print(f"\n{label}: " + ", ".join(
        f"{k} {base[k]:.4f} -> {gk[k]:.4f}"
        for k in ("acc_small", "acc_large", "s_d", "auroc", "s_o")))


def test_capacity_gap_exists(cascade_setup):
    """Setup sanity: M_L is genuinely stronger than M_S (paper assumption)."""
    base = _deferral_metrics(cascade_setup, cascade_setup["small"])
    assert base["acc_large"] > base["acc_small"] + 0.1


def test_gatekeeper_improves_deferral(cascade_setup):
    """Gatekeeper (alpha=0.1) improves s_d and AUROC, reduces s_o vs the
    untuned baseline — the paper's central claim."""
    setup = cascade_setup
    base = _deferral_metrics(setup, setup["small"])
    gk = _deferral_metrics(setup, _tune(setup))
    _report("JAX's draw, init and batch order", base, gk)
    assert gk["s_d"] > base["s_d"], (gk["s_d"], base["s_d"])
    assert gk["auroc"] > base["auroc"]
    assert gk["s_o"] < base["s_o"]


def test_cascade_end_to_end_cost_accuracy(cascade_setup):
    """At a 30% deferral budget the cascade beats M_S alone on accuracy and
    costs less than always calling M_L."""
    acc_joint, acc_small, res = _run_cascade(cascade_setup)
    assert acc_joint > acc_small
    assert res.compute_cost < 1.0


def test_headline_on_the_ports_own_draw(own_setup):
    """The claims with wide margins in JAX's run, on the port's own data
    and weights: the accuracy gap, s_o down after tuning, and the cascade
    beating M_S at cost < 1. s_d and AUROC are printed, not held."""
    setup = own_setup
    base = _deferral_metrics(setup, setup["small"])
    gk = _deferral_metrics(setup, _tune(setup))
    acc_joint, acc_small, res = _run_cascade(setup)
    _report("the port's own draw", base, gk)
    print(f"cascade: joint accuracy {acc_joint:.4f} against M_S "
          f"{acc_small:.4f} at deferral {res.deferral_ratio:.4f}, cost "
          f"{res.compute_cost:.4f}")
    assert base["acc_large"] > base["acc_small"] + 0.1
    assert gk["s_o"] < base["s_o"]
    assert acc_joint > acc_small
    assert res.compute_cost < 1.0
