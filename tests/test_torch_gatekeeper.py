"""The port's Gatekeeper loss (`repro_torch.core.gatekeeper`) and optimizer
(`repro_torch.training.optim`) against the JAX package on the same numpy
inputs: every loss and aux key, hard and soft targets, label smoothing,
padding masks, the all-correct and all-incorrect cases and the gradients
of both branches (atol 1e-6), the learning-rate schedules, clipping and
one AdamW update on the same tree (atol 1e-6)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import gatekeeper as jgk
from repro.training import optim as joptim
from repro_torch.core import gatekeeper as tgk
from repro_torch.training import optim as toptim

ATOL = 1e-6


def _logits_labels(seed, shape=(64,), c=10, scale=2.0):
    rng = np.random.default_rng(seed)
    logits = (rng.standard_normal(shape + (c,)) * scale).astype(np.float32)
    labels = rng.integers(0, c, size=shape).astype(np.int32)
    return logits, labels


def _both(fn_j, fn_t, *arrays, **kw):
    out_j = fn_j(*(jnp.asarray(a) for a in arrays), **kw)
    out_t = fn_t(*(torch.from_numpy(np.array(a)) for a in arrays), **kw)
    return out_j, out_t


def _assert_aux(aux_j, aux_t, atol=ATOL):
    assert set(aux_j) == set(aux_t)
    for k in aux_j:
        np.testing.assert_allclose(float(aux_t[k]), float(aux_j[k]),
                                   atol=atol, rtol=0, err_msg=k)


@pytest.mark.parametrize("fn", ["cross_entropy", "kl_to_uniform",
                                "predictive_entropy"])
def test_per_example_terms_match_jax(fn):
    logits, labels = _logits_labels(0)
    if fn == "cross_entropy":
        for ls in (0.0, 0.1):
            j, t = _both(lambda a, b: jgk.cross_entropy(a, b, ls),
                         lambda a, b: tgk.cross_entropy(a, b, ls),
                         logits, labels)
            np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=ATOL)
    else:
        j, t = _both(getattr(jgk, fn), getattr(tgk, fn), logits)
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=ATOL)


def test_soft_cross_entropy_matches_jax():
    logits, _ = _logits_labels(1, c=6)
    probs = np.asarray(jax.nn.softmax(jnp.asarray(_logits_labels(2, c=6)[0])))
    j, t = _both(jgk.soft_cross_entropy, tgk.soft_cross_entropy, logits, probs)
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=ATOL)


@pytest.mark.parametrize("cfg_kw", [
    dict(alpha=0.5), dict(alpha=0.2), dict(alpha=0.7, label_smoothing=0.1),
    dict(alpha=0.4, mask_pad=0)], ids=["a0.5", "a0.2", "smooth", "mask_pad"])
@pytest.mark.parametrize("token_level", [False, True])
def test_gatekeeper_loss_and_aux_match_jax(cfg_kw, token_level):
    shape = (4, 9) if token_level else (64,)
    logits, labels = _logits_labels(3, shape=shape, c=17)
    if token_level:
        labels[:, -3:] = 0                       # pad id 0 at the tail
    valid = (np.random.default_rng(4).random(shape) > 0.2).astype(np.float32)
    for vm in (None, valid):
        (lj, aj) = jgk.gatekeeper_loss(
            jnp.asarray(logits), jnp.asarray(labels),
            jgk.GatekeeperConfig(**cfg_kw),
            None if vm is None else jnp.asarray(vm))
        (lt, at) = tgk.gatekeeper_loss(
            torch.from_numpy(logits), torch.from_numpy(labels),
            tgk.GatekeeperConfig(**cfg_kw),
            None if vm is None else torch.from_numpy(vm))
        assert abs(float(lt) - float(lj)) <= ATOL
        _assert_aux(aj, at)


def test_soft_target_loss_matches_jax():
    logits, _ = _logits_labels(5, c=6)
    teacher = np.array(jax.nn.softmax(
        jnp.asarray(_logits_labels(6, c=6)[0])))
    cfg = dict(alpha=0.5, soft_targets=True)
    lj, aj = jgk.gatekeeper_loss(jnp.asarray(logits), jnp.asarray(teacher),
                                 jgk.GatekeeperConfig(**cfg))
    lt, at = tgk.gatekeeper_loss(torch.from_numpy(logits),
                                 torch.from_numpy(teacher),
                                 tgk.GatekeeperConfig(**cfg))
    assert abs(float(lt) - float(lj)) <= ATOL
    _assert_aux(aj, at)


@pytest.mark.parametrize("shift,branch", [(0, "l_incorr"), (1, "l_corr")],
                         ids=["all-correct", "all-incorrect"])
def test_single_branch_cases_match_jax(shift, branch):
    logits = (np.eye(8) * 10.0).astype(np.float32)
    labels = ((np.arange(8) + shift) % 8).astype(np.int32)
    lj, aj = jgk.gatekeeper_loss(jnp.asarray(logits), jnp.asarray(labels),
                                 jgk.GatekeeperConfig(alpha=0.7))
    lt, at = tgk.gatekeeper_loss(torch.from_numpy(logits),
                                 torch.from_numpy(labels),
                                 tgk.GatekeeperConfig(alpha=0.7))
    assert float(at[branch]) == 0.0
    assert float(at["frac_correct"]) == (1.0 if shift == 0 else 0.0)
    assert abs(float(lt) - float(lj)) <= ATOL
    _assert_aux(aj, at)


@pytest.mark.parametrize("labels", [[1], [0]], ids=["incorrect", "correct"])
def test_gradients_of_both_branches_match_jax(labels):
    """d loss / d logits for an incorrect (KL branch) and a correct (CE
    branch) example, and the batch case mixing both."""
    cases = [(np.array([[4.0, 0.0, 0.0]], np.float32),
              np.array(labels, np.int32))]
    cases.append(_logits_labels(7, shape=(16,), c=5))
    for logits, lab in cases:
        cfg_j, cfg_t = jgk.GatekeeperConfig(0.5), tgk.GatekeeperConfig(0.5)
        gj = jax.grad(lambda z: jgk.gatekeeper_loss(
            z, jnp.asarray(lab), cfg_j)[0])(jnp.asarray(logits))
        z = torch.from_numpy(logits).requires_grad_(True)
        tgk.gatekeeper_loss(z, torch.from_numpy(lab), cfg_t)[0].backward()
        np.testing.assert_allclose(z.grad.numpy(), np.asarray(gj), atol=ATOL)


def test_standard_ce_loss_matches_jax():
    logits, labels = _logits_labels(8, shape=(4, 7), c=11)
    mask = (np.random.default_rng(9).random((4, 7)) > 0.3).astype(np.float32)
    for vm in (None, mask):
        lj, aj = jgk.standard_ce_loss(jnp.asarray(logits), jnp.asarray(labels),
                                      None if vm is None else jnp.asarray(vm))
        lt, at = tgk.standard_ce_loss(torch.from_numpy(logits),
                                      torch.from_numpy(labels),
                                      None if vm is None
                                      else torch.from_numpy(vm))
        assert abs(float(lt) - float(lj)) <= ATOL
        _assert_aux(aj, at)


@pytest.mark.parametrize("schedule", ["constant", "cosine", "linear"])
def test_schedule_matches_jax(schedule):
    kw = dict(lr=1e-3, warmup_steps=10, total_steps=100, schedule=schedule,
              min_lr_ratio=0.1)
    cj, ct = joptim.AdamWConfig(**kw), toptim.AdamWConfig(**kw)
    for s in (0, 1, 5, 10, 11, 50, 99, 100, 150):
        a = float(joptim.schedule_lr(cj, jnp.asarray(s)))
        b = float(toptim.schedule_lr(ct, torch.tensor(s)))
        assert abs(a - b) <= 1e-9, (s, a, b)


def _tree(seed):
    rng = np.random.default_rng(seed)
    return {"w": rng.standard_normal((5, 3)).astype(np.float32),
            "blocks": {"b": rng.standard_normal(7).astype(np.float32),
                       "a": rng.standard_normal((2, 2)).astype(np.float32)}}


@pytest.mark.parametrize("clip", [None, 1.0, 1e3], ids=["noclip", "clip",
                                                        "noop-clip"])
def test_adamw_update_matches_jax(clip):
    """Two updates on identical trees and grads (step 1 and step 2, so the
    moments carry over): params, moments, lr and grad norm to 1e-6."""
    params, g1, g2 = _tree(0), _tree(1), _tree(2)
    kw = dict(lr=1e-2, warmup_steps=1, total_steps=10, clip_norm=clip)
    cj, ct = joptim.AdamWConfig(**kw), toptim.AdamWConfig(**kw)
    to_j = lambda t: jax.tree.map(jnp.asarray, t)            # noqa: E731
    to_t = lambda t: toptim.tree_map(torch.from_numpy, t)    # noqa: E731
    pj, sj = to_j(params), joptim.adamw_init(to_j(params))
    pt = toptim.tree_map(lambda a: torch.from_numpy(a.copy()), params)
    st = toptim.adamw_init(pt)
    for g in (g1, g2):
        pj, sj, mj = joptim.adamw_update(cj, to_j(g), sj, pj)
        pt, st, mt = toptim.adamw_update(ct, to_t(g), st, pt)
        for k in ("lr", "grad_norm"):
            assert abs(float(mt[k]) - float(mj[k])) <= ATOL * max(
                1.0, abs(float(mj[k]))), k
    for a, b in zip(jax.tree.leaves(pj), toptim.tree_leaves(pt)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=ATOL)
    for a, b in zip(jax.tree.leaves(sj.nu), toptim.tree_leaves(st.nu)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=ATOL)
    assert int(st.step) == int(sj.step) == 2


def test_sgd_update_matches_jax():
    params, g = _tree(3), _tree(4)
    cfg = dict(lr=0.1, momentum=0.9, weight_decay=0.01)
    pj = jax.tree.map(jnp.asarray, params)
    vj = joptim.sgd_init(pj)
    pt = toptim.tree_map(lambda a: torch.from_numpy(a.copy()), params)
    vt = toptim.sgd_init(pt)
    for _ in range(2):
        pj, vj = joptim.sgd_update(joptim.SGDConfig(**cfg),
                                   jax.tree.map(jnp.asarray, g), vj, pj)
        pt, vt = toptim.sgd_update(toptim.SGDConfig(**cfg),
                                   toptim.tree_map(torch.from_numpy, g), vt, pt)
    for a, b in zip(jax.tree.leaves(pj), toptim.tree_leaves(pt)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=ATOL)


def test_grad_clip_reports_unclipped_norm():
    params = {"w": torch.zeros(4)}
    state = toptim.adamw_init(params)
    _, _, m = toptim.adamw_update(toptim.AdamWConfig(clip_norm=1.0),
                                  {"w": torch.full((4,), 100.0)}, state, params)
    assert float(m["grad_norm"]) == pytest.approx(200.0)


def test_adamw_converges_quadratic():
    params = {"w": torch.tensor([5.0, -3.0])}
    cfg = toptim.AdamWConfig(lr=0.1, weight_decay=0.0, schedule="constant",
                             warmup_steps=0, clip_norm=None)
    state = toptim.adamw_init(params)
    for _ in range(300):
        params, state, _ = toptim.adamw_update(
            cfg, {"w": 2 * params["w"]}, state, params)
    assert float(params["w"].abs().max()) < 0.05
