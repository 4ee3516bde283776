"""The fused Gatekeeper-loss kernel's plain version and its autograd
function against the JAX package, on the same numpy inputs.

The token count is not a multiple of 128 and the vocabulary not a
multiple of 512, so the tails the CUDA kernel masks (and the Pallas
kernel pads) are exercised. The JAX kernel runs in interpret mode. Inputs
are drawn so that every row's top-2 logit gap exceeds 1e-3: no argmax tie
can flip `correct` between implementations.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.gatekeeper import GatekeeperConfig as JGK
from repro.kernels import ops as jops
from repro.kernels.gatekeeper_loss import \
    gatekeeper_loss_tokens as j_tokens
from repro.kernels.ref import gatekeeper_loss_ref
from repro.launch import steps as jsteps
from repro_torch.core.gatekeeper import GatekeeperConfig as TGK
from repro_torch.kernels import gatekeeper_loss as tk
from repro_torch.kernels import ops as tops
from repro_torch.launch import steps as tsteps

T, D, V = 200, 48, 1000          # T % 128 != 0, V % 512 != 0


def _case(seed, T=T, d=D, V=V, hot=3.0):
    """x [T, d], table [V, d], targets [T] with half the targets at the
    row's argmax (so both loss branches are populated) and no near-tie."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((T, d)).astype(np.float32)
    table = (rng.standard_normal((V, d)) * hot / np.sqrt(d)).astype(np.float32)
    logits = x.astype(np.float64) @ table.T.astype(np.float64)
    top2 = np.sort(logits, axis=1)[:, -2:]
    assert (top2[:, 1] - top2[:, 0]).min() > 1e-3, "near-tie: pick a seed"
    targets = rng.integers(0, V, size=T).astype(np.int32)
    hit = rng.random(T) < 0.5
    targets[hit] = logits.argmax(1)[hit]
    valid = (rng.random(T) > 0.25).astype(np.float32)
    return x, table, targets, valid


@pytest.fixture(scope="module")
def case():
    return _case(0)


def test_plain_matches_jax_ref_and_interpret_kernel(case):
    x, table, tgt, _ = case
    ce, kl, corr, ent = tk.gatekeeper_loss_tokens_plain(
        torch.from_numpy(x), torch.from_numpy(table), torch.from_numpy(tgt))
    ref = gatekeeper_loss_ref(jnp.asarray(x), jnp.asarray(table),
                              jnp.asarray(tgt), 0.5, jnp.ones((T,)))
    for name, got in (("ce", ce), ("kl", kl), ("entropy", ent)):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref[name]),
                                   atol=1e-5, rtol=0, err_msg=name)
    np.testing.assert_array_equal(corr.numpy(), np.asarray(ref["correct"]))
    assert 0.3 < float(corr.mean()) < 0.7
    # the Pallas kernel itself (interpret mode), token tail padded to 8
    Tp = -(-T // 8) * 8
    xp = np.pad(x, ((0, Tp - T), (0, 0)))
    tp = np.pad(tgt, (0, Tp - T))
    outs = j_tokens(jnp.asarray(xp), jnp.asarray(table), jnp.asarray(tp),
                    tb=8, vb=512, db=D, interpret=True)
    for name, got, want in zip(("ce", "kl", "correct", "entropy"),
                               (ce, kl, corr, ent), outs):
        np.testing.assert_allclose(got.numpy(), np.asarray(want)[:T],
                                   atol=1e-5, rtol=0, err_msg=name)


def test_wrapper_uses_plain_version_on_cpu(case):
    x, table, tgt, _ = case
    n = tk.gatekeeper_loss_tokens.launches
    args = (torch.from_numpy(x), torch.from_numpy(table),
            torch.from_numpy(tgt))
    got = tk.gatekeeper_loss_tokens(*args, return_lse=True)
    want = tk.gatekeeper_loss_tokens_plain(*args, return_lse=True)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, atol=0, rtol=0)
    assert tk.gatekeeper_loss_tokens.launches == n     # plain calls never count
    assert len(tops.gatekeeper_loss_tokens(*args)) == 4


@pytest.mark.parametrize("masked", [False, True], ids=["all-valid", "valid"])
def test_fused_loss_and_aux_match_jax_ops(case, masked):
    x, table, tgt, valid = case
    v = valid if masked else None
    lj, aj = jops.gatekeeper_loss_fused(
        jnp.asarray(x), jnp.asarray(table), jnp.asarray(tgt),
        None if v is None else jnp.asarray(v), alpha=0.3, tb=64, vb=512,
        db=D, interpret=True)
    lt, at = tops.gatekeeper_loss_fused(
        torch.from_numpy(x), torch.from_numpy(table), torch.from_numpy(tgt),
        None if v is None else torch.from_numpy(v), alpha=0.3)
    assert abs(float(lt) - float(lj)) <= 1e-5
    assert set(at) == set(aj)
    for k in aj:
        np.testing.assert_allclose(np.asarray(at[k]), np.asarray(aj[k]),
                                   atol=1e-5, rtol=0, err_msg=k)


def _jax_chunked_grads(x, table, tgt, valid, alpha):
    def f(xx, tb):
        return jsteps.chunked_gatekeeper_loss(
            xx[None], tb, jnp.asarray(tgt)[None], JGK(alpha=alpha),
            None if valid is None else jnp.asarray(valid)[None])
    (loss, aux), (gx, gt) = jax.value_and_grad(f, argnums=(0, 1),
                                               has_aux=True)(
        jnp.asarray(x), jnp.asarray(table))
    return loss, aux, np.asarray(gx), np.asarray(gt)


@pytest.mark.parametrize("masked", [False, True], ids=["all-valid", "valid"])
def test_fused_gradients_match_jax_chunked(case, masked):
    """dx and dtable of the autograd function (plain forward on the CPU,
    chunked backward) against jax.grad of JAX's `chunked_gatekeeper_loss`,
    atol 1e-5; with bf16 x the gradient comes back in bf16."""
    x, table, tgt, valid = case
    v = valid if masked else None
    lj, _, gxj, gtj = _jax_chunked_grads(x, table, tgt, v, 0.3)
    xt = torch.from_numpy(x).requires_grad_(True)
    tt = torch.from_numpy(table).requires_grad_(True)
    loss, _ = tops.gatekeeper_loss_fused(
        xt, tt, torch.from_numpy(tgt),
        None if v is None else torch.from_numpy(v), alpha=0.3)
    loss.backward()
    assert abs(float(loss.detach()) - float(lj)) <= 1e-5
    np.testing.assert_allclose(xt.grad.numpy(), gxj, atol=1e-5, rtol=0)
    np.testing.assert_allclose(tt.grad.numpy(), gtj, atol=1e-5, rtol=0)
    xb = torch.from_numpy(x).bfloat16().requires_grad_(True)
    tops.gatekeeper_loss_fused(xb, torch.from_numpy(table),
                               torch.from_numpy(tgt), alpha=0.3)[0].backward()
    assert xb.grad.dtype == torch.bfloat16


def test_backward_chunks_cover_a_vocab_tail(case, monkeypatch):
    """A backward chunk that does not divide V gives the same gradients."""
    x, table, tgt, valid = case
    grads = []
    for chunk in (tk.BACKWARD_CHUNK, 96):
        monkeypatch.setattr(tk, "BACKWARD_CHUNK", chunk)
        xt = torch.from_numpy(x).requires_grad_(True)
        tt = torch.from_numpy(table).requires_grad_(True)
        tops.gatekeeper_loss_fused(xt, tt, torch.from_numpy(tgt),
                                   torch.from_numpy(valid))[0].backward()
        grads.append((xt.grad, tt.grad))
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=0)


@pytest.mark.parametrize("masked", [False, True], ids=["all-valid", "valid"])
def test_chunked_loss_matches_jax(case, masked):
    """The port's two-pass `chunked_gatekeeper_loss`: loss, aux and
    autograd gradients against JAX's, atol 1e-5."""
    x, table, tgt, valid = case
    v = valid if masked else None
    lj, aj, gxj, gtj = _jax_chunked_grads(x, table, tgt, v, 0.3)
    xt = torch.from_numpy(x).requires_grad_(True)
    tt = torch.from_numpy(table).requires_grad_(True)
    lt, at = tsteps.chunked_gatekeeper_loss(
        xt[None], tt, torch.from_numpy(tgt)[None], TGK(alpha=0.3),
        None if v is None else torch.from_numpy(v)[None])
    lt.backward()
    assert abs(float(lt.detach()) - float(lj)) <= 1e-5
    assert set(at) == set(aj)
    for k in aj:
        assert abs(float(at[k].detach()) - float(aj[k])) <= 1e-5, k
    np.testing.assert_allclose(xt.grad.numpy(), gxj, atol=1e-5, rtol=0)
    np.testing.assert_allclose(tt.grad.numpy(), gtj, atol=1e-5, rtol=0)


def test_fused_and_chunked_step_losses_agree(case):
    """`launch.steps.fused_gatekeeper_loss` returns the chunked loss's
    keys and values (the switch `loss_kernel` flips between them)."""
    x, table, tgt, valid = case
    args = (torch.from_numpy(x)[None], torch.from_numpy(table),
            torch.from_numpy(tgt)[None], TGK(alpha=0.4),
            torch.from_numpy(valid)[None])
    lf, af = tsteps.fused_gatekeeper_loss(*args)
    lc, ac = tsteps.chunked_gatekeeper_loss(*args)
    assert set(af) == set(ac)
    assert abs(float(lf) - float(lc)) <= 1e-5
    for k in ac:
        assert abs(float(af[k]) - float(ac[k])) <= 1e-5, k


@pytest.mark.parametrize("T_,V_,sms", [(2048, 92544, 132), (200, 1000, 132),
                                       (7, 130, 4)])
def test_vocab_split_covers_vocab_with_whole_tiles(T_, V_, sms):
    per, n = tk.vocab_split(T_, V_, sms)
    tiles = -(-V_ // 128)
    assert per * (n - 1) < tiles <= per * n
    assert n * -(-T_ // 128) >= min(4 * sms, tiles * -(-T_ // 128)) or n == tiles
