"""`remat` and `attn_chunk` in the port on the CPU against the JAX package.

`remat` "none", "full" and "dots" give bit-equal gradients on reduced
dense, MoE, RWKV6, hybrid and encoder-decoder configs (the recompute runs
the same ops on the same inputs: tolerance 0), each layer recomputed once
under "full" and "dots"; the port's gradients under each mode match JAX
run with the same `remat` within ``1e-4 * max|g_leaf|`` plus rtol 1e-4
(REMAT_JAX_ATOL_OF_MAX: the readings); a bad value raises
ValueError in both packages. `_attend` with a chunk against JAX's
(`_attend_chunked`, mirroring tests/test_kernels.py's chunked-attention
property): causal, sliding and cache masks, fully masked rows, and Tk the
chunk does not divide; `mla_forward` with `attn_chunk` against JAX's
(mirroring tests/test_kernels.py::test_mla_chunked_matches_dense); and a
Stage-2 loss and its gradients with `attn_chunk` through a GQA and an MLA
model. Weights are JAX's, carried over by `params_from_jax`.
"""
import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from repro.configs import get_config, reduced
from repro.core.gatekeeper import GatekeeperConfig as JGK
from repro.launch import steps as jsteps
from repro.models import attention as jattn
from repro.models import common as jcommon
from repro.models import transformer as jtfm
from repro.sharding import ParallelContext
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs import reduced as t_reduced
from repro_torch.convert import params_from_jax
from repro_torch.core.gatekeeper import GatekeeperConfig as TGK
from repro_torch.launch import steps as tsteps
from repro_torch.models import attention as tattn
from repro_torch.models import ssm as tssm
from repro_torch.models import transformer as ttfm
from repro_torch.training import optim as toptim

torch.set_num_threads(1)
CTX = ParallelContext()
ATOL = 1e-5
GRAD_RTOL = 1e-4
ATTN_ATOL, ATTN_RTOL = 3e-5, 2e-4   # tests/test_kernels.py's chunked bound
REMAT_JAX_ATOL_OF_MAX = 1e-4  # the fixture's uniform targets leave every
                              # gradient small: max|d g| / max|g| per leaf
                              # read 7.6e-6 dense, 8.9e-6 MoE, 7.6e-6 encdec,
                              # 1.5e-5 hybrid, 5.5e-5 RWKV6 (`wv`; its
                              # per-step scan at T 8), the same under every
                              # remat mode: fp32 sums in other orders
FAMILIES = {"dense": "internlm2-1.8b", "moe": "deepseek-v2-236b",
            "rwkv": "rwkv6-3b", "hybrid": "zamba2-1.2b",
            "encdec": "whisper-small"}
MODES = ("none", "full", "dots")


def _named(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_named(tree[k], f"{prefix}/{k}"))
        return out
    return {prefix: np.asarray(tree)}


@pytest.fixture(scope="module", params=list(FAMILIES))
def family(request):
    """(JAX cfg, port cfg, JAX params, a numpy batch of 2 x 8 tokens, with
    stub frames for the encoder-decoder)."""
    arch = FAMILIES[request.param]
    cfg = reduced(get_config(arch))
    tcfg = t_reduced(t_get_config(arch))
    jparams = jax.device_get(jtfm.init_params(cfg, jax.random.PRNGKey(3)))
    rng = np.random.default_rng(4)
    B, T = 2, 8
    batch = {k: rng.integers(0, cfg.vocab_size, (B, T)).astype(np.int32)
             for k in ("tokens", "targets")}
    if cfg.family == "encdec":
        batch["frames"] = rng.standard_normal(
            (B, cfg.encoder.n_frames, cfg.d_model)).astype(np.float32)
    return cfg, tcfg, jparams, batch


def _port_grads(tcfg, jparams, batch, remat):
    loss_fn = tsteps.make_loss_fn(tcfg.replace(remat=remat), TGK(alpha=0.3),
                                  0.01, loss_kernel=False)
    tb = {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}
    (loss, _), grads = toptim.value_and_grad(
        loss_fn, params_from_jax(jparams, "cpu"), tb)
    return loss, grads


def _block_counter(monkeypatch, tcfg):
    """Count calls of the function each layer runs (its forward and each
    recompute)."""
    calls = []
    if tcfg.family == "ssm_rwkv":
        mod, name = tssm, "rwkv_block_forward"
    elif tcfg.family == "hybrid":
        mod, name = tssm, "mamba2_block_forward"
    elif tcfg.family == "encdec":
        mod, name = tattn, "cross_attn_forward"
    else:
        mod, name = ttfm, "_attn_ffn_block"
    inner = getattr(mod, name)

    def counted(*a, **kw):
        calls.append(1)
        return inner(*a, **kw)
    monkeypatch.setattr(mod, name, counted)
    return calls


@pytest.mark.parametrize("remat", ["full", "dots"])
def test_remat_gives_equal_gradients(family, remat, monkeypatch):
    """Each mode's loss and every gradient leaf equal "none"'s bit for bit,
    and every layer (the decoder's, for the encoder-decoder: its
    cross-attention counts them) runs once more in the backward."""
    _, tcfg, jparams, batch = family
    loss0, g0 = _port_grads(tcfg, jparams, batch, "none")
    calls = _block_counter(monkeypatch, tcfg)
    loss, g = _port_grads(tcfg, jparams, batch, remat)
    assert torch.equal(loss, loss0)
    n0, n = _named(toptim.tree_map(lambda t: t.numpy(), g0)), \
        _named(toptim.tree_map(lambda t: t.numpy(), g))
    assert n.keys() == n0.keys()
    for k in n0:
        np.testing.assert_array_equal(n[k], n0[k], err_msg=k)
    assert len(calls) == 2 * tcfg.n_layers


@pytest.mark.parametrize("remat", MODES)
def test_remat_matches_jax(family, remat):
    """The Stage-2 loss and its gradients under `remat` against JAX's
    `make_loss_fn` path with the same `remat` (its scanned layers under
    `jax.checkpoint`)."""
    cfg, tcfg, jparams, batch = family
    jcfg = cfg.replace(remat=remat)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    def j_loss(params):
        x, model_aux, mask = jsteps._final_hidden(params, jcfg, jb, CTX)
        table = params.get("unembed", params["embedding"])
        loss, _ = jsteps.chunked_gatekeeper_loss(
            x, table, jsteps._pad_targets(jcfg, jb, x.shape[1]),
            JGK(alpha=0.3), mask)
        return loss + 0.01 * model_aux
    lj, gj = jax.value_and_grad(j_loss)(jparams)
    lt, gt = _port_grads(tcfg, jparams, batch, remat)
    assert abs(float(lt) - float(lj)) <= ATOL * max(1.0, abs(float(lj)))
    nj, nt = _named(gj), _named(toptim.tree_map(lambda t: t.numpy(), gt))
    assert nj.keys() == nt.keys()
    for name in nj:
        scale = float(np.abs(nj[name]).max())
        np.testing.assert_allclose(nt[name], nj[name], rtol=GRAD_RTOL,
                                   atol=REMAT_JAX_ATOL_OF_MAX * scale + 1e-12,
                                   err_msg=name)


def test_bad_remat_raises_in_both_packages():
    cfg = reduced(get_config("internlm2-1.8b")).replace(remat="some")
    tcfg = t_reduced(t_get_config("internlm2-1.8b")).replace(remat="some")
    tokens = np.zeros((1, 4), np.int32)
    with pytest.raises(ValueError):
        jtfm.forward(jtfm.init_params(cfg, jax.random.PRNGKey(0)), cfg,
                     jnp.asarray(tokens), CTX)
    params = ttfm.init_params(tcfg, 0, "cpu")
    with pytest.raises(ValueError, match="some"):
        ttfm.forward(params, tcfg, torch.from_numpy(tokens))
    with torch.no_grad(), pytest.raises(ValueError):
        ttfm.forward(params, tcfg, torch.from_numpy(tokens))


def test_remat_leaves_serving_unchanged():
    """Serving runs under inference mode, where `_maybe_remat` is the
    layer itself: prefill and a decode step with `remat="full"` equal
    "none"'s bit for bit."""
    tcfg = t_reduced(t_get_config("rwkv6-3b"))
    params = ttfm.init_params(tcfg, 0, "cpu")
    tok = torch.randint(0, tcfg.vocab_size, (2, 6),
                        generator=torch.Generator().manual_seed(0))
    out = {}
    for remat in ("none", "full"):
        c = tcfg.replace(remat=remat)
        cache = ttfm.init_cache(c, 2, 16, device="cpu")
        logits, cache = ttfm.prefill(params, c, tok, cache)
        step, _ = ttfm.decode_step(params, c, tok[:, -1], 6, cache)
        out[remat] = (logits, step)
    assert all(torch.equal(a, b) for a, b in zip(out["none"], out["full"]))
    fn = object()
    with torch.no_grad():
        assert ttfm._maybe_remat(fn, tcfg.replace(remat="full")) is fn


# ---------------------------------------------------------------------------
# attn_chunk
# ---------------------------------------------------------------------------

def _attn_case(mode, seed, Tq=512):
    """q [2, Tq, 8, 32] over k, v [2, Tk, 4, 32] and a mask, as
    tests/test_kernels.py's property draws them (numpy here): "causal",
    "sliding" (window 128), "cache" (Tk 1024 at q offset 100), "masked"
    (causal with every third query row fully masked), "odd" (Tk 768, a
    causal cache at offset 256) and "short" (Tk 300)."""
    rng = np.random.default_rng(seed)
    Tk = {"cache": 1024, "odd": 768, "short": 300}.get(mode, Tq)
    q = rng.standard_normal((2, Tq, 8, 32)).astype(np.float32)
    k = rng.standard_normal((2, Tk, 4, 32)).astype(np.float32)
    v = rng.standard_normal((2, Tk, 4, 32)).astype(np.float32)
    if mode == "sliding":
        mask = np.asarray(jcommon.make_sliding_mask(Tq, Tk, 0, 128))
    elif mode == "cache":
        mask = np.asarray(jcommon.make_causal_mask(Tq, Tk, 100))
    elif mode == "odd":
        mask = np.asarray(jcommon.make_causal_mask(Tq, Tk, 256))
    else:
        mask = np.asarray(jcommon.make_causal_mask(Tq, Tk, 0))
    if mode == "masked":
        mask = mask.copy()
        mask[::3] = False
    return q, k, v, mask


@pytest.mark.parametrize("chunk", [128, 256, 512])
@pytest.mark.parametrize("mode", ["causal", "sliding", "cache", "masked",
                                  "odd", "short"])
def test_chunked_attend_matches_jax(mode, chunk):
    """`_attend(..., chunk)` against JAX's on the same inputs: JAX's chunk
    rule (halved until it divides Tk; chunked only from 128 and below
    Tk: Tk 768 takes 256 for a chunk of 512, Tk 300 the one-shot
    softmax), and fully masked rows 0 on the chunked path."""
    q, k, v, mask = _attn_case(mode, seed=chunk)
    want = np.asarray(jattn._attend(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), jnp.asarray(mask), 0.125,
                                    CTX, chunk))
    got = tattn._attend(torch.from_numpy(q), torch.from_numpy(k),
                        torch.from_numpy(v), torch.from_numpy(mask), 0.125,
                        chunk).numpy()
    np.testing.assert_allclose(got, want, atol=ATTN_ATOL, rtol=ATTN_RTOL)
    if mode == "masked" and chunk < k.shape[1]:     # the chunked path
        np.testing.assert_array_equal(got[:, ::3], 0.0)


@pytest.mark.parametrize("mode", ["causal", "sliding", "masked"])
def test_chunked_attend_gradients(mode):
    """The chunked schedule's gradients equal the one-shot softmax's within
    the chunked bound (a fully masked row: 0 on both), and stay finite
    where a chunk sees no key of a row (the sliding window)."""
    q, k, v, mask = _attn_case(mode, seed=7, Tq=384)
    grads = {}
    for chunk in (None, 128):
        ins = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
        out = tattn._attend(*ins, torch.from_numpy(mask), 0.125, chunk)
        if mode == "masked":      # the one-shot softmax is uniform there
            out = out * torch.from_numpy(mask.any(-1))[None, :, None, None]
        (out * torch.linspace(-1, 1, out.numel()).reshape(out.shape)
         ).sum().backward()
        grads[chunk] = [t.grad.numpy() for t in ins]
    for a, b in zip(grads[128], grads[None]):
        assert np.isfinite(a).all()
        np.testing.assert_allclose(a, b, atol=ATTN_ATOL, rtol=ATTN_RTOL)


def _mla_params():
    cfg = jattn.AttnConfig(d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
                           q_lora=24, kv_lora=32, rope_dim=8, v_head_dim=16)
    pf = jcommon.ParamFactory(jax.random.PRNGKey(0), jnp.float32)
    params = jattn.init_mla(pf, cfg)
    tcfg = tattn.AttnConfig(d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
                            q_lora=24, kv_lora=32, rope_dim=8, v_head_dim=16)
    return cfg, tcfg, params


@pytest.mark.parametrize("T", [512, 64])
def test_mla_chunked_matches_jax(T):
    """`mla_forward` with `attn_chunk` 128 against JAX's (its concatenated
    nope || rope score through `_attend`: chunked at T 512; at T 64 the
    chunk exceeds T, so the one-shot softmax over the concatenated
    score), and against the port's own two-term score within
    tests/test_kernels.py's bound."""
    cfg, tcfg, params = _mla_params()
    x = np.asarray(jax.random.normal(jax.random.PRNGKey(1), (2, T, 64)))
    pos = np.arange(T)[None, :]
    want, _ = jattn.mla_forward(params, dataclasses.replace(cfg,
                                                            attn_chunk=128),
                                jnp.asarray(x), jnp.asarray(pos), CTX)
    tp = params_from_jax(jax.device_get(params), "cpu")
    got, _ = tattn.mla_forward(tp, dataclasses.replace(tcfg, attn_chunk=128),
                               torch.from_numpy(x), torch.from_numpy(pos))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)
    dense, _ = tattn.mla_forward(tp, tcfg, torch.from_numpy(x),
                                 torch.from_numpy(pos))
    np.testing.assert_allclose(got.numpy(), dense.numpy(), atol=3e-5,
                               rtol=3e-5)


@pytest.mark.parametrize("arch", ["internlm2-1.8b", "deepseek-v2-236b"])
def test_attn_chunk_training_matches_jax(arch):
    """A Stage-2 loss and its gradients with `attn_chunk` 128 at T 256
    (two chunks a row), GQA and MLA, against JAX's with the same chunk;
    and the chunked logits against the port's unchunked ones."""
    cfg = reduced(get_config(arch)).replace(attn_chunk=128)
    tcfg = t_reduced(t_get_config(arch)).replace(attn_chunk=128)
    jparams = jax.device_get(jtfm.init_params(cfg, jax.random.PRNGKey(2)))
    rng = np.random.default_rng(3)
    batch = {k: rng.integers(0, cfg.vocab_size, (1, 256)).astype(np.int32)
             for k in ("tokens", "targets")}
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    def j_loss(params):
        x, model_aux, mask = jsteps._final_hidden(params, cfg, jb, CTX)
        loss, _ = jsteps.chunked_gatekeeper_loss(
            x, params.get("unembed", params["embedding"]), jb["targets"],
            JGK(alpha=0.3), mask)
        return loss + 0.01 * model_aux
    lj, gj = jax.value_and_grad(j_loss)(jparams)
    lt, gt = _port_grads(tcfg, jparams, batch, "none")
    assert abs(float(lt) - float(lj)) <= ATOL * max(1.0, abs(float(lj)))
    nj, nt = _named(gj), _named(toptim.tree_map(lambda t: t.numpy(), gt))
    for name in nj:
        scale = float(np.abs(nj[name]).max())
        np.testing.assert_allclose(nt[name], nj[name], rtol=GRAD_RTOL,
                                   atol=ATOL * scale + 1e-12, err_msg=name)
    tp = params_from_jax(jparams, "cpu")
    tok = torch.from_numpy(batch["tokens"])
    with torch.no_grad():
        chunked = ttfm.forward(tp, tcfg, tok)
        plain = ttfm.forward(tp, tcfg.replace(attn_chunk=0), tok)
    np.testing.assert_allclose(chunked.numpy(), plain.numpy(), atol=1e-4,
                               rtol=1e-4)
