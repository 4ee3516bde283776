"""Port model trunk on the CPU against the JAX package, on the reduced
internlm2-1.8b (2 layers, 4 heads over 2 KV heads, hd 32, vocab 512,
fp32) with JAX-initialised weights carried over by `convert.py`."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from repro.configs import get_config, reduced
from repro.models import transformer as jtfm
from repro.sharding import ParallelContext
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs import reduced as t_reduced
from repro_torch.convert import params_from_jax
from repro_torch.models import attention as tattn
from repro_torch.models import transformer as ttfm

torch.set_num_threads(1)
CTX = ParallelContext()
LOGIT_ATOL = 1e-4     # fp32 end to end; sums ordered differently


@pytest.fixture(scope="module")
def model():
    cfg = reduced(get_config("internlm2-1.8b"))
    tcfg = t_reduced(t_get_config("internlm2-1.8b"))
    jparams = jtfm.init_params(cfg, jax.random.PRNGKey(0))
    tparams = params_from_jax(jax.device_get(jparams), "cpu")
    return cfg, tcfg, jparams, tparams


def test_reduced_config_matches_jax(model):
    cfg, tcfg, _, _ = model
    for f in ("n_layers", "d_model", "n_heads", "n_kv_heads", "head_dim",
              "d_ff", "vocab_size", "rope_theta", "norm_eps"):
        assert getattr(tcfg, f) == getattr(cfg, f), f
    full = t_get_config("internlm2-1.8b")
    assert (full.n_layers, full.d_model, full.n_heads, full.n_kv_heads,
            full.d_ff, full.vocab_size) == (24, 2048, 16, 8, 8192, 92544)


def test_convert_keeps_layout(model):
    _, tcfg, jparams, tparams = model
    jl = jax.tree_util.tree_leaves_with_path(jparams)
    assert len(jl) == len(jax.tree_util.tree_leaves(
        jax.tree.map(lambda a: a, jparams)))
    for path, leaf in jl:
        t = tparams
        for p in path:
            t = t[p.key]
        assert tuple(t.shape) == leaf.shape, path
        np.testing.assert_array_equal(t.numpy(), np.asarray(leaf))
    assert tparams["blocks"]["dense"]["attn"]["wq"].shape == (
        tcfg.n_layers, tcfg.d_model, tcfg.n_heads, tcfg.head_dim)


def test_init_params_shapes_match_jax(model):
    cfg, tcfg, jparams, _ = model
    own = ttfm.init_params(tcfg, seed=3, device="cpu")
    shapes = jax.tree.map(lambda a: a.shape, jparams)
    assert jax.tree.map(lambda t: tuple(t.shape), own) == shapes
    assert float(own["blocks"]["dense"]["norm1"].abs().sum()) == 0.0
    std = float(own["blocks"]["dense"]["attn"]["wq"].std())
    assert abs(std - 1 / np.sqrt(cfg.d_model)) < 0.1 / np.sqrt(cfg.d_model)


def test_forward_logits_match_jax(model):
    cfg, tcfg, jparams, tparams = model
    toks = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 12)).astype(np.int32)
    ref = np.asarray(jtfm.forward(jparams, cfg, jnp.asarray(toks), CTX))
    out = ttfm.forward(tparams, tcfg, torch.from_numpy(toks)).numpy()
    np.testing.assert_allclose(out, ref, atol=LOGIT_ATOL)


def test_prefill_then_decode_matches_forward(model):
    _, tcfg, _, tparams = model
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, tcfg.vocab_size, (2, 12)).astype(np.int64))
    full = ttfm.forward(tparams, tcfg, toks)
    cache = ttfm.init_cache(tcfg, 2, 16, device="cpu")
    logits, cache = ttfm.prefill(tparams, tcfg, toks[:, :8], cache,
                                 last_only=True)
    torch.testing.assert_close(logits[:, 0], full[:, 7], atol=1e-5, rtol=0)
    for i in range(8, 12):
        # scalar position (static engine) and per-row positions (slots)
        pos = i if i % 2 else torch.full((2,), i, dtype=torch.int32)
        logits, cache = ttfm.decode_step(tparams, tcfg, toks[:, i], pos, cache)
        torch.testing.assert_close(logits, full[:, i], atol=1e-5, rtol=0)


def _paged_run_jax(cfg, params, prompts, tables, n_blocks, bs, chunk, steps):
    cache = jtfm.init_cache(cfg, n_blocks + 1, bs, dtype=cfg.cdtype())
    P = prompts.shape[1]
    outs = []
    for off in range(0, P, chunk):
        piece = prompts[:, off:off + chunk]
        last = np.minimum(P - 1 - off, piece.shape[1] - 1).repeat(2)
        lg, cache = jtfm.prefill(params, cfg, jnp.asarray(piece), cache, CTX,
                                 cache_offset=off, pages=jnp.asarray(tables),
                                 last_index=jnp.asarray(last))
        outs.append(np.asarray(lg[:, 0]))
    tok = jnp.argmax(lg[:, 0], -1).astype(jnp.int32)
    pos = jnp.full((2,), P, jnp.int32)
    for _ in range(steps):
        lg, cache = jtfm.decode_step(params, cfg, tok, pos, cache, CTX,
                                     pages=jnp.asarray(tables),
                                     paged_kernel=False)
        outs.append(np.asarray(lg))
        tok = jnp.argmax(lg, -1).astype(jnp.int32)
        pos = pos + 1
    return outs, jax.device_get(cache)


def _paged_run_torch(cfg, params, prompts, tables, n_blocks, bs, chunk, steps,
                     paged_kernel):
    cache = ttfm.init_cache(cfg, n_blocks + 1, bs, device="cpu")
    P = prompts.shape[1]
    tbl = torch.from_numpy(tables)
    outs = []
    for off in range(0, P, chunk):
        piece = torch.from_numpy(prompts[:, off:off + chunk].astype(np.int64))
        last = torch.full((2,), min(P - 1 - off, piece.shape[1] - 1))
        lg, cache = ttfm.prefill(params, cfg, piece, cache, cache_offset=off,
                                 pages=tbl, last_index=last)
        outs.append(lg[:, 0].numpy())
    tok = torch.argmax(lg[:, 0], -1).to(torch.int32)
    pos = torch.full((2,), P, dtype=torch.int32)
    for _ in range(steps):
        lg, cache = ttfm.decode_step(params, cfg, tok, pos, cache, pages=tbl,
                                     paged_kernel=paged_kernel)
        outs.append(lg.numpy())
        tok = torch.argmax(lg, -1).to(torch.int32)
        pos = pos + 1
    return outs, cache


# every decode position is mapped, as the engine guarantees (an unmapped
# page is skipped by the kernel contract but read by a gather)
PAGED_TABLES = np.asarray([[3, 1, 5, 8, 0], [2, 6, 4, 7, 0]], np.int32)
PAGED_ARGS = (8, 4, 4, 4)        # n_blocks, block_size, chunk, decode steps


@pytest.fixture(scope="module")
def paged_ref(model):
    cfg, _, jparams, _ = model
    prompts = np.random.default_rng(2).integers(
        0, cfg.vocab_size, (2, 10)).astype(np.int32)
    return prompts, _paged_run_jax(cfg, jparams, prompts, PAGED_TABLES,
                                   *PAGED_ARGS)


@pytest.mark.parametrize("paged_kernel", [False, True])
def test_paged_chunked_prefill_and_decode_match_jax(model, paged_ref,
                                                    paged_kernel):
    """Chunked paged prefill (block 4, chunk 4, a ragged final chunk) then
    paged decode, through the port's plain path and its kernel path: the
    logits match the JAX gather path at every step (atol 1e-4) and the
    written blocks, all but the trash block, within 1e-5."""
    _, tcfg, _, tparams = model
    prompts, (ref, jcache) = paged_ref
    out, tcache = _paged_run_torch(tcfg, tparams, prompts, PAGED_TABLES,
                                   *PAGED_ARGS, paged_kernel)
    for r, o in zip(ref, out):
        np.testing.assert_allclose(o, r, atol=LOGIT_ATOL)
    for name in ("k", "v"):
        j = np.asarray(jcache["dense"][name])[:, 1:]
        t = tcache["dense"][name].numpy()[:, 1:]
        np.testing.assert_allclose(t, j, atol=1e-5)


def _layer(model):
    _, tcfg, _, tparams = model
    p = {k: v[0] for k, v in tparams["blocks"]["dense"]["attn"].items()}
    rng = np.random.default_rng(7)
    cache = {n: torch.from_numpy(
        rng.standard_normal((8, 4, tcfg.n_kv_heads, tcfg.head_dim))
        .astype(np.float32) * 0.1) for n in ("k", "v")}
    x = torch.from_numpy(rng.standard_normal((4, 1, tcfg.d_model))
                         .astype(np.float32) * 0.3)
    return ttfm.attn_config(tcfg), p, cache, x


def test_gqa_decode_kernel_path_vs_plain_path(model):
    """One layer through both paged decode paths: outputs agree on mapped
    rows and the written caches are bit-identical."""
    ac, p, cache, x = _layer(model)
    tables = torch.tensor([[1, 2, 3, 0], [4, 5, 0, 0], [6, 0, 0, 0],
                           [0, 0, 0, 0]], dtype=torch.int32)
    pos = torch.tensor([9, 6, 2, 3], dtype=torch.int32)
    cf = {n: t.clone() for n, t in cache.items()}
    ck = {n: t.clone() for n, t in cache.items()}
    y_f, cf = tattn.gqa_decode(p, ac, x, pos, cf, pages=tables,
                               paged_kernel=False)
    y_k, ck = tattn.gqa_decode(p, ac, x, pos, ck, pages=tables,
                               paged_kernel=True)
    torch.testing.assert_close(y_k[:3], y_f[:3], atol=1e-5, rtol=0)
    assert torch.isfinite(y_k).all()
    for n in ("k", "v"):
        torch.testing.assert_close(ck[n], cf[n], atol=0, rtol=0)


@pytest.mark.parametrize("paged_kernel", [False, True])
def test_active_prefix_table_slice_is_exact(model, paged_kernel):
    """Slicing the page table to the blocks the masks can reach leaves
    the cache writes bit-identical and the output equal. On CPU tensors
    both switches run the plain version, whose einsum reduces over a
    shorter masked axis, so the output may move by rounding (atol 1e-6);
    the kernel's exactness is held on the card (tests/test_torch_cuda.py)."""
    ac, p, cache, x = _layer(model)
    full = torch.tensor([[1, 2, 3, 0], [4, 5, 0, 0], [6, 0, 0, 0],
                         [0, 0, 0, 0]], dtype=torch.int32)
    pos = torch.tensor([9, 6, 2, 3], dtype=torch.int32)
    a = {n: t.clone() for n, t in cache.items()}
    b = {n: t.clone() for n, t in cache.items()}
    y_full, a = tattn.gqa_decode(p, ac, x, pos, a, pages=full,
                                 paged_kernel=paged_kernel)
    y_cut, b = tattn.gqa_decode(p, ac, x, pos, b,
                                pages=full[:, :3].contiguous(),
                                paged_kernel=paged_kernel)
    torch.testing.assert_close(y_cut, y_full, rtol=0, atol=1e-6)
    for n in ("k", "v"):
        torch.testing.assert_close(a[n], b[n], atol=0, rtol=0)
