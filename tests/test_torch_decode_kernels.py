"""The decode-time designs of two CUDA kernels, pinned on the CPU.

`csrc/wkv_scan.cu`'s per-token kernel (`wkv_decode_kernel`, T < 32) and
`csrc/deferral_entropy.cu`'s one-launch signal run only on the card. Here
their algebra is repeated in plain torch, in the kernels' own fixed
reduction orders, and held against the JAX package on numpy-seeded inputs:

  * `_emulated_decode_kernel`: each thread's rows of S in order, the xor
    shuffles over a warp's four thread rows, the warps' sums in warp
    order, and rwkv's bonus as one scalar per stream times v, against JAX's
    `wkv_scan` (interpret mode) and `linear_attention_step`, in both modes
    (rwkv's exclusive read with the bonus, mamba's inclusive read) and
    both decay forms, at T 1 and 2. It may use at most half of the card
    tolerance (atol = rtol = 5e-4, as `tests/test_torch_cuda.py` holds the
    kernel).
  * `_emulated_signal_kernel`: the vocabulary split as `vocab_split` makes
    it for 132 SMs, each split's stats, then the last CTA's merge: thread
    i folds splits i, i + 256, ..., then the warp and shared-memory xor
    tree; against JAX's `deferral_entropy` (interpret mode), with a top
    tie across two splits, an all-equal row and the one-split case.
"""
import numpy as np
import pytest

import jax.numpy as jnp
import torch

from repro.kernels import ops as jops
from repro.kernels.wkv_scan import wkv_scan as j_wkv_scan
from repro.models import ssm as jssm
from repro_torch.kernels import deferral_entropy as tde
from repro_torch.kernels import wkv_scan as wk

torch.set_num_threads(1)
CARD_TOL = 5e-4        # atol = rtol of the kernel's card tests
SHARE = 0.5            # the emulation may use at most this share of it
SIGNAL_ATOL = 1e-5     # against JAX's kernel: fp32, sums in other orders
CARD_SIGNAL_ATOL = 1e-4  # against the plain version, as the card holds the
                       # kernel: its fp32 log_softmax then sum p log p over
                       # 92,544 columns is itself ~1.8e-5 off at these logits

# ---------------------------------------------------------------------------
# wkv_scan, T < 32: the per-token kernel
# ---------------------------------------------------------------------------

ROWS_PER_WARP = 4      # a warp's thread rows (32 lanes / 8 column threads)
# (largest K, rows a thread R, thread rows RT), as `launch_sequential`
BUCKETS = ((16, 1, 16), (32, 2, 16), (64, 4, 16), (128, 8, 16),
           (256, 8, 32), (512, 8, 64))


def _layout(K: int):
    return next((R, RT) for kmax, R, RT in BUCKETS if K <= kmax)


def _emulated_decode_kernel(q, k, v, logw, u, s0, mode: str):
    """The kernel's arithmetic on fp32 CPU tensors. q, k [B,T,H,K]; v
    [B,T,H,V]; logw [B,T,H,K] or [B,T,H,1]; u [H,K]; s0 [B,H,K,V].
    Returns (y [B,T,H,V], final state [B,H,K,V])."""
    B, T, H, K = q.shape
    V = v.shape[-1]
    R, RT = _layout(K)
    pad = R * RT - K

    def rows(x):              # [..., K] -> [..., R, RT]: row r = j RT + ty
        x = torch.nn.functional.pad(x.float(), (0, pad))
        return x.reshape(*x.shape[:-1], R, RT)

    w = rows(torch.exp(logw.float()).expand(B, T, H, K))
    qr, kr = rows(q), rows(k)
    ur = rows(u)                                      # [H, R, RT]
    S = torch.nn.functional.pad(s0.float(), (0, 0, 0, pad))
    S = S.reshape(B, H, R, RT, V)
    ys = []
    for t in range(T):
        qt, kt, wt = (x[:, t, :, :, :, None] for x in (qr, kr, w))
        vt = v[:, t].float()[:, :, None, None, :]     # [B, H, 1, 1, V]
        kv = kt * vt
        acc = torch.zeros(B, H, RT, V)
        bonus = torch.zeros(B, H, RT)
        for j in range(R):                            # a thread's rows
            if mode == "rwkv":
                acc = acc + qt[:, :, j] * S[:, :, j]
                S[:, :, j] = wt[:, :, j] * S[:, :, j] + kv[:, :, j]
                bonus = bonus + (qt[:, :, j, :, 0] * ur[None, :, j]
                                 * kt[:, :, j, :, 0])
            else:
                S[:, :, j] = wt[:, :, j] * S[:, :, j] + kv[:, :, j]
                acc = acc + qt[:, :, j] * S[:, :, j]

        def tree(x):          # xor 8 then 16 in a warp, then warp order
            x = x.reshape(B, H, RT // ROWS_PER_WARP, ROWS_PER_WARP,
                          *x.shape[3:])
            per_warp = (x[:, :, :, 0] + x[:, :, :, 1]) + (x[:, :, :, 2]
                                                          + x[:, :, :, 3])
            total = torch.zeros_like(per_warp[:, :, 0])
            for i in range(per_warp.shape[2]):
                total = total + per_warp[:, :, i]
            return total
        y = tree(acc)
        if mode == "rwkv":
            y = y + tree(bonus)[..., None] * v[:, t].float()
        ys.append(y)
    S = S.reshape(B, H, R * RT, V)[:, :, :K]
    return torch.stack(ys, dim=1), S


def _wkv_inputs(seed, B, T, H, K, V, scalar):
    """chip_smoke.py's `wkv_case` distributions (logw in [-1, -0.05])."""
    rng = np.random.default_rng(seed)
    q, k = (0.5 * rng.standard_normal((B, T, H, K)) for _ in range(2))
    v = 0.5 * rng.standard_normal((B, T, H, V))
    logw = -rng.uniform(0.05, 1.0, (B, T, H, 1 if scalar else K))
    u = 0.3 * rng.standard_normal((H, K))
    s0 = 0.2 * rng.standard_normal((B, H, K, V))
    return [a.astype(np.float32) for a in (q, k, v, logw, u, s0)]


def _share(got, want) -> float:
    got, want = (torch.as_tensor(np.array(a)) for a in (got, want))
    assert torch.isfinite(got).all()
    return float(((got - want).abs() / (CARD_TOL + CARD_TOL * want.abs()))
                 .max())


def _jax_steps(q, k, v, logw, u, s0, mode):
    """JAX's `linear_attention_step`, token by token."""
    S, ys = jnp.asarray(s0), []
    for t in range(q.shape[1]):
        y, S = jssm.linear_attention_step(
            *(jnp.asarray(a[:, t]) for a in (q, k, v, logw)), S, mode=mode,
            u=jnp.asarray(u) if mode == "rwkv" else None)
        ys.append(y)
    return jnp.stack(ys, axis=1), S


@pytest.mark.parametrize("T", [1, 2])
@pytest.mark.parametrize("scalar", [False, True], ids=["per-channel",
                                                       "scalar-decay"])
@pytest.mark.parametrize("mode", wk.MODES)
@pytest.mark.parametrize("B,H,K,V", [(1, 40, 64, 64), (1, 2, 256, 256),
                                     (1, 1, 200, 300)],
                         ids=["rwkv6-3b-heads", "k256", "k200-v300"])
def test_decode_algebra_matches_jax(B, H, K, V, mode, scalar, T):
    """y and the state within half the card tolerance of JAX's kernel
    (interpret mode; the decay broadcast over K, as it takes it) and of
    its `linear_attention_step`; every output finite."""
    q, k, v, logw, u, s0 = _wkv_inputs(7 * K + V + T + 2 * scalar, B, T, H,
                                       K, V, scalar)
    y, s = _emulated_decode_kernel(*(torch.from_numpy(a) for a in (
        q, k, v, logw, u, s0)), mode=mode)
    jq, jk, jv, jlw, ju, js0 = (jnp.asarray(a) for a in (q, k, v, logw, u,
                                                          s0))
    ky, ks = j_wkv_scan(jq, jk, jv, jnp.broadcast_to(jlw, jq.shape), ju, js0,
                        interpret=True, mode=mode)
    for want_y, want_s in ((ky, ks), _jax_steps(q, k, v, logw, u, s0, mode)):
        assert _share(y, want_y) <= SHARE
        assert _share(s, want_s) <= SHARE


# ---------------------------------------------------------------------------
# deferral_entropy: one launch, the last CTA of a row merges
# ---------------------------------------------------------------------------

N_SMS, THREADS, WARP = 132, 256, 32
NEG, NO_INDEX = -1e30, 2 ** 31 - 1


def _merge(a, b):
    """The kernel's `merge`: b folded into a, equal maxima keep the lower
    index. Stats are (m, s, w, idx) tensors of one shape."""
    am, as_, aw, ai = a
    bm, bs, bw, bi = b
    mn = torch.maximum(am, bm)
    ea, eb = torch.exp(am - mn), torch.exp(bm - mn)
    w = ea * (as_ * (am - mn) + aw) + eb * (bs * (bm - mn) + bw)
    take_b = (bm > am) | ((bm == am) & (bi < ai))
    return mn, as_ * ea + bs * eb, w, torch.where(take_b, bi, ai)


def _empty(shape):
    return (torch.full(shape, NEG), torch.zeros(shape), torch.zeros(shape),
            torch.full(shape, NO_INDEX, dtype=torch.int64))


def _xor_tree(st):
    """A warp's xor shuffles (16, 8, 4, 2, 1) over the last axis, in
    groups of 32 lanes. Returns every lane's result."""
    lanes = torch.arange(st[0].shape[-1])
    for off in (16, 8, 4, 2, 1):
        st = _merge(st, tuple(x[..., lanes ^ off] for x in st))
    return st


def _block_merge(st):
    """The kernel's `block_merge` over THREADS lanes: each warp's tree,
    then warp 0's tree over the warps' results. Returns thread 0's."""
    st = _xor_tree(st)
    warp0 = tuple(x[..., ::WARP] for x in st)                 # [T, 8]
    pad = _empty(warp0[0].shape[:-1] + (WARP - warp0[0].shape[-1],))
    st = _xor_tree(tuple(torch.cat([a, b], -1) for a, b in zip(warp0, pad)))
    return tuple(x[..., 0] for x in st)


def _split_stats(x, span):
    """Each vocabulary split's (m, s, w, first argmax) [T, n_splits], as
    one CTA reduces its span."""
    T, V = x.shape
    stats = []
    for c0 in range(0, V, span):
        part = x[:, c0:c0 + span]
        m = part.max(dim=1).values
        d = part - m[:, None]
        e = torch.exp(d)
        stats.append((m, e.sum(1), (e * d).sum(1),
                      part.argmax(dim=1).to(torch.int64) + c0))
    return tuple(torch.stack(c, dim=1) for c in zip(*stats))


def _emulated_signal_kernel(x):
    """The one-launch kernel on fp32 CPU logits [T, V]: (neg_entropy,
    max_prob, argmax) and the split count."""
    T, V = x.shape
    span, n_splits = tde.vocab_split(T, V, N_SMS)
    parts = _split_stats(x, span)
    if n_splits == 1:                 # the CTA writes its row directly
        st = tuple(p[:, 0] for p in parts)
    else:                             # the last CTA: thread i folds splits
        st = _empty((T, THREADS))     # i, i + 256, ... in order
        for first in range(0, n_splits, THREADS):
            n = min(THREADS, n_splits - first)
            nxt = tuple(p[:, first:first + n] for p in parts)
            cur = tuple(c[:, :n] for c in st)
            merged = _merge(cur, nxt)
            st = tuple(torch.cat([a, b[:, n:]], 1) for a, b in zip(merged,
                                                                    st))
        st = _block_merge(st)
    m, s, w, idx = st
    return w / s - torch.log(s), 1.0 / s, idx.to(torch.int32), n_splits


def _signal_logits(seed, T, V, span):
    """Normal logits of std 3: row 0 all equal, row 1 an exact top tie at
    two far columns, row 2 a top tie across the first split boundary."""
    x = (np.random.default_rng(seed).standard_normal((T, V)) * 3
         ).astype(np.float32)
    x[0] = 0.25
    if T > 2:
        x[1, 7] = x[1, V - 5] = x[1].max() + 1
        b = min(span, V - 1)
        x[2, b - 1] = x[2, b] = x[2].max() + 1
    return x


@pytest.mark.parametrize("T,V,n_splits", [
    (8, 92544, 46), (8, 65536, 32), (8, 50001, 25), (8, 2000, 1),
    (1, 600000, 293)],
    ids=["internlm2", "rwkv6-3b", "vocab-tail", "one-split",
         "splits-over-threads"])
def test_ticketed_merge_matches_jax(T, V, n_splits):
    """neg_entropy and max_prob within 1e-5 of JAX's kernel (interpret
    mode) and within the card's 1e-4 of the plain version; argmax exact,
    ties to the lowest index, the tie across splits included."""
    span, splits = tde.vocab_split(T, V, N_SMS)
    assert splits == n_splits
    x = _signal_logits(T + V, T, V, span)
    *got, _ = _emulated_signal_kernel(torch.from_numpy(x))
    got = [a.numpy() for a in got]
    jk = [np.asarray(a) for a in jops.deferral_signal(
        jnp.asarray(x), interpret=True, tb=8, vb=2048)]
    tp = [a.numpy() for a in tde.deferral_entropy_plain(torch.from_numpy(x))]
    for ref, atol in ((jk, SIGNAL_ATOL), (tp, CARD_SIGNAL_ATOL)):
        np.testing.assert_allclose(got[0], ref[0], atol=atol, rtol=0)
        np.testing.assert_allclose(got[1], ref[1], atol=atol, rtol=0)
        np.testing.assert_array_equal(got[2], ref[2])
    assert got[2][0] == 0
    np.testing.assert_allclose(got[0][0], -np.log(V), rtol=1e-5)
    if T > 2:
        assert got[2][1] == 7 and got[2][2] == min(span, V - 1) - 1


def test_row_counters_grow_and_stay_per_stream():
    """The wrapper's ticket counters: zeros, one tensor per (device,
    stream), kept while it holds enough rows and replaced by a larger
    zeroed one when a call has more."""
    dev = torch.device("cpu")
    tde._counters.clear()
    a = tde._row_counters(dev, 11, 8)
    assert a.dtype == torch.int32 and a.numel() == 8 and not a.any()
    assert tde._row_counters(dev, 11, 3) is a
    b = tde._row_counters(dev, 12, 3)
    assert b is not a and b.numel() == 3
    c = tde._row_counters(dev, 11, 20)
    assert c.numel() == 20 and not c.any()
    assert tde._row_counters(dev, 11, 8) is c
    tde._counters.clear()
