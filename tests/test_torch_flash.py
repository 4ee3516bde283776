"""Port's prefill attention on the CPU against the JAX package: the
`flash_attention` kernel's plain version against the Pallas kernel
(interpret mode) and `flash_attention_ref` with GQA, causal or not, a
sliding window and ragged tiles; `q_offset > 0` against JAX `_attend`
over `make_causal_mask(T, S, off)`; and the model's slot and paged
prefill with the kernel path forced on CPU tensors (the wrapper then runs
its plain version) against JAX `prefill`. Inputs come from numpy seeds;
JAX weights come over through `convert.py`."""
import math

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from repro.configs import get_config, reduced
from repro.kernels import ops as jops
from repro.kernels.ref import flash_attention_ref
from repro.models import transformer as jtfm
from repro.models.attention import _attend as j_attend
from repro.models.common import make_causal_mask as j_causal_mask
from repro.sharding import ParallelContext
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs import reduced as t_reduced
from repro_torch.convert import params_from_jax
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ops as tops
from repro_torch.models import attention as tattn
from repro_torch.models import transformer as ttfm

torch.set_num_threads(1)
CTX = ParallelContext()
F32_ATOL = 1e-5       # fp32 softmax attention, sums in other orders
BF16_TOL = 2e-2       # tests/test_kernels.py's bf16 flash tolerance
LOGIT_ATOL = 1e-4     # fp32 end to end through two layers


def _qkv(seed, B, T, S, H, KV, hd):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, T, H, hd)).astype(np.float32),
            rng.standard_normal((B, S, KV, hd)).astype(np.float32),
            rng.standard_normal((B, S, KV, hd)).astype(np.float32))


def _plain(q, k, v, **kw):
    return tfa.flash_attention_plain(torch.from_numpy(q), torch.from_numpy(k),
                                     torch.from_numpy(v), **kw).numpy()


@pytest.mark.parametrize("B,T,S,H,KV,hd,causal,win", [
    (2, 13, 13, 4, 2, 16, True, 0),        # GQA, T and S tails of 8-tiles
    (1, 21, 21, 4, 4, 32, True, 6),        # sliding window
    (2, 19, 19, 8, 2, 16, False, 0),       # bidirectional
    (1, 11, 11, 2, 1, 16, False, 5),       # MQA, window without causality
    (1, 13, 13, 4, 2, 96, True, 0),        # phi-3-vision's head_dim
    (1, 11, 11, 2, 1, 112, True, 0),       # kimi-k2's head_dim
], ids=["gqa-causal", "window", "bidirectional", "mqa-window", "hd96",
        "hd112"])
def test_plain_matches_jax_kernel_and_ref(B, T, S, H, KV, hd, causal, win):
    q, k, v = _qkv(B * T + H, B, T, S, H, KV, hd)
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    jker = np.asarray(jops.flash_attention(jq, jk, jv, causal=causal,
                                           window=win, qb=8, kb=8,
                                           interpret=True))
    jref = np.asarray(flash_attention_ref(jq, jk, jv, causal=causal,
                                          window=win))
    out = _plain(q, k, v, causal=causal, window=win)
    np.testing.assert_allclose(out, jker, atol=F32_ATOL, rtol=0)
    np.testing.assert_allclose(out, jref, atol=F32_ATOL, rtol=0)


def test_plain_bf16_matches_jax_kernel():
    """bf16 q/k/v, fp32 inside, bf16 out on both sides."""
    q, k, v = _qkv(7, 1, 24, 24, 4, 2, 32)
    jq, jk, jv = (jnp.asarray(a).astype(jnp.bfloat16) for a in (q, k, v))
    jker = np.asarray(jops.flash_attention(jq, jk, jv, causal=True, qb=8,
                                           kb=8, interpret=True), np.float32)
    tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    out = tfa.flash_attention_plain(tq, tk, tv, causal=True)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(), jker, atol=BF16_TOL,
                               rtol=BF16_TOL)


@pytest.mark.parametrize("off", [0, 3, 9])
def test_q_offset_matches_jax_attend_over_causal_mask(off):
    """A chunk of T queries at absolute offset `off` over S cached keys
    (S > off + T: positions past the chunk are hidden)."""
    B, T, S, H, KV, hd = 2, 6, 20, 4, 2, 16
    q, k, v = _qkv(11 + off, B, T, S, H, KV, hd)
    scale = 1.0 / np.sqrt(hd)
    ref = np.asarray(j_attend(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              j_causal_mask(T, S, off), scale, CTX))
    out = _plain(q, k, v, causal=True, q_offset=off)
    np.testing.assert_allclose(out, ref, atol=F32_ATOL, rtol=0)
    # the mask helper is make_causal_mask's function
    np.testing.assert_array_equal(
        tfa.visible_mask(T, S, q_offset=off).numpy(),
        np.asarray(j_causal_mask(T, S, off)))


def test_query_with_no_visible_key_gives_zeros():
    """Window 2 and queries placed past the keys: rows that see nothing
    are exact zeros, rows that see something are finite."""
    q, k, v = _qkv(3, 1, 4, 5, 2, 1, 16)
    out = _plain(q, k, v, causal=True, window=2, q_offset=5)
    assert np.all(out[0, 1:] == 0) and np.isfinite(out).all()
    assert np.abs(out[0, 0]).max() > 0      # position 5 sees key 4


def _emulated_bf16_kernel(q, k, v, q_offset, split):
    """The bf16 CUDA kernel's arithmetic in one softmax: fp32 scores of
    bf16 inputs (exact products), p = exp(s - row max), P rounded to bf16
    before P @ V (with ``split``, as hi = bf16(p) plus lo = bf16(p - hi)),
    fp32 accumulation, division by the fp32 row sum, a bf16 output."""
    B, T, H, hd = q.shape
    S, KV = k.shape[1], k.shape[2]
    qg = q.float().reshape(B, T, KV, H // KV, hd)
    s = torch.einsum("btkgh,bskh->bkgts", qg, k.float()) / math.sqrt(hd)
    mask = tfa.visible_mask(T, S, q_offset=q_offset)
    s = torch.where(mask, s, tfa.NEG)
    p = torch.where(mask, torch.exp(s - s.amax(dim=-1, keepdim=True)), 0.0)
    hi = p.bfloat16().float()
    pr = hi + (p - hi).bfloat16().float() if split else hi
    o = torch.einsum("bkgts,bskh->bkgth", pr, v.float()) / p.sum(-1)[..., None]
    return o.permute(0, 3, 1, 2, 4).reshape(B, T, H, hd).bfloat16()


@pytest.mark.parametrize("off", [0, 48, 128])
def test_bf16_kernel_precision_design_holds_the_card_tolerance(off):
    """Pins the bf16 kernel's P @ V design at the main path's prefill
    chunk (8 x 128 queries, 16/8 heads of 128, 288 keys): P split into two
    bf16 halves stays within the tolerance the card tests hold the kernel
    to (1e-4 + 2^-7 |ref| against `flash_attention_plain`), and a single
    bf16 P does not, so a one-product P @ V cannot pass for a
    simplification."""
    rng = np.random.default_rng(19 + off)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               .bfloat16() for s in ((8, 128, 16, 128), (8, 288, 8, 128),
                                     (8, 288, 8, 128)))
    ref = tfa.flash_attention_plain(q, k, v, causal=True, q_offset=off)
    tol = 1e-4 + 2 ** -7 * ref.float().abs()

    def share(split):
        out = _emulated_bf16_kernel(q, k, v, off, split)
        return float(((out.float() - ref.float()).abs() / tol).max())
    assert share(split=True) <= 1.0
    assert share(split=False) > 1.0


def _tf32(x):
    """x rounded to TF32 (10 mantissa bits) to nearest, ties away from
    zero, as `cvt.rna.tf32.f32` rounds (the kernel's `split_tf32` makes
    the same bits with an integer add and a mask)."""
    bits = (x.contiguous().view(torch.int32) + 0x1000) & ~0x1FFF
    return bits.view(torch.float32)


def _tf32_cut(x):
    """x truncated to TF32, as the tensor cores read an fp32 operand."""
    return (x.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def _tf32_product(eq, a, b, three):
    """einsum(eq, a, b) as the fp32 kernel's tensor cores form it: each
    operand split into hi = tf32(x) and lo = x - hi, truncated to TF32,
    the three products lo.hi + hi.lo + hi.hi (``three``) or hi.hi alone,
    fp32 sums."""
    ah, bh = _tf32(a), _tf32(b)
    out = torch.einsum(eq, ah, bh)
    if three:
        al, bl = _tf32_cut(a - ah), _tf32_cut(b - bh)
        out = torch.einsum(eq, al, bh) + torch.einsum(eq, ah, bl) + out
    return out


def _emulated_f32_kernel(q, k, v, three, **kw):
    """The fp32 kernel's arithmetic in one softmax: Q . K^T and P @ V as
    TF32 products (`_tf32_product`), fp32 scores, p = exp(s - row max),
    division by the fp32 row sum of the unsplit p."""
    B, T, H, hd = q.shape
    S, KV = k.shape[1], k.shape[2]
    qg = q.reshape(B, T, KV, H // KV, hd)
    s = _tf32_product("btkgh,bskh->bkgts", qg, k, three) / math.sqrt(hd)
    mask = tfa.visible_mask(T, S, **kw)
    s = torch.where(mask, s, tfa.NEG)
    p = torch.where(mask, torch.exp(s - s.amax(dim=-1, keepdim=True)), 0.0)
    o = _tf32_product("bkgts,bskh->bkgth", p, v, three)
    o = o / p.sum(-1).clamp_min(1e-30)[..., None]
    return o.permute(0, 3, 1, 2, 4).reshape(B, T, H, hd)


@pytest.mark.parametrize("B,T,S,H,KV,hd,causal,off", [
    (8, 128, 288, 16, 8, 128, True, 128),
    (1, 64, 1500, 4, 4, 64, False, 0),
], ids=["internlm2-chunk", "non-causal-S1500"])
def test_tf32x3_precision_design_holds_the_card_tolerance(B, T, S, H, KV, hd,
                                                          causal, off):
    """Pins the fp32 kernel's tensor-core design with a peaked softmax (q
    x 8): Q . K^T and P @ V each as three TF32 products of split operands
    stay within the 1e-4 the card tests hold the kernel to against
    `flash_attention_plain`, and one TF32 product each does not, so a
    one-product kernel cannot pass for a simplification."""
    rng = np.random.default_rng(23 + S)
    q = torch.from_numpy(rng.standard_normal((B, T, H, hd))
                         .astype(np.float32) * 8)
    k, v = (torch.from_numpy(rng.standard_normal((B, S, KV, hd))
                             .astype(np.float32)) for _ in range(2))
    kw = dict(causal=causal, q_offset=off)
    ref = tfa.flash_attention_plain(q, k, v, **kw)

    def err(three):
        return float((_emulated_f32_kernel(q, k, v, three, **kw) - ref)
                     .abs().max())
    assert err(three=True) <= 1e-4
    assert err(three=False) > 1e-4


def _split_partials(q, k, v, begin, span, n, **kw):
    """Per split s (keys [begin + s * span, begin + (s + 1) * span)): the
    rows' max m (log2 units, -1e30 where the split shows a row no key),
    sum l of p = exp2(x - m) and unnormalised acc = p @ V, as the split
    kernel writes them."""
    B, T, H, hd = q.shape
    S, KV = k.shape[1], k.shape[2]
    qg = q.reshape(B, T, KV, H // KV, hd)
    x = torch.einsum("btkgh,bskh->bkgts", qg, k) * (math.log2(math.e)
                                                   / math.sqrt(hd))
    mask = tfa.visible_mask(T, S, **kw)
    parts = []
    for i in range(n):
        cut = slice(begin + i * span, min(S, begin + (i + 1) * span))
        vis = mask[:, cut]
        xs = torch.where(vis, x[..., cut], tfa.NEG)
        m = xs.amax(dim=-1)
        p = torch.where(vis, torch.exp2(xs - m[..., None]), 0.0)
        parts.append((m, p.sum(-1),
                      torch.einsum("bkgts,bskh->bkgth", p, v[:, cut])))
    return parts


def _merge(parts):
    """The merge kernel's arithmetic: weights exp2(m_s - m) with m the
    splits' largest m, l and o summed in split order, o / max(l, 1e-30)."""
    m_all = parts[0][0]
    for m, _, _ in parts[1:]:
        m_all = torch.maximum(m_all, m)
    den, acc = 0.0, 0.0
    for m, l, a in parts:
        w = torch.exp2(m - m_all)
        den = den + w * l
        acc = acc + w[..., None] * a
    return acc / den.clamp_min(1e-30)[..., None]


def _rows(o):
    B, KV, G, T, hd = o.shape
    return o.permute(0, 3, 1, 2, 4).reshape(B, T, KV * G, hd)


@pytest.mark.parametrize("B,T,S,H,KV,hd,causal,win,off,want", [
    (8, 1, 1500, 12, 12, 64, False, 0, 0, None),     # whisper's decode step
    (2, 16, 1499, 4, 4, 64, False, 0, 0, None),
    (1, 128, 288, 16, 8, 128, True, 0, 128, None),   # internlm2, one row
    (2, 20, 300, 4, 2, 128, True, 90, 200, None),    # window cut
    (2, 20, 300, 4, 2, 64, True, 90, 200, 4),  # window starts in split 0,
                                               # split 2 past the chunk
    (2, 70, 300, 4, 2, 64, True, 90, 200, 4),  # chunk ends in split 2
    (1, 12, 300, 2, 1, 32, True, 3, 298, 4),   # rows past the keys: blind
    (1, 12, 200, 2, 1, 32, True, 5, 210, 3),   # every row blind
], ids=["whisper-decode", "T16-S1499", "internlm2-B1-chunk",
        "window-kv-split", "window-in-split", "window-in-split-T70",
        "blind-rows", "all-blind"])
def test_split_merge_arithmetic_holds_the_tolerance(B, T, S, H, KV, hd,
                                                    causal, win, off, want):
    """The split-KV path's arithmetic against the one-shot softmax of
    `flash_attention_plain`: per split (m, l, acc), merged in split order,
    within the kernel's 1e-4, with splits as `kv_split` (at 132 SMs) or
    `split_span` over all S keys cut them, including a split no query
    sees, a window that ends inside a split and rows that see nothing
    (exact zeros). One split merged is the single split's own o / max(l,
    1e-30), exactly."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(S + T, B, T, S, H, KV, hd))
    kw = dict(causal=causal, window=win, q_offset=off)
    begin, span, n = (tfa.kv_split(B, T, S, H, hd, 132, **kw)
                      if want is None else (0, *tfa.split_span(S, want)))
    first, last = tfa.seen_keys(T, S, **kw)
    assert n > 1 and begin <= first and last <= begin + n * span
    # kv_split's last split starts below the last seen key; a forced one
    # below S
    assert begin + (n - 1) * span < (last if want is None else S)
    parts = _split_partials(q, k, v, begin, span, n, **kw)
    ref = tfa.flash_attention_plain(q, k, v, **kw)
    out = _rows(_merge(parts))
    torch.testing.assert_close(out, ref, atol=1e-4, rtol=0)
    blind = ~tfa.visible_mask(T, S, **kw).any(dim=-1)
    assert torch.all(out[:, blind] == 0)
    mask = tfa.visible_mask(T, S, **kw)
    for i, (m, l, a) in enumerate(parts):   # a split no query sees adds 0
        if not mask[:, begin + i * span:begin + (i + 1) * span].any():
            assert torch.all(m <= tfa.NEG) and not l.any() and not a.any()
    (m1, l1, a1), = _split_partials(q, k, v, 0, -(-S // 64) * 64, 1, **kw)
    torch.testing.assert_close(_merge([(m1, l1, a1)]),
                               a1 / l1.clamp_min(1e-30)[..., None],
                               atol=0, rtol=0)


NON_CAUSAL = dict(causal=False, window=0, q_offset=0)


@pytest.mark.parametrize("shape,mask,want", [
    ((8, 128, 288, 16, 128), dict(causal=True, window=0, q_offset=128),
     (0, 288, 1)),                          # internlm2-1.8b's chunk
    ((8, 128, 288, 32, 64), dict(causal=True, window=288, q_offset=0),
     (0, 288, 1)),                          # zamba2-1.2b's shared block
    ((8, 577, 593, 32, 96), dict(causal=True, window=0, q_offset=0),
     (0, 593, 1)),                          # phi-3-vision's prefill
    ((8, 1500, 1500, 12, 64), NON_CAUSAL, (0, 1500, 1)),  # whisper's encoder
    ((8, 16, 32, 12, 64), dict(causal=True, window=0, q_offset=0),
     (0, 32, 1)),                           # its decoder's prefill
    ((8, 16, 1500, 12, 64), NON_CAUSAL, (0, 256, 6)),  # its cross-attention
    ((8, 1, 1500, 12, 64), NON_CAUSAL, (0, 256, 6)),   # ... at a decode step
    # the paged engine's prefill dispatches of 1, 2 and 4 rows: the keys
    # past the chunk's last query are never split
    ((1, 128, 288, 16, 128), dict(causal=True, window=0, q_offset=0),
     (0, 64, 2)),
    ((1, 128, 288, 16, 128), dict(causal=True, window=0, q_offset=128),
     (0, 64, 4)),
    ((2, 128, 288, 16, 128), dict(causal=True, window=0, q_offset=128),
     (0, 64, 4)),
    ((4, 128, 288, 16, 128), dict(causal=True, window=0, q_offset=0),
     (0, 64, 2)),
    ((4, 128, 288, 16, 128), dict(causal=True, window=0, q_offset=128),
     (0, 128, 2)),
    # zamba2's slot prefill of 1 or 2 rows: 128 keys at hd 64 are one
    # split's minimum bytes
    ((1, 128, 288, 32, 64), dict(causal=True, window=288, q_offset=0),
     (0, 288, 1)),
    ((2, 128, 288, 32, 64), dict(causal=True, window=288, q_offset=0),
     (0, 288, 1)),
], ids=["internlm2-chunk", "zamba2-shared", "phi3v-prefill",
        "whisper-encoder", "whisper-decoder-self", "whisper-cross-prefill",
        "whisper-cross-decode", "internlm2-B1-off0", "internlm2-B1-off128",
        "internlm2-B2-off128", "internlm2-B4-off0", "internlm2-B4-off128",
        "zamba2-B1", "zamba2-B2"])
def test_kv_split_at_the_path_shapes(shape, mask, want):
    """Grids of a wave or more never split; whisper's cross-attention (96
    one-warp CTAs of one row and head) splits its 1500 keys six ways; the
    paged engine's causal dispatches of 1 to 4 rows (32 to 128 four-warp
    CTAs) split only the keys their queries see."""
    assert tfa.kv_split(*shape, 132, **mask) == want


def test_kv_split_edges():
    """One wave of CTAs exactly: no split, one CTA fewer: splits; T 17
    takes 64-query tiles, T 65 two; fewer seen keys than two splits' minimum bytes:
    one split; the MAX_SPLITS cap; a causal chunk's keys past its last
    query and a window's before its first are never split; a call no query
    sees a key of takes one split; and for any shape and mask, whole
    64-key spans from an aligned begin at or before the first seen key,
    every split starting below the last seen key, the last ending at or
    past it."""
    kv = tfa.kv_split
    assert kv(1, 16, 1500, 132, 64, 132, **NON_CAUSAL)[2] == 1
    assert kv(1, 16, 1500, 131, 64, 132, **NON_CAUSAL)[2] > 1
    assert kv(1, 17, 1500, 66, 64, 132, **NON_CAUSAL)[2] > 1   # 1 tile x 66
    assert kv(1, 65, 1500, 66, 64, 132, **NON_CAUSAL)[2] == 1  # 2 tiles x 66
    assert kv(1, 1, 255, 1, 64, 132, **NON_CAUSAL) == (0, 255, 1)
    assert kv(1, 1, 256, 1, 64, 132, **NON_CAUSAL) == (0, 128, 2)
    assert kv(1, 1, 256, 1, 128, 132, **NON_CAUSAL) == (0, 64, 4)
    assert kv(1, 1, 10 ** 6, 1, 16, 132, **NON_CAUSAL)[2] == tfa.MAX_SPLITS
    # causal: one query at position 200 sees keys 0..200 of 4000
    assert kv(1, 1, 4000, 1, 128, 132, causal=True, window=0,
              q_offset=200) == (0, 128, 2)
    # a window of 300 ending at position 3000: keys 2701..3000, from 2688
    assert kv(1, 1, 4000, 1, 128, 132, causal=True, window=300,
              q_offset=3000) == (2688, 128, 3)
    assert kv(1, 4, 100, 1, 64, 132, causal=True, window=5,
              q_offset=500) == (0, 100, 1)             # nothing seen
    rng = np.random.default_rng(0)
    for _ in range(500):
        B, T, S, H = (int(x) for x in rng.integers(1, (9, 40, 9000, 40)))
        hd = int(rng.choice([16, 50, 64, 96, 128, 256]))
        causal = bool(rng.integers(2))
        mask = dict(causal=causal, window=int(rng.integers(0, 2 * S)),
                    q_offset=int(rng.integers(0, S)) if causal else 0)
        begin, span, n = kv(B, T, S, H, hd, 132, **mask)
        assert 1 <= n <= tfa.MAX_SPLITS
        if n == 1:
            assert (begin, span) == (0, S)
            continue
        seen = tfa.visible_mask(T, S, **mask).any(dim=0).nonzero()
        first, last = int(seen.min()), int(seen.max()) + 1
        assert (first, last) == (max(0, mask["q_offset"] - mask["window"]
                                     + 1) if mask["window"] else 0,
                                 tfa.seen_keys(T, S, **mask)[1])
        assert begin % tfa.SPLIT_ALIGN == 0 and span % tfa.SPLIT_ALIGN == 0
        assert begin <= first and begin + (n - 1) * span < last
        assert last <= begin + n * span


def test_wrapper_takes_plain_on_cpu_and_counts_nothing():
    q, k, v = (torch.from_numpy(a) for a in _qkv(2, 1, 9, 9, 4, 2, 16))
    n = tfa.flash_attention.launches
    out = tops.flash_attention(q, k, v, causal=True, q_offset=0)
    assert tfa.flash_attention.launches == n
    torch.testing.assert_close(out, tfa.flash_attention_plain(q, k, v),
                               atol=0, rtol=0)


# ---------------------------------------------------------------------------
# the model's prefill with the kernel path forced (plain versions on CPU)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def model():
    cfg = reduced(get_config("internlm2-1.8b"))
    tcfg = t_reduced(t_get_config("internlm2-1.8b"))
    jparams = jtfm.init_params(cfg, jax.random.PRNGKey(0))
    return cfg, tcfg, jparams, params_from_jax(jax.device_get(jparams), "cpu")


@pytest.fixture
def counted(monkeypatch):
    """Counts the model's calls of kernels.ops.flash_attention."""
    calls = []
    real = tops.flash_attention

    def wrapper(*a, **kw):
        calls.append(kw.get("q_offset", 0))
        return real(*a, **kw)
    monkeypatch.setattr(tops, "flash_attention", wrapper)
    return calls


def test_slot_prefill_in_two_chunks_matches_jax(model, counted):
    """Slot-cache prefill of 10 tokens as chunks of 6 and 4 (the second at
    cache_offset 6) with the kernel path forced: last-position logits of
    each chunk within 1e-4 of JAX's prefill, and one flash call per layer
    and chunk at q_offset = the chunk's offset."""
    cfg, tcfg, jparams, tparams = model
    prompts = np.random.default_rng(8).integers(
        0, cfg.vocab_size, (2, 10)).astype(np.int32)
    jcache = jtfm.init_cache(cfg, 2, 12)
    tcache = ttfm.init_cache(tcfg, 2, 12, device="cpu")
    for off, n in ((0, 6), (6, 4)):
        piece = prompts[:, off:off + n]
        jl, jcache = jtfm.prefill(jparams, cfg, jnp.asarray(piece), jcache,
                                  CTX, last_only=True, cache_offset=off)
        tl, tcache = ttfm.prefill(tparams, tcfg,
                                  torch.from_numpy(piece.astype(np.int64)),
                                  tcache, last_only=True, cache_offset=off,
                                  paged_kernel=True)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                   atol=LOGIT_ATOL)
    L = tcfg.n_layers
    assert counted == [0] * L + [6] * L


def test_paged_prefill_chunks_match_jax(model, counted):
    """Paged prefill in chunks of 4 (a ragged final chunk) over a page
    table, kernel path forced: each chunk's last-index logits within 1e-4
    of JAX's paged prefill; flash runs over the gathered view."""
    cfg, tcfg, jparams, tparams = model
    tables = np.asarray([[3, 1, 5, 8, 0], [2, 6, 4, 7, 0]], np.int32)
    prompts = np.random.default_rng(2).integers(
        0, cfg.vocab_size, (2, 10)).astype(np.int32)
    jcache = jtfm.init_cache(cfg, 9, 4, dtype=cfg.cdtype())
    tcache = ttfm.init_cache(tcfg, 9, 4, device="cpu")
    for off in range(0, 10, 4):
        piece = prompts[:, off:off + 4]
        last = np.full((2,), min(9 - off, piece.shape[1] - 1))
        jl, jcache = jtfm.prefill(jparams, cfg, jnp.asarray(piece), jcache,
                                  CTX, cache_offset=off,
                                  pages=jnp.asarray(tables),
                                  last_index=jnp.asarray(last))
        tl, tcache = ttfm.prefill(tparams, tcfg,
                                  torch.from_numpy(piece.astype(np.int64)),
                                  tcache, cache_offset=off,
                                  pages=torch.from_numpy(tables),
                                  last_index=torch.from_numpy(last),
                                  paged_kernel=True)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                   atol=LOGIT_ATOL)
    assert counted == sum(([o] * tcfg.n_layers for o in (0, 4, 8)), [])


def test_in_sequence_branch_takes_kernel_only_without_autograd(
        model, counted, monkeypatch):
    """tfm.forward: under inference mode with the switch forced on, the
    cacheless branch runs flash (logits within 1e-4 of JAX's forward);
    recording autograd, it keeps `_attend`."""
    cfg, tcfg, jparams, tparams = model
    monkeypatch.setenv("REPRO_PAGED_KERNEL", "1")
    toks = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 12)).astype(np.int32)
    ref = np.asarray(jtfm.forward(jparams, cfg, jnp.asarray(toks), CTX))
    with torch.inference_mode():
        out = ttfm.forward(tparams, tcfg, torch.from_numpy(toks))
    np.testing.assert_allclose(out.numpy(), ref, atol=LOGIT_ATOL)
    assert counted == [0] * tcfg.n_layers
    leaf = {k: v.clone().requires_grad_(True) for k, v in
            tparams["blocks"]["dense"]["attn"].items()}
    params = {**tparams, "blocks": {"dense": {
        **tparams["blocks"]["dense"], "attn": leaf}}}
    ttfm.forward(params, tcfg, torch.from_numpy(toks)).sum().backward()
    assert counted == [0] * tcfg.n_layers
    assert leaf["wq"].grad is not None


def test_gqa_forward_kernel_and_plain_paths_agree(model):
    """One layer's slot prefill at cache_offset 3, both paths: outputs
    within 1e-5 and the caches bit-identical."""
    _, tcfg, _, tparams = model
    p = {k: v[0] for k, v in tparams["blocks"]["dense"]["attn"].items()}
    ac = ttfm.attn_config(tcfg)
    rng = np.random.default_rng(9)
    x = torch.from_numpy(rng.standard_normal((2, 5, tcfg.d_model))
                         .astype(np.float32) * 0.3)
    base = {n: torch.from_numpy(rng.standard_normal(
        (2, 12, tcfg.n_kv_heads, tcfg.head_dim)).astype(np.float32) * 0.1)
        for n in ("k", "v")}
    pos = torch.arange(3, 8)[None, :]
    out = {}
    for kernel in (False, True):
        c = {n: t.clone() for n, t in base.items()}
        out[kernel] = tattn.gqa_forward(p, ac, x, pos, c, 3,
                                        paged_kernel=kernel)
    torch.testing.assert_close(out[True][0], out[False][0], atol=F32_ATOL,
                               rtol=0)
    for n in ("k", "v"):
        torch.testing.assert_close(out[True][1][n], out[False][1][n], atol=0,
                                   rtol=0)
