"""The precision design of the chunk-parallel `wkv_scan` prefill kernel
(`csrc/wkv_scan.cu`, T >= 2), pinned on the CPU.

`_emulated_chunked_kernel` repeats the kernel's algebra in plain torch: 64-
token chunks of 16-token sub-chunks, log2-unit decay sums, chunk states
carried from chunk to chunk, off-diagonal sub-chunk blocks referenced at
the key sub-chunk's last token, exact diagonal blocks, the `u` bonus on
the diagonal, and every matrix product's operands cut to TF32 as the
tensor cores read them: one TF32 product, or each fp32 operand split into
TF32 hi + lo with three products summed in fp32 (the kernel's choice). It is held against
JAX's Pallas `wkv_scan` (interpret mode) and `linear_attention_scan` on
numpy-seeded inputs, in both modes and decay forms, at the decays of
`chip_smoke.py` and at RWKV6's strong ones (logw = -exp(U(-3, 3)), down to
-20 a token): the split must use at most half of the card tolerance
(atol = rtol = 5e-4, as `tests/test_torch_cuda.py` holds the kernel), and
a single TF32 product must miss it, so a one-product kernel fails here."""
import math

import numpy as np
import pytest

import jax.numpy as jnp
import torch
import torch.nn.functional as F

from repro.kernels.wkv_scan import wkv_scan as j_wkv_scan
from repro.models import ssm as jssm
from repro_torch.kernels import wkv_scan as wk

torch.set_num_threads(1)
CARD_TOL = 5e-4        # atol = rtol of the kernel's card tests
SPLIT_SHARE = 0.5      # the split may use at most this share of CARD_TOL
LOG2E = 1.4426950408889634
CHUNK, SUB = wk.CHUNK, wk.SUB_CHUNK


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """fp32 cut to TF32 (its top 19 bits, 10 of the mantissa), as the
    tensor cores read an fp32 register and as the kernel masks its split."""
    return (x.contiguous().view(torch.int32) & -0x2000).view(torch.float32)


def _mm(a: torch.Tensor, b: torch.Tensor, products: str) -> torch.Tensor:
    """a @ b with fp32 accumulation and the operands cut as `products`
    says: "fp32" (exact operands), "tf32" (one TF32 product) or "3xtf32"
    (hi = tf32(x), lo = tf32(x - hi); lo.hi + hi.lo + hi.hi)."""
    if products == "fp32":
        return a @ b
    ah, bh = _tf32(a), _tf32(b)
    if products == "tf32":
        return ah @ bh
    assert products == "3xtf32", products
    al, bl = _tf32(a - ah), _tf32(b - bh)
    return (al @ bh + ah @ bl) + ah @ bh


def _emulated_chunked_kernel(q, k, v, logw, u, s0, mode: str, products: str):
    """The kernel's three phases on fp32 CPU tensors. q, k [B,T,H,K]; v
    [B,T,H,V]; logw [B,T,H,K] or [B,T,H,1]; u [H,K]; s0 [B,H,K,V]. Returns
    (y [B,T,H,V], final state [B,H,K,V])."""
    B, T, H, K = q.shape
    V = v.shape[-1]
    NC, NS = math.ceil(T / CHUNK), CHUNK // SUB

    def chunks(x):                       # [B, H, NC, CHUNK, *], zero-padded
        x = F.pad(x.float(), (0, 0, 0, 0, 0, NC * CHUNK - T))
        return x.reshape(B, NC, CHUNK, H, x.shape[-1]).permute(0, 3, 1, 2, 4)

    qc, kc, vc = chunks(q), chunks(k), chunks(v)
    lw2 = chunks(logw) * LOG2E
    cums, run = [], torch.zeros_like(lw2[..., 0, :])
    for t in range(CHUNK):               # in token order, as the kernel sums
        run = run + lw2[..., t, :]
        cums.append(run)
    cum = torch.stack(cums, -2)          # inclusive, log2 units
    ocum = cum if mode == "mamba" else F.pad(cum, (0, 0, 1, 0))[..., :-1, :]

    # 1. chunk states dS_c and decays g_c; 2. the carry
    last = cum[..., -1:, :]
    dS = _mm((kc * torch.exp2(last - cum)).transpose(-1, -2), vc, products)
    g = torch.exp2(last).transpose(-1, -2)            # [B, H, NC, Kw, 1]
    S, starts = s0.float(), []
    for c in range(NC):
        starts.append(S)
        S = g[:, :, c] * S + dS[:, :, c]
    Sc = torch.stack(starts, 2)

    # 3. outputs: r_j = cum at the last token of sub-chunk j, r_{-1} = 0
    r = cum[..., SUB - 1::SUB, :]
    r_prev = F.pad(r, (0, 0, 1, 0))[..., :-1, :]
    qd = qc * torch.exp2(ocum - r_prev.repeat_interleave(SUB, -2))
    kd = kc * torch.exp2(r.repeat_interleave(SUB, -2) - cum)
    y = _mm(qd * torch.exp2(r_prev.repeat_interleave(SUB, -2)), Sc, products)
    A = torch.zeros(qc.shape[:-1] + (CHUNK,))
    ones = torch.ones((SUB, SUB), dtype=torch.bool)
    tri = torch.tril(ones) if mode == "mamba" else torch.tril(ones, -1)
    for i in range(NS):
        rows = slice(i * SUB, (i + 1) * SUB)
        for j in range(i):
            qi = qd[..., rows, :] * torch.exp2(r_prev[..., i:i + 1, :]
                                               - r[..., j:j + 1, :])
            A[..., rows, j * SUB:(j + 1) * SUB] = _mm(
                qi, kd[..., j * SUB:(j + 1) * SUB, :].transpose(-1, -2),
                products)
        diff = ocum[..., rows, None, :] - cum[..., None, rows, :]
        dec = torch.where(tri[:, :, None], torch.exp2(
            torch.where(tri[:, :, None], diff, 0.0)), 0.0)
        qi, ki = qc[..., rows, :], kc[..., rows, :]
        if logw.shape[-1] == 1:
            diag = (qi @ ki.transpose(-1, -2)) * dec[..., 0]
        else:
            diag = (qi[..., :, None, :] * ki[..., None, :, :] * dec).sum(-1)
        if mode == "rwkv":
            bonus = (qi * u[None, :, None, None, :].float() * ki).sum(-1)
            diag = diag + torch.diag_embed(bonus)
        A[..., rows, rows] = diag
    y = y + _mm(A, vc, products)
    y = y.permute(0, 2, 3, 1, 4).reshape(B, NC * CHUNK, H, V)[:, :T]
    return y, S


def _inputs(seed, B, T, H, K, V, scalar, strong):
    """chip_smoke.py's `wkv_case` distributions, with logw in [-1, -0.05]
    or, `strong`, -exp(U(-3, 3)) (RWKV6's decays, down to -20 a token)."""
    rng = np.random.default_rng(seed)
    q, k = (0.5 * rng.standard_normal((B, T, H, K)) for _ in range(2))
    v = 0.5 * rng.standard_normal((B, T, H, V))
    Kw = 1 if scalar else K
    logw = (-np.exp(rng.uniform(-3, 3, (B, T, H, Kw))) if strong
            else -rng.uniform(0.05, 1.0, (B, T, H, Kw)))
    u = 0.3 * rng.standard_normal((H, K))
    s0 = 0.2 * rng.standard_normal((B, H, K, V))
    return [a.astype(np.float32) for a in (q, k, v, logw, u, s0)]


def _share(got, want) -> float:
    got, want = (torch.as_tensor(np.array(a)) for a in (got, want))
    assert torch.isfinite(got).all()
    return float(((got - want).abs() / (CARD_TOL + CARD_TOL * want.abs()))
                 .max())


@pytest.mark.parametrize("strong", [False, True], ids=["mild", "strong"])
@pytest.mark.parametrize("T", [2, 17, 97, 128, 256])
@pytest.mark.parametrize("mode,scalar", [
    ("rwkv", False), ("rwkv", True), ("mamba", False), ("mamba", True)],
    ids=["rwkv-perchannel", "rwkv-scalar", "mamba-perchannel",
         "mamba-scalar"])
def test_split_products_hold_the_card_tolerance(mode, scalar, T, strong):
    """The 3xTF32 emulation against JAX's kernel (interpret mode; the decay
    broadcast over K, as it takes it) and JAX's `linear_attention_scan`,
    y and state, within half the card tolerance; every output finite."""
    q, k, v, logw, u, s0 = _inputs(1000 * T + 10 * scalar + strong, 2, T, 2,
                                   16, 24, scalar, strong)
    y, s = _emulated_chunked_kernel(*(torch.from_numpy(a) for a in (
        q, k, v, logw, u, s0)), mode=mode, products="3xtf32")
    jq, jk, jv, jlw, ju, js0 = (jnp.asarray(a) for a in (q, k, v, logw, u,
                                                          s0))
    ky, ks = j_wkv_scan(jq, jk, jv, jnp.broadcast_to(jlw, jq.shape), ju, js0,
                        chunk=CHUNK, interpret=True, mode=mode)
    sy, ss = jssm.linear_attention_scan(jq, jk, jv, jlw, js0, mode=mode,
                                        u=ju if mode == "rwkv" else None)
    for want_y, want_s in ((ky, ks), (sy, ss)):
        assert _share(y, want_y) <= SPLIT_SHARE
        assert _share(s, want_s) <= SPLIT_SHARE


@pytest.mark.parametrize("strong", [False, True], ids=["mild", "strong"])
def test_single_tf32_product_misses_the_card_tolerance(strong):
    """At the card's own shape (chip_smoke.py's rwkv prefill: T 128, heads
    of K = V = 64; 2 rows of 8 heads here) against JAX's
    `linear_attention_scan`: the split stays within half the tolerance, as
    the fp32 algebra does, and one TF32 product per matrix product does
    not hold it."""
    q, k, v, logw, u, s0 = _inputs(21 + strong, 2, 128, 8, 64, 64, False,
                                   strong)
    want_y, want_s = jssm.linear_attention_scan(
        *(jnp.asarray(a) for a in (q, k, v, logw, s0)), mode="rwkv",
        u=jnp.asarray(u))
    shares = {}
    for products in ("fp32", "3xtf32", "tf32"):
        y, s = _emulated_chunked_kernel(*(torch.from_numpy(a) for a in (
            q, k, v, logw, u, s0)), mode="rwkv", products=products)
        shares[products] = max(_share(y, want_y), _share(s, want_s))
    assert shares["fp32"] <= SPLIT_SHARE and shares["3xtf32"] <= SPLIT_SHARE
    assert shares["tf32"] > 1.0, shares


def test_wrappers_on_cpu_tensors():
    """On CPU tensors `wkv_scan` runs its plain version and counts no
    launch on either path; `wkv_scan_path`, one kernel path alone, has no
    plain version and raises."""
    q, k, v, logw, u, s0 = (torch.from_numpy(a) for a in _inputs(
        3, 1, 70, 2, 16, 16, False, False))
    n, n_chunked = wk.wkv_scan.launches, wk.wkv_scan.launches_chunked
    y, s = wk.wkv_scan(q, k, v, logw, u, s0, mode="rwkv")
    ref_y, ref_s = wk.wkv_scan_plain(q, k, v, logw, u, s0, mode="rwkv")
    torch.testing.assert_close(y, ref_y, atol=0, rtol=0)
    torch.testing.assert_close(s, ref_s, atol=0, rtol=0)
    for chunked in (False, True):
        with pytest.raises(ValueError, match="CUDA"):
            wk.wkv_scan_path(q, k, v, logw, u, s0, chunked=chunked)
    assert (wk.wkv_scan.launches, wk.wkv_scan.launches_chunked,
            wk.wkv_scan_path.launches) == (n, n_chunked, 0)
