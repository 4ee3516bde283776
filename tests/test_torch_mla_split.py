"""The redesigned paged MLA decode and the one-launch paged write, on the CPU.

The CUDA MLA kernel takes both of its products on the tensor cores with
bf16 operands and fp32 accumulation, each operand as two bf16 halves (hi +
lo). A torch emulation of those roundings pins the design at the main
path's full width: the split holds the 1e-4 that the card tests hold the
kernel to with a 5x margin, and a single bf16 operand does not hold it.
`paged_write_token_pair` on CPU tensors is two plain writes; it is held
to the JAX package's Pallas `paged_write_token` (interpret mode), leaf by
leaf. Inputs come from numpy seeds."""
import math

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import _build
from repro_torch.kernels import ops as tops
from repro_torch.kernels import paged_attention as tpa

torch.set_num_threads(1)

CARD_ATOL = 1e-4      # the card tests' tolerance for the kernel's fp32 output
H, S, R, DR = 128, 288, 512, 64   # DeepSeek-V2's heads and MLA widths


def _halves(t: torch.Tensor):
    """t as hi = bf16(t) and lo = bf16(t - hi), both back in fp32."""
    hi = t.bfloat16().float()
    return hi, (t - hi).bfloat16().float()


def _emulated_kernel(q_abs, q_rope, ckv, kr, w, scale, scheme, eps=1e-6):
    """The kernel's arithmetic for one row whose positions all count: the
    latent rms-normed in fp32, products of bf16 halves (exact in fp32)
    summed in fp32, an fp32 softmax, P as bf16 halves, division by the
    fp32 row sum. `scheme`: "split" is the kernel (scores q_hi.n_hi +
    q_hi.n_lo + q_lo.n_hi and the same for q_rope . kr; P @ V as
    P_hi.V_hi + P_hi.V_lo + P_lo.V_hi); "single_v" drops V's lo half;
    "single" takes every operand as one bf16."""
    x = ckv.float()
    n = x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * (
        1.0 + w.float())
    (qh, ql), (nh, nl), (rh, rl), (kh, kl) = map(
        _halves, (q_abs.float(), n, q_rope.float(), kr.float()))
    if scheme == "single":
        s = qh @ nh.T + rh @ kh.T
    else:
        s = (qh @ nh.T + qh @ nl.T + ql @ nh.T
             + rh @ kh.T + rh @ kl.T + rl @ kh.T)
    s = s * scale
    p = torch.exp(s - s.amax(-1, keepdim=True))
    ph, pl = _halves(p)
    if scheme == "split":
        o = ph @ nh + ph @ nl + pl @ nh
    elif scheme == "single_v":
        o = ph @ nh + pl @ nh
    else:
        o = ph @ nh
    return o / p.sum(-1, keepdim=True)


def _reference(q_abs, q_rope, ckv, kr, w, scale, eps=1e-6):
    """The kernel's function in fp64."""
    x = ckv.double()
    n = x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * (
        1.0 + w.double())
    s = (q_abs.double() @ n.T + q_rope.double() @ kr.double().T) * scale
    return torch.softmax(s, -1) @ n


@pytest.mark.parametrize("q_dtype", [torch.bfloat16, torch.float32],
                         ids=["q bf16", "q fp32"])
def test_mla_kernel_precision_design_holds_the_card_tolerance(q_dtype):
    """One full-width row (128 heads, 288 positions, kv_lora 512, rope 64)
    over bf16 pages: the hi + lo split of both products stays within a
    fifth of the card tolerance against fp64, and single bf16 operands, or
    a single bf16 V, miss the tolerance, so neither can pass for a
    simplification of the kernel."""
    rng = np.random.default_rng(23)

    def f(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    q_abs, q_rope = f(H, R).to(q_dtype), f(H, DR).to(q_dtype)
    ckv, kr = f(S, R).bfloat16(), f(S, DR).bfloat16()
    w = (0.1 * f(R)).bfloat16()
    scale = 1.0 / math.sqrt(128 + DR)
    ref = _reference(q_abs, q_rope, ckv, kr, w, scale)

    def err(scheme):
        out = _emulated_kernel(q_abs, q_rope, ckv, kr, w, scale, scheme)
        return float((out.double() - ref).abs().max())
    assert err("split") <= CARD_ATOL / 5
    assert err("single_v") > CARD_ATOL
    assert err("single") > CARD_ATOL


# disjoint nonzero blocks per row; row 2 writes past its table (the block
# index is clipped to the last column) and row 3 into an unmapped block
TABLES = np.asarray([[1, 2, 3, 0],
                     [4, 5, 0, 0],
                     [6, 7, 8, 9],
                     [0, 0, 0, 0]], np.int32)
POS = np.asarray([9, 6, 21, 3], np.int32)
N, BS = 10, 4
TYPES = {"fp32": (torch.float32, jnp.float32),
         "bf16": (torch.bfloat16, jnp.bfloat16)}


@pytest.mark.parametrize("type_a", ["fp32", "bf16"])
@pytest.mark.parametrize("type_b", ["fp32", "bf16"])
def test_pair_write_on_cpu_matches_jax_kernel_per_leaf(monkeypatch, type_a,
                                                       type_b):
    """Two leaves of different widths (DeepSeek-V2's ckv 512 and kr 64)
    and types, fp32 values cast into them: each leaf bit for bit as JAX's
    interpret-mode `paged_write_token` writes it, the trash block 0
    included, in place; no build and no launch on CPU tensors."""
    def no_build(name):
        raise AssertionError(f"tried to build {name} for CPU tensors")
    monkeypatch.setattr(_build, "load", no_build)
    rng = np.random.default_rng(7)
    leaves, values, want = [], [], []
    for width, kind in ((R, type_a), (DR, type_b)):
        leaf = rng.standard_normal((N, BS, width)).astype(np.float32)
        vals = rng.standard_normal((len(POS), width)).astype(np.float32)
        jleaf = jnp.asarray(leaf).astype(TYPES[kind][1])
        ref = jops.paged_write_token(jleaf, jnp.asarray(TABLES),
                                     jnp.asarray(POS), jnp.asarray(vals),
                                     interpret=True)
        want.append(np.asarray(ref.astype(jnp.float32)))
        leaves.append(torch.from_numpy(leaf).to(TYPES[kind][0]))
        values.append(torch.from_numpy(vals))
    n = tpa.paged_write_token.launches
    got = tops.paged_write_token_pair(leaves[0], leaves[1],
                                      torch.from_numpy(TABLES),
                                      torch.from_numpy(POS), *values)
    assert tpa.paged_write_token.launches == n
    assert got[0] is leaves[0] and got[1] is leaves[1]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.float().numpy(), w)


@pytest.mark.parametrize("bs", [1, 4, 5, 16, 32])
def test_mla_splits_fit_a_workspace_bounded_whatever_the_cache_length(bs):
    """The MLA kernel's rule (`row_span` in csrc/mla_attention.cu): a row
    whose position reaches past MLA_MAX_SPLITS base spans takes longer
    splits, a whole number of spans each. So a row's splits follow from
    its position alone, the same for every table at least as wide as its
    active prefix, and never outnumber the workspace's
    `mla_split_count(M, bs)` partials a row, which stays at most
    MLA_MAX_SPLITS up to DeepSeek-V2's 128k context and beyond."""
    span = tpa.split_span(bs)

    def row_splits(pos, M):
        per = span * tpa.MLA_MAX_SPLITS
        rs = span * max(1, -(-(pos + 1) // per))
        n_tok = min(M * bs, pos + 1)
        return [(s * rs, min((s + 1) * rs, n_tok))
                for s in range(-(-n_tok // rs))]

    for pos in (0, 63, 64, 2047, 2048, 5000, 131071):
        need = pos // bs + 1
        want = row_splits(pos, need)
        assert want[0][0] == 0 and want[-1][1] == pos + 1
        assert all(a[1] == b[0] for a, b in zip(want, want[1:]))
        for M in (need, need + 1, 2 * need, need + 5000):
            n = tpa.mla_split_count(M, bs)
            assert row_splits(pos, M) == want
            assert len(want) <= n <= tpa.MLA_MAX_SPLITS
            assert n == min(tpa.MLA_MAX_SPLITS, -(-M * bs // span))
    assert tpa.mla_split_count(131072 // bs, bs) == tpa.MLA_MAX_SPLITS
