"""The redesigned Gatekeeper-loss kernel's arithmetic, emulated in torch on
the CPU, and the Stage-2 loss that hands it only the rows it reads.

  * Precision: the kernel computes each logit as split-TF32 products with
    fp32 accumulation, operands split by bit masks as
    `csrc/gatekeeper_loss.cu` splits them (hi rounded to TF32, lo = v -
    hi, which the tensor cores truncate to TF32). Emulated at d = 2048 with
    peaked logits, the three-product sum holds the full-width check's
    tolerances (`chip_smoke.py`'s LOSS_ATOL = 1e-3 on ce / kl / entropy,
    `correct` equal on rows whose top-2 gap exceeds TIE_GAP = 1e-4);
    one TF32 product misses them. A bf16 x has lo exactly 0, so its two
    products give the three-product sum bit for bit. The tensor cores'
    truncating accumulation, which the kernels bound by summing a few k8
    steps' products in a fresh accumulator before an fp32 add, is not
    emulated here: the card tests hold it (logits of std 16 at 1e-4).
  * The merge kernel, emulated in its fixed order (lane l folds splits l,
    l + 32, ... in turn, then xor shuffles 16 .. 1), on per-split partials
    at the splits `vocab_split` makes, against the plain version; exact
    ties resolve to the lowest index.
  * `launch.steps.fused_gatekeeper_loss` under a mask against JAX's
    `chunked_gatekeeper_loss`: loss, aux and both gradient leaves within
    the 1e-5 of tests/test_torch_vlm.py, with only the rows of non-zero
    weight reaching the kernel's wrapper, and none (no call) when no row
    is valid.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.gatekeeper import GatekeeperConfig as JGK
from repro.launch import steps as jsteps
from repro_torch.core.gatekeeper import GatekeeperConfig as TGK
from repro_torch.kernels import gatekeeper_loss as tk
from repro_torch.launch import steps as tsteps

LOSS_ATOL = 1e-3     # chip_smoke.py's full-width tolerance (ce / kl / H)
TIE_GAP = 1e-4       # rows whose top-2 logits lie closer may flip `correct`
ATOL = 1e-5          # tests/test_torch_vlm.py's parity tolerance
MASK = -8192         # 0xffffe000: the 19 bits of a TF32 operand
NEG, NO_INDEX = -1e30, 2 ** 31 - 1


def _split(v: torch.Tensor):
    """fp32 -> (hi, lo) as `split_tf32`: hi rounded to TF32 to nearest,
    ties away from zero, by an integer add and a mask; lo = v - hi."""
    hi = ((v.view(torch.int32) + 0x1000) & MASK).view(torch.float32)
    return hi, v - hi


def _read(v: torch.Tensor) -> torch.Tensor:
    """What the tensor cores read of an fp32 operand: its top 19 bits."""
    return (v.view(torch.int32) & MASK).view(torch.float32)


def _products(x: torch.Tensor, table: torch.Tensor, n: int) -> torch.Tensor:
    """The kernel's logits as n TF32 products, each an fp32 product of the
    operands the tensor cores read, summed small ones first: lo.hi (x's
    lo), hi.lo, hi.hi. n = 1 is a single product of the rounded
    operands."""
    xh, xl = _split(x)
    th, tl = _split(table)
    hh = xh @ th.t()
    if n == 1:
        return hh
    hl = xh @ _read(tl).t()
    if n == 2:
        return hl + hh
    return (_read(xl) @ th.t() + hl) + hh


def _stats(logits: torch.Tensor, tgt: torch.Tensor):
    """(ce, kl, correct, entropy) of fp32 logits, as the plain version."""
    lse = torch.logsumexp(logits, -1)
    logp = logits - lse[:, None]
    ce = -logp.gather(1, tgt.long()[:, None])[:, 0]
    ent = -(torch.exp(logp) * logp).sum(-1)
    kl = float(np.log(logits.shape[1])) - ent
    return ce, kl, (logits.argmax(-1) == tgt.long()).float(), ent


def _peaked_case(x_dtype, T=64, V=4000, d=2048, seed=0):
    """x of unit scale, the table at 8x the init's 1/sqrt(d) (logits of
    std 8: peaked softmaxes), targets at the argmax for half the rows."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((T, d)).astype(np.float32))
    x = x.to(x_dtype).float()
    table = torch.from_numpy(
        (rng.standard_normal((V, d)) * 8 / np.sqrt(d)).astype(np.float32))
    ref = x.double() @ table.double().t()
    tgt = torch.from_numpy(rng.integers(0, V, T).astype(np.int32))
    hit = torch.from_numpy(rng.random(T) < 0.5)
    tgt = torch.where(hit, ref.argmax(-1).int(), tgt)
    top2 = torch.topk(ref, 2, -1).values
    return x, table, tgt, (top2[:, 0] - top2[:, 1]).float()


def _miss(got, want, gap):
    """(max|err| of ce / kl / entropy, `correct` flips on clear rows)."""
    err = max(float((a - b).abs().max())
              for i, (a, b) in enumerate(zip(got, want)) if i != 2)
    clear = gap > TIE_GAP
    return err, int((got[2][clear] != want[2][clear]).sum())


@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16],
                         ids=["x-fp32", "x-bf16"])
def test_split_tf32_products_hold_the_full_width_tolerance(x_dtype):
    """Three products (two for bf16 x) within LOSS_ATOL and no clear flip
    against the plain version at d = 2048 with peaked logits; one TF32
    product misses."""
    x, table, tgt, gap = _peaked_case(x_dtype)
    want = tk.gatekeeper_loss_tokens_plain(x, table, tgt)
    n = 3 if x_dtype == torch.float32 else 2
    err, flips = _miss(_stats(_products(x, table, n), tgt), want, gap)
    assert err <= LOSS_ATOL / 20 and flips == 0, (err, flips)
    err1, flips1 = _miss(_stats(_products(x, table, 1), tgt), want, gap)
    assert err1 > LOSS_ATOL or flips1 > 0, (err1, flips1)


def test_bf16_x_two_products_equal_three_bit_for_bit():
    """A bf16 value is exact in TF32: its lo is exactly 0, so the lo.hi
    product adds exactly nothing and the kernel's two-product sum is the
    three-product sum, bit for bit."""
    x, table, _, _ = _peaked_case(torch.bfloat16, T=32, V=600, d=768)
    xh, xl = _split(x)
    assert torch.equal(xh, x) and not bool(xl.any())
    assert torch.equal(_products(x, table, 2), _products(x, table, 3))


def _merge(a, b):
    """`merge_stats`: equal maxima keep the lower index."""
    m, s, w, i = a
    m2, s2, w2, i2 = b
    mn = torch.maximum(m, m2)
    ea, eb = torch.exp(m - mn), torch.exp(m2 - mn)
    take = (m2 > m) | ((m2 == m) & (i2 < i))
    return mn, s * ea + s2 * eb, w * ea + w2 * eb, torch.where(take, i2, i)


def _emulated_kernel(logits: torch.Tensor, tgt: torch.Tensor, span: int):
    """Partials of splits of `span` columns from fp32 logits, then the
    merge kernel in its order: lane l folds splits l, l + 32, ... in
    turn, then the lanes merge by xor shuffles 16, 8, 4, 2, 1; lane 0's
    state gives the outputs."""
    T, V = logits.shape
    parts = []
    for c0 in range(0, V, span):
        lc = logits[:, c0:c0 + span]
        m = lc.max(-1).values
        p = torch.exp(lc - m[:, None])
        parts.append((m, p.sum(-1), (p * lc).sum(-1),
                      lc.argmax(-1) + c0))        # first index of the max
    ident = (torch.full((T,), NEG), torch.zeros(T), torch.zeros(T),
             torch.full((T,), NO_INDEX, dtype=torch.long))
    lanes = []
    for lane in range(32):
        st = ident
        for sp in range(lane, len(parts), 32):
            st = _merge(st, parts[sp])
        lanes.append(st)
    for off in (16, 8, 4, 2, 1):
        lanes = [_merge(lanes[i], lanes[i ^ off]) for i in range(32)]
    m, s, w, idx = lanes[0]
    lse = m + torch.log(s)
    ent = lse - w / s
    tl = logits.gather(1, tgt.long()[:, None])[:, 0]
    return (lse - tl, float(np.log(V)) - ent,
            (idx == tgt.long()).float(), ent)


@pytest.mark.parametrize("T,V", [(24, 32064), (128, 9000), (200, 1000)],
                         ids=["vlm-rows", "whisper-rows", "two-blocks"])
def test_merge_in_its_fixed_order_matches_plain(T, V):
    """At the splits `vocab_split` makes for 132 SMs (251, 71 and 8 of
    them), within 1e-4 of the plain version; duplicated table rows (exact
    ties across splits) resolve to the lowest index."""
    rng = np.random.default_rng(T)
    d = 64
    x = torch.from_numpy(rng.standard_normal((T, d)).astype(np.float32))
    table = torch.from_numpy(
        (rng.standard_normal((V, d)) * 3 / np.sqrt(d)).astype(np.float32))
    table[V - 5] = table[7]                 # ties: 7 wins over V - 5
    x[0] = table[7] * 10.0                  # row 0's argmax is a tie
    tgt = torch.from_numpy(rng.integers(0, V, T).astype(np.int32))
    tgt[0] = 7
    per, n_splits = tk.vocab_split(T, V, 132)
    logits = x @ table.t()
    got = _emulated_kernel(logits, tgt, per * 128)
    want = tk.gatekeeper_loss_tokens_plain(x, table, tgt)
    for i in (0, 1, 3):
        torch.testing.assert_close(got[i], want[i], atol=1e-4, rtol=0)
    assert torch.equal(got[2], want[2])
    assert float(got[2][0]) == 1.0 and n_splits > (32 if T < 200 else 1)


def _jax_loss_and_grads(x, table, tgt, mask, alpha):
    def f(xx, tb):
        return jsteps.chunked_gatekeeper_loss(
            xx, tb, jnp.asarray(tgt), JGK(alpha=alpha), jnp.asarray(mask))
    (loss, aux), (gx, gt) = jax.value_and_grad(f, argnums=(0, 1),
                                               has_aux=True)(
        jnp.asarray(x), jnp.asarray(table))
    return loss, aux, np.asarray(gx), np.asarray(gt)


def _masks(B, S):
    rng = np.random.default_rng(5)
    frac = rng.choice([0.0, 0.25, 0.5, 1.0], size=(B, S)).astype(np.float32)
    blocks = np.ones((B, S), np.float32)
    blocks[:2] = 0.0                        # whole sequences out of the loss
    blocks[3, :40] = 0.0
    return {"no-valid-row": np.zeros((B, S), np.float32),
            "fractional": frac, "empty-blocks": blocks}


@pytest.mark.parametrize("name", ["no-valid-row", "fractional",
                                  "empty-blocks"])
def test_fused_loss_hands_only_weighted_rows_and_matches_jax(name,
                                                              monkeypatch):
    """Loss, aux and the gradients of x and the table against jax.grad of
    JAX's `chunked_gatekeeper_loss`, atol 1e-5; the wrapper sees exactly
    the rows of non-zero weight (no call without one, and then every
    gradient is exactly zero)."""
    B, S, d, V = 4, 96, 48, 700
    rng = np.random.default_rng(11)
    x = rng.standard_normal((B, S, d)).astype(np.float32)
    table = (rng.standard_normal((V, d)) * 3 / np.sqrt(d)).astype(np.float32)
    tgt = rng.integers(0, V, (B, S)).astype(np.int32)
    mask = _masks(B, S)[name]
    lj, aj, gxj, gtj = _jax_loss_and_grads(x, table, tgt, mask, 0.3)

    seen = []
    inner = tk.gatekeeper_loss_tokens

    def recording(xx, *args, **kw):
        seen.append(xx.shape[0])
        return inner(xx, *args, **kw)
    monkeypatch.setattr(tk, "gatekeeper_loss_tokens", recording)
    xt = torch.from_numpy(x).requires_grad_(True)
    tt = torch.from_numpy(table).requires_grad_(True)
    lt, at = tsteps.fused_gatekeeper_loss(xt, tt, torch.from_numpy(tgt),
                                          TGK(alpha=0.3),
                                          torch.from_numpy(mask))
    lt.backward()
    assert seen == ([] if name == "no-valid-row"
                    else [int((mask != 0).sum())])
    assert abs(float(lt.detach()) - float(lj)) <= ATOL
    assert set(at) == set(aj)
    for k in aj:
        assert abs(float(at[k]) - float(aj[k])) <= ATOL, k
    np.testing.assert_allclose(xt.grad.numpy(), gxj, atol=ATOL, rtol=0)
    np.testing.assert_allclose(tt.grad.numpy(), gtj, atol=ATOL, rtol=0)
    dead = mask == 0
    assert not xt.grad.numpy()[dead].any()   # exactly zero, as JAX's
    if name == "no-valid-row":
        assert float(lt.detach()) == 0.0 and not tt.grad.numpy().any()
