"""The port's CUDA kernels against their plain versions, on the card.

Marked `requires_cuda`: they skip without an NVIDIA GPU (the kernels have
no CPU mode). On the card, where JAX need not be installed: ``PYTHONPATH=src
python -m pytest -q --noconftest tests/test_torch_cuda.py`` (this file
imports no JAX; tests/conftest.py does). `chip_smoke.py` runs the same
comparisons at full width."""
import math

import numpy as np
import pytest
import torch

from repro_torch.kernels import deferral_entropy as de
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import gatekeeper_loss as gk
from repro_torch.kernels import ops
from repro_torch.kernels import paged_attention as pa
from repro_torch.kernels import wkv_scan as wk

pytestmark = pytest.mark.requires_cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _case(cuda, B, H, KV, hd, bs, q_dtype, kv_dtype, seed=0, max_pos=None):
    """Decode inputs: ragged positions below `max_pos` (8 blocks by
    default), disjoint shuffled pages per row, the last row all trash."""
    rng = np.random.default_rng(seed)
    max_pos = max_pos or 8 * bs
    pos = rng.integers(max(0, max_pos - 8 * bs * 4), max_pos, size=B)
    n_map = [math.ceil((int(p) + 1) / bs) for p in pos]
    n_map[-1] = 0                               # one all-trash row
    M = max(n_map)
    N = sum(n_map) + 2
    perm = rng.permutation(N) + 1
    tables = np.zeros((B, M), np.int32)
    used = 0
    for b, n in enumerate(n_map):
        tables[b, :n] = perm[used:used + n]
        used += n
    g = torch.Generator(device=cuda).manual_seed(seed)
    q = torch.randn((B, 1, H, hd), generator=g, device=cuda).to(q_dtype)
    kp = torch.randn((N + 1, bs, KV, hd), generator=g, device=cuda).to(kv_dtype)
    vp = torch.randn((N + 1, bs, KV, hd), generator=g, device=cuda).to(kv_dtype)
    return (q, kp, vp, torch.from_numpy(tables).to(cuda),
            torch.from_numpy(pos.astype(np.int32)).to(cuda))


DECODE_SHAPES = {   # (B, H, KV, hd, bs, positions below)
    "reduced": (4, 4, 2, 16, 4, None),
    "full-width": (8, 16, 8, 128, 16, None),
    "llama3-405b": (8, 128, 8, 128, 16, 300),      # group 16
    "kimi-hd112": (8, 64, 8, 112, 16, 300),
    "mha": (8, 20, 20, 128, 16, 300),              # qwen1.5-4b, group 1
    "mha-40": (8, 40, 40, 128, 16, 300),           # qwen1.5-32b, group 1
    "odd-hd": (4, 6, 2, 50, 5, 200),               # scalar load path
    "wide-hd": (2, 4, 2, 640, 16, 100),            # two column blocks
    "long-cache": (8, 16, 8, 128, 16, 4096),
    "mqa-group128": (2, 128, 1, 128, 16, 300),     # 8 head chunks
}
DECODE_TYPES = [
    (torch.float32, torch.bfloat16), (torch.float32, torch.float32),
    (torch.bfloat16, torch.bfloat16), (torch.bfloat16, torch.float32)]


@pytest.mark.parametrize("shape", list(DECODE_SHAPES.values()),
                         ids=list(DECODE_SHAPES))
@pytest.mark.parametrize("q_dtype,kv_dtype", DECODE_TYPES)
def test_decode_kernel_matches_plain(cuda, shape, q_dtype, kv_dtype):
    """atol 1e-4 for fp32 output (both accumulate in fp32, in different
    orders); 2e-2 for a bf16 output (one bf16 rounding of the result)."""
    *shape, max_pos = shape
    q, kp, vp, tables, pos = _case(cuda, *shape, q_dtype, kv_dtype,
                                   max_pos=max_pos)
    n = pa.paged_flash_decode_gqa.launches
    out = pa.paged_flash_decode_gqa(q, kp, vp, tables, pos)
    ref = pa.paged_flash_decode_gqa_plain(q, kp, vp, tables, pos)
    torch.cuda.synchronize()
    assert pa.paged_flash_decode_gqa.launches == n + 1
    atol = 1e-4 if q_dtype == torch.float32 else 2e-2
    torch.testing.assert_close(out.float(), ref.float(), atol=atol, rtol=0)
    assert out[-1].abs().max() == 0


@pytest.mark.parametrize("shape", ["full-width", "llama3-405b", "odd-hd",
                                   "long-cache"])
def test_decode_kernel_two_calls_bit_equal(cuda, shape):
    """The splits' partials are merged in split order, with no atomics:
    two calls on the same inputs give the same bits."""
    *shape, max_pos = DECODE_SHAPES[shape]
    q, kp, vp, tables, pos = _case(cuda, *shape, torch.float32,
                                   torch.bfloat16, max_pos=max_pos)
    first = pa.paged_flash_decode_gqa(q, kp, vp, tables, pos)
    second = pa.paged_flash_decode_gqa(q, kp, vp, tables, pos)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


def test_decode_kernel_exact_under_active_prefix_slice(cuda):
    """Cutting the page table to the blocks the positions reach leaves the
    kernel's output bit-identical: it never visits the blocks cut away."""
    q, kp, vp, tables, pos = _case(cuda, 8, 16, 8, 128, 16, torch.float32,
                                   torch.bfloat16)
    need = int((pos.max() // 16) + 1)
    wide = torch.cat([tables, torch.zeros_like(tables)], dim=1).contiguous()
    full = pa.paged_flash_decode_gqa(q, kp, vp, wide, pos)
    cut = pa.paged_flash_decode_gqa(q, kp, vp, wide[:, :need].contiguous(),
                                    pos)
    torch.cuda.synchronize()
    torch.testing.assert_close(cut, full, atol=0, rtol=0)


@pytest.mark.parametrize("max_pos,width", [(300, 32), (300, 64), (700, 64)])
def test_decode_kernel_exact_when_the_cut_changes_the_split_count(
        cuda, max_pos, width):
    """Rows of 3 to 10 active splits, in a table cut to the active prefix
    and in one widened to `width` blocks, whose launch has 8 or 16 splits:
    the same bits. The merge sums a row's splits in an order set by
    the row's own active splits, never by the launch's split count."""
    q, kp, vp, tables, pos = _case(cuda, 8, 16, 8, 128, 16, torch.float32,
                                   torch.bfloat16, max_pos=max_pos)
    need = int((pos.max() // 16) + 1)
    assert need * 16 > 2 * pa.split_span(16) and width > need
    wide = torch.zeros((8, width), dtype=torch.int32, device=cuda)
    wide[:, :tables.shape[1]] = tables
    cut = pa.paged_flash_decode_gqa(q, kp, vp, wide[:, :need].contiguous(),
                                    pos)
    full = pa.paged_flash_decode_gqa(q, kp, vp, wide, pos)
    torch.cuda.synchronize()
    torch.testing.assert_close(cut, full, atol=0, rtol=0)


def test_decode_wrapper_raises_on_a_shape_the_kernel_refuses(cuda):
    """The kernel plans its own launch and refuses, launching nothing, a
    head_dim whose one-head 32-token stage overflows shared memory and a
    table of more than 4,096 splits; the wrapper raises, never falls
    back."""
    n = pa.paged_flash_decode_gqa.launches
    q = torch.zeros((1, 1, 1, 2048), device=cuda)
    kp = torch.zeros((2, 16, 1, 2048), device=cuda)
    one = torch.ones((1, 4), dtype=torch.int32, device=cuda)
    pos = torch.full((1,), 10, dtype=torch.int32, device=cuda)
    with pytest.raises(RuntimeError, match="launch failed"):
        pa.paged_flash_decode_gqa(q, kp, kp, one, pos)
    q = torch.zeros((1, 1, 2, 128), device=cuda)
    kp = torch.zeros((2, 64, 1, 128), device=cuda, dtype=torch.bfloat16)
    wide = torch.zeros((1, 5000), dtype=torch.int32, device=cuda)
    with pytest.raises(RuntimeError, match="launch failed"):
        pa.paged_flash_decode_gqa(q, kp, kp, wide, pos)
    torch.cuda.synchronize()
    assert pa.paged_flash_decode_gqa.launches == n


@pytest.mark.parametrize("leaf_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("val_dtype", [torch.bfloat16, torch.float32])
def test_write_kernel_matches_plain_bit_exact(cuda, leaf_dtype, val_dtype):
    q, kp, _, tables, pos = _case(cuda, 8, 16, 8, 128, 16, torch.float32,
                                  leaf_dtype)
    vals = torch.randn((8, 8, 128), device=cuda).to(val_dtype)
    ref = pa.paged_write_token_plain(kp.clone(), tables, pos, vals)
    n = pa.paged_write_token.launches
    got = pa.paged_write_token(kp, tables, pos, vals)
    torch.cuda.synchronize()
    assert got is kp and pa.paged_write_token.launches == n + 1
    torch.testing.assert_close(got[1:], ref[1:], atol=0, rtol=0)


def _mla_case(cuda, B, H, r, dr, bs, q_dtype, kv_dtype, seed=0,
              max_pos=None):
    """MLA decode inputs on the GQA case's tables and positions."""
    _, _, _, tables, pos = _case(cuda, B, 1, 1, 1, bs, torch.float32,
                                 torch.float32, seed, max_pos=max_pos)
    N = int(tables.max())
    g = torch.Generator(device=cuda).manual_seed(seed + 1)
    rnd = lambda *s: torch.randn(s, generator=g, device=cuda)  # noqa: E731
    return (rnd(B, 1, H, r).to(q_dtype), rnd(B, 1, H, dr).to(q_dtype),
            rnd(N + 1, bs, r).to(kv_dtype), rnd(N + 1, bs, dr).to(kv_dtype),
            (0.1 * rnd(r)).to(kv_dtype), tables, pos)


MLA_SHAPES = {   # (B, H, r, dr, bs, positions below)
    "reduced": (4, 4, 32, 16, 4, None),
    "full-width": (8, 128, 512, 64, 16, None),
    "long-cache": (8, 128, 512, 64, 16, 4096),     # 32 splits of 128 tokens
    "past-the-cap": (2, 128, 512, 64, 16, 20000),  # 32 splits of 640 tokens
    "h16": (8, 16, 512, 64, 16, 300),              # one head tile, half used
    "h24": (8, 24, 512, 64, 16, 300),              # H not a multiple of 32
    "bs4": (8, 128, 512, 64, 4, 200),              # 8 pages a 32-token tile
    "bs32": (8, 128, 512, 64, 32, 300),
    "odd-widths": (4, 40, 50, 10, 5, 150),         # element-wise load paths
}
MLA_TYPES = [
    (torch.float32, torch.bfloat16), (torch.float32, torch.float32),
    (torch.bfloat16, torch.bfloat16), (torch.bfloat16, torch.float32)]


@pytest.mark.parametrize("shape", list(MLA_SHAPES.values()),
                         ids=list(MLA_SHAPES))
@pytest.mark.parametrize("q_dtype,kv_dtype", MLA_TYPES)
def test_mla_kernel_matches_plain(cuda, shape, q_dtype, kv_dtype):
    """fp32 output, accumulated in fp32 by both in different orders, the
    kernel's products on bf16 hi + lo halves: atol 1e-4. The all-trash row
    is exact zeros."""
    *shape, max_pos = shape
    args = _mla_case(cuda, *shape, q_dtype, kv_dtype, max_pos=max_pos)
    scale = 1.0 / math.sqrt(128 + shape[3])
    n = pa.paged_flash_decode_mla.launches
    out = pa.paged_flash_decode_mla(*args, scale=scale)
    ref = pa.paged_flash_decode_mla_plain(*args, scale=scale)
    torch.cuda.synchronize()
    assert pa.paged_flash_decode_mla.launches == n + 1
    assert out.dtype == torch.float32 and out.shape == ref.shape
    torch.testing.assert_close(out, ref, atol=1e-4, rtol=0)
    assert out[-1].abs().max() == 0


@pytest.mark.parametrize("shape", ["full-width", "long-cache", "h24",
                                   "odd-widths"])
@pytest.mark.parametrize("q_dtype,kv_dtype", [MLA_TYPES[0], MLA_TYPES[2]])
def test_mla_kernel_two_calls_bit_equal(cuda, shape, q_dtype, kv_dtype):
    """The splits' partials are merged in split order, with no atomics:
    two calls on the same inputs give the same bits."""
    *shape, max_pos = MLA_SHAPES[shape]
    args = _mla_case(cuda, *shape, q_dtype, kv_dtype, max_pos=max_pos)
    first = pa.paged_flash_decode_mla(*args, scale=0.07)
    second = pa.paged_flash_decode_mla(*args, scale=0.07)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


def test_mla_kernel_exact_under_active_prefix_slice(cuda):
    """Cutting the page table to the blocks the positions reach leaves the
    MLA kernel's output bit-identical: it never visits the blocks cut
    away."""
    *args, tables, pos = _mla_case(cuda, 8, 128, 512, 64, 16, torch.bfloat16,
                                   torch.bfloat16)
    need = int((pos.max() // 16) + 1)
    wide = torch.cat([tables, torch.zeros_like(tables)], dim=1).contiguous()
    full = pa.paged_flash_decode_mla(*args, wide, pos, scale=0.07)
    cut = pa.paged_flash_decode_mla(*args, wide[:, :need].contiguous(), pos,
                                    scale=0.07)
    torch.cuda.synchronize()
    torch.testing.assert_close(cut, full, atol=0, rtol=0)


@pytest.mark.parametrize("max_pos,width", [(60, 8), (300, 32), (300, 64),
                                           (700, 64), (1500, 256),
                                           (700, 20000)])
def test_mla_kernel_exact_when_the_cut_changes_the_split_count(
        cuda, max_pos, width):
    """Rows of 1 to 24 active splits, in a table cut to the active prefix
    and in one widened to `width` blocks, whose launch has more splits, up
    to the cap of 32 (at max_pos 60 the cut has one split, so its kernel
    writes the output itself, and the wide table's goes through the merge;
    20,000 blocks are 5,000 base spans, which the launch caps at 32): the
    same bits. A row's splits, and the merge's order, follow from the
    row's own position, never from the launch's split count."""
    *args, tables, pos = _mla_case(cuda, 8, 128, 512, 64, 16, torch.bfloat16,
                                   torch.bfloat16, max_pos=max_pos)
    need = int((pos.max() // 16) + 1)
    assert width > need
    wide = torch.zeros((8, width), dtype=torch.int32, device=cuda)
    wide[:, :tables.shape[1]] = tables
    cut = pa.paged_flash_decode_mla(*args, wide[:, :need].contiguous(), pos,
                                    scale=0.07)
    full = pa.paged_flash_decode_mla(*args, wide, pos, scale=0.07)
    torch.cuda.synchronize()
    torch.testing.assert_close(cut, full, atol=0, rtol=0)


@pytest.mark.parametrize("type_a", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("type_b", [torch.bfloat16, torch.float32])
def test_write_pair_matches_two_plain_writes_bit_exact(cuda, type_a, type_b):
    """One `paged_write_token_pair` launch writes DeepSeek-V2's two leaves
    (ckv 512 and kr 64 wide, of their own types) as two plain writes do,
    bit for bit outside the trash block, in place; it counts one launch."""
    _, _, _, tables, pos = _case(cuda, 8, 1, 1, 1, 16, torch.float32,
                                 torch.float32)
    N = int(tables.max()) + 1
    la = torch.randn((N, 16, 512), device=cuda).to(type_a)
    lb = torch.randn((N, 16, 64), device=cuda).to(type_b)
    va = torch.randn((8, 512), device=cuda)
    vb = torch.randn((8, 64), device=cuda).bfloat16()
    ref_a = pa.paged_write_token_plain(la.clone(), tables, pos, va)
    ref_b = pa.paged_write_token_plain(lb.clone(), tables, pos, vb)
    n = pa.paged_write_token.launches
    got_a, got_b = pa.paged_write_token_pair(la, lb, tables, pos, va, vb)
    torch.cuda.synchronize()
    assert got_a is la and got_b is lb
    assert pa.paged_write_token.launches == n + 1
    torch.testing.assert_close(got_a[1:], ref_a[1:], atol=0, rtol=0)
    torch.testing.assert_close(got_b[1:], ref_b[1:], atol=0, rtol=0)


def test_wrappers_raise_instead_of_falling_back(cuda):
    q, kp, vp, tables, pos = _case(cuda, 4, 4, 2, 16, 4, torch.float32,
                                   torch.float32)
    with pytest.raises(ValueError, match="int32"):
        pa.paged_flash_decode_gqa(q, kp, vp, tables.long(), pos)
    with pytest.raises(ValueError, match="fp32 or bf16"):
        pa.paged_flash_decode_gqa(q.half(), kp, vp, tables, pos)
    qa, qr, ckv, kr, w, tables, pos = _mla_case(
        cuda, 4, 4, 32, 16, 4, torch.float32, torch.float32)
    n = pa.paged_flash_decode_mla.launches
    with pytest.raises(ValueError, match="int32"):
        pa.paged_flash_decode_mla(qa, qr, ckv, kr, w, tables.long(), pos,
                                  scale=0.1)
    with pytest.raises(ValueError, match="fp32 or bf16"):
        pa.paged_flash_decode_mla(qa.half(), qr, ckv, kr, w, tables, pos,
                                  scale=0.1)
    with pytest.raises(ValueError, match="differ in type"):
        pa.paged_flash_decode_mla(qa, qr, ckv, kr.bfloat16(), w, tables, pos,
                                  scale=0.1)
    with pytest.raises(ValueError, match="r <= 512"):
        big = torch.zeros((ckv.shape[0], 4, 1024), device=cuda)
        pa.paged_flash_decode_mla(
            torch.zeros((4, 1, 4, 1024), device=cuda), qr, big, kr,
            torch.zeros(1024, device=cuda), tables, pos, scale=0.1)
    assert pa.paged_flash_decode_mla.launches == n
    n = pa.paged_write_token.launches
    with pytest.raises(ValueError, match="int32"):
        pa.paged_write_token_pair(ckv, kr, tables.long(), pos, qa[:, 0, 0],
                                  qr[:, 0, 0])
    with pytest.raises(ValueError, match="fp32 or bf16"):
        pa.paged_write_token_pair(ckv, kr, tables, pos, qa[:, 0, 0].half(),
                                  qr[:, 0, 0])
    with pytest.raises(ValueError, match="distinct"):
        pa.paged_write_token_pair(ckv, ckv, tables, pos, qa[:, 0, 0],
                                  qa[:, 0, 0])
    with pytest.raises(ValueError, match="do not hold"):
        pa.paged_write_token_pair(ckv, kr, tables, pos, qa[:, 0, 0],
                                  qa[:, 0, 0])
    assert pa.paged_write_token.launches == n
    x, table, tgt = _loss_case(cuda, 16, 32, 100)
    n = gk.gatekeeper_loss_tokens.launches
    with pytest.raises(ValueError, match="int32"):
        gk.gatekeeper_loss_tokens(x, table, tgt.long())
    with pytest.raises(ValueError, match="fp32 or bf16"):
        gk.gatekeeper_loss_tokens(x.half(), table, tgt)
    with pytest.raises(ValueError, match="d=30"):
        gk.gatekeeper_loss_tokens(x[:, :30], table[:, :30], tgt)
    with pytest.raises(ValueError, match=r"\[T, d\]"):
        gk.gatekeeper_loss_tokens(x, table[:, :16], tgt)
    assert gk.gatekeeper_loss_tokens.launches == n


def _loss_case(cuda, T, d, V, x_dtype=torch.float32, seed=0, scale=1.0):
    g = torch.Generator(device=cuda).manual_seed(seed)
    x = (torch.randn((T, d), generator=g, device=cuda) * scale).to(x_dtype)
    table = torch.randn((V, d), generator=g, device=cuda) * (2.0 / d ** 0.5)
    tgt = torch.randint(0, V, (T,), generator=g, device=cuda,
                        dtype=torch.int32)
    logits = x.float() @ table.t()
    hit = torch.rand(T, generator=g, device=cuda) < 0.5
    tgt = torch.where(hit, logits.argmax(-1).int(), tgt).contiguous()
    return x, table, tgt


def _top2_gap(x, table):
    top2 = torch.topk(x.float() @ table.t(), 2, dim=-1).values
    return top2[:, 0] - top2[:, 1]


# (T, d, V, x scale): T <= 32 and <= 64 take the mma.sync kernel's 32-
# and 64-token tiles, past 64 the warpgroup kernel's 128-token blocks; d
# 36 and 100 are no multiple of the 32-deep ring stage; V no multiple of
# the 128-column tile
LOSS_SHAPES = {
    "tiny": (37, 32, 300, 1.0),
    "ragged": (200, 64, 1000, 1.0),
    "vocab-tail": (512, 256, 9000, 1.0),
    "vlm-rows": (24, 768, 5000, 1.0),
    "whisper-rows": (128, 768, 51865, 1.0),
    "token-blocks": (700, 128, 3000, 1.0),
    "d36": (60, 36, 1100, 1.0),
    "d36-blocks": (300, 36, 1100, 1.0),
    "d100-narrow": (9, 100, 777, 1.0),
    "peaked": (256, 768, 4000, 8.0),
    "rwkv6-3b-train": (2048, 2560, 65536, 1.0),   # Stage-2 shapes of the
    "zamba2-train": (2048, 2048, 32000, 1.0),     # recurrent trainers
}


@pytest.mark.parametrize("T,d,V,scale", list(LOSS_SHAPES.values()),
                         ids=list(LOSS_SHAPES))
@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16])
def test_gatekeeper_kernel_matches_plain(cuda, T, d, V, scale, x_dtype):
    """ce, kl, entropy and lse to atol 1e-4 (fp32 logits as split-TF32
    products, summed in other orders); `correct` equal on every row whose
    top-2 gap exceeds 1e-4. T and V are no multiples of the tiles."""
    x, table, tgt = _loss_case(cuda, T, d, V, x_dtype, scale=scale)
    n = gk.gatekeeper_loss_tokens.launches
    got = gk.gatekeeper_loss_tokens(x, table, tgt, return_lse=True)
    want = gk.gatekeeper_loss_tokens_plain(x, table, tgt, return_lse=True)
    torch.cuda.synchronize()
    assert gk.gatekeeper_loss_tokens.launches == n + 1
    for i in (0, 1, 3, 4):
        torch.testing.assert_close(got[i], want[i], atol=1e-4, rtol=0)
    clear = _top2_gap(x, table) > 1e-4
    assert torch.equal(got[2][clear], want[2][clear])
    assert 0 < float(want[2].mean()) < 1


@pytest.mark.parametrize("shape", ["vlm-rows", "whisper-rows",
                                   "token-blocks", "d36"])
@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16])
def test_gatekeeper_kernel_two_calls_bit_equal(cuda, shape, x_dtype):
    """No atomics and fixed merge orders: the same inputs give the same
    bits, at each token tile."""
    T, d, V, scale = LOSS_SHAPES[shape]
    x, table, tgt = _loss_case(cuda, T, d, V, x_dtype, scale=scale, seed=1)
    a = gk.gatekeeper_loss_tokens(x, table, tgt, return_lse=True)
    b = gk.gatekeeper_loss_tokens(x, table, tgt, return_lse=True)
    torch.cuda.synchronize()
    for u, v in zip(a, b):
        assert torch.equal(u, v)


@pytest.mark.parametrize("shape", ["vlm-rows", "whisper-rows",
                                   "token-blocks", "peaked"])
def test_gatekeeper_bf16_x_two_products_equal_three(cuda, shape):
    """A bf16 x is exact in TF32, so its two products (no x lo) give the
    bits of the three-product sum the kernel takes for the same x widened
    to fp32."""
    T, d, V, scale = LOSS_SHAPES[shape]
    x, table, tgt = _loss_case(cuda, T, d, V, torch.bfloat16, scale=scale)
    a = gk.gatekeeper_loss_tokens(x, table, tgt, return_lse=True)
    b = gk.gatekeeper_loss_tokens(x.float(), table, tgt, return_lse=True)
    torch.cuda.synchronize()
    for u, v in zip(a, b):
        assert torch.equal(u, v)


@pytest.mark.parametrize("T", [24, 100, 300])
@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16])
def test_gatekeeper_exact_ties_resolve_to_the_lowest_index(cuda, T, x_dtype):
    """Table rows duplicated within an n8 tile, across warps, tiles and
    vocabulary splits: every row's maximum is an exact tie among them, and
    the argmax is the lowest index, as in JAX."""
    V, d = 20000, 64
    x, table, _ = _loss_case(cuda, T, d, V, x_dtype)
    dups = [3, 5, 70, 300, 9001, V - 2]
    table[dups] = table[3].clone()
    x = (table[3] * 10.0).expand(T, d).to(x_dtype).contiguous()
    tgt = torch.tensor([dups[i % len(dups)] for i in range(T)],
                       dtype=torch.int32, device=cuda)
    got = gk.gatekeeper_loss_tokens(x, table, tgt)
    torch.cuda.synchronize()
    assert torch.equal(got[2], (tgt == 3).float())
    assert torch.equal(got[0], got[0][:1].expand(T))   # the same target logit


def test_stage2_loss_launches_once_on_the_weighted_rows(cuda, monkeypatch):
    """`launch.steps.fused_gatekeeper_loss` under the VLM's patch mask
    hands the kernel only the rows of non-zero weight (one launch); loss,
    aux and gradients within 1e-4 of the chunked plain loss, dx exactly 0
    on the masked rows. No valid row: loss 0, zero gradients, no launch."""
    from repro_torch.core.gatekeeper import GatekeeperConfig
    from repro_torch.launch import steps
    B, P, S, d, V = 4, 60, 63, 128, 5000
    x, table, tgt = _loss_case(cuda, B * S, d, V, torch.bfloat16, seed=2)
    mask = torch.ones((B, S), device=cuda)
    mask[:, :P] = 0.0
    seen = []
    inner = gk.gatekeeper_loss_tokens

    def recording(xx, *args, **kw):
        seen.append(xx.shape[0])
        return inner(xx, *args, **kw)
    monkeypatch.setattr(gk, "gatekeeper_loss_tokens", recording)
    recording.launches = 0      # the wrapper counts on the name it is bound to
    gkc = GatekeeperConfig(alpha=0.3)
    out = {}
    for name, fn in (("fused", steps.fused_gatekeeper_loss),
                     ("chunked", steps.chunked_gatekeeper_loss)):
        xk = x.view(B, S, d).clone().requires_grad_(True)
        tk = table.clone().requires_grad_(True)
        loss, aux = fn(xk, tk, tgt.view(B, S), gkc, mask)
        loss.backward()
        out[name] = (loss.detach(), aux, xk.grad.float(), tk.grad)
    torch.cuda.synchronize()
    assert seen == [B * (S - P)]
    (lf, af, gxf, gtf), (lc, ac, gxc, gtc) = out["fused"], out["chunked"]
    assert abs(float(lf) - float(lc)) <= 1e-4
    for k in ac:
        assert abs(float(af[k]) - float(ac[k])) <= 1e-4, k
    assert float(gxf[:, :P].abs().max()) == 0.0
    for a, b in ((gxf, gxc), (gtf, gtc)):
        torch.testing.assert_close(a, b, atol=1e-4 * float(b.abs().max()),
                                   rtol=2e-2)
    xk = x.view(B, S, d).clone().requires_grad_(True)
    tk = table.clone().requires_grad_(True)
    loss, _ = steps.fused_gatekeeper_loss(xk, tk, tgt.view(B, S), gkc,
                                          torch.zeros_like(mask))
    loss.backward()
    assert float(loss.detach()) == 0.0 and seen == [B * (S - P)]
    assert not bool(xk.grad.any()) and not bool(tk.grad.any())


@pytest.mark.parametrize("masked", [False, True], ids=["all-valid", "valid"])
def test_gatekeeper_fused_gradients_match_plain_autograd(cuda, masked):
    """dx (in x's bf16) and dtable of `gatekeeper_loss_fused` (kernel
    forward, chunked backward, which launches nothing) against autograd
    through the plain version: atol 1e-4 relative to the largest entry."""
    x, table, tgt = _loss_case(cuda, 300, 128, 5000, torch.bfloat16)
    valid = ((torch.arange(300, device=cuda) % 4) != 0).float() if masked \
        else None
    xk, tk = x.clone().requires_grad_(True), table.clone().requires_grad_(True)
    n = gk.gatekeeper_loss_tokens.launches
    loss_k, aux = ops.gatekeeper_loss_fused(xk, tk, tgt, valid, alpha=0.3)
    loss_k.backward()
    torch.cuda.synchronize()
    assert gk.gatekeeper_loss_tokens.launches == n + 1
    xp, tp = x.clone().requires_grad_(True), table.clone().requires_grad_(True)
    ce, kl, corr, _ = gk.gatekeeper_loss_tokens_plain(xp, tp, tgt)
    v = torch.ones_like(ce) if valid is None else valid
    corr = corr.detach()
    denom = v.sum().clamp(min=1)
    loss_p = (0.3 * (ce * corr * v).sum()
              + 0.7 * (kl * (1 - corr) * v).sum()) / denom
    loss_p.backward()
    assert abs(float(loss_k) - float(loss_p)) <= 1e-4
    assert xk.grad.dtype == torch.bfloat16
    for a, b in ((xk.grad.float(), xp.grad.float()), (tk.grad, tp.grad)):
        torch.testing.assert_close(a, b, atol=1e-4 * float(b.abs().max()),
                                   rtol=2e-2)


@pytest.mark.parametrize("P,T,d,V", [(576, 3, 256, 32064), (20, 7, 64, 999)],
                         ids=["phi-3-vision-rows", "small"])
def test_gatekeeper_fused_with_invalid_leading_positions(cuda, P, T, d, V):
    """The VLM's Stage-2 loss: 4 rows of P patch positions (out of the
    loss) then T text positions. Loss and aux of `gatekeeper_loss_fused`
    within 1e-4 of the plain version's masked reduction; dx (bf16,
    exactly zero on the patch rows) and dtable against autograd through
    the plain version, atol 1e-4 of the largest entry plus rtol 2e-2."""
    rows = 4
    x, table, tgt = _loss_case(cuda, rows * (P + T), d, V, torch.bfloat16,
                               seed=P)
    valid = torch.ones(rows, P + T, device=cuda)
    valid[:, :P] = 0.0
    valid = valid.reshape(-1)
    xk, tk = x.clone().requires_grad_(True), table.clone().requires_grad_(True)
    n = gk.gatekeeper_loss_tokens.launches
    loss_k, aux = ops.gatekeeper_loss_fused(xk, tk, tgt, valid, alpha=0.3)
    loss_k.backward()
    torch.cuda.synchronize()
    assert gk.gatekeeper_loss_tokens.launches == n + 1
    xp, tp = x.clone().requires_grad_(True), table.clone().requires_grad_(True)
    ce, kl, corr, _ = gk.gatekeeper_loss_tokens_plain(xp, tp, tgt)
    corr = corr.detach()
    denom = valid.sum()
    l_corr = (ce * corr * valid).sum() / denom
    l_incorr = (kl * (1 - corr) * valid).sum() / denom
    loss_p = 0.3 * l_corr + 0.7 * l_incorr
    loss_p.backward()
    for got, want in ((loss_k, loss_p), (aux["l_corr"], l_corr),
                      (aux["l_incorr"], l_incorr)):
        assert abs(float(got.detach()) - float(want.detach())) <= 1e-4
    assert float(xk.grad.float()[:P].abs().max()) == 0.0
    for a, b in ((xk.grad.float(), xp.grad.float()), (tk.grad, tp.grad)):
        torch.testing.assert_close(a, b, atol=1e-4 * float(b.abs().max()),
                                   rtol=2e-2)


@pytest.mark.parametrize("arch", ["internlm2-1.8b", "deepseek-v2-236b",
                                  "qwen1.5-4b", "qwen1.5-32b", "llama3-405b",
                                  "kimi-k2-1t-a32b"])
def test_engine_kernel_path_matches_plain_path(cuda, arch):
    from repro_torch.launch import serve
    from repro_torch.data.synthetic import make_ragged_lm_stream
    from repro_torch.serving import (CascadeSpec, ContinuousCascadeEngine,
                                     EngineConfig, PagedConfig, make_requests)
    small, large = serve.build_ladder(arch, 0, 2, device=cuda)
    prompts = make_ragged_lm_stream(3, 6, 4, 20, small.cfg.vocab_size)
    runs = {}
    for kernel in (True, False):
        eng = ContinuousCascadeEngine(
            CascadeSpec.two_tier(small, large, tau=-1e9),
            EngineConfig(n_slots=3, early_exit=False, backend="paged",
                         paged=PagedConfig(block_size=4, prefill_chunk=4,
                                           paged_kernel=kernel)))
        runs[kernel] = eng.run(make_requests(prompts, 5), 5)
    np.testing.assert_array_equal(runs[True].tokens, runs[False].tokens)
    assert runs[True].stats["paged_kernel"]


# ---------------------------------------------------------------------------
# deferral_entropy and flash_attention
# ---------------------------------------------------------------------------

def _signal_logits(cuda, T, V, dtype, seed=0):
    """Normal logits of std 3 with an all-equal row, a top tie at two far
    columns and a top tie at neighbouring columns."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    x = torch.randn((T, V), generator=g, device=cuda) * 3
    x[0] = 0.25
    x[1, 5] = x[1, V - 3] = x[1].max() + 1
    x[2, V // 2] = x[2, V // 2 + 1] = x[2].max() + 1
    return x.to(dtype)


@pytest.mark.parametrize("T,V", [(3, 50), (8, 1003), (8, 92544), (8, 102400),
                                 (300, 4096), (2048, 92544), (8, 32000),
                                 (8, 51865), (8, 32064), (8, 151936),
                                 (8, 152064), (8, 128256), (8, 163840)],
                         ids=["tiny", "vocab-tail", "internlm2", "deepseek",
                              "ragged", "evaluation", "zamba2", "whisper",
                              "phi-3-vision", "qwen1.5-4b", "qwen1.5-32b",
                              "llama3-405b", "kimi-k2"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_deferral_kernel_matches_plain(cuda, T, V, dtype):
    """neg_entropy and max_prob to atol 1e-4 (fp32 sums in other orders);
    argmax equal on every row, the ties to the lowest index."""
    x = _signal_logits(cuda, T, V, dtype)
    n = de.deferral_entropy.launches
    got = de.deferral_entropy(x)
    want = de.deferral_entropy_plain(x)
    torch.cuda.synchronize()
    assert de.deferral_entropy.launches == n + 1
    for a, b in zip(got[:2], want[:2]):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=0)
    assert torch.equal(got[2], want[2])
    assert got[2][:3].tolist() == [0, 5, V // 2]


@pytest.mark.parametrize("T,V", [(1000, 8), (3000, 4), (3000, 8),
                                 (3000, 10)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_deferral_kernel_at_classifier_shapes(cuda, T, V, dtype):
    """The classifier cascade's logits: thousands of rows of 4-10 classes,
    one CTA a row; V = 10 rows are not 16-byte aligned and take the scalar
    loads. Ties at columns 1 and V - 1 and at V // 3 and V // 3 + 1 go to
    the lower index; max_prob to 1e-4, argmax exact, two calls bit-equal."""
    g = torch.Generator(device=cuda).manual_seed(T + V)
    x = torch.randn((T, V), generator=g, device=cuda) * 3
    x[0] = 0.25
    x[1, 1] = x[1, V - 1] = x[1].max() + 1
    x[2, V // 3] = x[2, V // 3 + 1] = x[2].max() + 1
    x = x.to(dtype)
    assert de.vocab_split(T, V, 132)[1] == 1
    n = de.deferral_entropy.launches
    got = de.deferral_entropy(x)
    again = de.deferral_entropy(x)
    want = de.deferral_entropy_plain(x)
    torch.cuda.synchronize()
    assert de.deferral_entropy.launches == n + 2
    for a, b in zip(got[:2], want[:2]):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=0)
    assert torch.equal(got[2], want[2])
    assert got[2][:3].tolist() == [0, 1, V // 3]
    assert all(torch.equal(a, b) for a, b in zip(got, again))


def test_deferral_kernel_back_to_back_and_bit_equal(cuda):
    """Calls at changing T and V, fp32 and bf16, enqueued back to back with
    no synchronise between them: each row's last CTA leaves its ticket
    counter at zero for the next call on the stream, so every result
    matches the plain version (one split a row included: 2048 rows, and
    a vocabulary under one span) and repeats bit for bit."""
    shapes = [(8, 92544), (1, 65536), (3, 102400), (8, 92544), (1, 50),
              (2048, 4096), (5, 1003), (1, 65536)]
    xs = [_signal_logits(cuda, T, V, dt, seed=i) if T > 2 else
          (torch.randn((T, V), device=cuda) * 3).to(dt)
          for i, ((T, V), dt) in enumerate(zip(
              shapes, [torch.float32, torch.bfloat16] * 4))]
    n = de.deferral_entropy.launches
    first = [de.deferral_entropy(x) for x in xs]
    second = [de.deferral_entropy(x) for x in xs]
    torch.cuda.synchronize()
    assert de.deferral_entropy.launches == n + 2 * len(xs)
    for x, a, b in zip(xs, first, second):
        want = de.deferral_entropy_plain(x)
        for got, ref in zip(a[:2], want[:2]):
            torch.testing.assert_close(got, ref, atol=1e-4, rtol=0)
        assert torch.equal(a[2], want[2])
        assert all(torch.equal(p, r) for p, r in zip(a, b))
    assert de.vocab_split(2048, 4096, 132)[1] == 1
    assert de.vocab_split(1, 50, 132)[1] == 1


def test_deferral_wrapper_raises_on_refused_launch(cuda, monkeypatch):
    x = _signal_logits(cuda, 4, 64, torch.float32)
    n = de.deferral_entropy.launches
    with pytest.raises(ValueError, match="fp32 or bf16"):
        de.deferral_entropy(x.half())
    with pytest.raises(ValueError, match=r"\[T, V\]"):
        de.deferral_entropy(x[None])
    monkeypatch.setattr(de, "vocab_split", lambda T, V, n_sms: (8, 70000))
    with pytest.raises(RuntimeError, match="launch failed"):
        de.deferral_entropy(x)
    assert de.deferral_entropy.launches == n


@pytest.mark.parametrize("B,T,S,H,KV,hd,off,win", [
    (2, 13, 13, 4, 2, 16, 0, 0),
    (1, 70, 90, 4, 4, 32, 20, 0),
    (2, 65, 200, 8, 2, 64, 128, 0),
    (8, 128, 288, 16, 8, 128, 0, 0),
    (8, 128, 288, 16, 8, 128, 48, 0),
    (8, 128, 288, 16, 8, 128, 128, 0),
    (2, 100, 100, 4, 2, 128, 0, 24),
    (2, 70, 90, 4, 2, 96, 20, 0),
    (2, 65, 200, 8, 2, 112, 128, 0),
    (1, 70, 90, 4, 4, 256, 0, 0),
    (1, 33, 40, 2, 1, 50, 0, 0),
    (8, 128, 288, 32, 32, 64, 128, 288),
    (8, 128, 288, 20, 20, 128, 0, 0),
    (8, 128, 288, 20, 20, 128, 128, 0),
], ids=["tiny", "offset", "tail-offset", "full-0", "full-48", "full-128",
        "window", "hd96", "hd112", "hd256", "hd50", "zamba2-shared",
        "qwen1.5-4b-0", "qwen1.5-4b-128"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_matches_plain(cuda, B, T, S, H, KV, hd, off, win,
                                    dtype):
    """atol 1e-4 in fp32 (fp32 online softmax against a one-shot softmax);
    bf16 outputs also rtol 2^-7 (both sides round nearly equal fp32 values
    to bf16, at most one bf16 step apart)."""
    g = torch.Generator(device=cuda).manual_seed(B * T + off)
    q = torch.randn((B, T, H, hd), generator=g, device=cuda).to(dtype)
    k = torch.randn((B, S, KV, hd), generator=g, device=cuda).to(dtype)
    v = torch.randn((B, S, KV, hd), generator=g, device=cuda).to(dtype)
    n = fa.flash_attention.launches
    out = fa.flash_attention(q, k, v, causal=True, window=win, q_offset=off)
    ref = fa.flash_attention_plain(q, k, v, causal=True, window=win,
                                   q_offset=off)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == n + 1 and out.dtype == dtype
    rtol = 0 if dtype == torch.float32 else 2 ** -7
    torch.testing.assert_close(out.float(), ref.float(), atol=1e-4,
                               rtol=rtol)


def _flash_inputs(cuda, B, T, S, H, KV, hd, dtype, q_scale=1.0, seed=0):
    g = torch.Generator(device=cuda).manual_seed(seed)
    q = torch.randn((B, T, H, hd), generator=g, device=cuda) * q_scale
    k = torch.randn((B, S, KV, hd), generator=g, device=cuda)
    v = torch.randn((B, S, KV, hd), generator=g, device=cuda)
    return q.to(dtype), k.to(dtype), v.to(dtype)


@pytest.mark.parametrize("B,T,S,H,KV,hd,off,q_scale,dtype,causal", [
    (8, 128, 288, 16, 8, 128, 128, 8.0, torch.bfloat16, True),
    (8, 128, 288, 16, 8, 128, 128, 0.0, torch.bfloat16, True),
    (2, 77, 131, 4, 2, 128, 54, 1.0, torch.bfloat16, True),
    (2, 77, 131, 4, 2, 128, 54, 1.0, torch.float32, True),
    (2, 128, 288, 128, 8, 128, 48, 1.0, torch.bfloat16, True),
    (2, 128, 288, 128, 8, 128, 48, 1.0, torch.float32, True),
    (8, 128, 288, 16, 8, 128, 128, 8.0, torch.float32, True),
    (8, 128, 288, 16, 8, 128, 128, 0.0, torch.float32, True),
    (8, 1500, 1500, 12, 12, 64, 0, 8.0, torch.float32, False),
    (8, 1500, 1500, 12, 12, 64, 0, 0.0, torch.float32, False),
], ids=["peaked-bf16", "flat-bf16", "tile-edges-bf16", "tile-edges-fp32",
        "llama3-405b-group16-bf16", "llama3-405b-group16-fp32",
        "peaked-fp32", "flat-fp32", "whisper-encoder-peaked-fp32",
        "whisper-encoder-flat-fp32"])
def test_flash_kernel_matches_plain_on_hard_inputs(cuda, B, T, S, H, KV, hd,
                                                   off, q_scale, dtype,
                                                   causal):
    """The tolerance of test_flash_kernel_matches_plain on inputs that
    stress either kernel: a peaked softmax (q scaled by 8, P near
    one-hot, so P's low half, bf16 or TF32, carries the difference from
    1, and the scores' TF32 low halves matter most) and a flat one (q =
    0), T and S that no 16- or 64-wide tile divides, llama3-405b's group
    16, and in fp32 internlm2's chunk and whisper-small's encoder (8 x
    1500 over 1500, non-causal)."""
    q, k, v = _flash_inputs(cuda, B, T, S, H, KV, hd, dtype, q_scale)
    n = fa.flash_attention.launches
    out = fa.flash_attention(q, k, v, causal=causal, q_offset=off)
    ref = fa.flash_attention_plain(q, k, v, causal=causal, q_offset=off)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == n + 1 and out.dtype == dtype
    rtol = 0 if dtype == torch.float32 else 2 ** -7
    torch.testing.assert_close(out.float(), ref.float(), atol=1e-4,
                               rtol=rtol)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_kernel_two_calls_bit_equal(cuda, dtype):
    """No atomics and fixed sum orders: the main chunk twice, same bits."""
    q, k, v = _flash_inputs(cuda, 8, 128, 288, 16, 8, 128, dtype, seed=5)
    first = fa.flash_attention(q, k, v, causal=True, q_offset=128)
    second = fa.flash_attention(q, k, v, causal=True, q_offset=128)
    assert torch.equal(first, second)


def test_flash_kernel_non_causal_and_blind_rows(cuda):
    """Bidirectional attention, and queries past the keys under a window:
    rows that see no key are exact zeros."""
    g = torch.Generator(device=cuda).manual_seed(3)
    q, k, v = (torch.randn(s, generator=g, device=cuda) for s in
               ((1, 40, 2, 32), (1, 30, 1, 32), (1, 30, 1, 32)))
    for kw in (dict(causal=False), dict(causal=True, window=4, q_offset=28)):
        out = fa.flash_attention(q, k, v, **kw)
        ref = fa.flash_attention_plain(q, k, v, **kw)
        torch.cuda.synchronize()
        torch.testing.assert_close(out, ref, atol=1e-4, rtol=0)
    assert out[0, 5:].abs().max() == 0 and out[0, :5].abs().max() > 0


def test_flash_bf16_kernel_non_causal_and_blind_rows(cuda):
    """The same two masks through the bf16 tensor-core kernel, to the bf16
    tolerance: a row that sees nothing adds exactly 0 (its p is zeroed
    though exp(s - m) = 1 while m = -1e30)."""
    q, k, v = _flash_inputs(cuda, 1, 40, 30, 2, 1, 32, torch.bfloat16,
                            seed=3)
    for kw in (dict(causal=False), dict(causal=True, window=4, q_offset=28)):
        out = fa.flash_attention(q, k, v, **kw)
        ref = fa.flash_attention_plain(q, k, v, **kw)
        torch.cuda.synchronize()
        torch.testing.assert_close(out.float(), ref.float(), atol=1e-4,
                                   rtol=2 ** -7)
    assert out[0, 5:].abs().max() == 0 and out[0, :5].abs().max() > 0


@pytest.mark.parametrize("B,T,S,H,KV,hd", [
    (2, 130, 1500, 4, 4, 64),
    (8, 1500, 1500, 12, 12, 64),
    (8, 16, 1500, 12, 12, 64),
    (8, 1, 1500, 12, 12, 64),
    (3, 1, 4097, 4, 2, 128),
    (2, 70, 200, 8, 8, 96),
], ids=["S-1500", "whisper-encoder", "whisper-cross-prefill",
        "whisper-cross-decode", "T1-long", "hd96"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_non_causal_matches_plain(cuda, B, T, S, H, KV, hd,
                                               dtype):
    """Bidirectional attention (an encoder's, and cross-attention over its
    states) at key counts no 64-key tile divides, one query over many
    keys (the cross-attention of a decode step: a 64-query tile holding
    one query), and head_dim 96: the tolerance of
    test_flash_kernel_matches_plain, two calls bit-equal."""
    q, k, v = _flash_inputs(cuda, B, T, S, H, KV, hd, dtype, seed=T + S)
    n = fa.flash_attention.launches
    out = fa.flash_attention(q, k, v, causal=False)
    again = fa.flash_attention(q, k, v, causal=False)
    ref = fa.flash_attention_plain(q, k, v, causal=False)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == n + 2 and out.dtype == dtype
    rtol = 0 if dtype == torch.float32 else 2 ** -7
    torch.testing.assert_close(out.float(), ref.float(), atol=1e-4,
                               rtol=rtol)
    assert torch.equal(out, again)


def _n_sms():
    return torch.cuda.get_device_properties(0).multi_processor_count


def _force_split(monkeypatch, n):
    """Make the wrapper cut all S keys, from key 0, into about n splits."""
    monkeypatch.setattr(fa, "kv_split",
                        lambda B, T, S, H, hd, n_sms, **_: (
                            0, *fa.split_span(S, n)))


@pytest.mark.parametrize("B,T,S,H,KV,hd", [
    (8, 1, 1500, 12, 12, 64),
    (8, 16, 1500, 12, 12, 64),
    (8, 1, 1499, 12, 12, 64),
    (8, 16, 1499, 12, 12, 64),
    (2, 1, 4097, 4, 2, 128),
    (2, 16, 4097, 4, 2, 128),
], ids=["T1-S1500", "T16-S1500", "T1-S1499", "T16-S1499", "T1-S4097",
        "T16-S4097"])
def test_flash_fp32_split_kv_matches_plain(cuda, monkeypatch, B, T, S, H,
                                           KV, hd):
    """Grids under one wave split the keys (`kv_split` says so here): the
    fp32 kernel's split and merge launches against the plain version at
    1e-4, one launch counted per call, two calls bit-equal, and a
    one-split call of the same inputs within the same 1e-4."""
    assert fa.kv_split(B, T, S, H, hd, _n_sms(), causal=False, window=0,
                       q_offset=0)[2] > 1
    q, k, v = _flash_inputs(cuda, B, T, S, H, KV, hd, torch.float32,
                            seed=T + S)
    n = fa.flash_attention.launches
    out = fa.flash_attention(q, k, v, causal=False)
    again = fa.flash_attention(q, k, v, causal=False)
    _force_split(monkeypatch, 1)
    one = fa.flash_attention(q, k, v, causal=False)
    ref = fa.flash_attention_plain(q, k, v, causal=False)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == n + 3
    torch.testing.assert_close(out, ref, atol=1e-4, rtol=0)
    torch.testing.assert_close(one, ref, atol=1e-4, rtol=0)
    torch.testing.assert_close(out, one, atol=1e-4, rtol=0)
    assert torch.equal(out, again)


@pytest.mark.parametrize("T,S,off,win,n_split", [
    (20, 300, 200, 90, 4),
    (70, 300, 200, 90, 4),
    (12, 300, 298, 3, 4),
    (12, 200, 210, 5, 3),
], ids=["window-starts-in-a-split", "chunk-ends-in-a-split", "blind-rows",
        "all-blind"])
def test_flash_fp32_forced_split_under_a_window(cuda, monkeypatch, T, S, off,
                                                win, n_split):
    """Causal q_offset chunks with a window, the keys split by force: a
    split boundary inside the window, a split no query sees (the first
    case's keys past the chunk), rows that see no key (exact zeros) and a
    call where no row sees any; each within 1e-4 of the plain version and
    of a one-split call, two calls bit-equal."""
    q, k, v = _flash_inputs(cuda, 2, T, S, 4, 2, 64, torch.float32,
                            seed=off + T)
    kw = dict(causal=True, window=win, q_offset=off)
    assert fa.split_span(S, n_split)[1] > 1
    _force_split(monkeypatch, n_split)
    out = fa.flash_attention(q, k, v, **kw)
    again = fa.flash_attention(q, k, v, **kw)
    _force_split(monkeypatch, 1)
    one = fa.flash_attention(q, k, v, **kw)
    ref = fa.flash_attention_plain(q, k, v, **kw)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, ref, atol=1e-4, rtol=0)
    torch.testing.assert_close(out, one, atol=1e-4, rtol=0)
    assert torch.equal(out, again)
    blind = ~fa.visible_mask(T, S, **kw).any(dim=-1)
    assert torch.all(out[:, blind] == 0) and torch.all(one[:, blind] == 0)
    assert blind.all() or out[:, ~blind].abs().max() > 0


@pytest.mark.parametrize("B,H,KV,hd,off", [
    (1, 16, 8, 128, 0),
    (1, 16, 8, 128, 128),
    (2, 16, 8, 128, 0),
    (2, 16, 8, 128, 128),
    (4, 16, 8, 128, 0),
    (4, 16, 8, 128, 128),
], ids=["B1-off0", "B1-off128", "B2-off0", "B2-off128", "B4-off0",
        "B4-off128"])
def test_flash_fp32_causal_split_at_the_engine_shapes(cuda, monkeypatch, B,
                                                      H, KV, hd, off):
    """internlm2-1.8b's paged prefill dispatches of 1, 2 and 4 rows (128
    queries at q_offset 0 or 128 over the 288-position cache view, 16/8
    heads of 128): under one wave, so `kv_split` splits the keys the
    chunk's queries see, and no further; 4-warp CTAs of 64 queries, causal,
    against the plain version and a one-split call at 1e-4, two calls
    bit-equal, one launch counted a call."""
    T, S = 128, 288
    kw = dict(causal=True, window=0, q_offset=off)
    begin, span, n_split = fa.kv_split(B, T, S, H, hd, _n_sms(), **kw)
    assert n_split > 1 and begin + n_split * span == off + T
    q, k, v = _flash_inputs(cuda, B, T, S, H, KV, hd, torch.float32,
                            seed=B + off)
    n = fa.flash_attention.launches
    out = fa.flash_attention(q, k, v, **kw)
    again = fa.flash_attention(q, k, v, **kw)
    _force_split(monkeypatch, 1)
    one = fa.flash_attention(q, k, v, **kw)
    ref = fa.flash_attention_plain(q, k, v, **kw)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == n + 3
    torch.testing.assert_close(out, ref, atol=1e-4, rtol=0)
    torch.testing.assert_close(out, one, atol=1e-4, rtol=0)
    assert torch.equal(out, again)


def test_flash_wrapper_raises_instead_of_falling_back(cuda):
    q = torch.zeros((1, 4, 2, 320), device=cuda)
    n = fa.flash_attention.launches
    with pytest.raises(ValueError, match="hd=320"):
        fa.flash_attention(q, q, q)
    q = torch.zeros((1, 4, 2, 32), device=cuda)
    with pytest.raises(ValueError, match="one type"):
        fa.flash_attention(q, q.bfloat16(), q.bfloat16())
    with pytest.raises(ValueError, match="fp32 or bf16"):
        fa.flash_attention(q.half(), q.half(), q.half())
    big = torch.zeros((1, 1, 65536, 16), device=cuda)
    kv = torch.zeros((1, 2, 1, 16), device=cuda)
    with pytest.raises(RuntimeError, match="launch failed"):
        fa.flash_attention(big, kv, kv)
    assert fa.flash_attention.launches == n


def test_engine_switch_covers_signal_and_prefill_kernels(cuda, monkeypatch):
    """On the slot backend the engine's switch alone picks the deferral and
    flash kernels, calibration included, over a REPRO_PAGED_KERNEL that
    says the opposite: on, both launch (one signal per decode step); off,
    neither; greedy tokens equal."""
    from repro_torch.launch import serve
    from repro_torch.data.synthetic import make_lm_stream
    from repro_torch.serving import (CascadeSpec, ContinuousCascadeEngine,
                                     EngineConfig, PagedConfig, make_requests)
    small, large = serve.build_ladder("internlm2-1.8b", 0, 2, device=cuda)
    prompts = make_lm_stream(3, 6, 8, small.cfg.vocab_size)
    runs, counts = {}, {}
    for kernel in (True, False):
        monkeypatch.setenv("REPRO_PAGED_KERNEL", "0" if kernel else "1")
        de.deferral_entropy.launches = fa.flash_attention.launches = 0
        eng = ContinuousCascadeEngine(
            CascadeSpec.two_tier(small, large),
            EngineConfig(n_slots=3, early_exit=False,
                         paged=PagedConfig(paged_kernel=kernel)))
        eng.calibrate(prompts, prompts.shape[1], 5, deferral_ratio=0.5)
        eng.tau = -1e9
        runs[kernel] = eng.run(make_requests(prompts, 5), 5)
        torch.cuda.synchronize()
        counts[kernel] = (de.deferral_entropy.launches,
                          fa.flash_attention.launches)
    np.testing.assert_array_equal(runs[True].tokens, runs[False].tokens)
    assert counts[False] == (0, 0)
    assert counts[True][0] >= runs[True].steps > 0 and counts[True][1] > 0


# ---------------------------------------------------------------------------
# wkv_scan (the RWKV6 / Mamba2 recurrence)
# ---------------------------------------------------------------------------

def _wkv_case(cuda, B, T, H, K, V, scalar, seed=0, strong=False):
    """logw in [-1, -0.05], or -exp(U(-3, 3)) when `strong` (RWKV6's
    strongly decaying channels, down to -20 a token)."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    q, k = (0.5 * torch.randn((B, T, H, K), generator=g, device=cuda)
            for _ in range(2))
    v = 0.5 * torch.randn((B, T, H, V), generator=g, device=cuda)
    r = torch.rand((B, T, H, 1 if scalar else K), generator=g, device=cuda)
    logw = -torch.exp(6 * r - 3) if strong else -(0.05 + 0.95 * r)
    u = 0.3 * torch.randn((H, K), generator=g, device=cuda)
    s0 = 0.2 * torch.randn((B, H, K, V), generator=g, device=cuda)
    return q, k, v, logw, u, s0


def _wkv_close(y, st, ref_y, ref_s):
    assert torch.isfinite(y).all() and torch.isfinite(st).all()
    torch.testing.assert_close(y, ref_y, atol=5e-4, rtol=5e-4)
    torch.testing.assert_close(st, ref_s, atol=5e-4, rtol=5e-4)


WKV_SHAPES = [
    ("rwkv", 40, 64, 64), ("rwkv", 4, 32, 32), ("rwkv", 3, 128, 96),
    ("mamba", 64, 64, 64), ("mamba", 2, 16, 8), ("rwkv", 2, 256, 256),
    ("mamba", 2, 256, 256), ("rwkv", 1, 200, 300), ("mamba", 1, 512, 40),
    ("mamba", 128, 64, 64)]
WKV_IDS = ["rwkv6-3b", "rwkv-reduced", "rwkv-widest", "zamba2", "mamba-small",
           "rwkv-256", "mamba-256", "rwkv-v-blocks", "mamba-k512",
           "zamba2-large"]


@pytest.mark.parametrize("T", [1, 2, 16, 17, 97, 128, 256])
@pytest.mark.parametrize("mode,H,K,V", WKV_SHAPES, ids=WKV_IDS)
def test_wkv_kernel_matches_plain(cuda, mode, H, K, V, T):
    """y and the final state within atol = rtol = 5e-4 of the plain version
    (as tests/test_kernels.py holds the TPU kernel), the state written in
    place into `out`, which is `state0`; the Mamba2 cases take the scalar
    decay [B,T,H,1]. T below `CHUNKED_MIN_T` (T 1, 2, 16, 17) runs the
    per-token kernel, longer T the chunked one (whose last chunk is
    partial at T 97)."""
    scalar = mode == "mamba"
    q, k, v, logw, u, s0 = _wkv_case(cuda, 2, T, H, K, V, scalar)
    ref_y, ref_s = wk.wkv_scan_plain(q, k, v, logw, u, s0, mode=mode)
    out = s0.clone()
    n, n_chunked = wk.wkv_scan.launches, wk.wkv_scan.launches_chunked
    y, st = wk.wkv_scan(q, k, v, logw, u, out, mode=mode, out=out)
    torch.cuda.synchronize()
    assert wk.wkv_scan.launches == n + 1 and st.data_ptr() == out.data_ptr()
    assert (wk.wkv_scan.launches_chunked - n_chunked
            == int(T >= wk.CHUNKED_MIN_T))
    _wkv_close(y, st, ref_y, ref_s)


@pytest.mark.parametrize("T", [1, 2, 16, 17, 33, 65])
@pytest.mark.parametrize("mode,H,K,V", [
    ("rwkv", 40, 64, 64), ("mamba", 2, 16, 8), ("rwkv", 1, 200, 300)],
    ids=["rwkv6-3b", "mamba-small", "rwkv-v-blocks"])
def test_wkv_both_paths_match_plain_at_any_T(cuda, mode, H, K, V, T):
    """`wkv_scan_path` runs each kernel path at T on either side of the
    threshold, partial chunks included: both within 5e-4 of the plain
    version, and neither counted as a `wkv_scan` launch."""
    scalar = mode == "mamba"
    q, k, v, logw, u, s0 = _wkv_case(cuda, 2, T, H, K, V, scalar, seed=T)
    ref_y, ref_s = wk.wkv_scan_plain(q, k, v, logw, u, s0, mode=mode)
    n = wk.wkv_scan.launches
    for chunked in (False, True):
        y, st = wk.wkv_scan_path(q, k, v, logw, u, s0, chunked=chunked,
                                 mode=mode)
        torch.cuda.synchronize()
        _wkv_close(y, st, ref_y, ref_s)
    assert wk.wkv_scan.launches == n


@pytest.mark.parametrize("case", [
    ("one-row", "rwkv", 1, 256, 40, 64, 64, False, False),
    ("strong-decay", "rwkv", 2, 128, 8, 64, 64, False, True),
    ("strong-decay-prime-T", "rwkv", 2, 97, 8, 64, 64, False, True),
    ("strong-decay-mamba", "mamba", 2, 256, 8, 64, 64, True, True),
    ("mamba-per-channel", "mamba", 2, 130, 4, 48, 20, False, False),
    ("rwkv-scalar-decay", "rwkv", 2, 70, 4, 64, 64, True, False),
    ("odd-widths", "rwkv", 2, 65, 3, 6, 5, False, False)],
    ids=lambda c: c[0])
def test_wkv_chunked_kernel_on_hard_inputs(cuda, case):
    """The chunked path at one row of the longest main-path prompt, under
    RWKV6's strong decays, with the decay form the models do not use in
    each mode, and at widths no 16-byte copy takes (4-byte copies): within
    5e-4 of the plain version, every output finite, two calls bit-equal,
    the state in place; the per-token kernel agrees within the same
    tolerance."""
    _, mode, B, T, H, K, V, scalar, strong = case
    q, k, v, logw, u, s0 = _wkv_case(cuda, B, T, H, K, V, scalar,
                                     strong=strong)
    ref_y, ref_s = wk.wkv_scan_plain(q, k, v, logw, u, s0, mode=mode)
    out = s0.clone()
    n = wk.wkv_scan.launches_chunked
    y, st = wk.wkv_scan(q, k, v, logw, u, out, mode=mode, out=out)
    y2, st2 = wk.wkv_scan(q, k, v, logw, u, s0, mode=mode)
    ys, sts = wk.wkv_scan_path(q, k, v, logw, u, s0, chunked=False,
                               mode=mode)
    torch.cuda.synchronize()
    assert wk.wkv_scan.launches_chunked == n + 2
    assert st.data_ptr() == out.data_ptr()
    _wkv_close(y, st, ref_y, ref_s)
    assert torch.equal(y, y2) and torch.equal(st, st2)
    _wkv_close(ys, sts, ref_y, ref_s)


@pytest.mark.parametrize("mode,H,K,V", WKV_SHAPES, ids=WKV_IDS)
def test_wkv_decode_in_place_and_bit_equal(cuda, mode, H, K, V):
    """T 1 through the per-token kernel with `out` = `state0`, as the
    models' layers call it: within 5e-4 of the plain version, and two
    calls from the same state give the same bits (the reductions over K
    run in a fixed order, without atomics)."""
    scalar = mode == "mamba"
    q, k, v, logw, u, s0 = _wkv_case(cuda, 2, 1, H, K, V, scalar, seed=K + V)
    ref_y, ref_s = wk.wkv_scan_plain(q, k, v, logw, u, s0, mode=mode)
    outs = []
    for _ in range(2):
        state = s0.clone()
        y, st = wk.wkv_scan(q, k, v, logw, u, state, mode=mode, out=state)
        assert st.data_ptr() == state.data_ptr()
        outs.append((y, st))
    torch.cuda.synchronize()
    _wkv_close(*outs[0], ref_y, ref_s)
    assert torch.equal(outs[0][0], outs[1][0])
    assert torch.equal(outs[0][1], outs[1][1])


def test_wkv_zamba2_decode_step(cuda):
    """zamba2's Mamba2 decode step at the main path's 8 rows (64 heads of K
    = V = 64, scalar decay [B,1,H,1], T 1): the per-token kernel in place,
    within 5e-4 of the plain version, through 32 steps from the state it
    leaves."""
    q, k, v, logw, u, s0 = _wkv_case(cuda, 8, 32, 64, 64, 64, True)
    ref_y, ref_s = wk.wkv_scan_plain(q, k, v, logw, u, s0, mode="mamba")
    state, ys = s0.clone(), []
    n, n_chunked = wk.wkv_scan.launches, wk.wkv_scan.launches_chunked
    for t in range(32):
        y, _ = wk.wkv_scan(*(x[:, t:t + 1] for x in (q, k, v, logw)), u,
                           state, mode="mamba", out=state)
        ys.append(y)
    torch.cuda.synchronize()
    assert wk.wkv_scan.launches == n + 32
    assert wk.wkv_scan.launches_chunked == n_chunked
    _wkv_close(torch.cat(ys, dim=1), state, ref_y, ref_s)


def test_wkv_wrapper_raises_instead_of_falling_back(cuda):
    q, k, v, logw, u, s0 = _wkv_case(cuda, 2, 5, 2, 16, 16, False)
    n = wk.wkv_scan.launches
    big = torch.zeros((2, 5, 2, 600), device=cuda)
    with pytest.raises(ValueError, match="K <= 512"):
        wk.wkv_scan(big, big, v, big, torch.zeros((2, 600), device=cuda),
                    torch.zeros((2, 2, 600, 16), device=cuda))
    with pytest.raises(ValueError, match="u"):
        wk.wkv_scan(q, k, v, logw, None, s0, mode="rwkv")
    with pytest.raises(ValueError, match="out"):
        wk.wkv_scan(q, k, v, logw, u, s0, out=s0.double())
    with pytest.raises(ValueError, match="device"):
        wk.wkv_scan(q, k, v, logw, u, s0.cpu())
    assert wk.wkv_scan.launches == n


def test_rwkv_decode_step_kernel_matches_plain(cuda):
    """One reduced fp32 RWKV prefill and decode step, wkv_scan against the
    plain recurrence, from the same prefilled state: logits within 1e-4
    (fp32 recurrences summed in other orders), one launch per layer."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.models import transformer as tfm
    cfg = reduced(get_config("rwkv6-3b"))
    params = tfm.init_params(cfg, 0, cuda)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (3, 37))).to(cuda)
    cache = tfm.init_cache(cfg, 3, 38, device=cuda)
    n = wk.wkv_scan.launches
    logits, cache = tfm.prefill(params, cfg, toks, cache, last_only=True,
                                paged_kernel=True)
    assert wk.wkv_scan.launches == n + cfg.n_layers
    tok = logits[:, -1].argmax(-1)
    out = {}
    for kernel in (True, False):
        c = {kind: {k: t.clone() for k, t in leaves.items()}
             for kind, leaves in cache.items()}
        out[kernel], _ = tfm.decode_step(params, cfg, tok, 37, c,
                                         paged_kernel=kernel)
    torch.cuda.synchronize()
    assert wk.wkv_scan.launches == n + 2 * cfg.n_layers
    torch.testing.assert_close(out[True], out[False], atol=1e-4, rtol=0)


@pytest.mark.parametrize("T", [37, 64])
def test_zamba2_prefill_and_decode_step_kernel_matches_plain(cuda, T):
    """Reduced fp32 zamba2 (4 Mamba2 layers, the shared block after layers
    2 and 4): a prefill of T tokens (T 37: the per-token kernel; 64: the
    chunked one) and one decode step, the kernels against the plain
    recurrence and attention: prefill logits within 1e-3 (the kernels'
    fp32 sums in other orders through four layers, the chunked kernel's
    split tensor-core products among them; chip_smoke.py holds the
    full-width fp32 prefill to the same), the decode step's within 1e-4
    from the same prefilled state; one `wkv_scan` launch per Mamba2 layer
    and one `flash_attention` per shared-block call of the prefill."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.models import transformer as tfm
    cfg = reduced(get_config("zamba2-1.2b"))
    params = tfm.init_params(cfg, 0, cuda)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (3, T))).to(cuda)
    pre, caches = {}, {}
    n, n_chunked = wk.wkv_scan.launches, wk.wkv_scan.launches_chunked
    n_fa = fa.flash_attention.launches
    for kernel in (True, False):
        c = tfm.init_cache(cfg, 3, T + 1, device=cuda)
        pre[kernel], caches[kernel] = tfm.prefill(
            params, cfg, toks, c, last_only=True, paged_kernel=kernel)
    assert wk.wkv_scan.launches == n + cfg.n_layers
    assert (wk.wkv_scan.launches_chunked - n_chunked
            == cfg.n_layers * int(T >= wk.CHUNKED_MIN_T))
    assert fa.flash_attention.launches == n_fa + tfm.shared_attn_calls(cfg)
    torch.testing.assert_close(pre[True], pre[False], atol=1e-3, rtol=0)
    tok = pre[True][:, -1].argmax(-1)
    out = {}
    for kernel in (True, False):
        c = {kind: {k: t.clone() for k, t in leaves.items()}
             for kind, leaves in caches[True].items()}
        out[kernel], _ = tfm.decode_step(params, cfg, tok, T, c,
                                         paged_kernel=kernel)
    torch.cuda.synchronize()
    assert wk.wkv_scan.launches == n + 2 * cfg.n_layers
    assert fa.flash_attention.launches == n_fa + tfm.shared_attn_calls(cfg)
    torch.testing.assert_close(out[True], out[False], atol=1e-4, rtol=0)


# ---------------------------------------------------------------------------
# Training through the recurrence: wkv_scan_fused and remat
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode,H,K,V", [("rwkv", 40, 64, 64),
                                        ("mamba", 64, 64, 64)],
                         ids=["rwkv6-3b", "zamba2"])
def test_wkv_scan_fused_forward_equals_wkv_scan(cuda, mode, H, K, V):
    """`wkv_scan_fused`'s forward is `wkv_scan`'s launch: the same bits,
    counted once, on the chunked path at T 128; no input written."""
    q, k, v, logw, u, s0 = _wkv_case(cuda, 2, 128, H, K, V, mode == "mamba")
    keep = s0.clone()
    n, nc = wk.wkv_scan.launches, wk.wkv_scan.launches_chunked
    y, st = wk.wkv_scan_fused(q, k, v, logw, u, s0, mode=mode, chunk=32)
    torch.cuda.synchronize()
    assert (wk.wkv_scan.launches - n, wk.wkv_scan.launches_chunked - nc) \
        == (1, 1)
    y2, st2 = wk.wkv_scan(q, k, v, logw, u, s0, mode=mode)
    assert torch.equal(y, y2) and torch.equal(st, st2)
    assert torch.equal(s0, keep)


@pytest.mark.parametrize("T", [128, 97])
@pytest.mark.parametrize("mode,H,K,V,chunk", [("rwkv", 40, 64, 64, 32),
                                              ("mamba", 64, 64, 64, 64)],
                         ids=["rwkv6-3b", "zamba2"])
def test_wkv_scan_fused_grads_match_plain_autograd(cuda, mode, H, K, V,
                                                   chunk, T):
    """Gradients of sum(y * gy) + sum(S * gS) in q, k, v, logw, u and
    state0 through `wkv_scan_fused` (the kernel forward, the plain
    recurrence recomputed by the block's chunk rule in the backward)
    against autograd through `wkv_scan_plain` with that chunk: the same
    backward on the same inputs, within 1e-6 of each gradient's largest
    entry (T 128: the chunked recompute; T 97: the per-step scan)."""
    ins = list(_wkv_case(cuda, 2, T, H, K, V, mode == "mamba", seed=T))
    if mode == "mamba":
        ins[4] = None
    g = torch.Generator(device=cuda).manual_seed(1)
    gy = torch.randn((2, T, H, V), generator=g, device=cuda)
    gs = torch.randn((2, H, K, V), generator=g, device=cuda)
    grads = {}
    for fused in (True, False):
        leaves = [None if t is None else t.clone().requires_grad_(True)
                  for t in ins]
        fn = wk.wkv_scan_fused if fused else wk.wkv_scan_plain
        y, st = fn(*leaves, mode=mode, chunk=chunk)
        ((y * gy).sum() + (st * gs).sum()).backward()
        grads[fused] = [None if t is None else t.grad for t in leaves]
    torch.cuda.synchronize()
    for a, b in zip(grads[True], grads[False]):
        if b is None:
            continue
        assert torch.isfinite(a).all()
        torch.testing.assert_close(a, b, rtol=0,
                                   atol=1e-6 * float(b.abs().max()))


@pytest.mark.parametrize("remat", ["full", "dots"])
@pytest.mark.parametrize("arch", ["rwkv6-3b", "zamba2-1.2b"])
def test_remat_with_the_wkv_kernel_matches_none(cuda, arch, remat):
    """A reduced fp32 Stage-2 loss and gradient with the recurrence's
    kernel inside each layer: remat full and dots against none. The
    recompute launches `wkv_scan` again (n_layers launches under none,
    twice that under full and dots: a ctypes launch is invisible to the
    dispatcher, so "dots" must rerun it into a buffer it allocates, never
    reuse a stale one), and every gradient leaf equals none's within 1e-6
    of its largest entry."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.core.gatekeeper import GatekeeperConfig
    from repro_torch.launch import steps
    from repro_torch.models import transformer as tfm
    from repro_torch.training import optim
    cfg = reduced(get_config(arch))
    params = tfm.init_params(cfg, 0, cuda)
    g = torch.Generator(device=cuda).manual_seed(2)
    batch = {k: torch.randint(0, cfg.vocab_size, (4, 128), generator=g,
                              device=cuda) for k in ("tokens", "targets")}
    out, launched = {}, {}
    for mode in ("none", remat):
        fn = steps.make_loss_fn(cfg.replace(remat=mode),
                                GatekeeperConfig(alpha=0.3))
        n = wk.wkv_scan.launches
        out[mode] = optim.value_and_grad(fn, params, batch)
        torch.cuda.synchronize()
        launched[mode] = wk.wkv_scan.launches - n
    assert launched == {"none": cfg.n_layers, remat: 2 * cfg.n_layers}
    (l0, _), g0 = out["none"]
    (l1, _), g1 = out[remat]
    torch.testing.assert_close(l1, l0, rtol=0, atol=1e-6)
    for a, b in zip(optim.tree_leaves(g1), optim.tree_leaves(g0)):
        torch.testing.assert_close(a, b, rtol=0,
                                   atol=1e-6 * float(b.abs().max()) + 1e-12)


# ---------------------------------------------------------------------------
# M_L on a worker thread: its own CUDA stream, counters under concurrency
# ---------------------------------------------------------------------------

def _reduced_pair(cuda):
    from repro_torch.configs import get_config, reduced
    from repro_torch.models import transformer as tfm
    from repro_torch.serving import ModelRunner
    s_cfg = reduced(get_config("internlm2-1.8b"))
    l_cfg = s_cfg.replace(name="large", n_layers=3, d_ff=768)
    return (ModelRunner(s_cfg, tfm.init_params(s_cfg, 0, cuda)),
            ModelRunner(l_cfg, tfm.init_params(l_cfg, 1, cuda)))


def test_threaded_backend_on_its_own_stream_equals_sync(cuda):
    """A ThreadedBackend batch runs on the worker's own (non-default)
    stream, with the kernels on, and returns what SyncLocalBackend
    returns for the same batch, bit for bit; close() joins the worker and
    drains its stream."""
    from repro_torch.serving import (Request, SyncLocalBackend,
                                     ThreadedBackend)
    _, large = _reduced_pair(cuda)
    prompts = np.random.default_rng(3).integers(
        0, large.cfg.vocab_size, size=(6, 12)).astype(np.int32)
    seen = []
    generate = large.generate

    def recording(*args, **kw):
        seen.append(torch.cuda.current_stream(cuda).cuda_stream)
        return generate(*args, **kw)
    large.generate = recording
    outs = {}
    try:
        for cls in (SyncLocalBackend, ThreadedBackend):
            be = cls(large, max_new=6, large_batch=3, paged_kernel=True)
            try:
                be.submit([Request(rid=i, prompt=p, max_new=6)
                           for i, p in enumerate(prompts)])
                outs[cls.name] = {r.rid: r.tokens for r in be.drain()}
            finally:
                be.close()
            if cls is ThreadedBackend:
                assert be.stream is not None
                assert be.stream.cuda_stream != \
                    torch.cuda.default_stream(cuda).cuda_stream
                assert seen[-1] == be.stream.cuda_stream
                assert not be._worker.is_alive()
    finally:
        large.generate = generate
    assert seen[0] == torch.cuda.default_stream(cuda).cuda_stream
    assert sorted(outs["thread"]) == list(range(6))
    for rid, toks in outs["sync"].items():
        np.testing.assert_array_equal(outs["thread"][rid], toks)


def test_deferral_kernel_on_two_threads_two_streams(cuda):
    """Two threads, each on a stream of its own, enqueue deferral_entropy
    calls at changing shapes with no synchronise between: each result
    equals the plain version (each stream keeps its own zeroed ticket
    counters)."""
    import threading
    shapes = [(8, 92544), (3, 65536), (16, 32000), (8, 92544)] * 3
    results = {}

    def work(tid):
        stream = torch.cuda.Stream(cuda)
        g = torch.Generator(device=cuda).manual_seed(tid)
        with torch.cuda.stream(stream):
            outs = []
            for T, V in shapes:
                x = torch.randn((T, V), generator=g, device=cuda) * 4
                outs.append((x, de.deferral_entropy(x)))
            stream.synchronize()
        results[tid] = outs
    threads = [threading.Thread(target=work, args=(t,)) for t in (1, 2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert sorted(results) == [1, 2]
    for outs in results.values():
        for x, (nent, mprob, amax) in outs:
            p_nent, p_mprob, p_amax = de.deferral_entropy_plain(x)
            torch.testing.assert_close(nent, p_nent, atol=1e-4, rtol=0)
            torch.testing.assert_close(mprob, p_mprob, atol=1e-4, rtol=0)
            assert torch.equal(amax, p_amax)


def test_launch_counters_exact_after_concurrent_launches(cuda):
    """Eight threads on eight streams launch deferral_entropy and
    flash_attention at once: both counters end exact."""
    import threading
    n_threads, n_each = 8, 25
    de.deferral_entropy.launches = fa.flash_attention.launches = 0
    start = threading.Barrier(n_threads)
    errors = []

    def work(tid):
        try:
            stream = torch.cuda.Stream(cuda)
            g = torch.Generator(device=cuda).manual_seed(tid)
            with torch.cuda.stream(stream):
                x = torch.randn((4, 4096), generator=g, device=cuda)
                q = torch.randn((1, 16, 4, 64), generator=g, device=cuda)
                start.wait(timeout=60)
                for _ in range(n_each):
                    de.deferral_entropy(x)
                    fa.flash_attention(q, q, q, causal=True)
                stream.synchronize()
        except BaseException as e:              # noqa: BLE001
            errors.append(e)
    threads = [threading.Thread(target=work, args=(t,))
               for t in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not errors, errors
    assert de.deferral_entropy.launches == n_threads * n_each
    assert fa.flash_attention.launches == n_threads * n_each


@pytest.mark.parametrize("shape", [(4, 92544), (3, 97), (2, 3, 511)],
                         ids=str)
@pytest.mark.parametrize("seed", [0, 12345, 2 ** 31, 2 ** 32 - 1])
def test_prng_draw_on_the_card_matches_numpy(cuda, seed, shape):
    """`core.prng`'s draw on CUDA tensors against its numpy version: the
    bits and uniforms exact over several fold_in steps (seeds at and past
    2^31 included), the gumbel noise within the fp32 logs' few ulp, and
    the categorical draw equal on std-3 logits."""
    from repro_torch.core import prng
    key = prng.prng_key(seed)
    logits = (np.random.default_rng(seed % 991).normal(size=shape) * 3
              ).astype(np.float32)
    for step in (0, 1, 31):
        k = prng.fold_in(key, step)
        np.testing.assert_array_equal(
            prng.random_bits(k, shape, cuda).cpu().numpy(),
            prng.random_bits_np(k, shape))
        np.testing.assert_array_equal(prng.uniform(k, shape, cuda).cpu()
                                      .numpy(), prng.uniform_np(k, shape))
        np.testing.assert_allclose(prng.gumbel(k, shape, cuda).cpu().numpy(),
                                   prng.gumbel_np(k, shape), atol=2e-6,
                                   rtol=0)
        got = prng.categorical(k, torch.from_numpy(logits).to(cuda))
        np.testing.assert_array_equal(got.cpu().numpy(),
                                      prng.categorical_np(k, logits))


def test_sample_kernel_path_matches_plain(cuda):
    """`ModelRunner.sample` on the card with the kernels on (flash
    prefill) and off: the same tokens, twice the same, and each wrapper
    launched only on the kernel path."""
    small, _ = _reduced_pair(cuda)
    prompts = np.random.default_rng(5).integers(
        0, small.cfg.vocab_size, size=(4, 12)).astype(np.int32)
    fa.flash_attention.launches = 0
    on = small.sample(prompts, 12, 6, seed=2 ** 31 + 9, temperature=0.8,
                      paged_kernel=True)
    assert fa.flash_attention.launches == small.cfg.n_layers
    again = small.sample(prompts, 12, 6, seed=2 ** 31 + 9, temperature=0.8,
                         paged_kernel=True)
    fa.flash_attention.launches = 0
    off = small.sample(prompts, 12, 6, seed=2 ** 31 + 9, temperature=0.8,
                       paged_kernel=False)
    assert fa.flash_attention.launches == 0
    np.testing.assert_array_equal(on, again)
    np.testing.assert_array_equal(on, off)
    assert on.shape == (4, 6) and on.dtype == np.int32


# ---------------------------------------------------------------------------
# Sharding: a world of one over NCCL, and a threaded world of 8 on the card
# ---------------------------------------------------------------------------

def _free_port():
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_world_of_one_over_nccl_equals_ctx_none(cuda):
    """A (1, 1) DeviceMesh over a one-rank NCCL world: reduced
    internlm2-1.8b's make_serve_step with the context is bit-equal to
    ctx=None on the kernel path, one deferral launch a step."""
    import torch.distributed as dist
    from repro_torch.configs import get_config, reduced
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_context, make_host_mesh
    from repro_torch.models import transformer as tfm
    from repro_torch.sharding import rules_dict
    dist.init_process_group("nccl", rank=0, world_size=1,
                            init_method=f"tcp://localhost:{_free_port()}")
    try:
        ctx = make_context(make_host_mesh(),
                           rules_dict({"unembed_d": ("data",),
                                       "cache_seq": ("data", "model")}))
        cfg = reduced(get_config("internlm2-1.8b"))
        params = tfm.init_params(cfg, 0, cuda)
        tok0 = torch.arange(4, device=cuda) + 3

        def serve(c):
            step = steps.make_serve_step(cfg, ctx=c)
            cache = tfm.init_cache(cfg, 4, 8, device=cuda)
            tok, outs = tok0, []
            for pos in range(3):
                tok, conf, _, cache = step(params, cache, tok, pos)
                outs += [tok, conf]
            return outs + [cache["dense"]["k"]]

        ref = serve(None)
        de.deferral_entropy.launches = 0
        got = serve(ctx)
        assert de.deferral_entropy.launches == 3
        assert all(torch.equal(a, b) for a, b in zip(got, ref))
    finally:
        dist.destroy_process_group()


def _threaded_world(fn, n=8):
    import threading
    import traceback
    import torch.distributed as dist
    from torch.testing._internal.distributed import multi_threaded_pg as mtp
    torch._C._distributed_c10d._set_thread_isolation_mode(True)
    world = mtp._install_threaded_pg()
    if not hasattr(world, "comms"):     # torch 2.11's world lacks it
        world.comms = []
    store, out, errors = dist.HashStore(), [None] * n, []

    def run(r):
        try:
            dist.init_process_group("threaded", rank=r, world_size=n,
                                    store=store)
            try:
                out[r] = fn(r)
            finally:
                dist.destroy_process_group()
        except BaseException as e:
            errors.append(traceback.format_exc())
            mtp.ProcessLocalGroup.exception_handle(e)

    threads = [threading.Thread(target=run, args=(r,), daemon=True)
               for r in range(n)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
    finally:
        mtp._uninstall_threaded_pg()
        torch._C._distributed_c10d._set_thread_isolation_mode(False)
        mtp.ProcessLocalGroup.reset()
    assert not errors, errors[0]
    assert not any(t.is_alive() for t in threads)
    return out


def test_threaded_world_of_8_moe_and_seq_sharded_decode(cuda):
    """8 ranks as threads on the card, a (2, 4) mesh: the MoE scatter and
    decode paths (fp32, capacity factor 8) against the local path, and
    the sequence-sharded GQA decode (batch 1: sequence over data, KV
    heads over model) against the dense decode, cache write included."""
    from repro_torch.models import ffn
    from repro_torch.models.attention import AttnConfig, gqa_decode
    from repro_torch.sharding import ParallelContext, make_mesh
    g = torch.Generator(device=cuda).manual_seed(0)

    def rn(*shape, s=1.0):
        return torch.randn(shape, generator=g, device=cuda) * s

    cfg = ffn.MoEConfig(d_model=64, d_ff=32, n_experts=8, top_k=2,
                        capacity_factor=8.0)
    p = {"router": rn(64, 8, s=.2), "w_gate": rn(8, 64, 32, s=.2),
         "w_up": rn(8, 64, 32, s=.2), "w_down": rn(8, 32, 64, s=.2)}
    x = rn(4, 8, 64)
    acfg = AttnConfig(d_model=64, n_heads=8, n_kv_heads=4, head_dim=16)
    ap = {"wq": rn(64, 8, 16, s=.1), "wk": rn(64, 4, 16, s=.1),
          "wv": rn(64, 4, 16, s=.1), "wo": rn(8, 16, 64, s=.1)}
    cache = {n: rn(1, 256, 4, 16).to(torch.bfloat16) for n in ("k", "v")}
    xa = rn(1, 1, 64)

    def rank(r):
        with torch.inference_mode():
            ctx = ParallelContext(mesh=make_mesh((2, 4), ("data", "model")))
            ys = ffn.moe_forward(p, cfg, x, ctx)[0]
            yd = ffn.moe_forward(p, cfg, x, ctx, decode=True)[0]
            ya = gqa_decode(ap, acfg, xa, 150, cache, ctx=ctx)[0]
            return ys, yd, ya

    res = _threaded_world(rank)
    written = cache["k"][:, 150].clone()
    with torch.inference_mode():
        ref = ffn.moe_forward(p, cfg, x)[0]
        ya = gqa_decode(ap, acfg, xa, 150, cache)[0]
    assert torch.equal(written, cache["k"][:, 150])
    for ys, yd, y in res:
        torch.testing.assert_close(ys, ref, atol=1e-4, rtol=1e-3)
        torch.testing.assert_close(yd, ref, atol=1e-4, rtol=1e-3)
        torch.testing.assert_close(y, ya, atol=1e-5, rtol=1e-4)


@pytest.mark.parametrize("kind", ["prefill", "decode", "train"])
def test_dryrun_meta_count_equals_card_count(cuda, kind):
    """Phase 19b (i) on a 2-layer cut of internlm2-1.8b at its published
    widths in bf16: the dry-run's meta trace counts exactly the FLOPs
    FlopCounterMode counts for the same step on the card, kernels off; the
    traced peak lies within 15% of the card's."""
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.configs import InputShape, get_config
    from repro_torch.launch import dryrun, specs
    from repro_torch.sharding import MeshLayout
    S, B = {"prefill": (512, 2), "decode": (512, 4), "train": (256, 2)}[kind]
    shape = InputShape(kind, S, B, kind)
    cfg = specs.adapt_for_shape(get_config("internlm2-1.8b"), shape).replace(
        n_layers=2)
    step, meta, _ = dryrun.step_and_inputs(
        cfg, shape, MeshLayout((1, 1), ("data", "model")))
    tr = dryrun.trace_step(step, meta)

    def fresh():
        return dryrun.materialize(meta, cuda, torch.Generator(
            device=cuda).manual_seed(0), cfg.vocab_size)
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    args = fresh()
    with FlopCounterMode(display=False) as fc:
        step(*args)
    torch.cuda.synchronize()
    assert int(fc.get_total_flops()) == tr["flops"]
    del args
    args = fresh()
    torch.cuda.reset_peak_memory_stats()
    step(*args)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    assert abs(peak - tr["peak_bytes"]) <= 0.15 * tr["peak_bytes"], (
        peak, tr["peak_bytes"])
