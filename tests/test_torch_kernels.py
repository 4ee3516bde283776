"""Port kernels on the CPU: the plain versions of the paged decode kernels
against the JAX package's (Pallas kernel in interpret mode, and the XLA
`_paged_write` scatter), the wrappers' CPU path, and the paged-kernel
switch's resolution order."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from repro.kernels import ops as jops
from repro.models.attention import _paged_write
from repro_torch.kernels import _build
from repro_torch.kernels import ops as tops
from repro_torch.kernels import paged_attention as tpa

torch.set_num_threads(1)

# disjoint nonzero blocks per row + one all-trash row; ragged positions
# (the JAX package's tests/test_paged_kernel.py fixture)
TABLES = np.asarray([[1, 2, 3, 0],
                     [4, 5, 0, 0],
                     [6, 0, 0, 0],
                     [0, 0, 0, 0]], np.int32)
POS = np.asarray([9, 6, 2, 3], np.int32)
B, H, KV, HD, BS, N = 4, 4, 2, 16, 4, 8


def _decode_inputs(seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, 1, H, HD)).astype(np.float32)
    kp = rng.standard_normal((N, BS, KV, HD)).astype(np.float32)
    vp = rng.standard_normal((N, BS, KV, HD)).astype(np.float32)
    return q, kp, vp


def test_plain_decode_matches_jax_kernel():
    """atol 1e-5: both sides run an fp32 softmax, in different orders."""
    q, kp, vp = _decode_inputs(1)
    ref = np.asarray(jops.paged_flash_decode_gqa(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
        jnp.asarray(TABLES), jnp.asarray(POS)))
    out = tpa.paged_flash_decode_gqa_plain(
        torch.from_numpy(q), torch.from_numpy(kp), torch.from_numpy(vp),
        torch.from_numpy(TABLES), torch.from_numpy(POS)).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-5)
    # the all-trash row: every page skipped -> exact zeros, no NaN
    np.testing.assert_array_equal(out[3], np.zeros_like(out[3]))


def test_plain_decode_skips_unmapped_pages_inside_prefix():
    """A zero table entry below `pos` contributes nothing (the kernel
    skips page 0) — same as the JAX kernel, unlike a plain gather."""
    q, kp, vp = _decode_inputs(2)
    tables = TABLES.copy()
    tables[0, 1] = 0                      # hole in row 0's valid prefix
    ref = np.asarray(jops.paged_flash_decode_gqa(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
        jnp.asarray(tables), jnp.asarray(POS)))
    out = tpa.paged_flash_decode_gqa_plain(
        torch.from_numpy(q), torch.from_numpy(kp), torch.from_numpy(vp),
        torch.from_numpy(tables), torch.from_numpy(POS)).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-5)


@pytest.mark.parametrize("H,KV,hd", [(32, 2, 112), (4, 4, 32), (6, 2, 50)],
                         ids=["group16-hd112", "mha", "group3-hd50"])
def test_plain_decode_matches_jax_kernel_at_any_group_and_hd(H, KV, hd):
    """The shapes the CUDA kernel no longer refuses: llama3-405b's group
    16 at kimi-k2's head_dim 112, group 1 (qwen1.5's MHA) and an odd
    head_dim. atol 1e-5: fp32 softmax on both sides, in different
    orders."""
    rng = np.random.default_rng(H * 1000 + hd)
    q = rng.standard_normal((B, 1, H, hd)).astype(np.float32)
    kp, vp = (rng.standard_normal((N, BS, KV, hd)).astype(np.float32)
              for _ in range(2))
    ref = np.asarray(jops.paged_flash_decode_gqa(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
        jnp.asarray(TABLES), jnp.asarray(POS), interpret=True))
    out = tpa.paged_flash_decode_gqa_plain(
        torch.from_numpy(q), torch.from_numpy(kp), torch.from_numpy(vp),
        torch.from_numpy(TABLES), torch.from_numpy(POS)).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=0)
    np.testing.assert_array_equal(out[3], np.zeros_like(out[3]))


@pytest.mark.parametrize("bs", [1, 4, 5, 16, 48, 128])
def test_decode_split_plan_depends_on_position_and_block_only(bs):
    """The kernel's split s of a row covers tokens [s*span, (s+1)*span)
    below n_tok = min(M*bs, pos+1). For every table at least as wide as
    the row's active prefix, the spans a row uses are the same. The merge
    sums them in an order set by their count alone, so cutting the table
    to the active prefix leaves the output's bits as they were
    (test_torch_cuda.py holds the kernel to that on the card)."""
    def row_splits(pos, M):
        span = tpa.split_span(bs)
        n_tok = min(M * bs, pos + 1)
        return [(s * span, min((s + 1) * span, n_tok))
                for s in range(-(-n_tok // span))]

    span = tpa.split_span(bs)
    assert span % bs == 0 and (span <= tpa.SPLIT_TOKENS or span == bs)
    for pos in (0, bs - 1, 63, 64, 200, 1000, 4095):
        need = pos // bs + 1
        want = row_splits(pos, need)
        assert want[0][0] == 0 and want[-1][1] == pos + 1
        for M in (need + 1, 2 * need, need + 300):
            assert row_splits(pos, M) == want


@pytest.mark.parametrize("rest,leaf_dtype", [
    ((KV, HD), "float32"),
    ((7,), "float32"),                    # MLA-shaped leaf
    ((KV, HD), "bfloat16"),               # fp32 values cast into bf16
])
def test_plain_write_matches_jax_bit_exact(rest, leaf_dtype):
    rng = np.random.default_rng(3)
    leaf = rng.standard_normal((N, BS) + rest).astype(np.float32)
    vals = rng.standard_normal((B,) + rest).astype(np.float32)
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[leaf_dtype]
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[leaf_dtype]
    ref = _paged_write(jnp.asarray(leaf).astype(jdt), jnp.asarray(TABLES),
                       jnp.asarray(POS)[:, None], jnp.asarray(vals)[:, None])
    out = tpa.paged_write_token_plain(
        torch.from_numpy(leaf).to(tdt), torch.from_numpy(TABLES),
        torch.from_numpy(POS), torch.from_numpy(vals))
    # bit parity, including the trash row's write into block 0
    np.testing.assert_array_equal(out.float().numpy(),
                                  np.asarray(ref.astype(jnp.float32)))


def test_wrappers_take_plain_version_on_cpu(monkeypatch):
    """CPU tensors never reach the CUDA path: no build is attempted and
    the launch counters stay put."""
    def no_build(name):
        raise AssertionError(f"tried to build {name} for CPU tensors")
    monkeypatch.setattr(_build, "load", no_build)
    q, kp, vp = (torch.from_numpy(a) for a in _decode_inputs(4))
    tables, pos = torch.from_numpy(TABLES), torch.from_numpy(POS)
    n_dec = tpa.paged_flash_decode_gqa.launches
    n_wr = tpa.paged_write_token.launches
    out = tops.paged_flash_decode_gqa(q, kp, vp, tables, pos)
    torch.testing.assert_close(
        out, tpa.paged_flash_decode_gqa_plain(q, kp, vp, tables, pos),
        rtol=0, atol=0)
    leaf = kp.clone()
    got = tops.paged_write_token(leaf, tables, pos, q[:, 0, :KV])
    assert got is leaf                     # written in place
    assert tpa.paged_flash_decode_gqa.launches == n_dec
    assert tpa.paged_write_token.launches == n_wr


@pytest.mark.parametrize("override", [None, True, False])
@pytest.mark.parametrize("env", [None, "1", "0"])
def test_paged_kernel_switch_resolves_like_jax(monkeypatch, override, env):
    """Explicit argument > REPRO_PAGED_KERNEL > default. The defaults
    agree on CPU (JAX: off on a CPU backend; port: off for CPU
    tensors)."""
    if env is None:
        monkeypatch.delenv("REPRO_PAGED_KERNEL", raising=False)
    else:
        monkeypatch.setenv("REPRO_PAGED_KERNEL", env)
    assert jax.default_backend() == "cpu"
    assert (tops.paged_kernel_enabled(override, torch.device("cpu"))
            == jops.paged_kernel_enabled(override))


def test_paged_kernel_switch_defaults_on_for_cuda_tensors(monkeypatch):
    monkeypatch.delenv("REPRO_PAGED_KERNEL", raising=False)
    assert tops.paged_kernel_enabled(None, torch.device("cuda"))
    assert not tops.paged_kernel_enabled(False, torch.device("cuda"))
    monkeypatch.setenv("REPRO_PAGED_KERNEL", "0")
    assert not tops.paged_kernel_enabled(None, torch.device("cuda"))
