"""The port's linear-recurrence core on the CPU against the JAX package:
`kernels.wkv_scan.wkv_scan` (its plain version on CPU tensors) against
JAX's Pallas `wkv_scan` in interpret mode in both modes, as
tests/test_kernels.py holds it (T = 97 and T = 1 added), and the plain
`linear_attention_scan` / `_chunked` / `_step` against JAX's and against
each other, as tests/test_ssm.py holds them. Inputs come from numpy
seeds."""
import numpy as np
import pytest

import jax.numpy as jnp
import torch

from repro.kernels.wkv_scan import wkv_scan as j_wkv_scan
from repro.models import ssm as jssm
from repro_torch.kernels import ops
from repro_torch.kernels import wkv_scan as wk
from repro_torch.models import ssm

torch.set_num_threads(1)
KERNEL_TOL = 5e-4            # atol = rtol, as tests/test_kernels.py
CHUNK_ATOL, CHUNK_RTOL = 2e-4, 1e-3   # chunked against scan, tests/test_ssm.py
STEP_TOL = 1e-4              # step-by-step against the scan
JAX_TOL = 2e-5               # the same algorithm in both frameworks, fp32


def _kernel_inputs(seed, B, T, H, K, scalar=False):
    """tests/test_kernels.py's distributions, drawn with numpy."""
    rng = np.random.default_rng(seed)
    q, k, v = (0.5 * rng.standard_normal((B, T, H, K)) for _ in range(3))
    logw = -rng.uniform(0.05, 1.0, (B, T, H, 1 if scalar else K))
    u = 0.3 * rng.standard_normal((H, K))
    s0 = 0.2 * rng.standard_normal((B, H, K, K))
    return [a.astype(np.float32) for a in (q, k, v, logw, u, s0)]


def _ssm_inputs(seed, B=2, T=64, H=2, K=8, V=8, per_channel=False):
    """tests/test_ssm.py's distributions, drawn with numpy."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, T, H, K))
    k = rng.standard_normal((B, T, H, K))
    v = rng.standard_normal((B, T, H, V))
    logw = -np.exp(rng.standard_normal((B, T, H, K if per_channel else 1)))
    s0 = rng.standard_normal((B, H, K, V))
    return [a.astype(np.float32) for a in (q, k, v, logw, s0)]


def _t(arrays):
    return [torch.from_numpy(a) for a in arrays]


def _j(arrays):
    return [jnp.asarray(a) for a in arrays]


def _close(got, want, atol, rtol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol,
                               rtol=rtol)


@pytest.mark.parametrize("T", [1, 64, 96, 97])
@pytest.mark.parametrize("dim", [16, 32])
def test_wkv_rwkv_matches_jax_kernel(dim, T):
    q, k, v, logw, u, s0 = _kernel_inputs(dim * 1000 + T, 2, T, 2, dim)
    jy, js = j_wkv_scan(*_j((q, k, v, logw, u, s0)), chunk=32,
                        interpret=True)
    ty, ts = wk.wkv_scan(*_t((q, k, v, logw, u, s0)), mode="rwkv")
    assert ty.dtype == ts.dtype == torch.float32
    _close(ty, jy, KERNEL_TOL, KERNEL_TOL)
    _close(ts, js, KERNEL_TOL, KERNEL_TOL)


@pytest.mark.parametrize("T", [1, 64, 97])
@pytest.mark.parametrize("dim", [16, 32])
def test_wkv_mamba_matches_jax_kernel(dim, T):
    """mode="mamba": inclusive read, scalar decay [B,T,H,1] (the JAX test
    hands the kernel the decay broadcast over K; the port takes it as
    given, and u is ignored)."""
    q, k, v, logw, _, s0 = _kernel_inputs(dim * 7 + T, 2, T, 2, dim,
                                          scalar=True)
    jq, jk, jv, jlw, js0 = _j((q, k, v, logw, s0))
    jy, js = j_wkv_scan(jq, jk, jv, jnp.broadcast_to(jlw, jq.shape),
                        jnp.zeros((2, dim)), js0, chunk=32, interpret=True,
                        mode="mamba")
    ty, ts = wk.wkv_scan(*_t((q, k, v, logw)), None, torch.from_numpy(s0),
                         mode="mamba")
    _close(ty, jy, KERNEL_TOL, KERNEL_TOL)
    _close(ts, js, KERNEL_TOL, KERNEL_TOL)


@pytest.mark.parametrize("T", [1, 64])
@pytest.mark.parametrize("mode", ["rwkv", "mamba"])
def test_wkv_matches_jax_kernel_at_k_v_256(mode, T):
    """K = V = 256, past the CUDA kernel's old 128 limit, both modes
    (mamba with the scalar decay broadcast over K for the JAX kernel)."""
    scalar = mode == "mamba"
    q, k, v, logw, u, s0 = _kernel_inputs(256 + T, 1, T, 2, 256,
                                          scalar=scalar)
    jq, jk, jv, jlw, ju, js0 = _j((q, k, v, logw, u, s0))
    jy, js = j_wkv_scan(jq, jk, jv, jnp.broadcast_to(jlw, jq.shape), ju, js0,
                        chunk=32, interpret=True, mode=mode)
    ty, ts = wk.wkv_scan(*_t((q, k, v, logw, u, s0)), mode=mode)
    _close(ty, jy, KERNEL_TOL, KERNEL_TOL)
    _close(ts, js, KERNEL_TOL, KERNEL_TOL)


def test_wkv_takes_bf16_inputs_and_writes_out_in_place():
    q, k, v, logw, u, s0 = _t(_kernel_inputs(5, 2, 33, 3, 16))
    ref_y, ref_s = wk.wkv_scan_plain(q, k, v, logw, u, s0, mode="rwkv")
    out = s0.clone()
    y, s = wk.wkv_scan(q.bfloat16(), k.bfloat16(), v.bfloat16(), logw, u,
                       out, mode="rwkv", out=out)
    assert s.data_ptr() == out.data_ptr() and y.dtype == torch.float32
    # bf16 inputs: each operand rounded once (2^-8 relative)
    torch.testing.assert_close(y, ref_y, atol=0.05, rtol=0.05)
    y2, s2 = ops.wkv(q, k, v, logw, u, s0)
    torch.testing.assert_close(y2, ref_y, atol=0, rtol=0)
    torch.testing.assert_close(s2, ref_s, atol=0, rtol=0)
    with pytest.raises(ValueError, match="mode"):
        wk.wkv_scan(q, k, v, logw, u, s0, mode="gla")


@pytest.mark.parametrize("mode,per_channel", [
    ("mamba", False), ("mamba", True), ("rwkv", True), ("rwkv", False)])
def test_scan_matches_jax(mode, per_channel):
    q, k, v, logw, s0 = _ssm_inputs(11, T=16, per_channel=per_channel)
    u = np.abs(np.random.default_rng(9).standard_normal((2, 8))).astype(
        np.float32) if mode == "rwkv" else None
    jy, js = jssm.linear_attention_scan(
        *_j((q, k, v, logw, s0)), mode=mode,
        u=None if u is None else jnp.asarray(u))
    ty, ts = ssm.linear_attention_scan(
        *_t((q, k, v, logw, s0)), mode=mode,
        u=None if u is None else torch.from_numpy(u))
    _close(ty, jy, JAX_TOL, JAX_TOL)
    _close(ts, js, JAX_TOL, JAX_TOL)


@pytest.mark.parametrize("mode,per_channel,chunk", [
    ("mamba", False, 16), ("mamba", True, 16), ("rwkv", True, 8),
    ("rwkv", False, 32), ("mamba", False, 64)])
def test_chunked_matches_jax_and_scan(mode, per_channel, chunk):
    """As tests/test_ssm.py::test_chunked_matches_scan, plus the JAX
    chunked path on the same inputs."""
    q, k, v, logw, s0 = _ssm_inputs(1, per_channel=per_channel)
    u = np.abs(np.random.default_rng(9).standard_normal((2, 8))).astype(
        np.float32) if mode == "rwkv" else None
    tu = None if u is None else torch.from_numpy(u)
    y1, s1 = ssm.linear_attention_scan(*_t((q, k, v, logw, s0)), mode=mode,
                                       u=tu)
    y2, s2 = ssm.linear_attention_chunked(*_t((q, k, v, logw, s0)),
                                          mode=mode, u=tu, chunk=chunk)
    _close(y2, y1, CHUNK_ATOL, CHUNK_RTOL)
    _close(s2, s1, CHUNK_ATOL, CHUNK_RTOL)
    jy, js = jssm.linear_attention_chunked(
        *_j((q, k, v, logw, s0)), mode=mode,
        u=None if u is None else jnp.asarray(u), chunk=chunk)
    _close(y2, jy, CHUNK_ATOL, CHUNK_RTOL)
    _close(s2, js, CHUNK_ATOL, CHUNK_RTOL)


@pytest.mark.parametrize("mode", ["mamba", "rwkv"])
def test_step_matches_scan_and_jax(mode):
    """Sequential single-step decode reproduces the full scan (as
    tests/test_ssm.py), and each step equals JAX's."""
    q, k, v, logw, s0 = _ssm_inputs(2, T=16, per_channel=(mode == "rwkv"))
    u = (np.full((2, 8), 0.4, np.float32) if mode == "rwkv" else None)
    tu = None if u is None else torch.from_numpy(u)
    tq, tk, tv, tlw, ts0 = _t((q, k, v, logw, s0))
    y_ref, s_ref = ssm.linear_attention_scan(tq, tk, tv, tlw, ts0, mode=mode,
                                             u=tu)
    S, JS = ts0, jnp.asarray(s0)
    ys = []
    for t in range(16):
        y, S = ssm.linear_attention_step(tq[:, t], tk[:, t], tv[:, t],
                                         tlw[:, t], S, mode=mode, u=tu)
        jy, JS = jssm.linear_attention_step(
            jnp.asarray(q[:, t]), jnp.asarray(k[:, t]), jnp.asarray(v[:, t]),
            jnp.asarray(logw[:, t]), JS, mode=mode,
            u=None if u is None else jnp.asarray(u))
        _close(y, jy, JAX_TOL, JAX_TOL)
        ys.append(y)
    _close(torch.stack(ys, 1), y_ref, STEP_TOL, STEP_TOL)
    _close(S, s_ref, STEP_TOL, STEP_TOL)
    _close(S, JS, STEP_TOL, STEP_TOL)


def test_state_carry_composability():
    """chunked(T) == chunked(first half) then chunked(second half) with
    the carried state; the plain wkv_scan splits the same way at a T no
    chunk divides."""
    q, k, v, logw, s0 = _t(_ssm_inputs(3, T=32))
    y_full, s_full = ssm.linear_attention_chunked(q, k, v, logw, s0, chunk=8)
    y1, s1 = ssm.linear_attention_chunked(q[:, :16], k[:, :16], v[:, :16],
                                          logw[:, :16], s0, chunk=8)
    y2, s2 = ssm.linear_attention_chunked(q[:, 16:], k[:, 16:], v[:, 16:],
                                          logw[:, 16:], s1, chunk=8)
    _close(torch.cat([y1, y2], 1), y_full, CHUNK_ATOL, CHUNK_RTOL)
    _close(s2, s_full, CHUNK_ATOL, CHUNK_RTOL)
    y_a, s_a = wk.wkv_scan(q[:, :13], k[:, :13], v[:, :13], logw[:, :13],
                           None, s0, mode="mamba")
    y_b, s_b = wk.wkv_scan(q[:, 13:], k[:, 13:], v[:, 13:], logw[:, 13:],
                           None, s_a, mode="mamba")
    _close(torch.cat([y_a, y_b], 1), y_full, CHUNK_ATOL, CHUNK_RTOL)
    _close(s_b, s_full, CHUNK_ATOL, CHUNK_RTOL)


def test_zero_decay_is_cumulative_sum():
    """With w == 1 (logw = 0) and q = one-hot, outputs are running sums."""
    B, T, H, K, V = 1, 8, 1, 2, 3
    q = torch.tensor([1.0, 0.0]).expand(B, T, H, K)
    v = torch.ones((B, T, H, V))
    logw = torch.zeros((B, T, H, 1))
    y, _ = ssm.linear_attention_chunked(q, q, v, logw,
                                        torch.zeros((B, H, K, V)),
                                        mode="mamba", chunk=4)
    want = torch.arange(1, T + 1, dtype=torch.float32)[None, :, None, None]
    torch.testing.assert_close(y, want.expand(B, T, H, V), atol=1e-5, rtol=0)
