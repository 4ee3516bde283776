"""JAX's default sampling draw without JAX: `jax.random.categorical` under
a threefry2x32 key, as `repro.serving.engine.ModelRunner.sample` draws.

The JAX runner draws step i's tokens with

    jax.random.categorical(fold_in(PRNGKey(seed), i), logits * (1 / T))

for a uint32 `seed`. Under jax 0.9.0's defaults (threefry2x32,
``jax_threefry_partitionable`` on, gumbel mode "low") that is:

  * ``PRNGKey(seed)`` — the key pair ``(seed >> 32, seed & 0xFFFFFFFF)``,
    ``(0, seed)`` for a uint32 seed;
  * ``fold_in(key, d)`` — ``threefry2x32(key, (0, d))``, the hashed pair
    being the new key;
  * the 32 random bits of element n of a row-major shape — the two words
    of ``threefry2x32(key, (n >> 32, n & 0xFFFFFFFF))`` XORed;
  * ``_uniform`` over ``[tiny, 1)`` in fp32 — the bits' top 23 as the
    mantissa of a float in [1, 2), minus 1, times ``1 - tiny`` (1.0 in
    fp32), plus ``tiny``, at least ``tiny``;
  * ``_gumbel`` — ``-log(-log(u))``;
  * ``categorical`` — ``argmax(logits + gumbel)`` over the last axis,
    the first index of a tie.

Keys are pairs of Python ints: they depend on the host's seed and step
only, so the key schedule is host arithmetic. The per-element hash runs
on the logits' device as int64 tensor arithmetic masked to 32 bits
(PyTorch's uint32 lacks shifts on the card), so a draw on the card is
the same function as on the CPU: its bits are exact, and only the fp32
`log` may round differently from XLA's by an ulp. `_np` functions are
the plain numpy version (native uint32 arithmetic), which the tests hold
against both JAX and the tensor version.

JAX draws this noise with XLA, not with a Pallas kernel; there is no
kernel to port here.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

MASK32 = 0xFFFFFFFF
_KS_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_F32_TINY = float(np.finfo(np.float32).tiny)
_F32_ONE_MINUS_TINY = float(np.float32(1.0) - np.float32(_F32_TINY))


def _rotl(x: int, d: int) -> int:
    return ((x << d) | (x >> (32 - d))) & MASK32


def _threefry_int(k1: int, k2: int, x1: int, x2: int) -> Tuple[int, int]:
    """threefry2x32 of one counter pair, on Python ints (the key
    schedule's hashes)."""
    ks = (k1, k2, k1 ^ k2 ^ _KS_PARITY)
    x = [(x1 + ks[0]) & MASK32, (x2 + ks[1]) & MASK32]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x[0] = (x[0] + x[1]) & MASK32
            x[1] = _rotl(x[1], r) ^ x[0]
        x[0] = (x[0] + ks[(i + 1) % 3]) & MASK32
        x[1] = (x[1] + ks[(i + 2) % 3] + i + 1) & MASK32
    return x[0], x[1]


def prng_key(seed: int) -> Tuple[int, int]:
    """`jax.random.PRNGKey(seed)` for a seed in [0, 2^64): the key pair
    (high word, low word)."""
    seed = int(seed)
    if not 0 <= seed < 2 ** 64:
        raise ValueError(f"seed must lie in [0, 2**64), got {seed}")
    return (seed >> 32) & MASK32, seed & MASK32


def fold_in(key: Tuple[int, int], data: int) -> Tuple[int, int]:
    """`jax.random.fold_in(key, data)` for a uint32 `data`."""
    return _threefry_int(key[0], key[1], 0, int(data) & MASK32)


# ---------------------------------------------------------------------------
# The draw on tensors (any device)
# ---------------------------------------------------------------------------

def _rotl_t(x: torch.Tensor, d: int) -> torch.Tensor:
    return ((x << d) & MASK32) | (x >> (32 - d))


def random_bits(key: Tuple[int, int], shape: Sequence[int],
                device=None) -> torch.Tensor:
    """`jax.random.bits(key, shape, uint32)` as int64 values in
    [0, 2^32), on `device`: element n of the row-major shape hashes the
    counter pair (n >> 32, n & 0xFFFFFFFF)."""
    k1, k2 = key
    ks = (k1, k2, k1 ^ k2 ^ _KS_PARITY)
    n = torch.arange(int(np.prod(shape)), dtype=torch.int64, device=device)
    x0 = ((n >> 32) + ks[0]) & MASK32
    x1 = ((n & MASK32) + ks[1]) & MASK32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK32
            x1 = _rotl_t(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK32
        x1 = (x1 + (ks[(i + 2) % 3] + i + 1)) & MASK32
    return (x0 ^ x1).reshape(tuple(shape))


def uniform(key: Tuple[int, int], shape: Sequence[int],
            device=None) -> torch.Tensor:
    """`jax.random.uniform(key, shape, float32, minval=tiny, maxval=1)`,
    `_gumbel`'s uniform draw: fp32 in [tiny, 1)."""
    bits = random_bits(key, shape, device)
    floats = ((bits >> 9) | 0x3F800000).to(torch.int32).view(
        torch.float32) - 1.0
    return torch.clamp_min(floats * _F32_ONE_MINUS_TINY + _F32_TINY,
                           _F32_TINY)


def gumbel(key: Tuple[int, int], shape: Sequence[int],
           device=None) -> torch.Tensor:
    """`jax.random.gumbel(key, shape, float32)` (mode "low"):
    -log(-log(u)) in fp32."""
    return -torch.log(-torch.log(uniform(key, shape, device)))


def categorical(key: Tuple[int, int], logits: torch.Tensor) -> torch.Tensor:
    """`jax.random.categorical(key, logits, axis=-1)` for fp32 logits:
    argmax(logits + gumbel) over the last axis, int32."""
    g = gumbel(key, tuple(logits.shape), logits.device)
    return torch.argmax(logits + g, dim=-1).to(torch.int32)


# ---------------------------------------------------------------------------
# The plain numpy version (native uint32 arithmetic)
# ---------------------------------------------------------------------------

def _rotl_np(x: np.ndarray, d: int) -> np.ndarray:
    return (x << np.uint32(d)) | (x >> np.uint32(32 - d))


def random_bits_np(key: Tuple[int, int], shape: Sequence[int]
                   ) -> np.ndarray:
    """`random_bits` in numpy: uint32 [shape]."""
    k1, k2 = (np.uint32(k) for k in key)
    ks = (k1, k2, k1 ^ k2 ^ np.uint32(_KS_PARITY))
    n = np.arange(int(np.prod(shape)), dtype=np.uint64)
    x = [(n >> np.uint64(32)).astype(np.uint32) + ks[0],
         (n & np.uint64(MASK32)).astype(np.uint32) + ks[1]]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x[0] = x[0] + x[1]
            x[1] = _rotl_np(x[1], r) ^ x[0]
        x[0] = x[0] + ks[(i + 1) % 3]
        x[1] = x[1] + ks[(i + 2) % 3] + np.uint32(i + 1)
    return (x[0] ^ x[1]).reshape(tuple(shape))


def uniform_np(key: Tuple[int, int], shape: Sequence[int]) -> np.ndarray:
    """`uniform` in numpy: fp32 in [tiny, 1)."""
    bits = random_bits_np(key, shape)
    floats = ((bits >> np.uint32(9)) | np.uint32(0x3F800000)).view(
        np.float32) - np.float32(1.0)
    return np.maximum(floats * np.float32(_F32_ONE_MINUS_TINY)
                      + np.float32(_F32_TINY), np.float32(_F32_TINY))


def gumbel_np(key: Tuple[int, int], shape: Sequence[int]) -> np.ndarray:
    """`gumbel` in numpy, fp32."""
    return -np.log(-np.log(uniform_np(key, shape)))


def categorical_np(key: Tuple[int, int], logits: np.ndarray) -> np.ndarray:
    """`categorical` in numpy for fp32 logits, int32."""
    logits = np.asarray(logits, np.float32)
    return np.argmax(logits + gumbel_np(key, logits.shape),
                     axis=-1).astype(np.int32)
