"""Shared model components: seeded initializer, norms, RoPE, embeddings.

Counterpart of `repro.models.common`. Models are plain functions over
nested-dict parameter trees of tensors, laid out exactly as the JAX
package lays them out, so converted JAX weights drop straight in
(`repro_torch.convert`).
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.sharding import AbstractParam


class ParamInit:
    """Seeded parameter initializer on one device.

    One `torch.Generator` draws every parameter in a fixed order, so a
    seed gives the same weights on every run on the same device type. The
    shapes, the normal std 1/sqrt(fan_in) and the zero norms follow the
    JAX `ParamFactory`; the bits do not (its crc32 key folding is not
    reproduced — tests carry JAX weights over through `convert.py`). On
    the "meta" device it draws nothing: the tree's shapes and types
    without its memory, as JAX's abstract init gives them. Every creator
    takes the leaf's logical axes (`axes`, those of JAX's
    `ParamFactory.param`); with `abstract` it returns
    `sharding.AbstractParam(shape, dtype, axes)` and touches no device."""

    def __init__(self, seed: int, dtype: torch.dtype, device,
                 abstract: bool = False):
        self.dtype = dtype
        self.device = device
        self.abstract = abstract
        self.gen = None
        if not abstract and torch.device(device).type != "meta":
            self.gen = torch.Generator(device=device)
            self.gen.manual_seed(int(seed))

    # fp32 draws per step: bounds the init's scratch at 2 GiB. A tensor that
    # fits in one step is drawn in one call, so its bits do not depend on
    # the step (every internlm2-1.8b tensor fits, so its weights are those
    # of a single draw per tensor)
    CHUNK = 1 << 29

    def _leaf(self, shape, axes, dtype=None):
        """An AbstractParam in abstract mode, else None."""
        if len(axes) != len(shape):
            raise ValueError(f"shape {tuple(shape)} vs axes {tuple(axes)}")
        if self.abstract:
            return AbstractParam(tuple(int(s) for s in shape),
                                 dtype or self.dtype, tuple(axes))
        return None

    def normal(self, shape: Sequence[int], fan_in: int, axes: Sequence,
               dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        """std 1/sqrt(fan_in) normal in `dtype` (default: the factory's),
        drawn in fp32 CHUNK elements at a time into the flat output, so a
        bf16 expert stack of tens of GB never exists in fp32 at once."""
        leaf = self._leaf(shape, axes, dtype)
        if leaf is not None:
            return leaf
        out = torch.empty(tuple(shape), dtype=dtype or self.dtype,
                          device=self.device)
        flat = out.view(-1)
        std = 1.0 / math.sqrt(max(fan_in, 1))
        for lo in range(0, flat.numel(), self.CHUNK):
            n = min(self.CHUNK, flat.numel() - lo)
            flat[lo:lo + n] = torch.randn(n, generator=self.gen,
                                          device=self.device,
                                          dtype=torch.float32) * std
        return out

    def zeros(self, shape: Sequence[int], axes: Sequence) -> torch.Tensor:
        leaf = self._leaf(shape, axes)
        if leaf is not None:
            return leaf
        return torch.zeros(tuple(shape), dtype=self.dtype, device=self.device)

    def uniform(self, shape: Sequence[int], scale: float,
                axes: Sequence) -> torch.Tensor:
        """Uniform in [-scale, scale), drawn in fp32 (JAX's "uniform")."""
        leaf = self._leaf(shape, axes)
        if leaf is not None:
            return leaf
        u = torch.rand(tuple(shape), generator=self.gen, device=self.device,
                       dtype=torch.float32)
        return ((2.0 * u - 1.0) * scale).to(self.dtype)

    def full(self, shape: Sequence[int], value: float,
             axes: Sequence) -> torch.Tensor:
        """Every entry `value` (JAX's "constant")."""
        leaf = self._leaf(shape, axes)
        if leaf is not None:
            return leaf
        return torch.full(tuple(shape), value, dtype=self.dtype,
                          device=self.device)


def buffer(shape: Sequence[int], axes: Sequence, abstract: bool = False,
           **kw):
    """A zeroed cache or state leaf of `shape` (`kw`: dtype, device), or
    its `AbstractParam` with the logical `axes`."""
    if abstract:
        return AbstractParam(tuple(int(s) for s in shape), kw["dtype"],
                             tuple(axes))
    return torch.zeros(tuple(shape), **kw)


def lead(L: int) -> tuple:
    """The stacked layer axis of `L` layers; none for L = 0 (JAX's
    ``stacked=0``: the hybrid's shared block)."""
    return (L,) if L else ()


def lead_axes(L: int) -> tuple:
    """`lead(L)`'s logical axis."""
    return ("layers",) if L else ()


def einsum(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """`torch.einsum` with JAX's type promotion: bf16 activations against
    fp32 weights compute in fp32, as `jnp.einsum` does (torch refuses
    mixed operand types)."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return torch.einsum(eq, a.to(dt), b.to(dt))


# ---------------------------------------------------------------------------
# Normalization
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    var = torch.mean(x * x, dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * (1.0 + weight.float())).to(dt)


# ---------------------------------------------------------------------------
# Rotary position embeddings
# ---------------------------------------------------------------------------

def rope_frequencies(head_dim: int, theta: float = 10000.0,
                     device=None) -> torch.Tensor:
    exponents = torch.arange(0, head_dim, 2, dtype=torch.float32,
                             device=device) / head_dim
    return 1.0 / (theta ** exponents)                       # [head_dim/2]


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0) -> torch.Tensor:
    """x: [..., T, H, D]; positions: broadcastable to [..., T]."""
    d = x.shape[-1]
    freqs = rope_frequencies(d, theta, x.device)
    angles = positions[..., None].float() * freqs           # [..., T, D/2]
    cos = torch.cos(angles)[..., None, :]                   # [..., T, 1, D/2]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x[..., : d // 2], x[..., d // 2:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def sinusoidal_positions(n: int, d: int, device=None) -> torch.Tensor:
    """[n, d] fp32 sinusoidal positions, ``[sin | cos]`` halves side by
    side (not interleaved), computed in float64 with numpy and cast once,
    bit-equal to the JAX package's."""
    pos = np.arange(n)[:, None]
    dim = np.arange(d // 2)[None, :]
    angle = pos / np.power(10000.0, 2 * dim / d)
    emb = np.concatenate([np.sin(angle), np.cos(angle)], axis=-1)
    return torch.from_numpy(emb.astype(np.float32)).to(device)


# ---------------------------------------------------------------------------
# Embedding / unembedding
# ---------------------------------------------------------------------------

def embed_tokens(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    return F.embedding(tokens.long(), table)


def unembed(x: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """x [..., d] @ table.T -> fp32 logits [..., V]."""
    return torch.einsum("...d,vd->...v", x.float(), table.float())


# ---------------------------------------------------------------------------
# Misc
# ---------------------------------------------------------------------------

def make_causal_mask(q_len: int, kv_len: int, q_offset,
                     device=None) -> torch.Tensor:
    """[q_len, kv_len] bool; True = attendable. q_offset = absolute position
    of q index 0."""
    q_pos = torch.arange(q_len, device=device)[:, None] + q_offset
    kv_pos = torch.arange(kv_len, device=device)[None, :]
    return kv_pos <= q_pos


def make_sliding_mask(q_len: int, kv_len: int, q_offset, window: int,
                      device=None) -> torch.Tensor:
    """`make_causal_mask` restricted to keys less than `window` positions
    back from their query."""
    q_pos = torch.arange(q_len, device=device)[:, None] + q_offset
    kv_pos = torch.arange(kv_len, device=device)[None, :]
    return (kv_pos <= q_pos) & (kv_pos > q_pos - window)


def swiglu(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    return F.silu(gate) * up
