"""Zamba2 1.2B — Mamba2 backbone + shared attention blocks [arXiv:2411.15242].

38 Mamba2 layers, d_model=2048, ssm_state=64; a SHARED-weight attention+MLP
block (32H, d_ff=8192) is invoked every 6 mamba layers (weight re-use is
Zamba2's signature trick; the release interleaves two shared blocks — one
is used here, as in the JAX package's config).
"""
from repro_torch.configs import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b",
    family="hybrid",
    n_layers=38,             # mamba2 layers
    d_model=2048,
    n_heads=32,              # shared attention block heads
    n_kv_heads=32,
    head_dim=64,
    d_ff=8192,               # shared block MLP
    vocab_size=32000,
    ssm_state=64,
    ssm_head_dim=64,
    shared_attn_every=6,
    source="arXiv:2411.15242",
)
