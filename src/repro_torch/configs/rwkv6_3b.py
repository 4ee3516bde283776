"""RWKV6 "Finch" 3B — attention-free, data-dependent decay [arXiv:2404.05892].

32L d_model=2560 d_ff=8960 vocab=65536; head_dim 64 (40 heads).
"""
from repro_torch.configs import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-3b",
    family="ssm_rwkv",
    n_layers=32,
    d_model=2560,
    n_heads=40,              # d_model / 64 (informational; RWKV derives it)
    n_kv_heads=40,
    head_dim=64,
    d_ff=8960,
    vocab_size=65536,
    source="arXiv:2404.05892",
)
