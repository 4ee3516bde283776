"""Qwen1.5-32B — dense, QKV bias [hf:Qwen/Qwen1.5-0.5B family].

64L d_model=5120 40H (kv=40) d_ff=27392 vocab=152064.
"""
from repro_torch.configs import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-32b",
    family="dense",
    n_layers=64,
    d_model=5120,
    n_heads=40,
    n_kv_heads=40,
    head_dim=128,
    d_ff=27392,
    vocab_size=152064,
    qkv_bias=True,
    rope_theta=1000000.0,
    param_dtype="bfloat16",
    source="hf:Qwen/Qwen1.5-0.5B",
)
