"""Qwen1.5-4B — dense, QKV bias [hf:Qwen/Qwen1.5-0.5B family].

40L d_model=2560 20H (kv=20) d_ff=6912 vocab=151936.
"""
from repro_torch.configs import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-4b",
    family="dense",
    n_layers=40,
    d_model=2560,
    n_heads=20,
    n_kv_heads=20,
    head_dim=128,
    d_ff=6912,
    vocab_size=151936,
    qkv_bias=True,
    rope_theta=5000000.0,
    source="hf:Qwen/Qwen1.5-0.5B",
)
