"""Phi-3-vision 4.2B — phi3-mini decoder + CLIP frontend (STUBBED)
[hf:microsoft/Phi-3-vision-128k-instruct].

32L d_model=3072 32H (kv=32) d_ff=8192 vocab=32064. Vision encoder +
projector stubbed: callers provide patch embeddings [B, 576, 3072],
prepended to the token embeddings (the JAX package's config).
"""
from repro_torch.configs import ModelConfig, VisionSpec

CONFIG = ModelConfig(
    name="phi-3-vision-4.2b",
    family="vlm",
    n_layers=32,
    d_model=3072,
    n_heads=32,
    n_kv_heads=32,
    head_dim=96,
    d_ff=8192,
    vocab_size=32064,
    vision=VisionSpec(n_patches=576),
    source="hf:microsoft/Phi-3-vision-128k-instruct",
)
