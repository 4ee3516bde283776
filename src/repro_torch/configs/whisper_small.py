"""Whisper-small — enc-dec audio, conv frontend STUBBED [arXiv:2212.04356].

12L encoder + 12L decoder, d_model=768 12H d_ff=3072 vocab=51865. The
mel-spectrogram + conv feature extractor is a stub: callers provide
precomputed frame embeddings [B, 1500, 768]. GELU MLPs, bidirectional
encoder, cross-attention decoder (the JAX package's config).
"""
from repro_torch.configs import EncoderSpec, ModelConfig

CONFIG = ModelConfig(
    name="whisper-small",
    family="encdec",
    n_layers=12,              # decoder layers
    d_model=768,
    n_heads=12,
    n_kv_heads=12,
    head_dim=64,
    d_ff=3072,
    vocab_size=51865,
    encoder=EncoderSpec(n_layers=12, n_frames=1500),
    source="arXiv:2212.04356",
)
