"""Kimi K2 — trillion-param MoE (paper-table) [arXiv:2501.kimi2].

61L d_model=7168 64H (GQA kv=8) per-expert d_ff=2048 vocab=163840,
MoE 384 experts top-8 (+1 shared expert, DeepSeek-V3-style), first layer
dense. MLA in the real model is approximated here with GQA kv=8 per the
assignment line (which specifies GQA kv=8).
"""
from repro_torch.configs import ModelConfig, MoESpec

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b",
    family="moe",
    n_layers=61,
    d_model=7168,
    n_heads=64,
    n_kv_heads=8,
    head_dim=112,            # 7168 / 64
    d_ff=18432,              # dense-layer FFN (first layer)
    vocab_size=163840,
    rope_theta=50000.0,
    moe=MoESpec(n_experts=384, top_k=8, d_ff_expert=2048,
                n_shared_experts=1, shared_d_ff=2048, n_dense_layers=1),
    param_dtype="bfloat16",
    source="arXiv:2501.kimi2",
)
