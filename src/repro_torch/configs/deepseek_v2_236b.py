"""DeepSeek-V2 236B — MLA kv_lora=512, 2 shared + 160 routed top-6
[arXiv:2405.04434].

60L d_model=5120 128H d_ff(expert)=1536 vocab=102400. MLA: q_lora=1536,
kv_lora=512, decoupled rope_dim=64, v_head_dim=128. First layer dense FFN
(d_ff = 12288 as in the release).
"""
from repro_torch.configs import MLASpec, ModelConfig, MoESpec

CONFIG = ModelConfig(
    name="deepseek-v2-236b",
    family="moe",
    n_layers=60,
    d_model=5120,
    n_heads=128,
    n_kv_heads=128,          # MLA: per-head KV derived from the latent
    head_dim=128,            # nope dim
    d_ff=12288,              # dense-layer FFN
    vocab_size=102400,
    rope_theta=10000.0,
    moe=MoESpec(n_experts=160, top_k=6, d_ff_expert=1536,
                n_shared_experts=2, shared_d_ff=3072, n_dense_layers=1),
    mla=MLASpec(q_lora=1536, kv_lora=512, rope_dim=64, v_head_dim=128),
    param_dtype="bfloat16",
    source="arXiv:2405.04434",
)
