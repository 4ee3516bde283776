"""Model configuration for the port: `ModelConfig`, `get_config`, `reduced`.

Own copy of `repro.configs` for all ten of the repo's architectures
(`ARCH_IDS`, in the JAX package's order: dense GQA and MHA decoders,
DeepSeek-style MLA/MoE and GQA/MoE decoders, the attention-free RWKV6,
the Mamba2 hybrid with its shared attention block, the encoder-decoder
whisper and the vision-language decoder with its stub frontend);
`pdtype()` and `cdtype()` return torch dtypes. Each architecture lives in
its own module (src/repro_torch/configs/<id>.py) exporting `CONFIG`.
`InputShape` and `SHAPES` are the assigned input shapes, JAX's field for
field (`decode_32k` sizes the sequence-sharded decode's check on the
card). `MoESpec` carries the GShard capacity factor and the router's
aux-loss weight, which `models.transformer.moe_config` passes on.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Optional, Tuple

import torch

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass(frozen=True)
class MoESpec:
    n_experts: int
    top_k: int
    d_ff_expert: int
    n_shared_experts: int = 0
    shared_d_ff: Optional[int] = None
    n_dense_layers: int = 1          # leading layers with dense FFN
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01


@dataclasses.dataclass(frozen=True)
class MLASpec:
    q_lora: int = 1536
    kv_lora: int = 512
    rope_dim: int = 64
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class EncoderSpec:
    """Encoder stack for enc-dec (audio) models. The modality frontend is a
    stub: callers provide precomputed frame embeddings [B, n_frames, d]."""
    n_layers: int
    n_frames: int = 1500


@dataclasses.dataclass(frozen=True)
class VisionSpec:
    """VLM stub frontend: precomputed patch embeddings [B, n_patches, d]."""
    n_patches: int = 576


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | ssm_rwkv | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 128
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    moe: Optional[MoESpec] = None
    mla: Optional[MLASpec] = None
    ssm_state: int = 64
    ssm_head_dim: int = 64
    shared_attn_every: int = 0       # hybrid: shared attn block period
    encoder: Optional[EncoderSpec] = None
    vision: Optional[VisionSpec] = None
    sliding_window: Optional[int] = None
    # runtime policy
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    remat: str = "none"              # none | full | dots
    scan_layers: bool = True         # accepted: the port loops over layers
    attn_chunk: int = 0              # >0: online-softmax KV-chunked attention
    microbatches: int = 1            # train-step gradient accumulation
    source: str = ""                 # citation

    @property
    def attention_free(self) -> bool:
        return self.family == "ssm_rwkv"

    @property
    def sub_quadratic(self) -> bool:
        return (self.family in ("ssm_rwkv", "hybrid")
                or self.sliding_window is not None)

    @property
    def recurrent(self) -> bool:
        """Keeps a recurrent state (RWKV6, Mamba2), which cannot page."""
        return self.family in ("ssm_rwkv", "hybrid")

    def pdtype(self) -> torch.dtype:
        return _DTYPES[self.param_dtype]

    def cdtype(self) -> torch.dtype:
        return _DTYPES[self.compute_dtype]

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


# ---------------------------------------------------------------------------
# Input shapes (assigned)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str        # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": InputShape("train_4k", 4096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524288, 1, "decode"),
}

ARCH_IDS = (
    "kimi_k2_1t_a32b",
    "deepseek_v2_236b",
    "qwen1_5_32b",
    "llama3_405b",
    "whisper_small",
    "rwkv6_3b",
    "phi_3_vision_4_2b",
    "qwen1_5_4b",
    "internlm2_1_8b",
    "zamba2_1_2b",
)

# public ids (with dashes) -> module names
_ALIAS = {i.replace("_", "-"): i for i in ARCH_IDS}
_ALIAS.update({
    "kimi-k2-1t-a32b": "kimi_k2_1t_a32b",
    "deepseek-v2-236b": "deepseek_v2_236b",
    "qwen1.5-32b": "qwen1_5_32b",
    "llama3-405b": "llama3_405b",
    "whisper-small": "whisper_small",
    "rwkv6-3b": "rwkv6_3b",
    "phi-3-vision-4.2b": "phi_3_vision_4_2b",
    "qwen1.5-4b": "qwen1_5_4b",
    "internlm2-1.8b": "internlm2_1_8b",
    "zamba2-1.2b": "zamba2_1_2b",
})


def get_config(name: str) -> ModelConfig:
    mod_name = _ALIAS.get(name, name.replace("-", "_").replace(".", "_"))
    if mod_name not in ARCH_IDS:
        raise ValueError(
            f"config {name!r} is not one of the repo's architectures "
            f"({', '.join(ARCH_IDS)})")
    return importlib.import_module(f"repro_torch.configs.{mod_name}").CONFIG


def list_configs() -> Tuple[str, ...]:
    return ARCH_IDS


def reduced(cfg: ModelConfig) -> ModelConfig:
    """CPU-smoke variant of the same family: 2 layers, d_model<=256,
    4 heads of 32, small vocab, fp32, <=4 experts — identical to
    `repro.configs.reduced` for the families the port serves."""
    kw = dict(
        name=cfg.name + "-reduced",
        n_layers=2,
        d_model=min(cfg.d_model, 256),
        n_heads=4, n_kv_heads=2 if cfg.n_kv_heads < cfg.n_heads else 4,
        head_dim=32,
        d_ff=min(cfg.d_ff, 512),
        vocab_size=min(cfg.vocab_size, 512),
        param_dtype="float32", compute_dtype="float32",
    )
    if cfg.moe is not None:
        kw["moe"] = dataclasses.replace(
            cfg.moe, n_experts=4, top_k=2, d_ff_expert=64,
            n_shared_experts=min(cfg.moe.n_shared_experts, 1),
            shared_d_ff=64 if cfg.moe.n_shared_experts else None,
            n_dense_layers=1)
    if cfg.mla is not None:
        kw["mla"] = MLASpec(q_lora=64, kv_lora=32, rope_dim=16, v_head_dim=32)
    if cfg.encoder is not None:
        kw["encoder"] = EncoderSpec(n_layers=2, n_frames=16)
    if cfg.vision is not None:
        kw["vision"] = VisionSpec(n_patches=8)
    if cfg.family == "hybrid":
        kw["n_layers"] = 4
        kw["shared_attn_every"] = 2
    if cfg.family == "ssm_rwkv":
        kw["d_model"] = 128   # RWKV derives its heads: 4 of head_dim 32
    return cfg.replace(**kw)
