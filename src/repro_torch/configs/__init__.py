"""Model configuration for the port: `ModelConfig`, `get_config`, `reduced`.

Own copy of `repro.configs` for the families the port serves; `pdtype()` and
`cdtype()` return torch dtypes. Each architecture lives in its own module
(src/repro_torch/configs/<id>.py) exporting `CONFIG`.
"""
from __future__ import annotations

import dataclasses
import importlib

import torch

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # the port serves "dense" only
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
    sliding_window: int | None = None
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    source: str = ""                 # citation

    def pdtype(self) -> torch.dtype:
        return _DTYPES[self.param_dtype]

    def cdtype(self) -> torch.dtype:
        return _DTYPES[self.compute_dtype]

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


_ALIAS = {"internlm2-1.8b": "internlm2_1_8b"}


def get_config(name: str) -> ModelConfig:
    mod_name = _ALIAS.get(name, name.replace("-", "_").replace(".", "_"))
    try:
        mod = importlib.import_module(f"repro_torch.configs.{mod_name}")
    except ModuleNotFoundError:
        raise NotImplementedError(
            f"config {name!r} is not ported yet (the port serves dense "
            f"GQA decoders; see ROADMAP.md)") from None
    return mod.CONFIG


def reduced(cfg: ModelConfig) -> ModelConfig:
    """CPU-smoke variant of the same family: 2 layers, d_model<=256,
    4 heads of 32, small vocab, fp32 — identical to `repro.configs.reduced`
    for dense configs."""
    return cfg.replace(
        name=cfg.name + "-reduced",
        n_layers=2,
        d_model=min(cfg.d_model, 256),
        n_heads=4, n_kv_heads=2 if cfg.n_kv_heads < cfg.n_heads else 4,
        head_dim=32,
        d_ff=min(cfg.d_ff, 512),
        vocab_size=min(cfg.vocab_size, 512),
        param_dtype="float32", compute_dtype="float32",
    )
