"""Roofline terms of the port's dry-run, on the H100's constants.

Counterpart of `repro.launch.roofline`:

    compute term    = FLOPs(per rank) / PEAK_FLOPS_BF16
    memory term     = bytes(per rank) / HBM_BW
    collective term = sum over collectives of bytes moved / the link's rate

What is counted, and how it differs from JAX's figures:
  * FLOPs are `torch.utils.flop_counter.FlopCounterMode`'s count of the
    step as the port runs it (`launch.dryrun` traces it on "meta"
    tensors). A kernel launched through `ctypes` is invisible to the
    dispatcher, so the dry-run runs every kernel's plain version (the
    kernel switches off) and counts that.
  * Bytes are the input and output bytes of each aten op that is not a
    view (`launch.dryrun`'s traffic mode): eager PyTorch's traffic,
    unfused. XLA's `cost_analysis` counts after fusion, so this figure
    is the larger for the same work.
  * Collective bytes come from `sharding.record_collectives`' events,
    not from HLO text: the port's collectives are only the explicit ones
    of `sharding.py`. The ring factors are JAX's.
  * The link. JAX divides every collective by one ICI rate, since a v5e
    pod's ICI spans all its chips. NVLink spans one node of
    `NVLINK_DOMAIN` (8) H100s; past it the path is InfiniBand. A group
    whose ranks all lie in one block of 8 consecutive ranks is charged
    `NVLINK_BW`, any other `IB_BW` (`launch.mesh`). On the (16, 16) and
    (2, 16, 16) layouts every axis's groups cross nodes.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, Optional, Sequence

from repro_torch.configs import InputShape, ModelConfig
from repro_torch.launch.mesh import (HBM_BW, HBM_BYTES, IB_BW, NVLINK_BW,
                                     NVLINK_DOMAIN, PEAK_FLOPS_BF16)
from repro_torch.sharding import CollectiveEvent

OPS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
       "collective-permute")


def moved_bytes(op: str, size: float, g: int) -> float:
    """Bytes a rank moves for a collective whose result is `size` bytes
    over a group of `g` ranks (ring algorithms, JAX's factors)."""
    if op == "all-reduce":
        return 2.0 * size * (g - 1) / g
    if op == "all-gather":
        return size * (g - 1) / g            # result = gathered
    if op == "reduce-scatter":
        return size * (g - 1)                # result = scattered shard
    if op == "all-to-all":
        return size * (g - 1) / g
    if op == "collective-permute":
        return size
    raise ValueError(f"collective {op!r}: one of {OPS}")


def collective_bytes(events: Iterable[CollectiveEvent]) -> Dict[str, float]:
    """Per-rank bytes moved, by collective type (JAX's keys)."""
    out: Dict[str, float] = {op: 0.0 for op in OPS}
    out["count"] = 0
    for e in events:
        out[e.op] += moved_bytes(e.op, e.nbytes, e.group_size)
        out["count"] += 1
    out["total"] = sum(out[op] for op in OPS)
    return out


def link_of(ranks: Sequence[int]) -> str:
    """"nvlink" when the ranks lie in one node of NVLINK_DOMAIN
    consecutive ranks, else "ib"."""
    return ("nvlink" if len({r // NVLINK_DOMAIN for r in ranks}) <= 1
            else "ib")


def link_bytes(events: Iterable[CollectiveEvent]) -> Dict[str, float]:
    """Per-rank bytes moved over each link: {"nvlink": ..., "ib": ...}."""
    out = {"nvlink": 0.0, "ib": 0.0}
    for e in events:
        out[link_of(e.ranks)] += moved_bytes(e.op, e.nbytes, e.group_size)
    return out


def collective_seconds(links: Dict[str, float]) -> float:
    return links["nvlink"] / NVLINK_BW + links["ib"] / IB_BW


@dataclasses.dataclass
class RooflineReport:
    arch: str
    shape: str
    mesh: str
    flops_per_device: float
    bytes_per_device: float
    collective_bytes_per_device: float
    compute_s: float
    memory_s: float
    collective_s: float
    dominant: str
    model_flops_global: float
    useful_flops_ratio: float        # MODEL_FLOPS / (FLOPs * n_devices)
    peak_memory_bytes: Optional[float] = None
    fits_hbm: Optional[bool] = None
    collectives: Optional[Dict] = None

    def row(self) -> str:
        return (f"{self.arch},{self.shape},{self.mesh},"
                f"{self.compute_s:.6g},{self.memory_s:.6g},"
                f"{self.collective_s:.6g},{self.dominant},"
                f"{self.useful_flops_ratio:.4g}")


def make_report(arch: str, shape: str, mesh_name: str, n_devices: int,
                cost: Dict, events: Sequence[CollectiveEvent],
                model_flops: float,
                peak_bytes: Optional[float] = None) -> RooflineReport:
    """`cost`: {"flops", "bytes accessed"} per rank; `events`: the
    recorder's; `peak_bytes`: the traced peak per rank."""
    flops = float(cost.get("flops", 0.0))
    byts = float(cost.get("bytes accessed", 0.0))
    coll = collective_bytes(events)
    compute_s = flops / PEAK_FLOPS_BF16
    memory_s = byts / HBM_BW
    collective_s = collective_seconds(link_bytes(events))
    dominant = max((("compute", compute_s), ("memory", memory_s),
                    ("collective", collective_s)), key=lambda kv: kv[1])[0]
    ratio = model_flops / max(flops * n_devices, 1.0)
    fits = None if peak_bytes is None else peak_bytes <= HBM_BYTES
    return RooflineReport(arch, shape, mesh_name, flops, byts, coll["total"],
                          compute_s, memory_s, collective_s, dominant,
                          model_flops, ratio,
                          None if peak_bytes is None else float(peak_bytes),
                          fits, coll)


# ---------------------------------------------------------------------------
# Analytic MODEL_FLOPS: 6·N·D (train) / 2·N·D (inference), N = active
# matmul params (MoE counts top-k routed + shared experts; the embedding
# gather table is excluded, the unembed projection included), plus a
# causal attention term. JAX's formulas.
# ---------------------------------------------------------------------------

def active_matmul_params(cfg: ModelConfig) -> float:
    from repro_torch.models import transformer as tfm
    from repro_torch.sharding import param_count
    # the parameters do not depend on a window (which the port's MLA
    # refuses and JAX's ignores)
    params = tfm.init_params(cfg.replace(sliding_window=None), abstract=True)
    total = param_count(params)
    if "unembed" in params:
        total -= cfg.vocab_size * cfg.d_model
    if cfg.moe is not None:
        n_moe = cfg.n_layers - cfg.moe.n_dense_layers
        per_expert = 3 * cfg.d_model * cfg.moe.d_ff_expert
        routed_total = n_moe * cfg.moe.n_experts * per_expert
        routed_active = n_moe * cfg.moe.top_k * per_expert
        total = total - routed_total + routed_active
    return float(total)


def analytic_model_flops(cfg: ModelConfig, shape: InputShape) -> float:
    n = active_matmul_params(cfg)
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode"
                                   else 1)
    mult = 6.0 if shape.kind == "train" else 2.0
    flops = mult * n * tokens
    if cfg.family not in ("ssm_rwkv",):
        S_kv = shape.seq_len
        if cfg.sliding_window:
            S_kv = min(S_kv, cfg.sliding_window)
        hH = cfg.n_heads * cfg.head_dim
        if shape.kind == "decode":
            att = 4.0 * shape.global_batch * S_kv * cfg.n_layers * hH
        else:
            att = 2.0 * shape.global_batch * shape.seq_len * S_kv * \
                cfg.n_layers * hH
        flops += att * (3.0 if shape.kind == "train" else 1.0)
    return flops
