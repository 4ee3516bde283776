"""Input stand-ins for every (arch x input-shape) combo: "meta" tensors at
the global shapes with their shardings, nothing allocated.

Counterpart of `repro.launch.specs`. Where JAX returns `ShapeDtypeStruct`s
carrying a `NamedSharding`, each function here returns two trees of one
structure: the "meta" tensors (`sharding.tree_shape_structs`) and the
port's `sharding.NamedSharding`s (`sharding.tree_shardings`). `mesh` is a
`sharding.MeshLayout` (the production layouts of `launch.mesh`) or a
`DeviceMesh`. The dry-run traces the port's steps on these; the trainer
and the server build real tensors of the same shapes.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Tuple

import torch

from repro_torch.configs import InputShape, ModelConfig
from repro_torch.models import encdec as encdec_lib
from repro_torch.models import transformer as tfm
from repro_torch.sharding import (AbstractParam, NamedSharding, Spec,
                                  axes_of, axis_sizes, tree_leaves, tree_map,
                                  tree_shape_structs, tree_shardings)
from repro_torch.training import optim


def abstract_to_sds(tree: Any, mesh, rules=None) -> Tuple[Any, Any]:
    """AbstractParam tree -> (meta tensor tree, NamedSharding tree)."""
    return tree_shape_structs(tree), tree_shardings(tree, mesh, rules)


def adapt_for_shape(cfg: ModelConfig, shape: InputShape) -> ModelConfig:
    """Per-assignment policy, JAX's: long_500k needs sub-quadratic
    attention, so SSM / hybrid archs run natively and full-attention archs
    take the sliding-window variant (window 4096); every arch runs in
    bf16; PREFILL uses the KV-chunked online-softmax attention (chunks of
    1024)."""
    cfg = cfg.replace(param_dtype="bfloat16", compute_dtype="bfloat16")
    if shape.name == "long_500k" and cfg.family not in ("ssm_rwkv", "hybrid"):
        cfg = cfg.replace(sliding_window=4096)
    if shape.kind == "prefill" and cfg.family != "ssm_rwkv":
        cfg = cfg.replace(attn_chunk=1024)
    return cfg


def batch_abstract(cfg: ModelConfig, shape: InputShape) -> Dict:
    """A training / prefill batch's AbstractParams: tokens (after the
    patches of a VLM, beside the frames of an encoder-decoder), and the
    targets of a training batch."""
    B, S = shape.global_batch, shape.seq_len
    batch: Dict[str, Any] = {}
    if cfg.family == "vlm":
        P = cfg.vision.n_patches
        batch["tokens"] = AbstractParam((B, S - P), torch.int32,
                                        ("batch", None))
        batch["patches"] = AbstractParam((B, P, cfg.d_model), torch.bfloat16,
                                         ("batch", None, "act_embed"))
    elif cfg.family == "encdec":
        batch["tokens"] = AbstractParam((B, S), torch.int32, ("batch", None))
        batch["frames"] = AbstractParam(
            (B, cfg.encoder.n_frames, cfg.d_model), torch.bfloat16,
            ("batch", None, "act_embed"))
    else:
        batch["tokens"] = AbstractParam((B, S), torch.int32, ("batch", None))
    if shape.kind == "train":
        batch["targets"] = AbstractParam((B, S), torch.int32, ("batch", None))
    return batch


def batch_specs(cfg: ModelConfig, shape: InputShape, mesh,
                rules=None) -> Tuple[Dict, Dict]:
    """A training / prefill batch: (meta tensors, shardings)."""
    return abstract_to_sds(batch_abstract(cfg, shape), mesh, rules)


def moments_abstract(params_abs: Any) -> Any:
    """AdamW's fp32 moment leaves over an abstract parameter tree (JAX's
    `adamw_init` on AbstractParams)."""
    return tree_map(lambda l: AbstractParam(l.shape, torch.float32,
                                            l.logical_axes), params_abs)


def model_state_specs(cfg: ModelConfig, mesh, with_opt: bool, rules=None,
                      opt_rules=None) -> Tuple[Tuple[Any, Any],
                                               Tuple[Any, Any]]:
    """((params, opt_state), (their shardings)), abstract init, nothing
    allocated; opt_state is None without `with_opt`.

    opt_rules: a separate rule table for AdamW's moments (ZeRO-1: the
    moments sharded over more axes than the parameters)."""
    params_abs = tfm.init_params(cfg, abstract=True)
    params, params_sh = abstract_to_sds(params_abs, mesh, rules)
    if not with_opt:
        return (params, None), (params_sh, None)
    orl = opt_rules if opt_rules is not None else rules
    mu, mu_sh = abstract_to_sds(moments_abstract(params_abs), mesh, orl)
    nu, nu_sh = abstract_to_sds(moments_abstract(params_abs), mesh, orl)
    step = torch.empty((), dtype=torch.int32, device="meta")
    return ((params, optim.AdamWState(step, mu, nu)),
            (params_sh, optim.AdamWState(NamedSharding(mesh, Spec()), mu_sh,
                                         nu_sh)))


def cache_abstract(cfg: ModelConfig, shape: InputShape) -> Any:
    B, S = shape.global_batch, shape.seq_len
    init = (encdec_lib.init_cache if cfg.family == "encdec"
            else tfm.init_cache)
    return init(cfg, B, S, abstract=True)


def cache_specs(cfg: ModelConfig, shape: InputShape, mesh,
                rules=None) -> Tuple[Any, Any]:
    """The serving cache: (meta tensors, shardings)."""
    return abstract_to_sds(cache_abstract(cfg, shape), mesh, rules)


def decode_specs(cfg: ModelConfig, shape: InputShape, mesh, rules=None):
    """((token, position), (their shardings)) for `make_serve_step`.

    JAX's position is an abstract int32 scalar. The port's serve step
    takes a scalar position as a Python int (it indexes the cache on the
    host), so this is the shape's last position, `seq_len - 1`: the
    step attends over every cache slot, as JAX's traced step does."""
    token, token_sh = abstract_to_sds(
        AbstractParam((shape.global_batch,), torch.int32, ("batch",)), mesh,
        rules)
    return (token, shape.seq_len - 1), (token_sh, NamedSharding(mesh, Spec()))


def shard_bytes(tensors: Any, shardings: Any) -> int:
    """Bytes of the rank's blocks of `tensors` under `shardings` (two
    trees of one structure): what a partitioned run would hold."""
    total = 0
    for t, sh in zip(tree_leaves(tensors), tree_leaves(shardings)):
        sizes = axis_sizes(sh.mesh)
        blocks = math.prod(sizes[a] for e in sh.spec for a in axes_of(e))
        total += t.numel() * t.element_size() // blocks
    return total
