"""Checkpoints of nested-dict parameter trees, in the JAX package's format.

Counterpart of `repro.training.checkpoint`: a directory holding
``arrays.npz`` (leaves as ``leaf_0``, ``leaf_1``, ... in JAX's flatten
order, which sorts dict keys) and ``meta.json`` (``names`` in JAX's
`keystr` form such as ``['blocks']['dense']['attn']['wq']``, ``step``,
``dtypes``). A checkpoint written by `repro.launch.train --ckpt` restores
here and one written here restores in JAX. bfloat16 leaves are stored as
the JAX package's numpy writes them (2-byte void records) and restored by
the ``dtypes`` entry.
"""
from __future__ import annotations

import json
import os
from typing import Any, List, Optional, Tuple

import numpy as np
import torch


def _flatten_with_paths(tree: Any, prefix: str = ""
                        ) -> List[Tuple[str, torch.Tensor]]:
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += _flatten_with_paths(tree[k], f"{prefix}[{k!r}]")
        return out
    return [(prefix, tree)]


def _to_numpy(t: torch.Tensor) -> Tuple[np.ndarray, str]:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view("V2"), "bfloat16"
    a = t.numpy()
    return a, str(a.dtype)


def save_checkpoint(path: str, tree: Any, step: Optional[int] = None) -> None:
    os.makedirs(path, exist_ok=True)
    flat = _flatten_with_paths(tree)
    arrays, dtypes = {}, []
    for i, (_, leaf) in enumerate(flat):
        arrays[f"leaf_{i}"], dt = _to_numpy(leaf)
        dtypes.append(dt)
    np.savez(os.path.join(path, "arrays.npz"), **arrays)
    meta = {"names": [n for n, _ in flat], "step": step, "dtypes": dtypes}
    with open(os.path.join(path, "meta.json"), "w") as f:
        json.dump(meta, f)


def restore_checkpoint(path: str, like: Any) -> Any:
    """Restore into the structure of `like` (a nested dict of tensors);
    each leaf lands on its `like` leaf's device, in the stored type."""
    flat = _flatten_with_paths(like)
    names = [n for n, _ in flat]
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    if meta["names"] != names:
        raise ValueError("checkpoint/model structure mismatch")
    data = np.load(os.path.join(path, "arrays.npz"))
    by_name = {}
    for i, (name, leaf) in enumerate(flat):
        a = data[f"leaf_{i}"]
        if meta.get("dtypes", [None] * len(names))[i] == "bfloat16":
            t = torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
        else:
            t = torch.from_numpy(np.array(a, copy=True))
        by_name[name] = t.to(leaf.device)

    def build(tree, prefix=""):
        if isinstance(tree, dict):
            return {k: build(v, f"{prefix}[{k!r}]") for k, v in tree.items()}
        return by_name[prefix]
    return build(like)


def checkpoint_step(path: str) -> Optional[int]:
    try:
        with open(os.path.join(path, "meta.json")) as f:
            return json.load(f).get("step")
    except FileNotFoundError:
        return None
