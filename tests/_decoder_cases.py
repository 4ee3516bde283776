"""Shared by the port's tests of the four decoder configs that reached it
last (tests/test_torch_decoders.py, tests/test_torch_decoders_train.py)
and of the ladders (tests/test_torch_ladders.py): the archs, tree helpers,
the field-by-field config comparison and the QKV biases drawn non-zero.
JAX initialises `bq`, `bk` and `bv` to zeros, so a parity test on either
package's init cannot see a missing or misplaced bias add."""
import dataclasses

import numpy as np

import jax
import jax.numpy as jnp

ARCHS = ["qwen1.5-4b", "qwen1.5-32b", "llama3-405b", "kimi-k2-1t-a32b"]
BIASED = {"qwen1.5-4b", "qwen1.5-32b"}
BIAS_STD = 0.5        # the drawn QKV biases: as large as a projection's
                      # output, so a missing add moves the logits by O(1)


def named(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(named(tree[k], f"{prefix}/{k}"))
        return out
    return {prefix: tree}


def shapes(tree):
    return {k: tuple(v.shape) for k, v in named(tree).items()}


def jshapes(jtree):
    return shapes(jax.tree.map(lambda a: a, jtree,
                                is_leaf=lambda a: hasattr(a, "logical_axes")))


def set_biases(jparams, seed):
    """Every `bq`, `bk` and `bv` leaf of a JAX tree replaced by a normal
    draw of std BIAS_STD from a numpy seed (in the leaf's type)."""
    rng = np.random.default_rng(seed)

    def visit(tree):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = visit(v)
            elif k in ("bq", "bk", "bv"):
                out[k] = jnp.asarray(
                    rng.standard_normal(v.shape) * BIAS_STD, v.dtype)
            else:
                out[k] = v
        return out
    return visit(jparams)


def fields_equal(t, j):
    """Every field of the port's dataclass equals JAX's: the model's
    fields and the runtime policy (`remat`, `scan_layers`, `attn_chunk`,
    `microbatches`) alike, MoESpec's `capacity_factor` and
    `router_aux_weight` included."""
    for f in dataclasses.fields(t):
        tv, jv = getattr(t, f.name), getattr(j, f.name)
        if dataclasses.is_dataclass(tv):
            fields_equal(tv, jv)
        else:
            assert tv == jv, (t.name if hasattr(t, "name") else t, f.name)
