"""Logical-axis sharding for parameters, activations and caches, the
parallel context, and the collectives of the explicit expert- and
sequence-parallel paths, on `torch.distributed`.

Counterpart of `repro.sharding`. Every parameter, activation and cache
leaf carries a tuple of *logical* axis names (`AbstractParam`); a rule
table (`DEFAULT_RULES`, overridable per context) maps each logical name to
mesh axes in priority order. `logical_to_spec` keeps JAX's two rules: a
mesh axis that does not divide the dim's remaining size is skipped (the
dim stays replicated over it), and a mesh axis is used at most once per
spec, the first logical axis that can take it winning (batch 1 frees
`data` for the KV cache's sequence dim). It resolves on a `MeshLayout`
(axis names and sizes, no process group), so the production layouts of
`launch.mesh` resolve without 256 ranks, or on a `DeviceMesh`.

What runs split across ranks. The port does not reproduce GSPMD's
automatic partitioning of the dense layers: under a `ParallelContext`
every rank holds the global value of every parameter, activation and
cache and computes the dense layers whole. Only the explicit-collective
paths are split, as in the JAX package's `shard_map` bodies: the MoE
scatter and decode paths (`models.ffn`), the sequence-sharded decode
(`models.attention`) and the d-sharded confidence (`launch.steps`).
`shard_map` hands the body the rank's block of each global input (a
view), the body runs collectives over the process groups of the mesh
axes, and the global outputs are rebuilt on every rank.

Gradients. Outside a body every rank computes the same global loss, so a
global tensor's gradient is the same on every rank. Inside a body a
tensor's gradient is the rank's share: the derivative of the one global
loss by that rank's copy. The transposes follow:
  * taking a block of a global tensor (`take_block`): the shares of all
    ranks, each scattered to its block, summed over the world;
  * rebuilding a global tensor from blocks (`assemble`): a slice of the
    global gradient, divided by the number of ranks that hold the same
    block (a replicated output's replicas share its gradient), not a sum
    (`torch.distributed.nn.functional.all_gather` sums, which is right
    inside a body and world-size times too large here);
  * `all_gather` inside a body: a reduce-scatter (sum, then the block);
  * `all_reduce` sum: a sum of the shares; mean: their mean;
  * `all_to_all`: itself.
So a weight's gradient through `take_block` is all-reduced at the size
of the whole global weight, not of the rank's block: the cost of every
rank holding the global values.
`all_reduce` max returns a value with no gradient: the flash decode uses
it only as the stabilising row max, which its result does not depend on.

Recording. Inside `record_collectives()` every collective this module
runs in that thread appends one `CollectiveEvent` (the op it runs, the
result's bytes on the rank, the group's size, mesh axes and global
ranks), the `assemble` rebuilds included; the backward's too where
autograd runs it in the calling thread, as it does for CPU and meta
tensors (a CUDA backward runs in a thread of its own, which the recorder
does not see). These explicit collectives
are all the port runs across ranks, so the events are what the dry-run
counts in place of the collectives XLA writes into its HLO. The
transpose of `all_gather` runs as an all-reduce of the whole gradient
and keeps the rank's block (a reduce-scatter's result at an
all-reduce's traffic), and is recorded as the all-reduce it is. With no
recorder active nothing is recorded and nothing is read from the device.

The process group is the caller's: this module picks no backend and
initialises nothing; `make_mesh` refuses a world that does not match the
mesh, and `ParallelContext` a `DeviceMesh` that does not cover the world
(the transposes above sum and count replicas over the whole world). A collective over an axis of size 1 is the identity.
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import math
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

# ---------------------------------------------------------------------------
# Rule table: logical axis -> preferred mesh axes, in priority order.
# "pod" is a pure data-parallel axis; it only ever shards `batch`.
# ---------------------------------------------------------------------------
DEFAULT_RULES: Tuple[Tuple[str, Tuple[str, ...]], ...] = (
    ("batch", ("pod", "data")),
    ("embed", ("data",)),          # FSDP/ZeRO-3 dim of weight matrices
    ("vocab", ("model",)),
    ("heads", ("model",)),
    ("kv_heads", ("model",)),
    ("ffn", ("model",)),
    ("experts", ("model",)),
    ("expert_embed", ("data",)),   # FSDP dim of expert matrices (gathered
                                   # per layer at use: ZeRO-3)
    ("expert_ffn", ()),            # alt TP dim of expert matrices; routes
                                   # the decode path to "gather tokens"
    ("d_inner", ("model",)),       # SSM channel dim
    ("cache_seq", ("data",)),      # KV-cache seq; only wins when batch can't
    ("seq_mp", ("model",)),        # sequence-parallel regions (MoE dispatch)
    ("classes", ()),
    ("unembed_d", ()),             # d-dim of the fused unembed/entropy
                                   # contraction; -> ("data",) turns it into
                                   # partial-logit sums
    ("layers", ()),
    ("seq", ()),
    ("kv_seq", ()),
    ("head_dim", ()),
    ("kv_lora", ()),
    ("q_lora", ()),
    ("state", ()),
    ("conv", ()),
    ("act_embed", ()),             # activation embed dim: replicated
)


def rules_dict(overrides: Optional[dict] = None) -> dict:
    d = {k: tuple(v) for k, v in DEFAULT_RULES}
    if overrides:
        for k, v in overrides.items():
            d[k] = tuple(v) if v else ()
    return d


@dataclasses.dataclass(frozen=True)
class AbstractParam:
    """A leaf of an abstract tree: shape, dtype (a torch dtype) and logical
    axes, no memory."""
    shape: Tuple[int, ...]
    dtype: Any
    logical_axes: Tuple[Optional[str], ...]

    def __post_init__(self):
        if len(self.shape) != len(self.logical_axes):
            raise ValueError(f"shape {self.shape} vs axes {self.logical_axes}")


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """`fn` over the leaves of nested dicts (and of the trees in `rest`,
    which have `tree`'s keys)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def tree_leaves(tree: Any) -> list:
    if isinstance(tree, dict):
        return [l for v in tree.values() for l in tree_leaves(v)]
    return [tree]


def param_count(tree: Any) -> int:
    """Total element count of a tree of tensors or AbstractParams."""
    return sum(math.prod(l.shape) for l in tree_leaves(tree))


# ---------------------------------------------------------------------------
# Meshes and specs
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class MeshLayout:
    """A mesh's axis names and sizes without devices or process groups:
    what spec resolution reads (`DeviceMesh` has the same two fields)."""
    shape: Tuple[int, ...]
    mesh_dim_names: Tuple[str, ...]

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return self.mesh_dim_names


def axis_sizes(mesh) -> Dict[str, int]:
    """{axis name: size} of a MeshLayout or a DeviceMesh."""
    return dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))


def make_mesh(shape: Sequence[int], axes: Sequence[str],
              device_type: str = "cuda"):
    """A `DeviceMesh` of `shape` over the initialised world, whose size
    must be the mesh's; raises otherwise."""
    from torch.distributed.device_mesh import init_device_mesh
    n = math.prod(shape)
    if not dist.is_initialized() or dist.get_world_size() != n:
        world = dist.get_world_size() if dist.is_initialized() else None
        raise RuntimeError(
            f"a mesh of shape {tuple(shape)} needs an initialised world of "
            f"{n} ranks; the world is {world}")
    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(axes))


class Spec(tuple):
    """PartitionSpec counterpart: one entry per tensor dim, each None, a
    mesh axis name or a tuple of names (major to minor)."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __getnewargs__(self):
        return tuple(self)

    def __repr__(self):
        return f"Spec{tuple.__repr__(self)}"


def axes_of(entry) -> Tuple[str, ...]:
    """A spec entry as a tuple of mesh axis names."""
    if entry is None:
        return ()
    if isinstance(entry, str):
        return (entry,)
    return tuple(entry)


def logical_to_spec(logical_axes: Sequence[Optional[str]],
                    shape: Sequence[int], mesh,
                    rules: Optional[dict] = None) -> Spec:
    """A Spec honouring divisibility and axis uniqueness (JAX's rules)."""
    rules = rules or rules_dict()
    sizes = axis_sizes(mesh)
    used: set = set()
    spec = []
    for dim, name in zip(shape, logical_axes):
        picked = []
        if name is not None:
            remaining = dim
            for axis in rules.get(name, ()):
                if axis in used or axis not in sizes:
                    continue
                if remaining % sizes[axis] == 0:
                    picked.append(axis)
                    used.add(axis)
                    remaining //= sizes[axis]
        spec.append(None if not picked else
                    picked[0] if len(picked) == 1 else tuple(picked))
    return Spec(*spec)


def spec_placements(spec: Spec, mesh) -> tuple:
    """DTensor placements of `spec` on `mesh`: Shard(dim) for each mesh
    axis that shards a tensor dim, Replicate() for the others."""
    from torch.distributed.tensor import Replicate, Shard
    dim_of = {a: i for i, e in enumerate(spec) for a in axes_of(e)}
    return tuple(Shard(dim_of[a]) if a in dim_of else Replicate()
                 for a in mesh.mesh_dim_names)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    mesh: Any
    spec: Spec

    @property
    def placements(self) -> tuple:
        return spec_placements(self.spec, self.mesh)


def sharding_for(leaf: AbstractParam, mesh,
                 rules: Optional[dict] = None) -> NamedSharding:
    return NamedSharding(mesh, logical_to_spec(leaf.logical_axes, leaf.shape,
                                               mesh, rules))


def tree_shardings(tree: Any, mesh, rules: Optional[dict] = None) -> Any:
    """A tree of AbstractParams -> the same tree of NamedShardings."""
    return tree_map(lambda l: sharding_for(l, mesh, rules), tree)


def tree_shape_structs(tree: Any) -> Any:
    """A tree of AbstractParams -> the same tree of "meta" tensors."""
    return tree_map(lambda l: torch.empty(l.shape, dtype=l.dtype,
                                          device="meta"), tree)


def constrain(x, logical_axes: Sequence[Optional[str]], mesh=None,
              rules: Optional[dict] = None):
    """The identity on a plain (rank-local) tensor, as JAX's is without a
    mesh; a DTensor is redistributed to the logical axes' placements."""
    from torch.distributed.tensor import DTensor
    if mesh is None or not isinstance(x, DTensor):
        return x
    spec = logical_to_spec(logical_axes, x.shape, mesh, rules)
    return x.redistribute(mesh, spec_placements(spec, mesh))


@dataclasses.dataclass(frozen=True)
class ParallelContext:
    """Carries the mesh and its axis names through model code.

    mesh=None is single-device execution: every path is the local one.
    With a `DeviceMesh` the explicit paths run their collectives over the
    process groups of its axes; with a `MeshLayout` specs resolve but no
    collective can run."""
    mesh: Any = None
    data_axis: str = "data"
    model_axis: str = "model"
    pod_axis: Optional[str] = None
    rules: Optional[dict] = None

    def __post_init__(self):
        if (self.mesh is not None and not isinstance(self.mesh, MeshLayout)
                and self.mesh.size() != dist.get_world_size()):
            raise ValueError(f"a mesh of {self.mesh.size()} ranks in a "
                             f"world of {dist.get_world_size()}: the "
                             f"context's mesh must cover the world")

    def axis_size(self, axis: str) -> int:
        return 1 if self.mesh is None else axis_sizes(self.mesh).get(axis, 1)

    @property
    def model_parallel_size(self) -> int:
        return self.axis_size(self.model_axis)

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return tuple(self.mesh.mesh_dim_names)

    def spec(self, logical_axes, shape) -> Spec:
        return logical_to_spec(logical_axes, shape, self.mesh, self.rules)

    def constrain(self, x, logical_axes):
        return constrain(x, logical_axes, self.mesh, self.rules)

    def _device_mesh(self):
        if isinstance(self.mesh, MeshLayout):
            raise RuntimeError("a MeshLayout has no ranks or process groups: "
                               "collectives need a DeviceMesh (make_mesh)")
        return self.mesh

    def group(self, axis: str):
        """The process group of the ranks that differ only along `axis`."""
        return self._device_mesh().get_group(axis)

    def coord(self, axes: Sequence[str]) -> int:
        """The rank's index along `axes` taken together (major to minor)."""
        idx = 0
        for a in axes:
            idx = (idx * self.axis_size(a)
                   + self._device_mesh().get_local_rank(a))
        return idx

    def n_blocks(self, axes: Sequence[str]) -> int:
        return math.prod(self.axis_size(a) for a in axes)


# ---------------------------------------------------------------------------
# Recording the collectives
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class CollectiveEvent:
    """One collective as the port ran it on this rank."""
    op: str                    # "all-reduce", "all-gather" or "all-to-all"
    nbytes: int                # bytes of the result on the rank
    group_size: int
    axes: Tuple[str, ...]      # mesh axes of the group; () for the world
    ranks: Tuple[int, ...]     # the group's global ranks


_EVENTS: contextvars.ContextVar = contextvars.ContextVar(
    "repro_torch_collective_events", default=None)


@contextlib.contextmanager
def record_collectives():
    """Collect a `CollectiveEvent` for every collective of this module run
    in this context into the list it yields."""
    events: list = []
    token = _EVENTS.set(events)
    try:
        yield events
    finally:
        _EVENTS.reset(token)


def _record(op: str, out: torch.Tensor, group, axes) -> None:
    events = _EVENTS.get()
    if events is None:
        return
    ranks = (tuple(range(dist.get_world_size())) if group is None
             else tuple(dist.get_process_group_ranks(group)))
    events.append(CollectiveEvent(op, out.numel() * out.element_size(),
                                  len(ranks), tuple(axes), ranks))


# ---------------------------------------------------------------------------
# Collectives with the port's transposes
# ---------------------------------------------------------------------------

def _gather_cat(x: torch.Tensor, group, n: int, dim: int,
                axes=()) -> torch.Tensor:
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x, group=group)
    out = torch.cat(parts, dim=dim)
    _record("all-gather", out, group, axes)
    return out


def _sum(x: torch.Tensor, group, axes=(),
         op=dist.ReduceOp.SUM) -> torch.Tensor:
    x = x.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(x, op=op, group=group)
    _record("all-reduce", x, group, axes)
    return x


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx_, x, group, axis):
        ctx_.meta = (group, axis)
        return _sum(x, group, (axis,))

    @staticmethod
    def backward(ctx_, g):
        group, axis = ctx_.meta
        return _sum(g, group, (axis,)), None, None


class _AllGather(torch.autograd.Function):
    """Inside a body: gather the ranks' blocks along `dim`; the transpose
    sums the shares and keeps the rank's block (a reduce-scatter)."""

    @staticmethod
    def forward(ctx_, x, group, n, idx, dim, axis):
        ctx_.meta = (group, n, idx, dim, x.shape[dim], axis)
        return _gather_cat(x, group, n, dim, (axis,))

    @staticmethod
    def backward(ctx_, g):
        group, n, idx, dim, size, axis = ctx_.meta
        return (_sum(g, group, (axis,)).narrow(dim, idx * size, size),
                None, None, None, None, None)


class _AllToAll(torch.autograd.Function):
    """Block m of dim 0 goes to the m-th rank of the group; block m of the
    result came from it. Its own transpose."""

    @staticmethod
    def forward(ctx_, x, group, axis):
        ctx_.meta = (group, axis)
        return _all_to_all(x, group, (axis,))

    @staticmethod
    def backward(ctx_, g):
        group, axis = ctx_.meta
        return _all_to_all(g, group, (axis,)), None, None


def _all_to_all(x: torch.Tensor, group, axes=()) -> torch.Tensor:
    x = x.contiguous()
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=group)
    _record("all-to-all", out, group, axes)
    return out


class _SumShares(torch.autograd.Function):
    """The identity; its transpose sums the ranks' shares over the world."""

    @staticmethod
    def forward(ctx_, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx_, g):
        return _sum(g, None)


class _Assemble(torch.autograd.Function):
    """Rebuild a global tensor from the ranks' blocks (`gathers`: (dim,
    axes, index, block size) per sharded dim); the transpose is the
    rank's block of the global gradient over its replica count."""

    @staticmethod
    def forward(ctx_, y, pctx, gathers, replicas):
        ctx_.meta = (gathers, replicas)
        if not gathers:
            return y.view_as(y)
        for dim, axes, _, _ in gathers:
            for a in reversed(axes):          # minor axis first
                y = _gather_cat(y, pctx.group(a), pctx.axis_size(a), dim,
                                (a,))
        return y

    @staticmethod
    def backward(ctx_, g):
        gathers, replicas = ctx_.meta
        for dim, _, idx, size in gathers:
            g = g.narrow(dim, idx * size, size)
        return g / replicas, None, None, None


def _live(ctx: ParallelContext, axes: Sequence[str]) -> Tuple[str, ...]:
    return tuple(a for a in axes if ctx.axis_size(a) > 1)


def all_reduce(x: torch.Tensor, axes: Sequence[str], ctx: ParallelContext,
               op: str = "sum") -> torch.Tensor:
    """psum / pmean / pmax of `x` over the mesh axes `axes`."""
    axes = _live(ctx, axes)
    if op == "max":
        x = x.detach()
        for a in axes:
            x = _sum(x, ctx.group(a), (a,), dist.ReduceOp.MAX)
        return x
    if op not in ("sum", "mean"):
        raise ValueError(f"all_reduce op {op!r}: sum, mean or max")
    for a in axes:
        x = _AllReduceSum.apply(x, ctx.group(a), a)
    return x / ctx.n_blocks(axes) if op == "mean" and axes else x


def all_gather(x: torch.Tensor, axes: Sequence[str], ctx: ParallelContext,
               dim: int) -> torch.Tensor:
    """Concatenate the blocks of the ranks along `axes` (major to minor)
    on `dim`, inside a body."""
    for a in reversed(_live(ctx, axes)):
        x = _AllGather.apply(x, ctx.group(a), ctx.axis_size(a),
                             ctx.coord((a,)), dim, a)
    return x


def all_to_all(x: torch.Tensor, axis: str, ctx: ParallelContext
               ) -> torch.Tensor:
    """JAX's tiled `all_to_all(x, axis, 0, 0)`."""
    if ctx.axis_size(axis) == 1:
        return x
    return _AllToAll.apply(x, ctx.group(axis), axis)


def take_block(x: torch.Tensor, spec: Spec, ctx: ParallelContext
               ) -> torch.Tensor:
    """The rank's block of the global `x` under `spec`: a view."""
    if x.requires_grad and torch.is_grad_enabled():
        x = _SumShares.apply(x)
    for dim, entry in enumerate(spec):
        axes = axes_of(entry)
        n = ctx.n_blocks(axes)
        if n > 1:
            if x.shape[dim] % n:
                raise ValueError(f"dim {dim} of {tuple(x.shape)} does not "
                                 f"split into {n} blocks over {axes}")
            size = x.shape[dim] // n
            x = x.narrow(dim, ctx.coord(axes) * size, size)
    return x


def assemble(y: torch.Tensor, spec: Spec, ctx: ParallelContext
             ) -> torch.Tensor:
    """The global tensor whose rank blocks under `spec` are the ranks' `y`
    (every rank gets it)."""
    gathers, sharded = [], 1
    for dim, entry in enumerate(spec):
        axes = _live(ctx, axes_of(entry))
        if axes:
            gathers.append((dim, axes, ctx.coord(axes), y.shape[dim]))
            sharded *= ctx.n_blocks(axes)
    replicas = ctx.n_blocks(ctx.axis_names) // sharded
    if not gathers and replicas == 1:
        return y
    return _Assemble.apply(y, ctx, tuple(gathers), replicas)


def shard_map(f: Callable, *, ctx: ParallelContext, in_specs: Sequence[Spec],
              out_specs) -> Callable:
    """JAX's `shard_map` over the port's global tensors: `f` gets each
    argument's block (`take_block`) and its outputs are rebuilt into
    global tensors on every rank (`assemble`). `out_specs` is one Spec or
    a tuple of Specs, as `f` returns one tensor or a tuple."""
    single = isinstance(out_specs, Spec)

    def mapped(*args):
        blocks = [take_block(a, s, ctx) for a, s in zip(args, in_specs)]
        outs = f(*blocks)
        if single:
            return assemble(outs, out_specs, ctx)
        return tuple(assemble(o, s, ctx) for o, s in zip(outs, out_specs))

    return mapped


def shard_params(params: Any, abstract: Any, ctx: ParallelContext) -> Any:
    """The rank's blocks of a full tree (seeded or converted from JAX) by
    the specs of its abstract tree (`init_params(cfg, abstract=True)` or
    `init_cache(..., abstract=True)`): views where the block is
    contiguous, contiguous copies where it is not."""
    def block(t, leaf):
        b = take_block(t.detach(), ctx.spec(leaf.logical_axes, leaf.shape),
                       ctx)
        return b if b.is_contiguous() else b.contiguous()
    return tree_map(block, params, abstract)
