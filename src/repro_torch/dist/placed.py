"""The reference's weight placements run for real: the collectives a
placed step calls, as autograd functions, and what a rank needs to know
of a tree placed by ``PartitionSpec``s.

A placed step holds, on each rank, its block of every weight and
optimizer leaf (``place_tree``, ``dist.sharding.shard_block`` a leaf) and
runs the reference's program with explicit collectives on
``torch.distributed``. Over the ``model`` axis values follow Megatron's
convention: an activation is either replicated (the same on every model
rank, and so is its gradient), split, or a partial sum.

* ``copy_to_model``: a replicated value entering a split computation —
  the identity, whose backward sums the gradient over ``model``.
* ``reduce_from_model``: a partial sum made whole — an all-reduce in
  place, whose backward is the identity.
* ``gather_from_model``: a split value made whole along a dimension — an
  all-gather, whose backward keeps the rank's own block.

Over the data axes every rank holds other rows, so a collective's
backward is its true transpose:

* ``gather_axes``: FSDP's gather of a weight's data-split dimension
  before its use — an all-gather, whose backward reduce-scatters (sums
  over the ranks, keeps the rank's block).
* ``mean_over_data``: the mean of a value over the data ranks (the MoE
  layer's global load balance), whose backward is the same mean.

Under gloo a CUDA tensor crosses as a host copy (gloo reduces host
tensors only). ``LeafShard`` tells the optimizer how a leaf is split so
its norms and factored means count every element once
(``train/optimizer.py``).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Sequence

import torch
import torch.distributed as dist

from ..tree import tree_map
from .sharding import axis_index, axis_size, data_axes, shard_block

__all__ = ["copy_to_model", "replicated", "reduce_from_model", "gather_from_model", "gather_axes",
           "mean_over_data", "max_over_model", "psum", "all_gather_axes", "all_to_all_model",
           "LeafShard", "TreeShards", "leaf_shards", "place_tree", "split_axes", "spec_axes",
           "data_split"]

# torch ≥ 2.13 names the tensor forms *_single; older releases *_into_tensor / *_tensor
_ALL_GATHER = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
_REDUCE_SCATTER = getattr(dist, "reduce_scatter_single", None) or dist.reduce_scatter_tensor


def spec_axes(entry) -> tuple[str, ...]:
    """A ``PartitionSpec`` entry → its axis names (``()`` for None)."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def _group(mesh, axis: str):
    return mesh.get_group(axis)


def _host(t: torch.Tensor, group) -> bool:
    return t.is_cuda and dist.get_backend(group) == "gloo"


def _all_reduce(t: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """``t`` all-reduced over ``group`` (a new tensor)."""
    wire = t.detach().cpu() if _host(t, group) else t.detach().contiguous().clone()
    dist.all_reduce(wire, op=op, group=group)
    return wire.to(t.device)


def psum(t: torch.Tensor, mesh, axes: Sequence[str]) -> torch.Tensor:
    """The sum of ``t`` over the ranks along ``axes`` (an all-reduce over
    each axis in turn; no autograd)."""
    for a in axes:
        t = _all_reduce(t, _group(mesh, a))
    return t


def _gather_one(t: torch.Tensor, group, dim: int) -> torch.Tensor:
    """Every rank's ``t`` of ``group`` concatenated along ``dim`` in rank
    order."""
    n = dist.get_world_size(group)
    x = t.detach().movedim(dim, 0).contiguous()
    if dist.get_backend(group) == "gloo":  # gathers host tensors, into a list
        wire = x.cpu() if x.is_cuda else x
        parts = [torch.empty_like(wire) for _ in range(n)]
        dist.all_gather(parts, wire, group=group)
        out = torch.cat(parts).to(t.device)
    else:
        out = torch.empty((n * x.shape[0], *x.shape[1:]), dtype=x.dtype, device=x.device)
        _ALL_GATHER(out, x, group=group)
    return out.movedim(0, dim)


def all_gather_axes(t: torch.Tensor, mesh, axes: Sequence[str], dim: int) -> torch.Tensor:
    """Every rank's ``t`` along ``axes`` concatenated on ``dim`` in the
    row-major order of ``axes`` (the last axis gathered first; no
    autograd)."""
    for a in reversed(tuple(axes)):
        t = _gather_one(t, _group(mesh, a), dim)
    return t


def _reduce_scatter(t: torch.Tensor, mesh, axes: Sequence[str], dim: int) -> torch.Tensor:
    """The sum of ``t`` over the ranks along ``axes``, the rank's block of
    ``dim`` kept (row-major over ``axes``)."""
    axes = tuple(axes)
    if not axes:
        return t
    n = axis_size(mesh, axes)
    if len(axes) == 1 and dist.get_backend(_group(mesh, axes[0])) != "gloo":
        x = t.detach().movedim(dim, 0).contiguous()
        out = torch.empty((x.shape[0] // n, *x.shape[1:]), dtype=x.dtype, device=x.device)
        _REDUCE_SCATTER(out, x, group=_group(mesh, axes[0]))
        return out.movedim(0, dim)
    m = t.shape[dim] // n
    return psum(t, mesh, axes).narrow(dim, axis_index(mesh, axes) * m, m)


class _Replicated(torch.autograd.Function):
    """A value replicated over ``axes`` entering a computation each rank
    does its part of: the identity, whose backward sums the gradient over
    the ranks (the transpose of jax's ``P()`` in-spec)."""

    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return psum(g, ctx.mesh, ctx.axes), None, None


class _ReduceFromModel(torch.autograd.Function):
    """In place: a partial sum is a fresh intermediate no one else reads
    (a second ``[T, D]`` or lookup buffer would count in the peak)."""

    @staticmethod
    def forward(ctx, x, mesh):
        group = _group(mesh, "model")
        if _host(x, group):
            x.copy_(_all_reduce(x, group))
        else:
            dist.all_reduce(x, op=dist.ReduceOp.SUM, group=group)
        ctx.mark_dirty(x)
        return x

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, dim):
        ctx.mesh, ctx.dim, ctx.n = mesh, dim, x.shape[dim]
        return _gather_one(x, _group(mesh, "model"), dim)

    @staticmethod
    def backward(ctx, g):
        i = axis_index(ctx.mesh, "model")
        return g.narrow(ctx.dim, i * ctx.n, ctx.n), None, None


class _GatherAxes(torch.autograd.Function):
    """The tiled all-gather of a rank's block along ``dim`` over ``axes``
    (row-major rank order); its backward sums the cotangent over the ranks
    and keeps the rank's own block (a reduce-scatter)."""

    @staticmethod
    def forward(ctx, x, mesh, axes, dim):
        ctx.mesh, ctx.axes, ctx.dim = mesh, axes, dim
        return all_gather_axes(x, mesh, axes, dim)

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter(g, ctx.mesh, ctx.axes, ctx.dim), None, None, None


class _MeanOverData(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes, ctx.n = mesh, axes, axis_size(mesh, axes)
        return psum(x, mesh, axes) / ctx.n

    @staticmethod
    def backward(ctx, g):
        return psum(g, ctx.mesh, ctx.axes) / ctx.n, None, None


# The collectives run on groups of one too (a placed cell on one card runs
# every code path a larger mesh runs).


def max_over_model(x: torch.Tensor, mesh) -> torch.Tensor:
    """The elementwise max of ``x`` over ``model`` (no autograd)."""
    return _all_reduce(x, _group(mesh, "model"), op=dist.ReduceOp.MAX)


def replicated(x: torch.Tensor, mesh, axes: Sequence[str]) -> torch.Tensor:
    return _Replicated.apply(x, mesh, tuple(axes))


def copy_to_model(x: torch.Tensor, mesh) -> torch.Tensor:
    return _Replicated.apply(x, mesh, ("model",))


def reduce_from_model(x: torch.Tensor, mesh) -> torch.Tensor:
    return _ReduceFromModel.apply(x, mesh)


def gather_from_model(x: torch.Tensor, mesh, dim: int) -> torch.Tensor:
    return _GatherFromModel.apply(x, mesh, dim % x.dim())


def gather_axes(x: torch.Tensor, mesh, axes: Sequence[str], dim: int) -> torch.Tensor:
    """``_GatherAxes``: FSDP's gather of a weight's data-split dimension,
    GAT's of node rows over every axis."""
    axes = tuple(axes)
    return _GatherAxes.apply(x, mesh, axes, dim % x.dim()) if axes else x


def mean_over_data(x: torch.Tensor, mesh, axes: Sequence[str]) -> torch.Tensor:
    axes = tuple(axes)
    return _MeanOverData.apply(x, mesh, axes) if axes else x


def all_to_all_model(x: torch.Tensor, mesh, split_dim: int, cat_dim: int) -> torch.Tensor:
    """``x`` split into ``model``-many blocks along ``split_dim``, block
    ``j`` sent to model rank ``j``; the blocks received concatenated along
    ``cat_dim`` in rank order (no autograd)."""
    group = _group(mesh, "model")
    n = dist.get_world_size(group)
    blocks = x.movedim(split_dim, 0)
    m = blocks.shape[0] // n
    send = blocks.reshape(n, m, *blocks.shape[1:]).contiguous()
    wire = send.cpu() if _host(send, group) else send
    recv = torch.empty_like(wire)
    dist.all_to_all_single(recv, wire, group=group)
    recv = recv.to(x.device)  # [n (source), m, ...] in split_dim-first layout
    parts = [recv[j].movedim(0, split_dim) for j in range(n)]
    return torch.cat(parts, dim=cat_dim)


# ---------------------------------------------------------------------------
# placed trees
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class LeafShard:
    """How one leaf is placed: its global shape and, per dimension, the
    mesh axes that split it (``()``: whole)."""

    shape: tuple[int, ...]
    dims: tuple[tuple[str, ...], ...]

    @property
    def axes(self) -> tuple[str, ...]:
        """Every axis that splits the leaf."""
        return tuple(a for d in self.dims for a in d)


class TreeShards(NamedTuple):
    """A placed tree's ``LeafShard``s (``tree``, the parameters'
    structure) on ``mesh``: what the optimizer needs of the placement."""

    mesh: object
    tree: object


def leaf_shards(structs, specs):
    """A tree of ``LeafShard`` from the leaves' global ``structs`` and
    their ``PartitionSpec``s."""
    def one(s, spec):
        dims = tuple(spec_axes(e) for e in spec) + ((),) * (s.dim() - len(spec))
        return LeafShard(tuple(int(d) for d in s.shape), dims)

    return tree_map(one, structs, specs)


def split_axes(spec) -> tuple[str, ...]:
    """Every axis a ``PartitionSpec`` splits over."""
    return tuple(a for e in spec for a in spec_axes(e))


def place_tree(tree, specs, mesh):
    """The rank's placed copy of a whole tree: each leaf's block under its
    spec (``shard_block``), contiguous and owning its storage (the whole
    tree can then be dropped)."""
    return tree_map(lambda t, s: shard_block(t, s, mesh).contiguous().clone(), tree, specs)


def data_split(spec, mesh) -> bool:
    """Whether a spec splits its leaf over any data axis of ``mesh``."""
    da = set(data_axes(mesh))
    return any(a in da for a in split_axes(spec))

