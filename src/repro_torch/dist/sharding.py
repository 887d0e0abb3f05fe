"""The serving mesh and the axis helpers of the port's mesh paths — the
counterpart of ``repro/dist/sharding.py``'s serving half.

A mesh is a ``DeviceMesh`` over the initialised process group, one rank
per device. Its device type is where the collectives run: ``"cuda"``
under NCCL (a GPU a rank), ``"cpu"`` under gloo (on the CPU, or ranks
that share one GPU: gloo carries only small host copies of the results
and gradients, see ``all_gather``). A collective over several mesh
axes runs over each axis in turn, last axis first, so its result is in
the row-major order of the flattened axes, as jax lays out an
``all_gather`` over a tuple of axes.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.distributed as dist

__all__ = [
    "data_axes",
    "index_mesh",
    "tombstone_budget",
    "mesh_device_type",
    "axis_index",
    "axis_size",
    "axis_block",
    "axes_group",
    "group_all_gather",
    "all_gather",
]


def data_axes(mesh) -> tuple[str, ...]:
    """The data-parallel axes present on this mesh (pod-major)."""
    return tuple(a for a in ("pod", "data") if a in (mesh.mesh_dim_names or ()))


def mesh_device_type() -> str:
    """The ``DeviceMesh`` device type of the initialised process group:
    ``"cuda"`` under NCCL, ``"cpu"`` under any other backend."""
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def index_mesh(n_shards: int):
    """The serving mesh for shard-parallel search: ranks ``0 …
    n_shards - 1`` of the initialised process group on the ``model``
    axis (``data`` a size-1 placeholder), the ``(1, n_shards)`` mesh the
    search of ``make_sharded_search`` takes with ``index_axis="model"``.

    ``None`` when no process group is initialised or it has fewer than
    ``n_shards`` ranks — the caller (``ShardedRetriever``) then serves
    its shards in turn on its own device. Every rank of the group must
    call this (the mesh's axis groups are made collectively); a rank
    past ``n_shards`` holds no coordinate on the mesh."""
    from torch.distributed.device_mesh import DeviceMesh

    if n_shards < 1 or not dist.is_initialized() or dist.get_world_size() < n_shards:
        return None
    return DeviceMesh(mesh_device_type(), torch.arange(n_shards).reshape(1, n_shards),
                      mesh_dim_names=("data", "model"))


def tombstone_budget(k: int, n_local: int, n_tombstones: int) -> int:
    """Per-shard candidate budget under live tombstones: every shard
    surfaces ``k + n_tombstones`` candidates (capped at its size), so
    ``k`` live docs survive the merge's dead-doc mask even when every
    tombstoned doc outranks them. Uniform across shards: it depends on
    the tombstone count, never on which shard holds them, so the mesh's
    one ``k_local`` and the sequential rotation's per-shard budgets
    surface the same candidates."""
    if k < 1 or n_local < 1 or n_tombstones < 0:
        raise ValueError(
            f"invalid budget inputs: k={k}, n_local={n_local}, n_tombstones={n_tombstones}"
        )
    return min(n_local, k + n_tombstones)


def _axes(axes) -> tuple[str, ...]:
    return (axes,) if isinstance(axes, str) else tuple(axes)


def _coordinate(mesh) -> list[int]:
    coord = mesh.get_coordinate()
    if coord is None:
        raise ValueError(f"rank {dist.get_rank()} holds no coordinate on the mesh {mesh}")
    return coord


def axis_index(mesh, axes: str | Sequence[str]) -> int:
    """This rank's row-major index over ``axes`` (jax's ``axis_index``
    over a tuple of axes)."""
    coord, names = _coordinate(mesh), mesh.mesh_dim_names
    idx = 0
    for a in _axes(axes):
        d = names.index(a)
        idx = idx * mesh.shape[d] + coord[d]
    return idx


def axis_size(mesh, axes: str | Sequence[str]) -> int:
    """The number of ranks along ``axes``."""
    return math.prod(mesh.size(mesh.mesh_dim_names.index(a)) for a in _axes(axes))


def axis_block(x: torch.Tensor, mesh, axes: str | Sequence[str]) -> torch.Tensor:
    """This rank's contiguous block of ``x``'s leading axis split over
    ``axes`` (a ``PartitionSpec`` entry of ``axes`` on that axis); a
    length the axes' size does not divide raises."""
    n = axis_size(mesh, axes)
    if x.shape[0] % n:
        raise ValueError(f"leading axis {x.shape[0]} does not split over {_axes(axes)} of "
                         f"size {n}")
    m = x.shape[0] // n
    i = axis_index(mesh, axes)
    return x[i * m:(i + 1) * m]


def axes_group(mesh, axes: str | Sequence[str]):
    """The process group of ``axes``: one mesh axis's group, or the whole
    group where ``axes`` are every axis of a mesh that spans the world
    (pure data parallelism). Other axis sets raise."""
    axes = _axes(axes)
    if len(axes) == 1:
        return mesh.get_group(axes[0])
    if (sorted(axes) == sorted(mesh.mesh_dim_names)
            and mesh.mesh.numel() == dist.get_world_size()):
        return dist.group.WORLD
    raise ValueError(f"a collective over axes {axes} needs one axis or every axis of a mesh "
                     f"that spans the process group; mesh axes {mesh.mesh_dim_names}")


def group_all_gather(t: torch.Tensor, group=None) -> torch.Tensor:
    """Every rank's ``t`` in ``group`` (default: the world) → ``[size,
    *t.shape]`` in group-rank order, on ``t``'s device, the same on every
    rank. Under gloo a CUDA tensor crosses as a host copy (gloo gathers
    host tensors only): the serving path sends ``[nq, k]`` results, the
    data-parallel step int8 gradients."""
    wire = t.contiguous()
    if wire.is_cuda and dist.get_backend(group) == "gloo":
        wire = wire.cpu()
    parts = [torch.empty_like(wire) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, wire, group=group)
    return torch.stack(parts).to(t.device)


def all_gather(t: torch.Tensor, mesh, axes: str | Sequence[str]) -> torch.Tensor:
    """Every rank's ``t`` along ``axes`` → ``[axis_size, *t.shape]`` in
    row-major order of ``axes`` (``group_all_gather`` over each axis in
    turn, the last first)."""
    out = t.unsqueeze(0)
    for a in reversed(_axes(axes)):
        out = group_all_gather(out, mesh.get_group(a)).flatten(0, 1)
    return out
