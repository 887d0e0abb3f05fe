"""The serving mesh and the axis helpers of the port's mesh paths — the
counterpart of ``repro/dist/sharding.py``'s serving half.

A mesh is a ``DeviceMesh`` over the initialised process group, one rank
per device, or a device-free ``launch.mesh.MeshShape`` (axis names and
sizes) where only shapes are asked for: ``data_axes``, ``axis_size`` and
``shard_shape`` read either one. A ``DeviceMesh``'s device type is where
the collectives run: ``"cuda"`` under NCCL (a GPU a rank), ``"cpu"``
under gloo (on the CPU, or ranks that share one GPU: gloo carries only
small host copies of the results and gradients, see ``all_gather``). A collective over several mesh
axes runs over each axis in turn, last axis first, so its result is in
the row-major order of the flattened axes, as jax lays out an
``all_gather`` over a tuple of axes.

A placement is the reference's ``NamedSharding``: a mesh and a
``PartitionSpec`` (``P``, a tuple with one entry per leading dimension:
``None``, an axis name, or a tuple of axis names split row-major).
``to_shardings`` and ``replicate`` build them over a tree of specs as the
reference's do; ``Placement.shard_shape`` is the per-device shape and
``shard_block`` a rank's block of an array.

The families' rules are the reference's, entry for entry: the LM's
(``lm_param_specs``, ``kv_cache_spec``) over the ``meta`` parameter tree
of ``models.transformer.param_structs``, the GNN's (``gnn_batch_spec``;
its parameters are replicated) and the RecSys family's
(``recsys_param_specs``, ``recsys_batch_spec``) over the ``meta`` trees
of the configs' ``abstract_params``.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Sequence

import torch
import torch.distributed as dist

__all__ = [
    "P",
    "PartitionSpec",
    "Placement",
    "to_shardings",
    "replicate",
    "shard_shape",
    "shard_block",
    "mesh_size",
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
    "lm_param_specs",
    "kv_cache_spec",
    "gnn_batch_spec",
    "recsys_param_specs",
    "recsys_batch_spec",
]


class PartitionSpec(tuple):
    """The reference's ``PartitionSpec``: one entry a leading dimension —
    ``None`` (not split), an axis name, or a tuple of axis names. A spec
    is a leaf of a spec tree (a plain tuple is a node)."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


P = PartitionSpec


class Placement(NamedTuple):
    """The reference's ``NamedSharding(mesh, spec)``."""

    mesh: object
    spec: PartitionSpec

    def shard_shape(self, shape) -> tuple[int, ...]:
        return shard_shape(shape, self.spec, self.mesh)


def _tree_map(fn, tree):
    """``fn`` over the leaves of a tree of dicts, lists and tuples (a
    ``PartitionSpec`` is a leaf)."""
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not isinstance(tree, PartitionSpec):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def to_shardings(mesh, specs):
    """A tree of ``PartitionSpec``s → the same tree of ``Placement``s."""
    return _tree_map(lambda s: Placement(mesh, s), specs)


def replicate(tree):
    """A fully-replicated spec for every leaf of ``tree``."""
    return _tree_map(lambda _: P(), tree)


def mesh_size(mesh) -> int:
    """The number of devices of a ``DeviceMesh`` or a ``MeshShape``."""
    return math.prod(mesh.size(d) for d in range(len(mesh.mesh_dim_names)))


def shard_shape(shape, spec, mesh) -> tuple[int, ...]:
    """The per-device shape of an array of ``shape`` placed by ``spec``
    on ``mesh`` — the reference's ``NamedSharding(mesh,
    spec).shard_shape(shape)``, with its error on a dimension the axes'
    size does not divide."""
    shape = tuple(int(d) for d in shape)
    if len(spec) > len(shape):
        raise ValueError(f"spec {spec!r} has {len(spec)} entries for a {len(shape)}-D array")
    factors = [1 if e is None else axis_size(mesh, e) for e in spec]
    factors += [1] * (len(shape) - len(factors))
    for i, (d, f) in enumerate(zip(shape, factors)):
        if d % f:
            raise ValueError(
                f"Sharding {Placement(mesh, P(*spec))} implies that array axis {i} is "
                f"partitioned {f} times, but the dimension size is {d} (full shape: {shape}, "
                f"per-dimension tiling factors: {factors} should evenly divide the shape)")
    return tuple(d // f for d, f in zip(shape, factors))


def shard_block(x: torch.Tensor, spec, mesh) -> torch.Tensor:
    """This rank's block of ``x`` placed by ``spec`` on ``mesh`` (a
    ``DeviceMesh``): every dimension split over its entry's axes at the
    rank's row-major index over them. The block is a view of ``x``."""
    shard = shard_shape(x.shape, spec, mesh)
    for d, e in enumerate(spec):
        if e is not None:
            i = axis_index(mesh, e)
            x = x.narrow(d, i * shard[d], shard[d])
    return x


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


# ---------------------------------------------------------------------------
# LM family
# ---------------------------------------------------------------------------


def _fit(mesh, entry, dim: int):
    """Keep a spec entry only when it divides the dimension."""
    if entry is None:
        return None
    axes = entry if isinstance(entry, tuple) else (entry,)
    axes = tuple(a for a in axes if a in mesh.mesh_dim_names)
    if not axes or dim % axis_size(mesh, axes):
        return None
    return axes if len(axes) > 1 else axes[0]


def _spec(mesh, shape, *entries) -> PartitionSpec:
    return P(*[_fit(mesh, e, d) for e, d in zip(entries, shape)])


def lm_param_specs(cfg, mesh, fsdp: bool = True):
    """Storage specs for every LM parameter (stacked-layer layout).

    TP over ``model`` on the contraction-free dim; FSDP over the data
    axes on the other dim when ``fsdp`` (train/prefill — decode turns it
    off so weights stay TP-resident)."""
    from ..models.transformer import param_structs
    from ..tree import tree_leaves_with_path, tree_unflatten

    structs = param_structs(cfg)
    da = data_axes(mesh)
    dsp = da if fsdp else None

    def one(name, leaf):
        shape = tuple(leaf.shape)
        if leaf.dim() <= 1 or "norm" in name or "router" in name:
            return P()
        if "moe" in name:
            # stacked experts [L, E, d_in, d_out]: expert-parallel over
            # model, FSDP on d_in (gate/up) or d_out (down)
            if leaf.dim() == 4:
                if "w_down" in name:
                    return _spec(mesh, shape, None, "model", None, dsp)
                return _spec(mesh, shape, None, "model", dsp, None)
            if "shared_down" in name:  # [L, S·F, D]
                return _spec(mesh, shape, None, "model", dsp)
            return _spec(mesh, shape, None, dsp, "model")  # shared gate/up
        if "embed" in name:  # [V, D] — vocab-sharded over model
            return _spec(mesh, shape, "model", dsp)
        if "lm_head" in name:  # [D, V]
            return _spec(mesh, shape, dsp, "model")
        if "wo" in name or "w_down" in name:  # [L, X, D] row-parallel
            return _spec(mesh, shape, None, "model", dsp)
        # [L, D, X] column-parallel (wq/wk/wv/w_gate/w_up)
        return _spec(mesh, shape, None, dsp, "model")

    return tree_unflatten(structs, [one(n, leaf) for n, leaf in tree_leaves_with_path(structs)])


def kv_cache_spec(mesh, *, batch: int, seq_shard: bool = False) -> dict:
    """Specs for the [L, B, S, Hk, dh] KV cache dict.

    Normal decode: batch over data, sequence over ``model`` (matches
    ``flash_decode_shardmap(batch_axes=da, seq_axes=("model",))``).
    ``seq_shard`` (500k context): sequence over every axis, batch
    replicated."""
    da = data_axes(mesh)
    if seq_shard:
        spec = P(None, None, (*da, "model"), None, None)
    else:
        spec = P(None, _fit(mesh, da, batch), "model", None, None)
    return {"k": spec, "v": spec}


# ---------------------------------------------------------------------------
# GNN family
# ---------------------------------------------------------------------------


def gnn_batch_spec(mesh) -> dict:
    """Node and edge arrays split over the data axes; the parameters are
    replicated by ``replicate`` (they are KBs)."""
    da = data_axes(mesh)
    return {
        "x": P(da, None),
        "edge_src": P(da),
        "edge_dst": P(da),
        "labels": P(da),
        "train_mask": P(da),
    }


# ---------------------------------------------------------------------------
# RecSys family
# ---------------------------------------------------------------------------


def recsys_param_specs(model_name: str, abs_params, mesh):
    """Embedding tables row-split over ``model`` (the vocab dimension, where
    it divides); everything else (MLP towers, cross layers, heads) is
    small enough to replicate."""
    from ..tree import tree_leaves_with_path, tree_unflatten

    def one(name, leaf):
        if "embed" in name and leaf.dim() >= 1:
            return _spec(mesh, leaf.shape, "model", *([None] * (leaf.dim() - 1)))
        if "linear" in name and leaf.dim() == 1:  # deepfm's first-order terms
            return _spec(mesh, leaf.shape, "model")
        return P()

    return tree_unflatten(abs_params, [one(n, leaf)
                                       for n, leaf in tree_leaves_with_path(abs_params)])


def recsys_batch_spec(model_name: str, mesh) -> dict:
    da = data_axes(mesh)
    if model_name == "deepfm":
        return {"sparse": P(da, None), "label": P(da)}
    if model_name == "dcn-v2":
        return {"dense": P(da, None), "sparse": P(da, None), "label": P(da)}
    if model_name == "sasrec":
        return {
            "seq": P(da, None),
            "pos_label": P(da, None),
            "neg_label": P(da, None, None),
        }
    if model_name == "din":
        return {"hist": P(da, None), "target": P(da), "label": P(da)}
    raise KeyError(f"unknown recsys model {model_name!r}")
