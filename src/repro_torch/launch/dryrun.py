"""Production-mesh dry run — the port of ``repro/launch/dryrun.py``.

For every (architecture × input shape) cell, build the cell
against the production meshes, with ``meta`` inputs and no allocation:

    single-pod : (16, 16)      ("data", "model")        = 256 devices
    multi-pod  : (2, 16, 16)   ("pod", "data", "model") = 512 devices

The meshes are ``launch.mesh.MeshShape``s (no process group, no
devices). The reference lowers and compiles each cell with XLA and
reads the compiled module's memory and cost analyses; the port has no
compiler pass to ask, so each record carries the cell's own per-device
counts (``configs/retrieval.py``, ``launch/hlo_stats.py``): the
argument and output bytes a device holds under the cell's placements,
the useful flops split evenly, and the collectives' bytes.

The temporaries are measured without a device (``trace_memory``): the
rank's step of the cell runs once at its per-device shapes on fake
tensors (``FakeTensorMode``: shapes and dtypes, no storage), rank 0 of
a ``"fake"`` process group at the mesh's world size (256 or 512, its
collectives no-ops, its ``DeviceMesh`` axis groups real), under
``MemTracker``. The LM and RecSys cells run placed (``weights=
"placed"``: the rank's blocks of every weight); GAT's parameters are
replicated; the retrieval cells run their search or scan. As the
reference counts XLA's buffers, the peak is arguments + outputs +
``temp_bytes`` − ``alias_bytes``: ``alias_bytes`` are the outputs that
share storage with an argument (the decode cache written in place),
``temp_bytes`` the tracked peak above the resident arguments less the
outputs that are new. The XLA-only keys (``lower_s``, ``compile_s``,
``xla_cost_analysis_*``) are ``null``. Records land in
``<out>/<mesh>/<arch>__<shape>.json``; the ``OK`` line gives the
per-device GiB beside one H100's 80 GB.

Usage::

    PYTHONPATH=src python -m repro_torch.launch.dryrun                # every cell
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch msmarco-splade-opt2 --shape scan_100q
    PYTHONPATH=src python -m repro_torch.launch.dryrun --mesh single --out build/dryrun

Without ``--arch`` every id runs (the five LM configs × 4 shapes, GAT ×
4, the four RecSys configs × 4 and the two retrieval configs × 3, on
both meshes: 92 cells). The LM, GNN and RecSys cells' counts are
``configs/base.py``'s (``LMArch``, ``GNNArch``, ``RecsysArch``): the
parameters, optimizer state, batches and caches as ``meta`` tensors
under their placements, and ``hlo_stats``' ``lm_collectives``,
``gnn_collectives`` and ``recsys_collectives``.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import traceback

import math

import torch
import torch.distributed as dist

from ..configs import PORTED_IDS, get_arch
from ..dist.sharding import mesh_size
from ..tree import tree_leaves, tree_map
from .hlo_stats import cell_costs, roofline_terms
from .mesh import production_mesh_shape

__all__ = ["run_cell", "cell_memory", "trace_memory", "step_memory", "fake_mesh", "main",
           "DEVICE_MEMORY_BYTES"]

#: one H100's device memory (80 GB)
DEVICE_MEMORY_BYTES = 80e9


def _storage(t: torch.Tensor):
    from torch.multiprocessing.reductions import StorageWeakRef

    return StorageWeakRef(t.untyped_storage())


def _nbytes(t: torch.Tensor) -> int:
    return math.prod(t.shape) * t.element_size()


#: the LM cells' traced depths: a stack's per-device peak above its
#: arguments is linear in its depth (every layer saves the same checkpoint
#: input and cache block and has the same gradients; one layer's backward
#: runs at a time), so it is traced at two depths and extended to the
#: config's; a step's microbatches run one after another on the same
#: accumulators, so two of them peak as all of them do
LM_TRACE_DEPTHS = (2, 3)
LM_TRACE_MICROBATCHES = 2


@contextlib.contextmanager
def fake_mesh(mesh):
    """A ``DeviceMesh`` of ``mesh``'s (a ``MeshShape``) layout over a
    ``"fake"`` process group of its world size, this process rank 0;
    its collectives are no-ops on fake tensors."""
    from torch.distributed.device_mesh import DeviceMesh
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("the dry run's trace makes its own fake process group; one is "
                           "initialised")
    n = mesh_size(mesh)
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)
    try:
        yield DeviceMesh("cpu", torch.arange(n).reshape(mesh.shape),
                         mesh_dim_names=mesh.mesh_dim_names)
    finally:
        dist.destroy_process_group()


def step_memory(fn, *args) -> dict:
    """``fn(*args)`` (fake tensors) under ``MemTracker``, the arguments
    resident → ``{"peak_new", "alias_bytes", "arg_bytes", "out_bytes"}``:
    the tracked peak above the arguments, the outputs' bytes that share an
    argument's storage, the arguments' and the outputs' bytes."""
    from torch.distributed._tools.mem_tracker import MemTracker

    leaves = [t for a in args for t in tree_leaves(a) if isinstance(t, torch.Tensor)]
    mt = MemTracker()
    mt.track_external(*leaves)
    with mt:
        out = fn(*args)
    peak = mt.get_tracker_snapshot("peak")[leaves[0].device]["Total"]
    held = {_storage(t) for t in leaves}
    outs = [t for t in tree_leaves(list(out) if isinstance(out, tuple) else out)
            if isinstance(t, torch.Tensor)]
    arg = sum(_nbytes(t) for t in leaves)
    return {"peak_new": int(peak) - arg, "arg_bytes": arg,
            "alias_bytes": sum(_nbytes(t) for t in outs if _storage(t) in held),
            "out_bytes": sum(_nbytes(t) for t in outs)}


def _traced(arch, shape: str, mesh, **kw) -> dict:
    """The rank's step of ``arch``'s cell on fake inputs at its per-device
    shapes (``step_memory``)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    with fake_mesh(mesh) as dmesh:
        cell = arch.build_cell(shape, dmesh, **kw)
        with FakeTensorMode(allow_non_fake_inputs=True):
            args = [tree_map(lambda s, p: torch.empty(p.shard_shape(s.shape), dtype=s.dtype),
                             st, sh) for st, sh in zip(cell.input_structs, cell.in_shardings)]
            return step_memory(cell.fn, *args)


def trace_memory(arch, shape: str, mesh, global_batch: int | None = None) -> dict:
    """The memory of rank 0's step of the cell of ``arch`` (an id or an
    arch) at ``shape`` (its batch, or ``global_batch``) on ``mesh`` (a
    ``MeshShape``; module docstring) → ``{"peak_new", "alias_bytes"}``.
    The LM and RecSys cells run placed; an LM cell is traced at
    ``LM_TRACE_DEPTHS`` with at most ``LM_TRACE_MICROBATCHES``
    microbatches (their rows) and extended linearly to its depth."""
    arch = get_arch(arch) if isinstance(arch, str) else arch
    if arch.family == "lm":
        from ..configs.base import LM_SHAPES
        from ..dist.sharding import axis_size, data_axes

        sh = LM_SHAPES[shape]
        cut = {"decode_fsdp": (not arch.tp_fits(mesh) if arch.decode_fsdp is None
                               else arch.decode_fsdp)}
        B = global_batch
        if sh["kind"] == "train":  # LM_TRACE_MICROBATCHES of the rank's microbatches
            da = data_axes(mesh)
            n_data = axis_size(mesh, da) if da else 1
            rows = (global_batch or sh["global_batch"]) // n_data
            per = rows // math.gcd(arch.microbatches, rows)
            mb = min(rows // per, LM_TRACE_MICROBATCHES)
            B, cut["microbatches"] = mb * per * n_data, mb
        got = []
        for L in LM_TRACE_DEPTHS:
            a = dataclasses.replace(arch, cfg=dataclasses.replace(arch.cfg, n_layers=L), **cut)
            got.append(_traced(a, shape, mesh, weights="placed", global_batch=B))
        (L0, L1), L = LM_TRACE_DEPTHS, arch.cfg.n_layers
        return {k: got[0][k] + (got[1][k] - got[0][k]) * (L - L0) // (L1 - L0)
                for k in ("peak_new", "alias_bytes")}
    kw = {"weights": "placed"} if arch.family in ("recsys", "gnn") else {}
    if global_batch is not None:
        kw["global_batch"] = global_batch
    got = _traced(arch, shape, mesh, **kw)
    return {k: got[k] for k in ("peak_new", "alias_bytes")}


def cell_memory(arch, shape: str, mesh, global_batch: int | None = None, cell=None) -> dict:
    """The dry run's memory record of a cell (``arch`` an id or an arch,
    ``mesh`` a ``MeshShape``, at the shape's batch or ``global_batch``):
    the argument and output bytes under its placements, the traced
    ``temp_bytes`` and ``alias_bytes``, and the peak."""
    arch = get_arch(arch) if isinstance(arch, str) else arch
    if cell is None:
        kw = {} if global_batch is None else {"global_batch": global_batch}
        cell = arch.build_cell(shape, mesh, **kw)
    arg, out = int(cell.meta["argument_bytes"]), int(cell.meta["output_bytes"])
    mem = trace_memory(arch, shape, mesh, global_batch)
    alias = mem["alias_bytes"]
    temp = mem["peak_new"] - (out - alias)
    return {"argument_bytes": arg, "output_bytes": out, "temp_bytes": temp,
            "alias_bytes": alias, "peak_device_bytes": arg + out + temp - alias}


def run_cell(arch_id: str, shape: str, mesh, *, save_dir: str | None, mesh_tag: str) -> dict:
    """Build one cell against ``mesh`` (a ``MeshShape``) and trace its
    step's memory (``cell_memory``) → its record (written to
    ``save_dir/mesh_tag`` where given)."""
    cell = get_arch(arch_id).build_cell(shape, mesh)
    n_chips = mesh_size(mesh)
    hc = cell_costs(cell)
    rec = {
        "arch": arch_id,
        "shape": shape,
        "kind": cell.kind,
        "mesh": mesh_tag,
        "n_chips": int(n_chips),
        "ok": True,
        "lower_s": None,
        "compile_s": None,
        "memory": cell_memory(arch_id, shape, mesh, cell=cell),
        "cost": {
            "device_flops": hc["flops"],
            "device_bytes": hc["bytes"],
            "xla_cost_analysis_flops_unscaled": None,
            "xla_cost_analysis_bytes_unscaled": None,
        },
        "collectives": {
            "by_op": hc["collectives_by_op"],
            "total_bytes_per_device": hc["collective_bytes"],
        },
        "roofline": roofline_terms(
            global_flops=hc["flops"] * n_chips,
            device_flops=hc["flops"],
            device_bytes=hc["bytes"],
            collective_bytes=hc["collective_bytes"],
            n_chips=n_chips,
            model_flops=cell.model_flops,
        ),
        "meta": cell.meta,
    }
    if save_dir:
        d = os.path.join(save_dir, mesh_tag)
        os.makedirs(d, exist_ok=True)
        with open(os.path.join(d, f"{arch_id}__{shape}.json"), "w") as f:
            json.dump(rec, f, indent=1)
    return rec


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="size every cell on the production meshes")
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", choices=["single", "multi", "both"], default="both")
    ap.add_argument("--out", default="experiments/dryrun")
    args = ap.parse_args(argv)

    meshes = []
    if args.mesh in ("single", "both"):
        meshes.append(("pod256", production_mesh_shape(multi_pod=False)))
    if args.mesh in ("multi", "both"):
        meshes.append(("pod512x2", production_mesh_shape(multi_pod=True)))

    arch_ids = [args.arch] if args.arch else list(PORTED_IDS)

    n_ok = n_fail = 0
    for mesh_tag, mesh in meshes:
        for arch_id in arch_ids:
            arch = get_arch(arch_id)
            shapes = [args.shape] if args.shape else list(arch.shape_names)
            for shape in shapes:
                tag = f"[{mesh_tag}] {arch_id} × {shape}"
                try:
                    rec = run_cell(arch_id, shape, mesh, save_dir=args.out, mesh_tag=mesh_tag)
                    r = rec["roofline"]
                    print(
                        f"OK  {tag:60s} mem/dev={rec['memory']['peak_device_bytes'] / 2**30:6.2f}"
                        f"GiB of {DEVICE_MEMORY_BYTES / 1e9:.0f} GB (H100) "
                        f"terms(c/m/n)=({r['compute_s']:.2e},{r['memory_s']:.2e},"
                        f"{r['collective_s']:.2e})s dominant={r['dominant']}", flush=True)
                    n_ok += 1
                except Exception as e:  # noqa: BLE001 — report and continue
                    n_fail += 1
                    print(f"FAIL {tag}: {type(e).__name__}: {e}", flush=True)
                    traceback.print_exc()
    print(f"\ndry-run complete: {n_ok} ok, {n_fail} failed")
    if n_fail:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
