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
their sum as the peak (nothing temporary is counted), the useful flops
split evenly, and the collectives' bytes. The XLA-only keys
(``lower_s``, ``compile_s``, ``temp_bytes``, ``alias_bytes``,
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
import json
import os
import traceback

from ..configs import PORTED_IDS, get_arch
from ..dist.sharding import mesh_size
from .hlo_stats import cell_costs, roofline_terms
from .mesh import production_mesh_shape

__all__ = ["run_cell", "main", "DEVICE_MEMORY_BYTES"]

#: one H100's device memory (80 GB)
DEVICE_MEMORY_BYTES = 80e9


def run_cell(arch_id: str, shape: str, mesh, *, save_dir: str | None, mesh_tag: str) -> dict:
    """Build one cell against ``mesh`` (a ``MeshShape``) → its record
    (written to ``save_dir/mesh_tag`` where given)."""
    cell = get_arch(arch_id).build_cell(shape, mesh)
    n_chips = mesh_size(mesh)
    hc = cell_costs(cell)
    arg, out = int(cell.meta["argument_bytes"]), int(cell.meta["output_bytes"])
    rec = {
        "arch": arch_id,
        "shape": shape,
        "kind": cell.kind,
        "mesh": mesh_tag,
        "n_chips": int(n_chips),
        "ok": True,
        "lower_s": None,
        "compile_s": None,
        "memory": {
            "argument_bytes": arg,
            "output_bytes": out,
            "temp_bytes": None,
            "alias_bytes": None,
            "peak_device_bytes": arg + out,
        },
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
