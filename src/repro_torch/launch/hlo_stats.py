"""Roofline terms of a dry-run cell — the port of
``repro/launch/hlo_stats.py``'s ``HW`` and ``roofline_terms``.

The reference counts a cell's device flops, device bytes and collective
bytes from the partitioned HLO text XLA compiles (``count_hlo_costs``,
``parse_collectives``). The port never has HLO: each cell counts its own
work, per device, into ``Cell.meta`` (``configs/retrieval.py``), and
``cell_costs`` reads it in the shape ``count_hlo_costs`` returns:

* ``bytes``: every input the device holds read once and every output it
  holds written once (``argument_bytes + output_bytes``, each from its
  placement's per-device shape);
* ``flops``: ``model_flops / n_chips`` (the useful work, split evenly);
* ``collective_bytes``: the result bytes of the cell's collectives per
  device, the reference's convention — the all-gather of each device's
  ``[nq_local, k]`` ids and scores over the index axis for
  ``serve_4096q`` and ``graph_4096q``; 0 for the doc-aligned scan; the
  reduce-scatter of the ``[nq, n_docs]`` partial scores to each device's
  slice for the global scan (``opt`` 0).

``HW`` holds one H100 SXM's published peaks: 989 TFLOP/s dense bf16,
3.35 TB/s HBM3, 450 GB/s NVLink each way.
"""

from __future__ import annotations

import dataclasses

__all__ = ["HW", "cell_costs", "roofline_terms"]


@dataclasses.dataclass(frozen=True)
class HW:
    peak_flops: float = 989e12  # dense bf16 / device
    hbm_bw: float = 3.35e12  # bytes/s / device
    ici_bw: float = 450e9  # NVLink bytes/s / device, each way


def cell_costs(cell) -> dict:
    """A cell's per-device counts → ``{"flops", "bytes",
    "collective_bytes", "collectives_by_op"}``, the keys of the
    reference's ``count_hlo_costs``."""
    m = cell.meta
    return {
        "flops": float(m["device_flops"]),
        "bytes": float(m["device_bytes"]),
        "collective_bytes": float(m["collective_bytes"]),
        "collectives_by_op": dict(m["collectives_by_op"]),
    }


def roofline_terms(
    *,
    global_flops: float,
    device_flops: float,
    device_bytes: float,
    collective_bytes: float,
    n_chips: int,
    model_flops: float,
    hw: HW = HW(),
) -> dict:
    """The three roofline terms (seconds) and what derives from them."""
    compute_s = device_flops / hw.peak_flops
    memory_s = device_bytes / hw.hbm_bw
    collective_s = collective_bytes / hw.ici_bw
    dominant = max(
        ("compute", compute_s), ("memory", memory_s), ("collective", collective_s),
        key=lambda kv: kv[1],
    )[0]
    bound = max(compute_s, memory_s, collective_s)
    useful = model_flops / max(global_flops, 1.0)
    return {
        "compute_s": compute_s,
        "memory_s": memory_s,
        "collective_s": collective_s,
        "dominant": dominant,
        "step_lower_bound_s": bound,
        "model_flops": model_flops,
        "hlo_flops_global": global_flops,
        "useful_flops_ratio": useful,
        "roofline_fraction": compute_s / bound if bound > 0 else 0.0,
        "mfu_upper_bound": (model_flops / n_chips / hw.peak_flops) / bound if bound > 0 else 0.0,
    }
