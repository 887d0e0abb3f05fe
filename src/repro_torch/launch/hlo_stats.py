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
  slice for the global scan (``opt`` 0); for the LM cells the counts of
  ``lm_collectives``, from the placements ``lm_param_specs`` and
  ``kv_cache_spec`` imply (its docstring has the formula).

``HW`` holds one H100 SXM's published peaks: 989 TFLOP/s dense bf16,
3.35 TB/s HBM3, 450 GB/s NVLink each way.
"""

from __future__ import annotations

import dataclasses
import math

import torch

__all__ = ["HW", "cell_costs", "roofline_terms", "lm_collectives"]


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


def _factor(mesh, spec, axes) -> int:
    """How many ways ``spec`` splits an array over the mesh axes in ``axes``."""
    out = 1
    for e in spec:
        for a in (() if e is None else (e,) if isinstance(e, str) else e):
            if a in axes:
                out *= mesh.size(mesh.mesh_dim_names.index(a))
    return out


def _splits(spec, dim: int, axis: str) -> bool:
    e = spec[dim] if dim < len(spec) else None
    return e is not None and axis in ((e,) if isinstance(e, str) else e)


def lm_collectives(cfg, mesh, kind: str, param_specs, params, *, batch: int, seq: int,
                   microbatches: int = 1, seq_axes=(), batch_split: bool = True) -> dict:
    """The collectives an LM cell's placements imply, per device, as the
    result bytes of each op (the reference's convention) by op name.

    With ``n_d`` the data axes' size, ``n_m`` the model axis's, a pass's
    tokens ``t`` (train: ``B / n_d / microbatches · S``; prefill ``B / n_d
    · S``; decode ``B / n_d``, or ``B`` where the batch is replicated) and
    ``a`` the activations' itemsize:

    * ``all-gather`` — FSDP: every weight whose spec splits a dimension
      over the data axes is gathered over them once a pass, its result the
      weight's model shard (``numel / split_m · itemsize``); passes: train
      ``2 · microbatches`` (the forward, and its recompute in the backward
      under remat), prefill and decode 1.
    * ``all-reduce`` — TP (``n_m > 1``): one ``[t, D]`` sum (``t · D ·
      a`` bytes) over the model axis for each row-parallel product whose
      contraction splits over ``model`` a layer (``wo``; ``w_down`` or the
      experts' combine, ``moe.w_down`` split by expert; ``shared_down``)
      and for the vocab-parallel embedding lookup, each pass; a train
      step's backward adds one a layer for each column-parallel group
      whose output splits over ``model`` (q/k/v; ``w_gate``/``w_up`` or
      the experts'; the shared experts' gate/up) and one for the
      vocab-parallel head. Train, per step: the f32 gradient of every
      weight not split over the data axes, summed over them
      (``numel / split_m · 4``). Decode over a sequence split over
      ``seq_axes`` (flash decoding): one max ``[b, H]`` and two sums
      ``[b, H]``, ``[b, H, dh]`` in f32 a layer (``4 · b · H · (2 + dh)``).
    * ``reduce-scatter`` — train, per step: the f32 gradient of every
      weight split over the data axes, scattered to its shard
      (``numel / (split_d · split_m) · 4``).
    """
    from ..dist import sharding as shd
    from ..tree import tree_leaves, tree_leaves_with_path

    da = shd.data_axes(mesh)
    n_d = shd.axis_size(mesh, da) if da else 1
    n_m = shd.axis_size(mesh, "model")
    b = batch // n_d if batch_split else batch
    tokens = {"train": b // microbatches * seq, "prefill": b * seq, "decode": b}[kind]
    act = torch.empty((), dtype=cfg.dtype).element_size()
    specs = dict(tree_leaves_with_path(param_specs))
    leaves = dict(zip(specs, tree_leaves(params)))
    L = cfg.n_layers

    gather = grad_rs = grad_ar = 0.0
    for name, spec in specs.items():
        numel = math.prod(leaves[name].shape)
        f_d, f_m = _factor(mesh, spec, da), _factor(mesh, spec, ("model",))
        if f_d > 1:
            gather += numel / f_m * leaves[name].element_size()
            grad_rs += numel / (f_d * f_m) * 4
        elif n_d > 1:
            grad_ar += numel / f_m * 4

    def split(key, dim):
        return n_m > 1 and key in specs and _splits(specs[key], dim, "model")

    row = sum(split(f"['layers']{k}", 1) for k in (
        "['wo']", "['w_down']", "['moe']['w_down']", "['moe']['shared_down']"))
    col = (split("['layers']['wq']", 2) + split("['layers']['w_gate']", 2)
           + split("['layers']['moe']['w_gate']", 1) + split("['layers']['moe']['shared_gate']", 2))
    embed = split("['embed']", 0)
    head = split("['lm_head']", 1) if "['lm_head']" in specs else embed
    fwd = (L * row + embed) * tokens * cfg.d_model * act
    bwd = (L * col + head) * tokens * cfg.d_model * act

    out: dict[str, float] = {}
    if kind == "train":
        out["all-gather"] = 2 * microbatches * gather
        out["all-reduce"] = microbatches * (2 * fwd + bwd) + grad_ar
        out["reduce-scatter"] = grad_rs
    else:
        out["all-gather"] = gather
        out["all-reduce"] = fwd
    if kind == "decode" and seq_axes and shd.axis_size(mesh, seq_axes) > 1:
        out["all-reduce"] += L * 4.0 * b * cfg.n_heads * (2 + cfg.head_dim)
    return {k: float(v) for k, v in out.items() if v}
