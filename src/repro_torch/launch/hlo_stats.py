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
  ``kv_cache_spec`` imply; for the GNN cells ``gnn_collectives`` and for
  the RecSys cells ``recsys_collectives`` (each docstring has its
  formula).

``HW`` holds one H100 SXM's published peaks: 989 TFLOP/s dense bf16,
3.35 TB/s HBM3, 450 GB/s NVLink each way.
"""

from __future__ import annotations

import dataclasses
import math

import torch

__all__ = ["HW", "cell_costs", "roofline_terms", "lm_collectives", "gnn_collectives",
           "recsys_collectives"]


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


def _bytes(t, shape=None) -> float:
    return float(math.prod(t.shape if shape is None else shape) * t.element_size())


def gnn_collectives(cfg, mesh, params, batch: dict, batch_spec: dict, *,
                    edge_sharded: bool, min_side_gather: bool = False) -> dict:
    """The collectives of a GAT train cell, per device, as result bytes by
    op. With ``n`` the devices, ``n_d`` the data axes' size and ``N_pad``
    the node rows (``batch["x"]``'s):

    * ``opt`` 0 (and ``molecule``, ``minibatch_lg`` at any ``opt``): a
      rank all-gathers its blocks of the batch over the data axes
      (``n_d > 1``), so ``all-gather`` is the global bytes of every batch
      array split over them; the whole loss is taken on every rank, so the
      replicated parameters need no gradient sum.
    * edge-sharded (``opt`` ≥ 1, over every axis, ``n > 1``): a layer
      all-gathers ``[N_pad, w]`` f32 rows, ``w`` the projected width
      ``H · d`` (or, at ``min_side_gather``, the layer's input width where
      it is narrower), its result ``N_pad · w · 4`` (``all-gather``); its
      backward scatters the cotangent back to the rank's rows,
      ``N_pad / n · w · 4`` (``reduce-scatter``). ``all-reduce``: every
      parameter's f32 gradient summed over the ranks (``numel · 4``) and
      the loss's three f32 sums (12 bytes).
    """
    from ..dist import sharding as shd
    from ..tree import tree_leaves

    out: dict[str, float] = {}
    n = shd.mesh_size(mesh)
    if not edge_sharded:
        da = shd.data_axes(mesh)
        if da and shd.axis_size(mesh, da) > 1:
            out["all-gather"] = sum(_bytes(batch[k]) for k, spec in batch_spec.items()
                                    if any(e is not None for e in spec))
    elif n > 1:
        n_rows = batch["x"].shape[0]
        d_in = cfg.d_in
        gather = scatter = 0.0
        for l in range(cfg.n_layers):
            last = l == cfg.n_layers - 1
            wide = cfg.n_heads * (cfg.n_classes if last else cfg.d_hidden)
            w = d_in if min_side_gather and d_in < wide else wide
            gather += n_rows * w * 4.0
            scatter += n_rows // n * w * 4.0
            d_in = wide if not last else cfg.n_classes
        out["all-gather"] = gather
        out["reduce-scatter"] = scatter
        out["all-reduce"] = sum(4.0 * math.prod(p.shape) for p in tree_leaves(params)) + 12.0
    return {k: float(v) for k, v in out.items() if v}


def _recsys_lookups(cfg, shape: str, kind: str) -> list[tuple[str, int, int]]:
    """The rows a RecSys step gathers from each table: (table leaf name,
    rows a batch row (or candidate), elements a row)."""
    m = cfg.name
    if m in ("deepfm", "dcn-v2"):
        out = [("['embed']", cfg.n_fields, cfg.embed_dim)]
        if m == "deepfm":
            out.append(("['linear']", cfg.n_fields, 1))
        return out
    D, S = cfg.embed_dim, cfg.seq_len
    if m == "sasrec":
        if shape == "retrieval_cand":
            return [("['item_embed']", 1, D)]
        if kind == "train":
            return [("['item_embed']", S * (2 + cfg.n_negatives), D)]
        return [("['item_embed']", S, D)]
    return [("['item_embed']", S + 2, D)]  # din: history, target, the history's bag


def recsys_collectives(cfg, mesh, shape: str, kind: str, param_specs, params, *,
                       rows: int) -> dict:
    """The collectives a RecSys cell's placements imply, per device, as
    result bytes by op. With ``n_d`` the data axes' size, ``n_m`` the model
    axis's and ``b`` the rows a device takes (train and serve: ``rows /
    n_d``; ``retrieval_cand``: ``rows / (n_d · n_m)`` candidates):

    * ``all-reduce`` — a lookup in a table row-split over ``model``
      (``n_m > 1``) gives each device the rows it holds and zeros
      elsewhere, summed over ``model``: ``b`` × the rows a batch row
      gathers × the row's elements × 4 (DeepFM: its F embedding rows and
      F first-order terms; DCN-v2: F rows; SASRec: S sequence, S
      positive and S · K negative rows in training, S to serve, and at
      ``retrieval_cand`` one row a candidate plus the user's S once;
      DIN: S history rows, the target and the history's bag sum). The
      backward scatters into the device's own rows: no collective. A
      train step adds every parameter's f32 gradient averaged over the
      data axes (``n_d > 1``): ``numel / split_m · 4``.
    """
    from ..dist import sharding as shd
    from ..tree import tree_leaves, tree_leaves_with_path

    da = shd.data_axes(mesh)
    n_d = shd.axis_size(mesh, da) if da else 1
    n_m = shd.axis_size(mesh, "model")
    specs = dict(tree_leaves_with_path(param_specs))
    leaves = dict(zip(specs, tree_leaves(params)))
    b = rows // (n_d * n_m) if shape == "retrieval_cand" else rows // n_d
    total = 0.0
    for name, per_row, width in _recsys_lookups(cfg, shape, kind):
        if _factor(mesh, specs[name], ("model",)) > 1:
            total += b * per_row * width * leaves[name].element_size()
            if cfg.name == "sasrec" and shape == "retrieval_cand":
                total += cfg.seq_len * width * leaves[name].element_size()
    if kind == "train" and n_d > 1:
        total += sum(math.prod(leaves[k].shape) / _factor(mesh, s, ("model",)) * 4
                     for k, s in specs.items())
    return {"all-reduce": float(total)} if total else {}
