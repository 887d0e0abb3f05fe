"""A train cell placed over four cards: the rank program and the report
that ``tools/torch_lm_timing.py`` and ``tools/torch_family_timing.py``
run with ``--worlds nccl:4``.

Each of the four NCCL ranks (one a card, a ``(2, 2)`` mesh over
``("data", "model")``) draws the config's whole parameters from one seed
(the same bits on every card), keeps its blocks under the cell's
placements (``arch.place``) and frees the rest, takes its block of a
global batch drawn from one seed, and then:

1. reads ``torch.cuda.memory_allocated()`` (the resident state and batch)
   against the cell's ``argument_bytes`` (held within ``RESIDENT_RTOL``);
2. runs a warm-up step and ``steps`` timed ones (host clock around a
   barrier and a synchronise), and reads ``max_memory_allocated``
   against the dry run's peak of the same mesh and batch
   (``launch.dryrun.cell_memory``, traced in the parent; held within
   ``chip_smoke.MEM_FACTOR``);
3. checks the placed program against one process at a cut size (in f32,
   TF32 off): one step of the cut cell placed over the four cards and,
   on each card, the whole-weight step over the whole check batch; the
   losses and grad norms within ``CHECK_RTOL``, each rank's block of the
   first moment (AdamW's ``m``: 0.1 × the clipped gradient) within
   ``CHECK_RTOL`` of the leaf's largest entry (``CHECK_FLOOR`` of the
   tree's where larger), every parameter block within ``CHECK_LR`` lr.

The ranks write ``<d>/rank<r>.json``; ``report`` prints them beside the
card's name and power limit and says whether every check held.
"""

from __future__ import annotations

import dataclasses
import json
import pathlib
import statistics
import time

import torch

#: resident state and batch against the cell's argument bytes
RESIDENT_RTOL = 0.01
#: the cut check (f32): losses and grad norms (relative), the first
#: moment's blocks (of each leaf's largest entry, or CHECK_FLOOR of the
#: tree's), parameters (in lr: a first AdamW step moves a weight by ±lr
#: whatever its gradient's size, so a gradient within rounding of zero
#: may step either way; the first moment holds the gradients)
CHECK_RTOL, CHECK_FLOOR, CHECK_LR = 1e-4, 1e-2, 2.0


def _device() -> torch.device:
    return torch.device("cuda", torch.cuda.current_device())


def _params(arch, cfg, dev):
    from repro_torch.models import transformer as tf

    g = torch.Generator(device=dev).manual_seed(0)
    if arch.family == "lm":
        return tf.init_params(g, cfg, device=dev)
    return arch._fns(cfg)[0](g, cfg, device=dev)


def _batch(arch, cfg, rows: int, seq: int | None, dev) -> dict:
    """A global batch drawn from one seed (the same on every card)."""
    g = torch.Generator(device=dev).manual_seed(1)
    if arch.family == "lm":
        toks = torch.randint(0, cfg.vocab, (rows, seq + 1), generator=g, device=dev,
                             dtype=torch.int32)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    import chip_smoke

    return chip_smoke._rec_batch(cfg, rows, g, dev)


def _local(cell, batch: dict, mesh) -> dict:
    from repro_torch.dist.sharding import shard_block

    return {k: shard_block(v, cell.in_shardings[1][k].spec, mesh).contiguous().clone()
            for k, v in batch.items()}


def placed_rank(rank: int, world: int, d: str, arch_id: str, shape: str, rows: int,
                seq: int | None, steps: int, check: dict, dry_run: dict) -> None:
    """One of the four ranks (module docstring). ``rows`` / ``seq``: the
    global batch (``seq`` for an LM); ``check``: the cut check's
    ``layers`` (LM), ``rows`` and ``seq``; ``dry_run``: the parent's
    ``cell_memory`` record."""
    import torch.distributed as dist

    from repro_torch.configs import get_arch
    from repro_torch.dist.sharding import shard_block
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models import transformer as tf
    from repro_torch.train.optimizer import make_optimizer
    from repro_torch.train.train_step import make_train_step
    from repro_torch.tree import tree_leaves, tree_leaves_with_path

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = _device()
    mesh = make_debug_mesh((2, world // 2), ("data", "model"))
    arch = get_arch(arch_id)
    cfg = arch.cfg
    rec = dict(rank=rank, world=world, arch=arch_id, shape=shape, rows=rows, seq=seq)
    # 1. full width: place, then time
    cell = arch.build_cell(shape, mesh, weights="placed", global_batch=rows)
    t0 = time.perf_counter()
    params = _params(arch, cfg, dev)
    state = arch.place(shape, mesh, params)
    del params
    batch = _batch(arch, cfg, rows, seq, dev)
    local = _local(cell, batch, mesh)
    del batch
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    rec["place_s"] = time.perf_counter() - t0
    rec["memory_allocated"] = torch.cuda.memory_allocated()
    rec["argument_bytes"] = cell.meta["argument_bytes"]
    torch.cuda.reset_peak_memory_stats()
    times, losses = [], []
    for _ in range(steps + 1):  # the first is a warm-up
        dist.barrier()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = cell.fn(state, local)
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
        losses.append(float(m["loss"]))
    rec.update(step_ms=times[1:], step_ms_median=statistics.median(times[1:]), losses=losses,
               grad_norm=float(m["grad_norm"]),
               max_memory_allocated=torch.cuda.max_memory_allocated(), dry_run=dry_run)
    del state, local
    torch.cuda.empty_cache()
    # 2. the cut check in f32: placed over the cards against one process
    if arch.family == "lm":
        cut = dataclasses.replace(arch, cfg=dataclasses.replace(
            cfg, n_layers=check["layers"], dtype=torch.float32), microbatches=1)
    else:
        cut = arch
    ccfg = cut.cfg
    params = _params(cut, ccfg, dev)
    batch = _batch(cut, ccfg, check["rows"], check.get("seq"), dev)
    ccell = cut.build_cell(shape, mesh, weights="placed", global_batch=check["rows"])
    placed, pm = ccell.fn(cut.place(shape, mesh, params), _local(ccell, batch, mesh))
    oinit, oupd = make_optimizer(cut.optimizer)
    if arch.family == "lm":
        loss = lambda p, b: tf.lm_loss(p, ccfg, b["tokens"], b["labels"])  # noqa: E731
    else:
        raw = cut._fns(ccfg)[1]
        loss = lambda p, b: raw(p, ccfg, b)  # noqa: E731
    whole, wm = make_train_step(loss, oupd)({"params": params, "opt": oinit(params)}, batch)
    pspecs = ccell.in_shardings[0]
    want = dict(tree_leaves_with_path(whole))
    specs = dict(tree_leaves_with_path(pspecs))
    top = max(float(t.abs().max()) for k, t in want.items() if k.startswith("['opt']['m']"))
    lr = float(wm["lr"])
    m_err, p_err = 0.0, 0.0
    for k, got in tree_leaves_with_path(placed):
        w = shard_block(want[k], specs[k].spec, mesh)
        if k.startswith("['opt']['m']"):
            scale = max(float(w.abs().max()), CHECK_FLOOR * top)
            m_err = max(m_err, float((got - w).abs().max()) / scale)
        elif k.startswith("['params']"):
            p_err = max(p_err, float((got.float() - w.float()).abs().max()) / lr)
    rec["check"] = dict(layers=check.get("layers"), rows=check["rows"], seq=check.get("seq"),
                        loss=[float(pm["loss"]), float(wm["loss"])],
                        grad_norm=[float(pm["grad_norm"]), float(wm["grad_norm"])],
                        m_err=m_err, params_err_lr=p_err,
                        n_leaves=len(tree_leaves(placed)))
    (pathlib.Path(d) / f"rank{rank}.json").write_text(json.dumps(rec))


def report(recs: list, card: str, factor: float) -> bool:
    """Print every rank's lines → whether every check held."""
    gib = 2**30
    ok = True
    for r in recs:
        dr, c = r["dry_run"], r["check"]
        resident = r["memory_allocated"] / r["argument_bytes"] - 1
        ratio = r["max_memory_allocated"] / dr["peak_device_bytes"]
        rel = [abs(a - b) / abs(b) for a, b in (c["loss"], c["grad_norm"])]
        held = (abs(resident) <= RESIDENT_RTOL and 1 / factor <= ratio <= factor
                and max(rel) <= CHECK_RTOL and c["m_err"] <= CHECK_RTOL
                and c["params_err_lr"] <= CHECK_LR and all(map(lambda x: x == x, r["losses"])))
        ok &= held
        print(f"rank {r['rank']}: {r['arch']} {r['shape']} placed on (2, 2) at {r['rows']:,} rows"
              + (f" × {r['seq']:,} tokens" if r["seq"] else "") +
              f": resident after placing {r['memory_allocated'] / gib:.3f} GiB vs the cell's "
              f"argument_bytes {r['argument_bytes'] / gib:.3f} GiB ({100 * resident:+.2f}%, "
              f"within {100 * RESIDENT_RTOL:.0f}%); a step {r['step_ms_median']:.1f} ms (median "
              f"of {len(r['step_ms'])}: {[round(t, 1) for t in r['step_ms']]}), losses "
              f"{[round(x, 4) for x in r['losses']]}; max_memory_allocated "
              f"{r['max_memory_allocated'] / gib:.2f} GiB / dry-run peak "
              f"{dr['peak_device_bytes'] / gib:.2f} GiB (arguments {dr['argument_bytes'] / gib:.2f}"
              f" + outputs {dr['output_bytes'] / gib:.2f} + temporaries "
              f"{dr['temp_bytes'] / gib:.2f} − aliased {dr['alias_bytes'] / gib:.2f}) = "
              f"{ratio:.3f} (factor {factor}); placed in {r['place_s']:.1f}s ({card})")
        print(f"    cut check (f32" + (f", {c['layers']} layers" if c["layers"] else "") +
              f", {c['rows']:,} rows" + (f" × {c['seq']} tokens" if c["seq"] else "") +
              f") placed vs one process: loss {c['loss'][0]:.6f} / {c['loss'][1]:.6f}, grad "
              f"norm {c['grad_norm'][0]:.6f} / {c['grad_norm'][1]:.6f} (rel {max(rel):.1e}, "
              f"rtol {CHECK_RTOL}); first moment {c['m_err']:.1e} of scale; parameters within "
              f"{c['params_err_lr']:.1e} lr; {c['n_leaves']} leaves; "
              f"{'ok' if held else 'FAILED'} ({card})")
    return ok
