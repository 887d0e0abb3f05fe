"""The GNN and RecSys families on the card: ``chip_smoke.py``'s phase 15
alone, and GAT's ``ogb_products`` train step split by destination across
cards.

    python tools/torch_family_timing.py                    # phase 15 on one card
    python tools/torch_family_timing.py --worlds nccl:4    # ogb_products and DCN-v2, four cards
    python tools/torch_family_timing.py --worlds nccl:4 --cells placed   # DCN-v2 only

Phase 15 (``chip_smoke.family_rank``, one NCCL rank): see
``chip_smoke.py``'s module docstring; it prints what the smoke prints
for it.

``--worlds nccl:N`` spawns N NCCL ranks, one a card, on a ``(1, N)``
mesh: ``get_arch("gat-cora-opt1").build_cell("ogb_products", mesh)`` at
the shape's full budgets (2,449,408 node rows, 61,865,984 edges, d_feat
100, 47 classes), the graph drawn from seed 0 on every rank (the same
bits) and split by ``partition_edges_by_dst`` (each card's edges have
their destination in its node range; ~15.5M a card). Each rank passes
its blocks; a layer all-gathers the projected rows (64 and 376 wide).
The step runs a warm-up and ``STEPS`` timed calls. Checks: every rank's
loss the same and finite, and on rank 0 the sharded loss and gradients
against the unsharded ``gat_loss`` over the whole graph on its card
(``chip_smoke``'s tolerances: ``FAM_RTOL`` for the loss; each gradient
leaf within ``FAM_REL`` of the larger of its own largest entry and
``FAM_FLOOR`` × the tree's, the output layer's ``a_dst`` within
``FAM_REL`` of the tree's largest, ``OGB_FLOOR``; or within
``ORDER_NOISE_MULT`` × the leaf's difference between the unsharded
gradients over the graph's edge order and a permuted one).
Prints the step's ms (host clock + synchronise, median), the all-gather
bytes a layer and each rank's ``max_memory_allocated``, beside the
card's name and power limit.

``--cells placed`` (with ``--worlds nccl:4``): DCN-v2's ``train_batch``
at its full 65,536 rows with ``weights="placed"`` on a ``(2, 2)`` mesh
(its table's rows over ``model``, the batch over ``data``), ``STEPS``
timed steps, and the cut check at ``PLACED_CHECK_ROWS`` rows
(``tools/torch_placed_cards.py``: the resident state against
``argument_bytes``, ``max_memory_allocated`` against the dry run's peak
of the (2, 2) mesh, loss and gradients against one process).
"""

from __future__ import annotations

import argparse
import json
import pathlib
import shutil
import statistics
import sys
import time

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tools"))

OUT_DIR = ROOT / "build" / "torch_family_timing"
#: train steps timed after a warm-up
STEPS = 5
#: a sharded gradient leaf may also differ from the unsharded one by this
#: multiple of the unsharded leaf's own difference between two edge
#: orders (the graph's and a permutation of it: the same sums in another
#: f32 order). The output layer's attention vectors sum 61.9M edge terms
#: of either sign to ~1% of the tree's largest entry: four cards put
#: a_src 1.3e-9 from one card against a floor of 3.8e-10
ORDER_NOISE_MULT = 10
#: DCN-v2 placed on four cards: the global batch, and the cut check's rows
PLACED_ROWS, PLACED_CHECK_ROWS = 65_536, 4_096


def ogb_rank(rank: int, world: int, d: str, steps: int, n_nodes: int, n_edges: int) -> None:
    """One of ``world`` ranks: ``ogb_products`` at ``opt`` 1 over a graph of
    ``n_nodes`` / ``n_edges`` (the shape's budgets on the cards; see the
    module docstring) → ``<d>/rank<r>.json``. Under NCCL a rank runs on
    its card, under gloo on the CPU (a rehearsal at a small size)."""
    import torch.distributed as dist

    import chip_smoke as cs
    from repro_torch.configs import get_arch
    from repro_torch.dist.sharding import P, shard_block
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models import gnn
    from repro_torch.train.optimizer import make_optimizer
    from repro_torch.train.train_step import value_and_grad
    from repro_torch.tree import tree_leaves_with_path

    torch.backends.cuda.matmul.allow_tf32 = False
    nccl = dist.get_backend() == "nccl"
    dev = torch.device("cuda", torch.cuda.current_device()) if nccl else torch.device("cpu")
    mesh = make_debug_mesh((1, world), ("data", "model"))
    axes = ("data", "model")
    shape = "ogb_products"
    N, E = n_nodes, n_edges
    arch = get_arch("gat-cora-opt1")
    cfg = arch._cfg(shape)
    t0 = time.perf_counter()
    g = cs._gnn_graph(shape, np.random.default_rng(0), N, E)
    esrc, edst, ep = gnn.partition_edges_by_dst(g["edge_index"], N + 1, world)
    labels = np.concatenate([g["labels"], [-1]]).astype(np.int32)
    mask = np.concatenate([g["mask"], [False]]).astype(np.float32)
    x = np.concatenate([g["x"], np.zeros((1, g["x"].shape[1]), np.float32)])
    full = {"x": x, "edge_src": esrc, "edge_dst": edst, "labels": labels, "train_mask": mask}
    batch = {k: shard_block(torch.from_numpy(v), P(axes), mesh).contiguous().to(dev)
             for k, v in full.items()}
    host_s = time.perf_counter() - t0
    params = gnn.gat_init(torch.Generator(device=dev).manual_seed(0), cfg, device=dev)
    oinit, _ = make_optimizer(arch.optimizer)
    state = {"params": params, "opt": oinit(params)}
    cell = arch.build_cell(shape, mesh)
    cs._sync(dev)
    if nccl:
        torch.cuda.reset_peak_memory_stats()
    times, losses = [], []
    for _ in range(steps + 1):  # the first is a warm-up
        dist.barrier()
        cs._sync(dev)
        t0 = time.perf_counter()
        _, metrics = cell.fn(state, batch)
        cs._sync(dev)
        times.append(1e3 * (time.perf_counter() - t0))
        losses.append(float(metrics["loss"]))
    peak = torch.cuda.max_memory_allocated() if nccl else 0
    (l_s, _), g_s = value_and_grad(
        lambda p, b: gnn.gat_loss_edge_sharded(p, cfg, b, mesh, axes), params, batch)
    rec = dict(rank=rank, world=world, step_ms=times[1:],
               step_ms_median=statistics.median(times[1:]), losses=losses,
               finite=bool(np.isfinite(losses).all()), edges_local=int(ep),
               nodes_local=int(batch["x"].shape[0]), host_s=host_s, max_memory_allocated=peak,
               gather_bytes_per_layer=[(N + 1) * cfg.n_heads * cfg.d_hidden * 4,
                                       (N + 1) * cfg.n_heads * cfg.n_classes * 4],
               collectives_by_op=cell.meta["collectives_by_op"])
    if rank == 0:  # the whole graph on this card: the unsharded loss and gradients
        del batch
        if nccl:
            torch.cuda.empty_cache()
        unsharded = {}
        for order in ("graph", "permuted"):
            ei = g["edge_index"]
            if order == "permuted":
                ei = ei[:, np.random.default_rng(1).permutation(ei.shape[1])]
            whole = cs._gnn_batch(dict(g, edge_index=ei), E, dev)
            unsharded[order] = value_and_grad(
                lambda p, b: gnn.gat_loss(p, cfg, gnn.Graph(**b)), params, whole)
            del whole
        (l_u, _), g_u = unsharded["graph"]
        g_p = dict(tree_leaves_with_path(unsharded["permuted"][1]))
        top = max(float(v.abs().max()) for _, v in tree_leaves_with_path(g_u))
        noise = {k: float((g_p[k] - v).abs().max()) for k, v in tree_leaves_with_path(g_u)}
        floors = {k: max(cs.FAM_FLOOR, ORDER_NOISE_MULT * n / (cs.FAM_REL * top))
                  for k, n in noise.items()}
        floors[cs._output_a_dst(cfg)] = max(floors[cs._output_a_dst(cfg)], cs.OGB_FLOOR)
        print(f"rank 0: the unsharded gradients' edge-order differences (tree's largest "
              f"{top:.3e}): " + ", ".join(f"{k} {v:.2e}" for k, v in noise.items()), flush=True)
        rec["loss_vs_unsharded"] = cs._close("ogb_products sharded loss vs unsharded", l_s, l_u)
        rec["grads_vs_unsharded"] = cs._trees_close(
            "ogb_products sharded gradients vs unsharded", g_s, g_u, floors)
        rec["order_noise"], rec["floors"], rec["top"] = noise, floors, top
        rec["unsharded_max_memory_allocated"] = torch.cuda.max_memory_allocated() if nccl else 0
    (pathlib.Path(d) / f"rank{rank}.json").write_text(json.dumps(rec))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--worlds", default=None,
                    help="nccl:N runs ogb_products over N cards; default: phase 15 on one card")
    ap.add_argument("--cells", default="ogb,placed",
                    help="with --worlds: ogb (ogb_products over N cards), placed (DCN-v2 "
                         "train_batch placed on a (2, 2) mesh, N = 4) or both")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_family_timing: no CUDA device available", file=sys.stderr)
        return 1
    import chip_smoke
    from repro_torch.launch.mesh import spawn_ranks

    card = chip_smoke.card_line()
    shutil.rmtree(OUT_DIR, ignore_errors=True)
    OUT_DIR.mkdir(parents=True)
    if args.worlds is None:
        spawn_s = spawn_ranks(chip_smoke.family_rank, 1, str(OUT_DIR), backend="nccl",
                              init_file=OUT_DIR / "init", timeout_s=1500)
        out = json.loads((OUT_DIR / "out.json").read_text())
        print(f"phase 15: {out['seconds']:.1f}s in the rank ({spawn_s:.1f}s with its start) "
              f"({card})")
        shutil.rmtree(OUT_DIR, ignore_errors=True)
        return 0
    backend, n = args.worlds.split(":")
    n = int(n)
    if backend != "nccl" or torch.cuda.device_count() < n:
        raise SystemExit(f"--worlds {args.worlds}: needs nccl and {n} cards "
                         f"({torch.cuda.device_count()} here)")
    ok = True
    if "placed" in args.cells.split(","):
        ok &= placed(n, card)
    if "ogb" in args.cells.split(","):
        ok &= ogb_cards(n, card)
    return 0 if ok else 1


def placed(n: int, card: str) -> bool:
    """DCN-v2 ``train_batch`` placed on a (2, 2) mesh (module docstring)."""
    import chip_smoke
    import torch_placed_cards as pc
    from repro_torch.launch.dryrun import cell_memory
    from repro_torch.launch.mesh import MeshShape, spawn_ranks

    if n != 4:
        raise SystemExit("--cells placed runs on a (2, 2) mesh: --worlds nccl:4")
    t0 = time.perf_counter()
    dry = cell_memory("dcn-v2", "train_batch", MeshShape((2, 2), ("data", "model")),
                      PLACED_ROWS)
    print(f"dry run (2, 2), dcn-v2 train_batch at {PLACED_ROWS:,} rows: traced in "
          f"{time.perf_counter() - t0:.1f}s on the host")
    shutil.rmtree(OUT_DIR, ignore_errors=True)
    OUT_DIR.mkdir(parents=True)
    spawn_s = spawn_ranks(pc.placed_rank, n, str(OUT_DIR), "dcn-v2", "train_batch",
                          PLACED_ROWS, None, STEPS, {"rows": PLACED_CHECK_ROWS}, dry,
                          backend="nccl", init_file=OUT_DIR / "init", timeout_s=1200)
    recs = [json.loads((OUT_DIR / f"rank{r}.json").read_text()) for r in range(n)]
    ok = pc.report(recs, card, chip_smoke.MEM_FACTOR)
    print(f"dcn-v2 train_batch placed on four cards: spawn {spawn_s:.1f}s; "
          f"{'ok' if ok else 'FAILED'} ({card})")
    shutil.rmtree(OUT_DIR, ignore_errors=True)
    return ok


def ogb_cards(n: int, card: str) -> bool:
    """ogb_products over ``n`` cards (module docstring)."""
    import chip_smoke
    from repro_torch.configs.base import GNN_SHAPES
    from repro_torch.launch.mesh import spawn_ranks

    shutil.rmtree(OUT_DIR, ignore_errors=True)
    OUT_DIR.mkdir(parents=True)
    sh = GNN_SHAPES["ogb_products"]
    spawn_s = spawn_ranks(ogb_rank, n, str(OUT_DIR), STEPS, sh["n_nodes"], sh["n_edges"],
                          backend="nccl", init_file=OUT_DIR / "init", timeout_s=1500)
    recs = [json.loads((OUT_DIR / f"rank{r}.json").read_text()) for r in range(n)]
    ok = all(r["finite"] and r["losses"] == recs[0]["losses"] for r in recs)
    for r in recs:
        print(f"rank {r['rank']}: {r['nodes_local']:,} node rows, {r['edges_local']:,} edges "
              f"(dst-aligned); gat-cora-opt1 ogb_products train step {r['step_ms_median']:.2f} ms "
              f"(median of {STEPS}: {[round(t, 2) for t in r['step_ms']]}), loss "
              f"{r['losses'][-1]:.6f}, all-gather a layer "
              f"{[round(b / 1e9, 3) for b in r['gather_bytes_per_layer']]} GB, "
              f"max_memory_allocated {r['max_memory_allocated'] / 2**30:.2f} GiB; host graph "
              f"{r['host_s']:.1f}s ({card})")
    r0 = recs[0]
    print(f"rank 0: the sharded loss and gradients vs the unsharded gat_loss over the whole "
          f"graph on one card: loss err {r0['loss_vs_unsharded']:.2e}, gradients "
          f"{r0['grads_vs_unsharded']:.2e} of scale (rel {chip_smoke.FAM_REL} of the tree's "
          f"largest {r0['top']:.3e} × a leaf's floor: {chip_smoke.FAM_FLOOR}, the output a_dst's "
          f"{chip_smoke.OGB_FLOOR}, or {ORDER_NOISE_MULT} × its edge-order difference; "
          f"floors {', '.join(f'{k} {v:.3g}' for k, v in r0['floors'].items())}); the unsharded "
          f"step's max_memory_allocated {r0['unsharded_max_memory_allocated'] / 2**30:.2f} GiB; "
          f"spawn {spawn_s:.1f}s; {'ok' if ok else 'FAILED'} ({card})")
    shutil.rmtree(OUT_DIR, ignore_errors=True)
    return ok


if __name__ == "__main__":
    sys.exit(main())
