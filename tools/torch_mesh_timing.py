#!/usr/bin/env python
"""Time the parts of the port's mesh collectives on one CUDA GPU: where
the time of ``chip_smoke.py`` phase 12's all-gather and compressed step
goes when its ranks share the card.

    PYTHONPATH=src python tools/torch_mesh_timing.py [--worlds nccl:1,gloo:4] [--out FILE]

Each world of ``--worlds`` runs in turn, ``backend:ranks``: NCCL ranks
one card each (``nccl:4`` on a four-card machine), gloo ranks all on
``cuda:0`` (spawned by ``launch.mesh.spawn_ranks``, one torch thread
each). Every rank times, median of ``REPS`` host-clock calls, all ranks
in step:

* ``gather_host``: gloo's ``all_gather`` of a search's ``[64, 10]`` i32
  ids and f32 scores held on the host (no device);
* ``gather_card``: the same pair on the card through
  ``dist.sharding.all_gather`` (under gloo: a device → host copy, the
  gather, a host → device copy, as the serving path runs it);
* ``d2h``: the device → host copy of the pair alone;
* ``tiny_kernel``: one elementwise kernel on a ``[64, 10]`` tensor and a
  synchronise;
* ``compressed_mean``: ``compressed_psum_mean`` over random gradients
  with the 40,897,850-parameter encoder's leaf shapes, and its parts:
  ``quantize`` (every leaf's int8 codes), ``gather_int8`` (the codes'
  and scales' all-gather, 41 MB a rank);
* at two ranks or more, ``search_mesh`` and ``search_rotation``: a
  flat ``ShardedRetriever`` (dotvbyte, backend cuda, one shard a rank)
  over ``--n-docs`` random SPLADE-like documents
  (``torch_rows_timing.collection``), 64 queries, searched with
  ``use_mesh=True`` and with ``use_mesh=False`` (every shard in turn on
  the rank's own card); the two answers must be equal bit for bit.

Prints one JSON object per world and the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import statistics
import shutil
import subprocess
import sys
import time

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

REPS = 20
MEAN_REPS = 5


def _ms(fn, reps: int) -> float:
    """Median host ms of ``fn`` (ending in a device synchronise), after
    one call, every rank entering each call together (a barrier)."""
    import torch.distributed as dist

    fn()
    out = []
    for _ in range(reps):
        dist.barrier()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(out)


def rank_main(rank: int, world: int, out_dir: str, tree: str | None) -> None:
    import torch.distributed as dist

    from repro_torch.dist.compression import compressed_psum_mean, quantize_int8
    from repro_torch.dist.sharding import all_gather, group_all_gather
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models.sparse_encoder import SparseEncoderConfig, encoder_init
    from repro_torch.tree import tree_leaves, tree_map

    torch.set_num_threads(1)
    dev = torch.device("cuda")
    mesh = make_debug_mesh((world,), ("data",))
    ids, scores = (torch.zeros((64, 10), dtype=t, device=dev)
                   for t in (torch.int32, torch.float32))
    ids_h, scores_h = ids.cpu(), scores.cpu()
    out = {"backend": dist.get_backend()}
    if out["backend"] == "gloo":
        out["gather_host"] = _ms(lambda: (all_gather(ids_h, mesh, "data"),
                                          all_gather(scores_h, mesh, "data")), REPS)
    out["gather_card"] = _ms(lambda: (all_gather(ids, mesh, "data"),
                                      all_gather(scores, mesh, "data")), REPS)
    out["d2h"] = _ms(lambda: (ids.cpu(), scores.cpu()), REPS)
    out["tiny_kernel"] = _ms(lambda: scores.add_(1.0), REPS)
    gen = torch.Generator(device=dev).manual_seed(rank)
    shapes = tree_map(lambda p: p.shape, encoder_init(torch.Generator().manual_seed(0),
                                                      SparseEncoderConfig(), device="cpu"))
    grads = tree_map(lambda s: torch.randn(s, generator=gen, device=dev), shapes)
    residual = tree_map(lambda g: torch.zeros_like(g), grads)
    group = mesh.get_group("data")
    codes = torch.cat([quantize_int8(g)[0].reshape(-1) for g in tree_leaves(grads)])
    scales = torch.stack([quantize_int8(g)[1] for g in tree_leaves(grads)])
    out["params"] = int(codes.numel())
    out["quantize"] = _ms(lambda: [quantize_int8(g) for g in tree_leaves(grads)], MEAN_REPS)
    out["gather_int8"] = _ms(lambda: (group_all_gather(codes, group),
                                      group_all_gather(scales, group)), MEAN_REPS)
    out["compressed_mean"] = _ms(lambda: compressed_psum_mean(grads, residual, group), MEAN_REPS)
    del grads, residual, codes
    if tree is not None:
        import numpy as np

        from repro_torch.serve.api import open_retriever

        Q = torch.from_numpy(np.load(pathlib.Path(tree) / "queries.npy")).to(dev)
        r = open_retriever(tree, device=dev)
        r.use_mesh = False
        want = r.search(Q)
        out["search_rotation"] = _ms(lambda: r.search(Q), REPS)
        r.use_mesh = True
        got = r.search(Q)
        if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
            raise SystemExit(f"rank {rank}: the mesh's answer differs from the rotation's")
        out["search_mesh"] = _ms(lambda: r.search(Q), REPS)
    (pathlib.Path(out_dir) / f"rank{rank}.json").write_text(json.dumps(out))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--worlds", default="nccl:1,gloo:4",
                    help="backend:ranks pairs, comma-separated (NCCL: a card a rank; gloo: "
                         "every rank on cuda:0)")
    ap.add_argument("--n-docs", type=int, default=100_000,
                    help="documents of the sharded flat tree the search part serves")
    ap.add_argument("--out", default=None, help="also write the JSON lines to this file")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_mesh_timing: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.launch.mesh import spawn_ranks

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    import numpy as np

    from repro_torch.serve.api import Retriever, RetrieverConfig
    from torch_rows_timing import collection, queries

    rng = np.random.default_rng(0)
    fwd = collection(args.n_docs, rng)
    Q = queries(64, rng)
    lines = []
    for spec in args.worlds.split(","):
        backend, world = spec.split(":")[0], int(spec.split(":")[1])
        d = ROOT / "build" / "mesh_timing" / f"{backend}{world}"
        shutil.rmtree(d, ignore_errors=True)
        d.mkdir(parents=True)
        tree = None
        if world > 1:
            tree = d / "tree"
            Retriever.build(fwd, RetrieverConfig(engine="flat", codec="dotvbyte", backend="cuda",
                                                 k=10, n_shards=world)).save(tree)
            np.save(tree / "queries.npy", Q)
        spawn_ranks(rank_main, world, str(d), None if tree is None else str(tree),
                    backend=backend, init_file=d / "init", timeout_s=600)
        ranks = [json.loads((d / f"rank{r}.json").read_text()) for r in range(world)]
        shutil.rmtree(d, ignore_errors=True)
        lines.append(json.dumps({"backend": backend, "world": world, "card": card,
                                 "ranks": ranks}))
    for ln in lines:
        print(ln)
    print(card)
    if args.out:
        pathlib.Path(args.out).write_text("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
