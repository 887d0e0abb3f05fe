#!/usr/bin/env python
"""Time the port's Seismic search at ``chip_smoke.py`` phase 4's shape on
one CUDA GPU: the replayed plan of a 64-query batch and phase 1
(``SeismicEngine.probe``) run eagerly.

    PYTHONPATH=src python tools/torch_seismic_timing.py --index build/seismic_timing \\
        [--n-docs 100000] [--label change]

The first run draws phase 3's collection (``splade_config(n_docs, 64,
0)``, f16 values), builds the Seismic index at phase 3's parameters
(dotvbyte rows, f16) and saves it, with the queries, under ``--index``;
later runs open that directory, so two checkouts of the port time the
same index (``PYTHONPATH=<that checkout>/src``): compare two versions
within one call on one card, in the order parent, change, change,
parent. It uses only ``Retriever``, ``open_retriever`` and the engine's
``probe``, which every checkout since the sharded tree format has.

Prints the card's name and power limit, then one JSON object: the
replayed search's host-clock time (``search`` ending in a synchronise,
median and min of 50 calls), its device time (CUDA events over 50
back-to-back calls, the mean) and phase 1's device time the same way.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import pathlib
import statistics
import subprocess
import time

import numpy as np
import torch

NQ = 64
#: phase 3's Seismic parameters (``chip_smoke.SEISMIC_PARAMS``)
SEISMIC_PARAMS = dict(cut=8, block_budget=512, n_probe=64, n_postings=2000, block_size=64)


def cuda_ms(fn, iters: int = 50, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def host_ms(fn, reps: int = 50) -> list[float]:
    out = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append(1e3 * (time.perf_counter() - t0))
    return out


def build(index: pathlib.Path, n_docs: int) -> None:
    from repro_torch.data.synthetic import generate_collection, splade_config
    from repro_torch.serve.api import Retriever, RetrieverConfig

    t0 = time.perf_counter()
    col = generate_collection(splade_config(n_docs, NQ, 0), value_format="f16")
    Q = np.stack([col.query_dense(i) for i in range(col.n_queries)])
    cfg = RetrieverConfig(engine="seismic", codec="dotvbyte", backend="cuda", k=10,
                          params=SEISMIC_PARAMS)
    Retriever.build(col.fwd, cfg).save(index / "seismic", compress=False)
    np.save(index / "queries.npy", Q)
    print(f"built {n_docs} docs and their Seismic index in {time.perf_counter() - t0:.1f}s",
          flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--index", type=pathlib.Path, required=True)
    ap.add_argument("--n-docs", type=int, default=100_000)
    ap.add_argument("--label", default="")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA GPU")
    from repro_torch.serve.api import open_retriever

    if not (args.index / "queries.npy").exists():
        args.index.mkdir(parents=True, exist_ok=True)
        build(args.index, args.n_docs)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    print(card, flush=True)
    ret = open_retriever(args.index / "seismic")
    Q = torch.from_numpy(np.load(args.index / "queries.npy")[:NQ]).cuda()
    ids, _ = ret.search(Q)  # warm-up, capture, replay
    torch.cuda.synchronize()
    lat = host_ms(lambda: ret.search(Q))
    out = {
        "label": args.label,
        "card": card,
        "n_docs": ret.n_docs,
        "nq": NQ,
        "search_replayed_host_ms_median": statistics.median(lat),
        "search_replayed_host_ms_min": min(lat),
        "search_replayed_device_ms": cuda_ms(lambda: ret.search(Q)),
        "probe_eager_device_ms": cuda_ms(lambda: ret.impl.probe(ret.cfg, ret.arrays, Q)),
        "ids_sha1": hashlib.sha1(ids.cpu().numpy().tobytes()).hexdigest()[:16],
    }
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
