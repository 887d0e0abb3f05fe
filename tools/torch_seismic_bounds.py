#!/usr/bin/env python
"""Count where the port's Seismic phase 1 probes other blocks than the
reference's, at the CLI's parameters, on the CPU.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/torch_seismic_bounds.py \\
        [--n-docs 8000] [--n-queries 256]

Builds one SPLADE-statistics collection (seed 0) and the port's Seismic
index at the CLI's parameters (or ``--params`` as JSON) (``cut=8``, ``block_budget=512``,
``n_probe=64``, ``n_postings=2000``, ``block_size=64``; past 4,096
documents they are not exhaustive), saves it, and opens the artifact
with the reference (``backend="jnp"``) and the port (``backend=
"torch"``). Phase 1 runs on both over the same candidate blocks: the
port's ``SeismicEngine.probe`` and the reference's ``search_one`` lines
for it, jitted and vmapped as its search runs them
(``torch_seismic_cases.reference_phase1``). Prints the queries
whose probed block sets differ, each with the gap of its swapped blocks'
bounds to the cut over the tie rule's f32 limit (``tests/
torch_seismic_cases.py``, shared with the test), how many bounds differ
in their bits, and the queries whose final top-10 ids differ. Exits non-zero when a
disagreement is not a near tie. It imports the reference (and so jax) to
compare against it.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import tempfile

import numpy as np

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(_ROOT, "tests"))  # torch_seismic_cases

PARAMS = dict(cut=8, block_budget=512, n_probe=64, n_postings=2000, block_size=64)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n-docs", type=int, default=8000)
    ap.add_argument("--n-queries", type=int, default=256)
    ap.add_argument("--chunk", type=int, default=32, help="queries a phase-1 call takes")
    ap.add_argument("--params", type=json.loads, default=PARAMS,
                    help="Seismic parameters as JSON (default: the CLI's)")
    ap.add_argument("--dim", type=int, default=30522)
    args = ap.parse_args(argv)
    params = {**PARAMS, **args.params}

    import torch
    from repro.serve.api import open_retriever as ref_open
    from repro_torch.data.synthetic import generate_collection, splade_config
    from repro_torch.serve.api import Retriever, RetrieverConfig
    from torch_seismic_cases import bound_tolerance, probe_disagreements, reference_phase1

    torch.set_num_threads(1)
    cfg_col = dataclasses.replace(splade_config(args.n_docs, args.n_queries, 0), dim=args.dim)
    col = generate_collection(cfg_col, value_format="f16")
    Q = np.stack([col.query_dense(i) for i in range(col.n_queries)])
    cfg = RetrieverConfig(engine="seismic", codec="dotvbyte", backend="torch", k=10,
                          params=params)
    port = Retriever.build(col.fwd, cfg, device="cpu")
    with tempfile.TemporaryDirectory() as tmp:
        port.save(tmp)
        ref = ref_open(tmp)
    est_r, cand_r, probe_r = reference_phase1(ref.arrays, Q, params, args.chunk)
    Qt = torch.from_numpy(Q)
    est_p, cand_p, probe_p, tol = [], [], [], []
    for i in range(0, len(Q), args.chunk):
        e, c, p = port.impl.probe(port.cfg, port.arrays, Qt[i : i + args.chunk])
        est_p.append(e.numpy())
        cand_p.append(c.numpy())
        probe_p.append(p.numpy())
        tol.append(bound_tolerance(port.arrays, Qt[i : i + args.chunk], c).numpy())
    est_p, cand_p, probe_p, tol = (np.concatenate(x) for x in (est_p, cand_p, probe_p, tol))
    if not np.array_equal(cand_p, cand_r):
        raise SystemExit("the two sides' candidate blocks differ")
    live = cand_p >= 0
    bits = int((est_p[live].view(np.uint32) != est_r[live].view(np.uint32)).sum())
    rel = np.abs(est_p[live] - est_r[live]) / np.maximum(tol[live], 1e-30)
    dis = probe_disagreements(est_p, probe_p, est_r, probe_r, cand_p, tol)
    ids_p = port.search(Q)[0].numpy()
    ids_r = np.asarray(ref.search(Q)[0])
    top_diff = int((ids_p != ids_r).any(axis=1).sum())
    summary = {
        "n_docs": args.n_docs, "dim": args.dim, "n_queries": args.n_queries, "params": params,
        "s_max": int(ref.arrays["sum_comps"].shape[1]),
        "exhaustive": bool(params["n_probe"] * params["block_size"] >= args.n_docs),
        "queries_where_the_cut_binds": int(((cand_p >= 0).sum(1) > params["n_probe"]).sum()),
        "bounds": int(live.sum()), "bounds_differing_bits": bits,
        "max_bound_diff_over_tol": float(rel.max(initial=0.0)),
        "queries_probing_other_blocks": len(dis),
        "swapped_blocks": int(sum(len(d["only_a"]) + len(d["only_b"]) for d in dis)),
        "max_gap_over_limit": max((d["max_ratio"] for d in dis), default=0.0),
        "queries_top10_ids_differ": top_diff,
    }
    for d in dis:
        print(json.dumps(d))
    print(json.dumps(summary))
    return 0 if all(d["max_ratio"] <= 1.0 for d in dis) else 1


if __name__ == "__main__":
    sys.exit(main())
