"""Serving launcher: build (or load) an index over a synthetic
MsMarco-like collection and serve batched queries through the port's
``Retriever`` — the subset of ``repro/launch/serve.py`` the main path
needs.

    python -m repro_torch.launch.serve --engine seismic --codec dotvbyte \\
        --n-docs 20000 --n-queries 64

builds the collection and the index on the host, moves the arrays to
the device (``cuda`` unless ``--device cpu``), runs one warm-up and one
timed batched search, and prints recall@k against the exact top-k, the
latency per query and the paper's space metric: the components' bits
per component under the codec, against 16 for raw u16.
``--compare-codecs`` sweeps every registered row codec over ONE host
index (the Seismic or HNSW build is the slow part; it is built once).
``--engine hnsw`` takes the reference CLI's graph parameters (``m=16``,
``ef_construction=48``, 8 seeds) with ``--beam`` and ``--iters``.
``--save-index DIR`` writes each artifact under ``DIR/<engine>-<codec>/``
(the reference's format) with this run's top-k; ``--load-index DIR``
serves from them instead of building and checks each reopened index
returns the same top-k.
"""

from __future__ import annotations

import argparse
import pathlib
import time

import numpy as np
import torch


def _device_name(device: torch.device) -> str:
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return "CPU"


def _report(name, codec, backend, k, recs, dt_us, fwd, device, extra=""):
    """One result line: recall, latency and bits per component (the
    reference's ``launch/serve.py::_report``)."""
    comp_bytes = fwd.storage_bytes(codec)["components"]
    raw_bytes = fwd.storage_bytes("uncompressed")["components"]
    print(
        f"{name:8s} codec={codec:13s} backend={backend} "
        f"recall@{k}={np.mean(recs):.3f} "
        f"latency={dt_us:7.0f}µs/q ({_device_name(device)}) "
        f"components={comp_bytes / 2**20:.1f}MiB "
        f"({8 * comp_bytes / max(fwd.total_nnz, 1):.1f} bits/comp vs 16.0 raw, "
        f"{100 * (1 - comp_bytes / max(raw_bytes, 1)):.0f}% saved){extra}"
    )


def main(argv=None) -> None:
    from ..core.layout import available_layouts
    from ..kernels.modes import BACKENDS

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--engine", choices=["seismic", "hnsw", "flat"], default="seismic")
    ap.add_argument("--codec", choices=available_layouts(), default="dotvbyte")
    ap.add_argument("--compare-codecs", action="store_true",
                    help="sweep every registered serving codec over the same index")
    ap.add_argument("--backend", choices=list(BACKENDS), default=None,
                    help="rescoring path: the CUDA kernel or plain torch; "
                         "default cuda, or the artifact's under --load-index")
    ap.add_argument("--device", default=None,
                    help="torch device; default cuda (no GPU: pass cpu)")
    ap.add_argument("--n-docs", type=int, default=20000)
    ap.add_argument("--n-queries", type=int, default=64)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--cut", type=int, default=8)
    ap.add_argument("--n-probe", type=int, default=64)
    ap.add_argument("--beam", type=int, default=64, help="HNSW beam width (static ef)")
    ap.add_argument("--iters", type=int, default=64, help="HNSW nodes expanded per query")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--save-index", metavar="DIR", default=None,
                    help="save the built artifact under DIR/<engine>-<codec>/")
    ap.add_argument("--load-index", metavar="DIR", default=None,
                    help="serve from the artifact under DIR instead of building")
    args = ap.parse_args(argv)
    if args.save_index and args.load_index:
        ap.error("--save-index and --load-index are mutually exclusive")

    from .. import resolve_device
    from ..core.seismic import exact_top_k, recall_at_k
    from ..data.synthetic import generate_collection, splade_config
    from ..serve.api import Retriever, RetrieverConfig, get_engine, open_retriever

    device = resolve_device(args.device)
    print(f"generating {args.n_docs}-doc synthetic splade collection…")
    col = generate_collection(splade_config(args.n_docs, args.n_queries, args.seed),
                              value_format="f16")
    print(f"(nnz/doc={col.fwd.total_nnz / col.fwd.n_docs:.0f})")
    Q = np.stack([col.query_dense(i) for i in range(col.n_queries)])
    truth = [exact_top_k(col.fwd, Q[i], args.k)[0] for i in range(col.n_queries)]
    codecs = available_layouts() if args.compare_codecs else [args.codec]

    params = {
        "seismic": dict(cut=args.cut, block_budget=512, n_probe=args.n_probe,
                        n_postings=2000, block_size=64),
        "hnsw": dict(beam=args.beam, iters=args.iters, n_seeds=8, m=16, ef_construction=48),
        "flat": {},
    }[args.engine]
    impl = get_engine(args.engine)
    host_index = None
    if not args.load_index and hasattr(impl, "host_index"):
        # one host index; every codec packs its rows over it
        t0 = time.perf_counter()
        host_index = impl.host_index(col.fwd, RetrieverConfig(engine=args.engine, params=params))
        print(f"{args.engine}: host index built in {time.perf_counter() - t0:.1f}s")

    for codec in codecs:
        cfg = RetrieverConfig(engine=args.engine, codec=codec, k=args.k,
                              backend=args.backend or "cuda", params=params)
        art = pathlib.Path(args.load_index or args.save_index or ".") / f"{args.engine}-{codec}"
        if args.load_index:
            retriever = open_retriever(art, device=device)
            if args.backend and args.backend != retriever.cfg.backend:
                retriever = Retriever(
                    retriever.cfg.replace(backend=args.backend), retriever.arrays,
                    n_docs=retriever.n_docs, dim=retriever.dim,
                    value_scale=retriever.value_scale,
                    value_format=retriever.value_format, device=device,
                )
        elif host_index is not None:
            retriever = Retriever.from_host_index(host_index, cfg, device=device)
        else:
            retriever = Retriever.build(col.fwd, cfg, device=device)

        retriever.search(Q)  # warm-up: kernel build and first launches
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        ids, scores = retriever.search(Q)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        dt = time.perf_counter() - t0
        ids, scores = ids.cpu().numpy(), scores.cpu().numpy()

        recs = [recall_at_k(truth[i], ids[i]) for i in range(col.n_queries)]
        extra = ""
        if args.save_index:
            retriever.save(art)
            np.savez(art / "topk.npz", ids=ids, scores=scores)
            extra = f" saved→{art}"
        if args.load_index and (art / "topk.npz").is_file():
            with np.load(art / "topk.npz") as npz:
                if not np.array_equal(npz["ids"], ids):
                    raise SystemExit(f"{art}: reopened top-k ids differ from the build-time run")
                if not np.allclose(npz["scores"], scores, rtol=1e-5, atol=1e-6):
                    raise SystemExit(f"{art}: reopened top-k scores differ from the build-time run")
            extra = " roundtrip=ids-identical"
        _report(args.engine, codec, retriever.cfg.backend, args.k, recs,
                1e6 * dt / col.n_queries, col.fwd, device, extra)


if __name__ == "__main__":
    main()
