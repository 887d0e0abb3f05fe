#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (``src/repro_torch/``) on one
NVIDIA GPU — the quickest proof that the port still starts on the card.

    python3 chip_smoke.py            # from the repository root

Phases; any failure exits non-zero and prints no result:

1. device and build — the card's name and power limit; every CUDA kernel
   of the port built from ``src/repro_torch/kernels/csrc`` (one ``nvcc``
   per source, started together), with ptxas' register/spill report;
2. kernel vs plain — the rows kernel against its plain torch version on
   the card at real widths (dim 30522, C = 4096, nq = 64), in both
   candidate-set forms (shared ``nd = 1`` and per-query ``nd = nq``),
   with sentinel, empty and full-capacity rows;
3. main path — a SPLADE-statistics collection (``--n-docs``, default
   100,000 of MsMarco's 8,842,240, seed 0; 64 queries) → Seismic over
   DotVByte rows with ``backend="cuda"`` built, saved, reopened with
   ``open_retriever`` and searched, and the flat engine built and
   searched, with the kernels' launch counts zeroed just before and read
   just after;
4. checks and timings — Seismic ids equal to ``backend="torch"`` on the
   card, flat ids equal to ``exact_top_k``, recall@10, search latency
   (host clock around ``torch.cuda.synchronize()``, after a warm-up),
   and each kernel's time (CUDA events) beside its plain version and its
   bound at the main path's shapes;
5. one JSON line of kernels, the card line, and as the last line
   ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import shutil
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

#: H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, f32 (non-tensor) FLOP/s
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
#: kernel vs plain: f32 sums of the same products in another order
RTOL = ATOL = 1e-3

#: queries per search batch; candidates per query at the Seismic shape
N_QUERIES = 64
SEISMIC_PARAMS = dict(cut=8, block_budget=512, n_probe=64, n_postings=2000, block_size=64)


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def host_ms(fn, reps: int) -> list[float]:
    """Host-clock time of ``fn`` (ending in a device synchronise), per call."""
    out = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append(1e3 * (time.perf_counter() - t0))
    return out


def device_breakdown(name: str, fn, card: str, reps: int = 5) -> None:
    """Print one search's device busy time, idle share and top kernels,
    from ``torch.profiler`` over ``reps`` warm calls."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0) / reps
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = {e.key: e.self_device_time_total / 1e3 / reps for e in kernels}
    total = sum(busy.values())
    if total <= 0:
        log(f"    profile {name}: device time not measured (no device events traced)")
        return
    log(f"    profile {name}: wall {wall_ms:.3f} ms/search, device busy {total:.3f} ms "
        f"(idle share {1 - total / wall_ms:.2f}) ({card}); top kernels:")
    for key, ms in sorted(busy.items(), key=lambda kv: -kv[1])[:6]:
        log(f"      {ms:8.4f} ms {100 * ms / total:5.1f}%  {key[:90]}")


def rows_streams(arrays) -> list[torch.Tensor]:
    return [arrays[k] for k in ("vals_rows", "nnz_rows", "ctrl_rows", "data_rows")]


def rows_bound(Q, docs, arrays) -> tuple[float, str]:
    """Least time for one rows call on these inputs: each input byte read
    once — the distinct candidate rows' tight ctrl bytes (ceil(nnz/8)),
    used data bytes, 2·nnz value bytes and 4 nnz bytes, Q, the ids — and
    the nq×C f32 scores written once; against one multiply-add (2 FLOP)
    per (query, live entry) at the f32 peak."""
    nq, dim = Q.shape
    nd, C = docs.shape
    rows = torch.unique(docs).long()
    L = arrays["vals_rows"].shape[1]
    nnz = arrays["nnz_rows"][rows].long()
    ctrl = arrays["ctrl_rows"][rows, : L // 8].to(torch.int32)
    bits = (ctrl.unsqueeze(-1) >> torch.arange(8, device=ctrl.device, dtype=torch.int32)) & 1
    live = torch.arange(L, device=nnz.device) < nnz.unsqueeze(-1)
    data_bytes = int(((1 + bits.flatten(-2)) * live).sum())
    row_bytes = int(((nnz + 7) // 8).sum()) + data_bytes + 2 * int(nnz.sum()) + 4 * len(rows)
    n_bytes = row_bytes + 4 * nq * dim + 4 * nd * C + 4 * nq * C
    pairs = int(arrays["nnz_rows"][docs.long()].long().sum()) * (nq if nd == 1 else 1)
    t_bytes = 1e3 * n_bytes / HBM_BYTES_PER_S
    t_ops = 1e3 * 2 * pairs / F32_FLOP_PER_S
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def edge_rows(dim: int, L: int, n_docs: int, rng):
    """Packed dotvbyte rows of empty, full-capacity (L entries),
    all-1-byte-gap and random documents."""
    from repro_torch.core.forward_index import ForwardIndex
    from repro_torch.core.layout import pack_rows

    docs = []
    for i in range(n_docs):
        kind = i % 6
        if kind == 0:
            comps = np.zeros(0, np.int64)
        elif kind == 1:
            comps = np.sort(rng.choice(dim, size=L, replace=False))
        elif kind == 2:
            comps = 1000 + 3 * np.arange(int(rng.integers(1, L)))
        else:
            comps = np.sort(rng.choice(dim, size=int(rng.integers(1, L)), replace=False))
        docs.append((comps, rng.gamma(2.0, 0.5, size=len(comps)).astype(np.float32)))
    rows = pack_rows(ForwardIndex.from_docs(docs, dim, value_format="f16"), codec="dotvbyte")
    assert rows.l_max == L, rows.l_max
    return rows


def sparse_queries(nq: int, dim: int, nnz: int, rng) -> np.ndarray:
    Q = np.zeros((nq, dim), np.float32)
    for i in range(nq):
        Q[i, rng.choice(dim, size=nnz, replace=False)] = rng.gamma(2.0, 0.5, size=nnz)
    return Q


def check_kernel(name, Q, docs, arrays, scale=1.0) -> float:
    """Kernel vs plain on the card at one shape → max abs difference."""
    from repro_torch.kernels import rows_dot

    got = rows_dot.rows_scores(Q, docs, *rows_streams(arrays), scale)
    want = rows_dot.rows_scores_plain(Q, docs, *rows_streams(arrays), scale)
    torch.cuda.synchronize()
    err = float((got - want).abs().max()) if got.numel() else 0.0
    ok = torch.allclose(got, want, rtol=RTOL, atol=ATOL)
    log(f"  {name}: nq={Q.shape[0]} nd={docs.shape[0]} C={docs.shape[1]} "
        f"max_abs_err={err:.3e} (rtol={RTOL}, atol={ATOL}) {'ok' if ok else 'MISMATCH'}")
    if not ok:
        raise SystemExit(f"rows kernel disagrees with its plain version at {name}")
    return err


def main() -> int:
    ap = argparse.ArgumentParser(description="smoke run of the port on one GPU")
    ap.add_argument("--n-docs", type=int, default=100_000,
                    help="collection size (MsMarco has 8,842,240; the host build bounds it)")
    args = ap.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    # no matmul is on this path; full f32 stated all the same
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from repro_torch.core.seismic import exact_top_k, recall_at_k
    from repro_torch.data.synthetic import generate_collection, splade_config
    from repro_torch.kernels import build, rows_dot
    from repro_torch.serve.api import Retriever, RetrieverConfig, get_engine, open_retriever

    dev = torch.device("cuda")
    t_start = time.perf_counter()
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    log(f"[1] device: {kind} (count={torch.cuda.device_count()}); nvidia-smi: {card}")
    log(f"    torch {torch.__version__} cuda {torch.version.cuda}")

    # -- 1. build every kernel, in parallel --------------------------------
    t0 = time.perf_counter()
    built = build.compile_kernels(build.SOURCES)
    log(f"    built {sorted(built)} in {time.perf_counter() - t0:.2f}s")
    for name, info in built.items():
        for line in (info["log"] or "").splitlines():
            if "Used" in line or "spill" in line:
                log(f"    {name}: {line.strip()}")

    # -- 2. kernel vs plain at real widths -----------------------------------
    rng = np.random.default_rng(0)
    dim, nq, C = 30522, N_QUERIES, 4096
    edge = edge_rows(dim, 256, 3000, rng)
    e_arrays = {k: torch.from_numpy(v).to(dev) for k, v in edge.arrays().items()}
    Qe = torch.from_numpy(sparse_queries(nq, dim, 43, rng)).to(dev)
    n_e = edge.n_docs
    ids = rng.integers(0, n_e + 1, size=(nq, C)).astype(np.int32)
    ids[:, :4] = [n_e, 0, 1, 2]  # sentinel, empty, full capacity, 1-byte gaps
    ids = torch.from_numpy(ids).to(dev)
    log(f"[2] rows kernel vs plain on edge rows (L={edge.l_max}, N={n_e}):")
    max_err = max(
        check_kernel("shared set", Qe, ids[:1].contiguous(), e_arrays),
        check_kernel("per-query sets", Qe, ids, e_arrays),
    )

    # -- 3. the main path -----------------------------------------------------
    t0 = time.perf_counter()
    col = generate_collection(splade_config(args.n_docs, nq, 0), value_format="f16")
    fwd = col.fwd
    Q_np = np.stack([col.query_dense(i) for i in range(col.n_queries)])
    log(f"[3] generated {fwd.n_docs} docs (nnz/doc={fwd.total_nnz / fwd.n_docs:.1f}, "
        f"dim={fwd.dim}) + {nq} queries in {time.perf_counter() - t0:.1f}s")
    cfg_s = RetrieverConfig(engine="seismic", codec="dotvbyte", backend="cuda",
                            k=10, params=SEISMIC_PARAMS)
    cfg_f = RetrieverConfig(engine="flat", codec="dotvbyte", backend="cuda", k=10)
    rows_dot.launches = 0  # counts the main path's launches only
    t0 = time.perf_counter()
    built_s = Retriever.build(fwd, cfg_s)
    log(f"    Retriever.build(seismic, dotvbyte) in {time.perf_counter() - t0:.1f}s; "
        f"arrays: " + ", ".join(f"{k}{list(v.shape)}" for k, v in built_s.arrays.items()))
    art = ROOT / "build" / "chip_smoke" / "seismic-dotvbyte"
    t0 = time.perf_counter()
    built_s.save(art, compress=False)
    del built_s
    seismic = open_retriever(art)
    log(f"    save + open_retriever in {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    flat = Retriever.build(fwd, cfg_f)
    log(f"    Retriever.build(flat, dotvbyte) in {time.perf_counter() - t0:.1f}s")
    Q = torch.from_numpy(Q_np).to(dev)
    torch.cuda.synchronize()

    ids_s, sc_s = seismic.search(Q)
    torch.cuda.synchronize()
    launches_s = rows_dot.launches
    ids_f, sc_f = flat.search(Q)
    torch.cuda.synchronize()
    launches_f = rows_dot.launches - launches_s
    log(f"    main path launches: rows_dot seismic={launches_s} flat={launches_f}")
    if launches_s <= 0 or launches_f <= 0:
        raise SystemExit("the main path did not launch the rows kernel")

    # -- 4. checks ------------------------------------------------------------
    t0 = time.perf_counter()
    truth = [exact_top_k(fwd, Q_np[i], 10) for i in range(nq)]
    log(f"[4] exact top-10 of {nq} queries in {time.perf_counter() - t0:.1f}s")
    seismic_t = Retriever(cfg_s.replace(backend="torch"), seismic.arrays,
                          n_docs=seismic.n_docs, dim=seismic.dim,
                          value_scale=seismic.value_scale,
                          value_format=seismic.value_format)
    ids_t, sc_t = seismic_t.search(Q)
    if not torch.equal(ids_s, ids_t):
        raise SystemExit("Seismic ids differ between backend=cuda and backend=torch")
    torch.testing.assert_close(sc_s, sc_t, rtol=1e-5, atol=1e-4)
    log("    seismic ids: backend=cuda == backend=torch on the card")
    ids_f_np, sc_f_np = ids_f.cpu().numpy(), sc_f.cpu().numpy()
    for i, (t_ids, t_sc) in enumerate(truth):
        if not np.array_equal(ids_f_np[i], t_ids):
            raise SystemExit(f"flat ids differ from exact_top_k at query {i}")
        np.testing.assert_allclose(sc_f_np[i], t_sc, rtol=1e-5, atol=1e-4)
    log("    flat ids == exact_top_k for every query")
    recall = float(np.mean([recall_at_k(truth[i][0], ids_s[i].cpu().numpy()) for i in range(nq)]))
    log(f"    seismic recall@10 = {recall:.4f} (vs exact; {card})")

    lat_s = host_ms(lambda: seismic.search(Q), 10)
    lat_t = host_ms(lambda: seismic_t.search(Q), 5)
    lat_f = host_ms(lambda: flat.search(Q), 10)
    for name, lat in (("seismic cuda", lat_s), ("seismic torch", lat_t), ("flat cuda", lat_f)):
        log(f"    search latency {name}: median {statistics.median(lat):.3f} ms/batch "
            f"of {nq} ({1e3 * statistics.median(lat) / nq:.1f} µs/q), "
            f"min {min(lat):.3f} max {max(lat):.3f} ({card})")
    device_breakdown("seismic cuda", lambda: seismic.search(Q), card)
    device_breakdown("flat cuda", lambda: flat.search(Q), card)

    impl = get_engine("seismic")
    docs_s = impl.candidates(seismic.cfg, seismic.n_docs, seismic.arrays, Q)
    docs_f = torch.arange(flat.n_docs + 1, dtype=torch.int32, device=dev).unsqueeze(0)
    shapes = []
    for shape, arrays, docs, per_search in (
        ("seismic", seismic.arrays, docs_s, launches_s),
        ("flat", flat.arrays, docs_f, launches_f),
    ):
        max_err = max(max_err, check_kernel(f"{shape} shape", Q, docs, arrays, seismic.value_scale))
        streams = rows_streams(arrays)
        ms = cuda_ms(lambda: rows_dot.rows_scores(Q, docs, *streams, 1.0), 20)
        plain_ms = cuda_ms(lambda: rows_dot.rows_scores_plain(Q, docs, *streams, 1.0), 3, 1)
        bound_ms, bound_by = rows_bound(Q, docs, arrays)
        shapes.append(dict(shape=shape, nq=nq, nd=docs.shape[0], C=docs.shape[1],
                           launches_per_search=per_search, ms=ms, plain_ms=plain_ms,
                           bound_ms=bound_ms, bound_by=bound_by, library_ms=None))
        log(f"    rows_dot @ {shape} (nq={nq}, nd={docs.shape[0]}, C={docs.shape[1]}, "
            f"L={arrays['vals_rows'].shape[1]}): kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"bound {bound_ms:.4f} ms ({bound_by}), {per_search} launch/search ({card})")

    shutil.rmtree(ROOT / "build" / "chip_smoke", ignore_errors=True)

    # -- 5. summary -------------------------------------------------------------
    main_shape = shapes[0]
    kernels = [{
        "name": "rows_dot_dotvbyte_f16",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/rows_dot.cu",
        "replaces": "src/repro/kernels/rows_dot.py:190",
        "launches": launches_s + launches_f,
        "max_abs_err": max_err,
        "ms": main_shape["ms"],
        "plain_ms": main_shape["plain_ms"],
        "bound_ms": main_shape["bound_ms"],
        "bound_by": main_shape["bound_by"],
        "library_ms": None,
        "at_shapes": shapes,
    }]
    log(f"ported kernels: rows_dot_dotvbyte_f16=ok; total {time.perf_counter() - t_start:.0f}s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
