#!/usr/bin/env python
"""Time the port's rows kernel (``kernels/csrc/rows_dot.cu``) in every
scoring stage at the serving shapes, on one CUDA GPU.

    PYTHONPATH=src python tools/torch_rows_timing.py [--n-docs 100000] [--out FILE]

A collection of ``--n-docs`` random documents (SPLADE's 119 entries a
document on average, at most 256, components skewed toward low ids over
the 30,522-term vocabulary, f16 values, seed 0) is packed for all 16
row codec × value codec variants, and 64 queries of 43 entries score:

* Seismic's shape: one set of 4,096 sorted candidates per query (repeats
  mapped to the sentinel row), in row warps and entry lanes;
* flat's shape: one set of every row shared by the batch, query lanes,
  at nq 64, 97 and 128 (the pipeline's largest bucket; 97 leaves the
  second 64-query pass of a tile part empty), each beside its bound
  (``chip_smoke.rows_bound``) and the library call that computes the
  same scores, ``torch.sparse.mm`` of the collection's CSR (f32) by
  ``Qᵀ``;
* the hnsw engine's shapes: one set of 8 and of 32 rows per query, in
  entry lanes and row warps;
* the stage sweep at flat's shape, dotvbyte/f16, nq 1, 2, 4, 6 and 8 in
  entry lanes and query lanes.

Seismic, flat and the sweep are timed with CUDA events over back-to-back
calls (the mean of 20); the hnsw shapes by the kernel's device time in
one ``torch.profiler`` session (a launch there does a few µs of work
behind a longer host call). Prints one JSON object per line and the
card's name and power limit. It uses only the rows kernel's wrapper,
``pack_rows`` and ``ForwardIndex``, so it runs as well against an older
checkout of the port (``PYTHONPATH=<that checkout>/src``): compare two
versions within one call on one card.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import re
import subprocess
import sys

import numpy as np
import torch

DIM, NQ, L = 30522, 64, 256
SEISMIC_C = 4096
HNSW_C = (8, 32)
SWEEP_NQ = (1, 2, 4, 6, 8)
FLAT_NQ = (64, 97, 128)
_ROWS_KERNEL = re.compile(r"rows_dot_(shared_|warp_)?kernel<(\d), (\d)")
_ROWS_STAGE = {"": "entry_lanes", "shared_": "query_lanes", "warp_": "row_warps"}


def collection(n_docs: int, rng):
    """Random documents as a ``ForwardIndex`` (f16 values)."""
    from repro_torch.core.forward_index import VALUE_FORMATS, ForwardIndex

    nnz = np.clip(rng.poisson(119, n_docs), 1, L)
    doc = np.repeat(np.arange(n_docs, dtype=np.int64), nnz)
    comp = (DIM * rng.random(len(doc)) ** 2).astype(np.int64)
    keys = np.unique(doc * DIM + comp)  # sorted by doc, then component; repeats dropped
    doc, comp = keys // DIM, keys % DIM
    offsets = np.zeros(n_docs + 1, np.int64)
    np.cumsum(np.bincount(doc, minlength=n_docs), out=offsets[1:])
    vals = rng.gamma(2.0, 0.5, len(comp)).astype(np.float16)
    return ForwardIndex(comp.astype(np.uint32), vals, offsets, DIM, VALUE_FORMATS["f16"])


def queries(nq: int, rng) -> np.ndarray:
    Q = np.zeros((nq, DIM), np.float32)
    for i in range(nq):
        Q[i, rng.choice(DIM, 43, replace=False)] = rng.gamma(2.0, 0.5, 43)
    return Q


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
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


def device_ms(calls: dict, reps: int = 20) -> dict:
    """Device time a launch of each ``calls[(variant, stage)]`` → ms."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.values import VALUE_CODECS
    from repro_torch.kernels import rows_dot

    for call in calls.values():
        call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            for call in calls.values():
                call()
        torch.cuda.synchronize()
    sums = {}
    for e in prof.key_averages():
        m = _ROWS_KERNEL.search(e.key)
        if e.device_type != torch.autograd.DeviceType.CUDA or not m:
            continue
        key = (rows_dot.CODECS[int(m[2])], VALUE_CODECS[int(m[3])], _ROWS_STAGE[m[1] or ""])
        us, n = sums.get(key, (0.0, 0))
        sums[key] = (us + e.self_device_time_total, n + e.count)
    return {k: (sums[(*k[0], k[1])][0] / 1e3 / sums[(*k[0], k[1])][1]
                if (*k[0], k[1]) in sums else None) for k in calls}


def sparse_mm_ms(fwd, Q_by_n: dict, dev) -> dict:
    """``torch.sparse.mm`` of the collection's f32 CSR by ``Qᵀ`` for each
    batch of ``Q_by_n`` → ms, CUDA events."""
    import warnings

    with warnings.catch_warnings():  # "sparse CSR support is in beta"
        warnings.simplefilter("ignore", UserWarning)
        csr = torch.sparse_csr_tensor(
            torch.from_numpy(fwd.offsets.astype(np.int64)),
            torch.from_numpy(fwd.components.astype(np.int64)),
            torch.from_numpy(fwd.value_format.dequantise(fwd.values)),
            size=(fwd.n_docs, fwd.dim), check_invariants=True).to(dev)
        return {n: cuda_ms(lambda Qt=Qn.t().contiguous(): torch.sparse.mm(csr, Qt), 10)
                for n, Qn in Q_by_n.items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n-docs", type=int, default=100_000)
    ap.add_argument("--out", default=None, help="also write the JSON lines to this file")
    ap.add_argument("--variants", default=None,
                    help="only these codec/vq pairs, comma-separated (e.g. dotvbyte/f16)")
    ap.add_argument("--shapes", default="seismic,flat,hnsw,sweep",
                    help="the shapes to time, comma-separated")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_rows_timing: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.core.layout import pack_rows
    from repro_torch.kernels import rows_dot

    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    fwd = collection(args.n_docs, rng)
    N = fwd.n_docs
    Q = torch.from_numpy(queries(NQ, rng)).to(dev)
    seis = np.sort(rng.integers(0, N, size=(NQ, SEISMIC_C)), axis=1)
    seis[:, 1:][seis[:, 1:] == seis[:, :-1]] = N  # repeats → the sentinel, as Seismic's dedupe
    seis = torch.from_numpy(seis.astype(np.int32)).to(dev)
    flat = torch.arange(N + 1, dtype=torch.int32, device=dev).unsqueeze(0)
    hnsw = {C: torch.from_numpy(rng.integers(0, N, size=(NQ, C)).astype(np.int32)).to(dev)
            for C in HNSW_C}
    # flat's larger batches: Q and more queries, drawn last to leave the other shapes' draws
    Qf = torch.cat([Q, torch.from_numpy(queries(max(FLAT_NQ) - NQ, rng)).to(dev)])
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    lines = []
    hnsw_calls = {}
    shapes = set(args.shapes.split(","))
    variants = ([tuple(v.split("/")) for v in args.variants.split(",")] if args.variants
                else list(rows_dot.VARIANTS))
    # the values depend on the vq only and the payload on the codec only:
    # pack each once (PQ's training is the slow part) and pair them
    is_value = lambda k: k == "vals_rows" or k.startswith("vq_")  # noqa: E731
    values = {vq: {k: torch.from_numpy(v).to(dev) for k, v in pack_rows(
        fwd, codec="uncompressed", vq=vq).arrays().items() if is_value(k)}
        for vq in dict.fromkeys(v for _, v in variants)}
    payload = {c: {k: torch.from_numpy(v).to(dev) for k, v in pack_rows(
        fwd, codec=c).arrays().items() if not is_value(k)} for c in dict.fromkeys(
        c for c, _ in variants)}
    if "flat" in shapes:
        sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
        from chip_smoke import rows_bound

        library = sparse_mm_ms(fwd, {n: Qf[:n] for n in FLAT_NQ}, dev)
    for codec, vq in variants:
        arrays = {**payload[codec], **values[vq]}

        def run(docs, stage, Qn=Q, arrays=arrays, codec=codec):
            return rows_dot.rows_scores_for_codec(codec, arrays, Qn, docs, 1.0, stage=stage)

        rec = {"variant": rows_dot.variant_name(codec, vq)}
        if "seismic" in shapes:
            rec["seismic"] = {st: cuda_ms(lambda st=st: run(seis, st))
                              for st in ("row_warps", "entry_lanes")}
        if "flat" in shapes:
            rec["flat"] = {"query_lanes": {n: cuda_ms(lambda n=n: run(
                flat, "query_lanes", Qf[:n].contiguous()), 10) for n in FLAT_NQ},
                "bound": {n: rows_bound(codec, Qf[:n], flat, arrays) for n in FLAT_NQ},
                "library_ms": library}
        if (codec, vq) == ("dotvbyte", "f16") and "sweep" in shapes:
            rec["sweep"] = {st: {n: cuda_ms(lambda n=n, st=st: run(
                flat, st, Q[:n].contiguous()), 10) for n in SWEEP_NQ}
                for st in ("entry_lanes", "query_lanes")}
        for C in HNSW_C if "hnsw" in shapes else ():
            for st in ("entry_lanes", "row_warps"):
                hnsw_calls[((codec, vq), st, C)] = (lambda C=C, st=st, run=run:
                                                    run(hnsw[C], st))
        lines.append(rec)
        del arrays
    by_c = {C: device_ms({(k[0], k[1]): f for k, f in hnsw_calls.items() if k[2] == C})
            for C in HNSW_C if "hnsw" in shapes}
    for rec, (codec, vq) in zip(lines, variants):
        if by_c:
            rec["hnsw"] = {f"C{C}": {st: by_c[C][((codec, vq), st)]
                                     for st in ("entry_lanes", "row_warps")} for C in HNSW_C}
        rec["card"] = card
    out = [json.dumps(r) for r in lines]
    for ln in out:
        print(ln)
    print(card)
    if args.out:
        with open(args.out, "w") as f:
            f.write("\n".join(out) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
