#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (``src/repro_torch/``) on one
NVIDIA GPU — the quickest proof that the port still starts on the card.

    python3 chip_smoke.py            # from the repository root

Phases (each prints its seconds); any failure exits non-zero and prints
no result:

1. device and build — the card's name and power limit; every CUDA kernel
   of the port built from ``src/repro_torch/kernels/csrc`` (one ``nvcc``
   per library: the rows kernel and the six parts of the block-scan
   kernel, started together), with ptxas' register/spill report per
   kernel variant and scoring stage;
2. kernel vs plain — every variant of the rows kernel (row codec
   uncompressed / dotvbyte / streamvbyte / bitpack × value codec f16 /
   u8_sq / u4_sq / pq) against its plain torch version on the card at
   real widths (dim 30522, C = 4096, nq = 64), in both candidate-set
   forms (shared ``nd = 1`` and per-query ``nd = nq``), the shared form
   also at nq 1, 7, 32, 65 and 200 in both scoring stages (entry lanes,
   query lanes), on sentinel, empty, full-capacity, 1-byte-gap,
   2-byte-gap and word-straddling rows; and, for the codecs that take
   gaps past 16 bits, a small case at a vocabulary of 2**24 + 2**20
   (StreamVByte codes 2 and 3). The rows kernel again on f32 and fixedu8
   values (vq f16 reads the stored dtype), and ``Retriever.build`` over
   an f32 and a fixedu8 collection served with ``backend="cuda"``. Every
   block-scan entry (dotvbyte, streamvbyte and bitpack at the per-block
   width, single and batched; bitpack at each static width its packs
   hold) against its plain version in both output modes — slot scores,
   and the fused scan (scores of documents, both stages, the static
   widths added into one result) against the slot scores scattered —
   on f32 / f16 / fixedu8 values, i32 / i8 ``seg``, T = 128 and 512,
   blocks that close on D = 5 slots, docs longer than T, empty docs, a
   one-doc corpus and, for StreamVByte and bitpack, dim 2**24 + 2**20;
3. main path — a SPLADE-statistics collection (``--n-docs``, default
   100,000 of MsMarco's 8,842,240, seed 0; 64 queries) and ONE Seismic
   host index. DotVByte/f16 is served as before: ``Retriever`` built,
   saved, reopened with ``open_retriever``; the other 15 variants swap
   only their packed rows (``pack_rows``) into a ``Retriever`` over the
   same device-resident Seismic arrays. Every variant is searched with
   ``backend="cuda"``; the flat engine runs the four row codecs at f16
   and DotVByte at the three quantized value codecs. The kernels' launch
   counts are zeroed just before this phase and read just after;
4. checks and timings, per variant — Seismic ids equal to
   ``backend="torch"`` (tie-aware: a position may differ only where the
   two scores agree within rtol 1e-5), f16 flat ids equal to
   ``exact_top_k``, recall@10, search latency on both backends (host
   clock around ``torch.cuda.synchronize()``, after a warm-up), bits per component
   (``ForwardIndex.storage_bytes``) and stored row bytes, and the
   kernel's time (CUDA events) beside its plain version and its bound at
   the Seismic and flat shapes, with ``torch.sparse.mm`` (cuSPARSE) over
   the same scores as the flat shape's library yardstick; the stage
   sweep of the rows kernel at the flat shape (both stages at nq 1–64);
5. the full scan — the same collection packed into blocks (T = 512)
   for dotvbyte, streamvbyte and bitpack, every document scored through
   ``ops.score_*_batch`` (nq = 64), ``ops.score_*`` and
   ``score_bitpack_bucketed``, which run the fused kernel (the block
   scan with its scatter in the epilogue). The block-scan launch counts
   are zeroed just before and read just after: every entry must have
   launched the fused mode, and no slot-score launch. Each result is
   held against ``torch.sparse.mm`` over the uncompressed CSR (rtol =
   atol = 1e-4) and its top-10 against ``exact_top_k``; the fused call
   (in both stages), the whole entry, the slot-score kernel, both plain
   versions, the bound and the library call are timed, the stage sweep
   of the fused call is taken, and the profile of the batched entry
   must show no ``index_add_``;
6. one JSON line of kernels, the card line, and as the last line
   ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import re
import shutil
import statistics
import subprocess
import sys
import time
import warnings

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

#: H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, f32 (non-tensor) FLOP/s
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
#: kernel vs plain: f32 sums of the same products in another order
RTOL = ATOL = 1e-3
#: Seismic cuda vs torch: two scores of one position agree within this
TIE_RTOL = 1e-5

#: queries per search batch; candidates per query at the Seismic shape
N_QUERIES = 64
#: batch sizes at which phase 2 checks the rows kernel's shared form in
#: both stages (across the 32-lane and 128-query tile edges)
SHARED_NQ = (1, 7, 32, 65, 200)
#: batch sizes of the stage sweep that sets QUERY_LANES_MIN_NQ
SWEEP_NQ = (1, 2, 4, 6, 8, 16, 32, 64)
SEISMIC_PARAMS = dict(cut=8, block_budget=512, n_probe=64, n_postings=2000, block_size=64)
#: the flat engine's variants: every row codec at f16, dotvbyte at every vq
FLAT_VARIANTS = {(c, "f16") for c in ("uncompressed", "dotvbyte", "streamvbyte", "bitpack")} | {
    ("dotvbyte", v) for v in ("u8_sq", "u4_sq", "pq")}


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


def device_breakdown(name: str, fn, card: str, reps: int = 5) -> set[str]:
    """Print one search's device busy time, idle share and top kernels,
    from ``torch.profiler`` over ``reps`` warm calls → the names of every
    host op and kernel traced."""
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
    seen = {e.key for e in prof.key_averages()}
    if total <= 0:
        log(f"    profile {name}: device time not measured (no device events traced)")
        return seen
    log(f"    profile {name}: wall {wall_ms:.3f} ms/search, device busy {total:.3f} ms "
        f"(idle share {1 - total / wall_ms:.2f}) ({card}); top kernels:")
    for key, ms in sorted(busy.items(), key=lambda kv: -kv[1])[:6]:
        log(f"      {ms:8.4f} ms {100 * ms / total:5.1f}%  {key[:90]}")
    return seen


#: mangled template arguments → storage names
_MANGLED = {"f": "f32", "6__half": "f16", "h": "u8", "i": "i32", "a": "i8"}


def ptxas_report(log_text: str) -> dict[str, list[str]]:
    """ptxas' ``-v`` lines per kernel variant (by template args): rows
    ``<codec, vq, value storage>`` and block scan ``<code, value
    storage, seg storage>``."""
    from repro_torch.kernels import block_scan, rows_dot
    from repro_torch.core.values import VALUE_CODECS

    out, cur = {}, None
    for line in log_text.splitlines():
        rows = re.search(r"rows_dot_(shared_)?kernelILi(\d)ELi(\d)E(f|6__half|h)?", line)
        scan = re.search(r"block_scan_kernelILi(\d+)E(f|6__half|h)(i|a)E", line)
        if (rows or scan) and ("Compiling entry" in line or "Function properties" in line):
            if rows:
                cur = rows_dot.variant_name(rows_dot.CODECS[int(rows[2])],
                                            VALUE_CODECS[int(rows[3])])
                if rows[4] and VALUE_CODECS[int(rows[3])] == "f16":  # the stored dtype
                    cur += f"[{_MANGLED[rows[4]]}]"
                cur += " query lanes" if rows[1] else " entry lanes"
            else:
                code = int(scan[1])
                codec = block_scan.CODECS[min(code, 2)] + (f"_w{code - 2}" if code > 2 else "")
                cur = f"block_scan_{codec}[{_MANGLED[scan[2]]},{_MANGLED[scan[3]]}]"
        elif cur and ("Used" in line or "spill" in line):
            out.setdefault(cur, []).append(line.split(":", 1)[-1].strip())
    return out


def regs_spills(lines: list[str]) -> str:
    """ptxas' lines of one variant → "<registers> regs, <spill stores>/<spill
    loads> B spilled"."""
    text = " ".join(lines)
    regs = re.search(r"Used (\d+) registers", text)
    st = re.search(r"(\d+) bytes spill stores", text)
    ld = re.search(r"(\d+) bytes spill loads", text)
    return (f"{regs[1] if regs else '?'} regs, {st[1] if st else '?'}/{ld[1] if ld else '?'}"
            " B spilled")


def rows_bound(codec: str, Q, docs, arrays) -> tuple[float, str]:
    """Least time for one rows call on these inputs: each input byte read
    once — the distinct candidate rows' tight payload (dotvbyte
    ⌈nnz/8⌉ + Σ(1+bit); streamvbyte ⌈nnz/4⌉ + Σ(code+1); bitpack
    ⌈nnz·w/32⌉·4 + 4; uncompressed 4·nnz), their value bytes (f16 2·nnz;
    u8 nnz + 8; u4 ⌈nnz/2⌉ + 8; pq ⌈nnz/2⌉, plus the 2 KiB codebook
    once), 4 nnz bytes a row, Q and the ids — and the nq×C f32 scores
    written once; against one multiply-add (2 FLOP) per (query, live
    entry) at the f32 peak."""
    from repro_torch.core import values as value_codecs

    vq = value_codecs.infer_rows_vq(arrays)
    nq, dim = Q.shape
    nd, C = docs.shape
    rows = torch.unique(docs).long()
    L = arrays["vals_rows"].shape[1] * value_codecs.code_factor(vq)
    nnz = arrays["nnz_rows"][rows].long()
    used = nnz > 0
    live = torch.arange(L, device=nnz.device) < nnz.unsqueeze(-1)
    dev = Q.device
    if codec == "dotvbyte":
        ctrl = arrays["ctrl_rows"][rows, : L // 8].to(torch.int32)
        bits = ((ctrl.unsqueeze(-1) >> torch.arange(8, device=dev, dtype=torch.int32)) & 1)
        payload = (nnz + 7) // 8 + ((1 + bits.flatten(-2)) * live).sum(-1)
    elif codec == "streamvbyte":
        ctrl = arrays["ctrl_rows"][rows, : L // 4].to(torch.int32)
        codes = (ctrl.unsqueeze(-1) >> (2 * torch.arange(4, device=dev, dtype=torch.int32))) & 3
        payload = (nnz + 3) // 4 + ((1 + codes.flatten(-2)) * live).sum(-1)
    elif codec == "bitpack":
        w = arrays["widths_rows"][rows].long()
        payload = ((nnz * w + 31) // 32) * 4 + 4 * used
    else:
        payload = 4 * nnz
    values = {"f16": 2 * nnz, "u8_sq": nnz + 8 * used, "u4_sq": (nnz + 1) // 2 + 8 * used,
              "pq": (nnz + 1) // 2}[vq]
    n_bytes = int((payload + values + 4).sum()) + 4 * nq * dim + 4 * nd * C + 4 * nq * C
    n_bytes += 4 * value_codecs.PQ_K * value_codecs.PQ_M if vq == "pq" else 0
    pairs = int(arrays["nnz_rows"][docs.long()].long().sum()) * (nq if nd == 1 else 1)
    t_bytes = 1e3 * n_bytes / HBM_BYTES_PER_S
    t_ops = 1e3 * 2 * pairs / F32_FLOP_PER_S
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def edge_docs(dim: int, L: int, n_docs: int, rng):
    """Empty, full-capacity (L entries), all-1-byte-gap, word-straddling
    (gaps of 31: 5-bit bitpack words), all-2-byte-gap and random
    documents."""
    docs = []
    for i in range(n_docs):
        kind = i % 8
        if kind == 0:
            comps = np.zeros(0, np.int64)
        elif kind == 1:
            comps = np.sort(rng.choice(dim, size=L, replace=False))
        elif kind == 2:
            comps = 1000 + 3 * np.arange(int(rng.integers(1, L)))
        elif kind == 3:
            comps = 31 * np.arange(int(rng.integers(7, L)))
        elif kind == 4:
            comps = 300 + 257 * np.arange(int(rng.integers(1, min(L, dim // 300))))
        else:
            comps = np.sort(rng.choice(dim, size=int(rng.integers(1, L)), replace=False))
        docs.append((comps, rng.gamma(2.0, 0.5, size=len(comps)).astype(np.float32)))
    return docs


def wide_docs(dim: int, rng):
    """Documents whose gaps take every StreamVByte byte length (up to 2**24)."""
    comps = np.cumsum([0, 7, 300, 70_000, 1 << 24])
    docs = [(comps[comps < dim], rng.gamma(2.0, 0.5, size=int((comps < dim).sum())))]
    for n in rng.integers(1, 120, size=30):
        docs.append((np.sort(rng.choice(dim, size=int(n), replace=False)),
                     rng.gamma(2.0, 0.5, size=int(n))))
    return docs


def sparse_queries(nq: int, dim: int, nnz: int, rng) -> np.ndarray:
    Q = np.zeros((nq, dim), np.float32)
    for i in range(nq):
        Q[i, rng.choice(dim, size=nnz, replace=False)] = rng.gamma(2, 0.5, size=nnz)
    return Q


def check_kernel(codec, name, Q, docs, arrays, scale=1.0, stage=None, want=None) -> float:
    """Kernel (in ``stage``; default: the wrapper's pick) vs plain on the
    card at one shape → max abs difference. These launches compare; they
    are not the main path's."""
    from repro_torch.kernels import rows_dot

    got = rows_dot.rows_scores_for_codec(codec, arrays, Q, docs, scale, stage=stage)
    if want is None:
        want = rows_dot.rows_scores_plain(codec, arrays, Q, docs, scale)
    torch.cuda.synchronize()
    err = float((got - want).abs().max()) if got.numel() else 0.0
    if not torch.allclose(got, want, rtol=RTOL, atol=ATOL):
        raise SystemExit(f"rows kernel disagrees with its plain version at {name} "
                         f"(max_abs_err={err:.3e}, rtol={RTOL}, atol={ATOL})")
    return err


def same_topk(ids_a, sc_a, ids_b, sc_b) -> int:
    """Tie-aware top-k equality → the number of positions whose ids
    differ; raises where a differing position's two scores do not agree
    within TIE_RTOL."""
    diff = ids_a != ids_b
    if diff.any() and not torch.allclose(sc_a[diff], sc_b[diff], rtol=TIE_RTOL, atol=0):
        raise SystemExit("top-k ids differ at positions whose scores are not tied")
    torch.testing.assert_close(sc_a, sc_b, rtol=1e-5, atol=1e-4)
    return int(diff.sum())


#: block-scan entry → (codec, batched); bitpack_w is the bucketed static width
BLOCK_ENTRIES = {
    "block_scan_dotvbyte": ("dotvbyte", False),
    "block_scan_dotvbyte_batch": ("dotvbyte", True),
    "block_scan_streamvbyte": ("streamvbyte", False),
    "block_scan_streamvbyte_batch": ("streamvbyte", True),
    "block_scan_bitpack": ("bitpack", False),
    "block_scan_bitpack_batch": ("bitpack", True),
    "block_scan_bitpack_w": ("bitpack", False),
}
BLOCK_CODECS = ("dotvbyte", "streamvbyte", "bitpack")
#: the kernels' scoring stages (both kernels name them alike)
STAGES = ("entry_lanes", "query_lanes")


def scan_fn(codec: str, batched: bool):
    """The block-scan entry ``<codec>_block_scores[_batch]``."""
    from repro_torch.kernels import block_scan

    return getattr(block_scan, f"{codec}_block_scores" + ("_batch" if batched else ""))


def scan_args(packed) -> list:
    """The block-scan entry's stream arguments of a pack held as tensors."""
    keys = ("ctrl", "data") if packed.codec != "bitpack" else ("words", "widths")
    return [getattr(packed, k) for k in (*keys, "seg", "start_pos", "start_abs", "vals")]


def bucket_streams(packed, sel, words) -> dict:
    """One width bucket's streams (``ops.width_buckets``)."""
    return {"words": words, **{k: getattr(packed, k)[sel]
                               for k in ("seg", "start_pos", "start_abs", "vals")}}


def check_close(name: str, got, want) -> float:
    """Kernel vs plain → max abs difference; exits at a disagreement."""
    torch.cuda.synchronize()
    err = float((got - want).abs().max()) if got.numel() else 0.0
    if not torch.allclose(got, want, rtol=RTOL, atol=ATOL):
        raise SystemExit(f"block-scan kernel disagrees with its plain version at {name} "
                         f"(max_abs_err={err:.3e}, rtol={RTOL}, atol={ATOL})")
    return err


def check_blocks(name: str, Q, packed, max_err: dict, fused_err: dict) -> str:
    """Every block-scan entry of the pack's codec against its plain
    version, in both output modes: slot scores batched (Q), single
    (Q[0]) and, for bitpack, at each static width the pack holds; the
    fused scan (scores of documents) batched and single in both scoring
    stages, and bucketed into one result. These launches compare; they
    are not the main path's."""
    from repro_torch.core.scoring import scatter_block_scores
    from repro_torch.kernels import block_scan, ops

    codec, scale = packed.codec, float(packed.value_format.scale)
    streams = {k: v for k, v in packed.as_dict().items() if k != "doc_ids"}
    ids, n_docs = packed.doc_ids, packed.n_docs
    plain = block_scan.block_scores_plain(codec, Q, streams, scale=scale)
    plain_docs = scatter_block_scores(plain, ids, n_docs)
    single, batch = scan_fn(codec, False), scan_fn(codec, True)
    entry = f"block_scan_{codec}"
    errs = {f"{entry}_batch": check_close(
                f"{name} batch", batch(Q, *scan_args(packed), scale=scale), plain),
            entry: check_close(
                f"{name} single", single(Q[0], *scan_args(packed), scale=scale), plain[0])}
    fused = {f"{entry}_batch": 0.0, entry: 0.0}
    for stage in STAGES:
        for e, Qx, want in ((f"{entry}_batch", Q, plain_docs), (entry, Q[:1], plain_docs[:1])):
            got = block_scan.scan_scores(e, codec, Qx, streams, ids, n_docs, scale=scale,
                                         stage=stage)
            fused[e] = max(fused[e], check_close(f"{name} {e} fused {stage}", got, want))
    widths = []
    if codec == "bitpack":
        err_w, total, want_total = 0.0, None, torch.zeros_like(plain_docs[:1])
        for w, sel, words in ops.width_buckets(packed):
            b = bucket_streams(packed, sel, words)
            got = block_scan.bitpack_block_scores_w(Q[0], *b.values(), width=w, scale=scale)
            want = block_scan.block_scores_plain("bitpack", Q[:1], b, scale=scale, width=w)[0]
            err_w = max(err_w, check_close(f"{name} width {w}", got, want))
            total = block_scan.scan_scores("block_scan_bitpack_w", "bitpack", Q[:1], b,
                                           ids[sel], n_docs, scale=scale, width=w, out=total)
            want_total += scatter_block_scores(want.unsqueeze(0), ids[sel], n_docs)
            widths.append(w)
        errs["block_scan_bitpack_w"] = err_w
        fused["block_scan_bitpack_w"] = check_close(f"{name} bucketed fused", total, want_total)
    for into, new in ((max_err, errs), (fused_err, fused)):
        for k, v in new.items():
            into[k] = max(into.get(k, 0.0), v)
    return (f"B={packed.n_blocks} max_abs_err slots " + ", ".join(
        f"{k[len('block_scan_'):]} {v:.1e}" for k, v in errs.items())
        + "; fused " + ", ".join(f"{k[len('block_scan_'):]} {v:.1e}" for k, v in fused.items())
        + (f" (widths {widths})" if widths else ""))


def tie_aware_topk(name: str, ids, scores, truth_ids, truth_scores) -> int:
    """Top-k ids equal to the exact top-k, except where the exact scores
    of two differing positions are tied (rtol TIE_RTOL) → the number of
    such positions; exits otherwise."""
    diff = ids != truth_ids
    if diff.any() and not np.allclose(scores[diff], truth_scores[diff], rtol=TIE_RTOL, atol=0):
        raise SystemExit(f"{name}: top-k ids differ from exact_top_k at untied positions")
    np.testing.assert_allclose(scores, truth_scores, rtol=1e-4, atol=1e-4)
    return int(diff.sum())


def scan_bound(packed, nq: int, dim: int, words_bytes: int | None = None):
    """Least time for one full-scan entry on these inputs: every stream of
    the pack read once (bitpack's bucketed entry: the tight bucket words
    in place of the padded ones), Q read once and the nq × n_docs f32
    scores written once, over the HBM rate; against one multiply-add (2
    FLOP) per (query, live entry) at the f32 peak."""
    n_bytes = sum(int(a.nbytes) for a in packed.as_dict().values())
    if words_bytes is not None:
        n_bytes += words_bytes - int(packed.words.nbytes)
    n_bytes += 4 * nq * dim + 4 * nq * packed.n_docs
    pairs = nq * int((packed.seg >= 0).sum())
    t_bytes = 1e3 * n_bytes / HBM_BYTES_PER_S
    t_ops = 1e3 * 2 * pairs / F32_FLOP_PER_S
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def full_scan(fwd, Q, truth, csr, card: str, max_err: dict, fused_err: dict) -> list[dict]:
    """Phase 5: the full-scan path over the main collection → the
    block-scan entries' kernel-line records."""
    from repro_torch.core.layout import pack_blocks
    from repro_torch.kernels import block_scan, ops
    from repro_torch.serve.api import top_k

    nq, dim = Q.shape
    packs = {}
    for codec in BLOCK_CODECS:
        t0 = time.perf_counter()
        p = pack_blocks(fwd, codec=codec, block_size=512)
        secs = time.perf_counter() - t0
        streams = ", ".join(f"{k} {a.nbytes / 2**20:.1f}" for k, a in p.as_dict().items())
        log(f"    pack_blocks({codec}, T=512): B={p.n_blocks}, D={p.max_docs_per_block}; MiB "
            f"{streams}; payload_bytes {p.payload_bytes()} in {secs:.1f}s")
        packs[codec] = p.to(Q.device)
    q0 = Q[0]

    # the path: every entry once, counts zeroed just before and read just after
    block_scan.reset_launches()
    results = {}
    for codec, p in packs.items():
        single, batch = ops.block_scorers(codec)
        results[f"block_scan_{codec}_batch"] = batch(Q, p)
        results[f"block_scan_{codec}"] = single(q0, p)
    results["block_scan_bitpack_w"] = ops.score_bitpack_bucketed(q0, packs["bitpack"])
    torch.cuda.synchronize()
    launches = dict(block_scan.variant_launches)
    fused = dict(block_scan.fused_launches)
    stages = dict(block_scan.stage_launches)
    log("    full-scan launches (all / fused): " + ", ".join(
        f"{k}={v}/{fused[k]}" for k, v in launches.items())
        + "; by stage " + ", ".join(f"{k}={v}" for k, v in stages.items()))
    missing = [k for k, v in fused.items() if v <= 0]
    if missing:
        raise SystemExit(f"the full scan did not launch the fused kernel for {missing}")
    if any(launches[k] != fused[k] for k in launches):
        raise SystemExit("the full scan launched the slot-score mode on its path")

    # checks: torch.sparse.mm over the uncompressed CSR and exact_top_k
    Qt = Q.t().contiguous()
    q_col = q0.unsqueeze(1).contiguous()
    lib = {True: torch.sparse.mm(csr, Qt).t(), False: torch.sparse.mm(csr, q_col).t()}
    for entry, got in results.items():
        batched = BLOCK_ENTRIES[entry][1]
        want = lib[batched] if batched else lib[False][0]
        # f32 sums in another order, and a document's fragments added by
        # atomics in no fixed order: 1e-4 covers both at these magnitudes
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
        sc, ids = top_k(got if batched else got.unsqueeze(0), 10)
        swaps = sum(tie_aware_topk(f"{entry} query {i}", ids[i].cpu().numpy(),
                                   sc[i].cpu().numpy(), *truth[i]) for i in range(ids.shape[0]))
        log(f"    {entry}: scores == sparse.mm (rtol=atol=1e-4); top-10 == exact_top_k "
            f"for {ids.shape[0]} queries ({swaps} tied swaps)")

    # timings at the main path's shapes, and kernel vs plain there
    lib_ms = {True: cuda_ms(lambda: torch.sparse.mm(csr, Qt), 10),
              False: cuda_ms(lambda: torch.sparse.mm(csr, q_col), 20)}
    log(f"    torch.sparse.mm (CSR {fwd.n_docs}x{fwd.dim}, {fwd.total_nnz} nnz): "
        f"x Q.T {lib_ms[True]:.4f} ms, x q {lib_ms[False]:.4f} ms ({card})")
    out = []
    for entry, (codec, batched) in BLOCK_ENTRIES.items():
        p = packs[codec]
        scale = float(p.value_format.scale)
        Qx = Q if batched else Q[:1]
        single, batch = ops.block_scorers(codec)
        if entry == "block_scan_bitpack_w":
            buckets = [(w, bucket_streams(p, sel, words), p.doc_ids[sel])
                       for w, sel, words in ops.width_buckets(p)]

            def kernel():
                return [block_scan.bitpack_block_scores_w(q0, *b.values(), width=w, scale=scale)
                        for w, b, _ in buckets]

            def plain():
                return [block_scan.block_scores_plain("bitpack", Qx, b, scale=scale, width=w)[0]
                        for w, b, _ in buckets]

            def fused_call():
                total = None
                for w, b, ids in buckets:
                    total = block_scan.scan_scores(entry, "bitpack", Qx, b, ids, p.n_docs,
                                                   scale=scale, width=w, out=total)
                return total

            def fused_plain():
                return sum(block_scan.scan_scores_plain("bitpack", Qx, b, ids, p.n_docs,
                                                        scale=scale, width=w)
                           for w, b, ids in buckets)

            def whole():
                return ops.score_bitpack_bucketed(q0, p)

            err = max(check_close(f"{entry} @ 100k width {w}", g, e)
                      for (w, _, _), g, e in zip(buckets, kernel(), plain()))
            bound_ms, bound_by = scan_bound(p, 1, dim, sum(int(b["words"].nbytes)
                                                           for _, b, _ in buckets))
            stage_ms = {}
        else:
            args = scan_args(p)
            fn = scan_fn(codec, batched)
            streams = {k: v for k, v in p.as_dict().items() if k != "doc_ids"}

            def kernel():
                return fn(Q if batched else q0, *args, scale=scale)

            def plain():
                r = block_scan.block_scores_plain(codec, Qx, streams, scale=scale)
                return r if batched else r[0]

            def fused_call(stage=None):
                return block_scan.scan_scores(entry, codec, Qx, streams, p.doc_ids, p.n_docs,
                                              scale=scale, stage=stage)

            def fused_plain():
                return block_scan.scan_scores_plain(codec, Qx, streams, p.doc_ids, p.n_docs,
                                                    scale=scale)

            def whole():
                return (batch(Q, p) if batched else single(q0, p))

            err = check_close(f"{entry} @ 100k", kernel(), plain())
            bound_ms, bound_by = scan_bound(p, Qx.shape[0], dim)
            # both stages of the fused call, the picked one first
            stage_ms = {st: cuda_ms(lambda: fused_call(st), 10) for st in STAGES}
        max_err[entry] = max(max_err.get(entry, 0.0), err)
        f_err = check_close(f"{entry} @ 100k fused", fused_call(), fused_plain())
        fused_err[entry] = max(fused_err.get(entry, 0.0), f_err)
        ms = cuda_ms(kernel, 10 if batched else 20)
        fused_ms = cuda_ms(fused_call, 10 if batched else 20)
        entry_ms = cuda_ms(whole, 10 if batched else 20)
        plain_ms = cuda_ms(plain, 2 if batched else 3, 1)
        fused_plain_ms = cuda_ms(fused_plain, 2 if batched else 3, 1)
        stage = block_scan.pick_stage(Qx.shape[0])
        inter = 4 * Qx.shape[0] * p.n_blocks * p.max_docs_per_block
        log(f"  {entry}: fused {fused_ms:.4f} ms ({stage}; "
            + ", ".join(f"{k} {v:.4f}" for k, v in stage_ms.items())
            + f"), entry {entry_ms:.4f} ms, slot-score kernel {ms:.4f} ms (its [nq,B,D] "
            f"output {inter / 2**20:.1f} MiB, not on the path), plain {plain_ms:.3f} / fused "
            f"plain {fused_plain_ms:.3f} ms, bound {bound_ms:.4f} ms by {bound_by}, sparse.mm "
            f"{lib_ms[batched]:.4f} ms; max_abs_err slots {max_err[entry]:.2e}, fused "
            f"{fused_err[entry]:.2e} ({card})")
        out.append({
            "name": entry,
            "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/block_scan.cu",
            "replaces": block_scan.ENTRIES[entry],
            "launches": launches[entry],
            "max_abs_err": max(max_err[entry], fused_err[entry]),
            "ms": ms,
            "plain_ms": plain_ms,
            "bound_ms": bound_ms,
            "bound_by": bound_by,
            "library_ms": lib_ms[batched],
            "fused_ms": fused_ms,
            "fused_launches": fused[entry],
            "fused_plain_ms": fused_plain_ms,
            "fused_max_abs_err": fused_err[entry],
            "fused_ms_by_stage": stage_ms,
            "stage": stage,
            "entry_ms": entry_ms,
            "nq": Qx.shape[0],
            "n_blocks": p.n_blocks,
            "slot_scores_bytes": inter,
        })
    out[list(BLOCK_ENTRIES).index("block_scan_dotvbyte_batch")]["stage_sweep"] = stage_sweep(
        "fused block scan, dotvbyte", lambda Qn, st: block_scan.scan_scores(
            "block_scan_dotvbyte_batch", "dotvbyte", Qn,
            {k: v for k, v in packs["dotvbyte"].as_dict().items() if k != "doc_ids"},
            packs["dotvbyte"].doc_ids, fwd.n_docs, stage=st), Q, card)
    ops_seen = device_breakdown("full scan dotvbyte batch", lambda: ops.score_dotvbyte_batch(
        Q, packs["dotvbyte"]), card)
    if any("index_add" in k for k in ops_seen):
        raise SystemExit("the batched full scan still runs an index_add_ scatter")
    log("    the batched full scan ran no index_add_ (profiler: "
        f"{len(ops_seen)} distinct host ops and kernels)")
    device_breakdown("full scan dotvbyte single", lambda: ops.score_dotvbyte(q0, packs[
        "dotvbyte"]), card)
    return out


def stage_sweep(name: str, call, Q, card: str) -> dict:
    """Device time of ``call(Q[:n], stage)`` in both scoring stages at
    every batch size of SWEEP_NQ → ``{stage: {nq: ms}}``; the data behind
    QUERY_LANES_MIN_NQ."""
    out = {st: {} for st in STAGES}
    for n in SWEEP_NQ:
        Qn = Q[:n].contiguous()
        for st in STAGES:
            out[st][n] = cuda_ms(lambda: call(Qn, st), 10)
    log(f"    stage sweep, {name} (ms; {card}): " + "; ".join(
        f"nq {n}: entry {out['entry_lanes'][n]:.4f}, query {out['query_lanes'][n]:.4f}"
        for n in SWEEP_NQ))
    return out


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

    from repro_torch.core.forward_index import ForwardIndex
    from repro_torch.core.layout import pack_blocks, pack_rows
    from repro_torch.core.seismic import exact_top_k, recall_at_k
    from repro_torch.data.synthetic import generate_collection, splade_config
    from repro_torch.kernels import build, rows_dot
    from repro_torch.serve.api import Retriever, RetrieverConfig, get_engine, open_retriever

    dev = torch.device("cuda")
    t_start = time.perf_counter()
    phase_s = {}
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    log(f"[1] device: {kind} (count={torch.cuda.device_count()}); nvidia-smi: {card}")
    log(f"    torch {torch.__version__} cuda {torch.version.cuda}")
    variants = rows_dot.VARIANTS
    names = {v: rows_dot.variant_name(*v) for v in variants}

    # -- 1. build every kernel, in parallel --------------------------------
    t0 = time.perf_counter()
    built = build.compile_kernels(build.SOURCES)
    log(f"    built {sorted(built)} in {time.perf_counter() - t0:.2f}s")
    for name, info in built.items():
        log(f"    {name}: nvcc {info['seconds']:.1f}s")
        report = ptxas_report(info["log"] or "")
        groups = {}
        for variant, lines in sorted(report.items()):
            if variant.startswith("rows_dot"):
                name, stage = variant.rsplit(" ", 2)[0], " ".join(variant.rsplit(" ", 2)[1:])
                groups.setdefault(name, []).append(f"{stage} {regs_spills(lines)}")
            else:
                entry, storage = variant[:-1].split("[")
                groups.setdefault(entry, []).append(f"{storage} {regs_spills(lines)}")
        for entry, items in groups.items():
            log(f"    {entry}: " + "; ".join(items))
    phase_s["1 build"] = time.perf_counter() - t_start

    # -- 2. every variant vs plain at real widths ---------------------------------
    t0 = time.perf_counter()
    rng = np.random.default_rng(0)
    dim, nq, C = 30522, N_QUERIES, 4096
    e_docs = edge_docs(dim, 256, 3000, rng)
    fwd_e = ForwardIndex.from_docs(e_docs, dim, value_format="f16")
    Qe = torch.from_numpy(sparse_queries(nq, dim, 43, rng)).to(dev)
    n_e = fwd_e.n_docs
    ids = rng.integers(0, n_e + 1, size=(nq, C)).astype(np.int32)
    ids[:, :6] = [n_e, 0, 1, 2, 3, 4]  # sentinel, empty, full, 1-byte, straddle, 2-byte
    ids = torch.from_numpy(ids).to(dev)
    Qs = torch.from_numpy(sparse_queries(max(SHARED_NQ), dim, 43, rng)).to(dev)
    wide_dim = (1 << 24) + (1 << 20)
    fwd_w = ForwardIndex.from_docs(wide_docs(wide_dim, rng), wide_dim, value_format="f16")
    Qw = torch.rand((2, wide_dim), device=dev, generator=torch.Generator(dev).manual_seed(0))
    ids_w = torch.arange(fwd_w.n_docs + 1, dtype=torch.int32, device=dev)
    max_err = {v: 0.0 for v in variants}
    log(f"[2] rows kernel vs plain on edge rows (N={n_e}, dim={dim}, nq={nq}, C={C}; the "
        f"shared form also at nq {list(SHARED_NQ)} in both stages; rtol={RTOL}, atol={ATOL}):")
    for codec, vq in variants:
        rows = pack_rows(fwd_e, codec=codec, vq=vq)
        assert rows.l_max == 256, rows.l_max
        arrays = {k: torch.from_numpy(v).to(dev) for k, v in rows.arrays().items()}
        errs = [check_kernel(codec, f"{names[codec, vq]} nd=1", Qe, ids[:1].contiguous(),
                             arrays, 0.5),
                check_kernel(codec, f"{names[codec, vq]} nd=nq", Qe, ids, arrays, 0.5)]
        shared = []
        for n in SHARED_NQ:  # the shared form across the lane and tile edges, both stages
            Qn, set1 = Qs[:n], ids[:1].contiguous()
            want = rows_dot.rows_scores_plain(codec, arrays, Qn, set1, 0.5)
            shared += [check_kernel(codec, f"{names[codec, vq]} nd=1 nq={n} {st}", Qn, set1,
                                    arrays, 0.5, st, want) for st in rows_dot.STAGES]
        errs[0] = max(errs[0], *shared)
        wide = ""
        if codec != "dotvbyte":  # DotVByte stores 16-bit gaps only
            wa = {k: torch.from_numpy(v).to(dev)
                  for k, v in pack_rows(fwd_w, codec=codec, vq=vq).arrays().items()}
            errs += [check_kernel(codec, f"{names[codec, vq]} wide nd=1", Qw,
                                  ids_w.unsqueeze(0), wa),
                     check_kernel(codec, f"{names[codec, vq]} wide nd=nq", Qw,
                                  ids_w.unsqueeze(0).repeat(2, 1), wa)]
            wide = f", dim {wide_dim} nd=1/nq {errs[2]:.2e}/{errs[3]:.2e}"
        max_err[codec, vq] = max(errs)
        log(f"  {names[codec, vq]:28s} max_abs_err nd=1 {errs[0]:.2e} (both stages), nd=nq "
            f"{errs[1]:.2e}{wide} ok")
    del Qw
    # vq f16 reads the values as stored: f32 and fixedu8 rows too
    for vf in ("f32", "fixedu8"):
        fwd_v = ForwardIndex.from_docs(e_docs, dim, value_format=vf)
        errs = []
        for codec in rows_dot.CODECS:
            arrays = {k: torch.from_numpy(v).to(dev)
                      for k, v in pack_rows(fwd_v, codec=codec).arrays().items()}
            scale_v = float(fwd_v.value_format.scale)
            errs += [check_kernel(codec, f"{names[codec, 'f16']} {vf} nd=1", Qe,
                                  ids[:1].contiguous(), arrays, scale_v),
                     check_kernel(codec, f"{names[codec, 'f16']} {vf} nd=nq", Qe, ids, arrays,
                                  scale_v)]
            max_err[codec, "f16"] = max(max_err[codec, "f16"], *errs[-2:])
        log(f"  rows kernel on {vf} values (vq f16), 4 codecs x nd=1/nq: max_abs_err "
            f"{max(errs):.2e} ok")
    # Retriever.build over f32 and fixedu8 collections, served on the card
    for vf in ("f32", "fixedu8"):
        col_v = generate_collection(splade_config(2000, 8, 1), value_format=vf)
        Qv = np.stack([col_v.query_dense(i) for i in range(col_v.n_queries)])
        ret = Retriever.build(col_v.fwd, RetrieverConfig(engine="flat", codec="dotvbyte",
                                                         backend="cuda", k=10))
        before = rows_dot.variant_launches[names["dotvbyte", "f16"]]
        got_ids, got_sc = (t.cpu().numpy() for t in ret.search(Qv))
        if rows_dot.variant_launches[names["dotvbyte", "f16"]] <= before:
            raise SystemExit(f"the {vf} Retriever did not launch the rows kernel")
        swaps = sum(tie_aware_topk(f"{vf} flat query {i}", got_ids[i], got_sc[i],
                                   *exact_top_k(col_v.fwd, Qv[i], 10))
                    for i in range(len(Qv)))
        log(f"  Retriever.build({vf} collection, flat, dotvbyte, backend=cuda): ids == "
            f"exact_top_k for {len(Qv)} queries ({swaps} tied swaps)")
    phase_s["2 kernel vs plain"] = time.perf_counter() - t0

    # -- 2b. every block-scan entry vs plain on edge packs ---------------------------
    t0 = time.perf_counter()
    block_err: dict[str, float] = {}
    fused_err: dict[str, float] = {}
    b_docs = edge_docs(dim, 700, 600, rng)  # docs up to 700 entries: longer than T
    Qb = torch.from_numpy(rng.random((nq, dim)).astype(np.float32)).to(dev)
    log(f"[2b] block-scan kernel vs plain (nq={nq}, dim={dim}; rtol={RTOL}, atol={ATOL}):")
    for vf in ("f32", "f16", "fixedu8"):
        fwd_b = ForwardIndex.from_docs(b_docs, dim, value_format=vf)
        for codec in BLOCK_CODECS:
            for T, seg, D in ((128, np.int32, None), (512, np.int32, None), (128, np.int8, 5),
                              (512, np.int8, None)):
                packed = pack_blocks(fwd_b, codec=codec, block_size=T, max_docs_per_block=D,
                                     seg_dtype=seg).to(dev)
                name = f"{codec} {vf} T={T} seg={np.dtype(seg).name} D={packed.max_docs_per_block}"
                log(f"  {name}: " + check_blocks(name, Qb, packed, block_err, fused_err))
    one = ForwardIndex.from_docs([(np.sort(rng.choice(dim, 1500, replace=False)),
                                   rng.gamma(2.0, 0.5, 1500))], dim, value_format="f16")
    wide_b = ForwardIndex.from_docs(
        wide_docs(wide_dim, rng) + [(np.array([i, wide_dim - 1 - i]), np.ones(2))
                                    for i in range(200)], wide_dim, value_format="f16")
    Qwb = torch.rand((2, wide_dim), device=dev, generator=torch.Generator(dev).manual_seed(1))
    for codec in BLOCK_CODECS:
        log(f"  {codec} one-doc corpus (1500 entries, T=512): " + check_blocks(
            f"{codec} one-doc", Qb, pack_blocks(one, codec=codec).to(dev), block_err, fused_err))
        if codec != "dotvbyte":  # DotVByte stores 16-bit gaps only
            log(f"  {codec} dim {wide_dim} (T=256, D=200; a block's gap sum passes 2**31): "
                + check_blocks(f"{codec} wide", Qwb, pack_blocks(
                    wide_b, codec=codec, block_size=256, max_docs_per_block=200).to(dev),
                    block_err, fused_err))
    del Qwb
    phase_s["2b block scan vs plain"] = time.perf_counter() - t0

    # -- 3. the main path -----------------------------------------------------
    t0 = time.perf_counter()
    col = generate_collection(splade_config(args.n_docs, nq, 0), value_format="f16")
    fwd = col.fwd
    Q_np = np.stack([col.query_dense(i) for i in range(col.n_queries)])
    log(f"[3] generated {fwd.n_docs} docs (nnz/doc={fwd.total_nnz / fwd.n_docs:.1f}, "
        f"dim={fwd.dim}) + {nq} queries in {time.perf_counter() - t0:.1f}s")
    phase_s["3 generate"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    impl = get_engine("seismic")
    cfg_s = RetrieverConfig(engine="seismic", codec="dotvbyte", backend="cuda",
                            k=10, params=SEISMIC_PARAMS)
    cfg_f = RetrieverConfig(engine="flat", codec="dotvbyte", backend="cuda", k=10)
    index = impl.host_index(fwd, cfg_s)
    log(f"    Seismic host index ({index.n_blocks} blocks) built once in "
        f"{time.perf_counter() - t0:.1f}s")
    phase_s["3 seismic host build"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    Q = torch.from_numpy(Q_np).to(dev)
    rows_dot.reset_launches()  # counts the main path's launches only
    built_s = Retriever.from_host_index(index, cfg_s)
    art = ROOT / "build" / "chip_smoke" / "seismic-dotvbyte"
    built_s.save(art, compress=False)
    del built_s
    seismic = {("dotvbyte", "f16"): open_retriever(art)}
    engine_arrays = {k: v for k, v in seismic["dotvbyte", "f16"].arrays.items()
                     if not k.endswith("_rows") and not k.startswith("vq_")}
    log(f"    Retriever.from_host_index(dotvbyte, f16) + save + open_retriever in "
        f"{time.perf_counter() - t0:.1f}s; engine arrays: "
        + ", ".join(f"{k}{list(v.shape)}" for k, v in engine_arrays.items()))
    flat, results, per_search, row_bytes = {}, {}, {}, {}
    for codec, vq in variants:
        t1 = time.perf_counter()
        if (codec, vq) == ("dotvbyte", "f16"):
            rows = {k: v for k, v in seismic[codec, vq].arrays.items() if k not in engine_arrays}
            flat[codec, vq] = Retriever.build(fwd, cfg_f)
        else:
            rows = {k: torch.from_numpy(v).to(dev)
                    for k, v in pack_rows(fwd, codec=codec, vq=vq).arrays().items()}
            seismic[codec, vq] = Retriever(
                cfg_s.replace(codec=codec, vq=vq), {**engine_arrays, **rows},
                n_docs=fwd.n_docs, dim=fwd.dim, value_scale=float(fwd.value_format.scale),
                value_format=fwd.value_format.name)
            if (codec, vq) in FLAT_VARIANTS:
                flat[codec, vq] = Retriever(
                    cfg_f.replace(codec=codec, vq=vq), rows, n_docs=fwd.n_docs, dim=fwd.dim,
                    value_scale=float(fwd.value_format.scale),
                    value_format=fwd.value_format.name)
        row_bytes[codec, vq] = sum(v.numel() * v.element_size() for v in rows.values())
        pack_s = time.perf_counter() - t1
        name = names[codec, vq]
        before = rows_dot.variant_launches[name]
        results["seismic", codec, vq] = seismic[codec, vq].search(Q)
        torch.cuda.synchronize()
        per_search["seismic", codec, vq] = rows_dot.variant_launches[name] - before
        if (codec, vq) in flat:
            before = rows_dot.variant_launches[name]
            results["flat", codec, vq] = flat[codec, vq].search(Q)
            torch.cuda.synchronize()
            per_search["flat", codec, vq] = rows_dot.variant_launches[name] - before
        log(f"    {name:28s} rows packed + placed in {pack_s:.1f}s, "
            f"{row_bytes[codec, vq] / 2**20:.1f} MiB on the card")
    launches = dict(rows_dot.variant_launches)
    log("    main path launches: " + ", ".join(f"{names[v]}={launches[names[v]]}"
                                               for v in variants))
    missing = [names[v] for v in variants if launches[names[v]] <= 0]
    if missing:
        raise SystemExit(f"the main path did not launch {missing}")
    phase_s["3 main path"] = time.perf_counter() - t0

    # -- 4. checks and timings ----------------------------------------------------
    t0 = time.perf_counter()
    truth = [exact_top_k(fwd, Q_np[i], 10) for i in range(nq)]
    log(f"[4] exact top-10 of {nq} queries in {time.perf_counter() - t0:.1f}s")
    base = seismic["dotvbyte", "f16"]
    docs_s = impl.candidates(base.cfg, base.n_docs, base.arrays, Q)
    docs_f = torch.arange(fwd.n_docs + 1, dtype=torch.int32, device=dev).unsqueeze(0)
    scale = float(fwd.value_format.scale)
    # library yardstick at the flat shape: cuSPARSE CSR × dense over the
    # uncompressed collection (built outside the timing)
    with warnings.catch_warnings():  # "sparse CSR support is in beta"
        warnings.simplefilter("ignore", UserWarning)
        csr = torch.sparse_csr_tensor(
            torch.from_numpy(fwd.offsets.astype(np.int64)),
            torch.from_numpy(fwd.components.astype(np.int64)),
            torch.from_numpy(fwd.value_format.dequantise(fwd.values)),
            size=(fwd.n_docs, fwd.dim), check_invariants=True).to(dev)
    Qt = Q.t().contiguous()
    lib_out = torch.sparse.mm(csr, Qt).t()
    lib_ms = cuda_ms(lambda: torch.sparse.mm(csr, Qt), 10)
    log(f"    library yardstick torch.sparse.mm (CSR {fwd.n_docs}×{fwd.dim}, "
        f"{fwd.total_nnz} nnz) × Q.T: {lib_ms:.4f} ms ({card})")
    raw_bytes = fwd.storage_bytes("uncompressed")["components"]
    kernels = []
    for codec, vq in variants:
        name, s_ret = names[codec, vq], seismic[codec, vq]
        arrays = s_ret.arrays
        ids_c, sc_c = results["seismic", codec, vq]
        s_torch = Retriever(s_ret.cfg.replace(backend="torch"), arrays, n_docs=s_ret.n_docs,
                            dim=s_ret.dim, value_scale=s_ret.value_scale,
                            value_format=s_ret.value_format)
        ids_t, sc_t = s_torch.search(Q)
        n_swapped = same_topk(ids_c, sc_c, ids_t, sc_t)
        ids_np = ids_c.cpu().numpy()
        recall = float(np.mean([recall_at_k(truth[i][0], ids_np[i]) for i in range(nq)]))
        lat = host_ms(lambda: s_ret.search(Q), 10)
        lat_t = host_ms(lambda: s_torch.search(Q), 5)
        comp_bytes = fwd.storage_bytes(codec)["components"]
        bits = 8 * comp_bytes / fwd.total_nnz
        shapes = []
        for shape, docs in (("seismic", docs_s), ("flat", docs_f)):
            err = check_kernel(codec, f"{name} @ {shape}", Q, docs, arrays, scale)
            max_err[codec, vq] = max(max_err[codec, vq], err)
            slow = shape == "flat"
            ms = cuda_ms(lambda: rows_dot.rows_scores_for_codec(codec, arrays, Q, docs, scale),
                         10 if slow else 20)
            plain_ms = cuda_ms(lambda: rows_dot.rows_scores_plain(codec, arrays, Q, docs, scale),
                               2 if slow else 3, 1)
            bound_ms, bound_by = rows_bound(codec, Q, docs, arrays)
            shapes.append(dict(shape=shape, nq=nq, nd=docs.shape[0], C=docs.shape[1],
                               stage=rows_dot.pick_stage(nq, docs.shape[0]),
                               launches_per_search=per_search.get((shape, codec, vq)),
                               ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                               library_ms=lib_ms if slow else None, max_abs_err=err))
        if codec == "uncompressed" and vq == "f16":
            got = rows_dot.rows_scores_for_codec(codec, arrays, Q, docs_f, scale)[:, :-1]
            torch.testing.assert_close(got, lib_out, rtol=1e-4, atol=1e-4)
        flat_note = ""
        if (codec, vq) in flat:
            ids_f, sc_f = (t.cpu().numpy() for t in results["flat", codec, vq])
            f_recall = float(np.mean([recall_at_k(truth[i][0], ids_f[i]) for i in range(nq)]))
            if vq == "f16":
                for i, (t_ids, t_sc) in enumerate(truth):
                    if not np.array_equal(ids_f[i], t_ids):
                        raise SystemExit(f"{name}: flat ids differ from exact_top_k at query {i}")
                    np.testing.assert_allclose(sc_f[i], t_sc, rtol=1e-5, atol=1e-4)
            f_lat = host_ms(lambda: flat[codec, vq].search(Q), 5)
            flat_note = (f"; flat {'ids == exact_top_k, ' if vq == 'f16' else ''}"
                         f"recall@10 {f_recall:.4f}, median "
                         f"{statistics.median(f_lat):.3f} ms/batch")
        s, f = shapes
        log(f"  {name}: seismic cuda==torch ({n_swapped} tied swaps), recall@10 {recall:.4f}, "
            f"median {statistics.median(lat):.3f} ms/batch of {nq} (min {min(lat):.3f}; "
            f"backend=torch {statistics.median(lat_t):.3f}){flat_note}")
        log(f"    {bits:.2f} bits/comp ({100 * (1 - comp_bytes / raw_bytes):.1f}% saved vs "
            f"16 raw), rows {row_bytes[codec, vq] / 2**20:.1f} MiB; kernel @seismic "
            f"{s['ms']:.4f} ms (plain {s['plain_ms']:.3f}, bound {s['bound_ms']:.4f} "
            f"{s['bound_by']}), @flat {f['ms']:.4f} ms (plain {f['plain_ms']:.3f}, bound "
            f"{f['bound_ms']:.4f} {f['bound_by']}, sparse.mm {lib_ms:.4f}) ({card})")
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/rows_dot.cu",
            "replaces": "src/repro/kernels/rows_dot.py:190",
            "launches": launches[name],
            "max_abs_err": max_err[codec, vq],
            "ms": s["ms"],
            "plain_ms": s["plain_ms"],
            "bound_ms": s["bound_ms"],
            "bound_by": s["bound_by"],
            "library_ms": None,
            "at_shapes": shapes,
            "recall_at_10": recall,
            "search_ms_median": statistics.median(lat),
            "search_ms_median_torch_backend": statistics.median(lat_t),
            "bits_per_component": bits,
            "row_bytes": row_bytes[codec, vq],
        })
    dv = seismic["dotvbyte", "f16"].arrays
    kernels[[k["name"] for k in kernels].index(names["dotvbyte", "f16"])]["stage_sweep"] = \
        stage_sweep("rows kernel at the flat shape, dotvbyte f16",
                    lambda Qn, st: rows_dot.rows_scores_for_codec("dotvbyte", dv, Qn, docs_f,
                                                                  scale, stage=st), Q, card)
    device_breakdown("seismic dotvbyte f16", lambda: base.search(Q), card)
    device_breakdown("flat dotvbyte f16", lambda: flat["dotvbyte", "f16"].search(Q), card)
    shutil.rmtree(ROOT / "build" / "chip_smoke", ignore_errors=True)
    phase_s["4 checks + timings"] = time.perf_counter() - t0

    # -- 5. the full scan ------------------------------------------------------------
    t0 = time.perf_counter()
    log(f"[5] full scan of the {fwd.n_docs}-doc collection (nq={nq}):")
    n_rows = len(kernels)
    kernels += full_scan(fwd, Q, truth, csr, card, block_err, fused_err)
    phase_s["5 full scan"] = time.perf_counter() - t0

    # -- 6. summary -------------------------------------------------------------
    log("phases: " + ", ".join(f"{k} {v:.1f}s" for k, v in phase_s.items()))
    log(f"ported kernels: {n_rows} rows_dot variants and {len(kernels) - n_rows} block-scan "
        f"entries ok; total {time.perf_counter() - t_start:.0f}s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
