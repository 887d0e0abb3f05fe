#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (``src/repro_torch/``) on one
NVIDIA GPU — the quickest proof that the port still starts on the card.

    python3 chip_smoke.py            # from the repository root

Phases (each prints its seconds); any failure exits non-zero and prints
no result:

1. device and build — the card's name and power limit; every CUDA kernel
   of the port built from ``src/repro_torch/kernels/csrc`` (one ``nvcc``
   per library: the rows kernel and the seven parts of the block-scan
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
   an f32 and a fixedu8 collection served with ``backend="cuda"``. The
   per-query form in both its stages (row warps, entry lanes), and the
   shared form at one query in every stage. One summation order in every
   stage (C2): for every variant, rows of 1, 8, 9, 128, 129 and 256
   entries (capacity 256) and of 257–3,430 (capacity 3,456), the shared
   form at nq 1, 7, 8 and 32 and the per-query form at 15 and 16 × 4,096
   in every stage that takes the shape, each stage's scores the same
   bits as the others'. Every
   block-scan entry (dotvbyte, streamvbyte and bitpack at the per-block
   width, single and batched; bitpack at each static width its packs
   hold) against its plain version in both output modes — slot scores,
   and the fused scan (scores of documents in every stage that takes the
   batch: the single query also in the resident-query stage where the
   query fits in shared memory; the static widths added into one
   result) against the slot scores scattered —
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
   and DotVByte at the three quantized value codecs.
   ``Retriever.search`` runs the plan of its batch's bucket: a first
   search warms it eagerly, captures it as one CUDA graph and replays it.
   The kernels' launch counts are zeroed just before this phase and read
   just after, the eager warm-ups from the wrappers' counts and the
   replays from each plan's record of the launches its graph holds:
   every variant launched, each plan holds the launches of its warm-up,
   and every Seismic launch took the row-warp stage;
4. checks and timings, per variant — Seismic ids equal to
   ``backend="torch"`` (tie-aware: a position may differ only where the
   two scores agree within rtol 1e-5), f16 flat ids equal to
   ``exact_top_k``, recall@10, search latency on both backends (host
   clock around ``torch.cuda.synchronize()``, after a warm-up; the
   replayed plan and the engine run eagerly), bits per component
   (``ForwardIndex.storage_bytes``) and stored row bytes, and the
   kernel's time (CUDA events) beside its plain version and its bound at
   the Seismic shape (both stages) and the flat shape, with
   ``torch.sparse.mm`` (cuSPARSE) over the same scores as the flat
   shape's library yardstick; Seismic search latency with the row-warp
   stage and, in turns with it, with the entry-lane stage it replaced;
   the stage sweep of the rows kernel at the flat shape (every stage at
   nq 1–64 where it takes the batch);
5. the full scan — the same collection packed into blocks (T = 512)
   for dotvbyte, streamvbyte and bitpack, every document scored through
   ``ops.score_*_batch`` (nq = 64), ``ops.score_*`` and
   ``score_bitpack_bucketed``, which run the fused kernel (the block
   scan with its scatter in the epilogue). The block-scan launch counts
   are zeroed just before and read just after: every entry must have
   launched the fused mode, no slot-score launch, and every single-query
   launch the resident-query stage. Each result is
   held against ``torch.sparse.mm`` over the uncompressed CSR (rtol =
   atol = 1e-4) and its top-10 against ``exact_top_k``; the fused call
   (in every stage that takes it), the whole entry, the slot-score
   kernel, both plain
   versions, the bound and the library call are timed, the stage sweep
   of the fused call is taken, and the profile of the batched entry
   must show no ``index_add_``;
6. the hnsw engine — one host graph (the reference CLI's parameters:
   beam 64, 64 steps, 8 seeds, m 16, ef_construction 48) over the first
   ``--hnsw-docs`` documents (default 2,500: the build is Python
   insertion loops) with the same 64 queries, every rows variant served
   by swapping only its packed rows (dotvbyte/f16 saved and reopened
   with ``open_retriever``), searched with ``backend="cuda"``. Counts are
   zeroed just before and read just after (warm-ups and plan replays, as
   in phase 3): every search's plan holds 1 + iters rows launches, as its
   warm-up launched, in the stages ``pick_stage`` names for 8 seeds and
   M0 = 32 neighbours. Per variant: ids tie-aware equal to
   ``backend="torch"``, recall@10 against ``exact_top_k`` over the
   prefix, latency on both backends, graph bytes and bits per
   component, and the kernel at the graph's shape (nq 64 × C 8 and 32)
   in both stages beside its plain version and bound; the sweep over C
   at nq 64, 8 and 1 behind ``ROW_WARPS_MIN_ROWS``; and the wrapper's
   host time a launch;
7. the serving pipeline (``serve/pipeline.py``) over the Seismic, hnsw
   and flat retrievers of phases 3 and 6: every bucket of
   ``DEFAULT_BUCKETS`` captured (its capture time and graph pool bytes
   printed) and its replay held bit for bit against the engine run
   eagerly on the same padded batch, full and ragged; the same at bucket
   64 for all 16 variants of each engine; a synthetic trace of 256
   requests (seed 0, repeat share 0.25) through ``Pipeline`` (deadline
   1000 µs, cache 1024) per engine with every response held to direct
   search bit for bit, whatever stages its bucket took
   (``launch/serve.py::trace_parity``), its launches counted from
   zero, and the ServeStats line; and per engine, replayed against
   eager, the host-clock median of 10 searches and one profile of 5
   (device busy time, idle share, kernels a search, the rows kernel's
   device time a launch);
8. sharded, out-of-core serving (``serve/sharded.py``), dotvbyte/f16,
   the 64 queries, S = 4 shards: flat over all the collection's docs,
   Seismic over the first ``--shard-docs`` (default 5,000: its per-shard
   host build is phase 3's Python loops) and hnsw over the first 2,000
   (at most ``--hnsw-docs``). Each is built
   (``Retriever.build`` at ``n_shards=4``), saved uncompressed, reopened
   with ``open_retriever`` (every shard array an ``np.memmap``) and
   served with ``backend="cuda"`` at ``max_resident`` 4 and 1, prefetch
   on and off. Checks: prefetch on equals off and ``max_resident`` 4
   equals 1 bit for bit; flat held to phase 3's monolithic flat retriever
   bit for bit and Seismic and hnsw to their ``backend="torch"`` sharded
   twins (ids tie-aware, scores within rtol 1e-5), with recall@10 against
   ``exact_top_k``; ``prefetch_hits > 0`` by the second rotation; each
   search replays one plan per shard (the rows launches its graphs hold:
   S, or S × (1 + iters) for hnsw); ``set_tombstones`` on 3 ids keeps
   them out of every answer, retires the stale staged shard and equals a
   prefetch-off twin; memory allocated after the third rotation at
   ``max_resident=1`` is the first's within one shard's arrays and one
   graph pool; with prefetch off the peak resident bytes are at most half
   the whole index's. Printed per engine and setting: the host-clock
   median of 10 searches, admission split into page-in, host→device copy
   and capture, hits, misses, evictions, plan creations, peak resident
   and graph pool bytes, and the rows launches a search with their
   stages. Then a 256-request trace of the flat tree at ``max_resident=1``
   through ``ShardedRetriever.pipeline()``, held to direct sharded search
   bit for bit by ``trace_parity``, with its ServeStats line and prefetch
   counters.
   The kernels' counts are zeroed just before this phase and read just
   after; the flat tree is kept for phase 9;
9. live mutation (``serve/segments.py``), dotvbyte/f16, the 64 queries:
   phase 3's flat and Seismic retrievers (100,000 docs) and phase 6's
   hnsw one, each wrapped by a ``MutableRetriever`` (stable ids
   ``arange``, nothing rebuilt), take three seeded rounds from an insert
   pool of 2,048 docs of a second collection (seed 1) — hnsw at beam 512,
   since a part's budget k + its tombstones must fit the beam (``top_k``
   raises past it, as the reference does): insert 1 doc and
   delete 64 base ids (the first 20 one at a time, each followed by a
   search: memory allocated after the 20th must be the first's within
   one graph pool); insert 64 and update 32; insert 1,024, then delete
   256 ids spread over the base and the segments, the one-doc segment's
   doc among them. After each round: flat ids equal the exact top-k of
   ``live_corpus()`` (its row scores taken once and assembled per part,
   checked against ``exact_scores`` over ``live_corpus()``), Seismic and
   hnsw ids tie-aware equal to a ``backend="torch"`` twin of the same
   mutable index, recall@10, no deleted id served, every search one
   replayed plan per part, and a 256-request trace through
   ``m.pipeline()`` held to direct search bit for bit by ``trace_parity``
   with at least one cache invalidation. Then ``merge(background=True)``
   with the 64 queries streaming through the flip (each response the
   generation before or after it bit for bit), the first search after
   the flip timed: flat
   over its whole live corpus, Seismic over a base of the first 2,000
   docs and hnsw of the first 500 (the same rounds scaled to the base;
   their host builds are Python loops). A saved root crashed before its
   flip reopens with ``open_retriever`` at the committed generation, bit
   for bit; a mutable index over phase 8's 4-shard flat tree routes its
   deletes through ``set_tombstones``. Printed: search ms at 0–4
   segments; each mutation's host ms, its first search's ms, the plans
   it captured, their capture ms and pool MiB; allocated memory over the
   delete run; ``merge_wall_us``, ``blocked_swap_us``, the first search
   after the flip; the ServeStats lines. The kernels' counts are zeroed
   just before this phase and read just after;
10. the SPLADE encoder and its training (``models/``, ``train/``) at the
   full width, ``SparseEncoderConfig()`` (40,897,850 parameters), f32
   matmuls at full precision: a 4 × 128 batch (half of its positions
   masked, one row wholly) encoded on the card and on the CPU from the
   same weights (pooled output within rtol = atol = 1e-4); every leaf's
   gradient within 1e-3 of its norm (the contrastive scores reach ~6e4,
   which f32 resolves in steps of ~0.004); one AdamW step — loss,
   grad_norm and lr within rtol 1e-4, every updated parameter AdamW's
   first step on the card's own clipped gradient and, where both
   devices' clipped gradients share a sign on the step's flat part
   (|g| ≥ 1e3 eps), the CPU's within rtol 1e-4; one QAT step at a clip
   inside the activations' range (``quant_hi``'s gradient and update
   finite). Then ``--encoder-steps`` (default 50) of the example's
   stream (batch 16 × seq 24, AdamW lr 1e-3, warmup 20) through
   ``Runner`` with checkpoints every 25 steps under
   ``build/chip_smoke/``, twice under
   ``torch.use_deterministic_algorithms(True)`` — with a fault at step 30
   and without — the final states equal bit for bit, the loss falling,
   the last checkpoint restored onto the CPU equal to the card's state;
   the median of 10 train steps at 16 × 24 and 32 × 128 (tokens/s, peak
   memory, 6 · params · tokens over the f32 peak, reported; a profile of
   3 steps: device busy time and kernels a step), encode docs/s at
   32 × 128, checkpoint save and restore time and size. Last,
   ``--encoder-docs`` (default 1,488, the example's count) documents
   and 64 queries encoded by the trained encoder (learned nnz/doc,
   bits/comp for the four row codecs), served flat through the rows
   kernel for every row codec at f16 (ids = ``exact_top_k``,
   tie-aware), Seismic dotvbyte/f16 over the first 50 (after 50 steps
   a document holds ~3,400 terms, and the host build, Python loops,
   takes ~0.3–0.4 s a document; ids = its torch twin, tie-aware; recall@10;
   search ms) and
   the host ``SeismicIndex.search`` over the same (recall@10). The
   kernels' counts are zeroed just before the serving part and read
   just after (``launches_by_path["encoder"]``);
11. RGB and the LiLSR configuration, at the full width (dim 30,522):
   Recursive Graph Bisection (the reference Table 1's ``max_iters=6``,
   ``leaf_size=32``, seed 0; numpy on the host) over the first
   ``RGB_DOCS`` documents (50,000) of phase 3's collection,
   bits per component of all nine codecs before and after; the full scan
   (``ops.score_*_batch`` at nq 64 and ``ops.score_*`` at nq 1, dotvbyte,
   streamvbyte and bitpack) over the permuted pack with permuted queries
   (``apply_permutation_dense``), held to ``torch.sparse.mm`` over the
   permuted CSR and, top-10, to ``exact_top_k`` of the unpermuted prefix,
   timed beside the unpermuted pack; flat over the permuted rows for the
   four row codecs at f16 (ids = ``exact_top_k``, tie-aware). Then the
   CLI in-process, ``launch.serve.main`` with ``--encoder lilsr --engine
   all --compare-codecs --device cuda`` over ``LILSR_CLI_DOCS`` (500:
   the Seismic and hnsw host builds are Python loops) LiLSR-statistics
   documents (387 entries a document, 6 a query): recall@10 identical
   across codecs for every engine, the rows kernel's stages printed; and
   flat over ``LILSR_FLAT_DOCS`` (5,000) LiLSR documents (rows past
   256 entries) for the four row codecs, ids = ``exact_top_k``. The
   kernels' counts are zeroed just before this phase and read just after
   (``launches_by_path["rgb_lilsr"]``);
12. the mesh fan-out on ``torch.distributed`` — ranks are spawned
   processes (``launch.mesh.spawn_ranks``: ``file://`` rendezvous, a
   deadline that kills every rank and fails the phase) that load the
   kernels phase 1 built, and start while the parent makes their inputs.
   (a) one NCCL rank: ``make_sharded_search`` over
   ``build_shard_arrays(n_shards=1, host_index=phase 3's index)`` (100,000
   docs, dotvbyte/f16, the CLI's Seismic parameters) equals phase 3's
   Seismic ids and scores bit for bit. (b) four gloo ranks, all on
   ``cuda:0``, each holding one shard: ``ShardedRetriever(use_mesh=True)``
   over phase 8's trees (flat over 100,000 docs, Seismic over 5,000, hnsw
   over 2,000, kept in ``build/chip_smoke_trees``) equals phase 8's
   sequential answer bit for bit on every rank, and the sequential
   rotation's after ``set_tombstones`` with 5 victims; and
   ``make_sharded_search`` over ``build_shard_arrays(S=4, host_index=...)``
   equals an in-process oracle (each shard's ``search_batch`` on the card
   in turn, then the same merge) bit for bit. (c) the doc-aligned scan
   (``scoring.make_doc_aligned_scan``) of ``pack_blocks_sharded`` of the
   100,000 docs at S = 4, T = 512, D = 64 for dotvbyte, streamvbyte and
   bitpack at nq 64 and 1, the ranks' slices held to ``torch.sparse.mm``
   (rtol = atol = 1e-4) and, top-10, to ``exact_top_k``. (d) the
   compressed data-parallel step: the reference test's quadratic problem
   for 300 steps at world 1 (NCCL) and world 2 (gloo on ``cuda:0``) ends
   below loss 0.01 and |w − w*| 0.2 with bit-identical replicas; 5 steps
   of the full ``SparseEncoderConfig()`` at 16 × 24 split over 2 gloo
   ranks keep the loss finite and the replicas bit-identical after every
   step, step 0's loss equal to the plain step's within 1e-4. Logs the
   backends, per-rank search ms beside phase 8's sequential ms, the
   all-gather's bytes a query (8·k·S) and ms, the scan ms a rank and the
   step ms: four ranks share one card, so these show overheads, not
   scaling. The ranks' rows and block-scan launches go to
   ``launches_by_path["mesh"]``;
13. one JSON line of kernels, the card line, and as the last line
   ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import hashlib
import json
import os
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


def eager_search(ret, Q):
    """``ret``'s engine search run eagerly on ``Q`` — the path a plan
    captures, launched op by op."""
    return ret.impl.search_batch(ret.cfg, ret.n_docs, ret.value_scale, ret.arrays, Q)


def search_plan(ret, nq: int):
    """The plan ``ret.search`` runs for a batch of ``nq`` queries."""
    return ret.plans.get(ret.plans.bucket_for(nq))


def replay_marks(retrievers) -> dict:
    """Each plan of ``retrievers`` → its replays so far."""
    return {p: p.replays for r in retrievers for p in r.plans.created().values()}


def path_launches(retrievers, marks: dict) -> tuple[dict, dict]:
    """The rows kernel's launches on a path since the counts were zeroed
    and ``marks`` taken, per variant and per stage: the wrapper's counts
    (the eager launches — each plan's warm-up before its capture) plus,
    for every plan of ``retrievers``, the launches its CUDA graph holds
    times its replays since."""
    from repro_torch.kernels import rows_dot

    variants, stages = dict(rows_dot.variant_launches), dict(rows_dot.stage_launches)
    for r in retrievers:
        for p in r.plans.created().values():
            n = p.replays - marks.get(p, 0)
            for k, c in p.launches["variants"].items():
                variants[k] += c * n
            for k, c in p.launches["stages"].items():
                stages[k] += c * n
    return variants, stages


def device_breakdown(name: str, fn, card: str, reps: int = 5, out: dict | None = None) -> set[str]:
    """Print one search's device busy time, idle share and top kernels,
    from ``torch.profiler`` over ``reps`` warm calls → the names of every
    host op and kernel traced. ``out``, where given, receives the wall and
    busy ms per call and each kernel's (device ms, launches) per call."""
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
    if out is not None:
        out.update(wall_ms=wall_ms, busy_ms=total,
                   kernels={e.key: (busy[e.key], e.count / reps) for e in kernels})
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
    """ptxas' ``-v`` lines per kernel variant (by template args) and
    stage: rows ``<codec, vq, value storage>`` (query lanes also by the
    queries a lane, ``/2`` or ``/4``) and block scan ``<code, value
    storage, seg storage>`` (its resident-query kernel marked)."""
    from repro_torch.kernels import block_scan, rows_dot
    from repro_torch.core.values import VALUE_CODECS

    out, cur = {}, None
    for line in log_text.splitlines():
        rows = re.search(r"rows_dot_(shared_|warp_)?kernelILi(\d)ELi(\d)E(f|6__half|h)?(?:Li(\d)E)?",
                         line)
        scan = re.search(r"block_scan_(resident_)?kernelILi(\d+)E(f|6__half|h)(i|a)E", line)
        if (rows or scan) and ("Compiling entry" in line or "Function properties" in line):
            if rows:
                cur = rows_dot.variant_name(rows_dot.CODECS[int(rows[2])],
                                            VALUE_CODECS[int(rows[3])])
                if rows[4] and VALUE_CODECS[int(rows[3])] == "f16":  # the stored dtype
                    cur += f"[{_MANGLED[rows[4]]}]"
                cur += {"shared_": f" query lanes/{rows[5]}", "warp_": " row warps"}.get(
                    rows[1], " entry lanes")
            else:
                code = int(scan[2])
                codec = block_scan.CODECS[min(code, 2)] + (f"_w{code - 2}" if code > 2 else "")
                cur = (f"block_scan_{codec}[{_MANGLED[scan[3]]},{_MANGLED[scan[4]]}"
                       + (" resident]" if scan[1] else "]"))
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
    once), 4 nnz bytes a row, the 32-byte sectors of Q that the rows'
    components touch (:func:`q_sector_bytes`) and the ids — and the nq×C
    f32 scores written once; against one multiply-add (2 FLOP) per
    (query, live entry) at the f32 peak."""
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
    n_bytes = int((payload + values + 4).sum()) + q_sector_bytes(codec, Q, docs, arrays)
    n_bytes += 4 * nd * C + 4 * nq * C
    n_bytes += 4 * value_codecs.PQ_K * value_codecs.PQ_M if vq == "pq" else 0
    pairs = int(arrays["nnz_rows"][docs.long()].long().sum()) * (nq if nd == 1 else 1)
    t_bytes = 1e3 * n_bytes / HBM_BYTES_PER_S
    t_ops = 1e3 * 2 * pairs / F32_FLOP_PER_S
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def q_sector_bytes(codec: str, Q, docs, arrays) -> int:
    """Bytes of ``Q`` a rows call must read: the distinct (query, 32-byte
    sector) pairs that the live components of each query's candidate
    rows fall in, 32 bytes each (a sector is the least the memory moves;
    sectors are counted on Q's flat addresses, so a row that does not
    start on a sector shares its edge sectors) — at most all of Q. At
    Seismic's and the flat shape nearly every sector is read; at the
    hnsw engine's few rows a query, a small part."""
    from repro_torch.core.scoring import _gather_decode_rows

    nq, dim = Q.shape
    nd, C = docs.shape
    per_set = torch.arange(nd, device=Q.device).view(-1, 1, 1) * dim
    keys, step = [], max(1, (1 << 16) // nd)  # 65,536 rows a chunk
    for c0 in range(0, C, step):
        comps, _, nnz = _gather_decode_rows(codec, arrays, docs[:, c0 : c0 + step])
        live = torch.arange(comps.shape[-1], device=Q.device) < nnz.unsqueeze(-1)
        if nd == 1:  # one set for every query: its distinct components, placed per query below
            keys.append(comps[live].long().unique())
        else:
            keys.append(((per_set + comps.long())[live] >> 3).unique())
    keys = torch.cat(keys).unique() if keys else torch.zeros(0, dtype=torch.long)
    if nd == 1:
        at = torch.arange(nq, device=Q.device).view(-1, 1) * dim
        keys = ((at + keys.to(Q.device)) >> 3).unique()
    return min(32 * keys.numel(), 4 * nq * dim)


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


#: C2's row lengths: on both sides of the group (8), half-warp chunk
#: (128) and warp (256) edges at capacity 256, and past it
STAGE_LENGTHS = (1, 8, 9, 128, 129, 256)
LONG_LENGTHS = (257, 511, 513, 700, 1100, 3430)
#: the shared form's batch sizes (130: both 64-query passes of a query-lane
#: tile and a second tile) and the per-query form's (nq x C) shapes
STAGE_NQ = (1, 7, 8, 32, 130)
STAGE_PER_QUERY = ((15, 4096), (16, 4096))


def length_docs(dim: int, lengths, rng, n_random: int = 60):
    """One document of each length, then random ones of 1-199 entries."""
    ns = list(lengths) + [int(n) for n in rng.integers(1, 200, size=n_random)]
    return [(np.sort(rng.choice(dim, size=n, replace=False)),
             rng.gamma(2.0, 0.5, size=n).astype(np.float32)) for n in ns]


def stages_agree(codec, name, Q, docs, arrays) -> list[str]:
    """Every stage that takes the shape, on the card: the same bits (one
    summation order, C2), and the plain version's within RTOL/ATOL →
    the stages compared. These launches compare; they are not the main
    path's."""
    from repro_torch.kernels import rows_dot

    nq, nd, C = Q.shape[0], docs.shape[0], docs.shape[1]
    stages = [st for st in rows_dot.STAGES
              if _takes(rows_dot.pick_stage, nq, nd, st, dim=Q.shape[1], C=C)]
    outs = {st: rows_dot.rows_scores_for_codec(codec, arrays, Q, docs, 0.5, stage=st)
            for st in stages}
    torch.cuda.synchronize()
    ref = outs[stages[0]].view(torch.int32)
    for st in stages[1:]:
        differ = int((outs[st].view(torch.int32) != ref).sum())
        if differ:
            raise SystemExit(f"{name} nq={nq} nd={nd} C={C}: {st} differs from {stages[0]} in "
                             f"{differ} scores' bits")
    check_kernel(codec, f"{name} nq={nq} nd={nd} C={C}", Q, docs, arrays, 0.5, stages[0])
    return stages


def same_topk(ids_a, sc_a, ids_b, sc_b) -> int:
    """Tie-aware top-k equality → the number of positions whose ids
    differ; raises where a differing position's two scores do not agree
    within TIE_RTOL."""
    diff = ids_a != ids_b
    if diff.any() and not torch.allclose(sc_a[diff], sc_b[diff], rtol=TIE_RTOL, atol=0):
        raise SystemExit("top-k ids differ at positions whose scores are not tied")
    torch.testing.assert_close(sc_a, sc_b, rtol=1e-5, atol=1e-4)
    return int(diff.sum())


def bitwise(what: str, got, want) -> None:
    """Ids equal and scores the same bits, or exit: every rows-kernel
    stage sums a dot in one order, so no answer of the card depends on the
    batch or the stage it rode in."""
    gi, gs = (torch.as_tensor(np.asarray(x.cpu() if torch.is_tensor(x) else x)) for x in got)
    wi, ws = (torch.as_tensor(np.asarray(x.cpu() if torch.is_tensor(x) else x)) for x in want)
    if not (torch.equal(gi.long(), wi.long())
            and torch.equal(gs.float().view(torch.int32), ws.float().view(torch.int32))):
        raise SystemExit(f"{what}: not bit for bit equal")


def rows_stages(nq: int, nd: int, dim: int, C: int) -> list[str]:
    """The rows kernel's stages that take ``nq`` queries over ``nd`` sets
    of ``C`` rows."""
    from repro_torch.kernels import rows_dot

    return [st for st in rows_dot.STAGES
            if _takes(rows_dot.pick_stage, nq, nd, st, dim=dim, C=C)]


def scan_stages(nq: int, dim: int, T: int, D: int) -> list[str]:
    """The block scan's stages that take ``nq`` queries at this shape."""
    from repro_torch.kernels import block_scan

    return [st for st in block_scan.STAGES if _takes(
        block_scan.pick_stage, nq, st, dim=dim, block_size=T, slots=D)]


def _takes(pick, *args, **kw) -> bool:
    try:
        pick(*args, **kw)
        return True
    except ValueError:
        return False


@contextlib.contextmanager
def rows_stage(stage: str):
    """Every rows-kernel call inside takes ``stage``: how the smoke times
    a search on the stage the wrapper no longer picks."""
    from repro_torch.kernels import rows_dot

    pick = rows_dot.pick_stage
    rows_dot.pick_stage = lambda nq, nd, st=None, *, dim, C: pick(nq, nd, st or stage,
                                                                  dim=dim, C=C)
    try:
        yield
    finally:
        rows_dot.pick_stage = pick


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


def scan_fn(codec: str, batched: bool):
    """The block-scan entry ``<codec>_block_scores[_batch]``."""
    from repro_torch.kernels import block_scan

    return getattr(block_scan, f"{codec}_block_scores" + ("_batch" if batched else ""))


def scan_args(packed) -> list:
    """The block-scan entry's stream arguments of a pack held as tensors."""
    keys = ("ctrl", "data") if packed.codec != "bitpack" else ("words", "widths")
    return [getattr(packed, k) for k in (*keys, "seg", "start_pos", "start_abs", "vals")]


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
    T, D = packed.block_size, packed.max_docs_per_block
    for stage in scan_stages(1, Q.shape[1], T, D):  # the single query's slots, every stage
        got = block_scan.block_scores(entry, codec, Q[:1], streams, scale=scale, stage=stage)
        errs[entry] = max(errs[entry], check_close(f"{name} single {stage}", got, plain[:1]))
    fused = {f"{entry}_batch": 0.0, entry: 0.0}
    for e, Qx, want in ((f"{entry}_batch", Q, plain_docs), (entry, Q[:1], plain_docs[:1])):
        for stage in scan_stages(Qx.shape[0], Q.shape[1], T, D):
            got = block_scan.scan_scores(e, codec, Qx, streams, ids, n_docs, scale=scale,
                                         stage=stage)
            fused[e] = max(fused[e], check_close(f"{name} {e} fused {stage}", got, want))
    widths = []
    if codec == "bitpack":
        err_w, total, want_total = 0.0, None, torch.zeros_like(plain_docs[:1])
        for w, sel, b, b_ids in ops.width_buckets(packed):
            got = block_scan.bitpack_block_scores_w(Q[0], *b.values(), width=w, scale=scale)
            want = block_scan.block_scores_plain("bitpack", Q[:1], b, scale=scale, width=w)[0]
            err_w = max(err_w, check_close(f"{name} width {w}", got, want))
            total = block_scan.scan_scores("block_scan_bitpack_w", "bitpack", Q[:1], b,
                                           b_ids, n_docs, scale=scale, width=w, out=total)
            want_total += scatter_block_scores(want.unsqueeze(0), b_ids, n_docs)
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
    single = sum(v for k, v in launches.items() if not BLOCK_ENTRIES[k][1])
    if stages["resident_query"] != single:
        raise SystemExit(f"{stages['resident_query']} resident-query launches for {single} "
                         "single-query launches: one query at this shape must take that stage")

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
        stages_here = scan_stages(Qx.shape[0], dim, p.block_size, p.max_docs_per_block)
        if entry == "block_scan_bitpack_w":
            buckets = [(w, b, ids) for w, _, b, ids in ops.width_buckets(p)]

            def kernel():
                return [block_scan.bitpack_block_scores_w(q0, *b.values(), width=w, scale=scale)
                        for w, b, _ in buckets]

            def plain():
                return [block_scan.block_scores_plain("bitpack", Qx, b, scale=scale, width=w)[0]
                        for w, b, _ in buckets]

            def fused_call(stage=None):
                total = None
                for w, b, ids in buckets:
                    total = block_scan.scan_scores(entry, "bitpack", Qx, b, ids, p.n_docs,
                                                   scale=scale, width=w, out=total, stage=stage)
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
        max_err[entry] = max(max_err.get(entry, 0.0), err)
        # the fused call in every stage that takes it, each held against its plain version
        want_fused = fused_plain()
        for st in stages_here:
            f_err = check_close(f"{entry} @ 100k fused {st}", fused_call(st), want_fused)
            fused_err[entry] = max(fused_err.get(entry, 0.0), f_err)
        stage_ms = {st: cuda_ms(lambda: fused_call(st), 10 if batched else 20)
                    for st in stages_here}
        ms = cuda_ms(kernel, 10 if batched else 20)
        fused_ms = cuda_ms(fused_call, 10 if batched else 20)
        entry_ms = cuda_ms(whole, 10 if batched else 20)
        plain_ms = cuda_ms(plain, 2 if batched else 3, 1)
        fused_plain_ms = cuda_ms(fused_plain, 2 if batched else 3, 1)
        stage = block_scan.pick_stage(Qx.shape[0], dim=dim, block_size=p.block_size,
                                      slots=p.max_docs_per_block)
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
    pd = packs["dotvbyte"]
    out[list(BLOCK_ENTRIES).index("block_scan_dotvbyte_batch")]["stage_sweep"] = stage_sweep(
        "fused block scan, dotvbyte", lambda Qn, st: block_scan.scan_scores(
            "block_scan_dotvbyte_batch", "dotvbyte", Qn,
            {k: v for k, v in pd.as_dict().items() if k != "doc_ids"},
            pd.doc_ids, fwd.n_docs, stage=st), Q, card,
        lambda n: scan_stages(n, dim, pd.block_size, pd.max_docs_per_block))
    ops_seen = device_breakdown("full scan dotvbyte batch", lambda: ops.score_dotvbyte_batch(
        Q, packs["dotvbyte"]), card)
    if any("index_add" in k for k in ops_seen):
        raise SystemExit("the batched full scan still runs an index_add_ scatter")
    log("    the batched full scan ran no index_add_ (profiler: "
        f"{len(ops_seen)} distinct host ops and kernels)")
    device_breakdown("full scan dotvbyte single", lambda: ops.score_dotvbyte(q0, packs[
        "dotvbyte"]), card)
    return out


def stage_sweep(name: str, call, Q, card: str, stages_for) -> dict:
    """Device time of ``call(Q[:n], stage)`` in every scoring stage that
    ``stages_for(n)`` gives, at every batch size of SWEEP_NQ → ``{stage:
    {nq: ms}}``; the data behind the stage thresholds."""
    out = {}
    for n in SWEEP_NQ:
        Qn = Q[:n].contiguous()
        for st in stages_for(n):
            out.setdefault(st, {})[n] = cuda_ms(lambda: call(Qn, st), 10)
    log(f"    stage sweep, {name} (ms; {card}): " + "; ".join(
        f"nq {n}: " + ", ".join(f"{st} {ms[n]:.4f}" for st, ms in out.items() if n in ms)
        for n in SWEEP_NQ))
    return out


#: a rows kernel's name in a profile → (stage prefix, codec index, vq index)
_ROWS_KERNEL = re.compile(r"rows_dot_(shared_|warp_)?kernel<(\d), (\d)")
_ROWS_STAGE = {"": "entry_lanes", "shared_": "query_lanes", "warp_": "row_warps"}


def rows_device_ms(calls: dict, stages, reps: int = 20) -> dict:
    """Device time of the rows kernel per launch, per variant and stage,
    from ONE ``torch.profiler`` session over ``reps`` rounds of
    ``calls[variant](stage)`` for every variant and stage (the kernel's
    name tells them apart) → ``{variant: {stage: ms}}`` (None where
    nothing was traced). At a few µs of work a launch the host cannot
    keep the card busy, so CUDA events around back-to-back calls time
    the host's call, not the kernel; this times the kernel."""
    from repro_torch.core.values import VALUE_CODECS
    from repro_torch.kernels import rows_dot
    from torch.profiler import ProfilerActivity, profile

    for call in calls.values():
        for st in stages:
            call(st)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            for call in calls.values():
                for st in stages:
                    call(st)
        torch.cuda.synchronize()
    sums = {}
    for e in prof.key_averages():
        m = _ROWS_KERNEL.search(e.key)
        if e.device_type != torch.autograd.DeviceType.CUDA or not m:
            continue
        key = (rows_dot.CODECS[int(m[2])], VALUE_CODECS[int(m[3])], _ROWS_STAGE[m[1] or ""])
        us, n = sums.get(key, (0.0, 0))
        sums[key] = (us + e.self_device_time_total, n + e.count)
    out = {}
    for v in calls:
        out[v] = {}
        for st in stages:
            us, n = sums.get((*v, st), (0.0, 0))
            out[v][st] = us / 1e3 / n if n else None
    return out


#: the hnsw engine's parameters: the reference CLI's search and graph
#: parameters (``repro/launch/serve.py``)
HNSW_PARAMS = dict(beam=64, iters=64, n_seeds=8, m=16, ef_construction=48)
#: batch size → candidates a set in the sweep behind the row-warp rule (one
#: set per query): at nq 64 the hnsw engine's 8 and 32 up to Seismic's
#: 4,096; one query up to the whole 100k collection and past it
SWEEP_C = {64: (8, 32, 64, 256, 512, 1024, 2048, 4096),
           8: (256, 1024, 4096, 8192, 16384, 32768),
           1: (256, 1024, 4096, 16384, 65536, 100_001, 131_072, 262_144)}


def _ms(v) -> str:
    return "not measured" if v is None else f"{v:.4f}"


def hnsw_phase(fwd, Q_np, Q, n_docs: int, card: str, max_err: dict, rows_full):
    """Phase 6: the hnsw engine over docs ``[0, n_docs)`` of the main
    collection, every rows variant over ONE host graph → (per variant its
    records — launches on this path, checks, timings at the graph's
    shape — plus the C sweep under ``"_phase"``; the retrievers by
    variant)."""
    from repro_torch.core.layout import pack_rows
    from repro_torch.core.seismic import exact_top_k, recall_at_k
    from repro_torch.kernels import rows_dot
    from repro_torch.serve.api import Retriever, RetrieverConfig, get_engine, open_retriever

    nq, dim = Q.shape
    dev = Q.device
    sub = fwd.slice(0, n_docs)
    cfg = RetrieverConfig(engine="hnsw", codec="dotvbyte", backend="cuda", k=10,
                          params=HNSW_PARAMS)
    iters, n_seeds = HNSW_PARAMS["iters"], HNSW_PARAMS["n_seeds"]
    t0 = time.perf_counter()
    index = get_engine("hnsw").host_index(sub, cfg)
    build_s = time.perf_counter() - t0
    m0 = index.params.degree(0)
    log(f"[6] hnsw over docs [0, {n_docs}) of the collection (dim {dim}, {nq} queries; beam "
        f"{HNSW_PARAMS['beam']}, iters {iters}, n_seeds {n_seeds}, m {index.params.m}, M0 {m0}, "
        f"ef_construction {index.params.ef_construction}): host graph built once in "
        f"{build_s:.1f}s ({1e3 * build_s / n_docs:.2f} ms/doc; {index.n_edges} edges, "
        f"{len(index.graph)} layers)")

    # the path: every variant searched once, counts zeroed just before and read just after
    t0 = time.perf_counter()
    rows_dot.reset_launches()
    built = Retriever.from_host_index(index, cfg)
    art = ROOT / "build" / "chip_smoke" / "hnsw-dotvbyte"
    built.save(art, compress=False)
    del built
    served = {("dotvbyte", "f16"): open_retriever(art)}
    graph = {k: served["dotvbyte", "f16"].arrays[k] for k in ("adj", "seeds")}
    results, per_search, stage_per = {}, {}, {}
    for codec, vq in rows_dot.VARIANTS:
        if (codec, vq) != ("dotvbyte", "f16"):
            rows = {k: torch.from_numpy(v).to(dev)
                    for k, v in pack_rows(sub, codec=codec, vq=vq).arrays().items()}
            served[codec, vq] = Retriever(
                cfg.replace(codec=codec, vq=vq), {**graph, **rows}, n_docs=sub.n_docs,
                dim=sub.dim, value_scale=float(sub.value_format.scale),
                value_format=sub.value_format.name)
        name = rows_dot.variant_name(codec, vq)
        before, stages_before = rows_dot.variant_launches[name], dict(rows_dot.stage_launches)
        results[codec, vq] = served[codec, vq].search(Q)  # warm-up, capture, replay
        torch.cuda.synchronize()
        plan = search_plan(served[codec, vq], nq)
        per_search[codec, vq] = plan.launches["variants"].get(name, 0)
        stage_per[codec, vq] = plan.launches["stages"]
        warm = {k: v - stages_before[k] for k, v in rows_dot.stage_launches.items()
                if v > stages_before[k]}
        if (rows_dot.variant_launches[name] - before, warm) != (per_search[codec, vq],
                                                                stage_per[codec, vq]):
            raise SystemExit(f"hnsw {name}: the warm-up launched {warm}, the captured plan "
                             f"holds {plan.launches}")
    launches, stages = path_launches(served.values(), {})
    seed_stage = rows_dot.pick_stage(nq, nq, dim=dim, C=n_seeds)
    step_stage = rows_dot.pick_stage(nq, nq, dim=dim, C=m0)
    want = {seed_stage: 0, step_stage: 0}
    want[seed_stage] += 1
    want[step_stage] += iters
    log(f"    hnsw main path in {time.perf_counter() - t0:.1f}s; launches (warm-ups + graph "
        f"replays): "
        + ", ".join(f"{k}={launches[rows_dot.variant_name(*k)]}" for k in per_search)
        + "; by stage " + ", ".join(f"{k}={v}" for k, v in stages.items())
        + f"; per search {want} (seeds C={n_seeds} {seed_stage}, steps C={m0} {step_stage})")
    bad = {k: (per_search[k], stage_per[k]) for k in per_search
           if per_search[k] != 1 + iters or stage_per[k] != want}
    if bad:
        raise SystemExit(f"hnsw searches did not launch the rows kernel 1 + {iters} times in "
                         f"the picked stages: {bad}")
    phase = {"build_s": build_s, "n_docs": n_docs, "n_edges": index.n_edges, "M0": m0,
             "params": HNSW_PARAMS, "stage_per_search": want}

    # checks and timings per variant
    truth = [exact_top_k(sub, Q_np[i], 10) for i in range(nq)]
    rng = np.random.default_rng(6)
    shape_docs = {  # the kernel at the graph's shape: the seeds, and 64 adjacency rows
        n_seeds: graph["seeds"].unsqueeze(0).expand(nq, -1).contiguous(),
        m0: graph["adj"][torch.from_numpy(rng.integers(0, n_docs, nq)).to(dev)].contiguous(),
    }
    scale = float(sub.value_format.scale)
    raw = sub.storage_bytes("uncompressed")["components"]
    out = {"_phase": phase}
    for codec, vq in rows_dot.VARIANTS:
        name = rows_dot.variant_name(codec, vq)
        ret = served[codec, vq]
        ids_c, sc_c = results[codec, vq]
        plain = Retriever(ret.cfg.replace(backend="torch"), ret.arrays, n_docs=ret.n_docs,
                          dim=ret.dim, value_scale=ret.value_scale,
                          value_format=ret.value_format)
        ids_t, sc_t = plain.search(Q)
        swaps = same_topk(ids_c, sc_c, ids_t, sc_t)
        ids_np = ids_c.cpu().numpy()
        recall = float(np.mean([recall_at_k(truth[i][0], ids_np[i]) for i in range(nq)]))
        ret.search(Q)  # warm
        lat = host_ms(lambda: ret.search(Q), 10)
        lat_eager = host_ms(lambda: eager_search(ret, Q), 10)
        plain.search(Q)
        lat_t = host_ms(lambda: plain.search(Q), 10)
        sizes = index.index_bytes(codec)
        bits = 8 * sizes["forward_components"] / sub.total_nnz
        shapes = []
        for C, docs in shape_docs.items():
            errs, call_ms = [], {}
            for st in rows_stages(nq, nq, dim, C):
                errs.append(check_kernel(codec, f"{name} @ hnsw C={C} {st}", Q, docs, ret.arrays,
                                         scale, st))
                call_ms[st] = cuda_ms(lambda: rows_dot.rows_scores_for_codec(
                    codec, ret.arrays, Q, docs, scale, stage=st), 50)
            max_err[codec, vq] = max(max_err[codec, vq], *errs)
            bound_ms, bound_by = rows_bound(codec, Q, docs, ret.arrays)
            shapes.append(dict(
                shape=f"hnsw C={C}", nq=nq, nd=nq, C=C,
                stage=rows_dot.pick_stage(nq, nq, dim=dim, C=C),
                launches_per_search=1 if C == n_seeds else iters, call_ms_by_stage=call_ms,
                plain_ms=cuda_ms(lambda: rows_dot.rows_scores_plain(
                    codec, ret.arrays, Q, docs, scale), 10, 1),
                bound_ms=bound_ms, bound_by=bound_by, library_ms=None, max_abs_err=max(errs)))
        log(f"  {name} hnsw: cuda==torch ({swaps} tied swaps), recall@10 {recall:.4f}, median "
            f"{statistics.median(lat):.3f} ms/batch of {nq} replayed (min {min(lat):.3f}; eager "
            f"{statistics.median(lat_eager):.3f}; backend=torch replayed "
            f"{statistics.median(lat_t):.3f}); {bits:.2f} bits/comp "
            f"({100 * (1 - sizes['forward_components'] / raw):.1f}% saved), graph "
            f"{sizes['graph']} B of {sizes['total']} B ({card})")
        out[codec, vq] = dict(
            launches=launches[name], launches_per_search=per_search[codec, vq],
            stage_per_search=stage_per[codec, vq], at_shapes=shapes, recall_at_10=recall,
            tied_swaps=swaps, search_ms_median=statistics.median(lat),
            search_ms_median_eager=statistics.median(lat_eager),
            search_ms_median_torch_backend=statistics.median(lat_t),
            bits_per_component=bits, index_bytes=sizes)

    # the kernel's device time at the graph's shape: one profile a set size, every variant
    for i, (C, docs) in enumerate(shape_docs.items()):
        calls = {v: (lambda st, a=served[v].arrays, c=v[0]: rows_dot.rows_scores_for_codec(
            c, a, Q, docs, scale, stage=st)) for v in rows_dot.VARIANTS}
        by = rows_device_ms(calls, rows_stages(nq, nq, dim, C))
        for v in rows_dot.VARIANTS:
            sh = out[v]["at_shapes"][i]
            sh.update(ms=by[v][sh["stage"]], ms_by_stage=by[v])
    for v in rows_dot.VARIANTS:
        for sh in out[v]["at_shapes"]:
            log(f"    {rows_dot.variant_name(*v)} kernel @{sh['shape']}: {_ms(sh['ms'])} ms "
                f"device ({sh['stage']}; "
                + ", ".join(f"{k} {_ms(x)}" for k, x in sh["ms_by_stage"].items())
                + "; a call back to back " + ", ".join(
                    f"{k} {x:.4f}" for k, x in sh["call_ms_by_stage"].items())
                + f"; plain {sh['plain_ms']:.3f}, bound {sh['bound_ms']:.4f} {sh['bound_by']}) "
                f"({card})")

    # the sweep behind the row-warp rule: one set per query at nq 64, 8 and 1, every C in
    # every stage that takes the shape, over the full collection's rows (real ids at random)
    dv, n_full = rows_full, rows_full["nnz_rows"].shape[0] - 1
    sweep, sweep_call = {}, {}
    for n, Cs in SWEEP_C.items():
        Qn = Q[:n]
        for C in Cs:
            docs = torch.from_numpy(rng.integers(0, n_full, (n, C)).astype(np.int32)).to(dev)
            stages_here = rows_stages(n, n, dim, C)
            for st in stages_here:
                check_kernel("dotvbyte", f"sweep nq={n} C={C} {st}", Qn, docs, dv, scale, st)
                sweep_call.setdefault(n, {}).setdefault(st, {})[C] = cuda_ms(
                    lambda: rows_dot.rows_scores_for_codec("dotvbyte", dv, Qn, docs, scale,
                                                           stage=st), 20)
            call = {("dotvbyte", "f16"): lambda st: rows_dot.rows_scores_for_codec(
                "dotvbyte", dv, Qn, docs, scale, stage=st)}
            for st, ms in rows_device_ms(call, stages_here)["dotvbyte", "f16"].items():
                sweep.setdefault(n, {}).setdefault(st, {})[C] = ms
        log(f"    stage sweep, rows kernel nq {n} x one set of C per query, dotvbyte f16, "
            f"device ms (a call back to back) ({card}): " + "; ".join(
                f"C {C} (nd*C {n * C}): " + ", ".join(
                    f"{st} {_ms(ms[C])} ({sweep_call[n][st][C]:.4f})"
                    for st, ms in sweep[n].items()) for C in Cs))
    phase["stage_sweep_C"] = sweep
    phase["stage_sweep_C_call_ms"] = sweep_call
    # the wrapper's host time a launch, as a step pays it (checked once per search)
    dvh = served["dotvbyte", "f16"]
    score = rows_dot.rows_scorer("dotvbyte", dvh.arrays, Q, scale)
    docs = shape_docs[m0]
    for _ in range(3):
        score(docs)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(200):
        score(docs)
    host_us = 1e6 * (time.perf_counter() - t0) / 200
    torch.cuda.synchronize()
    phase["wrapper_host_us_per_launch"] = host_us
    log(f"    rows wrapper host time per launch at C={m0}: {host_us:.1f} us (scorer made once "
        f"a search; {card})")
    shutil.rmtree(ROOT / "build" / "chip_smoke", ignore_errors=True)
    return out, served


#: phase 7's trace: requests, generator seed, repeat share, deadline (µs), cache entries
TRACE = dict(requests=256, seed=0, repeat_frac=0.25, deadline_us=1000.0, cache_size=1024)


def check_replay(name: str, ret, plan, Qn) -> None:
    """A plan's replay on ``Qn`` against the engine run eagerly on the
    same batch padded with zero queries: the same kernels in the same
    stages, so bit for bit."""
    ids, scores = plan(Qn)
    pad = torch.cat([Qn, Qn.new_zeros((plan.key.bucket - Qn.shape[0], Qn.shape[1]))])
    want_ids, want_scores = (t[: Qn.shape[0]] for t in eager_search(ret, pad))
    if not (torch.equal(ids, want_ids) and torch.equal(scores, want_scores)):
        raise SystemExit(f"{name}: the replayed plan differs from eager search_batch on the "
                         "same padded batch")


def pipeline_phase(served: dict, Q_np, Q, card: str) -> dict:
    """Phase 7: the serving pipeline over the dotvbyte/f16 retriever of
    each engine (``served[engine][codec, vq]``) → per engine its records:
    every bucket's plan captured and its replay held against eager; the
    16 variants' bucket-64 plans held the same way; a synthetic trace
    through ``Pipeline`` with every response held to direct search bit for
    bit (``launch/serve.py::trace_parity``), its launches counted from
    zero; graph against eager latency and profiles."""
    from repro_torch.kernels import rows_dot
    from repro_torch.launch.serve import stage_names, trace_parity
    from repro_torch.serve.pipeline import DEFAULT_BUCKETS, ServeStats, synthetic_trace

    nq, dim = Q.shape
    out = {}
    for engine, rets in served.items():
        ret = rets["dotvbyte", "f16"]
        rec = out[engine] = {"buckets": {}}
        # 1. every bucket: capture, then replay vs eager on a full and a ragged batch
        for b in DEFAULT_BUCKETS:
            plan = ret.plans.get(b)
            t0 = time.perf_counter()
            captured = plan.warm(dim)
            warm_s = time.perf_counter() - t0
            for n in sorted({min(b, nq), min(b // 2 + 1, nq)}):
                check_replay(f"{engine} bucket {b} n={n}", ret, plan, Q[:n])
            rec["buckets"][b] = dict(
                captured_here=captured, warm_s=warm_s if captured else None,
                capture_s=plan.capture_s, pool_bytes=plan.pool_bytes,
                stages=plan.launches["stages"],
                rows_launches=sum(plan.launches["stages"].values()))
        log(f"[7] {engine} dotvbyte f16: every bucket's replay == eager bitwise (full and ragged "
            f"batch); per bucket: capture s (warm-up + capture s), graph pool MiB, rows stages "
            f"({card}): " + "; ".join(
                f"b{b} {r['capture_s']:.3f}"
                + (f" ({r['warm_s']:.3f})" if r["warm_s"] is not None else " (phase 3/6)")
                + f", {r['pool_bytes'] / 2**20:.1f}, {r['stages']}"
                for b, r in rec["buckets"].items()))
        # 2. every variant's bucket-64 plan
        pools = {}
        for v, r in rets.items():
            plan = search_plan(r, nq)
            plan.warm(dim)
            check_replay(f"{engine} {rows_dot.variant_name(*v)} bucket {nq}", r, plan, Q)
            check_replay(f"{engine} {rows_dot.variant_name(*v)} bucket {nq} ragged", r, plan,
                         Q[: nq // 2 + 1])
            pools[rows_dot.variant_name(*v)] = plan.pool_bytes
        rec["variant_pool_bytes"] = pools
        log(f"    {engine}: all {len(rets)} variants' bucket-{nq} replays == eager bitwise (full "
            f"and ragged); their graph pools {min(pools.values()) / 2**20:.1f}–"
            f"{max(pools.values()) / 2**20:.1f} MiB, {sum(pools.values()) / 2**20:.1f} MiB in all; "
            f"reserved on the card now {torch.cuda.memory_reserved() / 2**30:.2f} GiB ({card})")
        # 3. the trace through the pipeline: this slice's path, counted from zero
        direct_ids, direct_scores = (t.cpu().numpy() for t in ret.search(Q))
        pipe = ret.pipeline(deadline_us=TRACE["deadline_us"], cache_size=TRACE["cache_size"])
        pipe.warm()
        trace = synthetic_trace(np.random.default_rng(TRACE["seed"]), TRACE["requests"], nq,
                                repeat_frac=TRACE["repeat_frac"])
        rows_dot.reset_launches()
        marks = replay_marks([ret])
        tickets = []
        t0 = time.perf_counter()
        for qi in trace:
            pipe.poll()
            tickets.append(pipe.submit(Q_np[qi]))
        pipe.flush()
        torch.cuda.synchronize()
        trace_s = time.perf_counter() - t0
        variants_l, stages_l = path_launches([ret], marks)
        if variants_l[rows_dot.variant_name("dotvbyte", "f16")] <= 0:
            raise SystemExit(f"{engine}: the pipeline trace launched no rows kernel")
        counts = trace_parity(trace, tickets, direct_ids, direct_scores)
        snap = pipe.snapshot()
        rec.update(trace_s=trace_s, parity=counts, snapshot=snap,
                   rows_launches=variants_l[rows_dot.variant_name("dotvbyte", "f16")],
                   rows_stage_launches={k: n for k, n in stages_l.items() if n})
        log(f"    {engine} trace ({TRACE}): {trace_s:.3f}s, responses: {counts['bitwise']} "
            f"bit for bit equal to direct search, {counts['cache_replays']} cache replays; "
            f"dispatch stages {sorted(stage_names(st for t in tickets if not t.from_cache for st in t.stages))}"
            f"; rows launches "
            f"{rec['rows_launches']} {rec['rows_stage_launches']} ({card})")
        log(f"    {engine} ServeStats: {ServeStats.summary(snap)}")
        # 4. graph against eager: host clock in turns, then one profile each
        lat = {"graph": [], "eager": []}
        calls = {"graph": lambda: ret.search(Q), "eager": lambda: eager_search(ret, Q)}
        for mode in ("eager", "graph", "graph", "eager"):
            lat[mode] += host_ms(calls[mode], 5)
        for mode, fn in calls.items():
            prof = {}
            device_breakdown(f"{engine} dotvbyte f16 {mode}", fn, card, out=prof)
            row = dict(search_ms_median=statistics.median(lat[mode]))
            if prof.get("busy_ms"):  # empty where the profiler traced no device time
                rows_k = {k: v for k, v in prof["kernels"].items() if "rows_dot" in k}
                rows_n = sum(n for _, n in rows_k.values())
                row.update(wall_ms=prof["wall_ms"], busy_ms=prof["busy_ms"],
                           idle_share=1 - prof["busy_ms"] / prof["wall_ms"],
                           kernels_per_search=sum(n for _, n in prof["kernels"].values()),
                           rows_ms=sum(ms for ms, _ in rows_k.values()), rows_launches=rows_n,
                           rows_ms_per_launch=sum(ms for ms, _ in rows_k.values()) / rows_n
                           if rows_n else None)
            rec[mode] = row
        g, e = rec["graph"], rec["eager"]
        log(f"    {engine} search of {nq}, graph vs eager ({card}): median "
            f"{g['search_ms_median']:.3f} vs {e['search_ms_median']:.3f} ms; "
            + "; ".join(f"{k} {_ms(g.get(k))} vs {_ms(e.get(k))}" for k in (
                "busy_ms", "idle_share", "kernels_per_search", "rows_ms_per_launch")))
    return out


#: phase 8: shards, the hnsw prefix (within phase 6's), the (max_resident, prefetch)
#: settings served, the timed searches
SHARDS = 4
SHARD_HNSW_DOCS = 2_000
SHARD_SETTINGS = ((4, True), (4, False), (1, True), (1, False))
SHARD_REPS = 10


def _whole_bytes(ret) -> int:
    return sum(t.numel() * t.element_size() for t in ret.arrays.values())


def sharded_phase(fwd, Q_np, Q, flat_mono, card: str, n_seismic: int, n_hnsw: int) -> dict:
    """Phase 8: sharded, out-of-core serving of the flat, Seismic and hnsw
    engines (see the module docstring) → per engine its records, and under
    ``"_path"`` the rows launches of the phase."""
    from repro_torch.core.seismic import exact_top_k, recall_at_k
    from repro_torch.kernels import rows_dot
    from repro_torch.launch.serve import stage_names, trace_parity
    from repro_torch.serve.api import Retriever, RetrieverConfig, open_retriever
    from repro_torch.serve.pipeline import ServeStats, synthetic_trace
    from repro_torch.serve.sharded import ShardedRetriever

    nq = Q.shape[0]
    name = rows_dot.variant_name("dotvbyte", "f16")
    engines = {"flat": (fwd.n_docs, {}), "seismic": (n_seismic, SEISMIC_PARAMS),
               "hnsw": (n_hnsw, HNSW_PARAMS)}
    out = {}
    rows_dot.reset_launches()  # this path's launches only
    replayed = {"variants": dict.fromkeys(rows_dot.variant_launches, 0),
                "stages": dict.fromkeys(rows_dot.stage_launches, 0)}

    def retire(r):
        """Add the rows launches ``r``'s fan-out plans replayed (their
        records times their calls) to the path's count."""
        for p in r.plans.created().values():
            for part, counts in p.launches.items():
                for k, c in counts.items():
                    replayed[part][k] += c * p.replays

    def memmapped(r):
        return all(isinstance(a, np.memmap) for sh in r.shards for a in sh.arrays.values()
                   if a.size)

    def settle(r):
        """Wait for the staged build (so what is allocated is comparable)."""
        if r._staged is not None:
            r._staged[1].result()
        torch.cuda.synchronize()

    for engine, (n, params) in engines.items():
        sub = fwd if n == fwd.n_docs else fwd.slice(0, n)
        cfg = RetrieverConfig(engine=engine, codec="dotvbyte", backend="cuda", k=10,
                              n_shards=SHARDS, params=params)
        t0 = time.perf_counter()
        built = Retriever.build(sub, cfg)
        if not isinstance(built, ShardedRetriever):
            raise SystemExit(f"sharded {engine}: Retriever.build returned {type(built)}")
        build_s = time.perf_counter() - t0
        art = TREES_DIR / f"sharded-{engine}"  # kept for phase 12
        t0 = time.perf_counter()
        built.save(art)
        save_s = time.perf_counter() - t0
        whole = _whole_bytes(flat_mono) if engine == "flat" else built.disk_bytes()
        shard_bytes = [sh.disk_bytes() for sh in built.shards]
        del built
        rec = out[engine] = dict(n_docs=n, build_s=build_s, save_s=save_s, whole_bytes=whole,
                                 shard_bytes=shard_bytes, settings={})
        log(f"[8] sharded {engine} over docs [0, {n}) in {SHARDS} shards: built in "
            f"{build_s:.1f}s, saved uncompressed in {save_s:.1f}s; shard arrays "
            f"{[round(b / 2**20, 1) for b in shard_bytes]} MiB, whole index "
            f"{whole / 2**20:.1f} MiB")
        results, stages_of, rets = {}, {}, {}
        for max_res, prefetch in SHARD_SETTINGS:
            t0 = time.perf_counter()
            r = open_retriever(art)
            open_s = time.perf_counter() - t0
            if not memmapped(r):
                raise SystemExit(f"sharded {engine}: a reopened shard array is not an np.memmap")
            r.max_resident, r.prefetch = max_res, prefetch
            first = r.search(Q)  # rotation 1: admissions and captures
            settle(r)
            mem = {1: torch.cuda.memory_allocated()}
            a0, b0 = dict(r.admission_s), r.builds
            torch.cuda.reset_peak_memory_stats()
            lat, hits_r2 = [], None
            for i in range(SHARD_REPS):
                t0 = time.perf_counter()
                got = r.search(Q)
                torch.cuda.synchronize()
                lat.append(1e3 * (time.perf_counter() - t0))
                if i == 0:
                    hits_r2 = r.prefetch_hits
                if i == 1:  # rotation 3
                    settle(r)
                    mem[3] = torch.cuda.memory_allocated()
            if not (torch.equal(got[0], first[0]) and torch.equal(got[1], first[1])):
                raise SystemExit(f"sharded {engine} {max_res}/{prefetch}: searches differ")
            peak_alloc = torch.cuda.max_memory_allocated() - mem[1]
            plan = r.plans.get(r.plans.bucket_for(nq))
            builds = max(r.builds - b0, 1)
            st = dict(
                open_s=open_s, search_ms_median=statistics.median(lat), search_ms=lat,
                admissions=r.builds - b0,
                **{f"{k}_ms_per_admission": 1e3 * (r.admission_s[k] - a0[k]) / builds
                   for k in ("page_in", "h2d", "capture", "admit")},
                prefetch_hits=r.prefetch_hits, prefetch_misses=r.prefetch_misses,
                hits_after_rotation_2=hits_r2, evictions=r.evictions,
                compiles=r.plans.compiles, peak_resident_bytes=r.peak_resident_bytes,
                resident_bytes=r.resident_bytes(), pool_bytes=r.pool_bytes(),
                rows_launches_per_search=sum(plan.launches["variants"].values()),
                rows_stages_per_search=dict(plan.launches["stages"]),
                allocated_after_rotation={k: v for k, v in mem.items()},
                peak_allocated_over_searches=peak_alloc)
            per_shard = 1 + HNSW_PARAMS["iters"] if engine == "hnsw" else 1
            if st["rows_launches_per_search"] != SHARDS * per_shard:
                raise SystemExit(f"sharded {engine}: a search replayed "
                                 f"{st['rows_launches_per_search']} rows launches, not "
                                 f"{SHARDS} x {per_shard}")
            if prefetch and max_res == 1 and not hits_r2:
                raise SystemExit(f"sharded {engine}: no prefetch hit by the second rotation")
            if max_res == 1 and prefetch:
                grown = mem[3] - mem[1]
                allowed = max(shard_bytes) + st["pool_bytes"]
                st["allocated_growth_r1_to_r3"] = grown
                if grown > allowed:
                    raise SystemExit(f"sharded {engine}: allocated grew {grown} B from rotation "
                                     f"1 to 3, more than one shard + one pool ({allowed} B)")
            if max_res == 1 and not prefetch and 2 * r.peak_resident_bytes > whole:
                raise SystemExit(f"sharded {engine}: peak resident {r.peak_resident_bytes} B is "
                                 f"more than half the whole index ({whole} B)")
            rec["settings"][f"{max_res}/{'on' if prefetch else 'off'}"] = st
            results[max_res, prefetch] = got
            stages_of[max_res, prefetch] = plan.stages
            if max_res == 1:  # kept for the tombstones and the trace
                rets[max_res, prefetch] = r
            else:  # its device memory goes now (its plan cache refers back to it)
                retire(r)
            del r, plan
            gc.collect()
            log(f"    max_resident={max_res} prefetch={'on' if prefetch else 'off'}: median "
                f"{st['search_ms_median']:.3f} ms/search of {nq} (min {min(lat):.3f}); per "
                f"admission ({st['admissions']} in {SHARD_REPS} searches) page-in "
                f"{st['page_in_ms_per_admission']:.2f} ms, host->device "
                f"{st['h2d_ms_per_admission']:.2f} ms, capture "
                f"{st['capture_ms_per_admission']:.2f} ms, on the serving thread "
                f"{st['admit_ms_per_admission']:.2f} ms (build or wait, evict); hits "
                f"{st['prefetch_hits']}, misses "
                f"{st['prefetch_misses']}, evictions {st['evictions']}, compiles "
                f"{st['compiles']}; peak resident {st['peak_resident_bytes'] / 2**20:.1f} MiB, "
                f"graph pools {st['pool_bytes'] / 2**20:.1f} MiB, device allocated at most "
                f"{peak_alloc / 2**20:+.1f} MiB over rotation 1's; rows launches a search "
                f"{st['rows_launches_per_search']} {st['rows_stages_per_search']} ({card})")
        base = results[SHARD_SETTINGS[0]]
        stages = stages_of[SHARD_SETTINGS[0]]
        for setting, got in results.items():  # prefetch on == off, resident 4 == 1
            bitwise(f"sharded {engine} {setting}", got, base)
        truth = [exact_top_k(sub, Q_np[i], 10) for i in range(nq)]
        ids_np = base[0].cpu().numpy()
        rec["recall_at_10"] = float(np.mean([recall_at_k(truth[i][0], ids_np[i])
                                             for i in range(nq)]))
        if engine == "flat":
            bitwise("sharded flat vs monolithic", base, flat_mono.search(Q))
            rec["parity"] = dict(against="monolithic flat of phase 3", bitwise=True,
                                 stages=sorted(stage_names(stages)),
                                 monolithic_stages=sorted(search_plan(flat_mono, nq).stages))
        else:
            r = rets[1, True]
            twin = ShardedRetriever(r.cfg.replace(backend="torch"), r.shards, dim=r.dim,
                                    value_scale=r.value_scale, value_format=r.value_format)
            want = twin.search(Q)
            rec["parity"] = dict(against="backend=torch sharded twin", bitwise=False,
                                 tied_swaps=same_topk(*base, *want))
            del twin
        # tombstones on the out-of-core retriever with a staged shard
        r, r_off = rets[1, True], rets[1, False]
        victims = np.unique(ids_np[:3, 0]).astype(np.int64)
        if r._staged is None:
            raise SystemExit(f"sharded {engine}: nothing staged before set_tombstones")
        r.set_tombstones(victims)
        if r._staged is not None:
            raise SystemExit(f"sharded {engine}: set_tombstones left a stale staged shard")
        dead = r.search(Q)
        r_off.set_tombstones(victims)
        dead_off = r_off.search(Q)
        if np.intersect1d(dead[0].cpu().numpy(), victims).size:
            raise SystemExit(f"sharded {engine}: a tombstoned doc was served")
        bitwise(f"sharded {engine} tombstoned, prefetch on vs off", dead, dead_off)
        for x in (r, r_off):
            x.set_tombstones([])
        bitwise(f"sharded {engine} tombstones cleared", r.search(Q), base)
        rec["tombstones"] = victims.tolist()
        log(f"    {engine}: prefetch on == off and max_resident 4 == 1 bit for bit; "
            f"{rec['parity']['against']}: "
            + (f"bit for bit (stages {rec['parity']['stages']} against "
               f"{rec['parity']['monolithic_stages']})" if rec["parity"]["bitwise"] else
               f"ids tie-aware ({rec['parity']['tied_swaps']} tied swaps)")
            + f"; recall@10 {rec['recall_at_10']:.4f} vs exact_top_k over [0, {n}); "
            f"tombstones {victims.tolist()} out of every answer, the staged shard retired, "
            f"prefetch on == off")
        if engine == "flat":  # the trace, out of core
            direct = tuple(t.cpu().numpy() for t in r.search(Q))
            pipe = r.pipeline(deadline_us=TRACE["deadline_us"], cache_size=TRACE["cache_size"])
            t0 = time.perf_counter()
            warm = pipe.warm()
            warm_s = time.perf_counter() - t0
            trace = synthetic_trace(np.random.default_rng(TRACE["seed"]), TRACE["requests"], nq,
                                    repeat_frac=TRACE["repeat_frac"])
            tickets = []
            t0 = time.perf_counter()
            for qi in trace:
                pipe.poll()
                tickets.append(pipe.submit(Q_np[qi]))
            pipe.flush()
            torch.cuda.synchronize()
            trace_s = time.perf_counter() - t0
            counts = trace_parity(trace, tickets, *direct)
            snap = pipe.snapshot()
            rec["trace"] = dict(warm_s=warm_s, warm_compiles=warm, trace_s=trace_s,
                                parity=counts, snapshot=snap)
            log(f"    flat trace at max_resident=1 ({TRACE}): warm {warm_s:.2f}s ({warm} plans), "
                f"trace {trace_s:.3f}s; responses {counts['bitwise']} bit for bit equal to "
                f"direct search, {counts['cache_replays']} cache replays ({card})")
            log(f"    flat ServeStats: {ServeStats.summary(snap)}")
        for x in rets.values():
            retire(x)
        del results, rets, r, r_off
        # phase 9 serves a mutable index over the flat tree; phase 12 serves
        # every tree over the mesh and holds it to this phase's answers
        rec["tree"] = str(art)
        out.setdefault("_sequential", {})[engine] = tuple(x.cpu().numpy() for x in base)
    variants = {k: v + replayed["variants"][k] for k, v in rows_dot.variant_launches.items()}
    stages = {k: v + replayed["stages"][k] for k, v in rows_dot.stage_launches.items()}
    out["_path"] = dict(rows_launches=variants[name],
                        rows_stage_launches={k: v for k, v in stages.items() if v})
    if variants[name] <= 0:
        raise SystemExit("the sharded path launched no rows kernel")
    log(f"    sharded path launches (warm-ups + graph replays): {name}={variants[name]}, by "
        f"stage {out['_path']['rows_stage_launches']}")
    return out


#: phase 9: the insert pool (a second collection, seed 1); the rounds' inserts,
#: deletes and updates at scale 1; the single deletes of the delete run; the cut
#: bases the Seismic and hnsw merges run on; the crash test's corpus
MUT_POOL = 2_048
MUT_ROUNDS = ((1, 64, 0), (64, 0, 32), (1024, 256, 0))
MUT_DELETE_RUN = 20
MUT_MERGE_DOCS = {"seismic": 2_000, "hnsw": 500}
#: the hnsw beam the mutable index serves at over phase 6's graph: a part's
#: budget k + its tombstones must fit the beam (top_k raises past it, as in the
#: reference), and the rounds leave up to ~230 tombstones in one part
MUT_HNSW_BEAM = 512
#: the pause between the bursts of 64 queries streamed through a background merge
MUT_STREAM_GAP_S = 0.02
MUT_CRASH_DOCS = 20_000


def sync() -> None:
    torch.cuda.synchronize()


class LiveTruth:
    """Exact scores of a mutable index's live corpus, assembled from row
    scores taken once per part: ``ForwardIndex.exact_scores`` sums each row
    on its own, so a row scores the same bits in any corpus that holds it
    (checked against ``exact_scores`` over ``live_corpus()`` for one query at
    every use). ``top_k`` is ``exact_top_k``'s selection over them."""

    def __init__(self, Q_np, base_scores):
        self.Q, self.base, self.seg = Q_np, base_scores, {}

    def scores(self, m):
        parts = [self.base]
        for s in m.segments:
            if id(s.fwd) not in self.seg:
                self.seg[id(s.fwd)] = (s.fwd, np.stack([s.fwd.exact_scores(q) for q in self.Q]))
            parts.append(self.seg[id(s.fwd)][1])
        S = np.concatenate(parts, axis=1)
        ids = np.concatenate([m.base_ids] + [s.ids for s in m.segments])
        dead = np.concatenate([m.base_dead] + [s.dead for s in m.segments])
        pos = np.flatnonzero(~dead)
        order = np.argsort(ids[pos], kind="stable")
        live_fwd, live = m.live_corpus()
        S, live_s = S[:, pos[order]], ids[pos][order]
        if not (np.array_equal(live, live_s) and np.array_equal(S[0], live_fwd.exact_scores(
                self.Q[0]))):
            raise SystemExit("the assembled live scores differ from exact_scores over "
                             "live_corpus()")
        return S, live

    def top_k(self, m, k: int = 10):
        S, live = self.scores(m)
        out_i, out_s = [], []
        for row in S:
            pos = np.argpartition(-row, min(k, len(row) - 1))[:k]
            pos = pos[np.argsort(-row[pos])]
            out_i.append(live[pos])
            out_s.append(row[pos])
        return np.stack(out_i), np.stack(out_s), S


def mutation_phase(fwd, Q_np, Q, bases: dict, tree, card: str) -> dict:
    """Phase 9: live mutation (``serve/segments.py``) over phase 3's flat and
    Seismic retrievers and phase 6's hnsw one, each wrapped, not rebuilt (see
    the module docstring) → per engine its records, and under ``"_path"`` the
    rows launches of the phase."""
    from repro_torch.core.seismic import recall_at_k
    from repro_torch.data.synthetic import generate_collection, splade_config
    from repro_torch.kernels import rows_dot
    from repro_torch.launch.serve import trace_parity
    from repro_torch.serve.api import Retriever, open_retriever
    from repro_torch.serve.pipeline import ServeStats, synthetic_trace
    from repro_torch.serve.segments import DeltaSegment, InjectedCrash, MutableRetriever

    nq = Q.shape[0]
    name = rows_dot.variant_name("dotvbyte", "f16")
    rng = np.random.default_rng(9)
    t0 = time.perf_counter()
    pool = generate_collection(splade_config(MUT_POOL, 1, 1), value_format="f16").fwd
    t1 = time.perf_counter()
    base_scores = np.stack([fwd.exact_scores(q) for q in Q_np])
    log(f"[9] live mutation: insert pool of {pool.n_docs} docs (a second collection, seed 1) "
        f"in {t1 - t0:.1f}s; exact scores of the {fwd.n_docs} docs for {nq} queries in "
        f"{time.perf_counter() - t1:.1f}s ({card})")
    rows_dot.reset_launches()  # this path's launches only
    replayed = {"variants": dict.fromkeys(rows_dot.variant_launches, 0),
                "stages": dict.fromkeys(rows_dot.stage_launches, 0)}
    per_part = {"flat": 1, "seismic": 1, "hnsw": 1 + HNSW_PARAMS["iters"]}

    def counted(m):
        """``m`` with every fan-out call's part records (the rows launches
        each replayed graph holds) added to the path's count."""
        inner = m._dispatch

        def dispatch(Qp):
            ids, scores, ran = inner(Qp)
            for _, record, _ in ran:
                for part, counts in record.items():
                    for k, c in counts.items():
                        replayed[part][k] += c
            return ids, scores, ran

        m._dispatch = dispatch
        return m

    def search(m):
        """The 64 queries through ``m.search``: one replayed plan per part (its
        rows launches: the parts, times 1 + iters for hnsw; a sharded base is
        its shards)."""
        got = m.search(Q)
        sync()
        plan = m.plans.get(m.plans.bucket_for(nq))
        n_base = len(m.base.shards) if hasattr(m.base, "shards") else 1
        want = (n_base + len(m.segments)) * per_part[m.cfg.engine]
        n = sum(plan.launches["variants"].values())
        if n != want and m.device.type == "cuda":  # (a CPU rehearsal launches nothing)
            raise SystemExit(f"mutable {m.cfg.engine}: a search replayed {n} rows launches, "
                             f"not {want} (one plan per part)")
        return got

    def twin_of(m):
        """``m`` on ``backend="torch"``: the same base arrays, segments, ids and
        tombstones."""
        tcfg = m.cfg.replace(backend="torch")
        b = Retriever(tcfg, m.base.arrays, n_docs=m.base.n_docs, dim=m.dim,
                      value_scale=m.value_scale, value_format=m.value_format, device=m.device)
        return MutableRetriever(
            tcfg, b, base_fwd=m.base_fwd, base_ids=m.base_ids, base_dead=m.base_dead,
            segments=[DeltaSegment(s.ids, s.fwd, s.arrays, s.dead) for s in m.segments],
            next_id=m.next_id)

    def step(m, rec, op, fn):
        """One mutation, then the first search after it → ms of both, the plans
        that search created (captured), their capture ms and graph pool MiB."""
        before = list(m._wrappers.values())
        c0 = m.plans.compiles
        t = time.perf_counter()
        fn()
        mut_ms = 1e3 * (time.perf_counter() - t)
        t = time.perf_counter()
        search(m)
        first_ms = 1e3 * (time.perf_counter() - t)
        new = [p for r in m._wrappers.values() if not any(r is b for b in before)
               for p in r.plans.created().values()]
        st = dict(op=op, segments=len(m.segments), ms=mut_ms, first_search_ms=first_ms,
                  plans=m.plans.compiles - c0, capture_ms=1e3 * sum(p.capture_s for p in new),
                  pool_bytes=sum(p.pool_bytes for p in new))
        del before, new
        gc.collect()
        sync()
        st["allocated"] = torch.cuda.memory_allocated()
        rec["steps"].append(st)
        return st

    def live_sample(m, n, exclude=()):
        live = np.setdiff1d(m.live_ids(), np.asarray(list(exclude), np.int64))
        return np.sort(rng.choice(live, size=n, replace=False))

    def spread_sample(m, n, one_doc):
        """``n`` live ids: half from the base, the rest from the segments,
        the one-doc segment's doc among them."""
        in_base = m.base_ids[~m.base_dead]
        in_segs = np.setdiff1d(np.concatenate([s.ids[~s.dead] for s in m.segments]), [one_doc])
        return np.union1d(np.union1d(rng.choice(in_base, n // 2, replace=False),
                                     rng.choice(in_segs, n - n // 2 - 1, replace=False)),
                          [one_doc])

    def check(m, engine, truth, dead_ids, label, rec, pipe=None):
        """After a round: ids held (flat to the live exact top-k, Seismic and
        hnsw to the torch twin), recall, no deleted id served, the trace."""
        ids_c, sc_c = search(m)
        ids_np, sc_np = ids_c.cpu().numpy(), sc_c.cpu().numpy()
        if np.intersect1d(ids_np, np.asarray(sorted(dead_ids), np.int64)).size:
            raise SystemExit(f"mutable {engine} {label}: a deleted id was served")
        t_ids, t_sc, _ = truth.top_k(m)
        out = dict(label=label, segments=len(m.segments), n_live=m.n_live,
                   recall_at_10=float(np.mean([recall_at_k(t_ids[i], ids_np[i])
                                               for i in range(nq)])))
        if engine == "flat":
            out["tied_swaps_vs_exact"] = sum(
                tie_aware_topk(f"mutable flat {label} query {i}", ids_np[i], sc_np[i], t_ids[i],
                               t_sc[i]) for i in range(nq))
        else:
            twin = twin_of(m)
            out["tied_swaps_vs_torch"] = same_topk(ids_c, sc_c, *twin.search(Q))
            del twin
            gc.collect()
        if pipe is not None:
            direct = (ids_np, sc_np)
            inv0 = pipe.cache.invalidations
            trace = synthetic_trace(np.random.default_rng(TRACE["seed"] + len(rec["rounds"])),
                                    TRACE["requests"], nq, repeat_frac=TRACE["repeat_frac"])
            tickets = []
            for qi in trace:
                pipe.poll()
                tickets.append(pipe.submit(Q_np[qi]))
            pipe.flush()
            out["trace"] = trace_parity(trace, tickets, *direct)
            out["trace_invalidations"] = pipe.cache.invalidations - inv0
            if out["trace_invalidations"] < 1:
                raise SystemExit(f"mutable {engine} {label}: the trace's cache was not "
                                 "invalidated by the round's mutations")
        rec["rounds"].append(out)
        log(f"    {engine} {label}: {out['segments']} segments, {out['n_live']} live; "
            + (f"ids == live exact_top_k ({out['tied_swaps_vs_exact']} tied swaps)"
               if engine == "flat" else
               f"ids == torch twin tie-aware ({out['tied_swaps_vs_torch']} tied swaps)")
            + f", recall@10 {out['recall_at_10']:.4f}; no deleted id served"
            + (f"; trace {out['trace']} with {out['trace_invalidations']} invalidation(s)"
               if pipe is not None else ""))

    def rounds(m, engine, truth, rec, scale, pipe=None, delete_run=0):
        """The three rounds of MUT_ROUNDS, counts scaled (at least 1), the first
        round's first ``delete_run`` deletes one at a time; → the deleted ids."""
        dead_ids, n_pool = set(), 0
        one_doc = None
        for r, (n_ins, n_del, n_upd) in enumerate(MUT_ROUNDS):
            n_ins, n_del, n_upd = (max(1, round(x * scale)) if x else 0
                                   for x in (n_ins, n_del, n_upd))
            if r == 2:  # inserts first, then deletes across base and segments
                st = step(m, rec, f"insert {n_ins}", lambda: m.insert(
                    pool.slice(n_pool, n_pool + n_ins)))
                n_pool += n_ins
                rec["search_ms"][len(m.segments)] = statistics.median(
                    host_ms(lambda: m.search(Q), 5))
                victims = spread_sample(m, n_del, one_doc)
                step(m, rec, f"delete {len(victims)}", lambda: m.delete(victims))
                dead_ids |= set(victims.tolist())
            else:
                if n_ins:
                    step(m, rec, f"insert {n_ins}", lambda: m.insert(
                        pool.slice(n_pool, n_pool + n_ins)))
                    if n_ins == 1:
                        one_doc = int(m.segments[-1].ids[0])
                    n_pool += n_ins
                    rec["search_ms"][len(m.segments)] = statistics.median(
                        host_ms(lambda: m.search(Q), 5))
                if n_del:
                    victims = live_sample(m, n_del, [one_doc])
                    mem = []
                    for v in victims[:delete_run]:
                        st = step(m, rec, "delete 1", lambda: m.delete([v]))
                        mem.append((st["allocated"], st["pool_bytes"]))
                    if mem:
                        grown, pool_b = mem[-1][0] - mem[0][0], max(p for _, p in mem)
                        rec["delete_run"] = dict(deletes=len(mem), allocated_first=mem[0][0],
                                                 allocated_last=mem[-1][0], grown=grown,
                                                 one_pool=pool_b)
                        if grown > pool_b:
                            raise SystemExit(f"mutable {engine}: allocated grew {grown} B over "
                                             f"{len(mem)} deletes, more than one graph pool "
                                             f"({pool_b} B)")
                    if len(victims) > delete_run:
                        step(m, rec, f"delete {len(victims) - delete_run}",
                             lambda: m.delete(victims[delete_run:]))
                    dead_ids |= set(victims.tolist())
                if n_upd:
                    ids = live_sample(m, n_upd, [one_doc])
                    step(m, rec, f"update {n_upd}", lambda: m.update(
                        pool.slice(n_pool, n_pool + n_upd), ids))
                    n_pool += n_upd
                    rec["search_ms"][len(m.segments)] = statistics.median(
                        host_ms(lambda: m.search(Q), 5))
            check(m, engine, truth, dead_ids, f"round {r + 1}", rec, pipe)
        return dead_ids

    def merge_streaming(m, engine, truth, dead_ids, rec):
        """``merge(background=True)`` with the 64 queries streaming through the
        flip (a pipeline without a cache, so each is dispatched); the
        responses held to the generation before or after the flip, the first
        search after the flip timed."""
        pre = tuple(t.cpu().numpy() for t in search(m))
        before_merge, _ = truth.scores(m)  # the live corpus: the merged base's rows
        stream = m.pipeline(deadline_us=TRACE["deadline_us"], cache_size=0)
        stream.warm()
        gen0, w0, b0 = m.generation, m.merge_wall_us, m.blocked_swap_us
        t = time.perf_counter()
        handle = m.merge(background=True)
        during = []
        while not handle.done():
            for qi in range(nq):
                stream.poll()
                during.append((qi, stream.submit(Q_np[qi])))
            stream.flush()
            time.sleep(MUT_STREAM_GAP_S)  # a gap between bursts: the merge's host build needs the GIL
        handle.result()
        wall_s = time.perf_counter() - t
        t = time.perf_counter()
        post_c = search(m)
        first_ms = 1e3 * (time.perf_counter() - t)
        post = tuple(x.cpu().numpy() for x in post_c)
        if m.generation != gen0 + 1 or m.segments:
            raise SystemExit(f"mutable {engine}: the background merge did not flip")
        for qi, tk in during:  # each the generation before or after the flip, bit for bit
            got = tk.result()
            try:
                bitwise("", got, (pre[0][qi], pre[1][qi]))
            except SystemExit:
                bitwise(f"mutable {engine} during the merge, query {qi} (neither generation)",
                        got, (post[0][qi], post[1][qi]))
        truth.base, truth.seg = before_merge, {}
        out = dict(n_docs_after=m.base.n_docs, during=len(during), merge_s=wall_s,
                   merge_wall_us=m.merge_wall_us - w0, blocked_swap_us=m.blocked_swap_us - b0,
                   first_search_after_flip_ms=first_ms,
                   first_search_replayed_prewarm=all(
                       p._graph is not None for p in m._wrappers["base"].plans.created().values()),
                   during_bitwise=len(during), snapshot=stream.snapshot())
        t_ids, t_sc, _ = truth.top_k(m)
        if engine == "flat":
            for qi, tk in during:
                ids, sc = tk.result()
                tie_aware_topk(f"mutable flat during the merge, query {qi}", ids, sc, t_ids[qi],
                               t_sc[qi])
            out["tied_swaps_vs_exact"] = sum(
                tie_aware_topk(f"mutable flat after the merge, query {i}", post[0][i],
                               post[1][i], t_ids[i], t_sc[i]) for i in range(nq))
        else:
            twin = twin_of(m)
            out["tied_swaps_vs_torch"] = same_topk(*post_c, *twin.search(Q))
            del twin
        out["recall_at_10"] = float(np.mean([recall_at_k(t_ids[i], post[0][i])
                                             for i in range(nq)]))
        if np.intersect1d(post[0], np.asarray(sorted(dead_ids), np.int64)).size:
            raise SystemExit(f"mutable {engine}: a deleted id was served after the merge")
        rec["merge"] = out
        log(f"    {engine} background merge over {out['n_docs_after']} live docs: "
            f"{wall_s:.2f}s with {len(during)} responses streamed through the flip (held to "
            f"the generation before or after it bit for bit); merge_wall_us "
            f"{out['merge_wall_us']:.0f}, blocked_swap_us {out['blocked_swap_us']:.1f}; first "
            f"search after the flip {first_ms:.3f} ms (prewarmed plans replayed: "
            f"{out['first_search_replayed_prewarm']}); recall@10 {out['recall_at_10']:.4f} "
            f"({card})")
        log(f"    {engine} merge ServeStats: {ServeStats.summary(out['snapshot'])} ({card})")

    def mut_cfg(engine):
        cfg = bases[engine].cfg
        if engine == "hnsw":
            cfg = cfg.replace(params={**cfg.params, "beam": MUT_HNSW_BEAM})
        return cfg

    out = {}
    for engine in ("flat", "seismic", "hnsw"):
        t_e = time.perf_counter()
        base = bases[engine]
        n_base = base.n_docs
        m = counted(MutableRetriever(mut_cfg(engine), base, base_fwd=fwd.slice(0, n_base),
                                     base_ids=np.arange(n_base)))
        truth = LiveTruth(Q_np, base_scores[:, :n_base])
        rec = out[engine] = dict(n_base=n_base, steps=[], rounds=[], search_ms={})
        search(m)
        rec["search_ms"][0] = statistics.median(host_ms(lambda: m.search(Q), 5))
        pipe = m.pipeline(deadline_us=TRACE["deadline_us"], cache_size=TRACE["cache_size"])
        dead_ids = rounds(m, engine, truth, rec, 1.0, pipe, MUT_DELETE_RUN)
        snap = pipe.snapshot()
        rec["snapshot"] = snap
        by_op = {}
        for st in rec["steps"]:
            by_op.setdefault(st["op"].split()[0], []).append(st)
        log(f"    {engine} over docs [0, {n_base}), dotvbyte f16, backend cuda: search ms at "
            + ", ".join(f"{k} segments {v:.3f}" for k, v in rec["search_ms"].items())
            + f"; delete run of {rec['delete_run']['deletes']}: allocated "
            f"{rec['delete_run']['allocated_first'] / 2**20:.1f} -> "
            f"{rec['delete_run']['allocated_last'] / 2**20:.1f} MiB (one graph pool "
            f"{rec['delete_run']['one_pool'] / 2**20:.1f} MiB) ({card})")
        for op, sts in by_op.items():
            log(f"      {op}: " + "; ".join(
                f"{st['op']} {st['ms']:.1f} ms host, first search {st['first_search_ms']:.1f} "
                f"ms ({st['plans']} plans captured in {st['capture_ms']:.1f} ms, pools "
                f"{st['pool_bytes'] / 2**20:.1f} MiB)" for st in (sts if len(sts) <= 4 else
                                                                 [sts[0], sts[-1]]))
                + f" ({card})")
        log(f"    {engine} ServeStats: {ServeStats.summary(snap)} ({card})")
        if engine == "flat":
            merge_streaming(m, engine, truth, dead_ids, rec)
        del m, pipe
        gc.collect()
        rec["seconds"] = time.perf_counter() - t_e
    # the Seismic and hnsw merges, over cut bases (their host builds are Python loops)
    for engine, n_cut in MUT_MERGE_DOCS.items():
        t_e = time.perf_counter()
        n_cut = min(n_cut, fwd.n_docs)
        cfg = mut_cfg(engine)
        t = time.perf_counter()
        base = Retriever.build(fwd.slice(0, n_cut), cfg, device=bases[engine].device)
        build_s = time.perf_counter() - t
        m = counted(MutableRetriever(cfg, base, base_fwd=fwd.slice(0, n_cut),
                                     base_ids=np.arange(n_cut)))
        truth = LiveTruth(Q_np, base_scores[:, :n_cut])
        rec = out[engine]["merge_cut"] = dict(n_base=n_cut, build_s=build_s, steps=[],
                                              rounds=[], search_ms={})
        log(f"    {engine} merge base: docs [0, {n_cut}) built in {build_s:.1f}s; the rounds "
            f"scaled by {n_cut / fwd.n_docs:g} ({card})")
        dead_ids = rounds(m, engine, truth, rec, n_cut / fwd.n_docs)
        merge_streaming(m, engine, truth, dead_ids, rec)
        rec["seconds"] = time.perf_counter() - t_e
        del m, base
        gc.collect()
    # a saved root crashed before its flip and reopened at the committed generation
    t = time.perf_counter()
    root = ROOT / "build" / "chip_smoke" / "mutable"
    shutil.rmtree(root, ignore_errors=True)
    n_crash = min(MUT_CRASH_DOCS, fwd.n_docs)
    dev = bases["flat"].device
    m = counted(MutableRetriever.create(fwd.slice(0, n_crash), bases["flat"].cfg, root,
                                        device=dev))
    m.insert(pool.slice(0, 64))
    m.delete(np.arange(0, n_crash, n_crash // 32)[:32])
    want = search(m)
    try:
        m.merge(crash_before_flip=True)
    except InjectedCrash:
        pass
    else:
        raise SystemExit("crash_before_flip did not raise")
    r = open_retriever(root, device=dev)
    if not (isinstance(r, MutableRetriever) and r.generation == 0 and len(r.segments) == 1
            and r.device == dev):
        raise SystemExit("the crashed root did not reopen at its committed generation")
    got = counted(r).search(Q)
    if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
        raise SystemExit("the reopened root serves other answers than before the crash")
    m.merge()
    r = counted(open_retriever(root, device=dev))
    if r.generation != 1 or r.segments:
        raise SystemExit("the retried merge did not commit generation 1")
    got, want = r.search(Q), m.search(Q)
    if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
        raise SystemExit("the reopened generation 1 serves other answers")
    out["crash"] = dict(n_docs=n_crash, seconds=time.perf_counter() - t)
    log(f"    crash test over docs [0, {n_crash}) + 64: crash_before_flip left generation 0 "
        f"loadable, open_retriever served it bit for bit, the retry committed generation 1 "
        f"({out['crash']['seconds']:.1f}s, {card})")
    del m, r, got, want
    # a mutable over phase 8's 4-shard flat tree: deletes through set_tombstones
    t = time.perf_counter()
    tree_r = open_retriever(tree, device=dev)
    m = counted(MutableRetriever(tree_r.cfg, tree_r, base_fwd=fwd,
                                 base_ids=np.arange(fwd.n_docs)))
    truth = LiveTruth(Q_np, base_scores)
    victims = np.sort(rng.choice(fwd.n_docs, 64, replace=False))
    m.delete(victims)
    ids_c, sc_c = search(m)
    if not np.array_equal(tree_r._tombstones, victims):
        raise SystemExit("the sharded base's tombstones are not the deleted rows")
    per_shard = [int(c) for c in tree_r._shard_tombs]
    m.insert(pool.slice(0, 64))
    dead = set(victims.tolist())
    rec = out["sharded_flat"] = dict(n_docs=fwd.n_docs, shards=len(tree_r.shards),
                                     tombstones_per_shard=per_shard, steps=[], rounds=[])
    check(m, "flat", truth, dead, "sharded base, 64 deletes + 64 inserts", rec)
    rec["seconds"] = time.perf_counter() - t
    log(f"    sharded flat tree of phase 8 ({len(tree_r.shards)} shards, memory-mapped): 64 "
        f"deletes routed through set_tombstones {per_shard} per shard ({rec['seconds']:.1f}s, "
        f"{card})")
    del m, tree_r
    gc.collect()
    shutil.rmtree(ROOT / "build" / "chip_smoke", ignore_errors=True)
    variants = {k: v + replayed["variants"][k] for k, v in rows_dot.variant_launches.items()}
    stages = {k: v + replayed["stages"][k] for k, v in rows_dot.stage_launches.items()}
    out["_path"] = dict(rows_launches=variants[name],
                        rows_stage_launches={k: v for k, v in stages.items() if v})
    if variants[name] <= 0:
        raise SystemExit("the mutable path launched no rows kernel")
    log(f"    mutable path launches (warm-ups + graph replays): {name}={variants[name]}, by "
        f"stage {out['_path']['rows_stage_launches']}")
    return out


#: phase 10: the example's stream (batch, seq), its optimizer, the fault step,
#: the checkpoint interval; the timed shapes; the parity batch and its tolerances
ENC_BATCH, ENC_SEQ = 16, 24
ENC_OPT = dict(lr=1e-3, warmup_steps=20)
ENC_FAULT_AT, ENC_CKPT_EVERY = 30, 25
ENC_TIMED = ((16, 24), (32, 128))
ENC_PARITY_LENS = (128, 80, 48, 0)  # a 4 × 128 batch, half of its positions masked
ENC_RTOL = ENC_ATOL = 1e-4
#: a leaf gradient's norm-wise relative error, card against CPU: at init the
#: contrastive scores q·d / T reach ~6e4, which f32 resolves in steps of ~0.004,
#: so two summation orders give dL/ds (and every gradient) ~1e-4 apart
ENC_GRAD_NORM_RTOL = 1e-3
#: Adam's first step moves a parameter by lr · (g / (|g| + eps) + wd · p), g the
#: clipped gradient: flat (±lr) where |g| ≫ eps, steep near 0; the flat part
#: starts here (in eps)
ENC_FLAT_G = 1e3
ENC_QUERIES = 64
#: the prefix of the learned corpus its Seismic index holds: after 50 steps a
#: document holds ~3,400 terms, and the host build (Python loops, ROADMAP A4)
#: takes ~0.3–0.4 s a document at that density
ENC_SEISMIC_DOCS = 50
ENC_QAT_CLIP = 0.5


def encoder_parity(cfg, card: str) -> dict:
    """Phase 10's first part: the full-width encoder on the card against
    the port's CPU path on the same weights and batch — the pooled
    output, every leaf's gradient, one AdamW step, and a QAT step."""
    import dataclasses

    from repro_torch.models.common import count_params
    from repro_torch.models.sparse_encoder import contrastive_loss, encode, encoder_init
    from repro_torch.train import optimizer, train_step
    from repro_torch.tree import tree_leaves_with_path, tree_map

    out = {}
    dev = torch.device("cuda")
    params_cpu = encoder_init(torch.Generator().manual_seed(0), cfg, device="cpu")
    n = count_params(params_cpu)
    log(f"[10] the SPLADE encoder at full width: vocab {cfg.vocab}, {cfg.n_layers} layers, "
        f"d {cfg.d_model}, {cfg.n_heads} heads, d_ff {cfg.d_ff}, max_len {cfg.max_len}: "
        f"{n} parameters")
    if n != 40_897_850:
        raise SystemExit(f"the full configuration has {n} parameters, not 40,897,850")
    params_gpu = tree_map(lambda t: t.to(dev), params_cpu)
    rng = np.random.default_rng(0)
    S = cfg.max_len
    lens = np.array(ENC_PARITY_LENS)
    batch_cpu = {}
    for side in ("q", "d"):
        batch_cpu[f"{side}_tokens"] = torch.from_numpy(rng.integers(0, cfg.vocab, (4, S)))
        batch_cpu[f"{side}_mask"] = torch.from_numpy(np.arange(S)[None, :] < lens[:, None])
    batch_gpu = {k: v.to(dev) for k, v in batch_cpu.items()}

    with torch.inference_mode():
        want = encode(params_cpu, cfg, batch_cpu["d_tokens"], batch_cpu["d_mask"])
        got = encode(params_gpu, cfg, batch_gpu["d_tokens"], batch_gpu["d_mask"]).cpu()
    if got.shape != (4, cfg.vocab) or not torch.isfinite(got).all():
        raise SystemExit(f"encode on the card gave {tuple(got.shape)}, finite "
                         f"{bool(torch.isfinite(got).all())}")
    if not torch.allclose(got, want, rtol=ENC_RTOL, atol=ENC_ATOL):
        raise SystemExit(f"encode on the card differs from the CPU by "
                         f"{float((got - want).abs().max()):.3e}")
    out["encode_max_abs_err"] = float((got - want).abs().max())
    out["pooled_nnz_per_row"] = [int(c) for c in (want > 0).sum(-1)]
    if bool(want[3].any()):
        raise SystemExit("a fully masked row pooled a nonzero activation")

    loss_fn = lambda p, b: contrastive_loss(p, cfg, b)  # noqa: E731
    _, g_cpu = train_step.value_and_grad(loss_fn, params_cpu, batch_cpu)
    _, g_gpu = train_step.value_and_grad(loss_fn, params_gpu, batch_gpu)
    worst = 0.0
    for (p, a), (_, b) in zip(tree_leaves_with_path(g_gpu), tree_leaves_with_path(g_cpu)):
        err = float((a.cpu() - b).norm() / b.norm().clamp_min(1e-30))
        if not err <= ENC_GRAD_NORM_RTOL:
            raise SystemExit(f"gradient of {p} on the card differs from the CPU's by {err:.2e} "
                             f"of its norm (limit {ENC_GRAD_NORM_RTOL})")
        worst = max(worst, err)
    out["grad_rel_norm_err"] = worst

    ocfg = optimizer.OptimizerConfig(**ENC_OPT)
    oinit, oupd = optimizer.make_optimizer(ocfg)
    step = train_step.make_train_step(loss_fn, oupd)
    s_cpu, m_cpu = step(train_step.init_train_state(params_cpu, oinit), batch_cpu)
    s_gpu, m_gpu = step(train_step.init_train_state(params_gpu, oinit), batch_gpu)
    for k in ("loss", "grad_norm", "lr"):
        if not torch.allclose(m_gpu[k].cpu(), m_cpu[k], rtol=ENC_RTOL, atol=0):
            raise SystemExit(f"the AdamW step's {k} on the card {float(m_gpu[k]):.6g} differs "
                             f"from the CPU's {float(m_cpu[k]):.6g}")
    # every param of the card's step is AdamW's first step on the card's own
    # clipped gradient, p - lr (g / (|g| + eps) + wd p), within rtol 1e-4 (atol
    # 1e-4 lr); and equal to the CPU's step within the same where both clipped
    # gradients sit on the step's flat part with one sign
    lr = float(m_cpu["lr"])
    clip = {d: min(1.0, ocfg.grad_clip / max(float(m["grad_norm"]), 1e-9))
            for d, m in (("cpu", m_cpu), ("gpu", m_gpu))}
    steep = total = 0
    for (p, a), (_, b), (_, g), (_, h), (_, p0) in zip(
            tree_leaves_with_path(s_gpu["params"]), tree_leaves_with_path(s_cpu["params"]),
            tree_leaves_with_path(g_cpu), tree_leaves_with_path(g_gpu),
            tree_leaves_with_path(params_cpu)):
        a, gc, hc = a.cpu(), g * clip["cpu"], h.cpu() * clip["gpu"]
        own = p0 - lr * (hc / (hc.abs() + ocfg.eps) + (ocfg.weight_decay * p0 if p0.dim() >= 2
                                                        else 0))
        if not torch.allclose(a, own, rtol=ENC_RTOL, atol=ENC_RTOL * lr):
            raise SystemExit(f"the AdamW step's {p} on the card is not AdamW's first step on "
                             f"its own gradient: max {float((a - own).abs().max()):.3e}")
        flat = (torch.sign(gc) == torch.sign(hc)) & (gc.abs() >= ENC_FLAT_G * ocfg.eps) & (
            hc.abs() >= ENC_FLAT_G * ocfg.eps)
        close = torch.isclose(a, b, rtol=ENC_RTOL, atol=ENC_RTOL * lr)
        if bool((flat & ~close).any()):
            raise SystemExit(f"the AdamW step's {p} on the card differs from the CPU's at "
                             f"{int((flat & ~close).sum())} params on the step's flat part")
        steep += int((~flat).sum())
        total += a.numel()
    out.update(loss=float(m_cpu["loss"]), grad_norm=float(m_cpu["grad_norm"]),
               loss_rel_err=abs(float(m_gpu["loss"]) / float(m_cpu["loss"]) - 1),
               step_params_off_flat=steep, step_params=total)

    qcfg = dataclasses.replace(cfg, quantize=True, quant_clip_init=ENC_QAT_CLIP)
    q_params = dict(params_gpu, quant_hi=torch.tensor(qcfg.quant_clip_init, device=dev))
    qstep = train_step.make_train_step(lambda p, b: contrastive_loss(p, qcfg, b), oupd)
    _, q_grads = train_step.value_and_grad(
        lambda p, b: contrastive_loss(p, qcfg, b), q_params, batch_gpu)
    q_state, _ = qstep(train_step.init_train_state(q_params, oinit), batch_gpu)
    hi_grad, hi_new = float(q_grads["quant_hi"]), float(q_state["params"]["quant_hi"])
    if not (np.isfinite(hi_grad) and np.isfinite(hi_new)):
        raise SystemExit(f"quant_hi's gradient {hi_grad} or its update {hi_new} is not finite")
    out.update(quant_hi_grad=hi_grad, quant_hi_after=hi_new)
    log(f"    parity at 4 x {S} (row lengths {lens.tolist()}): pooled max err "
        f"{out['encode_max_abs_err']:.2e} (nnz/row {out['pooled_nnz_per_row']}); gradients "
        f"within {worst:.1e} of their norms; AdamW step: loss {out['loss']:.6g} (rel err "
        f"{out['loss_rel_err']:.1e}), grad_norm {out['grad_norm']:.6g}, {steep} of {total} "
        f"params off the step's flat part; QAT step: d quant_hi "
        f"{hi_grad:.4g}, quant_hi {hi_new:.6g} ({card})")
    return out


def _dir_bytes(path) -> int:
    return sum(f.stat().st_size for f in pathlib.Path(path).rglob("*") if f.is_file())


def encoder_training(cfg, n_steps: int, seed: int, card: str) -> tuple[dict, dict]:
    """Phase 10's second part: ``n_steps`` of the example's stream through
    ``Runner`` twice under deterministic algorithms — once with a fault at
    step ``ENC_FAULT_AT``, once without — whose final states must be equal
    bit for bit, the checkpoint restored onto the CPU equal to the card's
    state, then the step, encode and checkpoint timings. → (the trained
    state, the numbers)."""
    from repro_torch.launch.train_sparse_encoder import synth_pairs
    from repro_torch.models.common import count_params
    from repro_torch.models.sparse_encoder import contrastive_loss, encode, encoder_init
    from repro_torch.train import checkpoint, optimizer, train_step
    from repro_torch.train.elastic import FaultInjector, Runner, RunnerConfig
    from repro_torch.tree import tree_leaves, tree_leaves_with_path

    dev = torch.device("cuda")
    root = ROOT / "build" / "chip_smoke" / "encoder"
    shutil.rmtree(root, ignore_errors=True)
    params = encoder_init(torch.Generator().manual_seed(seed), cfg, device=dev)
    n_params = count_params(params)
    oinit, oupd = optimizer.make_optimizer(optimizer.OptimizerConfig(**ENC_OPT,
                                                                     total_steps=n_steps))
    step = train_step.make_train_step(lambda p, b: contrastive_loss(p, cfg, b), oupd)
    batch_fn = lambda i: synth_pairs(seed, i, cfg, batch=ENC_BATCH, seq=ENC_SEQ,  # noqa: E731
                                     device=dev)
    init = train_step.init_train_state(params, oinit)
    out = {"params": n_params, "steps": n_steps}
    deterministic = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        runs = {}
        # the uninterrupted run saves only its last step: saves leave the state alone
        for name, fault, every in (("faulted", FaultInjector(fail_at=(ENC_FAULT_AT,)),
                                    ENC_CKPT_EVERY), ("clean", None, n_steps)):
            t = time.perf_counter()
            runner = Runner(RunnerConfig(total_steps=n_steps, checkpoint_dir=str(root / name),
                                         checkpoint_every=every),
                            step, batch_fn, init, device=dev, fault_injector=fault)
            state, hist = runner.run()
            torch.cuda.synchronize()
            runs[name] = (state, hist, runner.restarts, time.perf_counter() - t)
    finally:
        torch.use_deterministic_algorithms(deterministic)
    (state, _, restarts, run_s), (clean, clean_hist, _, clean_s) = runs["faulted"], runs["clean"]
    want_restarts = int(n_steps > ENC_FAULT_AT)
    if restarts != want_restarts or [h["step"] for h in clean_hist] != list(range(n_steps)):
        raise SystemExit(f"the faulted run restarted {restarts} times (want {want_restarts})")
    for (p, a), (_, b) in zip(tree_leaves_with_path(state), tree_leaves_with_path(clean)):
        if not torch.equal(a, b):
            raise SystemExit(f"the faulted run's {p} differs from the uninterrupted run's")
    losses = [h["loss"] for h in clean_hist]
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise SystemExit(f"the loss did not fall: {losses[0]:.4g} → {losses[-1]:.4g}")
    last = checkpoint.latest_step(str(root / "faulted"))
    t = time.perf_counter()
    on_cpu, _ = checkpoint.restore(str(root / "faulted"), state, device="cpu")
    out["ckpt_restore_cpu_s"] = time.perf_counter() - t
    out["ckpt_bytes"] = _dir_bytes(root / "faulted" / f"step_{last:08d}")
    if last != n_steps - 1 or not all(torch.equal(a, b.cpu()) for a, b in
                                      zip(tree_leaves(on_cpu), tree_leaves(state))):
        raise SystemExit("the checkpoint restored onto the CPU differs from the card's state")
    out.update(loss_first=losses[0], loss_last=losses[-1], restarts=restarts,
               faulted_run_s=run_s, clean_run_s=clean_s, ckpt_steps=checkpoint.available_steps(
                   str(root / "faulted")),
               nnz_doc_last=clean_hist[-1]["nnz_doc"], acc_last=clean_hist[-1]["contrastive_acc"])
    log(f"    {n_steps} steps through Runner, batch {ENC_BATCH} x seq {ENC_SEQ}, AdamW "
        f"lr {ENC_OPT['lr']}, warmup {ENC_OPT['warmup_steps']}: loss {losses[0]:.4f} → "
        f"{losses[-1]:.4f} (train nnz/doc {out['nnz_doc_last']:.0f}, acc {out['acc_last']:.3f}); "
        f"fault at step {ENC_FAULT_AT} → {restarts} restart, final state equal bit for bit to "
        f"the uninterrupted run's (deterministic algorithms; {run_s:.1f}s / {clean_s:.1f}s); "
        f"checkpoint of step {last} restored onto the CPU equal")

    # timings, outside deterministic mode
    timed = {}
    state_t = train_step.init_train_state(state["params"], oinit)
    for B, S in ENC_TIMED:
        batches = [synth_pairs(seed, 50_000 + i, cfg, batch=B, seq=S, device=dev)
                   for i in range(12)]
        for b in batches[:2]:
            state_t, _ = step(state_t, b)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()  # earlier phases' arrays and this state
        ms = []
        for b in batches[2:]:
            t = time.perf_counter()
            state_t, m = step(state_t, b)
            torch.cuda.synchronize()
            ms.append(1e3 * (time.perf_counter() - t))
        med, peak = statistics.median(ms), torch.cuda.max_memory_allocated()
        prof = {}
        b = batches[-1]

        def one_step():
            nonlocal state_t
            state_t, _ = step(state_t, b)

        device_breakdown(f"train step {B} x {S}", one_step, card, reps=3, out=prof)
        tokens = 2 * B * S
        timed[f"{B}x{S}"] = rec = dict(
            step_ms=med, step_ms_all=ms, tokens=tokens, tokens_per_s=tokens / (med / 1e3),
            max_memory_allocated=peak, held_before=held,
            model_flops=6 * n_params * tokens,
            f32_peak_share=6 * n_params * tokens / (med / 1e3) / F32_FLOP_PER_S,
            profile_wall_ms=prof.get("wall_ms"), device_busy_ms=prof.get("busy_ms"),
            kernels_per_step=sum(c for _, c in prof.get("kernels", {}).values()))
        log(f"    train step {B} x {S} ({tokens} tokens): median {med:.3f} ms of 10 "
            f"[{min(ms):.3f}–{max(ms):.3f}], {rec['tokens_per_s']:.0f} tokens/s, max allocated "
            f"{peak / 2**30:.2f} GiB ({(peak - held) / 2**30:.2f} above the {held / 2**30:.2f} "
            f"held before), 6·params·tokens = "
            f"{rec['model_flops'] / 1e12:.3f} TFLOP = {100 * rec['f32_peak_share']:.1f}% of the "
            f"f32 peak's time (reported, not claimed); {rec['kernels_per_step']:.0f} kernels a "
            f"step ({card})")
    del state_t
    out["timed"] = timed
    enc_b = [synth_pairs(seed, 60_000 + i, cfg, batch=32, seq=cfg.max_len, device=dev)
             for i in range(12)]
    pending = iter(enc_b)

    @torch.inference_mode()
    def encode_next():
        b = next(pending)
        encode(state["params"], cfg, b["d_tokens"], b["d_mask"])

    encode_next(), encode_next()
    ms = host_ms(encode_next, 10)
    out["encode_docs_per_s"] = 32 / (statistics.median(ms) / 1e3)
    out["encode_ms_32x128"] = statistics.median(ms)
    t = time.perf_counter()
    checkpoint.save(str(root / "timed"), n_steps - 1, state, keep_last=None)
    out["ckpt_save_s"] = time.perf_counter() - t
    out["ckpt_codec"] = "zstd" if checkpoint.zstandard is not None else "zlib"
    log(f"    encode 32 x {cfg.max_len}: median {out['encode_ms_32x128']:.3f} ms, "
        f"{out['encode_docs_per_s']:.0f} docs/s; checkpoint of the train state "
        f"({out['ckpt_bytes'] / 2**20:.1f} MiB on disk, {out['ckpt_codec']}): save "
        f"{out['ckpt_save_s']:.2f}s, restore to the CPU {out['ckpt_restore_cpu_s']:.2f}s ({card})")
    shutil.rmtree(root, ignore_errors=True)
    return state, out


def encoder_serving(params, cfg, n_docs: int, n_seismic: int, seed: int, card: str) -> dict:
    """Phase 10's last part: the trained encoder's corpus (``n_docs`` of the
    example's stream) and 64 queries served through the rows kernel —
    flat over all four row codecs at f16, Seismic dotvbyte/f16 over the
    first ``n_seismic`` docs — and by the host Seismic search. Under
    ``"_path"`` the rows launches of this part, per variant."""
    from repro_torch.core.forward_index import ForwardIndex
    from repro_torch.core.seismic import SeismicIndex, SeismicParams, exact_top_k, recall_at_k
    from repro_torch.kernels import rows_dot
    from repro_torch.launch.train_sparse_encoder import (SEISMIC_BUILD, SEISMIC_SEARCH,
                                                         encode_corpus)
    from repro_torch.serve.api import Retriever, RetrieverConfig

    dev = torch.device("cuda")
    out = {}
    t = time.perf_counter()
    docs, Q_np = encode_corpus(params, cfg, seed, n_docs // 16, ENC_QUERIES // 16, dev)
    fwd = ForwardIndex.from_docs(docs, cfg.vocab, value_format="f16")
    Q = torch.from_numpy(Q_np).to(dev)
    out.update(encode_s=time.perf_counter() - t, n_docs=fwd.n_docs,
               nnz_per_doc=fwd.total_nnz / fwd.n_docs,
               nnz_per_query=float((Q_np > 0).sum(1).mean()))
    out["bits_per_comp"] = {c: 8 * fwd.storage_bytes(c)["components"] / fwd.total_nnz
                            for c in ("uncompressed", "dotvbyte", "streamvbyte", "bitpack")}
    log(f"    corpus: {fwd.n_docs} docs + {len(Q_np)} queries encoded in {out['encode_s']:.1f}s;"
        f" learned {out['nnz_per_doc']:.1f} nnz/doc, {out['nnz_per_query']:.1f} nnz/query; "
        "bits/comp " + ", ".join(f"{c} {v:.2f}" for c, v in out["bits_per_comp"].items()))
    t = time.perf_counter()
    truth = [exact_top_k(fwd, q, 10) for q in Q_np]
    out["exact_s"] = time.perf_counter() - t

    rows_dot.reset_launches()  # this part's launches only
    served, flat = [], {}
    for codec in out["bits_per_comp"]:
        t = time.perf_counter()
        ret = Retriever.build(fwd, RetrieverConfig(engine="flat", codec=codec, backend="cuda"),
                              device=dev)
        served.append(ret)
        ids, sc = (x.cpu().numpy() for x in ret.search(Q))
        swaps = sum(tie_aware_topk(f"flat {codec}", ids[i], sc[i], *truth[i])
                    for i in range(len(Q_np)))
        ms = statistics.median(host_ms(lambda: ret.search(Q), 10))
        flat[codec] = dict(tied_swaps=swaps, search_ms=ms, build_s=time.perf_counter() - t)
        log(f"    flat {codec:12s} f16 (rows kernel): ids = exact_top_k ({swaps} tied swaps), "
            f"search {ms:.3f} ms / {len(Q_np)} queries")
    out["flat"] = flat

    fwd_s = fwd if n_seismic >= fwd.n_docs else fwd.slice(0, n_seismic)
    t = time.perf_counter()
    index = SeismicIndex.build(fwd_s, SeismicParams(**SEISMIC_BUILD))
    out["seismic_build_s"] = time.perf_counter() - t
    truth_s = truth if fwd_s is fwd else [exact_top_k(fwd_s, q, 10) for q in Q_np]
    cfg_s = RetrieverConfig(engine="seismic", codec="dotvbyte", backend="cuda",
                            params=SEISMIC_BUILD)
    ret = Retriever.from_host_index(index, cfg_s, device=dev)
    twin = Retriever.from_host_index(index, cfg_s.replace(backend="torch"), device=dev)
    served.append(ret)
    ids, sc = ret.search(Q)
    ids_t, sc_t = twin.search(Q)
    swaps = same_topk(ids, sc, ids_t, sc_t)
    ids = ids.cpu().numpy()
    recall = float(np.mean([recall_at_k(truth_s[i][0], ids[i]) for i in range(len(Q_np))]))
    ms = statistics.median(host_ms(lambda: ret.search(Q), 10))
    index.prepare_codec("dotvbyte")
    t = time.perf_counter()
    host = float(np.mean([recall_at_k(truth_s[i][0], index.search(q, k=10, **SEISMIC_SEARCH)[0])
                          for i, q in enumerate(Q_np)]))
    out["seismic"] = dict(n_docs=fwd_s.n_docs, blocks=index.n_blocks,
                          build_s=out["seismic_build_s"],
                          tied_swaps_vs_torch=swaps, recall_at_10=recall, search_ms=ms,
                          host_recall_at_10=host, host_search_s=time.perf_counter() - t)
    log(f"    Seismic dotvbyte f16 over {fwd_s.n_docs} docs ({index.n_blocks} blocks, host build "
        f"{out['seismic_build_s']:.1f}s): ids = torch twin ({swaps} tied swaps), recall@10 "
        f"{recall:.4f}, search {ms:.3f} ms / {len(Q_np)} queries; host SeismicIndex.search "
        f"(heap_factor 0.9, cut 8, dotvbyte) recall@10 {host:.4f} "
        f"({out['seismic']['host_search_s']:.1f}s; {card})")
    launches, stages = path_launches(served, {})
    names = {c: rows_dot.variant_name(c, "f16") for c in flat}
    missing = [n for n in names.values() if launches[n] <= 0]
    if missing:
        raise SystemExit(f"the encoder's serving path did not launch {missing}")
    out["_path"] = dict(rows_launches={n: launches[n] for n in names.values()},
                        rows_stage_launches={k: v for k, v in stages.items() if v})
    log(f"    encoder path launches (warm-ups + graph replays): "
        + ", ".join(f"{n}={launches[n]}" for n in names.values())
        + f"; by stage {out['_path']['rows_stage_launches']}")
    return out


def encoder_phase(n_steps: int, n_docs: int, card: str) -> dict:
    """Phase 10: the SPLADE encoder and its training at full width (see
    the module docstring)."""
    from repro_torch.models.sparse_encoder import SparseEncoderConfig

    if torch.get_float32_matmul_precision() != "highest":
        raise SystemExit("f32 matmuls must run at full precision (no TF32) for the parity checks")
    cfg = SparseEncoderConfig()
    out = {"parity": encoder_parity(cfg, card)}
    state, out["training"] = encoder_training(cfg, n_steps, 0, card)
    out["serving"] = encoder_serving(state["params"], cfg, n_docs, ENC_SEISMIC_DOCS, 0, card)
    out["_path"] = out["serving"].pop("_path")
    return out


#: phase 11: the reference Table 1's RGB settings and the prefix of phase
#: 3's collection it reorders (numpy on the host); the LiLSR collection the
#: CLI serves with every engine (its Seismic and hnsw host builds are Python
#: loops) and the one flat serves
RGB_PARAMS = dict(max_iters=6, leaf_size=32, seed=0)
RGB_DOCS = 50_000
#: (cut from 1,000 and 10,000 to make room for phase 12)
LILSR_CLI_DOCS = 500
LILSR_FLAT_DOCS = 5_000
_CLI_LINE = re.compile(r"^(\w+)\s+codec=(\w+)\s+backend=cuda recall@10=([\d.]+) "
                       r"latency=\s*(\d+)µs/q .*\(([\d.]+) bits/comp", re.M)


def csr_of(fwd, dev):
    """``fwd`` as a CSR tensor on the card (``torch.sparse.mm``'s operand)."""
    with warnings.catch_warnings():  # "sparse CSR support is in beta"
        warnings.simplefilter("ignore", UserWarning)
        return torch.sparse_csr_tensor(
            torch.from_numpy(fwd.offsets.astype(np.int64)),
            torch.from_numpy(fwd.components.astype(np.int64)),
            torch.from_numpy(fwd.value_format.dequantise(fwd.values)),
            size=(fwd.n_docs, fwd.dim), check_invariants=True).to(dev)


def rgb_lilsr_phase(fwd, Q_np, Q, card: str, n_rgb: int, n_cli: int, n_flat: int) -> dict:
    """Phase 11: RGB over a prefix of phase 3's collection and the LiLSR
    configuration, at the full width (see the module docstring) → records,
    and under ``"_path"`` the phase's rows and block-scan launches."""
    import io

    from repro_torch.core import rgb
    from repro_torch.core.codecs import available_codecs
    from repro_torch.core.layout import pack_blocks
    from repro_torch.core.seismic import exact_top_k
    from repro_torch.data.synthetic import generate_collection, lilsr_config
    from repro_torch.kernels import block_scan, ops, rows_dot
    from repro_torch.launch import serve as serve_cli
    from repro_torch.serve.api import Retriever, RetrieverConfig, top_k

    nq, dim = Q.shape
    dev = Q.device
    out = {}
    rows_dot.reset_launches()  # this phase's launches only
    block_scan.reset_launches()
    retrievers = []

    # -- RGB over the prefix --------------------------------------------------
    sub = fwd.slice(0, n_rgb)
    docs = [sub.components[sub.offsets[i]:sub.offsets[i + 1]] for i in range(sub.n_docs)]
    t0 = time.perf_counter()
    pi = rgb.recursive_graph_bisection(docs, dim, **RGB_PARAMS)
    rgb_s = time.perf_counter() - t0
    perm = sub.apply_component_permutation(pi)
    cost = (rgb.log_gap_cost(docs), rgb.log_gap_cost(
        [perm.components[perm.offsets[i]:perm.offsets[i + 1]] for i in range(perm.n_docs)]))
    bits = {c: (8 * sub.storage_bytes(c)["components"] / sub.total_nnz,
                8 * perm.storage_bytes(c)["components"] / perm.total_nnz)
            for c in available_codecs()}
    out["rgb"] = dict(docs=sub.n_docs, params=RGB_PARAMS, seconds=rgb_s, log_gap_cost=cost,
                      bits_per_component={c: dict(before=b, after=a) for c, (b, a) in bits.items()})
    log(f"[11] RGB ({RGB_PARAMS}) over the first {sub.n_docs} docs in {rgb_s:.1f}s on the host; "
        f"log-gap cost {cost[0]:.0f} -> {cost[1]:.0f}; bits/comp before -> after: "
        + ", ".join(f"{c} {b:.2f} -> {a:.2f}" for c, (b, a) in bits.items()))
    Qp = torch.from_numpy(np.stack([rgb.apply_permutation_dense(q, pi) for q in Q_np])).to(dev)
    truth = [exact_top_k(sub, Q_np[i], 10) for i in range(nq)]
    # the full scan over the permuted pack: the path's calls first
    packs = {}
    for codec in BLOCK_CODECS:
        for label, index in (("rgb", perm), ("unpermuted", sub)):
            packs[codec, label] = pack_blocks(index, codec=codec, block_size=512).to(dev)
    scans = {}
    for codec in BLOCK_CODECS:
        single, batch = ops.block_scorers(codec)
        scans[codec] = (batch(Qp, packs[codec, "rgb"]), single(Qp[0], packs[codec, "rgb"]))
    torch.cuda.synchronize()
    block_path = {k: v for k, v in block_scan.variant_launches.items() if v}
    csr_p = csr_of(perm, dev)
    lib_b = torch.sparse.mm(csr_p, Qp.t().contiguous()).t()
    lib_1 = torch.sparse.mm(csr_p, Qp[0].unsqueeze(1).contiguous()).t()[0]
    out["scan"] = {}
    for codec in BLOCK_CODECS:
        got_b, got_1 = scans[codec]
        torch.testing.assert_close(got_b, lib_b, rtol=1e-4, atol=1e-4)
        torch.testing.assert_close(got_1, lib_1, rtol=1e-4, atol=1e-4)
        sc, ids = top_k(got_b, 10)
        swaps = sum(tie_aware_topk(f"rgb {codec} scan query {i}", ids[i].cpu().numpy(),
                                   sc[i].cpu().numpy(), *truth[i]) for i in range(nq))
        single, batch = ops.block_scorers(codec)
        rec = {"tied_swaps": swaps}
        for label, Qx in (("rgb", Qp), ("unpermuted", Q)):
            p = packs[codec, label]
            rec[label] = dict(blocks=p.n_blocks, payload_bytes=p.payload_bytes(),
                              ms_nq64=cuda_ms(lambda: batch(Qx, p), 10),
                              ms_nq1=cuda_ms(lambda: single(Qx[0], p), 20))
        out["scan"][codec] = rec
        log(f"    full scan {codec} over the RGB pack: scores == sparse.mm over the permuted "
            f"CSR (rtol=atol=1e-4), top-10 == exact_top_k of the unpermuted prefix ({swaps} "
            f"tied swaps); nq 64 {rec['rgb']['ms_nq64']:.4f} ms (unpermuted "
            f"{rec['unpermuted']['ms_nq64']:.4f}), nq 1 {rec['rgb']['ms_nq1']:.4f} ms "
            f"({rec['unpermuted']['ms_nq1']:.4f}); payload {rec['rgb']['payload_bytes']} B "
            f"({rec['unpermuted']['payload_bytes']}) ({card})")
    del packs, scans, csr_p, lib_b
    # flat through the rows kernel over the permuted rows
    out["rgb_flat"] = {}
    for codec in rows_dot.CODECS:
        r = Retriever.build(perm, RetrieverConfig(engine="flat", codec=codec, backend="cuda",
                                                  k=10), device=dev)
        ids, sc = (t.cpu().numpy() for t in r.search(Qp))
        swaps = sum(tie_aware_topk(f"rgb flat {codec} query {i}", ids[i], sc[i], *truth[i])
                    for i in range(nq))
        out["rgb_flat"][codec] = dict(tied_swaps=swaps,
                                      search_ms=statistics.median(host_ms(lambda: r.search(Qp), 5)))
        retrievers.append(r)
    log("    flat over the permuted rows (f16): ids == exact_top_k of the unpermuted prefix; "
        + ", ".join(f"{c} {v['search_ms']:.3f} ms/search ({v['tied_swaps']} tied swaps)"
                    for c, v in out["rgb_flat"].items()) + f" ({card})")

    # -- LiLSR: the CLI, every engine and codec, on the card --------------------
    marks = replay_marks(retrievers)
    eager0 = dict(rows_dot.variant_launches)
    stages0 = {k: rows_dot.stage_launches[k] + rows_dot.captured_stage_launches[k]
               for k in rows_dot.STAGES}
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        serve_cli.main(["--encoder", "lilsr", "--engine", "all", "--compare-codecs",
                        "--device", "cuda", "--n-docs", str(n_cli), "--n-queries", str(nq)])
    cli_s = time.perf_counter() - t0
    text = buf.getvalue()
    lines = _CLI_LINE.findall(text)
    recall = {}
    for engine, codec, rec10, lat, bpc in lines:
        recall.setdefault(engine, {})[codec] = dict(recall_at_10=float(rec10),
                                                    latency_us_per_q=int(lat),
                                                    bits_per_component=float(bpc))
    if sorted(recall) != ["flat", "hnsw", "seismic"] or any(len(v) != 4 for v in recall.values()):
        raise SystemExit(f"the LiLSR CLI run printed {len(lines)} result lines:\n{text}")
    for engine, per in recall.items():
        if len({v["recall_at_10"] for v in per.values()}) != 1:
            raise SystemExit(f"LiLSR {engine}: recall differs across codecs {per}")
    nnz_cli = float(re.search(r"\(nnz/doc=(\d+)\)", text)[1])
    cli_stages = {k: rows_dot.stage_launches[k] + rows_dot.captured_stage_launches[k] - stages0[k]
                  for k in rows_dot.STAGES}
    cli_eager = {k: v - eager0[k] for k, v in rows_dot.variant_launches.items() if v > eager0[k]}
    out["lilsr_cli"] = dict(docs=n_cli, seconds=cli_s, nnz_per_doc=nnz_cli, results=recall,
                            rows_stages=cli_stages, rows_eager_launches=cli_eager)
    log(f"    LiLSR CLI (--encoder lilsr --engine all --compare-codecs --device cuda, {n_cli} "
        f"docs, nnz/doc {nnz_cli:.0f}) in {cli_s:.1f}s: recall@10 identical across codecs: "
        + ", ".join(f"{e} {next(iter(p.values()))['recall_at_10']:.3f}" for e, p in recall.items())
        + "; latency µs/q " + "; ".join(
            f"{e} " + ", ".join(f"{c} {v['latency_us_per_q']}" for c, v in p.items())
            for e, p in recall.items())
        + f"; rows launches (eager and captured) by stage {cli_stages} ({card})")
    # flat over a larger LiLSR collection
    t0 = time.perf_counter()
    col = generate_collection(lilsr_config(n_flat, nq, 1), value_format="f16")
    Ql_np = np.stack([col.query_dense(i) for i in range(col.n_queries)])
    Ql = torch.from_numpy(Ql_np).to(dev)
    truth_l = [exact_top_k(col.fwd, Ql_np[i], 10) for i in range(nq)]
    gen_s = time.perf_counter() - t0
    out["lilsr_flat"] = dict(docs=col.fwd.n_docs, nnz_per_doc=col.fwd.total_nnz / col.fwd.n_docs,
                             generate_s=gen_s, codecs={})
    for codec in rows_dot.CODECS:
        r = Retriever.build(col.fwd, RetrieverConfig(engine="flat", codec=codec, backend="cuda",
                                                     k=10), device=dev)
        ids, sc = (t.cpu().numpy() for t in r.search(Ql))
        swaps = sum(tie_aware_topk(f"LiLSR flat {codec} query {i}", ids[i], sc[i], *truth_l[i])
                    for i in range(nq))
        L = int(r.arrays["vals_rows"].shape[1])  # vq f16: one value a logical entry
        out["lilsr_flat"]["codecs"][codec] = dict(
            tied_swaps=swaps, L=L, stages=sorted(search_plan(r, nq).stages),
            search_ms=statistics.median(host_ms(lambda: r.search(Ql), 5)))
        retrievers.append(r)
    lf = out["lilsr_flat"]
    log(f"    LiLSR flat over {lf['docs']} docs (nnz/doc {lf['nnz_per_doc']:.1f}, generated in "
        f"{gen_s:.1f}s): ids == exact_top_k; " + ", ".join(
            f"{c} L={v['L']} {v['stages']} {v['search_ms']:.3f} ms/search ({v['tied_swaps']} "
            f"tied swaps)" for c, v in lf["codecs"].items()) + f" ({card})")
    variants_l, stages_l = path_launches(retrievers, marks)
    out["_path"] = dict(rows_launches={k: v for k, v in variants_l.items() if v},
                        rows_stages={k: v for k, v in stages_l.items() if v},
                        block_launches=block_path)
    for name in ("rows_dot_dotvbyte_f16", "rows_dot_streamvbyte_f16", "rows_dot_bitpack_f16",
                 "rows_dot_uncompressed_f16"):
        if out["_path"]["rows_launches"].get(name, 0) <= 0:
            raise SystemExit(f"phase 11 did not launch {name}")
    if any(block_path.get(f"block_scan_{c}{b}", 0) <= 0 for c in BLOCK_CODECS
           for b in ("", "_batch")):
        raise SystemExit(f"phase 11's full scan did not launch every entry: {block_path}")
    return out


# ---------------------------------------------------------------------------
# phase 12: the mesh fan-out on torch.distributed
# ---------------------------------------------------------------------------

#: phase 12: the gloo world's ranks (all on cuda:0) and the compressed step's
#: world; tombstones of the check; timed repetitions; the compressed step's
#: steps (quadratic problem, encoder); each spawn's deadline (a hung
#: collective fails the phase)
MESH_RANKS, MESH_DP_RANKS = 4, 2
MESH_VICTIMS = 5
MESH_REPS = 10
MESH_QUAD_STEPS, MESH_ENC_STEPS = 300, 5
MESH_DEADLINE_S = 300
MESH_DIR = ROOT / "build" / "chip_smoke_mesh"
#: phase 8's trees, kept for phase 12 (phase 9 clears build/chip_smoke)
TREES_DIR = ROOT / "build" / "chip_smoke_trees"


def _wait_for(d: pathlib.Path, *names: str) -> None:
    """Wait until the parent has written ``names`` in ``d``; raise where it
    wrote ``abort`` or the deadline passes."""
    t0 = time.monotonic()
    while not all((d / n).exists() for n in names):
        if (d / "abort").exists():
            raise SystemExit("phase 12: the parent aborted")
        if time.monotonic() - t0 > MESH_DEADLINE_S:
            raise TimeoutError(f"phase 12: {names} not written within {MESH_DEADLINE_S}s")
        time.sleep(0.05)


def _save_arrays(d: pathlib.Path, name: str, arrays: dict) -> None:
    (d / name).mkdir(parents=True, exist_ok=True)
    for k, v in arrays.items():
        np.save(d / name / f"{k}.npy", v)


def _load_arrays(d: pathlib.Path, name: str) -> dict:
    """The arrays of ``_save_arrays``, memory-mapped: a rank reads its slice."""
    return {f.stem: np.load(f, mmap_mode="r") for f in sorted((d / name).glob("*.npy"))}


def _replayed(retrievers) -> dict:
    """Rows launches the plans of ``retrievers`` replayed: each plan's
    record times its replays."""
    out: dict = {}
    for r in retrievers:
        for p in r.plans.created().values():
            for k, c in p.launches["variants"].items():
                out[k] = out.get(k, 0) + c * p.replays
    return out


def _add(total: dict, more: dict) -> None:
    for k, v in more.items():
        total[k] = total.get(k, 0) + v


def _quadratic(mesh, dev) -> dict:
    """The reference's compressed data-parallel test problem: y = x · w*,
    w* = 0..7, AdamW at lr 0.05 with 5 warmup steps of 300, a global batch
    of 64 drawn from one seed on every rank and split over ``data``."""
    from repro_torch.train.optimizer import OptimizerConfig, make_optimizer
    from repro_torch.train.train_step import init_train_state, make_dp_compressed_train_step

    true_w = np.arange(8, dtype=np.float32).reshape(8, 1)

    def loss_fn(params, batch):
        return torch.mean((batch["x"] @ params["w"] + params["b"] - batch["y"]) ** 2), {}

    oinit, oupd = make_optimizer(OptimizerConfig(lr=0.05, warmup_steps=5,
                                                 total_steps=MESH_QUAD_STEPS))
    params = {"w": torch.zeros((8, 1), device=dev), "b": torch.zeros((1,), device=dev)}
    step = make_dp_compressed_train_step(loss_fn, oupd, mesh, dp_axes=("data",))
    state = init_train_state(params, oinit, mesh=mesh, dp_axes=("data",))
    rng = np.random.default_rng(0)
    t0 = time.perf_counter()
    for _ in range(MESH_QUAD_STEPS):
        x = rng.standard_normal((64, 8)).astype(np.float32)
        state, m = step(state, {"x": torch.from_numpy(x).to(dev),
                                "y": torch.from_numpy(x @ true_w).to(dev)})
    torch.cuda.synchronize()
    w = state["params"]["w"].cpu().numpy()
    return dict(loss=float(m["loss"]), w_err=float(np.abs(w - true_w).max()),
                w=w.ravel().tolist(), b=state["params"]["b"].cpu().numpy().tolist(),
                step_ms=1e3 * (time.perf_counter() - t0) / MESH_QUAD_STEPS)


def _params_digest(params) -> str:
    from repro_torch.tree import tree_leaves_with_path

    h = hashlib.sha256()
    for path, leaf in tree_leaves_with_path(params):
        h.update(path.encode())
        h.update(leaf.detach().cpu().numpy().tobytes())
    return h.hexdigest()


def _encoder_dp(mesh, rank: int, dev) -> dict:
    """``MESH_ENC_STEPS`` compressed data-parallel steps of the full
    ``SparseEncoderConfig()`` at phase 10's 16 × 24, the batch split over
    the mesh; a digest of the parameters after every step, and this rank's
    plain ``make_train_step`` loss on its half of step 0's batch."""
    from repro_torch.launch.train_sparse_encoder import synth_pairs
    from repro_torch.models.sparse_encoder import SparseEncoderConfig, contrastive_loss, encoder_init
    from repro_torch.train.optimizer import OptimizerConfig, make_optimizer
    from repro_torch.train.train_step import (init_train_state, make_dp_compressed_train_step,
                                              make_train_step)

    cfg = SparseEncoderConfig()
    params = encoder_init(torch.Generator().manual_seed(0), cfg, device=dev)
    oinit, oupd = make_optimizer(OptimizerConfig(**ENC_OPT, total_steps=MESH_ENC_STEPS))
    loss_fn = lambda p, b: contrastive_loss(p, cfg, b)  # noqa: E731
    batch = lambda i: synth_pairs(0, i, cfg, batch=ENC_BATCH, seq=ENC_SEQ, device=dev)  # noqa: E731
    half = ENC_BATCH // MESH_DP_RANKS
    mine = {k: v[rank * half:(rank + 1) * half] for k, v in batch(0).items()}
    _, plain = make_train_step(loss_fn, oupd)(init_train_state(params, oinit), mine)
    step = make_dp_compressed_train_step(loss_fn, oupd, mesh, dp_axes=("data",))
    state = init_train_state(params, oinit, mesh=mesh, dp_axes=("data",))
    losses, digests, ms = [], [], []
    for i in range(MESH_ENC_STEPS):
        b = batch(i)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, b)
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t0))
        losses.append(float(m["loss"]))
        digests.append(_params_digest(state["params"]))
    return dict(plain_loss_step0=float(plain["loss"]), losses=losses, digests=digests,
                step_ms=ms)


def mesh_rank_nccl(rank: int, world: int, d: str) -> None:
    """Phase 12's NCCL world (one rank, the card's own GPU): (a)
    ``make_sharded_search`` over ``build_shard_arrays(n_shards=1,
    host_index=phase 3's index)``, then (d) the quadratic problem."""
    import torch.distributed as dist

    from repro_torch.kernels import rows_dot
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.serve.api import RetrieverConfig, make_sharded_search

    torch.set_num_threads(1)  # five processes share the host's eight cores
    d = pathlib.Path(d)
    _wait_for(d, "ready_a")
    spec = json.loads((d / "a.json").read_text())
    dev = torch.device("cuda")
    rows_dot.reset_launches()
    Q = torch.from_numpy(np.load(d / "Q.npy")).to(dev)
    mesh = make_debug_mesh((1, 1), ("data", "model"))
    stacked, idmap = _load_arrays(d, "a"), np.load(d / "a_idmap.npy")
    fn = make_sharded_search(mesh, RetrieverConfig(**spec["cfg"]), spec["n_local"],
                             spec["n_docs"], spec["scale"])
    t0 = time.perf_counter()
    ids, scores = fn(stacked, idmap, Q)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    lat = host_ms(lambda: fn(stacked, idmap, Q), MESH_REPS)
    launches = dict(rows_dot.variant_launches)
    _add(launches, _replayed([fn._placed[2]]))
    quad = _quadratic(make_debug_mesh((1,), ("data",)), dev)
    np.savez(d / "a_out.npz", ids=ids.cpu().numpy(), scores=scores.cpu().numpy())
    (d / "a_out.json").write_text(json.dumps(dict(
        backend=dist.get_backend(), first_s=first_s, search_ms=lat, rows_launches=launches,
        quadratic=quad)))
    (d / "done_a").touch()


def mesh_rank_gloo(rank: int, world: int, d: str) -> None:
    """One of phase 12's gloo ranks, every one on ``cuda:0``: (b)
    ``ShardedRetriever(use_mesh=True)`` over phase 8's trees, without and
    with tombstones, and ``make_sharded_search`` over
    ``build_shard_arrays(S=world)``; (c) the doc-aligned scan of its range;
    (d) on ranks 0 and 1, the compressed step on the quadratic problem and
    the encoder."""
    import torch.distributed as dist

    from repro_torch.core.scoring import make_doc_aligned_scan
    from repro_torch.dist.sharding import all_gather
    from repro_torch.kernels import block_scan, rows_dot
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.serve.api import RetrieverConfig, make_sharded_search, open_retriever

    torch.set_num_threads(1)
    d = pathlib.Path(d)
    _wait_for(d, "ready_b", "done_a")  # the NCCL world's timings run alone
    spec = json.loads((d / "b.json").read_text())
    dev = torch.device("cuda")
    rows_dot.reset_launches()
    block_scan.reset_launches()
    Q = torch.from_numpy(np.load(d / "Q.npy")).to(dev)
    arrays, out, replayed = {}, {"backend": dist.get_backend()}, {}
    for engine, t in spec["trees"].items():
        r = open_retriever(t["path"], device=dev)
        r.use_mesh = True
        t0 = time.perf_counter()
        arrays[f"{engine}/ids"], arrays[f"{engine}/scores"] = (x.cpu().numpy()
                                                               for x in r.search(Q))
        first_s = time.perf_counter() - t0
        lat = host_ms(lambda: r.search(Q), MESH_REPS)
        _add(replayed, _replayed(r._resident.values()))
        r.set_tombstones(np.asarray(t["victims"], np.int64))
        arrays[f"{engine}/dead_ids"], arrays[f"{engine}/dead_scores"] = (x.cpu().numpy()
                                                                         for x in r.search(Q))
        _add(replayed, _replayed(r._resident.values()))
        out[engine] = dict(first_s=first_s, search_ms=lat)
        del r
        gc.collect()
    mesh = make_debug_mesh((1, world), ("data", "model"))
    stacked, idmap = _load_arrays(d, "b"), np.load(d / "b_idmap.npy")
    fn = make_sharded_search(mesh, RetrieverConfig(**spec["cfg"]), spec["n_local"],
                             spec["n_docs"], spec["scale"])
    arrays["search/ids"], arrays["search/scores"] = (x.cpu().numpy()
                                                     for x in fn(stacked, idmap, Q))
    out["search"] = dict(search_ms=host_ms(lambda: fn(stacked, idmap, Q), MESH_REPS))
    _add(replayed, _replayed([fn._placed[2]]))
    # the collective alone: one search's [nq, k] ids and scores over the index axis
    ids_l = torch.zeros((Q.shape[0], spec["cfg"]["k"]), dtype=torch.int32, device=dev)
    sc_l = torch.zeros(ids_l.shape, dtype=torch.float32, device=dev)
    out["collective_ms"] = host_ms(lambda: (all_gather(ids_l, mesh, "model"),
                                            all_gather(sc_l, mesh, "model")), 20)
    out["scan"] = {}
    for codec in BLOCK_CODECS:
        packs = _load_arrays(d, f"c_{codec}")
        scan = make_doc_aligned_scan(mesh, ("data", "model"), spec["docs_local"],
                                     spec["scale"], codec)
        arrays[f"scan/{codec}/batch"] = scan(packs, Q).cpu().numpy()
        arrays[f"scan/{codec}/single"] = scan(packs, Q[:1]).cpu().numpy()
        out["scan"][codec] = dict(ms_batch=cuda_ms(lambda: scan(packs, Q), MESH_REPS),
                                  ms_single=cuda_ms(lambda: scan(packs, Q[:1]), MESH_REPS))
        del packs, scan
    out["rows_launches"] = dict(rows_dot.variant_launches)
    _add(out["rows_launches"], replayed)
    out["block_launches"] = dict(block_scan.variant_launches)
    dp_mesh = make_debug_mesh((MESH_DP_RANKS,), ("data",))  # every rank takes part in its groups
    if rank < MESH_DP_RANKS:
        out["quadratic"] = _quadratic(dp_mesh, dev)
        out["encoder"] = _encoder_dp(dp_mesh, rank, dev)
        out["dp_backend"] = dist.get_backend(dp_mesh.get_group("data"))
    np.savez(d / f"b_rank{rank}.npz", **arrays)
    (d / f"b_rank{rank}.json").write_text(json.dumps(out))


def mesh_phase(fwd, Q_np, Q, index, cfg_s, mono, trees: dict, card: str, csr, truth) -> dict:
    """Phase 12: the mesh fan-out on ``torch.distributed`` (see the module
    docstring) → its records, and under ``"_path"`` the rows and block-scan
    launches of its ranks. ``mono`` is phase 3's Seismic answer, ``trees``
    engine → (phase 8's tree, its sequential answer, its sequential search
    ms)."""
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.core.layout import pack_blocks_sharded
    from repro_torch.launch.mesh import spawn_ranks
    from repro_torch.serve.api import (build_shard_arrays, get_engine, map_local_ids,
                                       merge_topk, open_retriever, top_k)

    d = MESH_DIR
    shutil.rmtree(d, ignore_errors=True)
    d.mkdir(parents=True)
    n, (nq, k) = fwd.n_docs, mono[0].shape
    scale = float(fwd.value_format.scale)
    cfg_kw = dict(engine=cfg_s.engine, codec=cfg_s.codec, backend=cfg_s.backend, k=cfg_s.k,
                  params=dict(cfg_s.params))
    np.save(d / "Q.npy", Q_np)
    out, prep = {}, {}
    pool = ThreadPoolExecutor(2)
    try:
        # the ranks start (Python, torch, the card) while their inputs are made
        fut_a = pool.submit(spawn_ranks, mesh_rank_nccl, 1, str(d), backend="nccl",
                            init_file=d / "init_a", timeout_s=MESH_DEADLINE_S)
        fut_b = pool.submit(spawn_ranks, mesh_rank_gloo, MESH_RANKS, str(d), backend="gloo",
                            init_file=d / "init_b", timeout_s=MESH_DEADLINE_S)
        t0 = time.perf_counter()
        stacked, idmap, n_local1 = build_shard_arrays(fwd, cfg_s, 1, host_index=index)
        _save_arrays(d, "a", stacked)
        np.save(d / "a_idmap.npy", idmap)
        (d / "a.json").write_text(json.dumps(dict(cfg=cfg_kw, n_local=n_local1, n_docs=n,
                                                  scale=scale)))
        (d / "ready_a").touch()
        prep["a_s"] = time.perf_counter() - t0
        del stacked, idmap
        # (b): 5 victims among the first answers; the sequential rotation's
        # answer after set_tombstones; the S-shard stack and its in-process oracle
        t0 = time.perf_counter()
        tree_spec, seq_dead = {}, {}
        for engine, (path, seq, _) in trees.items():
            victims = np.unique(seq[0][:, 0])[:MESH_VICTIMS].astype(np.int64)
            r = open_retriever(path)
            r.use_mesh = False
            r.set_tombstones(victims)
            seq_dead[engine] = tuple(x.cpu().numpy() for x in r.search(Q))
            del r
            tree_spec[engine] = dict(path=str(path), victims=victims.tolist())
        prep["b_sequential_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        stacked, idmap, n_local = build_shard_arrays(fwd, cfg_s, MESH_RANKS, host_index=index)
        _save_arrays(d, "b", stacked)
        np.save(d / "b_idmap.npy", idmap)
        impl = get_engine(cfg_s.engine)
        flat_i, flat_s = [], []
        for s in range(MESH_RANKS):  # the oracle: each shard's search_batch in turn
            shard = {key: torch.from_numpy(np.ascontiguousarray(v[s])).to(Q.device)
                     for key, v in stacked.items()}
            ids_s, sc_s = impl.search_batch(cfg_s, n_local, scale, shard, Q)
            flat_i.append(map_local_ids(torch.from_numpy(idmap[s]).to(Q.device), ids_s, n))
            flat_s.append(sc_s)
            del shard
        oracle = tuple(x.cpu().numpy() for x in merge_topk(
            torch.cat(flat_i, 1), torch.cat(flat_s, 1), k, dedupe=impl.dedupe_merge,
            n_docs_global=n))
        prep["b_stack_s"] = time.perf_counter() - t0
        del stacked, idmap, flat_i, flat_s
        t0 = time.perf_counter()
        docs_local = 0
        for codec in BLOCK_CODECS:
            packs, docs_local = pack_blocks_sharded(fwd, MESH_RANKS, codec=codec, block_size=512)
            _save_arrays(d, f"c_{codec}", packs)
        prep["c_pack_s"] = time.perf_counter() - t0
        (d / "b.json").write_text(json.dumps(dict(cfg=cfg_kw, n_local=n_local, n_docs=n,
                                                  scale=scale, docs_local=docs_local,
                                                  trees=tree_spec)))
        (d / "ready_b").touch()
        spawn_a_s, spawn_b_s = fut_a.result(), fut_b.result()
    except BaseException:
        (d / "abort").touch()
        raise
    finally:
        pool.shutdown(wait=True)
    a = json.loads((d / "a_out.json").read_text())
    with np.load(d / "a_out.npz") as z:
        bitwise("phase 12 (a): make_sharded_search at S = 1 (NCCL) vs phase 3's Seismic",
                (z["ids"], z["scores"]), mono)
    ranks = []
    for r in range(MESH_RANKS):
        with np.load(d / f"b_rank{r}.npz") as z:
            ranks.append(({key: z[key] for key in z.files},
                          json.loads((d / f"b_rank{r}.json").read_text())))
    first = ranks[0][0]
    for r, (got, _) in enumerate(ranks):  # every rank returns the global answer
        for engine, (_, seq, _) in trees.items():
            bitwise(f"phase 12 (b): {engine} use_mesh=True on rank {r} vs phase 8's sequential",
                    (got[f"{engine}/ids"], got[f"{engine}/scores"]), seq)
            bitwise(f"phase 12 (b): {engine} with {MESH_VICTIMS} tombstones on rank {r} vs the "
                    f"sequential rotation", (got[f"{engine}/dead_ids"],
                                            got[f"{engine}/dead_scores"]), seq_dead[engine])
            if np.intersect1d(got[f"{engine}/dead_ids"], tree_spec[engine]["victims"]).size:
                raise SystemExit(f"phase 12 (b): {engine} served a tombstoned doc")
        bitwise(f"phase 12 (b): make_sharded_search at S = {MESH_RANKS} on rank {r} vs the "
                f"in-process oracle", (got["search/ids"], got["search/scores"]), oracle)
    # (c): the ranks' slices in rank order against sparse.mm and exact_top_k
    lib = {"batch": torch.sparse.mm(csr, Q.t().contiguous()).t(),
           "single": torch.sparse.mm(csr, Q[:1].t().contiguous()).t()}
    scan_err = {}
    for codec in BLOCK_CODECS:
        for form, want in lib.items():
            got = torch.from_numpy(np.concatenate([g[f"scan/{codec}/{form}"] for g, _ in ranks],
                                                  axis=1)[:, :n]).to(Q.device)
            torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
            scan_err[f"{codec}/{form}"] = float((got - want).abs().max())
            sc, ids = top_k(got, 10)
            for i in range(ids.shape[0]):
                tie_aware_topk(f"phase 12 (c) {codec} {form} query {i}", ids[i].cpu().numpy(),
                               sc[i].cpu().numpy(), *truth[i])
    # (d): the compressed step, world 1 (NCCL) and world 2 (gloo on cuda:0)
    dp = [info for _, info in ranks[:MESH_DP_RANKS]]
    for world, quads in ((1, [a["quadratic"]]), (MESH_DP_RANKS, [x["quadratic"] for x in dp])):
        q = quads[0]
        if not (q["loss"] < 0.01 and q["w_err"] < 0.2):
            raise SystemExit(f"phase 12 (d): the quadratic problem at world {world} ended at "
                             f"loss {q['loss']:.4g}, |w - w*| {q['w_err']:.3g}")
        if any(x["w"] != q["w"] or x["b"] != q["b"] for x in quads):
            raise SystemExit(f"phase 12 (d): the quadratic replicas at world {world} differ")
    enc = [x["encoder"] for x in dp]
    if any(e["digests"] != enc[0]["digests"] for e in enc):
        raise SystemExit("phase 12 (d): the encoder replicas differ after a step")
    if not (all(np.isfinite(e["losses"]).all() for e in enc)
            and all(e["losses"] == enc[0]["losses"] for e in enc)):
        raise SystemExit(f"phase 12 (d): encoder losses {[e['losses'] for e in enc]}")
    plain0 = float(np.mean([e["plain_loss_step0"] for e in enc]))
    loss0_rel = abs(enc[0]["losses"][0] / plain0 - 1)
    if not loss0_rel <= 1e-4:
        raise SystemExit(f"phase 12 (d): step 0's loss {enc[0]['losses'][0]:.8g} differs from "
                         f"the plain step's {plain0:.8g} by {loss0_rel:.2e} of it")
    # the path's launches: every rank's, the comparisons' not
    rows, blocks = dict(a["rows_launches"]), {}
    for _, info in ranks:
        _add(rows, info["rows_launches"])
        _add(blocks, info["block_launches"])
    name = next(iter(k for k in rows if k.endswith("dotvbyte_f16")))
    used = [f"block_scan_{c}{s}" for c in BLOCK_CODECS for s in ("", "_batch")]
    if rows[name] <= 0 or any(blocks[e] <= 0 for e in used):
        raise SystemExit(f"phase 12 launched rows {rows[name]}, block scans "
                         f"{ {e: blocks[e] for e in used} }")
    med = statistics.median
    out = dict(
        backends={"a": a["backend"], "b": ranks[0][1]["backend"],
                  "dp": ranks[0][1]["dp_backend"]},
        prep_s=prep, spawn_s={"nccl_world_1": spawn_a_s, f"gloo_world_{MESH_RANKS}": spawn_b_s},
        a=dict(first_s=a["first_s"], search_ms_median=med(a["search_ms"]),
               mono_stages="bitwise", n_local=n_local1),
        b={engine: dict(search_ms_median_by_rank=[med(info[engine]["search_ms"])
                                                   for _, info in ranks],
                        first_s_by_rank=[info[engine]["first_s"] for _, info in ranks],
                        sequential_ms_median=trees[engine][2],
                        victims=tree_spec[engine]["victims"]) for engine in trees},
        search=dict(n_local=n_local, search_ms_median_by_rank=[
            med(info["search"]["search_ms"]) for _, info in ranks]),
        collective=dict(bytes_per_query=8 * k * MESH_RANKS, ms_median_by_rank=[
            med(info["collective_ms"]) for _, info in ranks]),
        scan=dict(docs_local=docs_local, max_abs_err=scan_err, ms_by_rank={
            codec: [info["scan"][codec] for _, info in ranks] for codec in BLOCK_CODECS}),
        dp=dict(quadratic_world_1=a["quadratic"], quadratic_world_2=dp[0]["quadratic"],
                encoder_losses=enc[0]["losses"], encoder_plain_loss_step0=plain0,
                encoder_loss_step0_rel_err=loss0_rel,
                encoder_step_ms_by_rank=[e["step_ms"] for e in enc]),
        _path=dict(rows_launches=rows[name], block_launches=blocks),
    )
    log(f"[12] the mesh fan-out ({card}): backends (a) {out['backends']['a']} at world 1, "
        f"(b)-(c) {out['backends']['b']} at world {MESH_RANKS} on one card, (d) "
        f"{out['backends']['dp']} at world {MESH_DP_RANKS}; inputs made in "
        + ", ".join(f"{key} {v:.1f}s" for key, v in prep.items())
        + f"; spawns {spawn_a_s:.1f}s / {spawn_b_s:.1f}s")
    log(f"    (a) make_sharded_search over build_shard_arrays(S=1, host_index) at {n} docs "
        f"== phase 3's Seismic bit for bit; search {out['a']['search_ms_median']:.3f} ms "
        f"(first {a['first_s']:.2f}s: placement + capture) ({card})")
    for engine, rec in out["b"].items():
        log(f"    (b) {engine} use_mesh=True == phase 8's sequential bit for bit on every rank, "
            f"and with {MESH_VICTIMS} tombstones {rec['victims']}; per-rank search ms "
            f"{[round(x, 3) for x in rec['search_ms_median_by_rank']]} vs sequential "
            f"{rec['sequential_ms_median']:.3f} ({card})")
    log(f"    (b) make_sharded_search at S = {MESH_RANKS} == in-process oracle bit for bit; "
        f"per-rank ms {[round(x, 3) for x in out['search']['search_ms_median_by_rank']]}; "
        f"all_gather of [{nq}, {k}] ids + scores ({8 * k * MESH_RANKS} B a query): ms "
        f"{[round(x, 3) for x in out['collective']['ms_median_by_rank']]} ({card})")
    for codec in BLOCK_CODECS:
        ms = out["scan"]["ms_by_rank"][codec]
        log(f"    (c) doc-aligned scan {codec} (T=512, S={MESH_RANKS}, {docs_local} docs a rank): "
            f"== sparse.mm within 1e-4 (max {scan_err[f'{codec}/batch']:.2e} / "
            f"{scan_err[f'{codec}/single']:.2e}), top-10 == exact_top_k; per-rank ms nq "
            f"{nq} {[round(m['ms_batch'], 4) for m in ms]}, nq 1 "
            f"{[round(m['ms_single'], 4) for m in ms]} ({card})")
    q1, q2 = a["quadratic"], dp[0]["quadratic"]
    log(f"    (d) quadratic, {MESH_QUAD_STEPS} steps: world 1 loss {q1['loss']:.2e}, |w - w*| "
        f"{q1['w_err']:.3f}, {q1['step_ms']:.2f} ms a step; world {MESH_DP_RANKS} loss "
        f"{q2['loss']:.2e}, |w - w*| {q2['w_err']:.3f}, {q2['step_ms']:.2f} ms a step, replicas "
        f"bit-identical ({card})")
    log(f"    (d) encoder (40,897,850 params) {MESH_ENC_STEPS} steps at {ENC_BATCH} x {ENC_SEQ} "
        f"over {MESH_DP_RANKS} ranks: losses {[round(x, 4) for x in enc[0]['losses']]}, step 0 "
        f"vs the plain step's {plain0:.8g}: rel err {loss0_rel:.1e}, replicas bit-identical after every step; step ms by rank "
        f"{[[round(x, 1) for x in e['step_ms']] for e in enc]} ({card})")
    log(f"    mesh path launches: {name}={rows[name]}, block scans "
        + ", ".join(f"{e}={blocks[e]}" for e in used))
    shutil.rmtree(d, ignore_errors=True)
    shutil.rmtree(TREES_DIR, ignore_errors=True)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description="smoke run of the port on one GPU")
    ap.add_argument("--n-docs", type=int, default=100_000,
                    help="collection size (MsMarco has 8,842,240; the host build bounds it)")
    ap.add_argument("--hnsw-docs", type=int, default=2_500,
                    help="the prefix of the collection the hnsw phase serves (its host build "
                         "is Python insertion loops, ~10 ms a document)")
    ap.add_argument("--shard-docs", type=int, default=5_000,
                    help="the prefix the sharded Seismic of phase 8 serves (its per-shard host "
                         "build is phase 3's Python loops)")
    ap.add_argument("--encoder-steps", type=int, default=50,
                    help="training steps of phase 10's encoder (the example's stream)")
    ap.add_argument("--encoder-docs", type=int, default=1_488,
                    help="documents phase 10 encodes and serves (the example's count)")
    args = ap.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    # phase 10 checks a restart under deterministic algorithms; cuBLAS reads
    # its workspace setting once, at its first use in the process
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
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
    len_fwd = {ls: ForwardIndex.from_docs(length_docs(dim, ls, rng), dim, value_format="f16")
               for ls in (STAGE_LENGTHS, LONG_LENGTHS)}
    Ql = torch.from_numpy(rng.standard_normal((max(STAGE_NQ + tuple(
        n for n, _ in STAGE_PER_QUERY)), dim)).astype(np.float32)).to(dev)
    log(f"[2] rows kernel vs plain on edge rows (N={n_e}, dim={dim}, nq={nq}, C={C}; the "
        f"shared form also at nq {list(SHARED_NQ)} in both stages; rtol={RTOL}, atol={ATOL}):")
    for codec, vq in variants:
        rows = pack_rows(fwd_e, codec=codec, vq=vq)
        assert rows.l_max == 256, rows.l_max
        arrays = {k: torch.from_numpy(v).to(dev) for k, v in rows.arrays().items()}
        errs = [check_kernel(codec, f"{names[codec, vq]} nd=1", Qe, ids[:1].contiguous(),
                             arrays, 0.5),
                check_kernel(codec, f"{names[codec, vq]} nd=nq", Qe, ids, arrays, 0.5)]
        errs[1] = max(errs[1], check_kernel(codec, f"{names[codec, vq]} nd=nq entry lanes", Qe,
                                            ids, arrays, 0.5, "entry_lanes"))
        shared = []
        for n in SHARED_NQ:  # the shared form across the lane and tile edges, every stage
            Qn, set1 = Qs[:n], ids[:1].contiguous()
            want = rows_dot.rows_scores_plain(codec, arrays, Qn, set1, 0.5)
            shared += [check_kernel(codec, f"{names[codec, vq]} nd=1 nq={n} {st}", Qn, set1,
                                    arrays, 0.5, st, want) for st in rows_stages(n, 1, dim, C)]
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
        # one summation order (C2): rows of every length, every stage, the same bits
        took = set()
        for lengths, lq in ((STAGE_LENGTHS, Ql), (LONG_LENGTHS, Ql)):
            la = {k: torch.from_numpy(v).to(dev) for k, v in pack_rows(
                len_fwd[lengths], codec=codec, vq=vq).arrays().items()}
            n_l = len_fwd[lengths].n_docs
            lead = torch.tensor([*range(len(lengths)), n_l], dtype=torch.int32, device=dev)
            shared = torch.cat([lead, torch.randint(0, n_l + 1, (300,), device=dev,
                                                     dtype=torch.int32)]).unsqueeze(0)
            for n in STAGE_NQ:
                took.update(stages_agree(codec, names[codec, vq], lq[:n].contiguous(), shared,
                                         la))
            for n, c in STAGE_PER_QUERY:
                per = torch.randint(0, n_l + 1, (n, c), device=dev, dtype=torch.int32)
                per[:, : len(lead)] = lead
                took.update(stages_agree(codec, names[codec, vq], lq[:n].contiguous(), per, la))
        if took != set(rows_dot.STAGES):
            raise SystemExit(f"{names[codec, vq]}: the stage checks took only {sorted(took)}")
        log(f"  {names[codec, vq]:28s} max_abs_err nd=1 {errs[0]:.2e} (every stage), nd=nq "
            f"{errs[1]:.2e} (both stages){wide} ok; every stage the same bits at rows of "
            f"{list(STAGE_LENGTHS)} and {list(LONG_LENGTHS)} entries, shared nq "
            f"{list(STAGE_NQ)}, per query {list(STAGE_PER_QUERY)}")
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
        # a first search warms its plan eagerly (wrapper counts), captures it (the
        # plan's record) and replays it: the record must be the warm-up's launches
        for engine, ret in (("seismic", seismic[codec, vq]), ("flat", flat.get((codec, vq)))):
            if ret is None:
                continue
            before = rows_dot.variant_launches[name]
            results[engine, codec, vq] = ret.search(Q)
            torch.cuda.synchronize()
            warm = rows_dot.variant_launches[name] - before
            plan = search_plan(ret, nq)
            per_search[engine, codec, vq] = plan.launches["variants"].get(name, 0)
            if warm != per_search[engine, codec, vq] or plan.replays != 1:
                raise SystemExit(f"{engine} {name}: the warm-up launched {warm}, the captured "
                                 f"plan holds {plan.launches} ({plan.replays} replays)")
        log(f"    {name:28s} rows packed + placed in {pack_s:.1f}s, "
            f"{row_bytes[codec, vq] / 2**20:.1f} MiB on the card")
    launches, rows_stage_launches = path_launches([*seismic.values(), *flat.values()], {})
    log("    main path launches (warm-ups + graph replays): "
        + ", ".join(f"{names[v]}={launches[names[v]]}" for v in variants)
        + "; by stage " + ", ".join(f"{k}={v}" for k, v in rows_stage_launches.items()))
    missing = [names[v] for v in variants if launches[names[v]] <= 0]
    if missing:
        raise SystemExit(f"the main path did not launch {missing}")
    n_seismic = 2 * sum(v for k, v in per_search.items() if k[0] == "seismic")
    if rows_stage_launches["row_warps"] != n_seismic or n_seismic < 2 * len(variants):
        raise SystemExit(f"{rows_stage_launches['row_warps']} row-warp launches for "
                         f"{n_seismic} Seismic rescoring launches: the per-query form must "
                         "take the row-warp stage")
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
        # in turns: eager on entry lanes (the stage before row warps), the replayed
        # plan and eager on row warps, twice, eager on entry lanes
        lat, lat_eager, lat_entry = [], [], []
        for turn in range(4):
            if turn in (0, 3):
                with rows_stage("entry_lanes"):
                    lat_entry += host_ms(lambda: eager_search(s_ret, Q), 5)
            else:
                lat += host_ms(lambda: s_ret.search(Q), 5)
                lat_eager += host_ms(lambda: eager_search(s_ret, Q), 5)
        lat_t = host_ms(lambda: s_torch.search(Q), 5)
        lat_t_eager = host_ms(lambda: eager_search(s_torch, Q), 5)
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
            by_stage = {}
            if not slow:  # the per-query form in both its stages
                for st in rows_stages(nq, docs.shape[0], fwd.dim, docs.shape[1]):
                    err = max(err, check_kernel(codec, f"{name} @ {shape} {st}", Q, docs, arrays,
                                                scale, st))
                    by_stage[st] = cuda_ms(lambda: rows_dot.rows_scores_for_codec(
                        codec, arrays, Q, docs, scale, stage=st), 20)
                max_err[codec, vq] = max(max_err[codec, vq], err)
            shapes.append(dict(shape=shape, nq=nq, nd=docs.shape[0], C=docs.shape[1],
                               stage=rows_dot.pick_stage(nq, docs.shape[0], dim=fwd.dim,
                                                         C=docs.shape[1]),
                               launches_per_search=per_search.get((shape, codec, vq)),
                               ms=ms, ms_by_stage=by_stage, plain_ms=plain_ms,
                               bound_ms=bound_ms, bound_by=bound_by,
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
            f_lat_eager = host_ms(lambda: eager_search(flat[codec, vq], Q), 5)
            flat_note = (f"; flat {'ids == exact_top_k, ' if vq == 'f16' else ''}"
                         f"recall@10 {f_recall:.4f}, median "
                         f"{statistics.median(f_lat):.3f} ms/batch (eager "
                         f"{statistics.median(f_lat_eager):.3f})")
        s, f = shapes
        log(f"  {name}: seismic cuda==torch ({n_swapped} tied swaps), recall@10 {recall:.4f}, "
            f"median {statistics.median(lat):.3f} ms/batch of {nq} replayed (min {min(lat):.3f}; "
            f"eager {statistics.median(lat_eager):.3f}, eager on entry lanes "
            f"{statistics.median(lat_entry):.3f}; backend=torch replayed "
            f"{statistics.median(lat_t):.3f}, eager {statistics.median(lat_t_eager):.3f})"
            f"{flat_note}")
        log(f"    {bits:.2f} bits/comp ({100 * (1 - comp_bytes / raw_bytes):.1f}% saved vs "
            f"16 raw), rows {row_bytes[codec, vq] / 2**20:.1f} MiB; kernel @seismic "
            f"{s['ms']:.4f} ms ({s['stage']}; "
            + ", ".join(f"{k} {v:.4f}" for k, v in s["ms_by_stage"].items())
            + f"; plain {s['plain_ms']:.3f}, bound {s['bound_ms']:.4f} "
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
            "stage": s["stage"],
            "ms_by_stage": s["ms_by_stage"],
            "at_shapes": shapes,
            "recall_at_10": recall,
            "search_ms_median": statistics.median(lat),
            "search_ms_median_eager": statistics.median(lat_eager),
            "search_ms_median_entry_lanes": statistics.median(lat_entry),
            "search_ms_median_torch_backend": statistics.median(lat_t),
            "search_ms_median_torch_backend_eager": statistics.median(lat_t_eager),
            "bits_per_component": bits,
            "row_bytes": row_bytes[codec, vq],
        })
    dv = seismic["dotvbyte", "f16"].arrays
    kernels[[k["name"] for k in kernels].index(names["dotvbyte", "f16"])]["stage_sweep"] = \
        stage_sweep("rows kernel at the flat shape, dotvbyte f16",
                    lambda Qn, st: rows_dot.rows_scores_for_codec("dotvbyte", dv, Qn, docs_f,
                                                                  scale, stage=st), Q, card,
                    lambda n: rows_stages(n, 1, fwd.dim, docs_f.shape[1]))
    shutil.rmtree(ROOT / "build" / "chip_smoke", ignore_errors=True)
    phase_s["4 checks + timings"] = time.perf_counter() - t0

    # -- 5. the full scan ------------------------------------------------------------
    t0 = time.perf_counter()
    log(f"[5] full scan of the {fwd.n_docs}-doc collection (nq={nq}):")
    n_rows = len(kernels)
    kernels += full_scan(fwd, Q, truth, csr, card, block_err, fused_err)
    phase_s["5 full scan"] = time.perf_counter() - t0

    # -- 6. the hnsw engine --------------------------------------------------------
    t0 = time.perf_counter()
    hnsw, hnsw_served = hnsw_phase(fwd, Q_np, Q, min(args.hnsw_docs, fwd.n_docs), card,
                                   max_err, seismic["dotvbyte", "f16"].arrays)
    for rec in kernels[:n_rows]:
        h = hnsw[next(v for v in variants if names[v] == rec["name"])]
        rec["launches_by_path"] = {"seismic+flat": rec["launches"], "hnsw": h["launches"]}
        rec["launches"] += h["launches"]
        rec["max_abs_err"] = max(rec["max_abs_err"], *(s["max_abs_err"] for s in h["at_shapes"]))
        rec["at_shapes"] += h.pop("at_shapes")
        rec["hnsw"] = h
    kernels[[k["name"] for k in kernels].index(names["dotvbyte", "f16"])]["hnsw_phase"] = \
        hnsw["_phase"]
    phase_s["6 hnsw"] = time.perf_counter() - t0

    # -- 7. the serving pipeline -------------------------------------------------------
    t0 = time.perf_counter()
    rows_of = lambda r: {k: v for k, v in r.arrays.items() if k not in engine_arrays}  # noqa: E731
    flat_all = {v: flat.get(v) or Retriever(
        cfg_f.replace(codec=v[0], vq=v[1]), rows_of(seismic[v]), n_docs=fwd.n_docs,
        dim=fwd.dim, value_scale=scale, value_format=fwd.value_format.name) for v in variants}
    pipe = pipeline_phase({"seismic": seismic, "hnsw": hnsw_served, "flat": flat_all}, Q_np, Q,
                          card)
    dv = kernels[[k["name"] for k in kernels].index(names["dotvbyte", "f16"])]
    dv["launches_by_path"]["pipeline"] = sum(r["rows_launches"] for r in pipe.values())
    dv["launches"] += dv["launches_by_path"]["pipeline"]
    dv["pipeline_phase"] = pipe
    phase_s["7 pipeline"] = time.perf_counter() - t0

    # -- 8. sharded, out-of-core serving -------------------------------------------------
    t0 = time.perf_counter()
    shard = sharded_phase(fwd, Q_np, Q, flat["dotvbyte", "f16"], card,
                          min(args.shard_docs, fwd.n_docs),
                          min(SHARD_HNSW_DOCS, args.hnsw_docs, fwd.n_docs))
    dv["launches_by_path"]["sharded"] = shard["_path"]["rows_launches"]
    dv["launches"] += dv["launches_by_path"]["sharded"]
    dv["sharded_phase"] = shard
    phase_s["8 sharded"] = time.perf_counter() - t0

    # -- 9. live mutation --------------------------------------------------------------
    t0 = time.perf_counter()
    mut = mutation_phase(fwd, Q_np, Q, {"flat": flat["dotvbyte", "f16"],
                                        "seismic": seismic["dotvbyte", "f16"],
                                        "hnsw": hnsw_served["dotvbyte", "f16"]},
                         shard["flat"]["tree"], card)
    dv["launches_by_path"]["mutable"] = mut["_path"]["rows_launches"]
    dv["launches"] += dv["launches_by_path"]["mutable"]
    dv["mutation_phase"] = mut
    phase_s["9 mutation"] = time.perf_counter() - t0

    # -- 10. the encoder and its training ----------------------------------------------
    t0 = time.perf_counter()
    encoder = encoder_phase(args.encoder_steps, args.encoder_docs, card)
    for rec in kernels[:n_rows]:
        n = encoder["_path"]["rows_launches"].get(rec["name"], 0)
        rec["launches_by_path"]["encoder"] = n
        rec["launches"] += n
    dv["encoder_phase"] = encoder
    phase_s["10 encoder"] = time.perf_counter() - t0

    # -- 11. RGB and the LiLSR configuration ------------------------------------------
    t0 = time.perf_counter()
    extra = rgb_lilsr_phase(fwd, Q_np, Q, card, min(RGB_DOCS, fwd.n_docs), LILSR_CLI_DOCS,
                            LILSR_FLAT_DOCS)
    for rec in kernels:
        n = {**extra["_path"]["rows_launches"], **extra["_path"]["block_launches"]}.get(
            rec["name"], 0)
        rec.setdefault("launches_by_path", {})["rgb_lilsr"] = n
        rec["launches"] += n
    dv["rgb_lilsr_phase"] = extra
    phase_s["11 rgb + lilsr"] = time.perf_counter() - t0
    log(f"[11] {phase_s['11 rgb + lilsr']:.1f}s")

    # -- 12. the mesh fan-out --------------------------------------------------------
    t0 = time.perf_counter()
    seq = shard.pop("_sequential")
    trees = {e: (shard[e]["tree"], seq[e], shard[e]["settings"]["4/on"]["search_ms_median"])
             for e in seq}
    mesh = mesh_phase(fwd, Q_np, Q, index, cfg_s, results["seismic", "dotvbyte", "f16"], trees,
                      card, csr, truth)
    for rec in kernels:
        n = (mesh["_path"]["rows_launches"] if rec["name"] == names["dotvbyte", "f16"]
             else mesh["_path"]["block_launches"].get(rec["name"], 0))
        rec.setdefault("launches_by_path", {})["mesh"] = n
        rec["launches"] += n
    dv["mesh_phase"] = mesh
    phase_s["12 mesh"] = time.perf_counter() - t0
    log(f"[12] {phase_s['12 mesh']:.1f}s")

    # -- 13. summary ------------------------------------------------------------
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
