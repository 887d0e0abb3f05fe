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
   60,000 of MsMarco's 8,842,240, seed 0; 64 queries) and ONE Seismic
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
   phase 3's flat and Seismic retrievers (all its docs) and phase 6's
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
   ``build_shard_arrays(n_shards=1, host_index=phase 3's index)`` (all its
   docs, dotvbyte/f16, the CLI's Seismic parameters) equals phase 3's
   Seismic ids and scores bit for bit. (b) four gloo ranks, all on
   ``cuda:0``, each holding one shard: ``ShardedRetriever(use_mesh=True)``
   over phase 8's trees (flat over all docs, Seismic over 5,000, hnsw
   over 2,000, kept in ``build/chip_smoke_trees``) equals phase 8's
   sequential answer bit for bit on every rank, and the sequential
   rotation's after ``set_tombstones`` with 5 victims; and
   ``make_sharded_search`` over ``build_shard_arrays(S=4, host_index=...)``
   equals an in-process oracle (each shard's ``search_batch`` on the card
   in turn, then the same merge) bit for bit. (c) the doc-aligned scan
   (``scoring.make_doc_aligned_scan``) of ``pack_blocks_sharded`` of the
   collection at S = 4, T = 512, D = 64 for dotvbyte, streamvbyte and
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
13. the paper's retrieval configs (``repro_torch.configs``), in one
   spawned NCCL rank on a ``(1, 1)`` mesh. (a) The cells of
   ``get_arch("msmarco-splade")`` at phase 3's collection (its
   ``n_docs`` replaced by the collection's): ``scan_100q`` at opt 0
   (global scatter, the fused batch entry) and opt 2 (the doc-aligned
   scan, int8 seg) over the first 100 queries, scores held to
   ``torch.sparse.mm`` (1e-4) and top-10 to ``exact_top_k``;
   ``serve_4096q`` over ``build_shard_arrays(n_shards=1, host_index=phase
   3's index)`` and ``graph_4096q`` over phase 6's graph (its arrays with a
   shard axis of 1 and the identity id map, what ``build_shard_arrays``
   stacks for one shard) with all 4,096 queries of phase 3's draw, ids
   and scores bit for bit equal to phase 3's Seismic and phase 6's hnsw
   retrievers' own searches (in batches of 64, the plans they captured).
   Each cell's ms (host clock + synchronise,
   median of 10), launches and ``max_memory_allocated`` beside the dry
   run's bytes for a one-device mesh. (b) Table 1's scan at the full
   corpus, ``scan_100q`` of both configs at their own ``n_docs``
   (8,842,240): the index made on the card from copies of phase 5's
   block pack of phase 3's docs (SPLADE) or of phase 11's 5,000 LiLSR docs,
   ``doc_ids`` offset a copy (``replicate_pack``), at opt 0 (int32 seg)
   and opt 2 (int8 seg), every copy's scores held to ``sparse.mm`` of the
   base CSR (1e-4); ms (CUDA events, median of 10), resident GB, bits per
   component, the bound; then, the pack freed, ``sparse.mm`` over the
   full CSR (nq 100 and 1, int32 indices), held to opt 2's scores: one
   CSR for SPLADE, row parts of at most 2**30 nonzeros for LiLSR's 3.4
   billion (27.4 GB; one int64 CSR of them gave cuSPARSE's SpMM wrong
   scores at nq 100 and an internal error at nq 1, and so did a part of
   2**31 − 1 at nq 1). (c) Each config's
   ``smoke()`` on the card. Launches go to
   ``launches_by_path["configs"]``;
14. the LM family (``repro_torch.configs``' LM configs, ``models/``,
   ``dist.collectives``), in one spawned NCCL rank on a ``(1, 1)`` mesh
   started after phase 2b: it needs nothing of the phases before it and
   runs beside phase 3's host build (Python, the card idle); the parent
   joins it before phase 3 places its index. qwen3-8b and olmoe-1b-7b at
   full width (random bf16 weights drawn on the card, seed 0): (a)
   ``build_cell("prefill_32k")`` at batch 1 (cut from 32: one card) over
   the full 32,768 tokens, chunked attention at 2,048, its cache's first
   positions held to ``forward``; (b) ``build_cell("decode_32k")`` at batch
   8 (cut from 128) over a full 32,768-slot cache (38.6 GB for qwen3-8b):
   a prompt prefilled into it, decode steps held to ``forward`` at their
   positions, then timed steps; (c) flash decoding's local path at
   ``long_500k``'s 524,288 keys (one qwen3-8b layer's cache) against the
   masked reference; (d) chunked against full attention at 4,096 tokens,
   one olmoe MoE layer's dispatch (capacity, order, no token twice),
   every LM config's ``smoke()`` on the card against the CPU, and one
   ``launch.train --smoke``. Tolerances beside their constants (``LM_*``).
   Prefill ms and tokens/s beside ``model_flops`` over 989 TFLOP/s, a
   decode step's ms beside weights + cache over 3.35 TB/s,
   ``max_memory_allocated`` beside the dry run's bytes at the cut batch.
   (e) C7: one olmoe-1b-7b MoE layer in bf16 at full width, five runs on
   the card without deterministic algorithms: the same bits each run
   (output and input gradient), the slot-order combine equal to the
   CPU's bits on the same expert outputs, the old ``index_add`` combine's
   distinct results counted. (f) qwen3-8b (bf16) and olmoe-1b-7b (f32) at
   full width cut to ``LM_PLACED_LAYERS`` layers: the four cells with
   ``weights="placed"`` at world 1 (every collective on a group of one)
   against the whole-weight cells. The LM family has no Pallas kernel, so
   no kernel of the port runs here;
15. the GNN and RecSys families (``GNNArch``, ``RecsysArch``,
   ``models/gnn.py``, ``models/recsys.py``), in phase 14's rank after its
   LM work, once that memory is freed; weights drawn on the card from a
   ``torch.Generator`` at the reference's scales, graphs and batches from
   seeds. (a) GAT: ``get_arch("gat-cora").build_cell`` for its four
   shapes at their budgets — Cora's 2,708 nodes and 10,556 edges (1,433
   binary features, 7 classes), 128 molecules of 30 nodes and 64 edges,
   ``NeighborSampler.sample_padded`` of 1,024 seeds at fanout (15, 10)
   over a host graph at Reddit's 232,965 nodes and mean in-degree
   (~114.6M edges), and ``ogb_products`` at its full 2,449,407 nodes and
   61,865,984 edges (the chunked SpMM keeps ``[E, H]`` tensors only);
   each step timed, its loss and every gradient held to the CPU's (the
   three shapes the CPU runs), and ``gat-cora-opt1`` / ``-opt2`` (the
   edge-sharded layer on this one-card mesh) held to ``opt`` 0 on
   ``full_graph_sm`` and ``ogb_products``. (b) DeepFM, DCN-v2, SASRec
   and DIN at full width, each in its four cells: ``serve_p99`` (512)
   held to the CPU on the same weights and batch, ``serve_bulk``
   (262,144) whose first 512 rows equal ``serve_p99``'s function,
   ``retrieval_cand`` (1,000,448 in-range candidates; DIN **cut to
   250,112**: at 1,000,448 its attention tower's input and first
   layer's product pass 80 GB) whose first 512 scores equal the batched
   forward of those rows, ``train_batch`` (65,536; SASRec **cut to
   8,192**: its gathered negatives are 1.28 MB a row) timed with a finite
   loss, and a train step's loss and gradients at 512 rows held to the
   CPU's. (c) The five configs' ``smoke()`` on the card against the CPU,
   and one ``launch.train --arch deepfm --smoke``. Every cell's ms (host
   clock + synchronise, median of 5 after a warm-up), samples, nodes or
   edges a second, bound (``model_flops`` over 67 TFLOP/s f32 against
   the cell's dry-run bytes over 3.35 TB/s) and ``max_memory_allocated``
   beside the dry run's bytes on this one-device mesh. Tolerances beside
   their constants (``FAM_*``). (d) DeepFM's and SASRec's
   ``train_batch``, ``serve_p99`` and ``retrieval_cand`` with
   ``weights="placed"`` at world 1 against the whole-weight cells. Then
   the parent holds each cell that phases 14 and 15 ran at full size
   (qwen3-8b's ``prefill_32k`` and ``decode_32k``, every phase-15 cell)
   to the dry run: ``max_memory_allocated`` over ``launch.dryrun.
   cell_memory``'s peak of a (1, 1) mesh at the same batch (arguments +
   outputs + the traced temporaries − aliases) within ``MEM_FACTOR``.
   Neither family has a Pallas kernel, so no kernel of the port runs
   here;
16. one JSON line of kernels, the card line, and as the last line
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

            err = max(check_close(f"{entry} @ n_docs width {w}", g, e)
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

            err = check_close(f"{entry} @ n_docs", kernel(), plain())
            bound_ms, bound_by = scan_bound(p, Qx.shape[0], dim)
        max_err[entry] = max(max_err.get(entry, 0.0), err)
        # the fused call in every stage that takes it, each held against its plain version
        want_fused = fused_plain()
        for st in stages_here:
            f_err = check_close(f"{entry} @ n_docs fused {st}", fused_call(st), want_fused)
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
#: 4,096; one query up to the whole collection and past it
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
    # drawn with phase 13's 100 scan queries; this phase serves the first nq
    col = generate_collection(lilsr_config(n_flat, max(nq, SCAN_NQ), 1), value_format="f16")
    Ql_all = np.stack([col.query_dense(i) for i in range(col.n_queries)])
    Ql_np = Ql_all[:nq]
    out["_lilsr"] = (col.fwd, Ql_all)
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


def _wait_for(d: pathlib.Path, *names: str, phase: int = 12) -> None:
    """Wait until the parent has written ``names`` in ``d``; raise where it
    wrote ``abort`` or the deadline passes."""
    t0 = time.monotonic()
    while not all((d / n).exists() for n in names):
        if (d / "abort").exists():
            raise SystemExit(f"phase {phase}: the parent aborted")
        if time.monotonic() - t0 > MESH_DEADLINE_S:
            raise TimeoutError(f"phase {phase}: {names} not written within {MESH_DEADLINE_S}s")
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


# ---------------------------------------------------------------------------
# phase 13: the paper's retrieval configs
# ---------------------------------------------------------------------------

#: phase 13: the rank's inputs and outputs; timed calls a cell; the scan's
#: batch; the configs' full corpus (MsMarco's passages padded to /512)
CELLS_DIR = ROOT / "build" / "chip_smoke_cells"
CELL_REPS = 10
SCAN_NQ = 100
SEARCH_NQ = 4096
FULL_DOCS = 8_842_240
#: the replicated scans against sparse.mm of the base collection
FULL_RTOL = FULL_ATOL = 1e-4


def replicate_pack(base: dict, n_base: int, n_docs: int) -> dict:
    """A block pack of ``n_docs`` documents made of copies of ``base``
    (the streams of a pack of ``n_base`` documents, tensors, blocks in
    doc order): ⌈n_docs / n_base⌉ copies, copy r's ``doc_ids`` offset by
    r · n_base (unused slots stay -1), cut after the last block whose
    first document is below ``n_docs``. Slots of that block past
    ``n_docs`` hold ids the scan drops."""
    reps = -(-n_docs // n_base)
    tail = n_docs - (reps - 1) * n_base
    first = base["doc_ids"][:, 0]  # slot 0 of every block is used
    B0 = first.shape[0]
    B = (reps - 1) * B0 + int((first < tail).sum())
    out = {k: v.repeat(reps, *([1] * (v.dim() - 1)))[:B] for k, v in base.items()}
    ids = out["doc_ids"]
    off = (torch.arange(B, device=ids.device, dtype=torch.int32) // B0 * n_base).unsqueeze(1)
    out["doc_ids"] = torch.where(ids >= 0, ids + off, ids)
    return out


def replicate_csr(offsets, comps, vals, n_base: int, n_docs: int, index_dtype=torch.int32,
                  col_dtype=None):
    """The CSR of ``replicate_pack``'s corpus (``offsets`` [n_base + 1],
    ``comps``, ``vals`` of the base, tensors) → (crow, col, val) with
    ``index_dtype`` indices (``col_dtype`` for ``col`` where given)."""
    reps = -(-n_docs // n_base)
    nnz0 = int(offsets[-1])
    starts = offsets[:-1].to(torch.int64).repeat(reps)[:n_docs]
    starts += torch.arange(n_docs, device=offsets.device) // n_base * nnz0
    total = nnz0 * (n_docs // n_base) + int(offsets[n_docs % n_base])
    crow = torch.cat([starts, starts.new_tensor([total])]).to(index_dtype)
    return crow, comps.to(col_dtype or index_dtype).repeat(reps)[:total], vals.repeat(reps)[:total]


def csr_row_parts(crow, col, val, n_cols: int, max_nnz: int = 2**30) -> list:
    """A CSR (``crow`` offsets of any integer dtype, ``col``, ``val``) as
    sparse CSR tensors over consecutive row ranges of at most ``max_nnz``
    nonzeros each, with int32 indices (``col`` and ``val`` sliced, not
    copied): ``sparse.mm`` over each, concatenated, is the whole's. The
    default keeps a part well inside int32: on the H100 (torch 2.11, CUDA
    12.8) cuSPARSE's SpMM raised an internal error at one query over a
    part of 2**31 − 1 nonzeros, and ran over parts of 1.71e9."""
    n = crow.shape[0] - 1
    wide = crow.to(torch.int64)
    bounds = [0]
    while bounds[-1] < n:  # each part the most rows that fit
        d0 = bounds[-1]
        d1 = int(torch.searchsorted(wide, wide[d0:d0 + 1] + max_nnz, right=True)) - 1
        if d1 <= d0:
            raise SystemExit(f"csr_row_parts: row {d0} alone holds more than {max_nnz} "
                             f"nonzeros")
        bounds.append(min(d1, n))
    parts = []
    for d0, d1 in zip(bounds[:-1], bounds[1:]):
        a, b = int(crow[d0]), int(crow[d1])
        parts.append(torch.sparse_csr_tensor((crow[d0:d1 + 1] - a).to(torch.int32),
                                             col[a:b].to(torch.int32), val[a:b],
                                             size=(d1 - d0, n_cols)))
    return parts


def replicas_close(scores, base_scores, n_base: int, rtol=FULL_RTOL, atol=FULL_ATOL) -> list:
    """Every copy's slice of ``scores`` (f32 [nq, n_docs], a transposed
    doc-major result) against ``base_scores`` (f32 [nq, n_base]) → each
    copy's max abs error; exits where one is outside the tolerance."""
    acc, want = scores.t(), base_scores.t()
    n = acc.shape[0]
    errs = []
    for lo in range(0, n, n_base):
        got = acc[lo:lo + n_base]
        w = want[: got.shape[0]]
        d = (got - w).abs()
        if not bool((d <= atol + rtol * w.abs()).all()):
            raise SystemExit(f"phase 13: copy {lo // n_base} differs from sparse.mm of the base "
                             f"beyond rtol {rtol}, atol {atol} (max {float(d.max()):.3g})")
        errs.append(float(d.max()))
    return errs


def cuda_ms_median(fn, reps: int, warmup: int = 1) -> float:
    """Median device time of ``fn`` over ``reps`` calls, each between two
    CUDA events."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def _to_dev(d: pathlib.Path, name: str, dev) -> dict:
    return {k: torch.from_numpy(np.array(v)).to(dev) for k, v in _load_arrays(d, name).items()}


def _padded(Q, width: int):
    return torch.nn.functional.pad(Q, (0, width - Q.shape[1]))


def _run_cell(fn, args, reps: int) -> dict:
    """A cell's first call (placement, capture) and ``reps`` timed calls
    (host clock + synchronise) → its last result and timings, with the
    device's peak allocation over them."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = fn(*args)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    lat = host_ms(lambda: fn(*args), reps)
    return dict(result=res, first_s=first_s, ms_median=statistics.median(lat), ms=lat,
                max_memory_allocated=torch.cuda.max_memory_allocated())


def _predicted(arch, shape: str) -> dict:
    """The dry run's per-device bytes of ``arch``'s cell on a one-device mesh."""
    from repro_torch.launch.mesh import MeshShape

    m = arch.build_cell(shape, MeshShape((1, 1), ("data", "model"))).meta
    return dict(argument_bytes=m["argument_bytes"], output_bytes=m["output_bytes"],
                peak_device_bytes=m["argument_bytes"] + m["output_bytes"])


def full_corpus_scan(config: str, base: dict, csr: tuple, Q, mesh, n_base: int,
                     n_docs: int | None = None) -> dict:
    """Phase 13 (b) for ``config``: its ``scan_100q`` over copies of
    ``base`` at the config's own ``n_docs`` (unless given), at opt 0
    (global scatter, int32 seg) and opt 2 (one doc-aligned shard, int8
    seg), each held copy by copy against ``sparse.mm`` of the base CSR;
    then ``sparse.mm`` over the full CSR where its indices fit int32 →
    the record."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.kernels import block_scan

    arch = get_arch(config)
    n_docs = n_docs or arch.n_docs
    dim = arch.dim
    Qd = Q[:, :dim].contiguous()
    offsets, comps, vals = csr
    csr_base = torch.sparse_csr_tensor(offsets, comps, vals, size=(n_base, dim))
    base_scores = torch.sparse.mm(csr_base, Qd.t().contiguous()).t()
    rec = dict(config=config, n_docs=n_docs, n_base=n_base, copies=-(-n_docs // n_base),
               nq=Q.shape[0])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    arrays = replicate_pack(base, n_base, n_docs)
    torch.cuda.synchronize()
    rec["replicate_s"] = time.perf_counter() - t0
    nnz = _live_entries(arrays["seg"])
    rec["n_blocks"], rec["nnz"] = int(arrays["seg"].shape[0]), nnz
    comp_bytes = int(arrays["ctrl"].nbytes + arrays["data"].nbytes)
    rec["bits_per_component"] = 8 * comp_bytes / nnz
    last = None
    for opt in (0, 2):
        if opt == 2:
            last = None
            arrays["seg"] = arrays["seg"].to(torch.int8)
        cell_arch = dataclasses.replace(get_arch(config + ("-opt2" if opt else "")),
                                        n_docs=n_docs)
        cell = cell_arch.build_cell("scan_100q", mesh)
        feed = arrays if opt == 0 else {k: v.unsqueeze(0) for k, v in arrays.items()}
        stream_bytes = sum(int(v.nbytes) for v in arrays.values())
        block_scan.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        scores = cell.fn(feed, Q)
        torch.cuda.synchronize()
        errs = replicas_close(scores, base_scores, n_base)
        ms = cuda_ms_median(lambda: cell.fn(feed, Q), CELL_REPS)
        n_bytes = stream_bytes + 4 * Q.numel() + 4 * Q.shape[0] * n_docs
        bound_bytes = 1e3 * n_bytes / HBM_BYTES_PER_S
        bound_ops = 1e3 * 2 * Q.shape[0] * nnz / F32_FLOP_PER_S
        rec[f"opt{opt}"] = dict(
            ms=ms, copies_max_abs_err=max(errs), resident_bytes=stream_bytes,
            scores_bytes=4 * Q.shape[0] * n_docs,
            max_memory_allocated=torch.cuda.max_memory_allocated(),
            bound_ms=max(bound_bytes, bound_ops),
            bound_by="bytes" if bound_bytes >= bound_ops else "operations",
            launches=dict(block_scan.variant_launches),
            predicted=_predicted(cell_arch, "scan_100q"), seg=str(arrays["seg"].dtype))
        if opt == 0:  # the single-query entry over the same pack (the table's row 2)
            rec["single"] = _single_query_scan(arrays, csr_base, Qd, n_base, n_docs, dim,
                                               stream_bytes, nnz)
        last = scores
        del cell, scores
        torch.cuda.empty_cache()
    # sparse.mm over the whole replicated CSR, int32 indices, in row parts
    # of at most 2**30 nonzeros (``csr_row_parts``), their products
    # concatenated: one for SPLADE, four for LiLSR's 3.4 billion.
    # cuSPARSE over one int64 CSR of them returned wrong scores at nq 100
    # and failed at nq 1 (torch 2.11, CUDA 12.8)
    del arrays, feed
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    total_nnz = int(offsets[-1]) * (n_docs // n_base) + int(offsets[n_docs % n_base])
    rec["nnz_csr"] = total_nnz
    wide = total_nnz >= 2**31
    crow, col, val = replicate_csr(offsets, comps, vals, n_base, n_docs,
                                   torch.int64 if wide else torch.int32, torch.int32)
    parts = csr_row_parts(crow, col, val, dim)
    csr_bytes = sum(p.crow_indices().nbytes + p.col_indices().nbytes + p.values().nbytes
                    for p in parts)
    del crow

    def lib_mm(q):
        outs = [torch.sparse.mm(p, q) for p in parts]
        return outs[0] if len(outs) == 1 else torch.cat(outs)

    Qt = Qd.t().contiguous()
    lib = lib_mm(Qt).t()
    torch.testing.assert_close(last, lib, rtol=FULL_RTOL, atol=FULL_ATOL)
    err = float((last - lib).abs().max())
    del lib
    q_col = Qt[:, :1].contiguous()
    rec["sparse_mm"] = dict(
        ms=cuda_ms_median(lambda: lib_mm(Qt), CELL_REPS),
        ms_nq1=cuda_ms_median(lambda: lib_mm(q_col), CELL_REPS),
        csr_bytes=csr_bytes, index_dtype="int32", parts=len(parts), max_abs_err_vs_opt2=err,
        max_memory_allocated=torch.cuda.max_memory_allocated())
    del parts, col, val
    del last
    torch.cuda.empty_cache()
    return rec


def _live_entries(seg) -> int:
    """Entries of ``seg`` that hold a document (≥ 0), counted in row chunks:
    a sum over the whole mask widens it to int64 (27 GB for LiLSR's 3.6
    billion entries)."""
    return sum(int((part >= 0).sum()) for part in seg.split(1 << 18))


def _single_query_scan(arrays: dict, csr_base, Qd, n_base: int, n_docs: int, dim: int,
                       stream_bytes: int, nnz: int) -> dict:
    """The full corpus's single-query scan (``ops.score_dotvbyte``, the
    resident-query stage where the query fits) over ``arrays``, held copy by
    copy to ``sparse.mm`` of the base → its record."""
    from repro_torch.core.forward_index import PackedBlocks, ValueFormat
    from repro_torch.kernels import block_scan, ops

    packed = PackedBlocks(codec="dotvbyte", block_size=int(arrays["seg"].shape[1]),
                          n_docs=n_docs, dim=dim,
                          value_format=ValueFormat("scaled", np.float16, 1.0), **arrays)
    q = Qd[0]
    block_scan.reset_launches()
    got = ops.score_dotvbyte(q, packed)
    torch.cuda.synchronize()
    want = torch.sparse.mm(csr_base, q.unsqueeze(1).contiguous()).t()
    errs = replicas_close(got.unsqueeze(0), want, n_base)
    ms = cuda_ms_median(lambda: ops.score_dotvbyte(q, packed), CELL_REPS)
    bound_bytes = 1e3 * (stream_bytes + 4 * dim + 4 * n_docs) / HBM_BYTES_PER_S
    bound_ops = 1e3 * 2 * nnz / F32_FLOP_PER_S
    return dict(ms=ms, copies_max_abs_err=max(errs), bound_ms=max(bound_bytes, bound_ops),
                bound_by="bytes" if bound_bytes >= bound_ops else "operations",
                launches=dict(block_scan.variant_launches),
                stages={k: v for k, v in block_scan.stage_launches.items() if v})


def cells_rank(rank: int, world: int, d: str) -> None:
    """Phase 13's NCCL rank (world 1, mesh ``(1, 1)``): (a) the configs'
    cells over phase 3's collection; (b) Table 1's scan at the full
    corpus, for both configs."""
    import dataclasses

    import torch.distributed as dist

    from repro_torch.configs import get_arch
    from repro_torch.kernels import block_scan, rows_dot
    from repro_torch.launch.mesh import make_debug_mesh

    d = pathlib.Path(d)
    _wait_for(d, "ready", phase=13)
    spec = json.loads((d / "spec.json").read_text())
    dev = torch.device("cuda")
    mesh = make_debug_mesh((1, 1), ("data", "model"))
    n = spec["n_docs"]
    Q = torch.from_numpy(np.load(d / "Q.npy")).to(dev)
    out = dict(backend=dist.get_backend(), cells={})
    splade = get_arch("msmarco-splade")
    dim_pad = splade.build_cell("scan_100q", mesh).input_structs[1].shape[1]
    Qs = _padded(Q[:SCAN_NQ], dim_pad)
    rows_dot.reset_launches()
    block_scan.reset_launches()
    # (a) scan_100q at opt 0 and 2 over phase 3's collection
    for opt in (0, 2):
        arch = dataclasses.replace(get_arch("msmarco-splade" + ("-opt2" if opt else "")),
                                   n_docs=n)
        cell = arch.build_cell("scan_100q", mesh)
        arrays = _to_dev(d, f"scan{opt}", dev)
        before = dict(block_scan.variant_launches)
        rec = _run_cell(cell.fn, (arrays, Qs), CELL_REPS)
        np.save(d / f"out_scan{opt}.npy", rec.pop("result").cpu().numpy())
        rec["launches"] = {k: v - before.get(k, 0)
                           for k, v in block_scan.variant_launches.items() if v - before.get(k, 0)}
        rec["predicted"] = _predicted(arch, "scan_100q")
        out["cells"][f"scan_100q/opt{opt}"] = rec
        del cell, arrays
    # serve_4096q and graph_4096q through make_sharded_search
    for shape, name, n_docs in (("serve_4096q", "serve", n), ("graph_4096q", "graph",
                                                               spec["hnsw_docs"])):
        arch = dataclasses.replace(splade, n_docs=n_docs)
        cell = arch.build_cell(shape, mesh)
        stacked, idmap = _load_arrays(d, name), np.load(d / f"{name}_idmap.npy")
        before = dict(rows_dot.variant_launches)
        rec = _run_cell(cell.fn, (stacked, idmap, Q), CELL_REPS)
        ids, scores = rec.pop("result")
        np.savez(d / f"out_{name}.npz", ids=ids.cpu().numpy(), scores=scores.cpu().numpy())
        eager = {k: v - before.get(k, 0) for k, v in rows_dot.variant_launches.items()}
        launches = _replayed([cell.fn.fn._placed[2]])
        _add(launches, eager)
        rec["launches"] = {k: v for k, v in launches.items() if v}
        rec["stages"] = sorted({st for p in cell.fn.fn._placed[2].plans.created().values()
                                for st in p.stages})
        rec["predicted"] = _predicted(arch, shape)
        out["cells"][shape] = rec
        del cell, stacked
    torch.cuda.empty_cache()
    # (b) Table 1's scan over the full corpus, each config from its base collection
    out["full"] = {}
    for config, name in (("msmarco-splade", "splade"), ("msmarco-lilsr", "lilsr")):
        base = _to_dev(d, f"base_{name}", dev)
        csr = tuple(torch.from_numpy(np.load(d / f"csr_{name}_{k}.npy")).to(dev)
                    for k in ("offsets", "comps", "vals"))
        Qb = Qs if name == "splade" else _padded(
            torch.from_numpy(np.load(d / "Q_lilsr.npy")).to(dev)[:SCAN_NQ], dim_pad)
        out["full"][config] = full_corpus_scan(config, base, csr, Qb, mesh,
                                               spec[f"{name}_base_docs"])
        del base, csr
        torch.cuda.empty_cache()
    (d / "out.json").write_text(json.dumps(out))


def _searched_in_batches(ret, Q, batch: int) -> tuple:
    """``ret.search`` over ``Q`` in batches of ``batch`` → host (ids, scores)."""
    parts = [ret.search(Q[i:i + batch]) for i in range(0, Q.shape[0], batch)]
    return tuple(torch.cat(x).cpu().numpy() for x in zip(*parts))


def _csr_parts(fwd) -> dict:
    return dict(offsets=fwd.offsets.astype(np.int64), comps=fwd.components.astype(np.int64),
                vals=fwd.value_format.dequantise(fwd.values).astype(np.float32))


def cells_phase(fwd, Q_all, index, seismic_ret, hnsw_ret, truth, csr, lilsr, card: str) -> dict:
    """Phase 13: the paper's retrieval configs (see the module docstring) →
    its records, and under ``"_path"`` the rows and block-scan launches of
    the rank and of (c). ``Q_all`` holds phase 3's 4,096 queries (host),
    ``truth`` the exact top-10 of its first queries, ``lilsr`` phase 11's
    (collection, queries)."""
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.configs import RETRIEVAL_IDS, get_arch
    from repro_torch.core.layout import pack_blocks, pack_blocks_sharded
    from repro_torch.core.seismic import exact_top_k
    from repro_torch.kernels import block_scan
    from repro_torch.launch.mesh import spawn_ranks
    from repro_torch.serve.api import build_shard_arrays, top_k

    d = CELLS_DIR
    shutil.rmtree(d, ignore_errors=True)
    d.mkdir(parents=True)
    dev = csr.device
    n = fwd.n_docs
    splade = get_arch("msmarco-splade")
    graph_p = splade._graph_cfg().params
    if any(hnsw_ret.cfg.params[k] != v for k, v in graph_p.items()) or hnsw_ret.cfg.codec != \
            splade.codec:
        raise SystemExit(f"phase 13: phase 6's graph serves {hnsw_ret.cfg}, the cell {graph_p}")
    prep = {}
    pool = ThreadPoolExecutor(1)
    try:
        # the rank starts (Python, torch, the card) while its inputs and the oracles are made
        fut = pool.submit(spawn_ranks, cells_rank, 1, str(d), backend="nccl",
                          init_file=d / "init", timeout_s=MESH_DEADLINE_S + 600)
        t0 = time.perf_counter()
        np.save(d / "Q.npy", Q_all)
        scan_pack = pack_blocks(fwd, codec="dotvbyte", block_size=512).as_dict()  # phase 5's
        _save_arrays(d, "scan0", scan_pack)
        _save_arrays(d, "base_splade", scan_pack)
        packs, _ = pack_blocks_sharded(fwd, 1, codec="dotvbyte", block_size=512,
                                       seg_dtype=np.int8)
        _save_arrays(d, "scan2", packs)
        stacked, idmap, _ = build_shard_arrays(fwd, splade._engine_cfg(), 1, host_index=index)
        _save_arrays(d, "serve", stacked)
        np.save(d / "serve_idmap.npy", idmap)
        # phase 6's graph as one shard: build_shard_arrays(n_shards=1) stacks a graph so
        # built with an identity id map (tests/test_torch_configs.py holds that on the CPU)
        n_h = hnsw_ret.n_docs
        _save_arrays(d, "graph", {k: v.unsqueeze(0).cpu().numpy()
                                  for k, v in hnsw_ret.arrays.items()})
        np.save(d / "graph_idmap.npy", np.arange(n_h + 1, dtype=np.int32)[None])
        fwd_l, Ql_np = lilsr
        pack_l = pack_blocks(fwd_l, codec="dotvbyte", block_size=512)
        _save_arrays(d, "base_lilsr", pack_l.as_dict())
        np.save(d / "Q_lilsr.npy", Ql_np)
        for name, f in (("splade", fwd), ("lilsr", fwd_l)):
            for k, v in _csr_parts(f).items():
                np.save(d / f"csr_{name}_{k}.npy", v)
        (d / "spec.json").write_text(json.dumps(dict(
            n_docs=n, hnsw_docs=n_h, splade_base_docs=n, lilsr_base_docs=fwd_l.n_docs)))
        prep["inputs_s"] = time.perf_counter() - t0
        # the oracles, before the rank touches the card
        t0 = time.perf_counter()
        # the retrievers' own searches, in the batches of 64 their plans were
        # captured at (an answer does not depend on its batch, C2)
        Q = torch.from_numpy(Q_all).to(dev)
        want_serve = _searched_in_batches(seismic_ret, Q, N_QUERIES)
        want_graph = _searched_in_batches(hnsw_ret, Q, N_QUERIES)
        Q100 = Q[:SCAN_NQ]
        lib = torch.sparse.mm(csr, Q100.t().contiguous()).t()
        truth = list(truth) + [exact_top_k(fwd, Q_all[i], 10)
                               for i in range(len(truth), SCAN_NQ)]
        prep["oracles_s"] = time.perf_counter() - t0
        del Q
        torch.cuda.empty_cache()
        prep["parent_reserved_gib"] = torch.cuda.memory_reserved() / 2**30
        (d / "ready").touch()
        spawn_s = fut.result()
    except BaseException:
        (d / "abort").touch()
        raise
    finally:
        pool.shutdown(wait=True)
    res = json.loads((d / "out.json").read_text())
    cells = res["cells"]
    # (a): the scans against sparse.mm and exact_top_k; the searches bit for bit
    for opt in (0, 2):
        got = torch.from_numpy(np.load(d / f"out_scan{opt}.npy")).to(dev)
        torch.testing.assert_close(got, lib, rtol=1e-4, atol=1e-4)
        sc, ids = top_k(got, 10)
        swaps = sum(tie_aware_topk(f"phase 13 scan_100q opt {opt} query {i}",
                                   ids[i].cpu().numpy(), sc[i].cpu().numpy(), *truth[i])
                    for i in range(SCAN_NQ))
        cells[f"scan_100q/opt{opt}"].update(max_abs_err=float((got - lib).abs().max()),
                                            tied_swaps=swaps)
    for shape, name, want, what in (("serve_4096q", "serve", want_serve, "phase 3's Seismic"),
                                    ("graph_4096q", "graph", want_graph, "phase 6's hnsw")):
        with np.load(d / f"out_{name}.npz") as z:
            bitwise(f"phase 13 (a): {shape} at nq {SEARCH_NQ} vs {what} retriever in batches "
                    f"of {N_QUERIES}",
                    (z["ids"], z["scores"]), want)
    # (c): each config's smoke on the card
    block_scan.reset_launches()
    smoke = {a: get_arch(a).smoke(seed=0) for a in RETRIEVAL_IDS}
    torch.cuda.synchronize()
    smoke_launches = {k: v for k, v in block_scan.variant_launches.items() if v}
    rows, blocks = {}, dict(smoke_launches)
    for key, rec in cells.items():
        _add(rows if key.endswith("4096q") else blocks, rec["launches"])
    for rec in res["full"].values():
        for opt in ("opt0", "opt2", "single"):
            _add(blocks, rec[opt]["launches"])
    if (rows.get("rows_dot_dotvbyte_f16", 0) <= 0
            or blocks.get("block_scan_dotvbyte_batch", 0) <= 0
            or blocks.get("block_scan_dotvbyte", 0) <= 0):
        raise SystemExit(f"phase 13 launched rows {rows}, block scans {blocks}")
    out = dict(backend=res["backend"], prep_s=prep, spawn_s=spawn_s, cells=cells,
               full=res["full"], smoke=smoke, _path=dict(rows_launches=rows,
                                                         block_launches=blocks))
    gib = 2**30
    docs_of = {"serve_4096q": n, "graph_4096q": n_h}
    log(f"[13] the retrieval configs ({card}): one {res['backend']} rank, mesh (1, 1); inputs "
        f"{prep['inputs_s']:.1f}s, oracles {prep['oracles_s']:.1f}s, spawn {spawn_s:.1f}s; the "
        f"parent held {prep['parent_reserved_gib']:.2f} GiB of the card meanwhile")
    for key, rec in cells.items():
        p = rec["predicted"]
        extra = (f"== sparse.mm (max {rec['max_abs_err']:.2e}), top-10 == exact_top_k "
                 f"({rec['tied_swaps']} tied swaps)" if key.startswith("scan") else
                 f"== the retriever's own search (batches of {N_QUERIES}) bit for bit, stages "
                 f"{rec['stages']}")
        log(f"    (a) {key} over {docs_of.get(key, n)} docs: {extra}; "
            f"{rec['ms_median']:.3f} ms median of {CELL_REPS} (first {rec['first_s']:.2f}s), "
            f"launches {rec['launches']}, max_memory_allocated "
            f"{rec['max_memory_allocated'] / gib:.2f} "
            f"GiB; dry run (1, 1): {p['peak_device_bytes'] / gib:.3f} GiB ({card})")
    for config, rec in res["full"].items():
        for opt in ("opt0", "opt2"):
            r = rec[opt]
            log(f"    (b) {config} scan_100q {opt} ({r['seg']} seg) over {rec['n_docs']:,} docs "
                f"({rec['copies']} copies of {rec['n_base']:,}; B={rec['n_blocks']:,}, "
                f"{rec['nnz']:,} nnz): == sparse.mm of the base copy by copy (max "
                f"{r['copies_max_abs_err']:.2e}); {r['ms']:.3f} ms (CUDA events, median of "
                f"{CELL_REPS}), bound {r['bound_ms']:.3f} ms by {r['bound_by']}; pack "
                f"{r['resident_bytes'] / 1e9:.2f} GB + scores {r['scores_bytes'] / 1e9:.2f} GB, "
                f"max_memory_allocated {r['max_memory_allocated'] / 1e9:.2f} GB; dry run (1, 1): "
                f"{r['predicted']['peak_device_bytes'] / 1e9:.2f} GB ({card})")
        sm, one = rec["sparse_mm"], rec["single"]
        log(f"    (b) {config} single query (block_scan_dotvbyte, {one['stages']}): == "
            f"sparse.mm of the base copy by copy (max {one['copies_max_abs_err']:.2e}); "
            f"{one['ms']:.3f} ms, bound {one['bound_ms']:.3f} ms by {one['bound_by']} ({card})")
        log(f"    (b) {config}: {rec['bits_per_component']:.2f} bits/comp (ctrl + data); "
            + f"sparse.mm over the full CSR ({sm['csr_bytes'] / 1e9:.2f} GB, int32, in "
            f"{sm['parts']} row part(s) of ≤ 2**30 nonzeros; max_memory_allocated "
            f"{sm['max_memory_allocated'] / 1e9:.2f} GB) {sm['ms']:.3f} ms (nq 1: "
            f"{sm['ms_nq1']:.3f}), == opt 2 within 1e-4 (max {sm['max_abs_err_vs_opt2']:.2e}) "
            f"({card})")
    log("    (c) smoke: " + ", ".join(f"{a} max_err {v['max_err']:.2e} on {v['device']}"
                                      for a, v in smoke.items())
        + f"; launches {smoke_launches}")
    shutil.rmtree(d, ignore_errors=True)
    return out


# ---------------------------------------------------------------------------
# phase 14: the LM family
# ---------------------------------------------------------------------------

#: phase 14: the configs served at full width (random bf16 weights, seed 0)
LM_SERVED = ("qwen3-8b", "olmoe-1b-7b")
#: every LM config, whose smoke() runs on the card and on the CPU
LM_ALL = ("olmoe-1b-7b", "kimi-k2-1t-a32b", "qwen3-8b", "yi-6b", "deepseek-coder-33b")
#: the cut batches (one card): prefill_32k's 32 sequences of 32,768 tokens
#: cut to 1 (its full logits alone are 10 GB for qwen3-8b); decode_32k's
#: 128 cut to 8 (a 32,768-slot cache is 4.83 GB a sequence for qwen3-8b)
LM_PREFILL_BATCH = 1
LM_DECODE_BATCH = 8
#: the prompt prefilled into the decode cache, the decode steps checked
#: against ``forward`` after it, the decode steps timed, the prefill's
#: warm-up tokens
LM_PROMPT, LM_CHECK_STEPS, LM_TIMED_STEPS, LM_WARM_TOKENS = 16, 8, 5, 2048
#: chunked vs full attention (qwen3-8b's heads), MoE at olmoe's width
LM_CHUNK_TOKENS = LM_MOE_TOKENS = 4096
#: long_500k's keys (one qwen3-8b layer's cache, 2.1 GB); the valid length
LM_LONG_KEYS = 524_288
LM_LONG_VALID = 524_288 - 12_345
#: bf16 model paths compared (prefill's cache and last logits, decode's
#: logits, each against ``forward``): relative L2 error of the block. The
#: paths round bf16 activations at other places (a chunked or a flash
#: softmax against a full one; GEMMs of other shapes): on the CPU an
#: 8-layer bf16 model's chunked and full forwards differ by ~1% and a
#: bf16 forward from its f32 twin by 0.9% (4% with experts, whose
#: routing flips on a rounding); a layer left out or an fp8 product
#: would not stay inside 5%
LM_BF16_RTOL = 5e-2
#: one attention call compared (chunked vs full, flash decode vs the
#: masked reference, bf16 in and out): relative L2 error; the sides
#: differ by where they round p to bf16 (2**-9)
LM_ATTN_RTOL = 1e-2
#: an MoE model's paths compared in f32 (TF32 off): relative L2 error of
#: the positions before any routing flip; on the CPU two f32 paths at
#: olmoe's width differed by 1.3e-6, a bf16 path would miss it by 100×
LM_F32_RTOL = 1e-4
#: the f32 check's decode batch: an f32 32,768-slot cache at batch 8 would
#: be 68.7 GB for olmoe-1b-7b beside its 27.7 GB of f32 weights
LM_F32_CHECK_BATCH = 2
#: smoke() on the card against the CPU (f32, TF32 off): losses (rtol) and
#: logits (atol); the second loss follows an AdamW step, whose first
#: update is ±lr for a gradient of either sign
LM_SMOKE_RTOL = 1e-4
LM_SMOKE_ATOL = 1e-4
LM_TRAIN_STEPS = 20
LM_DEADLINE_S = 1500
LM_DIR = ROOT / "build" / "chip_smoke_lm"
#: H100 SXM dense bf16 peak (NVIDIA data sheet)
BF16_FLOP_PER_S = 989e12


def _rel(got, want) -> float:
    """Relative L2 error of ``got`` against ``want`` (f32)."""
    want = want.float()
    return float((got.float() - want).norm() / want.norm())


def _tree_bytes(tree) -> int:
    from repro_torch.tree import tree_leaves

    return sum(t.numel() * t.element_size() for t in tree_leaves(tree))


def _lm_smoke_parity() -> dict:
    """Every LM config's ``smoke()`` on the card and on the CPU."""
    from repro_torch.configs import get_arch

    out = {}
    for a in LM_ALL:
        card, cpu = get_arch(a).smoke(0, device="cuda"), get_arch(a).smoke(0, device="cpu")
        rec = {k: [card[k], cpu[k]] for k in ("loss0", "loss1")}
        rec["logits_max_abs_err"] = max(float((card[k] - cpu[k]).abs().max())
                                        for k in ("logits", "decode_logits"))
        bad = [k for k in ("loss0", "loss1")
               if abs(card[k] - cpu[k]) > LM_SMOKE_RTOL * abs(cpu[k])]
        if bad or rec["logits_max_abs_err"] > LM_SMOKE_ATOL:
            raise SystemExit(f"phase 14 (d): {a} smoke() on the card differs from the CPU: "
                             f"{rec} (rtol {LM_SMOKE_RTOL}, atol {LM_SMOKE_ATOL})")
        out[a] = rec
    return out


def _lm_train_cli() -> str:
    """One ``launch.train --smoke`` run on the card → its result line."""
    import contextlib
    import io

    from repro_torch.launch import train

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        train.main(["--arch", "qwen3-8b", "--smoke", "--steps", str(LM_TRAIN_STEPS),
                    "--checkpoint-every", "10"])
    line = buf.getvalue().strip().splitlines()[-1]
    if not line.startswith(f"trained qwen3-8b {LM_TRAIN_STEPS} steps") or "restarts=0" not in line:
        raise SystemExit(f"phase 14 (d): launch.train printed {line!r}")
    return line


def _lm_attention_checks(cfg, mesh, dev) -> dict:
    """(c) flash decoding's local path at long_500k's length against the
    masked reference, and (d) chunked against full attention at 4,096
    tokens, both at ``cfg``'s heads (bf16)."""
    from repro_torch.dist.collectives import flash_decode_shardmap
    from repro_torch.models import transformer as tf

    g = torch.Generator(device=dev).manual_seed(2)
    H, Hk, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    out = {}

    def randn(*shape):
        return torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)

    q = randn(1, LM_CHUNK_TOKENS, H, dh)
    k, v = randn(1, LM_CHUNK_TOKENS, Hk, dh), randn(1, LM_CHUNK_TOKENS, Hk, dh)
    with torch.no_grad():
        chunked = tf.attention(q, k, v, causal=True, impl="chunked", chunk=2048)
        full = tf.attention(q, k, v, causal=True, impl="full")
    out["chunked_vs_full_rel"] = _rel(chunked, full)
    if not out["chunked_vs_full_rel"] <= LM_ATTN_RTOL:
        raise SystemExit(f"phase 14 (d): chunked attention differs from full by "
                         f"{out['chunked_vs_full_rel']:.3e} (rtol {LM_ATTN_RTOL})")
    del q, k, v, chunked, full
    q = randn(1, 1, H, dh)
    k, v = randn(1, LM_LONG_KEYS, Hk, dh), randn(1, LM_LONG_KEYS, Hk, dh)
    vl = torch.tensor([LM_LONG_VALID], dtype=torch.int32, device=dev)
    flash = flash_decode_shardmap(mesh, batch_axes=(), seq_axes=("data", "model"))
    with torch.no_grad():
        got, want = flash(q, k, v, vl), tf._decode_attention_ref(q, k, v, vl)
        out["flash_ms"] = cuda_ms_median(lambda: flash(q, k, v, vl), 10)
        out["ref_ms"] = cuda_ms_median(lambda: tf._decode_attention_ref(q, k, v, vl), 10)
    out["flash_vs_ref_rel"] = _rel(got, want)
    out["cache_bytes"] = 2 * k.numel() * k.element_size()
    if not (torch.isfinite(got).all() and out["flash_vs_ref_rel"] <= LM_ATTN_RTOL):
        raise SystemExit(f"phase 14 (c): flash decoding over {LM_LONG_KEYS} keys differs from "
                         f"the reference by {out['flash_vs_ref_rel']:.3e} (rtol {LM_ATTN_RTOL})")
    return out


def _lm_moe_check(params, cfg, dev) -> dict:
    """(d) one olmoe layer's experts on ``LM_MOE_TOKENS`` tokens: every
    expert keeps its first ``C`` pairs in token order and drops the rest,
    no token twice within an expert, every kept pair a routed one."""
    from repro_torch.models import moe

    lp = {k: v[0] for k, v in params["layers"]["moe"].items()}
    x = torch.randn((LM_MOE_TOKENS, cfg.d_model), generator=torch.Generator(device=dev)
                    .manual_seed(3), device=dev).to(cfg.dtype)
    E, K, T = cfg.moe.n_experts, cfg.moe.top_k, LM_MOE_TOKENS
    C = moe._capacity(T, cfg.moe)
    with torch.no_grad():
        _, gate_w, idx = moe._route(lp, cfg.moe, x)
        tok, w = moe._dispatch(idx, gate_w, cfg.moe)
        y, aux = moe.moe_apply(lp, cfg.moe, x)
        ms = cuda_ms_median(lambda: moe.moe_apply(lp, cfg.moe, x), 5)
    routed = torch.zeros((T, E), dtype=torch.bool, device=dev)
    routed[torch.arange(T, device=dev)[:, None], idx] = True
    slots = tok.reshape(E, C)
    counts = torch.bincount(idx.reshape(-1), minlength=E)
    for e in range(E):
        live = slots[e][slots[e] < T]
        want = torch.nonzero(routed[:, e])[:, 0][:C]  # its first C routed tokens, in order
        if not torch.equal(live, want):
            raise SystemExit(f"phase 14 (d): expert {e} kept {live.tolist()[:8]}…, its first "
                             f"{C} routed tokens are {want.tolist()[:8]}…")
    kept = int((tok < T).sum())
    if kept != int(torch.clamp(counts, max=C).sum()) or not torch.isfinite(y).all():
        raise SystemExit(f"phase 14 (d): MoE kept {kept} pairs of {T * K}")
    if (w[tok < T] <= 0).any():
        raise SystemExit("phase 14 (d): a kept pair has no router weight")
    return dict(tokens=T, capacity=C, kept=kept, pairs=T * K, dropped=T * K - kept,
                max_load=int(counts.max()), load_balance_loss=float(aux["load_balance_loss"]),
                ms=ms)


#: C7's check: one olmoe-1b-7b MoE layer in bf16 at full width on this
#: many tokens, run this many times on the card
C7_TOKENS, C7_RUNS = 4096, 5
#: the placed cells at world 1 (every collective on a group of one):
#: full width, cut to this many layers (qwen3-8b's AdamW state at full
#: depth is 98 GB), train_4k at 1 × 4,096 tokens, a prefill of
#: LM_PLACED_TOKENS, decode steps over a LM_PLACED_SLOTS-slot cache at
#: batch 2; the MoE config in f32 (a bf16 rounding flips a token's
#: experts, see LM_F32_RTOL)
LM_PLACED_LAYERS, LM_PLACED_TOKENS, LM_PLACED_SLOTS, LM_PLACED_STEPS = 2, 4096, 8192, 4
#: placed against whole weights on one card: relative L2 of logits and
#: caches, relative difference of losses and grad norms, AdamW's first
#: moment after two steps (of each leaf's scale), the parameters within
#: this many lr of each other beyond one rounding of their dtype (an
#: AdamW step moves a weight by ±lr whatever its gradient's size, so a
#: gradient within rounding of zero steps either way: 2 lr a step, two
#: steps; a bf16 weight rounds to 2**-7 of itself); the placed program
#: runs the same products in other shapes (an MoE buffer of min(C, T)
#: slots, vocab-parallel log-sum-exp), so its sums round apart
LM_PLACED_RTOL, LM_PLACED_LR = 1e-2, 4.0


def _lm_c7(dev) -> dict:
    """C7: one olmoe-1b-7b MoE layer (bf16, full width) on ``C7_TOKENS``
    tokens, ``C7_RUNS`` times on the card without deterministic
    algorithms: every run's output and input gradient the same bits; the
    combine (``moe._Combine``, each token's slots in ascending order, f32
    accumulation) on the card from the card's expert outputs equals the
    CPU's on the same inputs bit for bit, forward and backward; the old
    ``index_add`` combine on the card, for contrast, counted by its
    distinct results; the whole layer on the card against the CPU (their
    bf16 GEMMs differ: relative L2, and the routing)."""
    from repro_torch.configs import get_arch
    from repro_torch.models import moe

    if torch.are_deterministic_algorithms_enabled():
        raise SystemExit("phase 14 (e): C7's check must run without deterministic algorithms")
    cfg = get_arch("olmoe-1b-7b").cfg.moe
    p_cpu = moe.moe_init(torch.Generator().manual_seed(5), cfg, dtype=torch.bfloat16,
                         device="cpu")
    x_cpu = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (C7_TOKENS, cfg.d_model)).astype(np.float32)).to(torch.bfloat16)
    p = {k: v.to(dev) for k, v in p_cpu.items()}
    outs, grads = [], []
    for _ in range(C7_RUNS):
        x = x_cpu.to(dev).requires_grad_(True)
        y, _ = moe.moe_apply(p, cfg, x)
        (y.float() * torch.linspace(-1, 1, y.shape[1], device=dev)).sum().backward()
        outs.append(y.detach())
        grads.append(x.grad)
    repeat = all(torch.equal(outs[0], o) for o in outs) and all(
        torch.equal(grads[0], g) for g in grads)
    # the combine on both sides from the card's expert outputs
    with torch.no_grad():
        _, gate_w, idx = moe._route(p, cfg, x_cpu.to(dev))
        tok, w, slot_map = moe._dispatch_slots(idx, gate_w, cfg)
        E, C = cfg.n_experts, moe._capacity(C7_TOKENS, cfg)
        xe = moe._take_rows(x_cpu.to(dev), tok).reshape(E, C, -1)
        ye = moe._swiglu(xe, p["w_gate"], p["w_up"], p["w_down"])
        contrib = ye.reshape(E * C, -1) * w[:, None].to(ye.dtype)
    sides = {}
    for name, d in (("card", dev), ("cpu", torch.device("cpu"))):
        c = contrib.detach().to(d).clone().requires_grad_(True)
        yc = moe._Combine.apply(c, slot_map.to(d), tok.to(d))
        (yc.float() * torch.linspace(-1, 1, yc.shape[1], device=d)).sum().backward()
        sides[name] = (yc.detach().cpu(), c.grad.cpu())
    combine_bits = all(torch.equal(a, b) for a, b in zip(sides["card"], sides["cpu"]))
    old = {bytes(torch.zeros((C7_TOKENS + 1, contrib.shape[1]), dtype=contrib.dtype, device=dev)
                 .index_add(0, tok, contrib)[:C7_TOKENS].cpu().view(torch.int16).numpy())
           for _ in range(C7_RUNS)}
    y_cpu, _ = moe.moe_apply(p_cpu, cfg, x_cpu)
    idx_cpu = moe._route(p_cpu, cfg, x_cpu)[2]
    rec = dict(tokens=C7_TOKENS, runs=C7_RUNS, repeat_bits=repeat, combine_bits=combine_bits,
               combine_vs_cpu_max_abs=float((sides["card"][0].float() - sides["cpu"][0].float())
                                            .abs().max()),
               index_add_distinct=len(old), layer_vs_cpu_rel=_rel(outs[0].cpu(), y_cpu.detach()),
               routing_equal=bool(torch.equal(idx.cpu(), idx_cpu)),
               deterministic_mode=torch.are_deterministic_algorithms_enabled())
    if not (repeat and combine_bits):
        raise SystemExit(f"phase 14 (e): C7: {rec}")
    return rec


def _lm_placed(arch_id: str, mesh, dev) -> dict:
    """(f) ``arch_id``'s four cells with ``weights="placed"`` at world 1 on
    the card (see ``LM_PLACED_LAYERS``) against the whole-weight cells on
    the same inputs: two train steps (loss, grad norm, every parameter),
    a prefill (last logits, cache), decode steps of both layouts."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.models import transformer as tf
    from repro_torch.train.optimizer import make_optimizer
    from repro_torch.tree import tree_leaves

    arch = get_arch(arch_id)
    dt = torch.float32 if arch.cfg.moe is not None else arch.cfg.dtype
    cut = dataclasses.replace(arch, cfg=dataclasses.replace(arch.cfg, n_layers=LM_PLACED_LAYERS,
                                                            dtype=dt), microbatches=1)
    cfg = cut.cfg
    params = tf.init_params(torch.Generator(device=dev).manual_seed(3), cfg, device=dev)
    tg = torch.Generator(device=dev).manual_seed(4)
    toks = torch.randint(0, cfg.vocab, (2, LM_PLACED_TOKENS + 1), generator=tg, device=dev)
    rec = dict(arch=arch_id, layers=LM_PLACED_LAYERS, dtype=str(dt).removeprefix("torch."))
    t0 = time.perf_counter()
    # train_4k: two steps of each
    batch = {"tokens": toks[:1, :-1], "labels": toks[:1, 1:]}
    states, mets = {}, {}
    for w in ("whole", "placed"):
        cell = cut.build_cell("train_4k", mesh, weights=w, global_batch=1)
        st = (cut.place("train_4k", mesh, params) if w == "placed" else
              {"params": params, "opt": make_optimizer(cut.optimizer)[0](params)})
        for _ in range(2):
            st, m = cell.fn(st, batch)
        states[w], mets[w] = st, {k: float(v) for k, v in m.items()}
        del st
    rec["train"] = {k: [mets["placed"][k], mets["whole"][k]] for k in ("loss", "grad_norm")}
    rec["train_rel"] = max(abs(a - b) / abs(b) for a, b in rec["train"].values())
    lr = mets["whole"]["lr"]
    # the first moment (0.09 g1 + 0.1 g2) of each leaf's scale, or 1e-2 of the tree's
    ms = list(zip(tree_leaves(states["placed"]["opt"]["m"]),
                  tree_leaves(states["whole"]["opt"]["m"])))
    top = max(float(b.abs().max()) for _, b in ms)
    rec["m_err"] = max(float((a - b).abs().max()) / max(float(b.abs().max()), 1e-2 * top)
                       for a, b in ms)
    # beyond a rounding of the stored dtype (bf16: one ulp, 2**-7 relative)
    rec["params_max_abs_in_lr"] = max(
        float(((a.float() - b.float()).abs() - torch.finfo(b.dtype).eps * b.float().abs())
              .clamp_min(0).max()) / lr
        for a, b in zip(tree_leaves(states["placed"]["params"]),
                        tree_leaves(states["whole"]["params"])))
    del states
    torch.cuda.empty_cache()
    # prefill_32k at LM_PLACED_TOKENS
    got = {}
    for w in ("whole", "placed"):
        cell = cut.build_cell("prefill_32k", mesh, weights=w, global_batch=1)
        pp = cut.place("prefill_32k", mesh, params) if w == "placed" else params
        got[w] = cell.fn(pp, toks[:1, :LM_PLACED_TOKENS])
    rec["prefill_rel"] = max(_rel(got["placed"][0], got["whole"][0]),
                             _rel(got["placed"][1]["k"], got["whole"][1]["k"]))
    del got
    # decode: both layouts, from an empty cache
    rec["decode_rel"] = {}
    for shape in ("decode_32k", "long_500k"):
        outs = {}
        for w in ("whole", "placed"):
            cell = cut.build_cell(shape, mesh, weights=w, global_batch=2)
            pp = cut.place(shape, mesh, params) if w == "placed" else params
            cache = tf.init_kv_cache(cfg, 2, LM_PLACED_SLOTS, device=dev)
            lens = torch.zeros(2, dtype=torch.int32, device=dev)
            outs[w] = []
            for j in range(LM_PLACED_STEPS):
                lg, cache = cell.fn(pp, cache, toks[:, j:j + 1], lens)
                outs[w].append(lg)
                lens = lens + 1
        rec["decode_rel"][shape] = max(_rel(a, b) for a, b in zip(outs["placed"], outs["whole"]))
    rec["s"] = time.perf_counter() - t0
    worst = max(rec["train_rel"], rec["m_err"], rec["prefill_rel"], *rec["decode_rel"].values())
    if not (worst <= LM_PLACED_RTOL and rec["params_max_abs_in_lr"] <= LM_PLACED_LR):
        raise SystemExit(f"phase 14 (f): {arch_id} placed vs whole at world 1: {rec}")
    del params
    torch.cuda.empty_cache()
    return rec


@contextlib.contextmanager
def _routing_log():
    """Record every MoE routing (``moe._route``'s expert sets, sorted, on
    the host) made inside the block, in call order."""
    from repro_torch.models import moe

    route, log_ = moe._route, []

    def logged(params, cfg, x):
        out = route(params, cfg, x)
        log_.append(out[2].sort(dim=-1).values.cpu())
        return out

    moe._route = logged
    try:
        yield log_
    finally:
        moe._route = route


def _first_flips(want: list, got: list, B: int) -> list:
    """Per sequence, the first position whose expert sets differ at any
    layer between two routings (``[L]`` lists of ``[B, S, K]``; S when
    none differs). A flip changes that token's output wholesale and,
    through attention, every later position of its sequence."""
    S = want[0].shape[1]
    diff = torch.zeros((B, S), dtype=torch.bool)
    for w, g in zip(want, got):
        diff |= (w != g).any(dim=-1)
    return [int(torch.nonzero(diff[b])[0]) if diff[b].any() else S for b in range(B)]


def _clean_rel(got, want, clean) -> tuple[float, int]:
    """Relative L2 error over the positions ``clean`` marks (``[B]``
    bools) and how many were left out."""
    keep = torch.tensor(clean, dtype=torch.bool)
    if not keep.any():
        return float("nan"), len(clean)
    idx = torch.nonzero(keep)[:, 0].to(got.device)
    return _rel(got[idx], want[idx]), int((~keep).sum())


def _lm_checks(arch, params, mesh, dev, rtol: float, seed: int, batch: int) -> dict:
    """The model's paths against ``forward`` at full width, in ``params``'
    dtype: (a) ``prefill_32k`` over 32,768 tokens, its cache's first
    ``LM_PROMPT`` positions against a forward over them; (b) a prompt
    prefilled into a full 32,768-slot ``decode_32k`` cache at ``batch``, the
    prompt's last logits and ``LM_CHECK_STEPS`` decode steps against a
    forward over the whole sequence. MoE: the reference forward (and the
    prompt's prefill) run at capacity_factor = E / top_k, where no token
    drops (a 32,768-token prefill keeps its first tokens at the config's
    capacity, a decode step of 8 tokens drops none); the routing of both
    sides is recorded, and a position at or past a token whose expert set
    differs is left out and counted (see ``LM_F32_RTOL``)."""
    import dataclasses

    from repro_torch.models import transformer as tf

    cfg = arch.cfg
    moe_cfg = cfg.moe
    if moe_cfg is not None:
        nodrop = dataclasses.replace(moe_cfg, capacity_factor=moe_cfg.n_experts / moe_cfg.top_k)
        ref_arch = dataclasses.replace(arch, cfg=dataclasses.replace(cfg, moe=nodrop))
    else:
        ref_arch = arch
    L, P, n, B = cfg.n_layers, LM_PROMPT, LM_PROMPT + LM_CHECK_STEPS, batch
    tg = torch.Generator(device=dev).manual_seed(seed)
    out = {}
    # (a)
    cell = arch.build_cell("prefill_32k", mesh, global_batch=LM_PREFILL_BATCH)
    S = cell.input_structs[1].shape[1]
    toks = torch.randint(0, cfg.vocab, (LM_PREFILL_BATCH, S), generator=tg, device=dev)
    with _routing_log() as got_r:
        _, cache = cell.fn(params, toks)
    k_first = cache["k"][:, :, :P].clone()
    del cache
    torch.cuda.empty_cache()
    with _routing_log() as want_r, torch.no_grad():
        _, aux = tf.forward(params, ref_arch.cfg, toks[:, :P], collect_kv=True)
    want_k = aux["kv_cache"]["k"]
    first = [P] * LM_PREFILL_BATCH
    if moe_cfg is not None:
        first = _first_flips([w.reshape(LM_PREFILL_BATCH, P, -1) for w in want_r],
                             [g.reshape(LM_PREFILL_BATCH, S, -1)[:, :P] for g in got_r],
                             LM_PREFILL_BATCH)
    m = min(first)
    out["prefill_cache_rel"] = _rel(k_first[:, :, :m], want_k[:, :, :m]) if m else float("nan")
    out["prefill_positions_left_out"] = (P - m) * LM_PREFILL_BATCH
    del k_first, aux, want_k
    # (b)
    cache = tf.init_kv_cache(cfg, B, S, dtype=params["embed"].dtype, device=dev)
    ptoks = torch.randint(0, cfg.vocab, (B, n), generator=tg, device=dev)
    step = arch.build_cell("decode_32k", mesh, global_batch=B).fn
    with _routing_log() as got_r:
        last, pc = ref_arch.build_cell("prefill_32k", mesh, global_batch=B).fn(
            params, ptoks[:, :P])
        for k in ("k", "v"):
            cache[k][:, :, :P] = pc[k]
        del pc
        lens = torch.full((B,), P, dtype=torch.int32, device=dev)
        logits = [last]
        for j in range(LM_CHECK_STEPS):
            lg, cache = step(params, cache, ptoks[:, P + j:P + j + 1], lens)
            logits.append(lg)
            lens = lens + 1
    del cache
    torch.cuda.empty_cache()
    with _routing_log() as want_r, torch.no_grad():
        want, _ = tf.forward(params, ref_arch.cfg, ptoks)
    first = [n] * B
    if moe_cfg is not None:
        path = [torch.cat([got_r[l].reshape(B, P, -1)] + [got_r[L * (1 + j) + l][:, None]
                                                          for j in range(LM_CHECK_STEPS)], 1)
                for l in range(L)]
        first = _first_flips([w.reshape(B, n, -1) for w in want_r], path, B)
    errs, left_out = [], 0
    for j, lg in enumerate(logits):  # the prompt's last position, then each step's
        pos = P - 1 + j
        e, lo = _clean_rel(lg, want[:, pos], [pos < f for f in first])
        errs.append(e)
        left_out += lo
    out.update(prefill_then_decode_rel=errs, positions_left_out=left_out, batch=B,
               positions=B * (LM_CHECK_STEPS + 1), rtol=rtol,
               dtype=str(params["embed"].dtype).removeprefix("torch."))
    worst = max((e for e in errs if e == e), default=float("nan"))
    out["worst_rel"] = worst
    bad = not (worst <= rtol and out["prefill_cache_rel"] <= rtol)
    if bad or 2 * (left_out + out["prefill_positions_left_out"]) > out["positions"]:
        raise SystemExit(f"phase 14 (a)/(b): {arch.name} in {out['dtype']} vs forward: prefill "
                         f"cache {out['prefill_cache_rel']:.3e}, prefill → decode "
                         f"{[f'{e:.3e}' for e in errs]} (rtol {rtol}); positions past a "
                         f"routing flip left out: {left_out} of {out['positions']}")
    return out


def _lm_model(arch_id: str, mesh, dev, card: str) -> dict:
    """One config at full width: (a) ``prefill_32k`` and (b)
    ``decode_32k`` timed in bf16, then their checks against ``forward``
    (``_lm_checks``): in bf16 for a dense model; for an MoE model in f32
    (TF32 off), because with random weights a token's 8th and 9th router
    logits lie ~0.1 apart and two bf16 paths differ by ~1e-2 in a logit,
    so most tokens of a bf16 comparison would change experts on a
    rounding (measured on the CPU at olmoe's width: 2 f32 paths differ by
    1.3e-6, no flip in 3,072 token-layers)."""
    from repro_torch.configs import get_arch
    from repro_torch.models import transformer as tf
    from repro_torch.tree import tree_leaves, tree_map

    gib = 2**30
    arch = get_arch(arch_id)
    cfg = arch.cfg
    rec = dict(arch=arch_id)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = tf.init_params(torch.Generator(device=dev).manual_seed(0), cfg, device=dev)
    torch.cuda.synchronize()
    rec.update(init_s=time.perf_counter() - t0, param_bytes=_tree_bytes(params),
               n_params=sum(t.numel() for t in tree_leaves(params)))
    tg = torch.Generator(device=dev).manual_seed(1)

    # (a) prefill_32k at batch 1 over the full 32,768 tokens
    cell = arch.build_cell("prefill_32k", mesh, global_batch=LM_PREFILL_BATCH)
    S = cell.input_structs[1].shape[1]
    toks = torch.randint(0, cfg.vocab, (LM_PREFILL_BATCH, S), generator=tg, device=dev)
    cell.fn(params, toks[:, :LM_WARM_TOKENS])  # warm-up: cuBLAS handles, allocator
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    last, cache = cell.fn(params, toks)
    torch.cuda.synchronize()
    pre_s = time.perf_counter() - t0
    rec["prefill"] = dict(
        tokens=S, batch=LM_PREFILL_BATCH, s=pre_s, tokens_per_s=LM_PREFILL_BATCH * S / pre_s,
        bound_s=arch.model_flops("prefill_32k", LM_PREFILL_BATCH) / BF16_FLOP_PER_S,
        max_memory_allocated=torch.cuda.max_memory_allocated(),
        dry_run_bytes=cell.meta["argument_bytes"] + cell.meta["output_bytes"],
        finite=bool(torch.isfinite(last).all() and torch.isfinite(cache["k"]).all()))
    if not (rec["prefill"]["finite"] and tuple(last.shape) == (LM_PREFILL_BATCH, cfg.vocab)
            and tuple(cache["k"].shape) == (cfg.n_layers, LM_PREFILL_BATCH, S, cfg.n_kv_heads,
                                            cfg.head_dim)):
        raise SystemExit(f"phase 14 (a): {arch_id} prefill gave {tuple(last.shape)} / "
                         f"{tuple(cache['k'].shape)}, finite {rec['prefill']['finite']}")
    del last, cache
    torch.cuda.empty_cache()

    # (b) decode_32k at batch 8 over a full 32,768-slot cache: a prompt
    # prefilled into it, then a warm-up step and LM_TIMED_STEPS timed ones
    dec = arch.build_cell("decode_32k", mesh, global_batch=LM_DECODE_BATCH)
    B, S = LM_DECODE_BATCH, dec.input_structs[1]["k"].shape[2]
    torch.cuda.reset_peak_memory_stats()
    cache = tf.init_kv_cache(cfg, B, S, device=dev)
    ptoks = torch.randint(0, cfg.vocab, (B, LM_PROMPT + LM_TIMED_STEPS + 1), generator=tg,
                          device=dev)
    _, pc = arch.build_cell("prefill_32k", mesh, global_batch=B).fn(params, ptoks[:, :LM_PROMPT])
    for k in ("k", "v"):
        cache[k][:, :, :LM_PROMPT] = pc[k]
    del pc
    lens = torch.full((B,), LM_PROMPT, dtype=torch.int32, device=dev)
    times = []
    for j in range(LM_TIMED_STEPS + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lg, cache = dec.fn(params, cache, ptoks[:, LM_PROMPT + j:LM_PROMPT + j + 1], lens)
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
        lens = lens + 1
    prof = {}
    tok = ptoks[:, -1:]
    device_breakdown(f"{arch_id} decode_32k step (batch {B})",
                     lambda: dec.fn(params, cache, tok, lens), card, reps=2, out=prof)
    cache_bytes = _tree_bytes(cache)
    rec["decode"] = dict(
        batch=B, slots=S, step_ms=times[1:], step_ms_median=statistics.median(times[1:]),
        cache_bytes=cache_bytes,
        bound_ms=1e3 * (rec["param_bytes"] + cache_bytes) / HBM_BYTES_PER_S,
        max_memory_allocated=torch.cuda.max_memory_allocated(),
        dry_run_bytes=dec.meta["argument_bytes"] + dec.meta["output_bytes"],
        finite=bool(torch.isfinite(lg).all()), profile=dict(
            wall_ms=prof.get("wall_ms"), busy_ms=prof.get("busy_ms"), top=sorted(
                ((k, v[0]) for k, v in prof.get("kernels", {}).items()), key=lambda kv: -kv[1])
            [:6]))
    if not rec["decode"]["finite"]:
        raise SystemExit(f"phase 14 (b): {arch_id} decode logits are not finite")
    del cache, lg
    torch.cuda.empty_cache()
    if cfg.moe is not None:
        rec["moe"] = _lm_moe_check(params, cfg, dev)
    if arch_id == "qwen3-8b":
        rec["attention"] = _lm_attention_checks(cfg, mesh, dev)
    if cfg.moe is not None:  # the checks in f32 (see the docstring)
        params = tree_map(lambda t: t.float(), params)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        rec["check"] = _lm_checks(arch, params, mesh, dev, LM_F32_RTOL, seed=4,
                                  batch=LM_F32_CHECK_BATCH)
    else:
        rec["check"] = _lm_checks(arch, params, mesh, dev, LM_BF16_RTOL, seed=4,
                                  batch=LM_DECODE_BATCH)
    rec["check"]["max_memory_allocated"] = torch.cuda.max_memory_allocated()
    del params
    torch.cuda.empty_cache()
    rec["peak_gib"] = max(rec["prefill"]["max_memory_allocated"],
                          rec["decode"]["max_memory_allocated"]) / gib
    return rec


def _log_lm_model(a: str, r: dict, card: str) -> None:
    """One config's phase-14 lines (printed by the rank as it finishes)."""
    gib = 2**30
    p, dcd, c = r["prefill"], r["decode"], r["check"]
    log(f"[14] {a}: {r['n_params']:,} params ({r['param_bytes'] / 1e9:.2f} GB bf16, drawn on "
        f"the card in {r['init_s']:.1f}s)")
    log(f"    (a) {a} prefill_32k, batch {p['batch']} (cut from 32: one card) × "
        f"{p['tokens']:,} tokens, chunked attention (2,048), bf16: {1e3 * p['s']:.1f} ms, "
        f"{p['tokens_per_s']:,.0f} tokens/s, bound {1e3 * p['bound_s']:.1f} ms "
        f"(model_flops over {BF16_FLOP_PER_S / 1e12:.0f} TFLOP/s bf16); max_memory_allocated "
        f"{p['max_memory_allocated'] / gib:.2f} GiB, dry run (1, 1) at this batch "
        f"{p['dry_run_bytes'] / gib:.2f} GiB ({card})")
    log(f"    (b) {a} decode_32k, batch {dcd['batch']} (cut from 128) over "
        f"{dcd['slots']:,} slots ({dcd['cache_bytes'] / 1e9:.2f} GB cache), bf16: a step "
        f"{dcd['step_ms_median']:.2f} ms (median of {LM_TIMED_STEPS}, host clock + "
        f"synchronise; {[round(t, 2) for t in dcd['step_ms']]}), bound "
        f"{dcd['bound_ms']:.2f} ms (weights + cache over {HBM_BYTES_PER_S / 1e12:.2f} TB/s); "
        f"max_memory_allocated {dcd['max_memory_allocated'] / gib:.2f} GiB, dry run (1, 1) "
        f"at this batch {dcd['dry_run_bytes'] / gib:.2f} GiB ({card})")
    log(f"    (a)/(b) {a} against forward in {c['dtype']}: prefill_32k's cache at its first "
        f"{LM_PROMPT} positions {c['prefill_cache_rel']:.2e}; a {LM_PROMPT}-token prompt "
        f"prefilled into a {dcd['slots']:,}-slot cache at batch {c['batch']}, then "
        f"{LM_CHECK_STEPS} decode steps: relative L2 at most {c['worst_rel']:.2e} (rtol "
        f"{c['rtol']}); positions past a routing flip left out: {c['positions_left_out']} "
        f"of {c['positions']} (+{c['prefill_positions_left_out']} in the prefill's); "
        f"max_memory_allocated {c['max_memory_allocated'] / gib:.2f} GiB ({card})")
    if "moe" in r:
        m = r["moe"]
        log(f"    (d) {a} MoE layer 0 on {m['tokens']} tokens (bf16): capacity "
            f"{m['capacity']}, {m['kept']} of {m['pairs']} pairs kept ({m['dropped']} "
            f"dropped, busiest expert {m['max_load']}), each expert its first "
            f"{m['capacity']} in token order, no token twice; {m['ms']:.3f} ms ({card})")
    if "attention" in r:
        at = r["attention"]
        log(f"    (c) {a} flash decoding's local path over {LM_LONG_KEYS:,} keys "
            f"({at['cache_bytes'] / 1e9:.2f} GB, valid {LM_LONG_VALID:,}) vs the masked "
            f"reference: relative L2 {at['flash_vs_ref_rel']:.2e} (rtol {LM_ATTN_RTOL}); "
            f"{at['flash_ms']:.3f} ms vs {at['ref_ms']:.3f} ms (CUDA events, median of 10); "
            f"(d) chunked vs full attention at {LM_CHUNK_TOKENS} tokens: "
            f"{at['chunked_vs_full_rel']:.2e} ({card})")


def lm_rank(rank: int, world: int, d: str) -> None:
    """Phase 14's NCCL rank (world 1, mesh ``(1, 1)``): the LM family (see
    the module docstring); its record goes to ``<d>/out.json``."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_debug_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    dev = torch.device("cuda")
    mesh = make_debug_mesh((1, 1), ("data", "model"))
    card = card_line()
    out = dict(backend=dist.get_backend())
    t0 = time.perf_counter()
    out["smoke"] = _lm_smoke_parity()
    out["train_cli"] = _lm_train_cli()
    out["small_s"] = time.perf_counter() - t0
    _log_lm_small(out, card)
    out["models"] = {}
    for a in LM_SERVED:
        out["models"][a] = _lm_model(a, mesh, dev, card)
        _log_lm_model(a, out["models"][a], card)
    t0 = time.perf_counter()
    out["c7"] = _lm_c7(dev)
    _log_c7(out["c7"], card)
    out["placed"] = {}
    for a in LM_SERVED:
        out["placed"][a] = _lm_placed(a, mesh, dev)
        _log_lm_placed(out["placed"][a], card)
    out["placed_s"] = time.perf_counter() - t0
    out["lm_seconds"] = time.perf_counter() - t_start
    # phase 15 in the same rank, once the LM's memory is freed
    gc.collect()
    torch.cuda.empty_cache()
    out["families"] = family_phase(mesh, dev, card)
    out["seconds"] = time.perf_counter() - t_start
    (pathlib.Path(d) / "out.json").write_text(json.dumps(out))


def lm_phase_start():
    """Start phase 14's rank in the background → (pool, future). It needs
    nothing of the phases before it, so it runs beside phase 3's host
    build, which leaves the card idle."""
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.launch.mesh import spawn_ranks

    shutil.rmtree(LM_DIR, ignore_errors=True)
    LM_DIR.mkdir(parents=True)
    gc.collect()
    torch.cuda.empty_cache()
    pool = ThreadPoolExecutor(1)
    return pool, pool.submit(spawn_ranks, lm_rank, 1, str(LM_DIR), backend="nccl",
                             init_file=LM_DIR / "init", timeout_s=LM_DEADLINE_S)


def lm_phase_finish(job, card: str) -> dict:
    """Wait for phase 14's rank, log its records beside the card → them."""
    pool, fut = job
    t0 = time.perf_counter()
    try:
        spawn_s = fut.result()
    finally:
        pool.shutdown(wait=True)
    out = json.loads((LM_DIR / "out.json").read_text())
    out.update(spawn_s=spawn_s, waited_s=time.perf_counter() - t0)
    log(f"[14] the LM family ({card}): one {out['backend']} rank, mesh (1, 1), beside phase 3's "
        f"host build: {out['lm_seconds']:.1f}s in the rank, {len(out['models'])} configs at "
        f"full width, every check held; no kernel of the port is on this path (the reference "
        f"computes it with plain jnp, no Pallas)")
    log(f"[15] the GNN and RecSys families ({card}): {out['families']['seconds']:.1f}s in the "
        f"same rank after phase 14 ({out['seconds']:.1f}s in all, {spawn_s:.1f}s with its "
        f"start; the parent waited {out['waited_s']:.1f}s); gat-cora's 4 cells and 4 RecSys "
        f"configs × 4 cells at full width, every check held; no kernel of the port is on this "
        f"path (the reference builds both families from jnp gathers, segment sums and dense "
        f"products, no Pallas)")
    out["dry_run"] = _dry_run_ratios(out, card)
    shutil.rmtree(LM_DIR, ignore_errors=True)
    return out


def _log_c7(r: dict, card: str) -> None:
    log(f"[14] (e) C7: one olmoe-1b-7b MoE layer in bf16 at full width on {r['tokens']} tokens, "
        f"{r['runs']} runs on the card (deterministic algorithms "
        f"{'on' if r['deterministic_mode'] else 'off'}): output and input gradient the same "
        f"bits every run: {r['repeat_bits']}; the slot-order combine on the card == the CPU's "
        f"bits (forward and backward, the card's expert outputs): {r['combine_bits']}; the old "
        f"index_add combine gave {r['index_add_distinct']} distinct results in {r['runs']} runs; "
        f"the whole layer vs the CPU (their bf16 GEMMs differ): relative L2 "
        f"{r['layer_vs_cpu_rel']:.2e}, routing equal {r['routing_equal']} ({card})")


def _log_lm_placed(r: dict, card: str) -> None:
    log(f"[14] (f) {r['arch']} placed cells at world 1 (NCCL, every collective on a group of "
        f"one; full width, {r['layers']} layers, {r['dtype']}) vs whole weights: train_4k 2 "
        f"steps loss/grad_norm {r['train']} (rel {r['train_rel']:.1e}), first moment "
        f"{r['m_err']:.1e} of scale, parameters within {r['params_max_abs_in_lr']:.2f} lr beyond "
        f"a rounding; prefill of {LM_PLACED_TOKENS} tokens rel "
        f"{r['prefill_rel']:.1e}; decode "
        + ", ".join(f"{k} rel {v:.1e}" for k, v in r["decode_rel"].items())
        + f" (rtol {LM_PLACED_RTOL}); {r['s']:.1f}s ({card})")


def _log_lm_small(out: dict, card: str) -> None:
    log(f"[14] (d) smoke() card == CPU ({card}): " + ", ".join(
        f"{a} loss {r['loss0'][0]:.6f}/{r['loss1'][0]:.6f} (cpu {r['loss0'][1]:.6f}/"
        f"{r['loss1'][1]:.6f}), logits max err {r['logits_max_abs_err']:.1e}"
        for a, r in out["smoke"].items()) + f" (rtol {LM_SMOKE_RTOL}, atol {LM_SMOKE_ATOL})")
    log(f"    (d) launch.train --smoke on the card: {out['train_cli']}")


# ---------------------------------------------------------------------------
# phase 15: the GNN and RecSys families
# ---------------------------------------------------------------------------

#: timed repetitions a cell (after a warm-up)
FAM_REPS = 5
#: minibatch_lg's host graph: Reddit's nodes at its mean in-degree
#: (114,615,892 / 232,965 ≈ 492), built sorted by destination
REDDIT_NODES, REDDIT_EDGES = 232_965, 114_615_892
#: SASRec's train_batch on one card: its gathered negatives are 1.28 MB a
#: row ([50, 128, 50] f32), 83.9 GB at 65,536 rows and as much again for
#: their gradient
SASREC_TRAIN_BATCH = 8_192
#: DIN's retrieval_cand on one card: at 1,000,448 candidates the attention
#: tower's input [N, 100, 72] f32 (28.8 GB) and its first layer's product
#: and bias sum (32.0 GB each) pass 80 GB together
DIN_CANDIDATES = 250_112
#: the rows whose outputs and gradients are checked against the CPU
FAM_CHECK_ROWS = 512
#: card against the CPU, and one path against another on the card (f32,
#: TF32 off; sums in other orders, atomics on the card): losses and
#: outputs within FAM_RTOL (atol FAM_ATOL); gradients within FAM_REL of
#: the leaf's largest entry or FAM_FLOOR × the tree's largest, where that
#: is larger (DIN's attention tower's gradients are 1e-6–1e-11 beside
#: 0.1, and its last bias's is 0 up to rounding)
FAM_RTOL, FAM_ATOL = 1e-4, 1e-5
FAM_REL, FAM_FLOOR = 1e-4, 1e-2
#: ogb_products' output layer's a_dst gradient (two paths, or sharded
#: against unsharded) is held within FAM_REL of the tree's largest entry;
#: every other leaf keeps FAM_FLOOR. That gradient cancels (a constant
#: a_dst·h_dst over a node's incoming edges leaves the node's softmax
#: unchanged; only the leaky ReLU's kink breaks that), so what is left is
#: the rounding of 61.9M-edge sums whose atomics add in another order each
#: run: 3.0e-10 and 6.2e-10 apart against a largest entry ~1.5e-4 of the
#: tree (2.9e-4 of the 1e-2 floor's scale; 3.5e-7 of it in another run)
OGB_FLOOR = 1.0
#: minibatch_lg's step on the card is also run with the SpMM in chunks of
#: this many edges (42 chunks of its 168,960, the last partial) and held
#: against the CPU's single chunk
CARD_MESSAGE_CHUNK = 4_096
FAM_TRAIN_STEPS = 20


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _timed(fn, dev, reps: int = FAM_REPS) -> tuple:
    """A warm-up call, then ``reps`` timed ones (host clock around a
    synchronise) → (the last result, ms a call, max_memory_allocated)."""
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    out = fn()
    times = []
    for _ in range(reps):
        del out
        _sync(dev)
        t0 = time.perf_counter()
        out = fn()
        _sync(dev)
        times.append(1e3 * (time.perf_counter() - t0))
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    return out, times, peak


def _output_a_dst(cfg) -> str:
    """The path of GAT's output layer's ``a_dst``, whose gradient cancels
    (see OGB_FLOOR)."""
    return f"['layers'][{cfg.n_layers - 1}]['a_dst']"


def _trees_close(what: str, got, want, floors: dict | None = None) -> float:
    """Every leaf of ``got`` (any device) within FAM_REL of the larger of
    its own largest entry and a floor × the tree's largest in ``want``:
    ``floors[path]`` where given, else FAM_FLOOR → the largest error over
    that scale; exits otherwise."""
    from repro_torch.tree import tree_leaves_with_path

    g, w = dict(tree_leaves_with_path(got)), dict(tree_leaves_with_path(want))
    if sorted(g) != sorted(w):
        raise SystemExit(f"phase 15: {what}: leaves {sorted(g)} vs {sorted(w)}")
    top = max(float(v.detach().abs().max()) for v in w.values())
    worst = 0.0
    for k, v in w.items():
        floor = (floors or {}).get(k, FAM_FLOOR)
        scale = max(float(v.detach().abs().max()), floor * top, 1e-30)
        err = float((g[k].detach().to(v.device).float() - v.float()).abs().max())
        if not err <= FAM_REL * scale:
            raise SystemExit(f"phase 15: {what}: {k} differs by {err:.3e} (scale {scale:.3e}, "
                             f"rel {FAM_REL}, floor {floor})")
        worst = max(worst, err / scale)
    return worst


def _close(what: str, got, want) -> float:
    got, want = got.detach().float().cpu(), want.detach().float().cpu()
    if tuple(got.shape) != tuple(want.shape) or not bool(torch.isfinite(got).all()):
        raise SystemExit(f"phase 15: {what}: shape {tuple(got.shape)} vs {tuple(want.shape)}, "
                         f"finite {bool(torch.isfinite(got).all())}")
    err = (got - want).abs()
    if not bool((err <= FAM_ATOL + FAM_RTOL * want.abs()).all()):
        raise SystemExit(f"phase 15: {what}: max abs err {float(err.max()):.3e} (rtol "
                         f"{FAM_RTOL}, atol {FAM_ATOL})")
    return float(err.max())


def _bound_ms(cell) -> tuple[float, str]:
    """A train cell's bound: the larger of model_flops over the f32 peak
    (TF32 off) and the bytes the cell reads and writes (every input once,
    every output once: the dry run's per-device bytes on this one-device
    mesh, the whole state in and out) over HBM."""
    return _larger(cell.model_flops, cell.meta["argument_bytes"] + cell.meta["output_bytes"])


def _larger(ops: float, n_bytes: float) -> tuple[float, str]:
    t_ops, t_mem = ops / F32_FLOP_PER_S, n_bytes / HBM_BYTES_PER_S
    return 1e3 * max(t_ops, t_mem), "operations" if t_ops >= t_mem else "bytes"


#: the RecSys tables (leaf paths) that a serving cell reads by row
REC_TABLES = {"deepfm": ("['embed']", "['linear']"), "dcn-v2": ("['embed']",),
              "sasrec": ("['item_embed']",), "din": ("['item_embed']",)}


def _rec_serve_bound_ms(arch, shape: str, n: int, params, ids, inputs, out) -> tuple:
    """A serving cell's bound (``serve_*`` at ``n`` rows, ``retrieval_cand``
    at ``n`` candidates): the larger of its operations over the f32 peak
    and its bytes over HBM. Bytes: each table row that ``ids`` (this run's
    ids, global in the CTR models' combined table) touch, once; every
    other parameter whole; ``inputs`` and ``out`` once. Operations:
    ``model_flops``, except SASRec's (it charges the training's candidate
    logits, and at ``retrieval_cand`` an encode a candidate): an encode
    of each sequence, ``n`` to serve and one at ``retrieval_cand``
    (12·S·D² + 4·S²·D a block: the QKV, output and two feed-forward
    products, scores and weighted sum), plus one D-wide dot a candidate
    → (ms, "bytes" or "operations")."""
    from repro_torch.tree import tree_leaves_with_path

    cfg = arch.cfg
    rows = int(torch.unique(ids).numel())
    leaves = dict(tree_leaves_with_path(params))
    tables = REC_TABLES[cfg.name]
    n_bytes = sum(rows * t[0].numel() * t.element_size() if k in tables
                  else t.numel() * t.element_size() for k, t in leaves.items())
    n_bytes += sum(t.numel() * t.element_size() for t in (*inputs, out))
    if cfg.name == "sasrec":
        D, S = cfg.embed_dim, cfg.seq_len
        enc = cfg.n_blocks * (12 * S * D * D + 4 * S * S * D)
        ops = enc + 2 * n * D if shape == "retrieval_cand" else enc * n
    else:
        ops = arch.model_flops(shape, n)
    return _larger(ops, n_bytes)


def _to(tree, dev):
    from repro_torch.tree import tree_map

    return tree_map(lambda t: t.to(dev), tree)


def _gnn_graph(shape: str, rng, n_nodes: int, n_edges: int) -> dict:
    """A graph of ``shape`` drawn from ``rng`` at the shape's true sizes and
    padded to ``n_nodes`` / ``n_edges`` (numpy; ``gnn.pad_graph``'s rows
    plus ``edge_index``, the unpadded edges, and ``graph_*`` for
    molecule)."""
    from repro_torch.configs.base import GNN_SHAPES
    from repro_torch.models import gnn

    sh = GNN_SHAPES[shape]
    F, C = sh["d_feat"], sh["n_classes"]
    x = np.zeros((n_nodes, F), np.float32)
    labels = rng.integers(0, C, size=n_nodes)
    mask = np.zeros(n_nodes, bool)
    info = {}
    if shape == "full_graph_sm":  # Cora: binary bag of words, ~18 words a paper
        n, E = sh["true_nodes"], sh["true_edges"]
        x[:n] = rng.random((n, F), dtype=np.float32) < 18 / F
        ei = rng.integers(0, n, size=(2, E))
        mask[:140] = True  # the Planetoid split: 20 a class
    elif shape == "molecule":
        G, per, pe = sh["graphs"], 30, 64
        n = G * per
        x[:n] = rng.normal(size=(n, F))
        off = np.repeat(np.arange(G) * per, pe)
        ei = rng.integers(0, per, size=(2, G * pe)) + off
        gid = np.full(n_nodes + 1, -1, np.int32)
        gid[:n] = np.repeat(np.arange(G), per)
        info = {"graph_ids": gid, "graph_labels": rng.integers(0, C, size=G).astype(np.int32)}
    elif shape == "minibatch_lg":
        deg = rng.poisson(REDDIT_EDGES / REDDIT_NODES, size=REDDIT_NODES)
        dst = np.repeat(np.arange(REDDIT_NODES), deg)
        src = rng.integers(0, REDDIT_NODES, size=dst.shape[0])
        t0 = time.perf_counter()
        smp = gnn.NeighborSampler(np.stack([src, dst]), REDDIT_NODES, seed=0)
        del src, dst
        seeds = rng.choice(REDDIT_NODES, size=sh["batch_nodes"], replace=False)
        node_ids, es, ed = smp.sample_padded(seeds, sh["fanout"], n_nodes, n_edges)
        info = {"host_graph_edges": int(deg.sum()), "sampled_nodes": int((node_ids >= 0).sum()),
                "sampled_edges": int((es < n_nodes).sum()),
                "sampler_s": time.perf_counter() - t0}
        del smp
        x[:] = rng.normal(size=(n_nodes, F))
        mask[: sh["batch_nodes"]] = True  # the seeds' loss (GraphSAGE minibatch)
        ei = np.stack([es, ed])
    else:  # ogb_products at its budgets
        n = n_nodes
        x[:] = rng.normal(size=(n, F))
        ei = rng.integers(0, n, size=(2, n_edges))
        mask[:] = rng.random(n) < 0.08  # ogbn-products trains on ~8% of its nodes
    return dict(x=x, edge_index=ei, labels=labels, mask=mask, **info)


def _gnn_batch(g: dict, n_edges: int, dev) -> dict:
    from repro_torch.models import gnn

    graph = gnn.pad_graph(g["x"], g["edge_index"], g["labels"], g["mask"],
                          edge_budget=n_edges, device=dev)
    batch = dict(vars(graph))
    for k in ("graph_ids", "graph_labels"):
        if k in g:
            batch[k] = torch.from_numpy(g[k]).to(dev)
    return batch


def _profile(name: str, fn, card: str) -> dict:
    """One call of ``fn`` under ``torch.profiler`` (``device_breakdown``)
    → its wall and busy ms and its six busiest kernels."""
    prof = {}
    device_breakdown(name, fn, card, reps=1, out=prof)
    top = sorted(((k, v[0]) for k, v in prof.get("kernels", {}).items()),
                 key=lambda kv: -kv[1])[:6]
    return dict(wall_ms=prof.get("wall_ms"), busy_ms=prof.get("busy_ms"), top=top)


def _gnn_cell(shape: str, mesh, dev, rng, card: str = "") -> dict:
    """Phase 15 (a) for ``shape`` (see the module docstring) → its record."""
    from repro_torch.configs import get_arch
    from repro_torch.configs.base import GNN_SHAPES
    from repro_torch.models import gnn
    from repro_torch.train.optimizer import make_optimizer
    from repro_torch.train.train_step import value_and_grad

    sh = GNN_SHAPES[shape]
    N, E = sh["n_nodes"], sh["n_edges"]
    arch = get_arch("gat-cora")
    cfg = arch._cfg(shape)
    t0 = time.perf_counter()
    g = _gnn_graph(shape, rng, N, E)
    host_s = time.perf_counter() - t0
    batch = _gnn_batch(g, E, dev)
    params = gnn.gat_init(torch.Generator(device=dev).manual_seed(0), cfg, device=dev)
    oinit, _ = make_optimizer(arch.optimizer)
    state = {"params": params, "opt": oinit(params)}
    cell = arch.build_cell(shape, mesh)
    (new, metrics), times, peak = _timed(lambda: cell.fn(state, batch), dev)
    loss = float(metrics["loss"])
    ms = statistics.median(times)
    bound, by = _bound_ms(cell)
    rec = dict(shape=shape, nodes=N + 1, edges=E, host_s=host_s, loss=loss,
               step_ms=times, ms=ms, nodes_per_s=(N + 1) / ms * 1e3, edges_per_s=E / ms * 1e3,
               bound_ms=bound, bound_by=by, max_memory_allocated=peak,
               dry_run_bytes=cell.meta["argument_bytes"] + cell.meta["output_bytes"],
               **{k: v for k, v in g.items() if k in ("host_graph_edges", "sampled_nodes",
                                                      "sampled_edges", "sampler_s")})
    if not np.isfinite(loss):
        raise SystemExit(f"phase 15 (a): gat-cora {shape}: loss {loss}")
    del new
    if shape == "ogb_products" and dev.type == "cuda":
        rec["profile"] = _profile(f"gat-cora {shape} train step", lambda: cell.fn(state, batch),
                                  card)
    loss_fn = arch.loss(shape)
    (l_dev, _), grads = value_and_grad(loss_fn, params, batch)
    if shape != "ogb_products":  # the step's loss and gradients on the CPU
        cpu = torch.device("cpu")
        (l_cpu, _), g_cpu = value_and_grad(loss_fn, _to(params, cpu), _to(batch, cpu))
        rec["cpu_loss"] = float(l_cpu)
        rec["loss_vs_cpu"] = _close(f"{shape} loss vs the CPU", l_dev, l_cpu)
        rec["grads_vs_cpu"] = _trees_close(f"{shape} gradients vs the CPU", grads, g_cpu)
        if shape == "minibatch_lg":  # the SpMM in several chunks on the card
            whole, gnn.MESSAGE_CHUNK = gnn.MESSAGE_CHUNK, CARD_MESSAGE_CHUNK
            try:
                (l_ch, _), g_ch = value_and_grad(loss_fn, params, batch)
            finally:
                gnn.MESSAGE_CHUNK = whole
            rec["chunks"] = -(-E // CARD_MESSAGE_CHUNK)
            rec["chunked_loss_vs_cpu"] = _close(f"{shape} loss in chunks of "
                                                f"{CARD_MESSAGE_CHUNK} vs the CPU", l_ch, l_cpu)
            rec["chunked_grads_vs_cpu"] = _trees_close(
                f"{shape} gradients in chunks of {CARD_MESSAGE_CHUNK} vs the CPU", g_ch, g_cpu)
            del g_ch
    if arch.edge_sharded(shape) or get_arch("gat-cora-opt1").edge_sharded(shape):
        # opt 1 and 2: the edge-sharded layer on this (1, 1) mesh against opt 0
        esrc, edst, _ = gnn.partition_edges_by_dst(g["edge_index"], N + 1, 1)
        sb = {"x": batch["x"], "edge_src": torch.from_numpy(esrc).to(dev),
              "edge_dst": torch.from_numpy(edst).to(dev), "labels": batch["labels"],
              "train_mask": batch["train_mask"].float()}
        rec["opt"] = {}
        floors = {_output_a_dst(cfg): OGB_FLOOR} if shape == "ogb_products" else None
        for opt in (1, 2):
            a = get_arch(f"gat-cora-opt{opt}")
            c = a.build_cell(shape, mesh)
            (_, m), t_opt, peak_opt = _timed(lambda: c.fn(state, sb), dev)
            (l_s, _), g_s = value_and_grad(
                lambda p, b: gnn.gat_loss_edge_sharded(p, cfg, b, mesh, ("data", "model"),
                                                       min_side_gather=opt >= 2), params, sb)
            rec["opt"][opt] = dict(
                ms=statistics.median(t_opt), step_ms=t_opt, max_memory_allocated=peak_opt,
                loss_vs_opt0=_close(f"{shape} opt {opt} loss vs opt 0", m["loss"], l_dev),
                grads_vs_opt0=_trees_close(f"{shape} opt {opt} gradients vs opt 0", g_s, grads,
                                           floors))
            del g_s
    del params, state, batch, grads
    return rec


def _rec_batch(cfg, B: int, g, dev) -> dict:
    """A batch of ``B`` rows of ``cfg`` drawn on ``dev`` from generator
    ``g``, every id inside its table (or its field's vocabulary)."""
    def ints(lo, hi, shape):
        return torch.randint(lo, hi, shape, generator=g, device=dev, dtype=torch.int32)

    m = cfg.name
    if m in ("deepfm", "dcn-v2"):
        out = {"sparse": torch.stack([ints(0, v, (B,)) for v in cfg.vocab_sizes], 1)}
        if m == "dcn-v2":
            out = {"dense": torch.rand((B, cfg.n_dense), generator=g, device=dev), **out}
        out["label"] = ints(0, 2, (B,)).float()
        return out
    S = cfg.seq_len
    pad = torch.rand((B, 1), generator=g, device=dev) * S  # each row's padded prefix
    live = torch.arange(S, device=dev)[None] >= pad.floor().int()
    if m == "sasrec":
        seq = ints(1, cfg.n_items, (B, S)) * live
        pos = torch.cat([seq[:, 1:], ints(1, cfg.n_items, (B, 1))], 1) * live
        return {"seq": seq, "pos_label": pos,
                "neg_label": ints(1, cfg.n_items, (B, S, cfg.n_negatives))}
    return {"hist": ints(1, cfg.n_items, (B, S)) * live, "target": ints(1, cfg.n_items, (B,)),
            "label": ints(0, 2, (B,)).float()}


def _rows(batch: dict, n: int) -> dict:
    return {k: v[:n] for k, v in batch.items()}


def _rec_config(arch_id: str, mesh, dev, card: str = "") -> dict:
    """Phase 15 (b) for one RecSys config at full width: its four cells
    (see the module docstring) → its record."""
    from repro_torch.configs import get_arch
    from repro_torch.configs.base import CAND_FIELD, REC_SHAPES
    from repro_torch.models import recsys as rec_m
    from repro_torch.train.optimizer import make_optimizer
    from repro_torch.train.train_step import value_and_grad
    from repro_torch.tree import tree_leaves

    arch = get_arch(arch_id)
    cfg = arch.cfg
    init_fn, loss_raw, _ = arch._fns(cfg)
    _sync(dev)
    t0 = time.perf_counter()
    params = init_fn(torch.Generator(device=dev).manual_seed(0), cfg, device=dev)
    _sync(dev)
    rec = dict(arch=arch_id, init_s=time.perf_counter() - t0,
               n_params=sum(t.numel() for t in tree_leaves(params)),
               param_bytes=_tree_bytes(params), cells={})
    g = torch.Generator(device=dev).manual_seed(1)
    cpu = torch.device("cpu")
    serve = arch.serve_fn()
    with torch.no_grad():
        p_cpu = _to(params, cpu)
    for shape in ("serve_p99", "serve_bulk", "retrieval_cand", "train_batch"):
        sh = REC_SHAPES[shape]
        if shape == "retrieval_cand":
            B = DIN_CANDIDATES if arch_id == "din" else sh["n_candidates"]
        elif shape == "train_batch" and arch_id == "sasrec":
            B = SASREC_TRAIN_BATCH
        else:
            B = sh["batch"]
        cell = arch.build_cell(shape, mesh, global_batch=B)
        r = dict(batch=B, full=sh.get("n_candidates", sh["batch"]))
        if shape == "retrieval_cand":
            user = _rec_batch(cfg, 1, g, dev)
            hi = cfg.vocab_sizes[CAND_FIELD] if arch_id in ("deepfm", "dcn-v2") else cfg.n_items
            cand = torch.randint(0, hi, (B,), generator=g, device=dev, dtype=torch.int32)
            if arch_id == "deepfm":
                args = (user["sparse"],)
            elif arch_id == "dcn-v2":
                args = (user["dense"], user["sparse"])
            elif arch_id == "sasrec":
                args = (user["seq"],)
            else:
                args = (user["hist"][0],)
            scores, times, peak = _timed(lambda: cell.fn(params, *args, cand), dev)
            if arch_id in ("deepfm", "dcn-v2"):
                off = rec_m._field_offsets(cfg.vocab_sizes, dev)
                keep = torch.arange(cfg.n_fields, device=dev) != CAND_FIELD
                ids = torch.cat([(user["sparse"][0] + off)[keep], cand + off[CAND_FIELD]])
            else:
                ids = torch.cat([args[0].flatten(), cand])
            bound = _rec_serve_bound_ms(arch, shape, B, params, ids, (*args, cand), scores)
            n = FAM_CHECK_ROWS
            with torch.no_grad():  # the first candidates as one batched forward
                if arch_id in ("deepfm", "dcn-v2"):
                    rows = user["sparse"].expand(n, cfg.n_fields).clone()
                    rows[:, CAND_FIELD] = cand[:n]
                    b = {"sparse": rows}
                    if arch_id == "dcn-v2":
                        b["dense"] = user["dense"].expand(n, cfg.n_dense)
                    want = serve(params, b)
                elif arch_id == "sasrec":
                    u = rec_m.sasrec_encode(params, cfg, user["seq"])[:, -1]
                    want = u @ params["item_embed"][cand[:n].long()].T
                else:
                    want = serve(params, {"hist": user["hist"].expand(n, cfg.seq_len),
                                          "target": cand[:n]})
            got = scores[:, :n] if arch_id == "sasrec" else scores[:n]
            r["first_rows_vs_batched"] = _close(f"{arch_id} retrieval_cand's first {n}", got,
                                                want)
            del scores
        elif shape == "train_batch":
            oinit, _ = make_optimizer(arch.optimizer)
            state = {"params": params, "opt": oinit(params)}
            batch = _rec_batch(cfg, B, g, dev)
            (new, metrics), times, peak = _timed(lambda: cell.fn(state, batch), dev)
            bound = _bound_ms(cell)
            r["loss"] = float(metrics["loss"])
            if not np.isfinite(r["loss"]):
                raise SystemExit(f"phase 15 (b): {arch_id} train_batch loss {r['loss']}")
            del new
            if arch_id == "sasrec" and dev.type == "cuda":
                r["profile"] = _profile(f"{arch_id} train_batch step at {B:,}",
                                        lambda: cell.fn(state, batch), card)
            del state
            small = _rows(batch, FAM_CHECK_ROWS)
            del batch
            loss_fn = lambda p, b: loss_raw(p, cfg, b)  # noqa: E731
            (l_dev, _), g_dev = value_and_grad(loss_fn, params, small)
            (l_cpu, _), g_cpu = value_and_grad(loss_fn, p_cpu, _to(small, cpu))
            r["check_loss"] = [float(l_dev), float(l_cpu)]
            r["loss_vs_cpu"] = _close(f"{arch_id} train loss at {FAM_CHECK_ROWS} vs the CPU",
                                      l_dev, l_cpu)
            r["grads_vs_cpu"] = _trees_close(f"{arch_id} gradients at {FAM_CHECK_ROWS} vs the "
                                             f"CPU", g_dev, g_cpu)
            del g_dev, g_cpu
        else:
            batch = _rec_batch(cfg, B, g, dev)
            batch = {k: v for k, v in batch.items() if k not in ("label", "pos_label",
                                                                  "neg_label")}
            out, times, peak = _timed(lambda: cell.fn(params, batch), dev)
            if arch_id in ("deepfm", "dcn-v2"):
                ids = batch["sparse"] + rec_m._field_offsets(cfg.vocab_sizes, dev)[None]
            else:
                ids = torch.cat([batch[k].flatten() for k in ("seq", "hist", "target")
                                 if k in batch])
            bound = _rec_serve_bound_ms(arch, shape, B, params, ids, tuple(batch.values()), out)
            n = FAM_CHECK_ROWS
            with torch.no_grad():
                if shape == "serve_p99":
                    want = serve(p_cpu, _to(batch, cpu))
                    r["vs_cpu"] = _close(f"{arch_id} serve_p99 vs the CPU", out, want)
                else:
                    want = serve(params, _rows(batch, n))
                    r["first_rows_vs_p99_fn"] = _close(f"{arch_id} serve_bulk's first {n}",
                                                       out[:n], want)
            del out, batch
        ms = statistics.median(times)
        bound, by = bound
        r.update(step_ms=times, ms=ms, per_s=B / ms * 1e3, bound_ms=bound, bound_by=by,
                 max_memory_allocated=peak,
                 dry_run_bytes=cell.meta["argument_bytes"] + cell.meta["output_bytes"])
        rec["cells"][shape] = r
    del params, p_cpu
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return rec


#: the RecSys configs whose cells phase 15 also runs placed at world 1
REC_PLACED = ("deepfm", "sasrec")
#: placed against whole weights on one card (f32, TF32 off): losses, grad
#: norms and outputs (rtol), parameters after a step (within this many lr:
#: a first AdamW step moves a weight by ±lr whatever its gradient's size)
REC_PLACED_RTOL, REC_PLACED_LR = 1e-4, 1e-2


def _rec_placed(arch_id: str, mesh, dev) -> dict:
    """(d) ``arch_id``'s ``train_batch``, ``serve_p99`` and
    ``retrieval_cand`` with ``weights="placed"`` (its tables' rows split
    over ``model``, here of size 1) at full width against the whole-weight
    cells on the same inputs."""
    from repro_torch.configs import get_arch
    from repro_torch.configs.base import REC_SHAPES
    from repro_torch.train.optimizer import make_optimizer
    from repro_torch.tree import tree_leaves

    arch = get_arch(arch_id)
    cfg = arch.cfg
    params = arch._fns(cfg)[0](torch.Generator(device=dev).manual_seed(0), cfg, device=dev)
    g = torch.Generator(device=dev).manual_seed(2)
    rec = dict(arch=arch_id)
    t0 = time.perf_counter()
    B = SASREC_TRAIN_BATCH if arch_id == "sasrec" else REC_SHAPES["train_batch"]["batch"]
    batch = _rec_batch(cfg, B, g, dev)
    res = {}
    for w in ("whole", "placed"):
        cell = arch.build_cell("train_batch", mesh, weights=w, global_batch=B)
        st = (arch.place("train_batch", mesh, params) if w == "placed" else
              {"params": params, "opt": make_optimizer(arch.optimizer)[0](params)})
        st, m = cell.fn(st, batch)
        res[w] = (st["params"], {k: float(v) for k, v in m.items()})
        del st
    rec["train"] = {k: [res["placed"][1][k], res["whole"][1][k]] for k in ("loss", "grad_norm")}
    rec["train_rel"] = max(abs(a - b) / abs(b) for a, b in rec["train"].values())
    rec["params_max_abs_in_lr"] = max(
        float((a - b).abs().max()) / res["whole"][1]["lr"]
        for a, b in zip(tree_leaves(res["placed"][0]), tree_leaves(res["whole"][0])))
    del res, batch
    serve = {k: v for k, v in _rec_batch(cfg, REC_SHAPES["serve_p99"]["batch"], g, dev).items()
             if k not in ("label", "pos_label", "neg_label")}
    user = _rec_batch(cfg, 1, g, dev)
    user = (user["seq"],) if arch_id == "sasrec" else (user["sparse"],)
    hi = cfg.n_items if arch_id == "sasrec" else cfg.vocab_sizes[3]
    cand = torch.randint(0, hi, (REC_SHAPES["retrieval_cand"]["n_candidates"],), generator=g,
                         device=dev, dtype=torch.int32)
    outs = {}
    for w in ("whole", "placed"):
        pp = arch.place("serve_p99", mesh, params) if w == "placed" else params
        outs[w] = (arch.build_cell("serve_p99", mesh, weights=w).fn(pp, serve),
                   arch.build_cell("retrieval_cand", mesh, weights=w).fn(pp, *user, cand))
    rec["serve_rel"] = _rel(outs["placed"][0], outs["whole"][0])
    rec["cand_rel"] = _rel(outs["placed"][1], outs["whole"][1])
    rec["s"] = time.perf_counter() - t0
    worst = max(rec["train_rel"], rec["serve_rel"], rec["cand_rel"])
    if not (worst <= REC_PLACED_RTOL and rec["params_max_abs_in_lr"] <= REC_PLACED_LR):
        raise SystemExit(f"phase 15 (d): {arch_id} placed vs whole at world 1: {rec}")
    del params, outs
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return rec


#: phases 14 and 15's cells on one card against the dry run's peak of a
#: (1, 1) mesh at the same batch (arguments + outputs + the traced
#: temporaries − aliases): max_memory_allocated / peak within
#: [1 / MEM_FACTOR, MEM_FACTOR]. The card also holds what the process keeps
#: beside the step (a config's parameters while another cell runs, the
#: CUDA context's workspaces), and a cell under 1 GiB is dominated by that:
#: those are held to MEM_FLOOR_BYTES above the peak instead
MEM_FACTOR = 1.5
MEM_FLOOR_BYTES = 2**30


def _dry_run_ratios(out: dict, card: str) -> list:
    """Each cell phases 14 and 15 ran at full size on the card → its
    max_memory_allocated against ``dryrun.cell_memory``'s peak on a
    (1, 1) ``MeshShape`` at the batch it ran (logged; outside the factor
    fails)."""
    from repro_torch.launch.dryrun import cell_memory
    from repro_torch.launch.mesh import MeshShape

    one = MeshShape((1, 1), ("data", "model"))
    cells = []
    q = out["models"]["qwen3-8b"]
    cells += [("qwen3-8b", "prefill_32k", q["prefill"]["batch"],
               q["prefill"]["max_memory_allocated"]),
              ("qwen3-8b", "decode_32k", q["decode"]["batch"],
               q["decode"]["max_memory_allocated"])]
    fam = out["families"]
    cells += [("gat-cora", s, None, r["max_memory_allocated"]) for s, r in fam["gnn"].items()]
    cells += [(a, s, c["batch"], c["max_memory_allocated"])
              for a, r in fam["recsys"].items() for s, c in r["cells"].items()]
    rows, bad = [], []
    gib = 2**30
    t0 = time.perf_counter()
    for a, s, B, got in cells:
        mem = cell_memory(a, s, one, B)
        ratio = got / mem["peak_device_bytes"]
        ok = (1 / MEM_FACTOR <= ratio <= MEM_FACTOR if mem["peak_device_bytes"] >= gib
              else got <= mem["peak_device_bytes"] + MEM_FLOOR_BYTES)
        rows.append(dict(arch=a, shape=s, batch=B, max_memory_allocated=got, ratio=ratio, ok=ok,
                         **mem))
        log(f"    dry run vs the card: {a} {s}" + (f" at {B:,}" if B else "") +
            f": max_memory_allocated {got / gib:.3f} GiB / dry-run peak "
            f"{mem['peak_device_bytes'] / gib:.3f} GiB (arguments {mem['argument_bytes'] / gib:.3f}"
            f" + outputs {mem['output_bytes'] / gib:.3f} + temporaries "
            f"{mem['temp_bytes'] / gib:.3f} − aliased {mem['alias_bytes'] / gib:.3f}) = "
            f"{ratio:.3f}{'' if ok else '  OUTSIDE'} ({card})")
        if not ok:
            bad.append((a, s, ratio))
    log(f"[14/15] dry run (1, 1) against max_memory_allocated: {len(rows)} cells, factor "
        f"{MEM_FACTOR} (under 1 GiB: {MEM_FLOOR_BYTES / gib:.0f} GiB above the peak), traced in "
        f"{time.perf_counter() - t0:.1f}s on the host")
    if bad:
        raise SystemExit(f"phase 14/15: the card's peak is outside the dry run's by more than "
                         f"{MEM_FACTOR}×: {bad}")
    return rows


def _family_smoke_parity() -> dict:
    """The five new configs' ``smoke()`` on the card and on the CPU."""
    from repro_torch.configs import get_arch

    out = {}
    for a in FAMILY_IDS:
        card, cpu = get_arch(a).smoke(0, device="cuda"), get_arch(a).smoke(0, device="cpu")
        key = "losses" if a == "gat-cora" else "loss"
        got, want = np.atleast_1d(card[key]), np.atleast_1d(cpu[key])
        if not np.allclose(got, want, rtol=FAM_RTOL, atol=0):
            raise SystemExit(f"phase 15 (c): {a} smoke() on the card {got} vs the CPU {want} "
                             f"(rtol {FAM_RTOL})")
        out[a] = [got.tolist(), want.tolist()]
    return out


def _family_train_cli() -> str:
    """One ``launch.train --arch deepfm --smoke`` run on the card → its line."""
    import contextlib
    import io

    from repro_torch.launch import train

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        train.main(["--arch", "deepfm", "--smoke", "--steps", str(FAM_TRAIN_STEPS)])
    line = buf.getvalue().strip().splitlines()[-1]
    if not line.startswith(f"trained deepfm {FAM_TRAIN_STEPS} steps") or "restarts=0" not in line:
        raise SystemExit(f"phase 15 (c): launch.train printed {line!r}")
    return line


FAMILY_IDS = ("gat-cora", "deepfm", "dcn-v2", "sasrec", "din")


def family_phase(mesh, dev, card: str) -> dict:
    """Phase 15: (a) GAT's four cells, (b) the four RecSys configs at full
    width, (c) the small checks → the record (each line logged as it
    finishes)."""
    from repro_torch.configs.base import GNN_SHAPES

    t_start = time.perf_counter()
    out = dict(gnn={}, recsys={})
    rng = np.random.default_rng(0)
    gib = 2**30
    for shape in GNN_SHAPES:
        r = out["gnn"][shape] = _gnn_cell(shape, mesh, dev, rng, card)
        extra = ""
        if "cpu_loss" in r:
            extra += (f"; loss and gradients == the CPU's (loss err {r['loss_vs_cpu']:.1e}, "
                      f"gradients {r['grads_vs_cpu']:.1e} of scale)")
        if "chunks" in r:
            extra += (f"; the SpMM in {r['chunks']} chunks of {CARD_MESSAGE_CHUNK:,} edges == "
                      f"the CPU's (loss err {r['chunked_loss_vs_cpu']:.1e}, gradients "
                      f"{r['chunked_grads_vs_cpu']:.1e} of scale)")
        if "opt" in r:
            extra += "; " + ", ".join(
                f"opt {o}: {v['ms']:.2f} ms, loss/gradients == opt 0 ({v['loss_vs_opt0']:.1e}/"
                f"{v['grads_vs_opt0']:.1e})" for o, v in r["opt"].items())
        if "sampled_nodes" in r:
            extra += (f"; sampled {r['sampled_nodes']:,} nodes / {r['sampled_edges']:,} edges "
                      f"from a {REDDIT_NODES:,}-node, {r['host_graph_edges']:,}-edge host graph "
                      f"in {r['sampler_s']:.1f}s")
        log(f"[15] (a) gat-cora {shape}: {r['nodes']:,} nodes, {r['edges']:,} edges; a train step {r['ms']:.2f} ms "
            f"(median of {FAM_REPS}), {r['edges_per_s']:,.0f} edges/s, {r['nodes_per_s']:,.0f} "
            f"nodes/s, bound {r['bound_ms']:.3f} ms by {r['bound_by']}; loss {r['loss']:.4f}; "
            f"max_memory_allocated {r['max_memory_allocated'] / gib:.2f} GiB, dry run (1, 1) "
            f"{r['dry_run_bytes'] / gib:.3f} GiB{extra} ({card})")
    for a in FAMILY_IDS[1:]:
        r = out["recsys"][a] = _rec_config(a, mesh, dev, card)
        log(f"[15] (b) {a}: {r['n_params']:,} params ({r['param_bytes'] / 1e9:.2f} GB f32, "
            f"drawn on the card in {r['init_s']:.1f}s) ({card})")
        for shape, c in r["cells"].items():
            checks = ", ".join(f"{k} {v:.1e}" for k, v in c.items()
                               if k.endswith(("vs_cpu", "vs_batched", "p99_fn")))
            cut = f" (cut from {c['full']:,})" if c["batch"] != c["full"] else ""
            log(f"    {a} {shape} at {c['batch']:,}{cut}: {c['ms']:.3f} ms (median of "
                f"{FAM_REPS}), {c['per_s']:,.0f} "
                f"{'candidates' if shape == 'retrieval_cand' else 'samples'}/s, bound "
                f"{c['bound_ms']:.3f} ms by {c['bound_by']}; max_memory_allocated "
                f"{c['max_memory_allocated'] / gib:.2f} GiB, dry run (1, 1) "
                f"{c['dry_run_bytes'] / gib:.3f} GiB; checks held ({checks}) ({card})")
    out["placed"] = {}
    for a in REC_PLACED:
        r = out["placed"][a] = _rec_placed(a, mesh, dev)
        log(f"[15] (d) {a} placed cells at world 1 (its tables' rows over a model axis of "
            f"one) vs whole weights: train_batch loss/grad_norm {r['train']} (rel "
            f"{r['train_rel']:.1e}), parameters within {r['params_max_abs_in_lr']:.1e} lr; "
            f"serve_p99 rel {r['serve_rel']:.1e}; retrieval_cand rel {r['cand_rel']:.1e} (rtol "
            f"{REC_PLACED_RTOL}); {r['s']:.1f}s ({card})")
    t0 = time.perf_counter()
    out["smoke"] = _family_smoke_parity()
    out["train_cli"] = _family_train_cli()
    out["small_s"] = time.perf_counter() - t0
    log(f"[15] (c) smoke() card == CPU (rtol {FAM_RTOL}): " + ", ".join(
        f"{a} {v[0]}" for a, v in out["smoke"].items()) + f"; launch.train --smoke on the card: "
        f"{out['train_cli']} ({card})")
    out["seconds"] = time.perf_counter() - t_start
    return out


def family_rank(rank: int, world: int, d: str) -> None:
    """Phase 15 alone in an NCCL rank (world 1, mesh ``(1, 1)``) → ``<d>/out.json``."""
    from repro_torch.launch.mesh import make_debug_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mesh = make_debug_mesh((1, 1), ("data", "model"))
    out = family_phase(mesh, torch.device("cuda"), card_line())
    (pathlib.Path(d) / "out.json").write_text(json.dumps(out))


def main() -> int:
    ap = argparse.ArgumentParser(description="smoke run of the port on one GPU")
    ap.add_argument("--n-docs", type=int, default=60_000,
                    help="collection size (MsMarco has 8,842,240; the host build, Python "
                         "loops, bounds it)")
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

    # -- 14. the LM family, in a rank of its own beside phase 3's host build ----------
    lm_job = lm_phase_start()
    log("[14] the LM family, then [15] the GNN and RecSys families, started in a spawned "
        "NCCL rank (it runs beside phase 3's host build, which leaves the card idle)")

    # -- 3. the main path -----------------------------------------------------
    t0 = time.perf_counter()
    # drawn once with phase 13's 4,096 queries: the documents do not depend on
    # the query count, the first 64 queries (every earlier phase's) do
    col = generate_collection(splade_config(args.n_docs, SEARCH_NQ, 0), value_format="f16")
    fwd = col.fwd
    Q_all = np.stack([col.query_dense(i) for i in range(col.n_queries)])
    Q_np = Q_all[:nq]
    log(f"[3] generated {fwd.n_docs} docs (nnz/doc={fwd.total_nnz / fwd.n_docs:.1f}, "
        f"dim={fwd.dim}) + {col.n_queries} queries ({nq} a batch up to phase 12) in "
        f"{time.perf_counter() - t0:.1f}s")
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
    lm = lm_phase_finish(lm_job, card)
    phase_s["14 lm (beside 3)"] = lm["spawn_s"]
    phase_s["14 lm wait"] = lm["waited_s"]

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
    lilsr = extra.pop("_lilsr")  # kept for phase 13
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

    # -- 13. the paper's retrieval configs ----------------------------------------
    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    cells = cells_phase(fwd, Q_all, index, seismic["dotvbyte", "f16"],
                        hnsw_served["dotvbyte", "f16"], truth, csr, lilsr, card)
    for rec in kernels:
        n = (cells["_path"]["rows_launches"].get(rec["name"], 0)
             + cells["_path"]["block_launches"].get(rec["name"], 0))
        rec.setdefault("launches_by_path", {})["configs"] = n
        rec["launches"] += n
    dv["configs_phase"] = {k: v for k, v in cells.items() if k != "full"}
    kernels[[k["name"] for k in kernels].index("block_scan_dotvbyte_batch")]["full_corpus"] = \
        cells["full"]
    phase_s["13 configs"] = time.perf_counter() - t0
    log(f"[13] {phase_s['13 configs']:.1f}s")

    # -- 16. summary ------------------------------------------------------------
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
