"""Serving launcher: build (or load) an index over a synthetic
MsMarco-like collection and serve batched queries through the port's
``Retriever`` — the subset of ``repro/launch/serve.py`` the main path
needs.

    python -m repro_torch.launch.serve --engine seismic --codec dotvbyte \\
        --n-docs 20000 --n-queries 64

builds the collection (``--encoder splade``: SPLADE statistics, 119
terms a document and 43 a query; ``lilsr``: LiLSR's, 387 and 6) and the
index on the host, moves the arrays to
the device (``cuda`` unless ``--device cpu``), runs one warm-up and one
timed batched search, and prints recall@k against the exact top-k, the
latency per query and the paper's space metric: the components' bits
per component under the codec, against 16 for raw u16.
``--compare-codecs`` sweeps every registered row codec over ONE host
index (the Seismic or HNSW build is the slow part; it is built once).
``--engine both`` serves Seismic then hnsw, ``--engine all`` every
registered engine in name order; every mode loops over the engines.
``--engine hnsw`` takes the reference CLI's graph parameters (``m=16``,
``ef_construction=48``, 8 seeds) with ``--beam`` and ``--iters``.
``--save-index DIR`` writes each artifact under ``DIR/<engine>-<codec>/``
(the reference's format) with this run's top-k; ``--load-index DIR``
serves from them instead of building and checks each reopened index
returns the same top-k.

``--pipeline`` switches to the online-serving load generator (the
reference's ``_pipeline_loadgen``): a seeded repeat-heavy trace of
``--requests`` single queries (``synthetic_trace``, ``--repeat-frac``,
optional ``--trace-qps`` pacing) is driven through the micro-batching
scheduler (``--deadline-us``, ``--cache-size``) after every bucket's
plan is warmed (captured, on the card); every response is checked
against a direct ``Retriever.search`` of the query batch bit for bit
(:func:`trace_parity`), then the ``ServeStats`` line is
printed. It refuses ``--save-index`` and ``--load-index`` as the
reference does.

``--n-shards S`` builds a sharded index (``serve/sharded.py``): S
contiguous doc ranges, each its own sub-index (no shared host index is
built), searched in turn on the device and merged; ``--max-resident``
bounds the shards resident at once (default all) and ``--no-prefetch``
turns off the staging of the next shard. ``--save-index`` writes a
sharded artifact tree and ``--load-index`` opens one memory-mapped; a
tree serves the backend it was saved with. The result line adds the
residency counters.

``--mutate`` is the live-mutation load generator (the reference's
``_mutate_loadgen``, ``serve/segments.py``): ``--mutations`` seeded
inserts, deletes and updates in three rounds over a ``MutableRetriever``,
each round followed by a query burst through the pipeline that is held
to a fresh oracle over the live corpus, then a background merge with
queries streaming through the flip; it prints ``mutation parity OK``
with the ServeStats line. Budgets are exhaustive: keep ``--n-docs`` in
the low hundreds.
"""

from __future__ import annotations

import argparse
import pathlib
import time

import numpy as np
import torch

from ..data.synthetic import lilsr_config, splade_config

#: ``--encoder`` → the synthetic collection's statistics
ENCODERS = {"splade": splade_config, "lilsr": lilsr_config}


def _device_name(device: torch.device) -> str:
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return "CPU"


def _shard_note(retriever) -> str:
    """The residency counters of a sharded retriever; "" for a monolithic one."""
    if not hasattr(retriever, "shards"):
        return ""
    return (f" shards={len(retriever.shards)} max_resident={retriever.max_resident} "
            f"prefetch={retriever.prefetch_hits}h/{retriever.prefetch_misses}m "
            f"evictions={retriever.evictions} compiles={retriever.plans.compiles} "
            f"peak_resident={retriever.peak_resident_bytes / 2**20:.2f}MiB")


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


def stage_names(stages) -> frozenset:
    """A plan's stages as bare rows-kernel stage names: a fan-out plan's
    ``(label, stage)`` pairs (nested, for a sharded base inside a mutable
    index) lose their labels."""
    out = set()
    for st in stages:
        while isinstance(st, tuple):
            st = st[-1]
        out.add(st)
    return frozenset(out)


def _same_bits(t, ids, scores) -> bool:
    return np.array_equal(t.ids, ids) and np.array_equal(
        np.asarray(t.scores, np.float32).view(np.uint32),
        np.asarray(scores, np.float32).view(np.uint32))


def trace_parity(trace, tickets, direct_ids, direct_scores, *, oracle: bool = False) -> dict:
    """Hold every trace response against direct search (host numpy
    ``[n_queries, k]``) bit for bit → counts per rule.

    Every rows-kernel stage sums a dot in one order
    (``kernels/csrc/gaps.cuh``), so a response is the same bytes whatever
    bucket, and so whatever stage, its dispatch took. A cache hit must
    replay, byte for byte, a response served for the same query before it.
    With ``oracle`` the direct results come from a plan outside the
    pipeline (the mutation load generator's oracle over the live corpus),
    and a cache hit, which may replay a response served before this trace,
    is held to them like any response. Raises ``AssertionError`` on the
    first violation."""
    counts = {"bitwise": 0, "cache_replays": 0}
    served: dict[int, list] = {}
    for qi, t in zip(trace, tickets):
        qi = int(qi)
        if t.from_cache:
            counts["cache_replays"] += 1
            if not oracle:
                if not any(_same_bits(t, i, s) for i, s in served.get(qi, ())):
                    raise AssertionError(f"cache hit for query {qi} replays no served response")
                continue
            what = "a cache hit"
        else:
            served.setdefault(qi, []).append((t.ids, t.scores))
            counts["bitwise"] += 1
            what = f"bucket {t.bucket} (stages {sorted(stage_names(t.stages))})"
        if not _same_bits(t, direct_ids[qi], direct_scores[qi]):
            raise AssertionError(f"query {qi}: {what}: the top-k differs from direct search")
    return counts


def _pipeline_loadgen(retriever, Q, args, rng) -> str:
    """Drive a synthetic trace through the micro-batching scheduler and
    hold every response against direct search (:func:`trace_parity`) →
    the counts and the stats summary. Raises ``AssertionError`` on a
    parity violation."""
    from ..serve.pipeline import ServeStats, synthetic_trace

    trace = synthetic_trace(rng, args.requests, Q.shape[0], repeat_frac=args.repeat_frac)
    direct_ids, direct_scores = (t.cpu().numpy() for t in retriever.search(Q))
    pipe = retriever.pipeline(deadline_us=args.deadline_us, cache_size=args.cache_size)
    # capture cost out of the measured trace: p50/p95/p99 cover warm plans only
    warm = pipe.warm()
    gap = 1.0 / args.trace_qps if args.trace_qps > 0 else 0.0
    tickets = []
    for qi in trace:
        if gap:
            time.sleep(gap)
        pipe.poll()  # fire expired deadlines before admitting
        tickets.append(pipe.submit(Q[qi]))
    pipe.flush()
    counts = trace_parity(trace, tickets, direct_ids, direct_scores)
    snap = pipe.snapshot()
    return (f"parity: {counts['bitwise']} bitwise, {counts['cache_replays']} cache replays; "
            f"{ServeStats.summary(snap)} warm_compiles={warm} "
            f"trace_recompiles={snap['recompiles'] - warm}")


def _mutate_loadgen(col, engine, codec, args, device, rng) -> None:
    """The live-mutation load generator (the reference's
    ``_mutate_loadgen``): a ``MutableRetriever`` over the leading ~2/3 of
    the collection (the rest is the insert pool) at budgets exhaustive for
    the whole corpus; ``--mutations`` seeded inserts, deletes and updates
    in three rounds, each followed by a query burst through the
    micro-batching pipeline and a checkpoint that holds every burst
    response to a fresh oracle ``Retriever.build`` over the live corpus
    (stable id ``live_ids[pos]`` ↔ oracle position ``pos``) bit for bit
    (:func:`trace_parity`). The merge then runs in the
    background with queries streaming through the flip; those responses
    join the post-merge checkpoint (the merge does not change the live
    corpus). Raises ``AssertionError`` on a divergence, or if the result
    cache was not invalidated once per round and once for the merge."""
    from collections import Counter

    from ..serve.api import Retriever, RetrieverConfig
    from ..serve.pipeline import ServeStats, synthetic_trace
    from ..serve.segments import MutableRetriever

    fwd = col.fwd
    n_docs = fwd.n_docs
    exhaustive = {
        "seismic": dict(cut=16, block_budget=1024, n_probe=1024, n_postings=100000,
                        block_size=8),
        "hnsw": dict(beam=n_docs + 8, iters=n_docs + 8, n_seeds=4, m=8, ef_construction=48),
        "flat": {},
    }
    cfg = RetrieverConfig(engine=engine, codec=codec, k=args.k, backend=args.backend or "cuda",
                          n_shards=args.n_shards, params=exhaustive[engine])
    n_base = max(args.k + 4, (2 * n_docs) // 3)
    pool = list(range(n_base, n_docs))  # docs not inserted yet
    m = MutableRetriever.create(fwd.slice(0, n_base), cfg, device=device)
    pipe = m.pipeline(deadline_us=args.deadline_us, cache_size=args.cache_size)
    Q = np.stack([col.query_dense(i) for i in range(col.n_queries)])

    def mutate_one() -> str:
        live = m.live_ids()
        ops = ["delete", "update"] + (["insert"] if pool else [])
        if len(live) <= args.k + 2:  # the oracle needs k live docs
            ops = ["insert"] if pool else ["update"]
        op = ops[int(rng.integers(len(ops)))]
        if op == "insert":
            take = [pool.pop(0) for _ in range(min(len(pool), int(rng.integers(1, 4))))]
            m.insert([fwd.doc(i) for i in take])
        elif op == "delete":
            m.delete(int(live[int(rng.integers(len(live)))]))
        else:  # update in place: new content under the same stable id
            victim = int(live[int(rng.integers(len(live)))])
            c, v = fwd.doc(int(rng.integers(n_docs)))
            m.update([(c, v)], ids=[victim])
        return op

    def burst_and_checkpoint(label: str, pre=()) -> int:
        pipe.warm()  # new parts' plans captured out of the burst
        trace = synthetic_trace(rng, max(8, args.requests // 4), Q.shape[0],
                                repeat_frac=args.repeat_frac)
        tickets = []
        for qi in trace:
            pipe.poll()
            tickets.append(pipe.submit(Q[qi]))
        pipe.flush()
        live_fwd, live = m.live_corpus()
        oracle = Retriever.build(live_fwd, cfg.replace(n_shards=1), device=device)
        oids, osc = (t.cpu().numpy() for t in oracle.search(Q))
        everything = list(pre) + list(zip(trace, tickets))
        try:
            trace_parity([qi for qi, _ in everything], [t for _, t in everything],
                         live[oids], osc, oracle=True)
        except AssertionError as e:
            raise AssertionError(f"{engine}/{codec} {label}: the mutable top-k diverges from "
                                 f"the post-mutation oracle: {e}") from None
        return len(everything)

    served = burst_and_checkpoint("pre-mutation")
    rounds, ops = 3, []
    for r in range(rounds):
        lo = (args.mutations * r) // rounds
        hi = (args.mutations * (r + 1)) // rounds
        ops += [mutate_one() for _ in range(lo, hi)]
        served += burst_and_checkpoint(f"round {r + 1}")
    # the merge in the background, queries streaming through the flip
    handle = m.merge(background=True)
    during = []
    while not handle.done() and len(during) < 4 * args.requests:
        pipe.poll()
        qi = int(rng.integers(Q.shape[0]))
        during.append((qi, pipe.submit(Q[qi])))
    pipe.flush()
    handle.result()
    served += burst_and_checkpoint("post-merge", pre=during)
    snap = pipe.snapshot()
    rounds = min(args.mutations, rounds)  # one invalidation per mutated round + the merge
    assert snap["cache_invalidations"] >= rounds + 1, (
        f"{engine}/{codec}: the result cache survived a mutation "
        f"(invalidations={snap['cache_invalidations']})")
    mix = ",".join(f"{k}={v}" for k, v in sorted(Counter(ops).items()))
    print(f"{engine:8s} codec={codec:13s} backend={cfg.backend} mutation parity OK "
          f"({served} responses, {len(during)} during background merge, {args.mutations} "
          f"mutations [{mix}], {len(m.base_ids)} docs after merge, gen={m.generation}, "
          f"{_device_name(device)}) [{ServeStats.summary(snap)}]")


def expand_engines(name: str) -> tuple[str, ...]:
    """``--engine``'s value → the engines served, in order: ``both`` is
    Seismic then hnsw, ``all`` every registered engine in name order (the
    reference CLI's expansion)."""
    from ..serve.api import available_engines

    if name == "both":
        return ("seismic", "hnsw")
    if name == "all":
        return tuple(available_engines())
    return (name,)


def main(argv=None) -> None:
    from ..core.layout import available_layouts
    from ..kernels.modes import BACKENDS
    from ..serve.api import available_engines

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--encoder", choices=list(ENCODERS), default="splade",
                    help="the collection's statistics: SPLADE or LiLSR")
    ap.add_argument("--engine", choices=[*available_engines(), "both", "all"],
                    default="seismic",
                    help="a registered engine, 'both' (seismic+hnsw) or 'all'")
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
    ap.add_argument("--pipeline", action="store_true",
                    help="online-serving load generator: drive a synthetic trace "
                         "through the micro-batching scheduler, hold every response "
                         "against direct search, report ServeStats")
    ap.add_argument("--mutate", action="store_true",
                    help="live-mutation load generator: a seeded insert/delete/update "
                         "stream between query bursts over a MutableRetriever, every "
                         "response held to a fresh oracle at each checkpoint, then a "
                         "background merge and the check again; exhaustive budgets, so "
                         "keep --n-docs small")
    ap.add_argument("--mutations", type=int, default=12,
                    help="--mutate stream length (events across 3 rounds)")
    ap.add_argument("--requests", type=int, default=256, help="trace length for --pipeline")
    ap.add_argument("--deadline-us", type=float, default=1000.0,
                    help="--pipeline batch-filling deadline (µs)")
    ap.add_argument("--trace-qps", type=float, default=0.0,
                    help="--pipeline arrival pacing; 0 = closed-loop")
    ap.add_argument("--repeat-frac", type=float, default=0.25,
                    help="--pipeline fraction of requests re-asking a head query")
    ap.add_argument("--cache-size", type=int, default=1024,
                    help="--pipeline result-cache capacity (0 disables)")
    ap.add_argument("--n-shards", type=int, default=1,
                    help="index shards: > 1 builds and serves a sharded tree (per-shard "
                         "sub-indexes over contiguous doc ranges, memory-mapped under "
                         "--load-index, served in turn through an LRU of resident shards)")
    ap.add_argument("--max-resident", type=int, default=None,
                    help="bound on the shards resident at once (default: all)")
    ap.add_argument("--no-prefetch", action="store_true",
                    help="do not stage the next shard while the current one is scored; "
                         "every admission then copies on the critical path")
    args = ap.parse_args(argv)
    if args.save_index and args.load_index:
        ap.error("--save-index and --load-index are mutually exclusive")
    if args.pipeline and (args.save_index or args.load_index):
        ap.error("--pipeline is a serving-loop mode; run it without "
                 "--save-index/--load-index")
    if args.mutate and (args.pipeline or args.save_index or args.load_index):
        ap.error("--mutate is a serving-loop mode; run it without "
                 "--pipeline/--save-index/--load-index")

    from .. import resolve_device
    from ..core.seismic import exact_top_k, recall_at_k
    from ..data.synthetic import generate_collection
    from ..serve.api import Retriever, RetrieverConfig, get_engine, open_retriever

    device = resolve_device(args.device)
    print(f"generating {args.n_docs}-doc synthetic {args.encoder} collection…")
    col = generate_collection(ENCODERS[args.encoder](args.n_docs, args.n_queries, args.seed),
                              value_format="f16")
    print(f"(nnz/doc={col.fwd.total_nnz / col.fwd.n_docs:.0f})")
    engines = expand_engines(args.engine)
    codecs = available_layouts() if args.compare_codecs else [args.codec]
    if args.mutate:
        for engine in engines:
            for codec in codecs:
                _mutate_loadgen(col, engine, codec, args, device,
                                np.random.default_rng(args.seed + 2))
        return
    Q = np.stack([col.query_dense(i) for i in range(col.n_queries)])
    truth = [exact_top_k(col.fwd, Q[i], args.k)[0] for i in range(col.n_queries)]

    search_params = {
        "seismic": dict(cut=args.cut, block_budget=512, n_probe=args.n_probe,
                        n_postings=2000, block_size=64),
        "hnsw": dict(beam=args.beam, iters=args.iters, n_seeds=8, m=16, ef_construction=48),
        "flat": {},
    }
    # one host index per engine; every codec packs its rows over it (a
    # sharded build makes one sub-index per doc range instead)
    host_indexes = {}
    if not args.load_index and args.n_shards == 1:
        for engine in engines:
            impl = get_engine(engine)
            if not hasattr(impl, "host_index"):
                continue
            t0 = time.perf_counter()
            host_indexes[engine] = impl.host_index(
                col.fwd, RetrieverConfig(engine=engine, params=search_params[engine]))
            print(f"{engine}: host index built in {time.perf_counter() - t0:.1f}s")

    for engine, codec in ((e, c) for e in engines for c in codecs):
        cfg = RetrieverConfig(engine=engine, codec=codec, k=args.k,
                              backend=args.backend or "cuda", n_shards=args.n_shards,
                              params=search_params[engine])
        art = pathlib.Path(args.load_index or args.save_index or ".") / f"{engine}-{codec}"
        if args.load_index:
            retriever = open_retriever(art, device=device)
            # a sharded tree serves the backend it was saved with
            if (args.backend and args.backend != retriever.cfg.backend
                    and not hasattr(retriever, "shards")):
                retriever = Retriever(
                    retriever.cfg.replace(backend=args.backend), retriever.arrays,
                    n_docs=retriever.n_docs, dim=retriever.dim,
                    value_scale=retriever.value_scale,
                    value_format=retriever.value_format, device=device,
                )
        elif engine in host_indexes:
            retriever = Retriever.from_host_index(host_indexes[engine], cfg, device=device)
        else:
            retriever = Retriever.build(col.fwd, cfg, device=device)
        if hasattr(retriever, "shards"):
            if args.max_resident is not None:
                retriever.max_resident = args.max_resident
            retriever.prefetch = not args.no_prefetch

        if args.pipeline:
            summary = _pipeline_loadgen(retriever, Q, args, np.random.default_rng(args.seed + 1))
            print(f"{engine:8s} codec={codec:13s} backend={retriever.cfg.backend} "
                  f"pipeline parity OK ({args.requests} requests, {_device_name(device)}) "
                  f"[{summary}]{_shard_note(retriever)}")
            continue
        retriever.search(Q)  # warm-up: plan capture, kernel build and first launches
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
        _report(engine, codec, retriever.cfg.backend, args.k, recs,
                1e6 * dt / col.n_queries, col.fwd, device, extra + _shard_note(retriever))


if __name__ == "__main__":
    main()
