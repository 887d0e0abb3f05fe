"""Online serving pipeline: plan cache, bucketed micro-batching
scheduler, result cache and serving metrics — the port of
``repro/serve/pipeline.py`` (DESIGN.md §8).

Four layers, stacked as in the reference:

* ``PlanCache`` — ONE plan per ``(engine, codec, backend, k, bucket)``
  key. Arbitrary query-batch sizes are padded up to the smallest
  covering bucket (``DEFAULT_BUCKETS``, extended by the
  ``RetrieverConfig.batch_size`` hint); padded slots carry the zero
  query and are sliced away. On a CUDA retriever a plan is one CUDA
  graph of the engine's ``search_batch``, captured on a static
  ``[bucket, dim]`` query buffer (the counterpart of the reference's
  ``jax.jit(...).lower(spec).compile()``): a search replays it, so the
  host launches one graph where the eager path launches every kernel of
  the engine (an hnsw search: ~1,600). On a CPU retriever — the explicit
  ``device="cpu"`` request — a plan runs the engine eagerly on the
  padded batch and captures nothing. ``compiles`` counts plan creations.
  A ``FacadePlan`` fans its batch out through other plans (a sharded
  retriever's shards, ``serve/sharded.py``; a mutable index's base and
  delta segments, ``serve/segments.py``) and is never captured.

* ``Pipeline`` — the host-side micro-batching scheduler: ``submit``
  admits one query at a time, the queue coalesces into the smallest
  covering bucket, a full largest-bucket queue dispatches at once, and
  ``deadline_us`` bounds how long a lone query waits for batch-mates.

* ``ResultCache`` — an LRU over the quantized sparse query; a hit
  replays the top-k served before, byte for byte. The ``epoch`` check
  is generic (``getattr(retriever, "epoch", None)``): a mutable index
  bumps its epoch at every mutation and generation flip, and the next
  admission flushes the cache.

* ``ServeStats`` — QPS, p50/p95/p99 end-to-end latency, hit rate,
  dispatches and occupancy per bucket, the recompile count and the
  invalidation and overlap counters, under the reference's keys.

Parity: pipeline and padded search return byte-identical top-k to a
direct search of any batch size. On the CPU the same plain torch ops run
per query row; on the card a query scored in one bucket may take another
scoring stage of the rows kernel than in another
(``kernels/rows_dot.py::pick_stage`` picks it from the batch size), and
every stage sums a dot in one order (``kernels/csrc/gaps.cuh``), so the
bytes are the same whatever stages a plan launched.

Threading (DESIGN.md §11): ``PlanCache`` creates plans under a lock and
runs every capture and replay of its plans under a second one (they
share one graph memory pool, and a replay overwrites its graph's static
buffers); a capture holds the process-wide ``CUDA_EXCLUSIVE`` lock,
which a thread that allocates or synchronises beside a serving thread
(the shard-staging worker, a mutable index's writers and merge worker)
takes too. A capture on such a thread runs in the ``"thread_local"``
capture mode (``SearchPlan.warm``), so the serving thread may replay,
allocate and copy while it runs. ``ResultCache`` and ``ServeStats``
guard their state; ``Pipeline`` holds one scheduler lock across
admission and dispatch. The wall clock is injectable (``clock=``) for
deadline tests.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import threading
import time
from collections import OrderedDict, deque
from functools import partial
from typing import TYPE_CHECKING, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..kernels import modes, rows_dot
from ..spans import count, span

if TYPE_CHECKING:  # import cycle: api.py imports this module at runtime
    from .api import Retriever

__all__ = [
    "DEFAULT_BUCKETS",
    "plan_buckets",
    "PlanKey",
    "SearchPlan",
    "PlanCache",
    "ResultCache",
    "ServeStats",
    "Pipeline",
    "quantized_query_key",
    "synthetic_trace",
]

#: default padding buckets — arbitrary batch sizes round up to the
#: smallest covering entry; power-of-two spacing bounds pad waste < 2×
DEFAULT_BUCKETS: Tuple[int, ...] = (1, 2, 4, 8, 16, 32, 64, 128)

#: held by every CUDA graph capture in this process, and by any other
#: thread around CUDA calls that a capture in the default (global) mode
#: forbids from every thread — allocation, pinned allocation, stream
#: creation, synchronisation, graph destruction (the shard-staging
#: worker's page-in copies; a mutable index's segment placement, merge
#: placement and prewarm, and the release of its retired parts).
#: Reentrant: a worker holds it across a whole prewarm, captures included
CUDA_EXCLUSIVE = threading.RLock()


@contextlib.contextmanager
def _no_cyclic_gc():
    """Python's cyclic collector off for the duration, in every thread:
    a collection during a capture can destroy an unreachable retriever's
    CUDA graphs, a call the capture forbids (it invalidates the capture).
    Garbage waits for the next collection."""
    was = gc.isenabled()
    gc.disable()
    try:
        yield
    finally:
        if was:
            gc.enable()


def plan_buckets(
    batch_size: Optional[int] = None,
    buckets: Optional[Sequence[int]] = None,
) -> Tuple[int, ...]:
    """The sorted bucket set: an explicit ``buckets`` sequence (used
    verbatim), or ``DEFAULT_BUCKETS`` extended by the
    ``RetrieverConfig.batch_size`` hint (the expected steady-state
    batch gets an exact-fit plan)."""
    if buckets is not None:
        out = set(buckets)
    else:
        out = set(DEFAULT_BUCKETS)
        if batch_size is not None:
            out.add(int(batch_size))
    if not out or any(
        not isinstance(b, (int, np.integer)) or isinstance(b, bool) or b < 1
        for b in out
    ):
        raise ValueError(
            f"buckets must be a non-empty set of positive ints, got "
            f"{sorted(out)}"
        )
    return tuple(sorted(int(b) for b in out))


def synthetic_trace(
    rng: np.random.Generator,
    n_requests: int,
    n_queries: int,
    repeat_frac: float = 0.25,
) -> np.ndarray:
    """Repeat-heavy query-id trace, the load generator's workload:
    ``repeat_frac`` of requests re-ask one of a small head
    (``n_queries // 4`` hot queries), the rest draw uniformly. Returns
    i64 [n_requests] query indices, the reference's for the same
    generator state."""
    n_head = max(1, n_queries // 4)
    return np.where(
        rng.random(n_requests) < repeat_frac,
        rng.integers(0, n_head, size=n_requests),
        rng.integers(0, n_queries, size=n_requests),
    )


# ---------------------------------------------------------------------------
# plan cache — the capture layer
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class PlanKey:
    """Identity of one search plan. ``mode`` is the resolved port
    backend (``"torch"`` or ``"cuda"``, ``kernels/modes.py``); ``shard``
    is ``""`` for a monolithic index, ``"<s>/<S>"`` for shard ``s`` of a
    sharded one, ``"*/<S>"`` for the sharded retriever's fan-out plan,
    ``"mut"`` for a mutable index's fan-out plan and ``"mut:<part>"``
    for its parts' plans; ``gen`` is ``"g<N>"`` on the mutable fan-out
    plan (generation ``N``: a merge's flip retires the plan) and ``""``
    elsewhere; ``vq`` is the value codec."""

    engine: str
    codec: str
    backend: str
    mode: str
    k: int
    bucket: int
    shard: str = ""
    gen: str = ""
    vq: str = "f16"


def _captured() -> Dict[str, Dict[str, int]]:
    """The rows kernel's launches recorded into CUDA graphs so far, per
    variant and per stage."""
    return {"variants": dict(rows_dot.captured_variant_launches),
            "stages": dict(rows_dot.captured_stage_launches)}


class SearchPlan:
    """One plan: pad a ``[n ≤ bucket, dim]`` query batch to the bucket,
    run the engine's ``search_batch``, slice the padding off.

    On a CUDA device, ``warm(dim)`` captures the search as one CUDA
    graph on a static ``[bucket, dim]`` buffer, after an eager warm-up on
    a side stream (which also builds and loads the kernels' libraries);
    a call copies its ``n`` rows into the buffer, zeroes the rest, replays
    and returns copies of the first ``n`` rows of the static outputs —
    never views of them. A capture that fails raises: the plan never runs
    eagerly in its place. ``launches`` records the rows-kernel launches
    the graph holds (``{"variants": {name: n}, "stages": {stage: n}}``),
    each run at every replay; ``replays`` counts replays, ``pool_bytes``
    the graph memory the capture reserved and ``capture_s`` its seconds.
    A call's host stages are the spans (``spans.py``)
    ``repro_torch.plan.copy_in``, ``plan.replay`` and ``plan.copy_out``
    (``plan.eager`` on the CPU); a capture is ``plan.capture`` and counts
    in ``spans.counters["plan.captures"]``.

    ``lock`` (held across a capture and across each call's copy-in,
    replay and copy-out) and ``pool`` (the graph memory pool) are shared
    by every plan of one ``PlanCache``. On the CPU a call runs the engine
    eagerly on the padded batch."""

    __slots__ = ("key", "_fn", "_device", "_lock", "_pool", "_graph", "_Q", "_out",
                 "launches", "replays", "pool_bytes", "capture_s")

    def __init__(self, key: PlanKey, fn: Callable, device: torch.device, lock, pool):
        self.key = key
        self._fn = fn
        self._device = device
        self._lock = lock
        self._pool = pool
        self._graph: Optional[torch.cuda.CUDAGraph] = None
        self._Q: Optional[torch.Tensor] = None
        self._out: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
        self.launches: dict = {"variants": {}, "stages": {}}
        self.replays = 0
        self.pool_bytes = 0
        self.capture_s = 0.0

    @property
    def stages(self) -> frozenset:
        """The rows-kernel stages the captured graph launches."""
        return frozenset(self.launches["stages"])

    def warm(self, dim: int, capture_error_mode: str = "global") -> bool:
        """Capture this plan's graph for ``[bucket, dim]`` batches.
        Idempotent; returns True iff a capture happened (never on the
        CPU, where there is nothing to capture). A thread other than the
        serving thread captures in ``"thread_local"`` mode, holding
        ``CUDA_EXCLUSIVE`` across the whole call (the mutable index's
        merge worker): the serving thread's replays, allocations and
        copies then neither wait nor invalidate the capture."""
        if self._device.type != "cuda":
            return False
        with self._lock:
            if self._graph is not None:
                return False
            self._capture(int(dim), capture_error_mode)
            return True

    @torch.inference_mode()
    def _capture(self, dim: int, capture_error_mode: str = "global") -> None:
        dev = self._device
        with span("repro_torch.plan.capture"), torch.cuda.device(dev):
            Q = torch.zeros((self.key.bucket, dim), dtype=torch.float32, device=dev)
            side = torch.cuda.Stream(dev)
            side.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(side):
                self._fn(Q)  # eager warm-up: libraries loaded, workspaces sized
            torch.cuda.current_stream(dev).wait_stream(side)
            with CUDA_EXCLUSIVE:
                torch.cuda.synchronize(dev)
                torch.cuda.empty_cache()  # what torch.cuda.graph does on entry, counted before
                reserved = torch.cuda.memory_reserved(dev)
                before = _captured()
                graph = torch.cuda.CUDAGraph()
                caller = torch.cuda.current_stream(dev)
                t0 = time.perf_counter()
                try:
                    with _no_cyclic_gc(), torch.cuda.graph(
                            graph, pool=self._pool, stream=side,
                            capture_error_mode=capture_error_mode):
                        out = self._fn(Q)
                except RuntimeError as e:
                    # a failed capture_end leaves the capture stream current
                    torch.cuda.set_stream(caller)
                    raise RuntimeError(
                        f"CUDA graph capture of plan {self.key} failed (an op in the engine's "
                        f"search_batch synchronises with the host or is not capturable): {e}"
                    ) from e
                self.capture_s = time.perf_counter() - t0
                self.pool_bytes = torch.cuda.memory_reserved(dev) - reserved
            self.launches = {
                part: {k: n - before[part][k] for k, n in now.items() if n > before[part][k]}
                for part, now in _captured().items()
            }
            self._Q, self._out, self._graph = Q, out, graph
        count("plan.captures")

    @torch.inference_mode()
    def __call__(self, Q) -> Tuple[torch.Tensor, torch.Tensor]:
        Q = torch.as_tensor(Q, dtype=torch.float32)
        n, bucket = Q.shape[0], self.key.bucket
        if n > bucket:
            raise ValueError(f"batch of {n} exceeds plan bucket {bucket}")
        if self._device.type != "cuda":
            with span("repro_torch.plan.eager"):
                Q = Q.to(self._device)
                if n < bucket:
                    Q = torch.cat([Q, Q.new_zeros((bucket - n, Q.shape[1]))])
                ids, scores = self._fn(Q)
                return ids[:n], scores[:n]
        with self._lock:
            if self._graph is None:
                self._capture(Q.shape[1])
            with torch.cuda.device(self._device):
                with span("repro_torch.plan.copy_in"):
                    self._Q[:n].copy_(Q)
                    self._Q[n:].zero_()  # stale rows of an earlier call never leak in
                with span("repro_torch.plan.replay"):
                    self._graph.replay()
                self.replays += 1
                with span("repro_torch.plan.copy_out"):
                    ids, scores = self._out
                    return ids[:n].clone(), scores[:n].clone()


class FacadePlan:
    """A plan that runs by executing: ``fn`` takes the padded ``[bucket,
    dim]`` batch and returns ``(ids, scores, ran)``, where ``ran`` lists
    a ``(label, launches, stages)`` record of each plan the batch ran
    through (a sharded retriever's per-shard plans; records, not the
    plans, so an evicted shard's graphs are not kept alive). It is never
    captured, by design: its work admits shards, copies them to the
    device and replays other plans' graphs. ``warm`` returns False (the
    reference's facade contract; ``Pipeline.warm`` executes a zero query
    through it instead). After each call ``launches`` sums the
    sub-plans' records and ``stages`` holds ``(label, stage)`` pairs, so
    two buckets compare equal only where every sub-plan took the same
    stages; ``replays`` counts calls."""

    __slots__ = ("key", "_fn", "launches", "stages", "replays")

    def __init__(self, key: PlanKey, fn: Callable):
        self.key = key
        self._fn = fn
        self.launches: dict = {"variants": {}, "stages": {}}
        self.stages: frozenset = frozenset()
        self.replays = 0

    def warm(self, dim: int) -> bool:
        return False

    @torch.inference_mode()
    def __call__(self, Q) -> Tuple[torch.Tensor, torch.Tensor]:
        Q = torch.as_tensor(Q, dtype=torch.float32)
        n, bucket = Q.shape[0], self.key.bucket
        if n > bucket:
            raise ValueError(f"batch of {n} exceeds plan bucket {bucket}")
        if n < bucket:
            Q = torch.cat([Q, Q.new_zeros((bucket - n, Q.shape[1]))])
        ids, scores, ran = self._fn(Q)
        launches: dict = {"variants": {}, "stages": {}}
        for _, record, _ in ran:
            for part, counts in record.items():
                for name, c in counts.items():
                    launches[part][name] = launches[part].get(name, 0) + c
        self.launches = launches
        self.stages = frozenset((label, st) for label, _, stages in ran for st in stages)
        self.replays += 1
        return ids[:n], scores[:n]


class PlanCache:
    """The plans of ONE retriever, keyed by padding bucket.

    Holds the engine's ``search_batch`` bound to the retriever's arrays
    and hands out ``SearchPlan``s per bucket. ``compiles`` counts plan
    creations — the serving metrics' recompile counter. A batch beyond
    the largest bucket rounds up to the next power of two; that plan is
    cached but the configured bucket set stays fixed. On the card every
    plan of one cache captures into one graph memory pool, and its
    captures and replays run one at a time under one lock."""

    def __init__(self, retriever: "Retriever", buckets: Optional[Sequence[int]] = None):
        cfg = retriever.cfg
        self.buckets = plan_buckets(cfg.batch_size, buckets)
        self.k = cfg.k
        self.device = retriever.device
        self._key = partial(
            PlanKey, cfg.engine, cfg.codec, cfg.backend, modes.check_backend(cfg.backend),
            cfg.k, shard=getattr(retriever, "shard", ""), vq=cfg.vq,
        )
        self._dispatch = partial(
            retriever.impl.search_batch,
            cfg,
            retriever.n_docs,
            retriever.value_scale,
            retriever.arrays,
        )
        self._plans: Dict[int, SearchPlan] = {}
        self.compiles = 0
        self._lock = threading.Lock()
        self._run_lock = threading.RLock()
        self._pool = torch.cuda.graph_pool_handle() if self.device.type == "cuda" else None

    def bucket_for(self, n: int) -> int:
        """Smallest covering bucket; beyond the largest, the next power
        of two (one dispatch, never a silent truncation)."""
        if n < 1:
            raise ValueError(f"batch size must be ≥ 1, got {n}")
        for b in self.buckets:
            if b >= n:
                return b
        return 1 << (n - 1).bit_length()

    def get(self, bucket: int) -> SearchPlan:
        """The plan for ``bucket``, created on first request (captured
        at its first call or ``warm``). Thread-safe: concurrent first
        requests for one bucket create one plan."""
        with self._lock:
            plan = self._plans.get(bucket)
            if plan is None:
                plan = SearchPlan(self._key(bucket=bucket), self._dispatch, self.device,
                                  self._run_lock, self._pool)
                self._plans[bucket] = plan
                self.compiles += 1
            return plan

    def created(self) -> Dict[int, SearchPlan]:
        """Every plan created so far, by bucket."""
        with self._lock:
            return dict(sorted(self._plans.items()))

    def search(self, Q) -> Tuple[torch.Tensor, torch.Tensor]:
        """Pad ``Q`` to its covering bucket and run the plan. An empty
        batch short-circuits to empty ``(0, k)`` results."""
        if Q.shape[0] == 0:
            return (torch.zeros((0, self.k), dtype=torch.int32, device=self.device),
                    torch.zeros((0, self.k), dtype=torch.float32, device=self.device))
        return self.get(self.bucket_for(Q.shape[0]))(Q)


# ---------------------------------------------------------------------------
# result cache — quantized-query LRU
# ---------------------------------------------------------------------------


def quantized_query_key(q, value_dtype=np.float16) -> bytes:
    """Cache key of one dense query: the *quantized sparse* form —
    nonzero component ids + values rounded to ``value_dtype``, the
    reference's bytes. Sub-f32 keying is a deliberate tolerance (two
    queries within one f16 ulp per component share an entry), which is
    why ``Pipeline`` keys in f16 only over an f16-valued index."""
    qv = np.asarray(q, dtype=value_dtype)
    nz = np.flatnonzero(qv).astype(np.int32)
    return nz.tobytes() + qv[nz].tobytes()


class ResultCache:
    """Bounded LRU of per-query top-k results.

    Values are the ``(ids [k], scores [k])`` numpy pair exactly as
    served, stored as read-only COPIES: a caller mutating what it was
    handed never corrupts a later replay. ``capacity=0`` disables
    caching. ``invalidate()`` flushes every entry; ``epoch`` tags the
    index state the entries belong to; ``invalidations`` /
    ``invalidated_entries`` count flushes and the entries they dropped."""

    def __init__(self, capacity: int = 1024):
        if capacity < 0:
            raise ValueError(f"capacity must be ≥ 0, got {capacity}")
        self.capacity = int(capacity)
        self._items: "OrderedDict[bytes, Tuple[np.ndarray, np.ndarray]]" = OrderedDict()
        self.hits = 0
        self.lookups = 0
        #: index epoch the current entries were computed against
        self.epoch: int = 0
        self.invalidations = 0
        self.invalidated_entries = 0
        self._lock = threading.RLock()

    def __len__(self) -> int:
        with self._lock:
            return len(self._items)

    def get(self, key: bytes) -> Optional[Tuple[np.ndarray, np.ndarray]]:
        with self._lock:
            self.lookups += 1
            got = self._items.get(key)
            if got is None:
                return None
            self._items.move_to_end(key)
            self.hits += 1
            return got

    def put(self, key: bytes, ids: np.ndarray, scores: np.ndarray) -> None:
        if self.capacity == 0:
            return
        ids, scores = np.array(ids), np.array(scores)  # own the memory
        ids.flags.writeable = scores.flags.writeable = False
        with self._lock:
            self._items[key] = (ids, scores)
            self._items.move_to_end(key)
            while len(self._items) > self.capacity:
                self._items.popitem(last=False)

    def invalidate(self, epoch: Optional[int] = None) -> int:
        """Flush every entry; returns how many were dropped. ``epoch``
        (when given) records the index epoch the cache is now current
        for. An empty flush still counts as an invalidation."""
        with self._lock:
            n = len(self._items)
            self._items.clear()
            self.invalidations += 1
            self.invalidated_entries += n
            if epoch is not None:
                self.epoch = int(epoch)
            return n

    @property
    def hit_rate(self) -> float:
        return self.hits / self.lookups if self.lookups else 0.0


# ---------------------------------------------------------------------------
# serving metrics
# ---------------------------------------------------------------------------


class ServeStats:
    """The pipeline metrics block (DESIGN.md §8 metrics contract).

    Latency samples are end-to-end per query (submit → result), in µs
    under the pipeline's clock, kept in a sliding window of ``window``.
    ``snapshot()`` returns the reference's flat dict: qps, p50/p95/p99_us,
    cache_hit_rate, cache_invalidations, cache_invalidated_entries,
    n_queries, dispatches and bucket_occupancy per bucket, recompiles,
    and the overlap counters (the prefetch ones from a sharded retriever
    or a mutable index's sharded base; the merge ones from a mutable
    index: Σ merge wall-clock and Σ the flip's critical section)."""

    def __init__(self, clock: Callable[[], float], window: int = 8192):
        self._clock = clock
        self.t_start = clock()
        self.n_queries = 0  # completed (cache hits included)
        self.latencies_us = deque(maxlen=window)
        self.dispatches: Dict[int, int] = {}  # bucket → dispatch count
        self.occupancy: Dict[int, int] = {}  # bucket → Σ real queries
        self.prefetch_hits = 0
        self.prefetch_misses = 0
        self.merge_wall_us = 0.0
        self.blocked_swap_us = 0.0
        self._lock = threading.RLock()

    def reset_clock(self) -> None:
        """Restart the QPS clock (after ``Pipeline.warm``, so capture
        time does not dilute the measured trace)."""
        with self._lock:
            self.t_start = self._clock()

    def record_dispatch(self, bucket: int, n_real: int) -> None:
        with self._lock:
            self.dispatches[bucket] = self.dispatches.get(bucket, 0) + 1
            self.occupancy[bucket] = self.occupancy.get(bucket, 0) + n_real

    def record_query(self, latency_us: float) -> None:
        with self._lock:
            self.n_queries += 1
            self.latencies_us.append(latency_us)

    def percentile(self, p: float) -> float:
        with self._lock:
            if not self.latencies_us:
                return float("nan")
            samples = np.asarray(list(self.latencies_us))
        return float(np.percentile(samples, p))

    def sync_overlap(self, retriever) -> None:
        """Pull the overlap counters off the serving stack; a retriever
        without the attributes contributes zero."""
        srcs = [retriever, getattr(retriever, "base", None)]
        srcs = [r for r in srcs if r is not None]
        with self._lock:
            self.prefetch_hits = sum(int(getattr(r, "prefetch_hits", 0)) for r in srcs)
            self.prefetch_misses = sum(int(getattr(r, "prefetch_misses", 0)) for r in srcs)
            self.merge_wall_us = sum(float(getattr(r, "merge_wall_us", 0.0)) for r in srcs)
            self.blocked_swap_us = sum(float(getattr(r, "blocked_swap_us", 0.0)) for r in srcs)

    def snapshot(self, cache: Optional[ResultCache] = None,
                 plans: Optional[PlanCache] = None) -> dict:
        with self._lock:
            elapsed = max(self._clock() - self.t_start, 1e-9)
            dispatches = dict(sorted(self.dispatches.items()))
            occ = {b: self.occupancy[b] / (b * dispatches[b]) for b in dispatches}
            overlap = {
                "prefetch_hits": self.prefetch_hits,
                "prefetch_misses": self.prefetch_misses,
                "merge_wall_us": self.merge_wall_us,
                "blocked_swap_us": self.blocked_swap_us,
            }
            n_queries = self.n_queries
        return {
            "n_queries": n_queries,
            "qps": n_queries / elapsed,
            "p50_us": self.percentile(50),
            "p95_us": self.percentile(95),
            "p99_us": self.percentile(99),
            "cache_hit_rate": cache.hit_rate if cache is not None else 0.0,
            "cache_invalidations": cache.invalidations if cache is not None else 0,
            "cache_invalidated_entries": (
                cache.invalidated_entries if cache is not None else 0
            ),
            "dispatches": dispatches,
            "bucket_occupancy": occ,
            "recompiles": plans.compiles if plans is not None else 0,
            **overlap,
        }

    @staticmethod
    def summary(snap: dict) -> str:
        occ = " ".join(
            f"b{b}×{snap['dispatches'][b]}@{snap['bucket_occupancy'][b]:.0%}"
            for b in snap["dispatches"]
        )
        out = (
            f"served={snap['n_queries']} qps={snap['qps']:.0f} "
            f"p50={snap['p50_us']:.0f}µs p95={snap['p95_us']:.0f}µs "
            f"p99={snap['p99_us']:.0f}µs hit_rate={snap['cache_hit_rate']:.0%} "
            f"invalidations={snap.get('cache_invalidations', 0)} "
            f"recompiles={snap['recompiles']} buckets[{occ}]"
        )
        pf = snap.get("prefetch_hits", 0) + snap.get("prefetch_misses", 0)
        if pf:
            out += f" prefetch={snap['prefetch_hits']}h/{snap['prefetch_misses']}m"
        if snap.get("merge_wall_us", 0.0):
            out += (f" merge_wall={snap['merge_wall_us'] / 1e3:.0f}ms"
                    f" blocked_swap={snap['blocked_swap_us']:.0f}µs")
        return out


# ---------------------------------------------------------------------------
# micro-batching scheduler
# ---------------------------------------------------------------------------


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


class PendingQuery:
    """Ticket returned by ``Pipeline.submit``; ``result()`` flushes the
    owning pipeline if the query is still queued. ``bucket`` is the
    bucket it was dispatched in and ``stages`` the rows-kernel stages
    that dispatch's plan took (None for a cache hit)."""

    __slots__ = ("q", "key", "t_submit", "done", "ids", "scores", "from_cache", "bucket",
                 "stages", "_pipeline")

    def __init__(self, pipeline: "Pipeline", q: np.ndarray, key: bytes, t_submit: float):
        self._pipeline = pipeline
        self.q = q
        self.key = key
        self.t_submit = t_submit
        self.done = False
        self.from_cache = False
        self.bucket: Optional[int] = None
        self.stages: Optional[frozenset] = None
        self.ids: Optional[np.ndarray] = None
        self.scores: Optional[np.ndarray] = None

    def result(self) -> Tuple[np.ndarray, np.ndarray]:
        if not self.done:
            self._pipeline.flush()
        if not self.done:
            raise RuntimeError("flush() left a queued ticket incomplete")
        return self.ids, self.scores

    def _complete(self, ids: np.ndarray, scores: np.ndarray, now: float,
                  stats: ServeStats) -> None:
        self.ids, self.scores = ids, scores
        self.done = True
        stats.record_query(1e6 * (now - self.t_submit))


class Pipeline:
    """Host-side micro-batching scheduler over one ``Retriever``:
    ``submit`` (cache lookup, else enqueue; a queue at the largest
    bucket dispatches at once), ``poll`` (fires the deadline of the
    oldest queued query), ``flush`` (dispatches everything queued) and
    ``search_batch`` (submit every row, flush, results in submission
    order). The plan cache is the retriever's own unless ``buckets`` is
    given."""

    def __init__(
        self,
        retriever: "Retriever",
        *,
        buckets: Optional[Sequence[int]] = None,
        deadline_us: float = 1000.0,
        cache_size: int = 1024,
        key_dtype=None,
        clock: Callable[[], float] = time.perf_counter,
    ):
        if deadline_us < 0:
            raise ValueError(f"deadline_us must be ≥ 0, got {deadline_us}")
        self.retriever = retriever
        self.plans = retriever.plans if buckets is None else retriever.make_plans(buckets)
        self.deadline_us = float(deadline_us)
        self.cache = ResultCache(cache_size)
        if key_dtype is None:
            # the cache's tolerance follows the index's own value
            # quantization: f16 keys for f16-valued rows, else exact
            key_dtype = (
                np.float16
                if getattr(retriever, "value_format", None) == "f16"
                else np.float32
            )
        self.key_dtype = key_dtype
        self._clock = clock
        self.stats = ServeStats(clock)
        self._queue: List[PendingQuery] = []
        # one scheduler lock across admission + dispatch; RLock because
        # submit → _dispatch re-enters
        self._lock = threading.RLock()

    # -- warmup ---------------------------------------------------------
    def warm(self) -> int:
        """Create (and on the card capture) every configured bucket's
        plan, so capture cost stays out of a measured trace; a facade
        plan is warmed by running one zero query through it, outside the
        stats and the result cache, which creates and captures the plan
        of that bucket in every part it fans out to (each shard, or a
        mutable index's base and every delta segment). Restarts the QPS
        clock. Returns the number of plans it created."""
        dim = int(self.retriever.dim)
        before = self.plans.compiles
        for b in self.plans.buckets:
            plan = self.plans.get(b)
            if isinstance(plan, FacadePlan):
                plan(torch.zeros((1, dim), dtype=torch.float32))
            else:
                plan.warm(dim)
        self.stats.reset_clock()
        return self.plans.compiles - before

    # -- admission ------------------------------------------------------
    def submit(self, q) -> PendingQuery:
        q = _host(q).astype(np.float32, copy=False)
        now = self._clock()
        with self._lock:
            ep = getattr(self.retriever, "epoch", None)
            if ep is not None and ep != self.cache.epoch:
                self.cache.invalidate(epoch=ep)
            caching = self.cache.capacity > 0
            key = quantized_query_key(q, self.key_dtype) if caching else b""
            ticket = PendingQuery(self, q, key, now)
            if caching:
                hit = self.cache.get(ticket.key)
                if hit is not None:
                    ticket.from_cache = True
                    ticket._complete(hit[0], hit[1], self._clock(), self.stats)
                    return ticket
            self._queue.append(ticket)
            if len(self._queue) >= self.plans.buckets[-1]:
                self._dispatch()
            return ticket

    # -- scheduling -----------------------------------------------------
    def poll(self) -> int:
        """Fire the deadline if the oldest queued query has expired;
        returns how many queries were dispatched."""
        with self._lock:
            if not self._queue:
                return 0
            waited_us = 1e6 * (self._clock() - self._queue[0].t_submit)
            if waited_us >= self.deadline_us:
                return self._dispatch()
            return 0

    def flush(self) -> int:
        """Dispatch every queued query (possibly several buckets)."""
        with self._lock:
            n = 0
            while self._queue:
                n += self._dispatch()
            return n

    def _dispatch(self) -> int:
        """Coalesce the queue head into its smallest covering bucket, run
        the plan, bring the results to the host once, de-multiplex per
        query, feed the cache. Callers hold ``_lock``."""
        if not self._queue:
            return 0
        cap = self.plans.buckets[-1]
        batch, self._queue = self._queue[:cap], self._queue[cap:]
        bucket = self.plans.bucket_for(len(batch))
        Q = np.stack([t.q for t in batch])
        plan = self.plans.get(bucket)
        ids, scores = plan(Q)
        stages = plan.stages  # a fan-out plan's: this call's
        ids, scores = ids.cpu().numpy(), scores.cpu().numpy()
        ids.flags.writeable = scores.flags.writeable = False
        now = self._clock()
        self.stats.record_dispatch(bucket, len(batch))
        caching = self.cache.capacity > 0
        for i, t in enumerate(batch):
            t.bucket, t.stages = bucket, stages
            t._complete(ids[i], scores[i], now, self.stats)
            if caching:
                self.cache.put(t.key, ids[i], scores[i])
        return len(batch)

    # -- synchronous convenience surface --------------------------------
    def search_batch(self, Q) -> Tuple[np.ndarray, np.ndarray]:
        """Serve a whole query batch through the scheduler: host results
        stacked in submission order."""
        Q = _host(Q)
        if Q.shape[0] == 0:
            k = self.retriever.cfg.k
            return np.zeros((0, k), np.int32), np.zeros((0, k), np.float32)
        tickets = [self.submit(q) for q in Q]
        self.flush()
        ids = np.stack([t.ids for t in tickets])
        scores = np.stack([t.scores for t in tickets])
        return ids, scores

    def snapshot(self) -> dict:
        self.stats.sync_overlap(self.retriever)
        return self.stats.snapshot(cache=self.cache, plans=self.plans)
