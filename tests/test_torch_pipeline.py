"""The port's online serving pipeline (``repro_torch/serve/pipeline.py``)
on the CPU: every invariant of ``tests/test_pipeline.py`` for the port,
as the same cases on the reference's fixture (240 docs, dim 1024, 7
queries, k 5), and the port held against the reference — the cache key
bytes, the synthetic trace, the bucket set, the snapshot's keys and the
pipeline's top-k on the same artifact.

Scheduler semantics run under an injected fake clock, so nothing here
sleeps. On the CPU a plan runs the engine eagerly on the padded batch
(``backend="cuda"`` reaches the rows kernel's plain version), so every
bucket returns the same bytes; the card's plans are CUDA graphs, held in
``tests/test_torch_gpu.py``."""

import jax.numpy as jnp  # noqa: F401  (the reference runs on jax's CPU backend)
import numpy as np
import pytest
import torch

from repro.data import synthetic as ref_synthetic
from repro.serve import api as ref_api
from repro.serve import pipeline as ref_pipeline
from repro_torch.core.layout import available_layouts
from repro_torch.data.synthetic import SyntheticConfig, generate_collection
from repro_torch.serve import pipeline as port_pipeline
from repro_torch.serve.api import Retriever, RetrieverConfig, get_engine, open_retriever
from repro_torch.serve.pipeline import (
    DEFAULT_BUCKETS,
    Pipeline,
    ResultCache,
    plan_buckets,
    quantized_query_key,
    synthetic_trace,
)
from torch_cases import one_intra_op_thread  # noqa: F401  (autouse)

#: per-engine knobs sized for the tiny test collection (the reference's)
ENGINE_PARAMS = {
    "seismic": dict(cut=8, block_budget=128, n_probe=24, n_postings=200, block_size=16),
    "hnsw": dict(beam=16, iters=16, n_seeds=4, m=8, ef_construction=24),
    "flat": {},
}
COLLECTION = dict(name="pipe", dim=1024, n_docs=240, n_queries=7, doc_nnz_mean=35.0,
                  query_nnz_mean=10.0, seed=3)
# ids are compared exactly; scores sum the same f32 products in another order
RTOL, ATOL = 1e-5, 1e-4


class FakeClock:
    """Deterministic injectable clock (seconds)."""

    def __init__(self):
        self.t = 0.0

    def __call__(self) -> float:
        return self.t

    def advance_us(self, us: float) -> None:
        self.t += us * 1e-6


@pytest.fixture(scope="module")
def collection():
    return generate_collection(SyntheticConfig(**COLLECTION), value_format="f16")


@pytest.fixture(scope="module")
def queries(collection):
    return np.stack([collection.query_dense(i) for i in range(collection.n_queries)])


@pytest.fixture(scope="module")
def host_indexes(collection):
    out = {}
    for name in ("seismic", "hnsw"):
        cfg = RetrieverConfig(engine=name, params=ENGINE_PARAMS[name])
        out[name] = get_engine(name).host_index(collection.fwd, cfg)
    return out


def _retriever(collection, host_indexes, engine, codec, backend="torch", **kw):
    cfg = RetrieverConfig(engine=engine, codec=codec, k=5, backend=backend,
                          params=ENGINE_PARAMS[engine], **kw)
    if engine in host_indexes:
        return Retriever.from_host_index(host_indexes[engine], cfg, device="cpu")
    return Retriever.build(collection.fwd, cfg, device="cpu")


# ---------------------------------------------------------------------------
# pipeline ≡ direct search, all combinations
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("backend", ["torch", "cuda"])
@pytest.mark.parametrize("codec", available_layouts())
@pytest.mark.parametrize("engine", ["seismic", "hnsw", "flat"])
def test_pipeline_matches_direct_search(collection, queries, host_indexes, engine, codec,
                                        backend):
    """Bucketed/padded scheduler dispatch — and a cache-hit replay —
    return byte-identical top-k ids and scores to direct search, for
    every engine × codec × backend."""
    r = _retriever(collection, host_indexes, engine, codec, backend)
    ids_d, sc_d = r.search(queries)  # direct: pads 7 → bucket 8
    ids_p, sc_p = r.search_batch(queries)  # pipeline: same plan, queued
    assert np.array_equal(ids_d.numpy(), ids_p)
    assert np.array_equal(sc_d.numpy(), sc_p)
    ids_c, sc_c = r.search_batch(queries)  # every query now a cache hit
    assert np.array_equal(ids_p, ids_c)
    assert np.array_equal(sc_p, sc_c)
    snap = r.pipeline().snapshot()
    assert snap["cache_hit_rate"] == pytest.approx(0.5)
    assert snap["n_queries"] == 2 * collection.n_queries


def test_ragged_batches_and_custom_buckets(collection, queries, host_indexes):
    """A 7-query stream over buckets (2, 4) coalesces into a full
    4-bucket plus a ragged 3-in-4 final batch — the bytes of a direct
    search padded to 8."""
    r = _retriever(collection, host_indexes, "flat", "streamvbyte")
    ids_d, sc_d = r.search(queries)
    pipe = Pipeline(r, buckets=(2, 4), cache_size=0)
    ids_p, sc_p = pipe.search_batch(queries)
    assert np.array_equal(ids_d.numpy(), ids_p)
    assert np.array_equal(sc_d.numpy(), sc_p)
    snap = pipe.snapshot()
    assert snap["dispatches"] == {4: 2}  # 4 full + 3 padded to 4
    assert snap["bucket_occupancy"][4] == pytest.approx(7 / 8)


def test_batch_beyond_largest_bucket(collection, queries, host_indexes):
    """Streams longer than the largest bucket split across dispatches
    (scheduler) or round up to a power-of-two plan (direct search), with
    the same results either way."""
    r = _retriever(collection, host_indexes, "flat", "dotvbyte")
    Q = np.concatenate([queries, queries[:3]])  # 10 queries
    ids_d, sc_d = r.search(Q)
    pipe = Pipeline(r, buckets=(4,), cache_size=0)
    ids_p, sc_p = pipe.search_batch(Q)
    assert np.array_equal(ids_d.numpy(), ids_p)
    assert np.array_equal(sc_d.numpy(), sc_p)
    assert pipe.snapshot()["dispatches"] == {4: 3}


# ---------------------------------------------------------------------------
# scheduler semantics (fake clock — no sleeping)
# ---------------------------------------------------------------------------


def test_deadline_fires_undersized_batch(collection, queries, host_indexes):
    clock = FakeClock()
    r = _retriever(collection, host_indexes, "flat", "uncompressed")
    pipe = Pipeline(r, buckets=(8,), deadline_us=1000.0, cache_size=0, clock=clock)
    t0 = pipe.submit(queries[0])
    t1 = pipe.submit(queries[1])
    assert not t0.done and pipe.poll() == 0  # deadline not reached
    clock.advance_us(999.0)
    assert pipe.poll() == 0
    clock.advance_us(2.0)  # oldest query now past its deadline
    assert pipe.poll() == 2
    assert t0.done and t1.done and t0.bucket == t1.bucket == 8
    ids_d, _ = r.search(queries[:2])
    assert np.array_equal(ids_d.numpy()[0], t0.ids)
    assert np.array_equal(ids_d.numpy()[1], t1.ids)
    assert pipe.snapshot()["dispatches"] == {8: 1}
    # end-to-end latency saw the deadline wait
    assert pipe.stats.percentile(50) >= 1000.0


def test_full_bucket_dispatches_immediately(collection, queries, host_indexes):
    clock = FakeClock()
    r = _retriever(collection, host_indexes, "flat", "uncompressed")
    pipe = Pipeline(r, buckets=(1, 2, 4), deadline_us=1e9, cache_size=0, clock=clock)
    tickets = [pipe.submit(q) for q in queries[:4]]
    assert all(t.done for t in tickets)  # queue hit the largest bucket
    assert pipe.snapshot()["dispatches"] == {4: 1}


def test_ticket_result_flushes(collection, queries, host_indexes):
    r = _retriever(collection, host_indexes, "flat", "uncompressed")
    pipe = Pipeline(r, buckets=(8,), deadline_us=1e9, cache_size=0)
    t = pipe.submit(queries[0])
    assert not t.done
    ids, scores = t.result()  # flushes, never deadlocks
    assert t.done and ids.shape == (5,) and scores.shape == (5,)


# ---------------------------------------------------------------------------
# result cache
# ---------------------------------------------------------------------------


def test_result_cache_lru_eviction_and_keys():
    c = ResultCache(capacity=2)
    ids = np.arange(3)
    k1, k2, k3 = b"a", b"b", b"c"
    c.put(k1, ids, ids)
    c.put(k2, ids, ids)
    assert c.get(k1) is not None  # k1 now most-recent
    c.put(k3, ids, ids)  # evicts k2 (LRU)
    assert c.get(k2) is None
    assert c.get(k1) is not None and c.get(k3) is not None
    assert len(c) == 2
    # quantized key: f16-identical queries share one entry, distinct ones do not
    q = np.zeros(64, np.float32)
    q[7], q[20] = 1.25, 3.5
    q_jitter = q.copy()
    q_jitter[q > 0] += 1e-5  # below f16 resolution at these magnitudes
    q_other = q.copy()
    q_other[20] = 3.75
    assert quantized_query_key(q) == quantized_query_key(q_jitter)
    assert quantized_query_key(q) != quantized_query_key(q_other)


def test_cache_replays_survive_caller_mutation(collection, queries, host_indexes):
    """Dispatched results are read-only host arrays, and the cache owns
    read-only copies: a caller scribbling on what it was handed cannot
    corrupt a later replay."""
    r = _retriever(collection, host_indexes, "flat", "uncompressed")
    pipe = Pipeline(r, buckets=(2,))
    t1 = pipe.submit(queries[0])
    t2 = pipe.submit(queries[1])  # fills bucket 2 → dispatched
    assert t2.done
    ref = t1.ids.copy()
    with pytest.raises(ValueError):  # dispatch view: immutable
        t1.ids[:] = -1
    t3 = pipe.submit(queries[0])  # cache hit
    assert t3.from_cache and t3.bucket is None
    assert np.array_equal(t3.ids, ref)
    assert t3.ids is not t1.ids  # the cache owns a copy, not a view
    with pytest.raises(ValueError):  # replayed arrays: immutable too
        t3.ids[:] = -1


def test_cache_key_dtype_matches_index_quantization(collection, host_indexes):
    """The default cache tolerance follows the index: f16 keys for an
    f16-valued index, with an exact override."""
    r = _retriever(collection, host_indexes, "flat", "uncompressed")
    assert Pipeline(r).key_dtype == np.float16  # f16 value_format
    assert Pipeline(r, key_dtype=np.float32).key_dtype == np.float32


def test_cache_disabled(collection, queries, host_indexes):
    r = _retriever(collection, host_indexes, "flat", "uncompressed")
    pipe = Pipeline(r, cache_size=0)
    pipe.search_batch(queries[:2])
    pipe.search_batch(queries[:2])
    snap = pipe.snapshot()
    assert snap["cache_hit_rate"] == 0.0
    assert len(pipe.cache) == 0


# ---------------------------------------------------------------------------
# plan cache + batch_size wiring
# ---------------------------------------------------------------------------


def test_plan_buckets_and_bucket_for(collection, host_indexes):
    assert plan_buckets() == DEFAULT_BUCKETS
    assert 24 in plan_buckets(24)
    # an explicit bucket sequence is used verbatim
    assert plan_buckets(128, buckets=(2, 4)) == (2, 4)
    with pytest.raises(ValueError, match="positive"):
        plan_buckets(buckets=(0, 4))
    with pytest.raises(ValueError, match="positive ints"):
        plan_buckets(buckets=(2.5, 8))
    with pytest.raises(ValueError, match="non-empty"):
        plan_buckets(buckets=())
    r = _retriever(collection, host_indexes, "flat", "uncompressed")
    assert r.plans.bucket_for(1) == 1
    assert r.plans.bucket_for(7) == 8
    assert r.plans.bucket_for(128) == 128
    assert r.plans.bucket_for(129) == 256  # beyond max → next pow2
    with pytest.raises(ValueError, match="≥ 1"):
        r.plans.bucket_for(0)


def test_oversized_search_keeps_bucket_set_stable(collection, queries, host_indexes):
    """A one-off beyond-the-largest batch gets an ad hoc plan but must
    not grow the configured bucket set (the scheduler's full-queue
    threshold)."""
    r = _retriever(collection, host_indexes, "flat", "uncompressed", batch_size=3)
    pipe = Pipeline(r, buckets=(2,), cache_size=0)
    r.search(np.repeat(queries, 1 + 2 // len(queries), axis=0)[:3])
    buckets_before = r.plans.buckets
    Qbig = np.repeat(queries, 20, axis=0)  # 140 > max bucket 128
    ids_d, _ = r.search(Qbig)
    assert ids_d.shape[0] == 140
    assert r.plans.buckets == buckets_before  # 256 plan cached, set unchanged
    assert 256 in r.plans.created()
    assert pipe.plans.buckets == (2,)


def test_empty_batch(collection, host_indexes):
    """Zero queries: empty (0, k) results from the direct and the
    scheduler path."""
    r = _retriever(collection, host_indexes, "flat", "uncompressed")
    ids, scores = r.search(np.zeros((0, collection.fwd.dim), np.float32))
    assert ids.shape == scores.shape == (0, 5)
    assert ids.dtype == torch.int32 and scores.dtype == torch.float32
    ids_p, scores_p = r.search_batch(np.zeros((0, collection.fwd.dim)))
    assert ids_p.shape == scores_p.shape == (0, 5)


def test_batch_size_hint_gets_exact_plan(collection, queries, host_indexes):
    """``RetrieverConfig.batch_size`` joins the bucket set, so the
    steady-state batch is served un-padded — with the padded bytes."""
    r = _retriever(collection, host_indexes, "flat", "streamvbyte", batch_size=7)
    assert 7 in r.plans.buckets
    assert r.plans.bucket_for(7) == 7
    ids_h, sc_h = r.search(queries)  # exact-fit plan
    r8 = _retriever(collection, host_indexes, "flat", "streamvbyte")
    ids_8, sc_8 = r8.search(queries)  # padded to bucket 8
    assert np.array_equal(ids_h.numpy(), ids_8.numpy())
    assert np.array_equal(sc_h.numpy(), sc_8.numpy())


@pytest.mark.parametrize("bad", [0, -3, 2.5, True, "8"])
def test_invalid_batch_size_rejected(collection, bad):
    with pytest.raises(ValueError, match="batch_size"):
        Retriever.build(collection.fwd, RetrieverConfig(engine="flat", batch_size=bad),
                        device="cpu")


def test_recompile_counting(collection, queries, host_indexes):
    """Every batch size within one bucket reuses one plan; a new bucket
    is one plan more."""
    r = _retriever(collection, host_indexes, "flat", "uncompressed")
    assert r.plans.compiles == 0
    r.search(queries[:5])  # bucket 8
    assert r.plans.compiles == 1
    r.search(queries[:7])  # same bucket
    r.search(queries[:6])
    assert r.plans.compiles == 1
    r.search(queries[:2])  # bucket 2 — one more plan
    assert r.plans.compiles == 2
    assert r.pipeline().snapshot()["recompiles"] == 2
    # a CPU plan captures nothing: warm is a no-op, the key names the backend
    plan = r.plans.get(8)
    assert plan.warm(collection.fwd.dim) is False and plan.replays == 0
    assert plan.key.mode == plan.key.backend == "torch" and plan.key.bucket == 8


def test_plan_cache_shared_between_search_and_pipeline(collection, queries, host_indexes):
    r = _retriever(collection, host_indexes, "flat", "uncompressed")
    r.search(queries)  # bucket 8's plan
    n = r.plans.compiles
    r.search_batch(queries)  # scheduler dispatch reuses it
    assert r.plans.compiles == n
    pipe = Pipeline(r, buckets=(2,))  # an explicit bucket set makes its own cache
    assert pipe.plans is not r.plans
    assert pipe.warm() == 1 and pipe.plans.compiles == 1


def test_oversized_batch_rejected_by_plan(collection, host_indexes, queries):
    r = _retriever(collection, host_indexes, "flat", "uncompressed")
    plan = r.plans.get(4)
    with pytest.raises(ValueError, match="exceeds plan bucket"):
        plan(queries)  # 7 queries into a 4-bucket plan


def test_concurrent_submitters_share_one_pipeline(collection, queries, host_indexes):
    """Threads submitting to, polling and flushing one pipeline at once
    (more threads than cores, a short switch interval): every ticket
    completes with the direct search's bytes, and the stats count every
    query once."""
    import sys
    import threading

    r = _retriever(collection, host_indexes, "flat", "dotvbyte")
    ids_d, sc_d = (t.numpy() for t in r.search(queries))
    pipe = Pipeline(r, buckets=(1, 2, 4), deadline_us=0.0, cache_size=4)
    n_threads, per_thread = 12, 14
    got, errors = [], []

    def worker(seed):
        try:
            rng = np.random.default_rng(seed)
            for qi in rng.integers(0, len(queries), per_thread):
                t = pipe.submit(queries[qi])
                if qi % 2:
                    pipe.poll()
                got.append((int(qi), t))
            pipe.flush()
        except Exception as e:  # noqa: BLE001  (re-raised below, in the test's thread)
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker, args=(i,)) for i in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert not errors, errors
    assert len(got) == n_threads * per_thread
    for qi, t in got:
        ids, scores = t.result()
        assert np.array_equal(ids, ids_d[qi]) and np.array_equal(scores, sc_d[qi])
    snap = pipe.snapshot()
    assert snap["n_queries"] == n_threads * per_thread
    assert sum(snap["dispatches"].values()) >= 1


# ---------------------------------------------------------------------------
# artifacts + metrics
# ---------------------------------------------------------------------------


def test_artifact_round_trips_batch_size(collection, host_indexes, tmp_path):
    r = _retriever(collection, host_indexes, "flat", "streamvbyte", batch_size=24)
    art = r.save(tmp_path / "bs")
    r2 = open_retriever(art, device="cpu")
    assert r2.cfg.batch_size == 24
    assert 24 in r2.plans.buckets


def test_stats_snapshot_contract(collection, queries, host_indexes):
    clock = FakeClock()
    r = _retriever(collection, host_indexes, "flat", "uncompressed")
    pipe = Pipeline(r, buckets=(4,), deadline_us=1e9, clock=clock)
    clock.advance_us(1e6)  # 1 s window
    pipe.search_batch(queries)  # 4 + 3-padded-to-4, then replay 2 hits
    pipe.search_batch(queries[:2])
    snap = pipe.snapshot()
    assert snap["n_queries"] == 9
    assert snap["qps"] == pytest.approx(9.0)  # clock frozen after 1 s
    assert snap["dispatches"] == {4: 2}
    assert snap["bucket_occupancy"][4] == pytest.approx(7 / 8)
    assert snap["cache_hit_rate"] == pytest.approx(2 / 9)
    assert snap["recompiles"] == 1
    for key in ("p50_us", "p95_us", "p99_us"):
        assert np.isfinite(snap[key])


# ---------------------------------------------------------------------------
# the port against the reference
# ---------------------------------------------------------------------------


def test_module_exports_the_reference_surface():
    assert port_pipeline.__all__ == ref_pipeline.__all__
    assert port_pipeline.DEFAULT_BUCKETS == ref_pipeline.DEFAULT_BUCKETS
    for batch_size, buckets in ((None, None), (24, None), (128, (2, 4)), (None, (9, 3, 3))):
        assert plan_buckets(batch_size, buckets) == ref_pipeline.plan_buckets(
            batch_size, buckets)
    assert [f.name for f in port_pipeline.dataclasses.fields(port_pipeline.PlanKey)] == [
        f.name for f in ref_pipeline.dataclasses.fields(ref_pipeline.PlanKey)]


@pytest.mark.parametrize("key_dtype", [np.float16, np.float32])
def test_quantized_query_key_bytes_equal_reference(queries, key_dtype):
    for q in queries:
        assert quantized_query_key(q, key_dtype) == ref_pipeline.quantized_query_key(
            q, key_dtype)
    assert quantized_query_key(np.zeros(16, np.float32)) == b""


@pytest.mark.parametrize("seed,n_requests,n_queries,repeat_frac", [
    (0, 256, 64, 0.25), (1, 32, 4, 0.25), (7, 100, 3, 0.9),
])
def test_synthetic_trace_equals_reference(seed, n_requests, n_queries, repeat_frac):
    got = synthetic_trace(np.random.default_rng(seed), n_requests, n_queries, repeat_frac)
    want = ref_pipeline.synthetic_trace(np.random.default_rng(seed), n_requests, n_queries,
                                        repeat_frac)
    assert got.dtype == want.dtype and np.array_equal(got, want)


def test_snapshot_keys_and_summary_equal_reference(collection, queries, host_indexes):
    """``snapshot()`` has the reference's keys in its order, and the
    summary line of one snapshot is the reference's."""
    clock = FakeClock()
    r = _retriever(collection, host_indexes, "flat", "uncompressed")
    pipe = Pipeline(r, buckets=(4,), deadline_us=1e9, clock=clock)
    clock.advance_us(1e6)
    pipe.search_batch(queries)
    pipe.search_batch(queries[:2])
    snap = pipe.snapshot()
    assert list(snap) == list(ref_pipeline.ServeStats(clock).snapshot())
    line = port_pipeline.ServeStats.summary(snap)
    assert line == ref_pipeline.ServeStats.summary(snap)
    assert "served=9 " in line and "buckets[b4×2@88%]" in line


@pytest.fixture(scope="module")
def reference_artifacts(tmp_path_factory):
    """The reference's host indexes over the byte-identical collection;
    one artifact per engine × codec is saved by the reference."""
    col = ref_synthetic.generate_collection(ref_synthetic.SyntheticConfig(**COLLECTION),
                                            value_format="f16")
    Q = np.stack([col.query_dense(i) for i in range(col.n_queries)])
    hosts = {}
    for name in ("seismic", "hnsw"):
        cfg = ref_api.RetrieverConfig(engine=name, params=ENGINE_PARAMS[name])
        hosts[name] = ref_api.get_engine(name).host_index(col.fwd, cfg)
    return col, Q, hosts, tmp_path_factory.mktemp("ref_pipeline")


@pytest.mark.parametrize("codec", available_layouts())
@pytest.mark.parametrize("engine", ["seismic", "hnsw", "flat"])
def test_search_batch_matches_reference_on_its_artifact(reference_artifacts, engine, codec):
    """The reference saves an index; the port opens it and serves the
    same queries through its pipeline: ids equal the reference
    pipeline's exactly, scores within the serving tolerance."""
    col, Q, hosts, root = reference_artifacts
    cfg = ref_api.RetrieverConfig(engine=engine, codec=codec, k=5, backend="jnp",
                                  params=ENGINE_PARAMS[engine])
    ref = (ref_api.Retriever.from_host_index(hosts[engine], cfg) if engine in hosts
           else ref_api.Retriever.build(col.fwd, cfg))
    want_ids, want_scores = ref.search_batch(Q)
    port = open_retriever(ref.save(root / f"{engine}-{codec}"), device="cpu")
    assert port.cfg.backend == "torch" and port.plans.buckets == ref.plans.buckets
    ids, scores = port.search_batch(Q)
    assert ids.dtype == np.int32 and ids.shape == (len(Q), 5)
    np.testing.assert_array_equal(ids, want_ids)
    np.testing.assert_allclose(scores, want_scores, rtol=RTOL, atol=ATOL)
    direct_ids, _ = port.search(Q)
    np.testing.assert_array_equal(direct_ids.numpy(), ids)
