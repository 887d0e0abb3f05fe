"""The port's background merge and the serving surfaces under threads
(``repro_torch/serve/segments.py``, ``serve/pipeline.py``) on the CPU,
held to the reference's invariants of ``tests/test_overlap.py`` (its
mutable and thread-safety half; its mesh case is in
``tests/test_torch_mesh.py``) on
its fixture: 60 docs at dim 128, seed 3, 6 queries.

The bar everywhere: overlap is a latency mechanism, never an answer
mechanism — every response equals its synchronous twin's, and every
counter accounts for the work that moved off the serving thread."""

import sys
import threading
import time

import numpy as np
import pytest

from repro_torch.data.synthetic import SyntheticConfig, generate_collection
from repro_torch.serve.api import RetrieverConfig
from repro_torch.serve.pipeline import FacadePlan, ResultCache, ServeStats
from repro_torch.serve.segments import InjectedCrash, MergeHandle, MutableRetriever
from torch_segments_cases import host, one_intra_op_thread  # noqa: F401  (autouse)


def _coll(n_docs=60, n_queries=6, seed=3):
    return generate_collection(
        SyntheticConfig(name="overlap", dim=128, n_docs=n_docs, n_queries=n_queries,
                        doc_nnz_mean=16.0, query_nnz_mean=6.0, seed=seed),
        value_format="f16",
    )


def _queries(col):
    return np.stack([col.query_dense(i) for i in range(col.n_queries)])


def _mutable(col, n_base=45):
    cfg = RetrieverConfig(engine="flat", codec="streamvbyte", k=10)
    m = MutableRetriever.create(col.fwd.slice(0, n_base), cfg, device="cpu")
    m.insert([col.fwd.doc(i) for i in range(n_base, col.fwd.n_docs)])
    m.delete([1, 3, n_base + 1])
    return m


def test_background_merge_commits_and_prewarms():
    col = _coll()
    Q = _queries(col)
    m = _mutable(col)
    ids0, sc0 = host(m.search(Q))
    gen0, epoch0 = m.generation, m.epoch
    handle = m.merge(background=True)
    assert isinstance(handle, MergeHandle)
    new_base = handle.result(timeout=600)
    assert handle.done()
    assert m.generation == gen0 + 1 and m.epoch == epoch0 + 1
    assert not m.segments and new_base is m.base
    # the worker made the next generation's plans: serving it reuses the
    # wrapper the merge built and creates no plan
    assert "base" in m._wrappers
    assert set(m._wrappers["base"].plans.created()) == set(m.plans.buckets)
    compiles = m.plans.compiles
    ids1, sc1 = host(m.search(Q))
    assert m.plans.compiles == compiles
    np.testing.assert_array_equal(ids1, ids0)
    np.testing.assert_array_equal(sc1, sc0)
    assert m.merge_wall_us > 0 and m.blocked_swap_us > 0
    assert not m._retired  # the old generation's parts are released


def test_background_merge_crash_surfaces_in_result():
    col = _coll()
    Q = _queries(col)
    m = _mutable(col)
    ids0 = host(m.search(Q))[0]
    gen0, n_segs = m.generation, len(m.segments)
    handle = m.merge(background=True, crash_before_flip=True)
    with pytest.raises(InjectedCrash):
        handle.result(timeout=600)
    assert m.generation == gen0 and len(m.segments) == n_segs
    np.testing.assert_array_equal(host(m.search(Q))[0], ids0)
    m.merge()
    assert m.generation == gen0 + 1
    np.testing.assert_array_equal(host(m.search(Q))[0], ids0)


def test_merge_handle_result_timeout():
    col = _coll()
    m = _mutable(col)
    handle = m.merge(background=True)
    try:
        handle.result(timeout=0.0)
    except TimeoutError:
        pass  # caught it mid-build
    assert handle.result(timeout=600) is m.base


def test_merge_handle_reraises_and_demotes_its_worker():
    """``result`` re-raises what the run raised, and the worker runs at a
    higher nice value than the caller (where the platform allows it)."""
    seen = {}

    def run():
        import os

        seen["nice"] = os.getpriority(os.PRIO_PROCESS, threading.get_native_id())
        raise KeyError("from the worker")

    h = MergeHandle(run)
    with pytest.raises(KeyError, match="from the worker"):
        h.result(timeout=60)
    if sys.platform.startswith("linux"):
        import os

        assert seen["nice"] >= min(19, os.getpriority(os.PRIO_PROCESS, 0)
                                   + MergeHandle.NICENESS)


def test_background_merge_excludes_writers():
    """A mutation issued while a background merge runs blocks on the
    write lock and lands after the flip."""
    col = _coll(n_docs=200)
    m = _mutable(col, n_base=180)
    handle = m.merge(background=True)
    deadline = time.monotonic() + 60
    while time.monotonic() < deadline:
        if m._write_lock.acquire(blocking=False):
            m._write_lock.release()
            if handle.done():
                break
            time.sleep(0.002)
        else:
            break
    ids = m.insert([col.fwd.doc(0)])  # blocks until the merge commits
    assert handle.done(), "insert returned while the merge still ran"
    handle.result(timeout=600)
    assert m.generation == 1
    assert len(m.segments) == 1 and m.segments[0].ids[0] == ids[0]


def test_result_cache_thread_hammer():
    cache = ResultCache(capacity=32)
    errors: list = []

    def worker(seed: int) -> None:
        rng = np.random.default_rng(seed)
        try:
            for i in range(300):
                key = bytes([int(rng.integers(64))])
                roll = rng.random()
                if roll < 0.1:
                    cache.invalidate(epoch=i)
                elif roll < 0.55:
                    cache.put(key, np.arange(4), np.ones(4))
                else:
                    got = cache.get(key)
                    if got is not None:
                        assert got[0].shape == (4,)
        except BaseException as e:  # noqa: BLE001  (reported below)
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(s,)) for s in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads) and not errors, errors
    assert len(cache) <= 32
    assert cache.lookups >= cache.hits
    assert cache.invalidations >= 1


def test_serve_stats_thread_hammer():
    stats = ServeStats(clock=time.perf_counter)
    n_threads, n_iters = 4, 500

    def worker() -> None:
        for i in range(n_iters):
            stats.record_query(float(i % 97))
            stats.record_dispatch(8, 5)
            if i % 50 == 0:
                stats.percentile(95)
                stats.snapshot()

    threads = [threading.Thread(target=worker) for _ in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    snap = stats.snapshot()
    assert snap["n_queries"] == n_threads * n_iters
    assert stats.dispatches[8] == n_threads * n_iters
    assert stats.occupancy[8] == 5 * n_threads * n_iters


@pytest.mark.parametrize("n_submitters", [2, 8])
def test_pipeline_stress_during_background_merge(n_submitters):
    """Submitters hammer ``Pipeline.submit`` (with 8, more threads than
    cores, and a short switch interval) while another thread invalidates
    the cache and reads stats, and a background merge builds and commits
    mid-storm. Every response in every phase equals the constant oracle
    (the merge does not change the live corpus), and the commit's epoch
    reaches the result cache."""
    col = _coll()
    Q = _queries(col)
    m = _mutable(col)
    pipe = m.pipeline(deadline_us=300.0, cache_size=32)
    pipe.warm()
    oracle_ids, oracle_sc = host(m.search(Q))
    stop = threading.Event()
    failures: list = []
    served = [0] * n_submitters

    def submitter(tid: int) -> None:
        rng = np.random.default_rng(tid)
        try:
            while not stop.is_set():
                qi = int(rng.integers(Q.shape[0]))
                ids, sc = pipe.submit(Q[qi]).result()
                if not (np.array_equal(ids, oracle_ids[qi])
                        and np.array_equal(sc, oracle_sc[qi])):
                    failures.append(f"thread {tid} query {qi} diverged")
                    stop.set()
                    return
                served[tid] += 1
        except BaseException as e:  # noqa: BLE001  (reported below)
            failures.append(repr(e))
            stop.set()

    def chaos() -> None:
        while not stop.is_set():
            pipe.cache.invalidate()
            pipe.snapshot()
            pipe.stats.percentile(95)
            time.sleep(0.001)

    threads = [threading.Thread(target=submitter, args=(i,)) for i in range(n_submitters)]
    threads.append(threading.Thread(target=chaos))
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5 if n_submitters > 2 else interval)
    try:
        for t in threads:
            t.start()
        handle = m.merge(background=True)
        handle.result(timeout=600)
        targets = [n + 3 for n in served]
        deadline = time.monotonic() + 120
        while (any(served[t] < targets[t] for t in range(n_submitters))
               and not stop.is_set() and time.monotonic() < deadline):
            time.sleep(0.001)
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=120)
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert not failures, failures
    assert all(n > 0 for n in served)
    assert m.generation == 1
    ids, _ = pipe.submit(Q[0]).result()
    np.testing.assert_array_equal(ids, oracle_ids[0])
    assert pipe.cache.epoch == m.epoch


def test_pipeline_warm_reaches_every_part_and_stats_read_the_merge():
    """``Pipeline.warm`` runs a zero query through each bucket's fan-out
    plan, which creates that bucket's plan in the base and in every
    segment; after a merge the snapshot reports non-zero merge and swap
    microseconds, and the summary line names them."""
    col = _coll()
    m = _mutable(col)
    m.insert([col.fwd.doc(0)], ids=[1])  # a second segment: reinsert a deleted id
    pipe = m.pipeline(buckets=(1, 4, 16), cache_size=8)
    created = pipe.warm()
    assert all(isinstance(p, FacadePlan) for p in pipe.plans.created().values())
    assert set(pipe.plans.created()) == {1, 4, 16}
    for key in ("base", ("seg", 0), ("seg", 1)):
        assert set(m._wrappers[key].plans.created()) == {1, 4, 16}, key
    assert created == 9  # three buckets in three parts
    snap = pipe.snapshot()
    assert snap["merge_wall_us"] == 0 and snap["blocked_swap_us"] == 0
    m.merge()
    pipe.search_batch(_queries(col))
    snap = pipe.snapshot()
    assert snap["merge_wall_us"] > 0 and snap["blocked_swap_us"] > 0
    assert "merge_wall=" in ServeStats.summary(snap)
    assert snap["cache_invalidations"] >= 1
