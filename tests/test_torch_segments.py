"""The port's live index mutation (``repro_torch/serve/segments.py``) on
the CPU, held to the reference's own invariants (``tests/test_segments.py``,
``tests/test_values.py``) on the reference's fixture: 50 docs at dim 256,
seed 7, 4 queries.

* mutation parity: for every engine × codec, a ``MutableRetriever`` at 0,
  1 and 3 live delta segments (tombstones in base and segments, an
  update in place) is byte-identical to a port ``Retriever.build`` over
  ``live_corpus()``, before and after the merge, and at the value codecs
  f16, u8_sq and u4_sq; pq overlaps before the merge and is exact after;
* id semantics: delete-then-reinsert, update in place, the errors;
* shard boundaries: tombstones over a sharded base route to their shards;
* crash injection at both hooks, cache staleness and plan retirement,
  the part budgets, degenerate parts (a one-doc segment, an all-dead
  segment, hnsw over 1–3 docs, Seismic below one block) and C1's
  ``ValueError`` where the reference raises it;
* ``ForwardIndex.concat`` / ``select`` / ``append`` byte-identical to the
  reference's.

On the CPU a part's plans run eagerly; the card's captures and the
release of retired graph pools are held in ``tests/test_torch_gpu.py``."""

import numpy as np
import pytest

from repro.core.forward_index import ForwardIndex as RefForwardIndex
from repro.data import synthetic as ref_synthetic
from repro.serve import api as ref_api
from repro.serve import segments as ref_segments
from repro_torch.core.forward_index import ForwardIndex
from repro_torch.core.layout import available_layouts
from repro_torch.data.synthetic import SyntheticConfig, generate_collection
from repro_torch.serve.api import ArtifactError, Retriever, RetrieverConfig, open_retriever
from repro_torch.serve.segments import DeltaSegment, InjectedCrash, MutableRetriever
from torch_segments_cases import (  # noqa: F401  (one_intra_op_thread: an autouse fixture)
    ENGINES,
    N_BASE,
    SEGMENTS_COLLECTION,
    Twins,
    assert_oracle_parity,
    cfg_for,
    create,
    host,
    one_intra_op_thread,
    segment_sweep,
)


@pytest.fixture(scope="module")
def collection():
    return generate_collection(SyntheticConfig(**SEGMENTS_COLLECTION), value_format="f16")


@pytest.fixture(scope="module")
def queries(collection):
    return np.stack([collection.query_dense(i) for i in range(collection.n_queries)])


@pytest.fixture(scope="module")
def ref_collection():
    return ref_synthetic.generate_collection(
        ref_synthetic.SyntheticConfig(**SEGMENTS_COLLECTION), value_format="f16")


@pytest.mark.parametrize("codec", available_layouts())
@pytest.mark.parametrize("engine", ENGINES)
def test_mutation_parity_segment_sweep(collection, queries, engine, codec):
    fwd = collection.fwd
    cfg = cfg_for(engine, codec, k=5)
    m = create(fwd.slice(0, N_BASE), cfg)
    assert len(m.segments) == 0 and m.device.type == "cpu"
    segment_sweep(m, fwd, lambda label: assert_oracle_parity(
        m, cfg, queries, f"{engine}/{codec} {label}"))


def test_delete_then_reinsert_and_update_semantics(collection, queries):
    fwd = collection.fwd
    cfg = cfg_for("flat", "streamvbyte", k=5)
    m = create(fwd.slice(0, N_BASE), cfg)
    with pytest.raises(ValueError, match="still live"):
        m.insert([fwd.doc(41)], ids=[7])
    with pytest.raises(KeyError):
        m.delete([N_BASE + 99])
    # delete-then-reinsert under the same stable id serves the NEW row
    m.delete([7])
    assert 7 not in set(m.live_ids())
    m.insert([fwd.doc(44)], ids=[7])
    assert 7 in set(m.live_ids())
    assert_oracle_parity(m, cfg, queries, "reinserted id")
    c, v = fwd.doc(44)
    q = np.zeros(fwd.dim, np.float32)
    q[c] = 1.0
    ids, scores = host(m.search(q[None, :]))
    row = np.flatnonzero(ids[0] == 7)
    assert row.size == 1
    assert np.isclose(scores[0][row[0]], np.float32(v.sum()), rtol=1e-3)
    # update in place: the tombstone lands on the segment copy (newest wins)
    m.update([fwd.doc(45)], ids=[7])
    assert 7 in set(m.live_ids())
    assert_oracle_parity(m, cfg, queries, "updated id")
    m.delete([7])
    with pytest.raises(KeyError):
        m.delete([7])
    assert m.n_live == N_BASE - 1
    assert_oracle_parity(m, cfg, queries, "after final delete")


def test_insert_rejects_bad_input(collection):
    fwd = collection.fwd
    m = create(fwd.slice(0, N_BASE), cfg_for("flat"))
    with pytest.raises(ValueError, match="empty segment"):
        m.insert(fwd.slice(0, 0))
    with pytest.raises(ValueError, match="ids"):
        m.insert([fwd.doc(41), fwd.doc(42)], ids=[60, 60])
    with pytest.raises(ValueError, match="docs but"):
        m.insert([fwd.doc(41)], ids=[60, 61])
    with pytest.raises(ValueError, match="dim"):
        m.insert(ForwardIndex.from_docs([fwd.doc(41)], 128, "f16"))
    with pytest.raises(ValueError, match="value_format"):
        m.insert(ForwardIndex.from_docs([fwd.doc(41)], fwd.dim, "f32"))
    with pytest.raises(ValueError, match="next_id"):
        MutableRetriever(m.cfg, m.base, base_fwd=m.base_fwd, base_ids=m.base_ids, next_id=5)
    with pytest.raises(ValueError, match="rows but"):
        MutableRetriever(m.cfg, m.base, base_fwd=m.base_fwd, base_ids=m.base_ids[:-1])
    assert m.epoch == 0 and not m.segments  # nothing committed


@pytest.mark.parametrize("engine", ENGINES)
def test_tombstone_masking_at_shard_boundaries(collection, queries, engine):
    """Sharded base: deletes routed per shard by doc range — boundary
    docs, a whole shard, the id-space extremes — lose no live candidate
    and resurrect no dead one; after the merge the fresh sharded base
    routes them over its new ranges."""
    fwd = collection.fwd
    cfg = cfg_for(engine, "dotvbyte", n_shards=5, k=5)
    m = create(fwd.slice(0, N_BASE), cfg)
    base = m.base
    ranges = [(sh.doc_lo, sh.doc_hi) for sh in base.shards]
    lo1, hi1 = ranges[1]
    lo2, hi2 = ranges[2]
    victims = sorted({0, lo1, hi1 - 1, *range(lo2, hi2), N_BASE - 1})
    m.delete(victims)
    assert_oracle_parity(m, cfg, queries, f"{engine} shard-boundary deletes")
    assert sum(base._shard_tombs) == len(victims)
    assert base._shard_tombs[2] == hi2 - lo2
    m.insert([fwd.doc(i) for i in range(N_BASE, N_BASE + 3)])
    assert_oracle_parity(m, cfg, queries, f"{engine} sharded base + segment")
    m.merge()
    m.delete([int(m.live_ids()[0])])
    assert_oracle_parity(m, cfg, queries, f"{engine} post-merge delete")


def test_crash_between_write_and_flip_preserves_generation(collection, queries, tmp_path):
    fwd = collection.fwd
    cfg = cfg_for("flat", "bitpack", k=5)
    root = tmp_path / "idx"
    m = create(fwd.slice(0, N_BASE), cfg, root)
    m.insert([fwd.doc(40)])
    m.delete([5])
    want_ids, _ = host(m.search(queries))
    # a crash between the segment write and the state.json commit: the
    # orphan is invisible to open and reclaimed by the retry
    with pytest.raises(InjectedCrash):
        m.insert([fwd.doc(41)], _crash_before_commit=True)
    assert (root / "generation_0000" / "segment_0001").is_dir()
    r = open_retriever(root, device="cpu")
    assert isinstance(r, MutableRetriever)
    assert len(r.segments) == 1 and r.n_live == m.n_live
    np.testing.assert_array_equal(host(r.search(queries))[0], want_ids)
    m.insert([fwd.doc(41)])
    # a crash between the generation write and the CURRENT flip: the
    # previous generation, segments and tombstones, still opens
    with pytest.raises(InjectedCrash):
        m.merge(crash_before_flip=True)
    assert (root / "generation_0001").is_dir()
    r = open_retriever(root, device="cpu")
    assert r.generation == 0 and len(r.segments) == 2
    a, b = host(r.search(queries))
    c, d = host(m.search(queries))
    np.testing.assert_array_equal(a, c)
    np.testing.assert_array_equal(b, d)
    # the retried merge reclaims the orphan generation and flips cleanly
    m.merge()
    r = open_retriever(root, device="cpu")
    assert r.generation == 1 and not r.segments
    np.testing.assert_array_equal(host(r.search(queries))[0], host(m.search(queries))[0])
    # a CURRENT pointing at a missing generation fails loudly
    (root / "CURRENT").write_text("generation_0099")
    with pytest.raises(ArtifactError, match="generation"):
        open_retriever(root, device="cpu")


def test_in_memory_crash_and_corrupt_state(collection, tmp_path):
    """Without a root the flip hook still raises before any in-memory
    change; a corrupt or foreign ``state.json`` and an out-of-range
    tombstone are rejected on open."""
    fwd = collection.fwd
    m = create(fwd.slice(0, N_BASE), cfg_for("flat"))
    m.insert([fwd.doc(40)])
    epoch = m.epoch
    with pytest.raises(InjectedCrash):
        m.merge(crash_before_flip=True)
    assert m.generation == 0 and m.epoch == epoch and len(m.segments) == 1
    root = tmp_path / "idx"
    create(fwd.slice(0, N_BASE), cfg_for("flat"), root)
    state = root / "generation_0000" / "state.json"
    good = state.read_text()
    for bad, match in (("{", "corrupt"), (good.replace("repro.serve.mutable", "x"), "format"),
                       (good.replace('"version": 1', '"version": 9'), "version"),
                       (good.replace('"base": []', '"base": [99]'), "out of range")):
        state.write_text(bad)
        with pytest.raises(ArtifactError, match=match):
            open_retriever(root, device="cpu")


def test_result_cache_staleness_and_plan_retirement(collection, queries):
    """A cached answer survives neither a mutation nor a generation flip,
    and the flip retires the fan-out plan (its ``gen`` key component)."""
    fwd = collection.fwd
    cfg = cfg_for("flat", "uncompressed", k=5)
    m = create(fwd.slice(0, N_BASE), cfg)
    pipe = m.pipeline(cache_size=64, deadline_us=0.0)
    q = queries[0]
    t1 = pipe.submit(q)
    pipe.flush()
    t2 = pipe.submit(q)
    pipe.flush()
    assert t2.from_cache
    ids_before = np.asarray(t1.ids)
    m.delete([int(ids_before[0])])
    t3 = pipe.submit(q)
    pipe.flush()
    assert not t3.from_cache, "cached answer survived a mutation"
    assert int(np.asarray(t3.ids)[0]) != int(ids_before[0])
    live_fwd, live = m.live_corpus()
    oi, osc = host(Retriever.build(live_fwd, cfg, device="cpu").search(q[None, :]))
    np.testing.assert_array_equal(np.asarray(t3.ids), live[oi[0]])
    np.testing.assert_array_equal(np.asarray(t3.scores), osc[0])
    snap = pipe.snapshot()
    assert snap["cache_invalidations"] >= 1 and snap["cache_invalidated_entries"] >= 1
    t4 = pipe.submit(q)
    pipe.flush()
    assert t4.from_cache
    retired_before = m.plans.retired
    m.merge()
    t5 = pipe.submit(q)
    pipe.flush()
    assert not t5.from_cache, "cached answer survived a generation flip"
    np.testing.assert_array_equal(np.asarray(t5.ids), np.asarray(t4.ids))
    assert m.plans.retired > retired_before
    key = m.plans.get(pipe.plans.bucket_for(1)).key
    assert key.gen == f"g{m.generation}" and key.shard == "mut"
    assert key.mode == "torch" and key.k == 5


def test_part_budgets_keys_and_records(collection, queries):
    """Each part serves at ``min(n_part, k + dead_part)``; a delete that
    moves a part's budget retires that part's wrapper (its plan creations
    still counted); part plans are keyed ``mut:<label>`` and the fan-out
    plan keeps one ``(label, launches, stages)`` record per part."""
    fwd = collection.fwd
    cfg = cfg_for("flat", "dotvbyte", k=5)
    m = create(fwd.slice(0, N_BASE), cfg)
    m.insert([fwd.doc(i) for i in range(N_BASE, N_BASE + 3)])
    m.search(queries)
    base_w, seg_w = m._wrappers["base"], m._wrappers["seg", 0]
    assert (base_w.cfg.k, seg_w.cfg.k) == (5, 3)
    assert base_w.plans.get(4).key.shard == "mut:base"
    assert seg_w.plans.get(4).key.shard == "mut:seg0"
    plan = m.plans.get(4)
    assert [label for label, _, _ in plan.stages] == [] and plan.replays == 1
    compiles = m.plans.compiles
    m.delete([1, 2])
    m.search(queries)
    assert m._wrappers["base"] is not base_w and m._wrappers["base"].cfg.k == 7
    assert m._wrappers["seg", 0] is seg_w
    assert m.plans.compiles == compiles + 1  # the new base wrapper's plan
    assert not m._retired and m._inflight == 0  # released after the dispatch
    m.delete([N_BASE])  # inside the segment: its budget stays min(3, 6)
    m.search(queries)
    assert m._wrappers["seg", 0] is seg_w


@pytest.mark.parametrize("engine", ENGINES)
def test_degenerate_parts(collection, ref_collection, queries, engine):
    """A one-doc segment, a segment whose rows are all dead, a base cut
    to 3 live docs, merges down to 4 docs and to 1: the port behaves as
    the reference does."""
    t = Twins(collection, ref_collection, engine, "streamvbyte", N_BASE)
    t.insert([N_BASE])
    t.check(queries, f"{engine} one-doc segment")
    t.do("delete", t.insert(range(N_BASE + 1, N_BASE + 4)))
    assert not (~t.port.segments[1].dead).any()
    t.check(queries, f"{engine} all-dead segment")
    t.do("delete", np.arange(3, N_BASE))
    t.check(queries, f"{engine} 4 live docs")
    t.do("merge")
    assert t.port.base.n_docs == 4
    t.check(queries, f"{engine} merged to 4 docs")
    t.do("delete", t.port.live_ids()[1:])
    t.do("merge")
    assert t.port.base.n_docs == 1
    t.check(queries, f"{engine} merged to 1 doc")
    ids, scores = host(t.port.search(queries))
    assert (ids[:, 1:] == -1).all() and np.isneginf(scores[:, 1:]).all()
    t.do("delete", t.port.live_ids())
    for m in (t.port, t.ref):
        with pytest.raises(ValueError, match="empty corpus"):
            m.merge()


@pytest.mark.parametrize("n_docs", [1, 2, 3])
def test_hnsw_over_a_few_docs(collection, ref_collection, queries, n_docs):
    """hnsw over 1–3 docs, as the base and as a segment."""
    t = Twins(collection, ref_collection, "hnsw", "dotvbyte", n_docs)
    t.check(queries, f"hnsw base of {n_docs}")
    t.insert(range(N_BASE, N_BASE + n_docs))
    t.check(queries, f"hnsw + segment of {n_docs}")


def test_seismic_below_one_block(collection, ref_collection, queries):
    """Seismic segments smaller than one block (block_size 8) over a
    base of 5 docs."""
    t = Twins(collection, ref_collection, "seismic", "bitpack", 5)
    t.check(queries, "seismic base of 5")
    for lo, hi in ((N_BASE, N_BASE + 1), (N_BASE + 1, N_BASE + 7)):
        t.insert(range(lo, hi))
        t.check(queries, f"seismic segment of {hi - lo}")


@pytest.mark.parametrize("vq", ("f16", "u8_sq", "u4_sq"))
def test_mutation_parity_at_vq(queries, vq):
    """Tombstones and a delta segment at every per-doc-stable value codec
    (the reference's ``tests/test_values.py`` fixture, seed 3): byte for
    byte against the oracle, before and after the merge."""
    col = generate_collection(SyntheticConfig(name="values-test", dim=256, n_docs=50,
                                              n_queries=4, doc_nnz_mean=24.0,
                                              query_nnz_mean=8.0, seed=3),
                              value_format="f16")
    Q = np.stack([col.query_dense(i) for i in range(col.n_queries)])
    fwd = col.fwd
    cfg = RetrieverConfig(engine="flat", codec="streamvbyte", vq=vq, k=5)
    m = create(fwd.slice(0, 40), cfg)
    m.delete([3, 17])
    m.insert([fwd.doc(i) for i in range(40, 44)])
    assert_oracle_parity(m, cfg, Q, f"{vq} 1 segment")
    m.merge()
    assert_oracle_parity(m, cfg, Q, f"{vq} post-merge")


def test_mutation_pq_overlap_and_merge_parity():
    """PQ codebooks are per build: a segment quantizes against its own,
    so parity before the merge is top-k overlap; after it, exact."""
    col = generate_collection(SyntheticConfig(name="values-test", dim=256, n_docs=50,
                                              n_queries=4, doc_nnz_mean=24.0,
                                              query_nnz_mean=8.0, seed=3),
                              value_format="f16")
    Q = np.stack([col.query_dense(i) for i in range(col.n_queries)])
    fwd = col.fwd
    cfg = RetrieverConfig(engine="flat", codec="streamvbyte", vq="pq", k=5)
    m = create(fwd.slice(0, 40), cfg)
    m.delete([3, 17])
    m.insert([fwd.doc(i) for i in range(40, 44)])
    live_fwd, live = m.live_corpus()
    oi, _ = host(Retriever.build(live_fwd, cfg, device="cpu").search(Q))
    mi, _ = host(m.search(Q))
    overlap = np.mean([len(set(mi[i].tolist()) & set(live[oi[i]].tolist())) / mi.shape[1]
                       for i in range(mi.shape[0])])
    assert overlap >= 0.8, overlap
    m.merge()
    assert_oracle_parity(m, cfg, Q, "pq post-merge")


def test_seismic_part_budget_past_candidates_raises_like_reference():
    """C1 on a part: deletes grow the base's budget ``k + dead`` past
    Seismic's candidate axis (n_probe × block_size = 16); the port's
    search raises ``ValueError`` at the same delete as the reference's,
    and not one delete earlier. (At two probed blocks the ids themselves
    may differ: phase 1's summary bounds are f32 sums in another order,
    and a near tie picks another block.)"""
    spec = dict(name="segments-test", dim=256, n_docs=50, n_queries=4, doc_nnz_mean=24.0,
                query_nnz_mean=8.0, seed=7)
    port = generate_collection(SyntheticConfig(**spec), value_format="f16")
    ref = ref_synthetic.generate_collection(ref_synthetic.SyntheticConfig(**spec),
                                            value_format="f16")
    Q = np.stack([port.query_dense(i) for i in range(port.n_queries)])
    params = dict(cut=4, block_budget=64, n_probe=2, block_size=8)
    m = create(port.fwd.slice(0, N_BASE), RetrieverConfig(engine="seismic", k=10,
                                                           params=params))
    r = ref_segments.MutableRetriever.create(
        ref.fwd.slice(0, N_BASE), ref_api.RetrieverConfig(engine="seismic", k=10,
                                                          params=params))
    for x in (m, r):
        x.delete(np.arange(6))  # budget 16: fits
        x.search(Q)
    for x in (m, r):
        x.delete([6])  # budget 17 > 16 candidates
    with pytest.raises(ValueError, match="k argument to top_k") as port_err:
        m.search(Q)
    with pytest.raises(ValueError) as ref_err:
        r.search(Q)
    assert "top_k" in str(ref_err.value) and str(port_err.value) in str(ref_err.value)


def test_forward_index_concat_select_append():
    """The merge primitives round-trip the CSR rows, stored values byte
    for byte, and equal the reference's on the same input."""
    rng = np.random.default_rng(0)
    docs = []
    for _ in range(12):
        n = int(rng.integers(0, 6))
        docs.append((np.sort(rng.choice(64, size=n, replace=False)),
                     rng.random(n).astype(np.float32)))
    whole = ForwardIndex.from_docs(docs, dim=64, value_format="f16")
    ref_whole = RefForwardIndex.from_docs(docs, dim=64, value_format="f16")
    cuts = [(0, 5), (5, 8), (8, 12)]
    cat = ForwardIndex.concat([whole.slice(*c) for c in cuts])
    ref_cat = RefForwardIndex.concat([ref_whole.slice(*c) for c in cuts])
    for got, want in ((cat, whole), (cat, ref_cat)):
        for f in ("components", "values", "offsets"):
            a, b = getattr(got, f), getattr(want, f)
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), f
    assert whole.slice(0, 5).append(whole.slice(5, 8)).n_docs == 8
    assert ForwardIndex.concat([whole]) is whole
    idx = np.array([11, 0, 7, 7, 3, 2])  # repeats, an empty row
    sel, ref_sel = whole.select(idx), ref_whole.select(idx)
    assert sel.n_docs == len(idx)
    for f in ("components", "values", "offsets"):
        a, b = getattr(sel, f), getattr(ref_sel, f)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), f
    for r, src in enumerate(idx):
        np.testing.assert_array_equal(sel.doc(r)[0], whole.doc(src)[0])
        np.testing.assert_array_equal(sel.doc_raw_values(r), whole.doc_raw_values(src))
    assert whole.select(np.zeros(0, np.int64)).n_docs == 0
    assert [c.tolist() for c, _ in whole.iter_docs()] == [c.tolist() for c, _ in
                                                          ref_whole.iter_docs()]
    with pytest.raises(ValueError):
        whole.select(np.array([12]))
    with pytest.raises(ValueError):
        whole.select(np.array([-1]))
    with pytest.raises(ValueError):
        ForwardIndex.concat([])
    with pytest.raises(ValueError):
        ForwardIndex.concat([whole, ForwardIndex.from_docs(docs, 32, "f16")])
    with pytest.raises(ValueError):
        ForwardIndex.concat([whole, ForwardIndex.from_docs(docs, 64, "f32")])


def test_wrapping_a_built_base(collection, queries):
    """A mutable index made by wrapping an already-built base (stable ids
    ``arange``, nothing rebuilt) serves the same ids as one made by
    ``create``, and shares the base's arrays."""
    fwd = collection.fwd
    cfg = cfg_for("seismic", "dotvbyte", k=5)
    base = Retriever.build(fwd.slice(0, N_BASE), cfg, device="cpu")
    m = MutableRetriever(cfg, base, base_fwd=fwd.slice(0, N_BASE),
                         base_ids=np.arange(N_BASE))
    m.delete([0, 9])
    m.search(queries)
    assert all(m._wrappers["base"].arrays[k] is v for k, v in base.arrays.items())
    twin = create(fwd.slice(0, N_BASE), cfg)
    twin.delete([0, 9])
    for a, b in zip(host(m.search(queries)), host(twin.search(queries))):
        np.testing.assert_array_equal(a, b)
    seg = DeltaSegment(ids=np.array([N_BASE]), fwd=fwd.slice(N_BASE, N_BASE + 1), arrays={},
                       dead=np.zeros(1, bool))
    assert seg.n_docs == 1
