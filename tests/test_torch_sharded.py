"""The port's sharded, out-of-core serving (``repro_torch/serve/sharded.py``)
on the CPU, held against the reference (``repro/serve/sharded.py``) and
against the reference's own invariants (``tests/test_sharded_artifacts.py``,
``tests/test_overlap.py``), on the reference's fixtures: 50 docs at dim
256 (seed 7, 4 queries) and 60 docs at dim 128 (seed 3, 6 queries).

* sharding is invisible: for every engine × codec × S ∈ {1, 2, 4, 7} at
  budgets exhaustive for 50 docs, the port's sharded top-k is
  byte-identical to the port's unsharded index, whose ids equal the
  reference's (the reference's sharded ids on the same tree:
  ``tests/test_torch_sharded_parity.py``), down to one-document shards;
* the tree: ``shard_ranges`` (property-tested), save → open
  memory-mapped, trees crossing both ways, and every fault the
  reference's opener rejects;
* the merge contract: ``map_local_ids`` and ``merge_topk`` against the
  reference's and numpy, sentinels never aliasing a document;
* residency: the LRU at ``max_resident=1``, plan keys ``"<s>/<S>"``, the
  prefetch counters, the staged-discard and uniform tombstone budgets,
  the peak accounting of DESIGN.md §11 (a completed staged build counts),
  a staging failure re-raised on the serving thread, and the pipeline
  over shards.

On the CPU a shard's "device" arrays are host tensors and plans run
eagerly; the card's pinned staging and captured plans are held in
``tests/test_torch_gpu.py``."""

import json
import os
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from proptest import integers, run_property
from repro.data import synthetic as ref_synthetic
from repro.serve import api as ref_api
from repro.serve import sharded as ref_sharded
from repro_torch.core.layout import available_layouts
from repro_torch.data.synthetic import SyntheticConfig, generate_collection
from repro_torch.serve.api import (
    MANIFEST_VERSION,
    ArtifactError,
    Retriever,
    RetrieverConfig,
    map_local_ids,
    merge_topk,
    open_retriever,
)
from repro_torch.serve.sharded import ShardedRetriever, mmap_npz, shard_ranges, tombstone_budget

SHARD_COUNTS = [1, 2, 4, 7]
ENGINES = ["seismic", "hnsw", "flat"]

#: the reference's budgets, exhaustive for the 50-doc collection: every
#: query component probed, every block scored, the whole graph walkable
ENGINE_PARAMS = {
    "seismic": dict(cut=16, block_budget=512, n_probe=512, n_postings=10000, block_size=8),
    "hnsw": dict(beam=56, iters=56, n_seeds=4, m=8, ef_construction=48),
    "flat": {},
}
SHARD_COLLECTION = dict(name="shard-test", dim=256, n_docs=50, n_queries=4,
                        doc_nnz_mean=24.0, query_nnz_mean=8.0, seed=7)
OVERLAP_COLLECTION = dict(name="overlap", dim=128, n_docs=60, n_queries=6,
                          doc_nnz_mean=16.0, query_nnz_mean=6.0, seed=3)
#: f16 values: the two packages sum the same products in another order
ATOL = 2e-3


def _cfg(engine, codec="uncompressed", n_shards=1, k=10, **kw):
    return RetrieverConfig(engine=engine, codec=codec, k=k, n_shards=n_shards,
                           params=ENGINE_PARAMS[engine], **kw)


def _host(pair):
    return tuple(t.cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
                 for t in pair)


def _same(a, b):
    return all(np.array_equal(x, y) for x, y in zip(_host(a), _host(b)))


@pytest.fixture(scope="module")
def collection():
    return generate_collection(SyntheticConfig(**SHARD_COLLECTION), value_format="f16")


@pytest.fixture(scope="module")
def ref_collection():
    return ref_synthetic.generate_collection(
        ref_synthetic.SyntheticConfig(**SHARD_COLLECTION), value_format="f16")


@pytest.fixture(scope="module")
def queries(collection):
    return np.stack([collection.query_dense(i) for i in range(collection.n_queries)])


@pytest.fixture(scope="module")
def oracles(collection, ref_collection, queries):
    """(engine, codec) → the port's unsharded top-k, its ids checked once
    against the reference's unsharded ids."""
    cache = {}

    def get(engine, codec):
        if (engine, codec) not in cache:
            port = _host(Retriever.build(collection.fwd, _cfg(engine, codec),
                                         device="cpu").search(queries))
            ref_cfg = ref_api.RetrieverConfig(engine=engine, codec=codec, k=10,
                                              params=ENGINE_PARAMS[engine])
            ref = _host(ref_api.Retriever.build(ref_collection.fwd, ref_cfg).search(queries))
            assert np.array_equal(port[0], ref[0]), (engine, codec)
            np.testing.assert_allclose(port[1], ref[1], rtol=0, atol=ATOL)
            cache[engine, codec] = port
        return cache[engine, codec]

    return get


@pytest.fixture(scope="module")
def overlap():
    """The reference's overlap fixture and a saved flat/streamvbyte tree of
    three shards (the prefetch and tombstone cases)."""
    col = generate_collection(SyntheticConfig(**OVERLAP_COLLECTION), value_format="f16")
    Q = np.stack([col.query_dense(i) for i in range(col.n_queries)])
    return col, Q


@pytest.fixture
def overlap_tree(overlap, tmp_path):
    col, _ = overlap
    cfg = RetrieverConfig(engine="flat", codec="streamvbyte", k=10, n_shards=3)
    return Retriever.build(col.fwd, cfg, device="cpu").save(tmp_path / "tree")


def _open(tree, *, max_resident=1, prefetch=True, **kw):
    r = open_retriever(tree, device="cpu", **kw)
    r.use_mesh = False
    r.max_resident = max_resident
    r.prefetch = prefetch
    return r


# -- shard_ranges: the partition contract (property-tested) ---------------------------


def test_shard_ranges_properties():
    """Ranges tile [0, n) contiguously, balanced within one doc, the ragged
    shard last, equal to the reference's; infeasible splits raise in both."""

    def prop(n_docs, n_shards):
        if n_shards > n_docs:
            for fn in (shard_ranges, ref_sharded.shard_ranges):
                with pytest.raises(ValueError, match="at least one document"):
                    fn(n_docs, n_shards)
            return
        ranges = shard_ranges(n_docs, n_shards)
        assert ranges == ref_sharded.shard_ranges(n_docs, n_shards)
        assert len(ranges) == n_shards and ranges[0][0] == 0 and ranges[-1][1] == n_docs
        sizes = [hi - lo for lo, hi in ranges]
        assert min(sizes) >= 1 and max(sizes) - min(sizes) <= 1
        assert sizes == sorted(sizes, reverse=True)  # the ragged shard is last
        assert all(hi == lo for (_, hi), (lo, _) in zip(ranges, ranges[1:]))

    run_property(prop, integers(1, 200), integers(1, 40), seed=11)


def test_empty_shards_rejected(collection):
    with pytest.raises(ValueError, match="at least one document"):
        shard_ranges(5, 8)
    with pytest.raises(ValueError, match="n_shards"):
        shard_ranges(10, 0)
    with pytest.raises(ValueError, match="at least one document"):
        Retriever.build(collection.fwd, _cfg("flat", n_shards=51), device="cpu")


# -- sharding is invisible: engine × codec × n_shards ------------------------------------


@pytest.mark.parametrize("n_shards", SHARD_COUNTS)
@pytest.mark.parametrize("codec", available_layouts())
@pytest.mark.parametrize("engine", ENGINES)
def test_sharded_matches_unsharded_oracle(collection, queries, oracles, engine, codec,
                                          n_shards):
    """Ids and scores byte-identical to the port's unsharded index (whose
    ids are the reference's). S = 7 over 50 docs makes the last shard
    ragged (8- and 7-doc shards: per-shard shapes differ)."""
    r = Retriever.build(collection.fwd, _cfg(engine, codec, n_shards), device="cpu")
    if n_shards == 1:
        assert isinstance(r, Retriever)
    else:
        assert isinstance(r, ShardedRetriever)
        assert [sh.n_docs for sh in r.shards] == [
            hi - lo for lo, hi in shard_ranges(collection.fwd.n_docs, n_shards)]
    ids, scores = r.search(queries)
    assert ids.dtype == torch.int32 and scores.dtype == torch.float32
    assert _same((ids, scores), oracles(engine, codec))


@pytest.mark.parametrize("engine", ENGINES)
def test_single_doc_shards(engine):
    """n_shards == n_docs: every shard owns one document (shard < k, so the
    per-shard budget cap and the merge's sentinel padding both engage);
    the ids are the reference's unsharded ones."""
    kw = dict(name="tiny", dim=128, n_docs=10, n_queries=3, doc_nnz_mean=16.0,
              query_nnz_mean=6.0, seed=13)
    coll = generate_collection(SyntheticConfig(**kw), value_format="f16")
    Q = np.stack([coll.query_dense(i) for i in range(3)])
    cfg = RetrieverConfig(engine=engine, k=5, params=ENGINE_PARAMS[engine])
    oracle = Retriever.build(coll.fwd, cfg, device="cpu").search(Q)
    r = Retriever.build(coll.fwd, cfg.replace(n_shards=10), device="cpu")
    assert all(sh.n_docs == 1 for sh in r.shards)
    got = r.search(Q)
    assert _same(got, oracle)
    ref_coll = ref_synthetic.generate_collection(ref_synthetic.SyntheticConfig(**kw),
                                                 value_format="f16")
    ref = _host(ref_api.Retriever.build(
        ref_coll.fwd, ref_api.RetrieverConfig(engine=engine, k=5, params=ENGINE_PARAMS[engine])
    ).search(Q))
    assert np.array_equal(_host(got)[0], ref[0])
    np.testing.assert_allclose(_host(got)[1], ref[1], rtol=0, atol=ATOL)


def test_pipeline_search_batch_parity(collection, queries, oracles):
    """The micro-batching pipeline runs over shards unchanged."""
    r = Retriever.build(collection.fwd, _cfg("flat", n_shards=4), device="cpu")
    assert _same(r.search_batch(queries), oracles("flat", "uncompressed"))
    # a zero query through every bucket's fan-out plan: every shard makes the
    # plans of the buckets the direct search did not
    warm = r.pipeline(cache_size=0).warm()
    assert warm == 4 * (len(r.plans.buckets) - 1)


def test_out_of_core_lru_parity(collection, queries, oracles):
    """max_resident=1 re-admits each shard in turn: the same answers,
    evictions and a bounded peak; the second pass recreates the evicted
    plans and ``compiles`` counts them."""
    r = Retriever.build(collection.fwd, _cfg("flat", n_shards=4, backend="cuda"),
                        device="cpu")
    full = r.disk_bytes()
    r.max_resident = 1
    assert _same(r.search(queries), oracles("flat", "uncompressed"))
    assert len(r._resident) == 1 and r.evictions >= 3
    assert 0 < r.peak_resident_bytes < full
    before = r.plans.compiles
    assert _same(r.search(queries), oracles("flat", "uncompressed"))
    assert r.plans.compiles > before and r.evictions >= 7
    assert r.builds >= 8 and r.admission_s["page_in"] > 0 and r.admission_s["h2d"] == 0


def test_plan_keys_carry_shard_topology(collection, queries):
    """The fan-out plan is keyed ``*/S``, a resident shard's plans ``s/S``,
    and the fan-out plan records the sub-plans it ran."""
    r = Retriever.build(collection.fwd, _cfg("flat", n_shards=2), device="cpu")
    r.search(queries)
    bucket = r.plans.bucket_for(queries.shape[0])
    facade = r.plans.get(bucket)
    assert facade.key.shard == "*/2" and facade.replays == 1 and not facade.warm(r.dim)
    assert {sr.plans.get(bucket).key.shard for sr in r._resident.values()} == {"0/2", "1/2"}
    assert r.plans.compiles >= 2 and list(r.plans.created()) == [bucket]
    assert facade.stages == frozenset()  # nothing is launched on the CPU


def test_mesh_path_raises_and_names_its_roadmap_item(collection, queries):
    r = Retriever.build(collection.fwd, _cfg("flat", n_shards=2), device="cpu")
    for use_mesh in (None, False):
        r.use_mesh = use_mesh
        r.search(queries)
    r.use_mesh = True  # over the mesh, which needs a process group of ≥ 2 ranks
    with pytest.raises(ValueError, match=r"has 0 rank\(s\) for 2 shards"):
        r.search(queries)


# -- the artifact tree: memory-mapped open, trees crossing both ways ---------------------


@pytest.mark.parametrize("engine", ENGINES)
def test_save_open_memory_mapped(collection, queries, tmp_path, engine):
    """``open_retriever`` memory-maps every shard payload and answers
    byte-identically; the reference opens the port's tree, memory-mapped,
    with the same ids."""
    r = Retriever.build(collection.fwd, _cfg(engine, n_shards=3), device="cpu")
    want = r.search(queries)
    art = r.save(tmp_path / f"tree-{engine}")
    r2 = open_retriever(art, device="cpu")
    assert isinstance(r2, ShardedRetriever)
    assert r2.cfg == r.cfg and r2.n_docs == r.n_docs
    for sh in r2.shards:
        assert all(isinstance(a, np.memmap) for a in sh.arrays.values() if a.size > 0)
    assert _same(r2.search(queries), want)
    ref = ref_api.open_retriever(art)
    assert isinstance(ref, ref_sharded.ShardedRetriever)
    assert all(isinstance(a, np.memmap) for sh in ref.shards
               for a in sh.arrays.values() if a.size > 0)
    ref_ids, ref_scores = _host(ref.search(queries))
    assert np.array_equal(_host(want)[0], ref_ids)
    np.testing.assert_allclose(_host(want)[1], ref_scores, rtol=0, atol=ATOL)


@pytest.mark.parametrize("engine", ENGINES)
def test_reference_tree_opens_memory_mapped(ref_collection, queries, tmp_path, engine):
    """A tree saved by the reference opens in the port, memory-mapped, with
    byte-equal shard arrays and the reference's ids."""
    ref = ref_api.Retriever.build(ref_collection.fwd, ref_api.RetrieverConfig(
        engine=engine, codec="dotvbyte", k=10, n_shards=4, params=ENGINE_PARAMS[engine]))
    art = ref.save(tmp_path / "ref-tree")
    r = open_retriever(art, device="cpu")
    assert isinstance(r, ShardedRetriever) and r.cfg.backend == "torch"
    for sh, ref_sh in zip(r.shards, ref.shards):
        assert (sh.doc_lo, sh.doc_hi) == (ref_sh.doc_lo, ref_sh.doc_hi)
        assert set(sh.arrays) == set(ref_sh.arrays)
        for k, a in sh.arrays.items():
            assert a.size == 0 or isinstance(a, np.memmap)
            assert np.array_equal(a, np.asarray(ref_sh.arrays[k])), k
    ids, scores = _host(r.search(queries))
    ref_ids, ref_scores = _host(ref.search(queries))
    assert np.array_equal(ids, ref_ids)
    np.testing.assert_allclose(scores, ref_scores, rtol=0, atol=ATOL)


@pytest.fixture(scope="module")
def saved_tree(collection, tmp_path_factory):
    """One pristine flat tree; the fault cases copy and corrupt it."""
    r = Retriever.build(collection.fwd, _cfg("flat", n_shards=3), device="cpu")
    return r.save(tmp_path_factory.mktemp("pristine") / "tree")


def _edit_json(path, fn):
    mf = json.loads(path.read_text())
    fn(mf)
    path.write_text(json.dumps(mf))


def _truncate(tree):
    npz = tree / "shard_0000" / "arrays.npz"
    npz.write_bytes(npz.read_bytes()[: npz.stat().st_size // 2])


def _shift_lo(delta):
    return lambda t: _edit_json(t / "manifest.json", lambda mf: mf["shards"][1].__setitem__(
        "doc_lo", mf["shards"][1]["doc_lo"] + delta))


#: the reference's fault-injection cases: (mutation, message the error matches)
FAULTS = {
    "truncated": (_truncate, "truncat|corrupt"),
    "missing": (lambda t: (t / "shard_0001" / "arrays.npz").unlink(), "missing shard payload"),
    "count_mismatch": (lambda t: _edit_json(t / "manifest.json",
                                            lambda mf: mf.__setitem__("n_shards", 4)),
                       "shard-count mismatch"),
    "foreign_shard": (lambda t: _edit_json(t / "shard_0000" / "manifest.json",
                                           lambda mf: mf.__setitem__("n_shards", 5)),
                      "shard-count mismatch"),
    "overlap": (_shift_lo(-1), "tile"),
    "gap": (_shift_lo(+1), "tile"),
    "range_disagreement": (lambda t: _edit_json(
        t / "shard_0002" / "manifest.json",
        lambda mf: mf.__setitem__("doc_lo", mf["doc_lo"] + 1)), "doc range disagrees"),
    "version_top": (lambda t: _edit_json(t / "manifest.json", lambda mf: mf.__setitem__(
        "version", MANIFEST_VERSION + 1)), "version"),
    "version_shard": (lambda t: _edit_json(
        t / os.path.join("shard_0001", "manifest.json"),
        lambda mf: mf.__setitem__("version", MANIFEST_VERSION + 1)), "version"),
    "engine_skew": (lambda t: _edit_json(t / "shard_0001" / "manifest.json",
                                         lambda mf: mf.__setitem__("engine", "hnsw")), "skew"),
}


@pytest.mark.parametrize("fault", list(FAULTS))
def test_fault_injection(saved_tree, tmp_path, fault):
    """Every fault the reference's opener rejects raises ``ArtifactError``
    in the port, and in the reference on the same corrupted tree."""
    mutate, match = FAULTS[fault]
    tree = tmp_path / "tree"
    shutil.copytree(saved_tree, tree)
    mutate(tree)
    with pytest.raises(ArtifactError, match=match):
        open_retriever(tree, device="cpu")
    with pytest.raises(ref_api.ArtifactError, match=match):
        ref_api.open_retriever(tree)


def test_compressed_payload_not_mappable(collection, tmp_path):
    r = Retriever.build(collection.fwd, _cfg("flat", n_shards=2), device="cpu")
    art = r.save(tmp_path / "tree", compress=True)
    with pytest.raises(ArtifactError, match="compress=False"):
        mmap_npz(art / "shard_0000" / "arrays.npz")
    with pytest.raises(ArtifactError, match="compress=False"):
        open_retriever(art, device="cpu")


# -- the merge contract: sentinels never alias a document ------------------------------


def test_map_local_ids_never_aliases():
    """-1 padding must not alias local doc 0 and ids ≥ the shard size must
    not alias its last doc: both map to the out-of-corpus sentinel, as in
    the reference."""
    idmap = np.array([40, 41, 42, 43, 44, 100], np.int32)  # docs [40, 45); slot 5: sentinel
    ids = np.array([[-1, 0, 4, 5, 6, 2], [7, -9, 1, 3, 100, 0]], np.int32)
    out = map_local_ids(torch.from_numpy(idmap), torch.from_numpy(ids), 100)
    assert out.dtype == torch.int32
    assert out.tolist()[0] == [100, 40, 44, 100, 100, 42]
    ref = np.asarray(ref_api.map_local_ids(jnp.asarray(idmap), jnp.asarray(ids), 100))
    assert np.array_equal(out.numpy(), ref)


@pytest.mark.parametrize("dedupe", [False, True])
def test_sentinels_survive_merge_without_aliasing(dedupe):
    """-1 and ≥ n_docs ids carry the highest raw scores; the merge masks
    them so they never displace a real document, in both dedupe modes,
    and leaves its inputs as they were."""
    flat_ids = torch.tensor([[7, -1, 7, 99, 100, 3]], dtype=torch.int32)
    flat_scores = torch.tensor([[5.0, 9.0, 5.0, 1.0, 9.0, 2.0]])
    kept = flat_ids.clone(), flat_scores.clone()
    ids, scores = merge_topk(flat_ids, flat_scores, 4, dedupe=dedupe, n_docs_global=100)
    assert torch.equal(flat_ids, kept[0]) and torch.equal(flat_scores, kept[1])
    ids, scores = ids[0].numpy(), scores[0].numpy()
    finite = np.isfinite(scores)
    assert all(0 <= i < 100 for i in ids[finite])
    if dedupe:
        assert ids[finite].tolist() == [7, 3, 99] and scores[finite].tolist() == [5.0, 2.0, 1.0]
    else:
        assert ids[finite].tolist() == [7, 7, 3, 99]
        assert scores[finite].tolist() == [5.0, 5.0, 2.0, 1.0]
    ref = _host(ref_api.merge_topk(jnp.asarray(kept[0].numpy()), jnp.asarray(kept[1].numpy()),
                                   4, dedupe=dedupe, n_docs_global=100))
    assert np.array_equal(ids, ref[0][0]) and np.array_equal(scores, ref[1][0])


def test_merge_topk_matches_numpy_and_reference():
    """Randomized merge: ids from [-3, n_docs + 3) with per-id scores — the
    finite prefix equals a numpy top-k over the valid (unique, when
    deduping) candidates — and, with the same ids, scores full of ties;
    every output equals the reference's merge on the same inputs."""

    def merged(flat_ids, flat_scores, k, dedupe, n_docs):
        got = _host(merge_topk(torch.from_numpy(flat_ids), torch.from_numpy(flat_scores), k,
                               dedupe=dedupe, n_docs_global=n_docs))
        ref = _host(ref_api.merge_topk(jnp.asarray(flat_ids), jnp.asarray(flat_scores), k,
                                       dedupe=dedupe, n_docs_global=n_docs))
        assert np.array_equal(got[0], ref[0]) and np.array_equal(got[1], ref[1])
        return got

    def prop(n_docs, width, case_seed):
        rng = np.random.default_rng(case_seed)
        k = min(5, width)
        flat_ids = rng.integers(-3, n_docs + 3, size=(2, width)).astype(np.int32)
        tied = rng.integers(0, 3, size=(2, width)).astype(np.float32)
        injective = (1.0 + 0.5 * flat_ids).astype(np.float32)
        for dedupe in (False, True):
            merged(flat_ids, tied, k, dedupe, n_docs)
            ids, scores = merged(flat_ids, injective, k, dedupe, n_docs)
            for q in range(2):
                valid = flat_ids[q][(flat_ids[q] >= 0) & (flat_ids[q] < n_docs)]
                if dedupe:
                    valid = np.unique(valid)
                want = np.sort(valid)[::-1][:k]  # injective scores: sort by id
                finite = np.isfinite(scores[q])
                assert ids[q][finite].tolist() == want.tolist(), (dedupe, q)
                np.testing.assert_array_equal(scores[q][finite],
                                              (1.0 + 0.5 * want).astype(np.float32))

    run_property(prop, integers(4, 60), integers(1, 24), integers(0, 10**6), n_cases=30,
                 seed=5)


# -- prefetch: parity, counters, staged-buffer hygiene ---------------------------------


def test_prefetch_parity_and_counters(overlap, overlap_tree):
    """Prefetch on and off answer byte-identically at max_resident=1; the
    prefetcher consumes staged shards by the second rotation, and the
    disabled path counts neither hits nor misses."""
    _, Q = overlap
    off = _open(overlap_tree, prefetch=False)
    for _ in range(2):
        want = _host(off.search(Q))
    assert off.prefetch_hits == 0 and off.prefetch_misses == 0
    on = _open(overlap_tree, prefetch=True)
    for _ in range(2):
        got = _host(on.search(Q))
    assert _same(got, want)
    assert on.prefetch_hits > 0 and on.prefetch_misses >= 1
    assert on.prefetch_hits + on.prefetch_misses == 6  # every admission of two rotations
    assert on.builds >= 6 and off.builds == 6


def test_prefetch_peak_counts_completed_staged_build(overlap, overlap_tree):
    """DESIGN.md §11's contract: the peak is sampled before the staging
    buffer is consumed, so a COMPLETED staged build beside the resident
    shard counts. Waiting for the staged build makes the sample
    deterministic (the reference's test races the worker)."""
    _, Q = overlap
    off = _open(overlap_tree, prefetch=False)
    for _ in range(2):
        off.search(Q)
    on = _open(overlap_tree, prefetch=True)
    on.search(Q)
    on._staged[1].result()  # the wrap-around stage has landed
    on.search(Q)
    shard_bytes = [sum(int(a.nbytes) for a in sh.arrays.values()) for sh in on.shards]
    assert off.peak_resident_bytes == max(shard_bytes)
    assert max(shard_bytes) < on.peak_resident_bytes <= 2 * max(shard_bytes)


def test_prefetch_staged_discard_on_budget_change(overlap, overlap_tree):
    """A tombstone change retires the staged build whose budget went stale;
    the next rotation admits at the new budget, answering byte-identically
    to a fresh retriever with the same tombstones and with the reference's
    ids; no answer holds a tombstoned doc."""
    _, Q = overlap
    r = _open(overlap_tree, prefetch=True)
    r.search(Q)  # leaves the wrap-around shard staged
    assert r._staged is not None
    victims = np.asarray([0, 25, 59], np.int64)
    r.set_tombstones(victims)
    assert r._staged is None
    got = _host(r.search(Q))
    fresh = _open(overlap_tree, prefetch=False)
    fresh.set_tombstones(victims)
    assert _same(got, fresh.search(Q))
    assert not np.intersect1d(got[0].ravel(), victims).size
    ref = ref_api.open_retriever(overlap_tree)
    ref.use_mesh, ref.max_resident, ref.prefetch = False, 1, False
    ref.set_tombstones(victims)
    ref_ids, ref_scores = _host(ref.search(Q))
    assert np.array_equal(got[0], ref_ids)
    np.testing.assert_allclose(got[1], ref_scores, rtol=0, atol=ATOL)
    r.set_tombstones([])  # back to the plain budget: the tombstoned docs return
    assert _same(r.search(Q), _open(overlap_tree, prefetch=False).search(Q))


def test_uniform_tombstone_budgets(overlap):
    """Budgets are uniform across shards — min(n_docs_s, k + total) —
    while the per-shard tombstone counts stay local."""
    col, _ = overlap
    r = Retriever.build(col.fwd, RetrieverConfig(engine="flat", codec="streamvbyte", k=10,
                                                 n_shards=3), device="cpu")
    assert r._shard_k == [min(sh.n_docs, 10) for sh in r.shards]
    victims = np.asarray([0, 1, 59], np.int64)  # shards 0 and 2 only
    r.set_tombstones(victims)
    assert r._shard_k == [min(sh.n_docs, 10 + len(victims)) for sh in r.shards]
    assert r._shard_tombs[1] == 0 and sum(r._shard_tombs) == len(victims)
    with pytest.raises(ValueError, match="outside"):
        r.set_tombstones([60])


def test_tombstone_budget_contract():
    from repro.dist.sharding import tombstone_budget as ref_budget

    for args in [(10, 100, 0), (10, 100, 5), (10, 12, 5), (1, 1, 0)]:
        assert tombstone_budget(*args) == ref_budget(*args)
    assert tombstone_budget(10, 12, 5) == 12  # capped at the shard
    for bad in [(0, 10, 0), (10, 0, 0), (10, 10, -1)]:
        with pytest.raises(ValueError):
            tombstone_budget(*bad)


def test_staging_failure_reraises_on_the_serving_thread(overlap, overlap_tree, monkeypatch):
    """A failed staging build is not rebuilt in its place: the worker's
    exception re-raises where the serving thread consumes the staged
    shard."""
    _, Q = overlap
    r = _open(overlap_tree, prefetch=True)
    real = ShardedRetriever._place
    calls = []

    def place(self, arrays):
        calls.append(1)
        if len(calls) == 2:  # the first staged build, on the worker
            raise OSError("page-in failed")
        return real(self, arrays)

    monkeypatch.setattr(ShardedRetriever, "_place", place)
    with pytest.raises(OSError, match="page-in failed"):
        r.search(Q)
    assert r._staged is None
