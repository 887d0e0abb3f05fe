"""The mesh fan-out of the port (``torch.distributed``) against the
reference's ``shard_map`` programs, on the CPU.

* Host parity, no processes: ``ForwardIndex.padded``, ``pad_stack``,
  ``pack_blocks_sharded`` and ``build_shard_arrays`` byte for byte.
* Four gloo ranks (one spawn for the module): ``make_sharded_search``
  against the reference's per-shard pieces run one shard at a time
  (``vmap(search_one)`` on ``stacked[k][s]``, ``map_local_ids``, shard
  order, ``merge_topk``: the body of the reference's sharded search), on a
  ``(1, 4)`` and a ``(2, 2)`` mesh; ``ShardedRetriever(use_mesh=True)``
  against the sequential rotation on the fixtures of the reference's
  ``test_mesh_matches_sequential`` and ``test_mesh_serves_live_tombstones``.
* Eight gloo ranks: the doc-aligned scan on the data of the reference's
  ``test_doc_aligned_scan_matches_exact``.

Ranks use ``file://`` rendezvous in ``tmp_path``, a gloo timeout and a
spawn deadline, and one torch thread each (``tests/torch_mesh_cases.py``).
"""

import subprocess
import sys
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_mesh_cases import load, scan_ranks, serving_ranks
from torch_seismic_cases import bound_tolerance, probe_disagreements, reference_phase1

from repro.core import layout as ref_layout
from repro.core.forward_index import VALUE_FORMATS as REF_VF
from repro.core.forward_index import ForwardIndex as RefFwd
from repro.core.forward_index import pack_forward_index_sharded as ref_pack_sharded
from repro.serve import api as ref_api
from repro_torch.core import layout
from repro_torch.core.forward_index import ForwardIndex, pack_forward_index_sharded
from repro_torch.data.synthetic import SyntheticConfig, generate_collection
from repro_torch.launch.mesh import spawn_ranks
from repro_torch.serve import api
from repro_torch.serve.api import Retriever, RetrieverConfig

ROOT = __import__("pathlib").Path(__file__).resolve().parents[1]

#: the reference's test_dist.py budgets (Seismic's is not exhaustive)
SEISMIC = dict(cut=8, block_budget=256, n_probe=48, n_postings=300, block_size=16)
HNSW = dict(beam=48, iters=48, n_seeds=4, m=8, ef_construction=32)
#: the reference's mesh-vs-sequential fixture (tests/test_sharded_artifacts.py)
EXHAUSTIVE_SEISMIC = dict(cut=16, block_budget=512, n_probe=512, n_postings=10000, block_size=8)
VICTIMS = ([0, 11, 12, 30, 47], [1, 13, 14, 31, 46])
SPAWN_S = 120


def ref_fwd(fwd: ForwardIndex) -> RefFwd:
    return RefFwd(components=fwd.components, values=fwd.values, offsets=fwd.offsets,
                  dim=fwd.dim, value_format=REF_VF[fwd.value_format.name])


def assert_same_arrays(got: dict, want: dict):
    assert list(got) == list(want)
    for k in want:
        a, b = np.asarray(got[k]), np.asarray(want[k])
        assert a.dtype == b.dtype and a.shape == b.shape, (k, a.dtype, b.dtype, a.shape, b.shape)
        assert np.array_equal(a, b), k


@pytest.fixture(scope="module")
def corpus():
    """The reference's test_dist.py collection at a third of its size."""
    col = generate_collection(SyntheticConfig(name="t", dim=2048, n_docs=200, n_queries=8,
                                              doc_nnz_mean=60.0, query_nnz_mean=16.0, seed=0),
                              value_format="f16")
    Q = np.stack([col.query_dense(i) for i in range(col.n_queries)])
    return col.fwd, Q


# ---------------------------------------------------------------------------
# host parity
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("extra", [0, 1, 7])
def test_padded_matches_reference(corpus, extra):
    fwd = corpus[0].slice(3, 40)
    got, want = fwd.padded(fwd.n_docs + extra), ref_fwd(fwd).padded(fwd.n_docs + extra)
    assert got.n_docs == want.n_docs
    for f in ("components", "values", "offsets"):
        assert np.array_equal(getattr(got, f), getattr(want, f)), f
        assert getattr(got, f).dtype == getattr(want, f).dtype, f
    with pytest.raises(ValueError, match="cannot pad"):
        fwd.padded(fwd.n_docs - 1)


def test_pad_stack_matches_reference():
    rng = np.random.default_rng(3)
    dicts = [{"a": rng.integers(0, 9, (int(rng.integers(1, 5)), int(rng.integers(1, 6))))
              .astype(np.int32),
              "b": rng.random(int(rng.integers(1, 7))).astype(np.float16)} for _ in range(5)]
    pads = {"a": -1}
    assert_same_arrays(layout.pad_stack(dicts, pads), ref_layout.pad_stack(dicts, pads))
    assert_same_arrays(layout.pad_stack(dicts), ref_layout.pad_stack(dicts))
    with pytest.raises(ValueError, match="same fields"):
        layout.pad_stack([{"a": np.zeros(1)}, {"b": np.zeros(1)}])


@pytest.mark.parametrize("seg", [np.int32, np.int8], ids=["i32", "i8"])
@pytest.mark.parametrize("codec", ["dotvbyte", "streamvbyte", "bitpack", "uncompressed"])
def test_pack_blocks_sharded_matches_reference(corpus, codec, seg):
    fwd = corpus[0]
    for S in (3, 8):
        got, dl = layout.pack_blocks_sharded(fwd, S, codec=codec, block_size=128, seg_dtype=seg)
        want, dl_r = ref_layout.pack_blocks_sharded(ref_fwd(fwd), S, codec=codec,
                                                     block_size=128, seg_dtype=seg)
        assert dl == dl_r
        assert_same_arrays(got, want)


def test_pack_forward_index_sharded_alias(corpus):
    got, dl = pack_forward_index_sharded(corpus[0], 4, block_size=128, seg_dtype=np.int8)
    want, dl_r = ref_pack_sharded(ref_fwd(corpus[0]), 4, block_size=128, seg_dtype=np.int8)
    assert dl == dl_r
    assert_same_arrays(got, want)


SHARD_BUILDS = [("flat", "dotvbyte", False), ("flat", "bitpack", False),
                ("seismic", "dotvbyte", False), ("seismic", "bitpack", False),
                ("seismic", "dotvbyte", True), ("seismic", "bitpack", True),
                ("hnsw", "dotvbyte", False), ("hnsw", "bitpack", False)]


def _cfg(engine, codec, k=10):
    params = {"seismic": SEISMIC, "hnsw": HNSW, "flat": {}}[engine]
    return RetrieverConfig(engine=engine, codec=codec, k=k, params=params)


@pytest.mark.parametrize("engine,codec,host", SHARD_BUILDS,
                         ids=[f"{e}-{c}{'-host_index' if h else ''}" for e, c, h in SHARD_BUILDS])
def test_build_shard_arrays_matches_reference(corpus, engine, codec, host):
    fwd = corpus[0]
    n = 120 if engine == "hnsw" else fwd.n_docs  # the reference's graph build is Python loops
    fwd = fwd.slice(0, n)
    cfg = _cfg(engine, codec)
    ref_cfg = ref_api.RetrieverConfig(engine=engine, codec=codec, k=10, params=dict(cfg.params))
    kw, ref_kw = {}, {}
    if host:
        kw["host_index"] = api.get_engine(engine).host_index(fwd, cfg)
        ref_kw["host_index"] = ref_api.get_engine(engine).host_index(ref_fwd(fwd), ref_cfg)
    arrays, idmap, n_local = api.build_shard_arrays(fwd, cfg, 4, **kw)
    ref_arrays, ref_idmap, ref_n_local = ref_api.build_shard_arrays(ref_fwd(fwd), ref_cfg, 4,
                                                                    **ref_kw)
    assert n_local == ref_n_local
    assert_same_arrays({"idmap": idmap, **arrays},
                       {"idmap": np.asarray(ref_idmap), **{k: np.asarray(v)
                                                          for k, v in ref_arrays.items()}})


# ---------------------------------------------------------------------------
# four gloo ranks: make_sharded_search and ShardedRetriever's mesh path
# ---------------------------------------------------------------------------

SEARCH_CASES = [("flat", "dotvbyte", (1, 4)), ("hnsw", "streamvbyte", (1, 4)),
                ("seismic", "dotvbyte", (1, 4)), ("flat", "bitpack", (2, 2)),
                ("hnsw", "dotvbyte", (2, 2)), ("seismic", "bitpack", (2, 2))]


def _case_name(engine, codec, shape):
    return f"{engine}-{codec}-{shape[0]}x{shape[1]}"


@pytest.fixture(scope="module")
def mesh_fixture():
    """The reference's 48-doc mesh fixture (dim 256, S = 4)."""
    col = generate_collection(SyntheticConfig(name="mesh", dim=256, n_docs=48, n_queries=4,
                                              doc_nnz_mean=24.0, query_nnz_mean=8.0, seed=3),
                              value_format="f16")
    return col.fwd, np.stack([col.query_dense(i) for i in range(4)])


@pytest.fixture(scope="module")
def served(corpus, mesh_fixture, tmp_path_factory):
    """One four-rank spawn: every search case and every ShardedRetriever
    case, each rank's answers; and the stacked arrays the ranks served."""
    fwd, Q = corpus
    fwd = fwd.slice(0, 120)
    cases, stacks = {}, {}
    for engine, codec, shape in SEARCH_CASES:
        cfg = _cfg(engine, codec)
        arrays, idmap, n_local = api.build_shard_arrays(fwd, cfg, shape[1])
        stacks[engine, codec, shape] = (arrays, idmap, n_local, cfg)
        cases[_case_name(engine, codec, shape)] = dict(
            mesh=shape, cfg=cfg, arrays=arrays, idmap=idmap, n_local=n_local, n_docs=fwd.n_docs)
    out = tmp_path_factory.mktemp("serving")
    m_fwd, m_Q = mesh_fixture
    spawn_ranks(serving_ranks, 4, str(out), cases, torch.from_numpy(Q), m_fwd,
                torch.from_numpy(m_Q), [("flat", {}), ("seismic", EXHAUSTIVE_SEISMIC)],
                [list(v) for v in VICTIMS], "cpu", backend="gloo", init_file=out / "init",
                timeout_s=SPAWN_S)
    return load(str(out), 4), stacks, fwd, Q


def reference_oracle(arrays, idmap, n_local, cfg, n_docs, Q):
    """The body of the reference's sharded search, run one shard at a time
    in this process: ``vmap(search_one)`` on ``stacked[k][s]``,
    ``map_local_ids``, concatenation in shard order, ``merge_topk``."""
    impl = ref_api.get_engine(cfg.engine)
    ref_cfg = ref_api.RetrieverConfig(engine=cfg.engine, codec=cfg.codec, k=cfg.k,
                                      params=dict(cfg.params))
    ids, scores = [], []
    for s in range(idmap.shape[0]):
        shard = {k: jnp.asarray(v[s]) for k, v in arrays.items()}
        i, sc = jax.vmap(partial(impl.search_one, ref_cfg, n_local, 1.0, shard))(jnp.asarray(Q))
        ids.append(ref_api.map_local_ids(jnp.asarray(idmap[s]), i, n_docs))
        scores.append(sc)
    flat_i, flat_s = jnp.concatenate(ids, axis=1), jnp.concatenate(scores, axis=1)
    gi, gs = ref_api.merge_topk(flat_i, flat_s, cfg.k, dedupe=impl.dedupe_merge,
                                n_docs_global=n_docs)
    return np.asarray(gi), np.asarray(gs)


def seismic_probes_agree(arrays, n_local, cfg, Q) -> np.ndarray:
    """C3's tie rule on every shard: each probe disagreement with the
    reference's phase 1 is a near tie → per query, whether every shard
    probed the reference's blocks (where it did, the ids must be equal)."""
    impl = api.get_engine("seismic")
    agree = np.ones(len(Q), bool)
    Qt = torch.from_numpy(Q)
    for s in range(arrays["cbs"].shape[0]):
        shard = {k: torch.from_numpy(np.ascontiguousarray(v[s])) for k, v in arrays.items()}
        est_r, cand_r, probe_r = reference_phase1({k: jnp.asarray(v[s]) for k, v in
                                                   arrays.items()}, Q, cfg.params)
        est_p, cand_p, probe_p = (t.numpy() for t in impl.probe(cfg, shard, Qt))
        assert np.array_equal(cand_p, cand_r)
        tol = bound_tolerance(shard, Qt, torch.from_numpy(cand_p)).numpy()
        dis = probe_disagreements(est_p, probe_p, est_r, probe_r, cand_p, tol)
        assert all(d["max_ratio"] <= 1.0 for d in dis), dis
        for d in dis:
            agree[d["query"]] = False
    return agree


@pytest.mark.parametrize("engine,codec,shape", SEARCH_CASES,
                         ids=[_case_name(*c) for c in SEARCH_CASES])
def test_sharded_search_matches_reference_oracle(served, engine, codec, shape):
    ranks, stacks, fwd, Q = served
    arrays, idmap, n_local, cfg = stacks[engine, codec, shape]
    want_i, want_s = reference_oracle(arrays, idmap, n_local, cfg, fwd.n_docs, Q)
    name = _case_name(engine, codec, shape)
    got_i, got_s = ranks[0][f"{name}/ids"], ranks[0][f"{name}/scores"]
    for r in ranks[1:]:  # every rank returns the global answer, bit for bit
        assert np.array_equal(r[f"{name}/ids"], got_i)
        assert np.array_equal(r[f"{name}/scores"], got_s)
    assert got_i.shape == (len(Q), cfg.k)
    rows = np.ones(len(Q), bool)
    if engine == "seismic":
        rows = seismic_probes_agree(arrays, n_local, cfg, Q)
        assert rows.mean() >= 0.5
    assert np.array_equal(got_i[rows], want_i[rows])
    np.testing.assert_allclose(got_s[rows], want_s[rows], rtol=1e-5, atol=0)


@pytest.mark.parametrize("tag", ["none", "v0", "v1"])
@pytest.mark.parametrize("engine", ["flat", "seismic"])
def test_mesh_matches_sequential_bitwise(served, engine, tag):
    """``use_mesh=True`` (and None, with four ranks for four shards) equals
    ``use_mesh=False`` bit for bit, with no tombstones and with each of
    the reference's two victim sets; no victim is served."""
    ranks = served[0]
    for r in ranks:
        want_i, want_s = r[f"{engine}/{tag}/False/ids"], r[f"{engine}/{tag}/False/scores"]
        for mode in ("True", "None"):
            assert np.array_equal(r[f"{engine}/{tag}/{mode}/ids"], want_i), mode
            assert np.array_equal(r[f"{engine}/{tag}/{mode}/scores"], want_s), mode
        assert np.array_equal(want_i, ranks[0][f"{engine}/{tag}/False/ids"])
    if tag != "none":
        victims = VICTIMS[int(tag[1])]
        assert not np.intersect1d(ranks[0][f"{engine}/{tag}/True/ids"], victims).size


def test_use_mesh_true_with_too_few_ranks_raises_in_the_group(served):
    for r in served[0]:
        assert int(r["few/raised"]) == 1
        assert np.array_equal(r["few/none/ids"], r["few/false/ids"])
        assert np.array_equal(r["few/none/scores"], r["few/false/scores"])


def test_use_mesh_without_a_process_group(mesh_fixture):
    """A plain process: True raises naming the count, None serves the
    rotation (as today), bit for bit equal to False."""
    fwd, Q = mesh_fixture
    r = Retriever.build(fwd, RetrieverConfig(engine="flat", k=10, n_shards=4), device="cpu")
    r.use_mesh = True
    with pytest.raises(ValueError, match="0 rank"):
        r.search(Q)
    r.use_mesh = None
    ids_n, sc_n = r.search(Q)
    r.use_mesh = False
    ids_f, sc_f = r.search(Q)
    assert torch.equal(ids_n, ids_f) and torch.equal(sc_n, sc_f)


# ---------------------------------------------------------------------------
# eight gloo ranks: the doc-aligned scan
# ---------------------------------------------------------------------------

SCAN_CODECS = ["dotvbyte", "streamvbyte", "bitpack", "uncompressed"]


@pytest.fixture(scope="module")
def scanned(tmp_path_factory):
    """The reference test's data: 200 docs of 1–149 entries at dim 4096,
    f16, 8 shards of blocks of 128 with the int8 seg; 3 queries of 30
    entries."""
    rng = np.random.default_rng(0)
    dim = 4096
    docs = []
    for _ in range(200):
        n = int(rng.integers(1, 150))
        c = np.sort(rng.choice(dim, size=n, replace=False))
        docs.append((c, rng.gamma(2., .5, size=n).astype(np.float32)))
    fwd = ForwardIndex.from_docs(docs, dim, value_format="f16")
    Q = np.zeros((3, dim), np.float32)
    for i in range(3):
        qc = rng.choice(dim, 30, replace=False)
        Q[i, qc] = rng.gamma(2., .5, size=30)
    packs = {}
    for codec in SCAN_CODECS:
        packs[codec], docs_local = pack_forward_index_sharded(fwd, 8, codec=codec,
                                                              block_size=128, seg_dtype=np.int8)
    out = tmp_path_factory.mktemp("scan")
    spawn_ranks(scan_ranks, 8, str(out), packs, docs_local, torch.from_numpy(Q), (2, 4), "cpu",
                backend="gloo", init_file=out / "init", timeout_s=SPAWN_S)
    return load(str(out), 8), fwd, Q


@pytest.mark.parametrize("form", ["batch", "single"])
@pytest.mark.parametrize("codec", SCAN_CODECS)
def test_doc_aligned_scan_matches_exact(scanned, codec, form):
    ranks, fwd, Q = scanned
    got = np.concatenate([r[f"{codec}/{form}"] for r in ranks], axis=1)  # rank order = P(axes)
    want = np.stack([fwd.exact_scores(q) for q in (Q if form == "batch" else Q[:1])])
    assert got.shape[1] >= fwd.n_docs
    assert np.abs(got[:, : fwd.n_docs] - want).max() < 2e-3


def test_mesh_modules_import_no_jax():
    code = (
        "import sys\n"
        "import repro_torch.dist, repro_torch.dist.sharding, repro_torch.dist.compression\n"
        "import repro_torch.launch.mesh, repro_torch.serve.api, repro_torch.serve.sharded\n"
        "import repro_torch.core.scoring, repro_torch.train.train_step\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'repro'))\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120,
                   env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"})
