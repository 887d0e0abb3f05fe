"""The port's HNSW engine against the reference: the host graph is
byte-identical (levels, base-layer adjacency, seed nodes, edge count) on
the same collection and params; the host reference search returns the
same ids and scores; the batched engine's top-k ids equal the reference
``open_retriever(path).search(Q)`` (``backend="jnp"``) on the same
artifact for every row codec × value codec, under both port backends;
artifacts cross between the packages byte for byte.

Ids are compared exactly; scores at rtol 1e-5 / atol 1e-4 (the same f32
products summed in another order). Host scores are one numpy expression
on the same operands in both packages, so they are compared exactly."""

import jax.numpy as jnp  # noqa: F401  (the reference runs on jax's CPU backend)
import numpy as np
import pytest
import torch

from repro.core.forward_index import ForwardIndex as RefForwardIndex
from repro.core.hnsw import HNSWIndex as RefHNSWIndex
from repro.core.hnsw import HNSWParams as RefHNSWParams
from repro.data import synthetic as ref_synthetic
from repro.serve import api as ref_api
from repro_torch.core.forward_index import VALUE_FORMATS, ForwardIndex
from repro_torch.core.hnsw import HNSWIndex, HNSWParams
from repro_torch.kernels import rows_dot
from repro_torch.serve import api
from torch_cases import VARIANTS

RTOL, ATOL = 1e-5, 1e-4
#: the reference CLI's hnsw build parameters
BUILD = dict(m=16, ef_construction=48)
SEARCH = dict(beam=64, iters=64, n_seeds=8)


def _port_fwd(fwd) -> ForwardIndex:
    return ForwardIndex(fwd.components, fwd.values, fwd.offsets, fwd.dim,
                        VALUE_FORMATS[fwd.value_format.name])


def _collection(dim, n_docs, seed, n_queries=6):
    kw = dict(name="splade", dim=dim, n_docs=n_docs, n_queries=n_queries, seed=seed)
    col = ref_synthetic.generate_collection(ref_synthetic.SyntheticConfig(**kw),
                                            value_format="f16")
    Q = np.stack([col.query_dense(i) for i in range(col.n_queries)])
    return col, Q


#: (dim, n_docs, build params): the CLI's parameters at two vocabularies,
#: and a base-layer degree set explicitly
GRAPHS = {
    "dim2048": (2048, 400, BUILD),
    "dim30522": (30522, 200, BUILD),
    "m0": (2048, 250, dict(m=8, m0=12, ef_construction=32, seed=3)),
}


@pytest.fixture(scope="module", params=list(GRAPHS))
def graphs(request):
    dim, n_docs, params = GRAPHS[request.param]
    col, Q = _collection(dim, n_docs, seed=1)
    ref = RefHNSWIndex.build(col.fwd, RefHNSWParams(**params))
    port = HNSWIndex.build(_port_fwd(col.fwd), HNSWParams(**params))
    return col, Q, ref, port


@pytest.fixture(scope="module")
def served():
    """One reference host graph that every variant's artifact serves."""
    col, Q = _collection(2048, 200, seed=4)
    index = RefHNSWIndex.build(col.fwd, RefHNSWParams(**BUILD))
    return col, Q, index


def _same_graph(ref, port):
    assert port.levels.dtype == ref.levels.dtype
    assert port.levels.tobytes() == ref.levels.tobytes()
    assert (port.entry, port.max_level, port.n_edges) == (ref.entry, ref.max_level, ref.n_edges)
    assert port.graph == ref.graph
    for layer in range(len(ref.graph)):
        assert port.adjacency(layer).tobytes() == ref.adjacency(layer).tobytes()
    for n in (1, 8, 64):
        assert port.seed_nodes(n).tobytes() == ref.seed_nodes(n).tobytes()


def test_graph_is_byte_identical(graphs):
    _, _, ref, port = graphs
    _same_graph(ref, port)
    assert port.adjacency(0).shape == (port.fwd.n_docs + 1, port.params.degree(0))
    for codec in ("uncompressed", "dotvbyte", "bitpack"):
        assert port.index_bytes(codec) == ref.index_bytes(codec)


@pytest.mark.parametrize("codec", ["uncompressed", "dotvbyte"])
def test_host_search_matches_reference(graphs, codec):
    _, Q, ref, port = graphs
    for q in Q:
        want_ids, want_scores = ref.search(q, k=10, ef=64, codec=codec)
        ids, scores = port.search(q, k=10, ef=64, codec=codec)
        np.testing.assert_array_equal(ids, want_ids)
        assert scores.tobytes() == want_scores.tobytes()


def test_tiny_index_matches_reference():
    """The one-document index of ``tests/test_hnsw.py``: the graph, the
    host search and the engine (beam 8, 4 steps, 2 seeds) agree."""
    docs = [(np.array([3, 7], np.uint32), np.array([1.0, 2.0], np.float32))]
    params = dict(m=4, ef_construction=8)
    ref = RefHNSWIndex.build(RefForwardIndex.from_docs(docs, dim=16), RefHNSWParams(**params))
    port = HNSWIndex.build(ForwardIndex.from_docs(docs, dim=16), HNSWParams(**params))
    _same_graph(ref, port)
    q = np.zeros(16, np.float32)
    q[7] = 1.0
    ids, scores = port.search(q, k=1)
    assert ids.tolist() == [0] and scores[0] == pytest.approx(2.0)
    cfg = dict(engine="hnsw", k=1, params=dict(beam=8, iters=4, n_seeds=2))
    want_ids, want_scores = ref_api.Retriever.from_host_index(
        ref, ref_api.RetrieverConfig(backend="jnp", **cfg)).search(q[None, :])
    got_ids, got_scores = api.Retriever.from_host_index(
        port, api.RetrieverConfig(backend="cuda", **cfg), device="cpu").search(q[None, :])
    np.testing.assert_array_equal(got_ids.numpy(), np.asarray(want_ids))
    np.testing.assert_allclose(got_scores.numpy(), np.asarray(want_scores), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("codec,vq", VARIANTS, ids=[f"{c}-{v}" for c, v in VARIANTS])
def test_reference_artifact_serves_identically(served, tmp_path, codec, vq):
    """The reference saves the artifact; the port opens it byte-equal and
    its top-k ids equal the reference's on it, under both backends."""
    _, Q, index = served
    ref_api.Retriever.from_host_index(index, ref_api.RetrieverConfig(
        engine="hnsw", codec=codec, vq=vq, backend="jnp", params={**SEARCH, **BUILD}),
    ).save(tmp_path / "ref")
    ref = ref_api.open_retriever(tmp_path / "ref")
    want_ids, want_scores = (np.asarray(a) for a in ref.search(Q))
    port = api.open_retriever(tmp_path / "ref", device="cpu")
    assert (port.cfg.engine, port.cfg.codec, port.cfg.vq) == ("hnsw", codec, vq)
    assert port.cfg.params == {**SEARCH, **BUILD}
    for k, v in ref.arrays.items():
        got = port.arrays[k].numpy()
        assert got.dtype == np.asarray(v).dtype and got.tobytes() == np.asarray(v).tobytes(), k
    before = rows_dot.launches
    for backend in ("torch", "cuda"):  # cuda: the kernel's plain version on CPU tensors
        r = api.Retriever(port.cfg.replace(backend=backend), port.arrays, n_docs=port.n_docs,
                          dim=port.dim, value_scale=port.value_scale,
                          value_format=port.value_format, device="cpu")
        ids, scores = r.search(Q)
        assert ids.dtype == torch.int32 and ids.shape == (len(Q), 10)
        np.testing.assert_array_equal(ids.numpy(), want_ids)
        np.testing.assert_allclose(scores.numpy(), want_scores, rtol=RTOL, atol=ATOL)
    assert rows_dot.launches == before  # CPU tensors launch nothing


@pytest.mark.parametrize("codec,vq", [("dotvbyte", "f16"), ("bitpack", "pq")])
def test_port_artifact_opens_in_reference(served, tmp_path, codec, vq):
    """The port builds its own graph and saves it; the reference opens it
    byte-equal and returns the same ids."""
    col, Q, _ = served
    r = api.Retriever.build(_port_fwd(col.fwd), api.RetrieverConfig(
        engine="hnsw", codec=codec, vq=vq, backend="cuda", params=BUILD), device="cpu")
    r.save(tmp_path / "port")
    ref = ref_api.open_retriever(tmp_path / "port")
    assert ref.cfg.backend == "pallas" and ref.cfg.engine == "hnsw"
    assert sorted(ref.arrays) == sorted(r.arrays)
    for k, v in r.arrays.items():
        assert np.asarray(ref.arrays[k]).tobytes() == v.numpy().tobytes(), k
    ids, scores = r.search(Q)
    ref_cpu = ref_api.Retriever(ref.cfg.replace(backend="jnp"), ref.arrays, n_docs=ref.n_docs,
                                dim=ref.dim, value_scale=ref.value_scale,
                                value_format=ref.value_format)
    want_ids, want_scores = (np.asarray(a) for a in ref_cpu.search(Q))
    np.testing.assert_array_equal(ids.numpy(), want_ids)
    np.testing.assert_allclose(scores.numpy(), want_scores, rtol=RTOL, atol=ATOL)


def test_from_reference_arrays_and_host_index(served):
    """The reference's arrays cross as they are; a port host graph built
    once serves both backends as ``Retriever.build`` would."""
    col, Q, index = served
    cfg = dict(engine="hnsw", codec="streamvbyte", vq="u8_sq", params=BUILD)
    r = ref_api.Retriever.from_host_index(index, ref_api.RetrieverConfig(backend="jnp", **cfg))
    want_ids = np.asarray(r.search(Q)[0])
    host = {k: np.asarray(v) for k, v in r.arrays.items()}
    manifest = ref_api.manifest_dict(r.cfg, host, n_docs=r.n_docs, dim=r.dim,
                                     value_scale=r.value_scale, value_format=r.value_format)
    port = api.Retriever(api.cfg_from_manifest(manifest),
                         api.from_reference_arrays(manifest, host, device="cpu"),
                         n_docs=r.n_docs, dim=r.dim, value_scale=r.value_scale,
                         value_format=r.value_format, device="cpu")
    np.testing.assert_array_equal(port.search(Q)[0].numpy(), want_ids)

    from repro_torch.serve.engines.hnsw import HNSWEngine

    pcfg = api.RetrieverConfig(**cfg)
    graph = HNSWEngine().host_index(_port_fwd(col.fwd), pcfg)
    built = api.Retriever.build(_port_fwd(col.fwd), pcfg, device="cpu")
    for backend in ("torch", "cuda"):
        h = api.Retriever.from_host_index(graph, pcfg.replace(backend=backend), device="cpu")
        assert sorted(h.arrays) == sorted(built.arrays)
        for k in h.arrays:
            assert torch.equal(h.arrays[k], built.arrays[k]), k
        np.testing.assert_array_equal(h.search(Q)[0].numpy(), want_ids)


def test_n_seeds_above_beam_raises_in_both(served):
    col, _, _ = served
    params = dict(beam=4, n_seeds=8)
    with pytest.raises(ValueError, match="n_seeds must not exceed beam width"):
        ref_api.Retriever.build(col.fwd, ref_api.RetrieverConfig(engine="hnsw", params=params))
    with pytest.raises(ValueError, match="n_seeds must not exceed beam width"):
        api.Retriever.build(_port_fwd(col.fwd), api.RetrieverConfig(engine="hnsw",
                                                                    params=params),
                            device="cpu")
    with pytest.raises(ValueError, match="unknown 'hnsw' engine params"):
        api.Retriever.build(_port_fwd(col.fwd), api.RetrieverConfig(engine="hnsw",
                                                                    params={"cut": 3}),
                            device="cpu")


def test_zero_and_one_component_queries(served):
    """An all-zero query (every score 0: the order is the tie order) and a
    one-component query give the reference's ids."""
    col, Q, index = served
    Qx = np.zeros((3, col.fwd.dim), np.float32)
    Qx[1, int(col.fwd.components[5])] = 1.5
    Qx[2] = Q[0]
    cfg = dict(engine="hnsw", codec="dotvbyte", params=SEARCH)
    want_ids, want_scores = (np.asarray(a) for a in ref_api.Retriever.from_host_index(
        index, ref_api.RetrieverConfig(backend="jnp", **cfg)).search(Qx))
    r = api.Retriever.from_host_index(
        HNSWIndex.build(_port_fwd(col.fwd), HNSWParams(**BUILD)),
        api.RetrieverConfig(backend="cuda", **cfg), device="cpu")
    ids, scores = r.search(Qx)
    np.testing.assert_array_equal(ids.numpy(), want_ids)
    np.testing.assert_allclose(scores.numpy(), want_scores, rtol=RTOL, atol=ATOL)
    assert np.all(scores.numpy()[0] == 0)


def test_k_above_beam_raises_where_the_reference_raises(served):
    """C1: the final top-k over a beam of 8 at k = 10 raises ValueError in
    both packages, with the same message."""
    col, Q, index = served
    cfg = dict(engine="hnsw", k=10, params=dict(beam=8, iters=4, n_seeds=4))
    with pytest.raises(ValueError, match="k argument to top_k") as ref_err:
        ref_api.Retriever.from_host_index(
            index, ref_api.RetrieverConfig(backend="jnp", **cfg)).search(Q)
    r = api.Retriever.from_host_index(HNSWIndex.build(_port_fwd(col.fwd), HNSWParams(**BUILD)),
                                      api.RetrieverConfig(**cfg), device="cpu")
    with pytest.raises(ValueError, match="k argument to top_k") as err:
        r.search(Q)
    assert "got k=10 with shape=" in str(err.value)
    assert "k=10" in str(ref_err.value)
