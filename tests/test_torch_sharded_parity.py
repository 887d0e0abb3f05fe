"""The port's sharded top-k against the reference's on the same tree, on
the CPU.

For every engine × codec × S ∈ {1, 2, 4, 7} at the reference's budgets,
exhaustive for its 50-doc fixture (``tests/test_sharded_artifacts.py``),
the port builds and saves a tree, and both packages open it
memory-mapped and search it: the ids are equal and the scores within
atol 2e-3 (f16 values summed in another order). The port's own sharded
invariants are in ``tests/test_torch_sharded.py``, the CLI in
``tests/test_torch_sharded_cli.py``."""

import jax.numpy as jnp  # noqa: F401  (the reference runs on jax's CPU backend)
import numpy as np
import pytest
import torch

from repro.serve import api as ref_api
from repro.serve import sharded as ref_sharded
from repro_torch.core.layout import available_layouts
from repro_torch.data.synthetic import SyntheticConfig, generate_collection
from repro_torch.serve.api import Retriever, RetrieverConfig, open_retriever
from repro_torch.serve.sharded import ShardedRetriever

ENGINE_PARAMS = {
    "seismic": dict(cut=16, block_budget=512, n_probe=512, n_postings=10000, block_size=8),
    "hnsw": dict(beam=56, iters=56, n_seeds=4, m=8, ef_construction=48),
    "flat": {},
}
ATOL = 2e-3


@pytest.fixture(scope="module")
def collection():
    col = generate_collection(SyntheticConfig(
        name="shard-test", dim=256, n_docs=50, n_queries=4, doc_nnz_mean=24.0,
        query_nnz_mean=8.0, seed=7), value_format="f16")
    return col, np.stack([col.query_dense(i) for i in range(col.n_queries)])


@pytest.mark.parametrize("n_shards", [1, 2, 4, 7])
@pytest.mark.parametrize("codec", available_layouts())
@pytest.mark.parametrize("engine", ["seismic", "hnsw", "flat"])
def test_reference_sharded_ids_on_the_same_tree(collection, tmp_path, engine, codec, n_shards):
    col, Q = collection
    cfg = RetrieverConfig(engine=engine, codec=codec, k=10, n_shards=n_shards,
                          params=ENGINE_PARAMS[engine])
    built = Retriever.build(col.fwd, cfg, device="cpu")
    art = built.save(tmp_path / "tree", compress=False)
    port = open_retriever(art, device="cpu")
    ref = ref_api.open_retriever(art)
    if n_shards > 1:
        assert isinstance(port, ShardedRetriever) and isinstance(ref, ref_sharded.ShardedRetriever)
        for sh in (*port.shards, *ref.shards):
            assert all(isinstance(a, np.memmap) for a in sh.arrays.values() if a.size)
    ids, scores = (t.numpy() for t in port.search(Q))
    assert all(torch.equal(a, b) for a, b in zip(built.search(Q), (torch.from_numpy(ids),
                                                                  torch.from_numpy(scores))))
    ref_ids, ref_scores = (np.asarray(t) for t in ref.search(Q))
    assert np.array_equal(ids, ref_ids)
    np.testing.assert_allclose(scores, ref_scores, rtol=0, atol=ATOL)
