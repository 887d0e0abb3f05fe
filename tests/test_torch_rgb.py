"""The port's Recursive Graph Bisection (``repro_torch/core/rgb.py``) and
``ForwardIndex.apply_component_permutation`` against the reference's:
the permutation byte for byte on two seeded collections (one at the
SPLADE vocabulary), ``log_gap_cost``, the permuted index array for
array, and the permuted index's flat ids on the CPU against the
unpermuted exact top-k under permuted queries."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.core import rgb as ref_rgb
from repro.core.forward_index import ForwardIndex as RefForwardIndex
from repro_torch.core import rgb
from repro_torch.core.forward_index import ForwardIndex
from repro_torch.core.seismic import exact_top_k
from repro_torch.data.synthetic import SyntheticConfig, generate_collection
from repro_torch.serve.api import Retriever, RetrieverConfig


def _clustered_docs(rng, dim=2048, n_docs=400):
    """The reference RGB tests' clustered, label-scrambled documents."""
    centers = rng.integers(0, dim, size=24)
    docs = []
    for _ in range(n_docs):
        c = rng.choice(centers, size=2)
        comps = np.unique(np.clip(np.concatenate([rng.normal(x, 40, 30).astype(int) for x in c]),
                                  0, dim - 1)).astype(np.uint32)
        docs.append(comps)
    relabel = rng.permutation(dim).astype(np.uint32)
    return [np.sort(relabel[c]) for c in docs]


@pytest.fixture(scope="module")
def splade():
    """A few hundred SPLADE-statistics docs at the full vocabulary."""
    col = generate_collection(SyntheticConfig(name="splade", dim=30522, n_docs=300, n_queries=6,
                                              seed=4), value_format="f16")
    fwd = col.fwd
    docs = [fwd.components[fwd.offsets[i]:fwd.offsets[i + 1]] for i in range(fwd.n_docs)]
    Q = np.stack([col.query_dense(i) for i in range(col.n_queries)])
    return fwd, docs, Q


@pytest.fixture(scope="module")
def splade_pi(splade):
    fwd, docs, _ = splade
    return rgb.recursive_graph_bisection(docs, fwd.dim, max_iters=6, leaf_size=32, seed=0)


@pytest.mark.parametrize("max_iters,leaf_size", [(6, 32), (3, 16)])
def test_permutation_equals_reference_clustered(max_iters, leaf_size):
    docs = _clustered_docs(np.random.default_rng(1))
    kw = dict(max_iters=max_iters, leaf_size=leaf_size, seed=0)
    got = rgb.recursive_graph_bisection(docs, 2048, **kw)
    want = ref_rgb.recursive_graph_bisection(docs, 2048, **kw)
    assert got.dtype == want.dtype and got.tobytes() == want.tobytes()
    assert np.array_equal(np.sort(got), np.arange(2048, dtype=np.uint32))


def test_permutation_equals_reference_at_full_width(splade, splade_pi):
    """Table 1's settings (max_iters 6, leaf 32, seed 0) at dim 30,522."""
    fwd, docs, _ = splade
    want = ref_rgb.recursive_graph_bisection(docs, fwd.dim, max_iters=6, leaf_size=32, seed=0)
    assert splade_pi.tobytes() == want.tobytes()


def test_log_gap_cost_equals_reference_and_falls(splade, splade_pi):
    fwd, docs, _ = splade
    permuted = [np.sort(splade_pi[c]) for c in docs]
    for d in (docs, permuted, [np.zeros(0, np.uint32)]):
        assert rgb.log_gap_cost(d) == ref_rgb.log_gap_cost(d)
    assert rgb.log_gap_cost(permuted) < rgb.log_gap_cost(docs)


def test_apply_component_permutation_equals_reference(splade, splade_pi):
    fwd, _, Q = splade
    got = fwd.apply_component_permutation(splade_pi)
    ref = RefForwardIndex(fwd.components, fwd.values, fwd.offsets, fwd.dim, fwd.value_format)
    want = ref.apply_component_permutation(splade_pi)
    for name in ("components", "values", "offsets"):
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype and np.array_equal(a, b), name
    assert got.dim == want.dim and got.value_format == fwd.value_format
    q = Q[0]
    qp = rgb.apply_permutation_dense(q, splade_pi)
    assert np.array_equal(qp, ref_rgb.apply_permutation_dense(q, splade_pi))
    np.testing.assert_allclose(got.exact_scores(qp), fwd.exact_scores(q), rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError, match="permutation length"):
        fwd.apply_component_permutation(splade_pi[:-1])


def test_permuted_flat_ids_equal_unpermuted_exact_top_k(splade, splade_pi):
    """The flat engine over the permuted index, on the CPU through the
    rows kernel's plain version, returns the unpermuted exact top-10 for
    permuted queries (a swap only between scores tied within f32
    rounding)."""
    fwd, _, Q = splade
    permuted = fwd.apply_component_permutation(splade_pi)
    Qp = np.stack([rgb.apply_permutation_dense(q, splade_pi) for q in Q])
    for codec in ("dotvbyte", "streamvbyte", "bitpack", "uncompressed"):
        r = Retriever.build(permuted, RetrieverConfig(engine="flat", codec=codec, k=10,
                                                      backend="cuda"), device="cpu")
        ids, scores = (t.numpy() for t in r.search(Qp))
        for i, q in enumerate(Q):
            want_ids, want_sc = exact_top_k(fwd, q, 10)
            np.testing.assert_allclose(scores[i], want_sc, rtol=1e-5, atol=1e-5)
            diff = ids[i] != want_ids
            assert not diff.any() or np.allclose(scores[i][diff], want_sc[diff], rtol=1e-6), (
                codec, i)


def test_no_jax_on_import():
    code = ("import sys; import repro_torch.core.rgb, repro_torch.core.codecs, "
            "repro_torch.core.forward_index, repro_torch.launch.serve; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'repro')); "
            "assert not bad, bad")
    src = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120,
                   env=dict(os.environ, PYTHONPATH=src))


def test_rows_of_the_permuted_index_pack():
    """The permuted index packs into rows for every codec (RGB may move a
    gap past 8 bits; the row codecs take it)."""
    from repro_torch.core.layout import pack_rows

    docs = _clustered_docs(np.random.default_rng(2), dim=2048, n_docs=60)
    fwd = ForwardIndex.from_docs([(d, np.ones(len(d))) for d in docs], 2048, value_format="f16")
    pi = rgb.recursive_graph_bisection(docs, 2048, max_iters=2)
    permuted = fwd.apply_component_permutation(pi)
    for codec in ("dotvbyte", "streamvbyte", "bitpack", "uncompressed"):
        rows = pack_rows(permuted, codec=codec)
        assert rows.arrays()["nnz_rows"][:-1].tolist() == np.diff(permuted.offsets).tolist()
    assert torch.equal(torch.from_numpy(permuted.offsets), torch.from_numpy(fwd.offsets))
