"""The port's host-side build is byte-identical to the reference's:
the synthetic generator, ``pack_rows`` and the Seismic engine arrays,
on the same seed."""

import numpy as np
import pytest

from repro.core import layout as ref_layout
from repro.core.forward_index import ForwardIndex as RefForwardIndex
from repro.core.seismic import SeismicIndex as RefSeismicIndex
from repro.core.seismic import SeismicParams as RefSeismicParams
from repro.data import synthetic as ref_synthetic
from repro.serve.api import RetrieverConfig as RefConfig
from repro.serve.engines.seismic import SeismicEngine as RefSeismicEngine
from repro_torch.core import layout
from repro_torch.core.forward_index import ForwardIndex
from repro_torch.core.seismic import SeismicIndex, SeismicParams
from repro_torch.data import synthetic
from repro_torch.serve.api import RetrieverConfig
from repro_torch.serve.engines.seismic import SeismicEngine
from torch_cases import VARIANTS, edge_docs, wide_docs
from torch_cases import one_intra_op_thread  # noqa: F401  (autouse)

SIZES = [(2048, 400), (30522, 200)]


def _collections(dim, n_docs):
    kw = dict(name="splade", dim=dim, n_docs=n_docs, n_queries=6, seed=3)
    ref = ref_synthetic.generate_collection(ref_synthetic.SyntheticConfig(**kw), value_format="f16")
    port = synthetic.generate_collection(synthetic.SyntheticConfig(**kw), value_format="f16")
    return ref, port


@pytest.fixture(scope="module", params=SIZES, ids=lambda s: f"dim{s[0]}")
def collections(request):
    return _collections(*request.param)


def assert_same_arrays(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for k in want:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        assert g.dtype == w.dtype and g.shape == w.shape, k
        assert g.tobytes() == w.tobytes(), k


def test_generator_matches_reference(collections):
    ref, port = collections
    for field in ("components", "values", "offsets"):
        r, p = getattr(ref.fwd, field), getattr(port.fwd, field)
        assert r.dtype == p.dtype and r.tobytes() == p.tobytes(), field
    assert port.fwd.dim == ref.fwd.dim
    assert port.fwd.value_format.name == ref.fwd.value_format.name
    assert len(port.query_comps) == len(ref.query_comps)
    for a, b in zip(port.query_comps + port.query_vals, ref.query_comps + ref.query_vals):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    np.testing.assert_array_equal(port.query_dense(2), ref.query_dense(2))


@pytest.mark.parametrize("codec", ["dotvbyte", "uncompressed"])
def test_pack_rows_matches_reference(collections, codec):
    ref, port = collections
    r = ref_layout.pack_rows(ref.fwd, codec=codec)
    p = layout.pack_rows(port.fwd, codec=codec)
    assert p.l_max == r.l_max and p.n_docs == r.n_docs
    assert_same_arrays(p.arrays(), r.arrays())


@pytest.mark.parametrize("dim", [2048, 30522])
@pytest.mark.parametrize("l_max", [None, 384])
def test_pack_rows_edge_docs_match_reference(dim, l_max):
    docs = edge_docs(dim, np.random.default_rng(dim), n_random=20)
    ref = ref_layout.pack_rows(
        RefForwardIndex.from_docs(docs, dim, value_format="f16"), codec="dotvbyte", l_max=l_max)
    port = layout.pack_rows(
        ForwardIndex.from_docs(docs, dim, value_format="f16"), codec="dotvbyte", l_max=l_max)
    assert port.l_max == ref.l_max == (l_max or 256)
    assert_same_arrays(port.arrays(), ref.arrays())
    # doc_range packs shard-local rows, also byte-equal
    assert_same_arrays(
        layout.pack_rows(ForwardIndex.from_docs(docs, dim, "f16"), "dotvbyte",
                         doc_range=(1, 9)).arrays(),
        ref_layout.pack_rows(RefForwardIndex.from_docs(docs, dim, "f16"), "dotvbyte",
                             doc_range=(1, 9)).arrays(),
    )


@pytest.mark.parametrize("block_size,n_postings", [(64, 2000), (8, 40)])
def test_seismic_arrays_match_reference(collections, block_size, n_postings):
    ref, port = collections
    kw = dict(n_postings=n_postings, block_size=block_size)
    ref_index = RefSeismicIndex.build(ref.fwd, RefSeismicParams(**kw))
    index = SeismicIndex.build(port.fwd, SeismicParams(**kw))
    for field in ("comp_block_indptr", "block_doc_indptr", "block_docs",
                  "summary_indptr", "summary_comps", "summary_vals"):
        r, p = getattr(ref_index, field), getattr(index, field)
        assert r.dtype == p.dtype and r.tobytes() == p.tobytes(), field
    params = dict(cut=8, block_budget=512, n_probe=64, **kw)
    want = RefSeismicEngine().arrays_from_index(
        ref_index, RefConfig(engine="seismic", codec="dotvbyte", params=params))
    got = SeismicEngine().arrays_from_index(
        index, RetrieverConfig(engine="seismic", codec="dotvbyte", params=params))
    assert_same_arrays(got, want)


def test_unported_value_codec_raises():
    """Every value codec of the reference packs; an unknown name raises."""
    fwd = ForwardIndex.from_docs([(np.array([1, 2]), np.array([0.5, 1.0]))], 16, "f16")
    rows = layout.pack_rows(fwd, codec="dotvbyte", vq="u8_sq")
    assert rows.vals_rows.dtype == np.uint8 and "vq_lo_rows" in rows.payload
    with pytest.raises(ValueError, match="unknown value codec"):
        layout.pack_rows(fwd, codec="dotvbyte", vq="nope")


def test_gap_helpers_and_control_bits_match_reference(collections):
    from repro.core.codecs import base as ref_base
    from repro.core.codecs import dotvbyte as ref_dotvbyte
    from repro_torch.core.codecs import base, dotvbyte

    ref, port = collections
    for d in range(0, port.fwd.n_docs, 37):
        comps = port.fwd.doc(d)[0]
        gaps = base.gaps_from_components(comps)
        want = ref_base.gaps_from_components(comps)
        assert gaps.dtype == want.dtype and gaps.tobytes() == want.tobytes()
        np.testing.assert_array_equal(base.components_from_gaps(gaps), comps)
        np.testing.assert_array_equal(dotvbyte.control_bits(gaps),
                                      ref_dotvbyte.control_bits(want))
    with pytest.raises(ValueError, match="16-bit"):
        dotvbyte.control_bits(np.array([70000]))
    with pytest.raises(ValueError, match="strictly increasing"):
        base.gaps_from_components(np.array([3, 3]))


@pytest.mark.parametrize("codec,vq", VARIANTS, ids=[f"{c}-{v}" for c, v in VARIANTS])
def test_pack_rows_every_variant_matches_reference(collections, codec, vq):
    ref, port = collections
    r = ref_layout.pack_rows(ref.fwd, codec=codec, vq=vq)
    p = layout.pack_rows(port.fwd, codec=codec, vq=vq)
    assert p.l_max == r.l_max and p.vq == r.vq == vq
    assert_same_arrays(p.arrays(), r.arrays())


@pytest.mark.parametrize("codec,vq", VARIANTS, ids=[f"{c}-{v}" for c, v in VARIANTS])
def test_pack_rows_edge_docs_every_variant_match_reference(codec, vq):
    """Edge rows, a forced capacity and shard-local ``doc_range`` packs;
    for the codecs that take them, gaps past 2**16 too."""
    dim = 30522
    docs = edge_docs(dim, np.random.default_rng(4), n_random=12)
    if codec != "dotvbyte":
        dim = 1 << 25
        docs += wide_docs(dim, np.random.default_rng(5), n_random=3)
    for kw in ({}, {"l_max": 384}, {"doc_range": (1, 9)}):
        ref = ref_layout.pack_rows(RefForwardIndex.from_docs(docs, dim, "f16"),
                                   codec=codec, vq=vq, **kw)
        port = layout.pack_rows(ForwardIndex.from_docs(docs, dim, "f16"),
                                codec=codec, vq=vq, **kw)
        assert port.l_max == ref.l_max
        assert_same_arrays(port.arrays(), ref.arrays())


@pytest.mark.parametrize("codec,vq", [("streamvbyte", "u8_sq"), ("bitpack", "pq"),
                                      ("uncompressed", "u4_sq")])
def test_seismic_arrays_every_codec_match_reference(collections, codec, vq):
    ref, port = collections
    kw = dict(n_postings=40, block_size=8)
    params = dict(cut=8, block_budget=512, n_probe=64, **kw)
    want = RefSeismicEngine().arrays_from_index(
        RefSeismicIndex.build(ref.fwd, RefSeismicParams(**kw)),
        RefConfig(engine="seismic", codec=codec, vq=vq, params=params))
    got = SeismicEngine().arrays_from_index(
        SeismicIndex.build(port.fwd, SeismicParams(**kw)),
        RetrieverConfig(engine="seismic", codec=codec, vq=vq, params=params))
    assert_same_arrays(got, want)
