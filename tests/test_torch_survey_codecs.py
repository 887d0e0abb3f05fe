"""The port's survey codecs (``vbyte``, ``elias_gamma``, ``elias_delta``,
``zeta``, ``dotnibble``; the rest of the paper's Table 1) against the
reference's: each document's encoded bytes, the round trip, the port's
vectorised byte count (``Codec.doc_bytes``), ``bits_per_component`` and
``ForwardIndex.storage_bytes`` for all nine codecs, on the reference
codec tests' edge cases and a seeded Zipf collection; and the paper's
size orderings (the reference's ``test_paper_size_orderings``) with the
codecs as cases."""

import numpy as np
import pytest

from repro.core import codecs as ref_codecs
from repro.core.forward_index import ForwardIndex as RefForwardIndex
from repro_torch.core import codecs
from repro_torch.core.codecs.bitio import BitReader, BitWriter, bit_length
from repro_torch.core.forward_index import ForwardIndex
from torch_cases import one_intra_op_thread  # noqa: F401  (autouse)

SURVEY = ["vbyte", "elias_gamma", "elias_delta", "zeta", "dotnibble"]
ALL = sorted(ref_codecs.available_codecs())

#: the reference's ``test_roundtrip_edges`` cases
EDGES = [
    np.array([0], dtype=np.uint32),  # component 0 (gap 0 at start)
    np.array([65535], dtype=np.uint32),  # max component
    np.array([0, 65535], dtype=np.uint32),  # max gap
    np.arange(64, dtype=np.uint32),  # all-ones gaps
    np.arange(0, 65536, 8192, dtype=np.uint32),  # large uniform gaps
    np.array([7], dtype=np.uint32),
    np.arange(9, dtype=np.uint32),  # a remainder past a whole group
]


def _zipf_docs(n_docs=150, dim=30522, nnz=119, seed=0):
    """The reference codec tests' clustered Zipf-ish documents."""
    rng = np.random.default_rng(seed)
    w = 1.0 / np.arange(1, dim + 1) ** 1.1
    w /= w.sum()
    return [np.unique(rng.choice(dim, size=nnz, p=w)).astype(np.uint32) for _ in range(n_docs)]


@pytest.fixture(scope="module")
def zipf():
    docs = _zipf_docs()
    docs += [np.zeros(0, np.uint32), np.arange(4, dtype=np.uint32), np.array([3, 9, 70000])]
    return docs


def _csr(docs):
    offsets = np.concatenate([[0], np.cumsum([len(d) for d in docs])]).astype(np.int64)
    comps = np.concatenate(docs).astype(np.uint32) if docs else np.zeros(0, np.uint32)
    return comps, offsets


def test_registry_names_every_reference_codec():
    assert codecs.available_codecs() == ALL
    for name in ALL:
        assert codecs.get_codec(name).supports_zero == ref_codecs.get_codec(name).supports_zero


@pytest.mark.parametrize("case", range(len(EDGES)))
@pytest.mark.parametrize("name", SURVEY)
def test_edge_bytes_roundtrip_and_count(name, case):
    comps = EDGES[case]
    port, ref = codecs.get_codec(name), ref_codecs.get_codec(name)
    buf = port.encode_doc(comps)
    assert buf == ref.encode_doc(comps)
    assert np.array_equal(port.decode_doc(buf, len(comps)), comps)
    assert port.doc_bytes(*_csr([comps])).tolist() == [len(buf)]


@pytest.mark.parametrize("name", SURVEY)
def test_zipf_collection_against_reference(name, zipf):
    port, ref = codecs.get_codec(name), ref_codecs.get_codec(name)
    counts = port.doc_bytes(*_csr(zipf))
    for i, c in enumerate(zipf):
        try:
            want = ref.encode_doc(c)
        except ValueError:  # DotNibble: a gap past 16 bits, as the reference raises
            with pytest.raises(ValueError):
                port.encode_doc(c)
            continue
        got = port.encode_doc(c)
        assert got == want, i
        assert counts[i] == len(got), i
        if len(c) and (name != "dotnibble" or c.max() < 65536):  # its remainder is raw u16
            assert np.array_equal(port.decode_doc(got, len(c)), c), i
    docs = [d for d in zipf if name != "dotnibble" or d.max(initial=0) < 65536]
    assert port.bits_per_component(docs) == ref.bits_per_component(docs)


@pytest.mark.parametrize("name", ["vbyte", "elias_gamma", "elias_delta", "zeta"])
def test_components_past_16_bits(name):
    """The universal codes and VByte take 32-bit components; DotNibble
    refuses a gap past 16 bits in its whole quads, as the reference."""
    rng = np.random.default_rng(4)
    docs = [np.sort(rng.choice(1 << 25, size=n, replace=False)).astype(np.uint32)
            for n in (1, 5, 40)] + [np.array([0, 1 << 24, (1 << 32) - 1], np.uint32)]
    port, ref = codecs.get_codec(name), ref_codecs.get_codec(name)
    counts = port.doc_bytes(*_csr(docs))
    for i, c in enumerate(docs):
        buf = port.encode_doc(c)
        assert buf == ref.encode_doc(c) and counts[i] == len(buf)
        assert np.array_equal(port.decode_doc(buf, len(c)), c)


def test_dotnibble_refuses_wide_gaps():
    doc = np.array([0, 1, 2, 70000, 70001], np.uint32)  # a wide gap inside the first quad
    for codec in (codecs.get_codec("dotnibble"), ref_codecs.get_codec("dotnibble")):
        with pytest.raises(ValueError, match="16-bit"):
            codec.encode_doc(doc)
    with pytest.raises(ValueError, match="16-bit"):
        codecs.get_codec("dotnibble").doc_bytes(*_csr([doc]))


@pytest.mark.parametrize("name", ALL)
def test_storage_bytes_equals_reference(name, zipf):
    docs = [d for d in zipf if d.max(initial=0) < 65536]  # uncompressed stores u16
    vals = [np.full(len(d), 0.5, np.float32) for d in docs]
    port = ForwardIndex.from_docs(list(zip(docs, vals)), 30522, value_format="f16")
    ref = RefForwardIndex.from_docs(list(zip(docs, vals)), 30522, value_format="f16")
    assert port.storage_bytes(name) == ref.storage_bytes(name)


def test_zeta_shard_size():
    docs = _zipf_docs(n_docs=20, seed=3)
    for k in (1, 2, 3, 5):
        port, ref = codecs.get_codec("zeta", k=k), ref_codecs.get_codec("zeta", k=k)
        counts = port.doc_bytes(*_csr(docs))
        for i, c in enumerate(docs):
            assert port.encode_doc(c) == ref.encode_doc(c) and counts[i] == len(port.encode_doc(c))
    with pytest.raises(ValueError):
        codecs.get_codec("zeta", k=0)


def test_bit_length_and_bit_io():
    x = np.array([0, 1, 2, 3, 4, 7, 8, 255, 256, 2**31 - 1, 2**31, 2**32 - 1, 2**32, 2**40 + 5],
                 np.uint64)
    assert bit_length(x).tolist() == [int(v).bit_length() for v in x]
    w = BitWriter()
    w.write_unary(3)
    w.write_bits(0b1011, 4)
    w.write_bit(1)
    assert len(w) == 9
    r = BitReader(w.getvalue())
    assert (r.read_unary(), r.read_bits(4), r.read_bit(), r.remaining()) == (3, 0b1011, 1, 7)


#: the reference's ``test_paper_size_orderings``, one invariant a case
ORDERINGS = [("below_16", n) for n in ALL if n != "uncompressed"] + [
    ("uncompressed_is_16", "uncompressed"), ("dotvbyte_le_streamvbyte", "dotvbyte"),
    ("zeta_lt_vbyte", "zeta")]


@pytest.mark.parametrize("rule,name", ORDERINGS, ids=[f"{r}-{n}" for r, n in ORDERINGS])
def test_paper_size_orderings(rule, name):
    """Table 1's qualitative structure on the Zipf documents: every codec
    below 16 bits, uncompressed exactly 16, DotVByte at most StreamVByte
    (1-bit vs 2-bit controls), Zeta below VByte."""
    docs = _zipf_docs()
    bpc = lambda n: codecs.get_codec(n).bits_per_component(docs)  # noqa: E731
    if rule == "below_16":
        assert bpc(name) < 16.0
    elif rule == "uncompressed_is_16":
        assert bpc(name) == 16.0
    elif rule == "dotvbyte_le_streamvbyte":
        assert bpc("dotvbyte") <= bpc("streamvbyte") + 1e-9
    else:
        assert bpc("zeta") < bpc("vbyte")
