"""The port's host codecs and value codecs against the reference: each
document's encoded bytes, ``ForwardIndex.storage_bytes`` (the paper's
space metric, counted vectorised in the port), the bitpack word
packers, and the value codecs' encoded bytes and decoded values.

Byte streams are compared exactly. Decoded values are compared at
rtol 1e-6: both sides compute ``lo + code·step`` in f32, but XLA may
fuse the multiply and add where torch rounds each."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import codecs as ref_codecs
from repro.core import values as ref_values
from repro.core.codecs import bitpack as ref_bitpack
from repro.core.forward_index import ForwardIndex as RefForwardIndex
from repro.data import synthetic as ref_synthetic
from repro_torch.core import codecs, values
from repro_torch.core.codecs import bitpack
from repro_torch.core.forward_index import ForwardIndex
from torch_cases import CODECS, VQS, edge_docs, wide_docs
from torch_cases import one_intra_op_thread  # noqa: F401  (autouse)


@pytest.fixture(scope="module")
def collection():
    kw = dict(name="splade", dim=30522, n_docs=300, n_queries=2, seed=9)
    return ref_synthetic.generate_collection(ref_synthetic.SyntheticConfig(**kw),
                                             value_format="f16")


def _docs(codec):
    """Edge documents; wide-vocabulary ones too where the codec takes
    components past 2**16."""
    rng = np.random.default_rng(2)
    docs = edge_docs(30522, rng, n_random=30)
    if codec in ("streamvbyte", "bitpack"):
        return docs + wide_docs(1 << 25, rng), 1 << 25
    return docs, 30522


@pytest.mark.parametrize("codec", CODECS)
def test_encode_doc_matches_reference(codec):
    docs, dim = _docs(codec)
    fwd = ForwardIndex.from_docs(docs, dim, "f16")
    port, ref = codecs.get_codec(codec), ref_codecs.get_codec(codec)
    sizes = port.doc_bytes(fwd.components, fwd.offsets)
    for d in range(fwd.n_docs):
        comps = fwd.components[fwd.offsets[d] : fwd.offsets[d + 1]]
        buf = port.encode_doc(comps)
        assert buf == ref.encode_doc(comps), d
        assert sizes[d] == len(buf)
        np.testing.assert_array_equal(port.decode_doc(buf, len(comps)), comps)


@pytest.mark.parametrize("codec", CODECS)
def test_storage_bytes_matches_reference(collection, codec):
    col = collection.fwd
    ref = RefForwardIndex(col.components, col.values, col.offsets, col.dim, col.value_format)
    port = ForwardIndex(col.components, col.values, col.offsets, col.dim)
    assert port.storage_bytes(codec) == ref.storage_bytes(codec)


def test_codec_registry_matches_reference():
    assert set(CODECS) <= set(codecs.available_codecs())
    assert codecs.available_codecs() == sorted(ref_codecs.available_codecs())
    with pytest.raises(KeyError, match="unknown codec"):
        codecs.get_codec("zeta3")
    with pytest.raises(ValueError, match="16-bit"):
        codecs.get_codec("uncompressed").encode_doc(np.array([70000]))


@pytest.mark.parametrize("width", [1, 3, 5, 15, 17, 31, 32])
def test_pack_unpack_block_match_reference(width):
    rng = np.random.default_rng(width)
    gaps = rng.integers(0, 1 << width, size=77, dtype=np.uint64).astype(np.uint32)
    words = bitpack.pack_block(gaps, width)
    assert words.tobytes() == ref_bitpack.pack_block(gaps, width).tobytes()
    np.testing.assert_array_equal(bitpack.unpack_block(words, width, 77), gaps)
    np.testing.assert_array_equal(bitpack.bit_widths(gaps),
                                  [int(g).bit_length() for g in gaps])


# -- value codecs ----------------------------------------------------------------


def _rows(seed=0, n=40, cap=256):
    rng = np.random.default_rng(seed)
    nnz = rng.integers(0, cap + 1, size=n).astype(np.int32)
    nnz[:3] = [0, cap, 1]
    vals = (rng.gamma(2, .5, size=(n, cap)) * (np.arange(cap) < nnz[:, None])).astype(np.float16)
    vals[3, : nnz[3]] = 1.5  # a constant row: hi == lo
    return vals, nnz


@pytest.mark.parametrize("vq,clip", [(vq, None) for vq in VQS] + [
    ("u8_sq", (0.0, 4.0)), ("u4_sq", (0.0, 4.0))])
def test_encode_rows_values_matches_reference(vq, clip):
    vals, nnz = _rows()
    got_codes, got_extra = values.encode_rows_values(vals, nnz, vq, clip=clip)
    want_codes, want_extra = ref_values.encode_rows_values(vals, nnz, vq, clip=clip)
    assert got_codes.dtype == want_codes.dtype and got_codes.tobytes() == want_codes.tobytes()
    assert sorted(got_extra) == sorted(want_extra)
    for k, v in want_extra.items():
        assert got_extra[k].dtype == v.dtype and got_extra[k].tobytes() == v.tobytes(), k


def test_pq_codes_chunked_equal_unchunked():
    """Codes over chunks of sub-vectors equal the reference's one-shot
    assignment, ties included (duplicate centroids, repeated values)."""
    vals, nnz = _rows(seed=3, n=64)
    v = vals.astype(np.float32)
    live = np.arange(v.shape[1])[None, :] < nnz[:, None]
    cb = values.fit_pq_codebook(v.reshape(-1, 2)[live[:, ::2].reshape(-1)])
    assert cb.tobytes() == ref_values.fit_pq_codebook(
        v.reshape(-1, 2)[live[:, ::2].reshape(-1)]).tobytes()
    cb[1] = cb[0]  # a tie: the lower index must win
    want = ref_values._pq_codes(v, cb)
    for chunk in (None, 1, 7, 1000):
        got = values._pq_codes(v, cb, chunk=chunk)
        assert got.dtype == want.dtype and got.tobytes() == want.tobytes(), chunk


@pytest.mark.parametrize("vq", VQS)
def test_decode_codes_matches_reference(vq):
    vals, nnz = _rows(seed=1)
    codes, extra = ref_values.encode_rows_values(vals, nnz, vq)
    ref_args = {"lo": None, "step": None, "codebook_flat": None}
    if vq in ("u8_sq", "u4_sq"):
        lo_key, sc_key = ref_values.sq_keys(vq)
        ref_args.update(lo=jnp.asarray(extra[lo_key]), step=jnp.asarray(extra[sc_key]))
    elif vq == "pq":
        ref_args.update(codebook_flat=jnp.asarray(extra["vq_codebook"]).reshape(-1))
    want = np.asarray(ref_values.decode_codes(vq, jnp.asarray(codes), **ref_args))
    port = {"vals_rows": torch.from_numpy(codes),
            **{k: torch.from_numpy(v) for k, v in extra.items()}}
    assert values.infer_rows_vq(port) == ref_values.infer_rows_vq(extra) == vq
    streams = values.rows_vq_streams(vq, port)
    assert len(streams) == values.n_vq_streams(vq) == ref_values.n_vq_streams(vq)
    kw = {}
    if vq in ("u8_sq", "u4_sq"):
        kw = dict(lo=streams[0], step=streams[1])
    elif vq == "pq":
        kw = dict(codebook_flat=streams[0])
    got = values.decode_codes(vq, port["vals_rows"], **kw)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)
    assert values.code_factor(vq) * codes.shape[1] == vals.shape[1]
    assert values.value_payload_bytes(port) == ref_values.value_payload_bytes(
        {"vals_rows": codes, **extra})


def test_nibbles_round_trip():
    codes = np.random.default_rng(0).integers(0, 16, size=(5, 64)).astype(np.uint8)
    packed = values.pack_nibbles(codes)
    assert packed.tobytes() == ref_values.pack_nibbles(codes).tobytes()
    np.testing.assert_array_equal(values.unpack_nibbles(torch.from_numpy(packed)).numpy(), codes)
    with pytest.raises(ValueError, match="unknown value codec"):
        values.check_vq("u2_sq")
