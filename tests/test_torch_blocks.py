"""The port's full-scan block path against the reference, on the same
seeded inputs:

* packs — ``layout.pack_blocks`` arrays byte-identical to the
  reference's for every codec × seg dtype × value format, and
  ``encode_block_values`` under every quantized value codec; a
  reference pack crosses into the port's ``PackedBlocks``;
* slot scores — the plain versions behind the port's
  ``block_scan.*_block_scores{,_batch}`` and ``bitpack_block_scores_w``
  (what the entries run on CPU tensors) equal the reference's XLA
  lowering of the same tile program (``*_block_scores_xla{,_batch}``,
  ``bitpack_block_scores_w_xla``), rtol = atol = 1e-5 (the same f32
  products, summed in another order);
* the whole scan — ``scoring.score_packed{,_batch}`` (every codec and
  vq) and ``ops.score_*`` on CPU equal the reference's ``score_packed``
  and ``ops.score_*(mode="pallas_compiled")``, and ``exact_scores``
  (atol 2e-3: f16 values).

``pallas_interpret`` is no target: the reference's block scan does not
run in that mode under the installed jax."""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import layout as ref_layout
from repro.core import scoring as ref_scoring
from repro.core import values as ref_values
from repro.core.forward_index import ForwardIndex as RefForwardIndex
from repro.kernels import bitpack_dot as ref_bitpack_dot
from repro.kernels import dotvbyte_dot as ref_dotvbyte_dot
from repro.kernels import ops as ref_ops
from repro.kernels import streamvbyte_dot as ref_streamvbyte_dot
from repro.kernels import tiles as ref_tiles
from repro_torch.core import layout, scoring, values
from repro_torch.core.forward_index import ForwardIndex, PackedBlocks, pack_forward_index
from repro_torch.kernels import block_scan, build, ops
from torch_cases import CODECS, VQS, edge_docs, wide_docs

RTOL = ATOL = 1e-5
EXACT_ATOL = 2e-3
BLOCK_CODECS = ("dotvbyte", "streamvbyte", "bitpack")
VALUE_FORMATS = ("f32", "f16", "fixedu8")
WIDE_DIM = (1 << 24) + (1 << 20)

_REF_XLA = {
    "dotvbyte": (ref_dotvbyte_dot.dotvbyte_block_scores_xla,
                 ref_dotvbyte_dot.dotvbyte_block_scores_xla_batch),
    "streamvbyte": (ref_streamvbyte_dot.streamvbyte_block_scores_xla,
                    ref_streamvbyte_dot.streamvbyte_block_scores_xla_batch),
    "bitpack": (ref_bitpack_dot.bitpack_block_scores_xla,
                ref_bitpack_dot.bitpack_block_scores_xla_batch),
}
_PORT = {
    "dotvbyte": (block_scan.dotvbyte_block_scores, block_scan.dotvbyte_block_scores_batch),
    "streamvbyte": (block_scan.streamvbyte_block_scores,
                    block_scan.streamvbyte_block_scores_batch),
    "bitpack": (block_scan.bitpack_block_scores, block_scan.bitpack_block_scores_batch),
}


def _both(docs, dim, vf):
    return (RefForwardIndex.from_docs(docs, dim, value_format=vf),
            ForwardIndex.from_docs(docs, dim, value_format=vf))


def _queries(rng, nq, dim, nnz=43):
    Q = np.zeros((nq, dim), np.float32)
    for i in range(nq - 1):
        Q[i, rng.choice(dim, size=nnz, replace=False)] = rng.gamma(2, .5, nnz)
    Q[-1] = rng.random(dim)  # one dense query touches every component
    return Q


def _lane_pad(Q):
    return np.pad(Q, [(0, 0), (0, (-Q.shape[-1]) % 128)])


def _assert_same_arrays(ref, port):
    a, b = ref.as_dict(), port.as_dict()
    assert list(a) == list(b)
    for k in a:
        got = b[k].numpy() if isinstance(b[k], torch.Tensor) else b[k]
        assert got.dtype == a[k].dtype and got.shape == a[k].shape, k
        assert got.tobytes() == np.asarray(a[k]).tobytes(), k
    for k in ("codec", "block_size", "n_docs", "dim", "vq"):
        assert getattr(ref, k) == getattr(port, k), k
    assert ref.value_format.name == port.value_format.name


# -- packs ------------------------------------------------------------------------


@pytest.fixture(scope="module")
def edge():
    return edge_docs(2048, np.random.default_rng(3), n_random=40, full=700)


@pytest.mark.parametrize("vf", VALUE_FORMATS)
@pytest.mark.parametrize("seg", ["i32", "i8"])
@pytest.mark.parametrize("codec", CODECS)
def test_pack_blocks_byte_identical(edge, codec, seg, vf):
    """i8 seg packs at D = 5, so blocks also close on slots; the 700-entry
    doc spans several blocks."""
    ref_fwd, fwd = _both(edge, 2048, vf)
    kw = dict(codec=codec, block_size=128, seg_dtype=np.int8 if seg == "i8" else np.int32,
              max_docs_per_block=5 if seg == "i8" else None)
    ref = ref_layout.pack_blocks(ref_fwd, **kw)
    port = layout.pack_blocks(fwd, **kw)
    _assert_same_arrays(ref, port)
    assert port.n_blocks % 8 and port.max_docs_per_block == (5 if seg == "i8" else 16)
    assert ref_layout._fragments(ref_fwd, 128, 16) == layout._fragments(fwd, 128, 16)


@pytest.mark.parametrize("vq", VQS[1:])
def test_block_values_byte_identical(edge, vq):
    ref_fwd, fwd = _both(edge, 2048, "f16")
    ref = ref_layout.pack_blocks(ref_fwd, codec="dotvbyte", block_size=256, vq=vq)
    _assert_same_arrays(ref, layout.pack_blocks(fwd, codec="dotvbyte", block_size=256, vq=vq))
    raw = layout.pack_blocks(fwd, block_size=256)  # f16 values, as stored
    for clip in (None, (0.25, 3.0)):
        want = ref_values.encode_block_values(raw.vals, raw.seg, vq, clip=clip)
        got = values.encode_block_values(raw.vals, raw.seg, vq, clip=clip)
        assert got[0].tobytes() == want[0].tobytes()
        assert sorted(got[1]) == sorted(want[1])
        for k in want[1]:
            assert got[1][k].tobytes() == want[1][k].tobytes(), k


def test_pack_blocks_rejects_what_the_reference_rejects(edge):
    fwd = ForwardIndex.from_docs(edge, 2048, value_format="f16")
    with pytest.raises(ValueError, match="multiple of 128"):
        layout.pack_blocks(fwd, block_size=200)
    with pytest.raises(ValueError, match="int8 seg"):
        layout.pack_blocks(fwd, block_size=2048, seg_dtype=np.int8)
    with pytest.raises(ValueError, match="unknown value codec"):
        layout.pack_blocks(fwd, vq="u2")
    assert pack_forward_index(fwd, codec="bitpack").as_dict().keys() == \
        layout.pack_blocks(fwd, codec="bitpack").as_dict().keys()


@pytest.mark.parametrize("codec", CODECS)
def test_reference_pack_crosses_into_port(edge, codec):
    ref_fwd, _ = _both(edge, 2048, "fixedu8")
    ref = ref_layout.pack_blocks(ref_fwd, codec=codec, block_size=128, vq="u4_sq")
    port = PackedBlocks.from_dict(ref.as_dict(), codec=codec, block_size=128,
                                  n_docs=ref.n_docs, dim=ref.dim, value_format="fixedu8",
                                  vq="u4_sq")
    _assert_same_arrays(ref, port)
    _assert_same_arrays(ref, port.to("cpu"))
    assert port.payload_bytes() == ref.payload_bytes()
    Q = _queries(np.random.default_rng(1), 2, 2048)
    np.testing.assert_allclose(scoring.score_packed_batch(Q, port).numpy(),
                               np.asarray(ref_scoring.score_packed_batch(jnp.asarray(Q), ref)),
                               rtol=RTOL, atol=ATOL)
    with pytest.raises(ValueError, match="unknown PackedBlocks fields"):
        PackedBlocks.from_dict({**ref.as_dict(), "extra": ref.seg}, codec=codec, block_size=128,
                               n_docs=ref.n_docs, dim=ref.dim, value_format="fixedu8")


# -- slot scores vs the reference's tile program ---------------------------------------

#: name → (docs builder, dim, value format, block size, seg dtype, max docs/block)
SLOT_CASES = {
    "edge": (lambda rng: edge_docs(2048, rng, n_random=40, full=700), 2048, "fixedu8", 128,
             np.int8, 5),
    "one_doc": (lambda rng: [(np.sort(rng.choice(30522, 300, replace=False)),
                              rng.gamma(2, .5, 300))], 30522, "f32", 256, np.int32, None),
    "wide": (lambda rng: wide_docs(WIDE_DIM, rng), WIDE_DIM, "f16", 128, np.int32, None),
    # t runs past 2**31 inside a block: 128 two-entry docs whose gap is ~2**24
    "wrap": (lambda rng: [(np.array([i, WIDE_DIM - 1 - i]), np.ones(2)) for i in range(300)],
             WIDE_DIM, "f16", 256, np.int32, 200),
}


def _slot_case(name, codec):
    build_docs, dim, vf, T, seg, D = SLOT_CASES[name]
    rng = np.random.default_rng(len(name))
    ref_fwd, fwd = _both(build_docs(rng), dim, vf)
    kw = dict(codec=codec, block_size=T, seg_dtype=seg, max_docs_per_block=D)
    ref, port = ref_layout.pack_blocks(ref_fwd, **kw), layout.pack_blocks(fwd, **kw).to("cpu")
    # two dense queries at the wide vocabulary (each is 71 MB), three otherwise
    Q = rng.random((2, dim)).astype(np.float32) if dim > 1 << 16 else _queries(rng, 3, dim)
    return ref_fwd, ref, port, Q


def _ref_streams(ref):
    keys = ("ctrl", "data") if ref.codec != "bitpack" else ("words", "widths")
    return [jnp.asarray(getattr(ref, k)) for k in keys] + [
        jnp.asarray(getattr(ref, k)) for k in ("seg", "start_pos", "start_abs", "vals")]


def _port_streams(port):
    keys = ("ctrl", "data") if port.codec != "bitpack" else ("words", "widths")
    return [getattr(port, k) for k in (*keys, "seg", "start_pos", "start_abs", "vals")]


@pytest.mark.parametrize("case,codec", [(c, k) for c in SLOT_CASES for k in BLOCK_CODECS
                                        if not (c in ("wide", "wrap") and k == "dotvbyte")])
def test_slot_scores_match_reference_tile_program(case, codec):
    ref_fwd, ref, port, Q = _slot_case(case, codec)
    if case == "wrap":  # the case reaches what it is named for
        gaps = scoring.decode_block_gaps(codec, port.as_dict(), port.block_size)
        assert int((gaps.long() & 0xFFFFFFFF).sum(-1).max()) > 2**31
    scale = float(ref.value_format.scale)
    single, batch = _REF_XLA[codec]
    Qp = jnp.asarray(_lane_pad(Q))
    want_b = np.asarray(batch(Qp, *_ref_streams(ref), scale=scale))
    want_1 = np.asarray(single(Qp[0], *_ref_streams(ref), scale=scale))
    port_1, port_b = _PORT[codec]
    Qt = torch.from_numpy(Q)
    got_b = port_b(Qt, *_port_streams(port), scale=scale)
    got_1 = port_1(Qt[0], *_port_streams(port), scale=scale)
    assert got_b.shape == (len(Q), port.n_blocks, port.max_docs_per_block)
    np.testing.assert_allclose(got_b.numpy(), want_b, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got_1.numpy(), want_1, rtol=RTOL, atol=ATOL)
    # slot scores scattered to documents are the documents' exact scores
    exact = np.stack([ref_fwd.exact_scores(q) for q in Q])
    docs = scoring.scatter_block_scores(got_b, port.doc_ids, port.n_docs).numpy()
    np.testing.assert_allclose(docs, exact, rtol=RTOL, atol=EXACT_ATOL)


@pytest.mark.parametrize("case", ["edge", "wrap"])
def test_static_width_slot_scores_match_reference(case):
    """``bitpack_block_scores_w`` per width bucket over tight words, as
    ``score_bitpack_bucketed`` slices them."""
    _, ref, port, Q = _slot_case(case, "bitpack")
    scale = float(ref.value_format.scale)
    T = ref.block_size
    widths = sorted(set(ref.widths.tolist()))
    assert len(widths) > 1 or case == "wrap"
    for w in widths:
        sel = np.flatnonzero(ref.widths == w)
        words = ref_ops.pad_to(ref.words[sel, : (T * w + 31) // 32], 128, axis=1)
        rest = [getattr(ref, k)[sel] for k in ("seg", "start_pos", "start_abs", "vals")]
        want = np.asarray(ref_bitpack_dot.bitpack_block_scores_w_xla(
            jnp.asarray(_lane_pad(Q[:1]))[0], jnp.asarray(words), *map(jnp.asarray, rest),
            width=w, scale=scale))
        got = block_scan.bitpack_block_scores_w(
            torch.from_numpy(Q[0]), torch.from_numpy(words), *map(torch.from_numpy, rest),
            width=w, scale=scale)
        np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


def test_slot_reduction_semantics():
    """Slot d sums [start_pos[d], end_d): end_d = start_pos[d+1] where
    that is larger, else T; slot 0 always used, a later slot iff
    start_pos[d] > 0."""
    prod = torch.arange(1.0, 9.0).reshape(1, 8)  # entries 1..8
    sp = torch.tensor([[0, 3, 5, 0]], dtype=torch.int32)
    got = scoring.block_slot_scores(prod, sp)
    torch.testing.assert_close(got, torch.tensor([[1 + 2 + 3, 4 + 5, 6 + 7 + 8, 0.0]]))
    want = np.asarray(ref_scoring.block_slot_scores(jnp.asarray(prod.numpy()),
                                                    jnp.asarray(sp.numpy())))
    np.testing.assert_array_equal(got.numpy(), want)
    # doc_ids -1 (an unused slot) drops in the scatter
    out = scoring.scatter_block_scores(got, torch.tensor([[1, 0, 1, -1]]), 2)
    torch.testing.assert_close(out, torch.tensor([9.0, 6.0 + 21.0]))


@pytest.mark.parametrize("vq", VQS)
def test_tile_program_every_vq_matches_reference(edge, vq):
    """``tile_scores{,_batch}`` with the dequant stage of every value
    codec, on one pack's decoded gaps, against ``tiles.tile_scores*``."""
    ref_fwd, fwd = _both(edge, 2048, "f16")
    ref = ref_layout.pack_blocks(ref_fwd, codec="bitpack", block_size=128, vq=vq)
    port = layout.pack_blocks(fwd, codec="bitpack", block_size=128, vq=vq).to("cpu")
    Q = _queries(np.random.default_rng(8), 2, 2048)
    gaps = scoring.decode_block_gaps("bitpack", port.as_dict(), 128)
    extras = [getattr(port, k) for k in ("vq_lo", "vq_scale", "vq_codebook")]
    args = (gaps, port.seg, port.start_pos, port.start_abs, port.vals, 0.5, vq, *extras)
    ref_args = [jnp.asarray(np.asarray(a)) if a is not None else None for a in (
        gaps.numpy(), ref.seg, ref.start_pos, ref.start_abs, ref.vals)] + [0.5, vq] + [
        None if a is None else jnp.asarray(a) for a in (ref.vq_lo, ref.vq_scale, ref.vq_codebook)]
    np.testing.assert_allclose(
        block_scan.tile_scores_batch(torch.from_numpy(Q), *args).numpy(),
        np.asarray(ref_tiles.tile_scores_batch(jnp.asarray(Q), *ref_args)), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(
        block_scan.tile_scores(torch.from_numpy(Q[1]), *args).numpy(),
        np.asarray(ref_tiles.tile_scores(jnp.asarray(Q[1]), *ref_args)), rtol=RTOL, atol=ATOL)


# -- the whole scan -------------------------------------------------------------------


@pytest.fixture(scope="module")
def scan_inputs(edge):
    ref_fwd, fwd = _both(edge, 2048, "f16")
    Q = _queries(np.random.default_rng(5), 3, 2048)
    return ref_fwd, fwd, Q, np.stack([ref_fwd.exact_scores(q) for q in Q])


@pytest.mark.parametrize("vq", VQS)
@pytest.mark.parametrize("codec", CODECS)
def test_score_packed_matches_reference(scan_inputs, codec, vq):
    ref_fwd, fwd, Q, exact = scan_inputs
    ref = ref_layout.pack_blocks(ref_fwd, codec=codec, block_size=128, vq=vq)
    port = layout.pack_blocks(fwd, codec=codec, block_size=128, vq=vq)
    got_b = scoring.score_packed_batch(Q, port).numpy()
    got_1 = scoring.score_packed(Q[1], port).numpy()
    want = np.asarray(ref_scoring.score_packed_batch(jnp.asarray(Q), ref))
    np.testing.assert_allclose(got_b, want, rtol=RTOL, atol=ATOL)
    # the reference's batch is its single-query scorer under vmap
    np.testing.assert_allclose(got_1, want[1], rtol=RTOL, atol=ATOL)
    if vq == "f16":
        np.testing.assert_allclose(got_b, exact, rtol=RTOL, atol=EXACT_ATOL)


@pytest.mark.parametrize("vf,seg", [("f32", np.int32), ("f16", np.int8), ("fixedu8", np.int32)],
                         ids=["f32-i32", "f16-i8", "fixedu8-i32"])
def test_ops_scans_match_reference_and_exact(edge, vf, seg):
    """``ops.score_*`` on the CPU (the kernel's plain version + scatter)
    against ``ops.score_*(mode="pallas_compiled")`` and exact scores."""
    ref_fwd, fwd = _both(edge, 2048, vf)
    Q = _queries(np.random.default_rng(7), 3, 2048)
    exact = np.stack([ref_fwd.exact_scores(q) for q in Q])
    mode = dict(mode="pallas_compiled")
    before = block_scan.launches
    for codec in BLOCK_CODECS:
        kw = dict(codec=codec, block_size=256, seg_dtype=seg)
        ref, port = ref_layout.pack_blocks(ref_fwd, **kw), layout.pack_blocks(fwd, **kw)
        single, batch = ops.block_scorers(codec)
        ref_single = getattr(ref_ops, f"score_{codec}")
        ref_batch = getattr(ref_ops, f"score_{codec}_batch")
        with warnings.catch_warnings():  # the reference's "XLA lowering" notice
            warnings.simplefilter("ignore", RuntimeWarning)
            want_b = np.asarray(ref_batch(Q, ref, **mode))
            want_1 = np.asarray(ref_single(Q[0], ref, **mode))
        got_b = batch(Q, port, device="cpu").numpy()
        got_1 = single(Q[0], port, device="cpu").numpy()
        np.testing.assert_allclose(got_b, want_b, rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(got_1, want_1, rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(got_b, exact, rtol=RTOL, atol=EXACT_ATOL)
        if codec == "bitpack":
            with warnings.catch_warnings():
                warnings.simplefilter("ignore", RuntimeWarning)
                want_w = np.asarray(ref_ops.score_bitpack_bucketed(Q[2], ref, **mode))
            got_w = ops.score_bitpack_bucketed(Q[2], port, device="cpu").numpy()
            np.testing.assert_allclose(got_w, want_w, rtol=RTOL, atol=ATOL)
            np.testing.assert_allclose(got_w, exact[2], rtol=RTOL, atol=EXACT_ATOL)
    assert block_scan.launches == before  # CPU tensors launch nothing


def test_ops_refuse_quantized_values_and_other_codecs(scan_inputs):
    _, fwd, Q, _ = scan_inputs
    with pytest.raises(ValueError, match="score_packed"):
        ops.score_dotvbyte(Q[0], layout.pack_blocks(fwd, vq="u8_sq"), device="cpu")
    with pytest.raises(ValueError, match="bitpack scan got a 'dotvbyte' pack"):
        ops.score_bitpack(Q[0], layout.pack_blocks(fwd), device="cpu")
    with pytest.raises(ValueError, match="no block-scan kernel for codec 'uncompressed'"):
        ops.block_scorers("uncompressed")
    with pytest.raises(ValueError, match="static width"):
        block_scan.bitpack_block_scores_w(*[torch.zeros(1)] * 6, width=33)


# -- no fallback on CUDA tensors -------------------------------------------------------


class _FakeCuda(torch.Tensor):
    """A CPU tensor that reports a CUDA device: how a test on a machine
    without a GPU reaches the wrapper's CUDA branch."""

    @property
    def device(self):
        return torch.device("cuda", 0)


@pytest.mark.parametrize("entry", sorted(block_scan.ENTRIES))
def test_cuda_tensors_launch_or_raise(edge, entry, monkeypatch):
    """On (fake) CUDA tensors every entry goes to its kernel — which
    needs a GPU here — and never to the plain version."""
    codec = entry.split("_")[2]
    fwd = ForwardIndex.from_docs(edge, 2048, value_format="f16")
    packed = layout.pack_blocks(fwd, codec=codec, block_size=128).to("cpu")
    fake = {k: v.as_subclass(_FakeCuda) for k, v in packed.as_dict().items()}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(build, "_LIBS", {})
    monkeypatch.setattr(block_scan, "block_scores_plain", None)  # never reached
    Q = torch.zeros((2, 2048)).as_subclass(_FakeCuda)
    keys = ("ctrl", "data") if codec != "bitpack" else ("words", "widths")
    streams = [fake[k] for k in (*keys, "seg", "start_pos", "start_abs", "vals")]
    before = dict(block_scan.variant_launches)
    with pytest.raises(RuntimeError, match="needs a CUDA GPU"):
        if entry.endswith("_w"):
            block_scan.bitpack_block_scores_w(Q[0], fake["words"], *streams[2:], width=3)
        elif entry.endswith("_batch"):
            _PORT[codec][1](Q, *streams)
        else:
            _PORT[codec][0](Q[0], *streams)
    assert block_scan.variant_launches == before
