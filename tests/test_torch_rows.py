"""The port's row decode and rows scorer against the reference: decoded
components equal ``scoring.decode_doc_rows``; ``rows_scores_plain``
(the CUDA kernel's plain version, and what its wrapper runs on CPU
tensors) matches ``ForwardIndex.exact_scores`` and the reference rows
kernel in Pallas interpret mode, for every row codec × value codec.

Tolerance rtol 1e-5 / atol 1e-4: every path sums the same f32 products
of the same values, in a different order."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import layout as ref_layout
from repro.core import scoring as ref_scoring
from repro.core import values as ref_values
from repro.core.forward_index import ForwardIndex as RefForwardIndex
from repro.kernels import rows_dot as ref_rows_dot
from repro_torch.core import layout, scoring
from repro_torch.core.forward_index import ForwardIndex
from repro_torch.kernels import build, rows_dot
from torch_cases import VARIANTS, candidates, edge_docs, wide_docs

RTOL, ATOL = 1e-5, 1e-4


@pytest.fixture(scope="module", params=[2048, 30522], ids=lambda d: f"dim{d}")
def packed(request):
    dim = request.param
    rng = np.random.default_rng(dim)
    docs = edge_docs(dim, rng)
    ref_fwd = RefForwardIndex.from_docs(docs, dim, value_format="f16")
    fwd = ForwardIndex.from_docs(docs, dim, value_format="f16")
    ref_rows = ref_layout.pack_rows(ref_fwd, codec="dotvbyte")
    arrays = {k: torch.from_numpy(v) for k, v in
              layout.pack_rows(fwd, codec="dotvbyte").arrays().items()}
    Q = np.zeros((3, dim), np.float32)
    for i in range(3):
        Q[i, rng.choice(dim, size=43, replace=False)] = rng.gamma(2, .5, 43)
    Q[2] = rng.random(dim)  # one dense query touches every component
    return dict(fwd=fwd, ref_rows=ref_rows, arrays=arrays, Q=Q, rng=rng)




def test_decode_matches_reference(packed):
    ref_rows, arrays = packed["ref_rows"], packed["arrays"]
    L = ref_rows.l_max
    want = np.asarray(ref_scoring.decode_doc_rows(
        "dotvbyte", {k: jnp.asarray(v) for k, v in ref_rows.payload.items()}, l_max=L))
    got = scoring.decode_doc_rows(
        "dotvbyte", {k: arrays[k] for k in ("ctrl_rows", "data_rows")}, l_max=L)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    # live components are exactly the documents' own
    fwd = packed["fwd"]
    for d in range(fwd.n_docs):
        np.testing.assert_array_equal(got[d, : fwd.nnz(d)].numpy(), fwd.doc(d)[0])


def test_decode_gaps_matches_reference(packed):
    ref_rows, arrays = packed["ref_rows"], packed["arrays"]
    nc = ref_rows.l_max // 8
    want = np.asarray(ref_scoring.decode_gaps_dotvbyte(
        jnp.asarray(ref_rows.payload["ctrl_rows"][:, :nc]),
        jnp.asarray(ref_rows.payload["data_rows"])))
    got = scoring.decode_gaps_dotvbyte(arrays["ctrl_rows"][:, :nc], arrays["data_rows"])
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("shared", [True, False], ids=["nd1", "ndnq"])
def test_rows_plain_matches_exact_scores(packed, shared):
    fwd, arrays, Q = packed["fwd"], packed["arrays"], packed["Q"]
    n = fwd.n_docs
    docs = candidates(n, packed["rng"], (1 if shared else len(Q), 64))
    got = rows_dot.rows_scores_for_codec("dotvbyte", arrays, torch.from_numpy(Q),
                                         torch.from_numpy(docs)).numpy()
    exact = np.stack([np.append(fwd.exact_scores(q), 0.0) for q in Q])  # + sentinel
    want = np.take_along_axis(exact, np.broadcast_to(docs, (len(Q), docs.shape[1])), axis=1)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    assert np.all(got[:, :3] == 0)  # sentinel and empty rows score exactly 0


@pytest.mark.parametrize("shared", [True, False], ids=["nd1", "ndnq"])
def test_rows_plain_matches_reference_kernel(packed, shared):
    ref_rows, arrays, Q = packed["ref_rows"], packed["arrays"], packed["Q"]
    n = ref_rows.n_docs
    docs = candidates(n, packed["rng"], (1 if shared else len(Q), 32))
    got = rows_dot.rows_scores_plain("dotvbyte", arrays, torch.from_numpy(Q),
                                     torch.from_numpy(docs)).numpy()
    r = ref_rows
    ref_streams = [jnp.asarray(r.vals_rows), jnp.asarray(r.nnz_rows),
                   jnp.asarray(r.payload["ctrl_rows"]), jnp.asarray(r.payload["data_rows"])]
    if shared:
        want = np.asarray(ref_rows_dot.rows_scores_batch(
            "dotvbyte", jnp.asarray(Q), jnp.asarray(docs[0]), *ref_streams, interpret=True))
    else:
        want = np.stack([np.asarray(ref_rows_dot.rows_scores(
            "dotvbyte", jnp.asarray(Q[i]), jnp.asarray(docs[i]), *ref_streams,
            interpret=True)) for i in range(len(Q))])
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_score_candidate_rows_backends_agree_on_cpu(packed):
    """On CPU tensors the cuda backend's wrapper runs the plain version,
    so both backends agree — and launch nothing."""
    fwd, arrays = packed["fwd"], packed["arrays"]
    Q = torch.from_numpy(packed["Q"])
    docs = torch.from_numpy(candidates(fwd.n_docs, packed["rng"], (len(Q), 40)))
    before = rows_dot.launches
    a = scoring.score_candidate_rows("dotvbyte", arrays, docs, Q, 1.0, backend="torch")
    b = scoring.score_candidate_rows("dotvbyte", arrays, docs, Q, 1.0, backend="cuda")
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    shared = torch.arange(fwd.n_docs + 1, dtype=torch.int32)
    c = scoring.score_candidate_rows_batch("dotvbyte", arrays, shared, Q, 1.0, backend="cuda")
    exact = np.stack([fwd.exact_scores(q) for q in packed["Q"]])
    np.testing.assert_allclose(c[:, :-1].numpy(), exact, rtol=RTOL, atol=ATOL)
    assert rows_dot.launches == before


def test_plain_path_chunks_match_unchunked(packed, monkeypatch):
    fwd, arrays = packed["fwd"], packed["arrays"]
    Q = torch.from_numpy(packed["Q"])
    docs = torch.arange(fwd.n_docs + 1, dtype=torch.int32).unsqueeze(0)
    whole = scoring.score_rows_plain("dotvbyte", arrays, docs, Q, 1.0)
    monkeypatch.setattr(scoring, "_CHUNK_ELEMS", 1)  # one candidate per chunk
    torch.testing.assert_close(
        scoring.score_rows_plain("dotvbyte", arrays, docs, Q, 1.0), whole, rtol=0, atol=0)


class _FakeCuda(torch.Tensor):
    """A CPU tensor that reports a CUDA device — how a test on a machine
    without a GPU reaches the wrapper's CUDA branch."""

    @property
    def device(self):
        return torch.device("cuda", 0)


def test_cuda_tensor_without_kernel_raises_not_falls_back(packed, monkeypatch):
    arrays = packed["arrays"]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(build, "_LIBS", {})
    Q = torch.from_numpy(packed["Q"]).as_subclass(_FakeCuda)
    docs = torch.zeros((1, 4), dtype=torch.int32).as_subclass(_FakeCuda)
    fake = {k: v.as_subclass(_FakeCuda) for k, v in arrays.items()}
    before = rows_dot.launches
    with pytest.raises(RuntimeError, match="needs a CUDA GPU"):
        rows_dot.rows_scores_for_codec("dotvbyte", fake, Q, docs)
    assert rows_dot.launches == before


def test_wrapper_rejects_mixed_devices_and_unported_codecs(packed):
    arrays = packed["arrays"]
    Q = torch.from_numpy(packed["Q"])
    docs = torch.zeros((1, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="span devices"):
        rows_dot.rows_scores_for_codec("dotvbyte", arrays, Q.as_subclass(_FakeCuda), docs)
    # every registered codec has a kernel now; an unknown one is refused
    with pytest.raises(ValueError, match="no rows kernel for codec 'vbyte'"):
        scoring.score_candidate_rows("vbyte", arrays, docs, Q[:1], 1.0, backend="cuda")
    with pytest.raises(ValueError, match="unknown backend"):
        scoring.score_candidate_rows("dotvbyte", arrays, docs, Q[:1], 1.0, backend="pallas")


# -- every row codec × value codec ---------------------------------------------


def _pack_both(docs, dim, codec, vq):
    ref = ref_layout.pack_rows(RefForwardIndex.from_docs(docs, dim, value_format="f16"),
                               codec=codec, vq=vq)
    port = layout.pack_rows(ForwardIndex.from_docs(docs, dim, value_format="f16"),
                            codec=codec, vq=vq)
    return ref, {k: torch.from_numpy(v) for k, v in port.arrays().items()}


def _ref_rows_scores(codec, vq, ref_rows, Q, docs):
    """The reference rows kernel (Pallas interpret mode), one call per
    candidate set: [nq, C]."""
    arrays = ref_rows.arrays()
    payload = ref_rows_dot._payload_streams(codec, {k: jnp.asarray(v) for k, v in arrays.items()})
    streams = [jnp.asarray(ref_rows.vals_rows), jnp.asarray(ref_rows.nnz_rows),
               *ref_values.rows_vq_streams(vq, arrays), *payload]
    if docs.shape[0] == 1:
        return np.asarray(ref_rows_dot.rows_scores_batch(
            codec, jnp.asarray(Q), jnp.asarray(docs[0]), *streams, vq=vq, interpret=True))
    return np.stack([np.asarray(ref_rows_dot.rows_scores_batch(
        codec, jnp.asarray(Q[i : i + 1]), jnp.asarray(docs[i]), *streams, vq=vq,
        interpret=True))[0] for i in range(len(Q))])


@pytest.fixture(scope="module")
def variant_inputs():
    dim = 2048
    rng = np.random.default_rng(7)
    docs = edge_docs(dim, rng, n_random=24)
    Q = np.zeros((3, dim), np.float32)
    for i in range(2):
        Q[i, rng.choice(dim, size=43, replace=False)] = rng.gamma(2, .5, 43)
    Q[2] = rng.random(dim)
    return dim, docs, Q, rng


@pytest.mark.parametrize("shared", [True, False], ids=["nd1", "ndnq"])
@pytest.mark.parametrize("codec,vq", VARIANTS, ids=[f"{c}-{v}" for c, v in VARIANTS])
def test_rows_plain_every_variant_matches_reference_kernel(variant_inputs, codec, vq, shared):
    dim, docs, Q, rng = variant_inputs
    ref_rows, arrays = _pack_both(docs, dim, codec, vq)
    ids = candidates(ref_rows.n_docs, rng, (1 if shared else len(Q), 24))
    got = rows_dot.rows_scores_for_codec(codec, arrays, torch.from_numpy(Q),
                                         torch.from_numpy(ids)).numpy()
    np.testing.assert_allclose(got, _ref_rows_scores(codec, vq, ref_rows, Q, ids),
                               rtol=RTOL, atol=ATOL)
    assert np.all(got[:, :3] == 0)  # sentinel and empty rows score exactly 0


@pytest.mark.parametrize("shared", [True, False], ids=["nd1", "ndnq"])
@pytest.mark.parametrize("codec", ["uncompressed", "streamvbyte", "bitpack"])
def test_rows_plain_f16_matches_exact_scores(variant_inputs, codec, shared):
    dim, docs, Q, rng = variant_inputs
    fwd = ForwardIndex.from_docs(docs, dim, value_format="f16")
    arrays = {k: torch.from_numpy(v) for k, v in
              layout.pack_rows(fwd, codec=codec).arrays().items()}
    ids = candidates(fwd.n_docs, rng, (1 if shared else len(Q), 40))
    got = rows_dot.rows_scores_for_codec(codec, arrays, torch.from_numpy(Q),
                                         torch.from_numpy(ids)).numpy()
    exact = np.stack([np.append(fwd.exact_scores(q), 0.0) for q in Q])
    want = np.take_along_axis(exact, np.broadcast_to(ids, (len(Q), ids.shape[1])), axis=1)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("codec", ["uncompressed", "streamvbyte", "bitpack"])
@pytest.mark.parametrize("vq", ["f16", "pq"])
def test_rows_plain_wide_vocabulary_matches_reference(codec, vq):
    """A vocabulary past 2**16: StreamVByte code 2, bitpack widths > 16."""
    dim = (1 << 17) + 3
    rng = np.random.default_rng(11)
    docs = wide_docs(dim, rng)
    ref_rows, arrays = _pack_both(docs, dim, codec, vq)
    Q = rng.random((2, dim)).astype(np.float32)
    ids = rng.integers(0, ref_rows.n_docs + 1, size=(1, 16)).astype(np.int32)
    ids[0, :2] = [0, 1]
    got = rows_dot.rows_scores_for_codec(codec, arrays, torch.from_numpy(Q),
                                         torch.from_numpy(ids)).numpy()
    np.testing.assert_allclose(got, _ref_rows_scores(codec, vq, ref_rows, Q, ids),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("codec", ["streamvbyte", "bitpack"])
@pytest.mark.parametrize("dim", [2048, 30522, 1 << 25], ids=lambda d: f"dim{d}")
def test_decode_every_codec_matches_reference(codec, dim):
    """``decode_doc_rows`` equals the reference; at 2**25 the StreamVByte
    rows carry every code 0-3."""
    rng = np.random.default_rng(dim)
    docs = wide_docs(dim, rng) if dim > 1 << 16 else edge_docs(dim, rng, n_random=20)
    ref_rows, arrays = _pack_both(docs, dim, codec, "f16")
    L = ref_rows.l_max
    payload = {k: v for k, v in ref_rows.payload.items()}
    want = np.asarray(ref_scoring.decode_doc_rows(
        codec, {k: jnp.asarray(v) for k, v in payload.items()}, l_max=L))
    got = scoring.decode_doc_rows(codec, {k: arrays[k] for k in payload}, l_max=L)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    fwd = ForwardIndex.from_docs(docs, dim, value_format="f16")
    for d in range(fwd.n_docs):
        np.testing.assert_array_equal(got[d, : fwd.nnz(d)].numpy(), fwd.doc(d)[0])
    if codec == "streamvbyte" and dim == 1 << 25:
        codes = (arrays["ctrl_rows"][0, :2].int().unsqueeze(-1) >> torch.arange(0, 8, 2)) & 3
        assert set(codes.flatten().tolist()) == {0, 1, 2, 3}


def test_gap_decoders_match_reference():
    rng = np.random.default_rng(5)
    gaps = rng.integers(0, 1 << 32, size=(6, 64), dtype=np.uint64).astype(np.uint32)
    gaps[:, 32:] = rng.integers(0, 300, size=(6, 32))
    gaps[3] = 0
    for codec in ("streamvbyte", "bitpack"):
        enc = ref_layout.get_layout(codec).encode(gaps)
        want = np.asarray(ref_layout.get_layout(codec).decode(
            {k: jnp.asarray(v) for k, v in enc.items()}, 64))
        got = layout.get_layout(codec).decode(
            {k: torch.from_numpy(v) for k, v in enc.items()}, 64)
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(got.numpy().view(np.uint32), gaps)


@pytest.mark.parametrize("codec,vq", VARIANTS, ids=[f"{c}-{v}" for c, v in VARIANTS])
def test_every_variant_on_cuda_tensors_launches_or_raises(codec, vq, monkeypatch):
    """On (fake) CUDA tensors every variant goes to its kernel — which
    needs a GPU here — and never to the plain version."""
    fwd = ForwardIndex.from_docs(edge_docs(512, np.random.default_rng(0), n_random=4,
                                           full=40), 512, "f16")
    arrays = {k: torch.from_numpy(v).as_subclass(_FakeCuda)
              for k, v in layout.pack_rows(fwd, codec=codec, vq=vq).arrays().items()}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(build, "_LIBS", {})
    monkeypatch.setattr(rows_dot, "rows_scores_plain", None)  # never reached
    Q = torch.zeros((2, 512)).as_subclass(_FakeCuda)
    docs = torch.zeros((2, 4), dtype=torch.int32).as_subclass(_FakeCuda)
    before = dict(rows_dot.variant_launches)
    with pytest.raises(RuntimeError, match="needs a CUDA GPU"):
        rows_dot.rows_scores_for_codec(codec, arrays, Q, docs)
    assert rows_dot.variant_launches == before
    assert rows_dot.variant_name(codec, vq) in before


@pytest.mark.parametrize("nq,nd,dim,stage", [
    (64, 64, 30522, "row_warps"), (2, 2, 30522, "row_warps"), (64, 64, 57000, "row_warps"),
    (64, 64, 58000, "entry_lanes"), (2, 2, 1 << 24, "entry_lanes"), (1, 1, 30522, "row_warps"),
    (1, 1, 1 << 24, "entry_lanes"),
    (7, 1, 30522, "entry_lanes"), (8, 1, 30522, "query_lanes"), (200, 1, 1 << 24, "query_lanes"),
])
def test_rows_stage_rules(nq, nd, dim, stage):
    """The rows kernel's stage follows the shape: row warps for one set
    per query (one query over one set included) whose row fits in shared
    memory beside the PQ codebook (else entry lanes), query lanes or
    entry lanes for one set shared by 2 or more queries; a forced
    row-warp stage is checked against the same rule. The sets are large
    enough for row warps (``test_small_sets_take_entry_lanes`` holds the
    size rule)."""
    C = rows_dot.ROW_WARPS_MIN_ROWS
    assert rows_dot.row_warps_fit(dim) is (dim <= 57000)
    assert rows_dot.pick_stage(nq, nd, dim=dim, C=C) == stage
    assert rows_dot.pick_stage(nq, nd, "entry_lanes", dim=dim, C=C) == "entry_lanes"
    if nd == nq and rows_dot.row_warps_fit(dim):
        assert rows_dot.pick_stage(nq, nd, "row_warps", dim=dim, C=C) == "row_warps"
    else:
        with pytest.raises(ValueError, match="row warps score one candidate set per query"):
            rows_dot.pick_stage(nq, nd, "row_warps", dim=dim, C=C)


@pytest.mark.parametrize("nq,nd,stage", [(64, 64, "row_warps"), (3, 1, "entry_lanes"),
                                         (9, 1, "query_lanes")])
def test_cuda_tensors_take_the_picked_stage(nq, nd, stage, monkeypatch):
    """On (fake) CUDA tensors the wrapper launches the stage
    :func:`rows_dot.pick_stage` gives for the shapes: the Seismic shape
    (one candidate set of 4,096 rows per query, query rows of 512 floats)
    goes to row warps."""
    fwd = ForwardIndex.from_docs(edge_docs(512, np.random.default_rng(0), n_random=4,
                                           full=40), 512, "f16")
    arrays = {k: torch.from_numpy(v).as_subclass(_FakeCuda)
              for k, v in layout.pack_rows(fwd, codec="dotvbyte").arrays().items()}
    seen = []
    monkeypatch.setattr(rows_dot, "_launch", lambda *args: seen.append(args[-1]))
    Q = torch.zeros((nq, 512)).as_subclass(_FakeCuda)
    docs = torch.zeros((nd, 4096), dtype=torch.int32).as_subclass(_FakeCuda)
    rows_dot.rows_scores_for_codec("dotvbyte", arrays, Q, docs)
    assert seen == [stage]


@pytest.mark.parametrize("nq,C", [(64, 1), (64, 8), (64, 32), (64, 1023), (64, 1024), (64, 4096),
                                  (8, 8191), (8, 8192), (1, 4096), (1, 65535), (1, 65536)])
def test_small_sets_take_entry_lanes(nq, C, monkeypatch):
    """Sets per query of fewer than ``ROW_WARPS_MIN_ROWS`` rows in all
    (the hnsw engine's seeds and neighbours, a one-query Seismic search)
    take entry lanes, more rows row warps; a scorer made once picks per
    call from that call's ``docs``; a forced stage takes any set size."""
    want = "row_warps" if nq * C >= rows_dot.ROW_WARPS_MIN_ROWS else "entry_lanes"
    assert rows_dot.pick_stage(nq, nq, dim=30522, C=C) == want
    assert rows_dot.pick_stage(nq, nq, "row_warps", dim=30522, C=C) == "row_warps"
    assert rows_dot.pick_stage(64, 1, dim=30522, C=C) == "query_lanes"
    fwd = ForwardIndex.from_docs(edge_docs(512, np.random.default_rng(0), n_random=4,
                                           full=40), 512, "f16")
    arrays = {k: torch.from_numpy(v).as_subclass(_FakeCuda)
              for k, v in layout.pack_rows(fwd, codec="dotvbyte").arrays().items()}
    seen = []
    monkeypatch.setattr(rows_dot, "_launch", lambda *args: seen.append(args[-1]))
    score = rows_dot.rows_scorer("dotvbyte", arrays, torch.zeros((nq, 512)).as_subclass(_FakeCuda))
    for c in (C, rows_dot.ROW_WARPS_MIN_ROWS):
        score(torch.zeros((nq, c), dtype=torch.int32).as_subclass(_FakeCuda))
    assert seen == [want, "row_warps"]
    with pytest.raises(ValueError, match="docs must be 2-D"):
        score(torch.zeros((nq, C), dtype=torch.int64).as_subclass(_FakeCuda))
    with pytest.raises(ValueError, match="span devices"):
        score(torch.zeros((nq, C), dtype=torch.int32))
    with pytest.raises(ValueError, match="candidate sets"):
        score(torch.zeros((2, C), dtype=torch.int32).as_subclass(_FakeCuda))
