"""The port's row decode and rows scorer against the reference: decoded
components equal ``scoring.decode_doc_rows``; ``rows_scores_plain``
(the CUDA kernel's plain version, and what its wrapper runs on CPU
tensors) matches ``ForwardIndex.exact_scores`` and the reference rows
kernel in Pallas interpret mode.

Tolerance rtol 1e-5 / atol 1e-4: every path sums the same f32 products
of the same f16 values, in a different order."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import layout as ref_layout
from repro.core import scoring as ref_scoring
from repro.core.forward_index import ForwardIndex as RefForwardIndex
from repro.kernels import rows_dot as ref_rows_dot
from repro_torch.core import layout, scoring
from repro_torch.core.forward_index import ForwardIndex
from repro_torch.kernels import build, rows_dot
from torch_cases import candidates, edge_docs

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


def _streams(arrays):
    return [arrays[k] for k in ("vals_rows", "nnz_rows", "ctrl_rows", "data_rows")]


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
    got = rows_dot.rows_scores(torch.from_numpy(Q), torch.from_numpy(docs),
                               *_streams(arrays)).numpy()
    exact = np.stack([np.append(fwd.exact_scores(q), 0.0) for q in Q])  # + sentinel
    want = np.take_along_axis(exact, np.broadcast_to(docs, (len(Q), docs.shape[1])), axis=1)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    assert np.all(got[:, :3] == 0)  # sentinel and empty rows score exactly 0


@pytest.mark.parametrize("shared", [True, False], ids=["nd1", "ndnq"])
def test_rows_plain_matches_reference_kernel(packed, shared):
    ref_rows, arrays, Q = packed["ref_rows"], packed["arrays"], packed["Q"]
    n = ref_rows.n_docs
    docs = candidates(n, packed["rng"], (1 if shared else len(Q), 32))
    got = rows_dot.rows_scores_plain(torch.from_numpy(Q), torch.from_numpy(docs),
                                     *_streams(arrays)).numpy()
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
    streams = [s.as_subclass(_FakeCuda) for s in _streams(arrays)]
    before = rows_dot.launches
    with pytest.raises(RuntimeError, match="needs a CUDA GPU"):
        rows_dot.rows_scores(Q, docs, *streams)
    assert rows_dot.launches == before


def test_wrapper_rejects_mixed_devices_and_unported_codecs(packed):
    arrays = packed["arrays"]
    Q = torch.from_numpy(packed["Q"])
    docs = torch.zeros((1, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="span devices"):
        rows_dot.rows_scores(Q.as_subclass(_FakeCuda), docs, *_streams(arrays))
    with pytest.raises(NotImplementedError, match="B2-B4"):
        scoring.score_candidate_rows("uncompressed", arrays, docs, Q[:1], 1.0, backend="cuda")
    with pytest.raises(NotImplementedError, match="queue A2"):
        scoring.score_candidate_rows(
            "dotvbyte", {**arrays, "vq_lo_rows": arrays["nnz_rows"]}, docs, Q[:1], 1.0)
    with pytest.raises(ValueError, match="unknown backend"):
        scoring.score_candidate_rows("dotvbyte", arrays, docs, Q[:1], 1.0, backend="pallas")
