"""The CUDA rows kernel against its plain torch version, on the card, for
every row codec × value codec.

Every test here carries the ``gpu`` marker and skips where no CUDA GPU
is present; whether one is present is decided inside the fixture, never
at import. This file imports no JAX, so it runs on a machine with the
card and PyTorch alone:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py
"""

import numpy as np
import pytest
import torch

from repro_torch.core.forward_index import ForwardIndex
from repro_torch.core.layout import pack_rows
from repro_torch.kernels import rows_dot
from torch_cases import VARIANTS, candidates, edge_docs, wide_docs

pytestmark = pytest.mark.gpu

DIM = 30522
L = 256


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    return torch.device("cuda")


def edge_rows(seed=0, n_random=300, codec="dotvbyte", vq="f16"):
    """Packed rows of the edge-case documents at the real vocabulary
    width."""
    docs = edge_docs(DIM, np.random.default_rng(seed), n_random=n_random, full=L)
    fwd = ForwardIndex.from_docs(docs, DIM, value_format="f16")
    rows = pack_rows(fwd, codec=codec, vq=vq)
    assert rows.l_max == L
    return fwd, rows.arrays()


def _on(arrays, device):
    return {k: torch.from_numpy(v).to(device) for k, v in arrays.items()}


@pytest.mark.parametrize("shared", [True, False], ids=["nd1", "ndnq"])
def test_rows_kernel_matches_plain(cuda, shared):
    fwd, arrays = edge_rows()
    rng = np.random.default_rng(1)
    nq, C = 16, 512
    n = fwd.n_docs
    Q = torch.from_numpy(
        rng.gamma(2.0, 0.5, size=(nq, DIM)).astype(np.float32)
        * (rng.random((nq, DIM)) < 0.3)
    ).to(cuda)
    docs = torch.from_numpy(candidates(n, rng, (1 if shared else nq, C))).to(cuda)
    streams = _on(arrays, cuda)
    before = rows_dot.launches
    got = rows_dot.rows_scores_for_codec("dotvbyte", streams, Q, docs, 1.0)
    torch.cuda.synchronize()
    assert rows_dot.launches == before + 1
    want = rows_dot.rows_scores_plain("dotvbyte", streams, Q, docs, 1.0)
    # f32 sums of the same f16 values in another order
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4)
    assert torch.all(got[:, :3] == 0)  # sentinel and empty rows
    exact = np.stack([fwd.exact_scores(q) for q in Q.cpu().numpy()])
    ids = docs.cpu().numpy()
    ref = np.where(ids < n, np.take_along_axis(
        exact, np.minimum(np.broadcast_to(ids, (nq, C)), n - 1), axis=1), 0)
    np.testing.assert_allclose(got.cpu().numpy(), ref, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("shared", [True, False], ids=["nd1", "ndnq"])
@pytest.mark.parametrize("codec,vq", VARIANTS, ids=[f"{c}-{v}" for c, v in VARIANTS])
def test_every_variant_matches_plain(cuda, codec, vq, shared):
    """Each (codec, vq) kernel against its plain version on edge rows;
    the dequantized values are bit-equal, so only the sum order differs."""
    fwd, arrays = edge_rows(n_random=200, codec=codec, vq=vq)
    rng = np.random.default_rng(2)
    nq, C = 8, 384
    Q = torch.from_numpy(rng.random((nq, DIM)).astype(np.float32)).to(cuda)
    docs = torch.from_numpy(candidates(fwd.n_docs, rng, (1 if shared else nq, C))).to(cuda)
    streams = _on(arrays, cuda)
    name = rows_dot.variant_name(codec, vq)
    before = rows_dot.variant_launches[name]
    got = rows_dot.rows_scores_for_codec(codec, streams, Q, docs, 0.5)
    torch.cuda.synchronize()
    assert rows_dot.variant_launches[name] == before + 1
    want = rows_dot.rows_scores_plain(codec, streams, Q, docs, 0.5)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4)
    assert torch.all(got[:, :3] == 0)


@pytest.mark.parametrize("codec", ["uncompressed", "streamvbyte", "bitpack"])
def test_wide_vocabulary_matches_plain(cuda, codec):
    """Gaps past 2**24: StreamVByte codes 2 and 3, bitpack widths > 16."""
    dim = (1 << 24) + (1 << 20)
    rng = np.random.default_rng(3)
    fwd = ForwardIndex.from_docs(wide_docs(dim, rng), dim, value_format="f16")
    streams = _on(pack_rows(fwd, codec=codec).arrays(), cuda)
    Q = torch.rand((2, dim), generator=torch.Generator().manual_seed(0)).to(cuda)
    docs = torch.arange(fwd.n_docs + 1, dtype=torch.int32, device=cuda).unsqueeze(0)
    got = rows_dot.rows_scores_for_codec(codec, streams, Q, docs)
    want = rows_dot.rows_scores_plain(codec, streams, Q, docs)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4)
    exact = np.stack([fwd.exact_scores(q) for q in Q.cpu().numpy()])
    np.testing.assert_allclose(got[:, :-1].cpu().numpy(), exact, rtol=1e-5, atol=1e-4)


def test_rows_kernel_rejects_bad_input(cuda):
    _, arrays = edge_rows(n_random=8)
    streams = _on(arrays, cuda)
    Q = torch.zeros((2, DIM), device=cuda)
    docs = torch.zeros((2, 4), dtype=torch.int64, device=cuda)
    with pytest.raises(ValueError, match="docs must be"):
        rows_dot.rows_scores_for_codec("dotvbyte", streams, Q, docs)
    with pytest.raises(ValueError, match="candidate sets"):
        rows_dot.rows_scores_for_codec("dotvbyte", streams, Q, docs[:, :0].int().repeat(3, 1))
    with pytest.raises(ValueError, match="contiguous"):
        rows_dot.rows_scores_for_codec("dotvbyte", streams, Q.t().contiguous().t(), docs.int())


def test_rows_kernel_empty_candidate_set(cuda):
    _, arrays = edge_rows(n_random=8)
    before = rows_dot.launches
    out = rows_dot.rows_scores_for_codec(
        "dotvbyte", _on(arrays, cuda), torch.zeros((3, DIM), device=cuda),
        torch.zeros((1, 0), dtype=torch.int32, device=cuda))
    assert out.shape == (3, 0) and rows_dot.launches == before
