"""The CUDA kernels against their plain torch versions, on the card: the
rows kernel for every row codec × value codec and stored value format,
and the block-scan kernel for every codec, static width, value storage
and seg dtype.

Every test here carries the ``gpu`` marker and skips where no CUDA GPU
is present; whether one is present is decided inside the fixture, never
at import. This file imports no JAX, so it runs on a machine with the
card and PyTorch alone:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py
"""

import numpy as np
import pytest
import torch

from repro_torch.core import layout, scoring
from repro_torch.core.codecs.bitpack import pack_block
from repro_torch.core.forward_index import ForwardIndex
from repro_torch.core.layout import pack_rows
from repro_torch.kernels import block_scan, ops, rows_dot
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


# -- the rows kernel on the stored value formats ------------------------------------


@pytest.mark.parametrize("vf", ["f32", "fixedu8"])
@pytest.mark.parametrize("codec", ["uncompressed", "dotvbyte", "streamvbyte", "bitpack"])
def test_rows_kernel_reads_every_stored_value_format(cuda, codec, vf):
    """Under vq f16 the values ride as stored: f32 and fixedu8 (u8,
    scale 1/32) as well as f16."""
    docs = edge_docs(DIM, np.random.default_rng(4), n_random=200, full=L)
    fwd = ForwardIndex.from_docs(docs, DIM, value_format=vf)
    streams = _on(pack_rows(fwd, codec=codec).arrays(), cuda)
    assert streams["vals_rows"].dtype == (torch.float32 if vf == "f32" else torch.uint8)
    rng = np.random.default_rng(5)
    Q = torch.from_numpy(rng.random((8, DIM)).astype(np.float32)).to(cuda)
    ids = torch.from_numpy(candidates(fwd.n_docs, rng, (1, 384))).to(cuda)
    scale = float(fwd.value_format.scale)
    got = rows_dot.rows_scores_for_codec(codec, streams, Q, ids, scale)
    torch.cuda.synchronize()
    want = rows_dot.rows_scores_plain(codec, streams, Q, ids, scale)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4)
    exact = np.stack([np.append(fwd.exact_scores(q), 0.0) for q in Q.cpu().numpy()])
    np.testing.assert_allclose(got.cpu().numpy(), exact[:, ids[0].cpu().numpy()],
                               rtol=1e-5, atol=1e-4)


# -- the block-scan kernel ----------------------------------------------------------

BLOCK_VFS = ["f32", "f16", "fixedu8"]


def _block_pack(cuda, codec, vf, seg, T=512, D=None, docs=None, dim=DIM):
    docs = docs or edge_docs(dim, np.random.default_rng(6), n_random=300, full=700)
    fwd = ForwardIndex.from_docs(docs, dim, value_format=vf)
    packed = layout.pack_blocks(fwd, codec=codec, block_size=T, max_docs_per_block=D,
                                seg_dtype=np.int8 if seg == "i8" else np.int32)
    return fwd, packed.to(cuda)


def _block_streams(packed):
    keys = ("ctrl", "data") if packed.codec != "bitpack" else ("words", "widths")
    return {k: getattr(packed, k) for k in (*keys, "seg", "start_pos", "start_abs", "vals")}


def _scan_streams(packed):
    return list(_block_streams(packed).values())


_ENTRY_FNS = {
    "dotvbyte": (block_scan.dotvbyte_block_scores, block_scan.dotvbyte_block_scores_batch),
    "streamvbyte": (block_scan.streamvbyte_block_scores,
                    block_scan.streamvbyte_block_scores_batch),
    "bitpack": (block_scan.bitpack_block_scores, block_scan.bitpack_block_scores_batch),
}


@pytest.mark.parametrize("seg", ["i32", "i8"])
@pytest.mark.parametrize("vf", BLOCK_VFS)
@pytest.mark.parametrize("codec", ["dotvbyte", "streamvbyte", "bitpack"])
def test_block_scan_matches_plain(cuda, codec, vf, seg):
    """Single and batched scans (and, for bitpack, every static width the
    pack holds) against the plain version; blocks close on T = 128 or on
    D = 5 slots, docs run longer than T, two are empty."""
    fwd, packed = _block_pack(cuda, codec, vf, seg, T=128 if seg == "i8" else 512,
                              D=5 if seg == "i8" else None)
    rng = np.random.default_rng(7)
    Q = torch.from_numpy(rng.random((16, DIM)).astype(np.float32)).to(cuda)
    scale = float(fwd.value_format.scale)
    single, batch = _ENTRY_FNS[codec]
    streams = _scan_streams(packed)
    plain = block_scan.block_scores_plain(codec, Q, dict(zip(
        ("ctrl", "data") if codec != "bitpack" else ("words", "widths"), streams[:2]),
        seg=packed.seg, start_pos=packed.start_pos, start_abs=packed.start_abs,
        vals=packed.vals), scale=scale)
    got_b = batch(Q, *streams, scale=scale)
    got_1 = single(Q[3], *streams, scale=scale)
    torch.cuda.synchronize()
    torch.testing.assert_close(got_b, plain, rtol=1e-5, atol=1e-4)
    torch.testing.assert_close(got_1, plain[3], rtol=1e-5, atol=1e-4)
    exact = np.stack([fwd.exact_scores(q) for q in Q.cpu().numpy()])
    docs = scoring.scatter_block_scores(got_b, packed.doc_ids, fwd.n_docs)
    np.testing.assert_allclose(docs.cpu().numpy(), exact, rtol=1e-5, atol=1e-3)
    if codec == "bitpack":
        got_w = ops.score_bitpack_bucketed(Q[5], packed)
        np.testing.assert_allclose(got_w.cpu().numpy(), exact[5], rtol=1e-5, atol=1e-3)


@pytest.mark.parametrize("width", range(1, 33))
def test_every_static_width_matches_plain(cuda, width):
    """Synthetic blocks packed at each width 1..32 (gaps kept small, so
    components stay inside the vocabulary): the static-width kernel and
    the per-block-width kernel both equal the plain version."""
    rng = np.random.default_rng(width)
    B, T, D = 5, 256, 4
    gaps = rng.integers(0, min(1 << width, 400), size=(B, T), dtype=np.int64)
    gaps[:, :: T // D] = 0  # every fragment opens with gap 0
    tight = (T * width + 31) // 32
    words = np.zeros((B, tight + (-tight) % 128), np.uint32)
    for b in range(B):
        words[b, :tight] = pack_block(gaps[b], width)
    seg = np.repeat(np.arange(D, dtype=np.int32), T // D)[None].repeat(B, 0)
    seg[-1, T // 2:] = -1  # a half-empty last block
    start_pos = np.tile(np.arange(0, T, T // D, dtype=np.int32), (B, 1))
    start_abs = rng.integers(0, 3000, size=(B, D)).astype(np.int32)
    vals = rng.random((B, T)).astype(np.float16)
    t = {k: torch.from_numpy(v).to(cuda) for k, v in dict(
        words=words, widths=np.full(B, width, np.int32), seg=seg, start_pos=start_pos,
        start_abs=start_abs, vals=vals).items()}
    Q = torch.from_numpy(rng.random((3, DIM)).astype(np.float32)).to(cuda)
    rest = [t[k] for k in ("seg", "start_pos", "start_abs", "vals")]
    plain = block_scan.block_scores_plain("bitpack", Q, t, scale=0.5)
    got_w = block_scan.bitpack_block_scores_w(Q[1], t["words"], *rest, width=width, scale=0.5)
    got_r = block_scan.bitpack_block_scores_batch(Q, t["words"], t["widths"], *rest, scale=0.5)
    torch.cuda.synchronize()
    torch.testing.assert_close(got_w, plain[1], rtol=1e-5, atol=1e-4)
    torch.testing.assert_close(got_r, plain, rtol=1e-5, atol=1e-4)
    assert float(plain.abs().sum()) > 0


@pytest.mark.parametrize("codec", ["streamvbyte", "bitpack"])
def test_block_scan_wide_vocabulary(cuda, codec):
    """dim 2**24 + 2**20: StreamVByte codes 2-3, bitpack widths > 16, and
    a block whose gap prefix sum passes 2**31 (the rebase runs modulo
    2**32 in the kernel)."""
    dim = (1 << 24) + (1 << 20)
    rng = np.random.default_rng(8)
    docs = wide_docs(dim, rng) + [(np.array([i, dim - 1 - i]), np.ones(2)) for i in range(200)]
    fwd, packed = _block_pack(cuda, codec, "f16", "i32", T=256, D=200, docs=docs, dim=dim)
    Q = torch.rand((2, dim), generator=torch.Generator().manual_seed(0)).to(cuda)
    single, batch = _ENTRY_FNS[codec]
    got = batch(Q, *_scan_streams(packed))
    plain = block_scan.block_scores_plain(codec, Q, packed.as_dict())
    torch.testing.assert_close(got, plain, rtol=1e-5, atol=1e-4)
    exact = np.stack([fwd.exact_scores(q) for q in Q.cpu().numpy()])
    docs_s = scoring.scatter_block_scores(got, packed.doc_ids, fwd.n_docs)
    np.testing.assert_allclose(docs_s.cpu().numpy(), exact, rtol=1e-5, atol=1e-4)


def test_block_scan_launch_counters(cuda):
    """Each entry adds one to its own count and to the total per launch;
    comparing with the plain version launches nothing."""
    fwd, packed = _block_pack(cuda, "bitpack", "f16", "i32")
    Q = torch.rand((4, DIM), generator=torch.Generator().manual_seed(1)).to(cuda)
    before, total = dict(block_scan.variant_launches), block_scan.launches
    streams = _scan_streams(packed)
    block_scan.bitpack_block_scores_batch(Q, *streams)
    block_scan.bitpack_block_scores(Q[0], *streams)
    block_scan.block_scores_plain("bitpack", Q, packed.as_dict())
    n_widths = len(torch.unique(packed.widths))
    ops.score_bitpack_bucketed(Q[0], packed)
    torch.cuda.synchronize()
    after = block_scan.variant_launches
    assert after["block_scan_bitpack_batch"] == before["block_scan_bitpack_batch"] + 1
    assert after["block_scan_bitpack"] == before["block_scan_bitpack"] + 1
    assert after["block_scan_bitpack_w"] == before["block_scan_bitpack_w"] + n_widths
    assert block_scan.launches == total + 2 + n_widths
    block_scan.reset_launches()
    assert block_scan.launches == 0 and not any(block_scan.variant_launches.values())


def test_block_scan_refuses_quantized_values_and_bad_input(cuda):
    fwd = ForwardIndex.from_docs(edge_docs(DIM, np.random.default_rng(9), n_random=50),
                                 DIM, value_format="f16")
    q = torch.rand(DIM, device=cuda)
    with pytest.raises(ValueError, match="score_packed"):
        ops.score_dotvbyte(q, layout.pack_blocks(fwd, vq="u8_sq").to(cuda))
    packed = layout.pack_blocks(fwd).to(cuda)
    streams = _scan_streams(packed)
    with pytest.raises(ValueError, match="contiguous"):
        block_scan.dotvbyte_block_scores(q, streams[0], streams[1], streams[2].t().contiguous().t(),
                                         *streams[3:])
    with pytest.raises(ValueError, match="ctrl is"):
        block_scan.dotvbyte_block_scores(q, streams[0][:, :10].contiguous(), *streams[1:])


def test_block_scan_malformed_streams(cuda):
    """Random bytes in every stream (seg and start_pos out of range
    included) and random doc ids never read or write out of bounds and
    agree with the plain version, in both output modes and both scoring
    stages; a shape the CUDA entry refuses raises from the CUDA side."""
    rng = np.random.default_rng(10)
    B, T, D, n_docs = 9, 256, 12, 20
    a = dict(ctrl=rng.integers(0, 256, (B, 128), dtype=np.uint8),
             data=rng.integers(0, 256, (B, 2 * T + 128), dtype=np.uint8),
             seg=rng.integers(-3, D + 3, (B, T)).astype(np.int32),
             start_pos=rng.integers(-5, T + 5, (B, D)).astype(np.int32),
             start_abs=rng.integers(-(1 << 20), DIM, (B, D)).astype(np.int32),
             vals=rng.random((B, T)).astype(np.float32))
    t = {k: torch.from_numpy(v).to(cuda) for k, v in a.items()}
    ids = torch.from_numpy(rng.integers(-3, n_docs + 3, (B, D)).astype(np.int32)).to(cuda)
    entry = "block_scan_dotvbyte_batch"
    for nq in (3, 67):
        Q = torch.rand((nq, DIM), generator=torch.Generator().manual_seed(2)).to(cuda)
        want = block_scan.block_scores_plain("dotvbyte", Q, t)
        want_docs = block_scan.scan_scores_plain("dotvbyte", Q, t, ids, n_docs)
        for stage in block_scan.STAGES:
            got = block_scan.block_scores(entry, "dotvbyte", Q, t, stage=stage)
            got_docs = block_scan.scan_scores(entry, "dotvbyte", Q, t, ids, n_docs, stage=stage)
            torch.cuda.synchronize()
            torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4)
            torch.testing.assert_close(got_docs, want_docs, rtol=1e-5, atol=1e-4)
    bad = {**t, "seg": t["seg"][:, :100].contiguous(), "vals": t["vals"][:, :100].contiguous()}
    for stage in block_scan.STAGES:
        with pytest.raises(RuntimeError, match="CUDA error"):
            block_scan._launch(entry, "dotvbyte", Q, bad, t["ctrl"], t["data"], 1.0, 0, stage)
        with pytest.raises(RuntimeError, match="CUDA error"):
            block_scan._launch(entry, "dotvbyte", Q, bad, t["ctrl"], t["data"], 1.0, 0, stage,
                               doc_ids=ids, n_docs=n_docs)


# -- the block scan's scatter mode (the fused full-scan entry) -----------------------


def _fused_vs_plain(entry, codec, Q, packed, n_docs, stage=None, doc_ids=None):
    """scan_scores on the card against its plain version on the same
    tensors; the fused launch is counted once under ``entry``."""
    doc_ids = packed.doc_ids if doc_ids is None else doc_ids
    streams = _block_streams(packed)
    scale = float(packed.value_format.scale)
    before = block_scan.fused_launches[entry]
    got = block_scan.scan_scores(entry, codec, Q, streams, doc_ids, n_docs, scale=scale,
                                 stage=stage)
    torch.cuda.synchronize()
    assert block_scan.fused_launches[entry] == before + 1
    want = block_scan.scan_scores_plain(codec, Q, streams, doc_ids, n_docs, scale=scale)
    # f32 sums of the same products in another order; a document's
    # fragments are added by atomics in no fixed order
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4)
    return got


@pytest.mark.parametrize("seg", ["i32", "i8"])
@pytest.mark.parametrize("vf", BLOCK_VFS)
@pytest.mark.parametrize("codec", ["dotvbyte", "streamvbyte", "bitpack"])
def test_fused_scan_matches_plain(cuda, codec, vf, seg, monkeypatch):
    """``ops.score_*{,_batch}`` on the card run the scatter mode: equal to
    the plain version and to exact scores, with no slot scores, no
    ``scatter_block_scores`` and no ``index_add_`` on the way; docs span
    3 or more blocks."""
    fwd, packed = _block_pack(cuda, codec, vf, seg, T=128 if seg == "i8" else 512,
                              D=5 if seg == "i8" else None)
    ids = packed.doc_ids[packed.doc_ids >= 0]
    # the 700-entry doc spans 3 or more blocks of 128 entries (2 of 512)
    assert int(torch.bincount(ids.long()).max()) >= (3 if seg == "i8" else 2)
    rng = np.random.default_rng(11)
    Q = torch.from_numpy(rng.random((16, DIM)).astype(np.float32)).to(cuda)
    exact = np.stack([fwd.exact_scores(q) for q in Q.cpu().numpy()])
    entry = f"block_scan_{codec}"
    _fused_vs_plain(entry + "_batch", codec, Q, packed, fwd.n_docs)
    _fused_vs_plain(entry, codec, Q[:1], packed, fwd.n_docs)

    def refuse(*args, **kwargs):
        raise AssertionError("the fused path must not reach this")

    monkeypatch.setattr(scoring, "scatter_block_scores", refuse)
    monkeypatch.setattr(block_scan, "block_scores_plain", refuse)
    monkeypatch.setattr(block_scan, "scatter_block_scores", refuse)
    monkeypatch.setattr(torch.Tensor, "index_add_", refuse)
    single, batch = ops.block_scorers(codec)
    got_b, got_1 = batch(Q, packed), single(Q[2], packed)
    assert got_b.shape == (16, fwd.n_docs) and got_1.shape == (fwd.n_docs,)
    np.testing.assert_allclose(got_b.cpu().numpy(), exact, rtol=1e-5, atol=1e-3)
    np.testing.assert_allclose(got_1.cpu().numpy(), exact[2], rtol=1e-5, atol=1e-3)
    if codec == "bitpack":
        got_w = ops.score_bitpack_bucketed(Q[5], packed)
        np.testing.assert_allclose(got_w.cpu().numpy(), exact[5], rtol=1e-5, atol=1e-3)


@pytest.mark.parametrize("stage", ["entry_lanes", "query_lanes"])
@pytest.mark.parametrize("nq", [1, 5, 31, 64, 65, 130])
def test_fused_scan_every_batch_size(cuda, nq, stage):
    """Both scoring stages at batch sizes across the 32-lane and
    128-query tile edges, in both output modes."""
    fwd, packed = _block_pack(cuda, "dotvbyte", "f16", "i32", T=256)
    rng = np.random.default_rng(12 + nq)
    Q = torch.from_numpy(rng.random((nq, DIM)).astype(np.float32)).to(cuda)
    got = _fused_vs_plain("block_scan_dotvbyte_batch", "dotvbyte", Q, packed, fwd.n_docs,
                          stage=stage)
    exact = np.stack([fwd.exact_scores(q) for q in Q.cpu().numpy()])
    np.testing.assert_allclose(got.cpu().numpy(), exact, rtol=1e-5, atol=1e-3)
    before = dict(block_scan.stage_launches)
    slots = block_scan.block_scores("block_scan_dotvbyte_batch", "dotvbyte", Q,
                                    _block_streams(packed), stage=stage)
    assert block_scan.stage_launches[stage] == before[stage] + 1
    torch.testing.assert_close(
        slots, block_scan.block_scores_plain("dotvbyte", Q, _block_streams(packed)),
        rtol=1e-5, atol=1e-4)


def test_fused_scan_slot_zero_only(cuda):
    """Docs of exactly T entries: every block holds one fragment, so
    every slot but slot 0 is unused, and each doc lands in one block."""
    rng = np.random.default_rng(13)
    T = 256
    docs = [(np.sort(rng.choice(DIM, T, replace=False)), rng.gamma(2, .5, T))
            for _ in range(40)]
    fwd, packed = _block_pack(cuda, "streamvbyte", "f16", "i32", T=T, docs=docs)
    assert bool((packed.start_pos[:, 1:] == 0).all()) and packed.n_blocks == 40
    Q = torch.from_numpy(rng.random((70, DIM)).astype(np.float32)).to(cuda)
    for stage in block_scan.STAGES:
        got = _fused_vs_plain("block_scan_streamvbyte_batch", "streamvbyte", Q, packed,
                              fwd.n_docs, stage=stage)
        exact = np.stack([fwd.exact_scores(q) for q in Q.cpu().numpy()])
        np.testing.assert_allclose(got.cpu().numpy(), exact, rtol=1e-5, atol=1e-3)


@pytest.mark.parametrize("stage", ["entry_lanes", "query_lanes"])
def test_fused_scan_drops_bad_doc_ids(cuda, stage):
    """Slot ids of -1 and at or past n_docs drop, as the scatter drops
    them; every other slot still lands."""
    fwd, packed = _block_pack(cuda, "bitpack", "f32", "i32", T=128)
    rng = np.random.default_rng(14)
    ids = packed.doc_ids.clone()
    used = ids >= 0
    noise = torch.from_numpy(rng.integers(-4, fwd.n_docs + 40, ids.shape).astype(np.int32))
    ids = torch.where(used & (torch.rand(ids.shape, generator=torch.Generator().manual_seed(0))
                              < 0.3).to(cuda), noise.to(cuda), ids).contiguous()
    assert bool(((ids < 0) & used).any()) and bool((ids >= fwd.n_docs).any())
    Q = torch.from_numpy(rng.random((40, DIM)).astype(np.float32)).to(cuda)
    _fused_vs_plain("block_scan_bitpack_batch", "bitpack", Q, packed, fwd.n_docs, stage=stage,
                    doc_ids=ids)


def test_fused_static_widths_add_into_one_out(cuda):
    """Blocks at every width 1..32, one bucket each, all scattered into
    one result through ``out``: equal to the sum of the plain buckets."""
    rng = np.random.default_rng(15)
    T, D, n_docs = 256, 4, 50
    Q = torch.from_numpy(rng.random((1, DIM)).astype(np.float32)).to(cuda)
    out, want = None, torch.zeros((1, n_docs), device=cuda)
    before = block_scan.fused_launches["block_scan_bitpack_w"]
    for width in range(1, 33):
        gaps = rng.integers(0, min(1 << width, 400), size=(2, T), dtype=np.int64)
        gaps[:, :: T // D] = 0
        tight = (T * width + 31) // 32
        words = np.zeros((2, tight + (-tight) % 128), np.uint32)
        for b in range(2):
            words[b, :tight] = pack_block(gaps[b], width)
        s = {k: torch.from_numpy(v).to(cuda) for k, v in dict(
            words=words, seg=np.repeat(np.arange(D, dtype=np.int32), T // D)[None].repeat(2, 0),
            start_pos=np.tile(np.arange(0, T, T // D, dtype=np.int32), (2, 1)),
            start_abs=rng.integers(0, 3000, size=(2, D)).astype(np.int32),
            vals=rng.random((2, T)).astype(np.float16)).items()}
        ids = torch.from_numpy(rng.integers(-1, n_docs, (2, D)).astype(np.int32)).to(cuda)
        out = block_scan.scan_scores("block_scan_bitpack_w", "bitpack", Q, s, ids, n_docs,
                                     scale=0.5, width=width, out=out)
        want += block_scan.scan_scores_plain("bitpack", Q, s, ids, n_docs, scale=0.5,
                                             width=width)
    torch.cuda.synchronize()
    assert block_scan.fused_launches["block_scan_bitpack_w"] == before + 32
    torch.testing.assert_close(out, want, rtol=1e-5, atol=1e-4)
    assert float(want.abs().sum()) > 0


@pytest.mark.parametrize("stage", ["entry_lanes", "query_lanes"])
def test_block_scan_largest_block(cuda, stage):
    """T = 8192: 1024 threads, and 64 KB of shared memory under query
    lanes (above the 48 KB default)."""
    rng = np.random.default_rng(17)
    docs = [(np.sort(rng.choice(DIM, n, replace=False)), rng.gamma(2, .5, n))
            for n in rng.integers(1, 3000, size=12)]
    fwd, packed = _block_pack(cuda, "dotvbyte", "f16", "i32", T=8192, docs=docs)
    Q = torch.from_numpy(rng.random((3, DIM)).astype(np.float32)).to(cuda)
    got = _fused_vs_plain("block_scan_dotvbyte_batch", "dotvbyte", Q, packed, fwd.n_docs,
                          stage=stage)
    exact = np.stack([fwd.exact_scores(q) for q in Q.cpu().numpy()])
    np.testing.assert_allclose(got.cpu().numpy(), exact, rtol=1e-5, atol=2e-3)


# -- the rows kernel's shared form (nd = 1) in both stages ---------------------------


@pytest.mark.parametrize("nq", [1, 7, 32, 64, 65, 200])
@pytest.mark.parametrize("codec,vq", VARIANTS, ids=[f"{c}-{v}" for c, v in VARIANTS])
def test_rows_shared_form_every_batch_size(cuda, codec, vq, nq):
    """Every variant's shared form (one candidate set for the batch) in
    both stages against the plain version, across the lane and tile
    edges; the set holds the sentinel, both empty rows, the full row."""
    fwd, arrays = edge_rows(n_random=150, codec=codec, vq=vq)
    rng = np.random.default_rng(nq)
    Q = torch.from_numpy(rng.random((nq, DIM)).astype(np.float32)).to(cuda)
    docs = torch.from_numpy(candidates(fwd.n_docs, rng, (1, 300))).to(cuda)
    streams = _on(arrays, cuda)
    want = rows_dot.rows_scores_plain(codec, streams, Q, docs, 0.5)
    for stage in rows_dot.STAGES:
        before = rows_dot.stage_launches[stage]
        got = rows_dot.rows_scores_for_codec(codec, streams, Q, docs, 0.5, stage=stage)
        torch.cuda.synchronize()
        assert rows_dot.stage_launches[stage] == before + 1
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4)
        assert torch.all(got[:, :3] == 0)


@pytest.mark.parametrize("full", [700, 8192])
@pytest.mark.parametrize("codec", ["uncompressed", "dotvbyte", "streamvbyte", "bitpack"])
def test_rows_shared_form_wide_rows(cuda, codec, full):
    """Rows past 256 entries: the query-lane stage decodes them with the
    whole block, one row at a time (at L = 8192 into 64 KB of shared
    memory, above the 48 KB default)."""
    docs = edge_docs(DIM, np.random.default_rng(18), n_random=60, full=full)
    fwd = ForwardIndex.from_docs(docs, DIM, value_format="f16")
    streams = _on(pack_rows(fwd, codec=codec).arrays(), cuda)
    assert streams["vals_rows"].shape[1] >= full
    rng = np.random.default_rng(19)
    Q = torch.from_numpy(rng.random((40, DIM)).astype(np.float32)).to(cuda)
    ids = torch.from_numpy(candidates(fwd.n_docs, rng, (1, 64))).to(cuda)
    got = rows_dot.rows_scores_for_codec(codec, streams, Q, ids, stage="query_lanes")
    torch.cuda.synchronize()
    torch.testing.assert_close(got, rows_dot.rows_scores_plain(codec, streams, Q, ids),
                               rtol=1e-5, atol=1e-3)


def test_rows_query_lanes_refuse_per_query_sets(cuda):
    _, arrays = edge_rows(n_random=8)
    Q = torch.zeros((2, DIM), device=cuda)
    with pytest.raises(ValueError, match="shared candidate set"):
        rows_dot.rows_scores_for_codec("dotvbyte", _on(arrays, cuda), Q,
                                       torch.zeros((2, 4), dtype=torch.int32, device=cuda),
                                       stage="query_lanes")
