"""The CUDA kernels against their plain torch versions, on the card: the
rows kernel for every row codec × value codec and stored value format,
and the block-scan kernel for every codec, static width, value storage
and seg dtype; and the paths above them (serving, shards, mutation, the
encoder, the mesh, the configs, the LM family) on the card.

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
#: the block scan's stages that take a batch (the resident query takes one)
BATCH_STAGES = ("entry_lanes", "query_lanes")


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
    for nq in (1, 3, 67):
        Q = torch.rand((nq, DIM), generator=torch.Generator().manual_seed(2)).to(cuda)
        want = block_scan.block_scores_plain("dotvbyte", Q, t)
        want_docs = block_scan.scan_scores_plain("dotvbyte", Q, t, ids, n_docs)
        for stage in block_scan.STAGES if nq == 1 else BATCH_STAGES:
            got = block_scan.block_scores(entry, "dotvbyte", Q, t, stage=stage)
            got_docs = block_scan.scan_scores(entry, "dotvbyte", Q, t, ids, n_docs, stage=stage)
            torch.cuda.synchronize()
            torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4)
            torch.testing.assert_close(got_docs, want_docs, rtol=1e-5, atol=1e-4)
    bad = {**t, "seg": t["seg"][:, :100].contiguous(), "vals": t["vals"][:, :100].contiguous()}
    for stage in block_scan.STAGES:
        Qs = Q[:1] if stage == "resident_query" else Q
        with pytest.raises(RuntimeError, match="CUDA error"):
            block_scan._launch(entry, "dotvbyte", Qs, bad, t["ctrl"], t["data"], 1.0, 0, stage)
        with pytest.raises(RuntimeError, match="CUDA error"):
            block_scan._launch(entry, "dotvbyte", Qs, bad, t["ctrl"], t["data"], 1.0, 0, stage,
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
        Q = Q[:1] if stage == "resident_query" else Q
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


@pytest.mark.parametrize("stage", ["entry_lanes", "query_lanes", "resident_query"])
def test_block_scan_largest_block(cuda, stage):
    """T = 8192: 1024 threads, and 64 KB of shared memory under query
    lanes (above the 48 KB default); the resident query leaves room for
    three warps' scratch beside the 119 KB query."""
    rng = np.random.default_rng(17)
    docs = [(np.sort(rng.choice(DIM, n, replace=False)), rng.gamma(2, .5, n))
            for n in rng.integers(1, 3000, size=12)]
    fwd, packed = _block_pack(cuda, "dotvbyte", "f16", "i32", T=8192, docs=docs)
    Q = torch.from_numpy(rng.random((1 if stage == "resident_query" else 3, DIM))
                         .astype(np.float32)).to(cuda)
    got = _fused_vs_plain("block_scan_dotvbyte_batch", "dotvbyte", Q, packed, fwd.n_docs,
                          stage=stage)
    exact = np.stack([fwd.exact_scores(q) for q in Q.cpu().numpy()])
    np.testing.assert_allclose(got.cpu().numpy(), exact, rtol=1e-5, atol=2e-3)


# -- the rows kernel's shared form (nd = 1) in both stages ---------------------------


@pytest.mark.parametrize("nq", [1, 7, 32, 64, 65, 200])
@pytest.mark.parametrize("codec,vq", VARIANTS, ids=[f"{c}-{v}" for c, v in VARIANTS])
def test_rows_shared_form_every_batch_size(cuda, codec, vq, nq):
    """Every variant's shared form (one candidate set for the batch) in
    every stage that takes the batch (row warps: one query) against the
    plain version, across the lane and tile edges; the set holds the
    sentinel, both empty rows, the full row."""
    fwd, arrays = edge_rows(n_random=150, codec=codec, vq=vq)
    rng = np.random.default_rng(nq)
    Q = torch.from_numpy(rng.random((nq, DIM)).astype(np.float32)).to(cuda)
    docs = torch.from_numpy(candidates(fwd.n_docs, rng, (1, 300))).to(cuda)
    streams = _on(arrays, cuda)
    want = rows_dot.rows_scores_plain(codec, streams, Q, docs, 0.5)
    for stage in ("entry_lanes", "query_lanes", *(("row_warps",) if nq == 1 else ())):
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


# -- the block scan's resident-query stage (one query) -------------------------------


def _resident_vs_plain(Q, codec, streams, doc_ids, n_docs, scale=1.0, width=0):
    """Both output modes of the resident-query stage against their plain
    versions on the same tensors; each launch is counted under the
    stage."""
    entry = "block_scan_bitpack_w" if width else f"block_scan_{codec}"
    before = block_scan.stage_launches["resident_query"]
    got = block_scan.block_scores(entry, codec, Q, streams, scale=scale, width=width,
                                  stage="resident_query")
    got_docs = block_scan.scan_scores(entry, codec, Q, streams, doc_ids, n_docs, scale=scale,
                                      width=width, stage="resident_query")
    torch.cuda.synchronize()
    assert block_scan.stage_launches["resident_query"] == before + 2
    # the same products, summed in another order; fragments added by atomics
    torch.testing.assert_close(got, block_scan.block_scores_plain(
        codec, Q, streams, scale=scale, width=width), rtol=1e-5, atol=1e-4)
    torch.testing.assert_close(got_docs, block_scan.scan_scores_plain(
        codec, Q, streams, doc_ids, n_docs, scale=scale, width=width), rtol=1e-5, atol=1e-4)
    return got_docs


@pytest.mark.parametrize("seg", ["i32", "i8"])
@pytest.mark.parametrize("vf", BLOCK_VFS)
@pytest.mark.parametrize("codec", ["dotvbyte", "streamvbyte", "bitpack"])
def test_resident_query_matches_plain(cuda, codec, vf, seg):
    """Every codec, value storage and seg dtype in both output modes, at
    T = 128 (D = 5 slots) and T = 512; the single-query entries pick the
    stage themselves, and ``ops.score_*`` goes through it."""
    fwd, packed = _block_pack(cuda, codec, vf, seg, T=128 if seg == "i8" else 512,
                              D=5 if seg == "i8" else None)
    rng = np.random.default_rng(30)
    Q = torch.from_numpy(rng.random((1, DIM)).astype(np.float32)).to(cuda)
    scale = float(fwd.value_format.scale)
    got = _resident_vs_plain(Q, codec, _block_streams(packed), packed.doc_ids, fwd.n_docs,
                             scale)
    exact = fwd.exact_scores(Q[0].cpu().numpy())
    np.testing.assert_allclose(got[0].cpu().numpy(), exact, rtol=1e-5, atol=1e-3)
    before = block_scan.stage_launches["resident_query"]
    single, _ = ops.block_scorers(codec)
    np.testing.assert_allclose(single(Q[0], packed).cpu().numpy(), exact, rtol=1e-5, atol=1e-3)
    slots = _ENTRY_FNS[codec][0](Q[0], *_scan_streams(packed), scale=scale)
    torch.testing.assert_close(slots, block_scan.block_scores_plain(
        codec, Q, _block_streams(packed), scale=scale)[0], rtol=1e-5, atol=1e-4)
    assert block_scan.stage_launches["resident_query"] == before + 2


@pytest.mark.parametrize("width", range(1, 33))
def test_resident_query_every_static_width(cuda, width):
    """The static widths 1..32 of the bucketed entry, both output modes."""
    rng = np.random.default_rng(100 + width)
    B, T, D = 7, 512, 4
    gaps = rng.integers(0, min(1 << width, 400), size=(B, T), dtype=np.int64)
    gaps[:, :: T // D] = 0
    tight = (T * width + 31) // 32
    words = np.zeros((B, tight + (-tight) % 128), np.uint32)
    for b in range(B):
        words[b, :tight] = pack_block(gaps[b], width)
    seg = np.repeat(np.arange(D, dtype=np.int32), T // D)[None].repeat(B, 0)
    seg[-1, T // 2:] = -1
    s = {k: torch.from_numpy(v).to(cuda) for k, v in dict(
        words=words, seg=seg, start_pos=np.tile(np.arange(0, T, T // D, dtype=np.int32), (B, 1)),
        start_abs=rng.integers(0, 3000, size=(B, D)).astype(np.int32),
        vals=rng.random((B, T)).astype(np.float16)).items()}
    ids = torch.from_numpy(rng.integers(-1, 20, (B, D)).astype(np.int32)).to(cuda)
    Q = torch.from_numpy(rng.random((1, DIM)).astype(np.float32)).to(cuda)
    got = _resident_vs_plain(Q, "bitpack", s, ids, 20, scale=0.5, width=width)
    assert float(got.abs().sum()) > 0


def test_resident_query_largest_block_every_codec(cuda):
    """T = 8192 for each codec: a warp's scratch is 32 KB, so a thread
    block holds three warps beside the query."""
    rng = np.random.default_rng(31)
    docs = [(np.sort(rng.choice(DIM, n, replace=False)), rng.gamma(2, .5, n))
            for n in rng.integers(1, 3000, size=12)]
    Q = torch.from_numpy(rng.random((1, DIM)).astype(np.float32)).to(cuda)
    for codec in ("dotvbyte", "streamvbyte", "bitpack"):
        fwd, packed = _block_pack(cuda, codec, "f16", "i32", T=8192, docs=docs)
        got = _resident_vs_plain(Q, codec, _block_streams(packed), packed.doc_ids, fwd.n_docs)
        np.testing.assert_allclose(got[0].cpu().numpy(), fwd.exact_scores(Q[0].cpu().numpy()),
                                   rtol=1e-5, atol=2e-3)


@pytest.mark.parametrize("codec", ["streamvbyte", "bitpack"])
def test_resident_query_too_wide_routes_to_entry_lanes(cuda, codec):
    """A query of 2**24 + 2**20 floats does not fit in shared memory: the
    single-query scan stays on entry lanes (a shape rule, counted there),
    and asking for the resident stage raises before any launch."""
    dim = (1 << 24) + (1 << 20)
    rng = np.random.default_rng(32)
    fwd, packed = _block_pack(cuda, codec, "f16", "i32", T=256, D=200,
                              docs=wide_docs(dim, rng), dim=dim)
    Q = torch.rand((1, dim), generator=torch.Generator().manual_seed(3)).to(cuda)
    streams = _block_streams(packed)
    before = dict(block_scan.stage_launches)
    got = block_scan.scan_scores(f"block_scan_{codec}", codec, Q, streams, packed.doc_ids,
                                 fwd.n_docs)
    torch.cuda.synchronize()
    assert block_scan.stage_launches["entry_lanes"] == before["entry_lanes"] + 1
    assert block_scan.stage_launches["resident_query"] == before["resident_query"]
    torch.testing.assert_close(got, block_scan.scan_scores_plain(
        codec, Q, streams, packed.doc_ids, fwd.n_docs), rtol=1e-5, atol=1e-4)
    with pytest.raises(ValueError, match="resident-query stage"):
        block_scan.scan_scores(f"block_scan_{codec}", codec, Q, streams, packed.doc_ids,
                               fwd.n_docs, stage="resident_query")


@pytest.mark.parametrize("pad", [0, 3], ids=["aligned", "unaligned"])
def test_resident_query_malformed_streams(cuda, pad):
    """Random bytes in every stream (seg and start_pos out of range
    included), doc ids outside [0, n_docs), and data and word rows whose
    width is (pad 0) or is not (pad 3) a multiple of 16 bytes: the
    16-byte and the byte-wise loads agree with the plain version in both
    modes. (The plain decoders need every byte a random control stream
    can address, so the rows are that wide.)"""
    rng = np.random.default_rng(33 + pad)
    B, T, D, n_docs = 40, 256, 12, 20
    a = dict(ctrl=rng.integers(0, 256, (B, 128), dtype=np.uint8),
             data=rng.integers(0, 256, (B, 4 * T + 128 - pad), dtype=np.uint8),
             seg=rng.integers(-3, D + 3, (B, T)).astype(np.int32),
             start_pos=rng.integers(-5, T + 5, (B, D)).astype(np.int32),
             start_abs=rng.integers(-(1 << 20), DIM, (B, D)).astype(np.int32),
             vals=rng.random((B, T)).astype(np.float32))
    t = {k: torch.from_numpy(v).to(cuda) for k, v in a.items()}
    ids = torch.from_numpy(rng.integers(-3, n_docs + 3, (B, D)).astype(np.int32)).to(cuda)
    Q = torch.rand((1, DIM), generator=torch.Generator().manual_seed(4)).to(cuda)
    for codec in ("dotvbyte", "streamvbyte"):
        _resident_vs_plain(Q, codec, t, ids, n_docs)
    words = torch.from_numpy(rng.integers(0, 1 << 32, (B, T + 128 - pad),
                                          dtype=np.uint64).astype(np.uint32)).to(cuda)
    widths = torch.from_numpy(rng.integers(0, 33, B).astype(np.int32)).to(cuda)
    rest = {k: t[k] for k in ("seg", "start_pos", "start_abs", "vals")}
    _resident_vs_plain(Q, "bitpack", {"words": words, "widths": widths, **rest}, ids, n_docs)


# -- the rows kernel's row-warp stage -------------------------------------------------


def _row_warps_vs_plain(codec, streams, Q, docs, scale=0.5, n_rows=None):
    """Row warps against the plain version; ids outside [0, N] score 0
    (the plain version scores the sentinel N in their place)."""
    before = rows_dot.stage_launches["row_warps"]
    got = rows_dot.rows_scores_for_codec(codec, streams, Q, docs, scale, stage="row_warps")
    torch.cuda.synchronize()
    assert rows_dot.stage_launches["row_warps"] == before + 1
    N = streams["nnz_rows"].shape[0] - 1
    safe = torch.where((docs >= 0) & (docs <= N), docs, N).contiguous()
    want = rows_dot.rows_scores_plain(codec, streams, Q, safe, scale)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4)
    return got


@pytest.mark.parametrize("codec,vq", VARIANTS, ids=[f"{c}-{v}" for c, v in VARIANTS])
def test_row_warps_every_variant(cuda, codec, vq):
    """Every variant's per-query form (one candidate set per query, the
    Seismic form) in row warps, at 12 queries and at one, on edge rows:
    the sentinel, empty rows, the full row, and ids outside [0, N]."""
    fwd, arrays = edge_rows(n_random=200, codec=codec, vq=vq)
    rng = np.random.default_rng(34)
    streams = _on(arrays, cuda)
    nq, C = 12, 300
    Q = torch.from_numpy(rng.random((nq, DIM)).astype(np.float32)).to(cuda)
    docs = candidates(fwd.n_docs, rng, (nq, C))
    docs[:, 5:7] = [-7, fwd.n_docs + 9]
    docs = torch.from_numpy(docs).to(cuda)
    assert rows_dot.pick_stage(nq, nq, "row_warps", dim=DIM, C=C) == "row_warps"
    got = _row_warps_vs_plain(codec, streams, Q, docs)
    assert torch.all(got[:, :3] == 0) and torch.all(got[:, 5:7] == 0)
    _row_warps_vs_plain(codec, streams, Q[:1], docs[:1].contiguous())


@pytest.mark.parametrize("codec", ["uncompressed", "streamvbyte", "bitpack"])
def test_row_warps_too_wide_routes_to_entry_lanes(cuda, codec):
    """A query row of 2**24 + 2**20 floats does not fit in shared memory:
    the per-query form stays on entry lanes (a shape rule, counted
    there), and asking for row warps raises before any launch."""
    dim = (1 << 24) + (1 << 20)
    rng = np.random.default_rng(38)
    fwd = ForwardIndex.from_docs(wide_docs(dim, rng), dim, value_format="f16")
    streams = _on(pack_rows(fwd, codec=codec).arrays(), cuda)
    Q = torch.rand((2, dim), generator=torch.Generator().manual_seed(5)).to(cuda)
    docs = torch.arange(fwd.n_docs + 1, dtype=torch.int32, device=cuda).repeat(2, 1)
    assert rows_dot.pick_stage(2, 2, dim=dim, C=rows_dot.ROW_WARPS_MIN_ROWS) == "entry_lanes"
    before = dict(rows_dot.stage_launches)
    got = rows_dot.rows_scores_for_codec(codec, streams, Q, docs)
    torch.cuda.synchronize()
    assert rows_dot.stage_launches["entry_lanes"] == before["entry_lanes"] + 1
    assert rows_dot.stage_launches["row_warps"] == before["row_warps"]
    torch.testing.assert_close(got, rows_dot.rows_scores_plain(codec, streams, Q, docs),
                               rtol=1e-5, atol=1e-4)
    with pytest.raises(ValueError, match="row warps score"):
        rows_dot.rows_scores_for_codec(codec, streams, Q, docs, stage="row_warps")


@pytest.mark.parametrize("vf", ["f32", "fixedu8"])
@pytest.mark.parametrize("codec", ["uncompressed", "dotvbyte", "streamvbyte", "bitpack"])
def test_row_warps_every_stored_value_format(cuda, codec, vf):
    """Row warps read f32 and fixedu8 values under vq f16."""
    docs = edge_docs(DIM, np.random.default_rng(35), n_random=200, full=L)
    fwd = ForwardIndex.from_docs(docs, DIM, value_format=vf)
    streams = _on(pack_rows(fwd, codec=codec).arrays(), cuda)
    rng = np.random.default_rng(36)
    Q = torch.from_numpy(rng.random((6, DIM)).astype(np.float32)).to(cuda)
    ids = torch.from_numpy(candidates(fwd.n_docs, rng, (6, 256))).to(cuda)
    _row_warps_vs_plain(codec, streams, Q, ids, float(fwd.value_format.scale))


def _narrow(arrays, codec, vq, L):
    """The row streams cut to capacity L (the rows hold at most L entries),
    each to the width L needs: ctrl L/8 or L/4, data 4L + 1 bytes (not a
    multiple of 16: the byte-wise loads), words and comps L, values L or
    L/2."""
    half = vq in ("u4_sq", "pq")
    cut = {"vals_rows": L // 2 if half else L, "ctrl_rows": L // 8 if codec == "dotvbyte"
           else L // 4, "data_rows": 4 * L + 1, "words_rows": L, "comps_rows": L}
    return {k: (v[:, : cut[k]].copy() if k in cut and v.ndim == 2 else v)
            for k, v in arrays.items()}


@pytest.mark.parametrize("L_cap", [8, 256, 512, 2048])
@pytest.mark.parametrize("codec,vq", [("dotvbyte", "f16"), ("streamvbyte", "u8_sq"),
                                      ("bitpack", "u4_sq"), ("uncompressed", "pq")])
def test_row_warps_every_row_capacity(cuda, codec, vq, L_cap):
    """Rows of capacity 8 (cut by hand to odd widths) up to 2048 (one
    warp walks 256-entry chunks with a carried data offset)."""
    rng = np.random.default_rng(37 + L_cap)
    if L_cap == 8:
        docs = [(np.sort(rng.choice(DIM, n, replace=False)), rng.gamma(2, .5, n))
                for n in rng.integers(0, 9, size=60)]
    else:
        docs = edge_docs(DIM, rng, n_random=80, full=L_cap - 3)
    fwd = ForwardIndex.from_docs(docs, DIM, value_format="f16")
    arrays = pack_rows(fwd, codec=codec, vq=vq).arrays()
    if L_cap == 8:
        arrays = _narrow(arrays, codec, vq, 8)
    streams = _on(arrays, cuda)
    factor = 2 if vq in ("u4_sq", "pq") else 1
    assert streams["vals_rows"].shape[1] * factor == L_cap
    Q = torch.from_numpy(rng.random((5, DIM)).astype(np.float32)).to(cuda)
    ids = torch.from_numpy(rng.integers(0, fwd.n_docs + 1, (5, 128)).astype(np.int32)).to(cuda)
    got = _row_warps_vs_plain(codec, streams, Q, ids)
    assert float(got.abs().sum()) > 0



# -- the rows kernel at the hnsw engine's shape -----------------------------------------


@pytest.mark.parametrize("stage", ["row_warps", "entry_lanes"])
@pytest.mark.parametrize("C", [8, 32])
@pytest.mark.parametrize("codec,vq", VARIANTS, ids=[f"{c}-{v}" for c, v in VARIANTS])
def test_rows_kernel_at_the_graph_shape(cuda, codec, vq, C, stage):
    """64 queries, one set per query of the engine's 8 seeds or 32
    neighbours, in both stages that take the shape: sets that are all the
    sentinel (a step with nothing fresh), all real rows, and a mix."""
    fwd, arrays = edge_rows(seed=40, n_random=200, codec=codec, vq=vq)
    streams = _on(arrays, cuda)
    rng = np.random.default_rng(41)
    nq, N = 64, fwd.n_docs
    Q = torch.from_numpy(rng.random((nq, DIM)).astype(np.float32)).to(cuda)
    fresh = rng.integers(0, N, size=(nq, C)).astype(np.int32)
    mixed = np.where(rng.random((nq, C)) < 0.5, fresh, N).astype(np.int32)
    for name, ids in (("sentinel", np.full((nq, C), N, np.int32)), ("fresh", fresh),
                      ("mixed", mixed)):
        docs = torch.from_numpy(ids).to(cuda)
        before = rows_dot.stage_launches[stage]
        got = rows_dot.rows_scores_for_codec(codec, streams, Q, docs, 0.5, stage=stage)
        torch.cuda.synchronize()
        assert rows_dot.stage_launches[stage] == before + 1, name
        want = rows_dot.rows_scores_plain(codec, streams, Q, docs, 0.5)
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4, msg=name)
        if name == "sentinel":
            assert torch.all(got == 0)


@pytest.mark.parametrize("codec,vq", [("dotvbyte", "f16"), ("bitpack", "pq")])
def test_hnsw_search_on_the_card(cuda, codec, vq):
    """The hnsw engine on the card: 1 + iters rows-kernel launches a
    search, each in the stage ``pick_stage`` names for its set size, and
    the ids of ``backend="torch"`` on the same arrays."""
    from repro_torch.data.synthetic import generate_collection, splade_config
    from repro_torch.serve.api import Retriever, RetrieverConfig

    col = generate_collection(splade_config(400, 16, 3), value_format="f16")
    Q = np.stack([col.query_dense(i) for i in range(col.n_queries)])
    params = dict(beam=32, iters=20, n_seeds=8, m=16, ef_construction=48)
    cfg = RetrieverConfig(engine="hnsw", codec=codec, vq=vq, backend="cuda", params=params)
    r = Retriever.build(col.fwd, cfg, device=cuda)
    rows_dot.reset_launches()
    ids, scores = r.search(Q)
    torch.cuda.synchronize()
    assert rows_dot.launches == 1 + params["iters"]
    want = {rows_dot.pick_stage(16, 16, dim=col.fwd.dim, C=C): 0 for C in (8, 32)}
    want[rows_dot.pick_stage(16, 16, dim=col.fwd.dim, C=8)] += 1
    want[rows_dot.pick_stage(16, 16, dim=col.fwd.dim, C=32)] += params["iters"]
    assert {k: v for k, v in rows_dot.stage_launches.items() if v} == want
    plain = Retriever(cfg.replace(backend="torch"), r.arrays, n_docs=r.n_docs, dim=r.dim,
                      value_scale=r.value_scale, value_format=r.value_format, device=cuda)
    want_ids, want_scores = plain.search(Q)
    torch.testing.assert_close(scores, want_scores, rtol=1e-5, atol=1e-4)
    diff = ids != want_ids
    assert torch.allclose(scores[diff], want_scores[diff], rtol=1e-5, atol=0)


# -- the serving pipeline's plans: one captured CUDA graph per plan key --------------

#: per-engine knobs for the 400-doc collection (the CLI's Seismic blocks, a small graph)
PLAN_PARAMS = {
    "seismic": dict(cut=8, block_budget=512, n_probe=16, n_postings=400, block_size=16),
    "hnsw": dict(beam=32, iters=20, n_seeds=8, m=16, ef_construction=48),
    "flat": {},
}


@pytest.fixture(scope="module")
def plan_retrievers():
    """One dotvbyte retriever per engine on the card over a 400-doc
    SPLADE-statistics collection, with 64 queries."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    from repro_torch.data.synthetic import generate_collection, splade_config
    from repro_torch.serve.api import Retriever, RetrieverConfig

    col = generate_collection(splade_config(400, 64, 5), value_format="f16")
    Q = torch.from_numpy(np.stack([col.query_dense(i) for i in range(64)])).cuda()
    out = {}
    for engine, params in PLAN_PARAMS.items():
        cfg = RetrieverConfig(engine=engine, codec="dotvbyte", backend="cuda", params=params)
        out[engine] = Retriever.build(col.fwd, cfg, device="cuda")
    return out, Q


def _eager(r, Q, bucket):
    """The engine's search run eagerly on ``Q`` padded with zero queries
    to ``bucket``."""
    pad = torch.cat([Q, Q.new_zeros((bucket - Q.shape[0], Q.shape[1]))])
    ids, scores = r.impl.search_batch(r.cfg, r.n_docs, r.value_scale, r.arrays, pad)
    return ids[: Q.shape[0]], scores[: Q.shape[0]]


@pytest.mark.parametrize("bucket", [1, 8, 64])
@pytest.mark.parametrize("engine", ["seismic", "hnsw", "flat"])
def test_plan_replay_equals_eager_bitwise(plan_retrievers, engine, bucket):
    """A replayed plan runs the kernels the eager search runs, in the
    same stages, so its top-k equals ``impl.search_batch`` on the same
    padded batch bit for bit — full and ragged. The replay launches no
    kernel through a wrapper; the plan records the rows launches its
    graph holds, in the stages ``pick_stage`` names."""
    retrievers, Q = plan_retrievers
    r = retrievers[engine]
    plan = r.plans.get(bucket)
    plan.warm(r.dim)
    assert plan.pool_bytes >= 0 and plan.capture_s > 0
    assert plan.launches["variants"] == {"rows_dot_dotvbyte_f16": sum(
        plan.launches["stages"].values())}
    for n in sorted({bucket, max(1, bucket // 2 + 1)}):
        before, replays = rows_dot.launches, plan.replays
        ids, scores = plan(Q[:n])
        torch.cuda.synchronize()
        assert rows_dot.launches == before and plan.replays == replays + 1
        want_ids, want_scores = _eager(r, Q[:n], bucket)
        assert ids.shape == (n, r.cfg.k) and ids.dtype == torch.int32
        assert torch.equal(ids, want_ids) and torch.equal(scores, want_scores), n
    before = dict(rows_dot.stage_launches)
    _eager(r, Q[:bucket], bucket)
    torch.cuda.synchronize()
    eager = {k: v - before[k] for k, v in rows_dot.stage_launches.items() if v > before[k]}
    assert plan.launches["stages"] == eager


@pytest.mark.parametrize("engine", ["seismic", "hnsw", "flat"])
def test_plan_zeroes_stale_rows_and_hands_out_copies(plan_retrievers, engine):
    """A call with fewer queries than the last zeroes the static
    buffer's rows past its own, and no two calls' results share memory
    with each other or with the graph's static outputs."""
    retrievers, Q = plan_retrievers
    r = retrievers[engine]
    plan = r.plans.get(8)
    a_ids, a_scores = plan(Q[:8])
    a_copy = (a_ids.clone(), a_scores.clone())
    b_ids, b_scores = plan(Q[8:11])
    torch.cuda.synchronize()
    assert torch.equal(plan._Q[:3], Q[8:11]) and torch.all(plan._Q[3:] == 0)
    assert torch.equal(a_ids, a_copy[0]) and torch.equal(a_scores, a_copy[1])
    static = {t.data_ptr() for t in plan._out}
    assert not static & {t.data_ptr() for t in (a_ids, a_scores, b_ids, b_scores)}
    assert a_ids.data_ptr() != b_ids.data_ptr()
    want_ids, want_scores = _eager(r, Q[8:11], 8)
    assert torch.equal(b_ids, want_ids) and torch.equal(b_scores, want_scores)


@pytest.mark.parametrize("engine", ["seismic", "hnsw", "flat"])
def test_plan_over_a_host_syncing_engine_raises(plan_retrievers, engine):
    """An engine whose search reads a value back to the host cannot be
    captured: the plan raises at capture, every later call raises too,
    and nothing runs eagerly in its place."""
    from repro_torch.serve import api

    retrievers, Q = plan_retrievers
    base = retrievers[engine]
    inner = type(base.impl)

    class HostSync(inner):
        def search_batch(self, cfg, n_docs, value_scale, arrays, Q):
            calls.append(Q.shape[0])
            if int((Q != 0).sum().item()) < 0:  # a device → host read
                raise AssertionError
            return super().search_batch(cfg.replace(engine=engine), n_docs, value_scale,
                                        arrays, Q)

    calls = []
    api.register_engine("test_host_sync")(HostSync)
    try:
        r = api.Retriever(base.cfg.replace(engine="test_host_sync"), base.arrays,
                          n_docs=base.n_docs, dim=base.dim, value_scale=base.value_scale,
                          value_format=base.value_format, device="cuda")
        with pytest.raises(RuntimeError, match="CUDA graph capture of plan") as err:
            r.search(Q[:4])
        assert calls == [4, 4]  # the eager warm-up, then the capture that failed
        assert err.value.__cause__ is not None  # torch's own capture error
        with pytest.raises(RuntimeError, match="CUDA graph capture of plan"):
            r.search(Q[:4])  # no graph, and no eager answer in its place
        assert r.plans.get(4)._graph is None
    finally:
        api._ENGINES.pop("test_host_sync", None)
    assert torch.ones(3, device="cuda").sum().item() == 3  # the context still works
    ids, _ = base.search(Q[:4])  # and so do the other plans
    assert torch.equal(ids, _eager(base, Q[:4], 4)[0])


# -- sharded serving: pinned staging, prefetch, captures beside the staging worker --------


@pytest.fixture(scope="module")
def shard_trees(tmp_path_factory):
    """A four-shard dotvbyte tree per engine, saved uncompressed, over the
    400-doc collection of the plan tests, with its 64 queries."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    from repro_torch.data.synthetic import generate_collection, splade_config
    from repro_torch.serve.api import Retriever, RetrieverConfig

    col = generate_collection(splade_config(400, 64, 5), value_format="f16")
    Q = torch.from_numpy(np.stack([col.query_dense(i) for i in range(64)])).cuda()
    root = tmp_path_factory.mktemp("shard_trees")
    trees = {}
    for engine, params in PLAN_PARAMS.items():
        cfg = RetrieverConfig(engine=engine, codec="dotvbyte", backend="cuda", n_shards=4,
                              params=params)
        trees[engine] = Retriever.build(col.fwd, cfg, device="cuda").save(root / engine)
    return trees, Q


def _open_tree(tree, max_resident, prefetch):
    from repro_torch.serve.api import open_retriever

    r = open_retriever(tree, device="cuda")
    r.max_resident, r.prefetch = max_resident, prefetch
    return r


def test_pinned_staging_places_shard_arrays_on_the_card(shard_trees):
    """A memory-mapped shard is paged into pinned memory and copied to the
    card on the copy stream: every array lands byte-equal on the device,
    and a served shard never sits on the CPU."""
    trees, Q = shard_trees
    r = _open_tree(trees["flat"], 1, False)
    arrays = r.shards[2].arrays
    assert all(isinstance(a, np.memmap) for a in arrays.values() if a.size)
    placed = r._place(arrays)
    torch.cuda.synchronize()
    assert r.builds == 1 and r.admission_s["page_in"] > 0 and r.admission_s["h2d"] > 0
    for k, a in arrays.items():
        assert placed[k].is_cuda and placed[k].shape == a.shape, k
        assert torch.equal(placed[k].cpu(), torch.from_numpy(np.array(a))), k
    r.search(Q)
    assert len(r._resident) == 1
    assert all(t.is_cuda for sr in r._resident.values() for t in sr.arrays.values())


@pytest.mark.parametrize("engine", ["seismic", "hnsw", "flat"])
def test_prefetch_on_equals_off_bitwise(shard_trees, engine):
    """At max_resident 1 and 4, prefetch on and off answer bit for bit the
    same; the staged shards are consumed from the second rotation on, each
    search replays one plan per shard (the rows launches its graphs hold:
    one per shard, 1 + iters per shard for hnsw), and the memory allocated
    after the third rotation is the first's, within one shard's arrays and
    one graph pool."""
    trees, Q = shard_trees
    want = None
    for max_resident in (1, 4):
        for prefetch in (False, True):
            r = _open_tree(trees[engine], max_resident, prefetch)
            got = r.search(Q)
            if max_resident == 1 and prefetch:
                r._staged[1].result()
                torch.cuda.synchronize()
                first = torch.cuda.memory_allocated()
            for _ in range(2):
                got = r.search(Q)
            if max_resident == 1 and prefetch:
                r._staged[1].result()
                torch.cuda.synchronize()
                grown = torch.cuda.memory_allocated() - first
                shard = max(sum(int(a.nbytes) for a in sh.arrays.values()) for sh in r.shards)
                assert grown <= shard + r.pool_bytes(), (grown, shard, r.pool_bytes())
                assert r.prefetch_hits > 0 and r.evictions >= 8
            if want is None:
                want = got
            assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
            plan = r.plans.get(64)
            per_shard = 1 + PLAN_PARAMS["hnsw"]["iters"] if engine == "hnsw" else 1
            assert sum(plan.launches["variants"].values()) == 4 * per_shard
            assert {label for label, _ in plan.stages} == {"0/4", "1/4", "2/4", "3/4"}


def test_no_capture_error_under_a_concurrent_trace(shard_trees):
    """Two threads submit a trace through the pipeline of an out-of-core
    tree (max_resident 1, prefetch on): the staging worker copies the next
    shard while the serving thread captures each admitted shard's plans,
    and no capture raises; every response equals direct search bit for
    bit."""
    import threading

    from repro_torch.launch.serve import trace_parity
    from repro_torch.serve.pipeline import synthetic_trace

    trees, Q = shard_trees
    r = _open_tree(trees["flat"], 1, True)
    direct_ids, direct_scores = (t.cpu().numpy() for t in r.search(Q))
    pipe = r.pipeline(deadline_us=200.0, cache_size=0)
    Qn = Q.cpu().numpy()
    traces = [synthetic_trace(np.random.default_rng(seed), 48, 64) for seed in (1, 2)]
    tickets = [[], []]
    errors = []

    def drive(i):
        try:
            for qi in traces[i]:
                pipe.poll()
                tickets[i].append(pipe.submit(Qn[qi]))
            pipe.flush()
        except Exception as e:  # noqa: BLE001  (reported below, with its type)
            errors.append(e)

    threads = [threading.Thread(target=drive, args=(i,)) for i in (0, 1)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    assert not any(t.is_alive() for t in threads) and not errors, errors
    trace = np.concatenate(traces)
    done = tickets[0] + tickets[1]
    assert all(t.done for t in done) and r.prefetch_hits > 0
    trace_parity(trace, done, direct_ids, direct_scores)


def test_capture_survives_garbage_that_holds_a_graph(shard_trees):
    """A collection by Python's cyclic collector in the middle of a
    capture would destroy the CUDA graph an unreachable cycle holds (a
    dropped sharded retriever is one: its plan cache refers back to it),
    a call that invalidates the capture. Captures run with the collector
    off: here a cycle holding another plan's graph turns unreachable
    inside a capture, with the collector set to run at every allocation,
    and the capture still succeeds."""
    import gc

    from repro_torch.serve import api

    trees, Q = shard_trees
    ref = _open_tree(trees["flat"], 1, False)
    arrays = {k: np.array(a) for k, a in ref.shards[0].arrays.items()}
    kw = dict(n_docs=ref.shards[0].n_docs, dim=ref.dim, value_scale=ref.value_scale,
              value_format=ref.value_format, device="cuda")
    other = api.Retriever(ref.cfg.replace(n_shards=1), arrays, **kw)
    other.search(Q)  # one captured graph, held only by its plan below
    victims = [other.plans.get(64)]
    del other
    inner = type(api.get_engine("flat"))

    class DropsAGraph(inner):
        def search_batch(self, cfg, n_docs, value_scale, arrays, Q):
            if torch.cuda.is_current_stream_capturing() and victims:
                cycle = [victims.pop()]
                cycle.append(cycle)
                del cycle
                [object() for _ in range(64)]  # allocations: the collector's chance
            return super().search_batch(cfg.replace(engine="flat"), n_docs, value_scale,
                                        arrays, Q)

    api.register_engine("test_drops_a_graph")(DropsAGraph)
    threshold = gc.get_threshold()
    gc.set_threshold(1)
    try:
        r = api.Retriever(ref.cfg.replace(n_shards=1, engine="test_drops_a_graph"), arrays,
                          **kw)
        ids, scores = r.search(Q)
        torch.cuda.synchronize()
    finally:
        gc.set_threshold(*threshold)
        api._ENGINES.pop("test_drops_a_graph", None)
    assert not victims  # the cycle was made inside the capture
    gc.collect()  # the graph goes now, outside any capture
    want = api.Retriever(ref.cfg.replace(n_shards=1), arrays, **kw).search(Q)
    assert torch.equal(ids, want[0]) and torch.equal(scores, want[1])


# -- live mutation: parts' plans, retired pools, the merge worker's captures ------------

#: the reference's budgets, exhaustive for its 50-doc mutation fixture
MUT_PARAMS = {
    "seismic": dict(cut=16, block_budget=512, n_probe=512, n_postings=10000, block_size=8),
    "hnsw": dict(beam=64, iters=64, n_seeds=4, m=8, ef_construction=48),
    "flat": {},
}


@pytest.fixture(scope="module")
def mut_collection():
    """The reference's mutation fixture (50 docs at dim 256, seed 7, 4
    queries), made by the port's generator."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    from repro_torch.data.synthetic import SyntheticConfig, generate_collection

    col = generate_collection(SyntheticConfig(name="segments-test", dim=256, n_docs=50,
                                              n_queries=4, doc_nnz_mean=24.0,
                                              query_nnz_mean=8.0, seed=7), value_format="f16")
    return col, np.stack([col.query_dense(i) for i in range(col.n_queries)])


def _hold_bitwise(got, want, label):
    """Ids equal and scores the same bits: every rows-kernel stage sums a
    dot in one order, so no response depends on the stage its batch took."""
    gi, gs = (t.cpu() if isinstance(t, torch.Tensor) else torch.tensor(np.asarray(t))
              for t in got)
    wi, ws = (t.cpu() if isinstance(t, torch.Tensor) else torch.tensor(np.asarray(t))
              for t in want)
    assert torch.equal(gi, wi.to(gi.dtype)), label
    assert torch.equal(gs.float().view(torch.int32), ws.float().view(torch.int32)), label


def _hold_to_oracle(m, Q, label):
    """The mutable index against a ``Retriever.build`` over its live
    corpus on the card, bit for bit (``_hold_bitwise``)."""
    from repro_torch.serve.api import Retriever

    live_fwd, live = m.live_corpus()
    oracle = Retriever.build(live_fwd, m.cfg.replace(n_shards=1), device="cuda")
    oi, osc = (t.cpu().numpy() for t in oracle.search(Q))
    got = m.search(Q)
    want_ids = np.where(oi < len(live), live[np.minimum(oi, len(live) - 1)], -1)
    _hold_bitwise(got, (want_ids, osc), label)


@pytest.mark.parametrize("codec", ["uncompressed", "dotvbyte", "streamvbyte", "bitpack"])
@pytest.mark.parametrize("engine", ["seismic", "hnsw", "flat"])
def test_mutation_oracle_parity_on_the_card(mut_collection, engine, codec):
    """The reference's mutation sweep (``tests/test_segments.py``) on the
    card: tombstones at 0 segments, 1 and 3 segments (an update among
    them), the merge; at every step the mutable index against the oracle
    over its live corpus; every search replays one plan per part."""
    from repro_torch.serve.api import RetrieverConfig
    from repro_torch.serve.segments import MutableRetriever

    col, Q = mut_collection
    fwd = col.fwd
    cfg = RetrieverConfig(engine=engine, codec=codec, backend="cuda", k=5,
                          params=MUT_PARAMS[engine])
    m = MutableRetriever.create(fwd.slice(0, 40), cfg, device="cuda")
    per_part = 1 + MUT_PARAMS["hnsw"]["iters"] if engine == "hnsw" else 1

    def check(label):
        _hold_to_oracle(m, Q, f"{engine}/{codec} {label}")
        plan = m.plans.get(m.plans.bucket_for(len(Q)))
        assert sum(plan.launches["variants"].values()) == (1 + len(m.segments)) * per_part
        assert {label for label, _ in plan.stages} <= {"base"} | {
            f"seg{i}" for i in range(len(m.segments))}

    m.delete([3, 17])
    check("0 segments")
    m.insert([fwd.doc(i) for i in range(40, 44)])
    check("1 segment")
    m.insert([fwd.doc(i) for i in range(44, 47)])
    m.delete([41, 45])
    m.update([fwd.doc(47)], ids=[10])
    check("3 segments")
    m.merge()
    check("post-merge")
    assert all(t.is_cuda for t in m.base.arrays.values())


@pytest.mark.parametrize("engine", ["seismic", "hnsw", "flat"])
def test_one_doc_and_all_dead_segments_on_the_card(mut_collection, engine):
    """A one-doc segment and a segment whose rows are all dead, per
    engine, held to the oracle on the card; nothing served is dead."""
    from repro_torch.serve.api import RetrieverConfig
    from repro_torch.serve.segments import MutableRetriever

    col, Q = mut_collection
    fwd = col.fwd
    cfg = RetrieverConfig(engine=engine, codec="dotvbyte", backend="cuda", k=5,
                          params=MUT_PARAMS[engine])
    m = MutableRetriever.create(fwd.slice(0, 40), cfg, device="cuda")
    one = m.insert([fwd.doc(40)])
    _hold_to_oracle(m, Q, f"{engine} one-doc segment")
    dead = m.insert([fwd.doc(i) for i in range(41, 45)])
    m.delete(np.concatenate([dead, one]))
    _hold_to_oracle(m, Q, f"{engine} all-dead segments")
    ids = m.search(Q)[0].cpu().numpy()
    assert not np.intersect1d(ids, np.concatenate([dead, one])).size


@pytest.fixture(scope="module")
def mut_seismic():
    """A Seismic dotvbyte index over 2,000 SPLADE-statistics docs on the
    card with 64 queries: a bucket-64 graph pool of the size the serving
    path captures."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    from repro_torch.data.synthetic import generate_collection, splade_config

    col = generate_collection(splade_config(2000, 64, 9), value_format="f16")
    return col, torch.from_numpy(np.stack([col.query_dense(i) for i in range(64)])).cuda()


def test_retired_part_pools_are_released(mut_seismic):
    """Every delete in the base moves its budget (``k + dead``) and makes
    a new part wrapper, captured afresh; the retired wrapper's graphs and
    pool are released once the dispatch ends, so after 20 deletes the
    memory allocated is the first delete's within one graph pool."""
    from repro_torch.serve.api import RetrieverConfig
    from repro_torch.serve.segments import MutableRetriever

    col, Q = mut_seismic
    cfg = RetrieverConfig(engine="seismic", codec="dotvbyte", backend="cuda",
                          params=PLAN_PARAMS["seismic"])
    m = MutableRetriever.create(col.fwd, cfg, device="cuda")
    m.search(Q)
    mem, pools = [], []
    for i in range(20):
        before = m._wrappers["base"]
        m.delete([i])
        m.search(Q)
        torch.cuda.synchronize()
        assert m._wrappers["base"] is not before and not m._retired
        mem.append(torch.cuda.memory_allocated())
        pools.append(m._wrappers["base"].plans.get(64).pool_bytes)
        del before
    assert m._wrappers["base"].cfg.k == 30
    assert mem[-1] - mem[0] <= max(pools), (mem, pools)
    assert m.plans.compiles == 21


@pytest.mark.parametrize("rep", range(5))
def test_pipeline_stress_during_a_background_merge(mut_seismic, rep):
    """Two threads submit through the pipeline while a background merge
    builds the new base, places it and captures its plans on the worker
    (thread-local capture mode) and flips: no capture raises, every
    response equals the pre-merge direct search bit for bit, and the
    worker's prewarmed plans serve after the flip without
    a capture on the serving thread."""
    import threading

    from repro_torch.serve.api import RetrieverConfig
    from repro_torch.serve.segments import MutableRetriever

    col, Q = mut_seismic
    fwd = col.fwd
    cfg = RetrieverConfig(engine="flat", codec="dotvbyte", backend="cuda")
    m = MutableRetriever.create(fwd.slice(0, 1500), cfg, device="cuda")
    m.insert(fwd.slice(1500, 1800))
    m.insert(fwd.slice(1800, 2000))
    m.delete(np.arange(rep, 400, 7))
    pipe = m.pipeline(deadline_us=200.0, cache_size=0)
    pipe.warm()
    want = tuple(t.cpu().numpy() for t in m.search(Q))
    Qn = Q.cpu().numpy()
    tickets, errors, stop = [[], []], [], threading.Event()

    def drive(i):
        rng = np.random.default_rng(i + 10 * rep)
        try:
            while not stop.is_set() or len(tickets[i]) < 32:
                qi = int(rng.integers(64))
                pipe.poll()
                tickets[i].append((qi, pipe.submit(Qn[qi])))
            pipe.flush()
        except Exception as e:  # noqa: BLE001  (reported below, with its type)
            errors.append(e)
            stop.set()

    threads = [threading.Thread(target=drive, args=(i,)) for i in (0, 1)]
    for t in threads:
        t.start()
    try:
        new_base = m.merge(background=True).result(timeout=600)
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=600)
    assert not any(t.is_alive() for t in threads) and not errors, errors
    assert new_base is m.base and m.generation == 1
    for qi, t in tickets[0] + tickets[1]:
        ids, scores = t.result()
        _hold_bitwise((ids, scores), (want[0][qi], want[1][qi]), f"query {qi}")
    prewarmed = m._wrappers["base"].plans.created()
    assert all(p._graph is not None for p in prewarmed.values())
    graphs = {b: p._graph for b, p in prewarmed.items()}
    got = m.search(Q)
    assert m._wrappers["base"].plans.get(64)._graph is graphs[64]  # replayed, not captured
    _hold_bitwise(got, want, "after the flip")


# -- one summation order in every rows-kernel stage ------------------------------------

#: row lengths on both sides of the group (8), half-warp chunk (128) and
#: warp (256) edges, at row capacity 256; and past it
STAGE_LENGTHS = (1, 8, 9, 128, 129, 256)
LONG_LENGTHS = (257, 511, 512, 513, 700, 1100)


def _length_rows(codec, vq, lengths, seed):
    """Packed rows: one document of each length, then random ones."""
    rng = np.random.default_rng(seed)
    docs = [(np.sort(rng.choice(DIM, n, replace=False)), rng.gamma(2, .5, n)) for n in lengths]
    docs += [(np.sort(rng.choice(DIM, n, replace=False)), rng.gamma(2, .5, n))
             for n in rng.integers(1, 200, size=60)]
    fwd = ForwardIndex.from_docs(docs, DIM, value_format="f16")
    return fwd, pack_rows(fwd, codec=codec, vq=vq).arrays()


def _stages_agree(codec, streams, Q, docs, scale=0.5):
    """Every stage that takes the shape → the stages; their scores are the
    same bits, and the plain version's within f32 reordering."""
    nq, nd, C = Q.shape[0], docs.shape[0], docs.shape[1]
    outs = {}
    for st in rows_dot.STAGES:
        try:
            rows_dot.pick_stage(nq, nd, st, dim=Q.shape[1], C=C)
        except ValueError:
            continue
        outs[st] = rows_dot.rows_scores_for_codec(codec, streams, Q, docs, scale, stage=st)
    torch.cuda.synchronize()
    (first, ref), *rest = outs.items()
    for st, got in rest:
        same = got.view(torch.int32) == ref.view(torch.int32)
        assert bool(same.all()), (first, st, int((~same).sum()))
    torch.testing.assert_close(ref, rows_dot.rows_scores_plain(codec, streams, Q, docs, scale),
                               rtol=1e-5, atol=1e-3)
    return list(outs)


@pytest.mark.parametrize("form", ["shared", "per_query", "long_rows"])
@pytest.mark.parametrize("codec,vq", VARIANTS, ids=[f"{c}-{v}" for c, v in VARIANTS])
def test_rows_stages_agree_bitwise(cuda, codec, vq, form):
    """Every variant's stages give the same bits (C2): the shared form at
    nq 1, 7, 8, 32 and 130 (entry lanes, query lanes — 130 takes both
    64-query passes of a tile and a second tile — and row warps at one
    query), the per-query form at 15 and 16 x 4,096 (entry lanes, row
    warps), rows of 1-256 entries at capacity 256 and of 257-1,100 past
    it; queries of both signs."""
    lengths = LONG_LENGTHS if form == "long_rows" else STAGE_LENGTHS
    fwd, arrays = _length_rows(codec, vq, lengths, seed=50)
    streams = _on(arrays, cuda)
    rng = np.random.default_rng(51)
    N = fwd.n_docs
    lead = np.array([*range(len(lengths)), N], np.int32)  # every length, the sentinel
    took = set()
    if form == "per_query":
        Q = torch.from_numpy(rng.standard_normal((16, DIM)).astype(np.float32)).to(cuda)
        docs = rng.integers(0, N + 1, size=(16, 4096)).astype(np.int32)
        docs[:, : len(lead)] = lead
        docs = torch.from_numpy(docs).to(cuda)
        for nq in (15, 16):
            took |= set(_stages_agree(codec, streams, Q[:nq], docs[:nq].contiguous()))
        assert took == {"entry_lanes", "row_warps"}
        assert rows_dot.pick_stage(15, 15, dim=DIM, C=4096) == "entry_lanes"
        assert rows_dot.pick_stage(16, 16, dim=DIM, C=4096) == "row_warps"
        return
    Q = torch.from_numpy(rng.standard_normal((130, DIM)).astype(np.float32)).to(cuda)
    docs = np.concatenate([lead, rng.integers(0, N + 1, size=300).astype(np.int32)])[None]
    docs = torch.from_numpy(docs).to(cuda)
    for nq in (1, 7, 8, 32, 130):
        took |= set(_stages_agree(codec, streams, Q[:nq].contiguous(), docs))
    assert took == set(rows_dot.STAGES)


#: the reference pipeline tests' collection and knobs (``tests/test_pipeline.py``)
PIPE_COLLECTION = dict(name="pipe", dim=1024, n_docs=240, n_queries=7, doc_nnz_mean=35.0,
                       query_nnz_mean=10.0, seed=3)
PIPE_PARAMS = {
    "seismic": dict(cut=8, block_budget=128, n_probe=24, n_postings=200, block_size=16),
    "hnsw": dict(beam=16, iters=16, n_seeds=4, m=8, ef_construction=24),
    "flat": {},
}


@pytest.fixture(scope="module")
def pipe_collection():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    from repro_torch.data.synthetic import SyntheticConfig, generate_collection
    from repro_torch.serve.api import RetrieverConfig, get_engine

    col = generate_collection(SyntheticConfig(**PIPE_COLLECTION), value_format="f16")
    Q = np.stack([col.query_dense(i) for i in range(col.n_queries)])
    hosts = {e: get_engine(e).host_index(col.fwd, RetrieverConfig(engine=e, params=PIPE_PARAMS[e]))
             for e in ("seismic", "hnsw")}
    return col, Q, hosts


def _pipe_retriever(pipe_collection, engine, codec, **kw):
    from repro_torch.serve.api import Retriever, RetrieverConfig

    col, _, hosts = pipe_collection
    cfg = RetrieverConfig(engine=engine, codec=codec, k=5, backend="cuda",
                          params=PIPE_PARAMS[engine], **kw)
    if engine in hosts:
        return Retriever.from_host_index(hosts[engine], cfg, device="cuda")
    return Retriever.build(col.fwd, cfg, device="cuda")


PIPE_CODECS = ["uncompressed", "dotvbyte", "streamvbyte", "bitpack"]


@pytest.mark.parametrize("codec", PIPE_CODECS)
@pytest.mark.parametrize("engine", ["seismic", "hnsw", "flat"])
def test_pipeline_matches_direct_search_on_the_card(pipe_collection, engine, codec):
    """The reference's ``test_pipeline_matches_direct_search`` on
    ``backend="cuda"``: the scheduler's dispatch and a cache-hit replay
    give direct search's bytes."""
    col, Q, _ = pipe_collection
    r = _pipe_retriever(pipe_collection, engine, codec)
    ids_d, sc_d = (t.cpu().numpy() for t in r.search(Q))  # direct: pads 7 → bucket 8
    ids_p, sc_p = r.search_batch(Q)
    _hold_bitwise((ids_p, sc_p), (ids_d, sc_d), "pipeline")
    ids_c, sc_c = r.search_batch(Q)  # every query now a cache hit
    _hold_bitwise((ids_c, sc_c), (ids_p, sc_p), "cache")
    snap = r.pipeline().snapshot()
    assert snap["cache_hit_rate"] == pytest.approx(0.5)
    assert snap["n_queries"] == 2 * col.n_queries


@pytest.mark.parametrize("codec", PIPE_CODECS)
@pytest.mark.parametrize("engine", ["seismic", "hnsw", "flat"])
def test_batch_size_hint_gets_exact_plan_on_the_card(pipe_collection, engine, codec):
    """The reference's ``test_batch_size_hint_gets_exact_plan`` on
    ``backend="cuda"``: the exact-fit bucket 7 gives the padded bucket 8's
    bytes (flat: entry lanes at 7, query lanes at 8)."""
    _, Q, _ = pipe_collection
    r = _pipe_retriever(pipe_collection, engine, codec, batch_size=7)
    assert 7 in r.plans.buckets and r.plans.bucket_for(7) == 7
    got = r.search(Q)
    r8 = _pipe_retriever(pipe_collection, engine, codec)
    want = r8.search(Q)
    _hold_bitwise(got, want, f"{engine}/{codec}")
    if engine == "flat":
        assert r.plans.get(7).stages != r8.plans.get(8).stages


def test_seismic_buckets_15_and_16_agree_bitwise(cuda):
    """Seismic at 64 probed blocks of 64 docs: 4,096 candidates a query, so
    bucket 15 rescores on entry lanes and bucket 16 on row warps; the
    responses are the same bytes."""
    from repro_torch.data.synthetic import SyntheticConfig, generate_collection
    from repro_torch.serve.api import Retriever, RetrieverConfig

    col = generate_collection(SyntheticConfig(name="b16", dim=4096, n_docs=2500, n_queries=15,
                                              doc_nnz_mean=60.0, query_nnz_mean=20.0, seed=9),
                              value_format="f16")
    Q = np.stack([col.query_dense(i) for i in range(col.n_queries)])
    params = dict(cut=8, block_budget=512, n_probe=64, n_postings=2500, block_size=64)
    cfg = RetrieverConfig(engine="seismic", codec="dotvbyte", backend="cuda", params=params)
    r15 = Retriever.build(col.fwd, cfg.replace(batch_size=15), device="cuda")
    r16 = Retriever(cfg, r15.arrays, n_docs=r15.n_docs, dim=r15.dim, value_scale=r15.value_scale,
        value_format=r15.value_format, device="cuda")
    got, want = r15.search(Q), r16.search(Q)
    assert r15.plans.bucket_for(15) == 15 and r16.plans.bucket_for(15) == 16
    C = r15.impl.candidates(r15.cfg, r15.n_docs, r15.arrays, torch.from_numpy(Q).cuda()).shape[1]
    assert C == 4096, C
    assert set(r15.plans.get(15).stages) == {"entry_lanes"}
    assert set(r16.plans.get(16).stages) == {"row_warps"}
    _hold_bitwise(got, want, "seismic 15 vs 16")


# -- the encoder and its training on the card ----------------------------------------

#: a small encoder (the card's path at CPU-test speed)
ENC_SMALL = dict(vocab=2048, n_layers=2, d_model=64, n_heads=4, d_ff=128, max_len=32)


def _enc_setup(device, eps=1e-3, **kw):
    from repro_torch.models import sparse_encoder as enc
    from repro_torch.train import optimizer, train_step

    cfg = enc.SparseEncoderConfig(**ENC_SMALL, **kw)
    params = enc.encoder_init(torch.Generator().manual_seed(0), cfg, device=device)
    init, upd = optimizer.make_optimizer(
        optimizer.OptimizerConfig(lr=1e-3, warmup_steps=2, total_steps=20, eps=eps))
    step = train_step.make_train_step(lambda p, b: enc.contrastive_loss(p, cfg, b), upd)
    return cfg, train_step.init_train_state(params, init), step


def _enc_batch(cfg, device, seed=0, B=4):
    rng = np.random.default_rng(seed)
    S = cfg.max_len
    out = {}
    for side in ("q", "d"):
        out[f"{side}_tokens"] = torch.from_numpy(rng.integers(0, cfg.vocab, (B, S))).to(device)
        out[f"{side}_mask"] = torch.from_numpy(
            np.arange(S)[None, :] < rng.integers(1, S + 1, B)[:, None]).to(device)
    return out


def test_encoder_and_a_train_step_on_the_card_match_the_cpu(cuda):
    """Encode and one AdamW step (``eps`` 1e-3, so the update is a smooth
    function of the gradient) on the card against the CPU, full f32."""
    from repro_torch.models import sparse_encoder as enc
    from repro_torch.tree import tree_leaves_with_path, tree_map

    assert torch.get_float32_matmul_precision() == "highest"
    cfg, state_cpu, step = _enc_setup("cpu")
    state_gpu = tree_map(lambda t: t.to(cuda), state_cpu)
    b_cpu = _enc_batch(cfg, "cpu")
    b_gpu = {k: v.to(cuda) for k, v in b_cpu.items()}
    want = enc.encode(state_cpu["params"], cfg, b_cpu["d_tokens"], b_cpu["d_mask"])
    got = enc.encode(state_gpu["params"], cfg, b_gpu["d_tokens"], b_gpu["d_mask"])
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)
    s_cpu, m_cpu = step(state_cpu, b_cpu)
    s_gpu, m_gpu = step(state_gpu, b_gpu)
    assert all(v.is_cuda for v in m_gpu.values())
    for k in ("loss", "grad_norm", "lr"):
        torch.testing.assert_close(m_gpu[k].cpu(), m_cpu[k], rtol=1e-4, atol=0)
    for (p, a), (_, b) in zip(tree_leaves_with_path(s_gpu), tree_leaves_with_path(s_cpu)):
        assert a.is_cuda and a.dtype == b.dtype, p
        torch.testing.assert_close(a.cpu(), b, rtol=1e-4, atol=1e-6, msg=p)


def test_checkpoint_saved_from_the_card_restores_on_the_cpu(cuda, tmp_path):
    from repro_torch.train import checkpoint
    from repro_torch.tree import tree_leaves, tree_map

    cfg, state, step = _enc_setup(cuda)
    state, _ = step(state, _enc_batch(cfg, cuda))
    checkpoint.save(str(tmp_path), 3, state)
    on_cpu, meta = checkpoint.restore(str(tmp_path), state, device="cpu")
    assert meta["step"] == 3
    for a, b in zip(tree_leaves(on_cpu), tree_leaves(state)):
        assert a.device.type == "cpu" and a.dtype == b.dtype and torch.equal(a, b.cpu())
    back, _ = checkpoint.restore(str(tmp_path), tree_map(lambda t: t.cpu(), state), device=cuda)
    assert all(a.is_cuda and torch.equal(a, b) for a, b in zip(tree_leaves(back), tree_leaves(state)))
    same, _ = checkpoint.restore(str(tmp_path), state)  # each leaf where its template leaf is
    assert all(a.is_cuda for a in tree_leaves(same))


@pytest.fixture
def deterministic():
    """``torch.use_deterministic_algorithms(True)`` for one test (cuBLAS
    needs a fixed workspace for it)."""
    import os

    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    before = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(before)


def test_runner_replay_is_bit_for_bit_on_the_card(cuda, deterministic, tmp_path):
    from repro_torch.launch.train_sparse_encoder import synth_pairs
    from repro_torch.train.elastic import FaultInjector, Runner, RunnerConfig
    from repro_torch.tree import tree_leaves_with_path

    cfg, state, step = _enc_setup(cuda, eps=1e-8)
    batch_fn = lambda i: synth_pairs(0, i, cfg, batch=8, seq=16, device=cuda)  # noqa: E731
    faulted = Runner(RunnerConfig(total_steps=20, checkpoint_dir=str(tmp_path / "a"),
                                  checkpoint_every=5, step_timeout_s=60.0),
                     step, batch_fn, state, device=cuda,
                     fault_injector=FaultInjector(fail_at=(7, 13)))
    got, hist = faulted.run()
    assert faulted.restarts == 2 and hist[-1]["step"] == 19
    clean = Runner(RunnerConfig(total_steps=20, checkpoint_dir=str(tmp_path / "b"),
                                checkpoint_every=5), step, batch_fn, state, device=cuda)
    want, _ = clean.run()
    for (p, a), (_, b) in zip(tree_leaves_with_path(got), tree_leaves_with_path(want)):
        assert a.is_cuda and torch.equal(a, b), p


def test_train_sparse_encoder_cli_on_the_card(cuda, capsys):
    import re

    from repro_torch.launch import train_sparse_encoder as cli

    before = rows_dot.launches
    cli.main(["--steps", "20", "--n-docs", "160"])
    out = capsys.readouterr().out
    loss = re.search(r"loss ([\d.]+) → ([\d.]+) over 20 steps", out)
    assert loss and float(loss.group(2)) < float(loss.group(1)), out
    flat = re.search(r"Retriever flat \(dotvbyte, backend=cuda\) recall@10: ([\d.]+)", out)
    assert flat and float(flat.group(1)) == 1.0, out
    assert re.search(r"Retriever seismic \(dotvbyte, backend=cuda\) recall@10: [\d.]+", out), out
    assert rows_dot.launches > before  # the encoded corpus went through the rows kernel


# ---------------------------------------------------------------------------
# the mesh fan-out on the card: spawned ranks, NCCL at world 1 and gloo
# with every rank on cuda:0 (tests/torch_mesh_cases.py)
# ---------------------------------------------------------------------------

MESH_SEISMIC = dict(cut=8, block_budget=256, n_probe=48, n_postings=300, block_size=16)
MESH_EXHAUSTIVE = dict(cut=16, block_budget=512, n_probe=512, n_postings=10000, block_size=8)


@pytest.fixture(scope="module")
def mesh_corpus():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    from repro_torch.data.synthetic import SyntheticConfig, generate_collection

    col = generate_collection(SyntheticConfig(name="t", dim=2048, n_docs=600, n_queries=8,
                                              doc_nnz_mean=60.0, query_nnz_mean=16.0, seed=0),
                              value_format="f16")
    small = generate_collection(SyntheticConfig(name="mesh", dim=256, n_docs=48, n_queries=4,
                                                doc_nnz_mean=24.0, query_nnz_mean=8.0, seed=3),
                                value_format="f16")
    return (col.fwd, np.stack([col.query_dense(i) for i in range(8)]),
            small.fwd, np.stack([small.query_dense(i) for i in range(4)]))


def _mesh_cfg(engine, codec="dotvbyte", params=None):
    from repro_torch.serve.api import RetrieverConfig

    params = {"seismic": MESH_SEISMIC, "flat": {},
              "hnsw": dict(beam=48, iters=48, n_seeds=4, m=8, ef_construction=32)}[engine] \
        if params is None else params
    return RetrieverConfig(engine=engine, codec=codec, backend="cuda", k=10, params=params)


def _shard_oracle(cfg, arrays, idmap, n_local, n_docs, Q):
    """Each shard's ``search_batch`` on the card in turn, then the merge."""
    from repro_torch.serve.api import get_engine, map_local_ids, merge_topk

    impl = get_engine(cfg.engine)
    dev = torch.device("cuda")
    ids, scores = [], []
    for s in range(idmap.shape[0]):
        shard = {k: torch.from_numpy(np.ascontiguousarray(v[s])).to(dev) for k, v in arrays.items()}
        i, sc = impl.search_batch(cfg, n_local, 1.0, shard, Q)
        ids.append(map_local_ids(torch.from_numpy(idmap[s]).to(dev), i, n_docs))
        scores.append(sc)
    gi, gs = merge_topk(torch.cat(ids, 1), torch.cat(scores, 1), cfg.k,
                        dedupe=impl.dedupe_merge, n_docs_global=n_docs)
    return gi.cpu().numpy(), gs.cpu().numpy()


def test_sharded_search_nccl_world_1_equals_monolithic(mesh_corpus, tmp_path):
    """(a) ``make_sharded_search`` over ``build_shard_arrays(n_shards=1,
    host_index=)`` on one NCCL rank: the monolithic Seismic answer bit for
    bit, through the rows kernel."""
    from torch_mesh_cases import load, serving_ranks

    from repro_torch.launch.mesh import spawn_ranks
    from repro_torch.serve.api import Retriever, build_shard_arrays, get_engine

    fwd, Q, small, Qs = mesh_corpus
    cfg = _mesh_cfg("seismic")
    index = get_engine("seismic").host_index(fwd, cfg)
    mono = Retriever.from_host_index(index, cfg, device="cuda").search(Q)
    arrays, idmap, n_local = build_shard_arrays(fwd, cfg, 1, host_index=index)
    case = {"a": dict(mesh=(1, 1), cfg=cfg, arrays=arrays, idmap=idmap, n_local=n_local,
                      n_docs=fwd.n_docs)}
    spawn_ranks(serving_ranks, 1, str(tmp_path), case, torch.from_numpy(Q), small,
                torch.from_numpy(Qs), [], [], "cuda", backend="nccl",
                init_file=tmp_path / "init", timeout_s=300)
    got = load(str(tmp_path), 1)[0]
    assert np.array_equal(got["a/ids"], mono[0].cpu().numpy())
    assert np.array_equal(got["a/scores"].view(np.int32), mono[1].cpu().numpy().view(np.int32))
    assert int(got["rows_launches"]) > 0


@pytest.fixture(scope="module")
def mesh_served_on_the_card(mesh_corpus, tmp_path_factory):
    """(b) four gloo ranks on cuda:0: ``make_sharded_search`` at S = 4 for
    three engines and ``ShardedRetriever(use_mesh=)`` over the 48-doc
    fixture with tombstones, backend cuda."""
    from torch_mesh_cases import load, serving_ranks

    from repro_torch.launch.mesh import spawn_ranks
    from repro_torch.serve.api import build_shard_arrays

    fwd, Q, small, Qs = mesh_corpus
    cases, stacks = {}, {}
    for engine in ("flat", "seismic", "hnsw"):
        sub = fwd if engine != "hnsw" else fwd.slice(0, 200)
        cfg = _mesh_cfg(engine)
        arrays, idmap, n_local = build_shard_arrays(sub, cfg, 4)
        stacks[engine] = (cfg, arrays, idmap, n_local, sub.n_docs)
        cases[engine] = dict(mesh=(1, 4), cfg=cfg, arrays=arrays, idmap=idmap, n_local=n_local,
                             n_docs=sub.n_docs)
    out = tmp_path_factory.mktemp("mesh_cuda")
    spawn_ranks(serving_ranks, 4, str(out), cases, torch.from_numpy(Q), small,
                torch.from_numpy(Qs), [("flat", {}), ("seismic", MESH_EXHAUSTIVE)],
                [[0, 11, 12, 30, 47], [1, 13, 14, 31, 46]], "cuda", "cuda", backend="gloo",
                init_file=out / "init", timeout_s=300)
    return load(str(out), 4), stacks, Q


@pytest.mark.parametrize("engine", ["flat", "seismic", "hnsw"])
def test_sharded_search_on_the_card_equals_the_oracle(mesh_served_on_the_card, engine):
    ranks, stacks, Q = mesh_served_on_the_card
    cfg, arrays, idmap, n_local, n_docs = stacks[engine]
    want_i, want_s = _shard_oracle(cfg, arrays, idmap, n_local, n_docs,
                                   torch.from_numpy(Q).cuda())
    for r in ranks:
        assert np.array_equal(r[f"{engine}/ids"], want_i)
        assert np.array_equal(r[f"{engine}/scores"].view(np.int32), want_s.view(np.int32))
    assert sum(int(r["rows_launches"]) for r in ranks) > 0


@pytest.mark.parametrize("tag", ["none", "v0", "v1"])
@pytest.mark.parametrize("engine", ["flat", "seismic"])
def test_mesh_retriever_on_the_card_equals_the_rotation(mesh_served_on_the_card, engine, tag):
    for r in mesh_served_on_the_card[0]:
        for mode in ("True", "None"):
            assert np.array_equal(r[f"{engine}/{tag}/{mode}/ids"], r[f"{engine}/{tag}/False/ids"])
            assert np.array_equal(r[f"{engine}/{tag}/{mode}/scores"].view(np.int32),
                                  r[f"{engine}/{tag}/False/scores"].view(np.int32))


@pytest.mark.parametrize("codec", ["dotvbyte", "streamvbyte", "bitpack"])
def test_doc_aligned_scan_on_the_card(mesh_corpus, tmp_path, codec):
    """(c) the doc-aligned scan through the block-scan kernel on four gloo
    ranks (cuda:0): the ranks' slices in order against ``exact_scores``
    (f16 values: 2e-3) at nq 8 and 1."""
    from torch_mesh_cases import load, scan_ranks

    from repro_torch.core.layout import pack_blocks_sharded
    from repro_torch.launch.mesh import spawn_ranks

    fwd, Q, _, _ = mesh_corpus
    packs, docs_local = pack_blocks_sharded(fwd, 4, codec=codec, block_size=128)
    spawn_ranks(scan_ranks, 4, str(tmp_path), {codec: packs}, docs_local, torch.from_numpy(Q),
                (1, 4), "cuda", backend="gloo", init_file=tmp_path / "init", timeout_s=300)
    ranks = load(str(tmp_path), 4)
    for form, q in (("batch", Q), ("single", Q[:1])):
        got = np.concatenate([r[f"{codec}/{form}"] for r in ranks], axis=1)[:, : fwd.n_docs]
        want = np.stack([fwd.exact_scores(x) for x in q])
        assert np.abs(got - want).max() < 2e-3
    launched = {k: sum(int(r[f"launches/{k}"]) for r in ranks)
                for k in (f"block_scan_{codec}", f"block_scan_{codec}_batch")}
    assert all(v >= 4 for v in launched.values()), launched


# ---------------------------------------------------------------------------
# the retrieval configs' cells (repro_torch.configs) and phase 13's
# full-corpus replication, on the card
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def config_cells_on_the_card(mesh_corpus, tmp_path_factory):
    """Every cell of both configs at 600 docs (dim 2,048; the graph over
    200), 8 queries, from one gloo rank on ``cuda:0``: the CPU run and the
    card's."""
    from torch_mesh_cases import config_cells_ranks, load

    from repro_torch.launch.mesh import spawn_ranks

    fwd, Q, _, _ = mesh_corpus
    out = tmp_path_factory.mktemp("config_cells")
    spawn_ranks(config_cells_ranks, 1, str(out), fwd, torch.from_numpy(Q), 200,
                backend="gloo", init_file=out / "init", timeout_s=600)
    return load(str(out), 1)[0], fwd, Q


@pytest.mark.parametrize("opt", [0, 1, 2, 3])
@pytest.mark.parametrize("arch_id", ["msmarco-splade", "msmarco-lilsr"])
def test_config_scan_cell_on_the_card_matches_its_cpu_run(config_cells_on_the_card, arch_id,
                                                          opt):
    got, fwd, Q = config_cells_on_the_card
    card, cpu = got[f"{arch_id}/scan{opt}/cuda"], got[f"{arch_id}/scan{opt}/cpu"]
    assert card.shape == cpu.shape == (len(Q), fwd.n_docs)
    np.testing.assert_allclose(card, cpu, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(card, np.stack([fwd.exact_scores(q) for q in Q]), rtol=1e-4,
                               atol=2e-3)
    assert int(got["launches/block_scan_dotvbyte_batch"]) >= 8


@pytest.mark.parametrize("shape", ["serve_4096q", "graph_4096q"])
@pytest.mark.parametrize("arch_id", ["msmarco-splade", "msmarco-lilsr"])
def test_config_search_cell_on_the_card_matches_its_cpu_run(config_cells_on_the_card, arch_id,
                                                            shape):
    """The card (the rows kernel) against the CPU (plain torch): ids equal
    but where two scores tie (rtol 1e-5), scores within rtol 1e-5."""
    got = config_cells_on_the_card[0]
    ci, cs = got[f"{arch_id}/{shape}/cuda/ids"], got[f"{arch_id}/{shape}/cuda/scores"]
    pi, ps = got[f"{arch_id}/{shape}/cpu/ids"], got[f"{arch_id}/{shape}/cpu/scores"]
    diff = ci != pi
    assert np.allclose(cs[diff], ps[diff], rtol=1e-5, atol=0)
    np.testing.assert_allclose(cs, ps, rtol=1e-5, atol=1e-6)
    assert int(got[f"{arch_id}/{shape}/replayed"]) > 0


@pytest.mark.parametrize("n_docs", [6_000, 5_500])
def test_full_corpus_replication_on_the_card(cuda, mesh_corpus, n_docs):
    """``chip_smoke.py``'s ``replicate_pack`` and ``replicate_csr`` on a
    ten-fold copy of the 600-doc pack (whole, and cut inside the last
    copy): the fused batch scan on the card equals ``sparse.mm`` of the
    base copy by copy and ``sparse.mm`` of the replicated CSR (1e-4)."""
    import sys

    sys.path.insert(0, str(__import__("pathlib").Path(__file__).resolve().parents[1]))
    import chip_smoke

    from repro_torch.core.forward_index import PackedBlocks

    fwd, Q, _, _ = mesh_corpus
    n = fwd.n_docs
    Qc = torch.from_numpy(Q).to(cuda)
    base = {k: torch.from_numpy(v).to(cuda) for k, v in layout.pack_blocks(
        fwd, codec="dotvbyte", block_size=512).as_dict().items()}
    rep = chip_smoke.replicate_pack(base, n, n_docs)
    packed = PackedBlocks(codec="dotvbyte", block_size=512, n_docs=n_docs, dim=fwd.dim,
                          value_format=fwd.value_format, **rep)
    before = block_scan.variant_launches["block_scan_dotvbyte_batch"]
    got = ops.score_dotvbyte_batch(Qc, packed)
    assert block_scan.variant_launches["block_scan_dotvbyte_batch"] == before + 1
    parts = [torch.from_numpy(a).to(cuda) for a in (
        fwd.offsets.astype(np.int64), fwd.components.astype(np.int64),
        fwd.value_format.dequantise(fwd.values))]
    base_scores = torch.sparse.mm(torch.sparse_csr_tensor(*parts, size=(n, fwd.dim)),
                                  Qc.t().contiguous()).t()
    assert len(chip_smoke.replicas_close(got, base_scores, n)) == -(-n_docs // n)
    crow, col, val = chip_smoke.replicate_csr(*parts, n, n_docs)
    full = torch.sparse_csr_tensor(crow, col, val, size=(n_docs, fwd.dim))
    torch.testing.assert_close(got, torch.sparse.mm(full, Qc.t().contiguous()).t(),
                               rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# the LM family (chip_smoke.py phase 14 at a small size)
# ---------------------------------------------------------------------------

LM_IDS = ("olmoe-1b-7b", "kimi-k2-1t-a32b", "qwen3-8b", "yi-6b", "deepseek-coder-33b")


@pytest.mark.parametrize("arch_id", LM_IDS)
def test_lm_smoke_on_the_card_matches_the_cpu(cuda, arch_id):
    """Every LM config's ``smoke()`` (two train steps, a forward, a decode
    step at the smoke width, f32) on the card and on the CPU from the same
    weights: losses rtol 1e-4, logits atol 1e-4 (f32 sums in other orders;
    TF32 off)."""
    from repro_torch.configs import get_arch

    torch.backends.cuda.matmul.allow_tf32 = False
    card = get_arch(arch_id).smoke(0, device=cuda)
    cpu = get_arch(arch_id).smoke(0, device="cpu")
    assert card["device"] == "cuda"
    for k in ("loss0", "loss1"):
        assert abs(card[k] - cpu[k]) <= 1e-4 * abs(cpu[k]), (k, card[k], cpu[k])
    for k in ("logits", "decode_logits"):
        torch.testing.assert_close(card[k], cpu[k], rtol=0, atol=1e-4)


@pytest.mark.parametrize("moe", [False, True], ids=["dense", "moe"])
def test_lm_decode_matches_forward_on_the_card(cuda, moe):
    """The mini LM in f32 on the card: ten decode steps equal ``forward``
    at their positions (atol 3e-5, the reference's own test's), with
    experts at a capacity where no token drops."""
    import dataclasses

    from torch_lm_cases import mini_lm

    from repro_torch.models import transformer as tf

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = mini_lm(moe=moe)
    if moe:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=4.0))
    p = tf.init_params(torch.Generator().manual_seed(1), cfg, device=cuda)
    toks = torch.from_numpy(np.random.default_rng(1).integers(0, cfg.vocab, (2, 10))).to(cuda)
    with torch.no_grad():
        full, _ = tf.forward(p, cfg, toks)
        cache = tf.init_kv_cache(cfg, 2, 10, torch.float32, device=cuda)
        lens = torch.zeros(2, dtype=torch.int32, device=cuda)
        outs = []
        for t in range(10):
            lg, cache = tf.decode_step(p, cfg, cache, toks[:, t:t + 1], lens)
            lens = lens + 1
            outs.append(lg)
    torch.testing.assert_close(torch.stack(outs, 1), full, rtol=0, atol=3e-5)


def test_lm_decode_cell_and_flash_decode_nccl_world_1(cuda, tmp_path):
    """The mini LM's ``decode_32k`` cell on one NCCL rank (flash decoding
    over a one-rank group, the in-place cache write) against the CPU's
    ``decode_step`` (atol 1e-4), and flash decoding's local path against
    the masked reference (atol 1e-5)."""
    from torch_lm_cases import (MINI_DECODE, MINI_STEPS, card_ranks, flash_inputs, mini_lm)

    from repro_torch.launch.mesh import spawn_ranks
    from repro_torch.models import transformer as tf

    cfg = mini_lm()
    B, S = MINI_DECODE["decode_32k"]
    params = tf.init_params(torch.Generator().manual_seed(4), cfg, device="cpu")
    toks = np.random.default_rng(5).integers(0, cfg.vocab, (B, MINI_STEPS))
    spawn_ranks(card_ranks, 1, str(tmp_path), params, toks, "cuda", backend="nccl",
                init_file=tmp_path / "init", timeout_s=300)
    got = dict(np.load(tmp_path / "rank0.npz"))
    cache = tf.init_kv_cache(cfg, B, S, device="cpu")
    lens = torch.zeros(B, dtype=torch.int32)
    with torch.no_grad():
        for t in range(MINI_STEPS):
            want, cache = tf.decode_step(params, cfg, cache, torch.from_numpy(toks[:, t:t + 1]),
                                         lens)
            lens = lens + 1
            np.testing.assert_allclose(got[f"logits{t}"], want.numpy(), rtol=0, atol=1e-4)
    for k in ("k", "v"):
        np.testing.assert_allclose(got[k], cache[k].numpy(), rtol=0, atol=1e-4)
    want = tf._decode_attention_ref(*(torch.from_numpy(a) for a in flash_inputs(2)))
    np.testing.assert_allclose(got["flash"], want.numpy(), rtol=0, atol=1e-5)


def test_lm_train_cli_on_the_card(cuda, capsys, tmp_path):
    from repro_torch.launch import train

    train.main(["--arch", "kimi-k2-1t-a32b", "--smoke", "--steps", "4", "--checkpoint-every",
                "2", "--checkpoint-dir", str(tmp_path)])
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith("trained kimi-k2-1t-a32b 4 steps") and "restarts=0" in line


# ---------------------------------------------------------------------------
# C7, the placed cells at world 1, the GNN and RecSys families
# (chip_smoke.py phases 14 and 15 at a small size)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("top_k", [1, 2, 8])
def test_moe_combine_repeats_its_bits_on_the_card(cuda, top_k):
    """C7: an MoE layer in bf16 (8 experts, tight capacity: pairs drop)
    five times on the card without deterministic algorithms — the output
    and the input gradient the same bits each run; the slot-order combine
    on the card from the card's expert outputs equals the CPU's bits,
    forward and backward."""
    from repro_torch.models import moe

    assert not torch.are_deterministic_algorithms_enabled()
    cfg = moe.MoEConfig(n_experts=8, top_k=top_k, d_model=64, d_ff=96, capacity_factor=0.75)
    p = {k: v.to(cuda) for k, v in moe.moe_init(torch.Generator().manual_seed(top_k), cfg,
                                                dtype=torch.bfloat16, device="cpu").items()}
    x0 = torch.from_numpy(np.random.default_rng(top_k).standard_normal((2048, 64)).astype(
        np.float32)).to(torch.bfloat16).to(cuda)
    runs = []
    for _ in range(5):
        x = x0.clone().requires_grad_(True)
        y, _ = moe.moe_apply(p, cfg, x)
        (y.float() * torch.linspace(-1, 1, 64, device=cuda)).sum().backward()
        runs.append((y.detach(), x.grad))
    for y, g in runs[1:]:
        assert torch.equal(y, runs[0][0]) and torch.equal(g, runs[0][1])
    with torch.no_grad():
        _, gate_w, idx = moe._route(p, cfg, x0)
        tok, w, slot_map = moe._dispatch_slots(idx, gate_w, cfg)
        E, C = cfg.n_experts, moe._capacity(2048, cfg)
        ye = moe._swiglu(moe._take_rows(x0, tok).reshape(E, C, -1), p["w_gate"], p["w_up"],
                         p["w_down"])
        contrib = ye.reshape(E * C, -1) * w[:, None].to(ye.dtype)
    sides = []
    for d in (cuda, torch.device("cpu")):
        c = contrib.to(d).clone().requires_grad_(True)
        yc = moe._Combine.apply(c, slot_map.to(d), tok.to(d))
        (yc.float() * torch.linspace(-1, 1, 64, device=d)).sum().backward()
        sides.append((yc.detach().cpu(), c.grad.cpu()))
    assert torch.equal(sides[0][0], sides[1][0]) and torch.equal(sides[0][1], sides[1][1])


def test_lm_placed_cells_nccl_world_1(cuda, tmp_path):
    """The mini LMs' four cells with ``weights="placed"`` on one NCCL rank
    (every collective on a group of one) against one process's
    whole-weight run on the CPU (f32, TF32 off: losses rtol 1e-4, state
    atol 1e-5, logits and caches atol 1e-4)."""
    from torch_lm_cases import check_placed_ranks, placed_cases, placed_cells_ranks

    from repro_torch.launch.mesh import spawn_ranks

    cases = placed_cases()
    toks = np.random.default_rng(11).integers(0, 128, (4, 16)).astype(np.int32)
    spawn_ranks(placed_cells_ranks, 1, str(tmp_path), cases, toks, (1, 1), "cuda",
                backend="nccl", init_file=tmp_path / "init", timeout_s=300)
    check_placed_ranks([dict(np.load(tmp_path / "rank0.npz"))], cases, toks, (1, 1), rtol=1e-4,
                       state_atol=1e-5, atol=1e-4)


def test_recsys_placed_cells_nccl_world_1(cuda, tmp_path):
    """DeepFM's and SASRec's placed ``train_batch``, ``serve_p99`` and
    ``retrieval_cand`` on one NCCL rank against one process on the CPU
    (f32, TF32 off: rtol 1e-4 of each leaf's scale)."""
    from torch_family_cases import PLACED_REC, placed_rec_one_process, placed_rec_rank

    from repro_torch.launch.mesh import spawn_ranks

    spawn_ranks(placed_rec_rank, 1, str(tmp_path), (1, 1), "cuda", backend="nccl",
                init_file=tmp_path / "init", timeout_s=300)
    got = dict(np.load(tmp_path / "rank0.npz"))
    want = placed_rec_one_process()
    assert sorted(got) == sorted(want)
    for a in PLACED_REC:
        top = max(float(np.abs(v).max()) for k, v in want.items() if k.startswith(f"{a}/state"))
        for k, v in want.items():
            if k.startswith(a):
                scale = max(float(np.abs(v).max()), 1e-2 * top)
                assert float(np.abs(got[k] - v).max()) <= 1e-4 * scale, k


@pytest.mark.parametrize("arch_id", ["gat-cora", "deepfm", "dcn-v2", "sasrec", "din"])
def test_family_smoke_on_the_card_matches_the_cpu(cuda, arch_id):
    """Each GNN and RecSys config's ``smoke()`` (GAT: three train steps and
    the sampler; RecSys: a train step) on the card and on the CPU from the
    same weights and batches: losses rtol 1e-4 (f32, TF32 off)."""
    from repro_torch.configs import get_arch

    torch.backends.cuda.matmul.allow_tf32 = False
    card = get_arch(arch_id).smoke(0, device=cuda)
    cpu = get_arch(arch_id).smoke(0, device="cpu")
    assert card["device"] == "cuda"
    key = "losses" if arch_id == "gat-cora" else "loss"
    np.testing.assert_allclose(card[key], cpu[key], rtol=1e-4)

