"""The fused full-scan entry ``block_scan.scan_scores`` (the block-scan
kernel's scatter mode) and the scoring-stage choice, on the CPU:

* ``scan_scores`` on CPU tensors (the kernel's plain version and the
  scatter) equals the reference's ``ops.score_*(mode="jnp")`` and
  ``ForwardIndex.exact_scores`` (atol 2e-3: f16 values), on docs that
  span several blocks, with slot ids of -1, and added into one result
  across the static-width buckets;
* its argument checks (dtype, shape, device) raise;
* on (fake) CUDA tensors it goes to the kernel, never to the plain
  version;
* ``pick_stage`` of both kernels follows the stated thresholds.

``pallas_interpret`` is no target: the reference's block scan does not
run in that mode under the installed jax."""

import warnings

import numpy as np
import pytest
import torch

from repro.core import layout as ref_layout
from repro.core.forward_index import ForwardIndex as RefForwardIndex
from repro.kernels import ops as ref_ops
from repro_torch.core import layout
from repro_torch.core.forward_index import ForwardIndex
from repro_torch.kernels import block_scan, build, ops, rows_dot
from torch_cases import edge_docs, one_intra_op_thread  # noqa: F401  (one_intra_op_thread: autouse)

RTOL = ATOL = 1e-5
EXACT_ATOL = 2e-3
DIM = 2048
BLOCK_CODECS = ("dotvbyte", "streamvbyte", "bitpack")


@pytest.fixture(scope="module")
def docs():
    return edge_docs(DIM, np.random.default_rng(21), n_random=40, full=700)


def _queries(rng, nq):
    Q = np.zeros((nq, DIM), np.float32)
    for i in range(nq - 1):
        Q[i, rng.choice(DIM, size=43, replace=False)] = rng.gamma(2, .5, 43)
    Q[-1] = rng.random(DIM)
    return Q


def _streams(packed):
    keys = ("ctrl", "data") if packed.codec != "bitpack" else ("words", "widths")
    return {k: getattr(packed, k) for k in (*keys, "seg", "start_pos", "start_abs", "vals")}


@pytest.mark.parametrize("vf", ["f32", "f16", "fixedu8"])
@pytest.mark.parametrize("codec", BLOCK_CODECS)
def test_scan_scores_match_reference_and_exact(docs, codec, vf):
    """Batched and single scans over blocks of T = 128, where the
    700-entry doc spans six blocks."""
    ref_fwd = RefForwardIndex.from_docs(docs, DIM, value_format=vf)
    fwd = ForwardIndex.from_docs(docs, DIM, value_format=vf)
    kw = dict(codec=codec, block_size=128)
    ref, port = ref_layout.pack_blocks(ref_fwd, **kw), layout.pack_blocks(fwd, **kw).to("cpu")
    assert int(np.bincount(ref.doc_ids[ref.doc_ids >= 0]).max()) >= 3
    Q = _queries(np.random.default_rng(22), 4)
    exact = np.stack([ref_fwd.exact_scores(q) for q in Q])
    want_b = np.asarray(getattr(ref_ops, f"score_{codec}_batch")(Q, ref, mode="jnp"))
    want_1 = np.asarray(getattr(ref_ops, f"score_{codec}")(Q[1], ref, mode="jnp"))
    scale = float(port.value_format.scale)
    Qt = torch.from_numpy(Q)
    before = block_scan.launches
    got_b = block_scan.scan_scores(f"block_scan_{codec}_batch", codec, Qt, _streams(port),
                                   port.doc_ids, port.n_docs, scale=scale)
    got_1 = block_scan.scan_scores(f"block_scan_{codec}", codec, Qt[1:2], _streams(port),
                                   port.doc_ids, port.n_docs, scale=scale)
    assert block_scan.launches == before  # CPU tensors launch nothing
    assert got_b.shape == (4, port.n_docs) and got_1.shape == (1, port.n_docs)
    np.testing.assert_allclose(got_b.numpy(), want_b, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got_1[0].numpy(), want_1, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got_b.numpy(), exact, rtol=RTOL, atol=EXACT_ATOL)
    # the ops entries run the same thing
    single, batch = ops.block_scorers(codec)
    np.testing.assert_array_equal(batch(Q, port, device="cpu").numpy(), got_b.numpy())
    np.testing.assert_array_equal(single(Q[1], port, device="cpu").numpy(), got_1[0].numpy())


def test_scan_scores_drop_unknown_docs(docs):
    """Slot ids of -1 or past n_docs drop; the rest land as exact
    scores of their documents."""
    fwd = ForwardIndex.from_docs(docs, DIM, value_format="f16")
    port = layout.pack_blocks(fwd, codec="dotvbyte", block_size=128).to("cpu")
    Q = torch.from_numpy(_queries(np.random.default_rng(23), 3))
    ids = port.doc_ids.clone()
    gone = torch.unique(ids[ids >= 0])[::3]  # every third doc loses its slots
    drop = torch.isin(ids, gone)
    ids[drop] = torch.where(torch.arange(int(drop.sum())) % 2 == 0, -1, port.n_docs + 5
                            ).to(torch.int32)
    got = block_scan.scan_scores("block_scan_dotvbyte_batch", "dotvbyte", Q, _streams(port),
                                 ids, port.n_docs)
    exact = np.stack([fwd.exact_scores(q) for q in Q.numpy()])
    exact[:, gone.numpy()] = 0
    np.testing.assert_allclose(got.numpy(), exact, rtol=RTOL, atol=EXACT_ATOL)


def test_scan_scores_add_buckets_into_one_out(docs):
    """``score_bitpack_bucketed``'s accumulation: each width bucket adds
    into one result through ``out``, equal to the reference's bucketed
    scan and to exact scores."""
    ref_fwd = RefForwardIndex.from_docs(docs, DIM, value_format="f16")
    fwd = ForwardIndex.from_docs(docs, DIM, value_format="f16")
    ref = ref_layout.pack_blocks(ref_fwd, codec="bitpack", block_size=128)
    port = layout.pack_blocks(fwd, codec="bitpack", block_size=128).to("cpu")
    Q = _queries(np.random.default_rng(24), 2)
    buckets = ops.width_buckets(port)
    assert len(buckets) > 1
    out = None
    for w, sel, streams, ids in buckets:
        assert torch.equal(ids, port.doc_ids[sel])
        assert torch.equal(streams["vals"], port.vals[sel])
        res = block_scan.scan_scores("block_scan_bitpack_w", "bitpack", torch.from_numpy(Q[:1]),
                                     streams, ids, port.n_docs, width=w, out=out)
        assert out is None or res is out
        out = res
    with warnings.catch_warnings():  # the reference's "XLA lowering" notice
        warnings.simplefilter("ignore", RuntimeWarning)
        want = np.asarray(ref_ops.score_bitpack_bucketed(Q[0], ref, mode="pallas_compiled"))
    np.testing.assert_allclose(out[0].numpy(), want, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(out[0].numpy(), ref_fwd.exact_scores(Q[0]), rtol=RTOL,
                               atol=EXACT_ATOL)
    np.testing.assert_array_equal(ops.score_bitpack_bucketed(Q[0], port, device="cpu").numpy(),
                                  out[0].numpy())


def test_bucketed_scan_builds_its_buckets_once(docs, monkeypatch):
    """``score_bitpack_bucketed`` builds the width buckets on its first
    call and keeps them on the pack: a second call builds nothing, gives
    the identical result, and both equal the reference's bucketed scan
    (``mode="jnp"``); a pack moved with ``to`` starts without them."""
    ref_fwd = RefForwardIndex.from_docs(docs, DIM, value_format="f16")
    fwd = ForwardIndex.from_docs(docs, DIM, value_format="f16")
    ref = ref_layout.pack_blocks(ref_fwd, codec="bitpack", block_size=128)
    port = layout.pack_blocks(fwd, codec="bitpack", block_size=128).to("cpu")
    builds = []
    build_buckets = ops._build_buckets
    monkeypatch.setattr(ops, "_build_buckets", lambda p: builds.append(p) or build_buckets(p))
    Q = _queries(np.random.default_rng(25), 2)
    assert port.buckets is None
    first = ops.score_bitpack_bucketed(Q[0], port)
    held = port.buckets
    second = ops.score_bitpack_bucketed(Q[0], port)
    assert len(builds) == 1 and port.buckets is held and len(held) > 1
    np.testing.assert_array_equal(first.numpy(), second.numpy())
    want = np.asarray(ref_ops.score_bitpack_bucketed(Q[0], ref, mode="jnp"))
    np.testing.assert_allclose(first.numpy(), want, rtol=RTOL, atol=ATOL)
    assert sorted(b.width for b in held) == sorted(np.unique(ref.widths).tolist())
    assert port.to("cpu").buckets is None


def test_scan_scores_argument_checks(docs):
    fwd = ForwardIndex.from_docs(docs, DIM, value_format="f16")
    port = layout.pack_blocks(fwd, codec="dotvbyte", block_size=128).to("cpu")
    Q = torch.zeros((2, DIM))
    s, ids, n = _streams(port), port.doc_ids, port.n_docs
    entry = "block_scan_dotvbyte_batch"
    with pytest.raises(ValueError, match="doc_ids must be int32"):
        block_scan.scan_scores(entry, "dotvbyte", Q, s, ids.long(), n)
    with pytest.raises(ValueError, match="doc_ids must be int32"):
        block_scan.scan_scores(entry, "dotvbyte", Q, s, ids[:, :3], n)
    with pytest.raises(ValueError, match="n_docs must lie"):
        block_scan.scan_scores(entry, "dotvbyte", Q, s, ids, -1)
    with pytest.raises(ValueError, match="out must be"):
        block_scan.scan_scores(entry, "dotvbyte", Q, s, ids, n, out=torch.zeros((3, n)))
    with pytest.raises(ValueError, match="out must be"):
        block_scan.scan_scores(entry, "dotvbyte", Q, s, ids, n,
                               out=torch.zeros((2, n), dtype=torch.float64))
    with pytest.raises(ValueError, match="span devices"):
        block_scan.scan_scores(entry, "dotvbyte", Q, s, ids.to("meta"), n)
    with pytest.raises(ValueError, match="unknown block-scan entry"):
        block_scan.scan_scores("block_scan_rows", "dotvbyte", Q, s, ids, n)
    with pytest.raises(ValueError, match="static width"):
        block_scan.scan_scores(entry, "dotvbyte", Q, s, ids, n, width=4)
    meta = {k: v.to("meta") for k, v in s.items()}
    with pytest.raises(ValueError, match="cuda or cpu"):
        block_scan.scan_scores(entry, "dotvbyte", Q.to("meta"), meta, ids.to("meta"), n)


#: the smoke's full-scan shape: the SPLADE vocabulary, T = 512, D = 64
SHAPE = dict(dim=30522, block_size=512, slots=64)


def test_pick_stage_follows_the_thresholds():
    # one query at the smoke's shape: resident query; larger batches as before
    assert block_scan.pick_stage(1, **SHAPE) == "resident_query"
    assert block_scan.pick_stage(2, **SHAPE) == "entry_lanes"
    assert block_scan.pick_stage(block_scan.QUERY_LANES_MIN_NQ, **SHAPE) == "query_lanes"
    assert block_scan.pick_stage(block_scan.QUERY_LANES_MIN_NQ - 1, **SHAPE) == "entry_lanes"
    assert block_scan.pick_stage(1, "query_lanes", **SHAPE) == "query_lanes"
    assert block_scan.pick_stage(1, "entry_lanes", **SHAPE) == "entry_lanes"
    dim = SHAPE["dim"]
    flat, seismic = 100_001, 4096  # the smoke's candidate sets
    assert rows_dot.pick_stage(rows_dot.QUERY_LANES_MIN_NQ, 1, dim=dim, C=flat) == "query_lanes"
    assert rows_dot.pick_stage(rows_dot.QUERY_LANES_MIN_NQ - 1, 1, dim=dim,
                               C=flat) == "entry_lanes"
    # the per-query (Seismic) form takes row warps from ROW_WARPS_MIN_ROWS rows in all
    assert rows_dot.pick_stage(64, 64, dim=dim, C=seismic) == "row_warps"
    assert rows_dot.pick_stage(2, 2, dim=dim, C=rows_dot.ROW_WARPS_MIN_ROWS // 2) == "row_warps"
    assert rows_dot.pick_stage(2, 2, dim=dim, C=seismic) == "entry_lanes"
    with pytest.raises(ValueError, match="shared candidate set"):
        rows_dot.pick_stage(64, 64, "query_lanes", dim=dim, C=seismic)
    for pick in (lambda s: block_scan.pick_stage(8, s, **SHAPE),
                 lambda s: rows_dot.pick_stage(8, 1, s, dim=dim, C=flat)):
        with pytest.raises(ValueError, match="unknown scoring stage"):
            pick("warp_lanes")


@pytest.mark.parametrize("dim,T,D,fits", [
    (30522, 512, 64, True),      # the smoke's pack: the query is 119 KB
    (30522, 8192, 64, True),     # the largest block still leaves room for a warp
    (30522, 8192, 8192, True),
    (57000, 512, 64, True),      # 223 KB of query beside one warp's 2.3 KB
    (58000, 512, 64, False),     # no room for a warp's scratch
    (1 << 20, 128, 4, False),    # far past shared memory
])
def test_block_scan_resident_stage_is_a_shape_rule(dim, T, D, fits):
    """The resident-query stage takes one query whose dense form fits in
    shared memory beside one warp's scratch; otherwise the single-query
    scan keeps entry lanes, and asking for the resident stage raises."""
    shape = dict(dim=dim, block_size=T, slots=D)
    assert block_scan.resident_fits(dim, T, D) is fits
    assert block_scan.pick_stage(1, **shape) == ("resident_query" if fits else "entry_lanes")
    assert block_scan.pick_stage(2, **shape) == "entry_lanes"
    if fits:
        assert block_scan.pick_stage(1, "resident_query", **shape) == "resident_query"
    else:
        with pytest.raises(ValueError, match="resident-query stage"):
            block_scan.pick_stage(1, "resident_query", **shape)
    with pytest.raises(ValueError, match="resident-query stage"):
        block_scan.pick_stage(3, "resident_query", **shape)


@pytest.mark.parametrize("nq,dim,stage", [
    (1, 30522, "resident_query"), (3, 30522, "entry_lanes"), (9, 30522, "query_lanes"),
    (1, 60000, "entry_lanes"),
])
def test_fused_stage_choice_on_cuda_tensors(docs, nq, dim, stage, monkeypatch):
    """``scan_scores`` on (fake) CUDA tensors launches the stage
    :func:`block_scan.pick_stage` gives for the inputs' shapes; a query
    too wide for shared memory stays on entry lanes."""
    fwd = ForwardIndex.from_docs(docs, DIM, value_format="f16")
    packed = layout.pack_blocks(fwd, codec="dotvbyte", block_size=128).to("cpu")
    fake = {k: v.as_subclass(_FakeCuda) for k, v in _streams(packed).items()}
    seen = []

    def launch(entry, codec, Q, streams, p0, p1, scale, width, stage, **kw):
        seen.append(stage)

    monkeypatch.setattr(block_scan, "_launch", launch)
    block_scan.scan_scores("block_scan_dotvbyte_batch", "dotvbyte",
                           torch.zeros((nq, dim)).as_subclass(_FakeCuda), fake,
                           packed.doc_ids.as_subclass(_FakeCuda), packed.n_docs)
    assert seen == [stage]


class _FakeCuda(torch.Tensor):
    """A CPU tensor that reports a CUDA device: how a test on a machine
    without a GPU reaches the wrapper's CUDA branch."""

    @property
    def device(self):
        return torch.device("cuda", 0)


@pytest.mark.parametrize("entry", sorted(block_scan.ENTRIES))
def test_fused_cuda_tensors_launch_or_raise(docs, entry, monkeypatch):
    """On (fake) CUDA tensors the fused entry goes to its kernel — which
    needs a GPU here — and never to the plain version or the scatter."""
    codec = entry.split("_")[2]
    fwd = ForwardIndex.from_docs(docs, DIM, value_format="f16")
    packed = layout.pack_blocks(fwd, codec=codec, block_size=128).to("cpu")
    fake = {k: v.as_subclass(_FakeCuda) for k, v in _streams(packed).items()}
    width = 0
    if entry.endswith("_w"):
        del fake["widths"]
        width = 3
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(build, "_LIBS", {})
    monkeypatch.setattr(block_scan, "scan_scores_plain", None)  # never reached
    monkeypatch.setattr(block_scan, "block_scores_plain", None)
    Q = torch.zeros((1 if "batch" not in entry else 5, DIM)).as_subclass(_FakeCuda)
    before = dict(block_scan.fused_launches)
    with pytest.raises(RuntimeError, match="needs a CUDA GPU"):
        block_scan.scan_scores(entry, codec, Q, fake, packed.doc_ids.as_subclass(_FakeCuda),
                               packed.n_docs, width=width)
    assert block_scan.fused_launches == before
