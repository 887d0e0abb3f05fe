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
from torch_cases import edge_docs

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
    for w, sel, words in buckets:
        streams = {"words": words, **{k: getattr(port, k)[sel]
                                      for k in ("seg", "start_pos", "start_abs", "vals")}}
        res = block_scan.scan_scores("block_scan_bitpack_w", "bitpack", torch.from_numpy(Q[:1]),
                                     streams, port.doc_ids[sel], port.n_docs, width=w, out=out)
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


def test_pick_stage_follows_the_thresholds():
    assert block_scan.pick_stage(1) == "entry_lanes"
    assert block_scan.pick_stage(block_scan.QUERY_LANES_MIN_NQ) == "query_lanes"
    assert block_scan.pick_stage(block_scan.QUERY_LANES_MIN_NQ - 1) == "entry_lanes"
    assert block_scan.pick_stage(1, "query_lanes") == "query_lanes"
    assert rows_dot.pick_stage(rows_dot.QUERY_LANES_MIN_NQ, 1) == "query_lanes"
    assert rows_dot.pick_stage(rows_dot.QUERY_LANES_MIN_NQ - 1, 1) == "entry_lanes"
    # the per-query (Seismic) form keeps entry lanes at every batch size
    assert rows_dot.pick_stage(64, 64) == "entry_lanes"
    with pytest.raises(ValueError, match="shared candidate set"):
        rows_dot.pick_stage(64, 64, "query_lanes")
    for pick in (lambda s: block_scan.pick_stage(8, s), lambda s: rows_dot.pick_stage(8, 1, s)):
        with pytest.raises(ValueError, match="unknown scoring stage"):
            pick("warp_lanes")


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
