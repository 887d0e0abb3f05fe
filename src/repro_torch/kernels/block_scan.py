"""The block-scan kernel: the full scan's decode + rebase + gather +
multiply + per-slot reduction over every packed block, hand-written in
CUDA C++ for Hopper (``csrc/block_scan.cu``).

Replaces the reference's two remaining Pallas TPU kernels with the codec
tile functions that plug into them:

* ``repro/kernels/tiles.py::dma_block_scan`` (``pl.pallas_call`` at
  ``tiles.py:187``), the single-query scan behind
  ``{dotvbyte,streamvbyte,bitpack}_block_scores`` and the static-width
  ``bitpack_block_scores_w``;
* ``repro/kernels/tiles.py::grid_batch_scores`` (``tiles.py:225``), the
  queries × tiles grid behind ``*_block_scores_batch``.

Both become one CUDA template: the single-query entries launch it with
``nq = 1``, the batched ones with the whole batch, and each block is
decoded once per tile of 128 queries. Two output modes:

* slot scores (:func:`block_scores`), the TPU kernels' contract: f32
  ``[B, D]`` / ``[nq, B, D]``, behind the seven reference entries below;
* scores of documents (:func:`scan_scores`), the full scan's path
  (``ops.score_*``): the kernel adds each used slot's score into a
  doc-major ``[n_docs, nq]`` accumulator with atomics, so no ``[nq, B,
  D]`` intermediate and no ``index_add_`` exist. The reference scatters
  outside Pallas; the fusion is the port's own.

Three scoring stages (the source has the design), picked by
:func:`pick_stage` from the shapes: for one query whose dense form fits
in shared memory beside the warps' scratch (:func:`resident_fits`), the
resident-query stage (a persistent grid, the query staged once per
thread block, a warp per packed block); from :data:`QUERY_LANES_MIN_NQ`
queries on, lanes across queries over the transposed batch ``Qᵀ [dim,
nq]``; otherwise lanes across entries with a block scan per query.

Each entry runs the kernel on CUDA tensors and its plain torch version
(:func:`block_scores_plain`, the tile program ``tiles.py::tile_scores``
in torch, and the scatter after it) on CPU tensors; a CUDA call that
cannot build or launch the kernel raises. Values ride in their storage
dtype (f32, f16 or u8) and ``seg`` as i32 or i8. ``launches`` counts
kernel launches in total, ``variant_launches`` per entry
(:data:`ENTRIES`), ``fused_launches`` the scatter-mode ones per entry
and ``stage_launches`` per scoring stage.
"""

from __future__ import annotations

import ctypes

import torch

from ..core.scoring import (
    _CHUNK_ELEMS,
    _gather_query,
    _take_rows,
    block_slot_scores,
    block_values,
    components_from_gaps,
    decode_block_gaps,
    scatter_block_scores,
)
from ..spans import span
from . import build

__all__ = [
    "CODECS",
    "ENTRIES",
    "MAX_BLOCK_SIZE",
    "QUERY_LANES_MIN_NQ",
    "STAGES",
    "launches",
    "variant_launches",
    "fused_launches",
    "stage_launches",
    "reset_launches",
    "pick_stage",
    "resident_fits",
    "tile_scores",
    "tile_scores_batch",
    "block_scores",
    "block_scores_plain",
    "scan_scores",
    "scan_scores_plain",
    "dotvbyte_block_scores",
    "dotvbyte_block_scores_batch",
    "streamvbyte_block_scores",
    "streamvbyte_block_scores_batch",
    "bitpack_block_scores",
    "bitpack_block_scores_batch",
    "bitpack_block_scores_w",
]

#: block codecs in the kernel's code order (csrc/block_scan.cu); code
#: 2 + W is bitpack at the static width W
CODECS = ("dotvbyte", "streamvbyte", "bitpack")

#: one thread per 8 entries, at most 1024 threads a block
MAX_BLOCK_SIZE = 8 * 1024

#: entry name → the reference's pl.pallas_call it replaces
ENTRIES = {
    "block_scan_dotvbyte": "src/repro/kernels/tiles.py:187",
    "block_scan_dotvbyte_batch": "src/repro/kernels/tiles.py:225",
    "block_scan_streamvbyte": "src/repro/kernels/tiles.py:187",
    "block_scan_streamvbyte_batch": "src/repro/kernels/tiles.py:225",
    "block_scan_bitpack": "src/repro/kernels/tiles.py:187",
    "block_scan_bitpack_batch": "src/repro/kernels/tiles.py:225",
    "block_scan_bitpack_w": "src/repro/kernels/tiles.py:187",
}

#: scoring stages in the kernel's enum order (csrc/block_scan.cu ``Stage``)
STAGES = ("entry_lanes", "query_lanes", "resident_query")

#: the batch size from which the kernel scores with lanes across queries
#: (over ``Qᵀ``) rather than lanes across entries with a block scan per
#: query; from the stage sweep of ``chip_smoke.py`` (PERF.md): on an
#: H100 entry lanes win up to 4 queries, query lanes from 8 on
QUERY_LANES_MIN_NQ = 8

#: kernel launches made by the entries (CUDA tensors only)
launches = 0
#: the same, per entry (both output modes)
variant_launches = {name: 0 for name in ENTRIES}
#: the scatter-mode launches among them, per entry
fused_launches = {name: 0 for name in ENTRIES}
#: launches per scoring stage
stage_launches = {name: 0 for name in STAGES}

#: value and seg storage in the kernel's enum order (``Vals``, ``Seg``)
VALUE_DTYPES = (torch.float32, torch.float16, torch.uint8)
SEG_DTYPES = (torch.int32, torch.int8)

#: block_scan(code, vals_t, seg_t, stage, mode, 9 pointers, nq, dim, B,
#: T, D, p0_w, p1_w, n_docs, scale, stream)
_ARGTYPES = (
    [ctypes.c_int] * 5 + [ctypes.c_void_p] * 9 + [ctypes.c_int] * 8
    + [ctypes.c_float, ctypes.c_void_p]
)


def reset_launches() -> None:
    """Set every launch count to 0."""
    global launches
    launches = 0
    for counts in (variant_launches, fused_launches, stage_launches):
        for k in counts:
            counts[k] = 0


def resident_fits(dim: int, block_size: int, slots: int) -> bool:
    """Whether the resident-query stage takes a query of ``dim`` floats
    over blocks of ``block_size`` entries and ``slots`` slots: the query
    and one warp's scratch (``block_size + 1 + slots`` words), each
    rounded up to 16 bytes, within ``build.SMEM_OPTIN_BYTES``. At the
    SPLADE vocabulary (30,522) that leaves room for 32 warps at T = 512
    and 3 at T = 8192."""
    words = lambda n: (n + 3) // 4 * 4  # noqa: E731
    return 4 * (words(dim) + words(block_size + 1 + slots)) <= build.SMEM_OPTIN_BYTES


def pick_stage(nq: int, stage: str | None = None, *, dim: int, block_size: int,
               slots: int) -> str:
    """The scoring stage for ``nq`` queries of ``dim`` components over
    blocks of ``block_size`` entries and ``slots`` slots. Without a
    ``stage``: resident query for one query where
    :func:`resident_fits`, query lanes from :data:`QUERY_LANES_MIN_NQ`
    queries on, entry lanes otherwise. A given ``stage`` is checked
    against the same shape rules."""
    fits = nq == 1 and resident_fits(dim, block_size, slots)
    if stage is None:
        if fits:
            return "resident_query"
        return "query_lanes" if nq >= QUERY_LANES_MIN_NQ else "entry_lanes"
    if stage not in STAGES:
        raise ValueError(f"unknown scoring stage {stage!r}; have {list(STAGES)}")
    if stage == "resident_query" and not fits:
        raise ValueError(
            f"the resident-query stage takes one query whose {dim} floats fit in shared "
            f"memory beside a warp's scratch (T = {block_size}, D = {slots}); got nq = {nq}")
    return stage


# -- the plain tile program ----------------------------------------------------


#: the tile program's dequant stage (``tiles.py::_tile_values``)
_tile_values = block_values


def tile_scores(q, gaps, seg, sp, sa, vals, scale: float, vq="f16", vq_lo=None,
                vq_scale=None, vq_cb=None) -> torch.Tensor:
    """One tile, one query q [V]: [R, T] streams → [R, D] slot scores."""
    return tile_scores_batch(q.unsqueeze(0), gaps, seg, sp, sa, vals, scale, vq, vq_lo,
                             vq_scale, vq_cb)[0]


def tile_scores_batch(Q, gaps, seg, sp, sa, vals, scale: float, vq="f16", vq_lo=None,
                      vq_scale=None, vq_cb=None) -> torch.Tensor:
    """One tile, a query batch Q [nq, V]: decode once, score [nq, R, D]."""
    comps = components_from_gaps(gaps, seg, sp, sa)
    w = _tile_values(vals, scale, vq, vq_lo, vq_scale, vq_cb) * (seg >= 0)
    return block_slot_scores(_gather_query(Q, comps) * w, sp)


def _block_gaps(codec: str, streams, blocks: slice, T: int, width: int) -> torch.Tensor:
    """Gaps [b, T] of ``blocks``; a static ``width`` stands in for the
    per-block widths."""
    if codec == "bitpack":
        words = _take_rows(streams["words"], blocks)
        widths = (streams["widths"][blocks] if not width else
                  torch.full((words.shape[0],), width, dtype=torch.int32, device=words.device))
        return decode_block_gaps("bitpack", {"words": words, "widths": widths}, T)
    return decode_block_gaps(codec, {k: streams[k][blocks] for k in ("ctrl", "data")}, T)


def block_scores_plain(codec: str, Q, streams, *, scale: float = 1.0, width: int = 0):
    """The kernel's plain torch version: f32 [nq, B, D] slot scores of
    ``Q [nq, V]`` over the blocks' streams, in chunks of blocks that
    bound the working set (any device)."""
    B, T = streams["seg"].shape
    D = streams["start_pos"].shape[1]
    nq = Q.shape[0]
    out = torch.empty((nq, B, D), dtype=torch.float32, device=Q.device)
    step = max(1, _CHUNK_ELEMS // max(nq * T, 1))
    for b0 in range(0, B, step):
        blocks = slice(b0, b0 + step)
        gaps = _block_gaps(codec, streams, blocks, T, width)
        out[:, blocks] = tile_scores_batch(
            Q, gaps, streams["seg"][blocks], streams["start_pos"][blocks],
            streams["start_abs"][blocks], streams["vals"][blocks], scale)
    return out


# -- the kernel ------------------------------------------------------------------


def block_scores(entry: str, codec: str, Q, streams, *, scale: float = 1.0, width: int = 0,
                 stage: str | None = None):
    """Slot scores f32 ``[nq, B, D]`` of queries ``Q`` (f32 ``[nq, V]``)
    over the blocks' ``streams`` (``ctrl``/``data`` or ``words`` and,
    without a static ``width``, ``widths``; ``seg``, ``start_pos``,
    ``start_abs``, ``vals``). On CUDA tensors it launches the kernel in
    the scoring ``stage`` (default: :func:`pick_stage`) and counts the
    launch under ``entry``; on CPU tensors it runs the plain version."""
    if _route(entry, codec, width, [Q, *streams.values()]) == "cpu":
        return block_scores_plain(codec, Q, streams, scale=scale, width=width)
    p0, p1 = _check(codec, Q, streams, width)
    return _launch(entry, codec, Q, streams, p0, p1, float(scale), width,
                   _stage(Q, streams, stage))


def scan_scores_plain(codec: str, Q, streams, doc_ids, n_docs: int, *, scale: float = 1.0,
                      width: int = 0):
    """The fused entry's plain version: the slot scores of
    :func:`block_scores_plain` scattered to documents → f32 ``[nq,
    n_docs]`` (any device)."""
    return scatter_block_scores(block_scores_plain(codec, Q, streams, scale=scale, width=width),
                                doc_ids, n_docs)


def scan_scores(entry: str, codec: str, Q, streams, doc_ids, n_docs: int, *,
                scale: float = 1.0, width: int = 0, out=None, stage: str | None = None):
    """Every document's score f32 ``[nq, n_docs]``: the slot scores of
    :func:`block_scores` added to the documents ``doc_ids`` (i32 ``[B,
    D]``; an id outside ``[0, n_docs)`` drops). On CUDA tensors the
    kernel adds each used slot's score into a doc-major accumulator with
    atomics (the scatter mode: no slot scores are stored) and the result
    is that accumulator transposed, a view; on CPU tensors it runs
    :func:`scan_scores_plain`. ``out``, an earlier result of this
    function on the same device (f32 ``[nq, n_docs]``), is added into
    and returned; the sum of fragments of one document runs
    in no fixed order on the card."""
    with span("repro_torch.scan.check"):
        device = _route(entry, codec, width, [Q, *streams.values(), doc_ids]
                        + ([] if out is None else [out]))
        nq = Q.shape[0] if Q.dim() == 2 else -1
        B, D = streams["start_pos"].shape if streams["start_pos"].dim() == 2 else (-1, -1)
        if doc_ids.dtype != torch.int32 or tuple(doc_ids.shape) != (B, D):
            raise ValueError(f"doc_ids must be int32 [B, D] = [{B}, {D}] like start_pos, got "
                             f"{doc_ids.dtype} {list(doc_ids.shape)}")
        if not 0 <= n_docs < 2**31:
            raise ValueError(f"n_docs must lie in [0, 2**31), got {n_docs}")
        if out is not None and (out.dtype != torch.float32 or tuple(out.shape) != (nq, n_docs)
                                or (device == "cuda" and not out.t().is_contiguous())):
            raise ValueError(f"out must be an f32 [{nq}, {n_docs}] scan_scores result (on the "
                             f"card its transpose contiguous), got {out.dtype} "
                             f"{list(out.shape)}")
        if device == "cuda":
            p0, p1 = _check(codec, Q, streams, width)
            if not doc_ids.is_contiguous():
                raise ValueError("doc_ids must be contiguous")
            stage = _stage(Q, streams, stage)
    if device == "cpu":
        got = scan_scores_plain(codec, Q, streams, doc_ids, n_docs, scale=scale, width=width)
        if out is None:
            return got
        out += got
        return out
    return _launch(entry, codec, Q, streams, p0, p1, float(scale), width, stage,
                   doc_ids=doc_ids, n_docs=n_docs, out=out)


def _stage(Q, streams, stage):
    """:func:`pick_stage` at the shapes of checked inputs."""
    return pick_stage(Q.shape[0], stage, dim=Q.shape[1], block_size=streams["seg"].shape[1],
                      slots=streams["start_pos"].shape[1])


def _route(entry, codec, width, tensors) -> str:
    """Check the entry's name, codec and width and that every tensor lies
    on one device → ``"cpu"`` or ``"cuda"``."""
    if entry not in ENTRIES:
        raise ValueError(f"unknown block-scan entry {entry!r}; have {list(ENTRIES)}")
    if codec not in CODECS:
        raise ValueError(f"no block-scan kernel for codec {codec!r}; have {list(CODECS)}")
    if not 0 <= width <= 32 or (width and codec != "bitpack"):
        raise ValueError(f"a static width must be 1..32 and bitpack's, got {width} ({codec})")
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"block_scan inputs span devices {sorted(map(str, devices))}")
    device = devices.pop().type
    if device not in ("cpu", "cuda"):
        raise ValueError(f"block_scan runs on cuda or cpu tensors, got {device}")
    return device


def _check(codec, Q, streams, width):
    """Validate dtypes, shapes and contiguity → the codec streams
    (p0, p1; p1 None under a static width)."""
    seg, vals = streams["seg"], streams["vals"]
    if seg.dim() != 2:
        raise ValueError(f"seg must be 2-D [B, T], got {seg.dim()}-D")
    B, T = seg.shape
    if codec == "bitpack":
        names = ("words",) if width else ("words", "widths")
        dtypes = (torch.uint32, torch.int32)
    else:
        names, dtypes = ("ctrl", "data"), (torch.uint8, torch.uint8)
    want = {"Q": (Q, (torch.float32,), 2), "seg": (seg, SEG_DTYPES, 2),
            "start_pos": (streams["start_pos"], (torch.int32,), 2),
            "start_abs": (streams["start_abs"], (torch.int32,), 2),
            "vals": (vals, VALUE_DTYPES, 2)}
    for k, dt in zip(names, dtypes):
        want[k] = (streams[k], (dt,), 1 if k == "widths" else 2)
    for name, (t, dts, ndim) in want.items():
        if t.dtype not in dts or t.dim() != ndim:
            raise ValueError(f"{name} must be {ndim}-D {' or '.join(map(str, dts))}, "
                             f"got {t.dim()}-D {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    D = streams["start_pos"].shape[1]
    if T % 128 or not 0 < T <= MAX_BLOCK_SIZE:
        raise ValueError(f"block size {T} must be a positive multiple of 128, "
                         f"at most {MAX_BLOCK_SIZE}")
    if D == 0 or Q.shape[1] == 0:
        raise ValueError("start_pos and Q must not be empty")
    payload = [streams[k] for k in names]
    if (vals.shape != seg.shape or streams["start_abs"].shape != streams["start_pos"].shape
            or any(t.shape[0] != B for t in [streams["start_pos"], *payload])):
        raise ValueError("block streams disagree on their shapes")
    per = {"dotvbyte": 8, "streamvbyte": 4}.get(codec)
    if per and payload[0].shape[1] < T // per:
        raise ValueError(f"ctrl is {payload[0].shape[1]} wide; need ≥ {T // per}")
    if max(*Q.shape, B, D, *(t.shape[-1] for t in payload)) >= 2**31:
        raise ValueError("a dimension exceeds the kernel's 32-bit sizes")
    return payload[0], (payload[1] if len(payload) > 1 else None)


def _launch(entry, codec, Q, streams, p0, p1, scale, width, stage, doc_ids=None, n_docs=0,
            out=None):
    """Launch in the slot mode, or in the scatter mode where ``doc_ids``
    is given; the library is loaded before anything is allocated on the
    card."""
    global launches
    nq, dim = Q.shape
    B, T = streams["seg"].shape
    D = streams["start_pos"].shape[1]
    code = CODECS.index(codec) + width
    lib = build.load("block_scan", code % build.PARTS.get("block_scan", 1))
    fused = doc_ids is not None
    with span("repro_torch.scan.alloc"):
        if fused:
            acc = (out.t() if out is not None else
                   torch.zeros((n_docs, nq), dtype=torch.float32, device=Q.device))
            result = acc.t()
        else:
            acc = result = torch.empty((nq, B, D), dtype=torch.float32, device=Q.device)
        if nq == 0 or B == 0 or (fused and n_docs == 0):
            return result
        q_arg = Q.t().contiguous() if stage == "query_lanes" else Q
    with span("repro_torch.scan.launch"):
        fn = lib.block_scan
        fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
        vals, seg = streams["vals"], streams["seg"]
        with torch.cuda.device(Q.device):
            stream = torch.cuda.current_stream(Q.device).cuda_stream
            rc = fn(
                code, VALUE_DTYPES.index(vals.dtype), SEG_DTYPES.index(seg.dtype),
                STAGES.index(stage), int(fused),
                q_arg.data_ptr(), p0.data_ptr(), None if p1 is None else p1.data_ptr(),
                seg.data_ptr(), streams["start_pos"].data_ptr(), streams["start_abs"].data_ptr(),
                vals.data_ptr(), doc_ids.data_ptr() if fused else None, acc.data_ptr(),
                nq, dim, B, T, D, p0.shape[1], 0 if p1 is None or p1.dim() < 2 else p1.shape[1],
                n_docs, scale, stream,
            )
    if rc != 0:
        err = lib.block_scan_error_string
        err.argtypes, err.restype = [ctypes.c_int], ctypes.c_char_p
        raise RuntimeError(
            f"block_scan kernel launch failed ({entry}, width {width}, {stage}, "
            f"{'scatter' if fused else 'slot'} mode): CUDA error {rc} ({err(rc).decode()})"
        )
    launches += 1
    variant_launches[entry] += 1
    fused_launches[entry] += fused
    stage_launches[stage] += 1
    return result


# -- the reference's entries -----------------------------------------------------


def _streams(seg, start_pos, start_abs, vals, **codec_streams):
    return {**codec_streams, "seg": seg, "start_pos": start_pos, "start_abs": start_abs,
            "vals": vals}


def dotvbyte_block_scores(q, ctrl, data, seg, start_pos, start_abs, vals, *, scale=1.0):
    """Per-block slot scores f32 [B, D] of one query q [V]."""
    return block_scores("block_scan_dotvbyte", "dotvbyte", q.unsqueeze(0),
                        _streams(seg, start_pos, start_abs, vals, ctrl=ctrl, data=data),
                        scale=scale)[0]


def dotvbyte_block_scores_batch(Q, ctrl, data, seg, start_pos, start_abs, vals, *, scale=1.0):
    """Slot scores f32 [nq, B, D] of a query batch Q [nq, V]."""
    return block_scores("block_scan_dotvbyte_batch", "dotvbyte", Q,
                        _streams(seg, start_pos, start_abs, vals, ctrl=ctrl, data=data),
                        scale=scale)


def streamvbyte_block_scores(q, ctrl, data, seg, start_pos, start_abs, vals, *, scale=1.0):
    """Per-block slot scores f32 [B, D] of one query q [V]."""
    return block_scores("block_scan_streamvbyte", "streamvbyte", q.unsqueeze(0),
                        _streams(seg, start_pos, start_abs, vals, ctrl=ctrl, data=data),
                        scale=scale)[0]


def streamvbyte_block_scores_batch(Q, ctrl, data, seg, start_pos, start_abs, vals, *,
                                   scale=1.0):
    """Slot scores f32 [nq, B, D] of a query batch Q [nq, V]."""
    return block_scores("block_scan_streamvbyte_batch", "streamvbyte", Q,
                        _streams(seg, start_pos, start_abs, vals, ctrl=ctrl, data=data),
                        scale=scale)


def bitpack_block_scores(q, words, widths, seg, start_pos, start_abs, vals, *, scale=1.0):
    """Per-block slot scores f32 [B, D] of one query, each block at its
    own width (widths i32 [B])."""
    return block_scores("block_scan_bitpack", "bitpack", q.unsqueeze(0),
                        _streams(seg, start_pos, start_abs, vals, words=words, widths=widths),
                        scale=scale)[0]


def bitpack_block_scores_batch(Q, words, widths, seg, start_pos, start_abs, vals, *, scale=1.0):
    """Slot scores f32 [nq, B, D] of a query batch, per-block widths."""
    return block_scores("block_scan_bitpack_batch", "bitpack", Q,
                        _streams(seg, start_pos, start_abs, vals, words=words, widths=widths),
                        scale=scale)


def bitpack_block_scores_w(q, words, seg, start_pos, start_abs, vals, *, width: int, scale=1.0):
    """Per-block slot scores f32 [B, D] of one query over blocks that all
    share the static ``width`` (1..32), words sliced tight to
    ⌈T·width/32⌉ (lane-padded) by the caller."""
    if not 1 <= width <= 32:
        raise ValueError(f"static width must be 1..32, got {width}")
    return block_scores("block_scan_bitpack_w", "bitpack", q.unsqueeze(0),
                        _streams(seg, start_pos, start_abs, vals, words=words),
                        scale=scale, width=width)[0]
