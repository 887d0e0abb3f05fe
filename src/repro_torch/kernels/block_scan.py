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
decoded once and scored for every query. The output is the TPU kernels'
contract, per-slot scores f32 ``[B, D]`` / ``[nq, B, D]``; the scatter
to documents (``scoring.scatter_block_scores``) stays outside, as in the
reference.

Each entry runs the kernel on CUDA tensors and its plain torch version
(:func:`block_scores_plain`, the tile program ``tiles.py::tile_scores``
in torch) on CPU tensors; a CUDA call that cannot build or launch the
kernel raises. Values ride in their storage dtype (f32, f16 or u8) and
``seg`` as i32 or i8. ``launches`` counts kernel launches in total and
``variant_launches`` per entry (:data:`ENTRIES`).
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
)
from . import build

__all__ = [
    "CODECS",
    "ENTRIES",
    "MAX_BLOCK_SIZE",
    "launches",
    "variant_launches",
    "reset_launches",
    "tile_scores",
    "tile_scores_batch",
    "block_scores",
    "block_scores_plain",
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

#: kernel launches made by the entries (CUDA tensors only)
launches = 0
#: the same, per entry
variant_launches = {name: 0 for name in ENTRIES}

#: value and seg storage in the kernel's enum order (``Vals``, ``Seg``)
VALUE_DTYPES = (torch.float32, torch.float16, torch.uint8)
SEG_DTYPES = (torch.int32, torch.int8)

#: block_scan(code, vals_t, seg_t, 8 pointers, nq, dim, B, T, D, p0_w,
#: p1_w, scale, stream)
_ARGTYPES = (
    [ctypes.c_int] * 3 + [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7
    + [ctypes.c_float, ctypes.c_void_p]
)


def reset_launches() -> None:
    """Set every launch count to 0."""
    global launches
    launches = 0
    for k in variant_launches:
        variant_launches[k] = 0


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


def block_scores(entry: str, codec: str, Q, streams, *, scale: float = 1.0, width: int = 0):
    """Slot scores f32 ``[nq, B, D]`` of queries ``Q`` (f32 ``[nq, V]``)
    over the blocks' ``streams`` (``ctrl``/``data`` or ``words`` and,
    without a static ``width``, ``widths``; ``seg``, ``start_pos``,
    ``start_abs``, ``vals``). On CUDA tensors it launches the kernel and
    counts the launch under ``entry``; on CPU tensors it runs the plain
    version."""
    if entry not in ENTRIES:
        raise ValueError(f"unknown block-scan entry {entry!r}; have {list(ENTRIES)}")
    if codec not in CODECS:
        raise ValueError(f"no block-scan kernel for codec {codec!r}; have {list(CODECS)}")
    if not 0 <= width <= 32 or (width and codec != "bitpack"):
        raise ValueError(f"a static width must be 1..32 and bitpack's, got {width} ({codec})")
    devices = {t.device for t in [Q, *streams.values()]}
    if len(devices) != 1:
        raise ValueError(f"block_scan inputs span devices {sorted(map(str, devices))}")
    if Q.device.type == "cpu":
        return block_scores_plain(codec, Q, streams, scale=scale, width=width)
    if Q.device.type != "cuda":
        raise ValueError(f"block_scan runs on cuda or cpu tensors, got {Q.device}")
    p0, p1 = _check(codec, Q, streams, width)
    return _launch(entry, codec, Q, streams, p0, p1, float(scale), width)


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


def _launch(entry, codec, Q, streams, p0, p1, scale, width):
    global launches
    nq, dim = Q.shape
    B, T = streams["seg"].shape
    D = streams["start_pos"].shape[1]
    code = CODECS.index(codec) + width
    lib = build.load("block_scan", code % build.PARTS.get("block_scan", 1))
    out = torch.empty((nq, B, D), dtype=torch.float32, device=Q.device)
    if nq == 0 or B == 0:
        return out
    fn = lib.block_scan
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    vals, seg = streams["vals"], streams["seg"]
    with torch.cuda.device(Q.device):
        stream = torch.cuda.current_stream(Q.device).cuda_stream
        rc = fn(
            code, VALUE_DTYPES.index(vals.dtype), SEG_DTYPES.index(seg.dtype),
            Q.data_ptr(), p0.data_ptr(), None if p1 is None else p1.data_ptr(),
            seg.data_ptr(), streams["start_pos"].data_ptr(), streams["start_abs"].data_ptr(),
            vals.data_ptr(), out.data_ptr(),
            nq, dim, B, T, D, p0.shape[1], 0 if p1 is None or p1.dim() < 2 else p1.shape[1],
            scale, stream,
        )
    if rc != 0:
        err = lib.block_scan_error_string
        err.argtypes, err.restype = [ctypes.c_int], ctypes.c_char_p
        raise RuntimeError(
            f"block_scan kernel launch failed ({entry}, width {width}): CUDA error {rc} "
            f"({err(rc).decode()})"
        )
    launches += 1
    variant_launches[entry] += 1
    return out


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
