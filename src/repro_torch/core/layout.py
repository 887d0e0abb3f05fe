"""Codec-pluggable packed row layout — the one place a gap stream
becomes device arrays (a copy of the row half of
``repro/core/layout.py``; every packed array is byte-identical to the
reference's).

The row form ``[N+1, L]`` holds one fixed-capacity row per document for
the serve engines' candidate rescoring (``pack_rows`` →
``PackedRows``); the ``+1`` row is the all-zero sentinel that
out-of-corpus candidate ids gather. Row gaps carry the absolute first
component (per-document alignment), so a plain cumsum rebuilds the ids.
Four layouts are registered: ``uncompressed`` (absolute components,
decode-free), ``dotvbyte``, ``streamvbyte`` and ``bitpack``; each packs
under every value codec (``core/values.py``).

Streams are lane-aligned at pack time, as the reference lays them out
for the TPU: ``l_max`` rounds up to ``LANE_MULTIPLE`` (=128, times the
value codec's pack factor) and the ctrl/data/words streams pad their
trailing dim to a multiple of 128. Decoders therefore slice the control
stream tight (``L // 8`` bytes for DotVByte, ``L // 4`` for
StreamVByte) before decoding. The block form (``pack_blocks``) serves
only the full-scan path and is not ported yet (ROADMAP queue A8).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Mapping

import numpy as np

from . import values as value_codecs
from .codecs.bitpack import bit_widths, pack_block
from .codecs.dotvbyte import control_bits
from .codecs.streamvbyte import byte_codes
from .forward_index import ForwardIndex, ValueFormat

__all__ = [
    "LayoutCodec",
    "register_layout",
    "get_layout",
    "available_layouts",
    "PackedRows",
    "pack_rows",
    "LANE_MULTIPLE",
]

_LANES = 128  # the reference's TPU lane count; kept so packs stay byte-equal

#: public name for the pack-time stream alignment
LANE_MULTIPLE = _LANES


def _round_up(n: int, m: int) -> int:
    return (n + m - 1) // m * m


def _lane_pad(arr: np.ndarray) -> np.ndarray:
    """Pad a stream's trailing dim to the lane multiple."""
    pad = (-arr.shape[-1]) % _LANES
    if pad == 0:
        return arr
    widths = [(0, 0)] * (arr.ndim - 1) + [(0, pad)]
    return np.pad(arr, widths)


class LayoutCodec:
    """Gap-matrix ⇄ device-stream transform for one codec.

    ``encode`` consumes a padded u32 gap matrix ``[R, T]`` (zeros past
    each row's payload) and returns named numpy arrays with leading dim
    R. ``decode`` is the torch inverse: named tensors → i32 gaps
    ``[R, T]``. ``decode_free`` codecs store absolute components and
    are never decoded (the packer special-cases them)."""

    name: str = "abstract"
    #: row length must be a multiple of this (control-byte grouping)
    block_multiple: int = 1
    #: stores absolute components; no per-query decode work
    decode_free: bool = False

    def encode(self, gaps: np.ndarray) -> Dict[str, np.ndarray]:
        raise NotImplementedError

    def decode(self, arrays: Mapping, block_size: int):
        raise NotImplementedError

    @staticmethod
    def _byte_scatter(
        gaps: np.ndarray, lens: np.ndarray, n_over_read: int
    ) -> np.ndarray:
        """Scatter each gap's ``lens`` LE bytes into a dense [R, DP]
        stream (DP = max row length + over-read, lane-padded)."""
        R, T = gaps.shape
        ends = np.cumsum(lens, axis=1)
        starts = ends - lens
        max_end = int(np.max(ends[:, -1], initial=0)) if T else 0
        DP = max(_round_up(max_end + n_over_read, _LANES), _LANES)
        data = np.zeros((R, DP), dtype=np.uint8)
        rows = np.broadcast_to(np.arange(R)[:, None], (R, T))
        g64 = gaps.astype(np.uint64)
        for b in range(int(lens.max(initial=1))):
            sel = lens > b
            data[rows[sel], starts[sel] + b] = (g64[sel] >> (8 * b)).astype(np.uint8)
        return data


_LAYOUTS: Dict[str, Callable[[], LayoutCodec]] = {}


def register_layout(name: str):
    def deco(factory: Callable[[], LayoutCodec]):
        _LAYOUTS[name] = factory
        return factory

    return deco


def get_layout(name: str) -> LayoutCodec:
    try:
        return _LAYOUTS[name]()
    except KeyError:
        raise ValueError(
            f"no packed layout for codec {name!r}; have {sorted(_LAYOUTS)}"
        ) from None


def available_layouts() -> list[str]:
    return sorted(_LAYOUTS)


@register_layout("uncompressed")
class UncompressedLayout(LayoutCodec):
    """Raw gaps as i32 — the packer replaces them with absolute
    components (decode-free, the paper's baseline)."""

    name = "uncompressed"
    decode_free = True

    def encode(self, gaps: np.ndarray) -> Dict[str, np.ndarray]:
        return {"gaps": gaps.astype(np.int32)}

    def decode(self, arrays: Mapping, block_size: int):
        return arrays["gaps"]


@register_layout("dotvbyte")
class DotVByteLayout(LayoutCodec):
    """1-bit controls, 8 gaps per control byte, 1–2 data bytes per gap
    (paper §2.2). Requires 16-bit gaps. The data stream keeps one
    over-read byte past each row's payload (the vectorised decoder reads
    byte ``start + 1`` for every gap)."""

    name = "dotvbyte"
    block_multiple = 8

    def encode(self, gaps: np.ndarray) -> Dict[str, np.ndarray]:
        R, T = gaps.shape
        bits = control_bits(gaps.reshape(-1)).reshape(R, T)
        ctrl = np.packbits(
            bits.reshape(R, T // 8, 8), axis=2, bitorder="little"
        ).reshape(R, T // 8)
        lens = bits.astype(np.int64) + 1
        return {"ctrl": _lane_pad(ctrl), "data": self._byte_scatter(gaps, lens, 1)}

    def decode(self, arrays: Mapping, block_size: int):
        from .scoring import decode_gaps_dotvbyte

        ctrl = arrays["ctrl"]
        if block_size:  # lane-padded ctrl: slice tight before decoding
            ctrl = ctrl[..., : block_size // 8]
        return decode_gaps_dotvbyte(ctrl, arrays["data"])


@register_layout("streamvbyte")
class StreamVByteLayout(LayoutCodec):
    """2-bit controls, 4 gaps per control byte, 1–4 data bytes per gap
    (Lemire et al.), full 32-bit gap range. The data stream keeps three
    over-read bytes past each row's payload (the vectorised decoder
    reads bytes ``start .. start + 3`` for every gap)."""

    name = "streamvbyte"
    block_multiple = 4

    def encode(self, gaps: np.ndarray) -> Dict[str, np.ndarray]:
        R, T = gaps.shape
        q = byte_codes(gaps).reshape(R, T // 4, 4)
        ctrl = q[..., 0] | (q[..., 1] << 2) | (q[..., 2] << 4) | (q[..., 3] << 6)
        lens = q.reshape(R, T).astype(np.int64) + 1
        return {"ctrl": _lane_pad(ctrl), "data": self._byte_scatter(gaps, lens, 3)}

    def decode(self, arrays: Mapping, block_size: int):
        from .scoring import decode_gaps_streamvbyte

        ctrl = arrays["ctrl"]
        if block_size:  # lane-padded ctrl: slice tight before decoding
            ctrl = ctrl[..., : block_size // 4]
        return decode_gaps_streamvbyte(ctrl, arrays["data"])


@register_layout("bitpack")
class BitpackLayout(LayoutCodec):
    """Per-row fixed-width word packing: row r's gaps at ``widths[r]``
    bits each (its largest gap's bit length, at least 1), LSB-first in
    u32 words lane-padded to the widest row's need, packed by
    ``codecs.bitpack.pack_block``."""

    name = "bitpack"

    def encode(self, gaps: np.ndarray) -> Dict[str, np.ndarray]:
        R, T = gaps.shape
        widths = np.maximum(bit_widths(gaps.max(axis=1, initial=0)), 1).astype(np.int32)
        w_max = int(widths.max(initial=1))
        n_words = (T * w_max + 31) // 32
        words = np.zeros((R, n_words), dtype=np.uint32)
        for r in range(R):
            wr = pack_block(gaps[r], int(widths[r]))
            words[r, : len(wr)] = wr
        return {"words": _lane_pad(words), "widths": widths}

    def decode(self, arrays: Mapping, block_size: int):
        from .scoring import decode_gaps_bitpack

        return decode_gaps_bitpack(arrays["words"], arrays["widths"], block_size)


@dataclasses.dataclass
class PackedRows:
    """Fixed-capacity per-document rows for candidate rescoring.

    ``vals_rows``/``nnz_rows`` are codec-independent; ``payload`` holds
    the codec streams keyed engine-style (``comps_rows`` | ``ctrl_rows``
    + ``data_rows`` | ``words_rows`` + ``widths_rows``) and the value
    codec's extras (``vq_*``). Row N is the all-zero sentinel. Under a
    quantized ``vq``, ``vals_rows`` holds u8 codes of width
    ``l_max // code_factor(vq)``."""

    codec: str
    n_docs: int
    dim: int
    l_max: int
    value_format: ValueFormat
    vals_rows: np.ndarray
    nnz_rows: np.ndarray
    payload: dict[str, np.ndarray]
    vq: str = "f16"

    def arrays(self) -> dict[str, np.ndarray]:
        return {"vals_rows": self.vals_rows, "nnz_rows": self.nnz_rows, **self.payload}


def _row_gap_matrix(fwd: ForwardIndex, l_max: int):
    """CSR → padded [N+1, l_max] gap/value matrices, vectorised.

    Row-first gaps are ABSOLUTE (per-document alignment): cumsum alone
    rebuilds component ids; padding gaps are 0."""
    N = fwd.n_docs
    nnz = np.diff(fwd.offsets).astype(np.int64)
    total = int(fwd.total_nnz)
    doc_of = np.repeat(np.arange(N), nnz)
    pos = np.arange(total) - np.repeat(fwd.offsets[:-1].astype(np.int64), nnz)
    comps = fwd.components.astype(np.int64)
    gaps_flat = np.zeros(total, dtype=np.int64)
    if total:
        gaps_flat[1:] = comps[1:] - comps[:-1]
        starts = fwd.offsets[:-1][nnz > 0].astype(np.int64)
        gaps_flat[starts] = comps[starts]
    gaps = np.zeros((N + 1, l_max), dtype=np.uint32)
    gaps[doc_of, pos] = gaps_flat
    vals = np.zeros((N + 1, l_max), dtype=fwd.values.dtype)
    vals[doc_of, pos] = fwd.values
    return gaps, vals, np.concatenate([nnz, [0]]).astype(np.int32)


def pack_rows(
    fwd: ForwardIndex,
    codec: str = "uncompressed",
    l_max: int | None = None,
    doc_range: tuple[int, int] | None = None,
    vq: str = "f16",
) -> PackedRows:
    """Build the per-document row layout under any registered codec.

    ``doc_range=(lo, hi)`` packs only that contiguous doc slice with
    shard-local row ids (row 0 = doc ``lo``). The row capacity is the
    largest of ``l_max``, the longest document and 1, rounded up to
    ``LANE_MULTIPLE``."""
    value_codecs.check_vq(vq)
    if doc_range is not None:
        fwd = fwd.slice(*doc_range)
    lc = get_layout(codec)
    nnz_max = int(np.diff(fwd.offsets).max(initial=1))
    cap = max(l_max or 0, nnz_max, 1)
    cap = _round_up(cap, _LANES * value_codecs.code_factor(vq))
    gaps, vals_rows, nnz_rows = _row_gap_matrix(fwd, cap)
    if lc.decode_free:
        comps = np.cumsum(gaps.astype(np.int64), axis=1)
        live = np.arange(cap)[None, :] < nnz_rows[:, None]
        payload = {"comps_rows": np.where(live, comps, 0).astype(np.int32)}
    else:
        payload = {f"{k}_rows": v for k, v in lc.encode(gaps).items()}
    vals_rows, vq_extras = value_codecs.encode_rows_values(vals_rows, nnz_rows, vq)
    payload.update(vq_extras)
    return PackedRows(
        codec=codec,
        n_docs=fwd.n_docs,
        dim=fwd.dim,
        l_max=cap,
        value_format=fwd.value_format,
        vals_rows=vals_rows,
        nnz_rows=nnz_rows,
        payload=payload,
        vq=vq,
    )
