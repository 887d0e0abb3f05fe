"""Codec-pluggable packed layouts — the one place a gap stream becomes
device arrays (a copy of ``repro/core/layout.py``; every packed array is
byte-identical to the reference's).

A ``ForwardIndex`` reaches the device in two fixed-shape forms:

* the block form ``[B, T]`` (``pack_blocks`` → ``PackedBlocks``):
  documents greedily packed into self-contained blocks for the full
  scan. The fragment-first gap is 0 and the fragment's absolute first
  component lives in ``start_abs``, so every block decodes on its own;
* the row form ``[N+1, L]`` (``pack_rows`` → ``PackedRows``): one
  fixed-capacity row per document for the serve engines' candidate
  rescoring; the ``+1`` row is the all-zero sentinel that out-of-corpus
  candidate ids gather. Row gaps carry the absolute first component
  (per-document alignment), so a plain cumsum rebuilds the ids.

Four layouts are registered: ``uncompressed`` (absolute components,
decode-free), ``dotvbyte``, ``streamvbyte`` and ``bitpack``; each packs
under every value codec (``core/values.py``).

Streams are lane-aligned at pack time, as the reference lays them out
for the TPU: ``l_max`` rounds up to ``LANE_MULTIPLE`` (=128, times the
value codec's pack factor) and the ctrl/data/words streams pad their
trailing dim to a multiple of 128. Decoders therefore slice the control
stream tight (``L // 8`` bytes for DotVByte, ``L // 4`` for
StreamVByte) before decoding.

Sharded forms stack per-shard arrays with a leading shard axis
(``pad_stack``, every axis padded to the across-shard maximum):
``pack_blocks_sharded`` packs contiguous doc ranges with range-local
doc ids for the doc-aligned scan (``scoring.make_doc_aligned_scan``).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Mapping, Sequence

import numpy as np

from . import values as value_codecs
from .codecs import get_codec
from .codecs.bitpack import bit_widths, pack_block
from .codecs.dotvbyte import control_bits
from .codecs.streamvbyte import byte_codes
from ..spans import span
from .forward_index import ForwardIndex, PackedBlocks, ValueFormat

__all__ = [
    "LayoutCodec",
    "register_layout",
    "get_layout",
    "available_layouts",
    "PackedRows",
    "pack_blocks",
    "pack_blocks_sharded",
    "pack_rows",
    "pad_stack",
    "encode_docs",
    "BLOCK_PAD_VALUES",
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


# ---------------------------------------------------------------------------
# block form  [B, T]
# ---------------------------------------------------------------------------

#: pad values for stacking block arrays across shards
BLOCK_PAD_VALUES = {"seg": -1, "doc_ids": -1}


def _fragments(
    fwd: ForwardIndex, block_size: int, max_docs: int
) -> list[list[tuple[int, int, int]]]:
    """Greedy first-fit packing of doc fragments into blocks.

    Returns per-block lists of (doc_id, start_nnz, end_nnz) fragments.
    A block closes when T components or D doc slots are used; an empty
    document takes no slot."""
    blocks: list[list[tuple[int, int, int]]] = []
    cur: list[tuple[int, int, int]] = []
    used = 0
    for d, n in enumerate(np.diff(fwd.offsets).tolist()):
        pos = 0
        while pos < n:
            if used == block_size or len(cur) == max_docs:
                blocks.append(cur)
                cur, used = [], 0
            take = min(n - pos, block_size - used)
            cur.append((d, pos, pos + take))
            used += take
            pos += take
    if cur:
        blocks.append(cur)
    return blocks


def _resolve_absolute(gaps, seg, start_pos, start_abs):
    """numpy mirror of ``scoring.components_from_gaps`` for the
    decode-free layout: gaps + out-of-band absolutes → component ids."""
    D = start_pos.shape[1]
    t = np.cumsum(gaps.astype(np.int64), axis=1)
    tp = np.take_along_axis(t, start_pos.astype(np.int64), axis=1)
    segc = np.clip(seg, 0, D - 1).astype(np.int64)
    base = np.take_along_axis(start_abs.astype(np.int64), segc, axis=1)
    tseg = np.take_along_axis(tp, segc, axis=1)
    return np.where(seg >= 0, base + t - tseg, 0).astype(np.int32)


def pack_blocks(
    fwd: ForwardIndex,
    codec: str = "dotvbyte",
    block_size: int = 512,
    max_docs_per_block: int | None = None,
    seg_dtype=np.int32,
    vq: str = "f16",
    vq_clip: tuple[float, float] | None = None,
) -> PackedBlocks:
    """Build the packed block layout under any registered codec.

    ``block_size`` (T) must be a multiple of 128; ``max_docs_per_block``
    (D) defaults to T // 8. ``seg_dtype=np.int8`` is the slim metadata
    layout (D ≤ 127). ``vq`` selects the value codec: ``"f16"`` stores
    the raw storage dtype; the quantized codecs replace ``vals`` with u8
    codes plus per-block clip ranges or a shared codebook. ``vq_clip``
    overrides the fitted ranges with one global (lo, hi).

    The reference fills the arrays fragment by fragment; here the
    fragments' entries are placed with one vectorised scatter, to the
    same bytes."""
    with span("repro_torch.build.pack"):
        value_codecs.check_vq(vq)
        lc = get_layout(codec)
        if block_size % 128:
            raise ValueError("block_size must be a multiple of 128 (TPU lanes)")
        T = block_size
        D = max_docs_per_block or T // 8
        if np.dtype(seg_dtype) == np.int8 and D > 127:
            raise ValueError("int8 seg needs max_docs_per_block <= 127")
        frags = _fragments(fwd, T, D)
        B = len(frags)

        # one row per fragment: block, slot, doc, [lo, hi) within the doc
        f_block = np.repeat(np.arange(B), [len(f) for f in frags])
        f_slot = np.concatenate([np.arange(len(f)) for f in frags]) if B else np.zeros(0, np.int64)
        f = np.asarray([x for fl in frags for x in fl], dtype=np.int64).reshape(-1, 3)
        f_doc, f_lo, f_hi = f[:, 0], f[:, 1], f[:, 2]
        f_n = f_hi - f_lo
        f_first = np.cumsum(f_n) - f_n  # first entry of each fragment, flat
        # position of each fragment inside its block: fragments before it
        # in the same block, summed
        blk_first = np.zeros(B, np.int64)
        if B:
            blk_first[1:] = np.cumsum(np.bincount(f_block, weights=f_n, minlength=B))[:-1]
        f_pos = f_first - blk_first[f_block]

        n_ent = int(f_n.sum())
        e_frag = np.repeat(np.arange(len(f_n)), f_n)
        e_k = np.arange(n_ent) - f_first[e_frag]
        e_block = f_block[e_frag]
        e_pos = f_pos[e_frag] + e_k
        src = fwd.offsets[f_doc].astype(np.int64)[e_frag] + f_lo[e_frag] + e_k
        comps = fwd.components[src].astype(np.int64)
        g = np.zeros(n_ent, np.int64)
        g[1:] = comps[1:] - comps[:-1]
        g[f_first[f_n > 0]] = 0  # fragment-first gap forced to 0; absolute out-of-band

        seg = np.full((B, T), -1, dtype=seg_dtype)
        start_pos = np.zeros((B, D), dtype=np.int32)
        start_abs = np.zeros((B, D), dtype=np.int32)
        vals = np.zeros((B, T), dtype=fwd.values.dtype)
        doc_ids = np.full((B, D), -1, dtype=np.int32)
        gaps_all = np.zeros((B, T), dtype=np.uint32)
        gaps_all[e_block, e_pos] = g.astype(np.uint32)
        seg[e_block, e_pos] = f_slot[e_frag]
        vals[e_block, e_pos] = fwd.values[src]
        start_pos[f_block, f_slot] = f_pos
        start_abs[f_block, f_slot] = comps[f_first]
        doc_ids[f_block, f_slot] = f_doc

        vals, vq_extras = value_codecs.encode_block_values(vals, seg, vq, clip=vq_clip)
        out = PackedBlocks(
            codec=codec,
            block_size=T,
            n_docs=fwd.n_docs,
            dim=fwd.dim,
            value_format=fwd.value_format,
            seg=seg,
            start_pos=start_pos,
            start_abs=start_abs,
            vals=vals,
            doc_ids=doc_ids,
            vq=vq,
        )
        for field, arr in vq_extras.items():
            setattr(out, field, arr)
        if lc.decode_free:
            out.comps = _resolve_absolute(gaps_all, seg, start_pos, start_abs)
            return out
        for field, arr in lc.encode(gaps_all).items():
            setattr(out, field, arr)
        return out


def pack_blocks_sharded(
    fwd: ForwardIndex,
    n_shards: int,
    codec: str = "dotvbyte",
    block_size: int = 512,
    seg_dtype=np.int32,
) -> tuple[dict, int]:
    """Doc-aligned sharded packing: documents split into ``n_shards``
    contiguous ranges of ``docs_local = ⌈n / n_shards⌉``, each range
    packed on its own with range-local doc ids and ``pad_stack``ed to a
    leading shard axis → (arrays, docs_local). As in the reference, a
    short tail range is filled with one-entry documents (component 0,
    value 0) and every value makes the dequantise → quantise round trip
    of ``ForwardIndex.from_docs``; here in one vectorised pass, to the
    same bytes."""
    n = fwd.n_docs
    docs_local = (n + n_shards - 1) // n_shards
    vf = fwd.value_format
    dicts = []
    for s in range(n_shards):
        hi = min((s + 1) * docs_local, n)
        sub = fwd.slice(min(s * docs_local, hi), hi)
        n_tail = docs_local - sub.n_docs
        nnz = int(sub.offsets[-1])
        sub = ForwardIndex(
            components=np.concatenate([sub.components.astype(np.uint32),
                                       np.zeros(n_tail, np.uint32)]),
            values=np.concatenate([vf.quantise(vf.dequantise(sub.values)),
                                   vf.quantise(np.zeros(n_tail, np.float32))]),
            offsets=np.concatenate([sub.offsets, nnz + np.arange(1, n_tail + 1)]).astype(np.int64),
            dim=fwd.dim,
            value_format=vf,
        )
        dicts.append(pack_blocks(sub, codec=codec, block_size=block_size,
                                 seg_dtype=seg_dtype).as_dict())
    return pad_stack(dicts, BLOCK_PAD_VALUES), docs_local


# ---------------------------------------------------------------------------
# row form  [N+1, L]
# ---------------------------------------------------------------------------


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
    with span("repro_torch.build.pack"):
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


# ---------------------------------------------------------------------------
# shard stacking
# ---------------------------------------------------------------------------


def pad_stack(
    dicts: Sequence[Mapping[str, np.ndarray]],
    pad_values: Mapping[str, int] | None = None,
) -> dict[str, np.ndarray]:
    """Stack per-shard array dicts with a leading shard axis, padding
    every axis to the across-shard maximum with ``pad_values[key]``
    (default 0): block counts and stream widths legitimately differ
    between shards."""
    pad_values = pad_values or {}
    keys = list(dicts[0])
    for d in dicts[1:]:
        if list(d) != keys:
            raise ValueError("shard dicts must share the same fields")
    out: dict[str, np.ndarray] = {}
    for k in keys:
        arrs = [np.asarray(d[k]) for d in dicts]
        target = tuple(max(a.shape[i] for a in arrs) for i in range(arrs[0].ndim))
        buf = np.full((len(arrs), *target), pad_values.get(k, 0), dtype=arrs[0].dtype)
        for s, a in enumerate(arrs):
            buf[(s, *(slice(0, d) for d in a.shape))] = a
        out[k] = buf
    return out


def encode_docs(fwd: ForwardIndex, codec_name: str) -> list[bytes]:
    """Host-side per-document byte encoding (the HNSW reference search's
    codec-timed path) through the codec registry."""
    codec = get_codec(codec_name)
    offs = fwd.offsets
    return [
        codec.encode_doc(fwd.components[int(s) : int(e)])
        for s, e in zip(offs[:-1], offs[1:])
    ]
