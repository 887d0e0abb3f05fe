"""The forward index (paper §1-§2): doc_id → sparse vector, CSR layout
(numpy; a copy of the parts of ``repro/core/forward_index.py`` the
serving path, the full scan, the paper's space metric and the mutable
index's merge — ``concat``, ``append``, ``select`` — need).

Three arrays, as the paper describes: ``components`` (nonzero
coordinate ids), ``values`` (their values), ``offsets`` (row pointers).
Values may be stored as f32, f16 or fixedU8; quantisation is applied
at build time and dequantisation fused into the scoring path.

Also the packed block layout of the full scan (``PackedBlocks``):
documents split into self-contained blocks of ``block_size`` entries,
each fragment opening with its absolute first component stored out of
band (``start_abs``), so every block decodes on its own.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Mapping, Sequence

import numpy as np

__all__ = ["ValueFormat", "ForwardIndex", "PackedBlocks", "pack_forward_index",
           "pack_forward_index_sharded", "VALUE_FORMATS"]


@dataclasses.dataclass(frozen=True)
class ValueFormat:
    """Storage format for the values array."""

    name: str
    dtype: np.dtype
    scale: float  # dequantised value = stored * scale

    def quantise(self, v: np.ndarray) -> np.ndarray:
        if self.name == "fixedu8":
            q = np.clip(np.round(v / self.scale), 0, 255)
            return q.astype(np.uint8)
        return v.astype(self.dtype)

    def dequantise(self, q: np.ndarray) -> np.ndarray:
        return q.astype(np.float32) * np.float32(self.scale)


VALUE_FORMATS = {
    "f32": ValueFormat("f32", np.dtype(np.float32), 1.0),
    "f16": ValueFormat("f16", np.dtype(np.float16), 1.0),
    # U3F5-style fixed point: range [0, 8), resolution 1/32
    "fixedu8": ValueFormat("fixedu8", np.dtype(np.uint8), 1.0 / 32.0),
}


@dataclasses.dataclass
class ForwardIndex:
    """Uncompressed CSR forward index (the paper's baseline layout)."""

    components: np.ndarray  # u32 [total_nnz], sorted per doc
    values: np.ndarray  # stored dtype [total_nnz]
    offsets: np.ndarray  # i64 [n_docs + 1]
    dim: int
    value_format: ValueFormat = VALUE_FORMATS["f32"]

    @staticmethod
    def from_docs(
        docs: Iterable[tuple[np.ndarray, np.ndarray]],
        dim: int,
        value_format: str = "f32",
    ) -> "ForwardIndex":
        vf = VALUE_FORMATS[value_format]
        comps, vals, offs = [], [], [0]
        for c, v in docs:
            c = np.asarray(c, dtype=np.uint32)
            v = np.asarray(v, dtype=np.float32)
            order = np.argsort(c, kind="stable")
            comps.append(c[order])
            vals.append(vf.quantise(v[order]))
            offs.append(offs[-1] + len(c))
        return ForwardIndex(
            components=np.concatenate(comps) if comps else np.zeros(0, np.uint32),
            values=np.concatenate(vals) if vals else np.zeros(0, vf.dtype),
            offsets=np.asarray(offs, dtype=np.int64),
            dim=dim,
            value_format=vf,
        )

    @property
    def n_docs(self) -> int:
        return len(self.offsets) - 1

    @property
    def total_nnz(self) -> int:
        return int(self.offsets[-1])

    def nnz(self, i: int) -> int:
        return int(self.offsets[i + 1] - self.offsets[i])

    def doc(self, i: int) -> tuple[np.ndarray, np.ndarray]:
        s, e = int(self.offsets[i]), int(self.offsets[i + 1])
        return self.components[s:e], self.value_format.dequantise(self.values[s:e])

    def doc_raw_values(self, i: int) -> np.ndarray:
        s, e = int(self.offsets[i]), int(self.offsets[i + 1])
        return self.values[s:e]

    def iter_docs(self) -> Iterable[tuple[np.ndarray, np.ndarray]]:
        for i in range(self.n_docs):
            yield self.doc(i)

    def slice(self, lo: int, hi: int) -> "ForwardIndex":
        """CSR view of the contiguous doc range ``[lo, hi)`` (zero-copy
        on components/values; only the rebased offsets allocate)."""
        if not 0 <= lo <= hi <= self.n_docs:
            raise ValueError(
                f"doc range [{lo}, {hi}) outside collection [0, {self.n_docs})"
            )
        s, e = int(self.offsets[lo]), int(self.offsets[hi])
        return ForwardIndex(
            components=self.components[s:e],
            values=self.values[s:e],
            offsets=(self.offsets[lo : hi + 1] - s).astype(np.int64),
            dim=self.dim,
            value_format=self.value_format,
        )

    def padded(self, n_docs: int) -> "ForwardIndex":
        """This index extended with empty documents up to ``n_docs`` rows
        (zero-copy on components and values) — how the shard builds pad
        ragged ranges to one local size; an empty row scores 0 and is
        mapped out of every merge by its shard's id map."""
        if n_docs < self.n_docs:
            raise ValueError(f"cannot pad {self.n_docs} docs down to {n_docs}")
        if n_docs == self.n_docs:
            return self
        return ForwardIndex(
            components=self.components,
            values=self.values,
            offsets=np.concatenate(
                [self.offsets, np.full(n_docs - self.n_docs, self.offsets[-1], np.int64)]
            ),
            dim=self.dim,
            value_format=self.value_format,
        )

    @staticmethod
    def concat(parts: Sequence["ForwardIndex"]) -> "ForwardIndex":
        """Row-wise concatenation of CSR indexes (same dim and value
        format) in one vectorised pass — how a mutable index's merge
        stitches its base store and delta segments together
        (``serve/segments.py``). One part is returned as it is."""
        if not parts:
            raise ValueError("concat needs at least one part")
        dim = parts[0].dim
        vf = parts[0].value_format
        for p in parts[1:]:
            if p.dim != dim:
                raise ValueError(f"dim mismatch: {p.dim} != {dim}")
            if p.value_format.name != vf.name:
                raise ValueError(
                    f"value_format mismatch: {p.value_format.name} != {vf.name}"
                )
        if len(parts) == 1:
            return parts[0]
        offs = [np.zeros(1, np.int64)]
        base = 0
        for p in parts:
            offs.append(p.offsets[1:].astype(np.int64) + base)
            base += int(p.offsets[-1])
        return ForwardIndex(
            components=np.concatenate([p.components for p in parts]),
            values=np.concatenate([p.values for p in parts]),
            offsets=np.concatenate(offs),
            dim=dim,
            value_format=vf,
        )

    def append(self, other: "ForwardIndex") -> "ForwardIndex":
        """``concat([self, other])``."""
        return ForwardIndex.concat([self, other])

    def select(self, idx: np.ndarray) -> "ForwardIndex":
        """Row gather: row ``r`` of the result is row ``idx[r]`` of this
        index, in the given order (repeats allowed), stored values kept
        byte for byte. The merge extracts the live rows in stable-id
        order with this."""
        idx = np.asarray(idx, dtype=np.int64)
        if idx.size and (idx.min() < 0 or idx.max() >= self.n_docs):
            raise ValueError(
                f"row index outside [0, {self.n_docs}): [{idx.min()}, {idx.max()}]"
            )
        lens = np.diff(self.offsets)[idx]
        new_off = np.zeros(len(idx) + 1, np.int64)
        np.cumsum(lens, out=new_off[1:])
        total = int(new_off[-1])
        # element positions: per output row, a run of consecutive source
        # positions from the source row's first element
        starts = self.offsets[:-1][idx]
        pos = (
            np.repeat(starts, lens)
            + np.arange(total, dtype=np.int64)
            - np.repeat(new_off[:-1], lens)
        )
        return ForwardIndex(
            components=self.components[pos],
            values=self.values[pos],
            offsets=new_off,
            dim=self.dim,
            value_format=self.value_format,
        )

    def densify(self, i: int) -> np.ndarray:
        c, v = self.doc(i)
        out = np.zeros(self.dim, dtype=np.float32)
        out[c] = v
        return out

    def exact_scores(self, q_dense: np.ndarray) -> np.ndarray:
        """⟨q, x⟩ for every doc — the numpy ground truth."""
        q = np.asarray(q_dense, dtype=np.float32)
        contrib = q[self.components] * self.value_format.dequantise(self.values)
        out = np.zeros(self.n_docs, dtype=np.float32)
        np.add.at(out, np.repeat(np.arange(self.n_docs), np.diff(self.offsets)), contrib)
        return out

    def apply_component_permutation(self, pi: np.ndarray) -> "ForwardIndex":
        """Relabel component c as ``pi[c]`` and re-sort each doc (paper §2,
        ``core/rgb.py``); queries take the same permutation
        (``rgb.apply_permutation_dense``). Equal, array for array, to the
        reference's per-document loop: a permutation keeps a document's
        components distinct, so one sort by (doc, new component) orders
        every document at once."""
        pi = np.asarray(pi, dtype=np.uint32)
        if len(pi) != self.dim:
            raise ValueError("permutation length must equal dim")
        new_comp = pi[self.components]
        doc = np.repeat(np.arange(self.n_docs), np.diff(self.offsets))
        order = np.lexsort((new_comp, doc))
        return ForwardIndex(new_comp[order], self.values[order], self.offsets.copy(), self.dim,
                            self.value_format)

    def storage_bytes(self, codec_name: str = "uncompressed") -> dict[str, int]:
        """Bytes of the index with its components encoded per document
        by ``codec_name`` (the paper's space metric). Counts equal the
        reference's per-document ``encode_doc`` loop; here they are
        counted vectorised (``Codec.doc_bytes``)."""
        from .codecs import get_codec

        comp_bytes = get_codec(codec_name).doc_bytes(self.components, self.offsets)
        return {
            "components": int(comp_bytes.sum()),
            "values": int(self.values.nbytes),
            "offsets": int(self.offsets.nbytes),
        }


#: the optional array fields of ``PackedBlocks``, in ``as_dict`` order
_BLOCK_OPTIONAL = ("ctrl", "data", "words", "widths", "comps", "vq_lo", "vq_scale", "vq_codebook")


@dataclasses.dataclass
class PackedBlocks:
    """Self-contained fixed-size blocks for the full scan.

    Shapes (B = n_blocks, T = block_size, D = max docs/block):

    ============  =========  ==================================================
    field         shape      meaning
    ============  =========  ==================================================
    seg           i32 [B,T]  local doc-slot id per element, -1 for padding
                             (i8 in the slim layout)
    start_pos     i32 [B,D]  element index of each slot's first element
    start_abs     i32 [B,D]  absolute first component of each fragment
    vals          [B,T]      stored-dtype values (0 for padding), or u8 codes
                             under a quantized ``vq``
    doc_ids       i32 [B,D]  global doc id per slot, -1 for unused slots
    ctrl          u8 [B,T/8] DotVByte controls — or [B,T/4] StreamVByte
                             2-bit controls (lane-padded)
    data          u8 [B,DP]  byte stream, padded (dotvbyte/streamvbyte)
    words         u32[B,W]   bitpack words (codec="bitpack")
    widths        i32 [B]    bitpack bit-width per block (codec="bitpack")
    comps         i32 [B,T]  absolute components (codec="uncompressed")
    ============  =========  ==================================================

    Gap streams encode the within-fragment gaps with the fragment-first
    gap forced to 0; absolutes live in ``start_abs``. Built by
    ``core.layout.pack_blocks`` with numpy arrays; :meth:`to` moves
    every array onto a torch device for the scoring paths."""

    codec: str
    block_size: int
    n_docs: int
    dim: int
    value_format: ValueFormat
    seg: np.ndarray
    start_pos: np.ndarray
    start_abs: np.ndarray
    vals: np.ndarray
    doc_ids: np.ndarray
    ctrl: np.ndarray | None = None
    data: np.ndarray | None = None
    words: np.ndarray | None = None
    widths: np.ndarray | None = None
    comps: np.ndarray | None = None
    #: value codec: quantized vqs store u8 codes in ``vals`` plus
    #: per-block clip ranges or a shared codebook
    vq: str = "f16"
    vq_lo: np.ndarray | None = None
    vq_scale: np.ndarray | None = None
    vq_codebook: np.ndarray | None = None
    #: the bitpack width buckets, built at first use by
    #: ``kernels.ops.width_buckets`` and kept for the pack's life; not
    #: part of its contents (``to`` and ``replace`` start without them)
    buckets: list | None = dataclasses.field(default=None, init=False, repr=False,
                                              compare=False)

    @property
    def n_blocks(self) -> int:
        return self.seg.shape[0]

    @property
    def max_docs_per_block(self) -> int:
        return self.doc_ids.shape[1]

    def as_dict(self) -> dict:
        """Every populated array field, keyed by name."""
        out = {
            "seg": self.seg,
            "start_pos": self.start_pos,
            "start_abs": self.start_abs,
            "vals": self.vals,
            "doc_ids": self.doc_ids,
        }
        for k in _BLOCK_OPTIONAL:
            a = getattr(self, k)
            if a is not None:
                out[k] = a
        return out

    def payload_bytes(self) -> int:
        """Bytes the scoring path streams from device memory."""
        return sum(int(a.nbytes) for a in self.as_dict().values())

    @classmethod
    def from_dict(
        cls,
        arrays: Mapping,
        *,
        codec: str,
        block_size: int,
        n_docs: int,
        dim: int,
        value_format: str,
        vq: str = "f16",
    ) -> "PackedBlocks":
        """A pack from its ``as_dict()`` arrays plus metadata — how a
        reference pack crosses into the port byte for byte."""
        unknown = set(arrays) - {"seg", "start_pos", "start_abs", "vals", "doc_ids",
                                 *_BLOCK_OPTIONAL}
        if unknown:
            raise ValueError(f"unknown PackedBlocks fields {sorted(unknown)}")
        return cls(codec=codec, block_size=int(block_size), n_docs=int(n_docs),
                   dim=int(dim), value_format=VALUE_FORMATS[value_format], vq=vq,
                   **{k: np.asarray(v) for k, v in arrays.items()})

    def to(self, device) -> "PackedBlocks":
        """The same pack with every array a torch tensor on ``device``."""
        import torch

        from ..spans import span

        def move(a):
            if isinstance(a, torch.Tensor):
                return a.to(device)
            return torch.from_numpy(np.ascontiguousarray(a)).to(device)

        with span("repro_torch.build.place"):
            return dataclasses.replace(self, **{k: move(v) for k, v in self.as_dict().items()})


def pack_forward_index(
    fwd: ForwardIndex,
    codec: str = "dotvbyte",
    block_size: int = 512,
    max_docs_per_block: int | None = None,
    seg_dtype=np.int32,
    vq: str = "f16",
    vq_clip=None,
) -> PackedBlocks:
    """Build the packed block layout from a CSR forward index (an alias
    of ``core.layout.pack_blocks`` under the reference's import path)."""
    from .layout import pack_blocks

    return pack_blocks(fwd, codec=codec, block_size=block_size,
                       max_docs_per_block=max_docs_per_block, seg_dtype=seg_dtype,
                       vq=vq, vq_clip=vq_clip)


def pack_forward_index_sharded(
    fwd: ForwardIndex,
    n_shards: int,
    codec: str = "dotvbyte",
    block_size: int = 512,
    seg_dtype=np.int32,
) -> tuple[dict, int]:
    """Doc-aligned sharded packing under the reference's import path (an
    alias of ``core.layout.pack_blocks_sharded``): (stacked arrays,
    docs_local), for ``scoring.make_doc_aligned_scan``."""
    from .layout import pack_blocks_sharded

    return pack_blocks_sharded(fwd, n_shards, codec=codec, block_size=block_size,
                               seg_dtype=seg_dtype)
