"""The forward index (paper §1-§2): doc_id → sparse vector, CSR layout
(numpy; a copy of the parts of ``repro/core/forward_index.py`` the
serving path and the paper's space metric need).

Three arrays, as the paper describes: ``components`` (nonzero
coordinate ids), ``values`` (their values), ``offsets`` (row pointers).
Values may be stored as f32, f16 or fixedU8; quantisation is applied
at build time and dequantisation fused into the scoring path.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable

import numpy as np

__all__ = ["ValueFormat", "ForwardIndex", "VALUE_FORMATS"]


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

    def exact_scores(self, q_dense: np.ndarray) -> np.ndarray:
        """⟨q, x⟩ for every doc — the numpy ground truth."""
        q = np.asarray(q_dense, dtype=np.float32)
        contrib = q[self.components] * self.value_format.dequantise(self.values)
        out = np.zeros(self.n_docs, dtype=np.float32)
        np.add.at(out, np.repeat(np.arange(self.n_docs), np.diff(self.offsets)), contrib)
        return out

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
