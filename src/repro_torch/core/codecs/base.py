"""Codec protocol + d-gap transforms shared by the forward-index codecs
(numpy; a copy of ``repro/core/codecs/base.py``).

A codec encodes ONE document's sorted ``components`` into a byte string
and decodes it back. Documents are d-gap transformed first (paper §2):
``g[0] = c[0]``, ``g[i] = c[i] - c[i-1]``. The byte codecs (VByte,
StreamVByte, DotVByte, DotNibble, bitpack) encode gaps verbatim; the
bit-oriented universal codes (Elias gamma/delta, Zeta) cannot encode 0,
so they encode ``g + 1``.

Beyond the reference, every codec here also counts its encoded bytes
for a whole collection at once (:meth:`Codec.doc_bytes`), vectorised
over the CSR arrays, so ``ForwardIndex.storage_bytes`` needs no Python
loop over documents; the tests hold each count to ``len(encode_doc)``
of the reference's codec.
"""

from __future__ import annotations

from typing import Callable, Dict

import numpy as np

__all__ = [
    "gaps_from_components",
    "components_from_gaps",
    "csr_gaps",
    "Codec",
    "register",
    "get_codec",
    "available_codecs",
]


def gaps_from_components(components: np.ndarray) -> np.ndarray:
    """d-gap transform; components must be sorted strictly increasing."""
    c = np.asarray(components, dtype=np.int64)
    if c.ndim != 1:
        raise ValueError("components must be 1-D")
    if len(c) == 0:
        return c.astype(np.uint32)
    if np.any(np.diff(c) <= 0):
        raise ValueError("components must be strictly increasing")
    gaps = np.empty_like(c)
    gaps[0] = c[0]
    gaps[1:] = np.diff(c)
    return gaps.astype(np.uint32)


def components_from_gaps(gaps: np.ndarray) -> np.ndarray:
    return np.cumsum(np.asarray(gaps, dtype=np.int64)).astype(np.uint32)


def csr_gaps(components: np.ndarray, offsets: np.ndarray):
    """Per-document d-gaps of a whole CSR collection, vectorised →
    (gaps u64 [total_nnz], doc id of each entry, position in its doc,
    nnz per doc). Each document's first gap is its absolute component."""
    nnz = np.diff(offsets).astype(np.int64)
    c = np.asarray(components, dtype=np.int64)
    starts = np.asarray(offsets[:-1], dtype=np.int64)
    doc = np.repeat(np.arange(len(nnz)), nnz)
    pos = np.arange(len(c)) - np.repeat(starts, nnz)
    gaps = np.empty_like(c)
    if len(c):
        gaps[1:] = c[1:] - c[:-1]
        gaps[starts[nnz > 0]] = c[starts[nnz > 0]]
    return gaps.astype(np.uint64), doc, pos, nnz


class Codec:
    """Interface implemented by every forward-index components codec."""

    #: registry key, e.g. "dotvbyte"
    name: str = "abstract"
    #: True when the codec encodes raw gaps (can represent 0), False when
    #: it encodes gaps+1 (bit-oriented universal codes)
    supports_zero: bool = True

    def encode_doc(self, components: np.ndarray) -> bytes:
        raise NotImplementedError

    def decode_doc(self, buf: bytes, n: int) -> np.ndarray:
        """Decode ``n`` components from ``buf`` (absolute ids, uint32)."""
        raise NotImplementedError

    def doc_bytes(self, components: np.ndarray, offsets: np.ndarray) -> np.ndarray:
        """``len(encode_doc(doc))`` of every document of a CSR
        collection → i64 [n_docs], counted vectorised."""
        raise NotImplementedError

    def encoded_size_bytes(self, components: np.ndarray) -> int:
        return len(self.encode_doc(components))

    def bits_per_component(self, docs: list[np.ndarray]) -> float:
        """Encoded bits over components of a list of documents' component
        arrays (empty documents skipped), as the reference counts them."""
        total_bits = 0
        total_comps = 0
        for c in docs:
            if len(c) == 0:
                continue
            total_bits += 8 * self.encoded_size_bytes(c)
            total_comps += len(c)
        return total_bits / max(total_comps, 1)


_REGISTRY: Dict[str, Callable[[], Codec]] = {}


def register(name: str) -> Callable:
    def deco(factory: Callable[[], Codec]):
        _REGISTRY[name] = factory
        return factory

    return deco


def get_codec(name: str, **kwargs) -> Codec:
    try:
        factory = _REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown codec {name!r}; have {sorted(_REGISTRY)}") from None
    return factory(**kwargs)


def available_codecs() -> list[str]:
    return sorted(_REGISTRY)
