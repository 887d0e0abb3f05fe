"""Elias universal codes (Elias, 1975), gamma and delta — a copy of
``repro/core/codecs/elias.py``.

gamma(x), x >= 1: unary(len) ++ binary(x without its leading 1), where
len = floor(log2 x). delta(x): gamma(len + 1) ++ binary(x without its
leading 1). Gaps are encoded as g + 1, so a document opening with
component 0 stays representable.
"""

from __future__ import annotations

import numpy as np

from .base import Codec, components_from_gaps, csr_gaps, gaps_from_components, register
from .bitio import BitReader, BitWriter, bit_length

__all__ = ["EliasGammaCodec", "EliasDeltaCodec"]


def _gamma_write(w: BitWriter, x: int) -> None:
    if x < 1:
        raise ValueError("gamma codes positive integers only")
    nbits = x.bit_length() - 1  # floor(log2 x)
    w.write_unary(nbits)
    w.write_bits(x, nbits)  # low bits (the leading 1 is implicit)


def _gamma_read(r: BitReader) -> int:
    nbits = r.read_unary()
    return (1 << nbits) | r.read_bits(nbits)


def _delta_write(w: BitWriter, x: int) -> None:
    if x < 1:
        raise ValueError("delta codes positive integers only")
    nbits = x.bit_length() - 1
    _gamma_write(w, nbits + 1)
    w.write_bits(x, nbits)


def _delta_read(r: BitReader) -> int:
    nbits = _gamma_read(r) - 1
    return (1 << nbits) | r.read_bits(nbits)


def _gamma_bits(x: np.ndarray) -> np.ndarray:
    """Bits of gamma(x) for every x >= 1."""
    return 2 * (bit_length(x) - 1) + 1


class _EliasBase(Codec):
    supports_zero = False
    _write = staticmethod(_gamma_write)
    _read = staticmethod(_gamma_read)

    def encode_doc(self, components: np.ndarray) -> bytes:
        gaps = gaps_from_components(components)
        w = BitWriter()
        for g in gaps:
            self._write(w, int(g) + 1)
        return w.getvalue()

    def decode_doc(self, buf: bytes, n: int) -> np.ndarray:
        r = BitReader(buf)
        gaps = np.fromiter((self._read(r) - 1 for _ in range(n)), dtype=np.uint32, count=n)
        return components_from_gaps(gaps)

    def _code_bits(self, x: np.ndarray) -> np.ndarray:
        return _gamma_bits(x)

    def doc_bytes(self, components, offsets):
        gaps, doc, _, nnz = csr_gaps(components, offsets)
        bits = np.bincount(doc, weights=self._code_bits(gaps + np.uint64(1)),
                           minlength=len(nnz)).astype(np.int64)
        return (bits + 7) // 8  # zero-padded to a byte boundary


@register("elias_gamma")
class EliasGammaCodec(_EliasBase):
    name = "elias_gamma"


@register("elias_delta")
class EliasDeltaCodec(_EliasBase):
    name = "elias_delta"
    _write = staticmethod(_delta_write)
    _read = staticmethod(_delta_read)

    def _code_bits(self, x):
        nbits = bit_length(x) - 1
        return _gamma_bits(nbits + 1) + nbits
