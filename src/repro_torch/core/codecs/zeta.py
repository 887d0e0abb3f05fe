"""Zeta_k codes (Boldi & Vigna, 2005) — a copy of
``repro/core/codecs/zeta.py``.

zeta_k(x), x >= 1: let h = floor(log2 x / k) (the "shard"); write
unary(h), then the minimal-binary ("truncated binary") code of
x - 2^{hk} within [0, 2^{(h+1)k} - 2^{hk}). k = 3 is the web-graph
default and the paper's "Zeta" row. Gaps are encoded as g + 1.
"""

from __future__ import annotations

import numpy as np

from .base import Codec, components_from_gaps, csr_gaps, gaps_from_components, register
from .bitio import BitReader, BitWriter, bit_length

__all__ = ["ZetaCodec"]


def _minimal_binary_write(w: BitWriter, x: int, z: int) -> None:
    """Truncated binary code of x in [0, z)."""
    if z <= 0 or not (0 <= x < z):
        raise ValueError("minimal binary domain error")
    s = z.bit_length() - 1  # floor(log2 z)
    m = (1 << (s + 1)) - z  # count of short (s-bit) codewords
    if x < m:
        w.write_bits(x, s)
    else:
        w.write_bits(x + m, s + 1)


def _minimal_binary_read(r: BitReader, z: int) -> int:
    s = z.bit_length() - 1
    m = (1 << (s + 1)) - z
    x = r.read_bits(s)
    if x < m:
        return x
    return ((x << 1) | r.read_bit()) - m


def _zeta_write(w: BitWriter, x: int, k: int) -> None:
    if x < 1:
        raise ValueError("zeta codes positive integers only")
    h = (x.bit_length() - 1) // k
    w.write_unary(h)
    lo = 1 << (h * k)
    hi = 1 << ((h + 1) * k)
    _minimal_binary_write(w, x - lo, hi - lo)


def _zeta_read(r: BitReader, k: int) -> int:
    h = r.read_unary()
    lo = 1 << (h * k)
    hi = 1 << ((h + 1) * k)
    return lo + _minimal_binary_read(r, hi - lo)


@register("zeta")
class ZetaCodec(Codec):
    name = "zeta"
    supports_zero = False

    def __init__(self, k: int = 3) -> None:
        if k < 1:
            raise ValueError("zeta shard size k must be >= 1")
        self.k = k

    def encode_doc(self, components: np.ndarray) -> bytes:
        gaps = gaps_from_components(components)
        w = BitWriter()
        for g in gaps:
            _zeta_write(w, int(g) + 1, self.k)
        return w.getvalue()

    def decode_doc(self, buf: bytes, n: int) -> np.ndarray:
        r = BitReader(buf)
        gaps = np.fromiter(
            (_zeta_read(r, self.k) - 1 for _ in range(n)), dtype=np.uint32, count=n
        )
        return components_from_gaps(gaps)

    def doc_bytes(self, components, offsets):
        gaps, doc, _, nnz = csr_gaps(components, offsets)
        x = gaps.astype(np.int64) + 1
        h = (bit_length(x) - 1) // self.k
        lo = np.left_shift(np.int64(1), h * self.k)
        z = np.left_shift(np.int64(1), (h + 1) * self.k) - lo  # the interval's size
        s = bit_length(z) - 1
        m = np.left_shift(np.int64(1), s + 1) - z  # short (s-bit) codewords
        bits = (h + 1) + s + (x - lo >= m)
        bits = np.bincount(doc, weights=bits, minlength=len(nnz)).astype(np.int64)
        return (bits + 7) // 8
