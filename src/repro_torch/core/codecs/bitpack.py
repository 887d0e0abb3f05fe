"""bitpack — fixed-width (Frame-of-Reference) packing, a copy of
``repro/core/codecs/bitpack.py``.

Each block of ``block`` gaps is packed at the block's max bit-width b,
LSB-first into u32 words; decode is a shift and a mask with no
data-dependent offsets. Per-document layout (``encode_doc``)::

    [ widths: u8 per block ][ words: u32 LE, ceil(block*b/32) per block ]

The row layout (``core/layout.py``) packs each document row at its own
width with the same :func:`pack_block`.
"""

from __future__ import annotations

import numpy as np

from .base import Codec, components_from_gaps, csr_gaps, gaps_from_components, register

__all__ = ["BitpackCodec", "pack_block", "unpack_block", "bit_widths"]


def bit_widths(gaps: np.ndarray) -> np.ndarray:
    """``int.bit_length`` of each u32 gap (0 for a zero gap), vectorised:
    the binary exponent of the gap as an f64, exact below 2**53."""
    return np.frexp(np.asarray(gaps, dtype=np.uint64).astype(np.float64))[1].astype(np.int64)


def _width(gaps: np.ndarray) -> int:
    m = int(gaps.max(initial=0))
    return max(int(m).bit_length(), 1)


def pack_block(gaps: np.ndarray, width: int) -> np.ndarray:
    """Pack len(gaps) values at ``width`` bits into u32 words (LSB-first)."""
    g = np.asarray(gaps, dtype=np.uint64)
    n = len(g)
    n_words = (n * width + 31) // 32
    bitpos = np.arange(n, dtype=np.int64) * width
    words = np.zeros(n_words, dtype=np.uint64)
    wi = bitpos // 32
    off = (bitpos % 32).astype(np.uint64)
    lo = (g << off) & 0xFFFFFFFF
    # values can straddle a word boundary (width <= 32 → at most two words)
    np.add.at(words, wi, lo)
    straddle = (off + width) > 32
    np.add.at(words, wi[straddle] + 1, (g[straddle] >> (np.uint64(32) - off[straddle])))
    return words.astype(np.uint32)


def unpack_block(words: np.ndarray, width: int, n: int) -> np.ndarray:
    w = np.concatenate([words.astype(np.uint64), np.zeros(1, dtype=np.uint64)])
    bitpos = np.arange(n, dtype=np.int64) * width
    wi = bitpos // 32
    off = (bitpos % 32).astype(np.uint64)
    mask = np.uint64((1 << width) - 1)
    lo = w[wi] >> off
    hi = np.where(off > 0, w[wi + 1] << (np.uint64(32) - off), 0)
    return ((lo | hi) & mask).astype(np.uint32)


@register("bitpack")
class BitpackCodec(Codec):
    name = "bitpack"

    def __init__(self, block: int = 32) -> None:
        if block % 32:
            raise ValueError("block must be a multiple of 32 for aligned words")
        self.block = block

    def encode_doc(self, components: np.ndarray) -> bytes:
        gaps = gaps_from_components(components)
        n = len(gaps)
        n_blocks = (n + self.block - 1) // self.block
        widths = bytearray()
        words = []
        for b in range(n_blocks):
            blk = gaps[b * self.block : (b + 1) * self.block]
            pad = self.block - len(blk)
            if pad:
                blk = np.concatenate([blk, np.zeros(pad, dtype=blk.dtype)])
            w = _width(blk)
            widths.append(w)
            words.append(pack_block(blk, w))
        body = np.concatenate(words).astype("<u4").tobytes() if words else b""
        return bytes(widths) + body

    def decode_doc(self, buf: bytes, n: int) -> np.ndarray:
        n_blocks = (n + self.block - 1) // self.block
        widths = np.frombuffer(buf[:n_blocks], dtype=np.uint8)
        words = np.frombuffer(buf[n_blocks:], dtype="<u4")
        gaps = np.zeros(n_blocks * self.block, dtype=np.uint32)
        pos = 0
        for b in range(n_blocks):
            w = int(widths[b])
            n_words = (self.block * w + 31) // 32
            gaps[b * self.block : (b + 1) * self.block] = unpack_block(
                words[pos : pos + n_words], w, self.block
            )
            pos += n_words
        return components_from_gaps(gaps[:n])

    def doc_bytes(self, components, offsets):
        """Per block: one width byte + ceil(block·w/32) words, w the
        block's max gap width (at least 1; padding gaps are 0)."""
        gaps, doc, pos, nnz = csr_gaps(components, offsets)
        n_blocks = (nnz + self.block - 1) // self.block
        first = np.concatenate([[0], np.cumsum(n_blocks)[:-1]])
        width = np.ones(int(n_blocks.sum()), dtype=np.int64)
        np.maximum.at(width, first[doc] + pos // self.block, bit_widths(gaps))
        per_block = 1 + 4 * ((self.block * width + 31) // 32)
        return np.bincount(
            np.repeat(np.arange(len(nnz)), n_blocks), weights=per_block, minlength=len(nnz)
        ).astype(np.int64)
