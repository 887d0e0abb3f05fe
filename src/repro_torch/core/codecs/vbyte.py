"""VByte (Thiel & Heaps, 1972) — a copy of ``repro/core/codecs/vbyte.py``.

Each gap x is stored in L+1 bytes b_0..b_L; the MSB of b_i is a
continuation flag (1 = more bytes follow), and ``x = sum_i (b_i mod 128)
* 128**i`` (little-endian 7-bit groups).
"""

from __future__ import annotations

import numpy as np

from .base import Codec, components_from_gaps, csr_gaps, gaps_from_components, register
from .bitio import bit_length

__all__ = ["VByteCodec", "encode_gaps", "decode_gaps"]


def encode_gaps(gaps: np.ndarray) -> bytes:
    out = bytearray()
    for g in np.asarray(gaps, dtype=np.uint64):
        g = int(g)
        while True:
            byte = g & 0x7F
            g >>= 7
            if g:
                out.append(byte | 0x80)
            else:
                out.append(byte)
                break
    return bytes(out)


def decode_gaps(buf: bytes, n: int) -> np.ndarray:
    """Vectorised numpy decode of n varints from buf."""
    raw = np.frombuffer(buf, dtype=np.uint8)
    cont = (raw & 0x80) != 0
    payload = (raw & 0x7F).astype(np.uint64)
    ends = np.flatnonzero(~cont)  # bytes whose continuation bit is clear
    if len(ends) < n:
        raise ValueError("buffer truncated")
    ends = ends[:n]
    starts = np.concatenate([[0], ends[:-1] + 1])
    values = np.zeros(n, dtype=np.uint64)
    owner = np.zeros(len(raw), dtype=np.int64)
    owner[starts] = 1
    owner = np.cumsum(owner) - 1  # varint id per byte
    valid = owner < n
    idx = np.arange(len(raw), dtype=np.int64)
    within = idx - starts[np.clip(owner, 0, n - 1)]
    contrib = payload << (7 * within.astype(np.uint64))
    np.add.at(values, owner[valid], contrib[valid])
    return values.astype(np.uint32)


@register("vbyte")
class VByteCodec(Codec):
    name = "vbyte"
    supports_zero = True

    def encode_doc(self, components: np.ndarray) -> bytes:
        return encode_gaps(gaps_from_components(components))

    def decode_doc(self, buf: bytes, n: int) -> np.ndarray:
        return components_from_gaps(decode_gaps(buf, n))

    def doc_bytes(self, components, offsets):
        gaps, doc, _, nnz = csr_gaps(components, offsets)
        per_gap = np.maximum((bit_length(gaps) + 6) // 7, 1)  # 7 payload bits a byte
        return np.bincount(doc, weights=per_gap, minlength=len(nnz)).astype(np.int64)
