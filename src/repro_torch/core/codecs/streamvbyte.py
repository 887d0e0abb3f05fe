"""StreamVByte (Lemire, Kurz & Rupp, 2018) — a copy of
``repro/core/codecs/streamvbyte.py``.

A 2-bit control per value records its byte length minus one (1..4
bytes, little-endian); four values share one control byte (value i of
a quad in bits 2i..2i+1); the control stream precedes the data stream.
The row layout (``core/layout.py``) and the CUDA rows kernel decode the
same format with a prefix sum of the lengths.
"""

from __future__ import annotations

import numpy as np

from .base import Codec, components_from_gaps, csr_gaps, gaps_from_components, register

__all__ = ["StreamVByteCodec", "byte_codes", "encode_gaps", "decode_gaps", "split_streams"]


def byte_codes(gaps: np.ndarray) -> np.ndarray:
    """Each gap's 2-bit code: its little-endian byte length minus one."""
    g = np.asarray(gaps, dtype=np.uint64)
    codes = np.zeros(g.shape, dtype=np.uint8)
    codes[g > 0xFF] = 1
    codes[g > 0xFFFF] = 2
    codes[g > 0xFFFFFF] = 3
    return codes


def encode_gaps(gaps: np.ndarray) -> bytes:
    """-> control stream ++ data stream (lengths derivable from n)."""
    g = np.asarray(gaps, dtype=np.uint64)
    n = len(g)
    codes = byte_codes(g)
    lens = codes.astype(np.int64) + 1
    ctrl = np.zeros((n + 3) // 4, dtype=np.uint8)
    np.bitwise_or.at(ctrl, np.arange(n) // 4, codes << (2 * (np.arange(n) % 4)).astype(np.uint8))
    le = g.astype("<u8").view(np.uint8).reshape(n, 8)
    data = le[np.arange(8)[None, :] < lens[:, None]]
    return ctrl.tobytes() + data.tobytes()


def split_streams(buf: bytes, n: int) -> tuple[np.ndarray, np.ndarray]:
    n_ctrl = (n + 3) // 4
    raw = np.frombuffer(buf, dtype=np.uint8)
    return raw[:n_ctrl].copy(), raw[n_ctrl:].copy()


def decode_gaps(buf: bytes, n: int) -> np.ndarray:
    """Vectorised numpy decode."""
    if n == 0:
        return np.zeros(0, dtype=np.uint32)
    ctrl, data = split_streams(buf, n)
    quads = np.arange(n)
    codes = (ctrl[quads // 4] >> (2 * (quads % 4))) & 0x3
    lens = codes.astype(np.int64) + 1
    starts = np.concatenate([[0], np.cumsum(lens)[:-1]])
    data_pad = np.concatenate([data, np.zeros(4, dtype=np.uint8)]).astype(np.uint64)
    vals = np.zeros(n, dtype=np.uint64)
    for b in range(4):
        take = lens > b
        vals[take] += data_pad[starts[take] + b] << np.uint64(8 * b)
    return vals.astype(np.uint32)


@register("streamvbyte")
class StreamVByteCodec(Codec):
    name = "streamvbyte"

    def encode_doc(self, components: np.ndarray) -> bytes:
        return encode_gaps(gaps_from_components(components))

    def decode_doc(self, buf: bytes, n: int) -> np.ndarray:
        return components_from_gaps(decode_gaps(buf, n))

    def doc_bytes(self, components, offsets):
        gaps, doc, _, nnz = csr_gaps(components, offsets)
        data = np.bincount(doc, weights=byte_codes(gaps) + 1.0, minlength=len(nnz))
        return (nnz + 3) // 4 + data.astype(np.int64)
