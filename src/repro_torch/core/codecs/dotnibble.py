"""DotNibble — the paper's future-work direction (§4, sub-byte codes in
DotVByte) — a copy of ``repro/core/codecs/dotnibble.py``.

A 2-bit control per value selects a {4, 8, 12, 16}-bit code; one control
byte covers four values (value i of a quad in bits 2i..2i+1); the data
is a nibble stream, least significant nibble first within each byte;
per-document alignment: groups of 4 are coded, the ≤ 3 remaining
components are stored raw u16. A document's bytes are its controls, its
packed nibbles, then its remainder.
"""

from __future__ import annotations

import numpy as np

from .base import Codec, components_from_gaps, csr_gaps, gaps_from_components, register

__all__ = ["DotNibbleCodec", "encode_doc_arrays", "decode_doc_arrays"]

_WIDTH_BITS = (4, 8, 12, 16)  # code 0..3 → bits


def _codes_for(gaps: np.ndarray) -> np.ndarray:
    g = np.asarray(gaps, dtype=np.uint64)
    if np.any(g > 0xFFFF):
        raise ValueError("DotNibble requires 16-bit gaps (d <= 65536)")
    codes = np.zeros(len(g), dtype=np.uint8)
    codes[g > 0xF] = 1
    codes[g > 0xFF] = 2
    codes[g > 0xFFF] = 3
    return codes


def encode_doc_arrays(components: np.ndarray):
    """-> (controls u8[n4/4], nibbles u8[ceil(total_nibbles/2)],
    remainder u16[<4]). Nibble stream is LSN-first within each byte."""
    c = np.asarray(components, dtype=np.uint32)
    n = len(c)
    n4 = (n // 4) * 4
    gaps = gaps_from_components(c)[:n4].astype(np.uint64)
    codes = _codes_for(gaps)
    ctrl = np.zeros(n4 // 4, dtype=np.uint8)
    for lane in range(4):
        ctrl |= (codes[lane::4] & 0x3) << (2 * lane)
    nib_len = codes.astype(np.int64) + 1
    starts = np.concatenate([[0], np.cumsum(nib_len)[:-1]]) if n4 else np.zeros(0, np.int64)
    total = int(nib_len.sum()) if n4 else 0
    nibbles = np.zeros(total, dtype=np.uint8)
    for k in range(4):  # k-th nibble of each value (LS nibble first)
        take = nib_len > k
        nibbles[starts[take] + k] = ((gaps[take] >> (4 * k)) & 0xF).astype(np.uint8)
    if total % 2:
        nibbles = np.concatenate([nibbles, np.zeros(1, np.uint8)])
    packed = (nibbles[0::2] | (nibbles[1::2] << 4)).astype(np.uint8)
    rem = c[n4:].astype(np.uint16)
    return ctrl, packed, rem


def decode_doc_arrays(ctrl: np.ndarray, packed: np.ndarray, rem: np.ndarray, n4: int):
    """Vectorised reference decode → absolute components (uint32)."""
    if n4:
        lanes = np.arange(n4)
        codes = (ctrl[lanes // 4] >> (2 * (lanes % 4))) & 0x3
        nib_len = codes.astype(np.int64) + 1
        starts = np.concatenate([[0], np.cumsum(nib_len)[:-1]])
        nibbles = np.zeros(2 * len(packed) + 4, dtype=np.uint32)  # over-read margin
        nibbles[0 : 2 * len(packed) : 2] = packed & 0xF
        nibbles[1 : 2 * len(packed) : 2] = packed >> 4
        gaps = np.zeros(n4, dtype=np.uint32)
        for k in range(4):
            take = nib_len > k
            gaps[take] |= nibbles[starts[take] + k] << (4 * k)
        comps = components_from_gaps(gaps)
    else:
        comps = np.zeros(0, dtype=np.uint32)
    return np.concatenate([comps, np.asarray(rem, dtype=np.uint32)])


@register("dotnibble")
class DotNibbleCodec(Codec):
    name = "dotnibble"
    supports_zero = True

    def encode_doc(self, components: np.ndarray) -> bytes:
        ctrl, packed, rem = encode_doc_arrays(components)
        return ctrl.tobytes() + packed.tobytes() + rem.astype("<u2").tobytes()

    def decode_doc(self, buf: bytes, n: int) -> np.ndarray:
        n4 = (n // 4) * 4
        n_ctrl = n4 // 4
        raw = np.frombuffer(buf, dtype=np.uint8)
        ctrl = raw[:n_ctrl]
        if n4:
            lanes = np.arange(n4)
            codes = (ctrl[lanes // 4] >> (2 * (lanes % 4))) & 0x3
            total_nib = int((codes.astype(np.int64) + 1).sum())
            n_packed = (total_nib + 1) // 2
        else:
            n_packed = 0
        packed = raw[n_ctrl : n_ctrl + n_packed]
        rem = raw[n_ctrl + n_packed :].view("<u2")[: n - n4]
        return decode_doc_arrays(ctrl, packed, rem, n4)

    def doc_bytes(self, components, offsets):
        gaps, doc, pos, nnz = csr_gaps(components, offsets)
        n4 = (nnz // 4) * 4
        coded = pos < n4[doc]  # the gaps of whole quads (raises past 16 bits, as encoding)
        nib = np.bincount(doc[coded], weights=_codes_for(gaps[coded]).astype(np.int64) + 1,
                          minlength=len(nnz)).astype(np.int64)
        return n4 // 4 + (nib + 1) // 2 + 2 * (nnz - n4)
