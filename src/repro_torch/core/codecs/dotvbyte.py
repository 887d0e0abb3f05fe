"""DotVByte — the paper's codec (§2.2), a copy of
``repro/core/codecs/dotvbyte.py``: one control *bit* per gap (0 → 1
data byte, 1 → 2 little-endian bytes), so one control byte governs
eight gaps. Gaps must fit 16 bits.

Per-document alignment (``encode_doc``): only ``n8 = (nnz // 8) * 8``
components are compressed; the ≤7 remaining ones are stored as raw u16
absolute components after the data stream::

    [ controls: n8/8 bytes ][ data: n8 + popcount(controls) bytes ]
    [ remainder: 2 * (nnz - n8) bytes ]

The row streams the serve engines score are laid out by
``core/layout.py`` and decoded by ``core/scoring.py`` and the CUDA rows
kernel (``kernels/csrc/rows_dot.cu``)."""

from __future__ import annotations

import numpy as np

from .base import Codec, components_from_gaps, csr_gaps, gaps_from_components, register

__all__ = ["DotVByteCodec", "encode_doc_arrays", "decode_doc_arrays", "control_bits"]


def control_bits(gaps: np.ndarray) -> np.ndarray:
    """1 iff the gap needs two bytes. Gaps must fit 16 bits."""
    g = np.asarray(gaps, dtype=np.uint64)
    if np.any(g > 0xFFFF):
        raise ValueError("DotVByte requires 16-bit gaps (d <= 65536)")
    return (g > 0xFF).astype(np.uint8)


def encode_doc_arrays(components: np.ndarray) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """-> (controls u8[n8/8], data u8[n8+popcnt], remainder u16[<8]);
    ``remainder`` holds ABSOLUTE component ids."""
    c = np.asarray(components, dtype=np.uint32)
    n = len(c)
    n8 = (n // 8) * 8
    gaps = gaps_from_components(c)[:n8]
    bits = control_bits(gaps)
    ctrl = np.packbits(bits.reshape(-1, 8), axis=1, bitorder="little").reshape(-1)
    lens = bits.astype(np.int64) + 1
    starts = np.concatenate([[0], np.cumsum(lens)[:-1]]) if n8 else np.zeros(0, np.int64)
    data = np.zeros(int(lens.sum()) if n8 else 0, dtype=np.uint8)
    g64 = gaps.astype(np.uint64)
    if n8:
        data[starts] = (g64 & 0xFF).astype(np.uint8)
        two = bits.astype(bool)
        data[starts[two] + 1] = ((g64[two] >> 8) & 0xFF).astype(np.uint8)
    rem = c[n8:].astype(np.uint16)
    return ctrl, data, rem


def decode_doc_arrays(ctrl: np.ndarray, data: np.ndarray, rem: np.ndarray) -> np.ndarray:
    """Vectorised reference decode: controls+data -> absolute components."""
    n8 = len(ctrl) * 8
    if n8:
        bits = np.unpackbits(ctrl, bitorder="little").astype(np.int64)
        lens = bits + 1
        starts = np.concatenate([[0], np.cumsum(lens)[:-1]])
        dpad = np.concatenate([data, np.zeros(1, dtype=np.uint8)]).astype(np.uint32)
        gaps = dpad[starts] + (dpad[starts + 1] << 8) * bits.astype(np.uint32)
        comps = components_from_gaps(gaps)
    else:
        comps = np.zeros(0, dtype=np.uint32)
    return np.concatenate([comps, np.asarray(rem, dtype=np.uint32)])


@register("dotvbyte")
class DotVByteCodec(Codec):
    name = "dotvbyte"

    def encode_doc(self, components: np.ndarray) -> bytes:
        ctrl, data, rem = encode_doc_arrays(components)
        return ctrl.tobytes() + data.tobytes() + rem.astype("<u2").tobytes()

    def decode_doc(self, buf: bytes, n: int) -> np.ndarray:
        n8 = (n // 8) * 8
        n_ctrl = n8 // 8
        raw = np.frombuffer(buf, dtype=np.uint8)
        ctrl = raw[:n_ctrl]
        popcnt = int(np.unpackbits(ctrl).sum()) if n_ctrl else 0
        n_data = n8 + popcnt
        data = raw[n_ctrl : n_ctrl + n_data]
        rem = raw[n_ctrl + n_data :].view("<u2")[: n - n8]
        return decode_doc_arrays(ctrl, data, rem)

    def doc_bytes(self, components, offsets):
        """n8/8 control bytes + (1 + bit) per compressed gap + 2 per
        remainder component."""
        gaps, doc, pos, nnz = csr_gaps(components, offsets)
        n8 = (nnz // 8) * 8
        packed = pos < n8[doc]
        data = np.bincount(doc[packed], weights=control_bits(gaps[packed]) + 1.0,
                           minlength=len(nnz))
        return n8 // 8 + data.astype(np.int64) + 2 * (nnz - n8)
