"""DotVByte — the paper's codec (§2.2): one control *bit* per gap
(0 → 1 data byte, 1 → 2 little-endian bytes), so one control byte
governs eight gaps. Gaps must fit 16 bits.

Only the host-side control-bit rule lives here (a copy of
``repro/core/codecs/dotvbyte.py::control_bits``); the row streams are
laid out by ``core/layout.py`` and decoded by ``core/scoring.py`` and
the CUDA rows kernel (``kernels/csrc/rows_dot.cu``)."""

from __future__ import annotations

import numpy as np

__all__ = ["control_bits"]


def control_bits(gaps: np.ndarray) -> np.ndarray:
    """1 iff the gap needs two bytes. Gaps must fit 16 bits."""
    g = np.asarray(gaps, dtype=np.uint64)
    if np.any(g > 0xFFFF):
        raise ValueError("DotVByte requires 16-bit gaps (d <= 65536)")
    return (g > 0xFF).astype(np.uint8)
