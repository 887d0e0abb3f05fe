"""Value codecs (``vq``) — the quantization axis orthogonal to the id
codec, as in ``repro/core/values.py``.

The port carries only ``vq="f16"``: values ride as the raw storage
dtype in ``vals_rows``. The quantized codecs (``u8_sq``, ``u4_sq``,
``pq``) are named so that artifacts and configs that use them fail
with a clear ``NotImplementedError`` instead of mis-decoding; porting
them is ROADMAP queue A2 (and their in-kernel dequant, queue B5).
"""

from __future__ import annotations

from typing import Mapping

import numpy as np

__all__ = [
    "VALUE_CODECS",
    "PORTED_VALUE_CODECS",
    "check_vq",
    "code_factor",
    "infer_rows_vq",
    "encode_rows_values",
]

#: value codecs the reference registers (RetrieverConfig.vq names)
VALUE_CODECS = ("f16", "u8_sq", "u4_sq", "pq")

#: the subset this port serves
PORTED_VALUE_CODECS = ("f16",)


def check_vq(vq: str) -> str:
    """``vq`` if the port serves it; ValueError for an unknown name,
    NotImplementedError for a reference codec not yet ported."""
    if vq not in VALUE_CODECS:
        raise ValueError(f"unknown value codec {vq!r}; have {list(VALUE_CODECS)}")
    if vq not in PORTED_VALUE_CODECS:
        raise NotImplementedError(
            f"value codec {vq!r} is not ported yet (ROADMAP queue A2); "
            f"the port serves {list(PORTED_VALUE_CODECS)}"
        )
    return vq


def code_factor(vq: str) -> int:
    """Logical values per stored value column (1 for f16)."""
    check_vq(vq)
    return 1


def infer_rows_vq(arrays: Mapping) -> str:
    """Which value codec a packed rows dict carries, from its payload
    keys (the reference's rule), checked against what the port serves."""
    if "vq_codebook" in arrays:
        vq = "pq"
    elif "vq_lo4_rows" in arrays:
        vq = "u4_sq"
    elif "vq_lo_rows" in arrays:
        vq = "u8_sq"
    else:
        vq = "f16"
    return check_vq(vq)


def encode_rows_values(
    vals_rows: np.ndarray, nnz_rows: np.ndarray, vq: str
) -> tuple[np.ndarray, dict]:
    """Packed row values → (stored values, extra payload). f16 is the
    pass-through: the storage-dtype matrix is stored as is."""
    check_vq(vq)
    return vals_rows, {}
