"""Forward-index components codecs (paper §2) — the four the serve
engines' row layouts use, with the reference's registry
(``repro/core/codecs/__init__.py``):

* ``uncompressed`` — raw u16, the paper's baseline (16 bits/component)
* ``streamvbyte``  — Lemire et al., 2-bit controls, 4 values/control
* ``dotvbyte``     — the paper's codec: 1-bit controls, 8 values/control
* ``bitpack``      — fixed-width block packing

``ForwardIndex.storage_bytes`` reports the paper's space metric through
them. The reference's survey-only codecs (``vbyte``, ``elias_gamma``,
``elias_delta``, ``zeta``, ``dotnibble``) serve no engine and are not
ported yet (ROADMAP)."""

import numpy as np

from .base import (
    Codec,
    available_codecs,
    components_from_gaps,
    csr_gaps,
    gaps_from_components,
    get_codec,
    register,
)
from .bitpack import BitpackCodec
from .dotvbyte import DotVByteCodec, control_bits
from .streamvbyte import StreamVByteCodec


@register("uncompressed")
class UncompressedCodec(Codec):
    """Raw u16 components — the paper's 16-bits-per-component baseline."""

    name = "uncompressed"

    def encode_doc(self, components: np.ndarray) -> bytes:
        c = np.asarray(components, dtype=np.uint32)
        if np.any(c > 0xFFFF):
            raise ValueError("uncompressed codec stores 16-bit components")
        return c.astype("<u2").tobytes()

    def decode_doc(self, buf: bytes, n: int) -> np.ndarray:
        return np.frombuffer(buf, dtype="<u2", count=n).astype(np.uint32)

    def doc_bytes(self, components, offsets):
        if np.any(np.asarray(components) > 0xFFFF):
            raise ValueError("uncompressed codec stores 16-bit components")
        return 2 * np.diff(offsets).astype(np.int64)


__all__ = [
    "Codec",
    "available_codecs",
    "components_from_gaps",
    "csr_gaps",
    "gaps_from_components",
    "get_codec",
    "register",
    "control_bits",
    "UncompressedCodec",
    "StreamVByteCodec",
    "DotVByteCodec",
    "BitpackCodec",
]
