"""Forward-index components codecs (paper §2), with the reference's
registry (``repro/core/codecs/__init__.py``). The four the serve
engines' row layouts use:

* ``uncompressed`` — raw u16, the paper's baseline (16 bits/component)
* ``streamvbyte``  — Lemire et al., 2-bit controls, 4 values/control
* ``dotvbyte``     — the paper's codec: 1-bit controls, 8 values/control
* ``bitpack``      — fixed-width block packing

and the rest of the paper's Table 1 space comparison, which no engine
serves:

* ``vbyte``        — Thiel & Heaps byte-aligned varint
* ``elias_gamma`` / ``elias_delta`` — Elias universal codes
* ``zeta``         — Boldi-Vigna zeta_k (k = 3)
* ``dotnibble``    — the paper's future work: {4, 8, 12, 16}-bit codes

``ForwardIndex.storage_bytes`` reports the paper's space metric through
any of them."""

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
from .dotnibble import DotNibbleCodec
from .dotvbyte import DotVByteCodec, control_bits
from .elias import EliasDeltaCodec, EliasGammaCodec
from .streamvbyte import StreamVByteCodec
from .vbyte import VByteCodec
from .zeta import ZetaCodec


@register("uncompressed")
class UncompressedCodec(Codec):
    """Raw u16 components — the paper's 16-bits-per-component baseline."""

    name = "uncompressed"
    supports_zero = True

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
    "VByteCodec",
    "EliasGammaCodec",
    "EliasDeltaCodec",
    "ZetaCodec",
    "StreamVByteCodec",
    "DotVByteCodec",
    "DotNibbleCodec",
    "BitpackCodec",
]
