"""Bit-level I/O for the bit-oriented codecs (Elias gamma/delta, Zeta) —
a copy of ``repro/core/codecs/bitio.py``.

Plain Python/numpy, host-side like every index build. MSB-first bit
order within each byte, as in Elias (1975) and Boldi-Vigna (2005).
"""

from __future__ import annotations

import numpy as np

__all__ = ["BitWriter", "BitReader", "bit_length"]


def bit_length(x) -> np.ndarray:
    """``int.bit_length`` of every element of a non-negative integer array
    (below 2**64) → i64, by integer shifts (no float rounding)."""
    x = np.asarray(x, dtype=np.uint64)
    n = np.zeros(x.shape, dtype=np.int64)
    for s in (32, 16, 8, 4, 2, 1):
        big = x >= np.uint64(1 << s)
        n += big * s
        x = np.where(big, x >> np.uint64(s), x)
    return n + (x > 0)


class BitWriter:
    """Append-only MSB-first bit buffer."""

    def __init__(self) -> None:
        self._bits: list[int] = []

    def __len__(self) -> int:  # number of bits written
        return len(self._bits)

    def write_bit(self, bit: int) -> None:
        self._bits.append(bit & 1)

    def write_bits(self, value: int, width: int) -> None:
        """Write ``width`` low bits of ``value``, MSB first."""
        if width < 0:
            raise ValueError("width must be >= 0")
        for shift in range(width - 1, -1, -1):
            self._bits.append((value >> shift) & 1)

    def write_unary(self, n: int) -> None:
        """n zeros followed by a one (Elias gamma prefix convention)."""
        self._bits.extend([0] * n)
        self._bits.append(1)

    def getvalue(self) -> bytes:
        """Pack to bytes, zero-padded to a byte boundary."""
        bits = np.asarray(self._bits, dtype=np.uint8)
        pad = (-len(bits)) % 8
        if pad:
            bits = np.concatenate([bits, np.zeros(pad, dtype=np.uint8)])
        return np.packbits(bits).tobytes()


class BitReader:
    """MSB-first bit reader over a byte buffer."""

    def __init__(self, buf: bytes | np.ndarray) -> None:
        arr = np.frombuffer(bytes(buf), dtype=np.uint8)
        self._bits = np.unpackbits(arr)
        self._pos = 0

    @property
    def pos(self) -> int:
        return self._pos

    def remaining(self) -> int:
        return len(self._bits) - self._pos

    def read_bit(self) -> int:
        b = int(self._bits[self._pos])
        self._pos += 1
        return b

    def read_bits(self, width: int) -> int:
        if width == 0:
            return 0
        chunk = self._bits[self._pos : self._pos + width]
        self._pos += width
        value = 0
        for b in chunk:
            value = (value << 1) | int(b)
        return value

    def read_unary(self) -> int:
        """Count zeros up to (and consuming) the terminating one."""
        rest = self._bits[self._pos :]
        nz = np.flatnonzero(rest)
        if len(nz) == 0:
            raise EOFError("unary code ran off the end of the buffer")
        n = int(nz[0])
        self._pos += n + 1
        return n
