"""d-gap transforms shared by the forward-index codecs (numpy; a copy
of ``repro/core/codecs/base.py``'s helpers).

A document's sorted ``components`` become the gap sequence
``g[0] = c[0]``, ``g[i] = c[i] - c[i-1]`` (paper §2)."""

from __future__ import annotations

import numpy as np

__all__ = ["gaps_from_components", "components_from_gaps"]


def gaps_from_components(components: np.ndarray) -> np.ndarray:
    """d-gap transform; components must be sorted strictly increasing."""
    c = np.asarray(components, dtype=np.int64)
    if c.ndim != 1:
        raise ValueError("components must be 1-D")
    if len(c) == 0:
        return c.astype(np.uint32)
    if np.any(np.diff(c) <= 0):
        raise ValueError("components must be strictly increasing")
    gaps = np.empty_like(c)
    gaps[0] = c[0]
    gaps[1:] = np.diff(c)
    return gaps.astype(np.uint32)


def components_from_gaps(gaps: np.ndarray) -> np.ndarray:
    return np.cumsum(np.asarray(gaps, dtype=np.int64)).astype(np.uint32)
