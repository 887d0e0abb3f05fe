"""Shared inputs of the port's tests (``tests/test_torch_*.py``)."""

import numpy as np

#: positions in :func:`edge_docs`' output
EMPTY, FULL, ONE_BYTE, TWO_BYTE, EMPTY2 = range(5)


def edge_docs(dim, rng, n_random=40, full=256):
    """(components, values) documents that reach every row case:
    two empty docs, one at full row capacity (``full`` entries), one of
    only 1-byte gaps, one of only 2-byte gaps, then ``n_random`` random
    docs of 1–199 entries."""
    docs = [(np.zeros(0, np.int64), np.zeros(0, np.float32))]
    docs.append((np.sort(rng.choice(dim, size=full, replace=False)), rng.gamma(2, .5, full)))
    docs.append((np.arange(5, 5 + 3 * 40, 3), rng.gamma(2, .5, 40)))
    docs.append((np.arange(300, dim, max(300, dim // 60))[:50], rng.gamma(2, .5, 50)))
    docs.append((np.zeros(0, np.int64), np.zeros(0, np.float32)))
    for n in rng.integers(1, 200, size=n_random):
        docs.append((np.sort(rng.choice(dim, size=int(n), replace=False)),
                     rng.gamma(2, .5, int(n))))
    return docs


def candidates(n_docs, rng, shape):
    """Random candidate ids in [0, N] (N = the sentinel row), each set
    led by the sentinel, both empty rows, the full row and the 1-byte row."""
    docs = rng.integers(0, n_docs + 1, size=shape).astype(np.int32)
    docs[:, :5] = [n_docs, EMPTY, EMPTY2, FULL, ONE_BYTE]
    return docs
