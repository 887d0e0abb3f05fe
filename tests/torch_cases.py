"""Shared inputs of the port's tests (``tests/test_torch_*.py``)."""

import numpy as np
import pytest
import torch

@pytest.fixture(scope="module", autouse=True)
def one_intra_op_thread():
    """One torch intra-op thread per test process for the module that
    imports this fixture: a parallel run's workers share the cores, and
    at the default count each worker's small torch ops spun on every
    core (a 3 s hnsw test took 95 s in a 6-worker run). The previous
    count is restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


#: positions in :func:`edge_docs`' output
EMPTY, FULL, ONE_BYTE, TWO_BYTE, EMPTY2 = range(5)

#: every row codec × value codec the rows kernel serves
CODECS = ("uncompressed", "dotvbyte", "streamvbyte", "bitpack")
VQS = ("f16", "u8_sq", "u4_sq", "pq")
VARIANTS = [(c, v) for c in CODECS for v in VQS]


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


def wide_docs(dim, rng, n_random=12):
    """Documents over a vocabulary wider than 2**16 (StreamVByte codes 2
    and, past 2**24, 3; bitpack widths above 16): one whose gaps take
    every byte length the vocabulary allows, one of width-5 gaps that
    straddle u32 words, then random docs. DotVByte cannot encode them."""
    comps = np.cumsum([0, 7, 300, 70_000, 1 << 24])
    comps = comps[comps < dim]
    docs = [(comps, rng.gamma(2, .5, len(comps))),
            (np.arange(0, 31 * 37, 31), rng.gamma(2, .5, 37))]
    for n in rng.integers(1, 120, size=n_random):
        docs.append((np.sort(rng.choice(dim, size=int(n), replace=False)),
                     rng.gamma(2, .5, int(n))))
    return docs


def candidates(n_docs, rng, shape):
    """Random candidate ids in [0, N] (N = the sentinel row), each set
    led by the sentinel, both empty rows, the full row and the 1-byte row."""
    docs = rng.integers(0, n_docs + 1, size=shape).astype(np.int32)
    docs[:, :5] = [n_docs, EMPTY, EMPTY2, FULL, ONE_BYTE]
    return docs


def reference_top_k(scores, k, n_valid):
    """(values, int64 ids) of the first ``k`` of each row of ``scores``
    with the columns ``>= n_valid`` set to ``-inf``, in the order
    ``jax.lax.top_k`` gives them, but with ``-0.0`` tied to ``+0.0``: a
    stable descending sort, then every NaN whose sign bit is set moved,
    in column order, below ``-inf``. Plain torch, on either device."""
    cols = torch.arange(scores.shape[-1], device=scores.device)
    masked = scores.masked_fill(cols >= n_valid, float("-inf"))
    neg_nan = torch.isnan(masked) & (masked.view(torch.int32) < 0)
    _, order = torch.sort(masked.masked_fill(neg_nan, float("-inf")), dim=-1, descending=True,
                          stable=True)
    _, last = torch.sort(neg_nan.gather(-1, order).to(torch.uint8), dim=-1, stable=True)
    idx = order.gather(-1, last)[..., :k]
    return masked.gather(-1, idx), idx
