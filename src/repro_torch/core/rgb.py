"""Recursive Graph Bisection (Dhulipala et al., KDD 2016), paper §2 — the
port's numpy copy of ``repro/core/rgb.py``.

Re-orders *components* to minimise the log-gaps of every document's
component sequence: components are the "data" vertices of a bipartite
graph, documents the "query" vertices. Recursively split the ordering in
half; for ``max_iters`` rounds compute each vertex's move gain from the
degree-based cost model

    B(n, d) = d * log2(n / (d + 1))

sort both halves by gain and swap the top pairs while the pair gain is
positive; recurse until a partition reaches ``leaf_size``.

The permutation is byte-identical to the reference's for the same input,
``max_iters``, ``leaf_size`` and ``seed``: the same numpy operations run
in the same order (the default ``np.argsort`` is not stable, so its ties
must meet the same arrays). Only the gather of a partition's inverted
lists is vectorised; it builds the same arrays the reference's loop
does. Host-side, like every index build.
"""

from __future__ import annotations

import numpy as np

__all__ = ["recursive_graph_bisection", "apply_permutation_dense", "log_gap_cost"]


def _csr_from_docs(doc_comps: list[np.ndarray], dim: int):
    """component → docs inverted CSR from per-doc component arrays."""
    counts = np.zeros(dim, dtype=np.int64)
    for c in doc_comps:
        counts[c] += 1
    indptr = np.zeros(dim + 1, dtype=np.int64)
    np.cumsum(counts, out=indptr[1:])
    docs = np.zeros(int(indptr[-1]), dtype=np.int32)
    cursor = indptr[:-1].copy()
    for d, c in enumerate(doc_comps):
        docs[cursor[c]] = d
        cursor[c] += 1
    return indptr, docs


def _bits(n: int, deg: np.ndarray) -> np.ndarray:
    """Cost model B(n, d) = d * log2(n / (d+1)); deg may be float."""
    d = np.maximum(deg, 0.0)
    return d * np.log2(np.maximum(n, 2) / (d + 1.0))


def log_gap_cost(doc_comps: list[np.ndarray]) -> float:
    """Σ log2(gap+1) over all docs — the quantity RGB minimises (proxy)."""
    total = 0.0
    for c in doc_comps:
        if len(c) == 0:
            continue
        gaps = np.empty(len(c), dtype=np.int64)
        gaps[0] = c[0]
        gaps[1:] = np.diff(np.asarray(c, dtype=np.int64))
        total += float(np.log2(gaps + 1.0).sum())
    return total


def recursive_graph_bisection(
    doc_comps: list[np.ndarray],
    dim: int,
    *,
    max_iters: int = 20,
    leaf_size: int = 32,
    max_depth: int | None = None,
    seed: int = 0,
) -> np.ndarray:
    """Return permutation ``pi`` with new_component_id = pi[old_id].

    Components that never occur keep a stable order at the tail of each
    partition (they cost nothing either way). ``seed`` is accepted as the
    reference accepts it; the algorithm draws no random numbers.
    """
    indptr, adj_docs = _csr_from_docs(doc_comps, dim)
    n_docs = len(doc_comps)
    order = np.arange(dim, dtype=np.int64)  # order[rank] = component id
    if max_depth is None:
        max_depth = max(int(np.ceil(np.log2(max(dim, 2)))), 1)

    degA = np.zeros(n_docs, dtype=np.float64)
    degB = np.zeros(n_docs, dtype=np.float64)

    def vertex_docs(vs: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """Concatenate inverted lists of vertices vs → (docs, owner_idx)."""
        starts = indptr[vs]
        lens = (indptr[vs + 1] - starts).astype(np.int64)
        owner = np.repeat(np.arange(len(vs), dtype=np.int64), lens)
        first = np.cumsum(lens) - lens  # each list's first position in the output
        at = np.arange(int(lens.sum()), dtype=np.int64) - first[owner] + starts[owner]
        return adj_docs[at].astype(np.int32), owner

    def bisect(lo: int, hi: int, depth: int) -> None:
        n = hi - lo
        if n <= leaf_size or depth >= max_depth:
            return
        mid = lo + n // 2
        A = order[lo:mid]
        B = order[mid:hi]
        nA, nB = len(A), len(B)
        docsA, ownerA = vertex_docs(A)
        docsB, ownerB = vertex_docs(B)
        degA.fill(0.0)
        degB.fill(0.0)
        np.add.at(degA, docsA, 1.0)
        np.add.at(degB, docsB, 1.0)

        for _ in range(max_iters):
            # move gains: remove v from its side, add to the other
            curA = _bits(nA, degA) + _bits(nB, degB)
            gainA_per_doc = curA - (_bits(nA, degA - 1) + _bits(nB, degB + 1))
            gainB_per_doc = curA - (_bits(nA, degA + 1) + _bits(nB, degB - 1))
            gA = np.zeros(nA)
            gB = np.zeros(nB)
            np.add.at(gA, ownerA, gainA_per_doc[docsA])
            np.add.at(gB, ownerB, gainB_per_doc[docsB])
            ia = np.argsort(-gA)
            ib = np.argsort(-gB)
            pair_gain = gA[ia] + gB[ib[: len(ia)]] if nA <= nB else gA[ia[: len(ib)]] + gB[ib]
            k = int(np.searchsorted(-pair_gain, 0.0))  # first non-positive
            if k == 0:
                break
            sa, sb = ia[:k], ib[:k]
            # swap vertex sets (A and B are views of `order`)
            A_swap = A[sa].copy()
            A[sa] = B[sb]
            B[sb] = A_swap
            # recompute adjacency slices + degrees for the new split
            docsA, ownerA = vertex_docs(A)
            docsB, ownerB = vertex_docs(B)
            degA.fill(0.0)
            degB.fill(0.0)
            np.add.at(degA, docsA, 1.0)
            np.add.at(degB, docsB, 1.0)

        order[lo:mid] = A
        order[mid:hi] = B
        bisect(lo, mid, depth + 1)
        bisect(mid, hi, depth + 1)

    bisect(0, dim, 0)
    pi = np.empty(dim, dtype=np.uint32)
    pi[order] = np.arange(dim, dtype=np.uint32)  # new id of old component
    return pi


def apply_permutation_dense(q_dense: np.ndarray, pi: np.ndarray) -> np.ndarray:
    """Permute a dense query vector: out[pi[c]] = q[c] (paper §2)."""
    out = np.zeros_like(q_dense)
    out[pi] = q_dense
    return out
