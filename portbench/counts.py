"""The frozen yardstick: the least time a kernel could take on the work a
cell asks for, from the cell's configuration and the benchmark's own
corpus — never from the port's arrays or candidate lists, so a change
of layout leaves it where it is.

A bound is ``max(ops / F32_FLOP_PER_S, bytes / HBM_BYTES_PER_S)``
against the published peaks of one NVIDIA H100 SXM (dense f32 outside
the tensor cores; HBM3), at its 700 W limit; the run records the card's
``power.limit`` beside every share. A multiply-add counts two
operations, as the peak does.

The bytes are the benchmark's own reckoning of DotVByte over the
corpus's d-gaps (a document's first gap is its first component): one
control bit a component and one data byte, or two where the gap is 256
or more, plus the stored value (f16: two bytes). Each query value the
scoring needs (4 bytes a query nonzero) is read once and each output
score (4 bytes) written once.
"""

from __future__ import annotations

import torch

__all__ = ["HBM_BYTES_PER_S", "F32_FLOP_PER_S", "corpus_stats", "bound", "exhaustive_bound"]

#: NVIDIA H100 SXM data sheet: HBM3 bandwidth and dense f32 (non-tensor)
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12

_VALUE_BYTES = {"f16": 2, "f32": 4}


def corpus_stats(comps: torch.Tensor, offsets: torch.Tensor, value_format: str,
                 query_nnz: torch.Tensor) -> dict:
    """Counts of a CSR corpus (``comps`` [nnz], ascending within each
    document; ``offsets`` [n_docs + 1]) and of its query pool
    (``query_nnz`` [pool], each query's nonzeros) → n_docs, nnz, the
    DotVByte bytes of the whole corpus (``dotvbyte_bytes``: control bits,
    data bytes and values, each part kept), and the mean nonzeros of a
    query."""
    n_docs = offsets.shape[0] - 1
    nnz = int(offsets[-1])
    c = comps.to(torch.int64)
    gaps = torch.empty_like(c)
    if nnz:
        gaps[0] = c[0]
        gaps[1:] = c[1:] - c[:-1]
        first = offsets[:-1][offsets[1:] > offsets[:-1]]
        gaps[first] = c[first]  # a document's first gap is its component
    data = nnz + int((gaps >= 256).sum())
    ctrl = nnz / 8
    values = _VALUE_BYTES[value_format] * nnz
    total = ctrl + data + values
    return {
        "n_docs": n_docs,
        "nnz": nnz,
        "ctrl_bytes": ctrl,
        "data_bytes": data,
        "value_bytes": values,
        "dotvbyte_bytes": total,
        "mean_query_nnz": float(query_nnz.to(torch.float64).mean()) if query_nnz.numel() else 0.0,
    }


def bound(ops: float, n_bytes: float) -> float:
    """Least seconds for ``ops`` operations and ``n_bytes`` bytes."""
    return max(ops / F32_FLOP_PER_S, n_bytes / HBM_BYTES_PER_S)


def exhaustive_bound(stats: dict, nq: int) -> float:
    """Every document scored for each of ``nq`` queries, in either layout
    (the block scan, or the flat engine's rows kernel over every row):
    every document's compressed bytes once, the queries' values once, the
    ``nq × n_docs`` f32 scores written once; a multiply-add per (query,
    stored entry)."""
    n_bytes = (stats["dotvbyte_bytes"] + 4 * nq * stats["mean_query_nnz"]
               + 4 * nq * stats["n_docs"])
    return bound(2 * nq * stats["nnz"], n_bytes)
