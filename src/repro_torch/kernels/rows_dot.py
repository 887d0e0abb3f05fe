"""The rows kernel: fused candidate-row gather + DotVByte decode +
rescore, hand-written in CUDA C++ for Hopper (``csrc/rows_dot.cu``).

Replaces the Pallas TPU kernel ``repro/kernels/rows_dot.py::
rows_scores_batch`` (body ``_kernel``, ``pl.pallas_call`` at
``rows_dot.py:190``) for codec dotvbyte, vq f16 — the kernel every
serve engine's candidate rescoring runs. For each candidate id it
gathers the row, decodes the gaps, prefix-sums them to components,
gathers ``Q[:, comps]`` and takes the masked dot with ``vals · scale``.

``docs`` is ``[nd, C]`` with ``nd ∈ {1, nq}``: one candidate set shared
by the query batch (flat; each row decoded once, scored for every
query) or one set per query (Seismic). The work is bound by bytes; see
the source for the design and PERF.md for its time on the card.

:func:`rows_scores` runs the kernel on CUDA tensors and its plain torch
version (:func:`rows_scores_plain`) on CPU tensors; a CUDA call that
cannot build or launch the kernel raises. ``launches`` counts kernel
launches, so a run can show its main path went through the kernel.
"""

from __future__ import annotations

import ctypes

import torch

from . import build

__all__ = [
    "rows_scores",
    "rows_scores_plain",
    "rows_scores_for_codec",
    "MAX_ROW_CAPACITY",
    "launches",
]

#: kernel launches made by :func:`rows_scores` (CUDA tensors only)
launches = 0

#: one thread per control byte, at most 1024 threads a block
MAX_ROW_CAPACITY = 8 * 1024

#: rows_dot_dotvbyte_f16(7 pointers, nq, dim, nd, C, n_rows, L, ctrl_w,
#: data_w, scale, stream)
_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 8 + [ctypes.c_float, ctypes.c_void_p]


def rows_scores_plain(Q, docs, vals_rows, nnz_rows, ctrl_rows, data_rows, scale=1.0):
    """The kernel's plain torch version (same contract, any device)."""
    from ..core.scoring import score_rows_plain

    arrays = {
        "vals_rows": vals_rows,
        "nnz_rows": nnz_rows,
        "ctrl_rows": ctrl_rows,
        "data_rows": data_rows,
    }
    return score_rows_plain("dotvbyte", arrays, docs, Q, float(scale))


def rows_scores(Q, docs, vals_rows, nnz_rows, ctrl_rows, data_rows, scale=1.0):
    """Scores f32 ``[nq, C]`` of candidate rows ``docs`` (i32 ``[nd, C]``,
    ``nd ∈ {1, nq}``) against ``Q`` (f32 ``[nq, dim]``).

    Row streams as ``layout.pack_rows(codec="dotvbyte")`` lays them out:
    ``vals_rows`` f16 ``[N+1, L]``, ``nnz_rows`` i32 ``[N+1]``,
    ``ctrl_rows`` u8 ``[N+1, ≥L/8]``, ``data_rows`` u8 ``[N+1, DP]``.
    Candidate ids must lie in ``[0, N]`` (N is the all-zero sentinel)."""
    tensors = (Q, docs, vals_rows, nnz_rows, ctrl_rows, data_rows)
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"rows_scores inputs span devices {sorted(map(str, devices))}")
    if Q.device.type == "cpu":
        return rows_scores_plain(*tensors, scale)
    if Q.device.type != "cuda":
        raise ValueError(f"rows_scores runs on cuda or cpu tensors, got {Q.device}")
    _check(*tensors)
    return _launch(*tensors, float(scale))


def rows_scores_for_codec(codec: str, arrays, Q, docs, scale):
    """``rows_scores`` over an engine array dict; raises for the codecs
    and value codecs without a CUDA rows kernel yet."""
    from ..core import values as value_codecs

    if codec != "dotvbyte":
        raise NotImplementedError(
            f"no CUDA rows kernel for codec {codec!r} yet (ROADMAP queue "
            f"B2-B4); use backend='torch'"
        )
    value_codecs.infer_rows_vq(arrays)
    return rows_scores(
        Q, docs, arrays["vals_rows"], arrays["nnz_rows"],
        arrays["ctrl_rows"], arrays["data_rows"], scale,
    )


def _check(Q, docs, vals_rows, nnz_rows, ctrl_rows, data_rows):
    want = {
        "Q": (Q, torch.float32, 2),
        "docs": (docs, torch.int32, 2),
        "vals_rows": (vals_rows, torch.float16, 2),
        "nnz_rows": (nnz_rows, torch.int32, 1),
        "ctrl_rows": (ctrl_rows, torch.uint8, 2),
        "data_rows": (data_rows, torch.uint8, 2),
    }
    for name, (t, dtype, ndim) in want.items():
        if t.dtype != dtype or t.dim() != ndim:
            raise ValueError(
                f"{name} must be {ndim}-D {dtype}, got {t.dim()}-D {t.dtype}"
            )
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    nq, (nd, C) = Q.shape[0], docs.shape
    R, L = vals_rows.shape
    if nd not in (1, nq) or nd > 65535:
        raise ValueError(f"docs has {nd} candidate sets; need 1 or nq={nq} (≤ 65535)")
    if L % 8 or not 0 < L <= MAX_ROW_CAPACITY:
        raise ValueError(
            f"row capacity {L} must be a positive multiple of 8, at most "
            f"{MAX_ROW_CAPACITY}"
        )
    if nnz_rows.shape[0] != R or ctrl_rows.shape[0] != R or data_rows.shape[0] != R:
        raise ValueError("row streams disagree on the row count")
    if ctrl_rows.shape[1] < L // 8:
        raise ValueError(f"ctrl_rows is {ctrl_rows.shape[1]} wide; need ≥ {L // 8}")
    if max(*Q.shape, C, R, ctrl_rows.shape[1], data_rows.shape[1]) >= 2**31:
        raise ValueError("a dimension exceeds the kernel's 32-bit sizes")


def _launch(Q, docs, vals_rows, nnz_rows, ctrl_rows, data_rows, scale):
    global launches
    lib = build.load("rows_dot")
    fn = lib.rows_dot_dotvbyte_f16
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    nq, dim = Q.shape
    nd, C = docs.shape
    R, L = vals_rows.shape
    out = torch.empty((nq, C), dtype=torch.float32, device=Q.device)
    if nq == 0 or C == 0:
        return out
    with torch.cuda.device(Q.device):
        stream = torch.cuda.current_stream(Q.device).cuda_stream
        rc = fn(
            Q.data_ptr(), docs.data_ptr(), vals_rows.data_ptr(),
            nnz_rows.data_ptr(), ctrl_rows.data_ptr(), data_rows.data_ptr(),
            out.data_ptr(), nq, dim, nd, C, R, L, ctrl_rows.shape[1],
            data_rows.shape[1], scale, stream,
        )
    if rc != 0:
        err = lib.rows_dot_error_string
        err.argtypes, err.restype = [ctypes.c_int], ctypes.c_char_p
        raise RuntimeError(
            f"rows_dot kernel launch failed: CUDA error {rc} "
            f"({err(rc).decode()})"
        )
    launches += 1
    return out
