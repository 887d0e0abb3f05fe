"""Top-k selection along the rows of a score matrix: the port's stable-sort
:func:`top_k` (``jax.lax.top_k``'s tie rule) and a kernel hand-written in
CUDA C++ for Hopper (``csrc/topk_select.cu``).

The kernel replaces no Pallas kernel: it is the counterpart of the
``jax.lax.top_k`` that the reference's flat engine leaves to XLA, which the
port ran as a full stable descending sort (:func:`top_k`). The flat engine
calls it under ``backend="cuda"`` for ``k`` up to :data:`MAX_K`
(``serve/engines/flat.py``).

:func:`select_topk` returns exactly the first ``k`` entries of
``torch.sort(masked, dim=-1, descending=True, stable=True)``, ``masked``
being ``scores`` with the columns ``>= n_valid`` set to ``-inf``: the
lower index first on ties, ``-0.0`` equal to ``+0.0``. A NaN comes first,
and last (below ``-inf``) where its sign bit is set, as ``jax.lax.top_k``
orders them (whose total order also puts ``+0.0`` above ``-0.0``), and
as the card's sort does; the CPU's sort puts that NaN first. On CPU
tensors it runs the plain version (:func:`masked_top_k`, that mask and
:func:`top_k`); on CUDA tensors it launches the kernel (two passes: each
of ``S`` chunks of a row keeps its ``k`` largest, then one block a row
merges them; :func:`chunks` asks the source for ``S``) or raises. See the
source for the design.

``launches`` counts kernel launches; a launch made while the stream
captures a CUDA graph counts in ``captured_launches`` instead (it runs
at each replay of the graph). Every launch also counts in
``spans.counters["topk.selects"]``.
"""

from __future__ import annotations

import contextlib
import ctypes

import torch

from ..spans import count
from . import build

__all__ = ["MAX_K", "launches", "captured_launches", "reset_launches", "check_k", "top_k",
           "chunks", "masked_top_k", "select_topk"]

#: the largest k the kernel takes (its buckets 16, 32, 64, 128, 256; a
#: larger k fails the source's own check of its ``kMaxK``)
MAX_K = 256

#: kernel launches made by :func:`select_topk` (CUDA tensors only)
launches = 0
#: the same for launches recorded into a CUDA graph being captured
captured_launches = 0

#: topk_select(scores, nq, n_cols, k, n_valid, S, part, values, idx, stream)
_ARGTYPES = [ctypes.c_void_p] + [ctypes.c_int] * 5 + [ctypes.c_void_p] * 4


def reset_launches() -> None:
    """Set both launch counts to 0."""
    global launches, captured_launches
    launches = captured_launches = 0


def check_k(k: int, shape) -> None:
    """A ``k`` larger than the last axis of ``shape`` raises ``ValueError``,
    as it does in ``jax.lax.top_k`` (C1)."""
    if k > shape[-1]:
        raise ValueError(
            f"k argument to top_k must be no larger than size along axis; got k={k} "
            f"with shape={list(shape)} and axis={len(shape) - 1}"
        )


def top_k(scores: torch.Tensor, k: int):
    """(values, indices) of the ``k`` largest entries along the last
    axis, ties broken toward the lower index as ``jax.lax.top_k`` does
    (a stable descending sort; ``torch.topk`` promises no tie order).
    A ``k`` larger than the axis raises ``ValueError``, as it does there."""
    check_k(k, scores.shape)
    vals, idx = torch.sort(scores, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def chunks(nq: int, n_cols: int, k: int, device) -> int:
    """Pass 1's chunks a row, ``S``, on the CUDA ``device``: the source's
    rule (``topk_select_chunks``) for the device's SM count."""
    fn = _fn("topk_select_chunks", [ctypes.c_int] * 4)
    return fn(nq, n_cols, k, torch.cuda.get_device_properties(device).multi_processor_count)


def masked_top_k(scores: torch.Tensor, k: int, n_valid: int):
    """The plain version: columns ``>= n_valid`` set to ``-inf``, then
    :func:`top_k` (a stable descending sort; int64 indices)."""
    cols = torch.arange(scores.shape[-1], dtype=torch.int32, device=scores.device)
    return top_k(scores.masked_fill(cols.unsqueeze(0) >= n_valid, float("-inf")), k)


def select_topk(scores: torch.Tensor, k: int, n_valid: int):
    """(values f32 ``[nq, k]``, indices i32 ``[nq, k]``) of the ``k``
    largest entries of each row of ``scores`` (f32 ``[nq, n_cols]``,
    contiguous), the columns ``>= n_valid`` read as ``-inf``, in the
    stable sort's order (NaNs as the module's note says). A ``k`` past the
    axis raises :func:`top_k`'s ``ValueError``."""
    n_valid = int(n_valid)
    _check(scores, k, n_valid)
    if scores.device.type == "cpu":
        values, idx = masked_top_k(scores, k, n_valid)
        return values, idx.to(torch.int32)
    if scores.device.type != "cuda":
        raise ValueError(f"select_topk runs on cuda or cpu tensors, got {scores.device}")
    return _launch(scores, k, n_valid)


def _check(scores, k, n_valid):
    if scores.dtype != torch.float32 or scores.dim() != 2:
        raise ValueError(f"scores must be 2-D {torch.float32}, got {scores.dim()}-D "
                         f"{scores.dtype}")
    if not scores.is_contiguous():
        raise ValueError("scores must be contiguous")
    n_cols = scores.shape[1]
    check_k(k, scores.shape)
    if not 1 <= k <= MAX_K:
        raise ValueError(f"k must lie in [1, {MAX_K}], got {k}")
    if not 0 <= n_valid <= n_cols:
        raise ValueError(f"n_valid must lie in [0, {n_cols}], got {n_valid}")
    if n_cols >= 2**31:
        raise ValueError("a row exceeds the kernel's 32-bit column indices")


def _fn(name, argtypes):
    """The library's function ``name``, typed on first use (ctypes keeps
    the function object)."""
    fn = getattr(build.load("topk_select"), name)
    if fn.argtypes is None:
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
    return fn


def _launch(scores, k, n_valid):
    global launches, captured_launches
    fn = _fn("topk_select", _ARGTYPES)
    nq, n_cols = scores.shape
    dev = scores.device
    values = torch.empty((nq, k), dtype=torch.float32, device=dev)
    idx = torch.empty((nq, k), dtype=torch.int32, device=dev)
    if nq == 0:
        return values, idx
    S = chunks(nq, n_cols, k, dev)
    part = torch.empty((nq, S, k), dtype=torch.int64, device=dev)
    same = dev.index == torch.cuda.current_device()
    with contextlib.nullcontext() if same else torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(scores.data_ptr(), nq, n_cols, k, n_valid, S, part.data_ptr(),
                values.data_ptr(), idx.data_ptr(), stream)
    if rc != 0:
        err = build.load("topk_select").topk_select_error_string
        err.argtypes, err.restype = [ctypes.c_int], ctypes.c_char_p
        raise RuntimeError(f"topk_select kernel launch failed (nq {nq}, n_cols {n_cols}, k {k}): "
                           f"CUDA error {rc} ({err(rc).decode()})")
    if torch.cuda.is_current_stream_capturing():
        captured_launches += 1
    else:
        launches += 1
    count("topk.selects")
    return values, idx
