"""The rows kernel: fused candidate-row gather + decode + dequant +
rescore, hand-written in CUDA C++ for Hopper (``csrc/rows_dot.cu``).

Replaces the Pallas TPU kernel ``repro/kernels/rows_dot.py::
rows_scores_batch`` (body ``_kernel``, ``pl.pallas_call`` at
``rows_dot.py:190``) in all sixteen of its variants: row codec
``uncompressed`` / ``dotvbyte`` / ``streamvbyte`` / ``bitpack`` × value
codec ``f16`` / ``u8_sq`` / ``u4_sq`` / ``pq``, each a template
instantiation of one CUDA kernel. It is the kernel every serve engine's
candidate rescoring runs. For each candidate id it gathers the row,
decodes the gaps, prefix-sums them to components, dequantizes the
values, gathers ``Q[:, comps]`` and takes the masked dot with
``vals · scale``.

Under ``vq="f16"`` the values ride in their storage dtype — the
``ForwardIndex``'s f32, f16 or fixedu8 (u8, scale 1/32) — and the
kernel reads that dtype, as the reference casts whatever is stored.

``docs`` is ``[nd, C]`` with ``nd ∈ {1, nq}``: one candidate set shared
by the query batch (flat; each row decoded once per tile of 128
queries, scored for every query of it) or one set per query (Seismic).
The shared form scores with lanes across queries over the transposed
batch ``Qᵀ [dim, nq]`` from :data:`QUERY_LANES_MIN_NQ` queries on, and
below that, like the per-query form, with lanes across entries and a
block reduction per query. The work is bound by bytes; see the source
for the design and PERF.md for its time on the card.

:func:`rows_scores_for_codec` runs the kernel on CUDA tensors and its
plain torch version (:func:`rows_scores_plain`) on CPU tensors; a CUDA
call that cannot build or launch the kernel raises. ``launches`` counts
kernel launches in total, ``variant_launches`` per variant (keyed
:func:`variant_name`) and ``stage_launches`` per scoring stage, so a
run can show its main path went through each kernel and stage.
"""

from __future__ import annotations

import ctypes

import torch

from ..core import values as value_codecs
from . import build

__all__ = [
    "CODECS",
    "MAX_ROW_CAPACITY",
    "QUERY_LANES_MIN_NQ",
    "STAGES",
    "VARIANTS",
    "launches",
    "variant_launches",
    "stage_launches",
    "variant_name",
    "pick_stage",
    "reset_launches",
    "rows_scores_for_codec",
    "rows_scores_plain",
]

#: row codecs in the kernel's enum order (csrc/rows_dot.cu ``Codec``)
CODECS = ("uncompressed", "dotvbyte", "streamvbyte", "bitpack")

#: one thread per 8 logical entries, at most 1024 threads a block
MAX_ROW_CAPACITY = 8 * 1024


def variant_name(codec: str, vq: str) -> str:
    return f"rows_dot_{codec}_{vq}"


#: every (codec, vq) the kernel is instantiated for
VARIANTS = tuple((c, v) for c in CODECS for v in value_codecs.VALUE_CODECS)

#: scoring stages in the kernel's enum order (csrc/rows_dot.cu ``Stage``)
STAGES = ("entry_lanes", "query_lanes")

#: the batch size from which the shared form (``nd = 1``) scores with
#: lanes across queries over ``Qᵀ``; from the stage sweep of
#: ``chip_smoke.py`` (PERF.md): on an H100 entry lanes win up to 4
#: queries, query lanes from 8 on. The per-query form always uses entry
#: lanes.
QUERY_LANES_MIN_NQ = 8

#: kernel launches made by :func:`rows_scores_for_codec` (CUDA tensors only)
launches = 0
#: the same, per variant
variant_launches = {variant_name(c, v): 0 for c, v in VARIANTS}
#: launches per scoring stage
stage_launches = {name: 0 for name in STAGES}

#: rows_dot(codec, vq, vals_t, stage, 9 pointers, nq, dim, nd, C, n_rows,
#: L, vals_w, p0_w, p1_w, scale, stream)
_ARGTYPES = (
    [ctypes.c_int] * 4 + [ctypes.c_void_p] * 9 + [ctypes.c_int] * 9
    + [ctypes.c_float, ctypes.c_void_p]
)

#: value storage the kernel reads under vq f16, in its enum order
#: (csrc/rows_dot.cu ``Vals``); the quantized vqs store u8 codes
VALUE_DTYPES = (torch.float32, torch.float16, torch.uint8)

#: codec → (payload stream names, their dtypes)
_PAYLOAD = {
    "uncompressed": (("comps_rows",), (torch.int32,)),
    "dotvbyte": (("ctrl_rows", "data_rows"), (torch.uint8, torch.uint8)),
    "streamvbyte": (("ctrl_rows", "data_rows"), (torch.uint8, torch.uint8)),
    "bitpack": (("words_rows", "widths_rows"), (torch.uint32, torch.int32)),
}

#: control bytes per logical entry (streams a thread indexes by t)
_CTRL_PER_ENTRY = {"dotvbyte": 8, "streamvbyte": 4}


def reset_launches() -> None:
    """Set every launch count to 0."""
    global launches
    launches = 0
    for counts in (variant_launches, stage_launches):
        for k in counts:
            counts[k] = 0


def pick_stage(nq: int, nd: int, stage: str | None = None) -> str:
    """The scoring stage for ``nq`` queries over ``nd`` candidate sets:
    ``stage`` if given (query lanes take the shared form only), else
    query lanes for the shared form from :data:`QUERY_LANES_MIN_NQ`
    queries on."""
    if stage is None:
        return "query_lanes" if nd == 1 and nq >= QUERY_LANES_MIN_NQ else "entry_lanes"
    if stage not in STAGES:
        raise ValueError(f"unknown scoring stage {stage!r}; have {list(STAGES)}")
    if stage == "query_lanes" and nd != 1:
        raise ValueError(f"query lanes score one shared candidate set (nd = 1), got nd = {nd}")
    return stage


def rows_scores_plain(codec: str, arrays, Q, docs, scale=1.0):
    """The kernel's plain torch version (same contract, any device)."""
    from ..core.scoring import score_rows_plain

    return score_rows_plain(codec, arrays, docs, Q, float(scale))


def rows_scores_for_codec(codec: str, arrays, Q, docs, scale=1.0, stage: str | None = None):
    """Scores f32 ``[nq, C]`` of candidate rows ``docs`` (i32 ``[nd, C]``,
    ``nd ∈ {1, nq}``) against ``Q`` (f32 ``[nq, dim]``).

    ``arrays`` holds the row streams as ``layout.pack_rows(codec, vq)``
    lays them out (other keys are ignored); the value codec is inferred
    from its keys, and the kernel variant is ``(codec, vq)``. Candidate
    ids must lie in ``[0, N]`` (N is the all-zero sentinel). On the card
    the kernel scores in ``stage`` (default: :func:`pick_stage`)."""
    if codec not in _PAYLOAD:
        raise ValueError(f"no rows kernel for codec {codec!r}; have {list(CODECS)}")
    vq = value_codecs.infer_rows_vq(arrays)
    names, _ = _PAYLOAD[codec]
    tensors = [Q, docs, arrays["vals_rows"], arrays["nnz_rows"]]
    tensors += [arrays[k] for k in names] + value_codecs.rows_vq_streams(vq, arrays)
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"rows_scores inputs span devices {sorted(map(str, devices))}")
    if Q.device.type == "cpu":
        return rows_scores_plain(codec, arrays, Q, docs, scale)
    if Q.device.type != "cuda":
        raise ValueError(f"rows_scores runs on cuda or cpu tensors, got {Q.device}")
    streams = _check(codec, vq, arrays, Q, docs)
    return _launch(codec, vq, Q, docs, streams, float(scale),
                   pick_stage(Q.shape[0], docs.shape[0], stage))


def _check(codec, vq, arrays, Q, docs):
    """Validate dtypes, shapes and contiguity → the kernel's operands
    (vals, nnz, p0, p1, v0, v1; absent ones None) and the logical L."""
    names, dtypes = _PAYLOAD[codec]
    vals = arrays["vals_rows"]
    if vq == "f16" and vals.dtype not in VALUE_DTYPES:
        raise ValueError(f"vals_rows must be one of {VALUE_DTYPES} under vq f16, got {vals.dtype}")
    vals_dtype = vals.dtype if vq == "f16" else torch.uint8
    want = {"Q": (Q, torch.float32, 2), "docs": (docs, torch.int32, 2),
            "vals_rows": (vals, vals_dtype, 2),
            "nnz_rows": (arrays["nnz_rows"], torch.int32, 1)}
    for k, dt in zip(names, dtypes):
        want[k] = (arrays[k], dt, 1 if k == "widths_rows" else 2)
    vq_streams = value_codecs.rows_vq_streams(vq, arrays)
    for i, t in enumerate(vq_streams):
        want[f"vq stream {i}"] = (t, torch.float32, t.dim())
    for name, (t, dtype, ndim) in want.items():
        if t.dtype != dtype or t.dim() != ndim:
            raise ValueError(f"{name} must be {ndim}-D {dtype}, got {t.dim()}-D {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    nq, (nd, C) = Q.shape[0], docs.shape
    R, W = arrays["vals_rows"].shape
    L = W * value_codecs.code_factor(vq)
    if nd not in (1, nq) or nd > 65535:
        raise ValueError(f"docs has {nd} candidate sets; need 1 or nq={nq} (≤ 65535)")
    if L % 8 or not 0 < L <= MAX_ROW_CAPACITY:
        raise ValueError(
            f"row capacity {L} must be a positive multiple of 8, at most {MAX_ROW_CAPACITY}"
        )
    payload = [arrays[k] for k in names]
    if any(t.shape[0] != R for t in [arrays["nnz_rows"], *payload]):
        raise ValueError("row streams disagree on the row count")
    if vq in ("u8_sq", "u4_sq") and any(t.numel() != R for t in vq_streams):
        raise ValueError(f"{vq} clip columns must hold one value per row")
    if vq == "pq" and vq_streams[0].numel() != value_codecs.PQ_K * value_codecs.PQ_M:
        raise ValueError("pq codebook must be [PQ_K, PQ_M]")
    per = _CTRL_PER_ENTRY.get(codec)
    if per and payload[0].shape[1] < L // per:
        raise ValueError(f"ctrl_rows is {payload[0].shape[1]} wide; need ≥ {L // per}")
    if max(*Q.shape, C, R, *(t.shape[-1] for t in payload)) >= 2**31:
        raise ValueError("a dimension exceeds the kernel's 32-bit sizes")
    p0, p1 = (payload + [None])[:2]
    v0, v1 = (vq_streams + [None, None])[:2]
    return arrays["vals_rows"], arrays["nnz_rows"], p0, p1, v0, v1, L


def _launch(codec, vq, Q, docs, streams, scale, stage):
    global launches
    vals, nnz, p0, p1, v0, v1, L = streams
    lib = build.load("rows_dot")
    fn = lib.rows_dot
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    nq, dim = Q.shape
    nd, C = docs.shape
    out = torch.empty((nq, C), dtype=torch.float32, device=Q.device)
    if nq == 0 or C == 0:
        return out
    q_arg = Q.t().contiguous() if stage == "query_lanes" else Q
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    width = lambda t: 0 if t is None or t.dim() < 2 else t.shape[1]  # noqa: E731
    with torch.cuda.device(Q.device):
        stream = torch.cuda.current_stream(Q.device).cuda_stream
        rc = fn(
            CODECS.index(codec), value_codecs.VALUE_CODECS.index(vq),
            VALUE_DTYPES.index(vals.dtype), STAGES.index(stage),
            q_arg.data_ptr(), docs.data_ptr(), vals.data_ptr(), nnz.data_ptr(),
            ptr(p0), ptr(p1), ptr(v0), ptr(v1), out.data_ptr(),
            nq, dim, nd, C, vals.shape[0], L, vals.shape[1], width(p0), width(p1),
            scale, stream,
        )
    if rc != 0:
        err = lib.rows_dot_error_string
        err.argtypes, err.restype = [ctypes.c_int], ctypes.c_char_p
        raise RuntimeError(
            f"rows_dot kernel launch failed ({codec}, {vq}, {stage}): CUDA error {rc} "
            f"({err(rc).decode()})"
        )
    launches += 1
    variant_launches[variant_name(codec, vq)] += 1
    stage_launches[stage] += 1
    return out
