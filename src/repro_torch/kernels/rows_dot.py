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
queries, scored for every query of it) or one set per query (Seismic,
and the hnsw engine's seeds and neighbours). Three scoring stages,
picked by :func:`pick_stage` from the shapes: the per-query form takes
row warps (one thread block an SM holding a set's query row in shared
memory, a half-warp per candidate row, vector loads) where the row fits
(:func:`row_warps_fit`) and the sets hold :data:`ROW_WARPS_MIN_ROWS`
rows or more in all; the shared form takes lanes
across queries over the transposed batch ``Qᵀ [dim, nq]`` from
:data:`QUERY_LANES_MIN_NQ` queries on; everything else takes entry
lanes (a thread block per candidate row and a block reduction per
query). Every stage sums a (query, row) dot in one order — products
rounded alone, groups of 8 entries left to right, the balanced pairwise
tree over the groups (``csrc/gaps.cuh``) — so a score is the same bits
whichever stage the batch's shape picks, and an answer does not depend
on the batch it rode in. See the source for the design and PERF.md for
its time on the card.

:func:`rows_scores_for_codec` runs the kernel on CUDA tensors and its
plain torch version (:func:`rows_scores_plain`) on CPU tensors; a CUDA
call that cannot build or launch the kernel raises. :func:`rows_scorer`
checks the row streams and the queries once for a loop of calls over
one batch. ``launches`` counts
kernel launches in total, ``variant_launches`` per variant (keyed
:func:`variant_name`) and ``stage_launches`` per scoring stage, so a
run can show its main path went through each kernel and stage. A
launch made while the stream captures a CUDA graph counts in
``captured_variant_launches`` and ``captured_stage_launches`` instead:
the kernel runs at each replay, and the plan that captured it records
how many it holds (``serve/pipeline.py::SearchPlan.launches``).
"""

from __future__ import annotations

import contextlib
import ctypes

import torch

from ..core import values as value_codecs
from . import build

__all__ = [
    "CODECS",
    "MAX_ROW_CAPACITY",
    "QUERY_LANES_MIN_NQ",
    "ROW_WARPS_MIN_ROWS",
    "STAGES",
    "VARIANTS",
    "launches",
    "variant_launches",
    "stage_launches",
    "captured_variant_launches",
    "captured_stage_launches",
    "variant_name",
    "pick_stage",
    "row_warps_fit",
    "reset_launches",
    "rows_scores_for_codec",
    "rows_scorer",
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
STAGES = ("entry_lanes", "query_lanes", "row_warps")

#: the batch size from which the shared form (``nd = 1``) scores with
#: lanes across queries over ``Qᵀ``; from the stage sweep of
#: ``chip_smoke.py`` (PERF.md): on an H100 entry lanes win up to 6
#: queries, query lanes from 8 on.
QUERY_LANES_MIN_NQ = 8

#: the fewest candidate rows in all (``nd · C``) from which the per-query
#: form takes row warps. Each row-warp block stages a set's whole query row
#: in shared memory for its share of the ``nd · ⌈C/8⌉`` tasks, so what
#: repays the staging is the task count, not the set size. From the stage
#: sweep of ``chip_smoke.py`` (PERF.md; one set per query, dotvbyte f16, an
#: H100, µs entry lanes against row warps): at nq 64 entry lanes won up to
#: nd·C 65,536 (68 against 73) and row warps from 131,072 (129 against 104);
#: at nq 8 the same (60 against 64; 119 against 97); at nq 1 entry lanes
#: won up to 16,384 (17 against 19; Seismic's one-query 4,096: 7.5 against
#: 16.5) and row warps from 65,536 (57 against 44). At 65,536 the rule
#: loses 7% at nq 64 and 6% at nq 8, where the other side would lose 30% at
#: nq 1.
ROW_WARPS_MIN_ROWS = 1 << 16

#: floats of the PQ codebook, which a row-warp block keeps beside the
#: query row in shared memory
_PQ_FLOATS = value_codecs.PQ_K * value_codecs.PQ_M

#: kernel launches made by :func:`rows_scores_for_codec` (CUDA tensors only)
launches = 0
#: the same, per variant
variant_launches = {variant_name(c, v): 0 for c, v in VARIANTS}
#: launches per scoring stage
stage_launches = {name: 0 for name in STAGES}
#: the same two counts for launches recorded into a CUDA graph being
#: captured (``serve/pipeline.py``): such a kernel runs at each replay of
#: the graph, not at the call, so the counts above leave it out
captured_variant_launches = {variant_name(c, v): 0 for c, v in VARIANTS}
captured_stage_launches = {name: 0 for name in STAGES}

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
    for counts in (variant_launches, stage_launches, captured_variant_launches,
                   captured_stage_launches):
        for k in counts:
            counts[k] = 0


def row_warps_fit(dim: int) -> bool:
    """Whether the row-warp stage takes queries of ``dim`` components: a
    query row (rounded up to 16 bytes) and the PQ codebook within
    ``build.SMEM_OPTIN_BYTES``, so up to ~57,500 components (the SPLADE
    vocabulary of 30,522 takes 119 KB)."""
    return 4 * ((dim + 3) // 4 * 4 + _PQ_FLOATS) <= build.SMEM_OPTIN_BYTES


def pick_stage(nq: int, nd: int, stage: str | None = None, *, dim: int, C: int) -> str:
    """The scoring stage for ``nq`` queries of ``dim`` components over
    ``nd`` candidate sets of ``C`` rows. Without a ``stage``: the shared
    form (``nd = 1``) takes query lanes from :data:`QUERY_LANES_MIN_NQ`
    queries on; one candidate set per query (``nd = nq``, one query and
    one set included) takes row warps where :func:`row_warps_fit` and the
    sets hold at least :data:`ROW_WARPS_MIN_ROWS` rows in all; every other
    shape takes entry lanes. A given ``stage`` is checked against the same
    rules, but for the set size: query lanes take the shared form only,
    row warps one set per query with a query row that fits."""
    warps = nd == nq and row_warps_fit(dim)
    if stage is None:
        if nd == 1 and nq >= QUERY_LANES_MIN_NQ:
            return "query_lanes"
        return "row_warps" if warps and nd * C >= ROW_WARPS_MIN_ROWS else "entry_lanes"
    if stage not in STAGES:
        raise ValueError(f"unknown scoring stage {stage!r}; have {list(STAGES)}")
    if stage == "query_lanes" and nd != 1:
        raise ValueError(f"query lanes score one shared candidate set (nd = 1), got nd = {nd}")
    if stage == "row_warps" and not warps:
        raise ValueError(f"row warps score one candidate set per query whose {dim} floats fit "
                         f"in shared memory; got nq = {nq} over nd = {nd}")
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
    return rows_scorer(codec, arrays, Q, scale, stage)(docs)


def rows_scorer(codec: str, arrays, Q, scale=1.0, stage: str | None = None):
    """``docs → rows_scores_for_codec(codec, arrays, Q, docs, scale,
    stage)`` with the row streams and ``Q`` checked once: how a loop of
    launches over one query batch (the ``hnsw`` engine's steps) keeps
    the checks out of every step. Each call checks only its ``docs``."""
    if codec not in _PAYLOAD:
        raise ValueError(f"no rows kernel for codec {codec!r}; have {list(CODECS)}")
    vq = value_codecs.infer_rows_vq(arrays)
    names, _ = _PAYLOAD[codec]
    tensors = [Q, arrays["vals_rows"], arrays["nnz_rows"]]
    tensors += [arrays[k] for k in names] + value_codecs.rows_vq_streams(vq, arrays)
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"rows_scores inputs span devices {sorted(map(str, devices))}")
    if Q.device.type == "cpu":
        def plain(docs):
            _check_docs(Q, docs)
            return rows_scores_plain(codec, arrays, Q, docs, scale)

        return plain
    if Q.device.type != "cuda":
        raise ValueError(f"rows_scores runs on cuda or cpu tensors, got {Q.device}")
    streams = _check(codec, vq, arrays, Q)
    nq, dim = Q.shape

    def launch(docs):
        _check_docs(Q, docs)
        nd, C = docs.shape
        return _launch(codec, vq, Q, docs, streams, float(scale),
                       pick_stage(nq, nd, stage, dim=dim, C=C))

    return launch


def _check_docs(Q, docs):
    """Validate one call's candidate ids against the query batch."""
    if docs.device != Q.device:
        devices = sorted({str(Q.device), str(docs.device)})
        raise ValueError(f"rows_scores inputs span devices {devices}")
    if docs.dtype != torch.int32 or docs.dim() != 2:
        raise ValueError(f"docs must be 2-D {torch.int32}, got {docs.dim()}-D {docs.dtype}")
    if not docs.is_contiguous():
        raise ValueError("docs must be contiguous")
    nq, (nd, C) = Q.shape[0], docs.shape
    if nd not in (1, nq) or nd > 65535:
        raise ValueError(f"docs has {nd} candidate sets; need 1 or nq={nq} (≤ 65535)")
    if C >= 2**31:
        raise ValueError("a dimension exceeds the kernel's 32-bit sizes")


def _check(codec, vq, arrays, Q):
    """Validate the row streams' dtypes, shapes and contiguity, and Q's →
    the kernel's operands (vals, nnz, p0, p1, v0, v1; absent ones None)
    and the logical L."""
    names, dtypes = _PAYLOAD[codec]
    vals = arrays["vals_rows"]
    if vq == "f16" and vals.dtype not in VALUE_DTYPES:
        raise ValueError(f"vals_rows must be one of {VALUE_DTYPES} under vq f16, got {vals.dtype}")
    vals_dtype = vals.dtype if vq == "f16" else torch.uint8
    want = {"Q": (Q, torch.float32, 2), "vals_rows": (vals, vals_dtype, 2),
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
    R, W = arrays["vals_rows"].shape
    L = W * value_codecs.code_factor(vq)
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
    if max(*Q.shape, R, *(t.shape[-1] for t in payload)) >= 2**31:
        raise ValueError("a dimension exceeds the kernel's 32-bit sizes")
    p0, p1 = (payload + [None])[:2]
    v0, v1 = (vq_streams + [None, None])[:2]
    return arrays["vals_rows"], arrays["nnz_rows"], p0, p1, v0, v1, L


def _launch(codec, vq, Q, docs, streams, scale, stage):
    global launches
    vals, nnz, p0, p1, v0, v1, L = streams
    lib = build.load("rows_dot")
    fn = lib.rows_dot
    if fn.argtypes is None:  # the library's function object is kept; typed once
        fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    nq, dim = Q.shape
    nd, C = docs.shape
    out = torch.empty((nq, C), dtype=torch.float32, device=Q.device)
    if nq == 0 or C == 0:
        return out
    q_arg = Q.t().contiguous() if stage == "query_lanes" else Q
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    width = lambda t: 0 if t is None or t.dim() < 2 else t.shape[1]  # noqa: E731
    same = Q.device.index == torch.cuda.current_device()  # the hnsw steps' case: no switch
    with contextlib.nullcontext() if same else torch.cuda.device(Q.device):
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
    if torch.cuda.is_current_stream_capturing():
        captured_variant_launches[variant_name(codec, vq)] += 1
        captured_stage_launches[stage] += 1
    else:
        launches += 1
        variant_launches[variant_name(codec, vq)] += 1
        stage_launches[stage] += 1
    return out
