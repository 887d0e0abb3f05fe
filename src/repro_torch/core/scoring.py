"""Scoring over the packed forward index, written in torch: the port of
``repro/core/scoring.py`` (its jnp paths).

**Full scan (block form).** ``score_packed{,_batch}`` take the inner
product of every document with a query through ``PackedBlocks``
(``layout.pack_blocks``): decode each block's gaps, rebase them per
fragment to absolute components (``components_from_gaps``), gather the
query, multiply by the dequantized values and segment-sum per document
(``combine_block_scores``). Every codec (uncompressed included) and
every value codec; it reaches no kernel, as the reference's
``score_packed`` reaches none. The tile program the block kernels run
(per-slot prefix-sum differences, ``block_slot_scores``, then
``scatter_block_scores``) is ``kernels/block_scan.py``. The prefix sum
of a block's gaps runs across all of its fragments and can pass 2**31
at wide vocabularies, where the reference's int32 wraps; here it is
int64.

**The doc-aligned scan.** ``make_doc_aligned_scan`` is the full scan
over a mesh: each rank holds one contiguous range of documents and the
blocks that hold them (``layout.pack_blocks_sharded``, range-local doc
ids), scans it through the block-scan entries of ``kernels/ops.py`` and
returns its ``[nq, docs_local]`` slice, with no collective.

**Candidate-row rescoring.**

Every serve engine spends its rescoring time here: gather the packed
rows (``layout.pack_rows``) of the candidate documents, decode their
component ids, and take the exact inner product with the query. Where
the reference ran one query under ``vmap``, these functions carry the
query batch as a leading axis:

* ``score_candidate_rows`` — one candidate set per query,
  ``docs [nq, C]`` (Seismic); ``candidate_rows_scorer`` is the same
  for a loop of calls over one query batch, its streams checked once
  (the hnsw engine's steps);
* ``score_candidate_rows_batch`` — one candidate set shared by the
  batch, ``docs [C]``, decoded once (flat).

Every row codec of ``core/layout.py`` decodes here, under every value
codec (``core/values.py``). ``backend="torch"`` runs the plain path
below on the tensors' own device; ``backend="cuda"`` goes to the
hand-written rows kernel (``kernels/rows_dot.py``), which launches the
(codec, vq) variant on CUDA tensors or raises. Index
tensors stay int32 on the wire and widen to int64 only where torch
indexing needs it. Torch raises on an out-of-range gather where
``jnp.take`` clipped, so callers map every non-document id to the
all-zero sentinel row N themselves.
"""

from __future__ import annotations

import numpy as np
import torch

from ..kernels import modes
from . import values as value_codecs
from .layout import get_layout

__all__ = [
    "dequantise_values",
    "block_values",
    "decode_block_gaps",
    "components_from_gaps",
    "block_products",
    "combine_block_scores",
    "scatter_block_scores",
    "block_slot_scores",
    "score_packed",
    "score_packed_batch",
    "make_doc_aligned_scan",
    "decode_gaps_dotvbyte",
    "decode_gaps_streamvbyte",
    "decode_gaps_bitpack",
    "decode_doc_rows",
    "score_doc_rows",
    "score_candidate_rows",
    "candidate_rows_scorer",
    "score_candidate_rows_batch",
]

#: row-form fields every codec shares; every other ``*_rows`` field of a
#: ``pack_rows`` output is codec payload
_ROW_COMMON_KEYS = ("vals_rows", "nnz_rows", "comps_rows")

#: elements of one [nq, C, L] (rows) or [nq, B, T] (blocks) product
#: tensor the plain paths materialise at a time (bounds their working
#: set at a full scan)
_CHUNK_ELEMS = 1 << 25


def decode_gaps_dotvbyte(ctrl: torch.Tensor, data: torch.Tensor) -> torch.Tensor:
    """DotVByte decode, vectorised: ctrl u8 [..., T/8], data u8 [..., DP]
    (DP ≥ T + popcount + 1) → gaps i32 [..., T].

    Control bits are LSB-first within each byte; a gap's byte offset is
    the exclusive prefix sum of ``bit + 1``; it reads byte ``start`` and,
    masked by its bit, byte ``start + 1`` (the pack keeps one over-read
    byte so that read stays inside the row)."""
    shifts = torch.arange(8, dtype=torch.int32, device=ctrl.device)
    bits = (ctrl.to(torch.int32).unsqueeze(-1) >> shifts) & 1
    bits = bits.flatten(-2)  # [..., T]
    lens = bits + 1
    starts = torch.cumsum(lens, dim=-1) - lens  # int64
    d = data.to(torch.int32)
    lo = torch.gather(d, -1, starts)
    hi = torch.gather(d, -1, starts + 1) * bits
    return (lo + (hi << 8)).to(torch.int32)


def decode_gaps_streamvbyte(ctrl: torch.Tensor, data: torch.Tensor) -> torch.Tensor:
    """StreamVByte decode, vectorised: ctrl u8 [..., T/4] (2-bit codes,
    value i of a quad in bits 2i..2i+1), data u8 [..., DP] (DP ≥ total
    data bytes + 3 over-read) → gaps i32 [..., T].

    A gap's byte offset is the exclusive prefix sum of ``code + 1``; it
    reads bytes ``start .. start + 3``, each masked by the code. The
    bytes are assembled in int64 and the result keeps the low 32 bits,
    as the reference's int32 arithmetic does."""
    shifts = 2 * torch.arange(4, dtype=torch.int32, device=ctrl.device)
    codes = ((ctrl.to(torch.int32).unsqueeze(-1) >> shifts) & 0x3).flatten(-2)
    lens = codes + 1
    starts = torch.cumsum(lens, dim=-1) - lens  # int64
    d = data.to(torch.int64)
    out = torch.gather(d, -1, starts)
    for b in range(1, 4):
        out |= (torch.gather(d, -1, starts + b) * (codes >= b)) << (8 * b)
    return out.to(torch.int32)


def decode_gaps_bitpack(words: torch.Tensor, widths: torch.Tensor, block_size: int) -> torch.Tensor:
    """Fixed-width unpack: words u32 [..., W] (any 32-bit dtype),
    widths i32 [...] → gaps i32 [..., T] with T = ``block_size``.

    Value j sits at bit j·w, LSB-first; a read may straddle into the
    next word (a zero word is appended for the last one). The shifts
    and masks run in int64, so ``1 << 32`` and the u32 words are safe."""
    w = words.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    w = torch.cat([w, torch.zeros_like(w[..., :1])], dim=-1)
    width = widths.to(torch.int64).unsqueeze(-1)  # [..., 1]
    bitpos = torch.arange(block_size, dtype=torch.int64, device=w.device) * width
    wi, off = bitpos // 32, bitpos % 32
    lo = torch.gather(w, -1, wi) >> off
    hi = torch.where(off > 0, torch.gather(w, -1, wi + 1) << (32 - off), 0)
    mask = (1 << width) - 1
    return ((lo | hi) & mask).to(torch.int32)


# ---------------------------------------------------------------------------
# block form [B, T]: the full scan
# ---------------------------------------------------------------------------


def dequantise_values(vals: torch.Tensor, scale: float) -> torch.Tensor:
    return vals.to(torch.float32) * scale


def decode_block_gaps(codec: str, arrays, block_size: int) -> torch.Tensor:
    """Codec-dispatching gap decode over a block pack's streams
    (ctrl/data or words/widths) → gaps i32 [B, T]. The lane-padded
    control streams are sliced tight before the decode."""
    if codec == "dotvbyte":
        return decode_gaps_dotvbyte(arrays["ctrl"][:, : block_size // 8], arrays["data"])
    if codec == "streamvbyte":
        return decode_gaps_streamvbyte(arrays["ctrl"][:, : block_size // 4], arrays["data"])
    if codec == "bitpack":
        return decode_gaps_bitpack(arrays["words"], arrays["widths"], block_size)
    raise ValueError(f"no device decoder for codec {codec!r}")


def components_from_gaps(
    gaps: torch.Tensor, seg: torch.Tensor, start_pos: torch.Tensor, start_abs: torch.Tensor
) -> torch.Tensor:
    """Segmented prefix-sum rebase: gaps (u32 bits) [B, T] → absolute
    components i64 [B, T].

    ``comp[i] = start_abs[s] + t[i] - t[start_pos[s]]`` with ``t`` the
    inclusive cumsum of the gaps and ``s = clamp(seg[i], 0, D - 1)``;
    padding (seg < 0) maps to component 0."""
    seg = seg.long()
    D = start_pos.shape[-1]
    t = torch.cumsum(gaps.long() & 0xFFFFFFFF, dim=-1)
    tp = torch.gather(t, -1, start_pos.long().clamp(0, t.shape[-1] - 1))  # [B, D]
    segc = seg.clamp(0, D - 1)
    base = torch.gather(start_abs.long(), -1, segc)
    tseg = torch.gather(tp, -1, segc)
    return torch.where(seg >= 0, base + t - tseg, 0)


def _gather_query(Q: torch.Tensor, comps: torch.Tensor) -> torch.Tensor:
    """``Q[..., comps]`` for Q [nq, V] and comps [*S] → [nq, *S]; a
    component outside [0, V) gathers 0 (torch indexing would raise)."""
    V = Q.shape[-1]
    valid = (comps >= 0) & (comps < V)
    return torch.where(valid, Q[:, comps.clamp(0, V - 1)], 0.0)


def block_products(q: torch.Tensor, comps, vals_f, seg) -> torch.Tensor:
    """q-gather · values, zeroed on padding: [B, T] f32 (q [V]), or
    [nq, B, T] for a query batch Q [nq, V]."""
    qv = _gather_query(q if q.dim() == 2 else q.unsqueeze(0), comps)
    prod = qv * vals_f * (seg >= 0)
    return prod if q.dim() == 2 else prod[0]


def combine_block_scores(prod, seg, doc_ids, n_docs: int) -> torch.Tensor:
    """Per-element products [..., B, T] → per-document scores
    [..., n_docs] by one global segment sum over each element's doc."""
    seg = seg.long()
    segc = seg.clamp(0, doc_ids.shape[-1] - 1)
    gdoc = torch.gather(doc_ids.long(), -1, segc)
    gdoc = torch.where((seg >= 0) & (gdoc >= 0) & (gdoc < n_docs), gdoc, n_docs)
    return _segment_sum(prod, gdoc, n_docs)


def scatter_block_scores(block_scores, doc_ids, n_docs: int) -> torch.Tensor:
    """[..., B, D] per-slot scores + doc ids [B, D] → [..., n_docs];
    slots whose id is -1 (or outside the corpus) drop."""
    ids = doc_ids.long()
    ids = torch.where((ids >= 0) & (ids < n_docs), ids, n_docs)
    return _segment_sum(block_scores, ids, n_docs)


#: discard buckets of :func:`_segment_sum`: entries that drop are spread
#: over this many, so the card's atomic adds do not all contend for one
#: address (a full scan drops ~93% of its B·D slots: the unused ones)
_DISCARD_BUCKETS = 4096


def _segment_sum(vals: torch.Tensor, ids: torch.Tensor, n_docs: int) -> torch.Tensor:
    """Sum ``vals [..., *S]`` into ``n_docs`` buckets by ``ids [*S]``; an
    id outside [0, n_docs) drops → [..., n_docs]."""
    lead = vals.shape[: vals.dim() - ids.dim()]
    flat = vals.reshape(*lead, -1) if lead else vals.reshape(1, -1)
    ids = ids.reshape(-1)
    spread = torch.arange(ids.numel(), device=ids.device) % _DISCARD_BUCKETS
    ids = torch.where((ids >= 0) & (ids < n_docs), ids, n_docs + spread)
    out = torch.zeros((flat.shape[0], n_docs + _DISCARD_BUCKETS), dtype=torch.float32,
                      device=vals.device)
    out.index_add_(1, ids, flat.to(torch.float32))
    out = out[:, :n_docs]
    return out.reshape(*lead, n_docs) if lead else out[0]


def block_slot_scores(prod: torch.Tensor, start_pos: torch.Tensor) -> torch.Tensor:
    """Per-element products [..., B, T] → per-slot scores [..., B, D].

    Inside a block the slots' fragments are contiguous runs in position
    order, so slot d sums ``[start_pos[d], end_d)`` with ``end_d =
    start_pos[d+1]`` where that is larger, else T: a difference of the
    exclusive prefix sum of the products. Slot 0 is always used and a
    later slot iff ``start_pos[d] > 0``; unused slots score 0."""
    T = prod.shape[-1]
    sp = start_pos.long()
    cz = torch.cat([torch.zeros_like(prod[..., :1]), torch.cumsum(prod, dim=-1)], dim=-1)
    nxt = torch.cat([sp[..., 1:], torch.zeros_like(sp[..., :1])], dim=-1)
    ends = torch.where(nxt > sp, nxt, T).clamp(0, T)
    used = torch.cat([torch.ones_like(sp[..., :1], dtype=torch.bool), sp[..., 1:] > 0], dim=-1)
    lead = prod.shape[:-2]
    ends = ends.expand(*lead, *ends.shape)
    starts = sp.clamp(0, T).expand(*lead, *sp.shape)
    scores = torch.gather(cz, -1, ends) - torch.gather(cz, -1, starts)
    return scores * used


def block_values(vals, scale: float, vq: str = "f16", vq_lo=None, vq_scale=None, vq_cb=None):
    """Block values → scaled f32: the stored dtype under ``vq="f16"``,
    else u8 codes dequantized through ``values.decode_codes`` (per-block
    ``vq_lo``/``vq_scale`` columns, or the PQ codebook)."""
    if vq == "f16":
        return dequantise_values(vals, scale)
    cb = vq_cb.to(torch.float32).reshape(-1) if vq == "pq" else None
    return value_codecs.decode_codes(vq, vals, vq_lo, vq_scale, cb) * scale


def _block_values(packed, blocks: slice) -> torch.Tensor:
    """The pack's values of ``blocks``, dequantized and scaled → f32
    [b, T]."""
    sq = packed.vq in ("u8_sq", "u4_sq")
    return block_values(packed.vals[blocks], float(packed.value_format.scale), packed.vq,
                        packed.vq_lo[blocks] if sq else None,
                        packed.vq_scale[blocks] if sq else None, packed.vq_codebook)


def _block_components(packed, blocks: slice) -> torch.Tensor:
    """Absolute components i64 [b, T] of ``blocks``."""
    if get_layout(packed.codec).decode_free:
        return packed.comps[blocks].long()
    streams = {k: _take_rows(getattr(packed, k), blocks)
               for k in ("ctrl", "data", "words", "widths") if getattr(packed, k) is not None}
    gaps = decode_block_gaps(packed.codec, streams, packed.block_size)
    return components_from_gaps(gaps, packed.seg[blocks], packed.start_pos[blocks],
                                packed.start_abs[blocks])


def _on_tensors(packed, q):
    """(pack, query) as tensors on one device: the pack's own when it
    holds tensors, else the query's (the CPU for a numpy query)."""
    if isinstance(packed.seg, torch.Tensor):
        device = packed.seg.device
    else:
        device = q.device if isinstance(q, torch.Tensor) else torch.device("cpu")
        packed = packed.to(device)
    return packed, torch.as_tensor(q, dtype=torch.float32).to(device)


def score_packed_batch(Q, packed) -> torch.Tensor:
    """Scores of every document for a batch of dense queries
    ``Q [nq, ≥dim]`` → f32 [nq, n_docs], over chunks of blocks that
    bound the working set."""
    packed, Q = _on_tensors(packed, Q)
    Q = Q[:, : packed.dim]
    nq, T = Q.shape[0], packed.block_size
    out = torch.zeros((nq, packed.n_docs), dtype=torch.float32, device=Q.device)
    step = max(1, _CHUNK_ELEMS // max(nq * T, 1))
    for b0 in range(0, packed.n_blocks, step):
        blocks = slice(b0, b0 + step)
        prod = block_products(Q, _block_components(packed, blocks),
                              _block_values(packed, blocks), packed.seg[blocks])
        out += combine_block_scores(prod, packed.seg[blocks], packed.doc_ids[blocks],
                                    packed.n_docs)
    return out


def score_packed(q, packed) -> torch.Tensor:
    """Scores of every document for one dense query → f32 [n_docs]."""
    return score_packed_batch(torch.as_tensor(q).reshape(1, -1), packed)[0]


def make_doc_aligned_scan(mesh, axes, docs_local: int, scale: float, codec: str = "dotvbyte",
                          *, device=None):
    """The doc-aligned sharded scan: ``fn(arrays, Q [nq, dim]) → f32 [nq,
    docs_local]``, this rank's documents' scores.

    ``arrays`` are the stacked ``layout.pack_blocks_sharded`` arrays;
    the rank takes its range (its row-major index over ``axes``, the
    reference's ``P(axes)`` order) and keeps it resident on ``device``
    (``cuda`` unless given) while the same ``arrays`` come back. Its
    pack is scanned through ``kernels/ops.py``'s block-scan entry of
    ``codec`` — the single-query one at nq 1, the batched one above —
    so the score scatter stays on the rank; ``uncompressed``, which has
    no block kernel (as in the reference), runs ``score_packed_batch``.
    The reference's ``shard_map`` assembles ``[nq, S · docs_local]``;
    here each rank returns its slice and the scan carries no
    collective."""
    from .. import resolve_device
    from ..dist.sharding import axis_index
    from .forward_index import PackedBlocks, ValueFormat

    shard = axis_index(mesh, axes)
    device = resolve_device(device)
    placed: list = [None, None, None]  # arrays, dim, the rank's pack on the device

    def tensor(a) -> torch.Tensor:
        a = np.ascontiguousarray(a)
        return torch.from_numpy(a if a.flags.writeable else a.copy()).to(device)

    def scan(arrays, Q):
        Q = torch.as_tensor(Q, dtype=torch.float32).to(device)
        if placed[0] is not arrays or placed[1] != Q.shape[1]:
            local = {k: v[shard] for k, v in arrays.items()}
            vals = local["vals"]
            placed[:] = [arrays, Q.shape[1], PackedBlocks(
                codec=codec, block_size=int(vals.shape[-1]), n_docs=int(docs_local),
                dim=int(Q.shape[1]), value_format=ValueFormat("scaled", vals.dtype, float(scale)),
                **{k: tensor(v) for k, v in local.items()})]
        packed = placed[2]
        if codec == "uncompressed":
            return score_packed_batch(Q, packed)
        from ..kernels import ops

        single, batch = ops.block_scorers(codec)
        return single(Q[0], packed).unsqueeze(0) if Q.shape[0] == 1 else batch(Q, packed)

    return scan


# ---------------------------------------------------------------------------
# row form [N+1, L]: candidate rescoring
# ---------------------------------------------------------------------------


def decode_doc_rows(codec: str, payload, l_max: int | None = None) -> torch.Tensor:
    """Row-payload streams (``<stream>_rows`` → tensor) → absolute
    components i32 [..., L], through the layout registry. Row gaps carry
    the absolute first component, so a cumsum rebuilds the ids."""
    lc = get_layout(codec)
    if lc.decode_free:
        raise ValueError(
            f"codec {codec!r} is decode-free; rows store absolute components"
        )
    streams = {
        (k[: -len("_rows")] if k.endswith("_rows") else k): v
        for k, v in payload.items()
    }
    gaps = lc.decode(streams, 0 if l_max is None else int(l_max))
    return torch.cumsum(gaps, dim=-1, dtype=torch.int32)


def _take_rows(t: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``t[idx]``; u32 streams are gathered as their int32 bits (not
    every device indexes uint32 tensors)."""
    if t.dtype == torch.uint32:
        return t.view(torch.int32)[idx]
    return t[idx]


def _gather_decode_rows(codec: str, arrays, docs: torch.Tensor):
    """Gather + decode the packed rows of ``docs`` (any shape) →
    (comps i32 [*docs, L], vals [*docs, L], nnz [*docs]).

    The value codec is inferred from the payload keys: f16 values stay
    in their storage dtype; quantized rows gather their u8 codes with
    the per-row clip columns (or take the codebook whole) and
    dequantize through ``values.decode_codes`` to f32, so the logical
    row width ``L`` is the stored width × ``code_factor(vq)``."""
    vq = value_codecs.infer_rows_vq(arrays)
    idx = docs.long()
    vals = arrays["vals_rows"][idx]
    nnz = arrays["nnz_rows"][idx]
    if vq != "f16":
        streams = value_codecs.rows_vq_streams(vq, arrays)
        if vq == "pq":
            vals = value_codecs.decode_codes(vq, vals, codebook_flat=streams[0])
        else:
            lo, step = (s[idx] for s in streams)
            vals = value_codecs.decode_codes(vq, vals, lo, step)
    if get_layout(codec).decode_free:
        return arrays["comps_rows"][idx], vals, nnz
    payload = {
        k: _take_rows(arrays[k], idx)
        for k in arrays
        if k.endswith("_rows") and k not in _ROW_COMMON_KEYS and not k.startswith("vq_")
    }
    return decode_doc_rows(codec, payload, l_max=vals.shape[-1]), vals, nnz


def score_doc_rows(
    Q: torch.Tensor,  # f32 [nq, V]
    comps_rows: torch.Tensor,  # i32 [nd, C, L], nd ∈ {1, nq}
    vals_rows: torch.Tensor,  # [nd, C, L] storage dtype or dequantized f32
    nnz: torch.Tensor,  # i32 [nd, C]
    scale: float,
) -> torch.Tensor:
    """Exact ⟨q, doc⟩ of gathered candidate rows → f32 [nq, C]. A set
    axis of 1 is shared by every query."""
    L = comps_rows.shape[-1]
    mask = torch.arange(L, device=nnz.device) < nnz.unsqueeze(-1)
    q_idx = torch.arange(Q.shape[0], device=Q.device).view(-1, 1, 1)
    qv = Q[q_idx, comps_rows.long()]  # [nq, C, L]
    vals = vals_rows.to(torch.float32) * scale
    return (qv * vals * mask).sum(dim=-1)


def score_rows_plain(codec: str, arrays, docs: torch.Tensor, Q: torch.Tensor, scale: float):
    """The plain torch rescoring: docs i32 [nd, C] (nd ∈ {1, nq}) →
    f32 [nq, C], in candidate chunks that bound the working set."""
    nq, (nd, C) = Q.shape[0], docs.shape
    L = arrays["vals_rows"].shape[1] * value_codecs.code_factor(value_codecs.infer_rows_vq(arrays))
    out = torch.empty((nq, C), dtype=torch.float32, device=Q.device)
    step = max(1, _CHUNK_ELEMS // max(nq * L, 1))
    for c0 in range(0, C, step):
        comps, vals, nnz = _gather_decode_rows(codec, arrays, docs[:, c0 : c0 + step])
        out[:, c0 : c0 + step] = score_doc_rows(Q, comps, vals, nnz, scale)
    return out


def _rows_scorer(codec, arrays, Q, scale, backend):
    modes.check_backend(backend)
    if backend == "torch":
        return lambda docs: score_rows_plain(codec, arrays, docs, Q, scale)
    from ..kernels import rows_dot

    return rows_dot.rows_scorer(codec, arrays, Q, scale)


def candidate_rows_scorer(
    codec: str,
    arrays,
    Q: torch.Tensor,  # f32 [nq, V]
    scale: float,
    backend: str = "torch",
):
    """``docs → score_candidate_rows(codec, arrays, docs, Q, scale,
    backend)`` for one query batch, its row streams and ``Q`` checked
    once: the ``hnsw`` engine rescores a few rows per query in each of
    its steps, so only each step's ``docs`` is checked."""
    score = _rows_scorer(codec, arrays, Q, scale, backend)

    def scorer(docs: torch.Tensor) -> torch.Tensor:
        if docs.dim() != 2 or docs.shape[0] != Q.shape[0]:
            raise ValueError(
                f"docs must be [nq, C] with nq={Q.shape[0]}, got {tuple(docs.shape)}"
            )
        return score(docs)

    return scorer


def score_candidate_rows(
    codec: str,
    arrays,
    docs: torch.Tensor,  # i32 [nq, C]: one candidate set per query
    Q: torch.Tensor,  # f32 [nq, V]
    scale: float,
    backend: str = "torch",
) -> torch.Tensor:
    """Gather the packed rows of each query's candidates and score them
    exactly → f32 [nq, C]. Sentinel ids (row N) score 0; callers mask
    them."""
    return candidate_rows_scorer(codec, arrays, Q, scale, backend)(docs)


def score_candidate_rows_batch(
    codec: str,
    arrays,
    docs: torch.Tensor,  # i32 [C]: one candidate set shared by the batch
    Q: torch.Tensor,  # f32 [nq, V]
    scale: float,
    backend: str = "torch",
) -> torch.Tensor:
    """Rescore ONE candidate set against the whole query batch → f32
    [nq, C]; each candidate row is gathered and decoded once."""
    if docs.dim() != 1:
        raise ValueError(f"docs must be [C], got {tuple(docs.shape)}")
    return _rows_scorer(codec, arrays, Q, scale, backend)(docs.unsqueeze(0))
