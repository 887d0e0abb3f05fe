"""Candidate-row rescoring — the row half of ``repro/core/scoring.py``,
written in torch.

Every serve engine spends its rescoring time here: gather the packed
rows (``layout.pack_rows``) of the candidate documents, decode their
component ids, and take the exact inner product with the query. Where
the reference ran one query under ``vmap``, these functions carry the
query batch as a leading axis:

* ``score_candidate_rows`` — one candidate set per query,
  ``docs [nq, C]`` (Seismic);
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

import torch

from ..kernels import modes
from . import values as value_codecs
from .layout import get_layout

__all__ = [
    "decode_gaps_dotvbyte",
    "decode_gaps_streamvbyte",
    "decode_gaps_bitpack",
    "decode_doc_rows",
    "score_doc_rows",
    "score_candidate_rows",
    "score_candidate_rows_batch",
]

#: row-form fields every codec shares; every other ``*_rows`` field of a
#: ``pack_rows`` output is codec payload
_ROW_COMMON_KEYS = ("vals_rows", "nnz_rows", "comps_rows")

#: elements of one [nq, C, L] product tensor the plain path materialises
#: at a time (bounds its working set at a flat engine's full scan)
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


def _score_rows(codec, arrays, docs, Q, scale, backend):
    modes.check_backend(backend)
    if backend == "torch":
        return score_rows_plain(codec, arrays, docs, Q, scale)
    from ..kernels import rows_dot

    return rows_dot.rows_scores_for_codec(codec, arrays, Q, docs, scale)


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
    if docs.dim() != 2 or docs.shape[0] != Q.shape[0]:
        raise ValueError(
            f"docs must be [nq, C] with nq={Q.shape[0]}, got {tuple(docs.shape)}"
        )
    return _score_rows(codec, arrays, docs, Q, scale, backend)


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
    return _score_rows(codec, arrays, docs.unsqueeze(0), Q, scale, backend)
