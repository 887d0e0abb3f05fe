"""The full-scan entry points: every document's exact score through the
compressed block form — the port of ``repro/kernels/ops.py``.

``score_{dotvbyte,streamvbyte,bitpack}`` take one dense query and return
f32 ``[n_docs]``; the ``_batch`` forms take ``Q [nq, ≥dim]`` and return
``[nq, n_docs]`` (each block decoded once for the whole batch);
``score_bitpack_bucketed`` runs one static-width scan per distinct
bitpack width over word streams sliced tight to ``⌈T·w/32⌉`` words.
Each runs ``block_scan.scan_scores``: on CUDA tensors the block-scan
kernel in its scatter mode, which adds every used slot's score straight
into the documents' scores (no ``[nq, B, D]`` slot scores, no
``index_add_``); the batched result is a transposed view of the
kernel's doc-major accumulator. On CPU tensors the kernel's plain
version and ``scoring.scatter_block_scores`` (an ``index_add_``) run,
as in the reference. Each scorer is one ``repro_torch.scan`` span
(``spans.py``) over ``scan.prepare`` here and ``scan.check``,
``scan.alloc`` and ``scan.launch`` in ``block_scan``.

The pack (``PackedBlocks``) may hold numpy arrays, which go to
``device`` (``cuda`` unless the caller asks for the CPU), or tensors,
which are used where they lie. On CUDA tensors the kernel launches or
the call raises. The
block kernels read raw stored values only: a pack under a quantized
value codec raises a ``ValueError`` (``scoring.score_packed`` serves
every vq).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .. import resolve_device
from ..spans import span
from . import block_scan

__all__ = [
    "score_dotvbyte",
    "score_dotvbyte_batch",
    "score_streamvbyte",
    "score_streamvbyte_batch",
    "score_bitpack",
    "score_bitpack_batch",
    "score_bitpack_bucketed",
    "Bucket",
    "width_buckets",
    "BLOCK_SCORERS",
    "block_scorers",
]


def _prepare(Q, packed, codec: str, device):
    """(Q [nq, dim] f32 contiguous, the pack as tensors) on one device,
    after checking the pack's codec and value codec."""
    with span("repro_torch.scan.prepare"):
        if packed.codec != codec:
            raise ValueError(f"a {codec} scan got a {packed.codec!r} pack")
        if packed.vq != "f16":
            raise ValueError(
                f"the block-scan kernels read raw stored values; this pack has vq="
                f"{packed.vq!r}. scoring.score_packed serves every vq (the plain path)"
            )
        if isinstance(packed.seg, torch.Tensor):
            dev = packed.seg.device
        else:
            dev = resolve_device(device)
            packed = packed.to(dev)
        Q = torch.as_tensor(Q, dtype=torch.float32).to(dev)
        return Q[:, : packed.dim].contiguous(), packed


def _streams(packed) -> dict:
    """The pack's block streams as ``block_scan`` takes them."""
    keys = ("ctrl", "data") if packed.codec != "bitpack" else ("words", "widths")
    return {k: getattr(packed, k) for k in (*keys, "seg", "start_pos", "start_abs", "vals")}


def _scan(entry, codec, Q, packed, streams=None, doc_ids=None, **kw):
    return block_scan.scan_scores(
        entry, codec, Q, streams or _streams(packed),
        packed.doc_ids if doc_ids is None else doc_ids, packed.n_docs,
        scale=float(packed.value_format.scale), **kw)


def _single(codec):
    def score(q, packed, device=None):
        with span("repro_torch.scan"):
            Q, packed = _prepare(torch.as_tensor(q).reshape(1, -1), packed, codec, device)
            return _scan(f"block_scan_{codec}", codec, Q, packed)[0]

    score.__name__ = f"score_{codec}"
    score.__doc__ = (f"Every document's score for one dense query through the {codec} "
                     f"block-scan kernel: f32 [n_docs].")
    return score


def _batch(codec):
    def score(Q, packed, device=None):
        with span("repro_torch.scan"):
            Q, packed = _prepare(Q, packed, codec, device)
            return _scan(f"block_scan_{codec}_batch", codec, Q, packed)

    score.__name__ = f"score_{codec}_batch"
    score.__doc__ = (f"Every document's score for a query batch through the {codec} "
                     f"block-scan kernel, each block decoded once per query tile: f32 "
                     f"[nq, n_docs].")
    return score


score_dotvbyte = _single("dotvbyte")
score_dotvbyte_batch = _batch("dotvbyte")
score_streamvbyte = _single("streamvbyte")
score_streamvbyte_batch = _batch("streamvbyte")
score_bitpack = _single("bitpack")
score_bitpack_batch = _batch("bitpack")


class Bucket(NamedTuple):
    """One width bucket of a bitpack pack: its blocks (``sel``), their
    streams as ``block_scan`` takes them (words sliced tight) and their
    slots' documents."""

    width: int
    sel: torch.Tensor
    streams: dict
    doc_ids: torch.Tensor


def width_buckets(packed) -> list[Bucket]:
    """The width buckets of a bitpack pack held as tensors, one per
    distinct block width w, with the bucket's words sliced tight to
    ``⌈T·w/32⌉`` and padded to the 128-lane multiple, as the reference
    pads them. Built once per pack and kept on it (``packed.buckets``),
    so a scan only launches."""
    if packed.buckets is None:
        packed.buckets = _build_buckets(packed)
    return packed.buckets


def _build_buckets(packed) -> list[Bucket]:
    T = packed.block_size
    words = packed.words.view(torch.int32)  # u32 bits: not every device indexes u32
    out = []
    for w in torch.unique(packed.widths).tolist():
        sel = torch.nonzero(packed.widths == w).flatten()
        tight = (T * w + 31) // 32
        wt = torch.nn.functional.pad(words[sel, :tight], (0, (-tight) % 128))
        streams = {"words": wt.contiguous().view(torch.uint32),
                   **{k: getattr(packed, k)[sel] for k in ("seg", "start_pos", "start_abs",
                                                          "vals")}}
        out.append(Bucket(int(w), sel, streams, packed.doc_ids[sel]))
    return out


def score_bitpack_bucketed(q, packed, device=None):
    """Width-bucketed bitpack scan: one static-width kernel per distinct
    block width over that bucket's tight words (:func:`width_buckets`),
    so the bytes read track the true compressed size; every bucket adds
    into one result: f32 [n_docs]."""
    with span("repro_torch.scan"):
        Q, packed = _prepare(torch.as_tensor(q).reshape(1, -1), packed, "bitpack", device)
        total = None
        for b in width_buckets(packed):
            total = _scan("block_scan_bitpack_w", "bitpack", Q, packed, streams=b.streams,
                          doc_ids=b.doc_ids, width=b.width, out=total)
        if total is None:  # a pack of no blocks
            return torch.zeros(packed.n_docs, dtype=torch.float32, device=Q.device)
        return total[0]


#: codec → (single-query scorer, batch scorer): the counterpart of the
#: reference's ``KernelSet.block_scores{,_batch}``; uncompressed has no
#: block kernel, as in the reference
BLOCK_SCORERS = {
    "dotvbyte": (score_dotvbyte, score_dotvbyte_batch),
    "streamvbyte": (score_streamvbyte, score_streamvbyte_batch),
    "bitpack": (score_bitpack, score_bitpack_batch),
}


def block_scorers(codec: str):
    """(single, batch) full-scan scorers of ``codec``."""
    try:
        return BLOCK_SCORERS[codec]
    except KeyError:
        raise ValueError(
            f"no block-scan kernel for codec {codec!r}; have {sorted(BLOCK_SCORERS)} "
            f"(scoring.score_packed serves every codec)"
        ) from None
