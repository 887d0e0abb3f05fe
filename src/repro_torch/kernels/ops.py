"""The full-scan entry points: every document's exact score through the
compressed block form — the port of ``repro/kernels/ops.py``.

``score_{dotvbyte,streamvbyte,bitpack}`` take one dense query and return
f32 ``[n_docs]``; the ``_batch`` forms take ``Q [nq, ≥dim]`` and return
``[nq, n_docs]`` (each block decoded once for the whole batch);
``score_bitpack_bucketed`` runs one static-width scan per distinct
bitpack width over word streams sliced tight to ``⌈T·w/32⌉`` words.
Each runs the block-scan kernel (``kernels/block_scan.py``) and then
``scoring.scatter_block_scores`` (an ``index_add_``) to documents.

The pack (``PackedBlocks``) may hold numpy arrays, which go to
``device`` (``cuda`` unless the caller asks for the CPU), or tensors,
which are used where they lie. On CUDA tensors the kernel launches or
the call raises; on CPU tensors the kernel's plain version runs. The
block kernels read raw stored values only: a pack under a quantized
value codec raises a ``ValueError`` (``scoring.score_packed`` serves
every vq).
"""

from __future__ import annotations

import torch

from .. import resolve_device
from ..core.scoring import scatter_block_scores
from . import block_scan

__all__ = [
    "score_dotvbyte",
    "score_dotvbyte_batch",
    "score_streamvbyte",
    "score_streamvbyte_batch",
    "score_bitpack",
    "score_bitpack_batch",
    "score_bitpack_bucketed",
    "width_buckets",
    "BLOCK_SCORERS",
    "block_scorers",
]


def _prepare(Q, packed, codec: str, device):
    """(Q [nq, dim] f32 contiguous, the pack as tensors) on one device,
    after checking the pack's codec and value codec."""
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


def _block_args(packed):
    keys = ("ctrl", "data") if packed.codec != "bitpack" else ("words", "widths")
    return [getattr(packed, k) for k in keys] + [
        packed.seg, packed.start_pos, packed.start_abs, packed.vals]


def _single(fn, codec):
    def score(q, packed, device=None):
        Q, packed = _prepare(torch.as_tensor(q).reshape(1, -1), packed, codec, device)
        block = fn(Q[0], *_block_args(packed), scale=float(packed.value_format.scale))
        return scatter_block_scores(block, packed.doc_ids, packed.n_docs)

    score.__name__ = f"score_{codec}"
    score.__doc__ = (f"Every document's score for one dense query through the {codec} "
                     f"block-scan kernel: f32 [n_docs].")
    return score


def _batch(fn, codec):
    def score(Q, packed, device=None):
        Q, packed = _prepare(Q, packed, codec, device)
        block = fn(Q, *_block_args(packed), scale=float(packed.value_format.scale))
        return scatter_block_scores(block, packed.doc_ids, packed.n_docs)

    score.__name__ = f"score_{codec}_batch"
    score.__doc__ = (f"Every document's score for a query batch through the {codec} "
                     f"block-scan kernel, each block decoded once: f32 [nq, n_docs].")
    return score


score_dotvbyte = _single(block_scan.dotvbyte_block_scores, "dotvbyte")
score_dotvbyte_batch = _batch(block_scan.dotvbyte_block_scores_batch, "dotvbyte")
score_streamvbyte = _single(block_scan.streamvbyte_block_scores, "streamvbyte")
score_streamvbyte_batch = _batch(block_scan.streamvbyte_block_scores_batch, "streamvbyte")
score_bitpack = _single(block_scan.bitpack_block_scores, "bitpack")
score_bitpack_batch = _batch(block_scan.bitpack_block_scores_batch, "bitpack")


def width_buckets(packed):
    """The width buckets of a bitpack pack held as tensors: per distinct
    block width w, ``(w, block ids, words)`` with the bucket's words
    sliced tight to ``⌈T·w/32⌉`` and padded to the 128-lane multiple, as
    the reference pads them."""
    T = packed.block_size
    words = packed.words.view(torch.int32)  # u32 bits: not every device indexes u32
    out = []
    for w in torch.unique(packed.widths).tolist():
        sel = torch.nonzero(packed.widths == w).flatten()
        tight = (T * w + 31) // 32
        wt = torch.nn.functional.pad(words[sel, :tight], (0, (-tight) % 128))
        out.append((int(w), sel, wt.contiguous().view(torch.uint32)))
    return out


def score_bitpack_bucketed(q, packed, device=None):
    """Width-bucketed bitpack scan: one static-width kernel per distinct
    block width over that bucket's tight words (:func:`width_buckets`),
    so the bytes read track the true compressed size: f32 [n_docs]."""
    Q, packed = _prepare(torch.as_tensor(q).reshape(1, -1), packed, "bitpack", device)
    scale = float(packed.value_format.scale)
    total = torch.zeros(packed.n_docs, dtype=torch.float32, device=Q.device)
    for w, sel, words in width_buckets(packed):
        block = block_scan.bitpack_block_scores_w(
            Q[0], words, packed.seg[sel], packed.start_pos[sel], packed.start_abs[sel],
            packed.vals[sel], width=w, scale=scale)
        total += scatter_block_scores(block, packed.doc_ids[sel], packed.n_docs)
    return total


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
