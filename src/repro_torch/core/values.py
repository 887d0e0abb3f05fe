"""Value codecs (``vq``) — the quantization axis orthogonal to the id
codec, the port of ``repro/core/values.py``.

======== ===================== =======================================
vq       codes per stored byte decode
======== ===================== =======================================
f16      —                     pass-through (storage dtype, bit-exact)
u8_sq    1                     per-row clip range: lo + code·step
u4_sq    2 (nibble-packed)     per-row clip range, 4-bit codes
pq       ``PQ_M``              codebook gather: sub-vectors of PQ_M
                               consecutive values → one u8 code
======== ===================== =======================================

The codes ride inside ``vals_rows`` (u8, width divided by the pack
factor) and, in the block form, inside ``PackedBlocks.vals`` with
per-block clip ranges ``vq_lo``/``vq_scale`` f32 ``[B, 1]``
(:func:`encode_block_values`); the per-row clip ranges ride as f32 ``[N+1, 1]`` payload
columns (``vq_lo_rows``/``vq_scale_rows`` for u8, ``vq_lo4_rows``/
``vq_scale4_rows`` for u4) and the PQ codebook as f32 ``[PQ_K, PQ_M]``
``vq_codebook``, so artifacts carry them like any array. The vq of a
rows dict is inferred from which keys are present
(:func:`infer_rows_vq`).

The encode half is numpy and byte-identical to the reference (the
seeded PQ k-means included); the nearest-centroid assignment runs over
chunks of sub-vectors, so its working set stays bounded at any corpus
size (the reference's one-shot ``[N+1, L/2, 256, 2]`` distance tensor
is ~26 GB at 100k docs). The decode half is torch: the plain rescoring
path (``core/scoring.py``) runs it, and the CUDA rows kernel computes
the same ``lo + code·step`` (without fused multiply-add) and the same
codebook gather. Decoded values are in storage units: the downstream
``value_scale`` multiply applies unchanged.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

__all__ = [
    "VALUE_CODECS",
    "PQ_K",
    "PQ_M",
    "sq_keys",
    "check_vq",
    "code_factor",
    "n_vq_streams",
    "pack_nibbles",
    "fit_pq_codebook",
    "encode_rows_values",
    "encode_block_values",
    "unpack_nibbles",
    "dequant_sq",
    "dequant_pq",
    "decode_codes",
    "infer_rows_vq",
    "rows_vq_streams",
    "value_payload_bytes",
]

#: registered value codecs (RetrieverConfig.vq / pack-time knob)
VALUE_CODECS = ("f16", "u8_sq", "u4_sq", "pq")

#: PQ codebook entries (codes are u8) and sub-vector width
PQ_K = 256
PQ_M = 2

#: per-row clip-range payload keys by vq (f32 [N+1, 1] columns)
_SQ_KEYS = {
    "u8_sq": ("vq_lo_rows", "vq_scale_rows"),
    "u4_sq": ("vq_lo4_rows", "vq_scale4_rows"),
}

_MAXCODE = {"u8_sq": 255, "u4_sq": 15}

#: sub-vectors per nearest-centroid chunk: bounds the [S, PQ_K] f32
#: distance matrix of :func:`_pq_codes` to 32 MiB
_PQ_CHUNK = 1 << 15


def sq_keys(vq: str) -> tuple[str, str]:
    """The (lo, scale) payload key names of a scalar-quant vq."""
    return _SQ_KEYS[vq]


def check_vq(vq: str) -> str:
    if vq not in VALUE_CODECS:
        raise ValueError(f"unknown value codec {vq!r}; have {list(VALUE_CODECS)}")
    return vq


def code_factor(vq: str) -> int:
    """Logical values per stored byte column: the value array's stored
    width is ``logical_width // code_factor(vq)``."""
    check_vq(vq)
    if vq == "u4_sq":
        return 2
    if vq == "pq":
        return PQ_M
    return 1


def n_vq_streams(vq: str) -> int:
    """How many extra payload streams the rows kernel takes for vq
    (lo + scale columns for scalar quant, the codebook for PQ)."""
    check_vq(vq)
    if vq in _SQ_KEYS:
        return 2
    return 1 if vq == "pq" else 0


# ---------------------------------------------------------------------------
# pack-time encoders (numpy, host side)
# ---------------------------------------------------------------------------


def _fit_clip(vals: np.ndarray, live: np.ndarray, maxcode: int, clip):
    """Per-row clip range on each row's OWN live values → (lo, step),
    f32 [R, 1]. ``clip=(lo, hi)`` overrides with one global range,
    still stored per row."""
    v = vals.astype(np.float32)
    if clip is not None:
        lo = np.full((v.shape[0], 1), np.float32(clip[0]))
        hi = np.full((v.shape[0], 1), np.float32(clip[1]))
    else:
        big, small = np.float32(np.finfo(np.float32).max), np.float32(np.finfo(np.float32).min)
        lo = np.where(live, v, big).min(axis=1, keepdims=True)
        hi = np.where(live, v, small).max(axis=1, keepdims=True)
        none_live = ~live.any(axis=1, keepdims=True)
        lo = np.where(none_live, 0.0, lo).astype(np.float32)
        hi = np.where(none_live, 0.0, hi).astype(np.float32)
    step = np.where(hi > lo, (hi - lo) / np.float32(maxcode), 1.0).astype(np.float32)
    return lo.astype(np.float32), step


def _sq_codes(vals: np.ndarray, live: np.ndarray, maxcode: int, clip):
    lo, step = _fit_clip(vals, live, maxcode, clip)
    v = vals.astype(np.float32)
    codes = np.clip(np.rint((v - lo) / step), 0, maxcode).astype(np.uint8)
    return np.where(live, codes, 0).astype(np.uint8), lo, step


def pack_nibbles(codes: np.ndarray) -> np.ndarray:
    """4-bit codes [..., 2W] → packed bytes [..., W]: element ``2i`` in
    the low nibble, ``2i+1`` in the high nibble of byte ``i``."""
    if codes.shape[-1] % 2:
        raise ValueError("nibble packing needs an even trailing dim")
    pairs = codes.reshape(*codes.shape[:-1], -1, 2)
    return (pairs[..., 0] | (pairs[..., 1] << 4)).astype(np.uint8)


def fit_pq_codebook(
    subvecs: np.ndarray, seed: int = 0, iters: int = 8, sample: int = 4096
) -> np.ndarray:
    """Deterministic seeded Lloyd k-means over [S, PQ_M] sub-vectors →
    f32 codebook [PQ_K, PQ_M]: fixed iteration count, deterministic
    subsample, argmin ties to the lowest index."""
    sv = np.asarray(subvecs, np.float32).reshape(-1, PQ_M)
    if len(sv) == 0:
        return np.zeros((PQ_K, PQ_M), np.float32)
    rng = np.random.default_rng(seed)
    if len(sv) > sample:
        sv = sv[rng.choice(len(sv), size=sample, replace=False)]
    # init: evenly spaced points of the norm-sorted sample
    order = np.argsort(np.einsum("ij,ij->i", sv, sv), kind="stable")
    idx = np.linspace(0, len(sv) - 1, PQ_K).astype(np.int64)
    cb = sv[order[idx]].copy()
    for _ in range(iters):
        d2 = ((sv[:, None, :] - cb[None, :, :]) ** 2).sum(-1)  # [S, K]
        assign = np.argmin(d2, axis=1)
        for k in range(PQ_K):
            members = sv[assign == k]
            if len(members):
                cb[k] = members.mean(axis=0)
    return cb.astype(np.float32)


def _pq_codes(vals: np.ndarray, codebook: np.ndarray, chunk: int | None = None) -> np.ndarray:
    """Nearest-centroid assignment of every PQ_M sub-vector → u8 codes
    [..., W/PQ_M] (ties to the lowest index, matching the fit), over
    chunks of ``chunk`` sub-vectors. Each sub-vector's argmin depends on
    it alone, so the codes equal the one-shot computation's. The
    squared distance is summed lane by lane in f32 (lane 0 + lane 1, as
    numpy's sum over a length-2 axis adds them), without the 3-D
    intermediate."""
    v = vals.astype(np.float32)
    sv = v.reshape(*v.shape[:-1], -1, PQ_M)
    flat = sv.reshape(-1, PQ_M)
    cb = np.asarray(codebook, np.float32)
    out = np.empty(len(flat), dtype=np.uint8)
    step = chunk or _PQ_CHUNK
    for s in range(0, len(flat), step):
        x = flat[s : s + step]
        d2 = np.square(x[:, :1] - cb[None, :, 0])
        for m in range(1, PQ_M):
            d2 += np.square(x[:, m : m + 1] - cb[None, :, m])
        out[s : s + step] = np.argmin(d2, axis=-1)
    return out.reshape(sv.shape[:-1])


def encode_rows_values(
    vals_rows: np.ndarray,  # [N+1, cap] storage dtype (row N = sentinel)
    nnz_rows: np.ndarray,  # i32 [N+1]
    vq: str,
    clip: tuple[float, float] | None = None,
    pq_seed: int = 0,
):
    """Quantize a packed row value matrix → (codes u8 [N+1, cap/factor],
    payload extras dict). f16 is the pass-through. ``cap`` must be a
    multiple of the pack factor (``layout.pack_rows`` rounds it)."""
    check_vq(vq)
    if vq == "f16":
        return vals_rows, {}
    cap = vals_rows.shape[1]
    if cap % code_factor(vq):
        raise ValueError(
            f"row capacity {cap} not a multiple of the {vq} pack factor {code_factor(vq)}"
        )
    live = np.arange(cap)[None, :] < np.asarray(nnz_rows)[:, None]
    if vq in _SQ_KEYS:
        codes, lo, step = _sq_codes(vals_rows, live, _MAXCODE[vq], clip)
        if vq == "u4_sq":
            codes = pack_nibbles(codes)
        lo_key, sc_key = _SQ_KEYS[vq]
        return codes, {lo_key: lo, sc_key: step}
    return _pq_encode(vals_rows, live, pq_seed)


def _pq_encode(vals: np.ndarray, live: np.ndarray, pq_seed: int):
    """PQ codes of a [R, W] value matrix: the codebook is fit on the live
    sub-vectors only (a sub-vector is live when its first element is);
    dead sub-vectors get code 0, so only the live ones are assigned."""
    v = np.where(live, vals.astype(np.float32), 0.0)
    sub_live = live[:, ::PQ_M]
    live_sv = v.reshape(-1, PQ_M)[sub_live.reshape(-1)]
    cb = fit_pq_codebook(live_sv, seed=pq_seed)
    codes = np.zeros(sub_live.shape, dtype=np.uint8)
    codes[sub_live] = _pq_codes(live_sv, cb).reshape(-1)
    return codes, {"vq_codebook": cb}


def encode_block_values(
    vals: np.ndarray,  # [B, T] storage dtype
    seg: np.ndarray,  # [B, T], -1 = padding
    vq: str,
    clip: tuple[float, float] | None = None,
    pq_seed: int = 0,
):
    """Block-form mirror of :func:`encode_rows_values`: per-BLOCK clip
    ranges (``vq_lo``/``vq_scale`` f32 [B, 1]) or the shared codebook;
    an element is live where ``seg >= 0``."""
    check_vq(vq)
    if vq == "f16":
        return vals, {}
    live = np.asarray(seg) >= 0
    if vq in _SQ_KEYS:
        codes, lo, step = _sq_codes(vals, live, _MAXCODE[vq], clip)
        if vq == "u4_sq":
            codes = pack_nibbles(codes)
        return codes, {"vq_lo": lo, "vq_scale": step}
    return _pq_encode(vals, live, pq_seed)


# ---------------------------------------------------------------------------
# decode (torch; the plain rescoring path)
# ---------------------------------------------------------------------------


def unpack_nibbles(codes: torch.Tensor) -> torch.Tensor:
    """Packed bytes [..., W] → interleaved 4-bit codes i32 [..., 2W]
    (low nibble first — the inverse of :func:`pack_nibbles`)."""
    c = codes.to(torch.int32)
    return torch.stack([c & 0xF, (c >> 4) & 0xF], dim=-1).reshape(*codes.shape[:-1], -1)


def dequant_sq(codes: torch.Tensor, lo, step) -> torch.Tensor:
    """code → clip-range ``lo + code·step`` in f32; ``lo``/``step``
    broadcast ([..., 1] columns)."""
    return lo + codes.to(torch.float32) * step


def dequant_pq(codes: torch.Tensor, codebook_flat: torch.Tensor) -> torch.Tensor:
    """u8 codes [..., W] + flat codebook f32 [PQ_K·PQ_M] → values
    f32 [..., W·PQ_M] via a flat gather (code·M + lane offset)."""
    lanes = torch.arange(PQ_M, dtype=torch.int64, device=codes.device)
    idx = codes.to(torch.int64).unsqueeze(-1) * PQ_M + lanes
    return codebook_flat[idx.reshape(*codes.shape[:-1], -1)]


def decode_codes(vq: str, codes, lo=None, step=None, codebook_flat=None) -> torch.Tensor:
    """Quantized codes [..., W] → f32 storage-unit values [..., W·factor]."""
    if vq == "f16":
        return codes.to(torch.float32)
    if vq == "u8_sq":
        return dequant_sq(codes, lo, step)
    if vq == "u4_sq":
        return dequant_sq(unpack_nibbles(codes), lo, step)
    if vq == "pq":
        return dequant_pq(codes, codebook_flat)
    raise ValueError(f"unknown value codec {vq!r}; have {list(VALUE_CODECS)}")


# ---------------------------------------------------------------------------
# rows-array plumbing (vq inference + kernel stream marshalling)
# ---------------------------------------------------------------------------


def infer_rows_vq(arrays: Mapping) -> str:
    """Which value codec a packed rows dict carries, from its payload
    keys: ``vq_codebook`` → pq, ``vq_lo4_rows`` → u4_sq, ``vq_lo_rows``
    → u8_sq, else f16."""
    if "vq_codebook" in arrays:
        return "pq"
    if "vq_lo4_rows" in arrays:
        return "u4_sq"
    if "vq_lo_rows" in arrays:
        return "u8_sq"
    return "f16"


def rows_vq_streams(vq: str, arrays: Mapping) -> list[torch.Tensor]:
    """The ordered extra streams the rows kernel takes for ``vq``: the
    per-row lo/scale columns, or the flat codebook ``[PQ_K·PQ_M]``."""
    if vq in _SQ_KEYS:
        lo_key, sc_key = _SQ_KEYS[vq]
        return [arrays[lo_key], arrays[sc_key]]
    if vq == "pq":
        return [arrays["vq_codebook"].to(torch.float32).reshape(PQ_K * PQ_M)]
    return []


def value_payload_bytes(arrays: Mapping) -> int:
    """Per-candidate value bytes of a rows dict: code bytes per row plus
    the clip-range columns; the (read-once) codebook is left to the
    caller."""
    vals = arrays["vals_rows"]
    per_row = int(vals.dtype.itemsize) * int(vals.shape[-1])
    for k in ("vq_lo_rows", "vq_scale_rows", "vq_lo4_rows", "vq_scale4_rows"):
        if k in arrays:
            per_row += int(arrays[k].dtype.itemsize)
    return per_row
