"""Attention — the part of ``repro/models/transformer.py`` that the
sparse encoder uses: ``attention`` with its full (materialised) and
chunked (online softmax) forms, GQA by broadcasting KV heads.

Both keep the reference's arithmetic: scores in f32 scaled by
``1/sqrt(dh)``, the causal mask at ``-1e30``, plain einsum → softmax →
einsum (no fused attention kernel: parity with the reference is the
point). The reference's sharding hints are no-ops off a mesh and have no
counterpart here; the rest of the transformer waits for ROADMAP A11."""

from __future__ import annotations

import torch

__all__ = ["attention"]

NEG_INF = -1e30


def _scale(dh: int, device) -> torch.Tensor:
    return torch.sqrt(torch.tensor(float(dh), dtype=torch.float32, device=device))


def _gqa_scores_full(q, k, v, causal: bool, q_offset):
    """q [B,Sq,H,dh], k/v [B,Sk,Hk,dh] → [B,Sq,H,dh]. Full materialised."""
    B, Sq, H, dh = q.shape
    Sk, Hk = k.shape[1], k.shape[2]
    G = H // Hk
    k = torch.repeat_interleave(k, G, dim=2)  # [B,Sk,H,dh]
    v = torch.repeat_interleave(v, G, dim=2)
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k).float()
    scores = scores / _scale(dh, q.device)
    if causal:
        qpos = q_offset + torch.arange(Sq, device=q.device)
        kpos = torch.arange(Sk, device=q.device)
        mask = qpos[:, None] >= kpos[None, :]
        scores = torch.where(mask[None, None], scores, NEG_INF)
    attn = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", attn, v)


def _gqa_scores_chunked(q, k, v, causal: bool, q_offset, chunk: int):
    """Flash-style online softmax over KV chunks (plain torch, O(chunk²)
    memory); the same arithmetic as the full form up to the order of its
    f32 sums."""
    B, Sq, H, dh = q.shape
    Sk, Hk = k.shape[1], k.shape[2]
    G = H // Hk
    k = torch.repeat_interleave(k, G, dim=2)
    v = torch.repeat_interleave(v, G, dim=2)
    n_chunks = (Sk + chunk - 1) // chunk
    pad = n_chunks * chunk - Sk
    if pad:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
    kc = k.reshape(B, n_chunks, chunk, H, dh).transpose(0, 1)
    vc = v.reshape(B, n_chunks, chunk, H, dh).transpose(0, 1)
    qpos = q_offset + torch.arange(Sq, device=q.device)
    scale = _scale(dh, q.device)

    m = torch.full((B, H, Sq), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, H, Sq), dtype=torch.float32, device=q.device)  # noqa: E741
    acc = torch.zeros((B, H, Sq, dh), dtype=torch.float32, device=q.device)
    for c_idx in range(n_chunks):  # running max, denominator, numerator
        kb, vb = kc[c_idx], vc[c_idx]
        kpos = c_idx * chunk + torch.arange(chunk, device=q.device)
        s = torch.einsum("bqhd,bkhd->bhqk", q, kb).float() / scale
        valid = kpos[None, :] < Sk
        if causal:
            valid = valid & (qpos[:, None] >= kpos[None, :])
        s = torch.where(valid[None, None], s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        rescale = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * rescale + p.sum(dim=-1)  # noqa: E741
        acc = acc * rescale[..., None] + torch.einsum(
            "bhqk,bkhd->bhqd", p.to(q.dtype), vb
        ).float()
        m = m_new
    out = acc / torch.clamp_min(l, 1e-30)[..., None]
    return out.transpose(1, 2).to(q.dtype)


def attention(q, k, v, *, causal: bool, q_offset=0, impl: str = "full", chunk: int = 1024):
    if impl == "chunked":
        return _gqa_scores_chunked(q, k, v, causal, q_offset, chunk)
    return _gqa_scores_full(q, k, v, causal, q_offset)
