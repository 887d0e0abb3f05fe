"""Sequence-sharded flash decoding on ``torch.distributed`` — the port of
``repro/dist/collectives.py``.

``flash_decode_shardmap`` is the decode-attention step over a KV cache
split along its sequence: each rank scores the query against its LOCAL
slice of the cache, keeps the flash-attention partial statistics (its
running max, denominator and weighted accumulator), and the softmax is
completed with one ``all_reduce(MAX)`` and two ``all_reduce(SUM)`` over
the process group of the sequence axes — O(B·H·dh) collective bytes a
step instead of gathering O(S) cache. Softmax is an associative
reduction over the key axis, so the result equals the local reference
``models.transformer._decode_attention_ref`` up to the order of its f32
sums.

Where jax's ``shard_map`` runs one program over a ``Mesh``, every rank
here calls the returned function with its own blocks (``dist.sharding``).
Under gloo a CUDA tensor crosses as a host copy (gloo reduces host
tensors only): ``[B, H]`` and ``[B, H, dh]`` f32 a layer.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from .sharding import axes_group, axis_index

__all__ = ["flash_decode_shardmap"]

NEG_INF = -1e30


def _all_reduce(t: torch.Tensor, op, group) -> torch.Tensor:
    if t.is_cuda and dist.get_backend(group) == "gloo":
        host = t.cpu()
        dist.all_reduce(host, op=op, group=group)
        return host.to(t.device)
    dist.all_reduce(t, op=op, group=group)
    return t


def flash_decode_shardmap(mesh, *, batch_axes: tuple[str, ...] = ("data",),
                          seq_axes: tuple[str, ...] = ("model",)):
    """fn(q [B,1,H,dh], k/v caches [B,S,Hk,dh], valid_len [B]) → [B,1,H,dh],
    run on every rank of ``mesh`` (a ``DeviceMesh``) with its own blocks.

    The cache splits over ``seq_axes`` on S (and ``batch_axes`` on B);
    queries, lengths and outputs split over ``batch_axes`` only, so a rank
    passes its batch rows of ``q`` and ``valid_len`` (global lengths) and
    its ``[B_local, S_local]`` block of the cache. ``seq_axes`` may cover
    every mesh axis (the 500k-context layout, batch replicated). The
    global position of a rank's first key is its row-major index over
    ``seq_axes`` (major to minor, as a ``PartitionSpec`` splits the
    dimension) times ``S_local``."""
    sa = tuple(seq_axes)
    group = axes_group(mesh, sa)
    idx = axis_index(mesh, sa)

    def local(q, k, v, valid_len):
        B, _, H, dh = q.shape
        S_local, Hk = k.shape[1], k.shape[2]
        G = H // Hk
        kpos = idx * S_local + torch.arange(S_local, device=q.device)

        qg = q.reshape(B, Hk, G, dh)
        s = torch.einsum("bhgd,bkhd->bhgk", qg, k).float()
        s = s / torch.sqrt(torch.tensor(float(dh), dtype=torch.float32, device=q.device))
        mask = kpos[None, :] < valid_len[:, None]  # [B, S_local]
        s = torch.where(mask[:, None, None, :], s, NEG_INF)

        m = _all_reduce(s.amax(dim=-1), dist.ReduceOp.MAX, group)  # [B, Hk, G]
        p = torch.exp(s - m[..., None])
        p = torch.where(mask[:, None, None, :], p, 0.0)
        denom = _all_reduce(p.sum(dim=-1), dist.ReduceOp.SUM, group)
        acc = _all_reduce(torch.einsum("bhgk,bkhd->bhgd", p, v.float()), dist.ReduceOp.SUM,
                          group)
        out = acc / torch.clamp_min(denom, 1e-30)[..., None]
        return out.reshape(B, 1, H, dh).to(q.dtype)

    return local
