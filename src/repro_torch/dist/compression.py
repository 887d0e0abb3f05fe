"""Gradient wire compression for the data-parallel trainer — the port of
``repro/dist/compression.py``.

``compressed_psum_mean`` is int8 gradient averaging with error feedback:

1. add the carried residual to the fresh gradient (error feedback);
2. per leaf, symmetric int8 quantisation (``scale = max(max|x| / 127,
   1e-12)``, round half to even, clip to ±127) — the tensor that
   crosses the interconnect, 4× smaller than f32;
3. the quantisation error ``x − deq`` becomes the next step's residual,
   so the compression bias telescopes away;
4. the mean over the group of the dequantised tensors.

Step 4 is an ``all_gather`` of every rank's int8 codes and scales (all
leaves in one int8 buffer and one f32 vector), each rank dequantising
and summing them in rank order, then dividing by the group size — so the
wire carries int8, as the reference's docstring describes, and every
rank ends with the same bits (an ``all_reduce`` promises no summation
order). At one rank the mean is ``deq`` itself, as ``pmean`` over one
device.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..tree import tree_leaves, tree_unflatten
from .sharding import group_all_gather

__all__ = ["quantize_int8", "compressed_psum_mean"]


def quantize_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """f32 ``x`` → (int8 codes, f32 scale): ``scale = max(max|x| / 127,
    1e-12)``, codes ``clip(round(x / scale), ±127)`` (half to even, as
    ``jnp.round``)."""
    scale = torch.clamp_min(x.abs().max() / 127.0, 1e-12)
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def compressed_psum_mean(grads, residual, group=None):
    """→ (mean_grads, new_residual), both trees of ``grads``' structure
    in f32; ``group`` is the data-parallel process group (default: the
    world)."""
    g_leaves = tree_leaves(grads)
    r_leaves = tree_leaves(residual)
    if len(g_leaves) != len(r_leaves):
        raise ValueError(f"{len(g_leaves)} gradient leaves but {len(r_leaves)} residual leaves")
    xs = [g.float() + r for g, r in zip(g_leaves, r_leaves)]
    codes, scales = zip(*(quantize_int8(x) for x in xs))
    deqs = [q.float() * s for q, s in zip(codes, scales)]
    new_residual = [x - d for x, d in zip(xs, deqs)]
    n = dist.get_world_size(group)
    all_codes = group_all_gather(torch.cat([q.reshape(-1) for q in codes]), group)
    all_scales = group_all_gather(torch.stack(scales), group)
    sizes = [q.numel() for q in codes]
    total = None
    for r in range(n):  # rank order: every rank sums alike
        deq_r = [p.float().reshape(d.shape) * all_scales[r, i]
                 for i, (p, d) in enumerate(zip(torch.split(all_codes[r], sizes), deqs))]
        total = deq_r if total is None else [t + d for t, d in zip(total, deq_r)]
    mean = [t / n for t in total]
    return tree_unflatten(grads, mean), tree_unflatten(grads, new_residual)
