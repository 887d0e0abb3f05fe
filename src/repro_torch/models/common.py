"""Shared neural building blocks — the part of ``repro/models/common.py``
that the sparse encoder uses.

Parameters are nested dicts of tensors, as the reference's pytrees are.
Initialisers draw from a ``torch.Generator`` at the reference's scales
(``jax.random`` bits cannot be reproduced): normals scaled by 0.02 for
embeddings and by ``sqrt(2 / (d_in + d_out))`` for projections, drawn in
f32 on the generator's device, then cast and moved."""

from __future__ import annotations

import torch

from ..tree import tree_leaves

__all__ = ["dense_init", "embed_init", "normal", "rms_norm", "count_params"]


def normal(generator: torch.Generator, shape, scale: float, dtype=torch.float32, device=None):
    """``N(0, 1) · scale`` drawn in f32 from ``generator`` → ``dtype`` on
    ``device`` (the generator's own device when None)."""
    x = torch.randn(tuple(shape), generator=generator, device=generator.device) * scale
    return x.to(device=device or generator.device, dtype=dtype)


def dense_init(generator, d_in: int, d_out: int, dtype=torch.float32, scale: float | None = None,
               device=None):
    s = scale if scale is not None else (2.0 / (d_in + d_out)) ** 0.5
    return normal(generator, (d_in, d_out), s, dtype, device)


def embed_init(generator, vocab: int, dim: int, dtype=torch.float32, device=None):
    return normal(generator, (vocab, dim), 0.02, dtype, device)


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMS norm computed in f32, cast back to ``x``'s dtype."""
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * weight.float()).to(dt)


def count_params(params) -> int:
    """Elements over every leaf of a parameter tree."""
    return sum(int(x.numel()) for x in tree_leaves(params))
