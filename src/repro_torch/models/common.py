"""Shared neural building blocks — the port of ``repro/models/common.py``.

Parameters are nested dicts of tensors, as the reference's pytrees are.
Initialisers draw from a ``torch.Generator`` at the reference's scales
(``jax.random`` bits cannot be reproduced): normals scaled by 0.02 for
embeddings and by ``sqrt(2 / (d_in + d_out))`` for projections, drawn in
f32 on the generator's device, then cast and moved. The reference's
``shard_hint`` is a no-op off a mesh and has no counterpart: a rank here
holds whole weights (see ``configs/base.py``)."""

from __future__ import annotations

import numpy as np
import torch

from .. import resolve_device
from ..tree import tree_leaves, tree_map

__all__ = [
    "dense_init",
    "embed_init",
    "normal",
    "rms_norm",
    "layer_norm",
    "mlp_init",
    "mlp_apply",
    "rope_freqs",
    "apply_rope",
    "count_params",
    "params_from_jax",
    "params_to_numpy",
]


def normal(generator: torch.Generator, shape, scale: float, dtype=torch.float32, device=None):
    """``N(0, 1) · scale`` drawn in f32 from ``generator`` → ``dtype`` on
    ``device`` (the generator's own device when None). On the ``meta``
    device nothing is drawn: the shape and dtype only (a config's
    abstract parameters)."""
    if device is not None and torch.device(device).type == "meta":
        return torch.empty(tuple(shape), dtype=dtype, device="meta")
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


def layer_norm(x: torch.Tensor, weight, bias, eps: float = 1e-5) -> torch.Tensor:
    """Layer norm computed in f32, cast back to ``x``'s dtype."""
    dt = x.dtype
    x = x.float()
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean((x - mu) ** 2, dim=-1, keepdim=True)
    x = (x - mu) * torch.rsqrt(var + eps)
    return (x * weight + bias).to(dt)


def mlp_init(generator, sizes, dtype=torch.float32, device=None):
    """Plain MLP: weights + biases for ``len(sizes) - 1`` layers, drawn
    in layer order."""
    dev = device or generator.device
    return {
        "w": [dense_init(generator, a, b, dtype, device=dev)
              for a, b in zip(sizes[:-1], sizes[1:])],
        "b": [torch.zeros((b,), dtype=dtype, device=dev) for b in sizes[1:]],
    }


def mlp_apply(params, x, activation=torch.relu, final_activation=None):
    n = len(params["w"])
    for i, (w, b) in enumerate(zip(params["w"], params["b"])):
        x = x @ w + b
        if i < n - 1:
            x = activation(x)
        elif final_activation is not None:
            x = final_activation(x)
    return x


def rope_freqs(d_head: int, theta: float = 10000.0, device=None) -> torch.Tensor:
    """Inverse frequencies for rotary embeddings. [d_head // 2] f32."""
    return 1.0 / (theta ** (torch.arange(0, d_head, 2, dtype=torch.float32, device=device)
                            / d_head))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, inv_freq: torch.Tensor) -> torch.Tensor:
    """x [..., S, H, Dh]; positions [..., S] → rotated x. The two halves
    of the head are the pairs (not interleaved elements), as in the
    reference."""
    angles = positions[..., :, None].float() * inv_freq  # [..., S, Dh/2]
    cos = torch.cos(angles)[..., None, :]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.chunk(x, 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def count_params(params) -> int:
    """Elements over every leaf of a parameter tree."""
    return sum(int(x.numel()) for x in tree_leaves(params))


def _leaf_from_numpy(a) -> torch.Tensor:
    a = np.array(a, copy=True)
    if a.dtype.name == "bfloat16":  # ml_dtypes' bf16 (jax's): same bits as torch's
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def params_from_jax(tree, *, device=None):
    """A tree of arrays (the reference's parameters, ``jax.device_get``
    or ``np.asarray`` of each leaf; bf16 leaves keep their bits) → the
    same tree of tensors on ``device`` (``cuda`` unless given)."""
    dev = resolve_device(device)
    return tree_map(lambda a: _leaf_from_numpy(a).to(dev), tree)


def params_to_numpy(tree):
    """A tree of tensors → the same tree of host numpy arrays (copies);
    bf16 leaves become f32, which holds them exactly (numpy has no bf16)."""
    def one(t):
        t = t.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy().copy()

    return tree_map(one, tree)
