"""Hand-rolled optimizers over trees of tensors: AdamW + Adafactor — the
port of ``repro/train/optimizer.py``.

They keep the reference's rules, which ``torch.optim`` does not: one
global-norm clip over every gradient, the warmup-cosine schedule, and
decoupled weight decay on every leaf of two or more dimensions (so the
stacked ``[L, D]`` norms of the encoder are decayed). The state keeps
the reference's tree — ``{"m", "v", "step"}`` for AdamW,
``{"second": {vr, vc | v}, "step"}`` for Adafactor, ``step`` an int32
0-d tensor — so a checkpoint names its leaves as the reference's does.
Updates run under ``torch.no_grad``; gradients come from the caller.

On placed leaves (``shards``: a ``dist.placed.TreeShards``, each leaf's
global shape and the axes that split it) a rank holds its block of every
parameter, gradient and state leaf: the global norm sums each leaf's
squares over the axes that split it (a replicated leaf counts once),
Adafactor factors by the global shape and takes its row and column
means, and its update's RMS, over the full dimensions (all-reduced over
the axes that split them); AdamW is elementwise.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch

from ..tree import tree_leaves, tree_map

__all__ = [
    "OptimizerConfig",
    "warmup_cosine",
    "global_norm",
    "clip_by_global_norm",
    "adamw_init",
    "adamw_update",
    "adafactor_init",
    "adafactor_update",
    "make_optimizer",
]


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    name: str = "adamw"  # "adamw" | "adafactor"
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.01
    grad_clip: float = 1.0
    # adafactor specifics
    decay_rate: float = 0.8
    factored_min_dim: int = 128
    state_dtype: torch.dtype = torch.float32  # bf16 state halves optimizer memory


def warmup_cosine(cfg: OptimizerConfig, step: torch.Tensor) -> torch.Tensor:
    step = step.float()
    warm = torch.clamp_max(step / max(cfg.warmup_steps, 1), 1.0)
    t = torch.clamp(
        (step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0
    )
    return cfg.lr * warm * 0.5 * (1.0 + torch.cos(math.pi * t))


def global_norm(tree, shards=None) -> torch.Tensor:
    if shards is None:
        return torch.sqrt(sum(torch.sum(torch.square(x.float())) for x in tree_leaves(tree)))
    from ..dist.placed import psum

    by_axes: dict = {}  # the leaves' squares summed per set of splitting axes
    for x, sh in zip(tree_leaves(tree), tree_leaves(shards.tree)):
        sq = torch.sum(torch.square(x.float()))
        by_axes[sh.axes] = by_axes[sh.axes] + sq if sh.axes in by_axes else sq
    return torch.sqrt(sum(psum(v, shards.mesh, axes) for axes, v in by_axes.items()))


def clip_by_global_norm(grads, max_norm: float, shards=None):
    norm = global_norm(grads, shards)
    scale = torch.clamp_max(max_norm / torch.clamp_min(norm, 1e-9), 1.0)
    return tree_map(lambda g: g.float() * scale, grads), norm


def _zero_step(params) -> torch.Tensor:
    leaves = tree_leaves(params)
    return torch.zeros((), dtype=torch.int32, device=leaves[0].device if leaves else None)


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------


def adamw_init(params, cfg: OptimizerConfig):
    zeros = lambda p: torch.zeros(p.shape, dtype=cfg.state_dtype, device=p.device)  # noqa: E731
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params), "step": _zero_step(params)}


@torch.no_grad()
def adamw_update(grads, state, params, cfg: OptimizerConfig, shards=None):
    step = state["step"] + 1
    lr = warmup_cosine(cfg, step)
    grads, gnorm = clip_by_global_norm(grads, cfg.grad_clip, shards)
    b1, b2 = cfg.b1, cfg.b2
    bc1 = 1.0 - b1 ** step.float()
    bc2 = 1.0 - b2 ** step.float()

    def upd(p, g, m, v):
        m32, v32 = m.float(), v.float()
        m_new = b1 * m32 + (1 - b1) * g
        v_new = b2 * v32 + (1 - b2) * g * g
        mh = m_new / bc1
        vh = v_new / bc2
        delta = mh / (torch.sqrt(vh) + cfg.eps)
        if p.dim() >= 2:  # decoupled weight decay on matrices only
            delta = delta + cfg.weight_decay * p.float()
        p_new = p.float() - lr * delta
        return p_new.to(p.dtype), m_new.to(m.dtype), v_new.to(v.dtype)

    out = tree_map(upd, params, grads, state["m"], state["v"])
    pick = lambda i: tree_map(lambda t: t[i], out)  # noqa: E731
    return pick(0), {"m": pick(1), "v": pick(2), "step": step}, {"lr": lr, "grad_norm": gnorm}


# ---------------------------------------------------------------------------
# Adafactor (Shazeer & Stern, 2018)
# ---------------------------------------------------------------------------


def _factored(p, cfg: OptimizerConfig, shape=None) -> bool:
    """Whether a leaf of ``shape`` (default ``p``'s) keeps factored
    moments."""
    shape = tuple(p.shape) if shape is None else shape
    return len(shape) >= 2 and min(shape[-2:]) >= cfg.factored_min_dim


def _global_shapes(params, shards):
    """Each leaf's global shape (its own where nothing is placed)."""
    if shards is None:
        return tree_map(lambda p: tuple(p.shape), params)
    return tree_map(lambda p, sh: sh.shape, params, shards.tree)


def adafactor_init(params, cfg: OptimizerConfig, shards=None):
    def one(p, shape):
        z = lambda shape: torch.zeros(shape, dtype=cfg.state_dtype, device=p.device)  # noqa: E731
        if _factored(p, cfg, shape):
            return {"vr": z(p.shape[:-1]), "vc": z(p.shape[:-2] + p.shape[-1:])}  # row, col
        return {"v": z(p.shape)}

    return {"second": tree_map(one, params, _global_shapes(params, shards)),
            "step": _zero_step(params)}


@torch.no_grad()
def adafactor_update(grads, state, params, cfg: OptimizerConfig, shards=None):
    step = state["step"] + 1
    lr = warmup_cosine(cfg, step)
    decay = 1.0 - (step.float() + 1.0) ** (-cfg.decay_rate)
    grads, gnorm = clip_by_global_norm(grads, cfg.grad_clip, shards)
    if shards is not None:
        return _adafactor_placed(grads, state, params, cfg, shards, step, lr, decay, gnorm)

    def upd(p, g, s):
        g2 = g * g + 1e-30
        if "vr" in s:
            vr = decay * s["vr"].float() + (1 - decay) * g2.mean(dim=-1)
            vc = decay * s["vc"].float() + (1 - decay) * g2.mean(dim=-2)
            denom = torch.clamp_min(vr.mean(dim=-1, keepdim=True), 1e-30)
            vhat = (vr[..., None] / denom[..., None]) * vc[..., None, :]
            update = g / torch.sqrt(vhat + 1e-30)
            new_s = {"vr": vr.to(s["vr"].dtype), "vc": vc.to(s["vc"].dtype)}
        else:
            v = decay * s["v"].float() + (1 - decay) * g2
            update = g / torch.sqrt(v + 1e-30)
            new_s = {"v": v.to(s["v"].dtype)}
        # update clipping (RMS ≤ 1), per the paper
        rms = torch.sqrt(torch.mean(torch.square(update)) + 1e-30)
        update = update / torch.clamp_min(rms, 1.0)
        p_new = p.float() - lr * update
        if p.dim() >= 2:
            p_new = p_new - lr * cfg.weight_decay * p.float()
        return p_new.to(p.dtype), new_s

    out = tree_map(upd, params, grads, state["second"])
    new_params = tree_map(lambda t: t[0], out)
    new_second = tree_map(lambda t: t[1], out)
    return new_params, {"second": new_second, "step": step}, {"lr": lr, "grad_norm": gnorm}


def _adafactor_placed(grads, state, params, cfg: OptimizerConfig, shards, step, lr, decay,
                      gnorm):
    """``adafactor_update`` on placed leaves: a mean over a dimension is the
    rank's sum all-reduced over the axes that split it, over the global
    size."""
    from ..dist.placed import psum

    mesh = shards.mesh

    def upd(p, g, s, sh):
        g2 = g * g + 1e-30
        if "vr" in s:
            rows, cols = sh.dims[-2], sh.dims[-1]
            vr = decay * s["vr"].float() + (1 - decay) * psum(g2.sum(dim=-1), mesh, cols) / sh.shape[-1]
            vc = decay * s["vc"].float() + (1 - decay) * psum(g2.sum(dim=-2), mesh, rows) / sh.shape[-2]
            denom = torch.clamp_min(
                psum(vr.sum(dim=-1, keepdim=True), mesh, rows) / sh.shape[-2], 1e-30)
            vhat = (vr[..., None] / denom[..., None]) * vc[..., None, :]
            update = g / torch.sqrt(vhat + 1e-30)
            new_s = {"vr": vr.to(s["vr"].dtype), "vc": vc.to(s["vc"].dtype)}
        else:
            v = decay * s["v"].float() + (1 - decay) * g2
            update = g / torch.sqrt(v + 1e-30)
            new_s = {"v": v.to(s["v"].dtype)}
        numel = math.prod(sh.shape)
        rms = torch.sqrt(psum(torch.sum(torch.square(update)), mesh, sh.axes) / numel + 1e-30)
        update = update / torch.clamp_min(rms, 1.0)
        p_new = p.float() - lr * update
        if p.dim() >= 2:
            p_new = p_new - lr * cfg.weight_decay * p.float()
        return p_new.to(p.dtype), new_s

    out = tree_map(upd, params, grads, state["second"], shards.tree)
    new_params = tree_map(lambda t: t[0], out)
    new_second = tree_map(lambda t: t[1], out)
    return new_params, {"second": new_second, "step": step}, {"lr": lr, "grad_norm": gnorm}


def make_optimizer(cfg: OptimizerConfig, shards=None) -> tuple[Callable, Callable]:
    """``cfg`` → ``(init(params), update(grads, state, params) → (params,
    state, metrics))``; ``shards`` (a ``dist.placed.TreeShards``): on
    placed leaves."""
    if cfg.name == "adamw":
        return ((lambda p: adamw_init(p, cfg)),
                (lambda g, s, p: adamw_update(g, s, p, cfg, shards)))
    if cfg.name == "adafactor":
        return ((lambda p: adafactor_init(p, cfg, shards)),
                (lambda g, s, p: adafactor_update(g, s, p, cfg, shards)))
    raise KeyError(cfg.name)
