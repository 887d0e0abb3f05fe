"""Train-step factory with microbatched gradient accumulation — the port
of ``repro/train/train_step.py``'s ``make_train_step``.

``step(state, batch) -> (state, metrics)`` with ``state = {"params",
"opt"}``, so a checkpoint sees one tree. Gradients come from
``torch.autograd`` over the parameter leaves; with ``microbatches > 1``
the batch splits into contiguous chunks along its first axis, gradients
accumulate in f32, loss and gradients are averaged, and the loss
function's aux metrics are dropped, as in the reference. The reference's
compressed data-parallel step (``make_dp_compressed_train_step``, int8 +
error feedback over a mesh) waits for ROADMAP A6b.
"""

from __future__ import annotations

from typing import Callable

import torch

from ..tree import tree_leaves, tree_map, tree_unflatten

__all__ = ["make_train_step", "init_train_state", "value_and_grad"]


def init_train_state(params, opt_init: Callable):
    return {"params": params, "opt": opt_init(params)}


def value_and_grad(loss_fn: Callable, params, batch):
    """``loss_fn(params, batch) -> (loss, aux)`` → ``((loss, aux), grads)``,
    every tensor detached; a leaf the loss does not reach gets a zero
    gradient."""
    live = tree_map(lambda p: p.detach().requires_grad_(True), params)
    leaves = tree_leaves(live)
    with torch.enable_grad():
        loss, aux = loss_fn(live, batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]
    aux = tree_map(lambda v: v.detach() if isinstance(v, torch.Tensor) else v, aux)
    return (loss.detach(), aux), tree_unflatten(live, grads)


def _split_microbatches(batch, n: int) -> list:
    def split(x):
        b = x.shape[0]
        if b % n:
            raise ValueError(f"batch {b} not divisible by {n} microbatches")
        return x.reshape(n, b // n, *x.shape[1:])

    chunks = tree_map(split, batch)
    return [tree_map(lambda x, i=i: x[i], chunks) for i in range(n)]


def make_train_step(loss_fn: Callable, opt_update: Callable, *, microbatches: int = 1):
    """``loss_fn(params, batch) -> (scalar, metrics)``; ``opt_update(grads,
    opt_state, params) -> (params, opt_state, metrics)``."""

    def step(state, batch):
        params = state["params"]
        if microbatches == 1:
            (loss, aux), grads = value_and_grad(loss_fn, params, batch)
        else:
            grads = tree_map(
                lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device), params
            )
            loss = torch.zeros((), dtype=torch.float32, device=tree_leaves(params)[0].device)
            for mb in _split_microbatches(batch, microbatches):
                (l_i, _), g = value_and_grad(loss_fn, params, mb)
                grads = tree_map(lambda a, gi: a + gi.float(), grads, g)
                loss = loss + l_i
            grads = tree_map(lambda g: g / microbatches, grads)
            loss = loss / microbatches
            aux = {}

        new_params, new_opt, opt_metrics = opt_update(grads, state["opt"], params)
        metrics = {"loss": loss, **opt_metrics}
        if isinstance(aux, dict):
            metrics.update({k: v for k, v in aux.items() if getattr(v, "ndim", 1) == 0})
        return {"params": new_params, "opt": new_opt}, metrics

    return step
