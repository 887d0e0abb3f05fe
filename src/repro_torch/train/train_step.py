"""Train-step factory with microbatched gradient accumulation — the port
of ``repro/train/train_step.py``'s ``make_train_step``.

``step(state, batch) -> (state, metrics)`` with ``state = {"params",
"opt"}``, so a checkpoint sees one tree. Gradients come from
``torch.autograd`` over the parameter leaves; with ``microbatches > 1``
the batch splits into contiguous chunks along its first axis, gradients
accumulate in f32, loss and gradients are averaged, and the loss
function's aux metrics are dropped, as in the reference.

``make_dp_compressed_train_step`` is the pure data-parallel step over a
``DeviceMesh`` (``torch.distributed``, one rank a replica): each rank
takes its shard of the global batch along the data axes, runs
``value_and_grad`` on it, averages the gradients int8-compressed with
error feedback (``dist.compression.compressed_psum_mean``) and the loss
over the group, and applies ``opt_update``. Every rank sums the ranks'
terms in rank order, so parameters stay bit-identical across replicas;
the error-feedback residual is rank-local state (``state["residual"]``,
``init_dp_residual``).
"""

from __future__ import annotations

from typing import Callable

import torch

from ..dist.compression import compressed_psum_mean
from ..dist.sharding import axes_group, axis_block, group_all_gather
from ..tree import tree_leaves, tree_map, tree_unflatten

__all__ = ["make_train_step", "make_dp_compressed_train_step", "init_train_state",
           "init_dp_residual", "value_and_grad"]


def init_train_state(params, opt_init: Callable, *, mesh=None, dp_axes=None):
    """``{"params", "opt"}``; with ``mesh`` and ``dp_axes``, plus the
    rank's error-feedback ``"residual"`` (which
    ``make_dp_compressed_train_step`` needs)."""
    state = {"params": params, "opt": opt_init(params)}
    if mesh is not None and dp_axes is not None:
        state["residual"] = init_dp_residual(params, mesh, dp_axes)
    return state


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


def make_dp_compressed_train_step(
    loss_fn: Callable,
    opt_update: Callable,
    mesh,
    batch_spec=None,
    *,
    dp_axes: tuple[str, ...] = ("data",),
):
    """Pure data-parallel trainer with the int8 error-feedback gradient
    mean. ``params`` and ``opt`` are replicated (every rank holds the
    same); the global ``batch`` is split per ``batch_spec``: a tree of
    ``batch``'s structure whose leaf names the mesh axis (or tuple of
    axes) a batch leaf's leading axis splits over, or None to
    replicate it — the reference's ``PartitionSpec``'s first entry.
    ``batch_spec=None`` splits every leaf over ``dp_axes``. The residual
    is each rank's own (``state["residual"]``)."""
    group = axes_group(mesh, dp_axes)

    def step(state, batch):
        spec = tree_map(lambda _: dp_axes, batch) if batch_spec is None else batch_spec
        local = tree_map(lambda x, a: x if a is None else axis_block(x, mesh, a), batch, spec)
        params = state["params"]
        (loss, _aux), grads = value_and_grad(loss_fn, params, local)
        mean_grads, new_residual = compressed_psum_mean(grads, state["residual"], group)
        losses = group_all_gather(loss.float(), group)
        total = losses[0]
        for r in range(1, losses.shape[0]):  # rank order, as the gradients
            total = total + losses[r]
        loss = total / losses.shape[0]
        new_params, new_opt, opt_metrics = opt_update(mean_grads, state["opt"], params)
        return ({"params": new_params, "opt": new_opt, "residual": new_residual},
                {"loss": loss, **opt_metrics})

    return step


def init_dp_residual(params, mesh=None, dp_axes: tuple[str, ...] = ("data",)):
    """The rank's error-feedback residual: f32 zeros of every parameter's
    shape. The reference keeps one slot a replica on a leading axis sized
    from ``mesh`` and ``dp_axes``; here each rank holds its own slot, so
    neither is read."""
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device), params)
