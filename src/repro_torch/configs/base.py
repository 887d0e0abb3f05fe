"""Arch/Cell abstraction — the port of ``repro/configs/base.py``'s LM
family and the pieces every family shares. Every config exposes, per
input shape, everything the dry run needs:

    build_cell(shape, mesh) -> Cell(fn, input_structs, in_shardings,
                                    out_shardings, model_flops, meta)

``fn`` is the step a rank runs (train step, prefill, decode, serve);
``input_structs`` are ``meta`` tensors (shape and dtype, never
allocated); the shardings are ``dist.sharding.Placement``s, the
reference's ``NamedSharding``s. A cell builds against a ``DeviceMesh`` of
the process group, where ``fn`` runs, or a device-free
``launch.mesh.MeshShape``, where only its shapes and counts are read
(``launch/dryrun.py``). ``meta`` holds the per-device counts the dry run
reports in place of XLA's compiled statistics (``launch/hlo_stats.py``).

**The LM family** (``LMArch``). Four cells a config: ``train_4k``,
``prefill_32k``, ``decode_32k``, ``long_500k``, with the reference's
switches, so every per-device shape equals the reference's: prefill runs
chunked attention with chunks of 2,048; MoE training turns expert
gathering off; decode drops the gathering hints and keeps the weights
TP-only (no FSDP) where they fit 8 GiB a model shard (``tp_fits``);
``long_500k`` splits its cache's sequence over every axis and
replicates the batch. The placements are the reference's
(``lm_param_specs``, ``kv_cache_spec``).

On a ``DeviceMesh`` a rank passes its own block of every input that is
split — the batch's rows over the data axes, the cache's sequence slice
(``dist.sharding.shard_block``) — and the WHOLE weights and optimizer
state, and gets back its block of every output under
``out_shardings``: train steps average their gradients over the data
axes, decode runs ``dist.collectives.flash_decode_shardmap`` over the
cache's sequence axes and writes a new token only into the rank that
holds its position. An MoE layer routes the rank's own rows, so its
capacity and its load-balance loss follow the rank's share of the batch
(the reference's jit routes the global batch; with one data rank, as on
one card, the two are the same). Running
the reference's tensor- and FSDP-parallel
weight placements for real is ROADMAP A12: ``build_cell(...,
weights="placed")`` raises naming it.

The GNN and RecSys families (``GNNArch``, ``RecsysArch``) are still to
port (ROADMAP A11).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import numpy as np
import torch
import torch.distributed as dist

from .. import resolve_device
from ..dist import sharding as shd
from ..dist.sharding import P
from ..models import transformer as tf_m
from ..train.optimizer import OptimizerConfig, make_optimizer
from ..train.train_step import make_train_step
from ..tree import tree_map

__all__ = ["Cell", "BaseArch", "LMArch", "LM_SHAPES", "count_abstract_params",
           "device_counts"]


@dataclasses.dataclass
class Cell:
    arch: str
    shape: str
    kind: str  # train | prefill | decode | serve
    fn: Callable
    input_structs: tuple
    in_shardings: tuple
    out_shardings: Any
    model_flops: float  # useful work of one executed step, global
    meta: dict


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)) and not isinstance(tree, torch.Size):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def count_abstract_params(tree) -> int:
    """Elements over every leaf of a tree of tensors (``meta`` or not)."""
    return sum(math.prod(leaf.shape) for leaf in _leaves(tree))


def _struct(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def _nbytes(t: torch.Tensor, shape=None) -> int:
    return math.prod(t.shape if shape is None else shape) * t.element_size()


def _device_bytes(mesh, structs, placements) -> int:
    """Bytes one device holds of ``structs`` (a tree) under ``placements``
    (the same tree of ``Placement``s; None: every leaf replicated)."""
    if isinstance(structs, dict):
        return sum(_device_bytes(mesh, structs[k], None if placements is None else placements[k])
                   for k in structs)
    if isinstance(structs, (tuple, list)):
        return sum(_device_bytes(mesh, s, None if placements is None else placements[i])
                   for i, s in enumerate(structs))
    return _nbytes(structs, None if placements is None else placements.shard_shape(structs.shape))


def device_counts(mesh, structs, in_sh, out, out_sh, flops: float, collective: dict) -> dict:
    """The per-device counts the dry run reports (``launch/hlo_stats.py``):
    input and output bytes under their placements, the useful flops
    split evenly, and the collectives' result bytes by op."""
    n_chips = shd.mesh_size(mesh)
    arg = _device_bytes(mesh, structs, in_sh)
    res = _device_bytes(mesh, out, out_sh)
    return {"argument_bytes": arg, "output_bytes": res, "device_bytes": float(arg + res),
            "device_flops": flops / n_chips, "collectives_by_op": collective,
            "collective_bytes": float(sum(collective.values()))}


class _OnFirstCall:
    """A cell's step, made at its first call on the device its inputs lie
    on (a mesh program takes the rank's coordinate and groups, which a
    ``MeshShape`` does not have): ``make(device, *args)`` builds it, again
    when the device or ``key(*args)`` changes. The device is the last
    argument's (a tensor, or a dict's first tensor), else ``cuda``."""

    def __init__(self, mesh, make, key=lambda *args: None):
        self.mesh, self.make, self.key = mesh, make, key
        self.fn, self.made_for = None, None

    def __call__(self, *args):
        from ..launch.mesh import MeshShape

        if isinstance(self.mesh, MeshShape):
            raise ValueError(f"a cell built on {self.mesh} has shapes only; build it on a "
                             f"DeviceMesh of the process group to run it")
        last = args[-1]
        if isinstance(last, dict):
            last = next((v for v in _leaves(last) if isinstance(v, torch.Tensor)), None)
        device = last.device if isinstance(last, torch.Tensor) else resolve_device(None)
        made_for = (device, self.key(*args))
        if self.fn is None or made_for != self.made_for:
            self.fn, self.made_for = self.make(device, *args), made_for
        return self.fn(*args)


class BaseArch:
    # bare annotations only: a default here would become a subclass
    # dataclass field's default
    name: str
    family: str
    shape_names: tuple[str, ...]

    def build_cell(self, shape: str, mesh) -> Cell:
        raise NotImplementedError

    def smoke(self, seed: int = 0) -> dict:
        """A tiny end-to-end run → a dict of its checks."""
        raise NotImplementedError


# ---------------------------------------------------------------------------
# optimizer-state spec mirroring
# ---------------------------------------------------------------------------


def _adamw_state_specs(param_specs):
    return {"m": param_specs, "v": param_specs, "step": P()}


def _adafactor_state_specs(param_specs, abstract_params, opt_cfg: OptimizerConfig):
    from ..train.optimizer import _factored

    def one(spec, p):
        if _factored(p, opt_cfg):
            return {
                "vr": P(*spec[: p.dim() - 1]) if len(spec) else P(),
                "vc": P(*spec[: p.dim() - 2], *spec[p.dim() - 1: p.dim()]) if len(spec) else P(),
            }
        return {"v": spec}

    return {"second": tree_map(one, param_specs, abstract_params), "step": P()}


def _state_specs(param_specs, abstract_params, opt_cfg: OptimizerConfig):
    if opt_cfg.name == "adamw":
        opt = _adamw_state_specs(param_specs)
    else:
        opt = _adafactor_state_specs(param_specs, abstract_params, opt_cfg)
    return {"params": param_specs, "opt": opt}


# ---------------------------------------------------------------------------
# LM family
# ---------------------------------------------------------------------------

LM_SHAPES = {
    "train_4k": dict(kind="train", seq_len=4096, global_batch=256),
    "prefill_32k": dict(kind="prefill", seq_len=32768, global_batch=32),
    "decode_32k": dict(kind="decode", seq_len=32768, global_batch=128),
    "long_500k": dict(kind="decode", seq_len=524288, global_batch=1),
}


def _group_mean(t: torch.Tensor, group, n: int) -> torch.Tensor:
    """The mean of ``t`` over the ranks of ``group`` (``n`` of them); under
    gloo a CUDA tensor crosses as a host copy."""
    wire = t.detach().float().contiguous()
    if wire.is_cuda and dist.get_backend(group) == "gloo":
        wire = wire.cpu()
    dist.all_reduce(wire, op=dist.ReduceOp.SUM, group=group)
    return (wire / n).to(device=t.device, dtype=t.dtype)


def _unsplit_batch(spec, batch_dim: int):
    """``spec`` with its batch entry dropped (a rank's output already holds
    its batch rows only)."""
    return P(*[None if d == batch_dim else e for d, e in enumerate(spec)])


@dataclasses.dataclass
class LMArch(BaseArch):
    name: str
    cfg: tf_m.TransformerConfig
    optimizer: OptimizerConfig
    family: str = "lm"
    microbatches: int = 1
    shape_names: tuple[str, ...] = tuple(LM_SHAPES)
    smoke_cfg: tf_m.TransformerConfig | None = None

    # -- abstract state ---------------------------------------------------
    def abstract_params(self):
        """The parameter tree as ``meta`` tensors (kimi-k2's 1.03T
        parameters are never allocated)."""
        return tf_m.param_structs(self.cfg)

    def model_flops(self, shape: str, global_batch: int | None = None) -> float:
        """6 · N_active · tokens (train counts fwd+bwd ⇒ 3× fwd pair), at
        the shape's batch unless ``global_batch`` is given."""
        sh = LM_SHAPES[shape]
        n = self._active_params()
        B = sh["global_batch"] if global_batch is None else global_batch
        tokens = B * (sh["seq_len"] if sh["kind"] != "decode" else 1)
        per_tok = 6.0 * n if sh["kind"] == "train" else 2.0 * n
        return per_tok * tokens

    def _active_params(self) -> float:
        c = self.cfg
        dh = c.head_dim
        attn = c.d_model * dh * (2 * c.n_heads + 2 * c.n_kv_heads)
        if c.moe is None:
            ffn = 3 * c.d_model * c.d_ff
        else:
            ffn = 3 * c.d_model * c.moe.d_ff * (c.moe.top_k + c.moe.n_shared_experts)
            ffn += c.d_model * c.moe.n_experts  # router
        body = c.n_layers * (attn + ffn)
        embed = c.vocab * c.d_model * (1 if c.tie_embeddings else 2)
        return float(body + embed)

    def cell_cfg(self, shape: str) -> tf_m.TransformerConfig:
        """The model config a cell of ``shape`` runs (the reference's
        switches: chunked attention for prefill, expert gathering off for
        MoE training, every gathering hint off for decode)."""
        kind = LM_SHAPES[shape]["kind"]
        cfg = self.cfg
        if shape == "prefill_32k":
            cfg = dataclasses.replace(cfg, attention_impl="chunked", attention_chunk=2048)
        if cfg.moe is not None and kind == "train":
            cfg = dataclasses.replace(
                cfg, moe=dataclasses.replace(cfg.moe, jit_weight_gather=False))
        if kind == "decode":
            moe = cfg.moe and dataclasses.replace(cfg.moe, jit_weight_gather=False)
            cfg = dataclasses.replace(cfg, jit_weight_gather=False, moe=moe)
        return cfg

    def tp_fits(self, mesh) -> bool:
        """Decode keeps the weights TP-only (no FSDP) when a model shard of
        the bf16 weights fits 8 GiB."""
        param_bytes = count_abstract_params(self.abstract_params()) * 2  # bf16
        return param_bytes / shd.axis_size(mesh, "model") <= 8 * 2**30

    # -- cells -------------------------------------------------------------
    def build_cell(self, shape: str, mesh, *, weights: str = "whole",
                   global_batch: int | None = None) -> Cell:
        """The cell of ``shape`` on ``mesh`` (a ``DeviceMesh`` or a
        ``MeshShape``). ``weights="whole"``: every rank holds every weight
        (the placements still describe the reference's layout for the dry
        run); ``"placed"`` would run the tensor- and FSDP-parallel
        placements and raises (ROADMAP A12). ``global_batch`` sizes the
        cell's structs and counts for another batch than the shape's (a
        run on one card cuts it); the step takes any batch."""
        from ..launch.hlo_stats import lm_collectives

        if weights != "whole":
            raise NotImplementedError(
                f"{self.name} × {shape}: running the tensor- and FSDP-parallel weight "
                f"placements (weights={weights!r}) is not ported yet (ROADMAP A12); "
                f"weights='whole' holds every weight on every rank")
        sh = LM_SHAPES[shape]
        kind, S = sh["kind"], sh["seq_len"]
        B = sh["global_batch"] if global_batch is None else global_batch
        cfg = self.cell_cfg(shape)
        da = shd.data_axes(mesh)
        abs_params = self.abstract_params()
        n_params = count_abstract_params(abs_params)
        flops = self.model_flops(shape, B)
        if kind == "decode":
            pspecs = shd.lm_param_specs(cfg, mesh, fsdp=not self.tp_fits(mesh))
        else:
            pspecs = shd.lm_param_specs(cfg, mesh)

        if kind == "train":
            oinit, oupd = make_optimizer(self.optimizer)
            abs_state = {"params": abs_params, "opt": oinit(abs_params)}
            sspecs = _state_specs(pspecs, abs_params, self.optimizer)
            bspec = {"tokens": P(da, None), "labels": P(da, None)}
            structs = (abs_state, {"tokens": _struct((B, S), torch.int32),
                                   "labels": _struct((B, S), torch.int32)})
            in_sh = (shd.to_shardings(mesh, sspecs), shd.to_shardings(mesh, bspec))
            out_sh = (shd.to_shardings(mesh, sspecs), None)
            metric_names = ["loss", "lr", "grad_norm"] + (["nll"] if self.microbatches == 1
                                                          else [])
            out = (abs_state, {k: _struct((), torch.float32) for k in metric_names})
            fn = _OnFirstCall(mesh, lambda *_: self._train_step(cfg, mesh, oupd))
            meta = {"tokens_per_step": B * S, "params": n_params}
        elif kind == "prefill":
            cache_spec = shd.kv_cache_spec(mesh, batch=B, seq_shard=False)
            structs = (abs_params, _struct((B, S), torch.int32))
            in_sh = (shd.to_shardings(mesh, pspecs), shd.to_shardings(mesh, P(da, None)))
            out_spec = (P(da, "model"), cache_spec)
            out_sh = shd.to_shardings(mesh, out_spec)
            out = (_struct((B, cfg.vocab), cfg.dtype),
                   tf_m.init_kv_cache(cfg, B, S, device="meta"))
            fn = _OnFirstCall(mesh, lambda *_: self._prefill(cfg, mesh, out_spec))
            meta = {"tokens_per_step": B * S, "params": n_params}
        else:
            seq_shard = shape == "long_500k"
            cache_spec = shd.kv_cache_spec(mesh, batch=B, seq_shard=seq_shard)
            batch_axes, seq_axes = ((), (*da, "model")) if seq_shard else (da, ("model",))
            cache = tf_m.init_kv_cache(cfg, B, S, device="meta")
            structs = (abs_params, cache, _struct((B, 1), torch.int32),
                       _struct((B,), torch.int32))
            tok_spec = P(None, None) if seq_shard else P(da, None)
            len_spec = P(None) if seq_shard else P(da)
            logits_spec = P(None, "model") if seq_shard else P(da, "model")
            in_sh = (shd.to_shardings(mesh, pspecs), shd.to_shardings(mesh, cache_spec),
                     shd.to_shardings(mesh, tok_spec), shd.to_shardings(mesh, len_spec))
            out_sh = (shd.to_shardings(mesh, logits_spec), shd.to_shardings(mesh, cache_spec))
            out = (_struct((B, cfg.vocab), cfg.dtype), cache)
            fn = _OnFirstCall(mesh, lambda *_: self._decode(cfg, mesh, batch_axes, seq_axes,
                                                             logits_spec))
            meta = {"tokens_per_step": B, "params": n_params,
                    "kv_bytes": sum(_nbytes(t) for t in cache.values())}
        collective = lm_collectives(cfg, mesh, kind, pspecs, abs_params, batch=B, seq=S,
                                    microbatches=self.microbatches,
                                    seq_axes=(seq_axes if kind == "decode" else ()),
                                    batch_split=not (kind == "decode" and seq_shard))
        return Cell(self.name, shape, kind, fn, structs, in_sh, out_sh, flops,
                    {**meta, **device_counts(mesh, structs, in_sh, out, out_sh, flops,
                                             collective)})

    # -- a rank's steps ------------------------------------------------------
    def _train_step(self, cfg, mesh, oupd):
        """The reference's train step over the rank's rows of the batch;
        with more than one data rank the gradients (and the loss) are
        averaged over the data axes before the optimizer applies them."""
        da = shd.data_axes(mesh)
        n = shd.axis_size(mesh, da) if da else 1
        group = shd.axes_group(mesh, da) if n > 1 else None

        def update(grads, opt, params):
            if group is not None:
                grads = tree_map(lambda g: _group_mean(g, group, n), grads)
            return oupd(grads, opt, params)

        step = make_train_step(lambda p, b: tf_m.lm_loss(p, cfg, b["tokens"], b["labels"]),
                               update, microbatches=self.microbatches)

        def train(state, batch):
            state, metrics = step(state, batch)
            if group is not None:
                metrics["loss"] = _group_mean(metrics["loss"], group, n)
            return state, metrics

        return train

    def _prefill(self, cfg, mesh, out_spec):
        logits_spec, cache_spec = out_spec

        def prefill(params, tokens):
            with torch.no_grad():
                logits, aux = tf_m.forward(params, cfg, tokens, collect_kv=True)
            last = logits[:, -1, :]
            del logits
            last = shd.shard_block(last, _unsplit_batch(logits_spec, 0), mesh).contiguous()
            cache = {k: shd.shard_block(v, _unsplit_batch(cache_spec[k], 1), mesh).contiguous()
                     for k, v in aux["kv_cache"].items()}
            return last, cache

        return prefill

    def _decode(self, cfg, mesh, batch_axes, seq_axes, logits_spec):
        from ..dist.collectives import flash_decode_shardmap

        attn_fn = flash_decode_shardmap(mesh, batch_axes=batch_axes, seq_axes=seq_axes)
        idx, n_seq = shd.axis_index(mesh, seq_axes), shd.axis_size(mesh, seq_axes)

        def decode(params, cache, tokens, lengths):
            S_local = cache["k"].shape[2]
            with torch.no_grad():
                logits, cache = tf_m.decode_step(params, cfg, cache, tokens, lengths, attn_fn,
                                                 seq_start=idx * S_local,
                                                 seq_len=S_local * n_seq)
            return shd.shard_block(logits, _unsplit_batch(logits_spec, 0), mesh).contiguous(), \
                cache

        return decode

    # -- smoke -------------------------------------------------------------
    def smoke(self, seed: int = 0, device=None) -> dict:
        """Two train steps, a forward and a decode step of the smoke config
        on ``device`` (``cuda`` unless given). The weights come from a CPU
        generator seeded with ``seed`` and the tokens from numpy, so a run
        on the card and one on the CPU start from the same bits."""
        cfg = self.smoke_cfg
        if cfg is None:
            raise ValueError(f"{self.name}: no smoke config")
        dev = resolve_device(device)
        params = tf_m.init_params(torch.Generator().manual_seed(seed), cfg, device=dev)
        toks = torch.from_numpy(
            np.random.default_rng(seed).integers(0, cfg.vocab, size=(2, 16))).to(dev)
        opt = OptimizerConfig(name=self.optimizer.name, lr=1e-3, warmup_steps=2, total_steps=10)
        oinit, oupd = make_optimizer(opt)
        step = make_train_step(lambda p, b: tf_m.lm_loss(p, cfg, b["tokens"], b["labels"]), oupd)
        state = {"params": params, "opt": oinit(params)}
        batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        state, m1 = step(state, batch)
        state, m2 = step(state, batch)
        with torch.no_grad():
            logits, _ = tf_m.forward(params, cfg, toks)
            cache = tf_m.init_kv_cache(cfg, 2, 8, device=dev)
            lg, cache = tf_m.decode_step(params, cfg, cache, toks[:, :1],
                                         torch.zeros(2, dtype=torch.int32, device=dev))
        if tuple(logits.shape) != (2, 16, cfg.vocab) or not torch.isfinite(m2["loss"]):
            raise RuntimeError(f"{self.name} smoke: logits {tuple(logits.shape)}, "
                               f"loss {float(m2['loss'])}")
        if tuple(lg.shape) != (2, cfg.vocab) or not bool(torch.isfinite(lg).all()):
            raise RuntimeError(f"{self.name} smoke: decode logits {tuple(lg.shape)} not finite")
        return {"loss0": float(m1["loss"]), "loss1": float(m2["loss"]),
                "logits": logits.float().cpu(), "decode_logits": lg.float().cpu(),
                "device": dev.type}
