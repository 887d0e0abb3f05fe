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
(``dist.sharding.shard_block``) — and gets back its block of every
output under ``out_shardings``; decode runs
``dist.collectives.flash_decode_shardmap`` over the cache's sequence
axes and writes a new token only into the rank that holds its position.
The weights come one of two ways:

* ``weights="placed"``: the reference's placements run for real. A rank
  holds its block of every weight and optimizer leaf (``LMArch.place``
  cuts a whole tree, e.g. the reference's through ``params_from_jax``)
  and runs ``models.transformer``'s placed program: tensor-, vocab- and
  expert-parallel over ``model``, FSDP over the data axes (gathered
  before use, gradients reduce-scattered), MoE layers routing the
  global batch; the optimizer takes its norms and factored means over
  the full leaves (``train/optimizer.py``). A mesh whose groups cannot
  form raises; nothing falls back to whole weights.
* ``weights="whole"`` (the default): every rank holds every weight; train
  steps average their gradients over the data axes, and an MoE layer
  routes the rank's own rows (its capacity and load-balance loss follow
  the rank's share of the batch; with one data rank the two agree).

**The GNN family** (``GNNArch``, GAT). Four train cells:
``full_graph_sm`` (Cora), ``minibatch_lg`` (a sampled Reddit subgraph),
``ogb_products`` and ``molecule`` (128 small graphs, a graph-level
loss), with the reference's budgets. Parameters are replicated; at
``opt`` 0 the node and edge arrays split over the data axes
(``gnn_batch_spec``) and a rank all-gathers its blocks and takes the
whole loss; at ``opt`` ≥ 1 ``full_graph_sm`` and ``ogb_products`` run
the dst-aligned edge-sharded layer over every axis
(``models.gnn.gat_loss_edge_sharded``; the caller splits the edges with
``partition_edges_by_dst``).

**The RecSys family** (``RecsysArch``: DeepFM, DCN-v2, SASRec, DIN). Four
cells: ``train_batch``, ``serve_p99``, ``serve_bulk`` and
``retrieval_cand`` (one user against 1,000,448 candidates). A rank passes
its block of the batch (of the candidates, over every axis); train steps
average their gradients over the data axes. ``weights="placed"`` runs
the tables' placements (``recsys_param_specs``: every ``embed*`` table
and DeepFM's ``linear`` row-split over ``model``): a lookup gathers the
rank's rows for the ids in its range, sums the partial rows over
``model``, and its backward writes the rank's own rows only
(``models.recsys.row_split``). GAT's parameters are replicated, so its
placed cells run the whole-weight step.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import numpy as np
import torch
import torch.distributed as dist

from .. import resolve_device
from ..dist import placed as plc
from ..dist import sharding as shd
from ..dist.sharding import P, Placement
from ..models import gnn as gnn_m
from ..models import recsys as rec_m
from ..models import transformer as tf_m
from ..train.optimizer import OptimizerConfig, make_optimizer
from ..train.train_step import make_train_step
from ..tree import tree_map

__all__ = ["Cell", "BaseArch", "LMArch", "GNNArch", "RecsysArch", "LM_SHAPES", "GNN_SHAPES",
           "REC_SHAPES", "count_abstract_params", "device_counts"]


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


def _data_parallel_step(loss_fn, oupd, mesh, microbatches: int = 1):
    """The reference's train step over the rank's rows of the batch; with
    more than one data rank the gradients (and the loss) are averaged
    over the data axes before the optimizer applies them."""
    da = shd.data_axes(mesh)
    n = shd.axis_size(mesh, da) if da else 1
    group = shd.axes_group(mesh, da) if n > 1 else None

    def update(grads, opt, params):
        if group is not None:
            grads = tree_map(lambda g: _group_mean(g, group, n), grads)
        return oupd(grads, opt, params)

    step = make_train_step(loss_fn, update, microbatches=microbatches)

    def train(state, batch):
        state, metrics = step(state, batch)
        if group is not None:
            metrics["loss"] = _group_mean(metrics["loss"], group, n)
        return state, metrics

    return train


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
    #: decode's FSDP choice, where it is not ``tp_fits``' (a cut-depth copy
    #: of a config keeps the full config's placements)
    decode_fsdp: bool | None = None

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

    # -- placements --------------------------------------------------------
    def param_specs(self, shape: str, mesh):
        """The parameters' placements in ``shape``'s cell (decode keeps them
        TP-only where ``tp_fits``)."""
        cfg = self.cell_cfg(shape)
        if LM_SHAPES[shape]["kind"] == "decode":
            fsdp = not self.tp_fits(mesh) if self.decode_fsdp is None else self.decode_fsdp
            return shd.lm_param_specs(cfg, mesh, fsdp=fsdp)
        return shd.lm_param_specs(cfg, mesh)

    def tree_shards(self, shape: str, mesh) -> plc.TreeShards:
        return plc.TreeShards(mesh, plc.leaf_shards(self.abstract_params(),
                                                    self.param_specs(shape, mesh)))

    def place(self, shape: str, mesh, params, opt_state=None):
        """The rank's blocks of a whole parameter tree (``init_params``, or
        the reference's through ``params_from_jax``) for ``shape``'s placed
        cell on ``mesh`` (a ``DeviceMesh``); a train cell's state is
        ``{"params", "opt"}`` with ``opt_state`` placed too, or
        initialised on the rank's blocks."""
        pspecs = self.param_specs(shape, mesh)
        placed = plc.place_tree(params, pspecs, mesh)
        if LM_SHAPES[shape]["kind"] != "train":
            return placed
        if opt_state is None:
            opt = make_optimizer(self.optimizer, self.tree_shards(shape, mesh))[0](placed)
        else:
            sspecs = _state_specs(pspecs, self.abstract_params(), self.optimizer)
            opt = plc.place_tree(opt_state, sspecs["opt"], mesh)
        return {"params": placed, "opt": opt}

    # -- cells -------------------------------------------------------------
    def build_cell(self, shape: str, mesh, *, weights: str = "whole",
                   global_batch: int | None = None) -> Cell:
        """The cell of ``shape`` on ``mesh`` (a ``DeviceMesh`` or a
        ``MeshShape``). ``weights="whole"``: every rank holds every weight
        (the placements still describe the reference's layout for the dry
        run); ``"placed"``: a rank holds and passes its blocks (``place``)
        and runs the tensor-, vocab-, expert- and FSDP-parallel program.
        ``global_batch`` sizes the cell's structs and counts for another
        batch than the shape's (a run on one card cuts it); the step takes
        any batch."""
        from ..launch.hlo_stats import lm_collectives

        placed = _weights_placed(weights)
        sh = LM_SHAPES[shape]
        kind, S = sh["kind"], sh["seq_len"]
        B = sh["global_batch"] if global_batch is None else global_batch
        cfg = self.cell_cfg(shape)
        da = shd.data_axes(mesh)
        abs_params = self.abstract_params()
        n_params = count_abstract_params(abs_params)
        flops = self.model_flops(shape, B)
        pspecs = self.param_specs(shape, mesh)

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
            if placed:
                fn = _OnFirstCall(mesh, lambda *_: self._train_placed(cfg, mesh, shape, pspecs))
            else:
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
            fn = _OnFirstCall(mesh, lambda *_: self._prefill(
                cfg, mesh, out_spec,
                tf_m.LMPlacement(cfg, mesh, pspecs, collect_kv=True) if placed else None))
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
            pl = ((lambda: tf_m.LMPlacement(cfg, mesh, pspecs, batch_split=not seq_shard))
                  if placed else (lambda: None))
            fn = _OnFirstCall(mesh, lambda *_: self._decode(cfg, mesh, batch_axes, seq_axes,
                                                             logits_spec, pl()))
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
        return _data_parallel_step(
            lambda p, b: tf_m.lm_loss(p, cfg, b["tokens"], b["labels"]), oupd, mesh,
            microbatches=self.microbatches)

    def _train_placed(self, cfg, mesh, shape, pspecs):
        pl = tf_m.LMPlacement(cfg, mesh, pspecs)
        return _placed_step(lambda p, b: tf_m.lm_loss(p, cfg, b["tokens"], b["labels"], pl=pl),
                            self.optimizer, self.tree_shards(shape, mesh), pspecs,
                            microbatches=self.microbatches)

    def _prefill(self, cfg, mesh, out_spec, pl=None):
        logits_spec, cache_spec = out_spec

        def prefill(params, tokens):
            with torch.no_grad():
                logits, aux = tf_m.forward(params, cfg, tokens, collect_kv=True, pl=pl)
            last = logits[:, -1, :]
            del logits
            if pl is None or not pl.head_split:
                last = shd.shard_block(last, _unsplit_batch(logits_spec, 0), mesh)
            if pl is None:
                cache = {k: shd.shard_block(v, _unsplit_batch(cache_spec[k], 1), mesh)
                         for k, v in aux["kv_cache"].items()}
            else:  # the placed forward gives the rank's sequence block
                cache = aux["kv_cache"]
            return last.contiguous(), {k: v.contiguous() for k, v in cache.items()}

        return prefill

    def _decode(self, cfg, mesh, batch_axes, seq_axes, logits_spec, pl=None):
        from ..dist.collectives import flash_decode_shardmap

        attn_fn = flash_decode_shardmap(mesh, batch_axes=batch_axes, seq_axes=seq_axes)
        idx, n_seq = shd.axis_index(mesh, seq_axes), shd.axis_size(mesh, seq_axes)

        def decode(params, cache, tokens, lengths):
            S_local = cache["k"].shape[2]
            with torch.no_grad():
                logits, cache = tf_m.decode_step(params, cfg, cache, tokens, lengths, attn_fn,
                                                 seq_start=idx * S_local,
                                                 seq_len=S_local * n_seq, pl=pl)
            if pl is None or not pl.head_split:
                logits = shd.shard_block(logits, _unsplit_batch(logits_spec, 0), mesh)
            return logits.contiguous(), cache

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


def _weights_placed(weights: str) -> bool:
    """``weights="placed"`` → True, ``"whole"`` → False."""
    if weights not in ("whole", "placed"):
        raise ValueError(f"weights={weights!r}: 'whole' (every weight on every rank) or "
                         f"'placed' (the reference's placements)")
    return weights == "placed"


def _placed_step(loss_fn, opt_cfg: OptimizerConfig, shards: plc.TreeShards, pspecs,
                 microbatches: int = 1):
    """A placed train step: ``loss_fn`` on the rank's blocks; a gradient
    split over the data axes arrives summed over them (its FSDP gather's
    reduce-scatter), any other is summed here; both are divided by the
    data ranks (the mean of the ranks' losses, as ``_data_parallel_step``
    takes), then the optimizer runs on the rank's blocks. A rank with
    fewer rows than ``microbatches`` (deepseek's 16 on 512 devices, 8
    rows a rank) runs ``gcd(microbatches, rows)`` of them: the reference
    splits the global batch and XLA places the pieces."""
    mesh = shards.mesh
    da = shd.data_axes(mesh)
    n = shd.axis_size(mesh, da) if da else 1
    _, oupd = make_optimizer(opt_cfg, shards)
    split = tree_map(lambda s: plc.data_split(s, mesh), pspecs)

    def mean(g, summed):
        g32 = g.float() if summed else plc.psum(g.float(), mesh, da)
        return (g32 / n).to(g.dtype)

    def update(grads, opt, params):
        return oupd(tree_map(mean, grads, split), opt, params)

    steps = {}

    def train(state, batch):
        mb = math.gcd(microbatches, next(iter(batch.values())).shape[0])
        if mb not in steps:
            steps[mb] = make_train_step(loss_fn, update, microbatches=mb)
        state, metrics = steps[mb](state, batch)
        metrics["loss"] = plc.psum(metrics["loss"].float(), mesh, da) / n
        return state, metrics

    return train


def _metrics(*names: str) -> dict:
    """A train step's metrics as ``meta`` scalars: the loss, the
    optimizer's lr and grad_norm, then the loss's own."""
    return {k: _struct((), torch.float32) for k in ("loss", "lr", "grad_norm", *names)}


# ---------------------------------------------------------------------------
# GNN family (GAT)
# ---------------------------------------------------------------------------

# Static budgets are padded to multiples of 512 so node and edge arrays
# split over the 512-device multi-pod mesh (sentinel padding is neutral —
# see models/gnn.py). The datasets' true sizes are kept in ``true_*``.
GNN_SHAPES = {
    "full_graph_sm": dict(
        kind="train", n_nodes=3071, n_edges=10752, d_feat=1433, n_classes=7,
        true_nodes=2708, true_edges=10556,  # Cora
    ),
    "minibatch_lg": dict(
        kind="train", n_nodes=170_495, n_edges=168_960, d_feat=602, n_classes=41,
        sampled=True, batch_nodes=1024, fanout=(15, 10),
        true_nodes=232_965, true_edges=114_615_892,  # Reddit (sampled)
    ),
    "ogb_products": dict(
        kind="train", n_nodes=2_449_407, n_edges=61_865_984, d_feat=100, n_classes=47,
        true_nodes=2_449_029, true_edges=61_859_140,  # ogbn-products
    ),
    "molecule": dict(
        kind="train", n_nodes=4095, n_edges=8192, d_feat=16, n_classes=2,
        graphs=128, true_nodes=30 * 128, true_edges=64 * 128,
    ),
}


@dataclasses.dataclass
class GNNArch(BaseArch):
    """GAT configs. ``opt`` 0: the node and edge arrays split over the data
    axes (``gnn_batch_spec``); a rank all-gathers the blocks and computes
    the whole loss, so the replicated parameters get the same gradient
    on every rank. ``opt`` ≥ 1 (``full_graph_sm`` and ``ogb_products``):
    the dst-aligned edge-sharded layer (``models.gnn.
    gat_loss_edge_sharded``, one all-gather a layer) over every axis;
    ``opt`` ≥ 2 gathers the narrower side of each projection."""

    name: str
    n_layers: int = 2
    d_hidden: int = 8
    n_heads: int = 8
    family: str = "gnn"
    optimizer: OptimizerConfig = dataclasses.field(
        default_factory=lambda: OptimizerConfig(lr=5e-3, weight_decay=5e-4)
    )
    shape_names: tuple[str, ...] = tuple(GNN_SHAPES)
    opt: int = 0

    def _cfg(self, shape: str) -> gnn_m.GATConfig:
        sh = GNN_SHAPES[shape]
        return gnn_m.GATConfig(
            name=self.name, n_layers=self.n_layers, d_in=sh["d_feat"],
            d_hidden=self.d_hidden, n_heads=self.n_heads, n_classes=sh["n_classes"],
        )

    def abstract_params(self, shape: str):
        return gnn_m.gat_init(torch.Generator(), self._cfg(shape), device="meta")

    def edge_sharded(self, shape: str) -> bool:
        """Whether ``shape``'s cell runs the edge-sharded layer."""
        sh = GNN_SHAPES[shape]
        return self.opt >= 1 and not sh.get("graphs") and not sh.get("sampled")

    def model_flops(self, shape: str) -> float:
        sh = GNN_SHAPES[shape]
        cfg = self._cfg(shape)
        N, E = sh["n_nodes"], sh["n_edges"]
        H, d = cfg.n_heads, cfg.d_hidden
        l1 = N * cfg.d_in * H * d * 2 + E * H * (4 * d)
        l2 = N * (H * d) * H * cfg.n_classes * 2 + E * H * 4 * cfg.n_classes
        return 3.0 * (l1 + l2)  # fwd+bwd

    def build_cell(self, shape: str, mesh, *, weights: str = "whole") -> Cell:
        """The train cell of ``shape`` on ``mesh`` (a ``DeviceMesh`` or a
        ``MeshShape``) at the shape's budgets."""
        from ..launch.hlo_stats import gnn_collectives

        _weights_placed(weights)  # replicated parameters: placed is the whole step
        sh = GNN_SHAPES[shape]
        cfg = self._cfg(shape)
        N, E = sh["n_nodes"], sh["n_edges"]
        abs_params = self.abstract_params(shape)
        pspecs = shd.replicate(abs_params)
        oinit, oupd = make_optimizer(self.optimizer)
        graphs = sh.get("graphs")
        flat_axes = (*shd.data_axes(mesh), "model")
        use_sharded = self.edge_sharded(shape)
        abs_state = {"params": abs_params, "opt": oinit(abs_params)}
        sspecs = _state_specs(pspecs, abs_params, self.optimizer)
        bspec = shd.gnn_batch_spec(mesh)
        batch = {
            "x": _struct((N + 1, sh["d_feat"]), torch.float32),
            "edge_src": _struct((E,), torch.int32),
            "edge_dst": _struct((E,), torch.int32),
            "labels": _struct((N + 1,), torch.int32),
            "train_mask": _struct((N + 1,), torch.bool),
        }
        if graphs:
            batch["graph_ids"] = _struct((N + 1,), torch.int32)
            batch["graph_labels"] = _struct((graphs,), torch.int32)
            bspec = {**bspec, "graph_ids": P(shd.data_axes(mesh)), "graph_labels": P(None)}
        if use_sharded:
            # the dst-aligned contract: a float mask, nodes and edges over every axis
            batch["train_mask"] = _struct((N + 1,), torch.float32)
            bspec = {k: P(flat_axes, None) if k == "x" else P(flat_axes) for k in batch}
        structs = (abs_state, batch)
        in_sh = (shd.to_shardings(mesh, sspecs), shd.to_shardings(mesh, bspec))
        out_sh = (shd.to_shardings(mesh, sspecs), None)
        out = (abs_state, _metrics("acc"))
        flops = self.model_flops(shape)
        fn = _OnFirstCall(mesh, lambda *_: self._train_step(shape, mesh, oupd, use_sharded))
        collective = gnn_collectives(cfg, mesh, abs_params, batch, bspec,
                                     edge_sharded=use_sharded,
                                     min_side_gather=use_sharded and self.opt >= 2)
        meta = {"params": count_abstract_params(abs_params), "edges": E}
        return Cell(self.name, shape, "train", fn, structs, in_sh, out_sh, flops,
                    {**meta, **device_counts(mesh, structs, in_sh, out, out_sh, flops,
                                             collective)})

    def loss(self, shape: str):
        """The loss of ``shape``'s cell on a whole graph, ``(params, batch) →
        (loss, metrics)``: ``gat_graph_loss`` for batched graphs (``batch``
        holds ``graph_ids`` and ``graph_labels``), else ``gat_loss``."""
        cfg, graphs = self._cfg(shape), GNN_SHAPES[shape].get("graphs")

        def loss(p, b):
            b = dict(b)
            if graphs:
                gid, glab = b.pop("graph_ids"), b.pop("graph_labels")
                return gnn_m.gat_graph_loss(p, cfg, gnn_m.Graph(**b), gid, glab, graphs)
            return gnn_m.gat_loss(p, cfg, gnn_m.Graph(**b))

        return loss

    def _train_step(self, shape, mesh, oupd, use_sharded):
        """A rank's step. Edge-sharded: the rank's blocks go through
        ``gat_loss_edge_sharded``, whose gradients are whole on every rank.
        Otherwise the rank's blocks over the data axes are all-gathered
        and the whole loss taken."""
        if use_sharded:
            cfg, axes = self._cfg(shape), (*shd.data_axes(mesh), "model")
            return make_train_step(
                lambda p, b: gnn_m.gat_loss_edge_sharded(p, cfg, b, mesh, axes,
                                                         min_side_gather=self.opt >= 2),
                oupd)
        da = shd.data_axes(mesh)
        n = shd.axis_size(mesh, da) if da else 1

        def whole(v):
            wire = v.to(torch.uint8) if v.dtype == torch.bool else v  # gloo moves no bool
            return shd.all_gather(wire, mesh, da).flatten(0, 1).to(v.dtype)

        step = make_train_step(self.loss(shape), oupd)

        def train(state, batch):
            if n > 1:
                batch = {k: v if k == "graph_labels" else whole(v) for k, v in batch.items()}
            return step(state, batch)

        return train

    def smoke(self, seed: int = 0, device=None, params=None) -> dict:
        """Three train steps on a 64-node graph drawn from numpy at ``seed``
        (the reference's draws, in its order), then the sampler's smoke,
        on ``device`` (``cuda`` unless given). The weights come from a CPU
        generator seeded with ``seed``, or are ``params`` (a tree of
        tensors, e.g. the reference's through ``params_from_jax``)."""
        dev = resolve_device(device)
        rng = np.random.default_rng(seed)
        N, E, F, C = 64, 256, 12, 5
        cfg = gnn_m.GATConfig(name="smoke", d_in=F, n_classes=C, d_hidden=self.d_hidden,
                              n_heads=self.n_heads)
        g = gnn_m.pad_graph(
            rng.normal(size=(N, F)).astype(np.float32),
            rng.integers(0, N, size=(2, E)),
            rng.integers(0, C, size=N),
            rng.random(N) < 0.5,
            device=dev,
        )
        if params is None:
            params = gnn_m.gat_init(torch.Generator().manual_seed(seed), cfg, device=dev)
        else:
            params = tree_map(lambda t: t.to(dev), params)
        oinit, oupd = make_optimizer(self.optimizer)
        step = make_train_step(lambda p, b: gnn_m.gat_loss(p, cfg, gnn_m.Graph(**b)), oupd)
        state = {"params": params, "opt": oinit(params)}
        batch = dict(vars(g))
        losses = []
        for _ in range(3):
            state, m = step(state, batch)
            losses.append(float(m["loss"]))
        if not np.isfinite(losses).all():
            raise RuntimeError(f"{self.name} smoke: losses {losses}")
        smp = gnn_m.NeighborSampler(np.asarray(rng.integers(0, N, size=(2, E))), N)
        nid, es, ed = smp.sample_padded(np.arange(4), (3, 2), 64, 128)
        if len(nid) != 64 or len(es) != 128:
            raise RuntimeError(f"{self.name} smoke: sampler gave {len(nid)} / {len(es)}")
        return {"losses": losses, "sample": (nid, es, ed), "device": dev.type}


# ---------------------------------------------------------------------------
# RecSys family
# ---------------------------------------------------------------------------

REC_SHAPES = {
    "train_batch": dict(kind="train", batch=65_536),
    "serve_p99": dict(kind="serve", batch=512),
    "serve_bulk": dict(kind="serve", batch=262_144),
    # candidates padded 1,000,000 → 1,000,448 (divisible by the 512-device flat mesh)
    "retrieval_cand": dict(kind="serve", batch=1, n_candidates=1_000_448),
}

#: the field ``retrieval_cand`` varies for the CTR models (the reference's)
CAND_FIELD = 3


@dataclasses.dataclass
class RecsysArch(BaseArch):
    """RecSys configs. On a ``DeviceMesh`` the batch (and
    ``retrieval_cand``'s candidates, over every axis) splits as
    ``recsys_batch_spec`` says; a rank passes its block and holds whole
    tables, and train steps average their gradients over the data axes
    as ``LMArch`` does."""

    name: str
    cfg: Any = None
    family: str = "recsys"
    optimizer: OptimizerConfig = dataclasses.field(
        default_factory=lambda: OptimizerConfig(lr=1e-3)
    )
    shape_names: tuple[str, ...] = tuple(REC_SHAPES)
    smoke_cfg: Any = None

    # dispatch tables -------------------------------------------------------
    def _fns(self, cfg):
        m = cfg.name
        if m == "deepfm":
            return rec_m.deepfm_init, rec_m.deepfm_loss, rec_m.deepfm_forward
        if m == "dcn-v2":
            return rec_m.dcnv2_init, rec_m.dcnv2_loss, rec_m.dcnv2_forward
        if m == "sasrec":
            return rec_m.sasrec_init, rec_m.sasrec_loss, None
        if m == "din":
            return rec_m.din_init, rec_m.din_loss, None
        raise KeyError(m)

    def serve_fn(self, cfg=None):
        """``serve_p99`` / ``serve_bulk``'s batched forward, ``(params,
        batch) → [B]`` logits (SASRec: the last position's ``[B, D]``
        state)."""
        cfg = cfg or self.cfg
        m = cfg.name
        if m == "deepfm":
            return lambda p, b: rec_m.deepfm_forward(p, cfg, b["sparse"])
        if m == "dcn-v2":
            return lambda p, b: rec_m.dcnv2_forward(p, cfg, b["dense"], b["sparse"])
        if m == "sasrec":
            return lambda p, b: rec_m.sasrec_encode(p, cfg, b["seq"])[:, -1]
        return lambda p, b: rec_m.din_forward(p, cfg, b["hist"], b["target"])

    def abstract_params(self, cfg=None):
        """The parameter tree as ``meta`` tensors."""
        cfg = cfg or self.cfg
        return self._fns(cfg)[0](torch.Generator(), cfg, device="meta")

    def _batch_structs(self, cfg, B: int) -> dict:
        m = cfg.name
        if m == "deepfm":
            return {"sparse": _struct((B, cfg.n_fields), torch.int32),
                    "label": _struct((B,), torch.float32)}
        if m == "dcn-v2":
            return {
                "dense": _struct((B, cfg.n_dense), torch.float32),
                "sparse": _struct((B, cfg.n_fields), torch.int32),
                "label": _struct((B,), torch.float32),
            }
        if m == "sasrec":
            return {
                "seq": _struct((B, cfg.seq_len), torch.int32),
                "pos_label": _struct((B, cfg.seq_len), torch.int32),
                "neg_label": _struct((B, cfg.seq_len, cfg.n_negatives), torch.int32),
            }
        if m == "din":
            return {
                "hist": _struct((B, cfg.seq_len), torch.int32),
                "target": _struct((B,), torch.int32),
                "label": _struct((B,), torch.float32),
            }
        raise KeyError(m)

    def _smoke_batch(self, cfg, B: int, seed, device=None) -> dict:
        """A batch of ``B`` rows drawn from numpy at ``seed`` (an int or a
        sequence, e.g. ``(seed, step)``): ids in [0, 32), floats in [0, 1),
        leaf by leaf in the structs' order."""
        rng = np.random.default_rng(seed)
        dev = resolve_device(device)

        def rnd(s):
            if s.dtype == torch.int32:
                a = rng.integers(0, 32, size=tuple(s.shape)).astype(np.int32)
            else:
                a = rng.random(tuple(s.shape), dtype=np.float32)
            return torch.from_numpy(a).to(dev)

        return {k: rnd(s) for k, s in self._batch_structs(cfg, B).items()}

    def model_flops(self, shape: str, global_batch: int | None = None) -> float:
        cfg = self.cfg
        sh = REC_SHAPES[shape]
        B = sh.get("n_candidates", sh["batch"]) if shape == "retrieval_cand" else sh["batch"]
        B = B if global_batch is None else global_batch
        m = cfg.name
        if m == "deepfm":
            per = cfg.n_fields * cfg.embed_dim * (2 + 2 * cfg.mlp[0]) + sum(
                2 * a * b for a, b in zip(cfg.mlp[:-1], cfg.mlp[1:])
            )
        elif m == "dcn-v2":
            d = cfg.d_interact
            per = cfg.n_cross_layers * 2 * d * d + 2 * d * cfg.mlp[0] + sum(
                2 * a * b for a, b in zip(cfg.mlp[:-1], cfg.mlp[1:])
            )
        elif m == "sasrec":
            D, S = cfg.embed_dim, cfg.seq_len
            per = cfg.n_blocks * (8 * S * D * D + 4 * S * S * D) + S * D * 2 * (
                1 + cfg.n_negatives
            )
        else:  # din
            D, S = cfg.embed_dim, cfg.seq_len
            per = S * (2 * 4 * D * cfg.attn_mlp[0] + 2 * cfg.attn_mlp[0] * cfg.attn_mlp[1]) + \
                2 * 3 * D * cfg.mlp[0] + 2 * cfg.mlp[0] * cfg.mlp[1]
        mult = 3.0 if sh["kind"] == "train" else 1.0
        return float(per) * B * mult

    def build_cell(self, shape: str, mesh, *, weights: str = "whole",
                   global_batch: int | None = None) -> Cell:
        """The cell of ``shape`` on ``mesh`` (a ``DeviceMesh`` or a
        ``MeshShape``) at the shape's batch (candidates for
        ``retrieval_cand``), or at ``global_batch`` (a run on one card cuts
        it; the step takes any)."""
        from ..launch.hlo_stats import recsys_collectives

        placed = _weights_placed(weights)
        sh = REC_SHAPES[shape]
        cfg = self.cfg
        loss_fn_raw = self._fns(cfg)[1]
        abs_params = self.abstract_params()
        pspecs = shd.recsys_param_specs(cfg.name, abs_params, mesh)
        da = shd.data_axes(mesh)
        flat = (*da, "model")
        n_params = count_abstract_params(abs_params)
        flops = self.model_flops(shape, global_batch)
        f32 = torch.float32
        wrap = (lambda f: self._row_split(f, mesh, pspecs)) if placed else (lambda f: f)

        if sh["kind"] == "train":
            B = sh["batch"] if global_batch is None else global_batch
            oinit, oupd = make_optimizer(self.optimizer)
            abs_state = {"params": abs_params, "opt": oinit(abs_params)}
            sspecs = _state_specs(pspecs, abs_params, self.optimizer)
            bspec = shd.recsys_batch_spec(cfg.name, mesh)
            structs = (abs_state, self._batch_structs(cfg, B))
            in_sh = (shd.to_shardings(mesh, sspecs), shd.to_shardings(mesh, bspec))
            out_sh = (shd.to_shardings(mesh, sspecs), None)
            out = (abs_state, _metrics("hit_rate" if cfg.name == "sasrec" else "accuracy"))
            loss = wrap(lambda p, b: loss_fn_raw(p, cfg, b))
            if placed:
                fn = _OnFirstCall(mesh, lambda *_: _placed_step(
                    loss, self.optimizer, self.tree_shards(mesh), pspecs))
            else:
                fn = _OnFirstCall(mesh, lambda *_: _data_parallel_step(loss, oupd, mesh))
            meta = {"params": n_params}
            rows = B
        elif shape == "retrieval_cand":
            N = sh["n_candidates"] if global_batch is None else global_batch
            cand = _struct((N,), torch.int32)
            if cfg.name == "deepfm":
                user = (_struct((1, cfg.n_fields), torch.int32),)
                score = lambda p, u, c: rec_m.deepfm_score_candidates(p, cfg, u, c, CAND_FIELD)
            elif cfg.name == "dcn-v2":
                user = (_struct((1, cfg.n_dense), f32), _struct((1, cfg.n_fields), torch.int32))
                score = lambda p, ud, us, c: rec_m.dcnv2_score_candidates(p, cfg, ud, us, c,
                                                                          CAND_FIELD)
            elif cfg.name == "sasrec":
                user = (_struct((1, cfg.seq_len), torch.int32),)
                score = lambda p, s, c: rec_m.sasrec_score_candidates(p, cfg, s, c)
            else:  # din
                user = (_struct((cfg.seq_len,), torch.int32),)
                score = lambda p, h, c: rec_m.din_score_candidates(p, cfg, h, c)
            structs = (abs_params, *user, cand)
            in_sh = (shd.to_shardings(mesh, pspecs),
                     *(Placement(mesh, P(*([None] * u.dim()))) for u in user),
                     Placement(mesh, P(flat)))
            if cfg.name == "sasrec":
                out, out_sh = _struct((1, N), f32), Placement(mesh, P(None, flat))
            else:
                out, out_sh = _struct((N,), f32), Placement(mesh, P(flat))
            if placed:
                score = self._model_candidates(wrap(score), mesh)
            fn = _OnFirstCall(mesh, lambda *_: torch.no_grad()(score))
            meta = {"params": n_params, "candidates": N}
            rows = N
        else:  # serve_p99 / serve_bulk: a batched forward
            B = sh["batch"] if global_batch is None else global_batch
            fwd = wrap(self.serve_fn())
            batch = {k: v for k, v in self._batch_structs(cfg, B).items()
                     if k not in ("label", "pos_label", "neg_label")}
            bspec = {k: v for k, v in shd.recsys_batch_spec(cfg.name, mesh).items()
                     if k in batch}
            structs = (abs_params, batch)
            in_sh = (shd.to_shardings(mesh, pspecs), shd.to_shardings(mesh, bspec))
            if cfg.name == "sasrec":
                out, out_sh = _struct((B, cfg.embed_dim), f32), Placement(mesh, P(da, None))
            else:
                out, out_sh = _struct((B,), f32), Placement(mesh, P(da))
            fn = _OnFirstCall(mesh, lambda *_: torch.no_grad()(fwd))
            meta = {"params": n_params}
            rows = B
        collective = recsys_collectives(cfg, mesh, shape, sh["kind"], pspecs, abs_params,
                                        rows=rows)
        return Cell(self.name, shape, sh["kind"], fn, structs, in_sh, out_sh, flops,
                    {**meta, **device_counts(mesh, structs, in_sh, out, out_sh, flops,
                                             collective)})

    # placed -------------------------------------------------------------------
    def tree_shards(self, mesh) -> plc.TreeShards:
        abs_params = self.abstract_params()
        return plc.TreeShards(mesh, plc.leaf_shards(
            abs_params, shd.recsys_param_specs(self.cfg.name, abs_params, mesh)))

    def place(self, shape: str, mesh, params, opt_state=None):
        """The rank's blocks of a whole parameter tree for ``shape``'s placed
        cell on ``mesh`` (a ``DeviceMesh``); a train cell's state is
        ``{"params", "opt"}`` (``opt_state`` placed, or initialised on the
        rank's blocks)."""
        abs_params = self.abstract_params()
        pspecs = shd.recsys_param_specs(self.cfg.name, abs_params, mesh)
        placed = plc.place_tree(params, pspecs, mesh)
        if REC_SHAPES[shape]["kind"] != "train":
            return placed
        if opt_state is None:
            opt = make_optimizer(self.optimizer, self.tree_shards(mesh))[0](placed)
        else:
            opt = plc.place_tree(opt_state, _state_specs(pspecs, abs_params,
                                                         self.optimizer)["opt"], mesh)
        return {"params": placed, "opt": opt}

    @staticmethod
    def _row_split(fn, mesh, pspecs):
        """``fn(params, ...)`` with the lookups into the leaves ``pspecs``
        splits over ``model`` vocab-parallel (``models.recsys.row_split``)."""
        from ..tree import tree_leaves

        split = ["model" in plc.split_axes(s) for s in tree_leaves(pspecs)]

        def run(params, *args):
            tables = [t for t, sp in zip(tree_leaves(params), split) if sp]
            with rec_m.row_split(mesh, tables):
                return fn(params, *args)

        return run

    @staticmethod
    def _model_candidates(score, mesh):
        """``retrieval_cand`` placed: the candidates split over every axis,
        so the model ranks gather theirs, score them together (the lookups
        are vocab-parallel) and each keeps its own block of the scores."""
        def run(params, *args):
            *user, cand = args
            every = plc.all_gather_axes(cand, mesh, ("model",), 0)
            out = score(params, *user, every)
            n, r = cand.shape[0], shd.axis_index(mesh, "model")
            return out[..., r * n:(r + 1) * n].contiguous()

        return run

    def smoke(self, seed: int = 0, device=None, params=None, batch=None) -> dict:
        """One train step of the smoke config at batch 8 on ``device``
        (``cuda`` unless given). The weights come from a CPU generator
        seeded with ``seed`` and the batch from numpy at ``seed``, unless
        ``params`` / ``batch`` are given (trees of tensors, e.g. the
        reference's)."""
        cfg = self.smoke_cfg
        if cfg is None:
            raise ValueError(f"{self.name}: no smoke config")
        dev = resolve_device(device)
        init_fn, loss_fn_raw, _ = self._fns(cfg)
        if params is None:
            params = init_fn(torch.Generator().manual_seed(seed), cfg, device=dev)
        params = tree_map(lambda t: t.to(dev), params)
        if batch is None:
            batch = self._smoke_batch(cfg, 8, seed, dev)
        batch = {k: v.to(dev) for k, v in batch.items()}
        oinit, oupd = make_optimizer(self.optimizer)
        step = make_train_step(lambda p, b: loss_fn_raw(p, cfg, b), oupd)
        state, m = step({"params": params, "opt": oinit(params)}, batch)
        if not torch.isfinite(m["loss"]):
            raise RuntimeError(f"{self.name} smoke: loss {float(m['loss'])}")
        return {"loss": float(m["loss"]), "device": dev.type}
