"""One ``Retriever`` API: engine registry, build/serve split and
on-disk index artifacts — the port of ``repro/serve/api.py``.

Every serving engine is a registry entry (``@register_engine("flat")``)
implementing ``EngineImpl``: a host-side numpy array build and a
batched ``search_batch`` over torch tensors with the query batch as a
leading axis. The engine-agnostic surface is:

* ``Retriever.build(fwd, cfg, device=None)`` — host-side index build,
  arrays moved to ``device``;
* ``retriever.search(Q, k)`` — the batched search through the plan
  cache (``serve/pipeline.py``): the batch pads up to its smallest
  covering bucket and runs that bucket's plan, on the card one captured
  CUDA graph per ``(engine, codec, backend, k, bucket)`` key;
* ``retriever.search_batch(Q)`` — the same queries through the
  micro-batching scheduler (``retriever.pipeline()``: deadline
  coalescing, the quantized-query result cache, ``ServeStats``);
* ``retriever.save(path)`` / ``open_retriever(path)`` — the artifact
  lifecycle: ``manifest.json`` + ``arrays.npz``, the same format the
  reference writes and reads, so an index saved by either package
  opens in the other with byte-equal arrays;
* ``RetrieverConfig(n_shards=S > 1)`` — ``Retriever.build`` returns a
  ``ShardedRetriever`` (``serve/sharded.py``): one self-contained
  sub-index per contiguous doc range, saved as a tree of per-shard
  artifacts, memory-mapped on open and served out of core through an
  LRU of resident shards; ``map_local_ids`` and ``merge_topk`` are its
  sentinel-safe merge contract;
* ``build_shard_arrays`` / ``make_sharded_search`` — the mesh fan-out on
  ``torch.distributed``: every rank holds one self-contained sub-index
  (its slice of the stacked shard arrays) on its device, searches it
  through its plan cache and all-gathers ``[nq, k]`` ids and scores over
  the index axis before the same merge (``ShardedRetriever`` takes this
  path when a process group of ≥ ``n_shards`` ranks is initialised);
* ``MutableRetriever`` (``serve/segments.py``) — delta segments,
  tombstones and the crash-safe generation flip over a base index;
  ``open_retriever`` on a root that holds ``CURRENT`` opens one.

Every entry point runs on ``cuda`` unless the caller passes
``device="cpu"`` (``repro_torch.resolve_device``).
"""

from __future__ import annotations

import dataclasses
import json
import pathlib
from typing import Any, Callable, Dict, Mapping

import numpy as np
import torch

from .. import resolve_device
from ..core import layout
from ..core import values as value_codecs
from ..core.forward_index import VALUE_FORMATS, ForwardIndex
from ..kernels import modes
from . import pipeline as serve_pipeline

__all__ = [
    "RetrieverConfig",
    "EngineImpl",
    "register_engine",
    "get_engine",
    "available_engines",
    "Retriever",
    "open_retriever",
    "from_reference_arrays",
    "manifest_dict",
    "write_artifact",
    "load_manifest",
    "check_manifest_names",
    "check_array_spec",
    "cfg_from_manifest",
    "ArtifactError",
    "MANIFEST_VERSION",
    "top_k",
    "map_local_ids",
    "merge_topk",
    "build_shard_arrays",
    "make_sharded_search",
    "ShardedSearch",
    "row_array_specs",
]

#: artifact layout version; shared with the reference so artifacts cross
MANIFEST_VERSION = 1
_MANIFEST_FORMAT = "repro.serve.retriever"
_SHARDED_FORMAT = "repro.serve.retriever-sharded"
_MANIFEST_FILE = "manifest.json"
_ARRAYS_FILE = "arrays.npz"


class ArtifactError(ValueError):
    """A saved index artifact is missing, corrupt, or incompatible."""


@dataclasses.dataclass(frozen=True)
class RetrieverConfig:
    """Engine-agnostic serving configuration.

    ``params`` carries the engine-specific knobs (build and search
    time); unknown keys are rejected against the engine's defaults.
    ``backend`` selects the rescoring path: ``"torch"`` (plain torch)
    or ``"cuda"`` (the hand-written kernel; ``kernels/modes.py``).
    ``batch_size`` joins the plan cache's bucket set (the expected
    batch gets an exact-fit plan). ``n_shards > 1`` builds and serves a
    sharded index (``serve/sharded.py``): contiguous doc ranges, one
    sub-index each, searched one after another on one device and merged,
    or one a rank over a mesh (``ShardedRetriever.use_mesh``)."""

    engine: str = "seismic"
    codec: str = "uncompressed"
    backend: str = "torch"
    k: int = 10
    batch_size: int | None = None
    n_shards: int = 1
    params: Mapping[str, Any] = dataclasses.field(default_factory=dict)
    vq: str = "f16"

    def replace(self, **kw) -> "RetrieverConfig":
        return dataclasses.replace(self, **kw)


def top_k(scores: torch.Tensor, k: int):
    """(values, indices) of the ``k`` largest entries along the last
    axis, ties broken toward the lower index as ``jax.lax.top_k`` does
    (a stable descending sort; ``torch.topk`` promises no tie order).
    A ``k`` larger than the axis raises ``ValueError``, as it does there."""
    if k > scores.shape[-1]:
        raise ValueError(
            f"k argument to top_k must be no larger than size along axis; got k={k} "
            f"with shape={list(scores.shape)} and axis={scores.dim() - 1}"
        )
    vals, idx = torch.sort(scores, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


class EngineImpl:
    """Protocol every registered engine implements: a host-side numpy
    array build, the build of one doc-range shard, and a batched search
    over device tensors."""

    name: str = "abstract"
    #: engine knob defaults; ``RetrieverConfig.params`` overrides
    defaults: Dict[str, Any] = {}
    #: True when one document can be reported by several index shards
    #: (the sharded merge then dedupes by doc id)
    dedupe_merge: bool = False

    def params(self, cfg: RetrieverConfig) -> Dict[str, Any]:
        unknown = set(cfg.params) - set(self.defaults)
        if unknown:
            raise ValueError(
                f"unknown {self.name!r} engine params {sorted(unknown)}; "
                f"known: {sorted(self.defaults)}"
            )
        return {**self.defaults, **cfg.params}

    def build_arrays(self, fwd: ForwardIndex, cfg: RetrieverConfig) -> Dict[str, np.ndarray]:
        """Collection → engine arrays (numpy)."""
        raise NotImplementedError

    def build_shard(
        self, fwd: ForwardIndex, cfg: RetrieverConfig, lo: int, hi: int
    ) -> Dict[str, np.ndarray]:
        """Arrays of ONE self-contained shard over docs ``[lo, hi)`` with
        shard-local ids — the unit a sharded tree writes per shard
        directory. The default builds the engine's arrays over the CSR
        slice."""
        return self.build_arrays(fwd.slice(lo, hi), cfg)

    def shard_build(self, fwd: ForwardIndex, cfg: RetrieverConfig, n_shards: int):
        """→ (per-shard array dicts, idmaps, n_docs_local, pad_values) —
        the self-contained sub-indexes ``build_shard_arrays`` stacks.
        ``idmaps[s]`` is i32 [n_docs_local + 1] mapping shard-local doc ids
        to global ones (sentinel → global n_docs); ``pad_values`` feeds
        ``layout.pad_stack``."""
        raise NotImplementedError

    def search_batch(self, cfg: RetrieverConfig, n_docs: int, value_scale: float, arrays, Q):
        """Queries f32 [nq, dim] → (ids i32 [nq, k], scores f32 [nq, k])."""
        raise NotImplementedError

    def search_one(self, cfg: RetrieverConfig, n_docs: int, value_scale: float, arrays, q):
        """One dense query [dim] → (ids [k], scores [k])."""
        ids, scores = self.search_batch(cfg, n_docs, value_scale, arrays, q.unsqueeze(0))
        return ids[0], scores[0]

    def array_specs(self, cfg: RetrieverConfig, **dims) -> Dict[str, torch.Tensor]:
        """``meta`` tensors standing in for the engine arrays (the dry
        run's sizing; nothing is allocated)."""
        raise NotImplementedError


_ENGINES: Dict[str, Callable[[], EngineImpl]] = {}


def register_engine(name: str):
    """Class decorator: make an ``EngineImpl`` servable by name."""

    def deco(factory: Callable[[], EngineImpl]):
        _ENGINES[name] = factory
        return factory

    return deco


def _ensure_builtin_engines() -> None:
    from . import engines  # noqa: F401  (registers seismic, hnsw and flat)


def get_engine(name: str) -> EngineImpl:
    _ensure_builtin_engines()
    try:
        return _ENGINES[name]()
    except KeyError:
        raise ValueError(
            f"no registered engine {name!r}; have {sorted(_ENGINES)}"
        ) from None


def available_engines() -> list[str]:
    _ensure_builtin_engines()
    return sorted(_ENGINES)


def _spec(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def row_array_specs(
    codec: str,
    *,
    n_docs: int,
    l_max: int,
    d_max: int,
    value_dtype=torch.float16,
    bitpack_bits: int = 16,
    vq: str = "f16",
) -> Dict[str, torch.Tensor]:
    """``meta`` tensors of the packed row form under ``codec`` — the
    candidate-rescoring arrays every engine shares, with the reference's
    names, shapes and dtypes. Under a quantized ``vq`` the value stream
    is u8 codes at ``l_max // code_factor`` width plus the clip columns
    or the codebook; ``l_max`` must already be factor-aligned the way
    ``layout.pack_rows`` rounds it."""
    value_codecs.check_vq(vq)
    factor = value_codecs.code_factor(vq)
    arrays = {
        "vals_rows": (_spec((n_docs + 1, l_max), value_dtype) if vq == "f16"
                      else _spec((n_docs + 1, l_max // factor), torch.uint8)),
        "nnz_rows": _spec((n_docs + 1,), torch.int32),
    }
    if vq == "pq":
        arrays["vq_codebook"] = _spec((value_codecs.PQ_K, value_codecs.PQ_M), torch.float32)
    elif vq != "f16":
        for key in value_codecs.sq_keys(vq):
            arrays[key] = _spec((n_docs + 1, 1), torch.float32)
    if codec == "uncompressed":
        arrays["comps_rows"] = _spec((n_docs + 1, l_max), torch.int32)
    elif codec == "bitpack":
        arrays["words_rows"] = _spec((n_docs + 1, (l_max * bitpack_bits + 31) // 32),
                                     torch.uint32)
        arrays["widths_rows"] = _spec((n_docs + 1,), torch.int32)
    else:  # (ctrl, data) byte-stream codecs
        group = layout.get_layout(codec).block_multiple
        arrays["ctrl_rows"] = _spec((n_docs + 1, l_max // group), torch.uint8)
        arrays["data_rows"] = _spec((n_docs + 1, d_max), torch.uint8)
    return arrays


def _to_tensor(a) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a
    a = np.ascontiguousarray(a)
    # torch shares numpy's buffer; a read-only one (a jax export) is copied
    return torch.from_numpy(a if a.flags.writeable else a.copy())


def _to_device(arrays: Mapping[str, Any], device: torch.device) -> dict[str, torch.Tensor]:
    return {k: _to_tensor(v).to(device) for k, v in arrays.items()}


def map_local_ids(idmap: torch.Tensor, ids: torch.Tensor, n_docs_global: int) -> torch.Tensor:
    """Shard-local candidate ids → global doc ids, sentinel-safe.

    ``idmap`` is i32 [n_docs_local + 1]: slot ``i < n_docs_local`` holds
    the global id of local doc ``i``, the last slot the out-of-corpus
    sentinel ``n_docs_global``. Every local id outside ``[0,
    n_docs_local]`` — -1 padding and overflow ids — maps to
    ``n_docs_global``, which ``merge_topk`` masks to -inf; the ids are
    clamped before the gather (torch indexing raises where the
    reference's ``jnp.take`` clipped) and masked after it, so nothing
    aliases doc 0 or the shard's last doc."""
    n_local = idmap.shape[-1] - 1
    valid = (ids >= 0) & (ids <= n_local)
    mapped = torch.take(idmap, ids.clamp(0, n_local).long())
    return torch.where(valid, mapped, torch.full_like(mapped, n_docs_global))


def merge_topk(flat_ids: torch.Tensor, flat_scores: torch.Tensor, k: int, *, dedupe: bool,
               n_docs_global: int):
    """[nq, S·k] gathered per-shard candidates → global (ids, scores).

    Every out-of-corpus id — negative padding and ids ≥ n_docs_global —
    is masked to -inf so it never displaces a real document; with
    ``dedupe`` the candidates are stably sorted by id and repeats
    masked before the final ``top_k``, whose ties go to the lower
    position, as the reference's ``jax.lax.top_k`` (so without dedupe
    the merge is byte-stable in shard order). Fresh tensors out; the
    inputs are not written."""
    nq = flat_scores.shape[0]
    invalid = (flat_ids < 0) | (flat_ids >= n_docs_global)
    flat_scores = flat_scores.masked_fill(invalid, float("-inf"))
    if dedupe:
        order = torch.argsort(flat_ids, dim=1, stable=True)
        flat_ids = torch.gather(flat_ids, 1, order)
        dup = torch.cat([torch.zeros((nq, 1), dtype=torch.bool, device=flat_ids.device),
                         flat_ids[:, 1:] == flat_ids[:, :-1]], dim=1)
        flat_scores = torch.gather(flat_scores, 1, order).masked_fill(dup, float("-inf"))
    top_s, pos = top_k(flat_scores, k)
    return torch.gather(flat_ids, 1, pos), top_s


# ---------------------------------------------------------------------------
# the mesh fan-out (torch.distributed, one rank a shard)
# ---------------------------------------------------------------------------


def build_shard_arrays(
    fwd: ForwardIndex,
    cfg: RetrieverConfig,
    n_shards: int | None = None,
    *,
    host_index=None,
):
    """Partition a collection into self-contained per-shard sub-indexes
    and stack their engine arrays with a leading shard axis → (stacked
    numpy arrays, idmap i32 [n_shards, n_docs_local + 1], n_docs_local),
    byte-identical to the reference's. How the split happens is the
    engine's business (Seismic: blocks round-robin and doc ownership;
    hnsw and flat: contiguous doc ranges); the stacking is
    ``layout.pad_stack``. The arrays stay on the host: each rank of
    ``make_sharded_search`` places only its own slice.

    ``host_index`` reuses a built host index (``SeismicIndex``) instead
    of rebuilding it; engines that split by doc range ignore it."""
    impl = get_engine(cfg.engine)
    n_shards = n_shards or cfg.n_shards
    if host_index is not None and hasattr(impl, "shard_from_index"):
        dicts, idmaps, n_docs_local, pad_values = impl.shard_from_index(host_index, cfg, n_shards)
    else:
        dicts, idmaps, n_docs_local, pad_values = impl.shard_build(fwd, cfg, n_shards)
    return layout.pad_stack(dicts, pad_values), np.stack(idmaps), n_docs_local


class ShardedSearch:
    """The search ``make_sharded_search`` returns: ``fn(arrays, idmap, Q)
    → (ids i32 [nq, k], scores f32 [nq, k])``, the global top-k, on
    every rank of the mesh.

    Each rank takes its shard ``s`` (its index along ``index_axis``) of
    the stacked ``arrays`` and ``idmap`` and keeps it resident on
    ``device`` as a ``Retriever`` at ``k_local`` (placed at the first
    call, kept while the same ``arrays`` and ``idmap`` come back). Its
    slice of ``Q`` along ``query_axes`` is searched through that
    retriever's plan cache (on the card one CUDA graph per bucket, as
    the sequential path), mapped to global ids with ``map_local_ids``,
    and the ``[nq, k]`` ids and scores are all-gathered over
    ``index_axis`` and merged as the reference does (``merge_local``);
    the collective and the merge run outside the graph. The merged
    slices are then gathered over ``query_axes``. Collective bytes a
    query: 8·k·S."""

    def __init__(self, mesh, cfg: RetrieverConfig, n_docs_local: int, n_docs_global: int,
                 value_scale: float, *, index_axis: str, query_axes: tuple[str, ...],
                 k_local: int | None, device=None):
        from ..dist.sharding import axis_index, axis_size

        self.impl = get_engine(cfg.engine)
        self.mesh = mesh
        self.cfg = cfg
        self.n_docs_local = int(n_docs_local)
        self.n_docs_global = int(n_docs_global)
        self.value_scale = float(value_scale)
        self.index_axis = index_axis
        self.query_axes = tuple(query_axes)
        self.k_local = cfg.k if k_local is None else int(k_local)
        self.shard = axis_index(mesh, index_axis)
        self.n_shards = axis_size(mesh, index_axis)
        self.device = resolve_device(device)
        self._placed: tuple | None = None  # (arrays, idmap, Retriever, idmap tensor)

    def local(self, arrays, idmap, dim: int) -> tuple["Retriever", torch.Tensor]:
        """This rank's shard of ``arrays`` / ``idmap`` on the device."""
        p = self._placed
        if p is None or p[0] is not arrays or p[1] is not idmap:
            s = self.shard
            ret = Retriever(self.cfg.replace(n_shards=1, k=self.k_local),
                            {k: _to_tensor(v[s]) for k, v in arrays.items()},
                            n_docs=self.n_docs_local, dim=dim, value_scale=self.value_scale,
                            value_format="", device=self.device,  # never saved
                            shard=f"{s}/{self.n_shards}")
            p = self._placed = (arrays, idmap, ret, _to_tensor(idmap[s]).to(self.device))
        return p[2], p[3]

    def merge_local(self, ids: torch.Tensor, scores: torch.Tensor, idmap: torch.Tensor):
        """This rank's local top ``≤ k_local`` (ids, scores) of a query
        batch → the merged global (ids, scores) of the batch: a shard
        that returned fewer than ``k_local`` candidates sentinel-pads
        them, ``map_local_ids`` maps them, ``[nq, k_local]`` ids and
        scores are gathered over the index axis in shard order, the
        merge width is sentinel-padded up to ``cfg.k`` where ``S · k``
        falls short, and ``merge_topk`` (dedupe iff the engine asks)."""
        from ..dist.sharding import all_gather

        nq = ids.shape[0]
        if ids.shape[1] < self.k_local:
            pad = self.k_local - ids.shape[1]
            ids = torch.cat([ids, ids.new_full((nq, pad), -1)], dim=1)
            scores = torch.cat([scores, scores.new_full((nq, pad), float("-inf"))], dim=1)
        gids = map_local_ids(idmap, ids, self.n_docs_global)
        ag_s = all_gather(scores, self.mesh, self.index_axis)  # [S, nq, k]
        ag_i = all_gather(gids, self.mesh, self.index_axis)
        S, _, k = ag_s.shape
        flat_s = ag_s.transpose(0, 1).reshape(nq, S * k)
        flat_i = ag_i.transpose(0, 1).reshape(nq, S * k)
        if S * k < self.cfg.k:  # k > corpus: sentinel-pad the merge width
            pad = self.cfg.k - S * k
            flat_i = torch.cat([flat_i, flat_i.new_full((nq, pad), self.n_docs_global)], dim=1)
            flat_s = torch.cat([flat_s, flat_s.new_full((nq, pad), float("-inf"))], dim=1)
        return merge_topk(flat_i, flat_s, self.cfg.k, dedupe=self.impl.dedupe_merge,
                          n_docs_global=self.n_docs_global)

    @torch.inference_mode()
    def __call__(self, arrays, idmap, Q):
        from ..dist.sharding import all_gather, axis_block

        Q = torch.as_tensor(Q, dtype=torch.float32).to(self.device)
        ret, local_idmap = self.local(arrays, idmap, Q.shape[1])
        nq = Q.shape[0]
        if self.query_axes:
            Q = axis_block(Q, self.mesh, self.query_axes)
        ids, scores = ret.plans.search(Q)
        ids, scores = self.merge_local(ids, scores, local_idmap)
        if self.query_axes:
            ids = all_gather(ids, self.mesh, self.query_axes).reshape(nq, -1)
            scores = all_gather(scores, self.mesh, self.query_axes).reshape(nq, -1)
        return ids, scores


def make_sharded_search(
    mesh,
    cfg: RetrieverConfig,
    n_docs_local: int,
    n_docs_global: int,
    value_scale: float,
    *,
    index_axis: str = "model",
    query_axes: tuple[str, ...] = ("data",),
    k_local: int | None = None,
    device=None,
) -> ShardedSearch:
    """ONE distributed search for every registered engine, over a
    ``DeviceMesh`` of the initialised process group (``dist.sharding``).

    The index is pre-partitioned into ``mesh`` size along ``index_axis``
    self-contained sub-indexes (``build_shard_arrays``: a leading shard
    axis; ``idmap`` maps local → global doc ids, sentinel →
    ``n_docs_global``). Queries split over ``query_axes`` and replicate
    across index shards; every rank searches its shard with the engine's
    ``search_batch`` and the ranks all-gather ``[nq, k]`` ids and scores
    over ``index_axis`` and merge — deduping by doc id first iff the
    engine declares ``dedupe_merge`` (``ShardedSearch``).

    ``k_local`` caps the per-shard candidate count below the merge's
    ``cfg.k`` — shards smaller than k serve their whole doc range and
    engines whose score vector is shard-sized (flat) cannot top-k past
    it; the merge sentinel-pads back up to ``cfg.k`` when needed.
    ``device`` is each rank's (``cuda`` unless given)."""
    return ShardedSearch(mesh, cfg, n_docs_local, n_docs_global, value_scale,
                         index_axis=index_axis, query_axes=tuple(query_axes or ()),
                         k_local=k_local, device=device)


class Retriever:
    """Engine- and codec-agnostic serving handle: the device arrays of
    ONE engine×codec index plus its batched search. Construct with
    ``Retriever.build``, ``Retriever.from_host_index`` (reuse a built
    ``SeismicIndex`` or ``HNSWIndex``) or ``open_retriever`` (load a saved
    artifact)."""

    def __init__(
        self,
        cfg: RetrieverConfig,
        arrays: Mapping[str, Any],
        *,
        n_docs: int,
        dim: int,
        value_scale: float,
        value_format: str,
        device=None,
        shard: str = "",
    ):
        self.impl = get_engine(cfg.engine)
        layout.get_layout(cfg.codec)  # raises listing the known codecs
        value_codecs.check_vq(cfg.vq)
        modes.check_backend(cfg.backend)
        if cfg.batch_size is not None and (
            not isinstance(cfg.batch_size, int)
            or isinstance(cfg.batch_size, bool)
            or cfg.batch_size < 1
        ):
            raise ValueError(
                f"batch_size must be a positive int or None, got {cfg.batch_size!r}"
            )
        self.impl.params(cfg)  # rejects unknown engine knobs early
        self.cfg = cfg
        self.device = resolve_device(device)
        self.n_docs = int(n_docs)
        self.dim = int(dim)
        self.value_scale = float(value_scale)
        self.value_format = value_format
        #: shard component of the plan key: "" for a monolithic index,
        #: "<shard>/<n_shards>" inside a ShardedRetriever
        self.shard = shard
        self.arrays = _to_device(arrays, self.device)
        # one plan per (engine, codec, backend, k, bucket, shard);
        # cfg.batch_size joins the bucket set
        self.plans = serve_pipeline.PlanCache(self)
        self._pipeline: serve_pipeline.Pipeline | None = None

    def make_plans(self, buckets) -> "serve_pipeline.PlanCache":
        """A fresh plan cache with an explicit bucket set."""
        return serve_pipeline.PlanCache(self, buckets)

    @classmethod
    def build(cls, fwd: ForwardIndex, cfg: RetrieverConfig, device=None):
        """Host-side index construction: collection → servable arrays
        on ``device`` (``cuda`` unless given). With ``cfg.n_shards > 1``
        the build returns a ``ShardedRetriever``: one sub-index per
        contiguous doc range, kept on the host until a search admits it."""
        device = resolve_device(device)  # fail before the host build
        if cfg.n_shards > 1:
            from .sharded import ShardedRetriever

            return ShardedRetriever.build(fwd, cfg, device=device)
        impl = get_engine(cfg.engine)
        layout.get_layout(cfg.codec)
        return cls(
            cfg,
            impl.build_arrays(fwd, cfg),
            n_docs=fwd.n_docs,
            dim=fwd.dim,
            value_scale=float(fwd.value_format.scale),
            value_format=fwd.value_format.name,
            device=device,
        )

    @classmethod
    def from_host_index(cls, index, cfg: RetrieverConfig, device=None) -> "Retriever":
        """Wrap an already-built host index (``SeismicIndex`` or
        ``HNSWIndex``) — sweep codecs or backends over one build.
        ``cfg``'s build-time params are ignored."""
        device = resolve_device(device)
        impl = get_engine(cfg.engine)
        if not hasattr(impl, "arrays_from_index"):
            raise ValueError(
                f"engine {cfg.engine!r} has no host-index form; use Retriever.build"
            )
        fwd = index.fwd
        return cls(
            cfg,
            impl.arrays_from_index(index, cfg),
            n_docs=fwd.n_docs,
            dim=fwd.dim,
            value_scale=float(fwd.value_format.scale),
            value_format=fwd.value_format.name,
            device=device,
        )

    @torch.inference_mode()
    def search(self, Q, k: int | None = None):
        """[nq, dim] dense queries (numpy or tensor) → (ids i32 [nq, k],
        scores f32 [nq, k]) on the retriever's device, through the plan
        cache: ``Q`` pads up to its smallest covering bucket (zero
        queries) and that bucket's plan runs; the padding is sliced off.
        ``k`` defaults to ``cfg.k``; a smaller k is a slice."""
        if k is not None and k > self.cfg.k:
            raise ValueError(
                f"k={k} exceeds the static cfg.k={self.cfg.k}; rebuild the "
                f"Retriever with a larger cfg.k"
            )
        Q = torch.as_tensor(Q, dtype=torch.float32)
        if Q.dim() != 2 or Q.shape[1] != self.dim:
            raise ValueError(f"queries must be [nq, {self.dim}], got {tuple(Q.shape)}")
        ids, scores = self.plans.search(Q)
        if k is None or k == self.cfg.k:
            return ids, scores
        return ids[:, :k], scores[:, :k]

    def pipeline(self, **kw) -> "serve_pipeline.Pipeline":
        """The micro-batching scheduler over this retriever. With no
        arguments, one default instance is made lazily and reused (it
        shares this retriever's plan cache); keyword arguments
        (``buckets``, ``deadline_us``, ``cache_size``, ``key_dtype``,
        ``clock``) make a fresh pipeline."""
        if kw:
            return serve_pipeline.Pipeline(self, **kw)
        if self._pipeline is None:
            self._pipeline = serve_pipeline.Pipeline(self)
        return self._pipeline

    def search_batch(self, Q):
        """Serve a query batch through the default pipeline: result-cache
        admission, bucket coalescing, plan dispatch, results (host numpy)
        in submission order. On an f16-valued index the cache keys in
        f16, so two queries within one f16 ulp per component share an
        entry; ``pipeline(cache_size=0)`` or ``key_dtype=np.float32``
        serves them exactly."""
        return self.pipeline().search_batch(Q)

    def save(self, path, *, compress: bool = True) -> pathlib.Path:
        """Write the index artifact: ``manifest.json`` + ``arrays.npz``,
        in the reference's format (``compress=False`` stores the npz
        members raw)."""
        host = {k: v.cpu().numpy() for k, v in self.arrays.items()}
        return write_artifact(
            path,
            manifest_dict(self.cfg, host, n_docs=self.n_docs, dim=self.dim,
                          value_scale=self.value_scale,
                          value_format=self.value_format),
            host, compress=compress,
        )


def manifest_dict(
    cfg: RetrieverConfig,
    host_arrays: Mapping[str, np.ndarray],
    *,
    n_docs: int,
    dim: int,
    value_scale: float,
    value_format: str,
    extra: Mapping[str, Any] | None = None,
) -> dict:
    """The monolithic-artifact manifest: serving config (backend under
    the reference's name), corpus stats and per-array dtype/shape.
    ``extra`` merges in the shard bookkeeping (``shard``, ``doc_lo``,
    ``doc_hi``) of a sharded tree's per-shard directories."""
    manifest = {
        "format": _MANIFEST_FORMAT,
        "version": MANIFEST_VERSION,
        "engine": cfg.engine,
        "codec": cfg.codec,
        "backend": modes.backend_to_manifest(cfg.backend),
        "k": cfg.k,
        "batch_size": cfg.batch_size,
        "n_shards": cfg.n_shards,
        "params": dict(cfg.params),
        "vq": cfg.vq,
        "n_docs": int(n_docs),
        "dim": int(dim),
        "value_scale": float(value_scale),
        "value_format": value_format,
        "arrays": {
            k: {"dtype": str(v.dtype), "shape": list(v.shape)}
            for k, v in host_arrays.items()
        },
    }
    if extra:
        manifest.update(extra)
    return manifest


def write_artifact(
    path,
    manifest: Mapping[str, Any],
    host_arrays: Mapping[str, np.ndarray],
    *,
    compress: bool = True,
) -> pathlib.Path:
    """Write one artifact directory: ``manifest.json`` + ``arrays.npz``."""
    path = pathlib.Path(path)
    path.mkdir(parents=True, exist_ok=True)
    with open(path / _MANIFEST_FILE, "w", encoding="utf-8") as f:
        json.dump(manifest, f, indent=1, sort_keys=True)
    saver = np.savez_compressed if compress else np.savez
    saver(path / _ARRAYS_FILE, **dict(host_arrays))
    return path


def load_manifest(path) -> dict:
    """Read + parse ``manifest.json`` under ``path``."""
    path = pathlib.Path(path)
    mf = path / _MANIFEST_FILE
    if not mf.is_file():
        raise ArtifactError(f"no {_MANIFEST_FILE} under {path}")
    try:
        return json.loads(mf.read_text(encoding="utf-8"))
    except json.JSONDecodeError as e:
        raise ArtifactError(f"corrupt manifest at {mf}: {e}") from None


def check_manifest_names(manifest: Mapping[str, Any], where) -> None:
    """Version / engine / codec / value-format / vq validation."""
    version = manifest.get("version")
    if version != MANIFEST_VERSION:
        raise ArtifactError(
            f"artifact version {version!r} at {where} incompatible with "
            f"this build (expected {MANIFEST_VERSION}); rebuild the index"
        )
    engine, codec = manifest["engine"], manifest["codec"]
    if engine not in available_engines():
        raise ArtifactError(
            f"artifact engine {engine!r} is not registered; have "
            f"{available_engines()}"
        )
    if codec not in layout.available_layouts():
        raise ArtifactError(
            f"artifact codec {codec!r} is not registered; have "
            f"{layout.available_layouts()}"
        )
    if manifest["value_format"] not in VALUE_FORMATS:
        raise ArtifactError(
            f"unknown value_format {manifest['value_format']!r}; have "
            f"{sorted(VALUE_FORMATS)}"
        )
    vq = manifest.get("vq", "f16")
    if vq not in value_codecs.VALUE_CODECS:
        raise ArtifactError(
            f"unknown value codec {vq!r} at {where}; have "
            f"{list(value_codecs.VALUE_CODECS)}"
        )


def check_array_spec(
    spec: Mapping[str, Any], arrays: Mapping[str, np.ndarray], where
) -> None:
    """Manifest array specs vs the actual payload — names, dtypes and
    shapes must all agree or the artifact is rejected."""
    if set(spec) != set(arrays):
        raise ArtifactError(
            f"array payload mismatch at {where}: manifest lists "
            f"{sorted(spec)}, payload holds {sorted(arrays)}"
        )
    for k, meta in spec.items():
        got = arrays[k]
        if str(got.dtype) != meta["dtype"] or list(got.shape) != meta["shape"]:
            raise ArtifactError(
                f"array {k!r} at {where} is {got.dtype}{list(got.shape)}, "
                f"manifest says {meta['dtype']}{meta['shape']}"
            )


def cfg_from_manifest(manifest: Mapping[str, Any]) -> RetrieverConfig:
    return RetrieverConfig(
        engine=manifest["engine"],
        codec=manifest["codec"],
        backend=modes.backend_from_manifest(manifest.get("backend", "jnp")),
        k=int(manifest["k"]),
        batch_size=manifest.get("batch_size"),
        n_shards=int(manifest.get("n_shards", 1)),
        params=manifest.get("params", {}),
        vq=manifest.get("vq", "f16"),
    )


def from_reference_arrays(
    manifest: Mapping[str, Any], arrays: Mapping[str, np.ndarray], device=None
) -> dict[str, torch.Tensor]:
    """The reference's numpy engine arrays (as its ``Retriever.save``
    writes them) → the port's tensors on ``device``, byte for byte,
    after checking them against the manifest's specs."""
    check_array_spec(manifest["arrays"], arrays, "reference arrays")
    return _to_device(arrays, resolve_device(device))


def open_retriever(path, *, device=None):
    """Load a saved index artifact for serving on ``device``.

    Validates the manifest (format, version, engine/codec names, array
    specs) before serving. A sharded tree (``format`` =
    ``repro.serve.retriever-sharded``) opens as a ``ShardedRetriever``
    with every shard's arrays memory-mapped (``sharded.mmap_npz``): no
    array byte is read until a search admits the shard. A mutable root
    (one that holds a ``CURRENT`` file) opens as a ``MutableRetriever``
    at its committed generation (``serve/segments.py``)."""
    path = pathlib.Path(path)
    if (path / "CURRENT").is_file():
        from .segments import open_mutable

        return open_mutable(path, device=device)
    manifest = load_manifest(path)
    fmt = manifest.get("format")
    if fmt == _SHARDED_FORMAT:
        from .sharded import ShardedRetriever

        return ShardedRetriever.open(path, manifest, device=device)
    if fmt != _MANIFEST_FORMAT:
        raise ArtifactError(
            f"{path / _MANIFEST_FILE} is not a {_MANIFEST_FORMAT} artifact "
            f"(format={fmt!r})"
        )
    check_manifest_names(manifest, path / _MANIFEST_FILE)
    device = resolve_device(device)
    with np.load(path / _ARRAYS_FILE) as npz:
        arrays = {k: npz[k] for k in npz.files}
    cfg = cfg_from_manifest(manifest)
    return Retriever(
        cfg.replace(n_shards=1),
        from_reference_arrays(manifest, arrays, device),
        n_docs=manifest["n_docs"],
        dim=manifest["dim"],
        value_scale=manifest["value_scale"],
        value_format=manifest["value_format"],
        device=device,
    )
