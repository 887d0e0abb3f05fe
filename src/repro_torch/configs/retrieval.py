"""RetrievalArch — the paper's own workload as configs, the port of
``repro/configs/retrieval.py``.

Three cells a config:

* ``scan_100q``  — Table 1's hot loop: decode + dot of EVERY document
  against a query batch through the packed blocks. At ``opt`` 0 one
  program scatters every block's partial scores to the global documents
  (on the card ``kernels/ops.py``'s fused batch entry of the codec, on
  the CPU ``scoring.score_packed_batch``, the reference's composition);
  at ``opt`` ≥ 1 the doc-aligned scan (``scoring.make_doc_aligned_scan``)
  gives every rank a contiguous doc range and the blocks that pack it,
  so the scatter stays on the rank and the scan carries no collective;
  ``opt`` ≥ 2 stores ``seg`` as int8. ``opt`` 3 is ``opt`` 2's program:
  in the reference XLA already hoists the query-invariant decode, and
  here the block-scan kernel decodes each block once for its whole
  query tile.
* ``serve_4096q`` — the production two-phase Seismic search, the index
  split over ``model`` (self-contained sub-indexes), queries over the
  data axes, the ``[nq, k]`` all-gather merge
  (``serve.api.make_sharded_search``).
* ``graph_4096q`` — the batched HNSW beam search over the same layout.

A cell's step runs where its query lies (a CPU tensor: the plain torch
path; otherwise the card, the engines on ``backend="cuda"``), on the
rank's coordinate of a ``DeviceMesh``; each rank returns what the
reference's ``out_shardings`` give it: the doc-aligned scan its
``[nq, docs_local]`` slice, the searches the global ``[nq, k]``. Built on
a ``launch.mesh.MeshShape`` a cell has shapes and counts only.

Array sizes derive from MsMarco statistics (8.84M passages; SPLADE 119
nnz/doc, LiLSR 387 nnz/doc — §3 of the paper).
"""

from __future__ import annotations

import dataclasses

import torch

from .. import resolve_device
from ..dist import sharding as shd
from ..dist.sharding import P
from ..serve.api import RetrieverConfig, get_engine, make_sharded_search
from .base import BaseArch, Cell, _nbytes, _OnFirstCall, _struct, device_counts

__all__ = ["RetrievalArch", "RETRIEVAL_SHAPES"]

RETRIEVAL_SHAPES = {
    "scan_100q": dict(kind="serve", n_queries=100),
    "serve_4096q": dict(kind="serve", n_queries=4096),
    "graph_4096q": dict(kind="serve", n_queries=4096),
}


def _global_scan(codec: str, n_docs: int, dim: int, scale: float):
    """``fn(arrays, Q [nq, ≥dim]) → f32 [nq, n_docs]``: every block's
    partial scores scattered to the global documents, on the device of
    ``Q`` (the pack placed there once while ``arrays`` come back holding
    the same tensors)."""
    from ..core.forward_index import PackedBlocks, ValueFormat
    from ..core.scoring import score_packed_batch
    from ..kernels import block_scan, ops

    placed: list = [{}, None]  # a copy of the arrays placed, the pack on the device

    def make(device, *_):
        def scan(arrays, Q):
            Q = torch.as_tensor(Q, dtype=torch.float32).to(device)
            held = placed[0]
            if (held.keys() != arrays.keys() or any(held[k] is not v for k, v in arrays.items())
                    or placed[1].seg.device != device):
                vals = arrays["vals"]
                placed[:] = [dict(arrays), PackedBlocks(
                    codec=codec, block_size=int(vals.shape[-1]), n_docs=n_docs, dim=dim,
                    value_format=ValueFormat("scaled", vals.dtype, scale), **arrays).to(device)]
            packed = placed[1]
            if device.type == "cuda" and codec in block_scan.CODECS:
                return ops.block_scorers(codec)[1](Q, packed)
            return score_packed_batch(Q, packed)

        return scan

    return make


@dataclasses.dataclass
class RetrievalArch(BaseArch):
    name: str
    dim: int = 30522
    n_docs: int = 8_841_823
    doc_nnz: int = 119
    query_nnz: int = 43
    block_size: int = 512
    docs_per_block: int = 64
    l_max: int = 384  # per-doc row capacity (p100 nnz, 8-aligned)
    graph_degree: int = 32  # HNSW base-layer degree (2·m, m=16)
    value_scale: float = 1.0
    codec: str = "dotvbyte"  # any core/layout.py stream codec
    family: str = "retrieval"
    shape_names: tuple[str, ...] = tuple(RETRIEVAL_SHAPES)
    # scan_100q's optimisation levels (EXPERIMENTS.md §Perf):
    #   0 = the global scatter over block-split arrays
    #   1 = + the doc-aligned scan (the scatter stays on the rank, no
    #       collective on the scan path)
    #   2 = + int8 seg (4× smaller dominant stream)
    #   3 = + decode once, score many: opt 2's program (see the docstring)
    opt: int = 0

    # ------------------------------------------------------------------
    @property
    def n_blocks(self) -> int:
        # ~5% fragmentation overhead from per-document block boundaries,
        # rounded up to the 512-device mesh for even sharding
        raw = int(self.n_docs * self.doc_nnz / self.block_size * 1.05) + 1
        return (raw + 511) // 512 * 512

    def packed_structs(self) -> dict:
        """``meta`` tensors of the packed-block index: the fields and
        dtypes ``layout.pack_blocks(codec=…)`` emits, at the reference's
        estimated sizes."""
        B, T, D = self.n_blocks, self.block_size, self.docs_per_block
        seg_dt = torch.int8 if self.opt >= 2 else torch.int32
        structs = {
            "seg": _struct((B, T), seg_dt),
            "start_pos": _struct((B, D), torch.int32),
            "start_abs": _struct((B, D), torch.int32),
            "vals": _struct((B, T), torch.float16),
            "doc_ids": _struct((B, D), torch.int32),
        }
        if self.codec == "uncompressed":
            structs["comps"] = _struct((B, T), torch.int32)
        elif self.codec == "bitpack":
            # per-block width ≤ 16 bits for a 30522-dim vocabulary
            structs["words"] = _struct((B, (T * 16 + 31) // 32), torch.uint32)
            structs["widths"] = _struct((B,), torch.int32)
        else:  # dotvbyte (1-bit ctrl) | streamvbyte (2-bit ctrl)
            ctrl_group = 8 if self.codec == "dotvbyte" else 4
            DP = ((T + T // 2) // 128 + 1) * 128  # ~1.5 B/component + over-read
            structs["ctrl"] = _struct((B, T // ctrl_group), torch.uint8)
            structs["data"] = _struct((B, DP), torch.uint8)
        return structs

    def model_flops(self, shape: str) -> float:
        nq = RETRIEVAL_SHAPES[shape]["n_queries"]
        if shape == "scan_100q":
            # useful work: 2 flops per (query × nonzero)
            return 2.0 * self.n_docs * self.doc_nnz * nq
        if shape == "graph_4096q":
            gp = self._graph_cfg().params
            # one neighbour list scored per expanded node
            per_q = (gp["iters"] * self.graph_degree + gp["n_seeds"]) * self.l_max * 2
            return float(per_q) * nq
        ep = self._engine_cfg().params
        per_q = ep["block_budget"] * 64 * 2 + ep["n_probe"] * 64 * self.l_max * 2
        return float(per_q) * nq

    def _engine_cfg(self) -> RetrieverConfig:
        # every codec registered in core/layout.py serves the row form
        return RetrieverConfig(engine="seismic", codec=self.codec, k=10,
                               params=dict(cut=8, block_budget=512, n_probe=64))

    def _graph_cfg(self) -> RetrieverConfig:
        return RetrieverConfig(engine="hnsw", codec=self.codec, k=10,
                               params=dict(beam=64, iters=64, n_seeds=8))

    # ------------------------------------------------------------------
    def build_cell(self, shape: str, mesh) -> Cell:
        da = shd.data_axes(mesh)
        flat = (*da, "model")
        nq = RETRIEVAL_SHAPES[shape]["n_queries"]
        dim_pad = ((self.dim + 127) // 128) * 128
        if shape == "scan_100q":
            return self._scan_cell(mesh, flat, nq, dim_pad)
        return self._search_cell(shape, mesh, da, nq)

    def _scan_cell(self, mesh, flat, nq: int, dim_pad: int) -> Cell:
        base_structs = self.packed_structs()
        n_shards = shd.axis_size(mesh, flat)
        if self.opt == 0:
            make = _global_scan(self.codec, self.n_docs, self.dim, self.value_scale)
            structs_idx = base_structs
            arr_specs = {k: P(flat, *([None] * (v.dim() - 1))) for k, v in base_structs.items()}
            collective = {"reduce-scatter": 4.0 * nq * self.n_docs / n_shards}
        else:
            from ..core.scoring import make_doc_aligned_scan

            docs_local = self.n_docs // n_shards

            def make(device, *_):
                return make_doc_aligned_scan(mesh, flat, docs_local, self.value_scale,
                                             codec=self.codec, device=device)

            # an explicit leading shard axis (layout.pack_blocks_sharded)
            structs_idx = {k: _struct((n_shards, v.shape[0] // n_shards, *v.shape[1:]), v.dtype)
                           for k, v in base_structs.items()}
            arr_specs = {k: P(flat, *([None] * v.dim())) for k, v in base_structs.items()}
            collective = {}
        structs = (structs_idx, _struct((nq, dim_pad), torch.float32))
        in_sh = (shd.to_shardings(mesh, arr_specs), shd.to_shardings(mesh, P(None, None)))
        out_sh = shd.to_shardings(mesh, P(None, flat))
        out = _struct((nq, self.n_docs), torch.float32)
        meta = {"n_docs": self.n_docs, "payload_bytes": self._payload_bytes(), "opt": self.opt}
        return Cell(self.name, "scan_100q", "serve", _OnFirstCall(mesh, make), structs, in_sh,
                    out_sh, self.model_flops("scan_100q"),
                    {**meta, **device_counts(mesh, structs, in_sh, out, out_sh,
                                             self.model_flops("scan_100q"), collective)})

    def _search_cell(self, shape: str, mesh, da, nq: int) -> Cell:
        n_shards = shd.axis_size(mesh, "model")
        n_docs_local = self.n_docs // n_shards + 1
        d_max = ((self.l_max + self.l_max // 2) // 128 + 1) * 128
        if shape == "graph_4096q":
            # sharded HNSW beam search: per-shard sub-graphs over ``model``
            cfg = self._graph_cfg()
            arr = get_engine("hnsw").array_specs(cfg, n_docs=n_docs_local,
                                                 degree=self.graph_degree, l_max=self.l_max,
                                                 d_max=d_max)
        else:  # serve_4096q: the sharded two-phase search
            cfg = self._engine_cfg()
            n_blocks_inv = int(min(self.dim * 4000, self.n_docs * self.doc_nnz) / 64) + 1
            arr = get_engine("seismic").array_specs(
                cfg, dim=self.dim, n_docs=n_docs_local, n_blocks=n_blocks_inv // n_shards + 1,
                s_max=64, bs_max=64, l_max=self.l_max, d_max=d_max)
        arr_stacked = {k: _struct((n_shards, *v.shape), v.dtype) for k, v in arr.items()}
        idmap = _struct((n_shards, n_docs_local + 1), torch.int32)

        def make(device, arrays, idmap, Q):
            # the static n_docs_local above sizes the dry run; a run takes
            # the one its arrays were built at (idmap [S, n_docs_local + 1])
            backend = "cuda" if device.type == "cuda" else "torch"
            return make_sharded_search(mesh, cfg.replace(backend=backend), idmap.shape[-1] - 1,
                                       self.n_docs, self.value_scale, index_axis="model",
                                       query_axes=da, device=device)

        structs = (arr_stacked, idmap, _struct((nq, self.dim), torch.float32))
        in_sh = (shd.to_shardings(mesh, {k: P("model") for k in arr_stacked}),
                 shd.to_shardings(mesh, P("model")), shd.to_shardings(mesh, P(da, None)))
        out_sh = shd.to_shardings(mesh, (P(da, None), P(da, None)))
        out = (_struct((nq, cfg.k), torch.int32), _struct((nq, cfg.k), torch.float32))
        # each device's [nq_local, k] ids and scores, gathered over the index axis
        nq_local = nq // shd.axis_size(mesh, da) if da else nq
        collective = {"all-gather": float(n_shards * nq_local * cfg.k * 8)}
        flops = self.model_flops(shape)
        fn = _OnFirstCall(mesh, make, key=lambda arrays, idmap, Q: idmap.shape[-1])
        return Cell(self.name, shape, "serve", fn, structs, in_sh, out_sh,
                    flops, {"n_docs": self.n_docs, "n_shards": n_shards,
                            **device_counts(mesh, structs, in_sh, out, out_sh, flops,
                                            collective)})

    def _payload_bytes(self) -> int:
        return sum(_nbytes(v) for v in self.packed_structs().values())

    # ------------------------------------------------------------------
    def smoke(self, seed: int = 0, device=None) -> dict:
        """End-to-end mini pipeline: synthetic collection → pack → score
        one query, on ``device`` (``cuda`` unless given), through the
        codec's block-scan entry where it has one, held against
        ``ForwardIndex.exact_scores``."""
        import numpy as np

        from ..core.forward_index import pack_forward_index
        from ..core.scoring import score_packed
        from ..data.synthetic import SyntheticConfig, generate_collection
        from ..kernels import block_scan, ops

        cfg = SyntheticConfig(
            name="smoke", dim=2048, n_docs=200, n_queries=4,
            doc_nnz_mean=min(float(self.doc_nnz), 60.0),
            query_nnz_mean=float(min(self.query_nnz, 16)), seed=seed,
        )
        col = generate_collection(cfg, value_format="f16")
        packed = pack_forward_index(col.fwd, codec=self.codec, block_size=128)
        q = col.query_dense(0)
        device = resolve_device(device)
        if self.codec in block_scan.CODECS:
            got = ops.block_scorers(self.codec)[0](q, packed, device=device)
        else:
            got = score_packed(torch.from_numpy(q).to(device), packed)
        got = got.cpu().numpy()
        want = col.fwd.exact_scores(q)
        err = float(np.abs(got - want).max())
        assert err < 2e-3, err
        return {"max_err": err, "device": device.type}
