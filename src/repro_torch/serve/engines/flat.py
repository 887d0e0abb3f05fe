"""Flat registry entry: exact full scan over the packed row form — the
port of ``repro/serve/engines/flat.py``.

No pruning structure: every query scores every document's row and takes
the global top-k. It is the recall oracle, computed through the same
decode path the approximate engines use. The batch shares one candidate
set (all rows), so ``search_batch`` decodes each row once and scores
the whole query batch against it (``score_candidate_rows_batch``; the
CUDA rows kernel with ``nd = 1`` under ``backend="cuda"``), then selects
the top k: under ``backend="cuda"`` with the top-k select kernel
(``kernels/topk.py``) for ``k`` up to ``topk.MAX_K``, otherwise with a
stable sort (counted in ``spans.counters["topk.sorts"]`` under
``backend="cuda"``). A shard of a
sharded tree packs its rows straight from the doc range
(``build_shard``); the mesh's stacked shards (``shard_build``) are
contiguous ranges padded to one local size.
"""

from __future__ import annotations

import numpy as np
import torch

from ...core import layout
from ...core.forward_index import ForwardIndex
from ...core.scoring import score_candidate_rows_batch
from ...kernels import topk
from ...spans import count
from ..api import EngineImpl, RetrieverConfig, register_engine, row_array_specs

__all__ = ["FlatEngine"]


@register_engine("flat")
class FlatEngine(EngineImpl):
    name = "flat"
    defaults: dict = {}

    def build_arrays(self, fwd: ForwardIndex, cfg: RetrieverConfig):
        return layout.pack_rows(fwd, codec=cfg.codec, vq=cfg.vq).arrays()

    def build_shard(self, fwd: ForwardIndex, cfg: RetrieverConfig, lo: int, hi: int):
        """One shard's rows, packed from the doc range with shard-local
        row ids — no sub-index to build."""
        return layout.pack_rows(fwd, codec=cfg.codec, doc_range=(lo, hi), vq=cfg.vq).arrays()

    def search_batch(self, cfg: RetrieverConfig, n_docs: int, value_scale: float, arrays, Q):
        docs = torch.arange(arrays["nnz_rows"].shape[0], dtype=torch.int32, device=Q.device)
        scores = score_candidate_rows_batch(
            cfg.codec, arrays, docs, Q, value_scale, backend=cfg.backend
        )
        if cfg.backend == "cuda" and cfg.k <= topk.MAX_K:
            top_s, idx = topk.select_topk(scores, cfg.k, n_docs)
        else:
            if cfg.backend == "cuda":
                count("topk.sorts")
            top_s, idx = topk.masked_top_k(scores, cfg.k, n_docs)
        return docs[idx], top_s

    def array_specs(self, cfg: RetrieverConfig, *, n_docs: int, l_max: int, d_max: int,
                    value_dtype=torch.float16, **_ignored):
        return row_array_specs(cfg.codec, n_docs=n_docs, l_max=l_max, d_max=d_max,
                               value_dtype=value_dtype, vq=cfg.vq)

    def shard_build(self, fwd: ForwardIndex, cfg: RetrieverConfig, n_shards: int):
        """Contiguous doc ranges of ``⌈n / n_shards⌉``, each padded with
        empty documents to that local size."""
        n = fwd.n_docs
        docs_local = (n + n_shards - 1) // n_shards
        dicts, idmaps = [], []
        for s in range(n_shards):
            lo, hi = s * docs_local, min((s + 1) * docs_local, n)
            sub = fwd.slice(lo, hi).padded(docs_local)
            dicts.append(layout.pack_rows(sub, codec=cfg.codec, vq=cfg.vq).arrays())
            idmap = np.full(docs_local + 1, n, dtype=np.int32)
            idmap[: hi - lo] = np.arange(lo, hi, dtype=np.int32)
            idmaps.append(idmap)
        return dicts, idmaps, docs_local, {}
