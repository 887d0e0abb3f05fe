"""HNSW registry entry: batched, static-shape beam search over the graph
built by ``core/hnsw.py`` — the port of ``repro/serve/engines/hnsw.py``,
its ``search_one`` written out over a leading ``[nq]`` axis where the
reference ran it under ``vmap``.

The hierarchy collapses to the base-layer fixed-degree adjacency
``adj [N+1, M0]`` plus ``n_seeds`` query-independent entry hubs; the
heap becomes a fixed-width beam. Each of ``iters`` steps, for every
query at once:

1. takes the best not-yet-expanded beam node (``argmax``, the first
   index on ties as ``jnp.argmax``; a beam of ``-inf`` re-picks slot 0,
   whose neighbours are all visited or the sentinel);
2. gathers its ``M0`` neighbours and marks the fresh ones — real and not
   yet visited — before it sets them visited (``[nq, N+1]``, kept as its
   complement ``unseen``);
3. scores the fresh neighbours exactly through the packed rows
   (``scoring.candidate_rows_scorer``, one set per query: the CUDA rows
   kernel under ``backend="cuda"``), the rest ``-inf``;
4. keeps the top ``beam`` of beam ∪ neighbours (``api.top_k``: a stable
   sort, the lower index first on ties, as ``jax.lax.top_k``).

A search is one rows-kernel launch for the seeds and one per step. The
search holds no host synchronisation and no host-to-device copy (no
``.item()``, no transfer, no branch on a tensor's value), so the card
runs ahead of the host and a plan captures the whole search as one
CUDA graph (``serve/pipeline.py``).
"""

from __future__ import annotations

import numpy as np
import torch

from ...core import layout
from ...core.hnsw import HNSWIndex, HNSWParams
from ...core.scoring import candidate_rows_scorer
from ..api import EngineImpl, RetrieverConfig, register_engine, top_k

__all__ = ["HNSWEngine"]


@register_engine("hnsw")
class HNSWEngine(EngineImpl):
    name = "hnsw"
    defaults = {
        # search-time (static beam)
        "beam": 64,  # beam width (the static ef)
        "iters": 64,  # nodes expanded per query
        "n_seeds": 8,  # query-independent entry hubs
        # build-time (host HNSWIndex)
        "m": 16,
        "m0": None,
        "ef_construction": 64,
        "seed": 0,
    }

    def params(self, cfg: RetrieverConfig):
        p = super().params(cfg)
        if p["n_seeds"] > p["beam"]:
            raise ValueError("n_seeds must not exceed beam width")
        return p

    # -- host-side build ------------------------------------------------
    def host_params(self, cfg: RetrieverConfig) -> HNSWParams:
        p = self.params(cfg)
        return HNSWParams(
            m=p["m"], m0=p["m0"], ef_construction=p["ef_construction"], seed=p["seed"]
        )

    def host_index(self, fwd, cfg: RetrieverConfig) -> HNSWIndex:
        return HNSWIndex.build(fwd, self.host_params(cfg))

    def build_arrays(self, fwd, cfg: RetrieverConfig):
        return self.arrays_from_index(self.host_index(fwd, cfg), cfg)

    def arrays_from_index(self, index: HNSWIndex, cfg: RetrieverConfig):
        """HNSWIndex → engine arrays (numpy): ``adj`` i32 [N+1, M0],
        ``seeds`` i32 [n_seeds], plus the packed row form. Byte-identical
        to the reference's."""
        p = self.params(cfg)
        arrays = {
            "adj": index.adjacency(0),
            "seeds": index.seed_nodes(p["n_seeds"]),
        }
        arrays.update(layout.pack_rows(index.fwd, codec=cfg.codec, vq=cfg.vq).arrays())
        return arrays

    # -- serving --------------------------------------------------------
    def search_batch(self, cfg: RetrieverConfig, n_docs: int, value_scale: float, arrays, Q):
        """Queries f32 [nq, dim] → (ids i32 [nq, k], scores f32 [nq, k]).

        Sentinel id ``n_docs`` gathers the all-zero row and the
        all-sentinel adjacency row and scores −inf, so padding absorbs
        itself."""
        p = self.params(cfg)
        beam, iters = p["beam"], p["iters"]
        nq, dev = Q.shape[0], Q.device
        score = candidate_rows_scorer(cfg.codec, arrays, Q, value_scale, backend=cfg.backend)
        # ids ride as int64 (what gather and scatter index with) and go
        # to the kernel as int32; ``unseen`` is the reference's ~visited,
        # with the sentinel column cleared at the start (the reference's
        # ``nbrs < n_docs`` test), so one gather gives ``fresh``
        adj = arrays["adj"].long()
        seeds = arrays["seeds"].long()  # [n_seeds], sentinel-padded
        n_pad = beam - seeds.shape[0]

        seed_docs = seeds.unsqueeze(0).expand(nq, -1)
        seed_scores = torch.where(seed_docs < n_docs, score(seed_docs.int().contiguous()),
                                  float("-inf"))
        ids = torch.cat([seed_docs, torch.full((nq, n_pad), n_docs, device=dev)], dim=1)
        scores = torch.cat([seed_scores, torch.full((nq, n_pad), float("-inf"), device=dev)],
                           dim=1)
        expanded = ids >= n_docs  # sentinel slots never expand
        unseen = torch.ones((nq, n_docs + 1), dtype=torch.bool, device=dev)
        # in-place fills, not ``unseen[:, seeds] = False``: that setitem copies
        # a host scalar to the card, which a CUDA graph cannot capture
        unseen.index_fill_(1, seeds, False)
        unseen[:, n_docs].fill_(False)
        for _ in range(iters):
            b = torch.argmax(scores.masked_fill(expanded, float("-inf")), dim=1, keepdim=True)
            expanded.scatter_(1, b, True)
            nbrs = adj[torch.gather(ids, 1, b).squeeze(1)]  # [nq, M0]
            fresh = torch.gather(unseen, 1, nbrs)  # read before this step's marks
            nbrs = torch.where(fresh, nbrs, n_docs)
            unseen.scatter_(1, nbrs, False)
            ns = torch.where(fresh, score(nbrs.int()), float("-inf"))
            # top-beam merge of beam ∪ neighbours (ids unique by the visited mask)
            top_s, idx = top_k(torch.cat([scores, ns], dim=1), beam)
            ids = torch.gather(torch.cat([ids, nbrs], dim=1), 1, idx)
            expanded = torch.gather(torch.cat([expanded, ~fresh], dim=1), 1, idx)
            scores = top_s
        top_s, idx = top_k(scores, cfg.k)
        return torch.gather(ids, 1, idx).int(), top_s

    # -- sharded build (the mesh's stacked shards) ------------------------
    def shard_build(self, fwd, cfg: RetrieverConfig, n_shards: int):
        """Contiguous doc ranges, one self-contained sub-graph each with
        range-local ids, embedded in the padded local id space (rows past
        a range's documents all-sentinel, unreachable by search)."""
        p = self.params(cfg)
        hp = self.host_params(cfg)
        n = fwd.n_docs
        docs_local = (n + n_shards - 1) // n_shards
        dicts, idmaps = [], []
        for s in range(n_shards):
            lo, hi = s * docs_local, min((s + 1) * docs_local, n)
            sub = fwd.slice(lo, hi)
            n_real = sub.n_docs
            index = HNSWIndex.build(sub, hp)
            adj = np.full((docs_local + 1, hp.degree(0)), docs_local, dtype=np.int32)
            adj[:n_real] = index.adjacency(0, sentinel=docs_local)[:n_real]
            dicts.append({
                "adj": adj,
                "seeds": index.seed_nodes(p["n_seeds"], sentinel=docs_local),
                **layout.pack_rows(sub.padded(docs_local), codec=cfg.codec, vq=cfg.vq).arrays(),
            })
            idmap = np.full(docs_local + 1, n, dtype=np.int32)
            idmap[:n_real] = np.arange(lo, hi, dtype=np.int32)
            idmaps.append(idmap)
        return dicts, idmaps, docs_local, {"adj": docs_local, "seeds": docs_local}
