"""Seismic registry entry: batched, static-shape two-phase search — the
port of ``repro/serve/engines/seismic.py``, written out over a query
batch (every tensor carries a leading ``[nq]`` axis where the reference
ran ``search_one`` under ``vmap``).

  phase 1  for each query: gather the blocks of its top-``cut``
           components (≤ ``block_budget``), score every summary
           (gather + FMA, plain torch), take the top-``n_probe`` blocks;
  phase 2  gather the ≤ n_probe·block_size candidate documents, dedupe
           (sort by id, map repeats to the sentinel row N), re-score
           them exactly against the packed forward-index rows — the
           CUDA rows kernel with one candidate set per query under
           ``backend="cuda"`` — and take the top-k.

Top-k selections break ties toward the lower index, as the reference's
``jax.lax.top_k`` does (``api.top_k``), and the ``max(·, 0)`` guards of
the reference stay explicit: torch indexing raises where ``jnp.take``
clipped.
"""

from __future__ import annotations

import numpy as np
import torch

from ...core import layout
from ...core.scoring import score_candidate_rows
from ...core.seismic import SeismicIndex, SeismicParams
from ..api import EngineImpl, RetrieverConfig, register_engine, top_k

__all__ = ["SeismicEngine"]


@register_engine("seismic")
class SeismicEngine(EngineImpl):
    name = "seismic"
    #: the reference's declaration: a document's blocks may reach several
    #: shards of a block-partitioned index, so the sharded merge dedupes
    dedupe_merge = True
    defaults = {
        # search-time (phase budgets)
        "cut": 8,  # query components probed
        "block_budget": 512,  # max candidate blocks per query (phase 1)
        "n_probe": 64,  # blocks exactly re-scored (phase 2)
        # build-time (host SeismicIndex)
        "n_postings": 4000,
        "block_size": 64,
        "summary_mass": 0.5,
        "summary_scale": 1.0 / 32.0,
        "proj_dims": 1,
        "seed": 0,
    }

    # -- host-side build ------------------------------------------------
    def host_index(self, fwd, cfg: RetrieverConfig) -> SeismicIndex:
        p = self.params(cfg)
        return SeismicIndex.build(
            fwd,
            SeismicParams(
                n_postings=p["n_postings"],
                block_size=p["block_size"],
                summary_mass=p["summary_mass"],
                summary_scale=p["summary_scale"],
                proj_dims=p["proj_dims"],
                seed=p["seed"],
            ),
        )

    def build_arrays(self, fwd, cfg: RetrieverConfig):
        return self.arrays_from_index(self.host_index(fwd, cfg), cfg)

    def arrays_from_index(self, index: SeismicIndex, cfg: RetrieverConfig):
        """SeismicIndex → static engine arrays (numpy): inverted block
        ranges, padded summaries, block→doc lists, plus the packed row
        form for phase-2 rescoring. Byte-identical to the reference."""
        fwd = index.fwd
        n_docs, real_blocks = fwd.n_docs, index.n_blocks
        # an index with no blocks gets one empty sentinel block, so the
        # static arrays never have a zero-size axis 0
        n_blocks = max(real_blocks, 1)

        s_len = np.diff(index.summary_indptr)
        s_max = int(max(s_len.max(initial=1), 1))
        sum_comps = np.zeros((n_blocks, s_max), dtype=np.int32)
        sum_vals = np.zeros((n_blocks, s_max), dtype=np.float32)
        for b in range(real_blocks):
            s, e = int(index.summary_indptr[b]), int(index.summary_indptr[b + 1])
            sum_comps[b, : e - s] = index.summary_comps[s:e]
            sum_vals[b, : e - s] = (
                index.summary_vals[s:e].astype(np.float32) * index.params.summary_scale
            )

        b_len = np.diff(index.block_doc_indptr)
        bs_max = int(max(b_len.max(initial=1), 1))
        block_docs = np.full((n_blocks, bs_max), n_docs, dtype=np.int32)
        for b in range(real_blocks):
            s, e = int(index.block_doc_indptr[b]), int(index.block_doc_indptr[b + 1])
            block_docs[b, : e - s] = index.block_docs[s:e]

        arrays = {
            "cbs": index.comp_block_indptr[:-1].astype(np.int32),
            "cbl": np.diff(index.comp_block_indptr).astype(np.int32),
            "sum_comps": sum_comps,
            "sum_vals": sum_vals,
            "block_docs": block_docs,
        }
        arrays.update(layout.pack_rows(fwd, codec=cfg.codec, vq=cfg.vq).arrays())
        return arrays

    # -- serving --------------------------------------------------------
    def probe(self, cfg: RetrieverConfig, arrays, Q):
        """Phase 1: queries f32 [nq, dim] → (the summary bounds ``est`` f32
        [nq, block_budget], -inf past a component's blocks; the candidate
        blocks ``cand`` i32 [nq, block_budget], -1 there; the probed blocks
        i32 [nq, n_probe], the top ``n_probe`` of ``est``).

        A bound is ``Σ_j q[sum_comps[b, j]] · sum_vals[b, j]``, an f32 sum
        of ``s_max`` products (up to ~1,300 at the CLI's parameters). The
        reference sums them in XLA's order, which no torch op reproduces
        (a left-to-right loop, the pairwise trees and vector-lane orders
        were all tried against it); here torch's reduction sums them, in
        one order whatever the batch. So the contract with the reference
        is a tie rule: a block probed by one side and not the other has a
        bound within f32 rounding (``s_max · eps · Σ_j |q_j · sv_j|``, for
        it and for the block at the ``n_probe`` cut) of the bound at the
        cut (``tests/test_torch_seismic_bounds.py``; PERF.md §7 counts how
        often at the CLI's parameters)."""
        p = self.params(cfg)
        cut, block_budget, n_probe = p["cut"], p["block_budget"], p["n_probe"]
        nq, dev = Q.shape[0], Q.device
        # top-cut query components
        qv, qc = top_k(Q.abs(), cut)  # [nq, cut]
        live = qv > 0
        # candidate blocks: fixed budget round-robin over the cut comps
        starts = arrays["cbs"][qc]
        lens = torch.where(live, arrays["cbl"][qc], 0)
        per = block_budget // cut
        offs = torch.arange(per, dtype=torch.int32, device=dev)
        cand = starts.unsqueeze(-1) + offs  # [nq, cut, per]
        valid = offs < lens.unsqueeze(-1)
        cand = torch.where(valid, cand, -1).reshape(nq, -1)  # [nq, budget]

        # summary upper bounds
        blk = cand.clamp_min(0).long()
        sc = arrays["sum_comps"][blk]  # [nq, budget, s_max]
        sv = arrays["sum_vals"][blk]
        qs = torch.gather(Q, 1, sc.reshape(nq, -1).long()).reshape(sc.shape)
        est = (qs * sv).sum(-1)
        est = torch.where(cand >= 0, est, float("-inf"))
        _, probe = top_k(est, n_probe)
        return est, cand, torch.gather(cand, 1, probe)  # [nq, n_probe]

    def candidates(self, cfg: RetrieverConfig, n_docs: int, arrays, Q):
        """Phases 1 and the dedupe of phase 2: queries f32 [nq, dim] →
        sorted candidate doc ids i32 [nq, n_probe·bs_max], repeats and
        padding mapped to the sentinel ``n_docs``."""
        _, _, probe_blocks = self.probe(cfg, arrays, Q)
        nq = Q.shape[0]
        # phase 2: gather candidate docs, dedupe
        docs = arrays["block_docs"][probe_blocks.clamp_min(0).long()]
        docs = torch.where((probe_blocks >= 0).unsqueeze(-1), docs, n_docs)
        docs = torch.sort(docs.reshape(nq, -1), dim=1).values
        dup = torch.zeros_like(docs, dtype=torch.bool)
        dup[:, 1:] = docs[:, 1:] == docs[:, :-1]
        return torch.where(dup, n_docs, docs).contiguous()

    def search_batch(self, cfg: RetrieverConfig, n_docs: int, value_scale: float, arrays, Q):
        docs = self.candidates(cfg, n_docs, arrays, Q)
        scores = score_candidate_rows(
            cfg.codec, arrays, docs, Q, value_scale, backend=cfg.backend
        )
        scores = torch.where(docs < n_docs, scores, float("-inf"))
        top_s, idx = top_k(scores, cfg.k)
        return torch.gather(docs, 1, idx), top_s

    # -- sharded build (the mesh's stacked shards) ------------------------
    def shard_build(self, fwd, cfg: RetrieverConfig, n_shards: int):
        return self.shard_from_index(self.host_index(fwd, cfg), cfg, n_shards)

    def shard_from_index(self, index: SeismicIndex, cfg: RetrieverConfig, n_shards: int):
        """Partition a SeismicIndex into ``n_shards`` self-contained
        sub-indexes: blocks round-robin, documents by ownership (a doc
        goes to every shard holding one of its blocks — hence
        ``dedupe_merge``); the PQ codebook is copied into every shard.
        Byte-identical to the reference's."""
        A = self.arrays_from_index(index, cfg)
        n_docs = index.fwd.n_docs
        n_blocks = int(A["block_docs"].shape[0])

        shard_docs: list[np.ndarray] = []
        for s in range(n_shards):
            docs = np.unique(A["block_docs"][np.arange(s, n_blocks, n_shards)])
            shard_docs.append(docs[docs < n_docs])
        docs_local_max = max(len(d) for d in shard_docs)

        row_keys = [k for k in A if k.endswith("_rows")]
        shared_vq = {k: A[k] for k in A if k.startswith("vq_") and not k.endswith("_rows")}
        cbs, cbl = A["cbs"], A["cbl"]
        dicts, idmaps = [], []
        for s in range(n_shards):
            blocks = np.arange(s, n_blocks, n_shards)
            docs = shard_docs[s]
            g2l = np.full(n_docs + 1, docs_local_max, dtype=np.int32)
            g2l[docs] = np.arange(len(docs), dtype=np.int32)
            # a component's blocks in this shard are contiguous in the
            # round-robin order
            lcbs = (cbs - s + n_shards - 1) // n_shards
            lcbl = (cbs + cbl - s + n_shards - 1) // n_shards - lcbs
            sub = {
                "cbs": lcbs.astype(np.int32),
                "cbl": np.maximum(lcbl, 0).astype(np.int32),
                "sum_comps": A["sum_comps"][blocks],
                "sum_vals": A["sum_vals"][blocks],
                "block_docs": g2l[A["block_docs"][blocks]],
            }
            pad_rows = np.concatenate([docs, np.full(docs_local_max - len(docs) + 1, n_docs)])
            for k in row_keys:
                sub[k] = A[k][pad_rows]
            sub.update(shared_vq)
            dicts.append(sub)
            idmap = np.full(docs_local_max + 1, n_docs, dtype=np.int32)
            idmap[: len(docs)] = docs
            idmaps.append(idmap)
        return dicts, idmaps, docs_local_max, {"block_docs": docs_local_max}
