"""Seismic (Bruch et al., SIGIR 2024) — the host-side index the paper
plugs its compressed forward index into (numpy; a copy of
``repro/core/seismic.py``: the build byte-identical, the search returning
the same ids and scores on the same input).

Build pipeline:

1. **Static pruning** — each component's inverted list keeps only its
   top ``n_postings`` postings by value.
2. **Geometric blocking** — a list's documents are sorted by a global
   random projection of their sparse vectors and chunked into blocks of
   ≤ ``block_size`` documents.
3. **Summaries** — each block stores an element-wise max summary vector,
   pruned to the smallest component set covering ``summary_mass`` of its
   value mass and quantised to fixedU8.

Query processing (``search``, the reference's numpy heap engine): take
the query's top-``cut`` components, walk their blocks, and score a
block's documents exactly through the forward index (decoded with the
codec of ``prepare_codec``) when its summary's estimate beats
``heap_factor ×`` the current k-th best score. The batched search over
these structures on the device is the ``seismic`` engine
(``serve/engines/seismic.py``). The build is Python loops over
components and blocks; vectorising it for MsMarco scale is ROADMAP
queue A4.
"""

from __future__ import annotations

import dataclasses
import heapq

import numpy as np

from .codecs import get_codec
from .forward_index import ForwardIndex

__all__ = ["SeismicParams", "SeismicIndex", "exact_top_k", "recall_at_k"]


@dataclasses.dataclass(frozen=True)
class SeismicParams:
    n_postings: int = 4000  # λ: postings kept per inverted list
    block_size: int = 64  # max docs per block
    summary_mass: float = 0.5  # fraction of value mass kept in summaries
    summary_scale: float = 1.0 / 32.0  # fixedU8 quantisation step
    proj_dims: int = 1  # random-projection dims used for blocking
    seed: int = 0


def exact_top_k(fwd: ForwardIndex, q_dense: np.ndarray, k: int):
    scores = fwd.exact_scores(q_dense)
    ids = np.argpartition(-scores, min(k, len(scores) - 1))[:k]
    ids = ids[np.argsort(-scores[ids])]
    return ids, scores[ids]


def recall_at_k(true_ids: np.ndarray, got_ids: np.ndarray) -> float:
    return len(set(true_ids.tolist()) & set(got_ids.tolist())) / max(len(true_ids), 1)


@dataclasses.dataclass
class SeismicIndex:
    params: SeismicParams
    fwd: ForwardIndex
    dim: int
    # inverted structure: component → contiguous range of blocks
    comp_block_indptr: np.ndarray  # i64 [dim+1]
    # block → docs
    block_doc_indptr: np.ndarray  # i64 [n_blocks+1]
    block_docs: np.ndarray  # i32 [total_block_postings]
    # block → summary (sparse, quantised)
    summary_indptr: np.ndarray  # i64 [n_blocks+1]
    summary_comps: np.ndarray  # i32
    summary_vals: np.ndarray  # u8 (fixedU8, scale=params.summary_scale)
    # decoded-doc cache for the codec-timed rescoring path
    _decoded: dict | None = None

    @property
    def n_blocks(self) -> int:
        return len(self.block_doc_indptr) - 1

    @staticmethod
    def build(fwd: ForwardIndex, params: SeismicParams = SeismicParams()) -> "SeismicIndex":
        rng = np.random.default_rng(params.seed)
        dim, n_docs = fwd.dim, fwd.n_docs

        # --- global random projection for geometric blocking ------------
        proj = rng.normal(size=(dim, params.proj_dims)).astype(np.float32)
        coords = np.zeros((n_docs, params.proj_dims), dtype=np.float32)
        for d in range(n_docs):
            c, v = fwd.doc(d)
            coords[d] = v @ proj[c]

        # --- inverted lists with static pruning -------------------------
        doc_of = np.repeat(np.arange(n_docs, dtype=np.int32), np.diff(fwd.offsets))
        comps = fwd.components
        vals = fwd.value_format.dequantise(fwd.values)
        order = np.argsort(comps, kind="stable")
        sorted_comps = comps[order]
        list_starts = np.searchsorted(sorted_comps, np.arange(dim + 1))

        comp_block_indptr = np.zeros(dim + 1, dtype=np.int64)
        block_doc_indptr = [0]
        block_docs: list[np.ndarray] = []
        summary_indptr = [0]
        summary_comps: list[np.ndarray] = []
        summary_vals: list[np.ndarray] = []

        n_blocks = 0
        for c in range(dim):
            s, e = int(list_starts[c]), int(list_starts[c + 1])
            comp_block_indptr[c] = n_blocks
            if e == s:
                continue
            idx = order[s:e]
            docs_c = doc_of[idx]
            vals_c = vals[idx]
            # static pruning: top-λ by value
            if len(docs_c) > params.n_postings:
                keep = np.argpartition(-vals_c, params.n_postings)[: params.n_postings]
                docs_c, vals_c = docs_c[keep], vals_c[keep]
            # geometric blocking: sort by projection, chunk
            by_geo = np.argsort(coords[docs_c, 0], kind="stable")
            docs_c = docs_c[by_geo]
            for b0 in range(0, len(docs_c), params.block_size):
                blk = np.sort(docs_c[b0 : b0 + params.block_size])
                block_docs.append(blk)
                block_doc_indptr.append(block_doc_indptr[-1] + len(blk))
                sc, sv = _summarise(fwd, blk, params)
                summary_comps.append(sc)
                summary_vals.append(sv)
                summary_indptr.append(summary_indptr[-1] + len(sc))
                n_blocks += 1
        comp_block_indptr[dim] = n_blocks

        return SeismicIndex(
            params=params,
            fwd=fwd,
            dim=dim,
            comp_block_indptr=comp_block_indptr,
            block_doc_indptr=np.asarray(block_doc_indptr, dtype=np.int64),
            block_docs=(
                np.concatenate(block_docs).astype(np.int32)
                if block_docs
                else np.zeros(0, np.int32)
            ),
            summary_indptr=np.asarray(summary_indptr, dtype=np.int64),
            summary_comps=(
                np.concatenate(summary_comps).astype(np.int32)
                if summary_comps
                else np.zeros(0, np.int32)
            ),
            summary_vals=(
                np.concatenate(summary_vals).astype(np.uint8)
                if summary_vals
                else np.zeros(0, np.uint8)
            ),
        )

    # ------------------------------------------------------------------
    def prepare_codec(self, codec_name: str) -> None:
        """Pre-encode every document with ``codec_name`` for rescoring."""
        from .layout import encode_docs

        self._decoded = {"codec": codec_name, "bufs": encode_docs(self.fwd, codec_name)}

    def _doc_components(self, d: int, codec_name: str) -> np.ndarray:
        """Decode doc d's components with the configured codec (timed path)."""
        if codec_name == "uncompressed" or self._decoded is None:
            s, e = int(self.fwd.offsets[d]), int(self.fwd.offsets[d + 1])
            return self.fwd.components[s:e]
        codec = get_codec(self._decoded["codec"])
        return codec.decode_doc(self._decoded["bufs"][d], self.fwd.nnz(d))

    def search(
        self,
        q_dense: np.ndarray,
        k: int = 10,
        heap_factor: float = 0.9,
        cut: int = 8,
        codec: str = "uncompressed",
    ) -> tuple[np.ndarray, np.ndarray]:
        """Seismic query processing on the host (the reference's numpy
        engine): → (ids i64 [≤ k], scores f32), best first."""
        q = np.asarray(q_dense, dtype=np.float32)
        qc = np.flatnonzero(q)
        if len(qc) == 0:
            return np.zeros(0, np.int64), np.zeros(0, np.float32)
        qc = qc[np.argsort(-np.abs(q[qc]), kind="stable")][:cut]
        sscale = np.float32(self.params.summary_scale)
        vf = self.fwd.value_format

        heap: list[float] = []  # min-heap of top-k scores
        best: dict[int, float] = {}
        visited: set[int] = set()
        for c in qc:
            for b in range(
                int(self.comp_block_indptr[c]), int(self.comp_block_indptr[c + 1])
            ):
                ss, se = int(self.summary_indptr[b]), int(self.summary_indptr[b + 1])
                est = float(
                    q[self.summary_comps[ss:se]]
                    @ (self.summary_vals[ss:se].astype(np.float32) * sscale)
                )
                threshold = heap[0] if len(heap) == k else -np.inf
                if est <= heap_factor * threshold:
                    continue
                ds, de = int(self.block_doc_indptr[b]), int(self.block_doc_indptr[b + 1])
                for d in self.block_docs[ds:de]:
                    d = int(d)
                    if d in visited:
                        continue
                    visited.add(d)
                    comps = self._doc_components(d, codec)
                    s0, e0 = int(self.fwd.offsets[d]), int(self.fwd.offsets[d + 1])
                    score = float(q[comps] @ vf.dequantise(self.fwd.values[s0:e0]))
                    best[d] = score
                    if len(heap) < k:
                        heapq.heappush(heap, score)
                    elif score > heap[0]:
                        heapq.heapreplace(heap, score)
        ids = np.asarray(sorted(best, key=lambda d: -best[d])[:k], dtype=np.int64)
        return ids, np.asarray([best[int(d)] for d in ids], dtype=np.float32)

    # ------------------------------------------------------------------
    def index_bytes(self, codec_name: str = "uncompressed") -> dict[str, int]:
        """Index size accounting mirroring Table 2's GB column."""
        fwd_sizes = self.fwd.storage_bytes(codec_name)
        inverted = int(
            self.block_docs.nbytes
            + self.block_doc_indptr.nbytes
            + self.comp_block_indptr.nbytes
        )
        summaries = int(
            self.summary_comps.nbytes * 2 // 4 + self.summary_vals.nbytes
        )  # comps storable as u16
        return {
            "forward_components": fwd_sizes["components"],
            "forward_values": fwd_sizes["values"],
            "forward_offsets": fwd_sizes["offsets"],
            "inverted": inverted,
            "summaries": summaries,
            "total": fwd_sizes["components"]
            + fwd_sizes["values"]
            + fwd_sizes["offsets"]
            + inverted
            + summaries,
        }


def _summarise(fwd: ForwardIndex, docs: np.ndarray, params: SeismicParams):
    """Element-wise-max summary, α-mass pruned, fixedU8 quantised."""
    spans = [
        (int(fwd.offsets[d]), int(fwd.offsets[d + 1])) for d in np.asarray(docs)
    ]
    cs = np.concatenate([fwd.components[s:e] for s, e in spans]).astype(np.int32)
    vs = fwd.value_format.dequantise(
        np.concatenate([fwd.values[s:e] for s, e in spans])
    )
    order = np.argsort(cs, kind="stable")
    cs, vs = cs[order], vs[order]
    first = np.ones(len(cs), dtype=bool)
    first[1:] = cs[1:] != cs[:-1]
    starts = np.flatnonzero(first)
    comps = cs[starts]
    vals = np.maximum.reduceat(vs, starts) if len(starts) else vs[:0]
    order = np.argsort(-vals, kind="stable")
    comps, vals = comps[order], vals[order]
    mass = np.cumsum(vals)
    keep = int(np.searchsorted(mass, params.summary_mass * mass[-1])) + 1 if len(vals) else 0
    comps, vals = comps[:keep], vals[:keep]
    q = np.clip(np.round(vals / params.summary_scale), 0, 255).astype(np.uint8)
    by_comp = np.argsort(comps, kind="stable")
    return comps[by_comp], q[by_comp]
