"""HNSW (Malkov & Yashunin) over sparse learned embeddings — the host-side
graph build the ``hnsw`` engine serves (numpy; a copy of
``repro/core/hnsw.py`` whose graph is byte-identical on the same input:
the same ``levels``, adjacency, seed nodes and edge count).

Build pipeline (standard HNSW, inner-product "distance" = −⟨x, y⟩):

1. **level sampling** — node levels are geometric with multiplier
   ``1/ln(M)``;
2. **greedy descent** — insertion walks from the global entry point down
   through the upper layers with ef = 1;
3. **beam search + heuristic selection** — on each layer ≤ the node's
   level, an ``ef_construction`` beam collects candidates and the
   classic diversity heuristic keeps ≤ ``M`` of them (a candidate is
   kept only if it is closer to the new node than to every neighbour
   already selected; pruned candidates back-fill);
4. **bidirectional links** — over-full neighbour lists re-shrink with
   the same heuristic.

Every score is the reference's numpy expression on the same operands,
so every heap and sort sees the same floats and ties break by ascending
doc id as there. What differs is only where the operands come from: each
document's component and dequantised value slices are taken once
(``_rows``), and the heuristic's candidate rows are written into one
scratch vector and cleared after use instead of densified afresh. The
build is still Python insertion loops (~10 ms a document at SPLADE
statistics); vectorising it is ROADMAP queue A4.

The batched search over the graph is the ``hnsw`` engine
(``serve/engines/hnsw.py``); :meth:`HNSWIndex.search` here is the
faithful heap-based reference search.
"""

from __future__ import annotations

import dataclasses
import heapq
import math

import numpy as np

from .codecs import get_codec
from .forward_index import ForwardIndex

__all__ = ["HNSWParams", "HNSWIndex"]


@dataclasses.dataclass(frozen=True)
class HNSWParams:
    m: int = 16  # max degree on layers ≥ 1; selection budget at insert
    m0: int | None = None  # base-layer max degree (default 2·m)
    ef_construction: int = 64  # insertion beam width
    seed: int = 0

    @property
    def level_mult(self) -> float:
        return 1.0 / math.log(self.m)

    def degree(self, layer: int) -> int:
        return (self.m0 or 2 * self.m) if layer == 0 else self.m


@dataclasses.dataclass
class HNSWIndex:
    """Hierarchical small-world graph over the forward index.

    ``graph[layer]`` maps node → neighbour list (≤ ``degree(layer)``).
    Levels come from one seeded ``default_rng``; every heap and sort
    breaks ties by ascending doc id, so identical (fwd, params) builds
    are bit-identical, here and in the reference."""

    params: HNSWParams
    fwd: ForwardIndex
    dim: int
    levels: np.ndarray  # i32 [n_docs]
    entry: int = -1
    max_level: int = -1
    graph: list[dict[int, list[int]]] = dataclasses.field(default_factory=list)
    # host-encoded docs for the codec-timed reference search
    _decoded: dict | None = None
    # per doc: (component slice, dequantised value slice), views of the CSR
    _rows: list | None = None
    # the heuristic's candidate row, written and cleared per candidate
    _scratch: np.ndarray | None = None

    # ------------------------------------------------------------------
    @staticmethod
    def build(fwd: ForwardIndex, params: HNSWParams = HNSWParams()) -> "HNSWIndex":
        rng = np.random.default_rng(params.seed)
        u = rng.uniform(size=fwd.n_docs)
        levels = np.floor(
            -np.log(np.clip(u, 1e-12, None)) * params.level_mult
        ).astype(np.int32)
        index = HNSWIndex(params=params, fwd=fwd, dim=fwd.dim, levels=levels)
        for i in range(fwd.n_docs):
            index._insert(i)
        return index

    @property
    def n_edges(self) -> int:
        return sum(len(nbrs) for layer in self.graph for nbrs in layer.values())

    # -- scoring -------------------------------------------------------
    def _row(self, d: int) -> tuple[np.ndarray, np.ndarray]:
        """(components, dequantised values) of doc ``d``: slices of the
        CSR arrays and of their dequantised copy, taken once per doc."""
        if self._rows is None:
            vals = self.fwd.value_format.dequantise(self.fwd.values)
            offs = self.fwd.offsets.tolist()
            comps = self.fwd.components
            self._rows = [(comps[s:e], vals[s:e]) for s, e in zip(offs[:-1], offs[1:])]
        return self._rows[d]

    def prepare_codec(self, codec_name: str) -> None:
        """Pre-encode every document with ``codec_name`` for the timed
        reference-search path."""
        from .layout import encode_docs

        self._decoded = {"codec": codec_name, "bufs": encode_docs(self.fwd, codec_name)}

    def _doc_components(self, d: int, codec_name: str) -> np.ndarray:
        if codec_name == "uncompressed":
            return self._row(d)[0]
        if self._decoded is None or self._decoded["codec"] != codec_name:
            self.prepare_codec(codec_name)  # lazy, so timings stay honest
        codec = get_codec(codec_name)
        return codec.decode_doc(self._decoded["bufs"][d], self.fwd.nnz(d))

    def _score(self, q_dense: np.ndarray, d: int, codec: str = "uncompressed") -> float:
        comps, vals = self._row(d)
        if codec != "uncompressed":
            comps = self._doc_components(d, codec)
        return float(q_dense[comps] @ vals)

    # -- build internals -----------------------------------------------
    def _greedy(self, q: np.ndarray, ep: int, layer: int, codec: str = "uncompressed") -> int:
        """ef=1 hill climb on one layer (the upper-layer descent)."""
        cur, cur_s = ep, self._score(q, ep, codec)
        improved = True
        while improved:
            improved = False
            for nb in self.graph[layer].get(cur, ()):
                s = self._score(q, nb, codec)
                if s > cur_s:
                    cur, cur_s, improved = nb, s, True
        return cur

    def _search_layer(
        self, q: np.ndarray, eps: list[int], ef: int, layer: int,
        codec: str = "uncompressed",
    ) -> list[tuple[float, int]]:
        """Beam search on one layer → candidates sorted by score desc."""
        graph = self.graph[layer]
        visited = set(eps)
        cand: list[tuple[float, int]] = []  # max-heap by score (negated)
        res: list[tuple[float, int]] = []  # min-heap of the ef best
        for e in eps:
            s = self._score(q, e, codec)
            heapq.heappush(cand, (-s, e))
            heapq.heappush(res, (s, e))
            if len(res) > ef:
                heapq.heappop(res)
        while cand:
            ns, c = heapq.heappop(cand)
            if len(res) >= ef and -ns < res[0][0]:
                break
            for nb in graph.get(c, ()):
                if nb in visited:
                    continue
                visited.add(nb)
                s = self._score(q, nb, codec)
                if len(res) < ef or s > res[0][0]:
                    heapq.heappush(cand, (-s, nb))
                    heapq.heappush(res, (s, nb))
                    if len(res) > ef:
                        heapq.heappop(res)
        return sorted(res, key=lambda t: (-t[0], t[1]))

    def _select_heuristic(
        self, cands: list[tuple[float, int]], m: int
    ) -> list[int]:
        """Diversity heuristic: keep a candidate only if its similarity
        to every already-selected neighbour is below its similarity to
        the query point; pruned candidates back-fill up to ``m``."""
        if self._scratch is None:
            self._scratch = np.zeros(self.dim, dtype=np.float32)
        c_dense = self._scratch  # all zero between candidates
        selected: list[int] = []
        skipped: list[int] = []
        for s, c in cands:
            if len(selected) == m:
                break
            ccs, cvs = self._row(c)
            c_dense[ccs] = cvs  # densify(c), without a fresh zero fill
            diverse = True
            for sd in selected:
                scs, svs = self._row(sd)
                if float(c_dense[scs] @ svs) >= s:
                    diverse = False
                    break
            c_dense[ccs] = 0.0
            (selected if diverse else skipped).append(c)
        for c in skipped:
            if len(selected) == m:
                break
            selected.append(c)
        return selected

    def _shrink(self, node: int, layer: int) -> None:
        """Re-select an over-full neighbour list with the heuristic."""
        qd = self.fwd.densify(node)
        cands = sorted(
            ((self._score(qd, n), n) for n in self.graph[layer][node]),
            key=lambda t: (-t[0], t[1]),
        )
        self.graph[layer][node] = self._select_heuristic(
            cands, self.params.degree(layer)
        )

    def _insert(self, i: int) -> None:
        l = int(self.levels[i])  # noqa: E741  (the paper's name)
        while len(self.graph) <= l:
            self.graph.append({})
        for layer in range(l + 1):
            self.graph[layer].setdefault(i, [])
        if self.entry < 0:
            self.entry, self.max_level = i, l
            return
        q = self.fwd.densify(i)
        ep = self.entry
        for layer in range(self.max_level, l, -1):
            ep = self._greedy(q, ep, layer)
        eps = [ep]
        for layer in range(min(l, self.max_level), -1, -1):
            cands = self._search_layer(q, eps, self.params.ef_construction, layer)
            cands = [(s, c) for s, c in cands if c != i]
            for j in self._select_heuristic(cands, self.params.m):
                self.graph[layer][i].append(j)
                self.graph[layer][j].append(i)
                if len(self.graph[layer][j]) > self.params.degree(layer):
                    self._shrink(j, layer)
            eps = [c for _, c in cands]
        if l > self.max_level:
            self.entry, self.max_level = i, l

    # -- query processing (reference path) ------------------------------
    def search(
        self, q_dense: np.ndarray, k: int = 10, ef: int = 64,
        codec: str = "uncompressed",
    ) -> tuple[np.ndarray, np.ndarray]:
        """Faithful HNSW query processing (numpy reference engine).

        ``codec`` routes every candidate's component decode through the
        host codec, so decode cost sits inside the measured search."""
        if self.entry < 0:
            return np.zeros(0, np.int64), np.zeros(0, np.float32)
        q = np.asarray(q_dense, dtype=np.float32)
        ep = self.entry
        for layer in range(self.max_level, 0, -1):
            ep = self._greedy(q, ep, layer, codec)
        cands = self._search_layer(q, [ep], max(ef, k), 0, codec)[:k]
        ids = np.asarray([c for _, c in cands], dtype=np.int64)
        return ids, np.asarray([s for s, _ in cands], dtype=np.float32)

    # -- serving exports -----------------------------------------------
    def adjacency(self, layer: int = 0, sentinel: int | None = None) -> np.ndarray:
        """Fixed-degree adjacency ``[n_docs+1, degree(layer)]`` padded
        with ``sentinel`` (default n_docs); row n_docs is all-sentinel —
        the out-of-range absorber the batched engine gathers through."""
        n = self.fwd.n_docs
        deg = self.params.degree(layer)
        sent = n if sentinel is None else sentinel
        adj = np.full((n + 1, deg), sent, dtype=np.int32)
        if layer < len(self.graph):
            for node, nbrs in self.graph[layer].items():
                adj[node, : min(len(nbrs), deg)] = nbrs[:deg]
        return adj

    def seed_nodes(self, n_seeds: int, sentinel: int | None = None) -> np.ndarray:
        """Static entry points for the serve-time beam: the global entry
        point plus the highest-level nodes (the hierarchy's natural
        hubs), sentinel-padded to ``n_seeds``."""
        sent = self.fwd.n_docs if sentinel is None else sentinel
        order = np.argsort(-self.levels, kind="stable")
        if self.entry >= 0:
            seeds = np.concatenate(
                [[self.entry], order[order != self.entry][: n_seeds - 1]]
            )[:n_seeds]
        else:
            seeds = order[:n_seeds]
        return np.concatenate(
            [seeds, np.full(n_seeds - len(seeds), sent)]
        ).astype(np.int32)

    # ------------------------------------------------------------------
    def index_bytes(self, codec_name: str = "uncompressed") -> dict[str, int]:
        """Index size accounting (graph edges at i32 + level array),
        beside the forward index's bytes under ``codec_name``."""
        fwd_sizes = self.fwd.storage_bytes(codec_name)
        graph = int(4 * self.n_edges + self.levels.nbytes)
        return {
            "forward_components": fwd_sizes["components"],
            "forward_values": fwd_sizes["values"],
            "forward_offsets": fwd_sizes["offsets"],
            "graph": graph,
            "total": fwd_sizes["components"]
            + fwd_sizes["values"]
            + fwd_sizes["offsets"]
            + graph,
        }
