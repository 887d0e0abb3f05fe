"""Synthetic MsMarco-statistics collections (no external data offline).

A copy of ``repro/data/synthetic.py`` that draws the same numpy stream,
so the port generates the same collection from the same seed.

Generates learned-sparse-embedding collections whose first-order
statistics match the paper's two encoders (§3):

* **SPLADE**  — 119 nonzeros per document, 43 per query
* **LILSR**   — 387 nonzeros per document,  6 per query (inference-free,
  heavier document expansion — the paper's stress case for compression)

Realism knobs that matter to the paper's claims and are modelled here:

* **Zipfian component popularity** — vocabulary ids follow a power law,
  so d-gap distributions look like real posting data;
* **topical clustering** — documents mix a few latent topics, giving RGB
  a real co-occurrence structure to exploit and Seismic's geometric
  blocking something to cluster;
* **scrambled labels** — component ids are randomly relabelled so the
  *identity* ordering carries no locality (as with a real BPE vocab);
  RGB has to discover it (cf. §2 of the paper);
* **gamma-distributed activations** — positive, right-skewed values as
  produced by ReLU-style sparse encoders.

Queries are generated from the same topic mixture as a "focus" document,
so exact nearest neighbours are non-trivial and recall@k is meaningful.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..core.forward_index import ForwardIndex

__all__ = [
    "SyntheticConfig",
    "splade_config",
    "lilsr_config",
    "SparseCollection",
    "generate_collection",
    "densify",
]


@dataclasses.dataclass(frozen=True)
class SyntheticConfig:
    name: str
    dim: int = 30522
    n_docs: int = 20000
    n_queries: int = 100
    doc_nnz_mean: float = 119.0
    query_nnz_mean: float = 43.0
    n_topics: int = 64
    topic_concentration: float = 6.0  # boost of topic components over background
    zipf_a: float = 1.1  # component popularity power law
    value_shape: float = 2.0  # gamma shape for activations
    value_scale: float = 0.5
    seed: int = 0


def splade_config(n_docs: int = 20000, n_queries: int = 100, seed: int = 0) -> SyntheticConfig:
    return SyntheticConfig(
        name="splade",
        n_docs=n_docs,
        n_queries=n_queries,
        doc_nnz_mean=119.0,
        query_nnz_mean=43.0,
        seed=seed,
    )


def lilsr_config(n_docs: int = 20000, n_queries: int = 100, seed: int = 0) -> SyntheticConfig:
    return SyntheticConfig(
        name="lilsr",
        n_docs=n_docs,
        n_queries=n_queries,
        doc_nnz_mean=387.0,
        query_nnz_mean=6.0,
        seed=seed,
    )


@dataclasses.dataclass
class SparseCollection:
    config: SyntheticConfig
    fwd: ForwardIndex
    query_comps: list[np.ndarray]
    query_vals: list[np.ndarray]

    def query_dense(self, i: int) -> np.ndarray:
        q = np.zeros(self.config.dim, dtype=np.float32)
        q[self.query_comps[i]] = self.query_vals[i]
        return q

    @property
    def n_queries(self) -> int:
        return len(self.query_comps)


def densify(dim: int, comps: np.ndarray, vals: np.ndarray) -> np.ndarray:
    q = np.zeros(dim, dtype=np.float32)
    q[comps] = vals
    return q


def _topic_logits(cfg: SyntheticConfig, rng: np.random.Generator) -> tuple[np.ndarray, np.ndarray]:
    """Background Zipf log-weights + per-topic boosted component sets."""
    ranks = np.arange(1, cfg.dim + 1, dtype=np.float64)
    background = -cfg.zipf_a * np.log(ranks)  # popularity by rank
    topic_size = max(cfg.dim // cfg.n_topics, 8)
    topic_comps = np.stack(
        [rng.choice(cfg.dim, size=topic_size, replace=False) for _ in range(cfg.n_topics)]
    )
    return background.astype(np.float32), topic_comps


def _sample_rows(
    logits: np.ndarray, nnz: np.ndarray, rng: np.random.Generator
) -> list[np.ndarray]:
    """Gumbel top-k sampling without replacement, one row per logit row."""
    out = []
    g = rng.gumbel(size=logits.shape).astype(np.float32)
    keys = logits + g
    for i in range(logits.shape[0]):
        k = int(nnz[i])
        idx = np.argpartition(-keys[i], k)[:k]
        out.append(np.sort(idx).astype(np.uint32))
    return out


def generate_collection(
    cfg: SyntheticConfig, value_format: str = "f32", batch: int = 512
) -> SparseCollection:
    rng = np.random.default_rng(cfg.seed)
    background, topic_comps = _topic_logits(cfg, rng)
    # scrambled labels: identity order must carry no locality
    relabel = rng.permutation(cfg.dim).astype(np.uint32)

    def mixture_logits(n_rows: int, doc_topics: np.ndarray) -> np.ndarray:
        lg = np.tile(background, (n_rows, 1))
        for r in range(n_rows):
            for t in doc_topics[r]:
                lg[r, topic_comps[t]] += cfg.topic_concentration
        return lg

    docs: list[tuple[np.ndarray, np.ndarray]] = []
    doc_topic_sets = rng.integers(0, cfg.n_topics, size=(cfg.n_docs, 3))
    for lo in range(0, cfg.n_docs, batch):
        hi = min(lo + batch, cfg.n_docs)
        nnz = np.clip(
            rng.poisson(cfg.doc_nnz_mean, size=hi - lo), 4, cfg.dim // 4
        )
        lg = mixture_logits(hi - lo, doc_topic_sets[lo:hi])
        rows = _sample_rows(lg, nnz, rng)
        for comps in rows:
            vals = rng.gamma(cfg.value_shape, cfg.value_scale, size=len(comps)).astype(
                np.float32
            ) + np.float32(0.05)
            docs.append((np.sort(relabel[comps]), vals))

    # queries share topics with a focus document
    q_comps, q_vals = [], []
    focus = rng.integers(0, cfg.n_docs, size=cfg.n_queries)
    qnnz = np.clip(rng.poisson(cfg.query_nnz_mean, size=cfg.n_queries), 2, cfg.dim // 8)
    lg = mixture_logits(cfg.n_queries, doc_topic_sets[focus])
    rows = _sample_rows(lg, qnnz, rng)
    for comps in rows:
        vals = rng.gamma(cfg.value_shape, cfg.value_scale, size=len(comps)).astype(
            np.float32
        ) + np.float32(0.05)
        q_comps.append(np.sort(relabel[comps]))
        q_vals.append(vals)

    fwd = ForwardIndex.from_docs(docs, cfg.dim, value_format=value_format)
    return SparseCollection(config=cfg, fwd=fwd, query_comps=q_comps, query_vals=q_vals)
