"""A cell's corpus and query pool, made on the device from ``--seed``.

A PyTorch rewrite of the statistics of ``repro_torch/data/synthetic.py``
(the paper's §3 encoders), generated in a few large calls on the card
instead of a Python loop on the host:

* component popularity is Zipf(``zipf_a``) by rank;
* ``n_topics`` topics, each a random set of ``dim // n_topics``
  components boosted by ``topic_concentration`` in the logits; a
  document mixes ``topics_per_doc`` topics;
* a row's components are a Gumbel top-k over those logits (sampling
  without replacement), ``k`` Poisson(``doc_nnz_mean``) clipped to
  ``[4, dim // 4]`` (queries: Poisson(``query_nnz_mean``) in ``[2, dim //
  8]``), relabelled by a random permutation so that the id order carries
  no locality, and sorted;
* values are gamma(``value_shape``, ``value_scale``) + ``value_offset``;
  the shape is 2, so a value is ``scale · (E1 + E2)`` with two unit
  exponentials. Documents store them in ``value_format`` (f16); queries
  keep f32;
* a query takes the topics of a "focus" document drawn uniformly, so
  its exact neighbours are not trivial.

The same seed on the same device gives the same corpus and pool: one
``torch.Generator`` a stream, seeded from (seed, stream), drawn in a
fixed order of calls of fixed shapes. The seed draws the vocabulary's
layout too (which ids are popular, the topics), as the generator it
rewrites does.
"""

from __future__ import annotations

import dataclasses
import hashlib

import numpy as np
import torch

__all__ = ["Corpus", "QueryPool", "generator", "make", "schedule"]

#: documents drawn in one call: the [rows, dim] logits of a chunk are
#: 250 MB at dim 30,522
CHUNK_ROWS = 2048

_VALUE_DTYPES = {"f16": torch.float16, "f32": torch.float32}


@dataclasses.dataclass
class Corpus:
    """CSR over ``n_docs`` documents: ``comps`` int32 [nnz] ascending
    within each document, ``vals`` [nnz] in the stored format, ``offsets``
    int64 [n_docs + 1]."""

    comps: torch.Tensor
    vals: torch.Tensor
    offsets: torch.Tensor
    dim: int

    @property
    def n_docs(self) -> int:
        return self.offsets.shape[0] - 1

    @property
    def nnz(self) -> int:
        return self.comps.shape[0]

    def host(self) -> dict:
        """The CSR as numpy arrays: components u32, values, offsets i64."""
        return {"components": self.comps.cpu().numpy().view(np.uint32),
                "values": self.vals.cpu().numpy(),
                "offsets": self.offsets.cpu().numpy().astype(np.int64)}


@dataclasses.dataclass
class QueryPool:
    """``n`` sparse queries, padded: ``comps`` int64 [n, w], ``vals`` f32
    [n, w] (padding: component 0, value 0)."""

    comps: torch.Tensor
    vals: torch.Tensor
    dim: int

    @property
    def n(self) -> int:
        return self.comps.shape[0]

    def densify(self, rows: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
        """The dense f32 [len(rows), dim] batch of pool rows ``rows``,
        written into ``out``. Padding adds 0 to component 0, so the sum is
        exact."""
        out.zero_()
        return out.scatter_add_(1, self.comps[rows], self.vals[rows])

    def dense(self, rows: torch.Tensor) -> torch.Tensor:
        out = torch.empty((rows.shape[0], self.dim), dtype=torch.float32,
                          device=self.comps.device)
        return self.densify(rows, out)


def generator(seed: int, stream: str, device) -> torch.Generator:
    """A generator on ``device`` seeded from (``seed``, ``stream``): any
    whole number seeds it, the driver's large ones too."""
    digest = hashlib.sha256(f"{int(seed)}:{stream}".encode()).digest()
    g = torch.Generator(device=device)
    g.manual_seed(int.from_bytes(digest[:8], "little") >> 1)
    return g


def _exponential(shape, g, device) -> torch.Tensor:
    # 1 - U lies in (0, 1]: the log is finite
    return -torch.log1p(-torch.rand(shape, generator=g, device=device))


class _Model:
    """The topic model shared by a corpus and its queries."""

    def __init__(self, cfg: dict, n_docs: int, g: torch.Generator, device):
        dim, n_topics = int(cfg["dim"]), int(cfg["n_topics"])
        self.cfg, self.dim, self.device = cfg, dim, device
        ranks = torch.arange(1, dim + 1, dtype=torch.float32, device=device)
        self.background = -float(cfg["zipf_a"]) * torch.log(ranks)
        topic_size = max(dim // n_topics, 8)
        members = torch.rand((n_topics, dim), generator=g, device=device).argsort(dim=1)
        self.topics = torch.zeros((n_topics, dim), dtype=torch.float32, device=device)
        self.topics.scatter_(1, members[:, :topic_size], 1.0)
        self.relabel = torch.randperm(dim, generator=g, device=device)
        self.doc_topics = torch.randint(0, n_topics, (n_docs, int(cfg["topics_per_doc"])),
                                        generator=g, device=device)

    def nnz(self, n: int, mean: float, lo: int, hi: int, g) -> torch.Tensor:
        rate = torch.full((n,), float(mean), dtype=torch.float32, device=self.device)
        return torch.poisson(rate, generator=g).clamp_(lo, hi).to(torch.int64)

    def rows(self, topics: torch.Tensor, nnz: torch.Tensor, k: int, g):
        """Rows of ``nnz`` components each (at most ``k``) → (components
        int64 [n, k] ascending, padded with ``dim``; values f32 [n, k],
        padded with 0; the live mask)."""
        n = topics.shape[0]
        logits = self.background.expand(n, self.dim).clone()
        conc = float(self.cfg["topic_concentration"])
        for j in range(topics.shape[1]):
            logits.add_(torch.index_select(self.topics, 0, topics[:, j]), alpha=conc)
        u = torch.rand((n, self.dim), generator=g, device=self.device)
        logits.sub_(torch.log(-torch.log(u)))  # + Gumbel noise
        picked = logits.topk(k, dim=1).indices
        live = torch.arange(k, device=self.device) < nnz.unsqueeze(1)
        comps = torch.where(live, self.relabel[picked], self.dim).sort(dim=1).values
        vals = float(self.cfg["value_scale"]) * (_exponential((n, k), g, self.device)
                                                 + _exponential((n, k), g, self.device))
        vals = torch.where(live, vals + float(self.cfg["value_offset"]), 0.0)
        return comps, vals, live


def make(cfg: dict, n_docs: int, pool: int, seed: int, device) -> tuple[Corpus, QueryPool]:
    """The corpus of ``n_docs`` documents and a pool of ``pool`` queries
    under the statistics of ``cfg`` (a configuration file's contents)."""
    g = generator(seed, "corpus", device)
    model = _Model(cfg, n_docs, g, device)
    dim = model.dim
    nnz = model.nnz(n_docs, cfg["doc_nnz_mean"], 4, dim // 4, g)
    # the widest row of each chunk, read to the host once
    chunk_k = (torch.nn.functional.pad(nnz, (0, -n_docs % CHUNK_ROWS)).view(-1, CHUNK_ROWS)
               .amax(dim=1).tolist()) if n_docs else []
    comps, vals = [], []
    vdtype = _VALUE_DTYPES[cfg["value_format"]]
    for i, k in enumerate(chunk_k):
        lo, hi = i * CHUNK_ROWS, min((i + 1) * CHUNK_ROWS, n_docs)
        c, v, live = model.rows(model.doc_topics[lo:hi], nnz[lo:hi], k, g)
        comps.append(c[live].to(torch.int32))
        vals.append(v[live].to(vdtype))
    offsets = torch.zeros(n_docs + 1, dtype=torch.int64, device=device)
    torch.cumsum(nnz, 0, out=offsets[1:])
    corpus = Corpus(torch.cat(comps) if comps else torch.zeros(0, dtype=torch.int32, device=device),
                    torch.cat(vals) if vals else torch.zeros(0, dtype=vdtype, device=device),
                    offsets, dim)

    gq = generator(seed, "queries", device)
    focus = torch.randint(0, max(n_docs, 1), (pool,), generator=gq, device=device)
    qnnz = model.nnz(pool, cfg["query_nnz_mean"], 2, dim // 8, gq)
    qk = int(qnnz.max()) if pool else 1
    qc, qv, live = model.rows(model.doc_topics[focus], qnnz, qk, gq)
    queries = QueryPool(torch.where(live, qc, 0), qv, dim)
    return corpus, queries


def schedule(pool: int, batch: int, seed: int, device, epochs: int = 64) -> torch.Tensor:
    """The pool rows of each batch, int64 [n_batches, batch]: ``epochs``
    random permutations of the pool one after another, cut into batches.
    A run that serves more batches starts again from the first."""
    g = generator(seed, "schedule", device)
    order = torch.cat([torch.randperm(pool, generator=g, device=device) for _ in range(epochs)])
    n = order.shape[0] // batch
    if n == 0:
        raise ValueError(f"a pool of {pool} queries cannot fill batches of {batch}")
    return order[: n * batch].view(n, batch)
