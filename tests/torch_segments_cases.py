"""Shared cases of the port's mutation tests (``tests/test_torch_segments*.py``):
the reference's fixture and budgets, the oracle rule, the operation
sweep, and the port and the reference driven side by side."""

import numpy as np
import pytest
import torch

from repro.serve import api as ref_api
from repro.serve import segments as ref_segments
from repro_torch.serve.api import Retriever, RetrieverConfig
from repro_torch.serve.segments import MutableRetriever

ENGINES = ["seismic", "hnsw", "flat"]

#: the reference's budgets, exhaustive for the 50-doc collection: the
#: mutable fan-out and the oracle see the same candidate sets
ENGINE_PARAMS = {
    "seismic": dict(cut=16, block_budget=512, n_probe=512, n_postings=10000, block_size=8),
    "hnsw": dict(beam=64, iters=64, n_seeds=4, m=8, ef_construction=48),
    "flat": {},
}
SEGMENTS_COLLECTION = dict(name="segments-test", dim=256, n_docs=50, n_queries=4,
                           doc_nnz_mean=24.0, query_nnz_mean=8.0, seed=7)
N_BASE = 40
#: f16 values: the two packages sum the same products in another order
ATOL = 2e-3


@pytest.fixture(scope="module", autouse=True)
def one_intra_op_thread():
    """These modules score a few dozen docs at a time: one intra-op thread
    per test process keeps the workers of a parallel run from
    oversubscribing the cores (the previous count is restored after)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def cfg_for(engine, codec="uncompressed", n_shards=1, k=10, **kw):
    return RetrieverConfig(engine=engine, codec=codec, k=k, n_shards=n_shards,
                           params=ENGINE_PARAMS[engine], **kw)


def host(pair):
    return tuple(t.cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
                 for t in pair)


def create(fwd, cfg, root=None):
    return MutableRetriever.create(fwd, cfg, root, device="cpu")


def stable(live, oi):
    """Oracle positions → stable ids; the oracle's out-of-corpus slots
    (fewer live docs than k) → -1, the mutable index's empty slot."""
    return np.where(oi < len(live), live[np.minimum(oi, len(live) - 1)], -1)


def assert_oracle_parity(m, cfg, Q, label):
    """Mutable top-k == the oracle over the live corpus, byte for byte."""
    live_fwd, live = m.live_corpus()
    oracle = Retriever.build(live_fwd, cfg.replace(n_shards=1), device="cpu")
    oi, osc = host(oracle.search(Q))
    mi, ms = host(m.search(Q))
    np.testing.assert_array_equal(mi, stable(live, oi), err_msg=f"{label}: ids")
    np.testing.assert_array_equal(ms, osc, err_msg=f"{label}: scores")


def segment_sweep(m, fwd, check):
    """The reference's operation sequence: tombstones at 0 segments, one
    segment, three (tombstones inside segments, an update), the merge."""
    m.delete([3, 17])
    check("0 segments")
    m.insert([fwd.doc(i) for i in range(N_BASE, N_BASE + 4)])
    assert len(m.segments) == 1
    check("1 segment")
    m.insert([fwd.doc(i) for i in range(44, 47)])
    m.delete([41, 45])
    m.update([fwd.doc(47)], ids=[10])
    assert len(m.segments) == 3
    check("3 segments")
    expect_live = m.live_ids()
    m.merge()
    assert len(m.segments) == 0 and m.generation == 1
    np.testing.assert_array_equal(m.base_ids, expect_live)
    check("post-merge")


class Twins:
    """The port's and the reference's ``MutableRetriever`` driven through
    one operation sequence. ``check`` holds the port to the reference
    (ids equal, scores within f16's atol, and the bookkeeping) and, where
    the engine is exhaustive at these budgets (flat, Seismic), to the
    oracle byte for byte; hnsw orders score ties by its walk, so there
    the reference is the bar."""

    def __init__(self, port_col, ref_col, engine, codec, n_base, k=5):
        self.fwd, self.ref_fwd = port_col.fwd, ref_col.fwd
        self.engine = engine
        self.cfg = cfg_for(engine, codec, k=k)
        self.port = create(self.fwd.slice(0, n_base), self.cfg)
        self.ref = ref_segments.MutableRetriever.create(
            self.ref_fwd.slice(0, n_base),
            ref_api.RetrieverConfig(engine=engine, codec=codec, k=k,
                                    params=ENGINE_PARAMS[engine]))

    def insert(self, rows):
        a = self.port.insert([self.fwd.doc(i) for i in rows])
        b = self.ref.insert([self.ref_fwd.doc(i) for i in rows])
        np.testing.assert_array_equal(a, b)
        return a

    def do(self, op, *args):
        for m in (self.port, self.ref):
            getattr(m, op)(*args)

    def check(self, Q, label):
        p, r = self.port, self.ref
        np.testing.assert_array_equal(p.live_ids(), r.live_ids())
        assert (p.next_id, p.epoch, p.generation) == (r.next_id, r.epoch, r.generation)
        pi, ps = host(p.search(Q))
        ri, rs = host(r.search(Q))
        np.testing.assert_array_equal(pi, ri, err_msg=f"{label}: ids vs reference")
        np.testing.assert_allclose(ps, rs, rtol=0, atol=ATOL, err_msg=f"{label}: scores")
        if self.engine != "hnsw" and p.n_live + 1 >= p.cfg.k:  # else flat's oracle raises (C1)
            assert_oracle_parity(p, self.cfg, Q, label)
