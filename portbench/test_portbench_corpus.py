"""The benchmark's corpus generator (``corpus.py``) and its yardstick
(``counts.py``) on the CPU."""

import json

import pytest
import torch

from portbench import cells, corpus, counts


def _config(name):
    return json.loads((cells.HERE / "configs" / f"{name}.json").read_text())


@pytest.mark.parametrize("name,doc,query", [("msmarco-splade", 119, 43), ("msmarco-lilsr", 387, 6)])
def test_mean_nonzeros_follow_the_configuration(name, doc, query):
    cfg = _config(name)
    docs, pool = corpus.make(cfg, 600, 512, 3, "cpu")
    assert docs.n_docs == 600
    assert abs(docs.nnz / 600 - doc) < 0.05 * doc
    q = (pool.vals > 0).sum(dim=1).double().mean().item()
    assert abs(q - query) < 0.08 * query
    assert docs.vals.dtype == torch.float16 and float(docs.vals.float().min()) >= 0.05 - 1e-3


def test_rows_are_sorted_distinct_and_in_the_vocabulary():
    cfg = _config("msmarco-splade")
    docs, pool = corpus.make(cfg, 300, 64, 9, "cpu")
    c = docs.comps.long()
    inside = torch.ones(c.shape[0] - 1, dtype=torch.bool)
    inside[docs.offsets[1:-1] - 1] = False  # pairs across a document boundary
    assert bool(((c[1:] - c[:-1]) > 0)[inside].all())
    assert int(c.min()) >= 0 and int(c.max()) < cfg["dim"]
    Q = pool.dense(torch.arange(pool.n))
    assert torch.equal((Q > 0).sum(dim=1), (pool.vals > 0).sum(dim=1))


def test_the_same_seed_gives_the_same_inputs_and_another_seed_others():
    cfg = _config("msmarco-lilsr")
    big = 2**31 + 12345
    a, qa = corpus.make(cfg, 200, 32, big, "cpu")
    b, qb = corpus.make(cfg, 200, 32, big, "cpu")
    c, _ = corpus.make(cfg, 200, 32, big + 1, "cpu")
    assert torch.equal(a.comps, b.comps) and torch.equal(a.vals, b.vals)
    assert torch.equal(qa.comps, qb.comps) and torch.equal(qa.vals, qb.vals)
    assert not torch.equal(a.offsets, c.offsets)


def test_the_schedule_covers_the_pool_each_epoch():
    s = corpus.schedule(1000, 100, 5, "cpu", epochs=3)
    assert s.shape == (30, 100)
    for e in range(3):
        assert torch.equal(s[10 * e: 10 * (e + 1)].flatten().sort().values, torch.arange(1000))


def test_counts_by_hand():
    # doc 0: components 0, 5, 300 (gaps 0, 5, 295: data 1 + 1 + 2 bytes);
    # doc 1: component 256 (its first gap is 256: 2 bytes); doc 2 empty
    comps = torch.tensor([0, 5, 300, 256], dtype=torch.int32)
    offsets = torch.tensor([0, 3, 4, 4])
    st = counts.corpus_stats(comps, offsets, "f16", torch.tensor([2, 4]))
    assert st["n_docs"] == 3 and st["nnz"] == 4
    assert st["data_bytes"] == 6 and st["ctrl_bytes"] == 0.5 and st["value_bytes"] == 8
    assert st["dotvbyte_bytes"] == 14.5 and st["mean_query_nnz"] == 3.0
    # the scan of 2 queries: 14.5 + 2·3·4 + 2·3·4 = 62.5 bytes; 2·2·4 = 16 FLOP
    assert counts.exhaustive_bound(st, 2) == pytest.approx(62.5 / counts.HBM_BYTES_PER_S)


def test_an_ops_bound_when_the_bytes_are_few():
    st = {"n_docs": 1, "nnz": 10**9, "dotvbyte_bytes": 1.0, "mean_query_nnz": 0.0}
    assert counts.exhaustive_bound(st, 3) == pytest.approx(2 * 3 * 10**9 / counts.F32_FLOP_PER_S)
