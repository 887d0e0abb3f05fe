"""The port CLI's ``--encoder`` and ``--engine both|all``
(``repro_torch/launch/serve.py``) against the reference CLI's rules:
the engine expansion, LiLSR statistics, and one small ``--encoder lilsr
--engine all`` run on the CPU whose recall per engine equals the
reference library's ``Retriever.search`` on the same collection (the
reference CLI itself is not run: its XLA compiles take ~80 s)."""

import re

import numpy as np
import pytest
import torch

from repro.core.seismic import exact_top_k as ref_exact_top_k
from repro.core.seismic import recall_at_k as ref_recall_at_k
from repro.data import synthetic as ref_synthetic
from repro.serve import api as ref_api
from repro_torch.data import synthetic
from repro_torch.launch import serve as serve_cli

N_DOCS, N_QUERIES = 150, 4


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name", ["seismic", "hnsw", "flat", "both", "all"])
def test_engine_expansion_matches_reference(name):
    want = {"both": ("seismic", "hnsw"), "all": tuple(ref_api.available_engines())}
    assert serve_cli.expand_engines(name) == want.get(name, (name,))


def test_encoder_choices_pick_the_statistics():
    assert serve_cli.ENCODERS["splade"] is synthetic.splade_config
    assert serve_cli.ENCODERS["lilsr"] is synthetic.lilsr_config
    for name in ("splade", "lilsr"):
        got = serve_cli.ENCODERS[name](100, 3, 1)
        want = getattr(ref_synthetic, f"{name}_config")(100, 3, 1)
        assert got.doc_nnz_mean == want.doc_nnz_mean and got.query_nnz_mean == want.query_nnz_mean
    with pytest.raises(SystemExit):
        serve_cli.main(["--encoder", "bm25", "--device", "cpu"])


def test_lilsr_all_engines_recall_equals_reference(capsys):
    serve_cli.main(["--device", "cpu", "--encoder", "lilsr", "--engine", "all",
                    "--n-docs", str(N_DOCS), "--n-queries", str(N_QUERIES)])
    out = capsys.readouterr().out
    assert f"generating {N_DOCS}-doc synthetic lilsr collection" in out
    nnz = float(re.search(r"\(nnz/doc=(\d+)\)", out)[1])
    assert 360 <= nnz <= 410  # LiLSR's 387 a document
    got = {m[1]: m[2] for m in re.finditer(r"^(\w+)\s+codec=dotvbyte\s.*recall@10=([\d.]+)",
                                            out, re.M)}
    assert list(got) == list(ref_api.available_engines())

    col = ref_synthetic.generate_collection(
        ref_synthetic.lilsr_config(N_DOCS, N_QUERIES, 0), value_format="f16")
    Q = np.stack([col.query_dense(i) for i in range(col.n_queries)])
    truth = [ref_exact_top_k(col.fwd, Q[i], 10)[0] for i in range(N_QUERIES)]
    params = {"seismic": dict(cut=8, block_budget=512, n_probe=64, n_postings=2000,
                              block_size=64),
              "hnsw": dict(beam=64, iters=64, n_seeds=8, m=16, ef_construction=48),
              "flat": {}}
    for engine, recall in got.items():
        r = ref_api.Retriever.build(col.fwd, ref_api.RetrieverConfig(
            engine=engine, codec="dotvbyte", k=10, params=params[engine]))
        ids = np.asarray(r.search(Q)[0])
        want = np.mean([ref_recall_at_k(truth[i], ids[i]) for i in range(N_QUERIES)])
        assert recall == f"{want:.3f}", engine
