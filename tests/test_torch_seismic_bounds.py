"""C3, Seismic's phase-1 bounds, against the reference at a budget that
is not exhaustive (``TIGHT_SEISMIC``: 6 of up to 64 candidate blocks
probed a query, 64 queries).

The reference sums a block's summary bound in XLA's order, which no
torch op reproduces, so the port's contract is a tie rule
(``SeismicEngine.probe``): every bound lies within twice its f32
rounding bound (``torch_seismic_cases.bound_tolerance``) of the
reference's, and a block probed by one side only is a near tie at the
``n_probe`` cut (``probe_disagreements``)."""

import numpy as np
import pytest
import torch
from torch_seismic_cases import bound_tolerance, probe_disagreements, reference_phase1

from repro.serve.api import open_retriever as ref_open
from repro_torch.data.synthetic import SyntheticConfig, generate_collection
from repro_torch.serve.api import Retriever, RetrieverConfig

TIGHT_SEISMIC = dict(cut=4, block_budget=64, n_probe=6, n_postings=60, block_size=8)


@pytest.fixture(scope="module", params=[(2048, 400), (30522, 600)], ids=["dim2048", "dim30522"])
def sides(request, tmp_path_factory):
    dim, n_docs = request.param
    col = generate_collection(SyntheticConfig(name="splade", dim=dim, n_docs=n_docs,
                                              n_queries=64, seed=1), value_format="f16")
    Q = np.stack([col.query_dense(i) for i in range(col.n_queries)])
    cfg = RetrieverConfig(engine="seismic", codec="dotvbyte", backend="torch", k=5,
                          params=TIGHT_SEISMIC)
    port = Retriever.build(col.fwd, cfg, device="cpu")
    path = tmp_path_factory.mktemp("tight")
    port.save(path)
    ref = ref_open(path)
    est_r, cand_r, probe_r = reference_phase1(ref.arrays, Q, TIGHT_SEISMIC)
    Qt = torch.from_numpy(Q)
    est_p, cand_p, probe_p = (t.numpy() for t in port.impl.probe(port.cfg, port.arrays, Qt))
    tol = bound_tolerance(port.arrays, Qt, torch.from_numpy(cand_p)).numpy()
    return dict(port=port, ref=ref, Q=Q, est_p=est_p, est_r=est_r, cand_p=cand_p,
                cand_r=cand_r, probe_p=probe_p, probe_r=probe_r, tol=tol)


def test_budget_is_not_exhaustive(sides):
    live = (sides["cand_p"] >= 0).sum(axis=1)
    assert (live > TIGHT_SEISMIC["n_probe"]).mean() > 0.6  # the cut binds for most queries


def test_candidates_and_bounds_within_the_rule(sides):
    assert np.array_equal(sides["cand_p"], sides["cand_r"])
    live = sides["cand_p"] >= 0
    gap = np.abs(sides["est_p"][live] - sides["est_r"][live])
    assert (gap <= 2 * sides["tol"][live]).all()
    assert np.array_equal(sides["est_p"][~live], sides["est_r"][~live])  # -inf both


def test_every_probe_disagreement_is_a_near_tie(sides):
    dis = probe_disagreements(sides["est_p"], sides["probe_p"], sides["est_r"],
                              sides["probe_r"], sides["cand_p"], sides["tol"])
    assert all(d["max_ratio"] <= 1.0 for d in dis), dis


def test_top_k_ids_follow_the_probe(sides):
    """Where both sides probed the same blocks, the final ids are equal."""
    ids_p = sides["port"].search(sides["Q"])[0].numpy()
    ids_r = np.asarray(sides["ref"].search(sides["Q"])[0])
    same_probe = [set(a) == set(b) for a, b in zip(sides["probe_p"].tolist(),
                                                      sides["probe_r"].tolist())]
    for i, same in enumerate(same_probe):
        if same:
            assert np.array_equal(ids_p[i], ids_r[i]), i
