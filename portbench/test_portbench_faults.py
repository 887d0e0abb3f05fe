"""A run whose timed path is broken underneath comes out not correct: for
each fault a cell can have (``control.FAULTS``; one chip, so no exchange
between chips to leave out)."""

import pytest
import torch

from portbench import control
from portbench.cases import TINY_MIX, cell_names, tiny_run


@pytest.mark.parametrize("fault", sorted(control.FAULTS))
@pytest.mark.parametrize("name", cell_names())
def test_a_broken_run_is_not_correct(name, fault):
    r = tiny_run(name, wrap=control.FAULTS[fault])
    assert not r["correct"], (name, fault, r["check"])
    assert r["failed"] > 0


def _last_document_off_below_the_top(prog):
    """The last document's score 1% of the query's best too high, where it
    is not among the query's top 10: neither the top-k nor a sampled
    document (one a batch, not the last) can show it."""
    def call(Q):
        out = prog(Q).clone()
        below = out[:, -1] < out.topk(10, dim=1).values[:, -1]
        out[:, -1] += torch.where(below, 0.01 * out.amax(dim=1), 0.0)
        return out
    return call


def test_every_document_of_a_scan_is_checked():
    r = tiny_run("splade-scan-b100", wrap=_last_document_off_below_the_top,
                 mix={**TINY_MIX, "check_docs": 1})
    assert not r["correct"], r["check"]
    assert 0 < r["failed"] < r["attempted"]
