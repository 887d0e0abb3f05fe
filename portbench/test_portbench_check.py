"""The check that decides ``correct``: a sound run of each cell on the CPU
passes, and the control (the reference in bfloat16 in the program's
place) does not."""

import pytest

from portbench import control
from portbench.cases import cell_names, tiny_run


@pytest.mark.parametrize("name", cell_names())
def test_a_sound_run_is_correct(name):
    r = tiny_run(name)
    assert r["correct"], r["check"]
    assert r["failed"] == 0 and r["attempted"] > 0
    assert list(r)[-1] == "check"
    for n in r["check"].values():
        assert n["value"] <= n["limit"]
    assert {"qps", "p95_batch_ms", "setup_s"} <= set(r["metrics"])


@pytest.mark.parametrize("name", cell_names())
def test_the_control_is_not_correct(name):
    from portbench import cells

    r = tiny_run(name, driver=control.ControlDriver(cells.resolve(name).mix, "cpu"))
    assert not r["correct"]
    assert r["check"]["score_err"]["value"] > 10 * r["check"]["score_err"]["limit"]


def test_a_traced_run_reads_its_per_layer_metrics():
    r = tiny_run("splade-flat-b128", traced=True)
    assert r["correct"]
    assert {"index_build_s", "bits_per_comp", "host_dispatch_us"} <= set(r["metrics"])
    assert r["device"]["window_s"] > 0 and "breakdown" in r
