"""The program's spans in a traced run (``portbench/program.py``): the
profile reader on made-up profiles, each reading where its inputs are
absent, and the recording driver through a tiny run of each cell on the
CPU."""

import types

import pytest
import torch

from portbench import cells, program, trace
from portbench.cases import SEED, TINY_CONFIG, TINY_MIX, cell_names

P = program.PREFIX


def _event(name, start, end, cuda=False, id=0):
    kind = torch.autograd.DeviceType.CUDA if cuda else torch.autograd.DeviceType.CPU
    return types.SimpleNamespace(name=name, device_type=kind, id=id,
                                 time_range=types.SimpleNamespace(start=start, end=end))


def _profile(*events):
    return types.SimpleNamespace(events=lambda: [_event(trace.RANGE, 0, 1000),
                                                 _event(trace.RANGE, 0, 1000, True), *events])


def test_a_gap_inside_a_span_is_dispatch_idle_and_one_outside_is_not():
    p = program.read_profile(_profile(
        _event(P + "scan", 100, 300),
        _event(P + "scan.check", 120, 180),
        _event(P + "scan", 100, 300, cuda=True),  # the span's device-side mark
        _event("block_scan_kernel", 300, 900, cuda=True, id=7),
    ))
    # idle: [0, 100) outside, [100, 120) scan, [120, 180) scan.check,
    # [180, 300) scan, [900, 1000) outside
    assert p["window_s"] == pytest.approx(1000e-6) and p["busy_s"] == pytest.approx(600e-6)
    assert p["dispatch_idle_s"] == pytest.approx(200e-6)
    assert p["idle_by_stage"][P + "scan"] == pytest.approx(140e-6)
    assert p["idle_by_stage"][P + "scan.check"] == pytest.approx(60e-6)
    assert p["idle_by_stage"]["outside"] == pytest.approx(200e-6)
    assert program.dispatch_idle_pct({"program": {"profiled": p}}) == pytest.approx(20.0)
    assert p["replay_bubble_s"] == [] and p["replay_link"] is None


def test_a_bubble_between_two_replayed_operations_is_counted():
    p = program.read_profile(_profile(
        _event(P + "plan.replay", 100, 140),
        _event("cudaGraphLaunch", 105, 135, id=42),
        _event(P + "plan.copy_out", 150, 170),
        _event("cudaMemcpyAsync", 155, 160, id=43),
        _event("rows_dot_shared_kernel", 200, 400, cuda=True, id=42),
        _event("sort", 450, 600, cuda=True, id=42),  # a 50 µs bubble before it
        _event("sort_tail", 580, 650, cuda=True, id=42),  # overlapping: no bubble
        _event("Memcpy DtoD", 700, 710, cuda=True, id=43),  # after the replay: not its
    ))
    assert p["replay_link"] == "graph"
    assert p["replay_bubble_s"] == [pytest.approx(50e-6)]
    assert p["replay_gaps"] == [["rows_dot_shared_kernel -> sort", pytest.approx(50e-6)]]
    assert program.replay_bubble_us({"program": {"profiled": p}}) == pytest.approx(50.0)


def test_without_a_graph_link_the_replay_ends_at_the_copy_out():
    p = program.read_profile(_profile(
        _event(P + "plan.replay", 100, 140),
        _event("cudaGraphLaunch", 105, 135, id=42),
        _event(P + "plan.copy_out", 150, 170),
        _event("cudaMemcpyAsync", 155, 160, id=43),
        _event("rows_dot_shared_kernel", 200, 400, cuda=True, id=0),
        _event("sort", 430, 600, cuda=True, id=0),
        _event("Memcpy DtoD", 700, 710, cuda=True, id=43),
    ))
    assert p["replay_link"] == "clock"
    assert p["replay_bubble_s"] == [pytest.approx(30e-6)]


def test_a_profile_without_the_traced_range_raises():
    with pytest.raises(RuntimeError, match="no"):
        program.read_profile(types.SimpleNamespace(events=lambda: []))


@pytest.mark.parametrize("name", sorted(program.READERS))
def test_each_reading_is_none_without_its_inputs(name):
    read = program.READERS[name]
    assert read({}) is None
    assert read({"program": {}}) is None


def test_the_readings_on_a_made_up_record():
    s = lambda name, a, b, parent: {"name": P + name, "start_ns": a, "end_ns": b,  # noqa: E731
                                    "parent": parent, "call": 1}
    rec = {"program": {
        "setup": {"spans": [s("build", 0, 10**9, -1), s("build.pack", 0, 6 * 10**8, 0),
                            s("build.place", 6 * 10**8, 9 * 10**8, 0),
                            s("build.place", 7 * 10**8, 8 * 10**8, 2)]},
        "counters_window_start": {"plan.captures": 1, "kernels.loads": 2},
        "counters_window_end": {"plan.captures": 1, "kernels.loads": 3, "kernels.compiles": 9},
        "recorded": {"outer_us": [100.0, 300.0]},
    }}
    assert program.program_build_s(rec) == pytest.approx(0.9)
    assert program.window_rebuilds(rec) == 1
    assert program.program_dispatch_us(rec) == pytest.approx(200.0)


@pytest.mark.parametrize("name", cell_names())
def test_a_recorded_run_of_each_cell_on_the_cpu(name):
    r = program.run(cells.resolve(name), SEED, 0.2, "cpu", config=TINY_CONFIG, mix=TINY_MIX)
    assert r["correct"]
    assert {"qps", "p95_batch_ms", "host_dispatch_us", "setup_s"} <= set(r["metrics"])
    got = r["program"]["readings"]
    assert got["program_dispatch_us"] > 0 and got["program_build_s"] > 0
    assert got["window_rebuilds"] == 0
    assert got["replay_bubble_us"] is None  # a CPU plan replays nothing
    assert 0 <= got["dispatch_idle_pct"] <= 100
    outer = "repro_torch.search" if cells.resolve(name).mix["kind"] == "retriever" else \
        "repro_torch.scan"
    assert r["program"]["summary"][outer]["count"] == TINY_MIX["trace_batches"]
    assert r["program"]["passes_s"] > 0 and r["program"]["window_summary"] is None


def test_a_recorded_window_is_summarised():
    r = program.run(cells.resolve("splade-scan-b100"), SEED, 0.2, "cpu", config=TINY_CONFIG,
                    mix=TINY_MIX, record_window=True)
    assert r["correct"]
    assert r["program"]["window_summary"]["repro_torch.scan"]["count"] > 0
