"""The port's spans and counters (``repro_torch/spans.py``): the recorder
itself, the spans the serving and full-scan paths emit on the CPU, the
load and compile counters, and, on the card (``gpu``-marked, skipped
here), that a span and the device operations it launches share the
profiler's clock and that a capture counts."""

import stat
import sys
import threading

import numpy as np
import pytest
import torch

from repro_torch import spans
from repro_torch.core import layout
from repro_torch.core.forward_index import ForwardIndex
from repro_torch.kernels import block_scan, build, ops
from repro_torch.serve.api import Retriever, RetrieverConfig
from torch_cases import one_intra_op_thread  # noqa: F401  (module fixture)

DIM = 2048
P = "repro_torch."


@pytest.fixture(autouse=True)
def fresh():
    spans.reset()
    yield
    spans.reset()


@pytest.fixture(scope="module")
def fwd():
    rng = np.random.default_rng(3)
    docs = []
    for n in rng.integers(1, 80, size=60):
        docs.append((np.sort(rng.choice(DIM, size=int(n), replace=False)),
                     rng.gamma(2, .5, int(n)).astype(np.float32)))
    return ForwardIndex.from_docs(docs, DIM, value_format="f16")


def _queries(nq=4, seed=5):
    rng = np.random.default_rng(seed)
    return torch.tensor(rng.gamma(2, .5, (nq, DIM)) * (rng.random((nq, DIM)) < .03),
                        dtype=torch.float32)


def _names():
    return [s.name for s in spans.snapshot()["spans"]]


# -- the recorder ---------------------------------------------------------------------


def test_off_records_nothing_and_returns_the_shared_no_op(fwd):
    a, b = spans.span(P + "a"), spans.span(P + "b")
    assert a is b
    with a as inside:
        assert inside is a
    r = Retriever.build(fwd, RetrieverConfig(engine="flat", codec="dotvbyte", k=5), device="cpu")
    r.search(_queries())
    packed = layout.pack_blocks(fwd, codec="dotvbyte", block_size=128).to("cpu")
    ops.score_dotvbyte_batch(_queries(), packed, device="cpu")
    snap = spans.snapshot()
    assert snap["spans"] == [] and snap["dropped"] == 0


def test_recording_restores_the_state_before_it():
    with spans.recording():
        with spans.recording():
            assert spans.span(P + "a") is not spans.span(P + "a")
        assert spans.span(P + "a") is not spans.span(P + "a")
    assert spans.span(P + "a") is spans.span(P + "a")
    with pytest.raises(KeyError), spans.recording():
        raise KeyError("a failure inside")
    assert spans.span(P + "a") is spans.span(P + "a")


def test_names_nesting_parents_and_call_ids():
    with spans.recording():
        for _ in range(2):
            with spans.span(P + "outer"):
                with spans.span(P + "a"):
                    with spans.span(P + "a.inner"):
                        pass
                with spans.span(P + "b"):
                    pass
    got = spans.snapshot()["spans"]
    assert [s.name for s in got] == [P + n for n in ("outer", "a", "a.inner", "b")] * 2
    assert [s.parent for s in got] == [-1, 0, 1, 0, -1, 4, 5, 4]
    calls = [s.call for s in got]
    assert len(set(calls[:4])) == 1 and len(set(calls[4:])) == 1 and calls[0] != calls[4]
    assert all(s.start_ns <= s.end_ns for s in got)
    for s in got:
        if s.parent >= 0:
            p = got[s.parent]
            assert p.start_ns <= s.start_ns <= s.end_ns <= p.end_ns


def test_self_time_is_the_span_less_its_children():
    with spans.recording():
        with spans.span(P + "outer"):
            with spans.span(P + "a"):
                with spans.span(P + "a.inner"):
                    sum(range(1000))
            with spans.span(P + "b"):
                sum(range(1000))
    got = spans.snapshot()["spans"]
    us = [(s.end_ns - s.start_ns) / 1e3 for s in got]
    summ = spans.summary()
    assert summ[P + "outer"]["count"] == 1
    assert summ[P + "outer"]["total_us"] == pytest.approx(us[0])
    assert summ[P + "outer"]["self_us"] == pytest.approx(us[0] - us[1] - us[3])
    assert summ[P + "a"]["self_us"] == pytest.approx(us[1] - us[2])
    assert summ[P + "a.inner"]["self_us"] == pytest.approx(us[2])
    assert all(0 <= d["self_us"] <= d["total_us"] for d in summ.values())


def test_the_store_is_bounded_and_counts_what_it_drops(monkeypatch):
    monkeypatch.setattr(spans, "MAX_SPANS", 3)
    with spans.recording():
        for _ in range(5):
            with spans.span(P + "x"):
                pass
    snap = spans.snapshot()
    assert len(snap["spans"]) == 3 and snap["dropped"] == 2
    assert [s.call for s in snap["spans"]] == sorted({s.call for s in snap["spans"]})
    spans.reset()
    assert spans.snapshot()["dropped"] == 0


def test_open_spans_are_left_out_of_a_snapshot():
    with spans.recording():
        with spans.span(P + "open"):
            with spans.span(P + "closed"):
                pass
            mid = spans.snapshot()["spans"]
    assert [(s.name, s.parent) for s in mid] == [(P + "closed", -1)]


def test_threads_keep_their_own_nesting_and_no_update_is_lost():
    """More threads than cores, a short switch interval: every span and
    every count arrives, and a span's parent is in its own thread."""
    n_threads, per = 16, 200
    before = spans.counters.get("test.hits", 0)
    interval = sys.getswitchinterval()
    errors = []

    def work(i):
        try:
            for _ in range(per):
                with spans.span(f"{P}t{i}"):
                    with spans.span(f"{P}t{i}.inner"):
                        spans.count("test.hits")
        except Exception as e:  # reported below, with the thread's name
            errors.append(e)

    sys.setswitchinterval(1e-6)
    try:
        with spans.recording():
            threads = [threading.Thread(target=work, args=(i,)) for i in range(n_threads)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads) and not errors
    assert spans.counters["test.hits"] - before == n_threads * per
    got = spans.snapshot()["spans"]
    assert len(got) == 2 * n_threads * per
    for s in got:
        if s.name.endswith(".inner"):
            assert got[s.parent].name == s.name[: -len(".inner")]
            assert got[s.parent].call == s.call
    assert len({s.call for s in got}) == n_threads * per


def test_a_recorded_span_is_a_profiler_range_while_a_profile_runs():
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as off:
        with spans.span(P + "quiet"):
            torch.zeros(4)
    with spans.recording(), profile(activities=[ProfilerActivity.CPU]) as on:
        with spans.span(P + "seen"):
            torch.zeros(4)
    assert not [e for e in off.events() if e.name.startswith(P)]
    seen = [e for e in on.events() if e.name == P + "seen"]
    assert len(seen) == 1
    zeros = [e for e in on.events() if e.name == "aten::zeros"]
    assert zeros and seen[0].time_range.start <= zeros[0].time_range.start
    assert zeros[0].time_range.end <= seen[0].time_range.end


# -- the paths ------------------------------------------------------------------------


def test_build_and_flat_search_spans_in_order(fwd):
    cfg = RetrieverConfig(engine="flat", codec="dotvbyte", k=5)
    with spans.recording():
        r = Retriever.build(fwd, cfg, device="cpu")
    assert _names() == [P + "build", P + "build.pack", P + "build.place"]
    spans.reset()
    with spans.recording():
        r.search(_queries(3))
        r.search(_queries(3))
    got = spans.snapshot()["spans"]
    assert [s.name for s in got] == [P + "search", P + "plan.eager"] * 2
    assert [s.parent for s in got] == [-1, 0, -1, 2]
    assert got[0].call != got[2].call


def test_scan_spans_in_order(fwd):
    with spans.recording():
        packed = layout.pack_blocks(fwd, codec="dotvbyte", block_size=128)
        placed = packed.to("cpu")
    assert _names() == [P + "build.pack", P + "build.place"]
    spans.reset()
    with spans.recording():
        want = ops.score_dotvbyte_batch(_queries(), placed, device="cpu")
    got = spans.snapshot()["spans"]
    assert [s.name for s in got] == [P + "scan", P + "scan.prepare", P + "scan.check"]
    assert [s.parent for s in got] == [-1, 0, 0]
    assert len({s.call for s in got}) == 1
    torch.testing.assert_close(ops.score_dotvbyte_batch(_queries(), placed, device="cpu"), want,
                               rtol=0, atol=0)


def test_a_numpy_pack_is_placed_inside_the_scan(fwd):
    packed = layout.pack_blocks(fwd, codec="streamvbyte", block_size=128)
    with spans.recording():
        ops.score_streamvbyte(_queries(1)[0], packed, device="cpu")
    got = spans.snapshot()["spans"]
    assert [s.name for s in got] == [P + "scan", P + "scan.prepare", P + "build.place",
                                     P + "scan.check"]
    assert [s.parent for s in got] == [-1, 0, 1, 0]


def test_snapshot_reads_the_kernels_launch_counters_where_they_live(monkeypatch):
    monkeypatch.setattr(block_scan, "launches", 7)
    monkeypatch.setitem(block_scan.stage_launches, "query_lanes", 5)
    snap = spans.snapshot()["launches"]
    assert snap["block_scan"]["launches"] == 7
    assert snap["block_scan"]["stages"]["query_lanes"] == 5
    assert set(snap["rows_dot"]) >= {"launches", "variants", "stages", "captured_stages"}


# -- the counters ---------------------------------------------------------------------


def test_a_cpu_plan_captures_nothing(fwd):
    before = spans.counters.get("plan.captures", 0)
    r = Retriever.build(fwd, RetrieverConfig(engine="flat", codec="dotvbyte", k=5), device="cpu")
    plan = r.plans.get(4)
    assert plan.warm(DIM) is False
    plan(_queries(4))
    assert spans.counters.get("plan.captures", 0) == before


def _fake_nvcc(tmp_path):
    """A compiler stand-in that writes an empty file where ``-o`` points."""
    nvcc = tmp_path / "nvcc"
    nvcc.write_text("#!/bin/sh\nwhile [ $# -gt 0 ]; do\n  if [ \"$1\" = -o ]; then "
                    ": > \"$2\"; fi\n  shift\ndone\n")
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    return str(nvcc)


def test_compiles_and_loads_count_once_each(tmp_path, monkeypatch):
    nvcc = _fake_nvcc(tmp_path)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "libs")
    monkeypatch.setattr(build, "nvcc_path", lambda: nvcc)
    monkeypatch.setattr(build, "_LIBS", {})
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(build.ctypes, "CDLL", lambda path: ("lib", path))
    c0 = dict(spans.counters)
    with spans.recording():
        first = build.load("rows_dot")
        again = build.load("rows_dot")
    assert first is again
    assert spans.counters.get("kernels.compiles", 0) == c0.get("kernels.compiles", 0) + 1
    assert spans.counters.get("kernels.loads", 0) == c0.get("kernels.loads", 0) + 1
    assert _names() == [P + "kernels.load"]
    monkeypatch.setattr(build, "_LIBS", {})
    build.load("rows_dot")  # built already: loaded again, not compiled
    assert spans.counters["kernels.compiles"] == c0.get("kernels.compiles", 0) + 1
    assert spans.counters["kernels.loads"] == c0.get("kernels.loads", 0) + 2


# -- on the card ----------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    return torch.device("cuda")


def _profiled(fn):
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with spans.recording(), profile(activities=[ProfilerActivity.CPU,
                                                ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return prof.events()


def _one(events, name):
    found = [e for e in events if e.name == name and e.device_type == torch.autograd.DeviceType.CPU]
    assert len(found) == 1, (name, [e.name for e in events][:80])
    return found[0]


def _device_ops(events):
    """Device operations, without the spans' device-side marks."""
    return [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA
            and not e.name.startswith(P)]


@pytest.mark.gpu
def test_scan_launch_opens_before_its_kernel_on_one_clock(cuda, fwd):
    packed = layout.pack_blocks(fwd, codec="dotvbyte", block_size=128).to(cuda)
    Q = _queries(16).to(cuda)
    ops.score_dotvbyte_batch(Q, packed)  # the library loaded, outside the profile
    events = _profiled(lambda: ops.score_dotvbyte_batch(Q, packed))
    launch = _one(events, P + "scan.launch")
    alloc = _one(events, P + "scan.alloc")
    kernels = [e for e in _device_ops(events) if "block_scan" in e.name]
    assert len(kernels) == 1
    assert alloc.time_range.end <= launch.time_range.start
    assert launch.time_range.start <= kernels[0].time_range.start
    runtime = [e for e in events if e.id == kernels[0].id and e.device_type
               == torch.autograd.DeviceType.CPU and e.name.startswith("cuda")]
    assert runtime and launch.time_range.start <= runtime[0].time_range.start \
        <= launch.time_range.end


@pytest.mark.gpu
def test_plan_replay_opens_before_the_replay_on_one_clock(cuda, fwd):
    cfg = RetrieverConfig(engine="flat", codec="dotvbyte", backend="cuda", k=5)
    r = Retriever.build(fwd, cfg, device=cuda)
    Q = _queries(8).to(cuda)
    before = spans.counters.get("plan.captures", 0)
    r.search(Q)  # captures bucket 8
    assert spans.counters["plan.captures"] == before + 1
    events = _profiled(lambda: r.search(Q))
    assert spans.counters["plan.captures"] == before + 1
    replay = _one(events, P + "plan.replay")
    copy_out = _one(events, P + "plan.copy_out")
    launch = [e for e in events if e.name == "cudaGraphLaunch"
              and replay.time_range.start <= e.time_range.start <= replay.time_range.end]
    assert len(launch) == 1
    graph_ops = [e for e in _device_ops(events) if e.id == launch[0].id]
    assert any("rows_dot" in e.name for e in graph_ops), [e.name for e in graph_ops]
    first = min(e.time_range.start for e in graph_ops)
    assert replay.time_range.start <= first
    assert replay.time_range.end <= copy_out.time_range.start
