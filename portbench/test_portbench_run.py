"""The command line: no result without a card or without the program, and
the trace reader on a made-up profile."""

import shutil
import subprocess
import sys
import types

import pytest
import torch

from portbench import cells, trace


def _run(cwd, *args):
    return subprocess.run([sys.executable, "-m", "portbench.run", *args], cwd=cwd,
                          capture_output=True, text=True, timeout=120)


def test_without_the_program_there_is_no_result(tmp_path):
    shutil.copy(cells.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(cells.HERE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = _run(tmp_path, "--workload", "splade-scan-b100", "--seed", "1", "--seconds", "1")
    assert p.returncode != 0 and p.stdout == ""


def test_without_a_card_there_is_no_result():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    p = _run(cells.ROOT, "--workload", "splade-scan-b100", "--seed", "1", "--seconds", "1")
    assert p.returncode != 0 and p.stdout == ""


def _event(name, start, end, cuda):
    kind = torch.autograd.DeviceType.CUDA if cuda else torch.autograd.DeviceType.CPU
    return types.SimpleNamespace(name=name, device_type=kind,
                                 time_range=types.SimpleNamespace(start=start, end=end))


def test_the_trace_reader_on_a_made_up_profile():
    events = [_event(trace.RANGE, 100, 200, False),
              _event(trace.RANGE, 100, 200, True),  # the range's device-side mark
              _event("cudaGraphLaunch", 100, 110, False),
              _event("cudaDeviceSynchronize", 150, 200, False),
              _event("rows_dot_warp_kernel", 110, 140, True),
              _event("sort", 130, 150, True),
              _event("outside", 300, 400, True)]
    prof = types.SimpleNamespace(events=lambda: events)
    t = trace.summarize(prof, 2)
    assert t["window_s"] == pytest.approx(100e-6) and t["busy_s"] == pytest.approx(40e-6)
    assert t["device_s"] == pytest.approx(50e-6)
    assert trace.kernel_seconds(t, r"rows_dot_(shared_|warp_)?kernel") == pytest.approx(30e-6)
    gaps = dict(t["breakdown"]["idle_gaps"])
    assert gaps["host: cudaGraphLaunch"] == pytest.approx(10e-6)
    assert gaps["host: cudaDeviceSynchronize"] == pytest.approx(50e-6)
