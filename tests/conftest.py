"""Pytest config: tests run on ONE CPU device (multi-device cases spawn
subprocesses with their own XLA_FLAGS — see test_dist.py). The dry-run
(512 devices) is exercised only via python -m repro.launch.dryrun."""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))
sys.path.insert(0, os.path.dirname(__file__))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA GPU (and nvcc); skipped where none is present"
    )
