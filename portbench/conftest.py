"""Pytest settings for the benchmark's own tests: the card marker, and
torch at one intra-op thread (the driver runs six workers on eight
cores)."""

import pytest
import torch


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA GPU (and nvcc); skipped where none is present"
    )


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)
