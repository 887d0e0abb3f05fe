"""One cell on the card, end to end, through the command line. Marked
``gpu``: it skips where no CUDA device is present, decided inside the
fixture. Run on the chip machine:

    python -m pytest -q -m gpu portbench/test_portbench_gpu.py
"""

import json
import subprocess
import sys

import pytest
import torch

from portbench import cells

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    return torch.device("cuda")


def test_one_scan_cell_runs_correct(cuda):
    p = subprocess.run([sys.executable, "-m", "portbench.run", "--workload", "lilsr-scan-b100",
                        "--seed", str(2**31 + 3), "--seconds", "2", "--trace", "0"],
                       cwd=cells.ROOT, capture_output=True, text=True, timeout=1200)
    assert p.returncode == 0, p.stderr[-2000:]
    r = json.loads(p.stdout.strip().splitlines()[-1])
    assert r["correct"] and r["device"]["platform"] == "gpu"
    assert {"qps", "p95_batch_ms", "device_mem_gib", "setup_s"} <= set(r["metrics"])
