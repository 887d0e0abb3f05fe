"""The port's CLI in its live-mutation mode (``python -m
repro_torch.launch.serve --mutate``) on the CPU: it exits 0 and prints
``mutation parity OK`` — every burst response byte for byte equal to a
fresh oracle over the live corpus, before and after a background merge —
and runs the reference CLI's seeded operation stream: the same mix, the
same corpus after the merge, the same cache invalidations and plan
creations as ``python -m repro.launch.serve`` prints for the same
arguments (:data:`REFERENCE_LINE`; the reference CLI takes ~80 s to run
here, most of it XLA compiles, so its line is recorded, not rerun)."""

import os
import re
import subprocess
import sys

import pytest

ROOT = os.path.join(os.path.dirname(__file__), "..")
MUTATE_ARGS = ["--mutate", "--engine", "flat", "--codec", "streamvbyte", "--n-docs", "60",
              "--n-queries", "6", "--k", "5", "--mutations", "9"]
#: the seeded fields of ``python -m repro.launch.serve`` + MUTATE_ARGS (its
#: response counts and times vary from run to run, and are left out)
REFERENCE_LINE = ("flat     codec=streamvbyte   mutation parity OK (… 9 mutations "
                  "[delete=4,insert=3,update=2], 42 docs after merge, gen=1) [… "
                  "invalidations=4 recompiles=80 …]")


def _run(module, args):
    # one intra-op thread: a few dozen docs, and a parallel test run around it
    env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src"), "JAX_PLATFORMS": "cpu",
           "OMP_NUM_THREADS": "1"}
    proc = subprocess.run([sys.executable, "-m", module, *args], env=env, cwd=ROOT,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    return proc.stdout


def _fields(line):
    """The seeded parts of a result line: the operation mix, the corpus
    after the merge, the generation, cache invalidations, plan creations."""
    return (re.search(r"mutations \[([^\]]*)\]", line).group(1),
            re.search(r"(\d+) docs after merge", line).group(1),
            re.search(r"gen=(\d+)", line).group(1),
            re.search(r"invalidations=(\d+)", line).group(1),
            re.search(r"recompiles=(\d+)", line).group(1))


def test_mutate_cli_matches_the_reference_cli():
    out = _run("repro_torch.launch.serve", [*MUTATE_ARGS, "--device", "cpu"])
    line = next(ln for ln in out.splitlines() if "mutation parity OK" in ln)
    assert "backend=cuda" in line and ", CPU)" in line
    assert _fields(line) == _fields(REFERENCE_LINE)
    assert int(_fields(line)[3]) >= 4  # one invalidation per round and one for the merge


@pytest.mark.parametrize("args", [
    ["--engine", "flat", "--codec", "bitpack", "--n-shards", "2"],
    ["--engine", "flat", "--compare-codecs", "--backend", "torch"],
], ids=["flat-sharded", "flat-every-codec"])
def test_mutate_cli_other_engines(args):
    out = _run("repro_torch.launch.serve", ["--mutate", *args, "--n-docs", "40", "--n-queries",
                                            "4", "--k", "5", "--mutations", "6", "--device",
                                            "cpu"])
    lines = [ln for ln in out.splitlines() if "mutation parity OK" in ln]
    assert len(lines) == (4 if "--compare-codecs" in args else 1)
    assert all("[delete=2,insert=3,update=1]" in ln and "gen=1" in ln for ln in lines)


def test_mutate_cli_refuses_other_modes():
    env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src"), "OMP_NUM_THREADS": "1"}
    for extra in (["--pipeline"], ["--save-index", "x"], ["--load-index", "x"]):
        proc = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve", "--mutate",
                               *extra, "--device", "cpu"], env=env, cwd=ROOT,
                              capture_output=True, text=True, timeout=300)
        assert proc.returncode == 2 and "--mutate is a serving-loop mode" in proc.stderr
