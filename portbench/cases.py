"""Shared helpers of the benchmark's tests: a cell shrunk to a CPU size."""

from __future__ import annotations

from . import cells, harness

#: a cell at a size a CPU test holds: the real widths, few documents
TINY_CONFIG = {"n_docs": 400}
TINY_MIX = {"pool": 16, "batch": 8, "check_every": 2, "warm_batches": 2, "trace_batches": 1}
SEED = 2**31 + 11


def cell_names() -> list[str]:
    return [w["name"] for w in cells.load_benchmark()["workloads"]]


def tiny_run(name: str, seed: int = SEED, traced: bool = False, mix: dict = TINY_MIX,
             **kw) -> dict:
    """One run of cell ``name`` on the CPU at the tiny size."""
    return harness.run(cells.resolve(name), seed, 0.2, traced, "cpu",
                       config=TINY_CONFIG, mix=mix, **kw)
