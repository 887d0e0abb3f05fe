"""A cell of ``BENCHMARK.json``, resolved by name into the files that
define it: ``configs/<config>.json`` (the file the configuration entry
names), ``mixes/<traffic>.json``, ``limits/<cell>.json`` and, for every
metric the cell reports, ``metrics/<metric>.py``. Nothing here knows a
cell, a mix or a metric by name."""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import pathlib

__all__ = ["ROOT", "HERE", "Cell", "load_benchmark", "resolve", "reader"]

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    mix: dict
    limits: dict
    end_to_end: list
    per_layer: list


def load_benchmark(path: pathlib.Path | None = None) -> dict:
    with open(path or ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def _json(path: pathlib.Path) -> dict:
    with open(path) as f:
        return json.load(f)


def resolve(name: str, bench: dict | None = None) -> Cell:
    """The cell ``name`` with its configuration, mix, limits and metrics."""
    bench = bench or load_benchmark()
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; have {sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    applies = [m for m in bench["end_to_end"] if name in m.get("workloads", [name])]
    layers = [m for m in bench["per_layer"] if name in m.get("workloads", [name])]
    return Cell(name=name, chips=int(w["chips"]),
                config=_json(ROOT / configs[w["config"]]["file"]),
                mix=_json(HERE / "mixes" / f"{w['traffic']}.json"),
                limits=_json(HERE / "limits" / f"{name}.json"),
                end_to_end=applies, per_layer=layers)


def reader(metric: str):
    """The ``read(rec) -> float | None`` of ``metrics/<metric>.py``."""
    path = HERE / "metrics" / f"{metric}.py"
    module_name = "portbench_metric_" + "".join(c if c.isalnum() else "_" for c in metric)
    spec = importlib.util.spec_from_file_location(module_name, path)
    if spec is None or not path.is_file():
        raise FileNotFoundError(f"metric {metric!r} has no reader at {path}")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
