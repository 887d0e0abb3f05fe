"""BENCHMARK.json against the benchmark's contract, and every cell's files
found by name."""

import ast
import json
import pathlib
import re

import pytest

from portbench import cells
from portbench.cases import cell_names

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
BENCH = cells.load_benchmark()
KEYS = {
    "top": {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"},
    "config": {"name", "source", "file", "reduced", "why"},
    "workload": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


def _line(s, limit=200):
    return isinstance(s, str) and 1 <= len(s) <= limit and "\n" not in s and "\t" not in s


def test_top_level_keys_and_limits():
    assert set(BENCH) == KEYS["top"]
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    assert 1 <= len(BENCH["paths"]) <= 16 and BENCH["paths"] == ["portbench"]
    assert len(BENCH["command"]) <= 32 and all(_line(w) for w in BENCH["command"])
    assert not any(w.startswith("/") or ".." in w for w in BENCH["command"])
    assert len(json.dumps(BENCH)) <= 64 * 1024


@pytest.mark.parametrize("kind", ["config", "workload", "end_to_end", "per_layer"])
def test_entries_have_the_contract_keys_and_names(kind):
    entries = BENCH["configs" if kind == "config" else "workloads" if kind == "workload" else kind]
    names = [e["name"] for e in entries]
    assert len(names) == len(set(names))
    for e in entries:
        extra = {"workloads"} if kind in ("end_to_end", "per_layer") else set()
        assert KEYS[kind] <= set(e) <= KEYS[kind] | extra, e["name"]
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
            assert e["source"] in SOURCES
        if kind == "end_to_end":
            assert e["source"] in ("host_clock", "device_trace")
            assert 0.01 <= e["bound"] <= 0.25
        if kind == "per_layer":
            assert _line(e["layer"]) and e["moves"] in {m["name"] for m in BENCH["end_to_end"]}
        if kind in ("config", "workload"):
            assert _line(e["why"])


def test_metric_names_across_kinds_are_unique_and_setup_is_there():
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names)) and "setup_s" in names
    assert next(m for m in BENCH["end_to_end"] if m["name"] == "setup_s")["bound"] <= 0.25
    assert not any("mfu" in n for n in names)
    for m in BENCH["per_layer"]:
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"


def test_configs_point_into_paths_and_list_their_cuts():
    for c in BENCH["configs"]:
        assert c["file"].startswith("portbench/") and _line(c["source"])
        data = json.loads((cells.ROOT / c["file"]).read_text())
        assert data["name"] == c["name"]
        assert set(c["reduced"]) == set(data["reduced"]) and len(c["reduced"]) <= 16
        for key in c["reduced"]:
            assert NAME.match(key) and key in data
        assert any(w["config"] == c["name"] for w in BENCH["workloads"])


@pytest.mark.parametrize("name", cell_names())
def test_every_cell_resolves_by_name(name):
    cell = cells.resolve(name)
    assert cell.chips == 1
    assert cell.config["dim"] == 30522 and cell.config["value_format"] == "f16"
    assert cell.mix["kind"] in ("retriever", "block_scan")
    assert cell.limits and set(cell.limits) <= {"score_err", "rank_gap", "bad_ids"}
    assert cell.limits["bad_ids"] == 0
    e2e = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2 and cell.per_layer
    for m in cell.end_to_end + cell.per_layer:
        assert callable(cells.reader(m["name"]))
    w = next(w for w in BENCH["workloads"] if w["name"] == name)
    assert NAME.match(w["traffic"]) and NAME.match(w["config"])


def test_a_four_chip_cell_is_within_the_share():
    fours = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert fours <= max(1, len(BENCH["workloads"]) // 4)


def _imports(path: pathlib.Path) -> set[str]:
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            out.add(node.module.split(".")[0])
    return out


def test_no_module_of_the_benchmark_imports_jax_or_the_jax_package():
    for path in cells.HERE.rglob("*.py"):
        assert not _imports(path) & {"jax", "jaxlib", "flax", "repro"}, path


@pytest.mark.parametrize("module", ["reference", "check", "counts", "corpus"])
def test_the_yardstick_imports_nothing_of_the_program(module):
    assert "repro_torch" not in _imports(cells.HERE / f"{module}.py")


def test_forbidden_modules_are_compared_by_whole_top_level_name():
    from portbench import harness

    fake = ["repro_torch", "repro_torch.core", "jaxlib.xla", "reprox", "flax_like"]
    assert harness.forbidden_loaded(fake) == ["jaxlib"]
    assert harness.forbidden_loaded(["repro.core.layout"]) == ["repro"]
