"""The port's dry run (``python -m repro_torch.launch.dryrun``) on the
CPU: the command line over both production meshes, its records against
the reference's per-device shapes (subprocesses with 512 forced jax
devices, ``tests/torch_configs_cases.py``: the retrieval cells, and the
LM cells with their outputs from ``jax.eval_shape``), its ``OK`` lines
(no ``SKIP``: every id is ported), and no jax in the process that ran
it; the temporaries every record counts (C6: each cell's step traced on
fake tensors in a fake process group, ``launch/dryrun.py``), a
hand-counted toy step's, and the LM traces' cut depth against a full
one. The GNN and RecSys records are held to the reference in
``tests/test_torch_family_cells.py``."""

import json
import subprocess
import sys

import numpy as np
import pytest
from torch_configs_cases import LM_IDS, ROOT, device_bytes, reference_cells, reference_lm_cells

from repro_torch.configs import ARCH_IDS, PORTED_IDS, RETRIEVAL_IDS
from repro_torch.launch.hlo_stats import HW, roofline_terms

#: runs the dry run's ``main`` and fails if jax or the reference was imported
_RUN = (
    "import runpy, sys\n"
    "sys.argv = ['dryrun'] + sys.argv[1:]\n"
    "try:\n"
    "    runpy.run_module('repro_torch.launch.dryrun', run_name='__main__')\n"
    "finally:\n"
    "    bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'repro'))\n"
    "    assert not bad, bad\n"
)


def dryrun(*args, cwd):
    return subprocess.run([sys.executable, "-c", _RUN, *args], cwd=cwd, capture_output=True,
                          text=True, timeout=600,
                          env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"})


@pytest.fixture(scope="module")
def reference():
    return reference_cells()


@pytest.fixture(scope="module")
def full_run(tmp_path_factory):
    out = tmp_path_factory.mktemp("dryrun")
    res = dryrun("--out", str(out / "records"), cwd=out)
    return res, out / "records"


def test_cli_covers_every_ported_cell_and_names_the_rest(full_run):
    """Every id of the registry is ported: an ``OK`` line for each of its
    cells on both meshes, no ``SKIP`` and no ``FAIL``."""
    res, _ = full_run
    assert res.returncode == 0, res.stderr[-3000:]
    lines = res.stdout.splitlines()
    assert PORTED_IDS == ARCH_IDS + RETRIEVAL_IDS
    assert not [ln for ln in lines if ln.startswith(("SKIP ", "FAIL "))]
    oks = [ln for ln in lines if ln.startswith("OK  ")]
    assert len(oks) == 2 * (len(RETRIEVAL_IDS) * 3 + len(ARCH_IDS) * 4) == 92
    assert all("GiB of 80 GB (H100)" in ln and "dominant=" in ln for ln in oks)
    assert lines[-1] == "dry-run complete: 92 ok, 0 failed"


@pytest.mark.parametrize("mesh_tag", ["pod256", "pod512x2"])
@pytest.mark.parametrize("arch_id", RETRIEVAL_IDS)
def test_records_equal_the_parity_numbers(full_run, reference, arch_id, mesh_tag):
    _, records = full_run
    for shape in ("scan_100q", "serve_4096q", "graph_4096q"):
        rec = json.loads((records / mesh_tag / f"{arch_id}__{shape}.json").read_text())
        want = reference[f"{arch_id}|{mesh_tag}|{shape}"]
        assert (rec["arch"], rec["shape"], rec["kind"], rec["mesh"], rec["ok"]) == (
            arch_id, shape, "serve", mesh_tag, True)
        assert rec["n_chips"] == want["n_chips"]
        mem = rec["memory"]
        assert mem["argument_bytes"] == device_bytes(want["inputs"])
        assert mem["output_bytes"] == device_bytes(want["outputs"])
        assert mem["peak_device_bytes"] == (mem["argument_bytes"] + mem["output_bytes"]
                                            + mem["temp_bytes"] - mem["alias_bytes"])
        assert mem["temp_bytes"] > 0 and mem["alias_bytes"] == 0
        for k in ("lower_s", "compile_s"):
            assert rec[k] is None
        cost = rec["cost"]
        assert cost["device_flops"] == want["model_flops"] / want["n_chips"]
        assert cost["device_bytes"] == mem["argument_bytes"] + mem["output_bytes"]
        assert cost["xla_cost_analysis_flops_unscaled"] is None
        assert cost["xla_cost_analysis_bytes_unscaled"] is None
        coll = rec["collectives"]
        if shape == "scan_100q":
            assert coll["by_op"] == {"reduce-scatter": 4.0 * 100 * 8_842_240 / want["n_chips"]}
        else:  # [nq / |data|, 10] ids and scores from each of the 16 index shards
            nq_local = 4096 // (want["n_chips"] // 16)
            assert coll["by_op"] == {"all-gather": float(16 * nq_local * 10 * 8)}
        assert coll["total_bytes_per_device"] == sum(coll["by_op"].values())
        assert rec["roofline"] == roofline_terms(
            global_flops=cost["device_flops"] * rec["n_chips"],
            device_flops=cost["device_flops"], device_bytes=cost["device_bytes"],
            collective_bytes=coll["total_bytes_per_device"], n_chips=rec["n_chips"],
            model_flops=want["model_flops"], hw=HW())


@pytest.mark.parametrize("opt", [1, 2, 3])
def test_one_cell_at_an_opt_level(tmp_path, reference, opt):
    name = f"msmarco-lilsr-opt{opt}"
    res = dryrun("--arch", name, "--shape", "scan_100q", "--mesh", "multi", "--out",
                 str(tmp_path), cwd=tmp_path)
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.splitlines()[-1] == "dry-run complete: 1 ok, 0 failed"
    assert [p.name for p in tmp_path.rglob("*.json")] == [f"{name}__scan_100q.json"]
    rec = json.loads((tmp_path / "pod512x2" / f"{name}__scan_100q.json").read_text())
    want = reference[f"{name}|pod512x2|scan_100q"]
    assert rec["memory"]["argument_bytes"] == device_bytes(want["inputs"])
    assert rec["collectives"] == {"by_op": {}, "total_bytes_per_device": 0.0}
    assert rec["meta"]["opt"] == opt


def test_unported_and_unknown_ids_fail(tmp_path):
    """gat-cora (ported with the GNN family) sizes its four cells; an
    unknown id fails."""
    res = dryrun("--arch", "gat-cora", "--mesh", "single", "--out", str(tmp_path), cwd=tmp_path)
    assert res.returncode == 0, res.stderr[-3000:]
    oks = [ln for ln in res.stdout.splitlines() if ln.startswith("OK  [pod256] gat-cora × ")]
    assert len(oks) == 4 and "FAIL" not in res.stdout
    assert res.stdout.splitlines()[-1] == "dry-run complete: 4 ok, 0 failed"
    res = dryrun("--arch", "nope", "--out", str(tmp_path), cwd=tmp_path)
    assert res.returncode != 0 and "unknown arch 'nope'" in res.stderr


def test_per_device_bytes_fit_the_card(full_run):
    """Every production cell fits one H100's 80 GB per device, its
    temporaries counted (the dry run's point: the placement works at the
    real corpus)."""
    _, records = full_run
    peaks = [json.loads(p.read_text())["memory"]["peak_device_bytes"]
             for p in records.rglob("*.json")]
    assert len(peaks) == 92 and max(peaks) < 80e9
    assert np.all(np.asarray(peaks) > 0)


def test_every_record_counts_its_temporaries(full_run):
    """All 92 records carry ``temp_bytes`` > 0 and ``alias_bytes`` ≥ 0 from
    the traced step, and the peak is arguments + outputs + temp − alias
    (the reference's formula); the XLA-only keys stay null."""
    _, records = full_run
    recs = [json.loads(p.read_text()) for p in records.rglob("*.json")]
    assert len(recs) == 92
    for rec in recs:
        mem, tag = rec["memory"], (rec["arch"], rec["shape"], rec["mesh"])
        assert isinstance(mem["temp_bytes"], int) and mem["temp_bytes"] > 0, tag
        assert isinstance(mem["alias_bytes"], int) and 0 <= mem["alias_bytes"], tag
        assert mem["alias_bytes"] <= min(mem["argument_bytes"], mem["output_bytes"]), tag
        assert mem["peak_device_bytes"] == (mem["argument_bytes"] + mem["output_bytes"]
                                            + mem["temp_bytes"] - mem["alias_bytes"]), tag
        assert rec["lower_s"] is None and rec["compile_s"] is None
        assert rec["cost"]["xla_cost_analysis_flops_unscaled"] is None


def test_step_memory_counts_a_hand_counted_step():
    """``step_memory`` on a toy step whose buffers are counted by hand: a
    [256, 64] f32 argument (64 KiB); ``y = 2x`` and ``z = y + 1`` are
    alive together (128 KiB above the argument), ``y`` is freed, ``z``
    returned (64 KiB out, 64 KiB temporary); an in-place step returns its
    argument (64 KiB aliased, nothing new). Run as the dry run runs it:
    fake tensors in a fake process group."""
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.launch.dryrun import fake_mesh, step_memory
    from repro_torch.launch.mesh import MeshShape

    def step(x):
        y = x * 2
        z = y + 1
        del y
        return z

    def in_place(x):
        return x.add_(1)

    with fake_mesh(MeshShape((2, 2), ("data", "model"))), FakeTensorMode():
        x = torch.empty(256, 64)
        kib = 1024
        assert step_memory(step, x) == {"peak_new": 128 * kib, "arg_bytes": 64 * kib,
                                        "alias_bytes": 0, "out_bytes": 64 * kib}
        assert step_memory(in_place, x) == {"peak_new": 0, "arg_bytes": 64 * kib,
                                            "alias_bytes": 64 * kib, "out_bytes": 64 * kib}


@pytest.mark.parametrize("arch_id,shape", [("olmoe-1b-7b", "train_4k"),
                                           ("deepseek-coder-33b", "prefill_32k"),
                                           ("kimi-k2-1t-a32b", "decode_32k")])
def test_lm_trace_depth_cut_equals_a_full_trace(arch_id, shape):
    """An LM cell's traced peak above its arguments, extended linearly from
    ``LM_TRACE_DEPTHS`` to five layers, equals the five-layer trace (MoE
    routing and capacity, uneven heads with gathered weights, decode with
    FSDP), within a few bytes a layer (an MoE layer's scalars)."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import production_mesh_shape

    mesh = production_mesh_shape()
    arch = get_arch(arch_id)
    five = dataclasses.replace(arch, cfg=dataclasses.replace(arch.cfg, n_layers=5),
                               decode_fsdp=not arch.tp_fits(mesh))
    got = dryrun.trace_memory(five, shape, mesh)
    cut = dataclasses.replace(five, microbatches=dryrun.LM_TRACE_MICROBATCHES)
    B = None
    if shape == "train_4k":  # the same microbatch rows as the cut's
        B = 256 * dryrun.LM_TRACE_MICROBATCHES // arch.microbatches
    want = dryrun._traced(cut, shape, mesh, weights="placed", global_batch=B)
    assert abs(got["peak_new"] - want["peak_new"]) <= 64, (got, want)
    assert got["alias_bytes"] == want["alias_bytes"]


@pytest.fixture(scope="module")
def reference_lm():
    return reference_lm_cells()


@pytest.mark.parametrize("mesh_tag", ["pod256", "pod512x2"])
@pytest.mark.parametrize("arch_id", LM_IDS)
def test_lm_records_equal_the_reference_per_device_bytes(full_run, reference_lm, arch_id,
                                                         mesh_tag):
    """Every LM record's per-device argument and output bytes equal the
    reference cell's (its inputs under ``in_shardings``, its outputs from
    ``jax.eval_shape`` under ``out_shardings``), with the reference's
    model flops, meta and the counts' sums."""
    _, records = full_run
    for shape in ("train_4k", "prefill_32k", "decode_32k", "long_500k"):
        rec = json.loads((records / mesh_tag / f"{arch_id}__{shape}.json").read_text())
        want = reference_lm[f"{arch_id}|{mesh_tag}|{shape}"]
        assert (rec["arch"], rec["shape"], rec["kind"], rec["mesh"], rec["ok"]) == (
            arch_id, shape, want["kind"], mesh_tag, True)
        assert rec["n_chips"] == want["n_chips"]
        mem = rec["memory"]
        assert mem["argument_bytes"] == device_bytes(want["inputs"]), shape
        assert mem["output_bytes"] == device_bytes(want["outputs"]), shape
        assert mem["peak_device_bytes"] == (mem["argument_bytes"] + mem["output_bytes"]
                                            + mem["temp_bytes"] - mem["alias_bytes"])
        # decode writes its cache in place: the cache is the aliased output
        if want["kind"] == "decode":
            assert mem["alias_bytes"] == rec["meta"]["kv_bytes"] // rec["n_chips"], shape
        else:
            assert mem["alias_bytes"] == 0, shape
        cost = rec["cost"]
        assert cost["device_flops"] == want["model_flops"] / want["n_chips"]
        assert cost["device_bytes"] == mem["argument_bytes"] + mem["output_bytes"]
        for k, v in want["meta"].items():
            assert rec["meta"][k] == v, (shape, k)
        coll = rec["collectives"]
        assert coll["total_bytes_per_device"] == sum(coll["by_op"].values()) > 0
        assert set(coll["by_op"]) <= {"all-gather", "all-reduce", "reduce-scatter"}
        assert rec["roofline"] == roofline_terms(
            global_flops=cost["device_flops"] * rec["n_chips"],
            device_flops=cost["device_flops"], device_bytes=cost["device_bytes"],
            collective_bytes=coll["total_bytes_per_device"], n_chips=rec["n_chips"],
            model_flops=want["model_flops"], hw=HW())
