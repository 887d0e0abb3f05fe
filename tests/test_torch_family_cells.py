"""The GNN and RecSys families' cells (``GNNArch``, ``RecsysArch``) against
the reference's, on the CPU.

* All 20 cells (gat-cora and the four RecSys configs × 4 shapes), and
  gat-cora-opt1 / -opt2's, on both production ``MeshShape``s: every
  input's per-device shape and dtype, the per-device argument and output
  bytes, the model flops and ``meta`` equal the reference cell's
  (``NamedSharding.shard_shape`` of its inputs, and of its step's outputs
  from ``jax.eval_shape``, in one subprocess with 512 forced jax devices:
  ``tests/torch_configs_cases.py``); the dry run's records of the 20
  cells carry the same bytes; ``device_flops`` is ``model_flops /
  n_chips``; the collectives follow ``hlo_stats``' formulas.
* The mini cells on a ``(2, 2)`` gloo mesh (four spawned ranks,
  ``tests/torch_family_cases.py``) equal one process's run: GAT's
  ``full_graph_sm`` train step at ``opt`` 0 and 1, DeepFM's
  ``train_batch``, ``serve_p99`` and ``retrieval_cand`` (parameters within
  1e-5 of each leaf's largest entry or 1e-2 of the tree's, losses within
  rtol 1e-5, outputs within 1e-5).
* ``launch.train --arch deepfm --smoke --device cpu`` trains;
  ``--arch gat-cora --smoke`` exits with the reference's message; the
  runner replays a RecSys fault bit for bit (a step's batch is drawn at
  ``(seed, step)``).
* ``weights="placed"``: every cell builds with the whole-weight cell's
  counts (its step raises on a ``MeshShape``); DeepFM's and SASRec's
  cells with their tables' rows split over ``model`` on a (2, 2) gloo
  mesh equal one process's run.
"""

import json

import numpy as np
import pytest
import torch
from torch_cases import one_intra_op_thread  # noqa: F401 — autouse fixture
from torch_configs_cases import MESHES, _record, device_bytes, reference_lm_cells
from torch_family_cases import (PLACED_REC, PLACED_REC_STEPS, REC_BATCH, REC_CANDIDATES,
                                mini_cells_rank, one_process, placed_rec_inputs,
                                placed_rec_one_process, placed_rec_rank, rec_arch)

from repro_torch.configs import get_arch
from repro_torch.dist import sharding as shd
from repro_torch.launch.mesh import MeshShape, production_mesh_shape, spawn_ranks

FAMILY_IDS = ("gat-cora", "deepfm", "sasrec", "dcn-v2", "din")
CHECKED_IDS = FAMILY_IDS + ("gat-cora-opt1", "gat-cora-opt2")
REL, FLOOR = 1e-5, 1e-2


@pytest.fixture(scope="module")
def reference():
    return reference_lm_cells(CHECKED_IDS)


@pytest.mark.parametrize("mesh_tag", list(MESHES))
@pytest.mark.parametrize("arch_id", CHECKED_IDS)
def test_cells_equal_the_reference_per_device(reference, arch_id, mesh_tag):
    mesh = production_mesh_shape(multi_pod=MESHES[mesh_tag])
    arch = get_arch(arch_id)
    assert len(arch.shape_names) == 4
    for shape in arch.shape_names:
        cell = arch.build_cell(shape, mesh)
        want = reference[f"{arch_id}|{mesh_tag}|{shape}"]
        assert cell.kind == want["kind"], shape
        assert _record(cell.input_structs, cell.in_shardings) == want["inputs"], shape
        assert cell.meta["argument_bytes"] == device_bytes(want["inputs"]), shape
        assert cell.meta["output_bytes"] == device_bytes(want["outputs"]), shape
        assert cell.model_flops == want["model_flops"], shape
        assert cell.meta["device_flops"] == want["model_flops"] / want["n_chips"]
        for k, v in want["meta"].items():
            assert cell.meta[k] == v, (shape, k)
        coll = cell.meta["collectives_by_op"]
        assert cell.meta["collective_bytes"] == sum(coll.values())
        assert set(coll) <= {"all-gather", "all-reduce", "reduce-scatter"}


def test_dry_run_records_of_the_families(reference, tmp_path):
    """The dry run's records of the 20 cells carry the reference's bytes
    and ``model_flops / n_chips``."""
    from repro_torch.launch.dryrun import run_cell

    n = 0
    for mesh_tag, multi in MESHES.items():
        mesh = production_mesh_shape(multi_pod=multi)
        for arch_id in FAMILY_IDS:
            for shape in get_arch(arch_id).shape_names:
                rec = run_cell(arch_id, shape, mesh, save_dir=str(tmp_path), mesh_tag=mesh_tag)
                want = reference[f"{arch_id}|{mesh_tag}|{shape}"]
                assert rec["memory"]["argument_bytes"] == device_bytes(want["inputs"])
                assert rec["memory"]["output_bytes"] == device_bytes(want["outputs"])
                assert rec["cost"]["device_flops"] == want["model_flops"] / want["n_chips"]
                assert rec["memory"]["peak_device_bytes"] < 80e9
                saved = json.loads((tmp_path / mesh_tag / f"{arch_id}__{shape}.json").read_text())
                assert saved["memory"] == rec["memory"]
                n += 1
    assert n == 40


def test_collective_formulas():
    """The counts follow ``gnn_collectives`` / ``recsys_collectives``: the
    batch all-gather at GAT ``opt`` 0, the per-layer gather at ``opt`` 1
    and 2 (ogb_products: 64 then 376 wide, 100 and 64 at the min side),
    the row-split lookups and the gradient all-reduce of DeepFM."""
    mesh = production_mesh_shape()
    N = 2_449_408
    c0 = get_arch("gat-cora").build_cell("ogb_products", mesh).meta["collectives_by_op"]
    assert c0 == {"all-gather": float(N * 100 * 4 + 2 * 61_865_984 * 4 + N * 4 + N)}
    c1 = get_arch("gat-cora-opt1").build_cell("ogb_products", mesh).meta["collectives_by_op"]
    c2 = get_arch("gat-cora-opt2").build_cell("ogb_products", mesh).meta["collectives_by_op"]
    assert c1["all-gather"] == N * (64 + 376) * 4.0
    assert c2["all-gather"] == N * (64 + 64) * 4.0  # layer 2 gathers its 64-wide input
    assert c1["reduce-scatter"] == N // 256 * (64 + 376) * 4.0
    n_params = get_arch("gat-cora").build_cell("ogb_products", mesh).meta["params"]
    assert c1["all-reduce"] == 4.0 * n_params + 12
    cfg = get_arch("deepfm").cfg
    cell = get_arch("deepfm").build_cell("train_batch", mesh)
    b = 65_536 // 16
    lookups = b * cfg.n_fields * (cfg.embed_dim + 1) * 4
    grads = (cfg.total_vocab * (cfg.embed_dim + 1) / 16 + cell.meta["params"]
             - cfg.total_vocab * (cfg.embed_dim + 1)) * 4
    assert cell.meta["collectives_by_op"] == {"all-reduce": pytest.approx(lookups + grads)}
    one = get_arch("deepfm").build_cell("serve_p99", MeshShape((1, 1), ("data", "model")))
    assert one.meta["collectives_by_op"] == {}


def test_mini_cells_on_four_gloo_ranks_equal_one_process(tmp_path):
    spawn_ranks(mini_cells_rank, 4, str(tmp_path), backend="gloo",
                init_file=tmp_path / "init", timeout_s=240)
    ranks = [dict(np.load(tmp_path / f"rank{r}.npz")) for r in range(4)]
    want = one_process(get_arch("gat-cora"), rec_arch())

    def close(a, b, what):
        tree = what.split()[1].split("[")[0]  # gnn/state or rec/state
        top = max(float(np.abs(v).max()) for k, v in want.items() if k.startswith(tree))
        scale = max(float(np.abs(b).max()), FLOOR * top)
        assert float(np.abs(a - b).max()) <= REL * scale, what

    for r, got in enumerate(ranks):
        for opt in (0, 1):
            for k, v in want.items():
                if k.startswith("gnn/state"):
                    close(got[k.replace("gnn/", f"gnn{opt}/")], v, f"gnn{opt} {k} rank {r}")
            for m in ("loss", "grad_norm", "lr", "acc"):
                a, b = got[f"gnn{opt}/metrics['{m}']"], want[f"gnn/metrics['{m}']"]
                np.testing.assert_allclose(a, b, rtol=REL, err_msg=f"gnn{opt} {m}")
        for k, v in want.items():
            if k.startswith("rec/state"):
                close(got[k], v, f"rec {k} rank {r}")
        for m in ("loss", "grad_norm", "lr"):  # accuracy is the rank's own block's
            np.testing.assert_allclose(got[f"rec/metrics['{m}']"], want[f"rec/metrics['{m}']"],
                                       rtol=REL, err_msg=m)
        # serve: the rank's rows (its data block); candidates: its block over every axis
        d, b, c = r // 2, REC_BATCH // 2, REC_CANDIDATES // 4
        np.testing.assert_allclose(got["rec/serve"], want["rec/serve"][d * b:(d + 1) * b],
                                   rtol=REL, atol=1e-6)
        np.testing.assert_allclose(got["rec/cand"], want["rec/cand"][r * c:(r + 1) * c],
                                   rtol=REL, atol=1e-6)


def test_train_cli_recsys_and_gnn(capsys, tmp_path):
    from repro_torch.launch import train

    train.main(["--arch", "deepfm", "--smoke", "--steps", "6", "--checkpoint-every", "3",
                "--device", "cpu", "--checkpoint-dir", str(tmp_path)])
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith("trained deepfm 6 steps: loss ") and line.endswith("(restarts=0)")
    assert sorted(p.name for p in tmp_path.iterdir())  # the runner's checkpoints
    with pytest.raises(SystemExit, match="--smoke training loop not wired for family gnn"):
        train.main(["--arch", "gat-cora", "--smoke", "--device", "cpu"])


def test_runner_replays_a_recsys_fault_bit_for_bit(tmp_path):
    """A fault mid-run restores the last checkpoint and replays: the batch
    of a step is drawn at ``(seed, step)``, so the run ends where an
    unbroken one does."""
    from repro_torch.train.elastic import FaultInjector, Runner, RunnerConfig
    from repro_torch.train.optimizer import make_optimizer
    from repro_torch.train.train_step import init_train_state, make_train_step

    arch = get_arch("sasrec")
    cfg = arch.smoke_cfg
    init_fn, loss_fn, _ = arch._fns(cfg)
    oinit, oupd = make_optimizer(arch.optimizer)
    step = make_train_step(lambda p, b: loss_fn(p, cfg, b), oupd)
    finals = []
    for fault in ((), (4,)):
        params = init_fn(torch.Generator().manual_seed(0), cfg, device="cpu")
        runner = Runner(RunnerConfig(total_steps=6, checkpoint_dir=str(tmp_path / str(fault)),
                                     checkpoint_every=2),
                        step, lambda i: arch._smoke_batch(cfg, 8, [0, i], "cpu"),
                        init_train_state(params, oinit), device="cpu",
                        fault_injector=FaultInjector(fault))
        state, hist = runner.run()
        finals.append((state, [h["loss"] for h in hist], runner.restarts))
    (a, la, ra), (b, lb, rb) = finals
    assert (ra, rb) == (0, 1) and la[-1] == lb[-1]
    from repro_torch.tree import tree_leaves

    assert all(torch.equal(x, y) for x, y in zip(tree_leaves(a), tree_leaves(b)))


def test_placed_weights_raise_naming_a12():
    """Every cell builds with ``weights="placed"`` (the placements run,
    not raise) and sizes as the whole-weight cell; on a ``MeshShape`` its
    step raises (shapes only) rather than falling back; an unknown
    ``weights`` raises."""
    mesh = production_mesh_shape()
    for arch_id in FAMILY_IDS:
        arch = get_arch(arch_id)
        for shape in arch.shape_names:
            placed = arch.build_cell(shape, mesh, weights="placed")
            whole = arch.build_cell(shape, mesh)
            assert placed.meta == whole.meta, (arch_id, shape)
            with pytest.raises(ValueError, match="shapes only"):
                placed.fn(None, {})
    with pytest.raises(ValueError, match="weights='sharded'"):
        get_arch("din").build_cell("serve_p99", mesh, weights="sharded")
    with pytest.raises(ValueError, match="shapes only"):
        get_arch("deepfm").build_cell("serve_p99", mesh).fn(None, {})
    assert shd.recsys_batch_spec("din", mesh)["target"] == shd.P(("data",))


#: placed (2, 2) against one process (f32): losses and grad norms (rtol),
#: every parameter and optimizer leaf (within ``REL`` of the leaf's largest
#: entry, or ``FLOOR`` of the tree's, as the whole-weight test), outputs.
#: A lookup's partial rows are summed over ``model`` (one nonzero term a
#: row: exact); the rest is the data ranks' gradient mean.
PLACED_REL = 1e-5


def test_placed_deepfm_and_sasrec_on_four_gloo_ranks_equal_one_process(tmp_path):
    """DeepFM's and SASRec's ``train_batch`` (two steps), ``serve_p99`` and
    ``retrieval_cand`` cells placed on a (2, 2) gloo mesh — every
    ``embed*`` table and DeepFM's ``linear`` row-split over ``model``
    (SASRec's 12 positions too, read whole through an all-gather) — equal
    one process's run on the whole arrays."""
    spawn_ranks(placed_rec_rank, 4, str(tmp_path), backend="gloo",
                init_file=tmp_path / "init", timeout_s=240)
    ranks = [dict(np.load(tmp_path / f"rank{r}.npz")) for r in range(4)]
    want = placed_rec_one_process()
    mesh = MeshShape((2, 2), ("data", "model"))
    for a in PLACED_REC:
        arch = placed_rec_inputs(a)[0]
        pspecs = shd.recsys_param_specs(a, arch.abstract_params(), mesh)
        from repro_torch.configs import base
        from repro_torch.tree import tree_leaves_with_path

        specs = {"params": pspecs, "opt": base._state_specs(pspecs, arch.abstract_params(),
                                                            arch.optimizer)["opt"]}
        top = max(float(np.abs(v).max()) for k, v in want.items() if k.startswith(f"{a}/state"))
        for k, spec in tree_leaves_with_path(specs):
            w = want[f"{a}/state{k}"]
            split = [i for i, e in enumerate(spec) if e is not None]
            for r, got in enumerate(ranks):
                g = got[f"{a}/state{k}"]
                if split:  # the rank's row block
                    n = g.shape[0]
                    w_r = w[(r % 2) * n:(r % 2 + 1) * n]
                else:
                    w_r = w
                scale = max(float(np.abs(w_r).max()), FLOOR * top)
                assert float(np.abs(g - w_r).max()) <= PLACED_REL * scale, (a, k, r)
        for t in range(PLACED_REC_STEPS):
            for m in ("loss", "grad_norm", "lr"):
                for got in ranks:
                    np.testing.assert_allclose(got[f"{a}/metrics{t}['{m}']"],
                                               want[f"{a}/metrics{t}['{m}']"], rtol=PLACED_REL,
                                               err_msg=(a, m, t))
        d, b, c = None, REC_BATCH // 2, REC_CANDIDATES // 4
        for r, got in enumerate(ranks):
            d = r // 2
            np.testing.assert_allclose(got[f"{a}/serve"], want[f"{a}/serve"][d * b:(d + 1) * b],
                                       rtol=PLACED_REL, atol=1e-6, err_msg=a)
            np.testing.assert_allclose(got[f"{a}/cand"], want[f"{a}/cand"][..., r * c:(r + 1) * c],
                                       rtol=PLACED_REL, atol=1e-6, err_msg=a)
