"""The mini GNN and RecSys cells of ``tests/test_torch_family_cells.py``:
their inputs (numpy and a seeded ``torch.Generator``, so a rank and the
test process make the same), one process's run, and the rank program of
the ``(2, 2)`` gloo mesh. Nothing here imports jax."""

import dataclasses
import pathlib

import numpy as np
import torch

#: the mini graph: real nodes (one row of padding makes 64), edges
GNN_NODES, GNN_EDGES = 63, 400
#: the mini RecSys cells: the train and serve batch, the candidates
REC_BATCH, REC_CANDIDATES = 16, 64


def gnn_inputs(arch, shape: str) -> tuple:
    """(params, padded graph as a dict of tensors, edge_index) of the mini
    graph at ``shape``'s feature width and classes, on the CPU."""
    from repro_torch.models import gnn

    cfg = arch._cfg(shape)
    rng = np.random.default_rng(11)
    N = GNN_NODES
    ei = np.stack([rng.integers(0, N, size=GNN_EDGES), rng.integers(0, N - 5, size=GNN_EDGES)])
    g = gnn.pad_graph(rng.normal(size=(N, cfg.d_in)).astype(np.float32), ei,
                      rng.integers(0, cfg.n_classes, size=N), rng.random(N) < 0.5,
                      edge_budget=GNN_EDGES + 16, device="cpu")
    params = gnn.gat_init(torch.Generator().manual_seed(12), cfg, device="cpu")
    return params, dict(vars(g)), ei


def rec_arch():
    """DeepFM at its smoke widths, as a ``RecsysArch``."""
    from repro_torch.configs import get_arch

    arch = get_arch("deepfm")
    return dataclasses.replace(arch, cfg=arch.smoke_cfg)


def rec_inputs(arch) -> tuple:
    """(params, train batch, candidates) of the mini DeepFM cells."""
    cfg = arch.cfg
    params = arch._fns(cfg)[0](torch.Generator().manual_seed(13), cfg, device="cpu")
    batch = arch._smoke_batch(cfg, REC_BATCH, 14, "cpu")
    cand = torch.from_numpy(np.random.default_rng(15).integers(
        0, cfg.vocab_sizes[3], size=REC_CANDIDATES).astype(np.int32))
    return params, batch, cand


def _save(tree_prefix: str, tree, out: dict) -> None:
    from repro_torch.tree import tree_leaves_with_path

    for k, v in tree_leaves_with_path(tree):
        out[tree_prefix + k] = v.detach().cpu().numpy()


def mini_cells_rank(rank: int, world: int, d: str) -> None:
    """A rank of the (2, 2) gloo mesh: GAT's ``full_graph_sm`` train step at
    ``opt`` 0 (its blocks over the data axis) and 1 (its dst-aligned edges
    over both axes), and DeepFM's ``train_batch``, ``serve_p99`` and
    ``retrieval_cand``, each fed the rank's blocks → ``<d>/rank{rank}.npz``
    (the new state and metrics, the rank's outputs)."""
    from repro_torch.configs import get_arch
    from repro_torch.dist.sharding import shard_block
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models import gnn
    from repro_torch.train.optimizer import make_optimizer

    torch.set_num_threads(1)
    mesh = make_debug_mesh((2, 2), ("data", "model"))
    out = {}
    for opt in (0, 1):
        arch = get_arch("gat-cora" + ("-opt1" if opt else ""))
        params, batch, ei = gnn_inputs(arch, "full_graph_sm")
        cell = arch.build_cell("full_graph_sm", mesh)
        if opt:
            n_rows = batch["x"].shape[0]
            esrc, edst, _ = gnn.partition_edges_by_dst(ei, n_rows, world)
            batch = {**batch, "edge_src": torch.from_numpy(esrc),
                     "edge_dst": torch.from_numpy(edst),
                     "train_mask": batch["train_mask"].float()}
        blocks = {k: shard_block(v, cell.in_shardings[1][k].spec, mesh).contiguous()
                  for k, v in batch.items()}
        oinit, _ = make_optimizer(arch.optimizer)
        state, metrics = cell.fn({"params": params, "opt": oinit(params)}, blocks)
        _save(f"gnn{opt}/state", state["params"], out)
        _save(f"gnn{opt}/metrics", metrics, out)
    arch = rec_arch()
    params, batch, cand = rec_inputs(arch)
    cell = arch.build_cell("train_batch", mesh, global_batch=REC_BATCH)
    oinit, _ = make_optimizer(arch.optimizer)
    blocks = {k: shard_block(v, cell.in_shardings[1][k].spec, mesh) for k, v in batch.items()}
    state, metrics = cell.fn({"params": params, "opt": oinit(params)}, blocks)
    _save("rec/state", state["params"], out)
    _save("rec/metrics", metrics, out)
    serve = arch.build_cell("serve_p99", mesh, global_batch=REC_BATCH)
    sparse = shard_block(batch["sparse"], serve.in_shardings[1]["sparse"].spec, mesh)
    out["rec/serve"] = serve.fn(params, {"sparse": sparse}).numpy()
    rc = arch.build_cell("retrieval_cand", mesh, global_batch=REC_CANDIDATES)
    out["rec/cand"] = rc.fn(params, batch["sparse"][:1],
                            shard_block(cand, rc.in_shardings[2].spec, mesh)).numpy()
    np.savez(pathlib.Path(d) / f"rank{rank}.npz", **out)


def one_process(arch_gnn, arch_rec) -> dict:
    """The same steps and outputs in one process on the whole arrays →
    the keys of ``mini_cells_rank``'s record (serve and candidates whole)."""
    from repro_torch.models import gnn, recsys
    from repro_torch.train.optimizer import make_optimizer
    from repro_torch.train.train_step import make_train_step

    out = {}
    params, batch, _ = gnn_inputs(arch_gnn, "full_graph_sm")
    cfg = arch_gnn._cfg("full_graph_sm")
    oinit, oupd = make_optimizer(arch_gnn.optimizer)
    step = make_train_step(lambda p, b: gnn.gat_loss(p, cfg, gnn.Graph(**b)), oupd)
    state, metrics = step({"params": params, "opt": oinit(params)}, batch)
    _save("gnn/state", state["params"], out)
    _save("gnn/metrics", metrics, out)
    params, batch, cand = rec_inputs(arch_rec)
    cfg = arch_rec.cfg
    oinit, oupd = make_optimizer(arch_rec.optimizer)
    step = make_train_step(lambda p, b: recsys.deepfm_loss(p, cfg, b), oupd)
    state, metrics = step({"params": params, "opt": oinit(params)}, batch)
    _save("rec/state", state["params"], out)
    _save("rec/metrics", metrics, out)
    with torch.no_grad():
        out["rec/serve"] = recsys.deepfm_forward(params, cfg, batch["sparse"]).numpy()
        out["rec/cand"] = recsys.deepfm_score_candidates(params, cfg, batch["sparse"][:1],
                                                         cand, 3).numpy()
    return out


#: the placed RecSys cells: DeepFM and SASRec at their smoke widths
PLACED_REC = ("deepfm", "sasrec")
PLACED_REC_STEPS = 2


def placed_rec_inputs(arch_id: str) -> tuple:
    """(arch, params, train batch, candidates) of a placed mini cell: ids
    drawn over the whole of each table, so both model ranks' rows are
    read (``_smoke_batch`` draws ids below 32)."""
    from repro_torch.configs import get_arch

    arch = get_arch(arch_id)
    arch = dataclasses.replace(arch, cfg=arch.smoke_cfg)
    cfg = arch.cfg
    params = arch._fns(cfg)[0](torch.Generator().manual_seed(21), cfg, device="cpu")
    rng = np.random.default_rng(22)
    if arch_id == "sasrec":
        n, S = cfg.n_items, cfg.seq_len
        batch = {"seq": rng.integers(0, n, (REC_BATCH, S)),
                 "pos_label": rng.integers(0, n, (REC_BATCH, S)),
                 "neg_label": rng.integers(1, n, (REC_BATCH, S, cfg.n_negatives))}
        cand = rng.integers(1, n, REC_CANDIDATES)
    else:
        batch = {"sparse": rng.integers(0, 64, (REC_BATCH, cfg.n_fields)),
                 "label": (rng.random(REC_BATCH) < 0.5).astype(np.float32)}
        cand = rng.integers(0, cfg.vocab_sizes[3], REC_CANDIDATES)
    batch = {k: torch.from_numpy(v.astype(np.int32) if v.dtype.kind == "i" else v)
             for k, v in batch.items()}
    return arch, params, batch, torch.from_numpy(cand.astype(np.int32))


def _serve_input(arch_id: str, batch: dict) -> dict:
    return {"seq": batch["seq"]} if arch_id == "sasrec" else {"sparse": batch["sparse"]}


def _user(arch_id: str, batch: dict) -> torch.Tensor:
    return batch["seq"][:1] if arch_id == "sasrec" else batch["sparse"][:1]


def placed_rec_rank(rank: int, world: int, d: str, mesh_shape=(2, 2), device="cpu") -> None:
    """A rank of a ``mesh_shape`` mesh on ``device``: DeepFM's and SASRec's
    ``train_batch`` (``PLACED_REC_STEPS`` steps), ``serve_p99`` and
    ``retrieval_cand`` cells with ``weights="placed"`` (the tables' rows
    split over ``model``), each fed the rank's blocks →
    ``<d>/rank{rank}.npz``."""
    from repro_torch.dist.sharding import shard_block
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.tree import tree_map

    torch.set_num_threads(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = make_debug_mesh(mesh_shape, ("data", "model"))
    out = {}
    for a in PLACED_REC:
        arch, params, batch, cand = placed_rec_inputs(a)
        params = tree_map(lambda t: t.to(device), params)
        batch, cand = {k: v.to(device) for k, v in batch.items()}, cand.to(device)
        cell = arch.build_cell("train_batch", mesh, weights="placed", global_batch=REC_BATCH)
        blocks = {k: shard_block(v, cell.in_shardings[1][k].spec, mesh) for k, v in batch.items()}
        state = arch.place("train_batch", mesh, params)
        for t in range(PLACED_REC_STEPS):
            state, metrics = cell.fn(state, blocks)
            _save(f"{a}/metrics{t}", metrics, out)
        _save(f"{a}/state", state, out)
        serve = arch.build_cell("serve_p99", mesh, weights="placed", global_batch=REC_BATCH)
        p = arch.place("serve_p99", mesh, params)
        inp = {k: shard_block(v, serve.in_shardings[1][k].spec, mesh)
               for k, v in _serve_input(a, batch).items()}
        out[f"{a}/serve"] = serve.fn(p, inp).cpu().numpy()
        rc = arch.build_cell("retrieval_cand", mesh, weights="placed",
                             global_batch=REC_CANDIDATES)
        out[f"{a}/cand"] = rc.fn(p, _user(a, batch),
                                 shard_block(cand, rc.in_shardings[2].spec, mesh)).cpu().numpy()
    np.savez(pathlib.Path(d) / f"rank{rank}.npz", **out)


def placed_rec_one_process() -> dict:
    """``placed_rec_rank``'s steps and outputs in one process on the whole
    arrays (serve and candidates whole)."""
    from repro_torch.configs.base import CAND_FIELD
    from repro_torch.models import recsys
    from repro_torch.train.optimizer import make_optimizer
    from repro_torch.train.train_step import make_train_step

    out = {}
    for a in PLACED_REC:
        arch, params, batch, cand = placed_rec_inputs(a)
        cfg = arch.cfg
        loss = arch._fns(cfg)[1]
        oinit, oupd = make_optimizer(arch.optimizer)
        step = make_train_step(lambda p, b: loss(p, cfg, b), oupd)
        state = {"params": params, "opt": oinit(params)}
        for t in range(PLACED_REC_STEPS):
            state, metrics = step(state, batch)
            _save(f"{a}/metrics{t}", metrics, out)
        _save(f"{a}/state", state, out)
        with torch.no_grad():
            out[f"{a}/serve"] = arch.serve_fn()(params, _serve_input(a, batch)).numpy()
            if a == "sasrec":
                out[f"{a}/cand"] = recsys.sasrec_score_candidates(params, cfg, _user(a, batch),
                                                                  cand).numpy()
            else:
                out[f"{a}/cand"] = recsys.deepfm_score_candidates(params, cfg, _user(a, batch),
                                                                  cand, CAND_FIELD).numpy()
    return out
