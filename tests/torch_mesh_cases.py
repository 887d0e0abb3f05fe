"""Rank programs of the port's mesh tests (``tests/test_torch_mesh.py``,
``tests/test_torch_dp.py`` and the ``gpu`` cases of
``tests/test_torch_gpu.py``), run by ``launch.mesh.spawn_ranks``: every
rank runs the same function and writes what it returned to
``<out_dir>/rank<r>.npz``, so a test can check that each rank holds the
global answer. This module imports no JAX: spawned ranks import it, and
so does the card's test file."""

import os

import numpy as np
import torch

#: the reference's quadratic problem (``tests/test_dist.py``)
QUAD_STEPS = 300
QUAD_BATCH = 64


def one_thread():
    torch.set_num_threads(1)


def save(out_dir, rank, out: dict) -> None:
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)


def load(out_dir, world: int) -> list[dict]:
    ranks = []
    for r in range(world):
        with np.load(os.path.join(out_dir, f"rank{r}.npz")) as z:
            ranks.append({k: z[k] for k in z.files})
    return ranks


def _host(pair):
    return tuple(t.cpu().numpy() for t in pair)


def serving_ranks(rank, world, out_dir, search_cases, search_Q, fwd, Q, retriever_cases,
                  victim_sets, device, backend="torch"):
    """``make_sharded_search`` on ``search_Q`` for every case of
    ``search_cases`` (name → dict(mesh, cfg, arrays, idmap, n_local,
    n_docs)), then
    ``ShardedRetriever`` over ``fwd`` at ``n_shards = world`` for every
    (engine, params) of ``retriever_cases``: ``use_mesh`` False, True and
    None under no tombstones and each victim set; then ``use_mesh=True``
    at more shards than ranks (must raise) and None there (the rotation).
    ``backend`` is the retrievers' rescoring path; every rows launch of
    the rank, eager or replayed by a plan, is saved as ``rows_launches``."""
    from repro_torch.kernels import rows_dot
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.serve.api import Retriever, RetrieverConfig, make_sharded_search

    one_thread()
    rows_dot.reset_launches()
    out, meshes, plans = {}, {}, []
    for name, c in search_cases.items():
        shape = tuple(c["mesh"])
        if shape not in meshes:
            meshes[shape] = make_debug_mesh(shape, ("data", "model"))
        fn = make_sharded_search(meshes[shape], c["cfg"], c["n_local"], c["n_docs"], 1.0,
                                 index_axis="model", query_axes=("data",), device=device)
        out[f"{name}/ids"], out[f"{name}/scores"] = _host(fn(c["arrays"], c["idmap"],
                                                             search_Q))
        plans += fn._placed[2].plans.created().values()
    for engine, params in retriever_cases:
        cfg = RetrieverConfig(engine=engine, k=10, n_shards=world, params=params, backend=backend)
        r = Retriever.build(fwd, cfg, device=device)
        for tag, victims in [("none", [])] + [(f"v{i}", v) for i, v in enumerate(victim_sets)]:
            plans += [p for x in r._resident.values() for p in x.plans.created().values()]
            r.set_tombstones(np.asarray(victims, np.int64))
            for mode in (False, True, None):
                r.use_mesh = mode
                out[f"{engine}/{tag}/{mode}/ids"], out[f"{engine}/{tag}/{mode}/scores"] = \
                    _host(r.search(Q))
        plans += [p for x in r._resident.values() for p in x.plans.created().values()]
    out["rows_launches"] = np.array(rows_dot.launches + sum(
        c * p.replays for p in set(plans) for c in p.launches["variants"].values()))
    many = Retriever.build(fwd, RetrieverConfig(engine="flat", k=10, n_shards=2 * world),
                           device=device)
    many.use_mesh = True
    try:
        many.search(Q)
        out["few/raised"] = np.array(0)
    except ValueError as e:
        out["few/raised"] = np.array(int(f"{world} rank(s) for {2 * world} shards" in str(e)))
    many.use_mesh = None
    out["few/none/ids"], out["few/none/scores"] = _host(many.search(Q))
    many.use_mesh = False
    out["few/false/ids"], out["few/false/scores"] = _host(many.search(Q))
    save(out_dir, rank, out)


def scan_ranks(rank, world, out_dir, packs, docs_local, Q, shape, device):
    """The doc-aligned scan of every pack in ``packs`` (codec → stacked
    arrays) on a ``shape`` mesh over both axes, at ``Q``'s batch and at
    its first query alone → this rank's ``[nq, docs_local]`` slices and
    its block-scan launches."""
    from repro_torch.core.scoring import make_doc_aligned_scan
    from repro_torch.kernels import block_scan
    from repro_torch.launch.mesh import make_debug_mesh

    one_thread()
    mesh = make_debug_mesh(shape, ("data", "model"))
    block_scan.reset_launches()
    out = {}
    for codec, arrays in packs.items():
        fn = make_doc_aligned_scan(mesh, ("data", "model"), docs_local, 1.0, codec,
                                   device=device)
        out[f"{codec}/batch"] = fn(arrays, Q).cpu().numpy()
        out[f"{codec}/single"] = fn(arrays, Q[:1]).cpu().numpy()
    out.update({f"launches/{k}": np.array(v) for k, v in block_scan.variant_launches.items()})
    save(out_dir, rank, out)


def quadratic_run(mesh, steps: int = QUAD_STEPS, device="cpu"):
    """The reference test's problem: y = x · w*, w* = 0..7, AdamW at lr
    0.05 (5 warmup steps of 300), a global batch of 64 from one seed on
    every rank, split over ``data`` → (final loss, w, b, every step's
    loss)."""
    from repro_torch.train.optimizer import OptimizerConfig, make_optimizer
    from repro_torch.train.train_step import init_train_state, make_dp_compressed_train_step

    true_w = np.arange(8, dtype=np.float32).reshape(8, 1)

    def loss_fn(params, batch):
        pred = batch["x"] @ params["w"] + params["b"]
        return torch.mean((pred - batch["y"]) ** 2), {}

    oinit, oupd = make_optimizer(OptimizerConfig(lr=0.05, warmup_steps=5, total_steps=300))
    params = {"w": torch.zeros((8, 1), device=device), "b": torch.zeros((1,), device=device)}
    step = make_dp_compressed_train_step(loss_fn, oupd, mesh, {"x": ("data",), "y": ("data",)},
                                         dp_axes=("data",))
    state = init_train_state(params, oinit, mesh=mesh, dp_axes=("data",))
    rng = np.random.default_rng(0)
    losses = []
    for _ in range(steps):
        x = rng.standard_normal((QUAD_BATCH, 8)).astype(np.float32)
        batch = {"x": torch.from_numpy(x).to(device), "y": torch.from_numpy(x @ true_w).to(device)}
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
    p = state["params"]
    return losses[-1], p["w"].cpu().numpy(), p["b"].cpu().numpy(), np.asarray(losses)


def dp_ranks(rank, world, out_dir, shapes):
    """``compressed_psum_mean`` over a ``(world,)`` data mesh on this
    rank's seeded gradients and residual (leaf shapes ``shapes``), then
    the quadratic problem's compressed data-parallel run."""
    from repro_torch.dist.compression import compressed_psum_mean, quantize_int8
    from repro_torch.dist.sharding import axes_group
    from repro_torch.launch.mesh import make_debug_mesh

    one_thread()
    mesh = make_debug_mesh((world,), ("data",))
    rng = np.random.default_rng(100 + rank)
    grads = {k: torch.from_numpy((rng.standard_normal(s) * 10 ** rng.uniform(-3, 1))
                                 .astype(np.float32)) for k, s in shapes.items()}
    residual = {k: torch.from_numpy((rng.standard_normal(s) * 1e-3).astype(np.float32))
                for k, s in shapes.items()}
    mean, new_res = compressed_psum_mean(grads, residual, axes_group(mesh, ("data",)))
    out = {}
    for k in shapes:
        x = grads[k] + residual[k]
        q, scale = quantize_int8(x)
        out[f"deq/{k}"] = (q.float() * scale).numpy()
        out[f"x/{k}"] = x.numpy()
        out[f"mean/{k}"] = mean[k].numpy()
        out[f"residual/{k}"] = new_res[k].numpy()
    loss, w, b, losses = quadratic_run(mesh)
    out.update({"quad/loss": np.array(loss), "quad/w": w, "quad/b": b, "quad/losses": losses})
    save(out_dir, rank, out)


def config_cells_ranks(rank, world, out_dir, fwd, Q, graph_docs):
    """Every cell of both retrieval configs at ``fwd``'s size (its dim and
    doc count; ``graph_4096q`` over its first ``graph_docs`` docs) on a
    ``(1, 1)`` mesh, run on the CPU and on the card from one rank:
    ``scan_100q`` at opt 0–3 over ``Q`` padded to the cell's width, the
    searches over ``Q`` → ``<id>/<cell>/<device>/...`` and the card runs'
    rows and block-scan launches."""
    import dataclasses

    from repro_torch.configs import RETRIEVAL_IDS, get_arch
    from repro_torch.core import layout
    from repro_torch.kernels import block_scan, rows_dot
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.serve.api import build_shard_arrays

    one_thread()
    mesh = make_debug_mesh((1, 1), ("data", "model"))
    rows_dot.reset_launches()
    block_scan.reset_launches()
    out = {}
    for arch_id in RETRIEVAL_IDS:
        for opt in (0, 1, 2, 3):
            arch = get_arch(arch_id + (f"-opt{opt}" if opt else ""))
            arch = dataclasses.replace(arch, dim=fwd.dim, n_docs=fwd.n_docs)
            if opt == 0:
                arrays = layout.pack_blocks(fwd, codec=arch.codec,
                                            block_size=arch.block_size).as_dict()
            else:
                arrays, _ = layout.pack_blocks_sharded(
                    fwd, 1, codec=arch.codec, block_size=arch.block_size,
                    seg_dtype=np.int8 if opt >= 2 else np.int32)
            cell = arch.build_cell("scan_100q", mesh)
            Qp = torch.nn.functional.pad(Q, (0, cell.input_structs[1].shape[1] - Q.shape[1]))
            for dev in ("cpu", "cuda"):
                out[f"{arch_id}/scan{opt}/{dev}"] = cell.fn(arrays, Qp.to(dev)).cpu().numpy()
        for shape in ("serve_4096q", "graph_4096q"):
            sub = fwd.slice(0, graph_docs) if shape == "graph_4096q" else fwd
            arch = dataclasses.replace(get_arch(arch_id), dim=sub.dim, n_docs=sub.n_docs)
            cfg = arch._graph_cfg() if shape == "graph_4096q" else arch._engine_cfg()
            stacked, idmap, _ = build_shard_arrays(sub, cfg, 1)
            cell = arch.build_cell(shape, mesh)
            for dev in ("cpu", "cuda"):
                ids, scores = cell.fn(stacked, idmap, Q.to(dev))
                out[f"{arch_id}/{shape}/{dev}/ids"] = ids.cpu().numpy()
                out[f"{arch_id}/{shape}/{dev}/scores"] = scores.cpu().numpy()
            plans = cell.fn.fn._placed[2].plans.created().values()
            out[f"{arch_id}/{shape}/replayed"] = np.array(sum(
                c * p.replays for p in plans for c in p.launches["variants"].values()))
    out["rows_launches"] = np.array(rows_dot.launches)
    out.update({f"launches/{k}": np.array(v) for k, v in block_scan.variant_launches.items()})
    save(out_dir, rank, out)
