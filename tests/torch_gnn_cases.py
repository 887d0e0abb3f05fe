"""Rank programs and graphs of the port's GNN tests
(``tests/test_torch_gnn.py``, ``tests/test_torch_family_cells.py``).
Nothing here imports jax: the ranks are spawned processes."""

import pathlib

import numpy as np
import torch

#: the edge-sharded check's graph: nodes (the last one padding), features,
#: classes, heads, hidden width
SHARDED_N, SHARDED_F, SHARDED_C, SHARDED_H, SHARDED_D = 63, 12, 5, 4, 4


def sharded_graph(seed: int = 0) -> dict:
    """A 63-node graph (64 rows with the padding row) with isolated nodes
    (50–62 have no incoming edge), self-loops and duplicate edges, its
    edges split by destination over 4 ranks (``partition_edges_by_dst``)
    → numpy arrays: ``x`` [64, F], ``labels`` (-1 at the padding row),
    ``mask`` (f32), ``edge_index`` [2, E] and the partition ``esrc``,
    ``edst`` [4 · Ep]."""
    from repro_torch.models.gnn import partition_edges_by_dst

    rng = np.random.default_rng(seed)
    N, F, C = SHARDED_N, SHARDED_F, SHARDED_C
    src = rng.integers(0, N, size=300)
    dst = rng.integers(0, 50, size=300)
    src[:10], dst[:10] = np.arange(10), np.arange(10)  # self-loops
    src[10:20], dst[10:20] = src[20:30], dst[20:30]  # duplicates
    ei = np.stack([src, dst])
    x = np.concatenate([rng.normal(size=(N, F)).astype(np.float32),
                        np.zeros((1, F), np.float32)])
    labels = np.concatenate([rng.integers(0, C, size=N), [-1]]).astype(np.int32)
    mask = np.concatenate([rng.random(N) < 0.6, [False]]).astype(np.float32)
    esrc, edst, _ = partition_edges_by_dst(ei, N + 1, 4)
    return dict(x=x, labels=labels, mask=mask, edge_index=ei, esrc=esrc, edst=edst)


def edge_sharded_rank(rank: int, world: int, d: str) -> None:
    """A rank of the (2, 2) gloo mesh: its blocks of ``<d>/inputs.npz``
    through ``gat_loss_edge_sharded`` at both ``min_side_gather``
    settings (value and gradients), the SpMM in chunks of the file's
    ``message_chunk`` edges where it holds one →
    ``<d>/out{rank}_{min_side}.npz``."""
    from repro_torch.dist.sharding import P, shard_block
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models import gnn
    from repro_torch.train.train_step import value_and_grad
    from repro_torch.tree import tree_leaves_with_path

    torch.set_num_threads(1)
    d = pathlib.Path(d)
    mesh = make_debug_mesh((2, 2), ("data", "model"))
    axes = ("data", "model")
    z = dict(np.load(d / "inputs.npz"))
    L = int(z["n_layers"])
    if "message_chunk" in z:
        gnn.MESSAGE_CHUNK = int(z["message_chunk"])
    params = {"layers": [{k: torch.from_numpy(z[f"{l}/{k}"]) for k in ("w", "a_src", "a_dst")}
                         for l in range(L)]}
    cfg = gnn.GATConfig(name="sharded", n_layers=L, d_in=SHARDED_F, d_hidden=SHARDED_D,
                        n_heads=SHARDED_H, n_classes=SHARDED_C)
    full = {"x": z["x"], "edge_src": z["esrc"], "edge_dst": z["edst"], "labels": z["labels"],
            "train_mask": z["mask"]}
    batch = {k: shard_block(torch.from_numpy(v), P(axes), mesh).contiguous()
             for k, v in full.items()}
    for min_side in (False, True):
        (loss, aux), grads = value_and_grad(
            lambda p, b: gnn.gat_loss_edge_sharded(p, cfg, b, mesh, axes,
                                                   min_side_gather=min_side), params, batch)
        np.savez(d / f"out{rank}_{int(min_side)}.npz", loss=loss.numpy(),
                 acc=aux["acc"].numpy(),
                 **{k: g.numpy() for k, g in tree_leaves_with_path(grads)})
