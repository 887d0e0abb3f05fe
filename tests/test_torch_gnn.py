"""The port's GAT (``repro_torch.models.gnn``) against the reference's
(``repro.models.gnn``) on the CPU.

* ``gat_forward``, ``gat_loss``, ``gat_graph_loss`` and every gradient
  (``jax.value_and_grad`` against ``torch.autograd``), the reference's
  parameters carried across by ``params_from_jax``, on graphs with
  sentinel padding, isolated nodes (an empty segment: ``segment_max``'s
  ``-inf`` mapped to 0), self-loops, duplicate edges and an edge list of
  sentinels only. Tolerances: logits and losses within rtol 1e-5 (atol
  1e-6); gradients within 1e-5 of each leaf's largest entry (f32 sums in
  another order).
* ``pad_graph``, ``partition_edges_by_dst`` and ``NeighborSampler``
  byte-equal to the reference's for the same seed, the budget
  ``ValueError``s too.
* ``gat_loss_edge_sharded`` on a ``(2, 2)`` gloo mesh (four spawned
  ranks, ``tests/torch_gnn_cases.py``) at both ``min_side_gather``
  settings: the loss and every gradient against the reference's
  ``shard_map`` on four forced host devices (a subprocess) and against
  the unsharded ``gat_loss``.
* The SpMM's loop over edge chunks (``MESSAGE_CHUNK`` patched to 37, so
  every graph takes several chunks and a partial last one): the losses
  and gradients above, the edge-sharded ones included, against the
  reference, and bit for bit against one chunk.
* ``GNNArch.smoke`` with the reference's parameters against the
  reference's losses.

torch runs at one intra-op thread (``torch_cases.one_intra_op_thread``).
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_cases import one_intra_op_thread  # noqa: F401 — autouse fixture
from torch_configs_cases import ROOT
from torch_gnn_cases import (SHARDED_C, SHARDED_D, SHARDED_F, SHARDED_H, edge_sharded_rank,
                             sharded_graph)

from repro import configs as ref_configs
from repro.models import gnn as rg
from repro_torch import configs
from repro_torch.launch.mesh import spawn_ranks
from repro_torch.models import gnn as pg
from repro_torch.models.common import params_from_jax
from repro_torch.train.train_step import value_and_grad
from repro_torch.tree import tree_leaves_with_path

RTOL, ATOL = 1e-5, 1e-6
#: gradients: within this fraction of the leaf's largest entry
GRAD_REL = 1e-5


def _cfgs(F, C, H=4, D=4, L=2):
    kw = dict(name="t", n_layers=L, d_in=F, d_hidden=D, n_heads=H, n_classes=C)
    return rg.GATConfig(**kw), pg.GATConfig(**kw)


def _ref_params(cfg, seed=0):
    p = rg.gat_init(jax.random.PRNGKey(seed), cfg)
    return p, params_from_jax(jax.device_get(p), device="cpu")


def _graph_case(kind: str, rng):
    """(x, edge_index, labels, train_mask, edge_budget) of a test graph."""
    N, F, C = 40, 6, 3
    x = rng.normal(size=(N, F)).astype(np.float32)
    labels = rng.integers(0, C, size=N)
    mask = rng.random(N) < 0.6
    if kind == "all_sentinel":
        return x, np.zeros((2, 0), np.int64), labels, mask, 32
    src = rng.integers(0, N, size=120)
    dst = rng.integers(0, N - 8, size=120)  # the last 8 nodes are isolated
    if kind == "loops_and_duplicates":
        src[:12], dst[:12] = np.arange(12), np.arange(12)
        src[12:30], dst[12:30] = src[30:48], dst[30:48]
    return x, np.stack([src, dst]), labels, mask, 160


def _assert_grads(got, want, what=""):
    g = dict(tree_leaves_with_path(got))
    n = 0
    for path, leaf in jax.tree_util.tree_leaves_with_path(want):
        k = jax.tree_util.keystr(path)
        w = np.asarray(leaf)
        scale = max(float(np.abs(w).max()), 1e-30)
        err = float(np.abs(g[k].detach().numpy() - w).max())
        assert err <= GRAD_REL * scale, (what, k, err, scale)
        n += 1
    assert n == len(g), (what, sorted(g))


def _node_loss_case(kind: str):
    """``gat_forward``, ``gat_loss`` and its gradients on ``kind``'s graph
    against the reference → (the port's loss, its gradients, the edges)."""
    rng = np.random.default_rng(1)
    x, ei, labels, mask, budget = _graph_case(kind, rng)
    cr, cp = _cfgs(x.shape[1], 3)
    pr, pp = _ref_params(cr)
    gr = rg.pad_graph(x, ei, labels, mask, edge_budget=budget)
    gp = pg.pad_graph(x, ei, labels, mask, edge_budget=budget, device="cpu")
    with torch.no_grad():
        got = pg.gat_forward(pp, cp, gp).numpy()
    want = np.asarray(jax.jit(lambda p: rg.gat_forward(p, cr, gr))(pr))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    if kind != "all_sentinel":  # the isolated nodes took the empty-segment branch
        assert np.isfinite(got).all()
    (lr, ar), grads_r = jax.jit(jax.value_and_grad(lambda p: rg.gat_loss(p, cr, gr),
                                                   has_aux=True))(pr)
    (lp, ap), grads_p = value_and_grad(lambda p, b: pg.gat_loss(p, cp, b), pp, gp)
    np.testing.assert_allclose(float(lp), float(lr), rtol=RTOL)
    assert float(ap["acc"]) == pytest.approx(float(ar["acc"]), abs=1e-7)
    _assert_grads(grads_p, grads_r, kind)
    return float(lp), grads_p, gp.edge_src.shape[0]


def _graph_loss_case():
    """The molecule readout against the reference: 6 graphs of 5–9 nodes,
    one node of padding (graph id -1), mean-pooled logits → (the port's
    loss, its gradients, the edges)."""
    rng = np.random.default_rng(2)
    sizes = [5, 9, 7, 6, 8, 5]
    N = sum(sizes)
    gid = np.repeat(np.arange(len(sizes)), sizes).astype(np.int32)
    starts = np.cumsum([0] + sizes[:-1])
    src, dst = [], []
    for s, n in zip(starts, sizes):
        src.append(rng.integers(s, s + n, size=2 * n))
        dst.append(rng.integers(s, s + n, size=2 * n))
    ei = np.stack([np.concatenate(src), np.concatenate(dst)])
    x = rng.normal(size=(N, 5)).astype(np.float32)
    glab = rng.integers(0, 2, size=len(sizes)).astype(np.int32)
    cr, cp = _cfgs(5, 2)
    pr, pp = _ref_params(cr, seed=3)
    labels, mask = np.zeros(N, np.int32), np.ones(N, bool)
    gr = rg.pad_graph(x, ei, labels, mask, edge_budget=ei.shape[1] + 16)
    gp = pg.pad_graph(x, ei, labels, mask, edge_budget=ei.shape[1] + 16, device="cpu")
    gid_p = np.concatenate([gid, [-1]]).astype(np.int32)
    n_graphs = len(sizes)
    (lr, ar), grads_r = jax.jit(jax.value_and_grad(
        lambda p: rg.gat_graph_loss(p, cr, gr, jnp.asarray(gid_p), jnp.asarray(glab), n_graphs),
        has_aux=True))(pr)
    (lp, ap), grads_p = value_and_grad(
        lambda p, b: pg.gat_graph_loss(p, cp, b, torch.from_numpy(gid_p),
                                       torch.from_numpy(glab), n_graphs), pp, gp)
    np.testing.assert_allclose(float(lp), float(lr), rtol=RTOL)
    assert float(ap["acc"]) == pytest.approx(float(ar["acc"]), abs=1e-7)
    _assert_grads(grads_p, grads_r, "graph loss")
    return float(lp), grads_p, gp.edge_src.shape[0]


@pytest.mark.parametrize("kind", ["sentinel_padding", "loops_and_duplicates", "all_sentinel"])
def test_forward_loss_and_grads_equal_the_reference(kind):
    _node_loss_case(kind)


def test_graph_loss_and_grads_equal_the_reference():
    _graph_loss_case()


#: a message chunk that cuts every test graph's edges into several chunks,
#: the last one partial: 160 edges into 5, the molecule batch's 96 into 3,
#: a rank's 128 of the edge-sharded check into 4
SMALL_CHUNK = 37


@pytest.mark.parametrize("case", ["sentinel_padding", "loops_and_duplicates", "graph_loss"])
def test_messages_in_chunks_equal_the_reference(case, monkeypatch):
    """``_Aggregate``'s loop over several chunks (``MESSAGE_CHUNK`` patched
    to 37): ``gat_forward``, ``gat_loss`` / ``gat_graph_loss`` and every
    gradient against the reference within the tolerances above, and bit
    for bit against the port's single chunk (the CPU adds the edges in
    their order either way)."""
    run = _graph_loss_case if case == "graph_loss" else lambda: _node_loss_case(case)
    l_one, g_one, E = run()
    assert E > 2 * SMALL_CHUNK and E % SMALL_CHUNK, E
    monkeypatch.setattr(pg, "MESSAGE_CHUNK", SMALL_CHUNK)
    l_chunks, g_chunks, _ = run()
    assert l_chunks == l_one
    one = dict(tree_leaves_with_path(g_one))
    for k, v in tree_leaves_with_path(g_chunks):
        assert torch.equal(v, one[k]), k


def test_pad_graph_is_byte_equal_and_checks_its_budget():
    rng = np.random.default_rng(4)
    x, ei, labels, mask, budget = _graph_case("sentinel_padding", rng)
    gr = rg.pad_graph(x, ei, labels, mask, edge_budget=budget)
    gp = pg.pad_graph(x, ei, labels, mask, edge_budget=budget, device="cpu")
    for k in ("x", "edge_src", "edge_dst", "labels", "train_mask"):
        a, b = np.asarray(getattr(gr, k)), getattr(gp, k).numpy()
        assert a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes(), k
    with pytest.raises(ValueError, match="edge budget below edge count"):
        pg.pad_graph(x, ei, labels, mask, edge_budget=ei.shape[1] - 1, device="cpu")
    with pytest.raises(ValueError, match="edge budget below edge count"):
        rg.pad_graph(x, ei, labels, mask, edge_budget=ei.shape[1] - 1)


@pytest.mark.parametrize("n_shards", [1, 4, 7])
def test_partition_edges_by_dst_is_byte_equal(n_shards):
    rng = np.random.default_rng(5)
    ei = rng.integers(0, 300, size=(2, 1000))
    ei[1, :200] = 299  # the last range holds more edges
    got, want = pg.partition_edges_by_dst(ei, 301, n_shards), rg.partition_edges_by_dst(
        ei, 301, n_shards)
    assert got[2] == want[2]
    for a, b in zip(got[:2], want[:2]):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


def test_neighbor_sampler_is_byte_equal():
    rng = np.random.default_rng(6)
    ei = rng.integers(0, 500, size=(2, 6000))
    seeds = rng.choice(500, size=16, replace=False)
    a, b = pg.NeighborSampler(ei, 500, seed=3), rg.NeighborSampler(ei, 500, seed=3)
    for _ in range(2):  # the generator's state carries over from sample to sample
        for got, want in zip(a.sample(seeds, (5, 3)), b.sample(seeds, (5, 3))):
            assert got.dtype == want.dtype and got.tobytes() == want.tobytes()
    for got, want in zip(a.sample_padded(seeds, (4, 2), 512, 1024),
                         b.sample_padded(seeds, (4, 2), 512, 1024)):
        assert got.dtype == want.dtype and got.tobytes() == want.tobytes()
    with pytest.raises(ValueError, match="budget too small") as e_p:
        a.sample_padded(seeds, (15, 10), 64, 128)
    with pytest.raises(ValueError, match="budget too small") as e_r:
        b.sample_padded(seeds, (15, 10), 64, 128)
    assert str(e_p.value) == str(e_r.value)


_REFERENCE_SHARDED = r"""
import json, sys
import jax, numpy as np
from repro.models import gnn
z = dict(np.load(sys.argv[1]))
L = int(z["n_layers"])
F, C, H, D = json.loads(sys.argv[2])
cfg = gnn.GATConfig(name="sharded", n_layers=L, d_in=F, d_hidden=D, n_heads=H, n_classes=C)
params = {"layers": [{k: z[f"{l}/{k}"] for k in ("w", "a_src", "a_dst")} for l in range(L)]}
mesh = jax.make_mesh((2, 2), ("data", "model"))
batch = {"x": z["x"], "edge_src": z["esrc"], "edge_dst": z["edst"], "labels": z["labels"],
         "train_mask": z["mask"]}
out = {}
for min_side in (0, 1):
    with jax.set_mesh(mesh):
        (loss, aux), g = jax.jit(jax.value_and_grad(lambda p: gnn.gat_loss_edge_sharded(
            p, cfg, batch, mesh, ("data", "model"), min_side_gather=bool(min_side)),
            has_aux=True))(params)
    out[f"{min_side}/loss"] = np.asarray(loss)
    for path, leaf in jax.tree_util.tree_leaves_with_path(g):
        out[f"{min_side}/" + jax.tree_util.keystr(path)] = np.asarray(leaf)
np.savez(sys.argv[3], **out)
"""


def _edge_sharded_case(tmp_path, chunk=None):
    """``gat_loss_edge_sharded`` on a (2, 2) gloo mesh (the SpMM in chunks
    of ``chunk`` edges where given) against the reference's ``shard_map``
    on four forced host devices and the unsharded ``gat_loss``."""
    g = sharded_graph()
    cr, cp = _cfgs(SHARDED_F, SHARDED_C, H=SHARDED_H, D=SHARDED_D)
    pr, pp = _ref_params(cr, seed=7)
    leaves = {f"{l}/{k}": np.asarray(lp[k]) for l, lp in enumerate(pr["layers"]) for k in lp}
    extra = {} if chunk is None else {"message_chunk": chunk}
    np.savez(tmp_path / "inputs.npz", n_layers=2, **leaves, **extra,
             **{k: g[k] for k in ("x", "labels", "mask", "esrc", "edst")})
    spawn_ranks(edge_sharded_rank, 4, str(tmp_path), backend="gloo",
                init_file=tmp_path / "init", timeout_s=180)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    res = subprocess.run([sys.executable, "-c", _REFERENCE_SHARDED, str(tmp_path / "inputs.npz"),
                          json.dumps([SHARDED_F, SHARDED_C, SHARDED_H, SHARDED_D]),
                          str(tmp_path / "ref.npz")], env=env, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    ref = dict(np.load(tmp_path / "ref.npz"))
    # the unsharded loss on the same graph (padded: sentinel edges at node 63)
    n = g["x"].shape[0] - 1
    gp = pg.pad_graph(g["x"][:n], g["edge_index"], g["labels"][:n], g["mask"][:n] > 0,
                      device="cpu")
    (l_full, a_full), grads_full = value_and_grad(lambda p, b: pg.gat_loss(p, cp, b), pp, gp)
    full = dict(tree_leaves_with_path(grads_full))
    for min_side in (0, 1):
        outs = [dict(np.load(tmp_path / f"out{r}_{min_side}.npz")) for r in range(4)]
        for o in outs[1:]:  # every rank holds the same loss and whole gradients
            for k in o:
                assert np.array_equal(o[k], outs[0][k]), (min_side, k)
        got = outs[0]
        np.testing.assert_allclose(got["loss"], ref[f"{min_side}/loss"], rtol=RTOL)
        np.testing.assert_allclose(got["loss"], float(l_full), rtol=RTOL)
        assert float(got["acc"]) == pytest.approx(float(a_full["acc"]), abs=1e-7)
        for k, w in full.items():
            scale = float(np.abs(w.numpy()).max())
            for want, what in ((ref[f"{min_side}/{k}"], "reference"), (w.numpy(), "unsharded")):
                err = float(np.abs(got[k] - want).max())
                assert err <= GRAD_REL * scale, (min_side, what, k, err, scale)
    return g


def test_edge_sharded_loss_on_four_gloo_ranks(tmp_path):
    """``gat_loss_edge_sharded`` on a (2, 2) gloo mesh equals the
    reference's ``shard_map`` on four forced host devices and the
    unsharded ``gat_loss``, loss and every gradient, at both
    ``min_side_gather`` settings (the reference's run matches its own
    unsharded loss within 4e-7 relative; the port's gradients are
    whole on every rank, summed once)."""
    _edge_sharded_case(tmp_path)


def test_edge_sharded_loss_in_chunks_on_four_gloo_ranks(tmp_path, monkeypatch):
    """The same check with the SpMM in chunks of 37 edges on every rank
    (and in the unsharded loss): a rank's 128 edges take four chunks, the
    last one partial."""
    monkeypatch.setattr(pg, "MESSAGE_CHUNK", SMALL_CHUNK)
    g = _edge_sharded_case(tmp_path, SMALL_CHUNK)
    ep = g["esrc"].shape[0] // 4
    assert ep > 2 * SMALL_CHUNK and ep % SMALL_CHUNK, ep


def test_gnn_smoke_equals_the_reference():
    """``GNNArch.smoke`` with the reference's parameters: the same numpy
    graph and three AdamW steps give the reference's losses; the sampler's
    subgraph is the reference's."""
    seed = 0
    arch, ref_arch = configs.get_arch("gat-cora"), ref_configs.get_arch("gat-cora")
    cfg = rg.GATConfig(name="smoke", d_in=12, n_classes=5, d_hidden=ref_arch.d_hidden,
                       n_heads=ref_arch.n_heads)
    pr = rg.gat_init(jax.random.PRNGKey(seed), cfg)
    want = ref_arch.smoke(seed)["losses"]
    got = arch.smoke(seed, device="cpu", params=params_from_jax(jax.device_get(pr),
                                                                 device="cpu"))
    assert got["device"] == "cpu"
    np.testing.assert_allclose(got["losses"], want, rtol=1e-5)
    own = arch.smoke(seed, device="cpu")  # its own weights: finite, and repeatable
    assert np.isfinite(own["losses"]).all()
    assert own["losses"] == arch.smoke(seed, device="cpu")["losses"]
    rng = np.random.default_rng(seed)  # the smoke's draws, in its order
    rng.normal(size=(64, 12)), rng.integers(0, 64, size=(2, 256))
    rng.integers(0, 5, size=64), rng.random(64)
    smp = rg.NeighborSampler(np.asarray(rng.integers(0, 64, size=(2, 256))), 64)
    for a, b in zip(got["sample"], smp.sample_padded(np.arange(4), (3, 2), 64, 128)):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


def test_smoke_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        configs.get_arch("gat-cora").smoke()


def test_no_jax_on_import():
    code = ("import sys\nimport repro_torch.models.gnn, repro_torch.configs.gat_cora\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'repro'))\n"
            "assert not bad, bad\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"},
                         timeout=120)
    assert res.returncode == 0, res.stderr[-2000:]
