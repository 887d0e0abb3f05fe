"""GAT (Veličković et al., 2018) by edge-scatter message passing — the
port of ``repro/models/gnn.py``.

Message passing is built, as in the reference, from gathers and segment
reductions over an edge index:

    SDDMM   : per-edge attention logits  e_ij = LeakyReLU(a_s·h_i + a_d·h_j)
    softmax : segment max + segment sum over the incoming edges of a dst
    SpMM    : segment sum of α_ij · h_src over dst

The reference's ``jnp.take`` is ``index_select``, ``segment_sum`` is
``index_add_`` into zeros and ``segment_max`` is ``scatter_reduce("amax")``
from ``-inf`` with ``include_self=True``; a segment no edge reaches keeps
``-inf``, which the layer maps to 0 as the reference does. On the card,
under ``torch.use_deterministic_algorithms(True)``, ``index_add_`` (the
segment sums, and the backward of ``index_select``) takes torch's
deterministic path; ``amax`` does not depend on the order of its
inputs. No gather here is an indexing expression (``x[idx]``), whose
backward would be an accumulating ``index_put_``.

Shapes are static: graphs are padded to a fixed edge and node budget
with sentinel edges pointing at node ``N``, a real row (the overflow
bucket) that every segment op keeps and that the loss masks out.

The SpMM runs over chunks of edges (``_Aggregate``): a layer keeps
``[E, H]`` tensors and never the ``[E, H, d]`` messages, so
``ogb_products``' 61.9M edges train on one card.

The minibatch path uses a host-side CSR uniform neighbour sampler
(fanout per hop, GraphSAGE-style) in numpy: ``NeighborSampler``,
``pad_graph`` and ``partition_edges_by_dst`` are the reference's numpy,
so the same seed gives the same bytes.

``gat_loss_edge_sharded`` is the reference's dst-aligned edge-sharded
layer (its ``shard_map``) on ``torch.distributed``: a rank passes its
blocks and holds every parameter; one all-gather a layer, local softmax
and scatter, the loss's sums over the mesh.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from .. import resolve_device
from ..dist.placed import gather_axes, psum, replicated
from .common import dense_init, normal

__all__ = [
    "GATConfig",
    "gat_init",
    "gat_forward",
    "gat_loss",
    "gat_graph_loss",
    "gat_loss_edge_sharded",
    "Graph",
    "pad_graph",
    "partition_edges_by_dst",
    "NeighborSampler",
]


@dataclasses.dataclass(frozen=True)
class GATConfig:
    name: str
    n_layers: int = 2
    d_in: int = 1433
    d_hidden: int = 8
    n_heads: int = 8
    n_classes: int = 7
    negative_slope: float = 0.2
    dtype: torch.dtype = torch.float32


@dataclasses.dataclass
class Graph:
    """Static-shape graph batch. Sentinel edges point src = dst = n_nodes."""

    x: torch.Tensor  # [N(+1), F] node features (last row may be padding)
    edge_src: torch.Tensor  # i32 [E]
    edge_dst: torch.Tensor  # i32 [E]
    labels: torch.Tensor  # i32 [N(+1)]
    train_mask: torch.Tensor  # bool [N(+1)]


def gat_init(generator: torch.Generator, cfg: GATConfig, device=None):
    """The reference's tree ``{"layers": [{"w", "a_src", "a_dst"}, …]}``,
    drawn in that order from ``generator`` at the reference's scales."""
    layers = []
    d_in = cfg.d_in
    for l in range(cfg.n_layers):
        last = l == cfg.n_layers - 1
        d_out = cfg.n_classes if last else cfg.d_hidden
        H = cfg.n_heads
        layers.append({
            "w": dense_init(generator, d_in, H * d_out, cfg.dtype, device=device),
            "a_src": normal(generator, (H, d_out), 0.1, cfg.dtype, device),
            "a_dst": normal(generator, (H, d_out), 0.1, cfg.dtype, device),
        })
        d_in = d_out * H if not last else d_out
    return {"layers": layers}


def _segment_sum(x: torch.Tensor, seg: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.ops.segment_sum(x, seg, num_segments=n)``."""
    return torch.zeros((n, *x.shape[1:]), dtype=x.dtype, device=x.device).index_add(0, seg, x)


def _segment_max(x: torch.Tensor, seg: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.ops.segment_max(x, seg, num_segments=n)``: ``-inf`` where no
    entry falls."""
    out = torch.full((n, *x.shape[1:]), float("-inf"), dtype=x.dtype, device=x.device)
    idx = seg.long().view(-1, *([1] * (x.dim() - 1))).expand_as(x)
    return out.scatter_reduce(0, idx, x, "amax", include_self=True)


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return torch.index_select(x, 0, idx)


#: edges a chunk of the message scatter: its ``[chunk, H, d]`` products are
#: the largest temporaries of a layer (1.5 GB at ``ogb_products``' output
#: layer, 8 heads × 47 classes)
MESSAGE_CHUNK = 1 << 20


class _Aggregate(torch.autograd.Function):
    """``segment_sum(h[src] * attn[..., None], dst, n)`` — the reference's
    SpMM — without the ``[E, H, d]`` messages: the edges go through in
    chunks of ``MESSAGE_CHUNK``, in order (so the CPU's sums are the
    unchunked ones'), and the backward recomputes each chunk's gathered
    rows instead of keeping them (``grad_h = Σ_src grad[dst] · attn``,
    ``grad_attn = Σ_d grad[dst] · h[src]``, the reference's autograd,
    chunk by chunk). A layer keeps ``[E, H]`` tensors only: at
    ``ogb_products``' 61,865,984 edges the output layer's messages and
    their gathered rows would be 93.0 GB each."""

    @staticmethod
    def forward(ctx, h, attn, src, dst, n: int):
        out = torch.zeros((n, *h.shape[1:]), dtype=h.dtype, device=h.device)
        for lo in range(0, src.shape[0], MESSAGE_CHUNK):
            hi = lo + MESSAGE_CHUNK
            out.index_add_(0, dst[lo:hi], _take(h, src[lo:hi]) * attn[lo:hi, :, None])
        ctx.save_for_backward(h, attn, src, dst)
        return out

    @staticmethod
    def backward(ctx, grad):
        h, attn, src, dst = ctx.saved_tensors
        grad_h = torch.zeros_like(h) if ctx.needs_input_grad[0] else None
        grad_attn = torch.empty_like(attn) if ctx.needs_input_grad[1] else None
        for lo in range(0, src.shape[0], MESSAGE_CHUNK):
            hi = lo + MESSAGE_CHUNK
            g = _take(grad, dst[lo:hi])  # [chunk, H, d]
            if grad_h is not None:
                grad_h.index_add_(0, src[lo:hi], g * attn[lo:hi, :, None])
            if grad_attn is not None:
                grad_attn[lo:hi] = (g * _take(h, src[lo:hi])).sum(-1)
        return grad_h, grad_attn, None, None, None


def _attend(h_src, alpha_src, alpha_dst, edge_src, edge_dst, n_seg: int, slope: float):
    """Edge logits, the segment softmax over each dst's incoming edges and
    the weighted scatter of the source rows → ``[n_seg, H, d]``."""
    e = F.leaky_relu(_take(alpha_src, edge_src) + alpha_dst, slope)  # [E, H]
    e_max = _segment_max(e, edge_dst, n_seg)
    e_max = torch.where(torch.isfinite(e_max), e_max, torch.zeros_like(e_max))
    p = torch.exp(e - _take(e_max, edge_dst))
    denom = _segment_sum(p, edge_dst, n_seg)
    attn = p / torch.clamp_min(_take(denom, edge_dst), 1e-9)  # [E, H]
    return _Aggregate.apply(h_src, attn, edge_src, edge_dst, n_seg)


def _gat_layer(lp, cfg: GATConfig, x, edge_src, edge_dst, n_nodes: int, *, concat: bool):
    H = cfg.n_heads
    d_out = lp["w"].shape[1] // H
    h = (x @ lp["w"]).reshape(-1, H, d_out)  # [N+1, H, d]
    alpha_src = (h * lp["a_src"][None]).sum(-1)  # [N+1, H]
    alpha_dst = (h * lp["a_dst"][None]).sum(-1)
    out = _attend(h, alpha_src, _take(alpha_dst, edge_dst), edge_src, edge_dst, n_nodes + 1,
                  cfg.negative_slope)
    if concat:
        return out.reshape(n_nodes + 1, H * d_out)
    return out.mean(dim=1)  # average heads (output layer, per the paper)


def gat_forward(params, cfg: GATConfig, g: Graph):
    """→ logits [N+1, n_classes] (the last row is the padding bucket)."""
    n_nodes = g.x.shape[0] - 1
    x = g.x
    for l, lp in enumerate(params["layers"]):
        last = l == len(params["layers"]) - 1
        x = _gat_layer(lp, cfg, x, g.edge_src, g.edge_dst, n_nodes, concat=not last)
        if not last:
            x = F.elu(x)
    return x


def _gold(logits, labels):
    return logits.gather(1, labels.long()[:, None])[:, 0]


def gat_graph_loss(params, cfg: GATConfig, g: Graph, graph_ids, graph_labels, n_graphs: int):
    """Graph-level classification of batched small graphs (molecule): node
    logits → mean-pool readout per graph by segment sum → cross-entropy."""
    logits = gat_forward(params, cfg, g).float()  # [N+1, C]
    gid = torch.where(graph_ids >= 0, graph_ids, torch.full_like(graph_ids, n_graphs))
    pooled = _segment_sum(logits, gid, n_graphs + 1)[:n_graphs]
    counts = _segment_sum(torch.ones(gid.shape, dtype=torch.float32, device=gid.device), gid,
                          n_graphs + 1)[:n_graphs]
    pooled = pooled / torch.clamp_min(counts, 1.0)[:, None]
    logz = torch.logsumexp(pooled, dim=-1)
    nll = (logz - _gold(pooled, graph_labels)).mean()
    acc = (pooled.argmax(-1) == graph_labels).float().mean()
    return nll, {"acc": acc}


def gat_loss(params, cfg: GATConfig, g: Graph):
    logits = gat_forward(params, cfg, g).float()
    logz = torch.logsumexp(logits, dim=-1)
    mask = g.train_mask.float()
    nll = (logz - _gold(logits, g.labels.clamp_min(0))) * mask
    denom = torch.clamp_min(g.train_mask.sum(), 1)
    acc = ((logits.argmax(-1) == g.labels).float() * mask).sum() / denom
    return nll.sum() / denom, {"acc": acc}


def pad_graph(
    x: np.ndarray,
    edge_index: np.ndarray,
    labels: np.ndarray,
    train_mask: np.ndarray,
    *,
    edge_budget: int | None = None,
    device=None,
) -> Graph:
    """Numpy graph → static-shape padded ``Graph`` on ``device`` (``cuda``
    unless given; sentinel = node N)."""
    N = x.shape[0]
    E = edge_index.shape[1]
    budget = edge_budget or E
    if budget < E:
        raise ValueError("edge budget below edge count")
    src = np.full(budget, N, dtype=np.int32)
    dst = np.full(budget, N, dtype=np.int32)
    src[:E] = edge_index[0]
    dst[:E] = edge_index[1]
    xp = np.concatenate([x, np.zeros((1, x.shape[1]), x.dtype)], axis=0)
    lp = np.concatenate([labels.astype(np.int32), np.array([-1], np.int32)])
    mp = np.concatenate([train_mask.astype(bool), np.array([False])])
    dev = resolve_device(device)
    return Graph(*(torch.from_numpy(a).to(dev) for a in (xp, src, dst, lp, mp)))


def partition_edges_by_dst(
    edge_index: np.ndarray, n_nodes_pad: int, n_shards: int
) -> tuple[np.ndarray, np.ndarray, int]:
    """Host-side prep of the edge-sharded layer: nodes are split into
    ``n_shards`` equal ranges; every edge goes to the shard that owns its
    *destination* (so the aggregation scatter is local) and its dst id is
    made range-local. → (edge_src_global [S·Ep], edge_dst_local [S·Ep],
    Ep), padded with sentinels (src = n_nodes_pad - 1, dst_local = N_loc)."""
    src, dst = edge_index
    n_loc = n_nodes_pad // n_shards
    owner = np.minimum(dst // n_loc, n_shards - 1).astype(np.int64)
    order = np.argsort(owner, kind="stable")
    src, dst, owner = src[order], dst[order], owner[order]
    counts = np.bincount(owner, minlength=n_shards)
    ep = int(((counts.max(initial=1) + 127) // 128) * 128)
    out_src = np.full((n_shards, ep), n_nodes_pad - 1, dtype=np.int32)
    out_dst = np.full((n_shards, ep), n_loc, dtype=np.int32)  # overflow bucket
    pos = 0
    for s in range(n_shards):
        c = int(counts[s])
        out_src[s, :c] = src[pos: pos + c]
        out_dst[s, :c] = dst[pos: pos + c] - s * n_loc
        pos += c
    return out_src.reshape(-1), out_dst.reshape(-1), ep


# ---------------------------------------------------------------------------
# the edge-sharded layer on torch.distributed
# ---------------------------------------------------------------------------


def gat_loss_edge_sharded(
    params,
    cfg: GATConfig,
    batch,
    mesh,
    axes=("data", "model"),
    min_side_gather: bool = False,
):
    """The dst-aligned edge-sharded loss (the reference's ``shard_map``
    variant), run by every rank of ``mesh`` on its own blocks.

    ``batch`` is the rank's block of each array split over ``axes``
    (row-major over them): ``x`` [n_loc, F] node rows, ``edge_src``
    (global ids) and ``edge_dst`` (ids local to the rank's node range,
    ``n_loc`` the overflow bucket) [Ep] from ``partition_edges_by_dst``,
    ``labels`` and ``train_mask`` (f32) [n_loc]. ``params`` are whole on
    every rank. Collectives a layer: ONE all-gather of the projected
    features (of the pre-projection rows where ``min_side_gather`` and
    they are narrower), its backward a reduce-scatter; the softmax and the
    scatter are local. (The reference's ``gather_dtype``, which no caller
    sets, is left out.) The loss's
    sums (nll, count, accuracy) are summed over the mesh; the value is
    the global loss on every rank, and every rank's gradients are the
    whole gradients (the replicated parameters' summed over the ranks),
    equal to ``gat_loss`` on the unsharded graph."""
    axes = tuple(axes)
    x_loc = batch["x"]
    esrc, edst = batch["edge_src"], batch["edge_dst"]
    labels_loc, mask_loc = batch["labels"], batch["train_mask"]
    n_loc = x_loc.shape[0]
    h_in = x_loc
    layers = params["layers"]
    for li, lp in enumerate(layers):
        lp = {k: replicated(v, mesh, axes) for k, v in lp.items()}
        last = li == len(layers) - 1
        H = cfg.n_heads
        d_out = lp["w"].shape[1] // H
        hp_loc = (h_in @ lp["w"]).reshape(n_loc, H, d_out)
        if min_side_gather and h_in.shape[1] < H * d_out:
            h_full = (gather_axes(h_in, mesh, axes, 0) @ lp["w"]).reshape(-1, H, d_out)
        else:
            h_full = gather_axes(hp_loc, mesh, axes, 0)  # [N_pad, H, d]
        alpha_src = (h_full * lp["a_src"][None]).sum(-1)  # [N_pad, H]
        alpha_dst_loc = (hp_loc * lp["a_dst"][None]).sum(-1)  # [n_loc, H]
        out = _attend(h_full, alpha_src, _take(alpha_dst_loc, edst.clamp(0, n_loc - 1)), esrc,
                      edst, n_loc + 1, cfg.negative_slope)[:n_loc]
        h_in = out.reshape(n_loc, H * d_out) if not last else out.mean(dim=1)
        if not last:
            h_in = F.elu(h_in)
    logits = h_in.float()  # [n_loc, C]
    logz = torch.logsumexp(logits, dim=-1)
    mask = mask_loc.float()
    nll_loc = ((logz - _gold(logits, labels_loc.clamp_min(0))) * mask).sum()
    sums = psum(torch.stack([nll_loc.detach(), mask.sum(),
                                  ((logits.argmax(-1) == labels_loc).float() * mask).sum()]),
                     mesh, axes)
    denom = torch.clamp_min(sums[1], 1)
    # the value is the global loss, the same bits on every rank; the
    # gradient is the rank's own share, which the replicated parameters'
    # and the gathers' backwards sum
    loss = sums[0] / denom + (nll_loc - nll_loc.detach()) / denom
    return loss, {"acc": sums[2] / denom}


class NeighborSampler:
    """CSR uniform neighbour sampler (GraphSAGE-style, host-side).

    Produces fixed-fanout static-shape subgraph batches: for seed set S
    and fanouts (f1, f2, …), hop h samples ≤ f_h neighbours per frontier
    node. Missing neighbours are padded with the sentinel node.
    """

    def __init__(self, edge_index: np.ndarray, n_nodes: int, seed: int = 0):
        src, dst = edge_index
        order = np.argsort(dst, kind="stable")
        self.src_sorted = src[order].astype(np.int64)
        self.indptr = np.searchsorted(dst[order], np.arange(n_nodes + 1))
        self.n_nodes = n_nodes
        self.rng = np.random.default_rng(seed)

    def sample(self, seeds: np.ndarray, fanouts: tuple[int, ...]):
        """→ (node_ids [M], edge_src_local, edge_dst_local) numpy arrays.

        node_ids[0:len(seeds)] are the seeds; edges are directed src→dst
        into sampled frontier order."""
        nodes = list(seeds.astype(np.int64))
        index = {int(n): i for i, n in enumerate(nodes)}
        e_src: list[int] = []
        e_dst: list[int] = []
        frontier = list(seeds.astype(np.int64))
        for f in fanouts:
            nxt: list[int] = []
            for u in frontier:
                s, e = int(self.indptr[u]), int(self.indptr[u + 1])
                neigh = self.src_sorted[s:e]
                if len(neigh) > f:
                    neigh = self.rng.choice(neigh, size=f, replace=False)
                for v in neigh:
                    v = int(v)
                    if v not in index:
                        index[v] = len(nodes)
                        nodes.append(v)
                        nxt.append(v)
                    e_src.append(index[v])
                    e_dst.append(index[u])
            frontier = nxt
        return (
            np.asarray(nodes, dtype=np.int64),
            np.asarray(e_src, dtype=np.int32),
            np.asarray(e_dst, dtype=np.int32),
        )

    def sample_padded(
        self, seeds: np.ndarray, fanouts: tuple[int, ...], node_budget: int, edge_budget: int
    ):
        """``sample`` padded: node ids to ``node_budget`` with -1, edges to
        ``edge_budget`` with the sentinel ``node_budget``; a sample past
        either budget raises ``ValueError``."""
        nodes, es, ed = self.sample(seeds, fanouts)
        if len(nodes) > node_budget or len(es) > edge_budget:
            raise ValueError(
                f"budget too small: need {len(nodes)} nodes / {len(es)} edges"
            )
        node_ids = np.full(node_budget, -1, dtype=np.int64)
        node_ids[: len(nodes)] = nodes
        src = np.full(edge_budget, node_budget, dtype=np.int32)
        dst = np.full(edge_budget, node_budget, dtype=np.int32)
        src[: len(es)] = es
        dst[: len(ed)] = ed
        return node_ids, src, dst
