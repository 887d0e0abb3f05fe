"""RecSys models: DeepFM, DCN-v2, SASRec, DIN, and the EmbeddingBag they
share — the port of ``repro/models/recsys.py``.

``embedding_bag`` is the reference's gather plus segment sum
(``index_select`` and ``index_add_``). Every model keeps one *combined*
embedding table ([Σ field vocab, dim], per-field offsets), the layout the
placements row-shard over the ``model`` axis (``dist.sharding.
recsys_param_specs``). Inside ``row_split(mesh, tables)`` a lookup into
one of ``tables`` (a rank's block of rows) is vocab-parallel: the rank
gathers its rows for the ids in its range and zeros for the rest, the
partial rows are summed over ``model``, and the backward writes the
rank's own rows only; a table read whole (SASRec's positions) is
all-gathered.

Batch conventions (static shapes), the reference's:

* CTR models (DeepFM, DCN-v2): ``{"sparse": i32 [B, F], "dense": f32
  [B, 13] (DCN only), "label": f32 [B]}``; ids are *field-local*, the
  combined-table offset is added inside the model, so an id past its
  field's vocabulary reads the next field's rows, as in the reference.
* SASRec: ``{"seq": i32 [B, S], "pos_label": i32 [B, S], "neg_label":
  i32 [B, S, K]}`` (0 = padding item).
* DIN: ``{"hist": i32 [B, S], "target": i32 [B], "label": f32 [B]}``.

An id past the end of a table is an error here (``index_select``
raises on the CPU and asserts on the card), where ``jnp.take`` fills
NaN; callers draw ids inside the table. ``*_score_candidates`` is the
``retrieval_cand`` shape (one user × 10⁶ candidates) as one batched
forward or product, never a loop. The masked softmaxes mask with
``-1e30`` in f32, as the reference does; DIN casts back to the table's
dtype. On the card the gathers' backward (``index_add_``) and the bag
sums take torch's deterministic path under
``torch.use_deterministic_algorithms(True)``.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import math
from typing import Iterable, Sequence

import torch

from .common import dense_init, embed_init, layer_norm, mlp_apply, mlp_init, normal

__all__ = [
    "row_split",
    "embedding_bag",
    "bce_loss",
    "RecsysConfig",
    "DeepFMConfig",
    "DCNv2Config",
    "SASRecConfig",
    "DINConfig",
    "deepfm_init",
    "deepfm_forward",
    "deepfm_loss",
    "deepfm_score_candidates",
    "dcnv2_init",
    "dcnv2_forward",
    "dcnv2_loss",
    "dcnv2_score_candidates",
    "sasrec_init",
    "sasrec_encode",
    "sasrec_loss",
    "sasrec_score_candidates",
    "din_init",
    "din_forward",
    "din_loss",
    "din_score_candidates",
]


#: ``id`` of a table the lookups take as a row block → its mesh
_ROW_SPLIT: contextvars.ContextVar[dict] = contextvars.ContextVar("row_split", default={})


@contextlib.contextmanager
def row_split(mesh, tables: Iterable[torch.Tensor]):
    """Within the block, a lookup into one of ``tables`` — each the rank's
    block of rows of a table split over ``model`` — is vocab-parallel."""
    token = _ROW_SPLIT.set({id(t): mesh for t in tables})
    try:
        yield
    finally:
        _ROW_SPLIT.reset(token)


def _take(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``jnp.take(table, ids, axis=0)`` for ids of any shape."""
    mesh = _ROW_SPLIT.get().get(id(table))
    if mesh is None:
        return torch.index_select(table, 0, ids.reshape(-1)).reshape(*ids.shape,
                                                                     *table.shape[1:])
    from ..dist.placed import reduce_from_model
    from ..dist.sharding import axis_index

    n = table.shape[0]
    local = ids.long() - axis_index(mesh, "model") * n
    inside = (local >= 0) & (local < n)
    rows = torch.index_select(table, 0, torch.where(inside, local, 0).reshape(-1))
    # masked and reduced in place (a second lookup-sized buffer would count
    # in the peak), before the reshape (in place on a view, the backward
    # would copy the whole base)
    keep = inside.reshape(-1, *([1] * (table.dim() - 1)))
    rows = reduce_from_model(rows.masked_fill_(~keep, 0), mesh)
    return rows.reshape(*ids.shape, *table.shape[1:])


def _whole(table: torch.Tensor) -> torch.Tensor:
    """``table`` whole (a row block under ``row_split`` all-gathered)."""
    mesh = _ROW_SPLIT.get().get(id(table))
    if mesh is None:
        return table
    from ..dist.placed import gather_from_model

    return gather_from_model(table, mesh, 0)


def embedding_bag(
    table: torch.Tensor,
    ids: torch.Tensor,
    *,
    mode: str = "sum",
    valid: torch.Tensor | None = None,
) -> torch.Tensor:
    """EmbeddingBag (sum | mean) over the last axis of ``ids``: ids
    [..., L] → [..., dim]. Rows are gathered and summed by bag over a
    flattened bag index (``index_add_``); ``valid`` masks ids out, and a
    bag with no valid id has mean 0."""
    shape = ids.shape
    L = shape[-1]
    flat = ids.reshape(-1)
    n_bags = flat.shape[0] // L
    rows = _take(table, flat)  # [n_bags * L, dim]
    if valid is not None:
        rows = rows * valid.reshape(-1, 1).to(rows.dtype)
    bag = torch.arange(n_bags, dtype=torch.int64, device=ids.device).repeat_interleave(L)
    out = torch.zeros((n_bags, table.shape[1]), dtype=rows.dtype,
                      device=rows.device).index_add(0, bag, rows)
    if mode == "mean":
        if valid is not None:
            counts = torch.zeros((n_bags,), dtype=rows.dtype, device=rows.device).index_add(
                0, bag, valid.reshape(-1).to(rows.dtype))
        else:
            counts = torch.full((n_bags,), float(L), dtype=rows.dtype, device=rows.device)
        out = out / torch.clamp_min(counts, 1.0)[:, None]
    return out.reshape(*shape[:-1], table.shape[1])


def _field_offsets(vocab_sizes: Sequence[int], device=None) -> torch.Tensor:
    off = [0]
    for v in vocab_sizes[:-1]:
        off.append(off[-1] + v)
    return torch.tensor(off, dtype=torch.int32, device=device)


def bce_loss(logits: torch.Tensor, labels: torch.Tensor):
    logits = logits.float()
    nll = (torch.clamp_min(logits, 0) - logits * labels
           + torch.log1p(torch.exp(-logits.abs())))
    auc_proxy = ((logits > 0) == (labels > 0.5)).float().mean()
    return nll.mean(), {"accuracy": auc_proxy}


class RecsysConfig:
    """Marker base for recsys configs."""


# ---------------------------------------------------------------------------
# DeepFM  [arXiv:1703.04247]
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class DeepFMConfig(RecsysConfig):
    name: str = "deepfm"
    vocab_sizes: tuple[int, ...] = (100_000,) * 39  # 39 sparse fields
    embed_dim: int = 10
    mlp: tuple[int, ...] = (400, 400, 400)
    dtype: torch.dtype = torch.float32

    @property
    def n_fields(self) -> int:
        return len(self.vocab_sizes)

    @property
    def total_vocab(self) -> int:
        return sum(self.vocab_sizes)


def deepfm_init(generator: torch.Generator, cfg: DeepFMConfig, device=None):
    F, D = cfg.n_fields, cfg.embed_dim
    return {
        "embed": embed_init(generator, cfg.total_vocab, D, cfg.dtype, device),
        "linear": normal(generator, (cfg.total_vocab,), 0.01, cfg.dtype, device),
        "mlp": mlp_init(generator, (F * D, *cfg.mlp, 1), cfg.dtype, device),
        "bias": torch.zeros((), dtype=cfg.dtype, device=device or generator.device),
    }


def deepfm_forward(params, cfg: DeepFMConfig, sparse_ids: torch.Tensor) -> torch.Tensor:
    """sparse_ids i32 [B, F] (field-local) → logits [B]."""
    ids = sparse_ids + _field_offsets(cfg.vocab_sizes, sparse_ids.device)[None, :]
    e = _take(params["embed"], ids)  # [B, F, D]
    first = _take(params["linear"], ids).sum(-1)  # [B]
    s = e.sum(dim=1)
    fm = 0.5 * ((s * s).sum(-1) - (e * e).sum(dim=(1, 2)))  # [B]
    deep = mlp_apply(params["mlp"], e.reshape(e.shape[0], -1))[:, 0]
    return first + fm + deep + params["bias"]


def deepfm_loss(params, cfg: DeepFMConfig, batch):
    return bce_loss(deepfm_forward(params, cfg, batch["sparse"]), batch["label"])


def _with_field(user_rows: torch.Tensor, cand_ids: torch.Tensor, field: int) -> torch.Tensor:
    """``broadcast_to(user_rows, (N, F)).at[:, field].set(cand_ids)``: a
    copy of the broadcast rows, then the write (never into an expanded
    view)."""
    rows = user_rows.expand(cand_ids.shape[0], user_rows.shape[-1]).clone()
    rows[:, field] = cand_ids.to(rows.dtype)
    return rows


def deepfm_score_candidates(params, cfg: DeepFMConfig, user_sparse, cand_ids, cand_field: int):
    """retrieval_cand: one user row [1, F] × candidate values of one
    field (``cand_ids`` i32 [N], field-local ids of ``cand_field``) —
    a batched forward over the fixed user features."""
    return deepfm_forward(params, cfg, _with_field(user_sparse, cand_ids, cand_field))


# ---------------------------------------------------------------------------
# DCN-v2  [arXiv:2008.13535]
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class DCNv2Config(RecsysConfig):
    name: str = "dcn-v2"
    n_dense: int = 13
    vocab_sizes: tuple[int, ...] = (100_000,) * 26
    embed_dim: int = 16
    n_cross_layers: int = 3
    mlp: tuple[int, ...] = (1024, 1024, 512)
    dtype: torch.dtype = torch.float32

    @property
    def n_fields(self) -> int:
        return len(self.vocab_sizes)

    @property
    def total_vocab(self) -> int:
        return sum(self.vocab_sizes)

    @property
    def d_interact(self) -> int:
        return self.n_dense + self.n_fields * self.embed_dim


def dcnv2_init(generator: torch.Generator, cfg: DCNv2Config, device=None):
    d = cfg.d_interact
    dev = device or generator.device
    return {
        "embed": embed_init(generator, cfg.total_vocab, cfg.embed_dim, cfg.dtype, dev),
        "cross_w": [dense_init(generator, d, d, cfg.dtype, device=dev)
                    for _ in range(cfg.n_cross_layers)],
        "cross_b": [torch.zeros((d,), dtype=cfg.dtype, device=dev)
                    for _ in range(cfg.n_cross_layers)],
        "mlp": mlp_init(generator, (d, *cfg.mlp), cfg.dtype, dev),
        "head": dense_init(generator, cfg.mlp[-1], 1, cfg.dtype, device=dev),
    }


def dcnv2_forward(params, cfg: DCNv2Config, dense, sparse_ids):
    ids = sparse_ids + _field_offsets(cfg.vocab_sizes, sparse_ids.device)[None, :]
    e = _take(params["embed"], ids).reshape(sparse_ids.shape[0], -1)
    x0 = torch.cat([dense.to(cfg.dtype), e], dim=-1)  # [B, d]
    x = x0
    for w, b in zip(params["cross_w"], params["cross_b"]):
        x = x0 * (x @ w + b) + x  # DCN-v2 full-matrix cross
    h = mlp_apply(params["mlp"], x, final_activation=torch.relu)
    return (h @ params["head"])[:, 0]


def dcnv2_loss(params, cfg: DCNv2Config, batch):
    return bce_loss(dcnv2_forward(params, cfg, batch["dense"], batch["sparse"]), batch["label"])


def dcnv2_score_candidates(params, cfg: DCNv2Config, user_dense, user_sparse, cand_ids,
                           cand_field: int):
    N = cand_ids.shape[0]
    dense = user_dense.expand(N, cfg.n_dense)
    return dcnv2_forward(params, cfg, dense, _with_field(user_sparse, cand_ids, cand_field))


# ---------------------------------------------------------------------------
# SASRec  [arXiv:1808.09781]
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class SASRecConfig(RecsysConfig):
    name: str = "sasrec"
    n_items: int = 1_000_000  # item 0 = padding
    embed_dim: int = 50
    n_blocks: int = 2
    n_heads: int = 1
    seq_len: int = 50
    n_negatives: int = 128
    dtype: torch.dtype = torch.float32


def sasrec_init(generator: torch.Generator, cfg: SASRecConfig, device=None):
    D = cfg.embed_dim
    dev = device or generator.device
    ones = lambda: torch.ones((D,), dtype=cfg.dtype, device=dev)  # noqa: E731
    zeros = lambda: torch.zeros((D,), dtype=cfg.dtype, device=dev)  # noqa: E731
    item = embed_init(generator, cfg.n_items, D, cfg.dtype, dev)
    pos = embed_init(generator, cfg.seq_len, D, cfg.dtype, dev)
    blocks = [{
        "ln1_w": ones(), "ln1_b": zeros(),
        "wqkv": dense_init(generator, D, 3 * D, cfg.dtype, device=dev),
        "wo": dense_init(generator, D, D, cfg.dtype, device=dev),
        "ln2_w": ones(), "ln2_b": zeros(),
        "ff1": dense_init(generator, D, D, cfg.dtype, device=dev),
        "ff2": dense_init(generator, D, D, cfg.dtype, device=dev),
    } for _ in range(cfg.n_blocks)]
    return {"item_embed": item, "pos_embed": pos, "final_ln_w": ones(), "final_ln_b": zeros(),
            "blocks": blocks}


def sasrec_encode(params, cfg: SASRecConfig, seq: torch.Tensor) -> torch.Tensor:
    """seq i32 [B, S] (0 = pad) → user states [B, S, D]."""
    B, S = seq.shape
    H = cfg.n_heads
    D = cfg.embed_dim
    dh = D // H
    x = _take(params["item_embed"], seq) + _whole(params["pos_embed"])[None, :S]
    pad = (seq == 0)[..., None]
    x = torch.where(pad, torch.zeros((), dtype=x.dtype, device=x.device), x)
    causal = torch.tril(torch.ones((S, S), dtype=torch.bool, device=seq.device))
    for blk in params["blocks"]:
        h = layer_norm(x, blk["ln1_w"], blk["ln1_b"])
        qkv = (h @ blk["wqkv"]).reshape(B, S, 3, H, dh)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        s = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(dh)
        s = s.float().masked_fill(~causal[None, None], -1e30)
        a = torch.softmax(s, dim=-1).to(x.dtype)
        o = torch.einsum("bhqk,bkhd->bqhd", a, v).reshape(B, S, D)
        x = x + o @ blk["wo"]
        h = layer_norm(x, blk["ln2_w"], blk["ln2_b"])
        x = x + torch.relu(h @ blk["ff1"]) @ blk["ff2"]
        x = torch.where(pad, torch.zeros((), dtype=x.dtype, device=x.device), x)
    return layer_norm(x, params["final_ln_w"], params["final_ln_b"])


def sasrec_loss(params, cfg: SASRecConfig, batch):
    """Sampled-softmax next-item loss (the positive and K sampled
    negatives)."""
    states = sasrec_encode(params, cfg, batch["seq"])  # [B, S, D]
    pos = _take(params["item_embed"], batch["pos_label"])  # [B, S, D]
    neg = _take(params["item_embed"], batch["neg_label"])  # [B, S, K, D]
    pos_logit = (states * pos).sum(-1)  # [B, S]
    neg_logit = torch.einsum("bsd,bskd->bsk", states, neg)
    mask = (batch["pos_label"] > 0).float()
    logits = torch.cat([pos_logit[..., None], neg_logit], dim=-1).float()
    nll = torch.logsumexp(logits, dim=-1) - pos_logit.float()
    denom = torch.clamp_min(mask.sum(), 1.0)
    loss = (nll * mask).sum() / denom
    hit = ((pos_logit[..., None] > neg_logit).all(-1).float() * mask).sum() / denom
    return loss, {"hit_rate": hit}


def sasrec_score_candidates(params, cfg: SASRecConfig, seq, cand_ids):
    """retrieval_cand: dense MIPS — the user state × the candidates'
    item embeddings → [B, N]."""
    user = sasrec_encode(params, cfg, seq)[:, -1]  # [B, D]
    cand = _take(params["item_embed"], cand_ids)  # [N, D]
    return user @ cand.T


# ---------------------------------------------------------------------------
# DIN  [arXiv:1706.06978]
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class DINConfig(RecsysConfig):
    name: str = "din"
    n_items: int = 1_000_000
    embed_dim: int = 18
    seq_len: int = 100
    attn_mlp: tuple[int, ...] = (80, 40)
    mlp: tuple[int, ...] = (200, 80)
    dtype: torch.dtype = torch.float32


def din_init(generator: torch.Generator, cfg: DINConfig, device=None):
    D = cfg.embed_dim
    dev = device or generator.device
    return {
        "item_embed": embed_init(generator, cfg.n_items, D, cfg.dtype, dev),
        "attn_mlp": mlp_init(generator, (4 * D, *cfg.attn_mlp, 1), cfg.dtype, dev),
        # input: [attended interest, mean-pooled history, target]
        "mlp": mlp_init(generator, (3 * D, *cfg.mlp, 1), cfg.dtype, dev),
    }


def din_forward(params, cfg: DINConfig, hist, target):
    """hist i32 [B, S] (0 = pad), target i32 [B] → logits [B]."""
    h = _take(params["item_embed"], hist)  # [B, S, D]
    t = _take(params["item_embed"], target)  # [B, D]
    tb = t[:, None].expand(h.shape)
    feats = torch.cat([h, tb, h - tb, h * tb], dim=-1)  # [B, S, 4D]
    w = mlp_apply(params["attn_mlp"], feats, activation=torch.sigmoid)[..., 0]
    w = w.float().masked_fill(hist <= 0, -1e30)
    # DIN uses un-normalised weights; the reference takes the masked
    # softmax (the stable variant)
    a = torch.softmax(w, dim=-1).to(h.dtype)
    interest = (a[..., None] * h).sum(dim=1)  # weighted-sum pooling [B, D]
    # the mean-pooled history through the EmbeddingBag, a second interest feature
    hist_mean = embedding_bag(params["item_embed"], hist, mode="mean", valid=(hist > 0))
    z = torch.cat([interest, hist_mean, t], dim=-1)
    return mlp_apply(params["mlp"], z)[:, 0]


def din_loss(params, cfg: DINConfig, batch):
    return bce_loss(din_forward(params, cfg, batch["hist"], batch["target"]), batch["label"])


def din_score_candidates(params, cfg: DINConfig, hist, cand_ids):
    """retrieval_cand: one user history × N candidate targets, one batched
    forward."""
    N = cand_ids.shape[0]
    return din_forward(params, cfg, hist.expand(N, cfg.seq_len), cand_ids)
