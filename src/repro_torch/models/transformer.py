"""Decoder-only LM family — dense (Qwen3/Yi/DeepSeek-Coder) and MoE
(OLMoE, Kimi-K2) in one implementation: the port of
``repro/models/transformer.py``.

* **Stacked-layer params** ``[L, …]`` under the reference's names
  (``embed``, ``layers.{attn_norm, ffn_norm, wq, wk, wv, wo, q_norm,
  k_norm, w_gate, w_up, w_down | moe.*}``, ``final_norm``, ``lm_head``);
  the forward walks the layers in a Python loop where the reference
  scans them, with ``torch.utils.checkpoint`` per layer (non-reentrant)
  where the reference remats each scan step, and only while gradients
  are recorded.
* **GQA attention** with RoPE (the two halves of a head rotate as
  pairs) and optional per-head QK-RMSNorm (Qwen3): KV head ``h // G``
  serves query head ``h``.
* **Attention impls**: ``full`` and ``chunked`` (online softmax over KV
  chunks), both the plain einsum → softmax → einsum of the reference (no
  fused attention kernel: parity with the reference is the point).
  Scores in f32 scaled by ``1/sqrt(dh)``, the causal mask at ``-1e30``.
* **Decode** (``decode_step``) writes the new token's K/V into the
  static-shape cache IN PLACE at ``lengths`` (the reference's
  ``dynamic_update_slice`` returns a new cache: out of place, a 32,768-
  slot cache would be held twice) and attends over it;
  ``dist.collectives.flash_decode_shardmap`` is the sequence-sharded
  attention a cell injects, with the cache's global slice named by
  ``seq_start`` / ``seq_len``.
* **MoE** layers replace the dense FFN when ``cfg.moe`` is set
  (``models/moe.py``).

The reference's sharding hints (``shard_hint``, ``jit_weight_gather``)
select nothing. Initialisers draw from a ``torch.Generator``
(``jax.random`` bits cannot be reproduced); ``params_from_jax`` carries
the reference's own tree across.

**Placed** (``pl=LMPlacement(...)``; ``configs.base.LMArch``'s
``weights="placed"``): a rank holds its block of every weight under
``dist.sharding.lm_param_specs`` and runs the reference's program with
explicit collectives (``dist/placed.py``). A dimension split over the
data axes (FSDP) is all-gathered before its use, in the forward and
again in the backward's recompute, and its gradient reduce-scattered.
Over ``model``: ``wq/wk/wv/w_gate/w_up`` are column-parallel (a rank's
heads or hidden slice), ``wo/w_down`` row-parallel with one all-reduce;
the embedding and the head are vocab-parallel (a lookup masked to the
rank's rows and all-reduced; the loss's max, log-sum-exp and target
logit all-reduced); experts are expert-parallel (``models/moe.py``).
Attention runs on the rank's heads: its block of ``wq``/``wo`` where
the split falls on whole heads (its KV heads its own block, or selected
from every KV head where they are fewer than the ranks), else its
``[h0, h1)`` of ``H`` heads, uneven, from weights gathered over
``model`` (deepseek-coder-33b's 56 heads on 16 ranks). Decode gathers a
token's q/k/v heads over ``model`` (the cache splits its sequence there)
and slices the attention output back to the rank's ``wo`` rows; prefill
turns its head-split K/V into the cache's sequence split with an
all-to-all (or, where a rank does not hold whole KV heads, takes its
sequence block of every head).
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .. import resolve_device
from ..dist import placed as plc
from ..tree import tree_leaves_with_path, tree_map
from .common import (apply_rope, dense_init, embed_init, normal, params_from_jax,
                     params_to_numpy, rms_norm, rope_freqs)
from .moe import MoEConfig, moe_apply, moe_init

__all__ = ["TransformerConfig", "Transformer", "LMPlacement", "init_params", "param_structs",
           "forward", "lm_loss", "decode_step", "init_kv_cache", "attention", "params_from_jax",
           "params_to_numpy"]

NEG_INF = -1e30


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    d_head: int | None = None
    qk_norm: bool = False
    rope_theta: float = 10000.0
    moe: MoEConfig | None = None
    attention_impl: str = "full"  # "full" | "chunked"
    attention_chunk: int = 1024
    tie_embeddings: bool = False
    dtype: torch.dtype = torch.bfloat16
    remat: bool = True
    z_loss: float = 1e-4
    # the reference's ZeRO-3 gathering hint, which LMArch turns off for
    # decode cells (kept so the cells match; selects nothing here)
    jit_weight_gather: bool = True

    @property
    def head_dim(self) -> int:
        return self.d_head or self.d_model // self.n_heads


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def param_structs(cfg: TransformerConfig) -> dict:
    """The parameter tree as ``meta`` tensors (shape and dtype, never
    allocated) — the reference's ``eval_shape`` of ``init_params``."""
    L, D, V = cfg.n_layers, cfg.d_model, cfg.vocab
    H, Hk, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    dt = cfg.dtype

    def s(*shape, dtype=dt):
        return torch.empty(shape, dtype=dtype, device="meta")

    layers = {"attn_norm": s(L, D), "ffn_norm": s(L, D), "wq": s(L, D, H * dh),
              "wk": s(L, D, Hk * dh), "wv": s(L, D, Hk * dh), "wo": s(L, H * dh, D)}
    if cfg.qk_norm:
        layers["q_norm"] = s(L, dh)
        layers["k_norm"] = s(L, dh)
    if cfg.moe is None:
        layers["w_gate"] = s(L, D, cfg.d_ff)
        layers["w_up"] = s(L, D, cfg.d_ff)
        layers["w_down"] = s(L, cfg.d_ff, D)
    else:
        E, Fh, S = cfg.moe.n_experts, cfg.moe.d_ff, cfg.moe.n_shared_experts
        moe = {"router": s(L, D, E, dtype=torch.float32), "w_gate": s(L, E, D, Fh),
               "w_up": s(L, E, D, Fh), "w_down": s(L, E, Fh, D)}
        if S:
            moe.update(shared_gate=s(L, D, S * Fh), shared_up=s(L, D, S * Fh),
                       shared_down=s(L, S * Fh, D))
        layers["moe"] = moe
    params = {"embed": s(V, D), "layers": layers, "final_norm": s(D)}
    if not cfg.tie_embeddings:
        params["lm_head"] = s(D, V)
    return params


def init_params(generator: torch.Generator, cfg: TransformerConfig, *, device=None):
    """A fresh parameter tree on ``device`` (``cuda`` unless given), at
    the reference's scales, drawn from ``generator`` in this order: embed,
    wq, wk, wv, wo (each layer by layer), the FFN (dense w_gate, w_up,
    w_down, each layer by layer; or each layer's ``moe_init``), lm_head.
    Norms are ones. A matrix is drawn in f32 one layer at a time, then
    cast, so a full-width model never holds more than one f32 layer."""
    dev = resolve_device(device)
    L, D, V = cfg.n_layers, cfg.d_model, cfg.vocab
    H, Hk, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    dt = cfg.dtype
    structs = param_structs(cfg)
    params = {"embed": embed_init(generator, V, D, dt, dev)}
    layers = {k: torch.ones(v.shape, dtype=dt, device=dev)
              for k, v in structs["layers"].items() if "norm" in k}
    for name, d_in, d_out in (("wq", D, H * dh), ("wk", D, Hk * dh), ("wv", D, Hk * dh),
                              ("wo", H * dh, D)):
        layers[name] = _stacked_dense(generator, L, d_in, d_out, dt, dev)
    if cfg.moe is None:
        for name, d_in, d_out in (("w_gate", D, cfg.d_ff), ("w_up", D, cfg.d_ff),
                                  ("w_down", cfg.d_ff, D)):
            layers[name] = _stacked_dense(generator, L, d_in, d_out, dt, dev)
    else:
        moe = {k: torch.empty(v.shape, dtype=v.dtype, device=dev)
               for k, v in structs["layers"]["moe"].items()}
        for i in range(L):
            for k, v in moe_init(generator, cfg.moe, dt, dev).items():
                moe[k][i] = v
        layers["moe"] = moe
    params["layers"] = layers
    params["final_norm"] = torch.ones((D,), dtype=dt, device=dev)
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init(generator, D, V, dt, device=dev)
    return params


def _stacked_dense(generator, L, d_in, d_out, dtype, device):
    s = (2.0 / (d_in + d_out)) ** 0.5
    out = torch.empty((L, d_in, d_out), dtype=dtype, device=device)
    for i in range(L):
        out[i] = normal(generator, (d_in, d_out), s, dtype, device)
    return out


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------


def _scale(dh: int, device) -> torch.Tensor:
    return torch.sqrt(torch.tensor(float(dh), dtype=torch.float32, device=device))


def _gqa_scores_full(q, k, v, causal: bool, q_offset):
    """q [B,Sq,H,dh], k/v [B,Sk,Hk,dh] → [B,Sq,H,dh]. Full materialised."""
    B, Sq, H, dh = q.shape
    Sk, Hk = k.shape[1], k.shape[2]
    G = H // Hk
    k = torch.repeat_interleave(k, G, dim=2)  # [B,Sk,H,dh]
    v = torch.repeat_interleave(v, G, dim=2)
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k).float()
    scores = scores / _scale(dh, q.device)
    if causal:
        qpos = q_offset + torch.arange(Sq, device=q.device)
        kpos = torch.arange(Sk, device=q.device)
        mask = qpos[:, None] >= kpos[None, :]
        scores = torch.where(mask[None, None], scores, NEG_INF)
    attn = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", attn, v)


def _gqa_scores_chunked(q, k, v, causal: bool, q_offset, chunk: int):
    """Flash-style online softmax over KV chunks (plain torch, O(chunk²)
    memory); the same arithmetic as the full form up to the order of its
    f32 sums."""
    B, Sq, H, dh = q.shape
    Sk, Hk = k.shape[1], k.shape[2]
    G = H // Hk
    k = torch.repeat_interleave(k, G, dim=2)
    v = torch.repeat_interleave(v, G, dim=2)
    n_chunks = (Sk + chunk - 1) // chunk
    pad = n_chunks * chunk - Sk
    if pad:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
    kc = k.reshape(B, n_chunks, chunk, H, dh).transpose(0, 1)
    vc = v.reshape(B, n_chunks, chunk, H, dh).transpose(0, 1)
    qpos = q_offset + torch.arange(Sq, device=q.device)
    scale = _scale(dh, q.device)

    m = torch.full((B, H, Sq), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, H, Sq), dtype=torch.float32, device=q.device)  # noqa: E741
    acc = torch.zeros((B, H, Sq, dh), dtype=torch.float32, device=q.device)
    for c_idx in range(n_chunks):  # running max, denominator, numerator
        kb, vb = kc[c_idx], vc[c_idx]
        kpos = c_idx * chunk + torch.arange(chunk, device=q.device)
        s = torch.einsum("bqhd,bkhd->bhqk", q, kb).float() / scale
        valid = kpos[None, :] < Sk
        if causal:
            valid = valid & (qpos[:, None] >= kpos[None, :])
        s = torch.where(valid[None, None], s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        rescale = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * rescale + p.sum(dim=-1)  # noqa: E741
        acc = acc * rescale[..., None] + torch.einsum(
            "bhqk,bkhd->bhqd", p.to(q.dtype), vb
        ).float()
        m = m_new
    out = acc / torch.clamp_min(l, 1e-30)[..., None]
    return out.transpose(1, 2).to(q.dtype)


def attention(q, k, v, *, causal: bool, q_offset=0, impl: str = "full", chunk: int = 1024):
    if impl == "chunked":
        return _gqa_scores_chunked(q, k, v, causal, q_offset, chunk)
    return _gqa_scores_full(q, k, v, causal, q_offset)


# ---------------------------------------------------------------------------
# placement
# ---------------------------------------------------------------------------


class LMPlacement:
    """What a rank's placed program needs of ``specs`` (``lm_param_specs``
    over the stacked tree) on ``mesh`` (a ``DeviceMesh``): which layer
    leaves split over ``model`` on which dimension, the data axes to
    gather, and how attention's heads fall (module docstring).
    ``batch_split``: the batch's rows split over the data axes (not in
    ``long_500k``, whose batch is replicated), so an MoE layer routes
    the data ranks' tokens as one batch. ``collect_kv``: a prefill, whose
    cache needs every KV head of the rank's sequence block."""

    def __init__(self, cfg: TransformerConfig, mesh, specs, *, batch_split: bool = True,
                 collect_kv: bool = False):
        from ..dist.sharding import axis_index, axis_size, data_axes

        self.cfg, self.mesh = cfg, mesh
        self.batch_split, self.collect_kv = batch_split, collect_kv
        self.da = data_axes(mesh)
        self.nm, self.r = axis_size(mesh, "model"), axis_index(mesh, "model")
        # layer leaves drop the stacked L dimension
        self.specs = {k.replace("['layers']", "").replace("']['", "/").strip("[]'"):
                      tuple(v[1:]) if k.startswith("['layers']") else tuple(v)
                      for k, v in tree_leaves_with_path(specs)}
        H, Hk, nm = cfg.n_heads, cfg.n_kv_heads, self.nm
        G = H // Hk
        self.q_split, self.kv_split = self.split("wq", 1), self.split("wk", 1)
        self.o_split = self.split("wo", 0)
        Hl = H // nm
        self.heads = (self.q_split and self.o_split and H % nm == 0
                      and (Hl % G == 0 or G % Hl == 0))
        # the rank's query heads, even or not, and the KV heads they read
        self.h0, self.h1 = self.r * H // nm, (self.r + 1) * H // nm
        self.kv_lo, self.kv_n = self.h0 // G, (self.h1 - 1) // G + 1 - self.h0 // G
        self.kv_own = self.heads and self.kv_split and Hk % nm == 0
        self.vocab_split = self.split("embed", 0)
        self.head_split = (self.vocab_split if cfg.tie_embeddings else self.split("lm_head", 1))

    def split(self, name: str, dim: int) -> bool:
        """Whether leaf ``name`` (``wq``, ``moe/w_gate``, ``embed``…) splits
        dimension ``dim`` over ``model``."""
        spec = self.specs[name]
        return dim < len(spec) and "model" in plc.spec_axes(spec[dim])

    def w(self, t: torch.Tensor, name: str) -> torch.Tensor:
        """Leaf ``name``'s block ``t`` with its data-split dimensions
        gathered (FSDP); its ``model`` split stays."""
        for d, e in enumerate(self.specs[name]):
            axes = tuple(a for a in plc.spec_axes(e) if a in self.da)
            if axes:
                t = plc.gather_axes(t, self.mesh, axes, d)
        return t

    def copy(self, x):
        return plc.copy_to_model(x, self.mesh)

    def reduce(self, x):
        return plc.reduce_from_model(x, self.mesh)

    def gather(self, x, dim: int = -1):
        return plc.gather_from_model(x, self.mesh, dim)

    def block(self, lp, name: str, dim: int, lo: int, hi: int) -> torch.Tensor:
        """``[lo, hi)`` of leaf ``name``'s whole dimension ``dim`` (the
        rank's uneven heads): the weight gathered over ``model`` where it
        splits, its gradient summed back over the ranks."""
        w = self.w(lp[name], name)
        if self.split(name, dim):
            w = self.gather(w, dim)
        return self.copy(w).narrow(dim, lo, hi - lo)

    def vocab_lo(self, V_local: int) -> int:
        return self.r * V_local


# ---------------------------------------------------------------------------
# layer + forward
# ---------------------------------------------------------------------------


def _layer_params(layers, i: int):
    """Layer ``i``'s views of the stacked tree."""
    return tree_map(lambda t: t[i], layers)


def _qkv(lp, cfg: TransformerConfig, x, positions, inv_freq):
    B, S, _ = x.shape
    H, Hk, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    h = rms_norm(x, lp["attn_norm"])
    q = (h @ lp["wq"]).reshape(B, S, H, dh)
    k = (h @ lp["wk"]).reshape(B, S, Hk, dh)
    v = (h @ lp["wv"]).reshape(B, S, Hk, dh)
    if cfg.qk_norm:
        q = rms_norm(q, lp["q_norm"])
        k = rms_norm(k, lp["k_norm"])
    return apply_rope(q, positions, inv_freq), apply_rope(k, positions, inv_freq), v


def _proj_whole(pl: LMPlacement, lp, name: str, h):
    """``h @ lp[name]`` made whole over ``model`` (a split's columns
    gathered)."""
    if pl.split(name, 1):
        return pl.gather(pl.copy(h) @ pl.w(lp[name], name))
    return h @ pl.w(lp[name], name)


def _qkv_placed(lp, cfg: TransformerConfig, x, positions, inv_freq, pl: LMPlacement,
                whole: bool = False):
    """The placed q/k/v: every head (``whole``: decode), the rank's heads
    where the split falls on whole heads (``pl.heads``), else the rank's
    ``[h0, h1)`` of them from the gathered weights, each with its own copy
    of the KV head it reads."""
    B, S, _ = x.shape
    H, Hk, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    h = rms_norm(x, lp["attn_norm"])
    if whole:
        q, k, v = (_proj_whole(pl, lp, n, h).reshape(B, S, -1, dh) for n in ("wq", "wk", "wv"))
        qn, kn = (lp.get("q_norm"), lp.get("k_norm"))
    else:
        hc = pl.copy(h)
        if pl.heads:
            q = (hc @ pl.w(lp["wq"], "wq")).reshape(B, S, H // pl.nm, dh)
        else:
            q = (hc @ pl.block(lp, "wq", 1, pl.h0 * dh, pl.h1 * dh)).reshape(B, S, -1, dh)
        if pl.kv_own:
            k, v = ((hc @ pl.w(lp[n], n)).reshape(B, S, -1, dh) for n in ("wk", "wv"))
        elif pl.heads:  # every KV head, then the ones the rank's query heads read
            k, v = (pl.copy(_proj_whole(pl, lp, n, h).reshape(B, S, Hk, dh))
                    [:, :, pl.kv_lo:pl.kv_lo + pl.kv_n] for n in ("wk", "wv"))
        else:  # the KV heads the rank's query heads read, one a query head
            lo, hi = pl.kv_lo * dh, (pl.kv_lo + pl.kv_n) * dh
            sel = torch.arange(pl.h0, pl.h1, device=x.device) // (H // Hk) - pl.kv_lo
            k, v = ((hc @ pl.block(lp, n, 1, lo, hi)).reshape(B, S, -1, dh)[:, :, sel]
                    for n in ("wk", "wv"))
        qn, kn = ((pl.copy(lp[n]) if cfg.qk_norm else None) for n in ("q_norm", "k_norm"))
    if cfg.qk_norm:
        q, k = rms_norm(q, qn), rms_norm(k, kn)
    return apply_rope(q, positions, inv_freq), apply_rope(k, positions, inv_freq), v


def _kv_whole(lp, cfg: TransformerConfig, x, positions, inv_freq, pl: LMPlacement):
    """Every KV head of ``x``'s positions (the prefill cache where the
    rank's query heads fall off whole heads; no gradient)."""
    B, S, _ = x.shape
    h = rms_norm(x, lp["attn_norm"])
    k, v = (_proj_whole(pl, lp, n, h).reshape(B, S, -1, cfg.head_dim) for n in ("wk", "wv"))
    if cfg.qk_norm:
        k = rms_norm(k, lp["k_norm"])
    return apply_rope(k, positions, inv_freq), v


def _wo_placed(lp, out, pl: LMPlacement, whole: bool = False):
    """The row-parallel ``wo`` over the attention output ``out``: [B, S,
    H·dh] (``whole``: the rank's columns of it), or the rank's heads
    (``pl.heads``: its rows of ``wo``; else its ``[h0, h1)`` rows of the
    gathered ``wo``)."""
    if whole:
        w = pl.w(lp["wo"], "wo")
        if not pl.o_split:
            return out @ w
        c = w.shape[0]
        return pl.reduce(pl.copy(out)[..., pl.r * c:(pl.r + 1) * c] @ w)
    if pl.heads:
        return pl.reduce(out @ pl.w(lp["wo"], "wo"))
    dh = out.shape[-1] // (pl.h1 - pl.h0)
    return pl.reduce(out @ pl.block(lp, "wo", 0, pl.h0 * dh, pl.h1 * dh))


def _attn_block(lp, cfg: TransformerConfig, x, positions, inv_freq, kv=None, pl=None):
    """One attention block. kv=None → self-attention over x (training,
    prefill); kv(q, k, v) → (out, new_kv) attends elsewhere (decode)."""
    B, S, _ = x.shape
    if pl is None:
        q, k, v = _qkv(lp, cfg, x, positions, inv_freq)
    else:
        q, k, v = _qkv_placed(lp, cfg, x, positions, inv_freq, pl, whole=kv is not None)
    if kv is None:
        out = attention(q, k, v, causal=True, q_offset=0, impl=cfg.attention_impl,
                        chunk=cfg.attention_chunk)
        new_kv = (k, v)
        if pl is not None and pl.collect_kv and not pl.kv_own:  # the cache: every KV head
            new_kv = _kv_whole(lp, cfg, x, positions, inv_freq, pl)
    else:
        out, new_kv = kv(q, k, v)
    out = out.reshape(B, S, -1)
    if pl is None:
        return out @ lp["wo"], new_kv
    return _wo_placed(lp, out, pl, whole=kv is not None), new_kv


def _ffn_block(lp, cfg: TransformerConfig, x, pl=None):
    h = rms_norm(x, lp["ffn_norm"])
    if cfg.moe is None:
        if pl is None:
            y = F.silu(h @ lp["w_gate"]) * (h @ lp["w_up"])
            return y @ lp["w_down"], torch.zeros((), dtype=torch.float32, device=x.device)
        split = pl.split("w_gate", 1)
        hc = pl.copy(h) if split else h
        y = F.silu(hc @ pl.w(lp["w_gate"], "w_gate")) * (hc @ pl.w(lp["w_up"], "w_up"))
        y = y @ pl.w(lp["w_down"], "w_down")
        return (pl.reduce(y) if split else y), torch.zeros((), dtype=torch.float32,
                                                            device=x.device)
    B, S, D = h.shape
    y, aux = moe_apply(lp["moe"], cfg.moe, h.reshape(B * S, D), pl=pl)
    return y.reshape(B, S, D), aux["load_balance_loss"]


def _layer(lp, cfg: TransformerConfig, x, positions, inv_freq, pl=None):
    a, (k, v) = _attn_block(lp, cfg, x, positions, inv_freq, pl=pl)
    x = x + a
    f, aux = _ffn_block(lp, cfg, x, pl)
    return x + f, aux, k, v


def _embed(params, tokens, pl=None):
    """The token rows; placed: vocab-parallel (the rank's rows, the rest
    zeros, all-reduced over ``model``)."""
    if pl is None:
        return params["embed"][tokens]
    table = pl.w(params["embed"], "embed")
    if not pl.vocab_split:
        return table[tokens]
    Vl = table.shape[0]
    ids = tokens.long() - pl.vocab_lo(Vl)
    inside = (ids >= 0) & (ids < Vl)
    rows = table[torch.where(inside, ids, 0)]
    return pl.reduce(rows.masked_fill_(~inside[..., None], 0))


def _head(params, x, pl=None):
    """The logits; placed: the rank's vocab block where the head splits
    it (``pl.head_split``), else every logit."""
    head = params.get("lm_head")
    if pl is None:
        return x @ head if head is not None else x @ params["embed"].T
    xc = pl.copy(x) if pl.head_split else x
    if head is not None:
        return xc @ pl.w(head, "lm_head")
    return xc @ pl.w(params["embed"], "embed").T


def forward(params, cfg: TransformerConfig, tokens: torch.Tensor, *, collect_kv: bool = False,
            pl: LMPlacement | None = None):
    """tokens [B, S] → (logits [B, S, V], aux dict). Training/prefill path.

    collect_kv=True additionally returns the per-layer K/V stacks —
    the prefill path's KV-cache product ([L, B, S, Hk, dh]; placed: the
    rank's block of the cache's sequence split, [L, B, S/model, Hk,
    dh]). ``pl``: the rank's placed program on its blocks (its logits are
    its vocab block where the head splits it)."""
    B, S = tokens.shape
    dev = tokens.device
    x = _embed(params, tokens, pl)
    positions = torch.arange(S, device=dev)[None, :]
    inv_freq = rope_freqs(cfg.head_dim, cfg.rope_theta, device=dev)
    remat = cfg.remat and torch.is_grad_enabled()
    auxes, ks, vs = [], [], []
    for i in range(params["layers"]["wq"].shape[0]):
        lp = _layer_params(params["layers"], i)
        if remat:  # recompute the layer in the backward pass
            x, aux, k, v = checkpoint(_layer, lp, cfg, x, positions, inv_freq, pl,
                                      use_reentrant=False)
        else:
            x, aux, k, v = _layer(lp, cfg, x, positions, inv_freq, pl)
        auxes.append(aux)
        if collect_kv:
            if pl is not None:
                k, v = _cache_block(k, v, cfg, pl)
            ks.append(k)
            vs.append(v)
        del k, v
    aux = {"load_balance_loss": torch.stack(auxes).mean()}
    if collect_kv:
        aux["kv_cache"] = {"k": torch.stack(ks), "v": torch.stack(vs)}
        del ks, vs
    logits = _head(params, rms_norm(x, params["final_norm"]), pl)
    return logits, aux


def _cache_block(k, v, cfg: TransformerConfig, pl: LMPlacement):
    """A layer's K/V [B, S, ·, dh] → the rank's block of the cache's
    sequence split over ``model`` with every KV head: an all-to-all of
    the rank's heads, or a slice where every head is held."""
    S = k.shape[1]
    if pl.kv_own:  # the rank's KV heads
        return (plc.all_to_all_model(k.detach(), pl.mesh, 1, 2),
                plc.all_to_all_model(v.detach(), pl.mesh, 1, 2))
    m = S // pl.nm  # copies: a view would keep the whole sequence alive
    return k[:, pl.r * m:(pl.r + 1) * m].clone(), v[:, pl.r * m:(pl.r + 1) * m].clone()


def lm_loss(params, cfg: TransformerConfig, tokens, labels, pl: LMPlacement | None = None):
    """Next-token cross entropy with z-loss; labels -100 are masked.
    Placed with a vocab-split head: the max, the log-sum-exp and the
    target logit all-reduced over ``model`` (the rank that holds a label
    gives its logit)."""
    logits, aux = forward(params, cfg, tokens, pl=pl)
    logits = logits.float()
    mask = labels >= 0
    labels_safe = torch.clamp_min(labels, 0).long()  # int32 labels, as the cells' structs
    if pl is not None and pl.head_split:
        Vl = logits.shape[-1]
        m = plc.max_over_model(logits.detach().amax(dim=-1), pl.mesh)
        logz = m + torch.log(pl.reduce(torch.exp(logits - m[..., None]).sum(dim=-1)))
        ids = labels_safe - pl.vocab_lo(Vl)
        inside = (ids >= 0) & (ids < Vl)
        gold = torch.take_along_dim(logits, torch.where(inside, ids, 0)[..., None], dim=-1)[..., 0]
        gold = pl.reduce(torch.where(inside, gold, 0.0))
    else:
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.take_along_dim(logits, labels_safe[..., None], dim=-1)[..., 0]
    nll = (logz - gold) * mask
    z = cfg.z_loss * (logz ** 2) * mask
    denom = torch.clamp_min(mask.sum(), 1)
    loss = (nll.sum() + z.sum()) / denom
    if cfg.moe is not None:
        loss = loss + 0.01 * aux["load_balance_loss"]
    return loss, {"nll": nll.sum() / denom, "aux": aux}


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------


def init_kv_cache(cfg: TransformerConfig, batch: int, max_len: int, dtype=None, *, device=None):
    """Zeros ``{"k", "v"}`` of ``[L, batch, max_len, Hk, dh]`` on ``device``
    (``cuda`` unless given; ``"meta"`` for shapes only)."""
    dev = torch.device("meta") if str(device) == "meta" else resolve_device(device)
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    dt = dtype or cfg.dtype
    return {"k": torch.zeros(shape, dtype=dt, device=dev),
            "v": torch.zeros(shape, dtype=dt, device=dev)}


def decode_step(params, cfg: TransformerConfig, cache, tokens, lengths, attn_fn=None, *,
                seq_start: int = 0, seq_len: int | None = None, pl: LMPlacement | None = None):
    """One decode step.

    tokens [B, 1] new token ids; lengths [B] current cache fill (the new
    token is written at position ``lengths``). Returns (logits [B, V],
    cache): ``cache`` is the same dict, written in place.
    ``attn_fn(q, k_cache, v_cache, lengths)`` may be injected to run
    sequence-sharded flash decoding (``dist.collectives``); default is the
    local masked-softmax reference. A sharded cache holds the global
    positions ``[seq_start, seq_start + S_local)`` of a ``seq_len``-slot
    sequence (default: the whole of it), and a rank writes the new token
    only where its slice holds the position. ``pl``: the placed program
    (every head of the token gathered over ``model`` before the cache
    write and the attention, the output's columns back to the rank's
    ``wo`` rows).
    """
    B = tokens.shape[0]
    H, dh = cfg.n_heads, cfg.head_dim
    x = _embed(params, tokens, pl)  # [B, 1, D]
    inv_freq = rope_freqs(cfg.head_dim, cfg.rope_theta, device=tokens.device)
    positions = lengths[:, None]
    attn_impl = attn_fn or _decode_attention_ref
    for i in range(params["layers"]["wq"].shape[0]):
        lp = _layer_params(params["layers"], i)
        kc, vc = cache["k"][i], cache["v"][i]
        if pl is None:
            q, k, v = _qkv(lp, cfg, x, positions, inv_freq)
        else:
            q, k, v = _qkv_placed(lp, cfg, x, positions, inv_freq, pl, whole=True)
        # write the new kv at position `lengths` (per-batch dynamic index)
        _cache_write(kc, k, lengths, start=seq_start, total=seq_len)
        _cache_write(vc, v, lengths, start=seq_start, total=seq_len)
        a = attn_impl(q, kc, vc, lengths + 1).reshape(B, 1, H * dh)
        x = x + (a @ lp["wo"] if pl is None else _wo_placed(lp, a, pl, whole=True))
        f, _ = _ffn_block(lp, cfg, x, pl)
        x = x + f
    x = rms_norm(x, params["final_norm"])
    return _head(params, x[:, 0, :], pl), cache


def _cache_write(cache, kv_new, lengths, *, start: int = 0, total: int | None = None):
    """cache [B,S,Hk,dh]; kv_new [B,1,Hk,dh]; write IN PLACE at each row's
    position ``lengths[b]`` (clamped into the sequence, as the reference's
    ``dynamic_update_slice`` clamps its start), where ``cache`` holds
    positions ``[start, start + S)`` of a ``total``-slot sequence: a row
    whose position lies outside that slice is left as it was. No host
    sync: a row outside rewrites its own old value."""
    S = cache.shape[1]
    total = S if total is None else total
    pos = torch.clamp(lengths.long(), 0, total - 1) - start
    inside = (pos >= 0) & (pos < S)
    local = torch.clamp(pos, 0, S - 1)
    rows = torch.arange(cache.shape[0], device=cache.device)
    new = kv_new[:, 0].to(cache.dtype)
    cache[rows, local] = torch.where(inside[:, None, None], new, cache[rows, local])
    return cache


def _decode_attention_ref(q, k_cache, v_cache, valid_len):
    """Reference masked decode attention. q [B,1,H,dh], caches [B,S,Hk,dh]."""
    B, _, H, dh = q.shape
    S, Hk = k_cache.shape[1], k_cache.shape[2]
    G = H // Hk
    qg = q.reshape(B, Hk, G, dh)
    s = torch.einsum("bhgd,bkhd->bhgk", qg, k_cache).float()
    s = s / _scale(dh, q.device)
    mask = torch.arange(S, device=q.device)[None, :] < valid_len[:, None]
    s = torch.where(mask[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1).to(q.dtype)
    out = torch.einsum("bhgk,bkhd->bhgd", p, v_cache)
    return out.reshape(B, 1, H, dh)


class Transformer(torch.nn.Module):
    """The LM as an ``nn.Module``: the reference's tree held as parameters
    under its names (``state_dict`` keys ``embed``, ``layers.wq``,
    ``moe.w_gate``, …), its forward ``forward``. The functional API above
    works on ``tree()``, a view of the same storage."""

    def __init__(self, cfg: TransformerConfig, params):
        super().__init__()
        self.cfg = cfg
        for name in ("embed", "final_norm", "lm_head"):
            if name in params:
                self.register_parameter(name, torch.nn.Parameter(params[name]))
        layers = dict(params["layers"])
        self.moe = torch.nn.ParameterDict(
            {k: torch.nn.Parameter(v) for k, v in layers.pop("moe", {}).items()})
        self.layers = torch.nn.ParameterDict(
            {k: torch.nn.Parameter(v) for k, v in layers.items()})

    def tree(self) -> dict:
        out = {name: p for name, p in self.named_parameters() if "." not in name}
        out["layers"] = dict(self.layers.items())
        if len(self.moe):
            out["layers"]["moe"] = dict(self.moe.items())
        return out

    def forward(self, tokens: torch.Tensor):
        return forward(self.tree(), self.cfg, tokens)
