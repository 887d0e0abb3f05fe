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
are no-ops off a mesh; a rank here holds whole weights. Initialisers draw
from a ``torch.Generator`` (``jax.random`` bits cannot be reproduced);
``params_from_jax`` carries the reference's own tree across.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .. import resolve_device
from ..tree import tree_map
from .common import (apply_rope, dense_init, embed_init, normal, params_from_jax,
                     params_to_numpy, rms_norm, rope_freqs)
from .moe import MoEConfig, moe_apply, moe_init

__all__ = ["TransformerConfig", "Transformer", "init_params", "param_structs", "forward",
           "lm_loss", "decode_step", "init_kv_cache", "attention", "params_from_jax",
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


def _attn_block(lp, cfg: TransformerConfig, x, positions, inv_freq, kv=None):
    """One attention block. kv=None → self-attention over x (training,
    prefill); kv(q, k, v) → (out, new_kv) attends elsewhere (decode)."""
    B, S, _ = x.shape
    q, k, v = _qkv(lp, cfg, x, positions, inv_freq)
    if kv is None:
        out = attention(q, k, v, causal=True, q_offset=0, impl=cfg.attention_impl,
                        chunk=cfg.attention_chunk)
        new_kv = (k, v)
    else:
        out, new_kv = kv(q, k, v)
    return out.reshape(B, S, cfg.n_heads * cfg.head_dim) @ lp["wo"], new_kv


def _ffn_block(lp, cfg: TransformerConfig, x):
    h = rms_norm(x, lp["ffn_norm"])
    if cfg.moe is None:
        y = F.silu(h @ lp["w_gate"]) * (h @ lp["w_up"])
        return y @ lp["w_down"], torch.zeros((), dtype=torch.float32, device=x.device)
    B, S, D = h.shape
    y, aux = moe_apply(lp["moe"], cfg.moe, h.reshape(B * S, D))
    return y.reshape(B, S, D), aux["load_balance_loss"]


def _layer(lp, cfg: TransformerConfig, x, positions, inv_freq):
    a, (k, v) = _attn_block(lp, cfg, x, positions, inv_freq)
    x = x + a
    f, aux = _ffn_block(lp, cfg, x)
    return x + f, aux, k, v


def _head(params, x):
    head = params.get("lm_head")
    return x @ head if head is not None else x @ params["embed"].T


def forward(params, cfg: TransformerConfig, tokens: torch.Tensor, *, collect_kv: bool = False):
    """tokens [B, S] → (logits [B, S, V], aux dict). Training/prefill path.

    collect_kv=True additionally returns the per-layer K/V stacks —
    the prefill path's KV-cache product ([L, B, S, Hk, dh])."""
    B, S = tokens.shape
    dev = tokens.device
    x = params["embed"][tokens]
    positions = torch.arange(S, device=dev)[None, :]
    inv_freq = rope_freqs(cfg.head_dim, cfg.rope_theta, device=dev)
    remat = cfg.remat and torch.is_grad_enabled()
    auxes, ks, vs = [], [], []
    for i in range(params["layers"]["wq"].shape[0]):
        lp = _layer_params(params["layers"], i)
        if remat:  # recompute the layer in the backward pass
            x, aux, k, v = checkpoint(_layer, lp, cfg, x, positions, inv_freq,
                                      use_reentrant=False)
        else:
            x, aux, k, v = _layer(lp, cfg, x, positions, inv_freq)
        auxes.append(aux)
        if collect_kv:
            ks.append(k)
            vs.append(v)
        del k, v
    aux = {"load_balance_loss": torch.stack(auxes).mean()}
    if collect_kv:
        aux["kv_cache"] = {"k": torch.stack(ks), "v": torch.stack(vs)}
        del ks, vs
    logits = _head(params, rms_norm(x, params["final_norm"]))
    return logits, aux


def lm_loss(params, cfg: TransformerConfig, tokens, labels):
    """Next-token cross entropy with z-loss; labels -100 are masked."""
    logits, aux = forward(params, cfg, tokens)
    logits = logits.float()
    mask = labels >= 0
    labels_safe = torch.clamp_min(labels, 0).long()  # int32 labels, as the cells' structs
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
                seq_start: int = 0, seq_len: int | None = None):
    """One decode step.

    tokens [B, 1] new token ids; lengths [B] current cache fill (the new
    token is written at position ``lengths``). Returns (logits [B, V],
    cache): ``cache`` is the same dict, written in place.
    ``attn_fn(q, k_cache, v_cache, lengths)`` may be injected to run
    sequence-sharded flash decoding (``dist.collectives``); default is the
    local masked-softmax reference. A sharded cache holds the global
    positions ``[seq_start, seq_start + S_local)`` of a ``seq_len``-slot
    sequence (default: the whole of it), and a rank writes the new token
    only where its slice holds the position.
    """
    B = tokens.shape[0]
    H, dh = cfg.n_heads, cfg.head_dim
    x = params["embed"][tokens]  # [B, 1, D]
    inv_freq = rope_freqs(cfg.head_dim, cfg.rope_theta, device=tokens.device)
    positions = lengths[:, None]
    attn_impl = attn_fn or _decode_attention_ref
    for i in range(params["layers"]["wq"].shape[0]):
        lp = _layer_params(params["layers"], i)
        kc, vc = cache["k"][i], cache["v"][i]
        q, k, v = _qkv(lp, cfg, x, positions, inv_freq)
        # write the new kv at position `lengths` (per-batch dynamic index)
        _cache_write(kc, k, lengths, start=seq_start, total=seq_len)
        _cache_write(vc, v, lengths, start=seq_start, total=seq_len)
        a = attn_impl(q, kc, vc, lengths + 1)
        x = x + a.reshape(B, 1, H * dh) @ lp["wo"]
        f, _ = _ffn_block(lp, cfg, x)
        x = x + f
    x = rms_norm(x, params["final_norm"])
    return _head(params, x[:, 0, :]), cache


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
