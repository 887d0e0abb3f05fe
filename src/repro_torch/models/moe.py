"""Mixture-of-Experts FFN: top-k routing with capacity-based dispatch —
the port of ``repro/models/moe.py``.

The reference's static-shape formulation, op for op:

1. router logits (f32) → softmax → the top-k experts of each token and
   their renormalised weights, ties broken toward the lower expert index
   as ``jax.lax.top_k`` does (a stable descending sort: ``torch.topk``
   promises no tie order);
2. the ``T·k`` (token, expert) pairs grouped by expert with a stable
   argsort; an expert keeps its first ``C`` (``_capacity``: ``T·k/E ·
   capacity_factor``, rounded up to a multiple of 8) and every later
   pair goes to the sentinel slot ``E·C``, which is cut off;
3. the gathered ``[E, C, D]`` batch runs the expert SwiGLU as batched
   products;
4. the outputs are added back to their tokens, weighted by the router
   probabilities, with ``index_add`` (the reference's scatter-add) in the
   activations' dtype. On the CPU the adds run in slot order. On CUDA
   ``index_add`` adds by atomics, so the ≤ ``top_k`` terms of a token are
   summed in an order that can change from run to run (bf16 sums then
   differ in their last bits); the port leaves that choice to the
   caller: under ``torch.use_deterministic_algorithms(True)`` it runs
   torch's deterministic path.

Optional shared experts (DeepSeek/Kimi style) process every token
densely. ``jit_weight_gather`` is the reference's sharding hint; a rank
here holds every expert, so it selects nothing.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from .common import dense_init, normal

__all__ = ["MoEConfig", "moe_init", "moe_apply"]


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_model: int
    d_ff: int  # per-expert hidden size
    n_shared_experts: int = 0
    capacity_factor: float = 1.25
    router_dtype: str = "float32"
    # the reference's ZeRO-3 just-in-time expert-weight gathering hint,
    # which LMArch switches per cell kind (kept so the cells match)
    jit_weight_gather: bool = True


def moe_init(generator: torch.Generator, cfg: MoEConfig, dtype=torch.float32, device=None):
    """One layer's experts, drawn in the reference's order: router (kept
    f32), w_gate, w_up, w_down, then the shared experts' gate, up, down."""
    E, D, Fh = cfg.n_experts, cfg.d_model, cfg.d_ff
    s = (2.0 / (D + Fh)) ** 0.5
    p = {
        "router": dense_init(generator, D, E, torch.float32, device=device),
        "w_gate": normal(generator, (E, D, Fh), s, dtype, device),
        "w_up": normal(generator, (E, D, Fh), s, dtype, device),
        "w_down": normal(generator, (E, Fh, D), s, dtype, device),
    }
    if cfg.n_shared_experts:
        S = cfg.n_shared_experts
        p["shared_gate"] = normal(generator, (D, S * Fh), s, dtype, device)
        p["shared_up"] = normal(generator, (D, S * Fh), s, dtype, device)
        p["shared_down"] = normal(generator, (S * Fh, D), s, dtype, device)
    return p


def _capacity(tokens: int, cfg: MoEConfig) -> int:
    c = int(tokens * cfg.top_k * cfg.capacity_factor / cfg.n_experts) + 1
    return max((c + 7) // 8 * 8, 8)  # lane-align


def _route(params, cfg: MoEConfig, x: torch.Tensor):
    """x [T, D] → (probs [T, E] f32, gate_w [T, K], expert_idx [T, K])."""
    logits = x.float() @ params["router"].float()  # [T, E]
    probs = torch.softmax(logits, dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_w, expert_idx = vals[:, :cfg.top_k], idx[:, :cfg.top_k]
    gate_w = gate_w / torch.clamp_min(gate_w.sum(-1, keepdim=True), 1e-9)
    return probs, gate_w, expert_idx


def _dispatch(expert_idx: torch.Tensor, gate_w: torch.Tensor, cfg: MoEConfig):
    """Group the (token, expert) pairs by expert → (dispatch_tok [E·C]
    (``T`` marks an empty slot), dispatch_w [E·C] f32): slot ``e·C + r``
    holds expert ``e``'s ``r``-th pair in token order, and a pair past
    ``C`` is dropped."""
    T, K = expert_idx.shape
    E = cfg.n_experts
    C = _capacity(T, cfg)
    dev = expert_idx.device
    flat_e = expert_idx.reshape(-1)  # [T*K]
    flat_t = torch.arange(T, device=dev).repeat_interleave(K)
    flat_w = gate_w.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    se, st, sw = flat_e[order], flat_t[order], flat_w[order]
    starts = torch.searchsorted(se, torch.arange(E, device=dev, dtype=se.dtype))  # [E]
    rank = torch.arange(T * K, device=dev) - starts[se]
    slot = torch.where(rank < C, se * C + rank, E * C)  # drop → sentinel
    dispatch_tok = torch.full((E * C + 1,), T, dtype=torch.int64, device=dev).index_put(
        (slot,), st)
    dispatch_w = torch.zeros((E * C + 1,), dtype=torch.float32, device=dev).index_put(
        (slot,), sw.float())
    return dispatch_tok[:E * C], dispatch_w[:E * C]


def moe_apply(params, cfg: MoEConfig, x: torch.Tensor):
    """x [T, D] → (y [T, D], aux) with aux = load-balancing loss terms."""
    T, D = x.shape
    E, K = cfg.n_experts, cfg.top_k
    C = _capacity(T, cfg)

    probs, gate_w, expert_idx = _route(params, cfg, x)
    dispatch_tok, dispatch_w = _dispatch(expert_idx, gate_w, cfg)

    # ---- expert compute: batched SwiGLU over [E, C, D] -----------------
    x_pad = torch.cat([x, x.new_zeros((1, D))], dim=0)
    xe = x_pad[dispatch_tok].reshape(E, C, D)
    h = F.silu(torch.einsum("ecd,edf->ecf", xe, params["w_gate"])) * torch.einsum(
        "ecd,edf->ecf", xe, params["w_up"])
    ye = torch.einsum("ecf,efd->ecd", h, params["w_down"])  # [E, C, D]

    # ---- combine: weighted scatter-add back to tokens -------------------
    contrib = ye.reshape(E * C, D) * dispatch_w[:, None].to(ye.dtype)
    y = ye.new_zeros((T + 1, D)).index_add(0, dispatch_tok, contrib)[:T]

    if cfg.n_shared_experts:
        hs = F.silu(x @ params["shared_gate"]) * (x @ params["shared_up"])
        y = y + hs @ params["shared_down"]

    # GShard aux load-balance loss: E * Σ_e (fraction routed)·(mean prob)
    me = probs.mean(dim=0)  # [E]
    ce = torch.zeros((E,), dtype=torch.float32, device=x.device).index_add(
        0, expert_idx.reshape(-1), torch.ones(T * K, dtype=torch.float32, device=x.device)
    ) / (T * K)
    aux = E * torch.sum(me * ce)
    return y, {"load_balance_loss": aux}
