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
   probabilities, in one fixed order: each token keeps its ≤ ``top_k``
   slots in a ``[T, top_k]`` slot map (ascending; a dropped pair points
   at a zero row), its weighted outputs are gathered ``[T, top_k, D]``
   and added one term after another from zero in f32, then rounded once
   to the activations' dtype — what the reference's scatter-add
   (``index_add`` on the CPU) does, so the sums are the same bits on the
   CPU and on the card, where an ``index_add`` would add by atomics in an
   order that changes from run to run. The backward reads each slot's
   gradient from its one token (``_Combine``), and the dispatch's
   backward sums a token's ≤ ``top_k`` slot gradients in the same slot
   order (``_Dispatch``): no scatter has two writers, so a step is
   deterministic without ``torch.use_deterministic_algorithms``.

Optional shared experts (DeepSeek/Kimi style) process every token
densely. ``jit_weight_gather`` is the reference's sharding hint, which
selects nothing here.

**Placed** (``moe_apply(..., pl=)``, ``models.transformer.LMPlacement``):
the experts split over ``model`` (expert parallel) and their ``d_model``
dimension over the data axes (FSDP, gathered before use). The layer
routes, caps and balances the GLOBAL batch as the reference's jit does:
the data ranks exchange their per-expert pair counts (``[E]`` ints a
rank), so a rank knows how many pairs of each expert come before its
own in global token order (the batch's row blocks by data rank), keeps
a pair while that offset plus its rank within the expert is below the
capacity of the global ``T``, and takes the global counts and the mean
router probability over the data axes for the load-balance loss. A
data rank computes its own tokens' kept pairs for the model rank's
experts, so no token row crosses the data axes and no ``[T_global, D]``
is formed: a local expert has ``min(C, T_local)`` slots. The partial
outputs (and the shared experts', column- and row-parallel) are summed
over ``model`` once. Within a rank the combine keeps the slot order
above; across model ranks the all-reduce sums the experts' partial
outputs in another order than one process, a rounding-level difference.
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
    tok, w, _ = _dispatch_slots(expert_idx, gate_w, cfg)
    return tok, w


def _dispatch_slots(expert_idx, gate_w, cfg: MoEConfig, *, capacity: int | None = None,
                    slots: int | None = None, offset=None, experts: tuple[int, int] | None = None):
    """``_dispatch`` and the ``[T, K]`` slot map (each token's slots in
    ascending order; ``E_l·slots`` for a pair not held). Placed: an
    expert's pairs before this rank's are ``offset`` [E] (kept while
    ``offset + rank < capacity``), the rank holds experts ``[e0, e1)``
    with ``slots`` slots each."""
    T, K = expert_idx.shape
    E = cfg.n_experts
    C = _capacity(T, cfg) if capacity is None else capacity
    slots = C if slots is None else slots
    e0, e1 = (0, E) if experts is None else experts
    n = (e1 - e0) * slots
    dev = expert_idx.device
    flat_e = expert_idx.reshape(-1)  # [T*K]
    flat_t = torch.arange(T, device=dev).repeat_interleave(K)
    flat_w = gate_w.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    se, st, sw = flat_e[order], flat_t[order], flat_w[order]
    starts = torch.searchsorted(se, torch.arange(E, device=dev, dtype=se.dtype))  # [E]
    rank = torch.arange(T * K, device=dev) - starts[se]
    held = rank < C if offset is None else offset[se] + rank < C
    if experts is not None:
        held = held & (se >= e0) & (se < e1)
    slot = torch.where(held, (se - e0) * slots + rank, n)  # drop → sentinel
    dispatch_tok = torch.full((n + 1,), T, dtype=torch.int64, device=dev).index_put(
        (slot,), st)
    dispatch_w = torch.zeros((n + 1,), dtype=torch.float32, device=dev).index_put(
        (slot,), sw.float())
    slot_map = torch.empty_like(slot).index_put((order,), slot).reshape(T, K)
    return dispatch_tok[:n], dispatch_w[:n], torch.sort(slot_map, dim=-1).values


def _sum_slots(rows: torch.Tensor, slot_map: torch.Tensor, acc_dtype=None) -> torch.Tensor:
    """``Σ_k rows[slot_map[:, k]]`` added one term after another from zero
    in ``acc_dtype`` (default ``rows``'), then cast to ``rows``' dtype
    (``rows`` [n, D] with a zero row appended for the sentinel ``n``)."""
    terms = torch.cat([rows, rows.new_zeros((1, rows.shape[1]))])[slot_map]  # [T, K, D]
    out = torch.zeros(terms[:, 0].shape, dtype=acc_dtype or rows.dtype, device=rows.device)
    for k in range(slot_map.shape[1]):
        out = out + terms[:, k].to(out.dtype)
    return out.to(rows.dtype)


def _take_rows(x: torch.Tensor, tok: torch.Tensor) -> torch.Tensor:
    """``x`` [T, D] rows at ``tok`` (``T``: a zero row)."""
    return torch.cat([x, x.new_zeros((1, x.shape[1]))])[tok]


class _Combine(torch.autograd.Function):
    """contrib [n, D] (slot outputs, weighted) → y [T, D]: each token's
    slots added in ascending slot order in f32, rounded once (the CPU's
    ``index_add`` accumulates a reduced-precision row so); the backward
    reads a slot's gradient from its token (one reader a slot)."""

    @staticmethod
    def forward(ctx, contrib, slot_map, dispatch_tok):
        ctx.save_for_backward(dispatch_tok)
        return _sum_slots(contrib, slot_map, torch.float32)

    @staticmethod
    def backward(ctx, g):
        (dispatch_tok,) = ctx.saved_tensors
        return _take_rows(g, dispatch_tok), None, None


class _Dispatch(torch.autograd.Function):
    """x [T, D] → the slots' rows [n, D] (empty slots zero); the backward
    sums a token's slot gradients in ascending slot order, rounding each
    add (the CPU's accumulating ``index_put_``, the gather's backward)."""

    @staticmethod
    def forward(ctx, x, dispatch_tok, slot_map):
        ctx.save_for_backward(slot_map)
        return _take_rows(x, dispatch_tok)

    @staticmethod
    def backward(ctx, g):
        (slot_map,) = ctx.saved_tensors
        return _sum_slots(g, slot_map), None, None


def _swiglu(xe, w_gate, w_up, w_down):
    h = F.silu(torch.einsum("ecd,edf->ecf", xe, w_gate)) * torch.einsum(
        "ecd,edf->ecf", xe, w_up)
    return torch.einsum("ecf,efd->ecd", h, w_down)  # [E, C, D]


def moe_apply(params, cfg: MoEConfig, x: torch.Tensor, pl=None):
    """x [T, D] → (y [T, D], aux) with aux = load-balancing loss terms;
    ``pl`` (an ``LMPlacement``) runs the placed layer on the rank's
    blocks."""
    if pl is not None:
        return _moe_placed(params, cfg, x, pl)
    T, D = x.shape
    E, K = cfg.n_experts, cfg.top_k
    C = _capacity(T, cfg)

    probs, gate_w, expert_idx = _route(params, cfg, x)
    dispatch_tok, dispatch_w, slot_map = _dispatch_slots(expert_idx, gate_w, cfg)

    # ---- expert compute: batched SwiGLU over [E, C, D] -----------------
    xe = _Dispatch.apply(x, dispatch_tok, slot_map).reshape(E, C, D)
    ye = _swiglu(xe, params["w_gate"], params["w_up"], params["w_down"])

    # ---- combine: each token's slots in ascending slot order ------------
    contrib = ye.reshape(E * C, D) * dispatch_w[:, None].to(ye.dtype)
    y = _Combine.apply(contrib, slot_map, dispatch_tok)

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


def _moe_placed(params, cfg: MoEConfig, x: torch.Tensor, pl):
    """The placed layer (module docstring) on the rank's tokens ``x`` [T_l,
    D], replicated over ``model``."""
    from ..dist.placed import all_gather_axes, copy_to_model, mean_over_data, reduce_from_model
    from ..dist.sharding import axis_index

    T, D = x.shape
    E, K = cfg.n_experts, cfg.top_k
    mesh = pl.mesh
    probs, gate_w, expert_idx = _route(params, cfg, x)
    counts = torch.zeros((E,), dtype=torch.int64, device=x.device).index_add(
        0, expert_idx.reshape(-1), torch.ones(T * K, dtype=torch.int64, device=x.device))
    da = pl.da if pl.batch_split else ()
    if da:  # every data rank's counts, in global token order
        every = all_gather_axes(counts[None], mesh, da, 0)  # [n_data, E]
        d = axis_index(mesh, da)
        offset, total, T_glob = every[:d].sum(0), every.sum(0), T * every.shape[0]
    else:
        offset, total, T_glob = torch.zeros_like(counts), counts, T
    C = _capacity(T_glob, cfg)
    slots = min(C, T)  # a token routes to an expert at most once
    split = pl.split("moe/w_gate", 0)
    E_l = params["w_gate"].shape[0]
    e0 = axis_index(mesh, "model") * E_l if split else 0
    dispatch_tok, dispatch_w, slot_map = _dispatch_slots(
        expert_idx, copy_to_model(gate_w, mesh) if split else gate_w, cfg, capacity=C,
        slots=slots, offset=offset, experts=(e0, e0 + E_l))
    xin = copy_to_model(x, mesh) if split else x
    xe = _Dispatch.apply(xin, dispatch_tok, slot_map).reshape(E_l, slots, D)
    ye = _swiglu(xe, pl.w(params["w_gate"], "moe/w_gate"), pl.w(params["w_up"], "moe/w_up"),
                 pl.w(params["w_down"], "moe/w_down"))
    contrib = ye.reshape(E_l * slots, D) * dispatch_w[:, None].to(ye.dtype)
    routed = _Combine.apply(contrib, slot_map, dispatch_tok)
    partial, whole = ([routed], []) if split else ([], [routed])
    if cfg.n_shared_experts:
        s_split = pl.split("moe/shared_gate", 1)
        xs = copy_to_model(x, mesh) if s_split else x
        hs = F.silu(xs @ pl.w(params["shared_gate"], "moe/shared_gate")) * (
            xs @ pl.w(params["shared_up"], "moe/shared_up"))
        (partial if s_split else whole).append(hs @ pl.w(params["shared_down"],
                                                           "moe/shared_down"))
    y = reduce_from_model(sum(partial[1:], partial[0]), mesh) if partial else None
    for t in whole:
        y = t if y is None else y + t
    me = mean_over_data(probs.mean(dim=0), mesh, da)  # [E]
    ce = total.float() / (T_glob * K)
    aux = E * torch.sum(me * ce)
    return y, {"load_balance_loss": aux}
