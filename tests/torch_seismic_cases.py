"""C3's measurement of Seismic's phase 1 against the reference, shared by
``tests/test_torch_seismic_bounds.py`` and ``tools/torch_seismic_bounds.py``:
the reference's phase 1, the f32 rounding bound of a summary bound, and
the probed-set disagreements with their gaps to the cut."""

import numpy as np
import torch


def reference_phase1(arrays, Q, params: dict, chunk: int = 64):
    """The reference's phase 1 (``repro/serve/engines/seismic.py::
    search_one``, its lines up to the probe), vmapped and jitted as its
    search runs them, ``chunk`` queries a call → (est, cand, probed
    blocks) as numpy. Imports jax."""
    import jax
    import jax.numpy as jnp

    cut, budget, n_probe = params["cut"], params["block_budget"], params["n_probe"]

    def one(q):
        qv, qc = jax.lax.top_k(jnp.abs(q), cut)
        starts = arrays["cbs"][qc]
        lens = jnp.where(qv > 0, arrays["cbl"][qc], 0)
        offs = jnp.arange(budget // cut)[None, :]
        cand = jnp.where(offs < lens[:, None], starts[:, None] + offs, -1).reshape(-1)
        sc = jnp.take(arrays["sum_comps"], jnp.maximum(cand, 0), axis=0)
        sv = jnp.take(arrays["sum_vals"], jnp.maximum(cand, 0), axis=0)
        est = jnp.where(cand >= 0, (jnp.take(q, sc, axis=0) * sv).sum(-1), -jnp.inf)
        _, probe = jax.lax.top_k(est, n_probe)
        return est, cand, jnp.take(cand, probe)

    run = jax.jit(jax.vmap(one))
    parts = [run(jnp.asarray(Q[i : i + chunk])) for i in range(0, len(Q), chunk)]
    return tuple(np.concatenate([np.asarray(p[k]) for p in parts]) for k in range(3))


def bound_tolerance(arrays, Q, cand):
    """The f32 rounding bound of each summary bound of the port's
    ``SeismicEngine.probe``: ``s_max · eps · Σ_j |q_j · sv_j|`` over the
    block's summary, for the blocks ``cand`` i32 [nq, budget] (-1: none,
    bound 0) → f32 [nq, budget]. Two sums of the same products in any two
    orders differ by at most twice this."""
    nq = Q.shape[0]
    blk = cand.clamp_min(0).long()
    sc = arrays["sum_comps"][blk]
    sv = arrays["sum_vals"][blk]
    qs = torch.gather(Q, 1, sc.reshape(nq, -1).long()).reshape(sc.shape)
    mass = (qs * sv).abs().sum(-1)
    tol = sc.shape[-1] * torch.finfo(torch.float32).eps * mass
    return torch.where(cand >= 0, tol, 0.0)


def probe_disagreements(est_a, probe_a, est_b, probe_b, cand, tol) -> list[dict]:
    """The queries whose probed block sets differ between two phase-1 runs
    over the same candidates (``est_*`` f32 and ``cand`` i32 [nq, budget],
    ``probe_*`` i32 [nq, n_probe], ``tol`` from :func:`bound_tolerance`;
    numpy) → one record per such query: the blocks only one side probed,
    and for each its bound's gap to that side's cut (its ``n_probe``-th
    largest bound) over the tie rule's limit ``2 · (tol(b) + max tol of
    the query)``. A block probed by one side only is a near tie when this
    ratio is at most 1 on both sides: where every bound is within its tol
    of the exact sum, no other block can cross a cut."""
    out = []
    n_probe = probe_a.shape[1]
    for i in range(cand.shape[0]):
        a, b = set(probe_a[i].tolist()), set(probe_b[i].tolist())
        if a == b:
            continue
        pos = {int(c): j for j, c in enumerate(cand[i].tolist())}
        limit_q = float(tol[i].max())
        ratios = []
        for blk in sorted(a ^ b):
            j = pos[blk]
            r = 0.0
            for est in (est_a[i], est_b[i]):
                cut = float(np.sort(est)[::-1][n_probe - 1])
                r = max(r, abs(float(est[j]) - cut) / (2 * (float(tol[i, j]) + limit_q)))
            ratios.append(r)
        out.append({"query": i, "only_a": sorted(a - b), "only_b": sorted(b - a),
                    "max_ratio": max(ratios)})
    return out
