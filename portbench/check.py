"""How ``correct`` is decided: the answers the timed path gave, against the
plain reference's exact scores of the same queries over the same corpus.

An answer is a query's top-``k`` (ids and scores: the serving cells,
every query served in the window) or a query's scores over the whole
corpus (the full-scan cells: the queries of the sampled batches, read
as their top-``k`` and the scores of sampled documents, and a few of
them as every document's score). Per answer entry, with ``s`` the
program's score, ``r`` the reference's score of the same document,
``kth`` the reference's k-th best and ``top`` its best score of that
query:

* ``score_err`` — ``|s − r| / top``, the widest over the entries: the
  decode and the dot of every returned row (and sampled document, and
  every document of a query read in full);
* ``rank_gap`` — ``max(kth − r, 0) / top``, the widest: a returned
  document below the exact k-th best (ties count as hits) — the top-k;
* ``bad_ids`` — entries with an id outside the corpus, an id twice in
  one answer, or a score that is not finite: an exact count.

A cell compares the numbers its limits file names (``limits/<cell>.json``)
and is correct when each is at most its limit. A query whose entries
break a limit counts as failed.
"""

from __future__ import annotations

import dataclasses

import torch

__all__ = ["Answers", "judge"]


@dataclasses.dataclass
class Answers:
    """The answers to judge: ``rows`` int64 [N] (the pool row of each
    answered query), ``ids`` int64 [N, k] and ``scores`` f32 [N, k] (its
    top-k), and for scan cells ``sample_docs`` int64 [S] with the program's
    ``sample_scores`` f32 [N, S], and ``full_scores`` f32 [F, n_docs]:
    every document's score for the answers at ``full_at`` int64 [F]."""

    rows: torch.Tensor
    ids: torch.Tensor
    scores: torch.Tensor
    sample_docs: torch.Tensor | None = None
    sample_scores: torch.Tensor | None = None
    full_at: torch.Tensor | None = None
    full_scores: torch.Tensor | None = None


def judge(ref, pool, ans: Answers, limits: dict) -> tuple[dict, dict]:
    """→ (the compared numbers, each ``{"value", "limit"}``; a summary:
    ``checked`` answers, ``failed`` answers)."""
    n, k = ans.ids.shape
    dev = ref.csr.device
    rows, ids, scores = ans.rows.to(dev), ans.ids.to(dev).long(), ans.scores.to(dev).double()
    bad = (ids < 0) | (ids >= ref.n_docs) | ~torch.isfinite(scores)
    srt = ids.sort(dim=1).values
    bad[:, 1:] |= srt[:, 1:] == srt[:, :-1]  # a repeated id marks its answer
    safe = ids.clamp(0, max(ref.n_docs - 1, 0))
    r_at = torch.zeros_like(scores)
    kth = torch.zeros(n, dtype=torch.float64, device=dev)
    top = torch.ones(n, dtype=torch.float64, device=dev)
    samp = None
    if ans.sample_docs is not None:
        sdocs = ans.sample_docs.to(dev).long()
        s_sc = ans.sample_scores.to(dev).double()
        samp = torch.zeros_like(s_sc)
        bad |= ~torch.isfinite(s_sc).all(dim=1, keepdim=True)
    if ans.full_scores is not None:
        f_at = ans.full_at.to(dev).long()
        f_err = torch.zeros(f_at.shape[0], dtype=torch.float64, device=dev)
    step = ref.block_rows
    for p0 in range(0, pool.n, step):
        p1 = min(p0 + step, pool.n)
        at = torch.nonzero((rows >= p0) & (rows < p1)).flatten()
        if at.numel() == 0:
            continue
        S = ref.scores(pool.dense(torch.arange(p0, p1, device=dev))).double()
        best = S.topk(min(k, ref.n_docs), dim=1).values
        local = rows[at] - p0
        kth[at] = best[local, -1]
        top[at] = best[local, 0].abs().clamp_min(torch.finfo(torch.float64).tiny)
        r_at[at] = S[local.unsqueeze(1), safe[at]]
        if samp is not None:
            samp[at] = S[local.unsqueeze(1), sdocs.unsqueeze(0)]
        if ans.full_scores is not None:
            fa = torch.nonzero((rows[f_at] >= p0) & (rows[f_at] < p1)).flatten()
            if fa.numel():
                a = f_at[fa]
                prog = ans.full_scores[fa.cpu()].to(dev).double()
                bad[a] |= ~torch.isfinite(prog).all(dim=1, keepdim=True)
                diff = (prog - S[rows[a] - p0]).abs().nan_to_num(0.0)
                f_err[fa] = diff.amax(dim=1) / top[a]
        del S
    err = ((scores - r_at).abs() / top.unsqueeze(1)).masked_fill(bad, 0.0)
    gap = ((kth.unsqueeze(1) - r_at).clamp_min(0) / top.unsqueeze(1)).masked_fill(bad, 0.0)
    q_err = err.amax(dim=1) if k else torch.zeros(n, dtype=torch.float64, device=dev)
    if samp is not None:
        s_err = ((s_sc - samp).abs() / top.unsqueeze(1)).nan_to_num(0.0)
        q_err = torch.maximum(q_err, s_err.amax(dim=1))
    if ans.full_scores is not None:
        q_err[f_at] = torch.maximum(q_err[f_at], f_err)
    numbers = {"score_err": q_err, "rank_gap": gap.amax(dim=1), "bad_ids": bad.sum(dim=1)}
    out, failed = {}, torch.zeros(n, dtype=torch.bool, device=dev)
    for name, limit in limits.items():
        per_query = numbers[name]
        failed |= per_query > limit
        if name == "bad_ids":
            value = int(per_query.sum())
        else:
            value = float(per_query.amax()) if n else 0.0
        out[name] = {"value": value, "limit": limit}
    return out, {"checked": n, "failed": int(failed.sum())}
