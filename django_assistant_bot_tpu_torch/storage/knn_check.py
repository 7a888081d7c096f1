"""Holding a top-k result to the plain twin: the checks the card tests and
``chip_smoke.py`` run on :func:`~.knn.topk_scores` and on the ANN rerank
(:func:`~.ann.rerank`).  No serving path calls them."""

from __future__ import annotations

import torch

from .knn import topk_scores_plain


def topk_score_bound(queries: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """Per query, how far two f32 summation orders of the same bf16
    products can put a score apart: ``D 2^-22 |q| max_n |x_n|`` (each order
    is within ``(D - 1) u sum |q_d x_nd|`` of the exact sum, u = 2^-24,
    doubled for an accumulator that truncates, and ``sum |q_d x_nd| <= |q|
    |x_n|``).  It holds the kernel's scores to the plain twin's."""
    D = index.shape[1]
    qn = torch.linalg.vector_norm(queries.to(torch.bfloat16).float(), dim=-1)
    xn = torch.linalg.vector_norm(index.float(), dim=-1).max()
    return D * 2.0 ** -22 * qn * xn


def _over(err: torch.Tensor, bound: torch.Tensor) -> float:
    """The largest ``err / bound``: 0 where the error is 0 (a zero query
    has a zero bound), inf where a zero bound meets an error."""
    return torch.where(err == 0, 0.0, err / bound).max().item()


def topk_agreement(
    index: torch.Tensor, queries: torch.Tensor, valid: torch.Tensor,
    scores: torch.Tensor, ids: torch.Tensor,
) -> dict:
    """Hold a top-k result ``(scores, ids)`` ``[Q, k]`` of these inputs to
    :func:`topk_scores_plain`, at :func:`topk_score_bound`:

    - the same finite slots (the valid-row count, or k);
    - every score within the bound of the twin's score at the same rank;
    - every returned id valid and distinct within its query, and its own
      score (recomputed from the bf16 inputs in f32) within the bound of the
      score returned beside it;
    - the id equal to the twin's at every rank whose twin score lies more
      than twice the bound from both neighbours (the rank after k included).

    Returns ``max_abs_err``, ``worst`` (the largest error over its bound),
    ``ids_compared`` and ``problems`` (empty when the result agrees)."""
    Q, k = scores.shape
    N = index.shape[0]
    kk = min(k + 1, N)
    ref_s, ref_i = topk_scores_plain(index, queries, valid, kk)
    bound = topk_score_bound(queries, index)[:, None]
    s = scores.float()
    fin = torch.isfinite(s)
    ref_k = ref_s[:, :k]
    problems = []
    if not torch.equal(fin, torch.isfinite(ref_k)):
        problems.append("finite slots differ from the twin's")
    both = fin & torch.isfinite(ref_k)
    err = torch.where(both, (s - ref_k).abs(), 0.0)
    worst = _over(err, bound)
    if worst > 1:
        problems.append(f"scores off the twin's by {worst:.3f} x the bound")
    idl = ids.long()
    if bool(((idl < 0) | (idl >= N))[fin].any()):
        problems.append("ids out of range")
    idl = idl.clamp(0, N - 1)
    if not bool(valid[idl][fin].all()):
        problems.append("an id of a masked row")
    for qi in range(Q):
        live = idl[qi][fin[qi]]
        if torch.unique(live).numel() != live.numel():
            problems.append(f"query {qi}: repeated ids")
            break
    own = torch.einsum("qd,qkd->qk", queries.to(torch.bfloat16).float(), index[idl].float())
    own_worst = _over(torch.where(fin, (own - s).abs(), 0.0), bound)
    if own_worst > 1:
        problems.append(f"a score off its own row's by {own_worst:.3f} x the bound")
    worst = max(worst, own_worst)
    inf = torch.full((Q, 1), float("inf"), dtype=ref_s.dtype, device=ref_s.device)
    padded = torch.cat([inf, ref_s, -inf], dim=1)  # ranks -1 .. kk
    gap = torch.minimum(padded[:, :k] - padded[:, 1 : k + 1], padded[:, 1 : k + 1] - padded[:, 2 : k + 2])
    sep = torch.isfinite(ref_k) & (gap > 2 * bound)
    if bool((sep & (ids.long() != ref_i[:, :k].long())).any()):
        problems.append("ids differ from the twin's at separated ranks")
    return {"max_abs_err": err.max().item(), "worst": worst,
            "ids_compared": int(sep.sum()), "problems": problems}


def rerank_agreement(
    tier: torch.Tensor, rvalid: torch.Tensor, queries: torch.Tensor,
    sl_scores: torch.Tensor, sl_pos: torch.Tensor, scores: torch.Tensor, pos: torch.Tensor,
) -> dict:
    """Hold a rerank result ``(scores, pos)`` ``[Q, k]`` of these inputs to
    :func:`~.ann.rerank_plain` by :func:`topk_agreement`'s rules, at
    :func:`topk_score_bound` over the tier: the same finite slots, every
    score within the bound of the twin's at the same rank, every returned
    position's own score within the bound of the score beside it, and the
    position equal to the twin's at every rank whose twin score lies more
    than twice the bound from both neighbours (the rank after k included).
    Returns ``max_abs_err``, ``worst``, ``ids_compared`` and ``problems``."""
    from .ann import rerank_plain

    Q, k = scores.shape
    kk = min(k + 1, sl_pos.shape[1])
    ref_s, ref_p = rerank_plain(tier, rvalid, queries, sl_scores, sl_pos, kk)
    bound = topk_score_bound(queries, tier)[:, None]
    s = scores.float()
    fin = torch.isfinite(s)
    ref_k = ref_s[:, :k]
    problems = []
    if not torch.equal(fin, torch.isfinite(ref_k)):
        problems.append("finite slots differ from the twin's")
    err = torch.where(fin & torch.isfinite(ref_k), (s - ref_k).abs(), 0.0)
    worst = _over(err, bound)
    if worst > 1:
        problems.append(f"scores off the twin's by {worst:.3f} x the bound")
    p = pos.long().clamp(0, tier.shape[0] - 1)
    own = torch.einsum("qd,qkd->qk", queries.to(torch.bfloat16).float(), tier[p].float())
    own_worst = _over(torch.where(fin, (own - s).abs(), 0.0), bound)
    if own_worst > 1:
        problems.append(f"a score off its own row's by {own_worst:.3f} x the bound")
    if not bool(rvalid[p][fin].all()):
        problems.append("a position of a masked row")
    worst = max(worst, own_worst)
    inf = torch.full((Q, 1), float("inf"), dtype=ref_s.dtype, device=ref_s.device)
    padded = torch.cat([inf, ref_s, -inf], dim=1)
    gap = torch.minimum(padded[:, :k] - padded[:, 1 : k + 1],
                        padded[:, 1 : k + 1] - padded[:, 2 : k + 2])
    sep = torch.isfinite(ref_k) & (gap > 2 * bound)
    if bool((sep & (pos.long() != ref_p[:, :k].long())).any()):
        problems.append("positions differ from the twin's at separated ranks")
    return {"max_abs_err": err.max().item(), "worst": worst,
            "ids_compared": int(sep.sum()), "problems": problems}
