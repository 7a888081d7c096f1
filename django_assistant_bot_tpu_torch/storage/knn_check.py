"""Holding a top-k result to the plain twin: the check the card tests and
``chip_smoke.py`` run on :func:`~.knn.topk_scores`.  No serving path calls
it."""

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
    worst = (err / bound).max().item()
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
    own_worst = (torch.where(fin, (own - s).abs(), 0.0) / bound).max().item()
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
