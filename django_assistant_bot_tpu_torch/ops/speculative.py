"""Tree-verified prompt-lookup speculative decoding (port of ``ops/speculative.py``).

The drafter emits the top-N distinct continuations of the current tail
bigram in each row's token history (deduplicated on their first token, most
recent first, one spare branch for the unigram) as a static token tree: a
root (the pending input token) plus N linear branches of depth K, flattened
into ``[B, T]`` (T = 1 + N*K) with a precomputed ancestor mask.  One verify
forward scores every node (``models.llama.verify_tree_step_paged``), and
:func:`accept_tree` takes the longest root-to-leaf path that matches the
model's own argmax, plus one bonus token.  Greedy rows (temperature <= 0)
accept drafts exactly; sampled rows take the position-0 draw, so mixed
batches share one program and greedy output equals non-speculative greedy
output.

Everything but :class:`SpecController` is tensor code without host reads,
so the engine captures a whole speculative tick as one CUDA graph.  The
position-0 draw goes through :func:`~.sampling.sample_logits` (the fused
sampler kernel on a CUDA tensor), fed pre-drawn Gumbel noise as the decode
tick feeds it.

:func:`build_tree_draft` gives the JAX function's ints bit for bit.  Its
dedup does not build the JAX function's ``[B, S, S]`` compare: the
candidates are sorted by (first token, position), and a candidate survives
iff the next one in that order proposes another first token, which is the
JAX rule (the most recent candidate of each first token is kept).

:class:`SpecController`, :func:`breakeven_accept_rate` and
:func:`default_rungs` are the JAX package's host-side code, copied.
"""

from __future__ import annotations

import dataclasses
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from .sampling import sample_logits


class TreeSpec(NamedTuple):
    """Static layout of one speculation tree: a root (flat index 0, the
    pending input token) plus ``width`` linear branches of ``depth`` draft
    tokens.  Node (n, d) lives at flat index ``1 + n*depth + d``.  Host
    numpy constants; the engine keeps device copies per rung."""

    width: int
    depth: int
    size: int  # T = 1 + width*depth flattened nodes
    depths: np.ndarray  # [T] int32 — node depth; root = 0
    parent: np.ndarray  # [T] int32 — flat parent index; root's parent = 0
    anc_mask: np.ndarray  # [T, T] bool — anc_mask[t, u]: u is ancestor-of-or t
    branch_nodes: np.ndarray  # [width, depth] int32 — flat ids, depth order


def make_tree_spec(width: int, depth: int) -> TreeSpec:
    """Precompute the flat layout + ancestor mask for an (N, K) tree."""
    width = max(1, int(width))
    depth = max(1, int(depth))
    T = 1 + width * depth
    depths = np.zeros((T,), np.int32)
    parent = np.zeros((T,), np.int32)
    branch_nodes = np.zeros((width, depth), np.int32)
    for n in range(width):
        for d in range(depth):
            t = 1 + n * depth + d
            branch_nodes[n, d] = t
            depths[t] = d + 1
            parent[t] = 0 if d == 0 else t - 1
    anc = np.zeros((T, T), bool)
    for t in range(T):
        u = t
        anc[t, t] = True
        while u != 0:
            u = parent[u]
            anc[t, u] = True
    return TreeSpec(width=width, depth=depth, size=T, depths=depths, parent=parent,
                    anc_mask=anc, branch_nodes=branch_nodes)


def build_tree_draft(
    history: torch.Tensor,  # [B, S] int token history rows
    lengths: torch.Tensor,  # [B] cache lengths; history[b, :lengths[b]] is valid
    tokens: torch.Tensor,  # [B] the pending input token (sequence pos lengths[b])
    width: int,
    depth: int,
) -> torch.Tensor:
    """Draft ``[B, width, depth]`` int32: the top-``width`` distinct
    continuations of the tail bigram ``(history[n-2], tokens)`` in each
    row's history, most recent first (the JAX function's candidates, dedup,
    unigram fallback and rejectable tail garbage for unfilled branches)."""
    B, S = history.shape
    dev = history.device
    hist = history.long()
    lengths = lengths.long()
    tokens = tokens.long()
    n = lengths + 1  # known sequence tokens incl. the pending input
    js = torch.arange(S - 1, device=dev)
    prev = torch.gather(hist, 1, (lengths - 1).clamp(min=0)[:, None])[:, 0]
    # bigram (prev, tokens) at (j, j+1), ending strictly before the tail bigram
    big = (hist[:, :-1] == prev[:, None]) & (hist[:, 1:] == tokens[:, None])
    big = big & ((js[None, :] + 1) < (n - 1)[:, None])
    # first continuation token of candidate j is history[j+2]
    first_tok = torch.gather(hist, 1, (js + 2).clamp(0, S - 1)[None, :].expand(B, S - 1))
    # dedup: candidate j survives iff no later candidate proposes the same
    # first token.  Sorted by (first token, position), each first token's
    # candidates are a run with the most recent last.
    none = torch.iinfo(torch.int64).max
    key = torch.where(big, first_tok * S + js[None, :], none)
    skey, order = torch.sort(key, dim=1)
    nxt = torch.cat([skey[:, 1:], torch.full((B, 1), none, dtype=torch.int64, device=dev)], 1)
    last_of_run = (skey != none) & ((nxt == none) | (nxt // S != skey // S))
    keep = torch.zeros_like(big).scatter_(1, order, last_of_run)
    # width most recent distinct candidates, by position (desc); -1 = none
    ranked = torch.where(keep, js[None, :], -1)
    top_pos = torch.topk(ranked, width, dim=1).values  # [B, width]
    n_big = (top_pos >= 0).sum(dim=1)  # [B] filled bigram branches
    # unigram fallback: last occurrence of `tokens` strictly before pos n-1
    jsf = torch.arange(S, device=dev)
    uni = (hist == tokens[:, None]) & (jsf[None, :] < (n - 1)[:, None])
    has1 = uni.any(dim=1)
    j1 = torch.where(uni, jsf[None, :], -1).amax(dim=1)
    bidx = torch.arange(width, device=dev)[None, :]
    starts = torch.where(
        top_pos >= 0,
        top_pos + 2,
        torch.where((bidx == n_big[:, None]) & has1[:, None], (j1 + 1)[:, None], n[:, None]),
    )  # [B, width]
    idx = (starts[:, :, None] + torch.arange(depth, device=dev)[None, None, :]).clamp(0, S - 1)
    draft = torch.gather(history[:, None, :].expand(B, width, S), 2, idx)
    return draft.to(torch.int32)


def flatten_tree(tokens: torch.Tensor, draft: torch.Tensor) -> torch.Tensor:
    """[B] input tokens + [B, N, K] branch drafts -> flat tree [B, T] int32."""
    B = tokens.shape[0]
    return torch.cat([tokens.to(torch.int32)[:, None], draft.reshape(B, -1).to(torch.int32)], 1)


def accept_tree(
    logits: torch.Tensor,  # [B, T, V] f32 — verify logits over the flat tree
    tree: torch.Tensor,  # [B, T] int flat tree tokens (col 0 = input token)
    spec: TreeSpec,
    *,
    temperature: torch.Tensor,  # [B]
    top_k: int,
    top_p: torch.Tensor,  # [B]
    gumbel: Optional[torch.Tensor] = None,  # [B, noise width] pre-drawn noise
    generator: Optional[torch.Generator] = None,
    branch: Optional[torch.Tensor] = None,  # [N, K] device copy of spec.branch_nodes
):
    """Longest root-to-leaf acceptance + one bonus/corrected token per row.

    Returns ``(out [B, K+1], n_new [B] in [1, K+1], bonus [B], path_idx
    [B, K+1])``, int32 (the JAX function's outputs but the key): ``out[b,
    :n_new[b]]`` are the new tokens, ``bonus`` the next input token and
    ``path_idx`` the flat tree ids whose K/V the caller commits (root, then
    the winning branch).  A branch node is accepted iff the argmax at its
    parent equals its token and every shallower node of the branch was
    accepted; the longest run wins (ties: the lowest branch).  Sampled rows
    accept nothing and take the position-0 draw."""
    B, T, _ = logits.shape
    N, K = spec.width, spec.depth
    dev = logits.device
    if branch is None:
        branch = torch.as_tensor(spec.branch_nodes, dtype=torch.long, device=dev)
    greedy_next = torch.argmax(logits, dim=-1).to(torch.int32)  # [B, T]
    samp0 = sample_logits(logits[:, 0].contiguous(), temperature=temperature, top_k=top_k,
                          top_p=top_p, gumbel=gumbel, generator=generator)
    greedy_row = temperature <= 0.0
    tree = tree.to(torch.int32)
    # node (n, d)'s parent is the root for d = 0, else node (n, d - 1)
    parent_idx = torch.cat([torch.zeros((N, 1), dtype=torch.long, device=dev), branch[:, :-1]], 1)
    pred = greedy_next[:, parent_idx.reshape(-1)].reshape(B, N, K)
    tok = tree[:, branch.reshape(-1)].reshape(B, N, K)
    match = (tok == pred) & greedy_row[:, None, None]
    acc = torch.cumprod(match.to(torch.int32), dim=2).sum(dim=2)  # [B, N]
    best = torch.argmax(acc, dim=1)  # [B] first max wins
    n_acc = torch.gather(acc, 1, best[:, None])[:, 0]  # [B]
    win_nodes = branch[best]  # [B, K]
    last_idx = torch.where(
        n_acc > 0, torch.gather(win_nodes, 1, (n_acc - 1).clamp(min=0)[:, None])[:, 0], 0
    )
    bonus_greedy = torch.gather(greedy_next, 1, last_idx[:, None])[:, 0]
    bonus = torch.where(greedy_row, bonus_greedy, samp0.to(torch.int32))
    win_toks = torch.gather(tree, 1, win_nodes)  # [B, K]
    js = torch.arange(K + 1, device=dev)[None, :]
    accepted = torch.cat([win_toks, torch.zeros((B, 1), dtype=torch.int32, device=dev)], 1)
    out = torch.where(js < n_acc[:, None], accepted,
                      torch.where(js == n_acc[:, None], bonus[:, None], 0)).to(torch.int32)
    path_idx = torch.cat([torch.zeros((B, 1), dtype=torch.long, device=dev), win_nodes], 1)
    return out, (n_acc + 1).to(torch.int32), bonus.to(torch.int32), path_idx.to(torch.int32)


# Host-side pieces, copied from the JAX package ----------------------------


def build_prompt_lookup_draft(
    history: torch.Tensor,
    lengths: torch.Tensor,
    tokens: torch.Tensor,
    k: int,
) -> torch.Tensor:
    """Single-candidate prompt-lookup draft [B, k] — the width-1 tree."""
    return build_tree_draft(history, lengths, tokens, 1, k)[:, 0]


def breakeven_accept_rate(cost_ratio: float, depth: int) -> float:
    """Per-position accept probability ``p`` at which a (·, depth) verify
    tick exactly pays for itself against a plain decode tick that costs
    ``1/cost_ratio`` as much: solves E[tokens/tick] = (1 - p^(K+1))/(1 - p)
    = cost_ratio by bisection.  cost_ratio <= 1 means speculation is free
    (breakeven 0); an unreachable ratio (> K+1 tokens/tick) returns 1.0.
    """
    K = max(1, int(depth))
    r = float(cost_ratio)
    if r <= 1.0:
        return 0.0
    if r >= K + 1:
        return 1.0

    def expected(p: float) -> float:
        if p >= 1.0:
            return K + 1.0
        return (1.0 - p ** (K + 1)) / (1.0 - p)

    lo, hi = 0.0, 1.0
    for _ in range(60):
        mid = (lo + hi) / 2.0
        if expected(mid) < r:
            lo = mid
        else:
            hi = mid
    return (lo + hi) / 2.0


def default_rungs(width: int, depth: int) -> List[Tuple[int, int]]:
    """The controller's shrink ladder: full tree -> half width -> single
    branch -> half depth.  Deduplicated, widest first."""
    rungs: List[Tuple[int, int]] = []
    for w, k in (
        (width, depth),
        (max(1, width // 2), depth),
        (1, depth),
        (1, max(1, depth // 2)),
    ):
        if (w, k) not in rungs:
            rungs.append((w, k))
    return rungs


@dataclasses.dataclass
class SpecController:
    """Per-rung acceptance-EMA bandit over a ladder of tree shapes (the JAX
    controller).  Each rung keeps its own per-position accept-probability
    EMA ``p[rung]``, measured only from ticks that rung ran, initialised
    optimistically; per tick the controller compares each rung's expected
    speedup ``E[tokens/tick] / cost_ratio(rung)`` with ``E = (1 -
    p^(K+1))/(1 - p)`` (cost ratios measured by the engine: verify-tick
    seconds / plain-tick seconds), runs the best rung with a periodic
    exploration tick on the next-wider one, disables speculation below
    ``margin`` and re-probes every ``probe_every`` ticks while disabled.
    The engine checks the scheduler's under-load disable first."""

    rungs: List[Tuple[int, int]]  # (width, depth) ladder, widest first
    alpha: float = 0.15  # acceptance EMA smoothing
    margin: float = 1.0  # minimum expected speedup to keep speculating
    probe_every: int = 64  # disabled-state re-probe cadence (ticks)
    explore_every: int = 32  # enabled-state wider-rung refresh cadence
    init_accept: float = 0.5  # optimistic prior: start speculating
    accept_ema: dict = dataclasses.field(default_factory=dict)  # rung -> p
    cost_ratio: dict = dataclasses.field(default_factory=dict)
    disabled: bool = False
    _ticks_since_probe: int = 0
    _ticks_since_explore: int = 0

    def __post_init__(self):
        if not self.rungs:
            raise ValueError("SpecController needs at least one rung")
        self.rungs = [tuple(r) for r in self.rungs]
        for rung in self.rungs:
            self.accept_ema.setdefault(rung, float(self.init_accept))
        self._rung_idx = 0

    # ---------------------------------------------------------------- inputs
    def note_cost(self, rung: Tuple[int, int], ratio: float) -> None:
        """Record a measured verify/plain tick-cost ratio for ``rung``."""
        self.cost_ratio[tuple(rung)] = max(1.0, float(ratio))

    def note_tick(
        self,
        accepted: int,
        depth: int,
        rows: int = 1,
        rung: Optional[Tuple[int, int]] = None,
    ) -> None:
        """Fold one speculative tick's greedy-row acceptance into ``rung``'s
        EMA: ``accepted`` drafts accepted out of ``depth`` offered, over
        ``rows`` greedy rows (rows==0 ticks carry no signal and are
        ignored).  ``rung=None`` resolves to the deepest ladder entry of
        that depth."""
        if rows <= 0 or depth <= 0:
            return
        if rung is None:
            rung = next((r for r in self.rungs if r[1] == depth), self.rungs[0])
        rung = tuple(rung)
        rate = min(1.0, max(0.0, accepted / (rows * depth)))
        prev = self.accept_ema.get(rung, float(self.init_accept))
        self.accept_ema[rung] = (1 - self.alpha) * prev + self.alpha * rate

    # ---------------------------------------------------------------- policy
    def _cost(self, rung: Tuple[int, int]) -> float:
        got = self.cost_ratio.get(tuple(rung))
        if got is not None:
            return got
        # unmeasured default: each extra verified position costs a fraction
        # of a plain tick — a conservative stand-in until the engine feeds a
        # measurement
        w, k = rung
        return 1.0 + 0.15 * (1 + w * k - 1)

    def expected_tokens(self, rung: Tuple[int, int]) -> float:
        p = min(self.accept_ema.get(tuple(rung), self.init_accept), 0.999999)
        k = rung[1]
        return (1.0 - p ** (k + 1)) / (1.0 - p)

    def expected_speedup(self, rung: Tuple[int, int]) -> float:
        return self.expected_tokens(rung) / self._cost(rung)

    def best_rung(self) -> Tuple[int, Tuple[int, int], float]:
        """(index, rung, expected speedup) of the best rung right now."""
        best_i, best_s = 0, -1.0
        for i, rung in enumerate(self.rungs):
            s = self.expected_speedup(rung)
            if s > best_s:
                best_i, best_s = i, s
        return best_i, self.rungs[best_i], best_s

    def rung(self) -> Optional[Tuple[int, int]]:
        """The tree shape to issue THIS tick, or None for a plain tick.
        Call exactly once per issued tick."""
        i, rung, speedup = self.best_rung()
        if not self.disabled:
            if speedup < self.margin:
                self.disabled = True
                self._ticks_since_probe = 0
                return None
            self._ticks_since_explore += 1
            if i > 0 and self._ticks_since_explore >= self.explore_every:
                self._ticks_since_explore = 0
                self._rung_idx = i - 1
                return self.rungs[i - 1]
            self._rung_idx = i
            return rung
        self._ticks_since_probe += 1
        if self._ticks_since_probe >= self.probe_every:
            self._ticks_since_probe = 0
            self._rung_idx = i
            return rung
        if speedup >= self.margin:
            self.disabled = False
            self._rung_idx = i
            return rung
        return None

    def current(self) -> Tuple[int, int]:
        """The rung most recently issued (for stats/gauges)."""
        return self.rungs[self._rung_idx]

    def stats(self) -> dict:
        w, k = self.current()
        i, rung, speedup = self.best_rung()
        return {
            "spec_accept_ema": round(self.accept_ema.get((w, k), self.init_accept), 4),
            "spec_tree_width": w,
            "spec_tree_depth": k,
            "spec_auto_disabled": self.disabled,
            "spec_expected_speedup": round(speedup, 3),
            "spec_rung_accept_emas": {
                f"{rw}x{rk}": round(p, 4) for (rw, rk), p in sorted(self.accept_ema.items())
            },
        }
