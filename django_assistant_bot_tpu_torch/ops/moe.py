"""Mixtral MoE routing, grouped expert GEMM and combine: the four steps of the
JAX ``models/mixtral.py`` ``moe_mlp`` as wrappers of the Hopper kernels
(``csrc/moe_route.cu``, ``csrc/moe_gemm.cu``), each beside its plain twin.

A wrapper given CPU tensors runs its twin; given CUDA tensors it launches
its kernel or raises (no fallback).  The JAX function's dense one-hot
dispatch ``[T, X, C]`` becomes indices:

- :func:`moe_route` -> ``tok_slot [T, K]`` int32 (``expert * C + position``,
  -1 where the choice was dropped), ``tok_gate [T, K]`` f32, ``slot_tok [X,
  C]`` int32 (the token in each slot, -1 when empty) and ``fill [X]`` int32
  (slots used, ``min(count, C)``).  The JAX routing, in its order: f32
  logits, softmax, top-K on the probabilities with equal values to the
  lower expert (``lax.top_k``), the gates renormalised over the top K
  *before* any drop (``g / max(sum g, 1e-9)``: a token that loses a choice
  keeps the other choice's gate as it is), then the capacity positions,
  every token's first choice in token order before any second choice
  (the JAX code's ``counts`` carry), kept iff ``position < C``.
- :func:`moe_expert_gemm` -> ``h [X, C, F] = silu(r(A . Wg)) * r(A . Wu)``
  (``epilogue="gate_up"``, A's rows gathered from x through ``slot_tok``)
  or ``ye [X, C, E] = r(h . Wd)`` (``"down"``), ``r`` the model dtype's
  rounding at the JAX einsums' outputs, the activation and the product
  rounded as the dense MLP rounds them.  Only rows ``c < fill[x]`` are
  defined: the kernel neither reads the weights of nor writes a tile
  without slots, and nothing reads those rows.
- :func:`moe_combine` -> ``out [T, E]``: ``sum_k r(g_k) * ye[slot_k]`` in
  f32, the K terms left to right, a dropped choice adding nothing, rounded
  once (the JAX ``combine.astype(cfg.dtype)`` einsum).  The kernel equals
  the twin bit for bit.

:func:`route_margin` flags the tokens whose routing can flip between two
summation orders of the router product (for ``chip_smoke.py`` and the
tests), and :func:`moe_gemm_bf16_bound` is the per-element bound a bf16
expert GEMM output is held to against its f32 reference.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

# route_margin's default: top-(K+1) probabilities closer than this may order
# differently under another summation order of the f32 router product (its
# error at E = 4,096 is ~1e-6 of a logit, ~1e-7 of a probability)
ROUTE_EPS = 1e-5
MAX_EXPERTS = 32  # the routing kernel's lanes (an expert a lane in the top-k)
MAX_TOP_K = 8

Routing = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def _on_card(*tensors: torch.Tensor) -> bool:
    """True for CUDA tensors (the kernel), False for CPU ones (the twin);
    anything else, or a mix, raises."""
    kinds = {t.device.type for t in tensors}
    if kinds == {"cpu"}:
        return False
    if kinds == {"cuda"} and len({t.device for t in tensors}) == 1:
        return True
    raise ValueError(f"MoE ops take tensors on one CUDA card or all on the CPU, got {kinds}")


def _kernel_dtype(*tensors: torch.Tensor) -> None:
    dtypes = {t.dtype for t in tensors}
    if len(dtypes) != 1 or dtypes.pop() not in (torch.float32, torch.bfloat16):
        raise TypeError(f"the MoE kernels take f32 or bf16 operands of one dtype, got "
                        f"{[t.dtype for t in tensors]}")


# --------------------------------------------------------------------- route
def _stable_topk(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``lax.top_k``: descending, equal values the lower index first."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def router_probs(x: torch.Tensor, router: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(f32 logits ``x . router`` with both upcast, their softmax), ``[T, X]``."""
    logits = torch.matmul(x.float(), router.float())
    return logits, torch.softmax(logits, dim=-1)


def capacity_slots_plain(tok_expert: torch.Tensor, num_experts: int, capacity: int):
    """The capacity positions of the chosen experts ``tok_expert [T, K]``:
    (tok_slot [T, K], slot_tok [X, C], fill [X]), each choice in token
    order after all earlier choices, as the JAX code's cumsum and counts."""
    T, K = tok_expert.shape
    X, C = num_experts, capacity
    dev = tok_expert.device
    counts = torch.zeros((X,), dtype=torch.int64, device=dev)
    tok_slot = torch.empty((T, K), dtype=torch.int32, device=dev)
    for j in range(K):
        onehot = torch.nn.functional.one_hot(tok_expert[:, j].long(), X)  # [T, X]
        pos = ((torch.cumsum(onehot, 0) - onehot + counts) * onehot).sum(-1)
        counts = counts + onehot.sum(0)
        keep = pos < C
        tok_slot[:, j] = torch.where(keep, tok_expert[:, j].long() * C + pos, -1).to(torch.int32)
    slot_tok = torch.full((X * C,), -1, dtype=torch.int32, device=dev)
    kept = tok_slot >= 0
    tokens = torch.arange(T, dtype=torch.int32, device=dev)[:, None].expand(T, K)
    slot_tok[tok_slot[kept].long()] = tokens[kept]
    return tok_slot, slot_tok.reshape(X, C), counts.clamp(max=C).to(torch.int32)


def moe_route_plain(x: torch.Tensor, router: torch.Tensor, top_k: int, capacity: int) -> Routing:
    """The plain twin of :func:`moe_route` (the JAX ``moe_mlp`` lines 46-63)."""
    _, probs = router_probs(x, router)
    vals, idx = _stable_topk(probs, top_k)
    total = vals[:, 0]
    for j in range(1, top_k):  # left to right, the kernel's order
        total = total + vals[:, j]
    gates = vals / total.clamp_min(1e-9)[:, None]
    tok_slot, slot_tok, fill = capacity_slots_plain(idx, router.shape[1], capacity)
    return tok_slot, gates, slot_tok, fill


def _check_route(x, router, top_k, capacity):
    if x.dim() != 2 or router.dim() != 2 or x.shape[1] != router.shape[0]:
        raise ValueError(f"moe_route takes x [T, E] and router [E, X], got {tuple(x.shape)} "
                         f"and {tuple(router.shape)}")
    X = router.shape[1]
    if not 1 <= top_k <= min(X, MAX_TOP_K) or capacity < 1:
        raise ValueError(f"moe_route: top_k {top_k} of {X} experts, capacity {capacity}")


def moe_route(x: torch.Tensor, router: torch.Tensor, top_k: int, capacity: int) -> Routing:
    """Route ``x [T, E]`` through ``router [E, X]`` (see the module
    docstring): the routing kernel on the card, :func:`moe_route_plain` on
    the CPU."""
    _check_route(x, router, top_k, capacity)
    if not _on_card(x, router):
        return moe_route_plain(x, router, top_k, capacity)
    from .. import kernels

    _kernel_dtype(x, router)
    T, X = x.shape[0], router.shape[1]
    if X > MAX_EXPERTS:
        raise ValueError(f"the routing kernel takes at most {MAX_EXPERTS} experts, got {X}")
    dev = x.device
    tok_slot = torch.empty((T, top_k), dtype=torch.int32, device=dev)
    tok_gate = torch.empty((T, top_k), dtype=torch.float32, device=dev)
    slot_tok = torch.empty((X, capacity), dtype=torch.int32, device=dev)
    fill = torch.empty((X,), dtype=torch.int32, device=dev)
    kernels.moe_route(x.contiguous(), router.contiguous(), tok_slot, tok_gate, slot_tok, fill)
    return tok_slot, tok_gate, slot_tok, fill


def route_margin(x: torch.Tensor, router: torch.Tensor, top_k: int,
                 eps: float = ROUTE_EPS) -> Tuple[torch.Tensor, torch.Tensor]:
    """(near [T], flagged [T]) bool, from the twin's f32 probabilities.
    ``near``: a token two of whose top-(K+1) probabilities, next to each
    other in order, lie within ``eps`` while their logits differ, so its ids
    (or their order) may differ under another summation order.  An exact
    tie of equal logits (two equal router columns) is not near: every
    implementation computes it equal and gives it to the lower expert.
    ``flagged``: near, or a later choice (in the capacity order: choice 0
    of every token, then choice 1, ...) routed to an expert that a near
    token's top K+1 holds, whose position such a flip could move."""
    T, X = x.shape[0], router.shape[1]
    logits, probs = router_probs(x, router)
    m = min(top_k + 1, X)
    vals, idx = _stable_topk(probs, m)
    lsorted = torch.gather(logits, 1, idx)
    gaps = (vals[:, :-1] - vals[:, 1:]) < eps
    near = (gaps & (lsorted[:, :-1] != lsorted[:, 1:])).any(-1)
    # the earliest capacity-order position of a near token whose top K+1
    # holds each expert (a near token's first choice sits at its index)
    order = torch.arange(T, device=x.device)
    cand = torch.zeros((T, X), dtype=torch.bool, device=x.device)
    cand.scatter_(1, idx, True)
    cand &= near[:, None]
    first = torch.where(cand, order[:, None], T * top_k).amin(0)
    chosen = idx[:, :top_k]
    later = (torch.arange(top_k, device=x.device)[None, :] * T + order[:, None]) > first[chosen]
    return near, near | later.any(-1)


# ---------------------------------------------------------------- expert GEMM
def _gate_up_inputs(x, slot_tok):
    X, C = slot_tok.shape
    rows = x[slot_tok.clamp(min=0).long().reshape(-1)].reshape(X, C, x.shape[-1])
    return torch.where((slot_tok >= 0)[..., None], rows, torch.zeros_like(rows))


def moe_expert_gemm_plain(a: torch.Tensor, slot_tok: torch.Tensor, fill: torch.Tensor,
                          w: torch.Tensor, w_up: Optional[torch.Tensor] = None, *,
                          epilogue: str) -> torch.Tensor:
    """The plain twin of :func:`moe_expert_gemm`: the JAX einsums over every
    slot, empty slots (and, for ``"down"``, rows past ``fill``) zero."""
    if epilogue == "gate_up":
        xe = _gate_up_inputs(a, slot_tok)  # the one-hot dispatch: exact
        gate = torch.matmul(xe, w)
        return torch.nn.functional.silu(gate) * torch.matmul(xe, w_up)
    C = slot_tok.shape[1]
    live = torch.arange(C, device=a.device)[None, :] < fill[:, None].long()
    return torch.matmul(torch.where(live[..., None], a, torch.zeros_like(a)), w)


def _check_gemm(a, slot_tok, fill, w, w_up, epilogue):
    if epilogue not in ("gate_up", "down"):
        raise ValueError(f"moe_expert_gemm: epilogue must be 'gate_up' or 'down', got {epilogue!r}")
    if w.dim() != 3 or slot_tok.dim() != 2 or fill.shape != (w.shape[0],):
        raise ValueError(f"moe_expert_gemm: w [X, K, N], slot_tok [X, C], fill [X]; got "
                         f"{tuple(w.shape)}, {tuple(slot_tok.shape)}, {tuple(fill.shape)}")
    X, K, _ = w.shape
    if slot_tok.shape[0] != X:
        raise ValueError("moe_expert_gemm: slot_tok and w disagree on the experts")
    if epilogue == "gate_up":
        if w_up is None or w_up.shape != w.shape or a.dim() != 2 or a.shape[1] != K:
            raise ValueError("moe_expert_gemm gate_up: x [T, K], w and w_up [X, K, N]")
    elif w_up is not None or a.shape != (X, slot_tok.shape[1], K):
        raise ValueError("moe_expert_gemm down: h [X, C, K], w [X, K, N], no w_up")


def moe_expert_gemm(a: torch.Tensor, slot_tok: torch.Tensor, fill: torch.Tensor,
                    w: torch.Tensor, w_up: Optional[torch.Tensor] = None, *,
                    epilogue: str) -> torch.Tensor:
    """One grouped expert GEMM (see the module docstring): ``"gate_up"``
    with x ``[T, E]``, Wg and Wu ``[X, E, F]`` -> h ``[X, C, F]``;
    ``"down"`` with h ``[X, C, F]``, Wd ``[X, F, E]`` -> ye ``[X, C, E]``.
    The grouped GEMM kernel on the card, :func:`moe_expert_gemm_plain` on
    the CPU."""
    _check_gemm(a, slot_tok, fill, w, w_up, epilogue)
    operands = [t for t in (a, w, w_up) if t is not None]
    if not _on_card(*operands, slot_tok, fill):
        return moe_expert_gemm_plain(a, slot_tok, fill, w, w_up, epilogue=epilogue)
    from .. import kernels

    _kernel_dtype(*operands)
    if slot_tok.dtype != torch.int32 or fill.dtype != torch.int32:
        raise TypeError("moe_expert_gemm: slot_tok and fill must be int32 (moe_route's)")
    X, _, N = w.shape
    C = slot_tok.shape[1]
    out = torch.empty((X, C, N), dtype=a.dtype, device=a.device)
    kernels.moe_gemm(a.contiguous(), slot_tok.contiguous(), fill, w.contiguous(),
                     w_up.contiguous() if w_up is not None else None, out, epilogue=epilogue)
    return out


def moe_gemm_bf16_bound(a: torch.Tensor, slot_tok: torch.Tensor, w: torch.Tensor,
                        w_up: Optional[torch.Tensor] = None, *,
                        epilogue: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """(the f32 reference, the per-element bound) of a bf16 expert GEMM on
    the same bf16-valued inputs; u = 2^-8 is bf16's unit roundoff.

    ``"down"``: ``ye`` rounds once, ``2^-8 |ref| + 2^-12 A + 1e-4`` with ``A
    = |h| . |Wd|``: ``2^-12 A`` is the f32 summation order of both sides
    (qgemm's term: the worst case at K = 4,096, and the error of a sum of
    exact products grows as sqrt(K) past it).
    ``"gate_up"``: g and u round (u each), silu(g) rounds (u) and h rounds
    (u); with ``|silu'| <= 1.1``, ``|h' - h| <= 3u |h| + 1.1u |g| |u_val|``
    to first order, so ``2^-6 |h| + 2^-7 |g| |u_val|``, plus the summation
    order of both products, ``2^-12 (1.1 A_g |u_val| + |silu(g)| A_u)``, and
    ``1e-4``."""
    if epilogue == "gate_up":
        xe = _gate_up_inputs(a, slot_tok).float()
        g = torch.matmul(xe, w.float())
        u = torch.matmul(xe, w_up.float())
        s = torch.nn.functional.silu(g)
        ref = s * u
        a_g = torch.matmul(xe.abs(), w.float().abs())
        a_u = torch.matmul(xe.abs(), w_up.float().abs())
        bound = (2.0 ** -6 * ref.abs() + 2.0 ** -7 * (g * u).abs()
                 + 2.0 ** -12 * (1.1 * a_g * u.abs() + s.abs() * a_u) + 1e-4)
        return ref, bound
    ref = torch.matmul(a.float(), w.float())
    return ref, 2.0 ** -8 * ref.abs() + 2.0 ** -12 * torch.matmul(a.float().abs(),
                                                                   w.float().abs()) + 1e-4


MOE_GEMM_BF16_BOUND_TEXT = {
    "gate_up": "2^-6|h| + 2^-7|g u| + 2^-12(1.1 A_g|u| + |silu g| A_u) + 1e-4",
    "down": "2^-8|ref| + 2^-12 A + 1e-4, A = |h|.|Wd|",
}


# ------------------------------------------------------------------- combine
def moe_combine_plain(tok_slot: torch.Tensor, tok_gate: torch.Tensor,
                      ye: torch.Tensor) -> torch.Tensor:
    """The plain twin of :func:`moe_combine`: the products and their sum in
    f32, the K terms left to right, a dropped choice adding nothing."""
    T, K = tok_slot.shape
    flat = ye.reshape(-1, ye.shape[-1])
    acc = torch.zeros((T, flat.shape[1]), dtype=torch.float32, device=ye.device)
    for j in range(K):
        slot = tok_slot[:, j]
        rows = flat[slot.clamp(min=0).long()].float()
        gate = tok_gate[:, j].to(ye.dtype).float()
        acc = torch.where((slot >= 0)[:, None], acc + gate[:, None] * rows, acc)
    return acc.to(ye.dtype)


def moe_combine(tok_slot: torch.Tensor, tok_gate: torch.Tensor, ye: torch.Tensor) -> torch.Tensor:
    """``out [T, E]`` from the experts' outputs ``ye [X, C, E]`` (see the
    module docstring): the combine kernel on the card,
    :func:`moe_combine_plain` on the CPU."""
    if tok_slot.shape != tok_gate.shape or tok_slot.dim() != 2 or ye.dim() != 3:
        raise ValueError("moe_combine: tok_slot and tok_gate [T, K], ye [X, C, E]")
    if not _on_card(tok_slot, tok_gate, ye):
        return moe_combine_plain(tok_slot, tok_gate, ye)
    from .. import kernels

    _kernel_dtype(ye)
    if tok_slot.dtype != torch.int32 or tok_gate.dtype != torch.float32:
        raise TypeError("moe_combine: tok_slot int32 and tok_gate f32 (moe_route's)")
    if tok_slot.shape[1] > MAX_TOP_K:
        raise ValueError(f"the combine kernel takes at most {MAX_TOP_K} choices")
    out = torch.empty((tok_slot.shape[0], ye.shape[-1]), dtype=ye.dtype, device=ye.device)
    kernels.moe_combine(tok_slot.contiguous(), tok_gate.contiguous(), ye.contiguous(), out)
    return out
