"""Token sampling (port of ``ops/sampling.py``): temperature / top-k / top-p,
with the JSON grammar mask and FSM advance of the JAX engine's decode tick.

:func:`sample_logits` routes by device: a CPU tensor takes the plain twin
:func:`sample_logits_plain`, a CUDA tensor the fused sampler kernel
(``csrc/sample.cu`` via :func:`~..kernels.sample`), one launch a sampling
step; a call the kernel does not take (top-k outside 1-256 or not below the
vocab) raises on the card.  The semantics are the JAX function's, in its
order: the JSON mask (``NEG_INF`` where a JSON row's FSM state does not
allow a token), the temperature, the exact top-k (hierarchical at 16,384
lanes and up: the top-k 128-lane groups by their maximum, then the top-k of
their lanes), the softmax over the k values, top-p (``keep = cum - p <
top_p``), the draw ``argmax(vals + gumbel)`` (how ``jax.random.categorical``
draws), greedy rows (temperature <= 0) taking the head, and the FSM advance
``next_state[state, min(id, V - 1)]`` on JSON rows.  Equal values take the
JAX functions' order (the lower index first, ``lax.top_k``'s; by group
rank, then lane, in the hierarchical top-k), and the twin sums the softmax
and its cumulative sum sequentially over the sorted values, which is the
order the kernel sums in.

The noise comes from a ``torch.Generator``, or is passed in pre-drawn
(``gumbel=``): the engine's fused decode tick draws each step's noise with
:func:`gumbel_noise` into a buffer the tick (or its CUDA graph) reads, and a
test can feed the port the very noise JAX drew.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

from .attention import NEG_INF

# hierarchical top-k above this vocab size, plain top-k below it
_HIER_TOPK_MIN_VOCAB = 16_384
_GROUP = 128

Scalar = Union[float, torch.Tensor]


def _topk_stable(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``lax.top_k``: the k largest along the last axis, descending, equal
    values the lower index first."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def top_k_hierarchical(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k over a large last axis in two stages: the top-k 128-lane
    groups by their max, then the top-k among those groups' lanes.  Returns
    (values [B, k] descending, indices [B, k] int32); out-of-vocab pad lanes
    clamp to V - 1 as in the JAX function."""
    B, V = x.shape
    G = -(-V // _GROUP)
    pad = G * _GROUP - V
    if pad:
        x = torch.nn.functional.pad(x, (0, pad), value=NEG_INF)
    xg = x.reshape(B, G, _GROUP)
    gmax = xg.amax(dim=-1)  # [B, G]
    kg = min(k, G)
    _, gidx = _topk_stable(gmax, kg)  # [B, kg]
    cand = torch.gather(xg, 1, gidx[:, :, None].expand(B, kg, _GROUP)).reshape(B, kg * _GROUP)
    vals, cidx = _topk_stable(cand, k)
    idx = torch.gather(gidx, 1, cidx // _GROUP) * _GROUP + cidx % _GROUP
    idx = torch.clamp(idx, max=V - 1)
    return vals, idx.to(torch.int32)


def top_k_auto(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Hierarchical top-k past ``_HIER_TOPK_MIN_VOCAB``, plain top-k below."""
    if x.shape[-1] >= _HIER_TOPK_MIN_VOCAB:
        return top_k_hierarchical(x, k)
    vals, idx = _topk_stable(x, k)
    return vals, idx.to(torch.int32)


def noise_width(vocab: int, top_k: int) -> int:
    """The last axis of the draw's noise: ``top_k`` candidates when top-k
    filtering applies, else the whole vocabulary."""
    return top_k if 0 < top_k < vocab else vocab


def gumbel_noise(out: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Fill ``out`` (f32) with Gumbel(0, 1) noise, -log(-log(U)) for U
    uniform in (0, 1), drawn by ``generator``: the draw of
    :func:`sample_logits`, one generator call per fill."""
    torch.rand(out.shape, generator=generator, device=out.device, out=out)
    out.clamp_(min=torch.finfo(torch.float32).tiny, max=1.0 - 2**-24)
    return out.log_().neg_().log_().neg_()


def _per_row(value: Scalar, B: int, device) -> torch.Tensor:
    return torch.as_tensor(value, dtype=torch.float32, device=device).expand(B)


def _sequential_cumsum(x: torch.Tensor) -> torch.Tensor:
    """``cumsum`` over the last axis, added left to right (the kernel's order)."""
    out = torch.empty_like(x)
    acc = x[:, 0]
    out[:, 0] = acc
    for j in range(1, x.shape[-1]):
        acc = acc + x[:, j]
        out[:, j] = acc
    return out


def _masked_scaled(logits, temperature, allowed, fsm_state, jmask):
    logits = logits.float()
    B = logits.shape[0]
    if fsm_state is not None:
        ok = allowed[fsm_state.long()]  # [B, V]
        logits = torch.where(jmask[:, None] & ~ok, NEG_INF, logits)
    temperature = _per_row(temperature, B, logits.device)
    safe_t = torch.where(temperature > 0, temperature, 1.0)
    return logits, logits / safe_t[:, None], temperature


def _top_p_terms(vals: torch.Tensor):
    """The softmax of the sorted top-k values and its cumulative sum, each
    summed left to right (the kernel's order)."""
    e = torch.exp(vals - vals[:, :1])
    probs = e / _sequential_cumsum(e)[:, -1:]
    return probs, _sequential_cumsum(probs)


def top_p_margin(
    logits: torch.Tensor, *, temperature: Scalar = 1.0, top_k: int = 50,
    top_p: Scalar = 0.95, allowed: Optional[torch.Tensor] = None,
    fsm_state: Optional[torch.Tensor] = None, jmask: Optional[torch.Tensor] = None, **_,
) -> torch.Tensor:
    """Per row, the plain twin's distance from the top-p boundary,
    ``min_j |cum_j - p_j - top_p|`` over the k sorted values (inf for greedy
    rows): a row under about 1e-6 may keep one value more or less in a sum
    taken in another order (``chip_smoke.py`` counts such rows)."""
    _, scaled, temperature = _masked_scaled(logits, temperature, allowed, fsm_state, jmask)
    vals, _ = top_k_auto(scaled, top_k)
    probs, cum = _top_p_terms(vals)
    top_p = _per_row(top_p, scaled.shape[0], scaled.device)
    margin = (cum - probs - top_p[:, None]).abs().amin(dim=-1)
    return torch.where(temperature > 0, margin, float("inf"))


def sample_logits_plain(
    logits: torch.Tensor,
    *,
    temperature: Scalar = 1.0,
    top_k: int = 50,
    top_p: Scalar = 0.95,
    generator: Optional[torch.Generator] = None,
    gumbel: Optional[torch.Tensor] = None,
    allowed: Optional[torch.Tensor] = None,
    fsm_state: Optional[torch.Tensor] = None,
    jmask: Optional[torch.Tensor] = None,
    next_state: Optional[torch.Tensor] = None,
):
    """The plain twin of the fused sampler: ids ``[B]`` int32, and with the
    JSON inputs ``(ids, advanced states)`` (see :func:`sample_logits`)."""
    B, V = logits.shape
    json = fsm_state is not None
    logits, scaled, temperature = _masked_scaled(logits, temperature, allowed, fsm_state, jmask)
    top_p = _per_row(top_p, B, logits.device)

    def draw(vals: torch.Tensor) -> torch.Tensor:
        noise = gumbel
        if noise is None:
            noise = gumbel_noise(torch.empty(vals.shape, device=vals.device), generator)
        return torch.argmax(vals + noise.to(vals.dtype), dim=-1)

    if top_k and 0 < top_k < V:
        vals, idx = top_k_auto(scaled, top_k)  # [B, k] desc + ids
        probs, cum = _top_p_terms(vals)
        keep = (cum - probs) < top_p[:, None]  # first token always kept
        vals = torch.where(keep, vals, NEG_INF)
        choice = draw(vals)
        sampled = torch.gather(idx, 1, choice[:, None])[:, 0]
        ids = torch.where(temperature > 0, sampled, idx[:, 0]).to(torch.int32)
    else:
        greedy_ids = torch.argmax(logits, dim=-1).to(torch.int32)
        sorted_logits = torch.sort(scaled, dim=-1, descending=True).values
        sorted_probs = torch.softmax(sorted_logits, dim=-1)
        cum = torch.cumsum(sorted_probs, dim=-1)
        keep_sorted = (cum - sorted_probs) < top_p[:, None]
        threshold = torch.where(keep_sorted, sorted_logits, float("inf")).amin(dim=-1, keepdim=True)
        scaled = torch.where(scaled < threshold, NEG_INF, scaled)
        sampled = draw(scaled).to(torch.int32)
        ids = torch.where(temperature > 0, sampled, greedy_ids)
    if not json:
        return ids
    safe = torch.clamp(ids.long(), max=next_state.shape[1] - 1)
    advanced = next_state[fsm_state.long(), safe]
    return ids, torch.where(jmask, advanced, fsm_state).to(torch.int32)


def sample_logits(
    logits: torch.Tensor,  # [batch, vocab] float
    *,
    temperature: Scalar = 1.0,  # [batch] or scalar; <= 0 means greedy
    top_k: int = 50,
    top_p: Scalar = 0.95,  # [batch] or scalar
    generator: Optional[torch.Generator] = None,
    gumbel: Optional[torch.Tensor] = None,  # pre-drawn noise of the draw's shape
    allowed: Optional[torch.Tensor] = None,  # [S, V] bool: the FSM's allowed tokens
    fsm_state: Optional[torch.Tensor] = None,  # [batch] int32 FSM states
    jmask: Optional[torch.Tensor] = None,  # [batch] bool: the JSON rows
    next_state: Optional[torch.Tensor] = None,  # [S, V] int32 FSM transitions
):
    """Sampled token ids [batch] (int32); greedy per row via temperature <= 0.
    With ``fsm_state`` (and ``allowed``, ``jmask``, ``next_state``), JSON
    rows sample under their state's mask and the result is ``(ids, states)``,
    the states advanced on the JSON rows.  A CPU tensor runs the plain twin;
    a CUDA one the fused kernel (the noise drawn first when it is not
    given), which takes 1 <= top_k <= 256 below the vocab and raises
    otherwise."""
    if logits.device.type != "cuda":
        return sample_logits_plain(
            logits, temperature=temperature, top_k=top_k, top_p=top_p, generator=generator,
            gumbel=gumbel, allowed=allowed, fsm_state=fsm_state, jmask=jmask,
            next_state=next_state,
        )
    from .. import kernels

    B, V = logits.shape
    if not (0 < top_k < V and top_k <= kernels.SAMPLE_MAX_K):
        raise ValueError(
            f"the sampler kernel takes 1 <= top_k <= {kernels.SAMPLE_MAX_K} below the vocab "
            f"({V}), got top_k={top_k}"
        )
    if logits.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"the sampler kernel takes f32 or bf16 logits, got {logits.dtype}")
    dev = logits.device
    if gumbel is None:
        gumbel = gumbel_noise(torch.empty((B, top_k), device=dev), generator)
    if tuple(gumbel.shape) != (B, top_k):
        raise ValueError(f"gumbel must be [{B}, {top_k}], got {tuple(gumbel.shape)}")
    temps = _per_row(temperature, B, dev).contiguous()
    top_ps = _per_row(top_p, B, dev).contiguous()
    ids = torch.empty((B,), dtype=torch.int32, device=dev)
    json = fsm_state is not None
    state_out = None
    if json:
        S = allowed.shape[0]
        if not (allowed.dtype == torch.bool and tuple(allowed.shape) == (S, V)
                and next_state.dtype == torch.int32 and tuple(next_state.shape) == (S, V)
                and fsm_state.dtype == torch.int32 and tuple(fsm_state.shape) == (B,)
                and jmask.dtype == torch.bool and tuple(jmask.shape) == (B,)):
            raise ValueError("the sampler kernel takes allowed/next_state [S, V] bool/int32 "
                             "and fsm_state/jmask [B] int32/bool")
        state_out = torch.empty((B,), dtype=torch.int32, device=dev)
    tensors = [logits, temps, top_ps, gumbel]
    if json:
        tensors += [allowed, next_state, fsm_state, jmask]
    if any(t.device != dev or not t.is_contiguous() for t in tensors) or gumbel.dtype != torch.float32:
        raise ValueError("the sampler kernel takes contiguous tensors on the logits' card, "
                         "f32 noise")
    kernels.sample(
        logits, temps, top_ps, gumbel, ids, k=top_k, allowed=allowed, next_state=next_state,
        fsm_state=fsm_state, jmask=jmask, state_out=state_out,
    )
    return (ids, state_out) if json else ids
