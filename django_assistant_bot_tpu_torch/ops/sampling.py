"""Token sampling (port of ``ops/sampling.py``): temperature / top-k / top-p.

Plain PyTorch for now.  The JAX package's hierarchical top-k is ported as
written (the same exact two-stage selection, so the same candidate sets and
order); the fused top-k / top-p / draw kernel over ``[B, V]`` that replaces it
on Hopper is ROADMAP Queue 2 entry 4 and comes with a later slice.

The categorical draw is ``argmax(logits + gumbel)``, exactly how
``jax.random.categorical`` draws (``gumbel(key, logits.shape, logits.dtype)``
added to the candidate logits).  The noise comes from a ``torch.Generator``,
or is passed in pre-drawn (``gumbel=``): the engine's fused decode tick
draws each step's noise with :func:`gumbel_noise` into a buffer the tick
(or its CUDA graph) reads, and a test can feed the port the very noise JAX
drew.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

from .attention import NEG_INF

# hierarchical top-k above this vocab size, plain top-k below it
_HIER_TOPK_MIN_VOCAB = 16_384
_GROUP = 128

Scalar = Union[float, torch.Tensor]


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
    _, gidx = torch.topk(gmax, kg, dim=-1)  # [B, kg]
    cand = torch.gather(xg, 1, gidx[:, :, None].expand(B, kg, _GROUP)).reshape(B, kg * _GROUP)
    vals, cidx = torch.topk(cand, k, dim=-1)
    idx = torch.gather(gidx, 1, cidx // _GROUP) * _GROUP + cidx % _GROUP
    idx = torch.clamp(idx, max=V - 1)
    return vals, idx.to(torch.int32)


def top_k_auto(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Hierarchical top-k past ``_HIER_TOPK_MIN_VOCAB``, plain top-k below."""
    if x.shape[-1] >= _HIER_TOPK_MIN_VOCAB:
        return top_k_hierarchical(x, k)
    vals, idx = torch.topk(x, k, dim=-1)
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


def sample_logits(
    logits: torch.Tensor,  # [batch, vocab] float
    *,
    temperature: Scalar = 1.0,  # [batch] or scalar; <= 0 means greedy
    top_k: int = 50,
    top_p: Scalar = 0.95,  # [batch] or scalar
    generator: Optional[torch.Generator] = None,
    gumbel: Optional[torch.Tensor] = None,  # pre-drawn noise of the draw's shape
) -> torch.Tensor:
    """Sampled token ids [batch] (int32); greedy per row via temperature <= 0."""
    logits = logits.float()
    B, V = logits.shape
    temperature = _per_row(temperature, B, logits.device)
    top_p = _per_row(top_p, B, logits.device)
    safe_t = torch.where(temperature > 0, temperature, 1.0)
    scaled = logits / safe_t[:, None]

    def draw(vals: torch.Tensor) -> torch.Tensor:
        noise = gumbel
        if noise is None:
            noise = gumbel_noise(torch.empty(vals.shape, device=vals.device), generator)
        return torch.argmax(vals + noise.to(vals.dtype), dim=-1)

    if top_k and 0 < top_k < V:
        vals, idx = top_k_auto(scaled, top_k)  # [B, k] desc + ids
        probs = torch.softmax(vals, dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        keep = (cum - probs) < top_p[:, None]  # first token always kept
        vals = torch.where(keep, vals, NEG_INF)
        choice = draw(vals)
        sampled = torch.gather(idx, 1, choice[:, None])[:, 0]
        return torch.where(temperature > 0, sampled, idx[:, 0]).to(torch.int32)

    greedy_ids = torch.argmax(logits, dim=-1).to(torch.int32)
    sorted_logits = torch.sort(scaled, dim=-1, descending=True).values
    sorted_probs = torch.softmax(sorted_logits, dim=-1)
    cum = torch.cumsum(sorted_probs, dim=-1)
    keep_sorted = (cum - sorted_probs) < top_p[:, None]
    threshold = torch.where(keep_sorted, sorted_logits, float("inf")).amin(dim=-1, keepdim=True)
    scaled = torch.where(scaled < threshold, NEG_INF, scaled)
    sampled = draw(scaled).to(torch.int32)
    return torch.where(temperature > 0, sampled, greedy_ids)
