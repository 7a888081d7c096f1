"""Projection products (port of ``ops/quant.py``, dense branch only).

On a plain weight, the JAX package's ``qeinsum`` is an einsum in the model
dtype that XLA lowers to a matrix product; here every projection pattern of
the model (``x[..., in] . w[in, out]``) goes straight to ``torch.matmul``,
which is the product ``torch.einsum`` would reach after parsing the pattern
on every call, and other patterns to ``torch.einsum``.  Quantized weights
(the JAX ``QTensor``/``QTensor4`` leaves) need the weight-only GEMM kernel of
ROADMAP Queue 2 entry 3 and are refused until it lands.
"""

from __future__ import annotations

import functools

import torch


@functools.lru_cache(maxsize=64)
def _is_projection(pattern: str) -> bool:
    """``"<x>c,co-><x>o"``: contract x's last axis with w's first, keep the rest."""
    lhs, out = pattern.replace(" ", "").split("->")
    xs, ws = lhs.split(",")
    return len(ws) == 2 and xs[-1] == ws[0] and out == xs[:-1] + ws[1]


def qeinsum(pattern: str, x: torch.Tensor, w, dtype: torch.dtype) -> torch.Tensor:
    """``einsum(pattern, x, w)`` for a dense weight; any other leaf raises."""
    if not isinstance(w, torch.Tensor):
        raise NotImplementedError(
            f"quantized weight leaf {type(w).__name__}: int8/int4 weights need the "
            "qeinsum kernel of ROADMAP Queue 2 entry 3, not yet ported"
        )
    if _is_projection(pattern):
        return torch.matmul(x, w)
    return torch.einsum(pattern, x, w)
