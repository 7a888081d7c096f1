"""Mixtral-style MoE MLP (port of ``models/mixtral.py``): top-k routing with
expert capacity, SwiGLU experts, gated combine.

:func:`moe_mlp` is what the decoder (:mod:`.llama`) runs in place of its
dense MLP when ``cfg.is_moe``: four steps of :mod:`..ops.moe`, each a Hopper
kernel on the card (the routing, the grouped gate/up GEMM, the grouped down
GEMM, the combine) and its plain twin on the CPU.  It computes what the JAX
function computes, with its routing and drops: the capacity ``C`` depends
only on the call's token count (``B x S``, padding included, so pad tokens
and idle decode slots are routed and take capacity as in JAX), and the
expert GEMMs touch only the slots the router filled, reading no weight of an
expert without tokens.  Nothing here reads a device value on the host, so a
CUDA graph captures the whole layer.

:func:`moe_mlp_plain` is the JAX function line for line, its dense one-hot
dispatch and all: the tests hold the twins' composition to it; the serving
path never calls it.

Quantized experts are refused (ROADMAP Queue 1 item 17).
"""

from __future__ import annotations

import math
from typing import Any, Dict

import torch

from ..ops.moe import moe_combine, moe_expert_gemm, moe_route
from ..ops.quant import QuantizedWeight
from .config import DecoderConfig

QUANTIZED_EXPERTS = "ROADMAP Queue 1 item 17 (MoE with int8 / int4 experts)"


def expert_capacity(cfg: DecoderConfig, num_tokens: int) -> int:
    cap = math.ceil(
        num_tokens * cfg.experts_per_token / cfg.num_experts * cfg.expert_capacity_factor
    )
    # the JAX package's floor and multiple of 8 (its (8, 128) tiling)
    return max(8, int(math.ceil(cap / 8) * 8))


def _check_dense(p: Dict[str, Any]) -> None:
    if any(isinstance(p[k], QuantizedWeight) for k in ("router", "w_gate", "w_up", "w_down")):
        raise NotImplementedError(f"quantized MoE experts are not ported yet; {QUANTIZED_EXPERTS}")


def moe_mlp(cfg: DecoderConfig, p: Dict[str, Any], x: torch.Tensor) -> torch.Tensor:
    """x: [B, S, E] -> [B, S, E] through the top-k routed experts (one
    layer's ``router [E, X]``, ``w_gate`` / ``w_up [X, E, F]``, ``w_down
    [X, F, E]``)."""
    _check_dense(p)
    B, S, E = x.shape
    T = B * S
    C = expert_capacity(cfg, T)
    xt = x.reshape(T, E)
    tok_slot, tok_gate, slot_tok, fill = moe_route(xt, p["router"], cfg.experts_per_token, C)
    h = moe_expert_gemm(xt, slot_tok, fill, p["w_gate"], p["w_up"], epilogue="gate_up")
    ye = moe_expert_gemm(h, slot_tok, fill, p["w_down"], epilogue="down")
    return moe_combine(tok_slot, tok_gate, ye).reshape(B, S, E)


def moe_mlp_plain(cfg: DecoderConfig, p: Dict[str, Any], x: torch.Tensor) -> torch.Tensor:
    """The JAX ``moe_mlp`` line for line: dense ``[T, X, C]`` dispatch and
    combine, every expert over all C slots."""
    _check_dense(p)
    B, S, E = x.shape
    T = B * S
    X, K = cfg.num_experts, cfg.experts_per_token
    C = expert_capacity(cfg, T)
    xt = x.reshape(T, E)

    router_logits = torch.einsum("te,ex->tx", xt.float(), p["router"].float())
    probs = torch.softmax(router_logits, dim=-1)  # [T, X]
    srt, order = torch.sort(probs, dim=-1, descending=True, stable=True)  # lax.top_k
    gate_vals, gate_idx = srt[:, :K], order[:, :K]
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True), min=1e-9)

    dispatch = torch.zeros((T, X, C), dtype=cfg.dtype, device=x.device)
    combine = torch.zeros((T, X, C), dtype=torch.float32, device=x.device)
    counts = torch.zeros((X,), dtype=torch.int64, device=x.device)
    for choice in range(K):
        onehot_e = torch.nn.functional.one_hot(gate_idx[:, choice], X)  # [T, X]
        pos = torch.cumsum(onehot_e, dim=0) - onehot_e + counts[None, :]
        counts = counts + onehot_e.sum(dim=0)
        pos_in_e = (pos * onehot_e).sum(-1)  # [T]
        keep = pos_in_e < C
        pos_oh = torch.nn.functional.one_hot(pos_in_e.clamp(max=C - 1), C).to(cfg.dtype)
        pos_oh = pos_oh * keep[:, None].to(cfg.dtype)
        slot = onehot_e.to(cfg.dtype)[:, :, None] * pos_oh[:, None, :]
        dispatch = dispatch + slot
        combine = combine + gate_vals[:, choice, None, None] * slot.float()

    xe = torch.einsum("txc,te->xce", dispatch, xt)  # [X, C, E]
    h = torch.nn.functional.silu(torch.einsum("xce,xef->xcf", xe, p["w_gate"])) * torch.einsum(
        "xce,xef->xcf", xe, p["w_up"]
    )
    ye = torch.einsum("xcf,xfe->xce", h, p["w_down"])  # [X, C, E]
    out = torch.einsum("txc,xce->te", combine.to(cfg.dtype), ye)
    return out.reshape(B, S, E)
