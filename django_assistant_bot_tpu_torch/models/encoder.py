"""BERT-family bidirectional encoder for sentence embeddings (port of
``models/encoder.py``).

Params are a dict shaped like the JAX package's pytree: ``tok_embed``
``[V, E]``, ``pos_embed`` ``[P, E]``, ``type_embed`` ``[T, E]``, the
embedding LayerNorm, and a ``layers`` dict of tensors stacked on a leading
layer axis (``wq`` ``[L, E, E]``, ..., weights ``[in, out]``).  The JAX
``lax.scan`` over that axis is a Python loop.  Post-LN layers, exact-erf
GELU, token type always 0; activations in ``cfg.dtype`` with f32 LayerNorm
statistics.  Attention is the plain :func:`~..ops.attention.dot_product_attention`
with a ``[B, 1, 1, S]`` key mask, as in the JAX encoder (which never reaches
the flash kernel: it always passes a mask).  The products go to
``torch.matmul``, as the JAX package leaves them to XLA.
"""

from __future__ import annotations

from typing import Any, Dict

import torch
import torch.nn.functional as F

from ..device import DeviceLike, resolve_device
from ..ops.attention import dot_product_attention
from ..ops.norms import layer_norm
from .config import EncoderConfig

Params = Dict[str, Any]


def init(cfg: EncoderConfig, generator: torch.Generator, device: DeviceLike = "cuda") -> Params:
    """Random params like the JAX ``init``: normal(0, E^-0.5) weights and
    embeddings, zero biases, unit LayerNorm scales; drawn by ``generator``
    (which must live on ``device``) directly in ``cfg.dtype``."""
    device = resolve_device(device)
    E, Fd, L = cfg.hidden_size, cfg.intermediate_size, cfg.num_layers
    s = E ** -0.5

    def dense(shape):
        return torch.randn(shape, generator=generator, device=device, dtype=cfg.dtype).mul_(s)

    def zeros(shape):
        return torch.zeros(shape, device=device, dtype=cfg.dtype)

    def ones(shape):
        return torch.ones(shape, device=device, dtype=cfg.dtype)

    return {
        "tok_embed": dense((cfg.vocab_size, E)),
        "pos_embed": dense((cfg.max_position_embeddings, E)),
        "type_embed": dense((cfg.type_vocab_size, E)),
        "embed_ln_w": ones((E,)),
        "embed_ln_b": zeros((E,)),
        "layers": {
            "wq": dense((L, E, E)),
            "bq": zeros((L, E)),
            "wk": dense((L, E, E)),
            "bk": zeros((L, E)),
            "wv": dense((L, E, E)),
            "bv": zeros((L, E)),
            "wo": dense((L, E, E)),
            "bo": zeros((L, E)),
            "attn_ln_w": ones((L, E)),
            "attn_ln_b": zeros((L, E)),
            "w1": dense((L, E, Fd)),
            "b1": zeros((L, Fd)),
            "w2": dense((L, Fd, E)),
            "b2": zeros((L, E)),
            "mlp_ln_w": ones((L, E)),
            "mlp_ln_b": zeros((L, E)),
        },
    }


def _layer(cfg: EncoderConfig, x: torch.Tensor, p: Params, mask: torch.Tensor) -> torch.Tensor:
    """One post-LN transformer layer.  x: [B, S, E]; mask: [B, 1, 1, S], True=keep."""
    B, S, E = x.shape
    H, D = cfg.num_heads, cfg.head_dim

    def proj(w, b):
        return (x @ w + b).reshape(B, S, H, D).transpose(1, 2)

    attn = dot_product_attention(proj(p["wq"], p["bq"]), proj(p["wk"], p["bk"]),
                                 proj(p["wv"], p["bv"]), mask=mask)
    out = attn.transpose(1, 2).reshape(B, S, E) @ p["wo"] + p["bo"]
    x = layer_norm(x + out, p["attn_ln_w"], p["attn_ln_b"], cfg.layer_norm_eps)
    h = F.gelu(x @ p["w1"] + p["b1"], approximate="none")
    h = h @ p["w2"] + p["b2"]
    return layer_norm(x + h, p["mlp_ln_w"], p["mlp_ln_b"], cfg.layer_norm_eps)


def forward(
    params: Params,
    cfg: EncoderConfig,
    input_ids: torch.Tensor,  # [B, S] int
    attention_mask: torch.Tensor,  # [B, S] 1=real, 0=pad
) -> torch.Tensor:
    """Full encoder forward -> last hidden states [B, S, E]."""
    S = input_ids.shape[1]
    ids = input_ids.long()
    x = params["tok_embed"][ids] + params["pos_embed"][:S][None] + params["type_embed"][0]
    x = layer_norm(x, params["embed_ln_w"], params["embed_ln_b"], cfg.layer_norm_eps)
    x = x.to(cfg.dtype)
    mask = attention_mask[:, None, None, :].bool()
    layers = params["layers"]
    for i in range(cfg.num_layers):
        x = _layer(cfg, x, {k: w[i] for k, w in layers.items()}, mask)
    return x


def encode(
    params: Params,
    cfg: EncoderConfig,
    input_ids: torch.Tensor,
    attention_mask: torch.Tensor,
    *,
    normalize: bool = False,
) -> torch.Tensor:
    """Masked mean-pool sentence embeddings [B, E] (float32): padding is
    left out of the mean, which divides by max(count, 1)."""
    hidden = forward(params, cfg, input_ids, attention_mask).float()
    m = attention_mask.float()[..., None]
    pooled = (hidden * m).sum(dim=1) / m.sum(dim=1).clamp_min(1.0)
    if normalize:
        pooled = pooled / torch.linalg.vector_norm(pooled, dim=-1, keepdim=True).clamp_min(1e-12)
    return pooled
