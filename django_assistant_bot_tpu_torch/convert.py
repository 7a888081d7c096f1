"""Bridge from the JAX package's params to the port's.

:func:`params_from_jax` (decoders) and :func:`encoder_params_from_jax` take
the JAX param pytree with its leaves already turned into numpy arrays
(``jax.tree.map(np.asarray, params)`` on the JAX side — this module never
imports JAX) and return the port's params dict: the same keys and layouts,
as tensors in ``cfg.dtype`` on ``device``.
Quantized leaves (the JAX ``QTensor``/``QTensor4`` NamedTuples) are refused:
their kernel is ROADMAP Queue 2 entry 3.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from .device import DeviceLike, resolve_device
from .models.config import DecoderConfig, EncoderConfig

_LAYER_KEYS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down", "attn_norm", "mlp_norm")
_BIAS_KEYS = ("bq", "bk", "bv")


def _tensor(name: str, leaf: Any, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    if isinstance(leaf, tuple) or not hasattr(leaf, "dtype"):
        raise NotImplementedError(
            f"param {name!r} is a quantized leaf ({type(leaf).__name__}); int8/int4 "
            "weights wait for the qeinsum kernel (ROADMAP Queue 2 entry 3)"
        )
    arr = np.asarray(leaf)
    # bfloat16 leaves come as ml_dtypes' bfloat16, which numpy does not
    # class as floating
    if not (np.issubdtype(arr.dtype, np.floating) or arr.dtype.name == "bfloat16"):
        raise NotImplementedError(
            f"param {name!r} has dtype {arr.dtype}; quantized weights wait for "
            "ROADMAP Queue 2 entry 3"
        )
    # numpy has no bfloat16: widen (exactly) to float32 before torch
    return torch.tensor(arr.astype(np.float32)).to(device=device, dtype=dtype)


def params_from_jax(
    tree: Mapping[str, Any], cfg: DecoderConfig, device: DeviceLike = "cuda"
) -> dict:
    """JAX decoder params (numpy leaves) -> the port's params dict."""
    dev = resolve_device(device)
    if cfg.is_moe:
        raise NotImplementedError("MoE decoders wait for ROADMAP Queue 1 item 11")
    layers_in = tree["layers"]
    keys = _LAYER_KEYS + (_BIAS_KEYS if cfg.attn_bias else ())
    layers = {k: _tensor(f"layers.{k}", layers_in[k], cfg.dtype, dev) for k in keys}
    out = {
        "tok_embed": _tensor("tok_embed", tree["tok_embed"], cfg.dtype, dev),
        "final_norm": _tensor("final_norm", tree["final_norm"], cfg.dtype, dev),
        "layers": layers,
    }
    if not cfg.tie_embeddings:
        out["lm_head"] = _tensor("lm_head", tree["lm_head"], cfg.dtype, dev)
    return out


_ENCODER_TOP_KEYS = ("tok_embed", "pos_embed", "type_embed", "embed_ln_w", "embed_ln_b")
_ENCODER_LAYER_KEYS = ("wq", "bq", "wk", "bk", "wv", "bv", "wo", "bo", "attn_ln_w",
                       "attn_ln_b", "w1", "b1", "w2", "b2", "mlp_ln_w", "mlp_ln_b")


def encoder_params_from_jax(
    tree: Mapping[str, Any], cfg: EncoderConfig, device: DeviceLike = "cuda"
) -> dict:
    """JAX encoder params (numpy leaves) -> the port's params dict."""
    dev = resolve_device(device)
    out = {k: _tensor(k, tree[k], cfg.dtype, dev) for k in _ENCODER_TOP_KEYS}
    out["layers"] = {
        k: _tensor(f"layers.{k}", tree["layers"][k], cfg.dtype, dev) for k in _ENCODER_LAYER_KEYS
    }
    return out
