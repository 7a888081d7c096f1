"""Hugging Face safetensors -> the port's params (port of
``models/hf_loader.py``'s ``read_hf_config``, ``load_encoder`` and
``load_decoder``).

Tensors are read shard by shard straight into torch, transposed to the
``[in, out]`` einsum convention, stacked along the leading layer axis and
cast to the target dtype on the target device.  Same families as the JAX
loader (Llama-3, Mistral, Qwen2 with qkv biases, Gemma with the (1+w) norm
fold in f32, Phi-3 fused projections, Mixtral's router and experts stacked
``[L, X, in, out]``) and BERT encoders (an optional ``bert.`` prefix
stripped).  Unknown decoder model types are refused.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict

import torch

from ..device import DeviceLike, resolve_device
from .config import DecoderConfig, EncoderConfig

_SUPPORTED_DECODERS = {"llama", "mistral", "mixtral", "qwen2", "gemma", "phi3"}


def _read_safetensors(model_dir: str) -> Dict[str, torch.Tensor]:
    from safetensors import safe_open

    files = sorted(f for f in os.listdir(model_dir) if f.endswith(".safetensors"))
    if not files:
        raise FileNotFoundError(f"no .safetensors files in {model_dir}")
    tensors: Dict[str, torch.Tensor] = {}
    for fname in files:
        with safe_open(os.path.join(model_dir, fname), framework="pt") as f:
            for key in f.keys():
                tensors[key] = f.get_tensor(key)
    return tensors


def read_hf_config(model_dir: str) -> Dict[str, Any]:
    with open(os.path.join(model_dir, "config.json")) as f:
        return json.load(f)


def _stack(t: Dict[str, torch.Tensor], fmt: str, n: int, *, T: bool = False) -> torch.Tensor:
    """Stack per-layer tensors fmt.format(i) into [n, ...]; T transposes each."""
    return torch.stack([t[fmt.format(i)].T if T else t[fmt.format(i)] for i in range(n)])


def _place(params: Dict[str, Any], dtype: torch.dtype, dev: torch.device) -> Dict[str, Any]:
    def place(x: torch.Tensor) -> torch.Tensor:
        if x.is_floating_point():
            x = x.to(dtype)
        return x.contiguous().to(dev)

    return {
        k: ({n: place(w) for n, w in v.items()} if isinstance(v, dict) else place(v))
        for k, v in params.items()
    }


def load_encoder(
    model_dir: str, dtype: torch.dtype = torch.bfloat16, device: DeviceLike = "cuda"
) -> tuple[EncoderConfig, Dict[str, Any]]:
    """Load a BERT-family checkpoint directory -> (EncoderConfig, params)."""
    dev = resolve_device(device)
    cfg = EncoderConfig.from_hf(read_hf_config(model_dir), dtype=dtype)
    t = _read_safetensors(model_dir)
    if any(k.startswith("bert.") for k in t):
        t = {k[len("bert."):] if k.startswith("bert.") else k: v for k, v in t.items()}
    L = cfg.num_layers
    pre = "encoder.layer.{}."
    params = {
        "tok_embed": t["embeddings.word_embeddings.weight"],
        "pos_embed": t["embeddings.position_embeddings.weight"],
        "type_embed": t["embeddings.token_type_embeddings.weight"],
        "embed_ln_w": t["embeddings.LayerNorm.weight"],
        "embed_ln_b": t["embeddings.LayerNorm.bias"],
        "layers": {
            "wq": _stack(t, pre + "attention.self.query.weight", L, T=True),
            "bq": _stack(t, pre + "attention.self.query.bias", L),
            "wk": _stack(t, pre + "attention.self.key.weight", L, T=True),
            "bk": _stack(t, pre + "attention.self.key.bias", L),
            "wv": _stack(t, pre + "attention.self.value.weight", L, T=True),
            "bv": _stack(t, pre + "attention.self.value.bias", L),
            "wo": _stack(t, pre + "attention.output.dense.weight", L, T=True),
            "bo": _stack(t, pre + "attention.output.dense.bias", L),
            "attn_ln_w": _stack(t, pre + "attention.output.LayerNorm.weight", L),
            "attn_ln_b": _stack(t, pre + "attention.output.LayerNorm.bias", L),
            "w1": _stack(t, pre + "intermediate.dense.weight", L, T=True),
            "b1": _stack(t, pre + "intermediate.dense.bias", L),
            "w2": _stack(t, pre + "output.dense.weight", L, T=True),
            "b2": _stack(t, pre + "output.dense.bias", L),
            "mlp_ln_w": _stack(t, pre + "output.LayerNorm.weight", L),
            "mlp_ln_b": _stack(t, pre + "output.LayerNorm.bias", L),
        },
    }
    return cfg, _place(params, dtype, dev)


def load_decoder(
    model_dir: str, dtype: torch.dtype = torch.bfloat16, device: DeviceLike = "cuda"
) -> tuple[DecoderConfig, Dict[str, Any]]:
    """Load a Llama/Qwen2/Gemma/Phi-3/Mixtral checkpoint dir -> (DecoderConfig, params)."""
    dev = resolve_device(device)
    hf = read_hf_config(model_dir)
    model_type = hf.get("model_type")
    if model_type is not None and model_type not in _SUPPORTED_DECODERS:
        raise ValueError(
            f"unsupported decoder model_type {model_type!r}; "
            f"supported: {sorted(_SUPPORTED_DECODERS)}"
        )
    cfg = DecoderConfig.from_hf(hf, dtype=dtype)
    t = _read_safetensors(model_dir)
    L = cfg.num_layers
    pre = "model.layers.{}."

    layers: Dict[str, torch.Tensor] = {
        "attn_norm": _stack(t, pre + "input_layernorm.weight", L),
        "wo": _stack(t, pre + "self_attn.o_proj.weight", L, T=True),
        "mlp_norm": _stack(t, pre + "post_attention_layernorm.weight", L),
    }
    if model_type == "phi3":
        qkv = _stack(t, pre + "self_attn.qkv_proj.weight", L, T=True)  # [L,E,(H+2KH)*D]
        qd = cfg.num_heads * cfg.head_dim
        kd = cfg.num_kv_heads * cfg.head_dim
        layers["wq"] = qkv[:, :, :qd]
        layers["wk"] = qkv[:, :, qd : qd + kd]
        layers["wv"] = qkv[:, :, qd + kd :]
        gate_up = _stack(t, pre + "mlp.gate_up_proj.weight", L, T=True)  # [L,E,2F]
        F = cfg.intermediate_size
        layers["w_gate"] = gate_up[:, :, :F]
        layers["w_up"] = gate_up[:, :, F:]
    else:
        layers["wq"] = _stack(t, pre + "self_attn.q_proj.weight", L, T=True)
        layers["wk"] = _stack(t, pre + "self_attn.k_proj.weight", L, T=True)
        layers["wv"] = _stack(t, pre + "self_attn.v_proj.weight", L, T=True)
    if cfg.is_moe:
        X = cfg.num_experts

        def experts(w: str) -> torch.Tensor:  # [L, X, in, out]
            return torch.stack([
                torch.stack([t[f"model.layers.{i}.block_sparse_moe.experts.{j}.{w}.weight"].T
                             for j in range(X)])
                for i in range(L)
            ])

        layers["router"] = _stack(t, pre + "block_sparse_moe.gate.weight", L, T=True)
        layers["w_gate"] = experts("w1")
        layers["w_up"] = experts("w3")
        layers["w_down"] = experts("w2")
    else:
        if model_type != "phi3":
            layers["w_gate"] = _stack(t, pre + "mlp.gate_proj.weight", L, T=True)
            layers["w_up"] = _stack(t, pre + "mlp.up_proj.weight", L, T=True)
        layers["w_down"] = _stack(t, pre + "mlp.down_proj.weight", L, T=True)
    if cfg.attn_bias:  # Qwen2 family: qkv biases (o_proj stays bias-free)
        layers["bq"] = _stack(t, pre + "self_attn.q_proj.bias", L)
        layers["bk"] = _stack(t, pre + "self_attn.k_proj.bias", L)
        layers["bv"] = _stack(t, pre + "self_attn.v_proj.bias", L)

    params: Dict[str, Any] = {
        "tok_embed": t["model.embed_tokens.weight"],
        "final_norm": t["model.norm.weight"],
        "layers": layers,
    }
    if model_type == "gemma":
        # Gemma's RMSNorm multiplies by (1 + w): fold the +1 in f32, as HF
        # computes it, before the single cast to the model dtype
        layers["attn_norm"] = layers["attn_norm"].float() + 1.0
        layers["mlp_norm"] = layers["mlp_norm"].float() + 1.0
        params["final_norm"] = params["final_norm"].float() + 1.0
    if not cfg.tie_embeddings:
        head = t.get("lm_head.weight")
        if head is None:  # some checkpoints tie implicitly
            cfg = DecoderConfig(**{**cfg.__dict__, "tie_embeddings": True})
        else:
            params["lm_head"] = head.T

    return cfg, _place(params, dtype, dev)
