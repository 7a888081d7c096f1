"""Model configs: the port of ``models/config.py``'s ``EncoderConfig`` and
``DecoderConfig``.

Same fields, same ``from_hf`` mapping of Hugging Face ``config.json`` dicts,
same rope-scaling tuples; ``dtype`` is a ``torch.dtype``.
"""

from __future__ import annotations

import dataclasses
import logging
import math
from typing import Any, Mapping, Optional

import torch

_logger = logging.getLogger(__name__)


@dataclasses.dataclass(frozen=True)
class EncoderConfig:
    """BERT-family encoder (ruBert-base: 12L/768E/12H; MiniLM-L6: 6L/384E/12H)."""

    vocab_size: int = 119_547
    hidden_size: int = 768
    intermediate_size: int = 3072
    num_layers: int = 12
    num_heads: int = 12
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    layer_norm_eps: float = 1e-12
    pad_token_id: int = 0
    dtype: Any = torch.bfloat16

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @classmethod
    def from_hf(cls, hf: Mapping[str, Any], dtype=torch.bfloat16) -> "EncoderConfig":
        return cls(
            vocab_size=hf["vocab_size"],
            hidden_size=hf["hidden_size"],
            intermediate_size=hf["intermediate_size"],
            num_layers=hf["num_hidden_layers"],
            num_heads=hf["num_attention_heads"],
            max_position_embeddings=hf.get("max_position_embeddings", 512),
            type_vocab_size=hf.get("type_vocab_size", 2),
            layer_norm_eps=hf.get("layer_norm_eps", 1e-12),
            pad_token_id=hf.get("pad_token_id", 0),
            dtype=dtype,
        )

    @classmethod
    def tiny(cls) -> "EncoderConfig":
        """Test-size config (f32)."""
        return cls(
            vocab_size=512,
            hidden_size=64,
            intermediate_size=128,
            num_layers=2,
            num_heads=4,
            max_position_embeddings=128,
            dtype=torch.float32,
        )


@dataclasses.dataclass(frozen=True)
class DecoderConfig:
    """Llama-3 family decoder; ``num_experts > 0`` turns the MLP into Mixtral MoE."""

    vocab_size: int = 128_256
    hidden_size: int = 4096
    intermediate_size: int = 14_336
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: int = 8
    head_dim: Optional[int] = None
    max_seq_len: int = 8192
    rope_theta: float = 500_000.0
    # Llama-3.1-style rope frequency remap as a hashable 4-tuple
    # (factor, low_freq_factor, high_freq_factor, original_max_len); None = plain rope
    rope_scaling: Optional[tuple] = None
    rms_norm_eps: float = 1e-5
    tie_embeddings: bool = False
    # Qwen2 family: biases on the q/k/v projections (o stays bias-free)
    attn_bias: bool = False
    # sliding window (HF sliding_window_overlay semantics); None = full causal
    sliding_window: Optional[int] = None
    # first windowed layer (Qwen2 max_window_layers); 0 = every layer windowed
    window_layer_start: int = 0
    # Gemma family: GeGLU MLP and sqrt(E)-scaled embeddings (the (1+w) norm
    # folds into the stored weights at load time)
    hidden_act: str = "silu"
    embed_multiplier: float = 1.0
    # MoE (Mixtral): 0 experts = dense SwiGLU MLP
    num_experts: int = 0
    experts_per_token: int = 2
    expert_capacity_factor: float = 1.25
    dtype: Any = torch.bfloat16

    def __post_init__(self):
        if self.head_dim is None:
            object.__setattr__(self, "head_dim", self.hidden_size // self.num_heads)
        if self.rope_scaling and self.rope_scaling[0] == "longrope":
            orig = self.rope_scaling[3]
            if self.max_seq_len > orig:
                _logger.warning(
                    "longrope deployment with max_seq_len=%d > pretrained "
                    "context %d: LONG rope factors apply to every sequence, so "
                    "logits for prompts shorter than %d diverge from HF (which "
                    "switches factor lists per sequence).  For exact "
                    "short-context parity deploy with max_seq_len <= %d.",
                    self.max_seq_len,
                    int(orig),
                    int(orig),
                    int(orig),
                )

    @property
    def q_per_kv(self) -> int:
        return self.num_heads // self.num_kv_heads

    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

    @classmethod
    def from_hf(cls, hf: Mapping[str, Any], dtype=torch.bfloat16) -> "DecoderConfig":
        num_experts = hf.get("num_local_experts", 0)
        is_gemma = hf.get("model_type") == "gemma"
        act = hf.get("hidden_activation") or hf.get("hidden_act") or "silu"
        rs = hf.get("rope_scaling")
        rope_scaling = None
        if rs:
            kind = rs.get("rope_type") or rs.get("type")
            max_pos = hf.get("max_position_embeddings", 8192)
            if kind == "llama3":
                rope_scaling = (
                    float(rs["factor"]),
                    float(rs["low_freq_factor"]),
                    float(rs["high_freq_factor"]),
                    float(rs["original_max_position_embeddings"]),
                )
            elif kind == "linear":
                rope_scaling = ("linear", float(rs["factor"]))
            elif kind == "longrope":
                orig = float(
                    hf.get("original_max_position_embeddings")
                    or rs.get("original_max_position_embeddings")
                    or max_pos
                )
                factor = rs.get("factor")
                if hf.get("original_max_position_embeddings"):
                    factor = max_pos / float(hf["original_max_position_embeddings"])
                af = rs.get("attention_factor")
                if af is None:
                    af = (
                        1.0
                        if factor is None or factor <= 1.0
                        else math.sqrt(1.0 + math.log(factor) / math.log(orig))
                    )
                rope_scaling = (
                    "longrope",
                    tuple(float(x) for x in rs["short_factor"]),
                    tuple(float(x) for x in rs["long_factor"]),
                    orig,
                    float(af),
                )
            elif kind == "yarn":
                factor = float(rs["factor"])
                orig = float(rs.get("original_max_position_embeddings") or max_pos)
                mscale = rs.get("mscale")
                mscale_all = rs.get("mscale_all_dim")

                def _mscale(scale, m=1.0):
                    return 1.0 if scale <= 1.0 else 0.1 * m * math.log(scale) + 1.0

                af = rs.get("attention_factor")
                if af is None:
                    if mscale and mscale_all:
                        af = _mscale(factor, mscale) / _mscale(factor, mscale_all)
                    else:
                        af = _mscale(factor)
                rope_scaling = (
                    "yarn",
                    factor,
                    float(rs.get("beta_fast") or 32),
                    float(rs.get("beta_slow") or 1),
                    orig,
                    float(af),
                    bool(rs.get("truncate", True)),
                )
            elif kind != "default":  # HF "default" = plain rope, i.e. None
                raise ValueError(f"unsupported rope_scaling type {kind!r}")
        max_seq = hf.get("max_position_embeddings", 8192)
        window = hf.get("sliding_window")
        window_on = hf.get("use_sliding_window", hf.get("model_type") != "qwen2")
        sliding_window = int(window) if (window and window_on) else None
        window_layer_start = 0
        if sliding_window and hf.get("model_type") == "qwen2":
            mwl = hf.get("max_window_layers")
            window_layer_start = int(mwl) if mwl is not None else 28
        return cls(
            vocab_size=hf["vocab_size"],
            hidden_size=hf["hidden_size"],
            intermediate_size=hf["intermediate_size"],
            num_layers=hf["num_hidden_layers"],
            num_heads=hf["num_attention_heads"],
            num_kv_heads=hf.get("num_key_value_heads", hf["num_attention_heads"]),
            head_dim=hf.get("head_dim"),
            hidden_act="gelu_tanh" if "gelu" in act else "silu",
            embed_multiplier=float(hf["hidden_size"]) ** 0.5 if is_gemma else 1.0,
            max_seq_len=max_seq,
            rope_theta=hf.get("rope_theta", 500_000.0),
            rope_scaling=rope_scaling,
            rms_norm_eps=hf.get("rms_norm_eps", 1e-5),
            tie_embeddings=hf.get("tie_word_embeddings", False),
            attn_bias=bool(hf.get("attention_bias", hf.get("model_type") == "qwen2")),
            sliding_window=sliding_window,
            window_layer_start=window_layer_start,
            num_experts=num_experts,
            experts_per_token=hf.get("num_experts_per_tok", 2),
            dtype=dtype,
        )

    @classmethod
    def llama3_8b(cls, dtype=torch.bfloat16) -> "DecoderConfig":
        return cls(dtype=dtype)

    @classmethod
    def mixtral_8x7b(cls, dtype=torch.bfloat16) -> "DecoderConfig":
        return cls(
            vocab_size=32_000,
            hidden_size=4096,
            intermediate_size=14_336,
            num_layers=32,
            num_heads=32,
            num_kv_heads=8,
            rope_theta=1e6,
            num_experts=8,
            experts_per_token=2,
            max_seq_len=32_768,
            dtype=dtype,
        )

    @classmethod
    def tiny(cls, *, num_experts: int = 0) -> "DecoderConfig":
        return cls(
            vocab_size=512,
            hidden_size=64,
            intermediate_size=128,
            num_layers=2,
            num_heads=4,
            num_kv_heads=2,
            max_seq_len=256,
            rope_theta=10_000.0,
            num_experts=num_experts,
            dtype=torch.float32,
        )
