"""Ops of the port: attention (with the Hopper kernels), norms, rope, sampling."""

from .attention import (
    attention,
    dot_product_attention,
    flash_attention,
    flash_attention_plain,
    gqa_dot_product_attention,
    paged_gqa_decode_attention,
    paged_gqa_decode_attention_plain,
)
from .norms import layer_norm, rms_norm
from .rope import apply_rope, rope_frequencies
from .sampling import sample_logits, sample_logits_plain, top_k_auto, top_k_hierarchical

__all__ = [
    "apply_rope",
    "attention",
    "dot_product_attention",
    "flash_attention",
    "flash_attention_plain",
    "gqa_dot_product_attention",
    "layer_norm",
    "paged_gqa_decode_attention",
    "paged_gqa_decode_attention_plain",
    "rms_norm",
    "rope_frequencies",
    "sample_logits",
    "sample_logits_plain",
    "top_k_auto",
    "top_k_hierarchical",
]
