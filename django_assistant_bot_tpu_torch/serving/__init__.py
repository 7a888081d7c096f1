"""Serving plane of the port: generation engine, registry, HTTP server."""

from .engine import PREFILL_BUCKETS, GenerationEngine, GenerationResult, pick_bucket
from .registry import ModelRegistry, ModelSpec
from .tokenizer import ByteTokenizer, HFTokenizer, encode_chat_split, load_tokenizer

__all__ = [
    "PREFILL_BUCKETS",
    "ByteTokenizer",
    "GenerationEngine",
    "GenerationResult",
    "HFTokenizer",
    "ModelRegistry",
    "ModelSpec",
    "encode_chat_split",
    "load_tokenizer",
    "pick_bucket",
]
