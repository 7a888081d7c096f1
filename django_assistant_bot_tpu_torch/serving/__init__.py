"""Serving plane of the port: generation engine, registry, HTTP server."""

from .engine import PREFILL_BUCKETS, GenerationEngine, GenerationResult, pick_bucket
from .registry import ModelRegistry, ModelSpec
from .scheduler import DeadlineExceeded, RequestScheduler, SchedulerConfig, SchedulerRejected
from .tokenizer import ByteTokenizer, HFTokenizer, encode_chat_split, load_tokenizer

__all__ = [
    "PREFILL_BUCKETS",
    "ByteTokenizer",
    "DeadlineExceeded",
    "GenerationEngine",
    "GenerationResult",
    "HFTokenizer",
    "ModelRegistry",
    "ModelSpec",
    "RequestScheduler",
    "SchedulerConfig",
    "SchedulerRejected",
    "encode_chat_split",
    "load_tokenizer",
    "pick_bucket",
]
