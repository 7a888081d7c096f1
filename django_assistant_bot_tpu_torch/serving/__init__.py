"""Serving plane of the port: generation and embedding engines, registry, HTTP server."""

from .engine import (
    PREFILL_BUCKETS,
    EmbeddingEngine,
    EngineUnavailable,
    GenerationEngine,
    GenerationResult,
    RequestPoisoned,
    pick_bucket,
)
from .faults import FaultInjected, FaultInjector
from .registry import ModelRegistry, ModelSpec
from .scheduler import DeadlineExceeded, RequestScheduler, SchedulerConfig, SchedulerRejected
from .streaming import IncrementalDetokenizer, StreamChunk, TokenStream
from .tokenizer import ByteTokenizer, HFTokenizer, encode_chat_split, load_tokenizer

__all__ = [
    "PREFILL_BUCKETS",
    "ByteTokenizer",
    "DeadlineExceeded",
    "EmbeddingEngine",
    "EngineUnavailable",
    "FaultInjected",
    "FaultInjector",
    "GenerationEngine",
    "GenerationResult",
    "HFTokenizer",
    "IncrementalDetokenizer",
    "ModelRegistry",
    "ModelSpec",
    "RequestPoisoned",
    "RequestScheduler",
    "SchedulerConfig",
    "SchedulerRejected",
    "StreamChunk",
    "TokenStream",
    "encode_chat_split",
    "load_tokenizer",
    "pick_bucket",
]
