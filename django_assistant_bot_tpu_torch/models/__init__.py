"""Model families of the port: the Llama-family decoder and the BERT encoder."""

from . import encoder, llama
from .config import DecoderConfig, EncoderConfig

__all__ = ["DecoderConfig", "EncoderConfig", "encoder", "llama"]
