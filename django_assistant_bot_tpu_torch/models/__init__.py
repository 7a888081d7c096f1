"""Model families of the port: the Llama-family decoder (with Mixtral's MoE
MLP) and the BERT encoder."""

from . import encoder, llama, mixtral
from .config import DecoderConfig, EncoderConfig

__all__ = ["DecoderConfig", "EncoderConfig", "encoder", "llama", "mixtral"]
