"""Model families of the port (decoders; the encoder comes with ROADMAP Queue 1 item 7)."""

from . import llama
from .config import DecoderConfig

__all__ = ["DecoderConfig", "llama"]
