"""Tokenisation for the serving plane (a copy of the JAX package's
``serving/tokenizer.py``, which has no JAX in it but sits in a package whose
``__init__`` imports JAX).

Wraps HF fast tokenizers when a checkpoint directory ships one; falls back to a
byte-level tokenizer (vocab 256 + specials) so every code path — engine, server,
providers, tests — runs without any tokenizer asset.  Also owns chat-prompt
construction: HF chat templates when available, else the reference's plain
``"role: content"`` join (reference: assistant/ai/providers/transformers.py:50).
"""

from __future__ import annotations

from typing import List, Optional, Protocol, Sequence


class Tokenizer(Protocol):
    eos_id: int
    pad_id: int

    def encode(self, text: str) -> List[int]: ...
    def encode_chat(self, messages: Sequence[dict]) -> List[int]: ...
    def decode(self, ids: Sequence[int]) -> str: ...
    def apply_chat(self, messages: Sequence[dict]) -> str: ...


class ByteTokenizer:
    """UTF-8 byte tokenizer: ids 0..255 are bytes; 256=pad, 257=bos, 258=eos."""

    vocab_size = 259
    pad_id = 256
    bos_id = 257
    eos_id = 258
    # decode == UTF-8 of the concatenated token_bytes(): the streaming
    # detokenizer may use its O(1)-per-token incremental-codec fast path
    byte_level = True

    def encode(self, text: str) -> List[int]:
        return [self.bos_id] + list(text.encode("utf-8"))

    def decode(self, ids: Sequence[int]) -> str:
        return bytes(i for i in ids if 0 <= i < 256).decode("utf-8", errors="replace")

    def token_bytes(self) -> List[bytes]:
        """Exact bytes per id (constrained decoding); specials render nothing."""
        return [bytes([i]) for i in range(256)] + [b"", b"", b""]

    def apply_chat(self, messages: Sequence[dict]) -> str:
        return render_plain_chat(messages)

    def encode_chat(self, messages: Sequence[dict]) -> List[int]:
        return self.encode(self.apply_chat(messages))


class HFTokenizer:
    """Wrapper over a transformers fast tokenizer loaded from a model directory."""

    def __init__(self, tok):
        self._tok = tok
        self.eos_id = tok.eos_token_id if tok.eos_token_id is not None else -1
        pad = tok.pad_token_id
        self.pad_id = pad if pad is not None else (self.eos_id if self.eos_id >= 0 else 0)
        self.vocab_size = len(tok)  # incl. added tokens — ids the model can emit

    def encode(self, text: str) -> List[int]:
        return self._tok.encode(text)

    def decode(self, ids: Sequence[int]) -> str:
        return self._tok.decode(list(ids), skip_special_tokens=True)

    def apply_chat(self, messages: Sequence[dict]) -> str:
        if getattr(self._tok, "chat_template", None):
            return self._tok.apply_chat_template(
                list(messages), tokenize=False, add_generation_prompt=True
            )
        return render_plain_chat(messages)

    def encode_chat(self, messages: Sequence[dict]) -> List[int]:
        """Chat templates already render BOS text — encode without special tokens to
        avoid the classic double-BOS degradation."""
        if getattr(self._tok, "chat_template", None):
            return self._tok.encode(self.apply_chat(messages), add_special_tokens=False)
        return self.encode(render_plain_chat(messages))


def encode_chat_split(tok: Tokenizer, messages: Sequence[dict]) -> tuple[List[int], int]:
    """Encode a chat and report how many leading tokens form a stable prefix.

    The prefix covers every message before the last (system prompt + history +
    packed RAG context — the block the engine's prefix KV cache can reuse
    across requests).  Correctness-first: the split is only reported when the
    prefix's own encoding is EXACTLY a prefix of the full encoding (BPE merges
    can straddle the boundary; then 0 is returned and the engine simply
    prefills in full)."""
    ids = tok.encode_chat(messages)
    if len(messages) < 2:
        return ids, 0
    head = list(messages[:-1])
    try:
        inner = getattr(tok, "_tok", None)
        if inner is not None and getattr(inner, "chat_template", None):
            prefix_str = inner.apply_chat_template(
                head, tokenize=False, add_generation_prompt=False
            )
            prefix_ids = _encode_head_cached(
                tok, prefix_str, lambda: inner.encode(prefix_str, add_special_tokens=False)
            )
        else:
            prefix_str = "\n".join(f"{m['role']}: {m['content']}" for m in head) + "\n"
            prefix_ids = _encode_head_cached(tok, prefix_str, lambda: tok.encode(prefix_str))
    except Exception:
        return ids, 0
    n = len(prefix_ids)
    if 0 < n < len(ids) and ids[:n] == prefix_ids:
        return ids, n
    return ids, 0


def _encode_head_cached(tok, prefix_str: str, encode) -> List[int]:
    """Memoize the shared head's encoding on the tokenizer instance.

    The prefix-KV workload re-sends a near-identical multi-kilobyte head every
    turn; without this the hot path tokenizes that head twice per request
    (full prompt + verification encode).  Small LRU per tokenizer; falls back
    to plain encode on objects that refuse attributes (e.g. __slots__)."""
    try:
        cache = tok.__dict__.setdefault("_head_encode_cache", {})
    except AttributeError:
        return encode()
    hit = cache.get(prefix_str)
    if hit is not None:
        return hit
    out = encode()
    if len(cache) >= 64:
        cache.clear()  # tiny, regenerable; wholesale reset beats LRU plumbing
    cache[prefix_str] = out
    return out


def render_plain_chat(messages: Sequence[dict]) -> str:
    """The reference's prompt construction: newline-joined "role: content" plus a
    trailing assistant cue (reference: assistant/ai/providers/transformers.py:50)."""
    lines = [f"{m['role']}: {m['content']}" for m in messages]
    lines.append("assistant:")
    return "\n".join(lines)


def load_tokenizer(model_dir: Optional[str]) -> Tokenizer:
    """HF tokenizer if the directory has one, else the byte fallback."""
    if model_dir:
        try:
            from transformers import AutoTokenizer

            return HFTokenizer(AutoTokenizer.from_pretrained(model_dir))
        except Exception:
            pass
    return ByteTokenizer()
