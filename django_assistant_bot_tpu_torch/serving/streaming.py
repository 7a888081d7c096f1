"""Token streaming primitives: engine tick -> async consumer, UTF-8-safe (a
copy of the JAX package's ``serving/streaming.py``, stdlib only, whose
package ``__init__`` imports JAX).

The serving plane used to be strictly request/response: the engine samples
tokens tick-by-tick, but no layer could observe a partial generation, so the
user stares at a typing indicator for the full generation wall time and TTFT
was unmeasurable end-to-end.  This module is the bridge:

- :class:`TokenStream` — a per-request bounded event queue fed from the engine
  thread as already-in-flight device results resolve in ``_process_tick``
  (piggybacking on the existing async ``_TickRef`` consumption: pushing a
  sampled id is a deque append, NO new blocking device-to-host copy per token) and
  drained by one asyncio consumer.  The producer never blocks — capacity is
  ``max_tokens + 2``, which the generation can never exceed — so a slow SSE
  client cannot throttle the decode tick.
- :class:`IncrementalDetokenizer` — streaming decode that never emits a
  replacement character for an incomplete multi-byte/BPE fragment: partial
  sequences are held back and flushed once completed.  The concatenation of
  every emitted delta is byte-identical to the one-shot decode of the same
  ids.
- :class:`StreamChunk` — one event of ``GenerationEngine.generate_stream()``:
  a token delta, or the terminal chunk carrying the finish reason and the
  full :class:`~.engine.GenerationResult`.

Cancellation contract: abandoning the ``generate_stream`` iterator (client
disconnect) cancels the request's future; the engine's per-iteration reap
(:meth:`GenerationEngine._reap_dead_slots` — the deadline epoch mechanism)
frees the decode slot within one tick instead of burning the rest of the
generation on a consumer nobody is reading.  The JAX package's
docs/STREAMING.md gives the wire format.
"""

from __future__ import annotations

import asyncio
import codecs
import collections
import dataclasses
import logging
import threading
from concurrent.futures import CancelledError, Future
from typing import Any, AsyncIterator, List, Optional, Tuple

logger = logging.getLogger(__name__)


@dataclasses.dataclass
class StreamChunk:
    """One streaming event.

    ``index`` is the 0-based generated-token index; ``text`` the UTF-8-safe
    delta (may be ``""`` while a multi-byte fragment is held back).  The
    terminal chunk has ``done=True``, the ``finish_reason`` (``"stop"`` on
    EOS, ``"length"`` when length-limited), any held-back text tail, and the
    full :class:`~.engine.GenerationResult` — whose ``text`` equals the
    concatenation of every ``text`` delta, byte for byte."""

    index: int
    token_id: Optional[int]
    text: str
    done: bool = False
    finish_reason: Optional[str] = None
    result: Any = None


class TokenStream:
    """Thread-safe producer (engine thread) -> single async consumer bridge.

    The engine side (:meth:`push_token`, :meth:`finish`) only appends under a
    lock and pokes the consumer's loop via ``call_soon_threadsafe`` — no
    waiting, no device work.  ``finish`` is wired as the request future's
    done-callback, so EVERY resolution path (normal finish, deadline expiry,
    engine failure, client cancel) terminates the stream exactly once.
    """

    def __init__(self) -> None:
        self._events: "collections.deque[Tuple[str, Any]]" = collections.deque()
        self._lock = threading.Lock()
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._wake: Optional[asyncio.Event] = None
        self._capacity: Optional[int] = None
        self._closed = False
        # coalesced wakeups: one call_soon_threadsafe per consumer drain
        # cycle, not per token — cross-thread notification is the only
        # non-trivial producer cost and a burst tick pushes many tokens
        self._notify_pending = False
        self.dropped = 0  # defensive only: capacity covers max_tokens + terminal

    def bind(self, loop: asyncio.AbstractEventLoop, capacity: int) -> "TokenStream":
        """Attach the consumer's event loop.  ``capacity`` bounds queued token
        events; callers size it ``max_tokens + 2`` so the producer can never
        hit the bound (the generation itself is shorter)."""
        self._loop = loop
        self._wake = asyncio.Event()
        self._capacity = max(1, int(capacity))
        return self

    # --------------------------------------------------------- producer side
    def push_token(self, tok: int, *, notify: bool = True) -> bool:
        """Append a token event.  With ``notify=False`` the wakeup is the
        caller's responsibility (:meth:`notify_now`) — the engine defers it to
        the end of its tick processing so a burst of pushes costs ONE
        cross-thread wakeup per stream per tick, fired right before the
        engine thread goes back to (GIL-releasing) device work instead of
        mid-bookkeeping where the handoff stalls it.  Returns True when a
        deferred wakeup is owed."""
        with self._lock:
            if self._closed:
                return False
            if self._capacity is not None and len(self._events) >= self._capacity:
                # unreachable when capacity >= max_tokens + 1; never block the
                # engine thread on a consumer — drop and count instead
                self.dropped += 1
                return False
            self._events.append(("token", tok))
            need_notify = not self._notify_pending
            self._notify_pending = True
        if need_notify and notify:
            self._notify()
            return False
        return need_notify

    def notify_now(self) -> None:
        """Deliver a wakeup deferred by ``push_token(notify=False)``."""
        self._notify()

    def finish(self, fut: Future) -> None:
        """Future done-callback: terminal event (result or exception)."""
        if fut.cancelled():
            payload: Any = CancelledError()
        else:
            exc = fut.exception()
            payload = exc if exc is not None else fut.result()
        with self._lock:
            if self._closed:
                return
            self._closed = True
            self._events.append(("done", payload))
            self._notify_pending = True
        # terminal always notifies: it must never coalesce into a wakeup the
        # consumer already consumed
        self._notify()

    def _notify(self) -> None:
        loop, wake = self._loop, self._wake
        if loop is None or wake is None:
            return
        try:
            loop.call_soon_threadsafe(wake.set)
        except RuntimeError:
            pass  # consumer loop already closed; events stay queued, unread

    # --------------------------------------------------------- consumer side
    async def __aiter__(self) -> AsyncIterator[Tuple[str, Any]]:
        assert self._wake is not None, "bind() the consumer loop before iterating"
        while True:
            self._wake.clear()
            with self._lock:
                batch = list(self._events)
                self._events.clear()
                closed = self._closed
                # drained: the next producer append must schedule a wakeup
                self._notify_pending = False
            for ev in batch:
                yield ev
                if ev[0] == "done":
                    return
            if closed:
                return
            await self._wake.wait()


class IncrementalDetokenizer:
    """UTF-8-safe streaming decode: hold back incomplete fragments, flush on
    completion; the concatenated output is byte-identical to the one-shot
    decode of the same ids.

    Two paths:

    - **byte-level** (``tokenizer.byte_level``, e.g. :class:`ByteTokenizer`):
      each id maps to raw bytes (``token_bytes()``) and decode is plain UTF-8
      of the concatenation — an incremental UTF-8 codec holds partial
      multi-byte sequences exactly like the one-shot ``errors="replace"``
      decode would resolve them.  O(1) per token.
    - **general** (HF/BPE): re-decode the full id list and emit the suffix
      past what was already emitted, holding back any *trailing* U+FFFD run
      (an in-flight byte-fallback sequence the next token may complete).
      O(n) decode per token — bounded by ``max_tokens``, and the decode of a
      few-hundred-token list is microseconds on HF fast tokenizers.
    """

    def __init__(self, tokenizer) -> None:
        self._tok = tokenizer
        self._byte_table: Optional[List[bytes]] = None
        if getattr(tokenizer, "byte_level", False):
            tb = getattr(tokenizer, "token_bytes", None)
            if callable(tb):
                self._byte_table = tb()
        if self._byte_table is not None:
            self._dec = codecs.getincrementaldecoder("utf-8")("replace")
        else:
            self._ids: List[int] = []
            self._emitted = ""
            self._warned = False

    def push(self, tok: int) -> str:
        """Feed one token id; return the newly-safe text delta (may be "")."""
        if self._byte_table is not None:
            b = self._byte_table[tok] if 0 <= tok < len(self._byte_table) else b""
            return self._dec.decode(b)
        self._ids.append(tok)
        full = self._tok.decode(self._ids)
        if not full.startswith(self._emitted):
            # non-prefix-stable decode (pathological tokenizer): stop emitting
            # mid-stream; flush() reconciles against the final full decode
            return ""
        delta = full[len(self._emitted):]
        while delta.endswith("�"):
            delta = delta[:-1]
        self._emitted += delta
        return delta

    def flush(self) -> str:
        """Emit everything still held back (end of generation)."""
        if self._byte_table is not None:
            return self._dec.decode(b"", True)
        full = self._tok.decode(self._ids) if self._ids else ""
        if full.startswith(self._emitted):
            delta = full[len(self._emitted):]
        else:  # pragma: no cover - non-prefix-stable decode; keep totals honest
            if not self._warned:
                self._warned = True
                logger.warning(
                    "incremental detokenizer: decode is not prefix-stable; "
                    "final delta reconciled against the one-shot decode"
                )
            delta = full
            self._emitted = ""
        self._emitted += delta
        return delta
