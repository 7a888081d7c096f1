"""Grammar-constrained JSON decoding: char-level DFA -> token-level device tables
(a copy of the JAX package's ``ops/json_fsm.py``, which is numpy only but sits
in a package whose ``serving/__init__`` imports JAX).

SURVEY.md §7 hard part (d).  The reference gets JSON out of its models by asking
nicely and retrying up to 5 times with an LLM-side repair loop (reference:
assistant/ai/providers/ollama.py:49-107).  Here the decoder *cannot* emit invalid
JSON: a deterministic automaton over the JSON grammar rides inside the decode
tick as two tables on the device,

- ``next_state[state, token] -> state`` (dead state = invalid), and
- ``allowed[state, token]`` (= next_state != dead, with EOS handled specially),

so constrained sampling is one gather + one mask per tick — no host round trip,
fully compatible with the engine's lookahead pipeline (the FSM state chains
device-to-device exactly like the sampled-token array).

Construction is two-stage, Outlines-style but from scratch:

1. a char-level DFA over bytes for JSON values with a *bounded container stack*
   (object/array nesting encoded in the state, depth <= ``max_depth``), built by
   BFS over reachable (mode, stack) pairs;
2. closure over the tokenizer: a token is allowed in state ``s`` iff consuming its
   bytes from ``s`` never hits the dead state; computed vectorised over all
   (state, token) pairs at once.

Generation under the mask always terminates at a *complete* top-level object or
array: accepting states allow only EOS.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

WS = frozenset(b" \t\n\r")
DIGITS = frozenset(b"0123456789")
HEX = frozenset(b"0123456789abcdefABCDEF")
ESCAPABLE = frozenset(b'"\\/bfnrt')

# number phases that form a complete number (a terminator char may follow)
_NUM_COMPLETE = {"int", "int0", "frac", "exp"}


def _after_value(stack: tuple):
    if not stack:
        return ("done", ())
    return (("obj_comma", stack) if stack[-1] == "o" else ("arr_comma", stack))


def _start_value(stack: tuple, c: int, max_depth: int):
    """Dispatch the first char of a JSON value (stack already reflects context)."""
    if c == ord("{"):
        if len(stack) >= max_depth:
            return None
        return ("obj_open", stack + ("o",))
    if c == ord("["):
        if len(stack) >= max_depth:
            return None
        return ("arr_open", stack + ("a",))
    if c == ord('"'):
        return (("str", "val"), stack)
    if c == ord("-"):
        return (("num", "minus"), stack)
    if c == ord("0"):
        return (("num", "int0"), stack)
    if c in DIGITS:
        return (("num", "int"), stack)
    if c == ord("t"):
        return (("lit", "rue"), stack)
    if c == ord("f"):
        return (("lit", "alse"), stack)
    if c == ord("n"):
        return (("lit", "ull"), stack)
    return None


def _char_step(state, c: int, max_depth: int):
    """One byte through the automaton.  state = (mode, stack); None = dead."""
    mode, stack = state

    if mode == "done":
        return None  # accepting: only EOS may follow

    if mode == "top":
        if c in WS:
            return state
        if c in (ord("{"), ord("[")):  # top level restricted to object/array
            return _start_value(stack, c, max_depth)
        return None

    if mode == "value":
        if c in WS:
            return state
        return _start_value(stack, c, max_depth)

    if mode == "obj_open":  # just after '{'
        if c in WS:
            return state
        if c == ord('"'):
            return (("str", "key"), stack)
        if c == ord("}"):
            return _after_value(stack[:-1])
        return None

    if mode == "obj_key":  # after ',' in an object
        if c in WS:
            return state
        if c == ord('"'):
            return (("str", "key"), stack)
        return None

    if mode == "colon":
        if c in WS:
            return state
        if c == ord(":"):
            return ("value", stack)
        return None

    if mode == "obj_comma":  # after a value inside an object
        if c in WS:
            return state
        if c == ord(","):
            return ("obj_key", stack)
        if c == ord("}"):
            return _after_value(stack[:-1])
        return None

    if mode == "arr_open":  # just after '['
        if c in WS:
            return state
        if c == ord("]"):
            return _after_value(stack[:-1])
        return _start_value(stack, c, max_depth)

    if mode == "arr_comma":  # after a value inside an array
        if c in WS:
            return state
        if c == ord(","):
            return ("value", stack)
        if c == ord("]"):
            return _after_value(stack[:-1])
        return None

    if isinstance(mode, tuple) and mode[0] == "str":
        tag = mode[1]
        if c == ord('"'):
            return (("colon", stack) if tag == "key" else _after_value(stack))
        if c == ord("\\"):
            return (("esc", tag), stack)
        if c >= 0x20:  # any non-control byte incl. UTF-8 continuation bytes
            return state
        return None

    if isinstance(mode, tuple) and mode[0] == "esc":
        tag = mode[1]
        if c in ESCAPABLE:
            return (("str", tag), stack)
        if c == ord("u"):
            return (("hex", tag, 4), stack)
        return None

    if isinstance(mode, tuple) and mode[0] == "hex":
        tag, left = mode[1], mode[2]
        if c in HEX:
            return (("str", tag), stack) if left == 1 else (("hex", tag, left - 1), stack)
        return None

    if isinstance(mode, tuple) and mode[0] == "lit":
        rest = mode[1]
        if c == rest[0] if isinstance(rest[0], int) else c == ord(rest[0]):
            rest2 = rest[1:]
            return _after_value(stack) if not rest2 else (("lit", rest2), stack)
        return None

    if isinstance(mode, tuple) and mode[0] == "num":
        phase = mode[1]
        if phase == "minus":
            if c == ord("0"):
                return (("num", "int0"), stack)
            if c in DIGITS:
                return (("num", "int"), stack)
            return None
        if phase == "int0":  # a single leading 0
            if c == ord("."):
                return (("num", "frac0"), stack)
            if c in (ord("e"), ord("E")):
                return (("num", "exp0"), stack)
            # 0 followed by digit is invalid JSON; terminator handled below
        elif phase == "int":
            if c in DIGITS:
                return state
            if c == ord("."):
                return (("num", "frac0"), stack)
            if c in (ord("e"), ord("E")):
                return (("num", "exp0"), stack)
        elif phase == "frac0":
            return (("num", "frac"), stack) if c in DIGITS else None
        elif phase == "frac":
            if c in DIGITS:
                return state
            if c in (ord("e"), ord("E")):
                return (("num", "exp0"), stack)
        elif phase == "exp0":
            if c in (ord("+"), ord("-")):
                return (("num", "exp0s"), stack)
            return (("num", "exp"), stack) if c in DIGITS else None
        elif phase == "exp0s":
            return (("num", "exp"), stack) if c in DIGITS else None
        elif phase == "exp":
            if c in DIGITS:
                return state
        # complete number + terminator: resolve the value, re-apply the char
        if phase in _NUM_COMPLETE:
            return _char_step(_after_value(stack), c, max_depth)
        return None

    raise AssertionError(f"unknown mode {mode!r}")


@dataclasses.dataclass
class CharDFA:
    table: np.ndarray  # [S, 257] int32; column 256 is the identity/pad column
    initial: int
    dead: int
    accepting: np.ndarray  # [S] bool


def build_char_dfa(max_depth: int = 4) -> CharDFA:
    """Enumerate reachable (mode, stack) states by BFS and tabulate transitions."""
    initial = ("top", ())
    index: Dict = {initial: 0}
    order = [initial]
    rows: List[List[Optional[Tuple]]] = []
    i = 0
    while i < len(order):
        state = order[i]
        row: List[Optional[Tuple]] = []
        for c in range(256):
            nxt = _char_step(state, c, max_depth)
            if nxt is not None and nxt not in index:
                index[nxt] = len(order)
                order.append(nxt)
            row.append(nxt)
        rows.append(row)
        i += 1

    S = len(order) + 1  # + dead state
    dead = S - 1
    table = np.full((S, 257), dead, np.int32)
    for si, row in enumerate(rows):
        for c, nxt in enumerate(row):
            if nxt is not None:
                table[si, c] = index[nxt]
    table[:, 256] = np.arange(S)  # pad column: identity (used by the token closure)
    table[dead, :] = dead
    accepting = np.zeros((S,), bool)
    for st, si in index.items():
        if st[0] == "done":
            accepting[si] = True
    return CharDFA(table=table, initial=0, dead=dead, accepting=accepting)


@dataclasses.dataclass
class TokenFSM:
    next_state: np.ndarray  # [S, V] int32
    allowed: np.ndarray  # [S, V] bool — in accepting states only EOS is allowed
    initial: int
    dead: int
    accepting: np.ndarray  # [S] bool


def token_bytes_for(tokenizer) -> List[bytes]:
    """Byte string each token id appends to the output stream.

    Tokenizers that know their exact byte tables expose ``token_bytes()``
    (ByteTokenizer does).  For HF/SentencePiece tokenizers, a bare
    ``decode([i])`` is unsound — it strips the leading-space marker (``▁true``
    renders as ``"true"``, losing the space) — so each token is rendered *after*
    an anchor token and the anchor's prefix is stripped, preserving interior
    spacing (the Outlines-style construction)."""
    if hasattr(tokenizer, "token_bytes"):
        return tokenizer.token_bytes()
    V = getattr(tokenizer, "vocab_size", None)
    if V is None:
        raise ValueError("tokenizer must expose vocab_size for constrained decoding")
    special = {tokenizer.eos_id, tokenizer.pad_id, getattr(tokenizer, "bos_id", -1)}
    anchor_ids = [i for i in tokenizer.encode(":") if i not in special]
    anchor = anchor_ids[-1] if anchor_ids else None
    prefix = tokenizer.decode([anchor]) if anchor is not None else ""
    out = []
    for i in range(V):
        if i in special:
            out.append(b"")
            continue
        if anchor is not None:
            s = tokenizer.decode([anchor, i])
            text = s[len(prefix):] if s.startswith(prefix) else tokenizer.decode([i])
        else:
            text = tokenizer.decode([i])
        out.append(text.encode("utf-8"))
    return out


def build_token_fsm(
    dfa: CharDFA, token_bytes: Sequence[bytes], eos_id: int
) -> TokenFSM:
    """Close the char DFA over whole tokens, vectorised over (state, token)."""
    S = dfa.table.shape[0]
    V = len(token_bytes)
    max_len = max((len(b) for b in token_bytes), default=1) or 1
    chars = np.full((V, max_len), 256, np.int32)  # 256 = identity pad column
    for i, b in enumerate(token_bytes):
        if b:
            chars[i, : len(b)] = np.frombuffer(b, np.uint8)

    cur = np.broadcast_to(np.arange(S, dtype=np.int32)[:, None], (S, V)).copy()
    for pos in range(max_len):
        cur = dfa.table[cur, chars[None, :, pos]]

    next_state = cur
    allowed = next_state != dfa.dead
    # empty tokens (specials, zero-byte artifacts) would self-loop forever
    empty = np.asarray([len(b) == 0 for b in token_bytes])
    allowed[:, empty] = False
    next_state = np.where(allowed, next_state, dfa.dead)
    # EOS: allowed exactly in accepting states (and nothing else is)
    allowed[dfa.accepting, :] = False
    if 0 <= eos_id < V:
        allowed[dfa.accepting, eos_id] = True
        next_state[dfa.accepting, eos_id] = np.flatnonzero(dfa.accepting)[0]
    return TokenFSM(
        next_state=next_state,
        allowed=allowed,
        initial=dfa.initial,
        dead=dfa.dead,
        accepting=dfa.accepting,
    )


def fsm_for_tokenizer(tokenizer, *, max_depth: int = 4) -> TokenFSM:
    return build_token_fsm(
        build_char_dfa(max_depth), token_bytes_for(tokenizer), tokenizer.eos_id
    )
