"""Continuous-batching generation engine, paged KV (port of ``serving/engine.py``).

The port runs the JAX engine's default decode loop at the JAX ``ModelSpec``
defaults: ``kv_layout="paged"`` with prefix sharing, fused
``decode_steps``-step ticks, chunked prefill piggybacked into the decode
tick, the admission-controlled :class:`~.scheduler.RequestScheduler`, the
observability plane and crash-only supervision, with token streaming and
JSON-constrained decoding and tree-verified speculative decoding, over a
page pool of the model's dtype, bf16 or fp8 (``kv_cache_dtype``), read by
the dequant path or, with ``attn_fp8``, by the fp8 in-dot decode.  What is
ported is the JAX engine's own logic:

- **KV layouts.**  ``kv_layout="paged"`` (the default, the rest of this
  list) or ``"legacy"``: the JAX rollback plane, one contiguous slot cache
  row of ``max_seq_len`` positions per slot (:class:`~..models.llama.
  KVCache`), also taken when no page size divides the context.  Its decode
  step reads ``decode_kv_chunk``-wide chunks up to the batch's longest live
  position (the chunked decode kernel on the card) or, with None, the
  whole row; a prefill wave's pad rows alias its first slot and are
  written before it; prefix sharing pins a registered prefix's K/V
  (``_prefix_lru``, LRU under ``prefix_cache_size`` and the byte budget)
  and copies it into a hit's row; a speculative tick commits the accepted
  path at each row's length.  The ticks, the piggyback program, JSON,
  streaming and supervision are the paged layout's.

- **Admission.**  Free slots take queued requests in the scheduler's
  weighted-fair-share order (FIFO with ``scheduler=None``); each reserves
  ``ceil((prompt + max_tokens) / page)`` pages up front, so decode can never
  run out of pages mid-stream.  A wave is grouped by prefill bucket and each
  group is one prefill call whose batch pads to a batch bucket of {1, 4,
  max_slots}; pad rows come first and carry the slot-count and page
  sentinels, so their writes drop.  Prompts whose un-shared remainder is
  longer than ``chunk_size`` prefill one chunk per loop iteration, one at a
  time.  With a scheduler, ``submit`` may shed synchronously
  (:class:`~.scheduler.SchedulerRejected`), and deadlines are reaped while
  queued and while live.
- **Prefix sharing.**  A request's declared prefix (``prefix_len``: the
  system prompt and packed RAG context, every message before the last) is
  registered with the page allocator after its prefill.  A later prompt
  that starts with a registered prefix (longest match) shares its full pages
  read-only, takes a copy-on-write clone of the boundary page
  (:func:`~..models.llama.copy_pages`), and prefills only its suffix
  (:func:`~..models.llama.prefill_suffix_paged`, or chunks from the prefix
  length when the suffix is longer than a chunk).  Shared pages are never
  rewritten.
- **Fused decode ticks.**  One tick runs ``decode_steps`` chained
  :func:`~..models.llama.decode_step_paged` plus sampling steps for every
  live slot and yields the sampled ids ``[K, B]``; the last step's ids stay
  on the device and chain into the next tick, and their host copies are
  consumed ``lookahead`` ticks behind, so the host never waits on the tick
  it just issued.  Each step's sampling noise is drawn by the engine's
  generator into a buffer before the tick (one draw per step, as an N=1
  engine draws), so sampled ids do not depend on ``decode_steps``.  A slot
  finishes on EOS, on ``max_tokens`` or at the context; its later tokens in
  the tick are dropped, and its writes past its reservation land in the dump
  page.  On the card the tick is a CUDA graph captured once per engine (at
  construction) and replayed once per tick; on the CPU it is a Python loop.
- **Piggybacked prefill.**  While a slot is mid-chunked-prefill, a live
  batch exists and the chunk is not the final one, the chunk and the decode
  tick run as one program, chunk first (the JAX piggyback program's order:
  the chunk consumes no noise and writes only its own slot's pages, so the
  ids are those of the sequential path).  On the card that program is a
  second CUDA graph, captured with the tick's, whose chunk reads its ids,
  page chain, slot and start from buffers; on the CPU it is the chunk then
  the steps.  Otherwise the chunk runs on its own and the tick waits for it
  (``prefill_displacement_frac``); the final chunk always does, since its
  logits feed the slot's first token.
- **Supervision.**  A loop error is engine-fatal: the crash-only
  :meth:`GenerationEngine._restart` rebuilds the device state in place (the
  captured graphs keep every address), resubmits requests that emitted no
  token at the head of their queue, fails those past their first token, and
  leaves queued work alone; restarts back off, and ``max_restarts`` inside
  ``restart_window_s`` open a circuit during which ``submit`` raises
  :class:`EngineUnavailable`.  Garbage sampled ids and a failed
  detokenization are request poison: one request fails, the batch goes on.
  ``faults`` injects both kinds (:mod:`.faults`).
- **Streaming.**  :meth:`GenerationEngine.generate_stream` yields text
  deltas as the ids of in-flight ticks reach the host in
  :meth:`~GenerationEngine._process_tick` (a deque append per token, no
  device sync of its own; :mod:`.streaming`), then a terminal chunk with
  the result.  Abandoning the iterator cancels the request, and the reap
  frees its slot within one tick.
- **JSON-constrained decoding.**  ``submit(json_format=True)`` samples under
  the JSON grammar's token FSM (:mod:`..ops.json_fsm`, built on the host
  once per tokenizer, its ``allowed`` / ``next_state`` tables on the device
  padded to the model vocab).  A JSON slot's first token takes the initial
  state's mask; while any JSON slot is live the engine issues single-step
  JSON ticks (the JAX rule: ``json_downgraded_ticks`` counts them) and no
  chunk piggybacks; each step masks the JSON rows by their state and
  advances it in the fused sampler.  On the card the JSON tick is a third
  CUDA graph in the same pool, captured at the first JSON request or in
  :meth:`~GenerationEngine.warmup`.
- **Speculative decoding.**  ``speculative=K`` (with ``spec_width=N``):
  each tick drafts a token tree per slot from the slot's device token
  history (prompt-lookup, :mod:`..ops.speculative`; the history is seeded
  with the prompt at admission and extended by each verify step), verifies
  every node in one read-only forward
  (:func:`~..models.llama.verify_tree_step_paged`, whose attention is the
  paged tree kernel on the card), accepts the longest root-to-leaf run
  matching the model's argmax (greedy rows; sampled rows take the
  position-0 draw), commits that path's K/V through the block table and
  advances the lengths, tokens and history: up to K+1 tokens a slot per
  verify step, greedy output unchanged.  A tick runs one verify step unless
  ``decode_steps`` is given (then that many).  The JAX acceptance-EMA
  controller picks a rung of the tree ladder per tick, or a plain tick when
  no rung pays for its verify forward at the measured cost ratios
  (:meth:`~GenerationEngine.probe_spec`); under the scheduler's
  degradation band the engine ticks plain.  On the card each rung's tick is
  its own CUDA graph in the tick's pool, captured at construction.  Spec
  engines do not piggyback chunks and refuse ``json_format``, as in JAX.
- **Observability.**  With ``obs`` on, :class:`~.obs.EngineObs` records
  TTFT, inter-token, queue-wait and tick histograms, request traces and a
  flight recorder, all host bookkeeping after a tick's ids reached the host;
  its queue-wait histogram floors the scheduler's estimated wait.
- **A background thread** runs the loop; ``submit`` is thread-safe and
  returns a ``concurrent.futures.Future``; ``generate`` awaits one from
  asyncio.
"""

from __future__ import annotations

import asyncio
import collections
import contextlib
import dataclasses
import logging
import queue
import threading
import time
import weakref
from concurrent.futures import Future, InvalidStateError
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from .. import kernels
from ..device import DeviceLike, resolve_device
from ..models import DecoderConfig, EncoderConfig, encoder, llama
from ..ops.quant import FP8_DTYPES, KV_CACHE_DTYPES, check_kernel_params, weight_bits
from ..ops.json_fsm import TokenFSM, fsm_for_tokenizer
from ..ops.sampling import gumbel_noise, noise_width, sample_logits
from ..ops.speculative import (
    SpecController,
    accept_tree,
    breakeven_accept_rate,
    build_tree_draft,
    default_rungs,
    flatten_tree,
    make_tree_spec,
)
from .faults import FaultInjected, FaultInjector
from .kv_pool import PageAllocator, SharedPrefix
from .obs import EngineObs, new_trace_id
from .scheduler import DeadlineExceeded, RequestScheduler, SchedulerRejected
from .streaming import IncrementalDetokenizer, StreamChunk, TokenStream
from .tokenizer import Tokenizer, encode_chat_split

logger = logging.getLogger(__name__)

PREFILL_BUCKETS = (32, 64, 128, 256, 512, 1024, 2048, 4096, 8192)
TOP_K = 50  # sampling's top-k, the JAX engine's default
IDLE_POLL_S = 0.002  # loop sleep when there is no work

# the JSON token FSM per tokenizer, built on the host once (ops/json_fsm.py)
_FSM_CACHE: "weakref.WeakKeyDictionary[Any, TokenFSM]" = weakref.WeakKeyDictionary()
_FSM_LOCK = threading.Lock()


def token_fsm(tokenizer) -> TokenFSM:
    """The JSON grammar's token FSM for ``tokenizer`` (cached per tokenizer)."""
    with _FSM_LOCK:
        fsm = _FSM_CACHE.get(tokenizer)
        if fsm is None:
            fsm = _FSM_CACHE[tokenizer] = fsm_for_tokenizer(tokenizer)
        return fsm


class RequestPoisoned(RuntimeError):
    """A failure attributable to one request (garbage sampled ids from a
    NaN'd logits row): that request's future fails with this and its slot is
    quarantined; batch-mates keep decoding."""

    def __init__(self, detail: str, slot: Optional[int] = None):
        super().__init__(detail)
        self.slot = slot


class EngineUnavailable(RuntimeError):
    """The engine's restart circuit is open (too many crash-only restarts in
    the window): ``submit`` fails fast with this instead of queueing work the
    engine cannot serve.  The HTTP layer maps it to 503 + ``Retry-After``
    (``retry_after_s`` is the remaining cooldown)."""

    def __init__(self, detail: str, retry_after_s: float):
        super().__init__(f"{detail} (retry after {retry_after_s:.1f}s)")
        self.retry_after_s = float(retry_after_s)


def _safe_resolve(fut: Future, *, result=None, exc: Optional[BaseException] = None):
    """set_result/set_exception tolerant of a client cancelling concurrently."""
    try:
        if exc is not None:
            fut.set_exception(exc)
        else:
            fut.set_result(result)
    except InvalidStateError:  # future was cancelled mid-flight
        pass


def pick_bucket(n: int, buckets: Sequence[int], cap: int) -> int:
    for b in buckets:
        if n <= b and b <= cap:
            return b
    return cap


@dataclasses.dataclass
class GenerationResult:
    token_ids: List[int]
    text: str
    prompt_tokens: int
    completion_tokens: int
    length_limited: bool
    ttft_s: float = 0.0
    latency_s: float = 0.0

    def usage_dict(self, model: str) -> dict:
        """The wire-format usage object of ``/dialog/`` responses."""
        return {
            "model": model,
            "prompt_tokens": self.prompt_tokens,
            "completion_tokens": self.completion_tokens,
            "total_tokens": self.prompt_tokens + self.completion_tokens,
            "ttft_s": self.ttft_s,
            "latency_s": self.latency_s,
        }


@dataclasses.dataclass
class _Request:
    prompt_ids: List[int]
    max_tokens: int
    temperature: float
    top_p: float
    future: Future
    submitted_at: float
    # leading prompt tokens that form a cacheable shared prefix (system prompt
    # + packed RAG context); 0 = no prefix-cache participation
    prefix_len: int = 0
    first_token_at: Optional[float] = None
    # scheduling metadata (serving/scheduler.py): class tag, fair-share
    # tenant, absolute monotonic deadline, whether try_admit already charged
    # the queue depth, and the worst-case page reservation it charged
    priority: str = "interactive"
    tenant: str = "default"
    deadline_at: Optional[float] = None
    admitted: bool = False
    kv_pages: int = 0
    # slot-residency start (prefill begins): the scheduler's service sample
    started_at: Optional[float] = None
    # crash-only restarts this request survived (resubmitted with no token
    # emitted), bounded by the engine's max_request_restarts
    restarts: int = 0
    # the request's correlation id (client X-Request-Id or generated at
    # submit), carried through the obs plane's traces and flight recorder
    trace_id: str = ""
    # JSON-constrained decoding (ops/json_fsm.py)
    json: bool = False
    # per-token event sink (streaming.TokenStream), fed in _process_tick as
    # the ids reach the host; None = request/response
    stream: Any = None


@dataclasses.dataclass
class _Slot:
    request: _Request
    generated: List[int] = dataclasses.field(default_factory=list)
    # host arrival time of the previous token (inter-token-latency samples)
    last_token_at: Optional[float] = None
    # decode steps the slot sat through (a fused tick charges all its steps
    # even when the request ends mid-tick) and the prefill chunks it took:
    # the per-token denominator of the scheduler's service model
    resident_steps: int = 0
    prefill_chunks: int = 0


class _HostCopy:
    """A device tensor's copy on its way to the host: started without
    blocking (pinned buffer + event on CUDA), waited for in :meth:`numpy`.
    On the CPU it is a copy taken now: the tick's output buffer is reused."""

    def __init__(self, t: torch.Tensor):
        if t.device.type == "cuda":
            self._host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            self._host.copy_(t, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record()
        else:
            self._host = t.clone()
            self._event = None

    def numpy(self) -> np.ndarray:
        if self._event is not None:
            self._event.synchronize()
        return self._host.numpy()


@dataclasses.dataclass
class _TickRef:
    """One issued-but-not-yet-processed device result.  ``slots`` records
    (slot, epoch) for every slot live at issue time; entries whose epoch has
    moved on (request finished earlier) are dropped.  A tick's ``nxt`` is
    ``[K, max_slots]`` ids, oldest step first.  ``first=True`` marks an
    activation: ``nxt`` holds the wave's first tokens, entry ``offset + j``
    belonging to ``slots[j]`` (rows below ``offset`` are batch padding)."""

    nxt: _HostCopy
    slots: List[tuple]
    first: bool = False
    offset: int = 0
    # a speculative tick: ``nxt`` is ``[N, K+1, max_slots]`` ids and
    # ``n_new`` ``[N, max_slots]`` valid-token counts (entry k of a step is
    # real only for k < n_new), drafted at ``spec_rung`` (width, depth)
    n_new: Optional[_HostCopy] = None
    spec_rung: Optional[tuple] = None


@dataclasses.dataclass
class _Prefix:
    """One cached prompt prefix of the legacy layout: post-RoPE K/V at
    absolute positions [0, pb) (``[L, KH, pb, D]`` each).  ``length`` is the
    prefix's token count; ``pb`` the bucket the tensors carry, whose tail
    [length, pb) the consuming suffix prefill overwrites or masks."""

    pk: torch.Tensor
    pv: torch.Tensor
    length: int
    pb: int

    @property
    def nbytes(self) -> int:
        return self.pk.numel() * self.pk.element_size() * 2


@dataclasses.dataclass
class _ChunkedPrefill:
    """An in-flight chunked prefill: one chunk per engine-loop iteration."""

    request: _Request
    slot: int
    ids: np.ndarray  # [n_chunks, chunk_size] — every chunk is full of real tokens
    starts: List[int]  # absolute start position of each chunk
    n: int  # true prompt length
    step: int = 0  # chunks completed


class GenerationEngine:
    """Continuous-batching decode engine over one decoder model, paged KV."""

    def __init__(
        self,
        cfg: DecoderConfig,
        params,
        tokenizer: Tokenizer,
        *,
        device: DeviceLike = "cuda",
        max_slots: int = 8,
        max_seq_len: Optional[int] = None,
        chunk_size: int = 512,
        lookahead: int = 3,
        burst: int = 8,
        decode_steps: Optional[int] = None,
        decode_kv_chunk: Optional[int] = 0,
        kv_page_size: int = 0,
        kv_pages: int = 0,
        prefill_piggyback: bool = True,
        prefix_cache_size: int = 8,
        prefix_min_tokens: int = 32,
        prefix_cache_max_bytes: int = 1 << 30,
        scheduler: Optional[RequestScheduler] = None,
        faults: Optional[FaultInjector] = None,
        max_restarts: int = 5,
        restart_window_s: float = 60.0,
        restart_backoff_s: float = 0.05,
        restart_backoff_max_s: float = 2.0,
        degraded_cooldown_s: float = 30.0,
        heartbeat_degraded_s: float = 30.0,
        max_request_restarts: int = 2,
        name: str = "engine",
        obs: bool = True,
        obs_dump_dir: Optional[str] = None,
        speculative: int = 0,
        spec_width: int = 4,
        spec_probe_every: int = 64,
        spec_explore_every: int = 32,
        kv_layout: str = "paged",
        kv_cache_dtype: Optional[str] = None,
        attn_fp8: bool = False,
    ):
        # "paged" (default): a pool of fixed-size pages plus per-slot block
        # tables; "legacy": the contiguous [max_slots, max_seq_len] slot
        # cache, the JAX engine's rollback and A/B plane.  A context no page
        # size divides falls back to legacy below, so kv_stats() reports
        # what was asked beside what runs.
        if kv_layout not in ("paged", "legacy"):
            raise ValueError(f"unknown kv_layout {kv_layout!r}; expected 'paged' or 'legacy'")
        self.kv_layout_requested = kv_layout
        self.paged = kv_layout == "paged"
        # the KV cache's precision (None: the model's dtype): "fp8" halves
        # the KV bytes; K/V cast at the cache write and widen in the read
        if kv_cache_dtype not in KV_CACHE_DTYPES:
            raise ValueError(
                f"unknown kv_cache_dtype {kv_cache_dtype!r}; "
                f"expected one of {sorted(k for k in KV_CACHE_DTYPES if k)}"
            )
        self.kv_cache_dtype = KV_CACHE_DTYPES[kv_cache_dtype]
        # fp8 in-dot decode attention: the query quantized to the pool's fp8
        # format, both products on fp8 values (needs an fp8 pool)
        self.attn_fp8 = bool(attn_fp8)
        if self.attn_fp8 and self.kv_cache_dtype not in FP8_DTYPES:
            raise ValueError(
                "attn_fp8=True requires an fp8 KV cache "
                "(kv_cache_dtype='fp8' or 'fp8_e5m2')"
            )
        if decode_steps is not None and int(decode_steps) < 1:
            raise ValueError(f"decode_steps must be >= 1 (got {decode_steps})")
        self.device = resolve_device(device)
        if params["tok_embed"].device != self.device:
            raise ValueError(
                f"params live on {params['tok_embed'].device}, engine device is {self.device}"
            )
        self.name = name
        # the observability plane: None is the A/B off arm (no recorder
        # object at all; the hot path pays one `is None` check)
        self.obs = EngineObs(name=name, dump_dir=obs_dump_dir) if obs else None
        if self.device.type == "cuda":
            check_kernel_params(params, cfg.dtype)
        self.cfg = cfg
        self.params = params
        # dominant layer-projection weight width (16 / 8 / 4), as the JAX
        # engine reports it
        self.weight_bits = weight_bits(params)
        self.tokenizer = tokenizer
        self.max_slots = max_slots
        self.max_seq_len = int(min(max_seq_len or cfg.max_seq_len, cfg.max_seq_len))
        self.prefill_buckets = tuple(b for b in PREFILL_BUCKETS if b <= self.max_seq_len) or (
            self.max_seq_len,
        )
        self.chunk_size = int(min(chunk_size, self.max_seq_len))
        self.lookahead = max(0, int(lookahead))
        # the JAX resolution: decode_steps wins when given, else burst; a
        # speculative engine runs one verify step a tick unless decode_steps
        # asks for more (burst describes plain-decode dispatch amortization)
        self.speculative = max(0, int(speculative))
        if decode_steps is not None:
            self.decode_steps = max(1, int(decode_steps))
        else:
            self.decode_steps = 1 if self.speculative else max(1, int(burst))
        self.spec_width = max(1, int(spec_width)) if self.speculative else 0
        if self.speculative and self.decode_steps * (self.speculative + 1) > self.max_seq_len // 4:
            # each verify step writes up to K+1 positions and that much
            # finish headroom is reserved: fail at load, as the JAX engine
            raise ValueError(
                f"speculative={self.speculative} x decode_steps="
                f"{self.decode_steps} too large for max_seq_len="
                f"{self.max_seq_len}: each tick writes up to "
                f"decode_steps*(K+1) positions and that many tokens of "
                f"finish headroom are reserved; keep decode_steps*(K+1) "
                f"<= max_seq_len // 4 ({self.max_seq_len // 4})"
            )
        # spec engines keep sequential chunking: the spec tick owns the
        # token / history chain a piggybacked chunk would fork (JAX)
        self.prefill_piggyback = bool(prefill_piggyback) and not self.speculative
        self.spec_drafted = 0  # draft tokens proposed (greedy rows only)
        self.spec_accepted = 0  # draft tokens accepted
        self.spec_ticks_issued = 0  # speculative ticks dispatched
        self.spec_skipped_load = 0  # plain ticks forced by queue pressure
        self.spec_skipped_accept = 0  # plain ticks forced by the controller
        self.spec_row_steps = 0  # verify steps of greedy rows (K drafted each)
        self._spec_ctl: Optional[SpecController] = None
        if self.speculative:
            # one program (a CUDA graph on the card) per rung of the
            # controller's shrink ladder; the tree shape is static in each
            self._spec_ctl = SpecController(
                rungs=default_rungs(self.spec_width, self.speculative),
                probe_every=max(1, int(spec_probe_every)),
                explore_every=max(1, int(spec_explore_every)),
            )

        # the decode read's chunk (0 = auto, None = the full-row read on the
        # legacy layout), and the page size it defaults to
        self.decode_kv_chunk = self._resolve_kv_chunk(decode_kv_chunk)
        self._kv_frac_sum = 0.0
        self.kv_page_size = 0
        self._kv_blocks = 1
        self._kv_pool: Optional[PageAllocator] = None
        self._kv_sentinel = 0
        if self.paged:
            page = int(kv_page_size) or self.decode_kv_chunk or 0
            if not page:
                for c in (512, 256, 128, 64, 32, 16, 8):
                    if self.max_seq_len % c == 0 and self.max_seq_len // c >= 2:
                        page = c
                        break
            if not page or self.max_seq_len % page or self.max_seq_len // page < 2:
                logger.warning(
                    "kv_layout='paged' needs a page size dividing max_seq_len=%d into >= 2 "
                    "pages (got %s); falling back to the legacy slot cache",
                    self.max_seq_len, page or None,
                )
                self.paged = False
        if self.attn_fp8 and not self.paged and not self.decode_kv_chunk:
            raise ValueError(
                "attn_fp8=True on the legacy KV layout requires the "
                "chunked decode read (decode_kv_chunk != None)"
            )
        # prefix sharing: LRU over at most prefix_cache_size registered
        # prefixes of >= prefix_min_tokens tokens, under a byte budget; 0
        # disables the path
        self.prefix_cache_size = max(0, int(prefix_cache_size))
        self.prefix_min_tokens = max(1, int(prefix_min_tokens))
        self.prefix_cache_max_bytes = int(prefix_cache_max_bytes)
        self.prefix_hits = 0
        self.prefix_misses = 0
        # the legacy layout's prefix cache: post-RoPE K/V of registered
        # prefixes pinned on the device (the paged layout shares pages)
        self._prefix_lru: "collections.OrderedDict[tuple, _Prefix]" = collections.OrderedDict()
        self._prefix_bytes = 0
        if self.paged:
            self.kv_page_size = page
            self._kv_blocks = self.max_seq_len // page
            n_pages = int(kv_pages) or self.max_slots * self._kv_blocks
            if n_pages < self._kv_blocks:
                raise ValueError(
                    f"kv_pages={n_pages} cannot hold even one max-length request "
                    f"({self._kv_blocks} pages of {page})"
                )
            kv_itemsize = (self.kv_cache_dtype or cfg.dtype).itemsize
            page_bytes = cfg.num_layers * cfg.num_kv_heads * page * cfg.head_dim * 2 * kv_itemsize
            self._kv_pool = PageAllocator(
                n_pages, page, page_bytes=page_bytes,
                max_shared_bytes=self.prefix_cache_max_bytes,
                max_shared_entries=self.prefix_cache_size,
                min_prefix_tokens=self.prefix_min_tokens,
            )
            self._kv_sentinel = n_pages  # block-table "unallocated" marker

        # admission control: the scheduler orders and admits; None keeps FIFO
        self.scheduler = scheduler
        if scheduler is not None:
            scheduler.bind_slots(max_slots)
            if self._kv_pool is not None:
                # KV-pressure admission against the pool's obtainable pages
                scheduler.bind_kv(self._kv_pool.available, self._kv_pool.n_pages)
            if self.speculative:
                # load-disable vs acceptance-disable, side by side in the
                # scheduler's own stats
                scheduler.bind_spec(self._spec_disabled_gauge)
            if self.obs is not None:
                # once warm, the realized queue waits floor the estimated
                # wait of admission and of the 429's Retry-After
                scheduler.bind_wait_hist(self.obs.queue_wait_s)

        # supervision: injected faults (None = off), the restart circuit
        # (max_restarts inside restart_window_s opens it for
        # degraded_cooldown_s), bounded backoff between restarts, the loop
        # heartbeat, and how many restarts one request may ride through
        self._faults = faults
        self.max_restarts = max(1, int(max_restarts))
        self.restart_window_s = float(restart_window_s)
        self.restart_backoff_s = max(0.0, float(restart_backoff_s))
        self.restart_backoff_max_s = max(self.restart_backoff_s, float(restart_backoff_max_s))
        self.degraded_cooldown_s = max(0.0, float(degraded_cooldown_s))
        self.heartbeat_degraded_s = max(0.1, float(heartbeat_degraded_s))
        self.max_request_restarts = max(0, int(max_request_restarts))
        self.engine_restarts = 0
        self.poisoned_requests = 0
        self.circuit_trips = 0
        self.restarted_resubmitted = 0
        self.restarted_failed = 0
        self._restart_times: "collections.deque[float]" = collections.deque(maxlen=64)
        self._consecutive_failures = 0
        self._degraded_until: Optional[float] = None
        self._beat = time.monotonic()
        self._reseeds = 0  # distinct generator seeds for back-to-back restarts

        self._queue: "queue.Queue[_Request]" = queue.Queue()
        self._pending: "collections.deque[_Request]" = collections.deque()
        self._chunking: Optional[_ChunkedPrefill] = None
        # requests of a wave between their pop and their activation: in no
        # queue and no slot, so _restart salvages them from here
        self._starting_batch: Optional[List[tuple]] = None
        self._slots: List[Optional[_Slot]] = [None] * max_slots
        self._slot_epoch = [0] * max_slots
        self._inflight: "collections.deque[_TickRef]" = collections.deque()
        self._slot_pages: List[List[int]] = [[] for _ in range(max_slots)]
        self._block_tables = np.full((max_slots, self._kv_blocks), self._kv_sentinel, np.int32)
        self._temps = np.zeros((max_slots,), np.float32)
        self._top_ps = np.ones((max_slots,), np.float32)
        # JSON slots, and the token FSM with its device tables (_ensure_fsm)
        self._json = np.zeros((max_slots,), bool)
        self._fsm: Optional[TokenFSM] = None
        self._fsm_allowed_dev: Optional[torch.Tensor] = None
        self._fsm_next_dev: Optional[torch.Tensor] = None
        self._generator = torch.Generator(device=self.device).manual_seed(0)
        self._alloc_device_state()
        self._running = False
        self._thread: Optional[threading.Thread] = None
        self._iter_lock = threading.Lock()
        self.steps = 0
        self.reclaimed_slots = 0
        # the reclaimed slots whose client cancelled (a stream abandoned)
        self.cancelled_slots = 0
        # sampler calls that took first tokens (one per admitted wave group
        # or final chunk): with ``steps``, the sampling steps
        self.activations = 0
        self._ttft_s: "collections.deque[float]" = collections.deque(maxlen=1024)
        # inter-token gaps as ids reach the host (across ticks)
        self._itl_s: "collections.deque[float]" = collections.deque(maxlen=4096)
        # streams owed a wakeup, notified once each at the end of _process_tick
        self._stream_notify: set = set()
        self._json_downgraded_ticks = 0
        self._ticks_issued = 0
        self._ticks_processed = 0
        self._tick_issue_s = 0.0
        self._tick_block_s = 0.0
        self._prefill_displaced_ticks = 0
        self._prefill_chunks_piggybacked = 0
        # the fused tick, and the chunk + tick program, as CUDA graphs on the
        # card (captured here, while every slot is idle); the CPU runs the
        # same steps as a Python loop
        self._graph: Optional[torch.cuda.CUDAGraph] = None
        self._graph_launches: Optional[kernels.GraphLaunches] = None
        self._piggyback_graph: Optional[torch.cuda.CUDAGraph] = None
        self._piggyback_launches: Optional[kernels.GraphLaunches] = None
        self._json_graph: Optional[torch.cuda.CUDAGraph] = None
        self._json_launches: Optional[kernels.GraphLaunches] = None
        # each speculative rung's tick: (graph, its launches)
        self._spec_graphs: Dict[tuple, tuple] = {}
        self.graph_pool_bytes = 0
        self.graph_captures = 0  # CUDA graphs this engine captured
        if self.device.type == "cuda":
            self._capture_tick()

    # ------------------------------------------------------------ device state
    def _alloc_device_state(self) -> None:
        """Every tensor the decode tick reads or writes, allocated once per
        engine: a captured graph keeps their addresses, so later writes to
        them are in place (``copy_``, ``index_put_``, ``add_``)."""
        B, K, dev = self.max_slots, self.decode_steps, self.device
        if self.paged:
            self._cache = llama.init_paged_cache(
                self.cfg, B, self._kv_pool.n_pages, self.kv_page_size,
                dtype=self.kv_cache_dtype, device=dev,
            )
        else:
            self._cache = llama.init_cache(self.cfg, B, self.max_seq_len,
                                           dtype=self.kv_cache_dtype, device=dev)
        self._tokens_dev = torch.zeros((B,), dtype=torch.int32, device=dev)
        self._active_dev = torch.zeros((B,), dtype=torch.bool, device=dev)
        self._bt_dev = torch.full(
            (B, self._kv_blocks), self._kv_sentinel, dtype=torch.int32, device=dev
        )
        self._temps_dev = torch.zeros((B,), dtype=torch.float32, device=dev)
        self._top_ps_dev = torch.ones((B,), dtype=torch.float32, device=dev)
        # the JSON rows and their FSM states (advanced by the sampler)
        self._json_dev = torch.zeros((B,), dtype=torch.bool, device=dev)
        self._fsm_states_dev = torch.zeros((B,), dtype=torch.int32, device=dev)
        width = noise_width(self.cfg.vocab_size, TOP_K)
        self._noise = torch.zeros((K, B, width), dtype=torch.float32, device=dev)
        self._toks_dev = torch.zeros((K, B), dtype=torch.int32, device=dev)
        # the next prefill chunk's inputs (its ids, its slot's page chain,
        # the slot and the chunk's start), read by the chunk program
        self._chunk_ids_dev = torch.zeros((1, self.chunk_size), dtype=torch.int32, device=dev)
        self._chunk_bt_dev = torch.full(
            (self._kv_blocks,), self._kv_sentinel, dtype=torch.int32, device=dev
        )
        self._chunk_slot_dev = torch.zeros((1,), dtype=torch.int64, device=dev)
        self._chunk_start_dev = torch.zeros((1,), dtype=torch.int64, device=dev)
        # speculation: the token history (the draft source), each rung's
        # tree constants and output buffers (ids [K, K+1, B], counts [K, B])
        self._history_dev = None
        self._spec_consts: Dict[tuple, tuple] = {}
        self._spec_out: Dict[tuple, tuple] = {}
        if self.speculative:
            self._history_dev = torch.zeros((B, self.max_seq_len), dtype=torch.int32, device=dev)
            for rung in self._spec_ctl.rungs:
                spec = make_tree_spec(*rung)
                self._spec_consts[rung] = (
                    spec,
                    torch.as_tensor(spec.depths, dtype=torch.int32, device=dev),
                    torch.as_tensor(spec.anc_mask, dtype=torch.bool, device=dev),
                    torch.as_tensor(spec.branch_nodes, dtype=torch.long, device=dev),
                )
                self._spec_out[rung] = (
                    torch.zeros((K, spec.depth + 1, B), dtype=torch.int32, device=dev),
                    torch.zeros((K, B), dtype=torch.int32, device=dev),
                )
        self._bt_dirty = True
        self._sampling_dirty = True

    def reset(self) -> None:
        """Rebuild the engine in place with no request on it: the page pool
        and its prefix registry emptied, every slot's page chain dropped and
        its block table back to the sentinel (the legacy layout: the pinned
        prefixes dropped, cut from the failed cache's lineage), then the
        device state (:meth:`_reset_device_state`, a clean cache; the
        captured graphs are kept).  A crash-only restart calls it once it
        has taken the requests off the slots; otherwise call it on a stopped
        engine."""
        if self._chunking is not None or any(s is not None for s in self._slots):
            raise RuntimeError("reset() needs an engine with no request on a slot")
        self._sampling_dirty = True
        self._json[:] = False
        self._prefix_lru.clear()
        self._prefix_bytes = 0
        if self._kv_pool is not None:
            self._kv_pool.reset()
        self._slot_pages = [[] for _ in range(self.max_slots)]
        self._block_tables[:] = self._kv_sentinel
        self._bt_dirty = True
        self._reset_device_state()

    def _reset_device_state(self) -> None:
        """Rebuild the device state in place after a crash-only restart:
        every tensor the captured graphs read keeps its address, so the
        graphs are not re-captured.  Zeroes the cache, lengths and token
        buffers, clears the staged chunk buffers (the chunk's page chain all
        sentinels), leaves the graphs' paged scratch counters at zero,
        re-seeds the generator with a reseed counter (distinct streams for
        back-to-back failures, as the JAX engine's ``_fresh_rng``), and
        uploads the host's (cleared) block tables and sampling arrays.  On
        the card it synchronises, so a sticky device error raises here, in
        recovery, and the engine declares itself dead."""
        for t in (self._cache.k, self._cache.v, self._cache.lengths, self._tokens_dev,
                  self._toks_dev, self._chunk_ids_dev, self._chunk_slot_dev,
                  self._chunk_start_dev, self._fsm_states_dev):
            t.zero_()
        self._chunk_bt_dev.fill_(self._kv_sentinel)
        if self._history_dev is not None:
            self._history_dev.zero_()
            for toks, n_new in self._spec_out.values():
                toks.zero_()
                n_new.zero_()
        for _, counters in getattr(self, "_graph_scratch", {}).values():
            counters.zero_()
        self._reseeds += 1
        self._generator.manual_seed(self.steps + self._reseeds)
        self._bt_dirty = True
        self._sampling_dirty = True
        self._upload_dirty()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _resolve_kv_chunk(self, decode_kv_chunk: Optional[int]) -> Optional[int]:
        """Decode KV chunk (= page) width: 0 = auto, the largest of 512, 256,
        128 that divides ``max_seq_len`` into at least 2 chunks."""
        if decode_kv_chunk is None:
            return None
        if decode_kv_chunk == 0:
            for c in (512, 256, 128):
                if self.max_seq_len % c == 0 and self.max_seq_len // c >= 2:
                    return c
            return None
        c = int(decode_kv_chunk)
        if c <= 0 or self.max_seq_len % c or self.max_seq_len // c < 2:
            raise ValueError(
                f"decode_kv_chunk={decode_kv_chunk} must divide "
                f"max_seq_len={self.max_seq_len} into >= 2 chunks "
                f"(or be 0=auto / None=disabled)"
            )
        return c

    # ------------------------------------------------------------------ public
    def start(self) -> "GenerationEngine":
        if self._running:
            return self
        self._running = True
        self._beat = time.monotonic()
        self._thread = threading.Thread(target=self._loop, daemon=True, name="gen-engine")
        self._thread.start()
        return self

    def stop(self, drain_timeout_s: float = 120.0):
        """Stop the loop; the engine thread fails unfinished requests as it exits."""
        self._running = False
        t = self._thread
        if t is not None:
            t.join(timeout=drain_timeout_s)
            if t.is_alive():
                logger.error("engine thread did not stop within %.0fs", drain_timeout_s)
            else:
                self._thread = None
        err = RuntimeError("generation engine stopped")
        if self._thread is None:
            self._fail_all(err)  # no loop is left to race: release the queue's depth too
        else:
            self._drain_incoming(err)

    def warmup(self, seq_buckets: Optional[Sequence[int]] = None, json: bool = False) -> None:
        """Do before :meth:`start` what the first requests would otherwise
        do (the JAX ``warmup``'s compiles): on the card build every kernel
        library; run a prefill, its insert and the activation's sampler at
        every (batch bucket, prefill bucket up to ``chunk_size``), the suffix
        prefill of the prefix path and the page copy at each, and a chunk
        when prompts can chunk (paged: every write lands on the sentinel
        slot and pages; legacy: on slot 0's row, whose length is zeroed
        after, as the JAX warm-up's zero-length inserts); with ``json``, build the
        token FSM, its tables and the JSON tick's graph.  The tick and
        piggyback graphs were captured at construction.  After it, a request
        builds no library and captures no graph (``graph_captures``).  A
        speculative engine then times each rung's tick against the plain
        tick (:meth:`_measure_spec_costs`), feeding the controller."""
        if self._running:
            raise RuntimeError("warmup() must run before start(): the engine thread owns the "
                               "device state once running")
        if self.device.type == "cuda":
            kernels.build()
        buckets = {b for b in (seq_buckets if seq_buckets is not None else self.prefill_buckets)
                   if b <= self.chunk_size}
        buckets.add(self.chunk_size)  # pick_bucket's fallback when no bucket fits
        if json:
            self._ensure_fsm()
        dev, sentinel = self.device, self._kv_sentinel
        with torch.no_grad():
            for bucket in sorted(buckets):
                for bp in self._batch_buckets():
                    ids = torch.zeros((bp, bucket), dtype=torch.int32, device=dev)
                    lengths = torch.ones((bp,), dtype=torch.int32, device=dev)
                    slots = torch.full((bp,), self.max_slots, dtype=torch.int32, device=dev)
                    bt = torch.full((bp, self._kv_blocks), sentinel, dtype=torch.int32, device=dev)
                    logits, ks, vs = llama.prefill(self.params, self.cfg, ids, lengths)
                    zeros = torch.zeros((bp,), dtype=torch.int64, device=dev)
                    if self.paged:
                        llama.insert_sequences_paged(self._cache, ks, vs, lengths, slots, bt)
                    else:
                        llama.insert_sequences(self._cache, ks, vs, lengths, zeros)
                    ones = torch.ones((bp,), dtype=torch.float32, device=dev)
                    sample_logits(logits, temperature=ones, top_k=TOP_K, top_p=ones,
                                  gumbel=torch.zeros((bp, TOP_K), device=dev))
                    if self.prefix_cache_size > 0 and self.paged:
                        llama.prefill_suffix_paged(self.params, self.cfg, ids, self._cache, bt,
                                                   slots.long(), zeros, zeros)
                    elif self.prefix_cache_size > 0:
                        llama.prefill_suffix(self.params, self.cfg, ids, self._cache, zeros,
                                             zeros, zeros)
            if self.prefix_cache_size > 0 and self.paged:
                llama.copy_pages(self._cache, torch.zeros((1,), dtype=torch.int64, device=dev),
                                 torch.full((1,), sentinel, dtype=torch.int64, device=dev))
            if self.chunk_size < self.max_seq_len - 1:
                self._chunk_body()  # the staged chunk buffers: sentinel pages, slot 0
        for t in (self._cache.lengths, self._chunk_ids_dev, self._chunk_slot_dev,
                  self._chunk_start_dev):
            t.zero_()
        if self.speculative:
            # the controller's breakeven test then runs on measured
            # verify / plain cost ratios instead of its default
            with torch.no_grad():
                self._measure_spec_costs(iters=4)
        if self.device.type == "cuda":
            torch.cuda.synchronize(dev)

    def probe_decode(self, iters: int = 16, fill_len: Optional[int] = None) -> float:
        """Seconds per decode step of the tick alone: ``iters`` ticks issued
        back to back (the graph's replays on the card) after one warm tick,
        one sync at the end, divided by ``iters * decode_steps``.  Runs
        under the loop-iteration lock on an idle engine (waits up to 10 s
        for in-flight work to drain), so a request submitted meanwhile waits
        in the queue.  ``fill_len=None`` probes with every slot inactive;
        otherwise every slot gets a distinct round-robin page chain (the
        registry's shared pages avoided) and the cache length ``fill_len``,
        and runs active.  The lengths, block tables and token buffers are
        reset afterwards (the pages' contents past every valid length are
        garbage, as decode already allows)."""
        with self._idle("probe_decode"), torch.no_grad():
            return self._probe_decode_locked(int(iters), fill_len)

    @contextlib.contextmanager
    def _idle(self, what: str):
        """Hold the loop-iteration lock on an idle engine (no live slot,
        nothing in flight, no chunked prefill), waiting up to 10 s for
        in-flight work to drain; a request submitted meanwhile waits in the
        queue."""
        deadline = time.monotonic() + 10.0
        while True:
            self._iter_lock.acquire()
            if self.num_active == 0 and not self._inflight and self._chunking is None:
                break
            self._iter_lock.release()
            if time.monotonic() >= deadline:
                raise RuntimeError(f"{what} requires an idle engine")
            time.sleep(0.01)
        try:
            yield
        finally:
            self._iter_lock.release()

    def _probe_decode_locked(self, iters: int, fill_len: Optional[int]) -> float:
        dev = self.device
        if fill_len is not None and self.paged:
            avoid = {p for _, ent in self._kv_pool.shared_entries() for p in ent.pages}
            scratch = [p for p in range(self._kv_pool.n_pages) if p not in avoid]
            for b in range(self.max_slots):
                for j in range(self._kv_blocks):
                    self._block_tables[b, j] = scratch[(b * self._kv_blocks + j) % len(scratch)]
            self._bt_dirty = True
        if fill_len is not None:
            # rows stay active (unfrozen) through the warm tick and the probe
            fill = max(0, min(int(fill_len),
                              self.max_seq_len - (iters + 1) * self.decode_steps - 2))
            self._cache.lengths.fill_(fill)
            self._upload_dirty()
            self._active_dev.fill_(True)
        else:
            self._upload_dirty()
        try:
            self._launch_tick()  # warm
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            for _ in range(iters):
                self._launch_tick()
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            return (time.perf_counter() - t0) / (iters * self.decode_steps)
        finally:
            for t in (self._cache.lengths, self._tokens_dev, self._toks_dev):
                t.zero_()
            self._block_tables[:] = self._kv_sentinel
            self._bt_dirty = True
            self._sampling_dirty = True
            self._upload_dirty()

    def probe_spec(self, iters: int = 8) -> Dict[str, Any]:
        """Measured verify / plain tick costs per tree rung on an idle engine
        (the lock discipline of :meth:`probe_decode`): seconds per plain
        tick, per speculative tick of every (width, depth) rung, the cost
        ratios and each rung's breakeven accept rate.  Feeds the
        controller's cost table (the JAX ``probe_spec``)."""
        if not self.speculative:
            raise RuntimeError("probe_spec requires a speculative engine")
        with self._idle("probe_spec"), torch.no_grad():
            return self._measure_spec_costs(int(iters))

    def _measure_spec_costs(self, iters: int = 4) -> Dict[str, Any]:
        """Time the plain tick and every rung's tick (graph replays on the
        card), each ``iters`` times back to back after a warm one, with
        every slot inactive (nothing is written but the dump page and the
        output buffers), one sync per series; feed the cost ratios to the
        controller.  Called from :meth:`warmup` and :meth:`probe_spec`."""
        self._upload_dirty()  # an idle engine: every slot inactive
        dev = self.device

        def series(launch) -> float:
            launch()  # warm
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            for _ in range(iters):
                launch()
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            return (time.perf_counter() - t0) / iters

        plain_s = series(self._launch_tick)
        out: Dict[str, Any] = {"plain_tick_s": plain_s, "rungs": {}}
        for rung in self._spec_ctl.rungs:
            spec_s = series(lambda: self._launch_spec_tick(rung))
            ratio = spec_s / max(plain_s, 1e-9)
            self._spec_ctl.note_cost(rung, ratio)
            out["rungs"][f"{rung[0]}x{rung[1]}"] = {
                "width": rung[0],
                "depth": rung[1],
                "tick_s": spec_s,
                "cost_ratio": ratio,
                "breakeven_accept_rate": breakeven_accept_rate(ratio, rung[1]),
            }
        return out

    def submit(
        self,
        prompt_ids: Sequence[int],
        *,
        max_tokens: int = 1024,
        temperature: float = 0.8,
        top_p: float = 0.95,
        json_format: bool = False,
        prefix_len: int = 0,
        priority: str = "interactive",
        tenant: str = "default",
        deadline_s: Optional[float] = None,
        stream: Optional[TokenStream] = None,
        trace_id: Optional[str] = None,
    ) -> Future:
        """Thread-safe submission; returns a concurrent Future[GenerationResult].

        ``prefix_len``: the first N prompt tokens are a shared, cacheable
        prefix (identical across requests, e.g. the system + RAG-context
        block); the engine reuses their K/V when it can.  An optimisation
        hint only: results are identical with 0.

        Raises :class:`EngineUnavailable` while the restart circuit is open.
        With a scheduler attached, submission may raise
        :class:`SchedulerRejected` synchronously (load shed: the request was
        never queued); an expired deadline fails the future with
        :class:`DeadlineExceeded` and frees the request's slot.
        ``json_format``: sample under the JSON grammar's token FSM (the
        output is one JSON object or array, or a prefix of one when length
        limited).  ``stream``: a :class:`~.streaming.TokenStream` fed each
        token as it reaches the host (EOS is not pushed), and closed by the
        future's done-callback on every resolution path.  ``trace_id`` is
        the request's correlation id (generated when absent)."""
        trace_id = trace_id or new_trace_id()
        if json_format and self.speculative:
            raise ValueError(
                "speculative decoding and json_format are mutually exclusive "
                "(the JSON token-FSM advances one sequential state per token); "
                "serve JSON traffic from a non-speculative model entry"
            )
        if self.degraded():
            remaining = max(0.1, (self._degraded_until or 0.0) - time.monotonic())
            raise EngineUnavailable(
                "engine degraded after repeated restarts", retry_after_s=remaining
            )
        prompt_ids = list(prompt_ids)
        limit = self.max_seq_len - 1  # room for at least one generated token
        if len(prompt_ids) > limit:
            prompt_ids = prompt_ids[-limit:]
            prefix_len = 0  # truncation drops leading tokens: the prefix is gone
        prefix_len = max(0, min(int(prefix_len), len(prompt_ids) - 1))
        # the worst-case page reservation: the scheduler's KV-pressure charge
        # (prefix sharing only reduces the pages actually taken; the legacy
        # layout reserves no pages)
        kv_pages = 0
        if self.paged:
            demand_tokens = min(len(prompt_ids) + int(max_tokens), self.max_seq_len)
            kv_pages = -(-demand_tokens // self.kv_page_size)
        admitted = False
        if self.scheduler is not None:
            if deadline_s is None:
                deadline_s = self.scheduler.cfg.default_deadline_s
            adm = self.scheduler.try_admit(priority, deadline_s, kv_pages=kv_pages)
            if not adm.ok:
                if self.obs is not None:
                    self.obs.on_shed(adm.reason, priority, trace_id=trace_id)
                raise SchedulerRejected(adm.reason, adm.retry_after_s)
            if adm.clamp_max_tokens is not None:
                max_tokens = min(max_tokens, adm.clamp_max_tokens)
                if self.paged:  # the clamp shrinks the worst case: release the difference
                    demand_tokens = min(len(prompt_ids) + int(max_tokens), self.max_seq_len)
                    new_pages = -(-demand_tokens // self.kv_page_size)
                    if new_pages < kv_pages:
                        self.scheduler.release_kv(kv_pages - new_pages)
                        kv_pages = new_pages
            admitted = True
        now = time.monotonic()
        fut: Future = Future()
        if stream is not None:
            # attached before the put: a future resolved at once still
            # closes the stream
            fut.add_done_callback(stream.finish)
        if self.obs is not None:
            self.obs.on_admit(trace_id, priority, tenant, len(prompt_ids))
        self._queue.put(
            _Request(
                prompt_ids=prompt_ids,
                max_tokens=int(max_tokens),
                temperature=float(temperature),
                top_p=float(top_p),
                future=fut,
                submitted_at=now,
                prefix_len=prefix_len,
                priority=priority,
                tenant=tenant,
                deadline_at=(now + deadline_s) if deadline_s is not None else None,
                admitted=admitted,
                kv_pages=kv_pages,
                trace_id=trace_id,
                json=bool(json_format),
                stream=stream,
            )
        )
        # a stop() racing the put above would strand the request: re-check
        if not self._running:
            self._drain_incoming(RuntimeError("generation engine stopped"))
        return fut

    async def generate(
        self,
        prompt,
        *,
        max_tokens: int = 1024,
        temperature: float = 0.8,
        top_p: float = 0.95,
        json_format: bool = False,
        priority: str = "interactive",
        tenant: str = "default",
        deadline_s: Optional[float] = None,
        trace_id: Optional[str] = None,
    ) -> GenerationResult:
        """Tokenize (chat-templating message lists: every message before the
        last is the shared-prefix candidate), run, decode."""
        if isinstance(prompt, str):
            ids, plen = self.tokenizer.encode(prompt), 0
        else:
            ids, plen = encode_chat_split(self.tokenizer, prompt)
        fut = self.submit(
            ids, max_tokens=max_tokens, temperature=temperature, top_p=top_p,
            json_format=json_format, prefix_len=plen, priority=priority, tenant=tenant,
            deadline_s=deadline_s, trace_id=trace_id,
        )
        return await asyncio.wrap_future(fut)

    async def generate_stream(
        self,
        prompt,
        *,
        max_tokens: int = 1024,
        temperature: float = 0.8,
        top_p: float = 0.95,
        json_format: bool = False,
        priority: str = "interactive",
        tenant: str = "default",
        deadline_s: Optional[float] = None,
        trace_id: Optional[str] = None,
    ):
        """Async iterator of :class:`~.streaming.StreamChunk`: UTF-8-safe
        text deltas as the tokens reach the host, then one terminal chunk
        with the finish reason and the :class:`GenerationResult`.  The
        deltas concatenate to the non-streaming ``generate()`` text of the
        same request, byte for byte.  Abandoning the iterator cancels the
        request; the loop's reap frees its slot within one tick."""
        if isinstance(prompt, str):
            ids, plen = self.tokenizer.encode(prompt), 0
        else:
            ids, plen = encode_chat_split(self.tokenizer, prompt)
        stream = TokenStream().bind(asyncio.get_running_loop(), capacity=int(max_tokens) + 2)
        fut = self.submit(
            ids, max_tokens=max_tokens, temperature=temperature, top_p=top_p,
            json_format=json_format, prefix_len=plen, priority=priority, tenant=tenant,
            deadline_s=deadline_s, stream=stream, trace_id=trace_id,
        )
        detok = IncrementalDetokenizer(self.tokenizer)
        idx = 0
        try:
            async for kind, payload in stream:
                if kind == "token":
                    yield StreamChunk(index=idx, token_id=payload, text=detok.push(payload))
                    idx += 1
                    continue
                if isinstance(payload, BaseException):
                    raise payload
                result: GenerationResult = payload
                yield StreamChunk(
                    index=idx, token_id=None, text=detok.flush(), done=True,
                    finish_reason="length" if result.length_limited else "stop", result=result,
                )
                return
        finally:
            # the consumer is gone (disconnect, break, error): cancel, so the
            # reap frees the slot within one tick
            if not fut.done():
                fut.cancel()

    @property
    def num_active(self) -> int:
        return sum(s is not None for s in self._slots)

    def queued_depth(self) -> int:
        """Requests accepted but not yet slotted (the scheduler's depth
        ledger when there is one: ``submit`` charges it)."""
        if self.scheduler is not None:
            return self.scheduler.queue_depth
        return self._queue.qsize() + len(self._pending)

    def stats(self) -> Dict[str, Any]:
        """The engine's ``/healthz`` block."""
        ttft = sorted(self._ttft_s)
        out = {
            "active_slots": self.num_active,
            "steps": self.steps,
            "queued": self.queued_depth(),
            "kv_pages_total": self._kv_pool.n_pages if self.paged else 0,
            "kv_pages_free": self._kv_pool.pages_free if self.paged else 0,
            "kv_page_size": self.kv_page_size,
            "ttft_p50_s": ttft[len(ttft) // 2] if ttft else None,
            "ticks": self._ticks_issued,
            "reclaimed_slots": self.reclaimed_slots,
            **self.decode_path_stats(),
            "kv": self.kv_stats(),
            "supervision": self.supervision_stats(),
            "stream": self.latency_stats(),
        }
        if self.scheduler is not None:
            out["sched"] = self.scheduler.stats()
        if self.speculative:
            out["spec"] = self.spec_stats()
        return out

    def spec_stats(self) -> Optional[Dict[str, Any]]:
        """Speculation gauges, or None on a non-speculative engine (the
        JAX ``spec_stats``): cumulative draft / accept counters, the
        controller's state (acceptance EMAs per rung, the rung issued) and
        why speculation is off, if it is: ``spec_auto_disabled`` the
        controller's breakeven verdict, ``spec_load_disabled`` the
        scheduler's degradation band."""
        if not self.speculative:
            return None
        out = {
            "spec_drafted": self.spec_drafted,
            "spec_accepted": self.spec_accepted,
            "spec_accept_rate": round(self.spec_accepted / max(1, self.spec_drafted), 4),
            "spec_load_disabled": bool(self.scheduler is not None and self.scheduler.degraded()),
            "spec_ticks": self.spec_ticks_issued,
            "spec_skipped_load": self.spec_skipped_load,
            "spec_skipped_accept": self.spec_skipped_accept,
        }
        out.update(self._spec_ctl.stats())
        return out

    def _spec_disabled_gauge(self) -> Dict[str, Any]:
        """The gauge bound into the scheduler's stats: which mechanism (if
        any) holds speculation off, and the tick counters behind it."""
        return {
            "load": bool(self.scheduler is not None and self.scheduler.degraded()),
            "acceptance": bool(self._spec_ctl is not None and self._spec_ctl.disabled),
            "skipped_load_ticks": self.spec_skipped_load,
            "skipped_accept_ticks": self.spec_skipped_accept,
        }

    def kv_stats(self) -> Dict[str, Any]:
        """The KV plane's gauges (the JAX ``kv_stats``): the layout, the one
        the config asked for and the one that runs (a context no page
        divides falls back to legacy), then the pool (pages used, free,
        obtainable, shared; registry entries; evictions and COW copies) on
        the paged layout, or the pinned prefixes' count and bytes on the
        legacy one, and the prefix hit and miss counters."""
        out: Dict[str, Any] = {"kv_layout": "paged" if self.paged else "legacy"}
        out["kv_layout_requested"] = self.kv_layout_requested
        out["kv_layout_effective"] = out["kv_layout"]
        if self.paged:
            out.update(self._kv_pool.stats())
        else:
            out["prefix_entries"] = len(self._prefix_lru)
            out["prefix_bytes"] = self._prefix_bytes
        out["prefix_hits"] = self.prefix_hits
        out["prefix_misses"] = self.prefix_misses
        return out

    @staticmethod
    def _pctl_ms(samples, frac: float) -> float:
        vals = sorted(samples)
        if not vals:
            return 0.0
        idx = min(len(vals) - 1, max(0, round(frac * (len(vals) - 1))))
        return round(vals[idx] * 1e3, 3)

    def latency_stats(self) -> Dict[str, Any]:
        """The streaming plane's latency gauges (the JAX ``latency_stats``):
        TTFT (submit to the first token on the host) and inter-token gaps
        (host arrivals across ticks: a fused tick delivers its tokens at
        once) as p50 / p95 in ms with their sample counts, and the slots
        reclaimed because their client cancelled."""
        ttft, itl = list(self._ttft_s), list(self._itl_s)
        return {
            "ttft_p50_ms": self._pctl_ms(ttft, 0.50),
            "ttft_p95_ms": self._pctl_ms(ttft, 0.95),
            "ttft_n": len(ttft),
            "itl_p50_ms": self._pctl_ms(itl, 0.50),
            "itl_p95_ms": self._pctl_ms(itl, 0.95),
            "itl_n": len(itl),
            "cancelled_slots": self.cancelled_slots,
        }

    def degraded(self) -> bool:
        """True while the restart circuit is open (``submit`` fails fast)."""
        dl = self._degraded_until
        return dl is not None and time.monotonic() < dl

    def healthy(self) -> bool:
        """The liveness predicate (any thread): a running loop, a live thread
        (None: a single-threaded driver, not a death), a closed circuit and a
        fresh heartbeat."""
        if not self._running or self.degraded():
            return False
        t = self._thread
        if t is not None and not t.is_alive():
            return False
        return (time.monotonic() - self._beat) < self.heartbeat_degraded_s

    def supervision_stats(self) -> Dict[str, Any]:
        """Restart, quarantine and circuit counters and the loop heartbeat:
        the ``/healthz`` evidence that tells a live engine from a wedged or
        degraded one."""
        t = self._thread
        return {
            "running": self._running,
            "thread_alive": t is None or t.is_alive(),
            "healthy": self.healthy(),
            "degraded": self.degraded(),
            "loop_heartbeat_age_s": round(time.monotonic() - self._beat, 3),
            "heartbeat_degraded_s": self.heartbeat_degraded_s,
            "engine_restarts": self.engine_restarts,
            "poisoned_requests": self.poisoned_requests,
            "circuit_trips": self.circuit_trips,
            "restarted_requests_resubmitted": self.restarted_resubmitted,
            "restarted_requests_failed": self.restarted_failed,
        }

    def decode_path_stats(self) -> Dict[str, Any]:
        """Which decode path is active: the fused depth (the JAX engine's
        ``decode_steps_effective`` key; the port never lowers it), the
        weight format's width in bits (16, 8 or 4), the CUDA graphs, and the
        piggybacked-prefill gauges (chunks that rode a tick,
        and the fraction of ticks that waited on a chunk of their own), the
        single-step JSON ticks issued in place of fused ones, and whether the
        decode attention runs the fp8 in-dot scheme (``attn_fp8``).

        ``upload_overlap_frac`` is the JAX gauge's fraction of sampling and
        block-table upload cycles issued while a tick was in flight rather
        than on the issue path.  The port issues every upload on the issue
        path (:meth:`_upload_dirty` in :meth:`_issue_tick`: a copy from
        pinned memory, non-blocking, ordered on the stream behind the ticks
        in flight, so the host does not wait for it) and stages none ahead,
        so it reports 0.0."""
        return {
            "decode_steps": self.decode_steps,
            "decode_steps_effective": 1 if self._json.any() else self.decode_steps,
            "json_downgraded_ticks": self._json_downgraded_ticks,
            "upload_overlap_frac": 0.0,
            "weight_bits": self.weight_bits,
            "cuda_graph": self._graph is not None,
            "prefill_piggyback": self.prefill_piggyback,
            "prefill_chunks_piggybacked": self._prefill_chunks_piggybacked,
            "prefill_displacement_frac": round(
                self._prefill_displaced_ticks / max(1, self._ticks_issued), 4
            ),
            # whether the decode attention reads the fp8 pool in-dot
            "attn_fp8": self.attn_fp8,
            # the kernel launches one replay of the chunk + tick graph holds
            # (recorded at its capture), and its paged prefill launches by
            # form ("<route>:<read>"); empty without that graph
            "piggyback_launches": self._graph_counts(self._piggyback_launches, "launches"),
            "piggyback_paged_prefill_forms": self._graph_counts(self._piggyback_launches,
                                                                "paged_prefill"),
        }

    @staticmethod
    def _graph_counts(rec: Optional[kernels.GraphLaunches], which: str) -> Dict[str, int]:
        """The non-zero launches a graph's recorder holds: by kernel
        (``which="launches"``) or one kernel's by kind."""
        if rec is None:
            return {}
        counts = rec.launches if which == "launches" else rec.sub[which]
        return {k: n for k, n in counts.items() if n}

    def tick_stats(self) -> Dict[str, Any]:
        """:meth:`stats` plus the per-tick wall breakdown (ms per tick):
        ``issue_ms`` is what the host spends issuing a tick (uploads, noise,
        the replay or the eager steps), ``block_ms`` what it waits for a
        tick's ids in :meth:`_process_tick`; ``kv_read_frac``, the average
        share of the allocated KV row the decode read covered (the JAX
        gauge: the live chunks' share per plain tick, 1.0 for a speculative
        tick and with no chunked read); and the latency gauges
        (:meth:`latency_stats`) at the top level, as the JAX engine has
        them."""
        n = self._ticks_issued
        return {
            **self.stats(),
            **(self.spec_stats() or {}),
            **self.latency_stats(),
            "issue_ms": round(self._tick_issue_s / max(1, n) * 1e3, 3),
            "block_ms": round(self._tick_block_s / max(1, self._ticks_processed) * 1e3, 3),
            "kv_read_frac": round(self._kv_frac_sum / n, 4) if n else 1.0,
            "graph_pool_bytes": self.graph_pool_bytes,
        }

    def _kv_read_frac(self) -> float:
        """The share of the allocated row this tick's chunked read covers:
        the chunks up to the longest live slot's position over the row's
        chunks (the JAX host-side estimate, within a chunk of the device's
        ``hi``), or 1.0 with no chunked read."""
        c = self.decode_kv_chunk
        if not c:
            return 1.0
        mx = 0
        for s in self._slots:
            if s is not None:
                pos = len(s.request.prompt_ids) + len(s.generated)
                mx = max(mx, min(pos, self.max_seq_len - 1))
        return (mx // c + 1) / (self.max_seq_len // c)

    # ---------------------------------------------------------------- the loop
    def _loop_iteration(self) -> bool:
        """One iteration: reap, admit, one chunk of a chunked prefill (with
        the decode tick as one unit when it piggybacks), one decode tick,
        then drain results ``lookahead`` ticks behind (fully when no slot is
        live).  Returns whether admission or a chunk progressed."""
        with self._iter_lock:
            self._reap_dead_slots()
            admitted = self._admit()
            ticked = False
            if self._chunking is not None:
                if (
                    self.prefill_piggyback
                    and self.num_active > 0
                    and not self._json.any()
                    and self._chunking.step < len(self._chunking.starts) - 1
                ):
                    # the final chunk never piggybacks: its logits feed the
                    # activation, as in the JAX engine; nor does a chunk
                    # while a JSON slot is live (its ticks are single-step)
                    self._piggyback_step()
                    ticked = True
                else:
                    if self.num_active > 0:
                        self._prefill_displaced_ticks += 1
                    self._chunk_step()
                admitted = True
            if self.num_active > 0 and not ticked:
                self._issue_tick()
            while self._inflight and (
                len(self._inflight) > self.lookahead or self.num_active == 0
            ):
                self._process_tick()
        return admitted

    def _loop(self):
        try:
            with torch.no_grad():
                while self._running:
                    self._beat = time.monotonic()
                    if self._degraded_until is not None and not self._degraded_wait():
                        continue
                    try:
                        admitted = self._loop_iteration()
                        # a clean iteration closes a failure streak (the
                        # backoff escalates over consecutive failures only)
                        self._consecutive_failures = 0
                        if not admitted and self.num_active == 0 and not self._inflight:
                            time.sleep(IDLE_POLL_S)
                    except Exception as e:
                        logger.exception("engine-fatal loop error; crash-only restart")
                        with self._iter_lock:
                            self._restart(e)
                        self._backoff_after_failure()
        finally:
            self._running = False
            self._fail_all(RuntimeError("generation engine stopped"))

    def _degraded_wait(self) -> bool:
        """One degraded-mode loop beat.  Returns True once the cooldown has
        elapsed (half-open: the loop resumes, the restart history is kept, so
        a still-broken device re-trips on its next crash)."""
        now = time.monotonic()
        if self._degraded_until is not None and now >= self._degraded_until:
            logger.warning("engine circuit half-open: resuming after %.1fs degraded cooldown",
                           self.degraded_cooldown_s)
            self._degraded_until = None
            self._consecutive_failures = 0
            return True
        # new work fails fast in submit(); queued work keeps honouring its
        # deadlines and cancels while the engine cools down
        with self._iter_lock:
            self._reap_dead_slots()
        time.sleep(min(0.05, max(0.0, (self._degraded_until or now) - now)))
        return False

    def _backoff_after_failure(self) -> None:
        self._consecutive_failures += 1
        if not self._running or self.degraded():
            return  # the degraded wait (or shutdown) is the backoff
        delay = min(self.restart_backoff_max_s,
                    self.restart_backoff_s * (2 ** (self._consecutive_failures - 1)))
        if delay > 0:
            time.sleep(delay)

    def _fail_all(self, err: BaseException) -> None:
        """Fail every live, mid-prefill and queued request and free their
        pages (the loop's exit and ``stop``)."""
        self._inflight.clear()
        for i, s in enumerate(self._slots):
            if s is not None:
                _safe_resolve(s.request.future, exc=err)
                self._slots[i] = None
                self._slot_epoch[i] += 1
            self._free_slot_pages(i)
        self._json[:] = False
        self._sampling_dirty = True
        if self._chunking is not None:
            _safe_resolve(self._chunking.request.future, exc=err)
            self._free_slot_pages(self._chunking.slot)
            self._chunking = None
        while self._pending:
            _safe_resolve(self._pending.popleft().future, exc=err)
        if self.scheduler is not None:
            self._stage_incoming()  # their queue depth is released by the drain
            self.scheduler.drain(err)
        self._drain_incoming(err)

    def _drain_incoming(self, err: BaseException):
        while True:
            try:
                req = self._queue.get_nowait()
            except queue.Empty:
                break
            _safe_resolve(req.future, exc=err)

    def _free_slots(self) -> List[int]:
        busy = {self._chunking.slot} if self._chunking is not None else set()
        return [i for i, s in enumerate(self._slots) if s is None and i not in busy]

    def _dead(self, req: _Request, now: float, running: Optional[str]) -> bool:
        """Whether ``req`` is dead: its client cancelled, or its deadline
        passed, which fails it with :class:`DeadlineExceeded`.  ``running``
        says where a request holding a slot was (``None``: still queued); one
        that dies there counts as a reclaimed slot and, under a scheduler,
        as an expiry of a running request."""
        expired = req.deadline_at is not None and now >= req.deadline_at
        if not expired and not req.future.cancelled():
            return False
        if running is not None:
            self.reclaimed_slots += 1
            if not expired:
                # a client that cancelled (a stream abandoned mid-generation)
                self.cancelled_slots += 1
        if expired:
            msg = (f"deadline expired after {now - req.submitted_at:.2f}s in queue"
                   if running is None else f"deadline expired {running}")
            _safe_resolve(req.future, exc=DeadlineExceeded(msg))
            if running is not None and self.scheduler is not None:
                self.scheduler.note_expired_running(req.priority)
        return True

    def _reap_dead_slots(self) -> None:
        """Drop dead queued requests (cancelled or past their deadline) and
        free live slots whose request is dead, so an expired request stops
        burning decode steps within one tick."""
        now = time.monotonic()
        if self.scheduler is not None:
            self.scheduler.reap(now)
        elif self._pending:
            self._pending = collections.deque(
                r for r in self._pending if not self._dead(r, now, None)
            )
        for i, s in enumerate(self._slots):
            if s is not None and self._dead(s.request, now, (
                f"after {len(s.generated)} generated tokens "
                f"({now - s.request.submitted_at:.2f}s since submit)"
            )):
                self._release(i)

    # --------------------------------------------------------------- admission
    def _prefix_lookup(self, req: _Request):
        """The LONGEST registered prefix this prompt starts with (so a
        multi-turn dialog hits the previous turn's prefix even though its
        declared split moved), LRU-touched, or None: the allocator's
        registry on the paged layout (a :class:`~.kv_pool.SharedPrefix`), the
        pinned-K/V LRU on the legacy one (a :class:`_Prefix`)."""
        if self.prefix_cache_size <= 0 or req.prefix_len < self.prefix_min_tokens:
            return None
        if self.paged:
            return self._paged_usable_hit(
                req, self._kv_pool.lookup(req.prompt_ids, req.prefix_len))
        n = len(req.prompt_ids)
        best_key, best = None, None
        for key, ent in self._prefix_lru.items():
            if ent.length < n and (best is None or ent.length > best.length):
                if tuple(req.prompt_ids[: ent.length]) == key:
                    best, best_key = ent, key
        if best_key is not None:
            self._prefix_lru.move_to_end(best_key)
        return best

    def _paged_usable_hit(self, req: _Request, hit: Optional[SharedPrefix]):
        """Reject a hit whose bucketed suffix prefill would run past the
        context (the prefix within one bucket of the end): its window would
        have to slide left over the prefix and rewrite shared pages.  A
        chunked remainder never slides into the prefix (it is longer than a
        chunk, so the final chunk starts past it)."""
        if hit is None:
            return None
        n_eff = len(req.prompt_ids) - hit.length
        if n_eff > self.chunk_size:
            return hit
        b = pick_bucket(n_eff, self.prefill_buckets, self.chunk_size)
        return None if hit.length + b > self.max_seq_len else hit

    def _paged_admit_slot(self, slot: int, req: _Request, hit: Optional[SharedPrefix]) -> bool:
        """Reserve and wire pages for ``req`` in ``slot``: the hit's full
        prefix pages by reference (incref), its boundary page by a
        copy-on-write clone, everything else fresh from the pool, up to the
        request's worst-case demand.  False: the pool cannot place the
        request now (it stays queued until pages free)."""
        demand_tokens = min(len(req.prompt_ids) + req.max_tokens, self.max_seq_len)
        total = -(-demand_tokens // self.kv_page_size)
        shared: List[int] = []
        pinned: List[int] = []
        cow_src = None
        if hit is not None:
            # pin every hit page (the COW source too) before alloc: its
            # on-demand eviction could otherwise drop this very entry and
            # hand its pages back as "fresh" pages of the same request
            pinned = list(hit.pages)
            self._kv_pool.incref(pinned)
            shared = pinned[: hit.full_pages]
            if len(pinned) > hit.full_pages:
                cow_src = pinned[hit.full_pages]
        fresh = self._kv_pool.alloc(total - len(shared))
        if fresh is None:
            if pinned:
                self._kv_pool.decref(pinned)
            return False
        if cow_src is not None:
            # the sharer's suffix K/V lands in the boundary page: clone it
            # (below the prefix length it holds the owner's prefix K/V; above,
            # what the sharer's suffix prefill overwrites before reading)
            llama.copy_pages(self._cache, self._tensor(np.asarray([cow_src], np.int64)),
                             self._tensor(np.asarray([fresh[0]], np.int64)))
            self._kv_pool.cow_copies += 1
            self._kv_pool.decref([cow_src])  # cloned: the pin is no longer needed
        row = shared + fresh
        self._slot_pages[slot] = row
        self._block_tables[slot, :] = self._kv_sentinel
        self._block_tables[slot, : len(row)] = row
        self._bt_dirty = True
        return True

    def _free_slot_pages(self, slot: int) -> None:
        if not self._slot_pages[slot]:  # (always, on the legacy layout)
            return
        self._kv_pool.decref(self._slot_pages[slot])
        self._slot_pages[slot] = []
        self._block_tables[slot, :] = self._kv_sentinel
        self._bt_dirty = True

    def _stage_incoming(self) -> None:
        """Move submitted requests into the scheduler (fair-share order) or
        the FIFO deque."""
        while True:
            try:
                req = self._queue.get_nowait()
            except queue.Empty:
                break
            if self.scheduler is not None:
                self.scheduler.enqueue(req)
            else:
                self._pending.append(req)

    def _peek_next(self, now: float) -> Optional[_Request]:
        """The request admission would start next, not removed: the
        scheduler's fair-share winner, or the FIFO head (dead entries are
        dropped on the way)."""
        if self.scheduler is not None:
            return self.scheduler.peek(now)
        while self._pending and self._dead(self._pending[0], now, None):
            self._pending.popleft()
        return self._pending[0] if self._pending else None

    def _take_next(self, now: float) -> Optional[_Request]:
        if self.scheduler is not None:
            return self.scheduler.pop(now)
        return self._pending.popleft() if self._pending else None

    def _requeue_front(self, req: _Request) -> None:
        if self.scheduler is not None:
            self.scheduler.enqueue(req, front=True)
        else:
            self._pending.appendleft(req)

    def _admit(self) -> bool:
        self._stage_incoming()
        now = time.monotonic()
        free = self._free_slots()
        batch: List[tuple] = []  # (slot, request, hit)
        admitted = False

        def must_wait(n_eff: int) -> bool:
            # one chunked prefill at a time; scheduling order preserved (with
            # a hit only the remainder past the prefix runs through the model)
            return n_eff > self.chunk_size and (self._chunking is not None or bool(batch))

        while free:
            req = self._peek_next(now)
            if req is None:
                break
            hit = self._prefix_lookup(req)
            n_eff = len(req.prompt_ids) - (hit.length if hit else 0)
            if must_wait(n_eff):
                break
            slot = free[0]
            if self.paged and not self._paged_admit_slot(slot, req, hit):
                if hit is None:
                    break  # out of pages: the head waits for a slot to free
                # the pinned hit may be what eviction needed: drop it and
                # retry as a full prefill (the entry becomes evictable), so a
                # registry-heavy pool cannot wedge the queue head
                hit = None
                n_eff = len(req.prompt_ids)
                if must_wait(n_eff) or not self._paged_admit_slot(slot, req, None):
                    break
            taken = self._take_next(now)
            if taken is not req:
                # the head moved between peek and pop (a cancel, or a
                # re-ordered fair share): serve the popped request instead
                self._free_slot_pages(slot)
                if taken is None:
                    break
                req = taken
                hit = self._prefix_lookup(req)
                n_eff = len(req.prompt_ids) - (hit.length if hit else 0)
                if must_wait(n_eff) or (self.paged
                                        and not self._paged_admit_slot(slot, req, hit)):
                    self._requeue_front(req)
                    break
            free.pop(0)
            self._count_prefix(req, hit)
            if n_eff > self.chunk_size:
                self._begin_chunked(slot, req, prefix=hit)
                admitted = True
            else:
                batch.append((slot, req, hit))
        if batch:
            # group the wave by seq bucket (short prompts must not pay the
            # longest prompt's attention), one prefill call per group; hits
            # prefill only their suffix, bucketed by the suffix's length
            full_groups: Dict[int, List[tuple]] = {}
            suffix_groups: Dict[int, List[tuple]] = {}
            for slot, req, hit in batch:
                n_eff = len(req.prompt_ids) - (hit.length if hit else 0)
                b = pick_bucket(n_eff, self.prefill_buckets, self.chunk_size)
                if hit is None:
                    full_groups.setdefault(b, []).append((slot, req))
                else:
                    suffix_groups.setdefault(b, []).append((slot, req, hit))
            # every request of the wave stays in _starting_batch until its
            # group is activated: if a prefill raises, _restart salvages the
            # rest instead of orphaning them
            remaining = [(slot, req) for slot, req, _ in batch]
            self._starting_batch = remaining
            for group in full_groups.values():
                self._start_batch(group)
                for pair in group:
                    remaining.remove(pair)
            for sgroup in suffix_groups.values():
                self._start_suffix_batch(sgroup)
                for slot, req, _ in sgroup:
                    remaining.remove((slot, req))
            self._starting_batch = None
            admitted = True
        return admitted

    def _count_prefix(self, req: _Request, hit) -> None:
        """Hit and miss counters, once per admitted request that declared a
        cacheable prefix."""
        if self.prefix_cache_size > 0 and req.prefix_len >= self.prefix_min_tokens:
            if hit is not None:
                self.prefix_hits += 1
            else:
                self.prefix_misses += 1

    def _batch_buckets(self) -> tuple:
        """Prefill batch-dim buckets: {1, 4, max_slots}."""
        return tuple(sorted({1, min(4, self.max_slots), self.max_slots}))

    def _wave_block_tables(self, slots: List[int], pad: int) -> np.ndarray:
        """Block-table rows of a prefill wave; the first ``pad`` rows are
        batch padding and carry the page sentinel everywhere."""
        bt = np.full((pad + len(slots), self._kv_blocks), self._kv_sentinel, np.int32)
        for j, slot in enumerate(slots):
            bt[pad + j] = self._block_tables[slot]
        return bt

    def _host_tensor(self, arr) -> torch.Tensor:
        """``arr`` as a CPU tensor, pinned when the engine runs on the card,
        so its upload is asynchronous (the caching host allocator keeps the
        buffer until the copy has run)."""
        t = torch.from_numpy(np.ascontiguousarray(arr))
        return t.pin_memory() if self.device.type == "cuda" else t

    def _tensor(self, arr) -> torch.Tensor:
        """A new device tensor holding ``arr``, uploaded in stream order."""
        return self._host_tensor(arr).to(self.device, non_blocking=True)

    def _upload(self, dst: torch.Tensor, arr) -> None:
        """Write ``arr`` into the device buffer ``dst`` in place, in stream
        order: ticks issued before the write still read the old contents."""
        dst.copy_(self._host_tensor(arr), non_blocking=True)

    def _start_batch(self, batch: List[tuple[int, _Request]]):
        """One prefill call for a bucket group of the wave (misses: the whole
        prompt), registration of declared prefixes, then activation.  Pad
        rows come first: paged, they carry the slot and page sentinels, so
        their writes drop; legacy, they alias the first real slot, which
        ``insert_sequences`` writes after them (the later row wins)."""
        reqs = [r for _, r in batch]
        slots = [s for s, _ in batch]
        bucket = pick_bucket(
            max(len(r.prompt_ids) for r in reqs), self.prefill_buckets, self.chunk_size
        )
        Bp = pick_bucket(len(batch), self._batch_buckets(), self.max_slots)
        pad = Bp - len(batch)
        ids = np.full((Bp, bucket), self.tokenizer.pad_id, np.int32)
        lengths = np.zeros((Bp,), np.int32)
        slot_arr = np.full((Bp,), self.max_slots if self.paged else slots[0], np.int32)
        for j, req in enumerate(reqs):
            n = len(req.prompt_ids)
            ids[pad + j, :n] = req.prompt_ids
            lengths[pad + j] = n
            slot_arr[pad + j] = slots[j]
        lengths_t = self._tensor(lengths)
        logits, ks, vs = llama.prefill(self.params, self.cfg, self._tensor(ids), lengths_t)
        if self.paged:
            llama.insert_sequences_paged(
                self._cache, ks, vs, lengths_t, self._tensor(slot_arr),
                self._tensor(self._wave_block_tables(slots, pad)),
            )
        else:
            llama.insert_sequences(self._cache, ks, vs, lengths_t, self._tensor(slot_arr))
        for slot, req in batch:
            self._maybe_register_prefix(slot, req)
        self._activate_batch(slots, reqs, logits, pad=pad)

    def _start_suffix_batch(self, group: List[tuple]):
        """Admit a wave of prefix hits: paged, their shared pages are already
        wired into the block tables (and the boundary pages cloned) by
        :meth:`_paged_admit_slot`; legacy, each pinned prefix is copied into
        its slot's row.  Then one batched suffix prefill continues every row
        from its prefix length.  The skipped work is the prefix's
        recompute."""
        slots = [s for s, _, _ in group]
        reqs = [r for _, r, _ in group]
        hits = [h for _, _, h in group]
        bucket = pick_bucket(
            max(len(r.prompt_ids) - h.length for r, h in zip(reqs, hits)),
            self.prefill_buckets, self.chunk_size,
        )
        Bp = pick_bucket(len(group), self._batch_buckets(), self.max_slots)
        pad = Bp - len(group)
        ids = np.full((Bp, bucket), self.tokenizer.pad_id, np.int32)
        starts = np.zeros((Bp,), np.int64)
        valids = np.zeros((Bp,), np.int64)
        slot_arr = np.full((Bp,), self.max_slots if self.paged else slots[0], np.int64)
        for j, (req, hit) in enumerate(zip(reqs, hits)):
            # the write window [start, start + bucket) stays inside the row:
            # paged, _paged_usable_hit refused a hit that would cross it;
            # legacy, the window slides left (the re-fed prefix tokens
            # recompute the same K/V at the same positions)
            start = min(hit.length, self.max_seq_len - bucket)
            suffix = req.prompt_ids[start : start + bucket]
            ids[pad + j, : len(suffix)] = suffix
            starts[pad + j] = start
            valids[pad + j] = len(suffix)
            slot_arr[pad + j] = slots[j]
        if self.paged:
            logits, _ = llama.prefill_suffix_paged(
                self.params, self.cfg, self._tensor(ids), self._cache,
                self._tensor(self._wave_block_tables(slots, pad)), self._tensor(slot_arr),
                self._tensor(starts), self._tensor(valids),
            )
        else:
            for slot, hit in zip(slots, hits):
                llama.insert_prefix(self._cache, hit.pk, hit.pv, slot)
            logits, _ = llama.prefill_suffix(
                self.params, self.cfg, self._tensor(ids), self._cache, self._tensor(slot_arr),
                self._tensor(starts), self._tensor(valids),
            )
        # a hit whose declared split extends past the matched prefix (a
        # multi-turn history that grew) registers the longer prefix
        for slot, req in zip(slots, reqs):
            self._maybe_register_prefix(slot, req)
        self._activate_batch(slots, reqs, logits, pad=pad)

    def _maybe_register_prefix(self, slot: int, req: _Request) -> None:
        """After ``slot``'s prefill, make the request's declared prefix
        shareable: paged, register the pages covering it with the allocator
        (refcounting only: no copy, no memory beyond what the request
        holds); legacy, copy its K/V out of the slot's row into the pinned
        LRU (post-RoPE, positions [0, pb)), evicting the least recently
        used entries past ``prefix_cache_size`` or the byte budget."""
        if self.prefix_cache_size <= 0 or req.prefix_len < self.prefix_min_tokens:
            return
        if not self.paged:
            key = tuple(req.prompt_ids[: req.prefix_len])
            if key in self._prefix_lru:
                return
            pb = self._prefix_bucket(req.prefix_len)
            pk, pv = llama.extract_prefix(self._cache, slot, pb)
            ent = _Prefix(pk=pk, pv=pv, length=req.prefix_len, pb=pb)
            self._prefix_lru[key] = ent
            self._prefix_bytes += ent.nbytes
            while self._prefix_lru and (len(self._prefix_lru) > self.prefix_cache_size
                                        or self._prefix_bytes > self.prefix_cache_max_bytes):
                _, old = self._prefix_lru.popitem(last=False)
                self._prefix_bytes -= old.nbytes
            return
        nbp = -(-req.prefix_len // self.kv_page_size)
        pages = [int(p) for p in self._block_tables[slot, :nbp]]
        if any(p >= self._kv_sentinel for p in pages):
            return  # the allocation does not cover the prefix
        self._kv_pool.register(req.prompt_ids, req.prefix_len, pages)

    def _prefix_bucket(self, prefix_len: int) -> int:
        """The positions a pinned legacy prefix carries: the smallest prefill
        bucket that fits it, else the smallest multiple of the largest
        bucket (never the whole row), capped at ``max_seq_len``."""
        for b in self.prefill_buckets:
            if prefix_len <= b:
                return b
        step = self.prefill_buckets[-1]
        return min(-(-prefix_len // step) * step, self.max_seq_len)

    def _begin_chunked(self, slot: int, req: _Request, prefix=None):
        """Split a long prompt into full chunks, from the prefix length when
        a cached ``prefix`` is wired into the slot's pages (legacy: copied
        into its row here); the final chunk slides left to end at the prompt
        end (re-fed positions recompute identical K/V), so no chunk carries
        pad tokens.  A remainder longer than a chunk keeps the final chunk
        past the prefix."""
        n = len(req.prompt_ids)
        base = prefix.length if prefix is not None else 0
        c = self.chunk_size
        flat = np.asarray(req.prompt_ids, np.int32)
        starts = list(range(base, n - c, c)) + [n - c]
        ids = np.stack([flat[s : s + c] for s in starts])
        if prefix is not None and not self.paged:
            llama.insert_prefix(self._cache, prefix.pk, prefix.pv, slot)
        req.started_at = time.monotonic()
        self._chunking = _ChunkedPrefill(request=req, slot=slot, ids=ids, starts=starts, n=n)

    def _stage_chunk(self, st: _ChunkedPrefill) -> None:
        """Write the next chunk's inputs into the chunk buffers, in stream
        order, and count it as taken."""
        j = st.step
        self._upload(self._chunk_ids_dev, st.ids[j : j + 1])
        if self.paged:
            self._upload(self._chunk_bt_dev, self._block_tables[st.slot])
        self._upload(self._chunk_slot_dev, np.asarray([st.slot], np.int64))
        self._upload(self._chunk_start_dev, np.asarray([st.starts[j]], np.int64))
        st.step += 1

    def _chunk_body(self) -> torch.Tensor:
        """The staged chunk's forward and cache writes (every chunk is full of
        real tokens); returns its logits.  The piggyback graph holds it."""
        if self.paged:
            logits, _ = llama.prefill_chunk_paged(
                self.params, self.cfg, self._chunk_ids_dev, self._cache, self._chunk_bt_dev,
                self._chunk_slot_dev, self._chunk_start_dev, self.chunk_size,
            )
        else:
            logits, _ = llama.prefill_chunk(
                self.params, self.cfg, self._chunk_ids_dev, self._cache,
                self._chunk_slot_dev, self._chunk_start_dev, self.chunk_size,
            )
        return logits

    def _abandon_dead_prefill(self, st: _ChunkedPrefill) -> bool:
        """After a chunk: drop a prefill whose client cancelled or whose
        deadline passed (its pages free); True when it was dropped."""
        if not self._dead(st.request, time.monotonic(), "during chunked prefill"):
            return False
        self._free_slot_pages(st.slot)
        self._chunking = None
        return True

    def _chunk_step(self):
        """One chunk on its own; the final one activates the slot."""
        st = self._chunking
        self._stage_chunk(st)
        logits = self._chunk_body()
        if self._abandon_dead_prefill(st):
            return
        if st.step >= len(st.starts):
            self._chunking = None
            self._maybe_register_prefix(st.slot, st.request)
            self._starting_batch = [(st.slot, st.request)]
            self._activate_batch([st.slot], [st.request], logits, pad=0)
            self._starting_batch = None
            self._slots[st.slot].prefill_chunks = st.step

    def _piggyback_step(self):
        """A non-final chunk and the decode tick of the live slots as one
        program, chunk first (the JAX piggyback program's order: the chunk
        writes only the admitting slot's pages, which no live slot reads,
        and draws no noise, so the ids are those of the sequential path)."""
        st = self._chunking
        self._stage_chunk(st)
        self._issue_tick(piggyback=True)
        self._prefill_chunks_piggybacked += 1
        self._abandon_dead_prefill(st)

    def _activate_batch(self, slots: List[int], reqs: List[_Request], logits, *, pad: int):
        """Sample first tokens from prefill logits ([Bp, V], the first ``pad``
        rows batch padding), chain them into the decode token array on the
        device, and make the wave's slots live."""
        temps = np.asarray([1.0] * pad + [r.temperature for r in reqs], np.float32)
        top_ps = np.asarray([1.0] * pad + [r.top_p for r in reqs], np.float32)
        idx = self._tensor(np.asarray(slots, np.int64))
        kw = dict(temperature=self._tensor(temps), top_k=TOP_K, top_p=self._tensor(top_ps),
                  generator=self._generator)
        self.activations += 1
        if any(r.json for r in reqs):
            # JSON rows start in the FSM's initial state: its mask on the
            # first token, then the state advances (JAX _make_activate)
            self._ensure_fsm()
            jmask = np.asarray([False] * pad + [r.json for r in reqs])
            states = np.full((len(jmask),), self._fsm.initial, np.int32)
            first, advanced = sample_logits(
                logits, allowed=self._fsm_allowed_dev, fsm_state=self._tensor(states),
                jmask=self._tensor(jmask), next_state=self._fsm_next_dev, **kw,
            )
            self._fsm_states_dev.index_put_((idx,), advanced[pad:])
        else:
            first = sample_logits(logits, **kw)
        self._tokens_dev.index_put_((idx,), first[pad:])
        now = time.monotonic()
        ref_slots = []
        for slot, req in zip(slots, reqs):
            if req.started_at is None:  # chunked prefills set it at begin
                req.started_at = now
            self._slots[slot] = _Slot(request=req)
            self._temps[slot] = req.temperature
            self._top_ps[slot] = req.top_p
            self._json[slot] = req.json
            ref_slots.append((slot, self._slot_epoch[slot]))
            if self.speculative:
                # the prompt is the draft source (prompt-lookup): seed the
                # slot's history row with it, in stream order
                row = np.zeros((self.max_seq_len,), np.int32)
                n = min(len(req.prompt_ids), self.max_seq_len)
                row[:n] = req.prompt_ids[:n]
                self._upload(self._history_dev[slot], row)
        self._sampling_dirty = True
        self._inflight.append(_TickRef(nxt=_HostCopy(first), slots=ref_slots, first=True, offset=pad))

    # ------------------------------------------------------------------ ticks
    def _upload_dirty(self) -> None:
        """Write changed sampling / block-table arrays into their buffers."""
        if self._sampling_dirty:
            self._upload(self._active_dev, np.asarray([s is not None for s in self._slots]))
            self._upload(self._temps_dev, self._temps)
            self._upload(self._top_ps_dev, self._top_ps)
            self._upload(self._json_dev, self._json)
            self._sampling_dirty = False
        if self._bt_dirty:
            self._upload(self._bt_dev, self._block_tables)
            self._bt_dirty = False

    def _decode_step(self) -> torch.Tensor:
        """One decode step of every slot over the engine's cache -> logits:
        through the block tables (paged), or over the slot cache with the
        chunked read of ``decode_kv_chunk`` or, with None, the full row."""
        if self.paged:
            logits, _ = llama.decode_step_paged(
                self.params, self.cfg, self._tokens_dev, self._cache, self._bt_dev,
                active=self._active_dev, attn_fp8=self.attn_fp8,
            )
        else:
            logits, _ = llama.decode_step(
                self.params, self.cfg, self._tokens_dev, self._cache, active=self._active_dev,
                kv_chunk=self.decode_kv_chunk, attn_fp8=self.attn_fp8,
            )
        return logits

    def _tick_body(self) -> None:
        """The fused tick: ``decode_steps`` chained decode + sampling steps
        over the engine's buffers, step ``i`` reading noise ``i``; ids go to
        ``_toks_dev[i]`` and chain through ``_tokens_dev``.  On the card this
        is what the graph holds (the chunked read's range is found on the
        device from the lengths, so one graph serves every fill)."""
        for i in range(self.decode_steps):
            logits = self._decode_step()
            nxt = sample_logits(
                logits, temperature=self._temps_dev, top_k=TOP_K,
                top_p=self._top_ps_dev, gumbel=self._noise[i],
            )
            self._toks_dev[i].copy_(nxt)
            self._tokens_dev.copy_(nxt)

    def _json_tick_body(self) -> None:
        """The JSON tick: one decode step, its sampling under the JSON rows'
        FSM masks, and the advance of their states; its ids go to
        ``_toks_dev[0]``.  On the card this is what the JSON graph holds."""
        logits = self._decode_step()
        nxt, states = sample_logits(
            logits, temperature=self._temps_dev, top_k=TOP_K, top_p=self._top_ps_dev,
            gumbel=self._noise[0], allowed=self._fsm_allowed_dev,
            fsm_state=self._fsm_states_dev, jmask=self._json_dev, next_state=self._fsm_next_dev,
        )
        self._fsm_states_dev.copy_(states)
        self._toks_dev[0].copy_(nxt)
        self._tokens_dev.copy_(nxt)

    def _spec_tick_body(self, rung: tuple) -> None:
        """One speculative tick at ``rung`` (width N, depth K):
        ``decode_steps`` chained verify steps over the engine's buffers, each
        draft (from the history) -> flat tree -> read-only verify forward ->
        acceptance (step ``i``'s position-0 draw reading noise ``i``) ->
        accepted-path commit (paged: inactive rows and everything past the
        run go to the dump page; legacy: the whole path at each row's
        length, garbage past the run) -> history, length and token update, as the JAX
        ``_make_spec_tick`` body.  Ids go to the rung's ``[steps, K+1, B]``
        buffer, counts to its ``[steps, B]`` one.  On the card this is what
        the rung's graph holds."""
        spec, depths, anc, branch = self._spec_consts[rung]
        N, K = rung
        toks_out, n_out = self._spec_out[rung]
        cache, active, hist = self._cache, self._active_dev, self._history_dev
        S = self.max_seq_len
        rel0 = torch.arange(S, device=self.device)[None, :]
        for i in range(self.decode_steps):
            tokens = self._tokens_dev
            draft = build_tree_draft(hist, cache.lengths, tokens, N, K)
            tree = flatten_tree(tokens, draft)  # [B, 1 + N*K]
            if self.paged:
                logits, tks, tvs = llama.verify_tree_step_paged(
                    self.params, self.cfg, tree, cache, self._bt_dev, depths, anc)
            else:
                logits, tks, tvs = llama.verify_tree_step(
                    self.params, self.cfg, tree, cache, depths, anc)
            out, n_new, bonus, path_idx = accept_tree(
                logits, tree, spec, temperature=self._temps_dev, top_k=TOP_K,
                top_p=self._top_ps_dev, gumbel=self._noise[i], branch=branch)
            n_new = torch.where(active, n_new, 0)
            if self.paged:
                llama.commit_tree_path_paged(cache, tks, tvs, path_idx, self._bt_dev, n_new,
                                             active)
            else:
                llama.commit_tree_path(cache, tks, tvs, path_idx)
            # the input token and the accepted ones into the history at
            # positions lengths .. lengths + K + 1 (past the run: garbage the
            # next steps overwrite; the drafter never reads past the length)
            row_tokens = torch.cat([tokens[:, None], out], dim=1)  # [B, K + 2]
            pos = torch.clamp(cache.lengths.long(), max=S - (K + 2))
            rel = rel0 - pos[:, None]
            in_window = (rel >= 0) & (rel < K + 2)
            gathered = torch.gather(row_tokens, 1, rel.clamp(0, K + 1))
            upd = torch.where(in_window & active[:, None], gathered, hist)
            hist.copy_(upd)
            cache.lengths.copy_(torch.where(
                active, torch.clamp(cache.lengths + n_new, max=S), cache.lengths))
            self._tokens_dev.copy_(torch.where(active, bonus, tokens))
            toks_out[i].copy_(out.T)
            n_out[i].copy_(n_new)

    def _launch_spec_tick(self, rung: tuple) -> None:
        """Draw each verify step's noise (one generator call a step, as a
        plain tick draws), then run ``rung``'s tick: its graph's replay on
        the card, the body on the CPU."""
        for i in range(self.decode_steps):
            gumbel_noise(self._noise[i], self._generator)
        graph = self._spec_graphs.get(rung)
        if graph is None:
            self._spec_tick_body(rung)
        else:
            graph[0].replay()
            graph[1].replayed()

    def _ensure_fsm(self) -> None:
        """The JSON token FSM (:func:`token_fsm`) and its tables on the
        device, padded to the model vocab (ids past the tokenizer are never
        valid JSON), as the JAX ``_ensure_fsm`` builds them; on the card also
        the JSON tick's graph.  Once per engine."""
        if self._fsm is not None:
            return
        fsm = token_fsm(self.tokenizer)
        V = self.cfg.vocab_size
        S, V_tok = fsm.allowed.shape
        n = min(V_tok, V)
        allowed = np.zeros((S, V), bool)
        allowed[:, :n] = fsm.allowed[:, :n]
        nxt = np.full((S, V), fsm.dead, np.int32)
        nxt[:, :n] = fsm.next_state[:, :n]
        self._fsm_allowed_dev = torch.from_numpy(allowed).to(self.device)
        self._fsm_next_dev = torch.from_numpy(nxt).to(self.device)
        self._fsm = fsm
        if self.device.type == "cuda":
            self._capture_json_tick()

    def _capture_json_tick(self) -> None:
        """Capture :meth:`_json_tick_body` as a CUDA graph in the tick's
        pool, on the tick's capture stream and with its private kernel
        scratch.  The JSON body runs the tick's kernels at the tick's shapes,
        which the tick's warm-up already ran on that stream, so it needs no
        warm-up of its own and may be captured while slots are live (a
        capture runs nothing)."""
        dev = self.device
        stream = self._capture_stream
        stream.wait_stream(torch.cuda.current_stream(dev))
        with torch.no_grad(), kernels.private_paged_scratch(self._graph_scratch):
            graph = torch.cuda.CUDAGraph()
            with kernels.record_graph_launches() as launches:
                with torch.cuda.graph(graph, pool=self._graph.pool(), stream=stream,
                                      capture_error_mode="thread_local"):
                    self._json_tick_body()
        self._json_graph, self._json_launches = graph, launches
        self.graph_captures += 1

    def _capture_tick(self) -> None:
        """Capture :meth:`_tick_body` as a CUDA graph, and, when prompts can
        chunk with piggybacking on, :meth:`_chunk_body` followed by it as a
        second one, once per engine, while every slot is idle.  A warm-up
        runs both bodies first on the capture stream (PyTorch's recipe): it
        fills the caches they read (rope tables, the paged kernel's scratch
        and counters for that stream, its occupancy answer, cuBLAS's
        workspace) outside the capture; with every slot inactive and the
        chunk's page chain all sentinels it writes only the dump page, the
        token buffers and slot 0's length, which are cleared after.  The
        paged kernel's scratch and counters are the graphs' own
        (:func:`~..kernels.private_paged_scratch`), allocated by the
        warm-up, so no eager call shares them; the two graphs share one
        memory pool, as they replay one at a time on one stream.  A
        speculative engine also captures each rung's tick
        (:meth:`_spec_tick_body`) in that pool, after every body's warm-up
        (with every slot inactive a verify step writes only the dump page
        and its output buffers).  The launches recorded in a graph are
        counted at each of its replays.  A failure raises: there is no
        eager fallback on the card."""
        dev = self.device
        piggyback = self.prefill_piggyback and self.chunk_size < self.max_seq_len - 1
        # made on the engine's stream, not inside the warm-up
        llama._rope_tables(self.cfg, self.max_seq_len, dev)
        stream = self._capture_stream = torch.cuda.Stream(dev)
        # the paged kernel's scratch and counters of these graphs, and nobody else's
        self._graph_scratch: Dict[tuple, tuple] = {}
        with torch.no_grad(), kernels.private_paged_scratch(self._graph_scratch):
            stream.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(stream):
                if piggyback:
                    self._chunk_body()
                self._tick_body()
                # every body warms up before any capture: a later warm-up
                # that grew a kernel's scratch would move it under a graph
                for rung in self._spec_consts:
                    self._spec_tick_body(rung)
            torch.cuda.current_stream(dev).wait_stream(stream)
            torch.cuda.synchronize(dev)
            torch.cuda.empty_cache()  # what the captures reserve is then their pool
            reserved = torch.cuda.memory_reserved(dev)
            graph = torch.cuda.CUDAGraph()
            with kernels.record_graph_launches() as launches:
                with torch.cuda.graph(graph, stream=stream, capture_error_mode="thread_local"):
                    self._tick_body()
            self._graph, self._graph_launches = graph, launches
            self.graph_captures += 1
            if piggyback:
                graph = torch.cuda.CUDAGraph()
                with kernels.record_graph_launches() as launches:
                    with torch.cuda.graph(graph, pool=self._graph.pool(), stream=stream,
                                          capture_error_mode="thread_local"):
                        self._chunk_body()
                        self._tick_body()
                self._piggyback_graph, self._piggyback_launches = graph, launches
                self.graph_captures += 1
            for rung in self._spec_consts:
                graph = torch.cuda.CUDAGraph()
                with kernels.record_graph_launches() as launches:
                    with torch.cuda.graph(graph, pool=self._graph.pool(), stream=stream,
                                          capture_error_mode="thread_local"):
                        self._spec_tick_body(rung)
                self._spec_graphs[rung] = (graph, launches)
                self.graph_captures += 1
        self.graph_pool_bytes = torch.cuda.memory_reserved(dev) - reserved
        for t in (self._tokens_dev, self._toks_dev, self._cache.lengths):
            t.zero_()
        for toks, n_new in self._spec_out.values():
            toks.zero_()
            n_new.zero_()
        torch.cuda.synchronize(dev)

    def _launch_tick(self, piggyback: bool = False, json: bool = False) -> None:
        """Draw each step's noise into its buffer (one generator call per
        step, in step order), then run the tick, after the staged chunk when
        ``piggyback``, or the single-step JSON tick when ``json``: replay
        its graph on the card, the bodies on the CPU."""
        for i in range(1 if json else self.decode_steps):
            gumbel_noise(self._noise[i], self._generator)
        if json:
            if self._json_graph is None:
                self._json_tick_body()
            else:
                self._json_graph.replay()
                self._json_launches.replayed()
        elif self._graph is None:
            if piggyback:
                self._chunk_body()
            self._tick_body()
        elif piggyback:
            self._piggyback_graph.replay()
            self._piggyback_launches.replayed()
        else:
            self._graph.replay()
            self._graph_launches.replayed()

    def _issue_tick(self, piggyback: bool = False):
        """Dispatch one fused tick (after the staged chunk when
        ``piggyback``) without waiting for its result.  The injected
        ``tick_raise`` and ``slow_tick`` faults fire here, on the host,
        before anything is launched."""
        t0 = time.perf_counter()
        if self._faults is not None:
            self._faults.maybe_raise("tick_raise", "device step")
            delay = self._faults.sleep_s("slow_tick")
            if delay:
                time.sleep(delay)
        self._upload_dirty()
        if self.speculative:
            if self.scheduler is not None and self.scheduler.degraded():
                # under queue pressure a verify forward is wasted work at low
                # acceptance: a plain tick (the JAX degradation rule)
                self.spec_skipped_load += 1
            else:
                rung = self._spec_ctl.rung()
                if rung is None:
                    self.spec_skipped_accept += 1
                else:
                    self._issue_spec_tick(t0, rung)
                    return
        # while a JSON slot is live the whole batch takes single-step JSON
        # ticks (the JAX rule); a piggyback never coincides with one
        json = bool(self._json.any())
        if json and self.decode_steps > 1:
            self._json_downgraded_ticks += 1
        self._launch_tick(piggyback, json=json)
        self.steps += 1 if json else self.decode_steps
        self._ticks_issued += 1
        self._kv_frac_sum += self._kv_read_frac()
        live = [(i, self._slot_epoch[i]) for i, s in enumerate(self._slots) if s is not None]
        toks = self._toks_dev[:1] if json else self._toks_dev
        self._inflight.append(_TickRef(nxt=_HostCopy(toks), slots=live))
        self._tick_issue_s += time.perf_counter() - t0

    def _issue_spec_tick(self, t0: float, rung: tuple) -> None:
        """Dispatch one speculative tick at the controller's rung without
        waiting for its result; each of its verify steps advances a slot by
        1 to K+1 tokens."""
        self._launch_spec_tick(rung)
        self.steps += self.decode_steps
        self.spec_ticks_issued += 1
        self._ticks_issued += 1
        self._kv_frac_sum += 1.0  # the tree verify reads the whole row
        live = [(i, self._slot_epoch[i]) for i, s in enumerate(self._slots) if s is not None]
        toks, n_new = self._spec_out[rung]
        self._inflight.append(_TickRef(nxt=_HostCopy(toks), slots=live,
                                       n_new=_HostCopy(n_new), spec_rung=rung))
        self._tick_issue_s += time.perf_counter() - t0

    def _process_tick(self):
        """Consume the oldest in-flight result (waits until it arrives): a
        tick's steps oldest first, each over the slots live at issue."""
        ref = self._inflight.popleft()
        t0 = time.perf_counter()
        vals = ref.nxt.numpy()
        block_s = time.perf_counter() - t0
        self._tick_block_s += block_s
        self._ticks_processed += 1
        if self.obs is not None:
            self.obs.on_tick(block_s, len(ref.slots))
        now = time.monotonic()
        if self._faults is not None and ref.slots and self._faults.should_fire("nan_logits"):
            # what a NaN'd logits row yields after sampling: a garbage id
            # for one slot, which _consume_token quarantines
            vals = np.array(vals, copy=True)
            if ref.first:
                vals[ref.offset] = -1
            else:
                vals[..., ref.slots[0][0]] = -1
        if ref.first:
            for j, (slot, epoch) in enumerate(ref.slots):
                s = self._slots[slot]
                if s is None or self._slot_epoch[slot] != epoch:
                    continue  # reaped before its first token arrived
                s.resident_steps += 1
                self._consume_token(slot, s, int(vals[ref.offset + j]), now)
            self._notify_streams()
            return
        if ref.n_new is not None:
            self._process_spec_tick(ref, vals, now)
            self._notify_streams()
            return
        for slot, epoch in ref.slots:
            s = self._slots[slot]
            if s is not None and self._slot_epoch[slot] == epoch:
                s.resident_steps += vals.shape[0]
        for k in range(vals.shape[0]):
            for slot, epoch in ref.slots:
                s = self._slots[slot]
                if s is None or self._slot_epoch[slot] != epoch:
                    continue  # finished by an earlier token; dropped
                self._consume_token(slot, s, int(vals[k, slot]), now)
        self._notify_streams()

    def _process_spec_tick(self, ref: _TickRef, vals: np.ndarray, now: float) -> None:
        """A speculative tick's tokens, verify step by step (the JAX
        accounting): each live slot takes its step's ``n_new`` tokens
        (stopping at its finish), is charged ``n_new`` resident steps, and
        greedy rows add K drafted and ``n_new - 1`` accepted tokens, which
        the controller folds into the rung's acceptance EMA."""
        counts = ref.n_new.numpy()  # [steps, B]
        K = ref.spec_rung[1]
        greedy_row_steps = 0
        tick_accepted = 0
        for step in range(counts.shape[0]):
            for slot, epoch in ref.slots:
                s = self._slots[slot]
                if s is None or self._slot_epoch[slot] != epoch:
                    continue  # finished by an earlier step; drafts dropped
                n = int(counts[step, slot])
                s.resident_steps += max(1, n)
                if s.request.temperature <= 0:
                    self.spec_drafted += K
                    self.spec_accepted += max(0, n - 1)
                    greedy_row_steps += 1
                    tick_accepted += max(0, n - 1)
                for k in range(n):
                    if self._consume_token(slot, s, int(vals[step, k, slot]), now):
                        break  # the rest are post-finish garbage
        self.spec_row_steps += greedy_row_steps
        if greedy_row_steps:
            self._spec_ctl.note_tick(tick_accepted, K, greedy_row_steps, rung=ref.spec_rung)
            if self.obs is not None:
                self.obs.on_spec_tick(tick_accepted, K * greedy_row_steps)

    def _notify_streams(self) -> None:
        """One wakeup per stream that got tokens in this tick's processing."""
        for st in self._stream_notify:
            st.notify_now()
        self._stream_notify.clear()

    def _consume_token(self, slot: int, s: _Slot, tok: int, now: float) -> bool:
        """Append one sampled id to its slot; True when the slot is no
        longer live (finished or quarantined)."""
        if not 0 <= tok < self.cfg.vocab_size:
            # what a NaN'd logits row degenerates to: request poison
            self._quarantine(slot, RequestPoisoned(
                f"sampled id {tok} outside vocab [0, {self.cfg.vocab_size})"
                " — NaN/corrupt logits suspected; request quarantined", slot=slot,
            ))
            return True
        s.generated.append(tok)
        self._note_token(s, tok, now)
        if self._should_finish(s, tok):
            self._finish(slot)
            return True
        return False

    def _note_token(self, s: _Slot, tok: int, now: float) -> None:
        """TTFT and inter-token samples where a token reaches the host (the
        tokens of one tick share ``now``: gaps are sampled across ticks),
        and the token pushed to the request's stream (a deque append; the id
        is already on the host, so streaming adds no device sync).  EOS is
        not pushed: ``_finish`` drops it from the text too."""
        req = s.request
        if req.first_token_at is None:
            req.first_token_at = now
            self._ttft_s.append(now - req.submitted_at)
            if self.obs is not None:
                self.obs.on_first_token(now - req.submitted_at)
        elif s.last_token_at is not None and now > s.last_token_at:
            self._itl_s.append(now - s.last_token_at)
            if self.obs is not None:
                self.obs.on_token_gap(now - s.last_token_at)
        s.last_token_at = now
        if req.stream is not None and tok != self.tokenizer.eos_id:
            if req.stream.push_token(tok, notify=False):
                self._stream_notify.add(req.stream)

    def _should_finish(self, s: _Slot, tok: int) -> bool:
        if tok == self.tokenizer.eos_id:
            return True
        if len(s.generated) >= s.request.max_tokens:
            return True
        # cache full -> decode_step freezes the slot; finish as length-
        # limited.  A speculative tick commits up to decode_steps * (K + 1)
        # positions, so spec engines keep that much headroom, less one
        headroom = self.decode_steps * (self.speculative + 1) - 1 if self.speculative else 0
        return len(s.request.prompt_ids) + len(s.generated) >= self.max_seq_len - headroom

    def _release(self, slot: int) -> None:
        self._slots[slot] = None
        self._slot_epoch[slot] += 1  # invalidate this slot's in-flight ticks
        self._json[slot] = False
        self._sampling_dirty = True
        self._free_slot_pages(slot)

    def _finish(self, slot: int):
        s = self._slots[slot]
        self._release(slot)
        req = s.request
        ids = s.generated
        hit_eos = bool(ids) and ids[-1] == self.tokenizer.eos_id
        if hit_eos:
            ids = ids[:-1]
        now = time.monotonic()
        try:
            if self._faults is not None:
                self._faults.maybe_raise("detok_raise", "detokenize")
            text = self.tokenizer.decode(ids)
        except Exception as e:
            # request poison: only this result is lost (the slot is free)
            logger.warning("detokenization failed; quarantining request: %s", e)
            self.poisoned_requests += 1
            if self.obs is not None:
                self.obs.flight.record("quarantine", trace_id=req.trace_id, error=str(e))
                self.obs.flight.dump("quarantine", trace_id=req.trace_id)
            _safe_resolve(req.future, exc=e)
            return
        detok_s = max(0.0, time.monotonic() - now)
        result = GenerationResult(
            token_ids=ids,
            text=text,
            prompt_tokens=len(req.prompt_ids),
            completion_tokens=len(ids),
            length_limited=not hit_eos,
            ttft_s=(req.first_token_at or now) - req.submitted_at,
            latency_s=now - req.submitted_at,
        )
        if self.scheduler is not None:
            # the service model's sample: slot residency from prefill start,
            # per decode step and prefill chunk the slot took
            self.scheduler.note_service(
                now - (req.started_at or req.first_token_at or now),
                tokens=max(1, s.resident_steps + s.prefill_chunks),
            )
        if self.obs is not None:
            self.obs.on_finish(req, result, now=now + detok_s, detok_s=detok_s)
        _safe_resolve(req.future, result=result)

    # ------------------------------------------------------------- supervision
    def _quarantine(self, slot: int, err: BaseException) -> None:
        """Fail one slot's request and free the slot (the epoch bump drops
        its in-flight tokens); batch-mates keep decoding."""
        s = self._slots[slot]
        if s is None:
            return
        self._release(slot)
        self.poisoned_requests += 1
        if self.obs is not None:
            self.obs.flight.record("quarantine", trace_id=s.request.trace_id, slot=slot,
                                   error=str(err))
            self.obs.flight.dump("quarantine", trace_id=s.request.trace_id)
        _safe_resolve(s.request.future, exc=err)

    def _restart(self, err: BaseException):
        """Crash-only restart after an engine-fatal error: rebuild the device
        state in place, salvage what is safely retryable, fail the rest.

        Queued work is untouched (it never reached the device).  Requests in
        flight that emitted no token yet (mid-prefill, awaiting activation,
        live before their first token reached the host) are resubmitted at
        the head of their queue with their own futures; a request past its
        first token fails with the error; each request survives at most
        ``max_request_restarts`` restarts.  The page pool, its prefix
        registry (whose pages belong to the failed lineage) and the block
        tables are reset.  If the rebuild itself raises, the engine declares
        itself dead.  After ``max_restarts`` restarts inside
        ``restart_window_s`` the circuit opens: ``submit`` raises
        :class:`EngineUnavailable` until the cooldown ends."""
        now = time.monotonic()
        self.engine_restarts += 1
        self._restart_times.append(now)
        if self.obs is not None:
            if isinstance(err, FaultInjected):
                self.obs.flight.record("fault_fire", site=err.site, error=str(err))
            self.obs.flight.record("restart", error=f"{type(err).__name__}: {err}",
                                   engine_restarts=self.engine_restarts)
        salvage: List[_Request] = []
        if self._starting_batch is not None:
            salvage.extend(req for _, req in self._starting_batch)
            self._starting_batch = None
        if self._chunking is not None:
            salvage.append(self._chunking.request)
            self._chunking = None
        self._inflight.clear()
        for i, s in enumerate(self._slots):
            if s is not None:
                if s.generated:
                    _safe_resolve(s.request.future, exc=err)
                else:
                    salvage.append(s.request)
            self._slots[i] = None
            self._slot_epoch[i] += 1
        self._json[:] = False
        # a failure inside an activation can leave a request both slotted
        # and in _starting_batch: salvage each request once
        seen: set = set()
        requeue: List[_Request] = []
        for req in salvage:
            if id(req) in seen or req.future.cancelled():
                continue
            seen.add(id(req))
            if req.restarts >= self.max_request_restarts:
                self.restarted_failed += 1
                if self.obs is not None:
                    self.obs.flight.record("restart_failed", trace_id=req.trace_id,
                                           restarts=req.restarts)
                _safe_resolve(req.future, exc=err)
                continue
            req.restarts += 1
            req.started_at = None
            req.first_token_at = None
            self.restarted_resubmitted += 1
            if self.obs is not None:
                self.obs.flight.record("resubmit", trace_id=req.trace_id, restarts=req.restarts)
            requeue.append(req)
        # head inserts reverse the order: insert the newest first, so each
        # queue ends up with its salvaged requests back in FIFO order
        requeue.sort(key=lambda r: r.submitted_at, reverse=True)
        for req in requeue:
            self._requeue_front(req)
        try:
            self.reset()
        except Exception:
            # recovery itself failed (a sticky device error, an allocation
            # that cannot succeed): declare the engine dead; the loop exits
            # and fails everything queued, so later submits fail fast
            logger.exception("engine recovery failed; declaring the engine dead")
            self._running = False
            if self.obs is not None:
                self.obs.flight.record("engine_dead", error=f"{type(err).__name__}: {err}")
                self.obs.flight.dump("engine_dead", error=str(err))
            return
        recent = [t for t in self._restart_times if t >= now - self.restart_window_s]
        if len(recent) >= self.max_restarts:
            self.circuit_trips += 1
            self._degraded_until = now + self.degraded_cooldown_s
            if self.obs is not None:
                self.obs.flight.record("circuit_open", restarts_in_window=len(recent),
                                       cooldown_s=self.degraded_cooldown_s)
            logger.error("engine circuit OPEN: %d restarts in %.0fs; degraded for %.1fs",
                         len(recent), self.restart_window_s, self.degraded_cooldown_s)
        if self.obs is not None:
            self.obs.flight.dump("restart", error=str(err))


class EmbeddingEngine:
    """Batched, coalescing sentence-embedding engine over one encoder model
    (port of the JAX ``EmbeddingEngine``).

    Requests from concurrent callers coalesce into one device batch: the
    sequence length pads to a bucket of ``seq_buckets`` (capped at the
    model's positions), the batch to a power of two up to ``max_batch``; pad
    rows see one token, so the masked mean never divides by zero.  The queue
    is bounded: past ``max_queue`` waiting requests ``embed`` sheds with
    :class:`~.scheduler.SchedulerRejected` (HTTP 429).  Requests whose
    futures were cancelled are dropped before they pad out a batch.  The
    batch's rows are independent of each other in every op of the encoder,
    so a text embeds the same whatever its batch-mates (on the card, up to
    what a different GEMM kernel for another batch size rounds
    differently)."""

    def __init__(
        self,
        cfg: EncoderConfig,
        params,
        tokenizer: Tokenizer,
        *,
        max_batch: int = 64,
        seq_buckets: Sequence[int] = (32, 64, 128, 256, 512),
        normalize: bool = False,
        max_queue: int = 1024,
        mesh=None,
        device: DeviceLike = "cuda",
    ):
        if mesh is not None:
            raise NotImplementedError(
                "a sharded EmbeddingEngine (mesh=) waits for ROADMAP Queue 1 item 15 (parallelism)"
            )
        self.device = resolve_device(device)
        self.cfg = cfg
        self.params = params
        self.tokenizer = tokenizer
        self.max_batch = max_batch
        self.seq_buckets = tuple(
            b for b in seq_buckets if b <= cfg.max_position_embeddings
        ) or (cfg.max_position_embeddings,)
        self.normalize = normalize
        self.max_queue = max(1, int(max_queue))
        self.shed = 0
        self.dropped_cancelled = 0
        self._queue: "queue.Queue[tuple[List[str], Future]]" = queue.Queue(maxsize=self.max_queue)
        self._running = False
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "EmbeddingEngine":
        if self._running:
            return self
        self._running = True
        self._thread = threading.Thread(target=self._loop, daemon=True, name="emb-engine")
        self._thread.start()
        return self

    def stop(self):
        self._running = False
        if self._thread:
            self._thread.join(timeout=10)
            self._thread = None
        err = RuntimeError("embedding engine stopped")
        while True:
            try:
                _, fut = self._queue.get_nowait()
            except queue.Empty:
                break
            _safe_resolve(fut, exc=err)

    def warmup(self, seq_buckets: Optional[Sequence[int]] = None) -> None:
        """Run the encoder once at every (batch bucket, sequence bucket)
        shape (the JAX ``warmup``'s compiles), so no first-use cost (a
        cuBLAS plan, a kernel build) lands on a live batch."""
        with torch.no_grad():
            for bucket in seq_buckets if seq_buckets is not None else self.seq_buckets:
                for b in self._batch_buckets():
                    ids = torch.zeros((b, bucket), dtype=torch.int32, device=self.device)
                    mask = torch.ones((b, bucket), dtype=torch.int32, device=self.device)
                    encoder.encode(self.params, self.cfg, ids, mask, normalize=self.normalize)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def embed_sync(self, texts: Sequence[str]) -> List[List[float]]:
        """Blocking batched embed (the engine thread's path)."""
        out: List[List[float]] = []
        for i in range(0, len(texts), self.max_batch):
            out.extend(self._embed_batch(list(texts[i : i + self.max_batch])))
        return out

    async def embed(self, texts: Sequence[str]) -> List[List[float]]:
        if not texts:
            return []
        fut: Future = Future()
        try:
            self._queue.put_nowait((list(texts), fut))
        except queue.Full:
            self.shed += 1
            # one queue's worth of batches at about the coalescer's cadence
            raise SchedulerRejected(
                "embedding queue full", retry_after_s=min(30.0, 1.0 + self.max_queue * 0.01)
            ) from None
        if not self._running:
            self.start()
        return await asyncio.wrap_future(fut)

    def _loop(self):
        while self._running:
            try:
                texts, fut = self._queue.get(timeout=0.05)
            except queue.Empty:
                continue
            # coalesce whatever else waits now; cancelled clients are dropped
            # here, before their texts pad out a batch nobody will read
            jobs: List[tuple[List[str], Future]] = []
            total = 0
            if not fut.cancelled():
                jobs.append((texts, fut))
                total = len(texts)
            else:
                self.dropped_cancelled += 1
            while total < self.max_batch:
                try:
                    t2, f2 = self._queue.get_nowait()
                except queue.Empty:
                    break
                if f2.cancelled():
                    self.dropped_cancelled += 1
                    continue
                jobs.append((t2, f2))
                total += len(t2)
            if not jobs:
                continue
            flat = [t for ts, _ in jobs for t in ts]
            try:
                embs = self.embed_sync(flat)
            except Exception as e:
                for _, f in jobs:
                    _safe_resolve(f, exc=e)
                continue
            pos = 0
            for ts, f in jobs:
                _safe_resolve(f, result=embs[pos : pos + len(ts)])
                pos += len(ts)

    def _batch_buckets(self) -> List[int]:
        sizes, b = [], 1
        while b < self.max_batch:
            sizes.append(b)
            b *= 2
        sizes.append(self.max_batch)
        return sizes

    def _embed_batch(self, texts: List[str]) -> List[List[float]]:
        cap = self.seq_buckets[-1]
        encoded = [self.tokenizer.encode(t)[:cap] for t in texts]
        longest = max((len(e) for e in encoded), default=1)
        bucket = pick_bucket(longest, self.seq_buckets, cap)
        B = len(encoded)
        Bp = pick_bucket(B, self._batch_buckets(), self.max_batch)
        ids = np.full((Bp, bucket), self.tokenizer.pad_id, np.int32)
        mask = np.zeros((Bp, bucket), np.int32)
        mask[B:, 0] = 1  # pad rows see one pad token; all-zero masks divide by 0
        for i, e in enumerate(encoded):
            ids[i, : len(e)] = e
            mask[i, : len(e)] = 1
        with torch.no_grad():
            embs = encoder.encode(
                self.params, self.cfg, torch.from_numpy(ids).to(self.device),
                torch.from_numpy(mask).to(self.device), normalize=self.normalize,
            )
        return embs[:B].cpu().numpy().tolist()
