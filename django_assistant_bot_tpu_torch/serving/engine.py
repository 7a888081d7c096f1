"""Continuous-batching generation engine, paged KV (port of ``serving/engine.py``).

This slice ports the JAX engine's paged path with its rollback settings:
``kv_layout="paged"``, FIFO admission (no scheduler), sequential chunked
prefill (no piggybacking), no prefix cache, single-step decode ticks, no
speculation and no JSON-constrained decoding.  Each of those knobs is still
accepted at its ported value and refused, naming its ROADMAP item, at any
other.  What is ported is the JAX engine's own logic:

- **Admission waves.**  Free slots take queued requests in FIFO order; each
  reserves ``ceil((prompt + max_tokens) / page)`` pages up front, so decode
  can never run out of pages mid-stream.  A wave is grouped by prefill
  bucket and each group is one prefill call whose batch pads to a batch
  bucket of {1, 4, max_slots}; pad rows come first and carry the slot-count
  and page sentinels, so their writes drop.  Prompts longer than
  ``chunk_size`` prefill one chunk per loop iteration, one at a time.
- **Decode ticks.**  One :func:`~..models.llama.decode_step_paged` plus
  sampling per tick for every live slot; the sampled ids stay on the device
  and chain into the next tick, and their host copies are consumed
  ``lookahead`` ticks behind, so the host never waits on the tick it just
  issued.  A request finishes on EOS, on ``max_tokens`` or at the context.
- **A background thread** runs the loop; ``submit`` is thread-safe and
  returns a ``concurrent.futures.Future``; ``generate`` awaits one from
  asyncio.
"""

from __future__ import annotations

import asyncio
import collections
import dataclasses
import logging
import queue
import threading
import time
from concurrent.futures import Future, InvalidStateError
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..models import DecoderConfig, llama
from ..ops.sampling import sample_logits
from .kv_pool import PageAllocator
from .tokenizer import Tokenizer

logger = logging.getLogger(__name__)

PREFILL_BUCKETS = (32, 64, 128, 256, 512, 1024, 2048, 4096, 8192)
TOP_K = 50  # sampling's top-k, the JAX engine's default
IDLE_POLL_S = 0.002  # loop sleep when there is no work


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


def _refuse(knob: str, value: Any, ported: Any, item: str) -> None:
    if value != ported:
        raise NotImplementedError(
            f"{knob}={value!r} is not ported yet (only {ported!r}); ROADMAP {item}"
        )


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
    first_token_at: Optional[float] = None


@dataclasses.dataclass
class _Slot:
    request: _Request
    generated: List[int] = dataclasses.field(default_factory=list)


class _HostCopy:
    """A device tensor's copy on its way to the host: started without
    blocking (pinned buffer + event on CUDA), waited for in :meth:`numpy`."""

    def __init__(self, t: torch.Tensor):
        if t.device.type == "cuda":
            self._host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            self._host.copy_(t, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record()
        else:
            self._host = t
            self._event = None

    def numpy(self) -> np.ndarray:
        if self._event is not None:
            self._event.synchronize()
        return self._host.numpy()


@dataclasses.dataclass
class _TickRef:
    """One issued-but-not-yet-processed device result.  ``slots`` records
    (slot, epoch) for every slot live at issue time; entries whose epoch has
    moved on (request finished earlier) are dropped.  ``first=True`` marks
    an activation: ``nxt`` holds the wave's first tokens, entry ``offset + j``
    belonging to ``slots[j]`` (rows below ``offset`` are batch padding)."""

    nxt: _HostCopy
    slots: List[tuple]
    first: bool = False
    offset: int = 0


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
        decode_kv_chunk: Optional[int] = 0,
        kv_page_size: int = 0,
        kv_pages: int = 0,
        # the JAX engine's rollback settings: the only values ported so far
        kv_layout: str = "paged",
        scheduler: Any = None,
        prefill_piggyback: bool = False,
        prefix_cache_size: int = 0,
        decode_steps: int = 1,
        speculative: int = 0,
        kv_cache_dtype: Optional[str] = None,
        attn_fp8: bool = False,
    ):
        _refuse("kv_layout", kv_layout, "paged", "Queue 1 item 8 (legacy contiguous KV)")
        _refuse("scheduler", scheduler, None, "Queue 1 item 5 (scheduler)")
        _refuse("prefill_piggyback", prefill_piggyback, False, "Queue 1 item 5 (piggybacked prefill)")
        _refuse("prefix_cache_size", prefix_cache_size, 0, "Queue 1 item 5 (prefix sharing)")
        _refuse("decode_steps", decode_steps, 1, "Queue 1 item 5 (fused N-step ticks)")
        _refuse("speculative", speculative, 0, "Queue 1 item 9 (speculative decoding)")
        _refuse("kv_cache_dtype", kv_cache_dtype, None, "Queue 2 entry 5 (fp8 KV)")
        _refuse("attn_fp8", attn_fp8, False, "Queue 2 entry 5 (fp8 KV)")
        self.device = resolve_device(device)
        if params["tok_embed"].device != self.device:
            raise ValueError(
                f"params live on {params['tok_embed'].device}, engine device is {self.device}"
            )
        self.cfg = cfg
        self.params = params
        self.tokenizer = tokenizer
        self.max_slots = max_slots
        self.max_seq_len = int(min(max_seq_len or cfg.max_seq_len, cfg.max_seq_len))
        self.prefill_buckets = tuple(b for b in PREFILL_BUCKETS if b <= self.max_seq_len) or (
            self.max_seq_len,
        )
        self.chunk_size = int(min(chunk_size, self.max_seq_len))
        self.lookahead = max(0, int(lookahead))

        page = int(kv_page_size) or self._resolve_kv_chunk(decode_kv_chunk) or 0
        if not page:
            for c in (512, 256, 128, 64, 32, 16, 8):
                if self.max_seq_len % c == 0 and self.max_seq_len // c >= 2:
                    page = c
                    break
        if not page or self.max_seq_len % page or self.max_seq_len // page < 2:
            raise ValueError(
                f"paged KV needs a page size dividing max_seq_len={self.max_seq_len} "
                f"into >= 2 pages (got {page or None}); the legacy fallback is "
                "ROADMAP Queue 1 item 8"
            )
        self.kv_page_size = page
        self._kv_blocks = self.max_seq_len // page
        n_pages = int(kv_pages) or self.max_slots * self._kv_blocks
        if n_pages < self._kv_blocks:
            raise ValueError(
                f"kv_pages={n_pages} cannot hold even one max-length request "
                f"({self._kv_blocks} pages of {page})"
            )
        self._kv_pool = PageAllocator(n_pages, page)
        self._kv_sentinel = n_pages  # block-table "unallocated" marker

        self._queue: "queue.Queue[_Request]" = queue.Queue()
        self._pending: "collections.deque[_Request]" = collections.deque()
        self._chunking: Optional[_ChunkedPrefill] = None
        self._slots: List[Optional[_Slot]] = [None] * max_slots
        self._slot_epoch = [0] * max_slots
        self._inflight: "collections.deque[_TickRef]" = collections.deque()
        self._slot_pages: List[List[int]] = [[] for _ in range(max_slots)]
        self._block_tables = np.full((max_slots, self._kv_blocks), self._kv_sentinel, np.int32)
        self._temps = np.zeros((max_slots,), np.float32)
        self._top_ps = np.ones((max_slots,), np.float32)
        self._generator = torch.Generator(device=self.device).manual_seed(0)
        self._reset_device_state()
        self._running = False
        self._thread: Optional[threading.Thread] = None
        self._iter_lock = threading.Lock()
        self.steps = 0
        self._ttft_s: "collections.deque[float]" = collections.deque(maxlen=1024)

    # ------------------------------------------------------------ device state
    def _reset_device_state(self) -> None:
        self._cache = llama.init_paged_cache(
            self.cfg, self.max_slots, self._kv_pool.n_pages, self.kv_page_size,
            device=self.device,
        )
        self._tokens_dev = torch.zeros((self.max_slots,), dtype=torch.int32, device=self.device)
        self._bt_dirty = True
        self._sampling_dirty = True
        self._upload_dirty()

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
        self._drain_incoming(RuntimeError("generation engine stopped"))

    def submit(
        self,
        prompt_ids: Sequence[int],
        *,
        max_tokens: int = 1024,
        temperature: float = 0.8,
        top_p: float = 0.95,
        json_format: bool = False,
    ) -> Future:
        """Thread-safe submission; returns a concurrent Future[GenerationResult]."""
        _refuse("json_format", json_format, False, "Queue 1 item 10 (JSON-constrained decoding)")
        prompt_ids = list(prompt_ids)
        limit = self.max_seq_len - 1  # room for at least one generated token
        if len(prompt_ids) > limit:
            prompt_ids = prompt_ids[-limit:]
        fut: Future = Future()
        self._queue.put(
            _Request(
                prompt_ids=prompt_ids,
                max_tokens=int(max_tokens),
                temperature=float(temperature),
                top_p=float(top_p),
                future=fut,
                submitted_at=time.monotonic(),
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
    ) -> GenerationResult:
        """Tokenize (chat-templating message lists), run, decode."""
        if isinstance(prompt, str):
            ids = self.tokenizer.encode(prompt)
        else:
            ids = self.tokenizer.encode_chat(prompt)
        fut = self.submit(
            ids, max_tokens=max_tokens, temperature=temperature, top_p=top_p,
            json_format=json_format,
        )
        return await asyncio.wrap_future(fut)

    @property
    def num_active(self) -> int:
        return sum(s is not None for s in self._slots)

    def stats(self) -> Dict[str, Any]:
        ttft = sorted(self._ttft_s)
        return {
            "active_slots": self.num_active,
            "steps": self.steps,
            "queued": self._queue.qsize() + len(self._pending),
            "kv_pages_total": self._kv_pool.n_pages,
            "kv_pages_free": self._kv_pool.pages_free,
            "kv_page_size": self.kv_page_size,
            "ttft_p50_s": ttft[len(ttft) // 2] if ttft else None,
        }

    # ---------------------------------------------------------------- the loop
    def _loop_iteration(self) -> bool:
        """One iteration: reap, admit, one chunk of a chunked prefill, one
        decode tick, then drain results ``lookahead`` ticks behind (fully when
        no slot is live).  Returns whether admission or a chunk progressed."""
        with self._iter_lock:
            self._reap_dead_slots()
            admitted = self._admit()
            if self._chunking is not None:
                self._chunk_step()
                admitted = True
            if self.num_active > 0:
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
                    try:
                        admitted = self._loop_iteration()
                        if not admitted and self.num_active == 0 and not self._inflight:
                            time.sleep(IDLE_POLL_S)
                    except Exception as e:
                        logger.exception("engine loop error; failing in-flight requests")
                        with self._iter_lock:
                            self._fail_all(e)
                            self._reset_device_state()  # clean pools for what comes next
        finally:
            self._running = False
            self._fail_all(RuntimeError("generation engine stopped"))

    def _fail_all(self, err: BaseException) -> None:
        """Fail every live, mid-prefill and queued request and free their pages."""
        self._inflight.clear()
        for i, s in enumerate(self._slots):
            if s is not None:
                _safe_resolve(s.request.future, exc=err)
                self._slots[i] = None
                self._slot_epoch[i] += 1
            self._free_slot_pages(i)
        if self._chunking is not None:
            _safe_resolve(self._chunking.request.future, exc=err)
            self._free_slot_pages(self._chunking.slot)
            self._chunking = None
        while self._pending:
            _safe_resolve(self._pending.popleft().future, exc=err)
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

    def _reap_dead_slots(self) -> None:
        """Free slots (and drop queued requests) whose future the client cancelled."""
        if self._pending:
            self._pending = collections.deque(r for r in self._pending if not r.future.cancelled())
        for i, s in enumerate(self._slots):
            if s is not None and s.request.future.cancelled():
                self._slots[i] = None
                self._slot_epoch[i] += 1
                self._sampling_dirty = True
                self._free_slot_pages(i)

    # --------------------------------------------------------------- admission
    def _paged_admit_slot(self, slot: int, req: _Request) -> bool:
        """Reserve the request's worst-case pages for ``slot``; False = the
        pool cannot place it now (it stays queued until pages free)."""
        demand_tokens = min(len(req.prompt_ids) + req.max_tokens, self.max_seq_len)
        pages = self._kv_pool.alloc(-(-demand_tokens // self.kv_page_size))
        if pages is None:
            return False
        self._slot_pages[slot] = pages
        self._block_tables[slot, :] = self._kv_sentinel
        self._block_tables[slot, : len(pages)] = pages
        self._bt_dirty = True
        return True

    def _free_slot_pages(self, slot: int) -> None:
        if not self._slot_pages[slot]:
            return
        self._kv_pool.decref(self._slot_pages[slot])
        self._slot_pages[slot] = []
        self._block_tables[slot, :] = self._kv_sentinel
        self._bt_dirty = True

    def _admit(self) -> bool:
        while True:
            try:
                self._pending.append(self._queue.get_nowait())
            except queue.Empty:
                break
        free = self._free_slots()
        batch: List[tuple[int, _Request]] = []
        admitted = False
        while free and self._pending:
            req = self._pending[0]
            n = len(req.prompt_ids)
            if n > self.chunk_size and (self._chunking is not None or batch):
                break  # one chunked prefill at a time; FIFO order preserved
            slot = free[0]
            if not self._paged_admit_slot(slot, req):
                break  # out of pages: the head waits for a slot to free
            self._pending.popleft()
            free.pop(0)
            if n > self.chunk_size:
                self._begin_chunked(slot, req)
                admitted = True
            else:
                batch.append((slot, req))
        if batch:
            # group the wave by seq bucket: short prompts must not pay the
            # longest prompt's attention; one prefill call per bucket group
            groups: Dict[int, List[tuple[int, _Request]]] = {}
            for slot, req in batch:
                b = pick_bucket(len(req.prompt_ids), self.prefill_buckets, self.chunk_size)
                groups.setdefault(b, []).append((slot, req))
            for group in groups.values():
                self._start_batch(group)
            admitted = True
        return admitted

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

    def _tensor(self, arr) -> torch.Tensor:
        return torch.as_tensor(np.asarray(arr)).to(self.device)

    def _start_batch(self, batch: List[tuple[int, _Request]]):
        """One prefill call for a bucket group of the wave, then activation."""
        reqs = [r for _, r in batch]
        slots = [s for s, _ in batch]
        bucket = pick_bucket(
            max(len(r.prompt_ids) for r in reqs), self.prefill_buckets, self.chunk_size
        )
        Bp = pick_bucket(len(batch), self._batch_buckets(), self.max_slots)
        pad = Bp - len(batch)
        ids = np.full((Bp, bucket), self.tokenizer.pad_id, np.int32)
        lengths = np.zeros((Bp,), np.int32)
        slot_arr = np.full((Bp,), self.max_slots, np.int32)  # pad rows: sentinel
        for j, req in enumerate(reqs):
            n = len(req.prompt_ids)
            ids[pad + j, :n] = req.prompt_ids
            lengths[pad + j] = n
            slot_arr[pad + j] = slots[j]
        lengths_t = self._tensor(lengths)
        logits, ks, vs = llama.prefill(self.params, self.cfg, self._tensor(ids), lengths_t)
        self._cache = llama.insert_sequences_paged(
            self._cache, ks, vs, lengths_t, self._tensor(slot_arr),
            self._tensor(self._wave_block_tables(slots, pad)),
        )
        self._activate_batch(slots, reqs, logits, pad=pad)

    def _begin_chunked(self, slot: int, req: _Request):
        """Split a long prompt into full chunks; the final chunk slides left
        to end at the prompt end (re-fed positions recompute identical K/V),
        so no chunk carries pad tokens."""
        n = len(req.prompt_ids)
        c = self.chunk_size
        flat = np.asarray(req.prompt_ids, np.int32)
        starts = list(range(0, n - c, c)) + [n - c]
        ids = np.stack([flat[s : s + c] for s in starts])
        self._chunking = _ChunkedPrefill(request=req, slot=slot, ids=ids, starts=starts, n=n)

    def _chunk_step(self):
        st = self._chunking
        j = st.step
        logits, self._cache = llama.prefill_chunk_paged(
            self.params, self.cfg, self._tensor(st.ids[j : j + 1]), self._cache,
            self._tensor(self._block_tables[st.slot]), st.slot, st.starts[j],
            self.chunk_size,
        )
        st.step += 1
        if st.request.future.cancelled():
            self._free_slot_pages(st.slot)
            self._chunking = None
            return
        if st.step >= len(st.starts):
            self._chunking = None
            self._activate_batch([st.slot], [st.request], logits, pad=0)

    def _activate_batch(self, slots: List[int], reqs: List[_Request], logits, *, pad: int):
        """Sample first tokens from prefill logits ([Bp, V], the first ``pad``
        rows batch padding), chain them into the decode token array on the
        device, and make the wave's slots live."""
        temps = np.asarray([1.0] * pad + [r.temperature for r in reqs], np.float32)
        top_ps = np.asarray([1.0] * pad + [r.top_p for r in reqs], np.float32)
        first = sample_logits(
            logits, temperature=self._tensor(temps), top_k=TOP_K,
            top_p=self._tensor(top_ps), generator=self._generator,
        )
        idx = self._tensor(np.asarray(slots, np.int64))
        self._tokens_dev = self._tokens_dev.index_put((idx,), first[pad:])
        ref_slots = []
        for slot, req in zip(slots, reqs):
            self._slots[slot] = _Slot(request=req)
            self._temps[slot] = req.temperature
            self._top_ps[slot] = req.top_p
            ref_slots.append((slot, self._slot_epoch[slot]))
        self._sampling_dirty = True
        self._inflight.append(_TickRef(nxt=_HostCopy(first), slots=ref_slots, first=True, offset=pad))

    # ------------------------------------------------------------------ ticks
    def _upload_dirty(self) -> None:
        """Stage changed sampling / block-table arrays on the device."""
        if self._sampling_dirty:
            self._active_dev = self._tensor([s is not None for s in self._slots])
            self._temps_dev = self._tensor(self._temps)
            self._top_ps_dev = self._tensor(self._top_ps)
            self._sampling_dirty = False
        if self._bt_dirty:
            self._bt_dev = self._tensor(self._block_tables)
            self._bt_dirty = False

    def _issue_tick(self):
        """Dispatch one decode tick without waiting for its result."""
        self._upload_dirty()
        logits, self._cache = llama.decode_step_paged(
            self.params, self.cfg, self._tokens_dev, self._cache, self._bt_dev,
            active=self._active_dev,
        )
        nxt = sample_logits(
            logits, temperature=self._temps_dev, top_k=TOP_K,
            top_p=self._top_ps_dev, generator=self._generator,
        )
        self._tokens_dev = nxt
        self.steps += 1
        live = [(i, self._slot_epoch[i]) for i, s in enumerate(self._slots) if s is not None]
        self._inflight.append(_TickRef(nxt=_HostCopy(nxt), slots=live))

    def _process_tick(self):
        """Consume the oldest in-flight result (waits until it arrives)."""
        ref = self._inflight.popleft()
        vals = ref.nxt.numpy()
        now = time.monotonic()
        for j, (slot, epoch) in enumerate(ref.slots):
            s = self._slots[slot]
            if s is None or self._slot_epoch[slot] != epoch:
                continue  # finished by an earlier token; dropped
            tok = int(vals[ref.offset + j] if ref.first else vals[slot])
            self._consume_token(slot, s, tok, now)

    def _consume_token(self, slot: int, s: _Slot, tok: int, now: float) -> None:
        req = s.request
        if not 0 <= tok < self.cfg.vocab_size:
            # what a NaN'd logits row degenerates to: fail this request only
            self._release(slot)
            _safe_resolve(
                req.future,
                exc=RuntimeError(f"sampled id {tok} outside vocab [0, {self.cfg.vocab_size})"),
            )
            return
        s.generated.append(tok)
        if req.first_token_at is None:
            req.first_token_at = now
            self._ttft_s.append(now - req.submitted_at)
        if self._should_finish(s, tok):
            self._finish(slot)

    def _should_finish(self, s: _Slot, tok: int) -> bool:
        if tok == self.tokenizer.eos_id:
            return True
        if len(s.generated) >= s.request.max_tokens:
            return True
        # cache full -> decode_step freezes the slot; finish as length-limited
        return len(s.request.prompt_ids) + len(s.generated) >= self.max_seq_len

    def _release(self, slot: int) -> None:
        self._slots[slot] = None
        self._slot_epoch[slot] += 1  # invalidate this slot's in-flight ticks
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
            text = self.tokenizer.decode(ids)
        except Exception as e:  # request-poison: only this result is lost
            logger.warning("detokenization failed: %s", e)
            _safe_resolve(req.future, exc=e)
            return
        _safe_resolve(
            req.future,
            result=GenerationResult(
                token_ids=ids,
                text=text,
                prompt_tokens=len(req.prompt_ids),
                completion_tokens=len(ids),
                length_limited=not hit_eos,
                ttft_s=(req.first_token_at or now) - req.submitted_at,
                latency_s=now - req.submitted_at,
            ),
        )
