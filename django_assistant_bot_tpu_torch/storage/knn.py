"""Exact cosine KNN over a corpus held on the card (port of ``storage/knn.py``).

The whole embedding matrix stays on the device in bf16, rows normalised, and
every query scores every row: exact, with no index to build, and mutation is
append or compact.  What is ported is the JAX module's own discipline:

- **Buckets.**  Query rows pad to {8, 32, 128} (then power-of-two multiples
  of 128), ``k`` pads to {16, 64, 256, 1024} and is cut on the host, appends
  go in row buckets of {64, 256, 1024, 4096} written at a start offset held
  in a device tensor, and capacity grows by power-of-two multiples.
- **One rounding.**  Rows are rounded to bf16 before they are normalised
  (in f32) and rounded again, on every route (full stage, host append,
  device append), so the routes give bit-identical rows.  Queries are
  normalised on the host in f32 and rounded to bf16 by the score.
- **Device appends.**  :meth:`VectorIndex.add_device` writes rows that
  already live on the device (fresh encoder output) without a host round
  trip; their host copy is fetched lazily and in bounded batches.
- **One fetch per search.**  Scores and row ids come back to the host in a
  single copy.

Allow-listed searches pass a position mask as the score's validity input.

:func:`topk_scores` is the score + top-k.  On a CUDA tensor it launches the
hand-written kernel ``csrc/knn_topk.cu`` (through :mod:`..kernels`); on a CPU
tensor it runs :func:`topk_scores_plain`, the JAX function's arithmetic in
plain PyTorch.  A sharded corpus (``mesh``) waits for ROADMAP Queue 1 item
15 and :meth:`VectorIndex.from_model` (the ORM) for item 16.
"""

from __future__ import annotations

import threading
from typing import Optional, Sequence

import numpy as np
import torch

from .. import kernels
from ..device import DeviceLike, resolve_device
from ..ops.sampling import top_k_auto

_QUERY_BUCKETS = (8, 32, 128)
_K_BUCKETS = (16, 64, 256, 1024)
_APPEND_BUCKETS = (64, 256, 1024, 4096)
_ROW_MULTIPLE = 128  # staged rows pad to a power-of-two multiple of this
GROUP = 128  # rows per group of the kernel's first pass


def _bucket(n: int, buckets: Sequence[int]) -> int:
    for b in buckets:
        if n <= b:
            return b
    return _next_cap(buckets[-1], n)


def _next_cap(base: int, target: int) -> int:
    """Smallest power-of-two multiple of ``base`` that is >= ``target``."""
    while base < target:
        base *= 2
    return base


def topk_scores_plain(
    index: torch.Tensor, queries: torch.Tensor, valid: torch.Tensor, k: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Masked cosine scores and their exact top-k, as ``_topk_scores_impl``
    computes them: queries rounded to bf16, bf16 x bf16 products summed in
    f32 (an f32 product of bf16-rounded inputs, so every product is exact),
    ``-inf`` where ``valid`` is false, then :func:`~..ops.sampling.top_k_auto`
    (hierarchical from 16,384 rows).  Returns (scores [Q, k] f32
    descending, ids [Q, k] int32)."""
    scores = queries.to(torch.bfloat16).float() @ index.float().T
    scores = torch.where(valid[None, :], scores, float("-inf"))
    return top_k_auto(scores, k)


def topk_scores(
    index: torch.Tensor, queries: torch.Tensor, valid: torch.Tensor, k: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """The exact top-k of the masked scores ``queries . index^T``: index
    ``[N, D]`` bf16 (normalised rows), queries ``[Q, D]`` (rounded to bf16
    here), valid ``[N]`` bool, ``1 <= k <= N``.  Returns (scores [Q, k] f32
    descending, ids [Q, k] int32); equal scores lower row first; slots past
    the valid rows hold ``-inf``.  CPU tensors take :func:`topk_scores_plain`;
    CUDA tensors launch ``csrc/knn_topk.cu`` or raise."""
    if index.device.type == "cpu":
        return topk_scores_plain(index, queries, valid, k)
    if index.device.type != "cuda":
        raise ValueError(f"topk_scores: unsupported device {index.device}")
    if index.dim() != 2 or index.dtype != torch.bfloat16 or not index.is_contiguous():
        raise ValueError("topk_scores: index must be a contiguous [N, D] bf16 tensor")
    N, D = index.shape
    if D % 8 or index.data_ptr() % 16:
        raise ValueError("topk_scores: rows must be a multiple of 8 wide and 16-byte aligned")
    if queries.dim() != 2 or queries.shape[1] != D:
        raise ValueError(f"topk_scores: queries must be [Q, {D}]")
    if valid.shape != (N,) or valid.dtype != torch.bool:
        raise ValueError(f"topk_scores: valid must be a [{N}] bool tensor")
    if any(t.device != index.device for t in (queries, valid)):
        raise ValueError("topk_scores: index, queries and valid must share a device")
    if not 1 <= k <= N:
        raise ValueError(f"topk_scores: k={k} must be within [1, {N}]")
    q = queries.to(torch.bfloat16).contiguous()
    valid = valid.contiguous()
    Q = q.shape[0]
    G = -(-N // GROUP)
    cap = min(N, min(k, G) * GROUP)
    scores = torch.empty((Q, k), dtype=torch.float32, device=index.device)
    ids = torch.empty((Q, k), dtype=torch.int32, device=index.device)
    scratch = torch.empty(Q * G + 3 * Q, dtype=torch.int32, device=index.device)
    cand = torch.empty(Q * cap, dtype=torch.int64, device=index.device)
    win, kpad = None, 0
    if k > kernels.KNN_SORT_CAP:
        kpad = _next_cap(kernels.KNN_SORT_CAP, k)
        win = torch.empty(2 * Q * kpad, dtype=torch.int64, device=index.device)
    kernels.knn_topk(index, q, valid, scores, ids, scratch, cand, k, cap, win, kpad)
    return scores, ids


def _normalize(x: np.ndarray) -> np.ndarray:
    norms = np.linalg.norm(x, axis=-1, keepdims=True)
    return x / np.maximum(norms, 1e-12)


def _normalize_rows_dev(x: torch.Tensor) -> torch.Tensor:
    """Row-normalise on the device: f32 statistics, bf16 out."""
    xf = x.float()
    norms = torch.sqrt((xf * xf).sum(dim=-1, keepdim=True)).clamp_min(1e-12)
    return (xf / norms).to(torch.bfloat16)


def _append_rows(index, valid, fresh, fresh_valid, start) -> None:
    """Write a padded row bucket at ``start`` (a device tensor), in place.
    Rows are rounded to bf16 before they are normalised, as on every route;
    zero pad rows normalise to zero rows and land under ``fresh_valid``
    false."""
    rows = start + torch.arange(fresh.shape[0], device=index.device)
    index.index_copy_(0, rows, _normalize_rows_dev(fresh.to(torch.bfloat16)))
    valid.index_copy_(0, rows, fresh_valid)


def _grow_dev(index, valid, new_cap: int):
    big = torch.zeros((new_cap, index.shape[1]), dtype=index.dtype, device=index.device)
    big[: index.shape[0]] = index
    big_valid = torch.zeros((new_cap,), dtype=torch.bool, device=index.device)
    big_valid[: valid.shape[0]] = valid
    return big, big_valid


class VectorIndex:
    """Append/compact exact-KNN index over (id, vector) pairs.

    Thread-safe; the device copy is kept incrementally: pure appends write
    padded row buckets in place (from host vectors, or from device rows via
    :meth:`add_device`), while overwrites and removes re-stage the whole
    corpus.  Scores are cosine similarities: rows are normalised on the
    device when staged (host rows stay raw), queries on the host."""

    def __init__(self, dim: int, mesh=None, device: DeviceLike = "cuda"):
        if mesh is not None:
            raise NotImplementedError(
                "a sharded VectorIndex (mesh=) waits for ROADMAP Queue 1 item 15 (parallelism)"
            )
        self.dim = dim
        self.device = resolve_device(device)
        self._lock = threading.Lock()
        self._ids: list[int] = []
        self._id_pos: dict[int, int] = {}
        self._mat = np.empty((0, dim), np.float32)  # raw host rows, capacity doubling
        self._n = 0
        self._device_index: Optional[torch.Tensor] = None
        self._device_valid: Optional[torch.Tensor] = None
        self._device_count = 0  # rows materialised on the device
        self._snapshot_ids: list[int] = []
        self._dirty_full = True
        # device-born rows whose host copy is not fetched yet: [(start,
        # rows)], fetched lazily but bounded, so a long ingestion cannot hold
        # a second corpus copy on the card
        self._pending_host: list[tuple[int, torch.Tensor]] = []
        self._pending_bytes = 0
        self.pending_host_limit = 256 << 20

    def __len__(self) -> int:
        return self._n

    # ------------------------------------------------------------------ mutation
    def _grow_host(self, need: int) -> None:
        cap = _next_cap(max(1024, self._mat.shape[0]), need)
        if cap != self._mat.shape[0]:
            new = np.empty((cap, self.dim), np.float32)
            new[: self._n] = self._mat[: self._n]
            self._mat = new

    def _join_pending_host(self) -> None:
        """Materialise the host copies of device-born rows (one fetch)."""
        if not self._pending_host:
            return
        fetched = torch.cat([rows.float() for _, rows in self._pending_host]).cpu().numpy()
        at = 0
        for start, rows in self._pending_host:
            m = rows.shape[0]
            self._mat[start : start + m] = fetched[at : at + m]
            at += m
        self._pending_host = []
        self._pending_bytes = 0

    def add(self, ids: Sequence[int], vectors: np.ndarray) -> None:
        # rows are stored raw; normalisation happens on the device at staging
        vectors = np.asarray(vectors, np.float32).reshape(-1, self.dim)
        ids = [int(i) for i in ids]
        with self._lock:
            if len(set(ids)) == len(ids) and not any(i in self._id_pos for i in ids):
                m = len(ids)  # bulk append: one slice copy
                self._grow_host(self._n + m)
                self._mat[self._n : self._n + m] = vectors
                for j, i in enumerate(ids):
                    self._id_pos[i] = self._n + j
                self._ids.extend(ids)
                self._n += m
                return
            self._join_pending_host()
            for i, vec in zip(ids, vectors):
                pos = self._id_pos.get(i)
                if pos is None:
                    self._grow_host(self._n + 1)
                    self._mat[self._n] = vec
                    self._id_pos[i] = self._n
                    self._ids.append(i)
                    self._n += 1
                else:
                    self._mat[pos] = vec
                    self._dirty_full = True  # in-place overwrite: re-stage

    def add_device(self, ids: Sequence[int], rows) -> None:
        """Append rows that already live on the device (e.g. encoder output):
        a bucketed write on the device, no host transfer; the host copy is
        fetched lazily.  Falls back to :meth:`add` when ids collide or the
        device copy is stale."""
        ids = [int(i) for i in ids]
        rows = torch.as_tensor(rows, device=self.device)
        if rows.dim() != 2 or rows.shape[1] != self.dim:
            rows = rows.reshape(-1, self.dim)
        if rows.shape[0] != len(ids):
            raise ValueError(f"add_device: {len(ids)} ids for {rows.shape[0]} rows")
        with self._lock:
            fresh_ok = len(set(ids)) == len(ids) and not any(i in self._id_pos for i in ids)
            if fresh_ok and self._n == 0 and self._device_index is None:
                self._stage_full(0)  # cold start: an empty staged buffer, no transfer
                self._dirty_full = False
            if (fresh_ok and not self._dirty_full and self._device_index is not None
                    and self._device_count == self._n):
                m = len(ids)
                start = self._n
                self._write_bucketed(start, rows, m)
                self._grow_host(start + m)  # host rows reserved; filled lazily
                self._pending_host.append((start, rows[:m]))
                self._pending_bytes += rows[:m].numel() * rows.element_size()
                if self._pending_bytes > self.pending_host_limit:
                    self._join_pending_host()  # bound the card memory held by raw rows
                for j, i in enumerate(ids):
                    self._id_pos[i] = start + j
                self._ids.extend(ids)
                self._n = start + m
                self._device_count = start + m
                self._snapshot_ids = list(self._ids)
                return
        self.add(ids, rows.float().cpu().numpy())

    def _write_bucketed(self, start: int, rows: torch.Tensor, m: int) -> None:
        """Write ``m`` device rows at ``start``, padded to an append bucket;
        the whole padded bucket must fit the capacity, which grows by
        power-of-two multiples until it does.  Caller holds ``_lock``."""
        bkt = _bucket(m, _APPEND_BUCKETS)
        if start + bkt > self._capacity():
            self._device_index, self._device_valid = _grow_dev(
                self._device_index, self._device_valid,
                _next_cap(max(self._capacity(), 1), start + bkt),
            )
        if bkt != m:
            pad = torch.zeros((bkt - m, self.dim), dtype=rows.dtype, device=rows.device)
            rows = torch.cat([rows, pad])
        fresh_valid = torch.zeros((bkt,), dtype=torch.bool, device=self.device)
        fresh_valid[:m] = True
        start_dev = torch.tensor(start, dtype=torch.int64).to(self.device, non_blocking=True)
        _append_rows(self._device_index, self._device_valid, rows, fresh_valid, start_dev)

    def reserve(self, n: int) -> None:
        """Pre-grow the device capacity for a known ingestion size."""
        with self._lock:
            if self._dirty_full or self._device_index is None:
                self._stage_full(self._n)
                self._dirty_full = False
            cap = self._capacity()
            if n <= cap:
                return
            new_cap = _next_cap(cap, n)
            self._device_index, self._device_valid = _grow_dev(
                self._device_index, self._device_valid, new_cap
            )
            self._grow_host(new_cap)

    def remove(self, ids: Sequence[int]) -> None:
        with self._lock:
            drop = {int(i) for i in ids} & set(self._id_pos)
            if not drop:
                return
            self._join_pending_host()
            keep_mask = np.fromiter((i not in drop for i in self._ids), bool, self._n)
            kept = self._mat[: self._n][keep_mask]
            self._mat[: kept.shape[0]] = kept
            self._ids = [i for i in self._ids if i not in drop]
            self._id_pos = {i: p for p, i in enumerate(self._ids)}
            self._n = len(self._ids)
            self._dirty_full = True

    def clear(self) -> None:
        with self._lock:
            self._ids, self._id_pos = [], {}
            self._mat = np.empty((0, self.dim), np.float32)
            self._n = 0
            self._device_index = self._device_valid = None
            self._device_count = 0
            self._pending_host = []
            self._pending_bytes = 0
            self._dirty_full = True

    # ------------------------------------------------------------------- search
    def _capacity(self) -> int:
        return 0 if self._device_index is None else self._device_index.shape[0]

    def _stage_full(self, n: int) -> None:
        """Re-stage the whole corpus, padded to the next power-of-two multiple
        of 128 rows; the host-to-device copy goes out as bf16."""
        self._join_pending_host()
        n_pad = _next_cap(_ROW_MULTIPLE, n)
        mat = torch.zeros((n_pad, self.dim), dtype=torch.bfloat16)
        if n:
            mat[:n] = torch.from_numpy(self._mat[:n]).to(torch.bfloat16)
        valid = torch.zeros((n_pad,), dtype=torch.bool)
        valid[:n] = True
        self._device_index = _normalize_rows_dev(mat.to(self.device))
        self._device_valid = valid.to(self.device)
        self._device_count = n
        self._snapshot_ids = list(self._ids)

    def _ensure_device(self, allowed_ids: Optional[set] = None):
        """(device matrix, valid mask, ids snapshot, allowed-positions mask or
        None), the snapshot and the mask taken under the lock that built the
        device copy, so a concurrent remove or add cannot shift the
        position -> id mapping of an in-flight search."""
        with self._lock:
            n = self._n
            if self._dirty_full or self._device_index is None:
                self._stage_full(n)
                self._dirty_full = False
            elif n > self._device_count:
                # host-added rows: a bucketed device write of the new rows
                start = self._device_count
                fresh = torch.from_numpy(self._mat[start:n]).to(torch.bfloat16).to(self.device)
                self._write_bucketed(start, fresh, n - start)
                self._device_count = n
                self._snapshot_ids = list(self._ids)
            allowed_mask = None
            if allowed_ids is not None:
                allowed_mask = np.zeros((self._capacity(),), bool)
                for i in allowed_ids:
                    pos = self._id_pos.get(int(i))
                    if pos is not None and pos < allowed_mask.shape[0]:
                        allowed_mask[pos] = True
            return self._device_index, self._device_valid, self._snapshot_ids, allowed_mask

    def warmup(self, ks: Sequence[int] = _K_BUCKETS, q_rows: Sequence[int] = (8,)):
        """Stage the corpus and run the search for the common (query rows, k)
        buckets, blocking until the results are on the host.  Nothing is
        compiled per shape; on the card the first call builds the kernel."""
        if not self._n:
            return self
        index, valid, ids, _ = self._ensure_device()
        q = torch.zeros((1, self.dim), dtype=torch.float32)
        q[0, 0] = 1.0
        seen: set = set()
        for qr in q_rows:
            qb = _bucket(qr, _QUERY_BUCKETS)
            for k in ks:
                kb = min(_bucket(min(k, len(ids)), _K_BUCKETS), index.shape[0])
                if (qb, kb) in seen:
                    continue
                seen.add((qb, kb))
                scores, _ = topk_scores(index, q.repeat(qb, 1).to(self.device), valid, kb)
                scores.cpu()
        return self

    def search(
        self, query: np.ndarray, k: int = 10, allowed_ids: Optional[set] = None
    ) -> list[tuple[int, float]]:
        """Top-k (id, cosine similarity) for one query vector."""
        return self.search_batch(
            np.asarray(query, np.float32)[None, :], k, allowed_ids=allowed_ids
        )[0]

    def search_batch(
        self, queries: np.ndarray, k: int = 10, allowed_ids: Optional[set] = None
    ) -> list[list[tuple[int, float]]]:
        """Batched top-k.  ``allowed_ids`` restricts the candidates to that
        subset by masking their row positions (the mask is the score's
        validity input)."""
        index, valid, ids, allowed_mask = self._ensure_device(allowed_ids)
        if not ids:
            return [[] for _ in range(len(queries))]
        n_live = len(ids)
        if allowed_mask is not None:
            hits = int(allowed_mask.sum())
            if not hits:
                return [[] for _ in range(len(queries))]
            valid = torch.from_numpy(allowed_mask).to(self.device)
            n_live = hits
        k_eff = min(k, n_live)
        kb = min(_bucket(k_eff, _K_BUCKETS), index.shape[0])
        q = _normalize(np.asarray(queries, np.float32).reshape(-1, self.dim))
        q_pad = _bucket(q.shape[0], _QUERY_BUCKETS)
        if q_pad != q.shape[0]:
            q = np.concatenate([q, np.zeros((q_pad - q.shape[0], self.dim), np.float32)])
        scores, idx = topk_scores(index, torch.from_numpy(q).to(self.device), valid, kb)
        # one device -> host copy for both outputs (the ids ride as f32 bits)
        packed = torch.cat([scores, idx.view(torch.float32)], dim=1).cpu()
        scores = packed[:, :kb].numpy()
        idx = packed[:, kb:].contiguous().view(torch.int32).numpy()
        out_rows = []
        for qi in range(len(queries)):
            row = []
            for j in range(k_eff):
                p = int(idx[qi, j])
                if p < len(ids) and np.isfinite(scores[qi, j]):
                    row.append((ids[p], float(scores[qi, j])))
            out_rows.append(row)
        return out_rows

    # ----------------------------------------------------------------- loading
    @classmethod
    def from_model(cls, model_cls, field: str = "embedding", mesh=None, **filter_kw):
        raise NotImplementedError(
            "VectorIndex.from_model needs the ORM, which waits for ROADMAP Queue 1 item 16"
        )


class AsyncSearcher:
    """Coalesce concurrent async searches into one batched search.

    Concurrent RAG requests each need a search; one batched ``[Q, D]``
    search costs about what one search costs, so searches that arrive within
    ``window_s`` of each other (up to ``max_batch``) go to the device
    together, each caller getting its own ``k``.  Allow-listed searches
    bypass coalescing: their position masks are per-query state."""

    def __init__(self, index: VectorIndex, window_s: float = 0.002, max_batch: int = 32):
        self.index = index
        self.window_s = window_s
        self.max_batch = max_batch
        self._pending: list = []  # [(vector, k, asyncio.Future)]
        self._flusher = None
        self._runs: set = set()  # batched searches in flight (the loop holds tasks weakly)

    async def search(
        self, query: np.ndarray, k: int = 10, allowed_ids: Optional[set] = None
    ) -> list[tuple[int, float]]:
        import asyncio

        if allowed_ids is not None:
            return await asyncio.to_thread(self.index.search, query, k, allowed_ids=allowed_ids)
        loop = asyncio.get_running_loop()
        fut = loop.create_future()
        self._pending.append((np.asarray(query, np.float32), int(k), fut))
        if self._flusher is None or self._flusher.done():
            self._flusher = loop.create_task(self._flush_soon())
        if len(self._pending) >= self.max_batch:
            self._flush_now()
        return await fut

    async def _flush_soon(self):
        import asyncio

        await asyncio.sleep(self.window_s)
        self._flush_now()

    def _flush_now(self):
        import asyncio

        batch, self._pending = self._pending, []
        if not batch:
            return
        vecs = np.stack([v for v, _, _ in batch])
        k_max = max(k for _, k, _ in batch)
        loop = asyncio.get_running_loop()

        # asyncio futures, resolved on the event loop's thread with no lock
        # held (the index's lock lives inside search_batch's worker thread)
        async def run():
            try:
                rows = await asyncio.to_thread(self.index.search_batch, vecs, k_max)
            except Exception as e:
                for _, _, fut in batch:
                    if not fut.done():
                        fut.set_exception(e)
                return
            for (_, k, fut), hits in zip(batch, rows):
                if not fut.done():
                    fut.set_result(hits[:k])

        task = loop.create_task(run())
        self._runs.add(task)
        task.add_done_callback(self._runs.discard)
