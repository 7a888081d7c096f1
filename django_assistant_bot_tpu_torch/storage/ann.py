"""IVF-PQ approximate KNN on the card (port of ``storage/ann.py``).

The exact plane (:mod:`.knn`) reads every row of the corpus for every query:
right up to a few million rows, wrong-shaped past them.  This module is the
JAX package's IVF-PQ design, on tensors on the index's device:

- **Training** (host-driven, off the hot path): spherical mini-batch k-means
  for the ``nlist`` coarse centroids (assignment by max dot) and per-subspace
  PQ codebooks (``m`` subquantizers x 256 codes, Euclidean k-means over
  residuals ``x - centroid[list]``), one step function per seeded minibatch
  with the MiniBatchKMeans learning rate.
- **Storage**: uint8 PQ codes packed per IVF list in fixed-capacity device
  blocks ``[nlist, list_cap, m]`` with a validity mask and a row-position
  map.  Appends stage on the host and flush as one scatter per batch; the
  padding entries the JAX function sends to the out-of-range list ``nlist``
  (which its ``mode='drop'`` scatter discards) are filtered out before the
  scatter here, since ``index_put_`` has no drop mode and a clamp would
  overwrite the last list.  Scatters write in place, in the order codes,
  row positions, validity, so a concurrent search that sees a slot valid
  sees its code and row.  List capacity grows by doubling.
- **Query**: ADC.  Per query: score the ``nlist`` centroids, take the
  ``nprobe`` best, build a ``[m, 256]`` dot LUT, sum the LUT entries of every
  probed slot's codes (:func:`adc_shortlist`), take a top-``shortlist``, then
  rerank the shortlist with exact bf16 dots against the row tier and cut to
  the final k (:func:`rerank`).
- **Liveness**: ``add`` assigns and packs without retraining; ``remove``
  tombstones and compacts past a dead fraction; a drift gauge advises
  retraining; ``probe_recall`` measures recall@k against the exact tier.

:func:`adc_shortlist` and :func:`rerank` are the JAX package's two hand-
written loops (``_adc_body`` / ``_adc_shortlist_impl`` and ``_rerank_impl``).
On a CUDA tensor they launch ``csrc/ann_adc.cu`` and ``csrc/ann_rerank.cu``
(through :mod:`..kernels`); on a CPU tensor they run their plain twins
:func:`adc_shortlist_plain` and :func:`rerank_plain`.  Both break ties as
``lax.top_k`` does (the lower flat index first; the flat index is
probe-major, slot-minor), and the ADC sum adds the ``m`` LUT terms one by
one from 0 before ``q . c_list``, the JAX loop's order, so the kernel's
scores equal the twin's bit for bit.

Untrained indexes and allow-listed searches run the exact kernel over the
rerank tier (:func:`.knn.topk_scores`, ``csrc/knn_topk.cu`` on the card).
A sharded index (``mesh``) waits for ROADMAP Queue 1 item 15 and
:meth:`ANNIndex.from_model` (the ORM) for item 16.
"""

from __future__ import annotations

import math
import threading
import time
from typing import Optional, Sequence

import numpy as np
import torch

from .. import kernels
from ..device import DeviceLike, resolve_device
from ..ops.sampling import top_k_auto
from .knn import (
    _APPEND_BUCKETS,
    _K_BUCKETS,
    _QUERY_BUCKETS,
    _append_rows,
    _bucket,
    _grow_dev,
    _next_cap,
    _normalize,
    topk_scores,
)


_CODES = 256  # codes per subquantizer: one uint8
_TRAIN_SAMPLE = 65_536
_TRAIN_BATCH = 4_096
_ENCODE_BATCH = 65_536
_ENCODE_CHUNK = 8_192  # rows per [rows, m, 256] f32 distance block on the device
_DEF_RERANK = 256
_DEAD_COMPACT_FRAC = 0.25
_DRIFT_ADVISE_FRAC = 0.20
# the longest shortlist the kernels take (MAX_S in csrc/ann_adc.cu and
# csrc/ann_rerank.cu)
MAX_SHORTLIST = 2048


def make_clustered(n: int, dim: int, n_clusters: int = 64, seed: int = 0) -> np.ndarray:
    """Seeded synthetic clustered corpus (the IVF-friendly geometry real
    embedding corpora have); the JAX package's generator, draw for draw, so
    recall numbers line up across both packages."""
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((n_clusters, dim)).astype(np.float32)
    assign = rng.integers(0, n_clusters, size=n)
    rows = centers[assign] + 0.25 * rng.standard_normal((n, dim)).astype(np.float32)
    return rows.astype(np.float32)


# ------------------------------------------------------------------- training
def _kmeans_step(centroids, counts, batch):
    """One spherical mini-batch k-means step (centroids stay row-normalized).

    counts carry across steps so the per-center learning rate decays like
    MiniBatchKMeans; centers a batch never hits keep their old value."""
    C = centroids.shape[0]
    assign = torch.argmax(batch @ centroids.T, dim=1)  # the first max, as jnp.argmax
    n_b = torch.bincount(assign, minlength=C).float()
    sum_b = torch.zeros_like(centroids).index_add_(0, assign, batch)
    new_counts = counts + n_b
    eta = torch.where(new_counts > 0, n_b / new_counts.clamp_min(1.0), 0.0)[:, None]
    batch_mean = sum_b / n_b.clamp_min(1.0)[:, None]
    mixed = centroids * (1.0 - eta) + torch.where(n_b[:, None] > 0, batch_mean, centroids) * eta
    norm = torch.linalg.vector_norm(mixed, dim=1, keepdim=True)
    return mixed / norm.clamp_min(1e-12), new_counts


def _pq_codes(codebooks, batch):
    """Nearest code per subspace: argmin of ``|c|^2 - 2 r.c`` (``|r|^2`` is
    constant per row), batch ``[B, m, sub]`` -> ``[B, m]`` int64."""
    c2 = (codebooks * codebooks).sum(dim=-1)  # [m, 256]
    rc = torch.einsum("bms,mcs->bmc", batch, codebooks)  # [B, m, 256]
    return torch.argmin(c2[None] - 2.0 * rc, dim=-1)


def _pq_step(codebooks, counts, batch):
    """One mini-batch k-means step per PQ subspace, all m subspaces at once.
    batch is residuals ``[B, m, sub]``."""
    m, C, sub = codebooks.shape
    flat = (_pq_codes(codebooks, batch) + C * torch.arange(m, device=batch.device)).reshape(-1)
    n_b = torch.bincount(flat, minlength=m * C).float().reshape(m, C)
    sum_b = torch.zeros((m * C, sub), dtype=batch.dtype, device=batch.device).index_add_(
        0, flat, batch.reshape(-1, sub)).reshape(m, C, sub)
    new_counts = counts + n_b
    eta = torch.where(new_counts > 0, n_b / new_counts.clamp_min(1.0), 0.0)[..., None]
    batch_mean = sum_b / n_b.clamp_min(1.0)[..., None]
    upd = torch.where(n_b[..., None] > 0, batch_mean, codebooks)
    return codebooks * (1.0 - eta) + upd * eta, new_counts


def _assign(centroids, rows):
    """Two nearest lists per row: ``[B, D]`` -> ``[B, 2]`` int32, as
    ``lax.top_k(sims, 2)``: the first max, then the first max of the rest.
    The runner-up is the spill target when the nearest list is full."""
    sims = rows @ centroids.T
    first = torch.argmax(sims, dim=1)
    sims.scatter_(1, first[:, None], float("-inf"))
    second = torch.argmax(sims, dim=1)
    return torch.stack([first, second], dim=1).to(torch.int32)


def _encode_assigned(centroids, codebooks, rows, lists):
    """PQ-encode residuals against the list each row actually LIVES in
    (which may be its spill list): the score at query time is ``q.c_list +
    q.residual``.  In chunks of ``_ENCODE_CHUNK`` rows (each row's codes are
    its own, so the chunking changes no bit).  Returns ``[B, m]`` uint8."""
    b = rows.shape[0]
    m, _, sub = codebooks.shape
    out = torch.empty((b, m), dtype=torch.uint8, device=rows.device)
    for s in range(0, b, _ENCODE_CHUNK):
        e = min(b, s + _ENCODE_CHUNK)
        resid = rows[s:e] - centroids[lists[s:e].long()]
        out[s:e] = _pq_codes(codebooks, resid.reshape(e - s, m, sub)).to(torch.uint8)
    return out


# -------------------------------------------------------------------- storage
def _scatter_codes(codes, lvalid, rowpos, li, si, c, pos) -> None:
    """Pack an append batch into its list slots, in place.  Entries with
    ``li == nlist`` are the JAX function's padding, which its ``mode='drop'``
    discards: they are filtered out here (an index_put_ would raise on them,
    and a clamp would overwrite the last list's slots).  Codes and row
    positions land before validity."""
    keep = li < codes.shape[0]
    li, si = li[keep].long(), si[keep].long()
    codes[li, si] = c[keep]
    rowpos[li, si] = pos[keep]
    lvalid[li, si] = True


def _tombstone(lvalid, li, si) -> None:
    keep = li < lvalid.shape[0]
    lvalid[li[keep].long(), si[keep].long()] = False


def _mask_positions(rvalid, pos) -> None:
    keep = pos < rvalid.shape[0]
    rvalid[pos[keep].long()] = False


def _grow_lists(codes, lvalid, rowpos, new_cap: int):
    nlist, cap, m = codes.shape
    g_codes = torch.zeros((nlist, new_cap, m), dtype=codes.dtype, device=codes.device)
    g_valid = torch.zeros((nlist, new_cap), dtype=lvalid.dtype, device=lvalid.device)
    g_pos = torch.zeros((nlist, new_cap), dtype=rowpos.dtype, device=rowpos.device)
    g_codes[:, :cap] = codes
    g_valid[:, :cap] = lvalid
    g_pos[:, :cap] = rowpos
    return g_codes, g_valid, g_pos


# ---------------------------------------------------------------------- query
def _top_stable(x: torch.Tensor, k: int):
    """``lax.top_k`` over the last axis: descending, equal values the lower
    index first."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def adc_shortlist_plain(codes, lvalid, rowpos, top_ci, top_c, lut, shortlist: int):
    """The ADC scan and shortlist in plain PyTorch, as ``_adc_shortlist_impl``
    computes it after its centroid scores and LUT: for every slot of every
    probed list (``top_ci`` ``[Q, P]``), ``top_c[q, p] + sum_j lut[q, j,
    code_j]`` (the m terms added one by one from 0, then ``top_c``), ``-inf``
    where ``lvalid`` is false; then the top ``shortlist`` over the flat
    probe-major, slot-minor index, equal scores the lower index first.
    Returns (scores ``[Q, shortlist]`` f32, row positions ``[Q, shortlist]``
    int32)."""
    Q, P = top_ci.shape
    _, L, m = codes.shape
    ci = top_ci.long()
    pc = codes[ci].reshape(Q, P * L, m)
    acc = torch.zeros((Q, P * L), dtype=torch.float32, device=codes.device)
    for j in range(m):
        acc = acc + torch.gather(lut[:, j, :], 1, pc[:, :, j].long())
    scores = top_c.repeat_interleave(L, dim=1) + acc
    scores = torch.where(lvalid[ci].reshape(Q, -1), scores, float("-inf"))
    vals, idx = _top_stable(scores, shortlist)
    return vals, torch.gather(rowpos[ci].reshape(Q, -1), 1, idx).to(torch.int32)


def adc_shortlist(codes, lvalid, rowpos, top_ci, top_c, lut, shortlist: int, fill=None,
                  mean_fill: Optional[int] = None):
    """The ADC scan and top-``shortlist`` of :func:`adc_shortlist_plain`:
    codes ``[nlist, L, m]`` uint8, lvalid ``[nlist, L]`` bool, rowpos
    ``[nlist, L]`` int32, top_ci ``[Q, P]`` int32, top_c ``[Q, P]`` f32, lut
    ``[Q, m, 256]`` f32, ``1 <= shortlist <= P L``.  CPU tensors take the
    plain twin (``fill`` unused); CUDA tensors launch ``csrc/ann_adc.cu``
    (bit-equal scores, the same positions) or raise.  On the card ``fill``
    ``[nlist]`` int32 and ``mean_fill`` are required together: each list's
    high-water mark (``lvalid`` false at and past it), so the kernel scans
    only ``[0, fill)`` of each probed list, and its mean rounded up, from
    the host, which sizes the grid (:func:`..kernels.ann_adc_plan`)."""
    if codes.device.type == "cpu":
        return adc_shortlist_plain(codes, lvalid, rowpos, top_ci, top_c, lut, shortlist)
    if codes.device.type != "cuda":
        raise ValueError(f"adc_shortlist: unsupported device {codes.device}")
    nlist, L, m = codes.shape
    Q, P = top_ci.shape
    if codes.dtype != torch.uint8 or lvalid.dtype != torch.bool or rowpos.dtype != torch.int32:
        raise ValueError("adc_shortlist: codes uint8, lvalid bool, rowpos int32 expected")
    if lvalid.shape != (nlist, L) or rowpos.shape != (nlist, L):
        raise ValueError(f"adc_shortlist: lvalid and rowpos must be [{nlist}, {L}]")
    if (fill is None or mean_fill is None or fill.shape != (nlist,)
            or fill.dtype != torch.int32):
        raise ValueError(f"adc_shortlist: the lists' fill [{nlist}] int32 and its mean are "
                         "required on the card")
    if top_ci.dtype != torch.int32 or top_c.shape != (Q, P) or lut.shape != (Q, m, _CODES):
        raise ValueError("adc_shortlist: top_ci [Q, P] int32, top_c [Q, P], lut [Q, m, 256]")
    if not 1 <= shortlist <= min(P * L, MAX_SHORTLIST) or P * L >= 2 ** 31 - 32:
        raise ValueError(f"adc_shortlist: shortlist {shortlist} outside [1, "
                         f"{min(P * L, MAX_SHORTLIST)}]")
    if any(t.device != codes.device for t in (lvalid, rowpos, fill, top_ci, top_c, lut)):
        raise ValueError("adc_shortlist: all tensors must share a device")
    args = [t.contiguous() for t in (codes, lvalid, rowpos, fill)]
    # a top-k's slices and an einsum's LUT ([m, Q, 256] in memory) are read
    # in place, through their strides
    top_ci, top_c = (t if t.stride(1) == 1 and (Q == 1 or t.stride(0) >= P) else t.contiguous()
                     for t in (top_ci, top_c.float()))
    lut = lut.float()
    if (lut.stride(2) != 1 or lut.stride(1) % 4 or (m > 1 and lut.stride(1) < _CODES)
            or (Q > 1 and lut.stride(0) % 4) or lut.data_ptr() % 16):
        lut = lut.contiguous()
    dev = codes.device
    scores = torch.empty((Q, shortlist), dtype=torch.float32, device=dev)
    pos = torch.empty((Q, shortlist), dtype=torch.int32, device=dev)
    kernels.ann_adc(*args, top_ci, top_c, lut, scores, pos, shortlist, mean_fill)
    return scores, pos


def rerank_plain(tier, rvalid, q, sl_scores, sl_pos, k: int):
    """``_rerank_impl`` in plain PyTorch: gather the shortlist's rows of the
    bf16 tier (positions clipped to the tier), score them with the
    bf16-rounded query (bf16 products summed in f32), ``-inf`` where the
    shortlist score is not finite or the row is not valid, then the top k,
    equal scores the lower shortlist index first.  Returns (scores ``[Q,
    k]`` f32, row positions ``[Q, k]`` int32)."""
    pos = sl_pos.long().clamp(0, tier.shape[0] - 1)
    exact = torch.einsum("qd,qsd->qs", q.to(torch.bfloat16).float(), tier[pos].float())
    ok = torch.isfinite(sl_scores) & rvalid[pos]
    exact = torch.where(ok, exact, float("-inf"))
    vals, idx = _top_stable(exact, k)
    return vals, torch.gather(sl_pos, 1, idx).to(torch.int32)


def rerank(tier, rvalid, q, sl_scores, sl_pos, k: int):
    """The exact rerank of :func:`rerank_plain`: tier ``[N, D]`` bf16, rvalid
    ``[N]`` bool, q ``[Q, D]`` f32, sl_scores ``[Q, S]`` f32, sl_pos ``[Q,
    S]`` int32, ``1 <= k <= S``.  CPU tensors take the plain twin; CUDA
    tensors launch ``csrc/ann_rerank.cu`` (scores within
    ``knn_check.topk_score_bound`` of the twin's: another summation order)
    or raise."""
    if tier.device.type == "cpu":
        return rerank_plain(tier, rvalid, q, sl_scores, sl_pos, k)
    if tier.device.type != "cuda":
        raise ValueError(f"rerank: unsupported device {tier.device}")
    N, D = tier.shape
    Q, S = sl_pos.shape
    if tier.dtype != torch.bfloat16 or rvalid.shape != (N,) or rvalid.dtype != torch.bool:
        raise ValueError("rerank: tier [N, D] bf16 and rvalid [N] bool expected")
    if q.shape != (Q, D) or sl_scores.shape != (Q, S) or sl_pos.dtype != torch.int32:
        raise ValueError(f"rerank: q [{Q}, {D}], sl_scores [{Q}, {S}] and int32 sl_pos expected")
    if not 1 <= k <= S or S > MAX_SHORTLIST:
        raise ValueError(f"rerank: k={k} outside [1, {S}] or shortlist {S} past {MAX_SHORTLIST}")
    if any(t.device != tier.device for t in (rvalid, q, sl_scores, sl_pos)):
        raise ValueError("rerank: all tensors must share a device")
    dev = tier.device
    scores = torch.empty((Q, k), dtype=torch.float32, device=dev)
    pos = torch.empty((Q, k), dtype=torch.int32, device=dev)
    kernels.ann_rerank(tier.contiguous(), rvalid.contiguous(), q.float().contiguous(),
                       sl_scores.float().contiguous(), sl_pos.contiguous(), scores, pos, k)
    return scores, pos


def _adc_shortlist(centroids, codebooks, codes, lvalid, rowpos, q, nprobe: int, shortlist: int,
                   fill=None, mean_fill: Optional[int] = None):
    """Scan the nprobe nearest lists' codes and return a top-``shortlist`` of
    (approximate score, row position) per query.  The centroid scores and
    the LUT are products outside the scan, as in the JAX function; ``fill``
    and ``mean_fill`` as :func:`adc_shortlist` takes them."""
    q_n = q.shape[0]
    _, _, m = codes.shape
    sub = codebooks.shape[2]
    csim = q @ centroids.T  # [Q, nlist]
    top_c, top_ci = top_k_auto(csim, nprobe)  # [Q, P]
    lut = torch.einsum("qms,mcs->qmc", q.reshape(q_n, m, sub), codebooks)  # [Q, m, 256]
    return adc_shortlist(codes, lvalid, rowpos, top_ci, top_c, lut, shortlist, fill, mean_fill)


def _spill_assign(lists2: np.ndarray, fill: np.ndarray, cap: int) -> np.ndarray:
    """Capacity-respecting list assignment (host-side, vectorized).

    Rows go to their nearest list until it reaches the soft cap; overflow rows
    go to their runner-up if it has room, else stay (the cap is soft — the
    block capacity just grows).  Bounds the dense-block scan cost at
    ``nprobe * O(avg fill)`` instead of ``nprobe * max fill``: unbalanced
    k-means lists otherwise make every probe pay for the biggest list.
    Mutates ``fill`` to the resulting per-list occupancy.
    """
    n = lists2.shape[0]
    l1 = lists2[:, 0].astype(np.int64)
    l2 = lists2[:, 1].astype(np.int64)
    out = l1.astype(np.int32).copy()
    counts = np.bincount(l1, minlength=fill.shape[0])
    cum = np.concatenate([[0], np.cumsum(counts)])
    order = np.argsort(l1, kind="stable")
    rank = np.empty((n,), np.int64)
    rank[order] = np.arange(n) - cum[l1[order]]
    overflow = rank + fill[l1] >= cap
    ov = np.nonzero(overflow)[0]
    np.add.at(fill, out[~overflow], 1)
    # exact greedy over the overflow tail only (a small fraction of n): rows
    # whose runner-up is ALSO full stay in their nearest list past the cap —
    # the cap is soft and the block capacity grows to cover them
    for j in ov:
        t = int(l2[j])
        if fill[t] >= cap:
            t = int(l1[j])
        out[j] = t
        fill[t] += 1
    return out


def _auto_m(dim: int) -> int:
    """Largest reasonable subquantizer count: prefer ~8-d subspaces, fall back
    to any divisor giving sub_dim >= 2."""
    for sub in (8, 12, 16, 4, 6, 24, 32, 2, 3):
        if dim % sub == 0 and dim // sub >= 1:
            return dim // sub
    return 1


def _auto_nlist(n: int, shards: int = 1) -> int:
    """~2*sqrt(n) lists, power-of-two-ish, multiple of the mesh shard count."""
    base = max(8, shards)
    return min(4096 * max(1, shards), _next_cap(base, max(8, int(2.0 * math.sqrt(max(1, n))))))


class ANNIndex:
    """IVF-PQ approximate index with the ``VectorIndex`` search surface.

    Thread-safe under the JAX index's single-lock discipline: mutators
    change the device state under ``_lock``; searches take the handles
    under the lock and compute outside it.  Restages build fresh tensors
    and swap them in; appends and tombstones scatter in place (see the
    module docstring for the order that keeps a concurrent search
    consistent).  ``device`` (default ``"cuda"``) holds every tensor.
    """

    def __init__(
        self,
        dim: int,
        mesh=None,
        nlist: int = 0,
        m: int = 0,
        nprobe: int = 0,
        rerank_depth: int = _DEF_RERANK,
        seed: int = 0,
        mat_alloc=None,
        device: DeviceLike = "cuda",
    ):
        if mesh is not None:
            raise NotImplementedError(
                "a sharded ANNIndex (mesh=) waits for ROADMAP Queue 1 item 15 (parallelism)"
            )
        self.device = resolve_device(device)
        self.dim = dim
        self.nlist = int(nlist)
        self.m = int(m) if m else _auto_m(dim)
        if dim % self.m:
            raise ValueError(f"m={self.m} must divide dim={dim}")
        self.sub_dim = dim // self.m
        self.nprobe = int(nprobe)
        self.rerank_depth = int(rerank_depth)
        self.seed = int(seed)
        self.drift_threshold = _DRIFT_ADVISE_FRAC
        self._lock = threading.Lock()
        # host f32 row tier allocator — the durability plane injects an
        # mmap-backed allocator here so corpora past host RAM page from disk
        self._mat_alloc = mat_alloc or (lambda shape: np.empty(shape, np.float32))
        self._ids: list[int] = []
        self._id_pos: dict[int, int] = {}
        self._mat = self._mat_alloc((0, dim))
        self._n = 0
        self._dead: set[int] = set()
        # device rerank tier (bf16 normalized rows + validity)
        self._rerank: Optional[torch.Tensor] = None
        self._rvalid: Optional[torch.Tensor] = None
        self._rerank_count = 0
        self._snapshot_ids: list[int] = []
        self._rerank_dirty = True
        # trained state
        self._trained = False
        self._centroids: Optional[torch.Tensor] = None
        self._codebooks: Optional[torch.Tensor] = None
        self._codes: Optional[torch.Tensor] = None
        self._lvalid: Optional[torch.Tensor] = None
        self._rowpos: Optional[torch.Tensor] = None
        # each list's high-water mark (slots ever handed out; tombstones do
        # not lower it) on the host, and its int32 copy on the device (the
        # ADC kernel's scan bound) and their mean, all set by _set_counts_locked
        self._set_counts_locked(np.zeros((0,), np.int64))
        self._row_list = np.empty((0,), np.int32)  # position -> IVF list (-1 = none)
        self._row_slot = np.empty((0,), np.int32)
        # drift gauge state: running sums of appended/encoded normalized rows
        self._list_sums = np.zeros((0, dim), np.float32)
        self._list_nums = np.zeros((0,), np.int64)
        self._drift_frac = 0.0
        self._drift_stale = 0
        # counters
        self.searches = 0
        self.compactions = 0
        self.retrains = 0
        self.appended_since_train = 0
        self.last_recall: Optional[dict] = None
        # wall seconds of the last (re)train's or compaction's stages
        self.last_restage: dict = {}

    def __len__(self) -> int:
        return self._n - len(self._dead)

    # ------------------------------------------------------------------ config
    def _dev(self, arr: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(arr)).to(self.device)

    def _set_counts_locked(self, counts: np.ndarray) -> None:
        """Adopt ``counts`` as the lists' high-water marks: the host array and
        the device fill (an H2D copy on the current stream, after whatever
        scatter came before it there).  A search that took the old fill
        keeps it: it misses only the slots appended after it started."""
        self._list_counts = counts
        self._fill = self._dev(counts.astype(np.int32))
        self._mean_fill = -(-int(counts.sum()) // max(1, counts.size))

    def _nprobe_eff(self, nprobe: Optional[int] = None) -> int:
        p = int(nprobe) if nprobe else (self.nprobe or max(8, self.nlist // 64))
        return max(1, min(p, self.nlist))

    # ---------------------------------------------------------------- mutation
    def _grow_host(self, need: int) -> None:
        cap = _next_cap(max(1024, self._mat.shape[0]), need)
        if cap != self._mat.shape[0]:
            new_mat = self._mat_alloc((cap, self.dim))
            new_mat[: self._n] = self._mat[: self._n]
            self._mat = new_mat
            for name in ("_row_list", "_row_slot"):
                old = getattr(self, name)
                new_arr = np.full((cap,), -1, np.int32)
                new_arr[: old.shape[0]] = old
                setattr(self, name, new_arr)

    def add(self, ids: Sequence[int], vectors: np.ndarray) -> None:
        vectors = np.asarray(vectors, np.float32).reshape(-1, self.dim)
        ids = [int(i) for i in ids]
        with self._lock:
            self._add_locked(ids, vectors)

    def _add_locked(self, ids: list[int], vectors: np.ndarray) -> None:
        # overwrite semantics: tombstone the old slot, append the new row —
        # positions are append-only so in-flight searches stay consistent
        old_positions = [self._id_pos[i] for i in ids if i in self._id_pos]
        if old_positions:
            self._tombstone_locked(old_positions)
        m_rows = len(ids)
        start = self._n
        self._grow_host(start + m_rows)
        self._mat[start : start + m_rows] = vectors
        last = {}
        for j, i in enumerate(ids):
            last[i] = start + j  # duplicate ids in one batch: last write wins
        dup_dead = [start + j for j, i in enumerate(ids) if last[i] != start + j]
        self._ids.extend(ids)
        self._id_pos.update(last)
        self._n = start + m_rows
        if self._trained:
            self._append_trained_locked(start, m_rows, dup_dead)
        else:
            self._dead.update(dup_dead)
            self._rerank_dirty = True

    def add_device(self, ids: Sequence[int], rows) -> None:
        """API-compat with ``VectorIndex``: encode needs host rows anyway (list
        slot allocation is host logic), so fetch and take the host path."""
        self.add(ids, torch.as_tensor(rows).float().cpu().numpy())

    def reserve(self, n: int) -> None:
        with self._lock:
            self._grow_host(n)

    def remove(self, ids: Sequence[int]) -> None:
        with self._lock:
            drop = [self._id_pos[int(i)] for i in ids if int(i) in self._id_pos]
            if not drop:
                return
            for i in ids:
                self._id_pos.pop(int(i), None)
            self._tombstone_locked(drop)
            if not self._trained:
                self._rerank_dirty = True
        self._maybe_compact()

    def clear(self) -> None:
        with self._lock:
            self._swap_empty_locked()
            self._drift_frac = 0.0
            self._drift_stale = 0

    def _tombstone_locked(self, positions: list[int]) -> None:
        """Mark positions dead: host set + list-validity and rerank-validity
        scatters."""
        fresh = [p for p in positions if p not in self._dead]
        if not fresh:
            return
        self._dead.update(fresh)
        if self._trained and self._codes is not None:
            assigned = [p for p in fresh if self._row_list[p] >= 0]
            if assigned:
                _tombstone(self._lvalid, self._dev(self._row_list[assigned]),
                           self._dev(self._row_slot[assigned]))
        if self._rvalid is not None and self._rerank_count:
            in_tier = [p for p in fresh if p < self._rerank_count]
            if in_tier:
                _mask_positions(self._rvalid, self._dev(np.asarray(in_tier, np.int64)))

    def _append_rerank_locked(self, start: int, rows_f32: np.ndarray) -> None:
        """Bucketed device append into the rerank tier (bf16-then-normalize,
        the exact index's bit discipline).  Caller holds ``_lock``."""
        m_rows = rows_f32.shape[0]
        bkt = _bucket(m_rows, _APPEND_BUCKETS)
        cap = 0 if self._rerank is None else self._rerank.shape[0]
        if self._rerank is None:
            new_cap = _next_cap(1024, start + bkt)
            self._rerank = torch.zeros((new_cap, self.dim), dtype=torch.bfloat16,
                                       device=self.device)
            self._rvalid = torch.zeros((new_cap,), dtype=torch.bool, device=self.device)
        elif start + bkt > cap:
            self._rerank, self._rvalid = _grow_dev(self._rerank, self._rvalid,
                                                   _next_cap(cap, start + bkt))
        fresh = torch.zeros((bkt, self.dim), dtype=torch.bfloat16)
        fresh[:m_rows] = torch.from_numpy(np.ascontiguousarray(rows_f32, np.float32))
        fresh_valid = torch.zeros((bkt,), dtype=torch.bool)
        fresh_valid[:m_rows] = True
        _append_rows(self._rerank, self._rvalid, fresh.to(self.device),
                     fresh_valid.to(self.device), start)
        self._rerank_count = max(self._rerank_count, start + m_rows)
        self._snapshot_ids = self._ids

    def _scatter_batch_locked(
        self, positions: np.ndarray, lists: np.ndarray, codes: torch.Tensor
    ) -> None:
        """Allocate list slots host-side and flush one scatter."""
        m_rows = positions.shape[0]
        if not m_rows:
            return
        slots = np.empty((m_rows,), np.int32)
        counts = self._list_counts.copy()
        for j in range(m_rows):
            li = int(lists[j])
            slots[j] = counts[li]
            counts[li] += 1
        need = int(counts.max())
        list_cap = self._codes.shape[1]
        if need > list_cap:
            self._codes, self._lvalid, self._rowpos = _grow_lists(
                self._codes, self._lvalid, self._rowpos, _next_cap(list_cap, need))
        _scatter_codes(self._codes, self._lvalid, self._rowpos,
                       self._dev(lists.astype(np.int32)), self._dev(slots), codes,
                       self._dev(positions.astype(np.int32)))
        self._set_counts_locked(counts)
        self._row_list[positions] = lists
        self._row_slot[positions] = slots

    def _append_trained_locked(self, start: int, m_rows: int, dup_dead: list[int]) -> None:
        """Incremental append on a trained index: encode with the CURRENT
        quantizers (no retrain), pack, extend the rerank tier, feed the drift
        gauge.  Caller holds ``_lock``."""
        rows_norm = _normalize(self._mat[start : start + m_rows])
        rows_d = self._dev(rows_norm)
        lists2 = _assign(self._centroids, rows_d).cpu().numpy()
        # spill against a copy: _scatter_batch_locked owns the real counters
        cap_soft = max(32, self._codes.shape[1]) if self._codes is not None else 1 << 30
        lists = _spill_assign(lists2, self._list_counts.copy(), cap_soft)
        codes = _encode_assigned(self._centroids, self._codebooks, rows_d, self._dev(lists))
        keep = np.ones((m_rows,), bool)
        for p in dup_dead:
            keep[p - start] = False
        positions = start + np.nonzero(keep)[0].astype(np.int32)
        self._scatter_batch_locked(positions, lists[keep], codes[self._dev(keep)])
        # all rows append to the rerank tier (positions are contiguous);
        # duplicate-in-batch losers never reach the code blocks and their
        # rerank rows are masked dead right after
        self._append_rerank_locked(start, self._mat[start : start + m_rows])
        if dup_dead:
            self._tombstone_locked(list(dup_dead))
        np.add.at(self._list_sums, lists[keep], rows_norm[keep])
        np.add.at(self._list_nums, lists[keep], 1)
        self.appended_since_train += int(keep.sum())
        self._drift_stale += int(keep.sum())
        if self._drift_stale >= max(1024, self._n // 50):
            self._refresh_drift_locked()

    # ---------------------------------------------------------------- training
    def train(
        self,
        nlist: int = 0,
        iters: int = 4,
        sample: int = _TRAIN_SAMPLE,
        seed: Optional[int] = None,
    ) -> "ANNIndex":
        """(Re)learn the coarse quantizer + PQ codebooks from a seeded sample
        of the live rows, then re-encode and re-stage everything.  Searches
        keep running against the old tensors until the swap at the end."""
        self._restage(retrain=True, nlist=nlist, iters=iters, sample=sample, seed=seed)
        return self

    def compact(self) -> None:
        """Reclaim tombstoned slots: rebuild positions from live rows and
        re-encode with the existing quantizers (no re-learning)."""
        self._restage(retrain=False)

    def _maybe_compact(self) -> None:
        with self._lock:
            n, dead = self._n, len(self._dead)
        if n and dead / n > _DEAD_COMPACT_FRAC:
            self.compact()

    def _learn(self, rows_norm: np.ndarray, nlist: int, iters: int, rng):
        """Mini-batch k-means for centroids, then PQ codebooks over residuals,
        with the JAX function's draws from ``rng``.  Returns device
        (centroids, codebooks)."""
        n = rows_norm.shape[0]
        init = rng.choice(n, size=min(nlist, n), replace=False)
        cent = np.zeros((nlist, self.dim), np.float32)
        cent[: init.shape[0]] = rows_norm[init]
        if init.shape[0] < nlist:  # fewer rows than lists: pad with jittered repeats
            extra = rows_norm[rng.integers(0, n, nlist - init.shape[0])]
            cent[init.shape[0] :] = extra + 1e-3 * rng.standard_normal(extra.shape).astype(
                np.float32
            )
        centroids = self._dev(_normalize(cent))
        counts = torch.zeros((nlist,), dtype=torch.float32, device=self.device)
        rows_d = self._dev(rows_norm)
        for _ in range(max(1, iters)):
            order = self._dev(rng.permutation(n))
            for s in range(0, n, _TRAIN_BATCH):
                centroids, counts = _kmeans_step(centroids, counts, rows_d[order[s : s + _TRAIN_BATCH]])
        # PQ over residuals of the sample under the final centroids
        lists = _assign(centroids, rows_d)[:, 0].long()
        resid = (rows_d - centroids[lists]).reshape(n, self.m, self.sub_dim)
        cinit = rng.choice(n, size=min(_CODES, n), replace=False)
        codebooks = torch.zeros((self.m, _CODES, self.sub_dim), dtype=torch.float32,
                                device=self.device)
        codebooks[:, : cinit.shape[0]] = resid[self._dev(cinit)].transpose(0, 1)
        ccounts = torch.zeros((self.m, _CODES), dtype=torch.float32, device=self.device)
        for _ in range(max(1, iters)):
            order = self._dev(rng.permutation(n))
            for s in range(0, n, _TRAIN_BATCH):
                codebooks, ccounts = _pq_step(codebooks, ccounts, resid[order[s : s + _TRAIN_BATCH]])
        return centroids, codebooks

    def _encode_pack(self, live_rows: np.ndarray, all_lists: np.ndarray,
                     centroids, codebooks, nlist_eff: int):
        """Encode every row against its ASSIGNED list and pack the device code
        blocks — shared by ``_restage`` (fresh spill assignment) and
        ``restore_state`` (assignment read back from a snapshot, so restored
        placement — and therefore every ADC score — matches pre-crash bits).

        Returns ``(codes_d, lvalid_d, rowpos_d, counts, row_slot, sums)``.
        """
        n = live_rows.shape[0]
        all_codes = torch.empty((n, self.m), dtype=torch.uint8, device=self.device)
        sums = torch.zeros((nlist_eff, self.dim), dtype=torch.float32, device=self.device)
        for s in range(0, n, _ENCODE_BATCH):
            e = min(n, s + _ENCODE_BATCH)
            rows_d = self._dev(_normalize(live_rows[s:e]))
            lists_d = self._dev(all_lists[s:e].astype(np.int64))
            all_codes[s:e] = _encode_assigned(centroids, codebooks, rows_d, lists_d)
            # drift gauge restarts from the fresh assignment
            sums.index_add_(0, lists_d, rows_d)
        counts = np.bincount(all_lists, minlength=nlist_eff).astype(np.int64)
        # tight rounding (multiple of 128, not power of two): list_cap directly
        # multiplies every probe's scan cost; append-time growth stays geometric
        list_cap = max(32, -(-int(counts.max(initial=0)) // 128) * 128)
        # each row's slot within its list: its rank in a stable sort by list
        order = np.argsort(all_lists, kind="stable")
        cum = np.concatenate([[0], np.cumsum(counts)])
        row_slot = np.empty((n,), np.int32)
        row_slot[order] = (np.arange(n) - cum[all_lists[order]]).astype(np.int32)
        codes_d = torch.zeros((nlist_eff, list_cap, self.m), dtype=torch.uint8, device=self.device)
        lvalid_d = torch.zeros((nlist_eff, list_cap), dtype=torch.bool, device=self.device)
        rowpos_d = torch.zeros((nlist_eff, list_cap), dtype=torch.int32, device=self.device)
        li = self._dev(all_lists.astype(np.int64))
        si = self._dev(row_slot.astype(np.int64))
        codes_d[li, si] = all_codes
        lvalid_d[li, si] = True
        rowpos_d[li, si] = torch.arange(n, dtype=torch.int32, device=self.device)
        return codes_d, lvalid_d, rowpos_d, counts, row_slot, sums.cpu().numpy()

    def _restage(
        self,
        retrain: bool,
        nlist: int = 0,
        iters: int = 4,
        sample: int = _TRAIN_SAMPLE,
        seed: Optional[int] = None,
    ) -> None:
        """Rebuild the whole device state from live host rows.  Compaction =
        restage with the existing quantizers; (re)train = learn first.

        Everything is computed into fresh tensors and swapped in under the
        lock at the end, so concurrent searches never see a half-built index.
        Mutations that land DURING the rebuild are captured as a delta at
        swap time and replayed through the normal append/tombstone paths."""
        t0 = time.perf_counter()
        with self._lock:
            n0 = self._n
            dead0 = set(self._dead)
            live_mask = np.ones((n0,), bool)
            for p in dead0:
                live_mask[p] = False
            live_rows = self._mat[:n0][live_mask]
            live_ids = [i for p, i in enumerate(self._ids[:n0]) if live_mask[p]]
        n = live_rows.shape[0]
        if n == 0:
            with self._lock:
                self._swap_empty_locked()
            return
        rng = np.random.default_rng(self.seed if seed is None else seed)
        centroids, codebooks = self._centroids, self._codebooks
        nlist_eff = self.nlist
        timing = {}
        if retrain or centroids is None:
            nlist_eff = int(nlist) or self.nlist or _auto_nlist(n, 1)
            take = rng.choice(n, size=min(n, sample), replace=False)
            centroids, codebooks = self._learn(_normalize(live_rows[take]), nlist_eff, iters, rng)
            timing["learn_s"] = time.perf_counter() - t0
        # assign every live row (top-2 candidates), balance with spill, then
        # re-encode against the FINAL placement
        t1 = time.perf_counter()
        all_lists2 = np.empty((n, 2), np.int32)
        for s in range(0, n, _ENCODE_BATCH):
            e = min(n, s + _ENCODE_BATCH)
            all_lists2[s:e] = _assign(centroids, self._dev(_normalize(live_rows[s:e]))).cpu().numpy()
        cap_soft = max(32, _next_cap(32, 2 * max(1, -(-n // nlist_eff))))
        fill = np.zeros((nlist_eff,), np.int64)
        all_lists = _spill_assign(all_lists2, fill, cap_soft)
        timing["assign_s"] = time.perf_counter() - t1
        t1 = time.perf_counter()
        (codes_d, lvalid_d, rowpos_d, counts, row_slot, sums) = self._encode_pack(
            live_rows, all_lists, centroids, codebooks, nlist_eff
        )
        timing["encode_s"] = time.perf_counter() - t1
        t1 = time.perf_counter()
        with self._lock:
            was_trained = self._trained
            # capture mutations that raced the rebuild, replayed after the swap
            removed_ids = [self._ids[p] for p in self._dead - dead0 if p < n0]
            delta = [
                (self._ids[p], self._mat[p].copy())
                for p in range(n0, self._n)
                if p not in self._dead
            ]
            self._ids = live_ids
            self._id_pos = {i: p for p, i in enumerate(live_ids)}
            cap = _next_cap(1024, n)
            mat = self._mat_alloc((cap, self.dim))
            mat[:n] = live_rows
            self._mat = mat
            self._n = n
            self._dead = set()
            self.nlist = nlist_eff
            self._centroids, self._codebooks = centroids, codebooks
            self._codes, self._lvalid, self._rowpos = codes_d, lvalid_d, rowpos_d
            self._set_counts_locked(counts)
            rl = np.full((cap,), -1, np.int32)
            rs = np.full((cap,), -1, np.int32)
            rl[:n] = all_lists
            rs[:n] = row_slot
            self._row_list, self._row_slot = rl, rs
            self._list_sums = sums
            self._list_nums = counts.copy()
            self._drift_frac = 0.0
            self._drift_stale = 0
            if was_trained and retrain:
                self.retrains += 1
            self._trained = True
            self.appended_since_train = 0
            # rebuild the rerank tier from scratch at the new positions
            self._rerank = None
            self._rvalid = None
            self._rerank_count = 0
            for s in range(0, n, _ENCODE_BATCH):
                e = min(n, s + _ENCODE_BATCH)
                self._append_rerank_locked(s, live_rows[s:e])
            self._snapshot_ids = self._ids
            self._rerank_dirty = False
            if was_trained and not retrain:
                self.compactions += 1
            for rid in removed_ids:
                pos = self._id_pos.pop(rid, None)
                if pos is not None:
                    self._tombstone_locked([pos])
            if delta:
                self._add_locked([i for i, _ in delta], np.stack([r for _, r in delta]))
            timing["swap_s"] = time.perf_counter() - t1
            timing["total_s"] = time.perf_counter() - t0
            self.last_restage = timing

    def _swap_empty_locked(self) -> None:
        """Everything was removed while (re)staging: reset to untrained empty."""
        self._ids, self._id_pos = [], {}
        self._mat = self._mat_alloc((0, self.dim))
        self._n = 0
        self._dead = set()
        self._rerank = self._rvalid = None
        self._rerank_count = 0
        self._snapshot_ids = []
        self._rerank_dirty = True
        self._trained = False
        self._centroids = self._codebooks = None
        self._codes = self._lvalid = self._rowpos = None
        self._set_counts_locked(np.zeros((0,), np.int64))
        self._row_list = np.empty((0,), np.int32)
        self._row_slot = np.empty((0,), np.int32)
        self._list_sums = np.zeros((0, self.dim), np.float32)
        self._list_nums = np.zeros((0,), np.int64)
        self.appended_since_train = 0

    # ------------------------------------------------------------------- drift
    def _refresh_drift_locked(self, sample: int = 512) -> None:
        """Fraction of sampled assigned rows whose nearest *running-mean* list
        differs from their assigned list."""
        self._drift_stale = 0
        assigned = np.nonzero(self._row_list[: self._n] >= 0)[0]
        if self._dead:
            assigned = assigned[~np.isin(assigned, list(self._dead))]
        if assigned.shape[0] == 0 or self._list_nums.sum() == 0:
            self._drift_frac = 0.0
            return
        rng = np.random.default_rng(self.seed + 1)
        take = rng.choice(assigned, size=min(sample, assigned.shape[0]), replace=False)
        means = self._list_sums / np.maximum(self._list_nums, 1)[:, None]
        means = _normalize(means)
        rows = _normalize(self._mat[take])
        nearest = np.argmax(rows @ means.T, axis=1)
        self._drift_frac = float(np.mean(nearest != self._row_list[take]))

    # ------------------------------------------------------------------ search
    def _ensure_exact_locked(self):
        """Stage/refresh the rerank tier for the exact paths."""
        if self._rerank_dirty or self._rerank is None:
            self._rerank = None
            self._rvalid = None
            self._rerank_count = 0
            if self._n:
                for s in range(0, self._n, _ENCODE_BATCH):
                    e = min(self._n, s + _ENCODE_BATCH)
                    self._append_rerank_locked(s, self._mat[s:e])
                if self._dead:
                    _mask_positions(self._rvalid, self._dev(np.asarray(sorted(self._dead),
                                                                       np.int64)))
            self._snapshot_ids = self._ids
            self._rerank_dirty = False

    def _snapshot(self, allowed_ids: Optional[set]):
        """A consistent view of everything a search needs, under the lock."""
        with self._lock:
            if not self._trained or allowed_ids is not None:
                self._ensure_exact_locked()
            allowed_mask = None
            if allowed_ids is not None and self._rvalid is not None:
                allowed_mask = np.zeros((self._rvalid.shape[0],), bool)
                for i in allowed_ids:
                    pos = self._id_pos.get(int(i))
                    if pos is not None and pos < allowed_mask.shape[0]:
                        allowed_mask[pos] = True
            return (
                self._trained,
                self._centroids,
                self._codebooks,
                self._codes,
                self._lvalid,
                self._rowpos,
                self._fill,
                self._mean_fill,
                self._rerank,
                self._rvalid,
                self._snapshot_ids,
                len(self),
                allowed_mask,
            )

    def _queries(self, queries: np.ndarray) -> torch.Tensor:
        """Host-normalized f32 queries padded to a query bucket, on the device."""
        q = _normalize(np.asarray(queries, np.float32).reshape(-1, self.dim))
        q_pad = _bucket(q.shape[0], _QUERY_BUCKETS)
        if q_pad != q.shape[0]:
            q = np.concatenate([q, np.zeros((q_pad - q.shape[0], self.dim), np.float32)])
        return self._dev(q)

    @staticmethod
    def _fetch(scores: torch.Tensor, idx: torch.Tensor):
        """One device -> host copy for both outputs (the ids ride as f32 bits)."""
        kb = scores.shape[1]
        packed = torch.cat([scores, idx.view(torch.float32)], dim=1).cpu()
        return packed[:, :kb].numpy(), packed[:, kb:].contiguous().view(torch.int32).numpy()

    def search(
        self,
        query: np.ndarray,
        k: int = 10,
        allowed_ids: Optional[set] = None,
        nprobe: Optional[int] = None,
    ) -> list[tuple[int, float]]:
        return self.search_batch(
            np.asarray(query, np.float32)[None, :], k, allowed_ids=allowed_ids, nprobe=nprobe
        )[0]

    def search_batch(
        self,
        queries: np.ndarray,
        k: int = 10,
        allowed_ids: Optional[set] = None,
        nprobe: Optional[int] = None,
    ) -> list[list[tuple[int, float]]]:
        """Batched approximate top-k: ADC shortlist -> exact rerank.

        Allow-listed and untrained searches run the EXACT kernel over the
        rerank tier — identical results to ``VectorIndex``."""
        (trained, centroids, codebooks, codes, lvalid, rowpos, fill, mean_fill,
         tier, rvalid, ids, n_live, allowed_mask) = self._snapshot(allowed_ids)
        n_q = len(queries)
        if not ids or n_live == 0 or tier is None:
            return [[] for _ in range(n_q)]
        self.searches += n_q
        qd = self._queries(queries)
        if (not trained) or allowed_mask is not None:
            valid = rvalid
            if allowed_mask is not None:
                if not allowed_mask.any():
                    return [[] for _ in range(n_q)]
                valid = self._dev(allowed_mask)
                n_live = int(allowed_mask.sum())
            k_eff = min(k, n_live)
            kb = min(_bucket(k_eff, _K_BUCKETS), tier.shape[0])
            scores, idx = topk_scores(tier, qd, valid, kb)
        else:
            k_eff = min(k, n_live)
            kb = min(_bucket(k_eff, _K_BUCKETS), tier.shape[0])
            p_eff = self._nprobe_eff(nprobe)
            sl = min(max(self.rerank_depth, kb), p_eff * codes.shape[1])
            sl_scores, sl_pos = _adc_shortlist(
                centroids, codebooks, codes, lvalid, rowpos, qd, p_eff, sl, fill, mean_fill
            )
            scores, idx = rerank(tier, rvalid, qd, sl_scores, sl_pos, min(kb, sl))
        scores, idx = self._fetch(scores, idx)
        out_rows = []
        for qi in range(n_q):
            row = []
            seen: set = set()
            for j in range(min(k_eff, scores.shape[1])):
                p = int(idx[qi, j])
                if p < len(ids) and np.isfinite(scores[qi, j]) and p not in seen:
                    seen.add(p)
                    row.append((ids[p], float(scores[qi, j])))
            out_rows.append(row)
        return out_rows

    def warmup(self, ks: Sequence[int] = (16,), q_rows: Sequence[int] = (8, 32)):
        """Run the scan + rerank for the common buckets, blocking until the
        results are on the host (on the card the first call builds the
        kernels)."""
        if not len(self):
            return self
        q = np.zeros((1, self.dim), np.float32)
        q[0, 0] = 1.0
        for qr in q_rows:
            qb = _bucket(qr, _QUERY_BUCKETS)
            for k in ks:
                self.search_batch(np.repeat(q, qb, axis=0), k=k)
        return self

    # ------------------------------------------------------------------ stats
    def probe_recall(
        self,
        n_queries: int = 64,
        k: int = 10,
        nprobe: Optional[int] = None,
        seed: int = 0,
        noise: float = 0.05,
    ) -> dict:
        """Recall@k of the ANN path against this index's own exact tier.

        Queries are seeded perturbations of stored rows — near-duplicate
        lookups, the RAG-retrieval shape.  Result is cached for stats()."""
        with self._lock:
            n = self._n
            live = [p for p in range(n) if p not in self._dead]
            trained = self._trained
            if trained and live:
                rng = np.random.default_rng(seed)
                take = rng.choice(
                    np.asarray(live), size=min(n_queries, len(live)), replace=False
                )
                base = self._mat[take].copy()  # under the lock: _mat can be swapped
        if not trained or not live:
            rec = {"recall_at_k": 1.0, "k": k, "nprobe": 0, "queries": 0, "exact": True}
            self.last_recall = rec
            return rec
        qs = base + noise * rng.standard_normal((take.shape[0], self.dim)).astype(np.float32)
        exact = self._exact_batch(qs, k)
        approx = self.search_batch(qs, k=k, nprobe=nprobe)
        hits = total = 0
        for e_row, a_row in zip(exact, approx):
            truth = {i for i, _ in e_row}
            got = {i for i, _ in a_row}
            hits += len(truth & got)
            total += len(truth)
        rec = {
            "recall_at_k": (hits / total) if total else 1.0,
            "k": k,
            "nprobe": self._nprobe_eff(nprobe),
            "queries": int(take.shape[0]),
            "exact": False,
        }
        self.last_recall = rec
        return rec

    def _exact_batch(self, queries: np.ndarray, k: int) -> list[list[tuple[int, float]]]:
        """Exact top-k over the rerank tier (ground truth for recall probes)."""
        (_, _, _, _, _, _, _, _, tier, rvalid, ids, n_live, _) = self._snapshot(None)
        if tier is None or not ids:
            return [[] for _ in range(len(queries))]
        k_eff = min(k, n_live)
        kb = min(_bucket(k_eff, _K_BUCKETS), tier.shape[0])
        scores, idx = self._fetch(*topk_scores(tier, self._queries(queries), rvalid, kb))
        out = []
        for qi in range(len(queries)):
            row = []
            for j in range(k_eff):
                p = int(idx[qi, j])
                if p < len(ids) and np.isfinite(scores[qi, j]):
                    row.append((ids[p], float(scores[qi, j])))
            out.append(row)
        return out

    def stats(self) -> dict:
        """Operator/observability snapshot, computed without touching the
        device."""
        with self._lock:
            n_live = len(self)
            codes_bytes = 0 if self._codes is None else int(np.prod(self._codes.shape))
            list_cap = 0 if self._codes is None else int(self._codes.shape[1])
            list_fill_max = int(self._list_counts.max()) if self._list_counts.size else 0
            if self._trained and self._drift_stale and self._n < 50_000:
                self._refresh_drift_locked()
            drift = self._drift_frac
            return {
                "kind": "ivfpq",
                "trained": self._trained,
                "exact_fallback": not self._trained,
                "rows": n_live,
                "tombstones": len(self._dead),
                "nlist": self.nlist,
                "nprobe": self._nprobe_eff() if self._trained else 0,
                "m": self.m,
                "sub_dim": self.sub_dim,
                "codes_bytes": codes_bytes,
                "codes_bytes_per_vector": (codes_bytes / n_live) if n_live else 0.0,
                "rerank_depth": self.rerank_depth,
                "pending_appends": self.appended_since_train,
                "drift_frac": drift,
                "retrain_advised": bool(self._trained and drift > self.drift_threshold),
                "last_recall": self.last_recall,
                "searches": self.searches,
                "compactions": self.compactions,
                "retrains": self.retrains,
                "list_cap": list_cap,
                "list_fill_max": list_fill_max,
            }

    # -------------------------------------------------------------- durability
    def snapshot_state(self) -> dict:
        """Host-side state for an atomic snapshot (:mod:`.durable`): live rows
        only, in position order, with each live row's ASSIGNED list verbatim
        (restore re-encodes against it rather than re-running spill
        balancing, so restored ADC scores keep the pre-crash placement)."""
        with self._lock:
            n0 = self._n
            live_mask = np.ones((n0,), bool)
            for p in self._dead:
                if p < n0:
                    live_mask[p] = False
            state = {
                "ids": np.asarray(
                    [i for p, i in enumerate(self._ids[:n0]) if live_mask[p]], np.int64
                ),
                "vectors": np.ascontiguousarray(self._mat[:n0][live_mask], dtype=np.float32),
                "trained": bool(self._trained),
                "nlist": int(self.nlist),
                "m": int(self.m),
                "dim": int(self.dim),
                "seed": int(self.seed),
            }
            if self._trained and self._centroids is not None:
                state["centroids"] = self._centroids.cpu().numpy().astype(np.float32)
                state["codebooks"] = self._codebooks.cpu().numpy().astype(np.float32)
                state["row_list"] = np.ascontiguousarray(self._row_list[:n0][live_mask], np.int32)
            return state

    def restore_state(self, state) -> None:
        """Rebuild the whole index from a ``snapshot_state`` dict: the stored
        list assignment adopted verbatim, the rerank tier restaged at the
        restored positions, the drift gauge restarted."""
        ids = [int(i) for i in np.asarray(state["ids"]).reshape(-1).tolist()]
        vectors = np.asarray(state["vectors"], np.float32).reshape(-1, self.dim)
        if len(ids) != vectors.shape[0]:
            raise ValueError("snapshot ids/vectors length mismatch")
        n = len(ids)
        with self._lock:
            self._swap_empty_locked()
            if n == 0:
                return
            cap = _next_cap(1024, n)
            mat = self._mat_alloc((cap, self.dim))
            mat[:n] = vectors
            self._mat = mat
            self._n = n
            self._ids = ids
            self._id_pos = {i: p for p, i in enumerate(ids)}
            rl = np.full((cap,), -1, np.int32)
            rs = np.full((cap,), -1, np.int32)
            if not bool(state.get("trained")):
                self._row_list, self._row_slot = rl, rs
                self._rerank_dirty = True
                return
            nlist_eff = int(state["nlist"])
            centroids = self._dev(np.asarray(state["centroids"], np.float32))
            codebooks = self._dev(np.asarray(state["codebooks"], np.float32))
            all_lists = np.asarray(state["row_list"], np.int32).reshape(-1)
            (codes_d, lvalid_d, rowpos_d, counts, row_slot, sums) = self._encode_pack(
                vectors, all_lists, centroids, codebooks, nlist_eff
            )
            self.nlist = nlist_eff
            self._centroids, self._codebooks = centroids, codebooks
            self._codes, self._lvalid, self._rowpos = codes_d, lvalid_d, rowpos_d
            self._set_counts_locked(counts)
            rl[:n] = all_lists
            rs[:n] = row_slot
            self._row_list, self._row_slot = rl, rs
            self._list_sums = sums
            self._list_nums = counts.copy()
            self._drift_frac = 0.0
            self._drift_stale = 0
            self._trained = True
            self.appended_since_train = 0
            self._rerank = self._rvalid = None
            self._rerank_count = 0
            for s in range(0, n, _ENCODE_BATCH):
                e = min(n, s + _ENCODE_BATCH)
                self._append_rerank_locked(s, vectors[s:e])
            self._snapshot_ids = self._ids
            self._rerank_dirty = False

    def install_trained(self, centroids, codebooks, nlist: int) -> "ANNIndex":
        """Adopt quantizers learned elsewhere and restage against them — the
        WAL-replay twin of ``train()``: recovery re-installs the exact arrays
        the crashed process logged, then the deterministic assign + spill +
        encode restage reproduces the pre-crash placement."""
        with self._lock:
            self.nlist = int(nlist)
            self._centroids = self._dev(np.asarray(centroids, np.float32))
            self._codebooks = self._dev(np.asarray(codebooks, np.float32))
            # _trained flips inside _restage's locked swap — flipping it here
            # would let a concurrent search snapshot trained=True with no codes
        self._restage(retrain=False)
        return self

    def live_ids(self) -> list[int]:
        """Ids currently serving (tombstoned ones excluded)."""
        with self._lock:
            return list(self._id_pos.keys())

    def trained_arrays(self):
        """Host copies of the learned quantizers ``(centroids, codebooks,
        nlist)`` for a WAL install record; None while untrained."""
        with self._lock:
            if not self._trained or self._centroids is None:
                return None
            return (
                self._centroids.cpu().numpy().astype(np.float32),
                self._codebooks.cpu().numpy().astype(np.float32),
                int(self.nlist),
            )

    # ----------------------------------------------------------------- loading
    @classmethod
    def from_model(cls, model_cls, field: str = "embedding", mesh=None, **kw) -> "ANNIndex":
        raise NotImplementedError(
            "ANNIndex.from_model needs the ORM, which waits for ROADMAP Queue 1 item 16"
        )
