"""Attention (port of ``ops/attention.py``): plain PyTorch paths plus the two
hand-written Hopper kernels of the serving path.

- :func:`dot_product_attention` / :func:`gqa_dot_product_attention` — plain
  PyTorch, f32 scores, the JAX functions' masks and ``NEG_INF``.
- :func:`flash_attention` — blocked online-softmax prefill.  On a CUDA
  tensor it launches ``csrc/flash_prefill.cu``; on a CPU tensor it runs
  :func:`flash_attention_plain`.
- :func:`paged_prefill_attention` — a prefill chunk (or a wave of prefix
  suffixes) at a query offset against its rows' pages plus its own K/V.
  On a CUDA tensor it launches ``csrc/paged_prefill.cu``; on a CPU tensor
  it runs :func:`paged_prefill_attention_plain`, the gather + write +
  masked plain attention the JAX function composes.  bf16 outputs are held
  to :func:`paged_prefill_bf16_bound` on the card.
  :func:`chunked_prefill_attention` is the same over the legacy slot
  cache (the kernel's contiguous form: every slot row one page).
- :func:`paged_gqa_decode_attention` — one query per slot against a page
  pool.  On a CUDA tensor it launches ``csrc/paged_decode.cu``; on a CPU
  tensor it runs :func:`paged_gqa_decode_attention_plain`, which mirrors the
  JAX page loop.  bf16 outputs are held to :func:`paged_bf16_bound` on the
  card.
- :func:`chunked_gqa_decode_attention` — one query per slot against the
  legacy contiguous slot cache ``[B, KH, S, D]``, read in ``chunk``-wide
  slices up to the batch's longest live position.  On a CUDA tensor it
  launches the contiguous form of ``csrc/paged_decode.cu`` (the same
  kernels, the page being the chunk); on a CPU tensor it runs
  :func:`chunked_gqa_decode_attention_plain`, the paged twin's loop over
  the cache's chunks, so a paged read whose pages hold the cache's chunks
  gives the same bytes.
- :func:`paged_tree_attention` — the speculative verify forward's read: T
  tree queries per slot against the slot's verified prefix in the page
  pool plus the tree's own ancestor-masked keys.  On a CUDA tensor it
  launches ``csrc/paged_tree.cu``; on a CPU tensor it runs
  :func:`paged_tree_attention_plain`.  bf16 outputs are held to
  :func:`paged_tree_bf16_bound` on the card.
- :func:`attention` — the dispatch: the flash kernel for mask-free CUDA
  prefill of at least 256 tokens, the plain path otherwise.  ``k``/``v``
  carry H heads either way; :func:`flash_attention` itself also takes KH
  heads dividing H, which is how ``llama.prefill`` calls it.

Layouts are the JAX package's: ``[B, H, S, D]`` activations and
``[P, KH, page, D]`` page pools.  A pool may hold another dtype than q (the
engine's ``kv_cache_dtype``): bf16 under f32 queries, or fp8 (e4m3fn,
e5m2).  Both paged reads then dequantize per page as the JAX functions do
(the pool's values widened exactly to q's dtype, P rounded to q's dtype);
paged decode also takes the JAX in-dot scheme, ``fp8_dot=True``: the query
quantized to the pool's fp8 format (:func:`~.quant.quantize_fp8`), its
scale on the f32 score partials, P rounded to the pool's format before
P.V, held to :func:`paged_fp8_dot_bound` on the card.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from .. import kernels
from .quant import FP8_DTYPES, quantize_fp8, to_kv_dtype

NEG_INF = -1e30


def _check_fp8_dot(kv_dtype: torch.dtype, site: str) -> None:
    """The JAX check (and message) of ``fp8_dot=True`` on a pool that is
    not fp8."""
    if kv_dtype not in FP8_DTYPES:
        raise ValueError(
            f"{site}: fp8_dot=True requires an fp8 KV cache "
            f"(float8_e4m3fn / float8_e5m2), got {kv_dtype}"
        )


def _check_pool_dtype(site: str, q: torch.Tensor, k_pool: torch.Tensor,
                      v_pool: torch.Tensor) -> None:
    """The pools the card's paged kernels read: f32 or bf16 queries over a
    pool of their own dtype, bf16 pools under f32 queries, and fp8 pools
    (e4m3fn, e5m2) under either, K and V alike."""
    ok = (q.dtype in (torch.float32, torch.bfloat16) and k_pool.dtype == v_pool.dtype
          and (k_pool.dtype in (q.dtype, torch.bfloat16) or k_pool.dtype in FP8_DTYPES))
    if not ok:
        raise TypeError(
            f"{site} kernel takes f32 or bf16 queries over pools of their dtype, bf16 or fp8; "
            f"got {q.dtype} queries over {k_pool.dtype}/{v_pool.dtype} pools"
        )


def _repeat_heads(k: torch.Tensor, heads: int) -> torch.Tensor:
    """[B, KH, S, D] -> [B, heads, S, D]: contiguous blocks of KV heads, as
    the JAX package's ``jnp.repeat`` along the head axis."""
    if k.shape[1] == heads:
        return k
    return k.repeat_interleave(heads // k.shape[1], dim=1)


def dot_product_attention(
    q: torch.Tensor,  # [B, H, Sq, D]
    k: torch.Tensor,  # [B, H, Sk, D]
    v: torch.Tensor,  # [B, H, Sk, D]
    *,
    causal: bool = False,
    mask: Optional[torch.Tensor] = None,  # broadcastable to [B, H, Sq, Sk]; True=keep
    q_offset: int = 0,  # absolute position of q[0]
    window: Optional[int] = None,  # sliding window: keep iff kpos > qpos - window
) -> torch.Tensor:
    scale = q.shape[-1] ** -0.5
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if causal or window is not None:
        qpos = torch.arange(q.shape[2], device=q.device) + q_offset
        kpos = torch.arange(k.shape[2], device=q.device)
        keep = torch.ones((q.shape[2], k.shape[2]), dtype=torch.bool, device=q.device)
        if causal:
            keep &= qpos[:, None] >= kpos[None, :]
        if window is not None:
            keep &= kpos[None, :] > qpos[:, None] - window
        scores = torch.where(keep, scores, NEG_INF)
    if mask is not None:
        scores = torch.where(mask, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.matmul(probs, v)


def gqa_dot_product_attention(
    q: torch.Tensor,  # [B, H, Sq, D]
    k: torch.Tensor,  # [B, KH, Sk, D] — KV heads NOT repeated
    v: torch.Tensor,  # [B, KH, Sk, D]
    *,
    mask: Optional[torch.Tensor] = None,  # broadcastable to [B, 1, Sq, Sk]; True=keep
) -> torch.Tensor:
    """Grouped-query attention contracting query groups against the shared
    KV heads directly (no repeat of K/V up to H heads)."""
    B, H, Sq, D = q.shape
    KH = k.shape[1]
    G = H // KH
    scale = D ** -0.5
    if k.dtype != q.dtype:
        k = k.to(q.dtype)
        v = v.to(q.dtype)
    qg = q.reshape(B, KH, G, Sq, D)
    scores = torch.matmul(qg.float(), k.float()[:, :, None].transpose(-1, -2)) * scale
    if mask is not None:
        m = mask[:, :, None] if mask.dim() == 4 else mask  # insert group axis
        scores = torch.where(m, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.matmul(probs, v[:, :, None])
    return out.reshape(B, H, Sq, D)


# ---------------------------------------------------------------------------
# Flash prefill: Hopper kernel + plain twin
# ---------------------------------------------------------------------------

_FLASH_TILE = 64  # the kernel's q and kv tile
_FLASH_HEAD_DIMS = (64, 128, 256)  # the kernel's instantiations
# bf16 head dims that run the tensor-core kernel, which rounds P to bf16
# before P.V; f32, and bf16 at head_dim 256, run the CUDA-core kernel,
# whose P.V is f32
FLASH_MMA_HEAD_DIMS = (64, 128)


def flash_attention_plain(
    q: torch.Tensor,  # [B, H, Sq, D]
    k: torch.Tensor,  # [B, KH, Sk, D], KH divides H
    v: torch.Tensor,
    *,
    causal: bool = False,
    window: Optional[int] = None,
) -> torch.Tensor:
    """What the flash kernel computes, in plain PyTorch: f32 attention over
    KV heads repeated up to H, output in ``q``'s dtype."""
    H = q.shape[1]
    out = dot_product_attention(
        q.float(),
        _repeat_heads(k, H).float(),
        _repeat_heads(v, H).float(),
        causal=causal,
        window=window,
    )
    return out.to(q.dtype)


def flash_bf16_bound(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    ref: torch.Tensor,
    *,
    causal: bool = False,
    window: Optional[int] = None,
) -> torch.Tensor:
    """Per-element bound on ``|out - ref|`` for a bf16 flash output against
    the f32 plain twin ``ref`` on the same inputs:
    ``2^-8 |ref| + 2^-8 A + 1e-4`` with ``A`` the same attention over ``|v|``.

    It holds for the tensor-core kernel (bf16 at ``FLASH_MMA_HEAD_DIMS``),
    which, like the JAX kernel, rounds each probability to bf16 before the
    P.V product.  bf16 keeps 8 significant bits, so rounding moves a value
    by at most 2^-8 of its size: p_j by 2^-8 p_j, and so the output by at
    most 2^-8 A as long as the normaliser sums the unrounded f32 p; rounding
    the output to bf16 adds 2^-8 |out|.  The bound is the worst case of
    these two rounding steps, with 1e-4 for the f32 summation order."""
    a = flash_attention_plain(q.float(), k.float(), v.float().abs(), causal=causal, window=window)
    return 2.0 ** -8 * (ref.abs() + a) + 1e-4


def flash_attention(
    q: torch.Tensor,  # [B, H, Sq, D]
    k: torch.Tensor,  # [B, KH, Sk, D], KH divides H
    v: torch.Tensor,
    *,
    causal: bool = False,
    window: Optional[int] = None,
) -> torch.Tensor:
    """Flash prefill attention.  CPU tensors run the plain twin; CUDA tensors
    launch ``csrc/flash_prefill.cu`` or raise on what it does not take."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    B, H, Sq, D = q.shape
    if k.dim() != 4 or k.shape != v.shape or k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"flash_attention: bad shapes q={tuple(q.shape)} k={tuple(k.shape)} v={tuple(v.shape)}")
    KH, Sk = k.shape[1], k.shape[2]
    if H % KH:
        raise ValueError(f"flash_attention: KV heads {KH} must divide query heads {H}")
    if D not in _FLASH_HEAD_DIMS:
        raise ValueError(f"flash_attention kernel takes head_dim 64, 128 or 256, got {D}")
    if Sq % _FLASH_TILE or Sk % _FLASH_TILE:
        raise ValueError(f"flash_attention kernel needs Sq, Sk multiples of {_FLASH_TILE}, got {Sq}, {Sk}")
    if window is not None and window <= 0:
        raise ValueError(f"flash_attention: window must be positive, got {window}")
    if q.dtype not in (torch.float32, torch.bfloat16) or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention kernel takes matching f32 or bf16 q/k/v, got {q.dtype}/{k.dtype}/{v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError("flash_attention: q, k, v on different devices")
    q, k, v = (t.contiguous() for t in (q, k, v))
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("flash_attention kernel copies 16 bytes at a time: q, k, v must start on 16-byte boundaries")
    out = torch.empty_like(q)
    kernels.flash_prefill(q, k, v, out, causal=causal, window=window)
    return out


def flash_eligible(
    q: torch.Tensor,
    k: torch.Tensor,
    *,
    mask: Optional[torch.Tensor] = None,
    q_offset: int = 0,
) -> bool:
    """The JAX dispatch rule with "the TPU backend" read as "q is a CUDA
    tensor": mask-free, q_offset 0, Sq >= 256, Sq and Sk multiples of 128,
    and D equal to 64 or a multiple of 128.  :func:`flash_attention` raises
    on a D its kernel has no instantiation for (past 256), so such a model
    fails on the card rather than running the plain path there."""
    D = q.shape[-1]
    return (
        q.device.type == "cuda"
        and mask is None
        and q.shape[2] >= 256
        and q.shape[2] % 128 == 0
        and k.shape[2] % 128 == 0
        and (D == 64 or D % 128 == 0)
        and isinstance(q_offset, int)
        and q_offset == 0
    )


def attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = False,
    mask: Optional[torch.Tensor] = None,
    q_offset: int = 0,
    window: Optional[int] = None,
) -> torch.Tensor:
    """Dispatch: the flash kernel for long mask-free CUDA prefill,
    :func:`dot_product_attention` otherwise.  ``k``/``v`` are repeated to H
    heads by the caller."""
    if flash_eligible(q, k, mask=mask, q_offset=q_offset):
        return flash_attention(q, k, v, causal=causal, window=window)
    return dot_product_attention(
        q, k, v, causal=causal, mask=mask, q_offset=q_offset, window=window
    )


# ---------------------------------------------------------------------------
# Paged prefill (a chunk or a suffix at a query offset): Hopper kernel + plain twin
# ---------------------------------------------------------------------------

_PAGED_PREFILL_TILE = 64  # the kernel's query and key tile
_PAGED_PREFILL_HEAD_DIMS = (16, 32, 64, 128, 256)  # the kernel's instantiations


def gather_paged_rows(pool: torch.Tensor, block_tables: torch.Tensor) -> torch.Tensor:
    """One layer's logical rows from its pages: ``pool`` [P + 1, KH, page, D],
    ``block_tables`` [B, NB] -> [B, KH, NB * page, D].  Unallocated blocks
    gather a clamped page (``P - 1``) that the caller masks."""
    P = pool.shape[0] - 1
    _, KH, page, D = pool.shape
    B, NB = block_tables.shape
    phys = block_tables.long().clamp(0, P - 1).reshape(-1)
    rows = pool[phys].reshape(B, NB, KH, page, D)
    return rows.transpose(1, 2).reshape(B, KH, NB * page, D)


def _prefill_mask(starts: torch.Tensor, C: int, S: int, window: Optional[int]) -> torch.Tensor:
    """[B, 1, C, S] keep-mask of a chunk at ``starts``: ``kpos <= pos`` (and
    ``kpos > pos - window``), ``pos = start + i``."""
    pos = starts.long()[:, None] + torch.arange(C, device=starts.device)[None, :]
    kpos = torch.arange(S, device=starts.device)[None, None, None, :]
    keep = kpos <= pos[:, None, :, None]
    if window is not None:
        keep = keep & (kpos > pos[:, None, :, None] - window)
    return keep


def paged_prefill_attention_plain(
    q: torch.Tensor,  # [B, H, C, D]
    k_chunk: torch.Tensor,  # [B, KH, C, D] in the pool's dtype
    v_chunk: torch.Tensor,
    k_pool: torch.Tensor,  # [P + 1, KH, page, D] one layer (page P the dump page)
    v_pool: torch.Tensor,
    block_tables: torch.Tensor,  # [B, NB]; entries >= P unallocated
    starts: torch.Tensor,  # [B] tokens already present
    *,
    window: Optional[int] = None,
) -> torch.Tensor:
    """The JAX composition in plain PyTorch: gather each row's logical view
    of ``S = NB * page`` keys from its pages (sentinels clamped to page ``P -
    1``), write the chunk into it at ``min(start, S - C)`` as
    ``dynamic_update_slice`` clamps, then :func:`gqa_dot_product_attention`
    under ``kpos <= start + i`` (and the window).  The chunk's K/V come
    already cast to the pool's dtype (``to_kv_dtype``), as the row holds
    them, so an fp8 pool's chunk is read rounded.  Returns [B, H, C, D]."""
    B, C = q.shape[0], q.shape[2]
    S = block_tables.shape[1] * k_pool.shape[2]
    k_row = gather_paged_rows(k_pool, block_tables)
    v_row = gather_paged_rows(v_pool, block_tables)
    wpos = starts.long().clamp(max=S - C)[:, None] + torch.arange(C, device=q.device)[None, :]
    rows = torch.arange(B, device=q.device)[:, None]
    # advanced indices (dims 0 and 2) around a slice: values [B, C, KH, D]
    k_row[rows, :, wpos, :] = k_chunk.transpose(1, 2)
    v_row[rows, :, wpos, :] = v_chunk.transpose(1, 2)
    return gqa_dot_product_attention(q, k_row, v_row, mask=_prefill_mask(starts, C, S, window))


def paged_prefill_key_tiles(start: int, C: int, S: int, q0: int, window: Optional[int] = None,
                            tile: int = _PAGED_PREFILL_TILE) -> tuple:
    """The key tiles ``[lo, hi)`` (of ``tile`` keys, from position 0) that
    the kernel's block for query rows ``[q0, q0 + tile)`` of a ``C``-token
    chunk at ``start`` reads, as ``key_tiles`` in ``csrc/paged_prefill.cu``
    finds them on the device: up to the tile's last query row's position
    (inside the row of ``S`` keys), and from the first row's window edge;
    from 0 where a row's window lies wholly past the row's end (it keeps no
    key, and the twin's softmax then weighs every key of the row alike)."""
    last = min(q0 + tile, C) - 1
    hi = -(-min(S, start + last + 1) // tile)
    lo = 0
    if window is not None and start + last - window + 1 < S:
        lo = min(max(start + q0 - window + 1, 0) // tile, hi)
    return lo, hi


def paged_prefill_bf16_bound(
    q: torch.Tensor,
    k_chunk: torch.Tensor,
    v_chunk: torch.Tensor,
    k_pool: torch.Tensor,
    v_pool: torch.Tensor,
    block_tables: torch.Tensor,
    starts: torch.Tensor,
    ref: torch.Tensor,
    *,
    window: Optional[int] = None,
) -> torch.Tensor:
    """Per-element bound on ``|out - ref|`` for a bf16 paged prefill output
    of the tensor-core kernel against the f32 plain twin ``ref`` on the same
    inputs: ``2^-8 |ref| + 2^-8 A + 1e-4``, ``A`` the same attention over
    ``|v|`` (chunk and pool) -- :func:`flash_bf16_bound`'s formula over the
    same mask, by the same argument: the kernel rounds each probability to
    bf16 before P.V while the normaliser sums the unrounded f32 p (at most
    2^-8 A), and rounds the output (2^-8 |out|); 1e-4 covers the f32
    summation order.  Widening a bf16 or fp8 page to bf16 is exact."""
    a = paged_prefill_attention_plain(
        q.float(), k_chunk.float(), v_chunk.float().abs(), k_pool.float(), v_pool.float().abs(),
        block_tables, starts, window=window,
    )
    return 2.0 ** -8 * (ref.abs() + a) + 1e-4


def _aligned_rows(t: torch.Tensor) -> bool:
    """Whether every row of ``t`` (its last dim contiguous) starts on a
    16-byte boundary, as the tensor-core kernel's 16-byte copies need."""
    esz = t.element_size()
    return (t.stride(-1) == 1 and t.data_ptr() % 16 == 0
            and all((s * esz) % 16 == 0 for s in t.stride()[:-1]))


def paged_prefill_attention(
    q: torch.Tensor,  # [B, H, C, D]
    k_chunk: torch.Tensor,  # [B, KH, C, D] in the pool's dtype
    v_chunk: torch.Tensor,
    k_pool: torch.Tensor,  # [P + 1, KH, page, D]
    v_pool: torch.Tensor,
    block_tables: torch.Tensor,  # [B, NB] int
    starts: torch.Tensor,  # [B] int
    *,
    window: Optional[int] = None,
) -> torch.Tensor:
    """Causal GQA attention of a prefill chunk (or a suffix wave) at query
    offsets ``starts`` over its rows' pages plus its own K/V.  CPU tensors
    run the plain twin; CUDA tensors launch ``csrc/paged_prefill.cu`` or
    raise on what it does not take: the kernel reads each row's live keys
    through its block table, and the chunk's own K/V in place of the pages
    at ``[min(start, S - C), + C)``, so no row is gathered and no score
    reaches device memory.  The output may be a transposed view (the kernel
    writes ``[B, C, H, D]``, the layout the output projection reads)."""
    if q.device.type == "cpu":
        return paged_prefill_attention_plain(q, k_chunk, v_chunk, k_pool, v_pool, block_tables,
                                             starts, window=window)
    return _prefill_launch("paged_prefill_attention", q, k_chunk, v_chunk, k_pool, v_pool,
                           block_tables, starts, window, k_pool.shape[0] - 1)


def chunked_prefill_attention_plain(
    q: torch.Tensor,  # [B, H, C, D]
    k_chunk: torch.Tensor,  # [B, KH, C, D] in the cache's dtype
    v_chunk: torch.Tensor,
    k_cache: torch.Tensor,  # [slots, KH, S, D] one layer of the legacy slot cache
    v_cache: torch.Tensor,
    slots: torch.Tensor,  # [B] each row's slot (pad rows alias a real one)
    starts: torch.Tensor,  # [B]
    *,
    window: Optional[int] = None,
) -> torch.Tensor:
    """The legacy plane's composition (the JAX ``prefill_suffix``): each
    row's slot row as it is, the chunk written into it at ``min(start, S -
    C)``, :func:`gqa_dot_product_attention` under ``kpos <= start + i``
    (and the window).  Returns [B, H, C, D]."""
    B, C = q.shape[0], q.shape[2]
    S = k_cache.shape[2]
    sl = slots.long()
    k_row, v_row = k_cache[sl], v_cache[sl]
    wpos = starts.long().clamp(0, S - C)[:, None] + torch.arange(C, device=q.device)[None, :]
    rows = torch.arange(B, device=q.device)[:, None]
    k_row[rows, :, wpos, :] = k_chunk.transpose(1, 2)
    v_row[rows, :, wpos, :] = v_chunk.transpose(1, 2)
    return gqa_dot_product_attention(q, k_row, v_row, mask=_prefill_mask(starts, C, S, window))


def chunked_prefill_attention(
    q: torch.Tensor,  # [B, H, C, D]
    k_chunk: torch.Tensor,  # [B, KH, C, D] in the cache's dtype
    v_chunk: torch.Tensor,
    k_cache: torch.Tensor,  # [slots, KH, S, D]
    v_cache: torch.Tensor,
    slots: torch.Tensor,  # [B] int
    starts: torch.Tensor,  # [B] int
    *,
    window: Optional[int] = None,
) -> torch.Tensor:
    """:func:`paged_prefill_attention` over the legacy contiguous slot
    cache.  CPU tensors run :func:`chunked_prefill_attention_plain`; CUDA
    tensors launch the paged prefill kernel's contiguous form: the cache
    read as a pool of pages of S keys, every slot one (no dump page), each
    row's block table its slot."""
    if q.device.type == "cpu":
        return chunked_prefill_attention_plain(q, k_chunk, v_chunk, k_cache, v_cache, slots,
                                               starts, window=window)
    return _prefill_launch("chunked_prefill_attention", q, k_chunk, v_chunk, k_cache, v_cache,
                           slots.reshape(-1, 1), starts, window, k_cache.shape[0])


def _prefill_launch(site, q, k_chunk, v_chunk, k_pool, v_pool, block_tables, starts, window,
                    n_pages: int) -> torch.Tensor:
    """Validate a CUDA call of the paged prefill kernel (pages ``[0,
    n_pages)`` of the pools readable) and launch it, or raise."""
    if q.device.type != "cuda":
        raise ValueError(f"{site}: unsupported device {q.device}")
    B, H, C, D = q.shape
    if k_pool.dim() != 4 or k_pool.shape != v_pool.shape or k_pool.shape[3] != D:
        raise ValueError(f"{site}: bad pool shapes {tuple(k_pool.shape)} / {tuple(v_pool.shape)}")
    KH, page = k_pool.shape[1], k_pool.shape[2]
    if H % KH:
        raise ValueError(f"{site}: KV heads {KH} must divide query heads {H}")
    if D not in _PAGED_PREFILL_HEAD_DIMS:
        raise ValueError(f"paged prefill kernel takes head_dim 16, 32, 64, 128 or 256, got {D}")
    if tuple(k_chunk.shape) != (B, KH, C, D) or v_chunk.shape != k_chunk.shape:
        raise ValueError(f"{site}: chunk K/V must be [{B}, {KH}, {C}, {D}], got "
                         f"{tuple(k_chunk.shape)} / {tuple(v_chunk.shape)}")
    _check_pool_dtype("paged prefill", q, k_pool, v_pool)
    if k_chunk.dtype != k_pool.dtype or v_chunk.dtype != v_pool.dtype:
        raise TypeError(f"paged prefill kernel takes the chunk's K/V in the pool's dtype, got "
                        f"{k_chunk.dtype}/{v_chunk.dtype} over {k_pool.dtype} pools")
    if block_tables.dim() != 2 or block_tables.shape[0] != B:
        raise ValueError(f"{site}: block_tables must be [{B}, NB]")
    NB = block_tables.shape[1]
    if C < 1 or C > NB * page:
        raise ValueError(f"{site}: a chunk of {C} tokens in a row of {NB * page}")
    if n_pages < 1:
        raise ValueError(f"{site}: the pool holds no page to read")
    if starts.shape != (B,):
        raise ValueError(f"{site}: starts must be [{B}]")
    if window is not None and window <= 0:
        raise ValueError(f"{site}: window must be positive, got {window}")
    for t in (k_chunk, v_chunk, k_pool, v_pool, block_tables, starts):
        if t.device != q.device:
            raise ValueError(f"{site}: tensors on different devices")
    if not (k_pool.is_contiguous() and v_pool.is_contiguous()):
        raise ValueError(f"{site}: pools must be contiguous")
    mma = q.dtype == torch.bfloat16 and D in kernels.PAGED_MMA_HEAD_DIMS
    if mma and not (k_pool.data_ptr() % 16 == 0 and v_pool.data_ptr() % 16 == 0):
        raise ValueError("paged prefill kernel copies 16 bytes at a time: pools must start on "
                         "16-byte boundaries")
    # the kernel reads q and the chunk through their strides (the layout
    # the projections leave them in); a view it cannot read is copied
    if q.stride(-1) != 1 or (mma and not _aligned_rows(q)):
        q = q.contiguous()
    if k_chunk.stride() != v_chunk.stride() or k_chunk.stride(-1) != 1 or (
            mma and not (_aligned_rows(k_chunk) and _aligned_rows(v_chunk))):
        k_chunk, v_chunk = k_chunk.contiguous(), v_chunk.contiguous()
    out = torch.empty((B, C, H, D), dtype=q.dtype, device=q.device).transpose(1, 2)
    kernels.paged_prefill(
        q, k_chunk, v_chunk, k_pool, v_pool, block_tables.to(torch.int32).contiguous(),
        starts.to(torch.int64).contiguous(), out, mma=mma, window=window, n_pages=n_pages,
    )
    return out


# ---------------------------------------------------------------------------
# Paged decode: Hopper kernel + plain twin
# ---------------------------------------------------------------------------


def _decode_range(positions, active, page: int, NB: int, window: Optional[int]):
    """The JAX loop's logical-block range [lo, hi) as host ints (plain twin)."""
    S = NB * page
    act_pos = torch.where(active, positions, 0)
    hi = min(int(act_pos.max()) // page + 1, NB)
    if window is not None:
        min_pos = int(torch.where(active, positions, S).min())
        lo = min(max(min_pos - window + 1, 0) // page, hi)
    else:
        lo = 0
    return lo, hi


def _decode_loop(
    q, k_dtype, v_dtype, KH: int, page: int, NB: int, fetch, positions, active, window, fp8_dot,
    site, *, round_p: bool = True, ones: bool = False,
):
    """The JAX decode loop shared by the paged and the chunked reads ->
    (acc [B, KH, G, D], l [B, KH, G, 1]), both f32: logical blocks [lo, hi)
    of ``page`` keys each, ``fetch(ci)`` giving block ``ci``'s K and V rows
    ``[B, KH, page, D]`` widened exactly to f32.  ``round_p=False`` leaves
    P unrounded; ``ones`` weighs every kept key 1 (the bounds' sums)."""
    B, H, Sq, D = q.shape
    if Sq != 1:
        raise ValueError(f"decode attention expects Sq=1 queries, got {Sq}")
    G = H // KH
    scale = D ** -0.5
    if active is None:
        active = torch.ones((B,), dtype=torch.bool, device=q.device)
    qg = q.reshape(B, KH, G, D)
    if fp8_dot:
        _check_fp8_dot(k_dtype, site)
        qg_q, qg_s = quantize_fp8(qg, axis=-1, dtype=k_dtype)
        qg = qg_q.float()
        s_scale = qg_s * scale  # the f32 scale on the f32 partials
        p_dtype = v_dtype  # P in the pool's fp8 format, as p.astype(v_blk.dtype)
    else:
        qg = qg.float()
        s_scale = scale
        # the dequant read widens the page to q's dtype, so p.astype(v_blk.dtype)
        # rounds P to q's dtype
        p_dtype = q.dtype
    lo, hi = _decode_range(positions, active, page, NB, window)
    m = torch.full((B, KH, G, 1), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, KH, G, 1), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, KH, G, D), dtype=torch.float32, device=q.device)
    offs = torch.arange(page, device=q.device)
    for ci in range(lo, hi):
        k_blk, v_blk = fetch(ci)
        s = torch.matmul(qg, k_blk.transpose(-1, -2)) * s_scale  # [B, KH, G, page]
        kpos = ci * page + offs
        keep = kpos[None, :] <= positions[:, None]
        if window is not None:
            keep &= kpos[None, :] > positions[:, None] - window
        s = torch.where(keep[:, None, None, :], s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.exp(s - m_new)
        alpha = torch.exp(m - m_new)
        if ones:
            p = keep[:, None, None, :].expand_as(p).float()
            alpha = torch.ones_like(alpha)
        l = alpha * l + p.sum(dim=-1, keepdim=True)  # the unrounded f32 p
        pv = to_kv_dtype(p, p_dtype).float() if round_p else p
        acc = alpha * acc + torch.matmul(pv, v_blk)
        m = m_new
    return acc, l


def _paged_decode_loop(
    q, k_pool, v_pool, block_tables, positions, active, window, fp8_dot, *,
    round_p: bool = True, ones: bool = False,
):
    """:func:`_decode_loop` over a page pool (:func:`paged_gqa_decode_attention_plain`):
    block ``ci`` of each row is its page through the block table, sentinels
    clamped to page ``P - 1`` (masked by the loop)."""
    P, KH, page, _ = k_pool.shape

    def fetch(ci):
        phys = block_tables[:, ci].long().clamp(0, P - 1)
        return k_pool[phys].float(), v_pool[phys].float()  # exact for every pool dtype

    return _decode_loop(
        q, k_pool.dtype, v_pool.dtype, KH, page, block_tables.shape[1], fetch, positions, active,
        window, fp8_dot, "paged_gqa_decode_attention", round_p=round_p, ones=ones,
    )


def _check_chunk(S: int, chunk: int) -> int:
    """The JAX check of the chunk width; the number of chunks of a row."""
    if chunk <= 0 or S % chunk:
        raise ValueError(f"chunk={chunk} must divide cache length {S}")
    return S // chunk


def _chunked_decode_loop(
    q, k, v, positions, active, window, fp8_dot, chunk, *,
    round_p: bool = True, ones: bool = False,
):
    """:func:`_decode_loop` over the contiguous slot cache ``[B, KH, S, D]``
    (:func:`chunked_gqa_decode_attention_plain`): block ``ci`` of each row is
    its chunk ``ci``, read in place."""
    NB = _check_chunk(k.shape[2], chunk)

    def fetch(ci):
        sl = slice(ci * chunk, (ci + 1) * chunk)
        return k[:, :, sl].float(), v[:, :, sl].float()

    return _decode_loop(
        q, k.dtype, v.dtype, k.shape[1], chunk, NB, fetch, positions, active, window, fp8_dot,
        "chunked_gqa_decode_attention", round_p=round_p, ones=ones,
    )


def paged_gqa_decode_attention_plain(
    q: torch.Tensor,  # [B, H, 1, D]
    k_pool: torch.Tensor,  # [P, KH, page, D], q's dtype, bf16 or fp8
    v_pool: torch.Tensor,
    block_tables: torch.Tensor,  # [B, NB] int; entries >= P mean unallocated
    positions: torch.Tensor,  # [B] int
    *,
    active: Optional[torch.Tensor] = None,  # [B] bool
    window: Optional[int] = None,
    fp8_dot: bool = False,
) -> torch.Tensor:
    """The JAX page loop in plain PyTorch: logical blocks [lo, hi) of the
    batch, one gathered page per row per step, f32 online softmax with the
    finite ``NEG_INF`` mask.  The dequant read widens each page exactly and
    rounds P to q's dtype before P.V (a no-op for f32 queries); with
    ``fp8_dot`` the query is quantized to the pool's fp8 format, its scale
    multiplies the f32 score partials, and P is rounded to the pool's format
    before P.V.  ``l`` sums the unrounded f32 p either way."""
    B, H, _, D = q.shape
    acc, l = _paged_decode_loop(q, k_pool, v_pool, block_tables, positions, active, window,
                                fp8_dot)
    out = (acc / torch.clamp(l, min=1e-30)).to(q.dtype)
    return out.reshape(B, H, 1, D)


def paged_bf16_bound(
    q: torch.Tensor,
    k_pool: torch.Tensor,
    v_pool: torch.Tensor,
    block_tables: torch.Tensor,
    positions: torch.Tensor,
    ref: torch.Tensor,
    *,
    active: Optional[torch.Tensor] = None,
    window: Optional[int] = None,
) -> torch.Tensor:
    """Per-element bound on ``|out - ref|`` for a bf16 paged decode output
    against the f32 plain twin ``ref`` on the same inputs:
    ``2^-8 |ref| + 2^-8 A + 1e-4`` with ``A`` the same paged attention over
    ``|v_pool|`` — the decode counterpart of :func:`flash_bf16_bound`, by
    the same argument: the kernel, like the JAX function, rounds each
    probability to bf16 before P.V (moving the output by at most 2^-8 A
    while the normaliser sums the unrounded f32 p) and rounds the output
    (2^-8 |out|); 1e-4 covers the f32 summation order.  It holds for the
    dequant read of a bf16 or fp8 pool too: every value of those formats is
    a bf16 value, so widening a page is exact."""
    a = paged_gqa_decode_attention_plain(
        q.float(), k_pool.float(), v_pool.float().abs(), block_tables, positions,
        active=active, window=window,
    )
    return 2.0 ** -8 * (ref.abs() + a) + 1e-4


# fp8 formats: (mantissa bits m, the subnormal spacing u)
_FP8_STEPS = {torch.float8_e4m3fn: (3, 2.0 ** -9), torch.float8_e5m2: (2, 2.0 ** -16)}


def paged_fp8_dot_bound(
    q: torch.Tensor,
    k_pool: torch.Tensor,
    v_pool: torch.Tensor,
    block_tables: torch.Tensor,
    positions: torch.Tensor,
    ref: torch.Tensor,
    *,
    active: Optional[torch.Tensor] = None,
    window: Optional[int] = None,
) -> torch.Tensor:
    """Per-element bound on ``|out - ref|`` for an ``fp8_dot=True`` paged
    decode output (the card's kernel, or the JAX function) against the
    port's plain twin ``ref`` on the same inputs (q in its own dtype, the
    fp8 pools): ``2^-m A + u S + 2^-8 |ref| + 1e-4``, where m is the pool
    format's mantissa bits (3 for e4m3fn, 2 for e5m2), u its subnormal
    spacing (2^-9, 2^-16), ``A`` the in-dot attention over ``|v|`` with
    unrounded P, and ``S`` the sum of ``|v|`` over a row's kept keys over
    its normaliser ``l``.

    Why: every side rounds each probability to the fp8 format before P.V,
    but each at its own scale.  The JAX loop and the twin take p = exp(s -
    m) against the running max of whole pages; the kernels against the
    running max of their own tiles (each warp's 16 keys of a chunk in the
    tensor-core kernel, each warp's 4 keys in the CUDA-core kernel), and
    rescale later.  The same key's p is then rounded at two scales that
    differ by a factor that is not a power of two, so the two roundings
    can land a step apart: each is within half a step, at most 2^-(m+1) p
    for a normal p and u / 2 for a subnormal one.  The output so moves by
    at most ``(2^-m p + u) |v| / l`` summed over the keys: ``2^-m A + u
    S``.  The quantized query is bit-equal on both sides (the same f32
    division and rounding); rounding the output adds 2^-8 |out| (bf16
    queries), and 1e-4 covers the f32 sums.

    The bound is that loose (2^-3 A for e4m3) because of the scales, so on
    random inputs it cannot show whether a kernel rounds P at all (P
    rounded to bf16 instead moves the output by about 2^-4 A).  That is
    checked on :func:`paged_fp8_dot_probe`'s inputs, where every side rounds
    at the same scale, to ``paged_bf16_bound``."""
    absv = v_pool.float().abs().to(v_pool.dtype)  # |v| is exact in the format
    return _fp8_dot_bound(
        lambda **kw: _paged_decode_loop(q, k_pool, absv, block_tables, positions, active,
                                        window, True, **kw),
        q, v_pool.dtype, ref,
    )


def _fp8_dot_bound(loop, q, v_dtype, ref):
    """:func:`paged_fp8_dot_bound` from ``loop``, the in-dot read over |v|
    (keyword ``round_p`` / ``ones`` as :func:`_decode_loop`)."""
    m_bits, u = _FP8_STEPS[v_dtype]
    acc, l = loop(round_p=False)
    a = acc / torch.clamp(l, min=1e-30)
    tot, _ = loop(round_p=False, ones=True)
    S = tot / torch.clamp(l, min=1e-30)
    B, H, _, D = q.shape
    bound = 2.0 ** -m_bits * a + u * S
    return bound.reshape(B, H, 1, D) + 2.0 ** -8 * ref.abs() + 1e-4


def paged_fp8_dot_probe(
    B: int, H: int, KH: int, D: int, P: int, page: int, kv_dtype: torch.dtype,
    q_dtype: torch.dtype, generator: torch.Generator,
) -> tuple:
    """CPU inputs (q [B, H, 1, D] in ``q_dtype``; K and V pools [P, KH,
    page, D] in the fp8 ``kv_dtype``) on which an ``fp8_dot=True`` read
    must meet ``paged_bf16_bound`` (2^-8 (|ref| + A) + 1e-4, A = ref here)
    against the plain twin: every side rounds each p at the same scale and
    no p lies near a rounding boundary, so a read that rounds P to another
    format, or skips pages, misses it.

    - Query head g of a KV head holds ``a = 7 2^k`` at components 2g, 2g +
      1 and zeros elsewhere: ``quantize_fp8`` is exact (its scale a power
      of two, the quantized value the format's max), so the in-dot scores
      equal the dequant read's, which is the control: the same scores with
      P unrounded (f32 q) or rounded to bf16.
    - Every key at a position 0 mod 4 is the max key (components 2g, 2g + 1
      equal to 2): every tile of either kernel (4 or 16 aligned keys) and
      every page of the JAX loop holds it, so every running max is the
      row's max from the first tile on, and p = exp(s - max) everywhere.
    - Every other key's components (2g, 2g + 1) are a pair of format
      values whose p lies 0.2 to 0.4 of a format step above a grid point
      in [0.25, 1): f32 differences in p cannot flip its rounding, and the
      rounding lowers it by at least 0.2 of a step (2^-5.3 of p in e4m3).
    - V is positive, column d large (1/16 elsewhere) on the physical pages
      that are d mod 8, so that a dropped page takes most of some column.
    """
    G = H // KH
    if 2 * G > D or page % 4 or kv_dtype not in FP8_DTYPES:
        raise ValueError(f"paged_fp8_dot_probe: needs 2 H / KH <= D, a page of 4 n keys and "
                         f"an fp8 pool, got H={H} KH={KH} D={D} page={page} {kv_dtype}")
    a = 7.0 * 2.0 ** round(math.log2(0.7 * D ** 0.5 / 7.0))
    c = a * D ** -0.5  # the score of one unit of k[2g] + k[2g + 1]
    fin = torch.arange(256, dtype=torch.int32).to(torch.uint8).view(kv_dtype).double()
    fin = torch.unique(fin[torch.isfinite(fin) & (fin >= 0)])  # the format's grid, sorted
    vals = fin[(fin >= 0.5) & (fin <= 2.0)]
    x, y = torch.meshgrid(vals, vals, indexing="ij")
    p = torch.exp(c * (x + y - 4.0)).flatten()
    at = torch.searchsorted(fin, p, right=True) - 1  # the grid point at or below p
    frac = (p - fin[at]) / (fin[at + 1] - fin[at])
    ok = (p >= 0.25) & (p < 1.0) & (frac >= 0.2) & (frac <= 0.4)
    pairs = torch.stack([x.flatten(), y.flatten()], 1)[ok]
    if not len(pairs):
        raise ValueError(f"paged_fp8_dot_probe: no key pair for {kv_dtype} at D={D}")
    k = torch.randn((P, KH, page, D), generator=generator, dtype=torch.float64)
    pick = pairs[torch.randint(len(pairs), (P, KH, page, G), generator=generator)]
    k[..., :2 * G] = pick.reshape(P, KH, page, 2 * G)
    k[:, :, ::4, :2 * G] = 2.0
    heavy = (torch.arange(D)[None, :] % 8 == torch.arange(P)[:, None] % 8).double()
    v = torch.randn((P, KH, page, D), generator=generator, dtype=torch.float64).abs()
    v = v * (heavy + (1 - heavy) / 16)[:, None, None, :]
    q = torch.zeros((B, H, 1, D), dtype=torch.float64)
    for h in range(H):
        q[:, h, 0, 2 * (h % G):2 * (h % G) + 2] = a
    return (q.to(q_dtype), to_kv_dtype(k.float(), kv_dtype), to_kv_dtype(v.float(), kv_dtype))


def paged_gqa_decode_attention(
    q: torch.Tensor,  # [B, H, 1, D]
    k_pool: torch.Tensor,  # [P, KH, page, D]
    v_pool: torch.Tensor,
    block_tables: torch.Tensor,  # [B, NB] int32; entries >= P mean unallocated
    positions: torch.Tensor,  # [B] int32
    *,
    active: Optional[torch.Tensor] = None,  # [B] bool
    window: Optional[int] = None,
    fp8_dot: bool = False,
) -> torch.Tensor:
    """Paged decode attention.  CPU tensors run the plain twin; CUDA tensors
    launch ``csrc/paged_decode.cu`` or raise on what it does not take.  The
    pools may be q's dtype, bf16 under f32 queries, or fp8 (the dequant
    read, or the in-dot scheme with ``fp8_dot``, which needs an fp8 pool)."""
    if q.device.type == "cpu":
        return paged_gqa_decode_attention_plain(
            q, k_pool, v_pool, block_tables, positions,
            active=active, window=window, fp8_dot=fp8_dot,
        )
    if q.device.type != "cuda":
        raise ValueError(f"paged_gqa_decode_attention: unsupported device {q.device}")
    if fp8_dot:
        _check_fp8_dot(k_pool.dtype, "paged_gqa_decode_attention")
    B, H, Sq, D = q.shape
    if Sq != 1:
        raise ValueError(f"decode attention expects Sq=1 queries, got {Sq}")
    if k_pool.dim() != 4 or k_pool.shape != v_pool.shape or k_pool.shape[3] != D:
        raise ValueError(f"paged_gqa_decode_attention: bad pool shapes {tuple(k_pool.shape)} / {tuple(v_pool.shape)}")
    KH = k_pool.shape[1]
    if H % KH or H // KH not in (1, 2, 4, 8):
        raise ValueError(f"paged decode kernel takes H/KH in 1, 2, 4, 8, got H={H} KH={KH}")
    if D not in (16, 32, 64, 128, 256):
        raise ValueError(f"paged decode kernel takes head_dim 16, 32, 64, 128 or 256, got {D}")
    if D == 256 and H // KH > 4:
        raise ValueError(f"paged decode kernel takes H/KH up to 4 at head_dim 256, got {H // KH}")
    if k_pool.shape[2] % 4:
        raise ValueError(f"paged decode kernel takes a page size divisible by 4, got {k_pool.shape[2]}")
    _check_pool_dtype("paged decode", q, k_pool, v_pool)
    if block_tables.dim() != 2 or block_tables.shape[0] != B or block_tables.dtype != torch.int32:
        raise ValueError("paged_gqa_decode_attention: block_tables must be [B, NB] int32")
    if positions.shape != (B,) or positions.dtype != torch.int32:
        raise ValueError("paged_gqa_decode_attention: positions must be [B] int32")
    if active is not None and (active.shape != (B,) or active.dtype != torch.bool):
        raise ValueError("paged_gqa_decode_attention: active must be [B] bool")
    if window is not None and window <= 0:
        raise ValueError(f"paged_gqa_decode_attention: window must be positive, got {window}")
    for t in (k_pool, v_pool, block_tables, positions) + ((active,) if active is not None else ()):
        if t.device != q.device:
            raise ValueError("paged_gqa_decode_attention: tensors on different devices")
    if not (k_pool.is_contiguous() and v_pool.is_contiguous()):
        raise ValueError("paged_gqa_decode_attention: pools must be contiguous")
    q = q.contiguous()
    block_tables = block_tables.contiguous()
    positions = positions.contiguous()
    active = active.contiguous() if active is not None else None
    out = torch.empty_like(q)
    kernels.paged_decode(
        q, k_pool, v_pool, out, block_tables, positions, active, window=window, fp8_dot=fp8_dot
    )
    return out


# ---------------------------------------------------------------------------
# Chunked decode over the legacy slot cache: Hopper kernel + plain twin
# ---------------------------------------------------------------------------


def chunked_gqa_decode_attention_plain(
    q: torch.Tensor,  # [B, H, 1, D]
    k: torch.Tensor,  # [B, KH, S, D] slot cache, q's dtype, bf16 or fp8
    v: torch.Tensor,
    positions: torch.Tensor,  # [B] int
    *,
    chunk: int,
    active: Optional[torch.Tensor] = None,  # [B] bool
    window: Optional[int] = None,
    fp8_dot: bool = False,
) -> torch.Tensor:
    """The JAX chunk loop in plain PyTorch: chunks [lo, hi) of the batch
    (hi from the largest active position, lo from the smallest with a
    window; inactive rows widen neither), each row's slice of the cache read
    in place, f32 online softmax with the finite ``NEG_INF`` mask.  The
    numerics are :func:`paged_gqa_decode_attention_plain`'s (the same loop):
    a narrower cache widened per chunk and P rounded to q's dtype, or with
    ``fp8_dot`` the query quantized to the cache's fp8 format and P rounded
    to it; ``l`` sums the unrounded f32 p.  ``hi`` is clamped to the row's
    chunk count, which the JAX loop leaves to ``dynamic_slice``'s clamp (a
    position past the cache, which no caller passes)."""
    B, H, _, D = q.shape
    acc, l = _chunked_decode_loop(q, k, v, positions, active, window, fp8_dot, chunk)
    out = (acc / torch.clamp(l, min=1e-30)).to(q.dtype)
    return out.reshape(B, H, 1, D)


def chunked_bf16_bound(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    positions: torch.Tensor,
    ref: torch.Tensor,
    *,
    chunk: int,
    active: Optional[torch.Tensor] = None,
    window: Optional[int] = None,
) -> torch.Tensor:
    """:func:`paged_bf16_bound` for the chunked read (the same kernels and
    rounding): ``2^-8 |ref| + 2^-8 A + 1e-4``, ``A`` the chunked read over
    ``|v|``."""
    acc, l = _chunked_decode_loop(q.float(), k.float(), v.float().abs(), positions, active,
                                  window, False, chunk)
    B, H, _, D = q.shape
    a = (acc / torch.clamp(l, min=1e-30)).reshape(B, H, 1, D)
    return 2.0 ** -8 * (ref.abs() + a) + 1e-4


def chunked_fp8_dot_bound(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    positions: torch.Tensor,
    ref: torch.Tensor,
    *,
    chunk: int,
    active: Optional[torch.Tensor] = None,
    window: Optional[int] = None,
) -> torch.Tensor:
    """:func:`paged_fp8_dot_bound` for the chunked in-dot read."""
    absv = v.float().abs().to(v.dtype)
    return _fp8_dot_bound(
        lambda **kw: _chunked_decode_loop(q, k, absv, positions, active, window, True, chunk,
                                          **kw),
        q, v.dtype, ref,
    )


def chunked_gqa_decode_attention(
    q: torch.Tensor,  # [B, H, 1, D]
    k: torch.Tensor,  # [B, KH, S, D] slot cache
    v: torch.Tensor,
    positions: torch.Tensor,  # [B] int32
    *,
    chunk: int,
    active: Optional[torch.Tensor] = None,  # [B] bool
    window: Optional[int] = None,
    fp8_dot: bool = False,
) -> torch.Tensor:
    """Chunked decode attention over the contiguous slot cache.  CPU tensors
    run the plain twin; CUDA tensors launch the contiguous form of
    ``csrc/paged_decode.cu`` (``kernels.chunked_decode``) or raise on what
    it does not take.  The cache may be q's dtype, bf16 under f32 queries,
    or fp8 (the dequant read, or the in-dot scheme with ``fp8_dot``)."""
    if q.device.type == "cpu":
        return chunked_gqa_decode_attention_plain(
            q, k, v, positions, chunk=chunk, active=active, window=window, fp8_dot=fp8_dot,
        )
    if q.device.type != "cuda":
        raise ValueError(f"chunked_gqa_decode_attention: unsupported device {q.device}")
    if fp8_dot:
        _check_fp8_dot(k.dtype, "chunked_gqa_decode_attention")
    B, H, Sq, D = q.shape
    if Sq != 1:
        raise ValueError(f"decode attention expects Sq=1 queries, got {Sq}")
    if k.dim() != 4 or k.shape != v.shape or k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"chunked_gqa_decode_attention: bad cache shapes {tuple(k.shape)} / {tuple(v.shape)}")
    KH, S = k.shape[1], k.shape[2]
    _check_chunk(S, chunk)
    if H % KH or H // KH not in (1, 2, 4, 8):
        raise ValueError(f"chunked decode kernel takes H/KH in 1, 2, 4, 8, got H={H} KH={KH}")
    if D not in (16, 32, 64, 128, 256):
        raise ValueError(f"chunked decode kernel takes head_dim 16, 32, 64, 128 or 256, got {D}")
    if D == 256 and H // KH > 4:
        raise ValueError(f"chunked decode kernel takes H/KH up to 4 at head_dim 256, got {H // KH}")
    if chunk % 4:
        raise ValueError(f"chunked decode kernel takes a chunk divisible by 4, got {chunk}")
    _check_pool_dtype("chunked decode", q, k, v)
    if positions.shape != (B,) or positions.dtype != torch.int32:
        raise ValueError("chunked_gqa_decode_attention: positions must be [B] int32")
    if active is not None and (active.shape != (B,) or active.dtype != torch.bool):
        raise ValueError("chunked_gqa_decode_attention: active must be [B] bool")
    if window is not None and window <= 0:
        raise ValueError(f"chunked_gqa_decode_attention: window must be positive, got {window}")
    for t in (k, v, positions) + ((active,) if active is not None else ()):
        if t.device != q.device:
            raise ValueError("chunked_gqa_decode_attention: tensors on different devices")
    if not (k.is_contiguous() and v.is_contiguous()):
        raise ValueError("chunked_gqa_decode_attention: the cache must be contiguous")
    q = q.contiguous()
    positions = positions.contiguous()
    active = active.contiguous() if active is not None else None
    out = torch.empty_like(q)
    kernels.chunked_decode(q, k, v, out, positions, active, chunk=chunk, window=window,
                           fp8_dot=fp8_dot)
    return out


# ---------------------------------------------------------------------------
# Paged tree attention (the speculative verify read): Hopper kernel + plain twin
# ---------------------------------------------------------------------------

def paged_tree_attention_plain(
    q: torch.Tensor,  # [B, H, T, D] — one query per speculation-tree node
    k_pool: torch.Tensor,  # [P, KH, page, D]
    v_pool: torch.Tensor,
    block_tables: torch.Tensor,  # [B, NB] int; entries >= P unallocated
    lengths: torch.Tensor,  # [B] int — verified prefix length per row
    tree_k: torch.Tensor,  # [B, KH, T, D] — the tree's freshly-projected keys
    tree_v: torch.Tensor,
    anc_mask: torch.Tensor,  # [T, T] bool — anc_mask[t, u]: u ancestor-or-self of t
    depths: torch.Tensor,  # [T] int node depths (root = 0)
    *,
    window: Optional[int] = None,
) -> torch.Tensor:
    """The JAX page loop in plain PyTorch: logical blocks [lo, hi) over the
    batch's longest prefix, one gathered page per row per step, f32 online
    softmax with the finite ``NEG_INF`` mask (keys below the row's length,
    and, with a window, above ``qpos - window`` for each node at ``qpos =
    lengths + depths``), probabilities rounded to q's dtype before
    P.V while ``l`` sums the unrounded ones; then the tree as the final
    chunk under the ancestor mask (and the window on the keys' positions
    ``lengths + depths``), probabilities rounded to ``q``'s dtype.  A pool
    of another dtype (bf16 under f32 queries, fp8) is read as the JAX
    function reads it: each page widened exactly to q's dtype, so P rounds
    to q's dtype there too; the tree's own K/V are in q's dtype."""
    B, H, T, D = q.shape
    P, KH, page, _ = k_pool.shape
    NB = block_tables.shape[1]
    G = H // KH
    scale = D ** -0.5
    dev = q.device
    qg = q.reshape(B, KH, G, T, D).float()
    lengths = lengths.long()
    depths = depths.long().to(dev)
    hi = min((int(lengths.max()) + page - 1) // page, NB)
    qpos = lengths[:, None] + depths[None, :]  # [B, T]
    lo = 0
    if window is not None:
        lo = min(max(int(lengths.min()) - window + 1, 0) // page, hi)
    m = torch.full((B, KH, G, T, 1), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((B, KH, G, T, 1), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, KH, G, T, D), dtype=torch.float32, device=dev)
    offs = torch.arange(page, device=dev)

    def update(m, l, acc, s, keep, v_blk, p_dtype):
        # s [B, KH, G, T, n], keep [B, T, n], v_blk [B, KH, n, D]
        s = torch.where(keep[:, None, None], s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.exp(s - m_new)
        alpha = torch.exp(m - m_new)
        l = alpha * l + p.sum(dim=-1, keepdim=True)
        acc = alpha * acc + torch.matmul(p.to(p_dtype).float(), v_blk[:, :, None])
        return m_new, l, acc

    for ci in range(lo, hi):
        phys = block_tables[:, ci].long().clamp(0, P - 1)
        k_blk = k_pool[phys].float()  # [B, KH, page, D]
        v_blk = v_pool[phys].float()
        s = torch.matmul(qg, k_blk[:, :, None].transpose(-1, -2)) * scale  # [B,KH,G,T,page]
        kpos = ci * page + offs
        keep = (kpos[None, None, :] < lengths[:, None, None]).expand(B, T, page)
        if window is not None:
            keep = keep & (kpos[None, None, :] > qpos[:, :, None] - window)
        m, l, acc = update(m, l, acc, s, keep, v_blk, q.dtype)
    tk = tree_k.to(q.dtype).float()
    tv = tree_v.to(q.dtype).float()
    s = torch.matmul(qg, tk[:, :, None].transpose(-1, -2)) * scale  # [B, KH, G, T, T]
    keep = anc_mask.to(dev)[None].expand(B, T, T)
    if window is not None:
        keep = keep & (qpos[:, None, :] > qpos[:, :, None] - window)
    _, l, acc = update(m, l, acc, s, keep, tv, q.dtype)
    out = (acc / torch.clamp(l, min=1e-30)).to(q.dtype)
    return out.reshape(B, H, T, D)


def paged_tree_bf16_bound(
    q: torch.Tensor,
    k_pool: torch.Tensor,
    v_pool: torch.Tensor,
    block_tables: torch.Tensor,
    lengths: torch.Tensor,
    tree_k: torch.Tensor,
    tree_v: torch.Tensor,
    anc_mask: torch.Tensor,
    depths: torch.Tensor,
    ref: torch.Tensor,
    *,
    window: Optional[int] = None,
) -> torch.Tensor:
    """Per-element bound on ``|out - ref|`` for a bf16 paged tree output
    against the f32 plain twin ``ref`` on the same inputs:
    ``2^-8 |ref| + 2^-8 A + 1e-4`` with ``A`` the same tree attention over
    ``|v|`` (pool and tree) — :func:`paged_bf16_bound`'s argument: the
    kernel, like the JAX function, rounds each probability to bf16 before
    P.V (at most 2^-8 A while the normaliser sums the unrounded f32 p) and
    rounds the output (2^-8 |out|); 1e-4 covers the f32 summation order."""
    a = paged_tree_attention_plain(
        q.float(), k_pool.float(), v_pool.float().abs(), block_tables, lengths,
        tree_k.float(), tree_v.float().abs(), anc_mask, depths, window=window,
    )
    return 2.0 ** -8 * (ref.abs() + a) + 1e-4


def paged_tree_attention(
    q: torch.Tensor,  # [B, H, T, D]
    k_pool: torch.Tensor,  # [P, KH, page, D]
    v_pool: torch.Tensor,
    block_tables: torch.Tensor,  # [B, NB] int32
    lengths: torch.Tensor,  # [B] int32
    tree_k: torch.Tensor,  # [B, KH, T, D]
    tree_v: torch.Tensor,
    anc_mask: torch.Tensor,  # [T, T] bool
    depths: torch.Tensor,  # [T] int32
    *,
    window: Optional[int] = None,
) -> torch.Tensor:
    """Paged tree attention.  CPU tensors run the plain twin; CUDA tensors
    launch ``csrc/paged_tree.cu`` or raise on what it does not take.  The
    pools may be q's dtype, bf16 under f32 queries, or fp8 (the dequant
    read; the JAX function has no in-dot scheme here)."""
    if q.device.type == "cpu":
        return paged_tree_attention_plain(
            q, k_pool, v_pool, block_tables, lengths, tree_k, tree_v, anc_mask, depths,
            window=window,
        )
    if q.device.type != "cuda":
        raise ValueError(f"paged_tree_attention: unsupported device {q.device}")
    B, H, T, D = q.shape
    if k_pool.dim() != 4 or k_pool.shape != v_pool.shape or k_pool.shape[3] != D:
        raise ValueError(f"paged_tree_attention: bad pool shapes {tuple(k_pool.shape)} / {tuple(v_pool.shape)}")
    KH = k_pool.shape[1]
    if H % KH:
        raise ValueError(f"paged_tree_attention: KV heads {KH} must divide query heads {H}")
    if D not in (16, 32, 64, 128, 256):
        raise ValueError(f"paged tree kernel takes head_dim 16, 32, 64, 128 or 256, got {D}")
    if T < 1:
        raise ValueError(f"paged tree kernel takes at least one tree node, got {T}")
    _check_pool_dtype("paged tree", q, k_pool, v_pool)
    if tuple(tree_k.shape) != (B, KH, T, D) or tree_v.shape != tree_k.shape:
        raise ValueError(f"paged_tree_attention: tree K/V must be [{B}, {KH}, {T}, {D}], got {tuple(tree_k.shape)}")
    if block_tables.dim() != 2 or block_tables.shape[0] != B or block_tables.dtype != torch.int32:
        raise ValueError("paged_tree_attention: block_tables must be [B, NB] int32")
    if lengths.shape != (B,) or lengths.dtype != torch.int32:
        raise ValueError("paged_tree_attention: lengths must be [B] int32")
    if tuple(anc_mask.shape) != (T, T) or anc_mask.dtype != torch.bool:
        raise ValueError(f"paged_tree_attention: anc_mask must be [{T}, {T}] bool")
    if depths.shape != (T,) or depths.dtype != torch.int32:
        raise ValueError(f"paged_tree_attention: depths must be [{T}] int32")
    if window is not None and window <= 0:
        raise ValueError(f"paged_tree_attention: window must be positive, got {window}")
    for t in (k_pool, v_pool, block_tables, lengths, tree_k, tree_v, anc_mask, depths):
        if t.device != q.device:
            raise ValueError("paged_tree_attention: tensors on different devices")
    if not (k_pool.is_contiguous() and v_pool.is_contiguous()):
        raise ValueError("paged_tree_attention: pools must be contiguous")
    q, tree_k, tree_v = (t.to(q.dtype).contiguous() for t in (q, tree_k, tree_v))
    out = torch.empty_like(q)
    kernels.paged_tree(
        q, k_pool, v_pool, out, block_tables.contiguous(), lengths.contiguous(), tree_k,
        tree_v, anc_mask.contiguous(), depths.contiguous(), window=window,
    )
    return out
