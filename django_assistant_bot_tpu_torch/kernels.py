"""Build, bind and launch the hand-written Hopper kernels in ``csrc/``.

Each ``csrc/<name>.cu`` exports one C entry point and is compiled on first
use by its own ``nvcc`` process (all sources in parallel) into a shared
library under ``build/`` beside this file, named by a hash of the source and
the flags, so an edited source rebuilds and an unchanged one is reused.  The
libraries are loaded with ``ctypes``; every pointer (and the stream) is
passed as ``c_void_p``.  A kernel launches on ``torch.cuda.current_stream()``,
allocates nothing (the launch functions allocate outputs and scratch with
``torch.empty``) and
returns ``cudaGetLastError()``, which :func:`_check` turns into an exception.

``LAUNCHES`` counts launches per kernel: the launch functions below add one
each time they launch, and nowhere else, so a run can show that its main
path went through the kernels (:func:`reset_counts`, :func:`launch_counts`).
A call made while a CUDA graph is being captured launches nothing: it is
recorded into the graph, and the launches a graph holds are counted each
time the graph is replayed (:class:`GraphLaunches`).  A launch function
called during a capture outside :func:`record_graph_launches` raises, so no
replayed kernel goes uncounted.

Nothing here touches CUDA, ``nvcc`` or the build directory at import time.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import hashlib
import math
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import Dict, NamedTuple, Optional, Sequence

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# kernel name -> (source file stem, C symbol)
KERNELS = {
    "flash_prefill": ("flash_prefill", "dabt_flash_prefill"),
    "paged_decode": ("paged_decode", "dabt_paged_decode"),
    "knn_topk": ("knn_topk", "dabt_knn_topk"),
    "qgemm": ("qgemm", "dabt_qgemm"),
    "sample": ("sample", "dabt_sample"),
    "ann_adc": ("ann_adc", "dabt_ann_adc"),
    "ann_rerank": ("ann_rerank", "dabt_ann_rerank"),
    # the MoE routing source holds two kernels, an entry each
    "moe_route": ("moe_route", "dabt_moe_route"),
    "moe_combine": ("moe_route", "dabt_moe_combine"),
    "moe_gemm": ("moe_gemm", "dabt_moe_gemm"),
    "paged_tree": ("paged_tree", "dabt_paged_tree"),
    # the paged decode source's contiguous form: the legacy slot cache read
    # in chunks, with no block table
    "chunked_decode": ("paged_decode", "dabt_chunked_decode"),
    "paged_prefill": ("paged_prefill", "dabt_paged_prefill"),
}

LAUNCHES: Dict[str, int] = {name: 0 for name in KERNELS}

# nvcc's stderr per source stem from the last build in this process (ptxas
# register / shared-memory report); empty for a library reused from disk
BUILD_LOG: Dict[str, str] = {}

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# page-pool storage formats of the paged kernels (csrc/paged_decode.cu,
# paged_tree.cu): f32 and bf16 as _DTYPE_CODE, then the two fp8 formats
_KV_CODE = {**_DTYPE_CODE, torch.float8_e4m3fn: 2, torch.float8_e5m2: 3}
_KV_NAME = {torch.float32: "f32", torch.bfloat16: "bf16", torch.float8_e4m3fn: "e4m3",
            torch.float8_e5m2: "e5m2"}

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = {
    # q, k, v, o, dtype, B, H, KH, Sq, Sk, D, causal, window, stream
    "flash_prefill": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    # q, k_pool, v_pool, out, block_tables, positions, active, scratch,
    # scratch_floats, counters, mma, dtype, kv format, in-dot, B, H, KH, P,
    # page, NB, D, window, stream
    "paged_decode": [_P] * 8 + [ctypes.c_longlong, _P] + [_I] * 12 + [_P],
    # index, queries, valid, out_scores, out_ids, scratch, cand, N, D, Q, k,
    # cap, stream
    "knn_topk": [_P] * 7 + [_I] * 4 + [ctypes.c_longlong, _P, _I, _P],
    # x, w, scale, y, scratch, counters, dtype, bits, M, N, K, group, mt,
    # warps_m, ksplit, kchunk, stream
    "qgemm": [_P] * 6 + [_I] * 10 + [_P],
    # logits, temperature, top_p, gumbel, allowed, next_state, state, jmask,
    # ids, state_out, gmax, counters, dtype, B, V, k, splits, stream
    "sample": [_P] * 12 + [_I] * 5 + [_P],
    # codes, lvalid, rowpos, fill, top_ci, top_c, lut, cand, counters,
    # out_scores, out_pos, nlist, L, m, Q, P, S, blocks, chunk, cap, top_ci's
    # and top_c's row strides, the LUT's query and subspace strides, stream
    "ann_adc": [_P] * 11 + [_I] * 13 + [_P],
    # tier, rvalid, q, sl_scores, sl_pos, out_scores, out_pos, N, D, Q, S, k,
    # stream
    "ann_rerank": [_P] * 7 + [_I] * 5 + [_P],
    # x, router, tok_slot, tok_gate, slot_tok, fill, scratch, counter, dtype,
    # T, E, X, K, C, xmax, splits, vec_x, vec_r, stream
    "moe_route": [_P] * 8 + [_I] * 10 + [_P],
    # tok_slot, tok_gate, ye, out, dtype, T, E, K, vec, stream
    "moe_combine": [_P] * 4 + [_I] * 5 + [_P],
    # a, slot_tok, fill, w0, w1, out, scratch, counters, rows, dtype,
    # epilogue, route, X, C, K, N, ksplit, kchunk, tile_n, tile_m, stream
    "moe_gemm": [_P] * 9 + [_I] * 11 + [_P],
    # q, k_pool, v_pool, block_tables, lengths, tree_k, tree_v, anc, depths,
    # out, scratch, scratch_floats, counters, mma, dtype, kv format, B, H, KH,
    # T, P, page, NB, D, window, blocks, warps, min_items, stream
    "paged_tree": [_P] * 11 + [ctypes.c_longlong, _P] + [_I] * 15 + [_P],
    # q, k_cache, v_cache, out, positions, active, scratch, scratch_floats,
    # counters, mma, dtype, kv format, in-dot, B, H, KH, S, chunk, D,
    # window, stream
    "chunked_decode": [_P] * 7 + [ctypes.c_longlong, _P] + [_I] * 11 + [_P],
    # q, k_chunk, v_chunk, k_pool, v_pool, block_tables, starts, out, mma,
    # dtype, kv format, B, H, KH, C, P, page, NB, D, window, then the element
    # strides (batch, head, row) of q, of the chunk's K/V and of out, stream
    "paged_prefill": [_P] * 8 + [_I] * 12 + [ctypes.c_longlong] * 9 + [_P],
}
# further C symbols of a library: name -> (argtypes, restype)
_EXTRA_SYMBOLS = {
    "paged_decode": {
        # mma, kv format, B, H, KH, page, NB, D -> f32 scratch floats, -1 if
        # not taken
        "dabt_paged_decode_scratch": ([_I] * 8, ctypes.c_longlong),
    },
    "qgemm": {
        # x, w0-w2, scale0-scale2, y0-y2, n0-n2, members, bits, M, K, group,
        # kmajor, sms, scratch, counters, stream
        "dabt_qgemm_stream": ([_P] * 10 + [_I] * 10 + [_P] * 3, ctypes.c_int),
        # x, w, scale, y, scratch, counters, dtype, bits, M, N, K, group,
        # kmajor, sms, stream
        "dabt_qgemm_generic": ([_P] * 6 + [_I] * 8 + [_P], ctypes.c_int),
    },
}

# bf16 head dims of the tensor-core paged decode kernel; the CUDA-core split
# and combine kernels take f32, the other head dims, and bf16 inputs off
# 16-byte boundaries
PAGED_MMA_HEAD_DIMS = (64, 128)
# the most keys a knn_topk select block sorts in shared memory (SORT_CAP in
# csrc/knn_topk.cu); a larger k sorts in a global buffer the caller gives
KNN_SORT_CAP = 16384

# the pool read of each paged launch: "native" (the pool in q's dtype),
# "<format>/dequant" (a bf16 or fp8 pool widened to q's dtype in the kernel)
# or "<format>/in_dot" (the fp8 in-dot scheme)
PAGED_READS = ("native", "bf16/dequant", "e4m3/dequant", "e5m2/dequant", "e4m3/in_dot",
               "e5m2/in_dot")
# paged decode launches by route and read, "<route>:<read>": the route "mma"
# (the tensor-core kernel) or "cuda_core" (split + combine); counted beside
# LAUNCHES, so a run can show which kernel and read its paged calls took
# (:func:`by_route` sums them per route)
PAGED_FORMS: Dict[str, int] = {f"{r}:{m}": 0 for r in ("mma", "cuda_core") for m in PAGED_READS}
# chunked decode launches (the legacy slot cache) by route and read, keyed
# as PAGED_FORMS: the same kernels and routes over the contiguous cache
CHUNKED_FORMS: Dict[str, int] = dict.fromkeys(PAGED_FORMS, 0)

# qgemm launches by weight format, counted beside LAUNCHES like PAGED_FORMS
QGEMM_FORMATS: Dict[str, int] = {"int8": 0, "int4": 0}
# and by route (:func:`qgemm_route`): "stream" (the decode kernel, M <= 64,
# one launch for up to three members; also the tied int8 head), "mma" (the
# direct-load kernel: where TMA cannot take N or a pointer), "wgmma" (the
# prefill kernel), "cuda_core" (f32, the generic kernel's CUDA-core form),
# "generic" (the generic kernel on the shapes no other route takes)
QGEMM_ROUTES: Dict[str, int] = {"stream": 0, "mma": 0, "wgmma": 0, "cuda_core": 0, "generic": 0}
# the grouped expert GEMM's launches by route and epilogue,
# "<route>:<epilogue>", as PAGED_FORMS: the route (:func:`moe_gemm_plan`)
# "wgmma" (the prefill kernel), "mma" (the mma.sync kernel: decode and
# short prefills), "mma_split" (the same kernel with down's K split:
# decode) or "cuda_core" (f32 and the shapes the tensor cores' kernels do
# not take); the epilogue "gate_up" or "down"
MOE_GEMM_ROUTES = ("wgmma", "mma", "mma_split", "cuda_core")
MOE_GEMM_FORMS: Dict[str, int] = {f"{r}:{e}": 0 for r in MOE_GEMM_ROUTES
                                  for e in ("gate_up", "down")}
# K and N of the tensor-core routes are multiples of MOE_GEMM_TILE, the wgmma
# route's N of MOE_WGMMA_TILE_N (gate/up's feature tile).  A wgmma block of
# down's 128 features takes one of MOE_WGMMA_TILES_M slots (two or three
# consumer warpgroups of 64), the one that computes the fewest rows over C
# (ties to the smaller); other wgmma blocks take the first;
# down on wgmma takes 2 MOE_WGMMA_TILE_N features a block while that leaves
# at least MOE_WIDE_WAVES waves of blocks (one an SM), every slot taken as
# live: at Mixtral's widths the wide blocks took 0.88x the narrow ones' time
# at C 320, 0.76x at 640, 1.01x at 160 (``tools/moe_gemm_ab.py --routes
# wgmma,wgmma_wide``, PERF.md section 6)
MOE_GEMM_TILE = 64
MOE_WGMMA_TILE_N = 128
MOE_WGMMA_TILES_M = (128, 192)
MOE_WIDE_WAVES = 2
# the fewest slots an expert (C) that take the wgmma route, both epilogues.
# At Mixtral 8x7B's widths on an H100 SXM (``tools/moe_gemm_ab.py --tokens
# 51,76,102,128,153,179,204,230,256 --routes mma_plan,wgmma`` and in the
# other order, PERF.md section 6) wgmma took less time than the plan's form
# below the threshold at every C from 16 to 80, gate/up (mma) and down
# (mma_split) alike.  C 16 is the smallest capacity past the floor of 8, so
# only a decode tick's C 8 stays on the mma.sync kernel: there down's
# mma_split took 0.95x wgmma's time (gate/up's mma 1.008x)
MOE_WGMMA_MIN_C = 16
# down's K split on the mma kernel aims at this many waves of blocks over
# the card (three blocks an SM), each split at least MOE_SPLIT_MIN_K rows of
# K, at most MOE_MAX_SPLIT splits and MOE_PARTIAL_FLOATS f32 partials (64
# MiB); measured with ``tools/moe_gemm_ab.py --splits`` (PERF.md section 6)
MOE_MMA_WAVES = 4
MOE_SPLIT_MIN_K = 1024
MOE_MAX_SPLIT = 4
MOE_PARTIAL_FLOATS = 1 << 24
# the routing kernel's launches by form (:func:`moe_route_plan`): "split"
# (one tile of tokens, E split over blocks: the decode tick), "block" (one
# tile, one block) or "tiles" (token tiles, the last block scans the
# capacity)
MOE_ROUTE_FORMS: Dict[str, int] = {"block": 0, "split": 0, "tiles": 0}
# the routing kernel (csrc/moe_route.cu): the partial logits a thread keeps
# (tile tokens x experts), the expert widths a tile holds (64 / that many
# tokens a tile), and the blocks E is split over at one tile of tokens: at
# Mixtral's widths, T 8, 1 / 2 / 4 / 8 blocks took 0.0082 / 0.0073 / 0.0073
# / 0.0075 ms on an H100 SXM (``tools/moe_route_ab.py --splits``, PERF.md
# section 6)
MOE_ROUTE_VALUES = 64
MOE_ROUTE_XMAX = (8, 16, 32)
MOE_ROUTE_SPLITS = 4
# paged tree attention launches by route and read, as PAGED_FORMS: "mma"
# (the tensor-core kernel: bf16 at PAGED_MMA_HEAD_DIMS on 16-byte boundaries)
# or "cuda_core" (the tree read has no in-dot scheme)
PAGED_TREE_FORMS: Dict[str, int] = {f"{r}:{m}": 0 for r in ("mma", "cuda_core")
                                    for m in PAGED_READS if "in_dot" not in m}
# the tensor-core tree kernel's persistent grid (csrc/paged_tree.cu): the
# most warps a block (two warpgroups of 64 query rows), the blocks its
# __launch_bounds__ keeps on an SM, the least items a block takes, and what
# an item holds at most: a chunk of prefix keys, or a tile of tree nodes
PAGED_TREE_MAX_WARPS = 8
PAGED_TREE_BLOCKS_PER_SM = 1
PAGED_TREE_MIN_ITEMS = 4
PAGED_TREE_CHUNK = 64
PAGED_TREE_NODES = 32
# paged prefill launches by route and read, as PAGED_TREE_FORMS: "mma" (the
# tensor-core kernel: bf16 at PAGED_MMA_HEAD_DIMS) or "cuda_core"
PAGED_PREFILL_FORMS: Dict[str, int] = dict.fromkeys(PAGED_TREE_FORMS, 0)
# a kernel's launches by kind, for the kernels that count them
# ("<kernel>_route": a second kind, by route)
SUBCOUNTS: Dict[str, Dict[str, int]] = {
    "paged_decode": PAGED_FORMS, "qgemm": QGEMM_FORMATS, "qgemm_route": QGEMM_ROUTES,
    "moe_route": MOE_ROUTE_FORMS, "moe_gemm": MOE_GEMM_FORMS,
    "paged_tree": PAGED_TREE_FORMS, "chunked_decode": CHUNKED_FORMS,
    "paged_prefill": PAGED_PREFILL_FORMS,
}
# output columns of a direct-load qgemm block (TILE_N in csrc/qgemm.cu)
QGEMM_TILE_N = 64
# the wgmma qgemm plan's cost model (qgemm_plan), in microseconds: a wave of
# blocks takes QGEMM_WAVE_US plus QGEMM_ROW_US[bits] per row of K, and a
# split adds QGEMM_PARTIAL_US per f32 partial written and summed; a least-
# squares fit to ``tools/qgemm_ab.py --splits 1,2,3,4,8`` (the four
# Llama-3-8B projections at M = 512) on an H100 SXM (PERF.md section 6)
QGEMM_ROW_US = {8: 0.0067, 4: 0.0131}
QGEMM_WAVE_US = 3.5
QGEMM_PARTIAL_US = 0.0000033
# the most f32 partials (16 MiB) a split wgmma qgemm call writes
QGEMM_PARTIAL_FLOATS = 1 << 22
# the stream route (qgemm_stream_kernel): rows of K a stage (and a granule
# of int8 work), output columns a tile (two 128-column TMA boxes), the most
# rows of x a launch, and the most f32 partials (32 MiB) its scratch holds
QGEMM_STREAM_KT = 64
QGEMM_STREAM_BN = 256
QGEMM_STREAM_MAX_M = 64
QGEMM_STREAM_PARTIAL_FLOATS = 1 << 23
# the generic route (qgemm_generic_kernel): rows of K a stage (a granule of
# int8 work), output columns a tile, rows of x a tile at most
QGEMM_GENERIC_KT = 64
QGEMM_GENERIC_BN = 256
QGEMM_GENERIC_BM = 64
# a generic launch runs two blocks an SM up to 16 rows of x where each
# still takes QGEMM_GENERIC_DEEP granules, else one (gn_blocks_for)
QGEMM_GENERIC_DEEP = 8
# granules a generic block takes at least (GN_MIN_GRANULES): a small call's
# tiles are cut between fewer blocks, fewer partials to sum
QGEMM_GENERIC_MIN_GRANULES = 2

# split-K scratch per (kernel, device, stream): (f32 partials, int32
# counters); the counters start at zero and every call leaves them at zero
# (a graph's owner keeps its own store, see private_paged_scratch)
_split_scratch: Dict[tuple, tuple] = {}
# the sampler (csrc/sample.cu): the largest top-k it takes, and the vocab
# from which its top-k is hierarchical (ops/sampling.py's)
SAMPLE_MAX_K = 256
SAMPLE_HIER_MIN_VOCAB = 16_384
# the ADC scan + shortlist (csrc/ann_adc.cu): threads a block, slots a tile
# (a warp's), the most LUT subspaces staged at once, the least tiles a block
# takes (two a warp), the dynamic shared memory a block may take (MAX_SMEM),
# an SM's shared memory and the kernel's static arrays, about
ANN_ADC_THREADS = 512
ANN_ADC_TILE = 32
ANN_ADC_LUT_CHUNK = 192
ANN_ADC_MIN_TILES = 32
ANN_ADC_SMEM = 222 * 1024
ANN_ADC_SM_SMEM = 228 * 1024
ANN_ADC_STATIC = 5 * 1024

# f32 scratch floats per (device, route, shapes), as the library reports them
_paged_need: Dict[tuple, int] = {}


class GraphLaunches:
    """The kernel launches recorded into one CUDA graph at its capture;
    :meth:`replayed` adds them to ``LAUNCHES`` and ``SUBCOUNTS`` once per
    replay of the graph."""

    def __init__(self):
        self.launches: Dict[str, int] = {name: 0 for name in KERNELS}
        self.sub = {name: dict.fromkeys(counts, 0) for name, counts in SUBCOUNTS.items()}

    def replayed(self) -> None:
        for name, n in self.launches.items():
            LAUNCHES[name] += n
        for name, counts in self.sub.items():
            for kind, n in counts.items():
                SUBCOUNTS[name][kind] += n


# per thread: the GraphLaunches a capture records into, and a private
# paged-scratch store that replaces the shared one
_tls = threading.local()


@contextlib.contextmanager
def record_graph_launches():
    """Record the launches this thread captures into a graph (yields the
    :class:`GraphLaunches` they go to) instead of counting them."""
    rec = GraphLaunches()
    _tls.rec = rec
    try:
        yield rec
    finally:
        _tls.rec = None


@contextlib.contextmanager
def private_paged_scratch(store: Dict[tuple, tuple]):
    """Give this thread's paged decode and qgemm calls the scratch in
    ``store`` (keyed like the shared cache) instead of the shared cache.  A
    CUDA graph's owner warms up and captures inside it, so the scratch and
    counters the graph holds are its own: no eager call, on any stream, uses
    them."""
    _tls.scratch = store
    try:
        yield store
    finally:
        _tls.scratch = None


def _count(name: str, kind: Optional[str] = None, route: Optional[str] = None) -> None:
    """One launch of ``name`` (and of its ``kind`` in ``SUBCOUNTS[name]``,
    its ``route`` in ``SUBCOUNTS[name + "_route"]``): counted now, or
    recorded for the replays when this thread is capturing a graph."""
    launches, subs = LAUNCHES, SUBCOUNTS
    rec = getattr(_tls, "rec", None)
    if rec is not None:
        launches, subs = rec.launches, rec.sub
    elif torch.cuda.is_current_stream_capturing():
        raise RuntimeError(
            f"{name} captured into a CUDA graph outside record_graph_launches(): "
            "its replays would go uncounted"
        )
    launches[name] += 1
    if kind is not None:
        subs[name][kind] += 1
    if route is not None:
        subs[name + "_route"][route] += 1


def reset_counts() -> None:
    for counts in (LAUNCHES, *SUBCOUNTS.values()):
        for key in counts:
            counts[key] = 0


def launch_counts() -> Dict[str, int]:
    return dict(LAUNCHES)


def by_route(forms: Dict[str, int]) -> Dict[str, int]:
    """Launches per route of a count keyed "<route>:<kind>"
    (``PAGED_FORMS``, ``CHUNKED_FORMS``, ``PAGED_TREE_FORMS``: routes
    "mma" and "cuda_core"; ``MOE_GEMM_FORMS``: ``MOE_GEMM_ROUTES``)."""
    routes: Dict[str, int] = {}
    for form, n in forms.items():
        route = form.split(":", 1)[0]
        routes[route] = routes.get(route, 0) + n
    return routes


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the Hopper kernels are built with the CUDA toolkit")


def _lib_path(stem: str) -> Path:
    # the shared headers are part of every source's digest
    src = b"".join(f.read_bytes() for f in [CSRC / f"{stem}.cu", *sorted(CSRC.glob("*.cuh"))])
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{stem}-{digest}.so"


def lib_path(name: str) -> Path:
    """The shared library that :func:`build` makes for kernel ``name``."""
    return _lib_path(KERNELS[name][0])


def build(names: Optional[Sequence[str]] = None) -> float:
    """Compile (if needed) and load the named kernels (default: all), one
    ``nvcc`` per source, all started together.  Returns the seconds spent."""
    t0 = time.perf_counter()
    names = list(names or KERNELS)
    with _lock:
        todo = [n for n in names if n not in _libs]
        procs = {}
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        for stem in dict.fromkeys(KERNELS[n][0] for n in todo):
            out = _lib_path(stem)
            if out.exists():
                continue
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{stem}.cu")]
            procs[stem] = (
                subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True),
                tmp,
                out,
            )
        failed = []
        for stem, (proc, tmp, out) in procs.items():
            stdout, stderr = proc.communicate()
            BUILD_LOG[stem] = stdout + stderr
            if proc.returncode != 0:
                failed.append(f"{stem}: nvcc exited {proc.returncode}\n{stderr}")
                os.unlink(tmp)
            else:
                os.replace(tmp, out)  # atomic: a concurrent build sees all or nothing
        if failed:
            raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
        for name in todo:
            stem, symbol = KERNELS[name]
            lib = ctypes.CDLL(str(_lib_path(stem)))
            fn = getattr(lib, symbol)
            fn.argtypes = _ARGTYPES[name]
            fn.restype = ctypes.c_int
            for extra, (argtypes, restype) in _EXTRA_SYMBOLS.get(name, {}).items():
                getattr(lib, extra).argtypes = argtypes
                getattr(lib, extra).restype = restype
            _libs[name] = lib
    return time.perf_counter() - t0


def loaded() -> frozenset:
    """The kernels whose libraries this process has built or loaded."""
    return frozenset(_libs)


def _fn(name: str):
    if name not in _libs:
        build([name])
    return getattr(_libs[name], KERNELS[name][1])


def _check(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed with cudaError {err}")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def dtype_code(dtype: torch.dtype) -> int:
    if dtype not in _DTYPE_CODE:
        raise TypeError(f"kernels take float32 or bfloat16 tensors, got {dtype}")
    return _DTYPE_CODE[dtype]


def flash_prefill(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor,
    *, causal: bool, window: Optional[int],
) -> None:
    """Launch the flash prefill kernel; the caller validated the arguments."""
    B, H, Sq, D = q.shape
    KH, Sk = k.shape[1], k.shape[2]
    fn = _fn("flash_prefill")
    with torch.cuda.device(q.device):
        err = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            dtype_code(q.dtype), B, H, KH, Sq, Sk, D, int(causal),
            int(window) if window is not None else 0, _stream(q),
        )
    _count("flash_prefill")
    _check("flash_prefill", err)


def paged_prefill(
    q: torch.Tensor, k_chunk: torch.Tensor, v_chunk: torch.Tensor, k_pool: torch.Tensor,
    v_pool: torch.Tensor, block_tables: torch.Tensor, starts: torch.Tensor, out: torch.Tensor,
    *, mma: bool, window: Optional[int], n_pages: int,
) -> None:
    """Launch the paged prefill kernel; the caller validated the arguments
    (q, the chunk's K/V and out are read and written through their strides,
    block_tables int32, starts int64; pages ``[0, n_pages)`` of the pools
    are read, a block-table entry clamped into them).  ``mma`` takes the
    tensor-core kernel (bf16 at ``PAGED_MMA_HEAD_DIMS``, rows on 16-byte
    boundaries), else the CUDA-core one; ``PAGED_PREFILL_FORMS`` counts the
    route and the pool read (:func:`paged_read`)."""
    B, H, C, D = q.shape
    _, KH, page, _ = k_pool.shape
    NB = block_tables.shape[1]
    fn = _fn("paged_prefill")
    with torch.cuda.device(q.device):
        err = fn(
            q.data_ptr(), k_chunk.data_ptr(), v_chunk.data_ptr(), k_pool.data_ptr(),
            v_pool.data_ptr(), block_tables.data_ptr(), starts.data_ptr(), out.data_ptr(),
            int(mma), dtype_code(q.dtype), _KV_CODE[k_pool.dtype], B, H, KH, C, n_pages, page,
            NB, D, int(window) if window is not None else 0, *q.stride()[:3],
            *k_chunk.stride()[:3], *out.stride()[:3], _stream(q),
        )
    route = "mma" if mma else "cuda_core"
    _count("paged_prefill", f"{route}:{paged_read(q.dtype, k_pool.dtype)}")
    _check("paged_prefill", err)


def paged_read(q_dtype: torch.dtype, kv_dtype: torch.dtype, fp8_dot: bool = False) -> str:
    """The pool read of a paged launch, as ``PAGED_READS`` names it."""
    if kv_dtype == q_dtype:
        return "native"
    return f"{_KV_NAME[kv_dtype]}/{'in_dot' if fp8_dot else 'dequant'}"


def paged_scratch_floats(device: torch.device, shapes: tuple) -> int:
    """The f32 scratch floats a paged decode call needs on ``device``, as the
    library reports them for ``shapes`` = (mma, kv format, B, H, KH, page,
    NB, D) (cached per device and shapes; the format's code as
    ``_KV_CODE``)."""
    key = (device.index, *shapes)
    need = _paged_need.get(key)
    if need is None:
        _fn("paged_decode")  # builds and loads the library if needed
        with torch.cuda.device(device):
            need = _libs["paged_decode"].dabt_paged_decode_scratch(*shapes)
        if need < 0:
            raise RuntimeError(
                f"paged decode kernel does not take (mma, kv format, B, H, KH, page, NB, D) = "
                f"{shapes}"
            )
        _paged_need[key] = need
    return need


def _scratch_buffers(kernel: str, device: torch.device, stream: int, need: int, n_rows: int):
    """The scratch of ``kernel`` (paged or chunked decode, qgemm, the grouped
    expert GEMM, the MoE routing or the ADC shortlist) on (device,
    stream), grown to ``need`` f32 floats and ``n_rows`` counters.  A graph
    captures the buffers' addresses, so they must exist before its capture
    (a warm-up call on the capture stream makes them): growing them during a
    capture would put graph-pool memory in this cache, where eager calls
    would find it, and raises instead."""
    key = (kernel, device.index, stream)
    store = getattr(_tls, "scratch", None)
    if store is None:
        store = _split_scratch
    part, counters = store.get(key, (None, None))
    grow_part = part is None or part.numel() < need
    grow_counters = counters is None or counters.numel() < n_rows
    if (grow_part or grow_counters) and torch.cuda.is_current_stream_capturing():
        raise RuntimeError(
            f"{kernel} scratch must be allocated before a CUDA graph capture: "
            "warm the captured calls up on the capture stream first"
        )
    if grow_part:
        part = torch.empty(need, dtype=torch.float32, device=device)
    if grow_counters:
        counters = torch.zeros(n_rows, dtype=torch.int32, device=device)
    store[key] = (part, counters)
    return part, counters


def paged_decode(
    q: torch.Tensor, k_pool: torch.Tensor, v_pool: torch.Tensor, out: torch.Tensor,
    block_tables: torch.Tensor, positions: torch.Tensor, active: Optional[torch.Tensor],
    *, window: Optional[int], fp8_dot: bool = False,
) -> None:
    """Launch the paged decode kernel; the caller validated the arguments.
    bf16 queries at ``PAGED_MMA_HEAD_DIMS`` with q and the pools on 16-byte
    boundaries take the tensor-core kernel (over a bf16 or fp8 pool),
    everything else the CUDA-core split and combine kernels;
    ``PAGED_FORMS`` counts the route and the pool read (:func:`paged_read`).
    The f32 scratch (partials; its size is the library's answer for the
    shapes) and the counters, one per (slot, KV head), are kept per device
    and stream, not allocated per call."""
    B, H, _, D = q.shape
    P, KH, page, _ = k_pool.shape
    NB = block_tables.shape[1]
    mma = (q.dtype == torch.bfloat16 and D in PAGED_MMA_HEAD_DIMS
           and not any(t.data_ptr() % 16 for t in (q, k_pool, v_pool)))
    kfmt = _KV_CODE[k_pool.dtype]
    stream = _stream(q)
    fn = _fn("paged_decode")
    with torch.cuda.device(q.device):
        shapes = (int(mma), kfmt, B, H, KH, page, NB, D)
        scratch, counters = _scratch_buffers(
            "paged_decode", q.device, stream, paged_scratch_floats(q.device, shapes), B * KH
        )
        err = fn(
            q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), out.data_ptr(),
            block_tables.data_ptr(), positions.data_ptr(),
            active.data_ptr() if active is not None else None,
            scratch.data_ptr(), scratch.numel(), counters.data_ptr(), int(mma),
            dtype_code(q.dtype), kfmt, int(fp8_dot), B, H, KH, P, page, NB, D,
            int(window) if window is not None else 0, stream,
        )
    route = "mma" if mma else "cuda_core"
    _count("paged_decode", f"{route}:{paged_read(q.dtype, k_pool.dtype, fp8_dot)}")
    _check("paged_decode", err)


def chunked_decode(
    q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor, out: torch.Tensor,
    positions: torch.Tensor, active: Optional[torch.Tensor],
    *, chunk: int, window: Optional[int], fp8_dot: bool = False,
) -> None:
    """Launch the paged decode kernels' contiguous form over the slot cache
    ``[B, KH, S, D]`` in ``chunk``-wide slices; the caller validated the
    arguments.  Routes, scratch and counts as :func:`paged_decode` (the
    scratch is the paged read's with the chunk as the page, kept apart from
    it), launches counted under ``chunked_decode`` and ``CHUNKED_FORMS``."""
    B, H, _, D = q.shape
    _, KH, S, _ = k_cache.shape
    NB = S // chunk
    mma = (q.dtype == torch.bfloat16 and D in PAGED_MMA_HEAD_DIMS
           and not any(t.data_ptr() % 16 for t in (q, k_cache, v_cache)))
    kfmt = _KV_CODE[k_cache.dtype]
    stream = _stream(q)
    fn = _fn("chunked_decode")
    with torch.cuda.device(q.device):
        shapes = (int(mma), kfmt, B, H, KH, chunk, NB, D)
        scratch, counters = _scratch_buffers(
            "chunked_decode", q.device, stream, paged_scratch_floats(q.device, shapes), B * KH
        )
        err = fn(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), out.data_ptr(),
            positions.data_ptr(), active.data_ptr() if active is not None else None,
            scratch.data_ptr(), scratch.numel(), counters.data_ptr(), int(mma),
            dtype_code(q.dtype), kfmt, int(fp8_dot), B, H, KH, S, chunk, D,
            int(window) if window is not None else 0, stream,
        )
    route = "mma" if mma else "cuda_core"
    _count("chunked_decode", f"{route}:{paged_read(q.dtype, k_cache.dtype, fp8_dot)}")
    _check("chunked_decode", err)


def knn_topk(
    index: torch.Tensor, queries: torch.Tensor, valid: torch.Tensor,
    out_scores: torch.Tensor, out_ids: torch.Tensor, scratch: torch.Tensor,
    cand: torch.Tensor, k: int, cap: int, win: Optional[torch.Tensor] = None, kpad: int = 0,
) -> None:
    """Launch the fused score + top-k kernel; the caller validated the
    arguments and allocated the scratch (``Q G + 3 Q`` int32 words), the
    candidate buffer (``Q cap`` int64 keys) and, for ``k`` past
    ``KNN_SORT_CAP``, the sort buffer ``win`` (``2 Q kpad`` int64 keys,
    ``kpad`` the least ``KNN_SORT_CAP 2^m >= k``)."""
    N, D = index.shape
    Q = queries.shape[0]
    fn = _fn("knn_topk")
    with torch.cuda.device(index.device):
        err = fn(
            index.data_ptr(), queries.data_ptr(), valid.data_ptr(), out_scores.data_ptr(),
            out_ids.data_ptr(), scratch.data_ptr(), cand.data_ptr(), N, D, Q, k, cap,
            win.data_ptr() if win is not None else None, kpad, _stream(index),
        )
    _count("knn_topk")
    _check("knn_topk", err)


@functools.lru_cache(maxsize=512)
def qgemm_plan(M: int, N: int, K: int, bits: int, group: int, sms: int = 132,
               tma: bool = True) -> tuple:
    """(mt, warps_m, ksplit, kchunk) of a bf16 qgemm call.

    Past 64 rows of x with N a multiple of 16 and the operands on 16-byte
    boundaries (``tma``), the wgmma kernel: ``(2, 8, ksplit, kchunk)``, 128
    x 128 outputs a block, its K range ``kchunk`` rows (a multiple of 64 and,
    for int4, of the group).  Of the splits whose f32 partials stay within
    ``QGEMM_PARTIAL_FLOATS``, it takes the least estimated time: the waves
    of blocks over ``sms`` SMs, each the rows of K a block runs
    (``QGEMM_ROW_US``) plus a fixed cost (``QGEMM_WAVE_US``), and, split,
    the partials written and summed (``QGEMM_PARTIAL_US`` each); ties go
    to fewer splits.

    Otherwise the direct-load kernel: the warp tile (``mt`` m-tiles of 8
    rows; ``warps_m`` warps along M, the other ``4 // warps_m`` splitting a
    block's K range), the K splits across blocks and the rows of K a warp
    takes (a multiple of 16, and of the group for int4).  K is split until
    the grid has about two blocks per SM, but not so far that the f32
    partials (written and read once) pass a quarter of the weight bytes, and
    not below one group (int4) or 16 rows a warp."""
    if N % 16 == 0 and M > 64 and tma:
        unit = math.lcm(64, group) if bits == 4 else 64
        tiles = qgemm_tiles(M, N, 2, 8)
        best = None
        for want in range(1, max(1, K // unit) + 1):
            kchunk = -(-K // (want * unit)) * unit
            ksplit = -(-K // kchunk)
            partials = ksplit * M * N if ksplit > 1 else 0
            if partials > QGEMM_PARTIAL_FLOATS:
                continue
            waves = -(-tiles * ksplit // sms)
            cost = (waves * (kchunk * QGEMM_ROW_US[bits] + QGEMM_WAVE_US)
                    + partials * QGEMM_PARTIAL_US)
            if best is None or (cost, ksplit) < best[0]:
                best = ((cost, ksplit), ksplit, kchunk)
        return 2, 8, best[1], best[2]
    if M <= 8:
        mt, warps_m = 1, 1
    elif M <= 16:
        mt, warps_m = 2, 1
    elif M <= 64:
        mt, warps_m = 2, 4
    else:
        mt, warps_m = 4, 4
    kw = 4 // warps_m
    tiles = qgemm_tiles(M, N, mt, warps_m)
    unit = group if bits == 4 else 16
    by_traffic = int(K * bits / 8) // (32 * M)
    ksplit = max(1, min(-(-2 * sms // tiles), by_traffic, K // (kw * unit)))
    kchunk = -(-K // (ksplit * kw * unit)) * unit
    return mt, warps_m, -(-K // (kchunk * kw)), kchunk


def qgemm_tiles(M: int, N: int, mt: int, warps_m: int) -> int:
    """Output tiles (blocks of one K split, one counter each) of a bf16
    qgemm launch with warp tile ``mt`` and ``warps_m`` (see
    :func:`qgemm_plan`)."""
    if warps_m == 8:  # the wgmma kernel: 128 x 128
        return -(-N // 128) * -(-M // 128)
    return -(-N // QGEMM_TILE_N) * -(-M // (8 * mt * warps_m))


def qgemm_route(dtype: torch.dtype, M: int, N: int, K: int, group: int, *,
                qs_aligned: bool = True, aligned: bool = True) -> str:
    """The route of a qgemm call ``[M, K] . [K, N]`` (``group`` 0: int8,
    else int4 at that group); ``qs_aligned``: x, q and scale on 16-byte
    boundaries (the direct-load kernel reads x 8 bytes at a time),
    ``aligned``: out too.  K not a multiple of 16, N not one of 8, an int4
    group not one of 16, or x, q or scale off 16 bytes: ``"generic"`` (the
    generic kernel, :func:`qgemm_generic`: tensor cores in bf16, CUDA
    cores in f32).  Otherwise f32 ``"cuda_core"`` (the same kernel's f32
    form); bf16 with N a multiple of 16 and every tensor aligned (TMA's
    terms) ``"stream"`` up to ``QGEMM_STREAM_MAX_M`` rows and ``"wgmma"``
    past them; other bf16 calls ``"mma"``."""
    if K % 16 or N % 8 or (group and group % 16) or not qs_aligned:
        return "generic"
    if dtype == torch.float32:
        return "cuda_core"
    if N % 16 == 0 and aligned:
        return "stream" if M <= QGEMM_STREAM_MAX_M else "wgmma"
    return "mma"


def qgemm_tied_route(dtype: torch.dtype, V: int, E: int, *, aligned: bool = True) -> str:
    """The route of the tied int8 head over a ``[V, E]`` table (``aligned``:
    x and the table on 16-byte boundaries): bf16 with E a multiple of 16 and
    V of 8 the stream kernel's K-contiguous form; f32 with E a multiple of
    16 ``"cuda_core"``; anything else ``"generic"`` (both the generic
    kernel's K-contiguous form)."""
    if E % 16 == 0 and aligned:
        if dtype == torch.bfloat16 and V % 8 == 0:
            return "stream"
        if dtype == torch.float32:
            return "cuda_core"
    return "generic"


def _misaligned(*tensors: torch.Tensor) -> bool:
    return any(t.data_ptr() % 16 for t in tensors)


def qgemm(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor, out: torch.Tensor,
          *, group: int) -> None:
    """Launch the weight-only GEMM ``out[M, N] = x[M, K] . W[K, N]``; the
    caller (``ops.quant.qeinsum``) validated the arguments: ``q`` int8
    ``[K, N]`` (``group`` 0, ``scale`` per column) or packed int4 ``[K/2,
    N]`` (``scale`` per ``group`` rows and column), every tensor contiguous,
    x and out in one type.  :func:`qgemm_route` picks the kernel
    (``QGEMM_ROUTES`` counts which): the stream kernel
    (:func:`qgemm_stream`), the wgmma or the direct-load kernel, or the
    generic kernel (:func:`qgemm_generic`: the f32 and generic routes).  A
    call that splits K takes its f32 partials and counters from the
    per-(device, stream) scratch, like paged decode."""
    M, K = x.shape
    N = out.shape[1]
    bits = 4 if group else 8
    qs_aligned = not _misaligned(x, q, scale)
    tma = qs_aligned and not _misaligned(out)
    route = qgemm_route(x.dtype, M, N, K, group, qs_aligned=qs_aligned, aligned=tma)
    if route == "stream":
        qgemm_stream(x, [q], [scale], [out], group=group)
        return
    if route in ("cuda_core", "generic"):
        qgemm_generic(x, q, scale, out, group=group, route=route)
        return
    stream = _stream(x)
    fn = _fn("qgemm")
    with torch.cuda.device(x.device):
        scratch = counters = None
        mt, warps_m, ksplit, kchunk = qgemm_plan(M, N, K, bits, group, tma=tma)
        if ksplit > 1:
            scratch, counters = _scratch_buffers("qgemm", x.device, stream, ksplit * M * N,
                                                 qgemm_tiles(M, N, mt, warps_m))
        err = fn(
            x.data_ptr(), q.data_ptr(), scale.data_ptr(), out.data_ptr(),
            scratch.data_ptr() if scratch is not None else None,
            counters.data_ptr() if counters is not None else None,
            dtype_code(x.dtype), bits, M, N, K, group, mt, warps_m, ksplit, kchunk, stream,
        )
    _count("qgemm", f"int{bits}", route)
    _check("qgemm", err)


def qgemm_generic(x: torch.Tensor, w: torch.Tensor, scale: Optional[torch.Tensor],
                  out: torch.Tensor, *, group: int, kmajor: bool = False,
                  route: str = "generic") -> None:
    """One launch of the generic kernel (``qgemm_generic_kernel`` of
    ``csrc/qgemm.cu``): ``out = x . W`` for any shape and element-aligned
    tensors, with ``w`` int8 ``[K, N]``, packed int4 ``[K/2, N]`` at any
    even ``group`` dividing K, or (``kmajor``) the tied head's int8 ``[N,
    K]`` with no scale; contiguous tensors, x and out f32 (CUDA-core FMAs)
    or bf16 (tensor cores).  Its grid is :func:`qgemm_generic_plan`'s; the
    split tiles' partials and counters come from the per-(device, stream)
    scratch.  Counted under ``route``: ``"cuda_core"`` for f32 at the
    shapes the tensor-core kernels take, ``"generic"`` for the rest."""
    M, K = x.shape
    N = out.shape[1]
    bits = 4 if group else 8
    sms = _sm_count(x.device.index)
    mt, mtiles, ntiles, _, _, _, _, ctas = _generic_grid(M, N, K, bits, group, sms)
    stream = _stream(x)
    _fn("qgemm")
    with torch.cuda.device(x.device):
        scratch, counters = _scratch_buffers("qgemm", x.device, stream,
                                             2 * ctas * 8 * mt * QGEMM_GENERIC_BN, mtiles * ntiles)
        err = _libs["qgemm"].dabt_qgemm_generic(
            x.data_ptr(), w.data_ptr(), scale.data_ptr() if scale is not None else None,
            out.data_ptr(), scratch.data_ptr(), counters.data_ptr(), dtype_code(x.dtype), bits,
            M, N, K, group, int(kmajor), sms, stream,
        )
    _count("qgemm", f"int{bits}", route)
    _check("qgemm", err)


class StreamUnit(NamedTuple):
    """One unit of a stream-route block: rows ``[k0, k1)`` of K of column
    tile ``tile`` of member ``member``; ``slot`` the f32 partial it writes
    (-1: the block owns the whole tile and writes y), ``splits`` the blocks
    the tile's K is cut between."""

    member: int
    tile: int
    k0: int
    k1: int
    slot: int
    splits: int


class StreamPlan(NamedTuple):
    """A stream-route launch (``qgemm_stream_kernel``): ``mt`` m-tiles of 8
    rows of x, K in granules of ``granule`` rows (``gcount`` a tile),
    ``tiles`` column tiles per member, ``total`` granules, ``ctas`` blocks,
    each block's units in order, and the f32 partial floats its scratch
    holds (two slots a block)."""

    mt: int
    granule: int
    gcount: int
    tiles: tuple
    total: int
    ctas: int
    units: tuple
    partial_floats: int


@functools.lru_cache(maxsize=256)
def qgemm_stream_plan(M: int, Ns: tuple, K: int, bits: int, group: int,
                      sms: int = 132) -> StreamPlan:
    """The work of one stream-route launch over members of widths ``Ns``
    (the same arithmetic as ``csrc/qgemm.cu``'s ``st_unit``, ``st_first``
    and ``st_owner``).  The members' column tiles of ``QGEMM_STREAM_BN``
    form one sequence of granules, each tile's K cut into ``granule`` rows
    (``QGEMM_STREAM_KT``; int4: lcm with the group, so every range starts on
    a group boundary); block ``c`` of ``ctas`` takes granules ``[c total //
    ctas, (c + 1) total // ctas)``, cut where a tile ends, ``ctas`` the
    fewest blocks that keep a block's share at ``ceil(total / sms)`` (the
    ranges then often end on tile boundaries: fewer partials).  A
    tile cut between blocks sums their partials in block order; a block's
    first unit writes slot ``2c``, its last ``2c + 1``."""
    mt = next(t for t in (1, 2, 4, 8) if 8 * t >= M)
    granule = math.lcm(QGEMM_STREAM_KT, group) if bits == 4 else QGEMM_STREAM_KT
    gcount = -(-K // granule)
    tiles = tuple(-(-n // QGEMM_STREAM_BN) for n in Ns)
    total, ctas, ranges = _granule_ranges(sum(tiles) * gcount, gcount, sms)
    units = []
    for mine in ranges:
        out = []
        for gt, g0, g1, slot, splits in mine:
            member, t = 0, gt
            while t >= tiles[member]:
                t -= tiles[member]
                member += 1
            out.append(StreamUnit(member, t, g0 * granule, min(K, g1 * granule), slot, splits))
        units.append(tuple(out))
    return StreamPlan(mt, granule, gcount, tiles, total, ctas, tuple(units),
                      2 * ctas * 8 * mt * QGEMM_STREAM_BN)


def _granule_ranges(total: int, gcount: int, sms: int, least: int = 1) -> tuple:
    """The split of ``total`` granules (tiles of ``gcount`` each, in order)
    between blocks that the stream and generic kernels share (``st_first``,
    ``st_owner`` in ``csrc/qgemm.cu``): ``(total, ctas, ranges)``, ``ctas``
    the fewest blocks that keep a block's share at ``ceil(total / sms)``,
    block ``c`` taking granules ``[c total // ctas, (c + 1) total //
    ctas)`` (at least ``least`` granules a block while there are enough),
    cut where a tile ends into ``(tile, g0, g1, slot, splits)``:
    granules ``[g0, g1)`` of the tile, ``splits`` the blocks its K is cut
    between, ``slot`` the f32 partial the block writes (-1: the block owns
    the whole tile; a block's first unit writes ``2c``, its last ``2c +
    1``), summed in block order by the last block to finish."""
    per = max(least, -(-total // sms))  # the most granules a block takes
    ctas = -(-total // per)

    def first(c):
        return c * total // ctas

    def owner(s):
        return ((s + 1) * ctas - 1) // total

    ranges = []
    for c in range(ctas):
        s, end, mine = first(c), first(c + 1), []
        while s < end:
            gt, g0 = divmod(s, gcount)
            g1 = min(gcount, g0 + end - s)
            cf, cl = owner(gt * gcount), owner(gt * gcount + gcount - 1)
            mine.append((gt, g0, g1, -1 if cf == cl else 2 * c + (s != first(c)), cl - cf + 1))
            s += g1 - g0
        ranges.append(tuple(mine))
    return total, ctas, tuple(ranges)


class GenericUnit(NamedTuple):
    """One unit of a generic-route block: rows ``[m0, m0 + bm)`` of x
    (``mtile``), columns of column tile ``ntile``, rows ``[k0, k1)`` of K;
    ``slot`` and ``splits`` as :class:`StreamUnit`'s."""

    mtile: int
    ntile: int
    k0: int
    k1: int
    slot: int
    splits: int


class GenericPlan(NamedTuple):
    """A generic-route launch (``qgemm_generic_kernel``): ``mt`` m-tiles of
    8 rows of x a tile (``mtiles`` tiles along M, ``ntiles`` of
    ``QGEMM_GENERIC_BN`` columns along N), K in granules of ``granule`` rows
    (``gcount`` a tile), ``total`` granules, ``ctas`` blocks, each block's
    units in order, the f32 partial floats its scratch holds (two slots a
    block) and, int4, the scale rows a 64-row stage reads."""

    mt: int
    mtiles: int
    ntiles: int
    granule: int
    gcount: int
    total: int
    ctas: int
    units: tuple
    partial_floats: int
    srows: int


def _scale_rows(group: int, kt: int = QGEMM_GENERIC_KT) -> int:
    """The scale rows a ``kt``-row stage touches at most when ranges start on
    group boundaries (``wg_scale_rows`` in ``csrc/qgemm.cu``)."""
    return max(((kt * t) % group + kt - 1) // group + 1 for t in range(group))


def _generic_grid(M: int, N: int, K: int, bits: int, group: int, sms: int) -> tuple:
    """A generic-route launch's grid, in a few operations (``dabt_qgemm_generic``'s
    arithmetic): ``(mt, mtiles, ntiles, granule, gcount, total, bps, ctas)``,
    as :func:`qgemm_generic_plan` documents them, ``bps`` the blocks an SM."""
    mt = next(t for t in (1, 2, 4, 8) if 8 * t >= min(M, QGEMM_GENERIC_BM))
    granule = math.lcm(QGEMM_GENERIC_KT, group) if bits == 4 else QGEMM_GENERIC_KT
    gcount = -(-K // granule)
    mtiles, ntiles = -(-M // (8 * mt)), -(-N // QGEMM_GENERIC_BN)
    total = mtiles * ntiles * gcount
    bps = 2 if mt <= 2 and total >= 2 * QGEMM_GENERIC_DEEP * sms else 1
    per = max(QGEMM_GENERIC_MIN_GRANULES, -(-total // (sms * bps)))
    return mt, mtiles, ntiles, granule, gcount, total, bps, -(-total // per)


@functools.lru_cache(maxsize=256)
def qgemm_generic_plan(M: int, N: int, K: int, bits: int, group: int,
                       sms: int = 132) -> GenericPlan:
    """The work of one generic-route launch (the same arithmetic as
    ``dabt_qgemm_generic`` and ``gn_unit`` in ``csrc/qgemm.cu``): tiles of
    ``8 mt`` rows of x (M rounded up to 8, 16, 32 or 64; past 64 rows, tiles
    of 64) by ``QGEMM_GENERIC_BN`` columns, m tile outer, each tile's K cut
    into granules of ``QGEMM_GENERIC_KT`` rows (int4: lcm with the group, so
    every range starts on a group boundary), split between blocks as
    :func:`_granule_ranges` splits them over the blocks the ``sms`` SMs run
    at once (two an SM up to 16 rows where each block still takes
    ``QGEMM_GENERIC_DEEP`` granules, else one), at least
    ``QGEMM_GENERIC_MIN_GRANULES`` a block."""
    mt, mtiles, ntiles, granule, gcount, total, bps, _ = _generic_grid(M, N, K, bits, group, sms)
    _, ctas, ranges = _granule_ranges(total, gcount, sms * bps, QGEMM_GENERIC_MIN_GRANULES)
    units = tuple(tuple(GenericUnit(gt // ntiles, gt % ntiles, g0 * granule,
                                    min(K, g1 * granule), slot, splits)
                        for gt, g0, g1, slot, splits in mine) for mine in ranges)
    return GenericPlan(mt, mtiles, ntiles, granule, gcount, total, ctas, units,
                       2 * ctas * 8 * mt * QGEMM_GENERIC_BN, _scale_rows(group) if bits == 4 else 0)


@functools.lru_cache(maxsize=16)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def qgemm_stream(x: torch.Tensor, qs: Sequence[torch.Tensor], scales: Sequence,
                 outs: Sequence[torch.Tensor], *, group: int, kmajor: bool = False) -> None:
    """One stream-route launch: ``outs[i] = x . W_i`` for the 1-3 members
    (``qs[i]`` int8 ``[K, N_i]`` or packed int4 ``[K/2, N_i]``, ``scales[i]``
    per column or per ``group`` rows), bf16 x ``[M, K]`` with M <= 64; the
    caller checked that :func:`qgemm_route` gives ``"stream"`` for each.  ``kmajor``: one int8 member
    ``[N, K]`` and no scale (the tied head).  The split tiles' partials and
    counters come from the per-(device, stream) scratch."""
    M, K = x.shape
    Ns = tuple(o.shape[1] for o in outs)
    bits = 4 if group else 8
    sms = _sm_count(x.device.index)
    plan = qgemm_stream_plan(M, Ns, K, bits, group, sms)
    stream = _stream(x)
    _fn("qgemm")  # builds and loads the library if needed
    pad = [None] * (3 - len(qs))
    with torch.cuda.device(x.device):
        scratch, counters = _scratch_buffers("qgemm", x.device, stream, plan.partial_floats,
                                             sum(plan.tiles))
        err = _libs["qgemm"].dabt_qgemm_stream(
            x.data_ptr(), *[q.data_ptr() for q in qs], *pad,
            *[s.data_ptr() if s is not None else None for s in scales], *pad,
            *[o.data_ptr() for o in outs], *pad, *Ns, *[0] * len(pad),
            len(qs), bits, M, K, group, int(kmajor), sms,
            scratch.data_ptr(), counters.data_ptr(), stream,
        )
    _count("qgemm", f"int{bits}", "stream")
    _check("qgemm", err)


def qgemm_tied(xs: torch.Tensor, q: torch.Tensor, out: torch.Tensor) -> None:
    """The tied int8 head: ``out[M, V] = xs[M, E] . q[V, E]^T``, ``xs``
    already scaled per E (``ops.quant.tied_head``, which validated the
    arguments).  :func:`qgemm_tied_route` picks the stream route's
    K-contiguous form (bf16, 64 rows of x a launch) or the generic
    kernel's (f32, or a bf16 E or V off the stream form's multiples)."""
    M, K = xs.shape
    route = qgemm_tied_route(xs.dtype, q.shape[0], K, aligned=not _misaligned(xs, q))
    if route != "stream":
        qgemm_generic(xs, q, None, out, group=0, kmajor=True, route=route)
        return
    for m0 in range(0, M, QGEMM_STREAM_MAX_M):
        rows = slice(m0, min(M, m0 + QGEMM_STREAM_MAX_M))
        qgemm_stream(xs[rows], [q], [None], [out[rows]], group=0, kmajor=True)


def sample_splits(B: int, V: int, sms: int = 132) -> int:
    """Blocks that share each row's first pass (the groups' maxima) in a
    sampler launch: about two blocks per SM over the B rows, at least 8
    groups a block; 1 below ``SAMPLE_HIER_MIN_VOCAB`` (no first pass)."""
    if V < SAMPLE_HIER_MIN_VOCAB:
        return 1
    return max(1, min(-(-2 * sms // B), -(-V // 128) // 8))


def sample(logits: torch.Tensor, temperature: torch.Tensor, top_p: torch.Tensor,
           gumbel: torch.Tensor, ids: torch.Tensor, *, k: int,
           allowed: Optional[torch.Tensor] = None, next_state: Optional[torch.Tensor] = None,
           fsm_state: Optional[torch.Tensor] = None, jmask: Optional[torch.Tensor] = None,
           state_out: Optional[torch.Tensor] = None) -> None:
    """Launch the fused masked top-k / top-p / draw / FSM-advance kernel
    (``csrc/sample.cu``), one launch a sampling step; the caller
    (``ops.sampling.sample_logits``) validated the arguments: logits ``[B,
    V]`` f32 or bf16, temperature and top_p ``[B]`` f32, gumbel ``[B, k]``
    f32, ids ``[B]`` int32 out, and, for a JSON FSM, allowed ``[S, V]``
    bool, next_state ``[S, V]`` int32, fsm_state and state_out ``[B]``
    int32, jmask ``[B]`` bool, all contiguous on one card.  Past
    ``SAMPLE_HIER_MIN_VOCAB`` the groups' maxima and the per-row counters
    come from the per-(device, stream) scratch."""
    B, V = logits.shape
    stream = _stream(logits)
    fn = _fn("sample")
    json = allowed is not None
    with torch.cuda.device(logits.device):
        splits = sample_splits(B, V, _sm_count(logits.device.index))
        gmax = counters = None
        if V >= SAMPLE_HIER_MIN_VOCAB:
            gmax, counters = _scratch_buffers("sample", logits.device, stream,
                                              B * -(-V // 128), B)
        err = fn(
            logits.data_ptr(), temperature.data_ptr(), top_p.data_ptr(), gumbel.data_ptr(),
            *([allowed.data_ptr(), next_state.data_ptr(), fsm_state.data_ptr(),
               jmask.data_ptr()] if json else [None] * 4),
            ids.data_ptr(), state_out.data_ptr() if json else None,
            gmax.data_ptr() if gmax is not None else None,
            counters.data_ptr() if counters is not None else None,
            dtype_code(logits.dtype), B, V, k, splits, stream,
        )
    _count("sample")
    _check("sample", err)


class AnnAdcPlan(NamedTuple):
    """One ADC launch (``csrc/ann_adc.cu``): ``blocks`` a query, ``chunk``
    LUT subspaces staged at once, a block's candidate buffer of ``cap``
    keys, ``smem`` bytes of dynamic shared memory a block, and the scratch:
    ``cand_keys`` 64-bit candidates (Q blocks S: each block's sorted top S)
    and ``counters`` int32 (Q tickets)."""

    blocks: int
    chunk: int
    cap: int
    smem: int
    cand_keys: int
    counters: int


def _adc_merge_lists(blocks: int) -> int:
    """Lists of S keys the last block of a query holds in shared memory:
    the blocks', the -inf tail's, and half as many for the first pairwise
    merge's outputs."""
    return blocks + 1 + (blocks + 2) // 2


def _adc_smem(chunk: int, cap: int, blocks: int, S: int) -> int:
    """The kernel's dynamic shared memory (``dabt_ann_adc``): the LUT chunk
    and the buffer, or the merge's lists, whichever is larger (rounded to 16
    bytes), then S rounded up to a power of two keys (the block's sort)."""
    region = max(chunk * 1024 + cap * 8, _adc_merge_lists(blocks) * S * 8)
    return -(-region // 16) * 16 + (1 << (S - 1).bit_length()) * 8


@functools.lru_cache(maxsize=512)
def ann_adc_plan(Q: int, P: int, L: int, m: int, S: int, mean_fill: int,
                 sms: int = 132) -> AnnAdcPlan:
    """The ADC launch for Q queries over P probed lists of L slots, m
    subspaces and a shortlist of S, from shapes and the index's mean fill
    (its high-water marks' mean, a host number: no device sync).  The
    buffer holds ``2 S + ANN_ADC_THREADS`` keys (a round's slots past 2 S);
    the LUT is staged whole where it fits beside it in ``ANN_ADC_SMEM``,
    else ``ANN_ADC_LUT_CHUNK`` or fewer subspaces a multiple of 16 at a
    time.  Blocks a query: as many as the card holds at once (by shared
    memory and threads) over the Q queries, rounded down (one wave: at Q
    32 on 132 SMs 8 blocks a query, not 9 and a second wave of 24), at most
    one per ``ANN_ADC_MIN_TILES`` of the query's estimated live tiles (P
    ceil(mean_fill / 32)), and no more than the merge's lists fit in shared
    memory (:func:`_adc_merge_lists`)."""
    if not (Q >= 1 and P >= 1 and L >= 1 and m >= 1 and S >= 1):
        raise ValueError(f"ann_adc_plan: Q {Q}, P {P}, L {L}, m {m}, S {S}")
    cap = 2 * S + ANN_ADC_THREADS
    sel = (1 << (S - 1).bit_length()) * 8
    room = (ANN_ADC_SMEM - cap * 8 - sel) // 1024
    chunk = m if m <= min(room, ANN_ADC_LUT_CHUNK) else min(ANN_ADC_LUT_CHUNK, room) // 16 * 16
    scan = _adc_smem(chunk, cap, 0, S)
    per_sm = max(1, min(2048 // ANN_ADC_THREADS,
                        ANN_ADC_SM_SMEM // (scan + ANN_ADC_STATIC + 1024)))
    tiles = P * -(-min(max(mean_fill, 0), L) // ANN_ADC_TILE)
    lists = (ANN_ADC_SMEM - sel) // (8 * S)
    most = max(b for b in range(1, lists + 1) if _adc_merge_lists(b) <= lists)
    blocks = max(1, min(per_sm * sms // Q, tiles // ANN_ADC_MIN_TILES, most))
    return AnnAdcPlan(blocks, chunk, cap, _adc_smem(chunk, cap, blocks, S), Q * blocks * S, Q)


def ann_adc(codes: torch.Tensor, lvalid: torch.Tensor, rowpos: torch.Tensor,
            fill: torch.Tensor, top_ci: torch.Tensor, top_c: torch.Tensor, lut: torch.Tensor,
            out_scores: torch.Tensor, out_pos: torch.Tensor, shortlist: int,
            mean_fill: int) -> None:
    """Launch the ADC scan + shortlist (``csrc/ann_adc.cu``: one kernel on
    :func:`ann_adc_plan`'s grid, each block scoring its share of the probed
    lists' live tiles and writing its top ``shortlist`` sorted, the last
    block of a query merging the blocks' lists); the caller
    (``storage.ann.adc_shortlist``) validated the arguments (``fill
    [nlist]`` int32, each list's high-water mark; top_ci's and top_c's rows
    may lie apart, their elements not, and the LUT's 256-float rows too,
    16-byte aligned) and allocated the outputs (``[Q,
    shortlist]`` f32 scores, int32 row positions).  The candidates and the
    counters (left at zero) come from the per-(device, stream) scratch."""
    nlist, L, m = codes.shape
    Q, P = top_ci.shape
    stream = _stream(codes)
    fn = _fn("ann_adc")
    with torch.cuda.device(codes.device):
        plan = ann_adc_plan(Q, P, L, m, shortlist, int(mean_fill),
                            _sm_count(codes.device.index))
        cand, counters = _scratch_buffers("ann_adc", codes.device, stream,
                                          2 * plan.cand_keys, plan.counters)
        err = fn(
            codes.data_ptr(), lvalid.data_ptr(), rowpos.data_ptr(), fill.data_ptr(),
            top_ci.data_ptr(), top_c.data_ptr(), lut.data_ptr(), cand.data_ptr(),
            counters.data_ptr(), out_scores.data_ptr(), out_pos.data_ptr(), nlist, L, m, Q, P,
            shortlist, plan.blocks, plan.chunk, plan.cap,
            *(t.stride(0) if Q > 1 else P for t in (top_ci, top_c)),
            lut.stride(0) if Q > 1 else 0, lut.stride(1), stream,
        )
    _count("ann_adc")
    _check("ann_adc", err)


def ann_rerank(tier: torch.Tensor, rvalid: torch.Tensor, q: torch.Tensor,
               sl_scores: torch.Tensor, sl_pos: torch.Tensor, out_scores: torch.Tensor,
               out_pos: torch.Tensor, k: int) -> None:
    """Launch the gather + exact bf16 dot + top-k over an ADC shortlist
    (``csrc/ann_rerank.cu``, one block a query); the caller
    (``storage.ann.rerank``) validated the arguments and allocated the
    outputs (``[Q, k]`` f32 scores, int32 row positions)."""
    N, D = tier.shape
    Q, S = sl_pos.shape
    fn = _fn("ann_rerank")
    with torch.cuda.device(tier.device):
        err = fn(
            tier.data_ptr(), rvalid.data_ptr(), q.data_ptr(), sl_scores.data_ptr(),
            sl_pos.data_ptr(), out_scores.data_ptr(), out_pos.data_ptr(), N, D, Q, S, k,
            _stream(tier),
        )
    _count("ann_rerank")
    _check("ann_rerank", err)


class RoutePlan(NamedTuple):
    """A routing launch (``moe_route_kernel`` of ``csrc/moe_route.cu``):
    its ``form`` (``MOE_ROUTE_FORMS``), the experts a tile holds (``xmax``)
    and its ``tile_tokens``, the ``tiles`` and ``splits`` (blocks a tile:
    E's ranges), the 32-bit words of scratch and the ticket counters it
    takes (0: none)."""

    form: str
    xmax: int
    tile_tokens: int
    tiles: int
    splits: int
    scratch: int
    counters: int


@functools.lru_cache(maxsize=256)
def moe_route_plan(dtype: torch.dtype, T: int, E: int, X: int, K: int) -> RoutePlan:
    """The routing launch for ``x [T, E]`` in ``dtype`` through ``router [E,
    X]`` with top ``K``, from shapes alone (a CUDA graph captures it).  A
    tile holds the fewest of ``MOE_ROUTE_XMAX`` experts that covers X and
    ``MOE_ROUTE_VALUES`` / that many tokens.  One tile (T 8 at X <= 8: the
    decode tick) takes ``"split"``: ``MOE_ROUTE_SPLITS`` blocks, each a
    range of E (at least a warp's worth of 16-byte chunks a block), 64 f32
    partials a block and a counter; ``"block"`` where a short E leaves one
    block: no scratch.  More tokens take ``"tiles"``: a block a tile, K X
    ``tiles`` counts and a counter.  Every form is one launch."""
    code = dtype_code(dtype)
    if not (1 <= X <= MOE_ROUTE_XMAX[-1] and 1 <= K <= min(X, 8) and T >= 1 and E >= 1):
        raise ValueError(f"moe_route_plan: T {T}, E {E}, X {X}, K {K}")
    xmax = next(m for m in MOE_ROUTE_XMAX if X <= m)
    tt = MOE_ROUTE_VALUES // xmax
    tiles = -(-T // tt)
    if tiles > 1:
        return RoutePlan("tiles", xmax, tt, tiles, 1, K * X * tiles, 1)
    chunks = -(-E // (4 if code == 0 else 8))
    splits = max(1, min(MOE_ROUTE_SPLITS, chunks // 32))
    if splits == 1:
        return RoutePlan("block", xmax, tt, 1, 1, 0, 0)
    return RoutePlan("split", xmax, tt, 1, splits, splits * MOE_ROUTE_VALUES, 1)


def moe_route(x: torch.Tensor, router: torch.Tensor, tok_slot: torch.Tensor,
              tok_gate: torch.Tensor, slot_tok: torch.Tensor, fill: torch.Tensor) -> None:
    """Launch the MoE routing (``csrc/moe_route.cu``: one launch on
    :func:`moe_route_plan`'s form); the caller (``ops.moe.moe_route``) validated the
    arguments and allocated the outputs: tok_slot / tok_gate ``[T, K]``
    int32 / f32, slot_tok ``[X, C]`` and fill ``[X]`` int32.  A form with
    more than one block takes its scratch and ticket counter (left at zero)
    from the per-(device, stream) scratch; x is read with 16-byte loads
    where it lies on 16 bytes and E fills whole 16-byte chunks, the router
    with 16-byte copies where it lies on 16 bytes."""
    T, E = x.shape
    X = router.shape[1]
    K = tok_slot.shape[1]
    plan = moe_route_plan(x.dtype, T, E, X, K)
    vec = 16 // x.element_size()
    stream = _stream(x)
    fn = _fn("moe_route")
    with torch.cuda.device(x.device):
        scratch = counters = None
        if plan.counters:
            scratch, counters = _scratch_buffers("moe_route", x.device, stream, plan.scratch,
                                                 plan.counters)
        err = fn(x.data_ptr(), router.data_ptr(), tok_slot.data_ptr(), tok_gate.data_ptr(),
                 slot_tok.data_ptr(), fill.data_ptr(),
                 scratch.data_ptr() if scratch is not None else None,
                 counters.data_ptr() if counters is not None else None,
                 dtype_code(x.dtype), T, E, X, K, slot_tok.shape[1], plan.xmax, plan.splits,
                 int(E % vec == 0 and not _misaligned(x)), int(not _misaligned(router)),
                 stream)
    _count("moe_route", kind=plan.form)
    _check("moe_route", err)


class MoePlan(NamedTuple):
    """A grouped expert GEMM launch: its route (``MOE_GEMM_ROUTES``), K in
    ``ksplit`` ranges of ``kchunk`` rows (``ksplit`` 1: one range, K), and
    the output features and slots a block, ``tile_n`` and ``tile_m``."""

    route: str
    ksplit: int
    kchunk: int
    tile_n: int
    tile_m: int


def _moe_split(K: int, tiles: int, slots: int, waves: int, partials: int) -> tuple:
    """(ksplit, kchunk): the fewest splits that give ``tiles`` output tiles
    ``waves`` waves over ``slots`` resident blocks, within the split limits
    (``MOE_SPLIT_MIN_K``, ``MOE_MAX_SPLIT``, ``MOE_PARTIAL_FLOATS`` for
    ``partials`` floats a split)."""
    want = min(-(-waves * slots // tiles), MOE_MAX_SPLIT, K // MOE_SPLIT_MIN_K,
               MOE_PARTIAL_FLOATS // partials)
    if want <= 1:
        return 1, K
    kchunk = -(-K // (want * MOE_GEMM_TILE)) * MOE_GEMM_TILE
    return -(-K // kchunk), kchunk


@functools.lru_cache(maxsize=256)
def moe_gemm_plan(dtype: torch.dtype, epilogue: str, X: int, C: int, K: int, N: int, *,
                  aligned: bool = True, sms: int = 132) -> MoePlan:
    """The launch of a grouped expert GEMM ``[X, C, K] . [X, K, N]`` from
    dtype, shapes and alignment alone (a CUDA graph captures it; the
    experts' fills stay on the card).  ``aligned``: every operand on a
    16-byte boundary.

    - f32, K or N not a multiple of ``MOE_GEMM_TILE``, or an operand off 16
      bytes: ``"cuda_core"``.
    - bf16 with N a multiple of ``MOE_WGMMA_TILE_N`` and at least
      ``MOE_WGMMA_MIN_C`` slots an expert (prefill): ``"wgmma"``, K whole
      (a split's partials cost more than the tail they remove there);
      down's blocks take 256 features where that still leaves
      ``MOE_WIDE_WAVES`` waves of blocks, else 128 features and the slots
      from ``MOE_WGMMA_TILES_M`` that cover C with the fewest rows (192 at
      a 512-token chunk's C 160: one pass where 128 takes a second, mostly
      empty, tile).
    - Other bf16 calls: ``"mma"``; down's K split (``"mma_split"``) until its
      64 x 64 tiles (every slot taken as live) make ``MOE_MMA_WAVES`` waves
      of three blocks an SM (at decode a single wave's tail leaves most SMs
      idle).
    """
    small = MOE_GEMM_TILE
    if (dtype != torch.bfloat16 or K % MOE_GEMM_TILE or N % MOE_GEMM_TILE or not aligned):
        return MoePlan("cuda_core", 1, K, small, small)
    wide = 2 * MOE_WGMMA_TILE_N
    if N % MOE_WGMMA_TILE_N == 0 and C >= MOE_WGMMA_MIN_C:
        tile_n, tile_m = MOE_WGMMA_TILE_N, MOE_WGMMA_TILES_M[0]
        if epilogue == "down":
            if N % wide == 0 and X * -(-C // tile_m) * (N // wide) >= MOE_WIDE_WAVES * sms:
                tile_n = wide
            else:
                tile_m = min(MOE_WGMMA_TILES_M, key=lambda m: (-(-C // m) * m, m))
        return MoePlan("wgmma", 1, K, tile_n, tile_m)
    if epilogue == "down":
        tiles = X * -(-C // MOE_GEMM_TILE) * (N // MOE_GEMM_TILE)
        ksplit, kchunk = _moe_split(K, tiles, 3 * sms, MOE_MMA_WAVES, X * C * N)
        if ksplit > 1:
            return MoePlan("mma_split", ksplit, kchunk, small, small)
    return MoePlan("mma", 1, K, small, small)


def moe_gemm_tiles(X: int, C: int, N: int) -> int:
    """Output tiles (one split-K counter each) of an ``mma_split`` launch."""
    return X * -(-C // MOE_GEMM_TILE) * -(-N // MOE_GEMM_TILE)


def moe_gemm(a: torch.Tensor, slot_tok: torch.Tensor, fill: torch.Tensor, w0: torch.Tensor,
             w1: Optional[torch.Tensor], out: torch.Tensor, *, epilogue: str) -> None:
    """Launch one grouped expert GEMM (``csrc/moe_gemm.cu``): ``epilogue``
    ``"gate_up"`` (a = x ``[T, K]``, w0 / w1 = Wg / Wu ``[X, K, N]``) or
    ``"down"`` (a = h ``[X, C, K]``, w0 = Wd, w1 None), into out ``[X, C,
    N]``; the caller (``ops.moe.moe_expert_gemm``) validated the arguments.
    :func:`moe_gemm_plan` picks the route and K split; a split launch takes
    its f32 partials and counters from the per-(device, stream) scratch,
    like paged decode; gate/up on ``"wgmma"`` gathers its slots' rows into a
    ``[X, C, K]`` buffer allocated here (TMA has no row gather).
    ``MOE_GEMM_FORMS`` counts the launch's route and epilogue; a launch the
    kernel refuses raises."""
    X, K, N = w0.shape
    C = slot_tok.shape[1]
    operands = [t for t in (a, w0, w1) if t is not None]
    plan = moe_gemm_plan(a.dtype, epilogue, X, C, K, N, aligned=not _misaligned(*operands),
                         sms=_sm_count(a.device.index))
    code = {"mma": 0, "mma_split": 0, "cuda_core": 1, "wgmma": 2}[plan.route]
    stream = _stream(a)
    fn = _fn("moe_gemm")
    with torch.cuda.device(a.device):
        scratch = counters = rows = None
        if plan.ksplit > 1:
            scratch, counters = _scratch_buffers("moe_gemm", a.device, stream,
                                                 plan.ksplit * X * C * N, moe_gemm_tiles(X, C, N))
        if plan.route == "wgmma" and epilogue == "gate_up":
            rows = torch.empty((X, C, K), dtype=a.dtype, device=a.device)
        err = fn(a.data_ptr(), slot_tok.data_ptr(), fill.data_ptr(), w0.data_ptr(),
                 w1.data_ptr() if w1 is not None else None, out.data_ptr(),
                 scratch.data_ptr() if scratch is not None else None,
                 counters.data_ptr() if counters is not None else None,
                 rows.data_ptr() if rows is not None else None,
                 dtype_code(a.dtype), 0 if epilogue == "gate_up" else 1, code,
                 X, C, K, N, plan.ksplit, plan.kchunk, plan.tile_n, plan.tile_m, stream)
    _count("moe_gemm", kind=f"{plan.route}:{epilogue}")
    _check("moe_gemm", err)


def moe_combine(tok_slot: torch.Tensor, tok_gate: torch.Tensor, ye: torch.Tensor,
                out: torch.Tensor) -> None:
    """Launch the MoE combine (``csrc/moe_route.cu``: a thread a 16-byte
    vector of a token's row, one element at a time where E is not a
    multiple of the vector or ye / out is off 16 bytes); the caller
    (``ops.moe.moe_combine``) validated the arguments and allocated out
    ``[T, E]`` in ye's dtype."""
    T, K = tok_slot.shape
    E = ye.shape[-1]
    vec = E % (16 // ye.element_size()) == 0 and not _misaligned(ye, out)
    fn = _fn("moe_combine")
    with torch.cuda.device(ye.device):
        err = fn(tok_slot.data_ptr(), tok_gate.data_ptr(), ye.data_ptr(), out.data_ptr(),
                 dtype_code(ye.dtype), T, E, K, int(vec), _stream(ye))
    _count("moe_combine")
    _check("moe_combine", err)


class TreePlan(NamedTuple):
    """A tensor-core paged tree launch (:func:`paged_tree_plan`)."""
    warps: int  # warps of 16 query rows a block
    row_chunks: int  # blocks' worth of query rows a (slot, KV head)
    blocks: int  # the persistent grid
    min_items: int  # the least items a block takes
    items: int  # the most items a call of these shapes has
    scratch_floats: int  # f32 partials: two a block
    counters: int  # one a (slot, KV head, row chunk)


@functools.lru_cache(maxsize=256)
def paged_tree_plan(B: int, H: int, KH: int, T: int, D: int, page: int, NB: int, sms: int,
                    min_items: int = PAGED_TREE_MIN_ITEMS) -> TreePlan:
    """The tensor-core paged tree launch for these shapes on a card of
    ``sms`` SMs, from shapes alone (a CUDA graph captures it).  The G T
    query rows of a (slot, KV head) go in row chunks of at most
    ``PAGED_TREE_MAX_WARPS`` / 4 warpgroups of 64 rows (wgmma's M), as even
    as the chunks allow;
    each row chunk of each (slot, KV head) is a row of items, its prefix's
    64-key chunks (``ceil(page / 64)`` a page at most) and its tree's
    ``ceil(T / 32)`` tiles.  The grid is ``PAGED_TREE_BLOCKS_PER_SM`` blocks
    an SM, fewer where even the longest rows (every one at NB pages) give
    fewer than ``min_items`` items a block; the kernel splits the call's own
    items over as many of them as take ``min_items`` each.  The scratch holds
    two (acc, m, l) partials of a row chunk a block."""
    tiles = -(-(H // KH) * T // 64)
    row_chunks = -(-tiles // (PAGED_TREE_MAX_WARPS // 4))
    warps = 4 * -(-tiles // row_chunks)
    chunks = NB * -(-page // PAGED_TREE_CHUNK) + -(-T // PAGED_TREE_NODES)
    items = B * KH * row_chunks * chunks
    blocks = max(1, min(PAGED_TREE_BLOCKS_PER_SM * sms, -(-items // min_items)))
    return TreePlan(warps, row_chunks, blocks, min_items, items,
                    2 * blocks * 16 * warps * (D + 2), B * KH * row_chunks)


def paged_tree(
    q: torch.Tensor, k_pool: torch.Tensor, v_pool: torch.Tensor, out: torch.Tensor,
    block_tables: torch.Tensor, lengths: torch.Tensor, tree_k: torch.Tensor,
    tree_v: torch.Tensor, anc: torch.Tensor, depths: torch.Tensor, *, window: Optional[int],
) -> None:
    """Launch the paged tree attention kernel (``csrc/paged_tree.cu``); the
    caller (``ops.attention.paged_tree_attention``) validated the arguments.
    bf16 at ``PAGED_MMA_HEAD_DIMS`` with every operand on a 16-byte boundary
    takes the tensor-core kernel on the persistent grid of
    :func:`paged_tree_plan`; its f32 partials and counters come from the
    per-(device, stream) scratch, like paged decode's.  Everything else takes
    the CUDA-core kernel.  The pools may be bf16 or fp8 (widened to q's dtype
    in the kernel); ``PAGED_TREE_FORMS`` counts route and read."""
    B, H, T, D = q.shape
    P, KH, page, _ = k_pool.shape
    NB = block_tables.shape[1]
    mma = (q.dtype == torch.bfloat16 and D in PAGED_MMA_HEAD_DIMS
           and not _misaligned(q, k_pool, v_pool, tree_k, tree_v, out))
    stream = _stream(q)
    fn = _fn("paged_tree")
    with torch.cuda.device(q.device):
        blocks = warps = min_items = 0
        scratch = counters = None
        if mma:
            plan = paged_tree_plan(B, H, KH, T, D, page, NB, _sm_count(q.device.index),
                                   PAGED_TREE_MIN_ITEMS)
            blocks, warps, min_items = plan.blocks, plan.warps, plan.min_items
            scratch, counters = _scratch_buffers("paged_tree", q.device, stream,
                                                 plan.scratch_floats, plan.counters)
        err = fn(
            q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), block_tables.data_ptr(),
            lengths.data_ptr(), tree_k.data_ptr(), tree_v.data_ptr(), anc.data_ptr(),
            depths.data_ptr(), out.data_ptr(),
            scratch.data_ptr() if scratch is not None else None,
            scratch.numel() if scratch is not None else 0,
            counters.data_ptr() if counters is not None else None,
            int(mma), dtype_code(q.dtype), _KV_CODE[k_pool.dtype], B, H, KH, T, P, page, NB, D,
            int(window) if window is not None else 0, blocks, warps, min_items, stream,
        )
    route = "mma" if mma else "cuda_core"
    _count("paged_tree", f"{route}:{paged_read(q.dtype, k_pool.dtype)}")
    _check("paged_tree", err)
