#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/H100 port (``django_assistant_bot_tpu_torch``).

    python3 chip_smoke.py

Needs one CUDA card, ``nvcc`` and the repository checkout around this file;
without a card, or run from a directory that holds only this script, it
exits non-zero before printing any result.  Phases, in the order they run
(1-7, 11, 12, 13, 8-10; any failure exits non-zero; each phase's wall seconds are
printed on a line of their own):

1. environment (torch / CUDA versions, ``nvidia-smi`` name and power limit)
   and the kernel build from ``django_assistant_bot_tpu_torch/csrc`` (one
   ``nvcc`` per source, all at once), with each library's ``ptxas`` report;
2. every kernel against its plain PyTorch twin on the card, at the main
   path's shapes, with the stated tolerance, plus its time, its bound, the
   plain twin's time and, where one PyTorch call computes the same
   function, that call's time (a yardstick only; the port never calls it);
   ``ms`` is the wall time per call over back-to-back calls (CUDA events),
   ``device_ms`` the summed kernel time per call (torch.profiler; where
   its profiles all come back without kernel records, the CUDA-event span
   of a call, logged as such and counted at the end); the
   HMMA / LDGSTS / HGMMA / UTMALDG / SYNCS counts of the libraries; for
   paged decode also the main path's own decode shape and a bitwise repeat
   check (``paged_live_keys`` and ``paged_bound_ms`` are also imported by
   ``tools/paged_decode_ab.py``);
   the KNN score + top-k at the RAG corpus (1,048,576 x 768, Q 8 / 32 /
   128, k 16 / 1024, all rows and a 1% allow-list) and at 4,096 x 64; the
   weight-only GEMM (``qgemm``, int8 and int4 at groups 64 and 128) at
   Llama-3-8B's projection shapes, M 1 / 8 / 16 / 37 / 64 / 65 / 512 /
   2048, its grouped decode launches (QKV, gate/up) and the tied int8 head,
   and its time at M 8 (each projection and each grouped launch, with the
   stream-read yardstick and the direct-load kernel beside it) and 512
   (gate/up and down also 2048) beside cuBLAS on the dequantized weight;
   qgemm's generic route (``qgemm_generic_kernel``: int4 groups 2 / 4 / 6
   / 8 / 24 / 40, widths off 16 and 8, K off 64, tied heads at E 40 and
   4,040; M 1 / 8 / 65 / 512, bf16, and f32; a repeat bitwise equal) and
   its time at int4 g8, 4096 x 4096, M 8 and 512, beside the bound, the
   flush-aware bound, the plain twin and cuBLAS; the tied int8 head's time
   at Llama-3-8B's [128,256, 4096] table beside ``torch.matmul``; the fused
   sampler at B 8, V 128,256, k 50 (f32 and bf16, with and without a JSON
   mask, a planted tie block): ids and FSM states equal to the plain
   twin's but for rows at the top-p boundary (counted), its time beside
   ``torch.topk`` alone; the ANN kernels (``ann_adc``, ``ann_rerank``),
   checked in phase 9 on its corpus, built once (2,000,000 x 768 through
   ``add`` + ``train()``, 4,096 lists, m 96, with duplicated rows for ties
   and one probed list made all-invalid; Q 1 / 8 / 32, nprobe 64 / 256,
   shortlist 256, k 16; then a probed list at fill 0, tombstones inside the
   fills, and the -inf tail at shortlist 2,048): ADC scores bit-equal to
   the twin's and the same positions, the rerank within
   ``topk_score_bound``; their time at the main path's search (Q 8, nprobe
   64) beside the bound (to each list's fill; the padded figure beside
   it), the twins and, for the rerank, gather + ``torch.bmm`` +
   ``torch.topk``; the ADC kernel at Q 32 and at nprobe 1,024 with its
   scratch bytes; the paged tree
   attention (``paged_tree``, :func:`check_paged_tree`) at 8 slots of
   Llama-3-8B's heads and the (4, 4) tree at 10,208 and 1,868 live prefix
   keys (a row at length 0), then lopsided lengths and trees of 65 and 129
   nodes at G 4 and 8 (``TREE_MORE``), bf16 within ``paged_tree_bf16_bound``
   (also with a window), f32 within 1e-4, bitwise repeatable, its time
   beside the bound (with its grid, items a block, waves and scratch
   bytes, :func:`tree_partition`), the twin and a dense gather +
   ``scaled_dot_product_attention``
   (the same yardstick for paged decode); the fp8 forms of both paged
   kernels, in the same two functions (:func:`check_paged`,
   :func:`check_paged_tree`): the dequant read of e4m3 and e5m2 pools
   under bf16 and f32 queries, the in-dot read, and the tree read over fp8
   pages, at the same shapes, each within its bound of the twin on the
   same pools, bitwise repeatable, the in-dot read also on
   ``paged_fp8_dot_probe``'s inputs to ``paged_bf16_bound`` while the
   dequant read of the same scores misses it (:func:`check_indot_probe`),
   their times beside the byte bound at 1 byte a pool value, the twin and
   the yardstick; and the pool writes' cast on the card against the CPU's
   bits (:func:`check_kv_cast`, with what torch's own CUDA cast does);
   the chunked decode read over the legacy slot cache (``chunked_decode``,
   the paged kernels' contiguous form; :func:`check_chunked`) at B 8, H
   32, KH 8, D 128, S 4096, chunk 512: bf16 and f32 queries, the native,
   dequant and in-dot reads of e4m3 and e5m2 caches, ragged rows with one
   inactive, a window past chunk 0, a batch whose ``hi`` is 1, each within
   its bound of the twin and bit-equal to ``paged_decode`` on the same K/V
   laid out as pages, the in-dot read on the probe's inputs, and its time
   at 10,208 and 1,868 live keys beside the bound, the twin and
   ``scaled_dot_product_attention`` over the live chunks;
   the paged prefill attention (``paged_prefill``, a chunk's or a suffix
   wave's attention over its rows' pages; :func:`check_paged_prefill`) at
   Llama-3-8B's heads: C 512 at starts 0 / 511 / 512 / 1,536 / 3,584 on an
   8-page chain of 512, 4-row suffix waves at C 32 and 128 (starts 40 / 64
   / 100, a COW boundary page, a pad row, sentinel blocks; pages of 512
   and 16), window 100, e4m3 and e5m2 pools, D 64, bf16 at D 256 and f32
   queries over f32 / bf16 / e4m3 / e5m2 pools (the CUDA-core kernel, f32
   also at D 16): bf16 within ``paged_prefill_bf16_bound``, f32 within
   1e-4, bitwise repeatable, the token write's pages bitwise the whole
   block scatter's; its time at starts 0 and 3,584 beside the bound, the
   twin and pages gathered + masked ``scaled_dot_product_attention``;
   the MoE kernels (``moe_route``, the
   grouped ``moe_gemm`` with its gate/up and down epilogues,
   ``moe_combine``) at Mixtral 8x7B's widths (:func:`check_moe`: T 8, 512
   and 2,048, a capacity factor that drops, every token on two experts;
   bf16 and f32): routing equal outside tokens near a tie, each GEMM within
   ``moe_gemm_bf16_bound``, the combine bit-equal; their time at the decode
   tick's shape beside the bound, the twins and ``torch.bmm`` over the
   dense dispatch;
3. small f32 models on the card (kernels) against the same models on the
   CPU (plain twins): the decoder's prefill logits and the engine's greedy
   token ids at the default loop (on the card the fused 8-step tick
   replayed as a CUDA graph, with a piggybacked chunk; on the CPU the same
   loop eagerly), and on the card at ``decode_steps=1`` too, then the same
   at int8 and int4 (``quantize_decoder_params``; the qgemm kernel on the
   card, its plain twin on the CPU), and a tied int8 head (the kernel's
   K-contiguous form); ``quantize="int4", quant_group_size=8`` on the tiny
   decoder (the generic route) card vs CPU and over ``/dialog/``; greedy
   JSON-mode ids card vs CPU (the JSON tick's graph captured at the first
   JSON request, sampler launches = sampling steps); the tiny encoder's
   ``encode`` and an ``EmbeddingEngine`` coalescing three calls; the tiny
   MoE decoder (``ModelSpec(tiny=True, num_experts=4)``, f32) card vs CPU:
   prefill logits, greedy ids at the default loop and ``/dialog/`` answers
   (:func:`small_moe`); speculative engines (K 4, N 4) on the small f32
   model, dense and int8: greedy ids card vs CPU vs the card's plain engine,
   ``paged_tree`` launches = layers x verify steps (:func:`small_spec`);
   the small model's engine on ``kv_cache_dtype`` "fp8", "fp8_e5m2",
   "bf16" and "fp8" with ``attn_fp8``, a prefix wave and a spec engine on
   an fp8 pool, card vs CPU (:func:`small_fp8`);
4. the main path at full width: a 32-layer bf16 Llama-3-8B with random
   weights drawn on the card, a ``GenerationEngine`` at the default loop
   (fused 8-step ticks as a CUDA graph, piggybacked prefill, the admission
   scheduler) registered in a ``ModelRegistry`` behind ``create_app`` on a
   localhost port, and concurrent greedy ``/dialog/`` requests (two through
   the 512 prefill bucket, one through chunked prefill); launch counts are
   zeroed just before the requests and read just after (a graph's launches
   are counted at each replay), both kernels must have run, every paged
   call through the tensor-core kernel, 32 paged launches per decode step,
   one sampler launch per sampling step (decode steps and activations);
   the four requests read over 6 runs (medians and spreads);
   then a RAG wave on the same engine (a ~1,500-token shared head: one
   miss that registers it, one hit alone, six hits together, one of them
   chunked after the hit; exact hit and copy-on-write counts, the pool back
   to the registry's pages); the decode breakdown: the eager step and the
   replay of the engine's captured 8-step tick, per step, side by side, and
   a 512-token chunk with the tick as one replay of the piggyback graph
   against the chunk run eagerly before the tick's replay (on a chain of
   sentinels, and on slot 0's real chain at starts 0 and 3,584), over 3
   (eager step) and 4 batches (medians and spreads); the Llama-3-8B eager
   chunk split at starts 0 and 3,584 (:func:`engine_chunk_split`:
   attention, the page write, GEMMs, the rest); ``paged_prefill`` launches
   = 32 x the chunk and suffix forwards (here, in the RAG wave, in phases
   3, 10 and 12; no twin call on the card after phase 2); the four
   requests again with ``obs`` off; and the RAG hits served alone by an
   engine with prefix sharing off, their first-step logits held to the
   hits';
5. a load-shedding check (a tiny engine with a queue bound of 1: a burst of
   ``/dialog/`` requests gets 429 with ``Retry-After``) and one
   ``/embeddings/`` and one ``/dialog/`` request through ``cli serve --tiny
   --device cuda``;
6. the RAG request at full width (:func:`rag_phase`): a ruBert-base
   encoder behind ``/embeddings/`` and phase 4's engine behind ``/dialog/``
   in one server, a 1,000,000-row corpus on the card, embed -> exact top-k
   (the KNN kernel) -> answer over the whole top-3 passages (a chunked
   prefill, then paged decode), with its checks and readings;
7. SSE streaming and JSON-constrained ``/dialog/`` at full width
   (:func:`stream_json_phase`): a fresh engine over phase 4's bf16
   tensors, ``warmup(json=True)`` by the registry before ``start()``; the
   warmup's time and ``probe_decode`` beside the replayed step; two greedy
   streams (their deltas equal to their non-streaming twins' text), a
   dropped stream (its slot free within one tick), eight JSON requests at
   temperature 0.8 with two plain ones (the JSON answers parse or are live
   prefixes, the plain ones equal their solo runs), no graph captured and
   no library built by a request after the warmup, sampler launches =
   sampling steps;
8. int8, int4 g64 and int4 g8 Llama-3-8B (``init_int8`` / ``init_int4``,
   32 layers, full width) behind ``/dialog/`` with ``quantize`` (and
   ``quant_group_size``) set (:func:`quant_phase`): phase 4's four
   requests, qgemm launches = 4 x 32 x decode steps (the stream kernel) +
   7 x 32 x prefill forwards (the wgmma kernel), at g8 7 x 32 x (decode
   steps + prefill forwards) all on the generic route, ``weight_bits`` in
   ``/healthz`` and ``/metrics``, the weight bytes on the card, at g8 a
   300-token prefill's argmax against the forward with ``qeinsum_plain``
   patched in, readings over 4 runs and the decode breakdown, the g8 step
   beside int8's;
9. ANN retrieval at scale (:func:`ann_phase`), after phase 8's memory is
   freed: 2,000,000 x 768 through ``ANNIndex.add`` and ``train()`` (wall
   times, bytes on the card), phase 2's ANN kernel checks on it, 64
   planted near-duplicate queries, ANN search
   beside the exact tier over 6 batches at Q 1 / 8 / 32 (medians and
   min-max), planted top-1 >= 99%, ``ann_adc`` / ``ann_rerank`` launches
   equal to the ANN search batches with no plain-twin call, ``knn_topk``
   for the exact tier, a recall@10 curve at nprobe 16 / 64 / 256 / 1024
   with the card's peak memory at each, and the durability drill
   (:func:`durability_drill`: 65,536 x 768,
   WAL + snapshot, reopen with equal searches, ``cli ann verify`` in a
   subprocess clean and after a flipped byte);
10. Mixtral 8x7B at full width, 24 of its 32 layers (the most whose bf16
    weights fit the card), bf16 random weights drawn on the card, behind
    ``/dialog/`` at the JAX ``ModelSpec`` defaults (:func:`mixtral_phase`),
    after every engine of the earlier phases is stopped and allocated
    memory checked near zero: phase 4's four requests over 6 runs, MoE
    launches = 4 x 24 per forward (route, gate/up, down, combine) with no
    plain twin called, one layer's ``moe_mlp`` on a real chunk's
    activations held to its twins, the live experts a decode step, and the
    decode breakdown (MoE kernels, attention and the rest);
11. (run right after phase 7, on phase 4's tensors) tree-verified
    speculative decoding at full width (:func:`spec_phase`): ``speculative
    = 4, spec_width = 4`` behind ``/dialog/`` with ``warmup``; the warmup's
    time, ``probe_spec`` per rung beside the plain tick, each rung's graph
    span; phase 4's four requests and four chats quoting a passage, each
    asking for 256 tokens, over 3 runs (TTFT, tok/s, drafted / accepted,
    tokens a verify step), paged tree launches = 32 x verify steps; greedy
    ids equal to a plain engine's but at flagged near ties, the verify
    path's logits on one state within ``VERIFY_DRIFT_ULPS`` of the decode
    step's; the eager verify step's device split (drafter, tree attention,
    GEMMs, sampler, commit; :func:`verify_breakdown`);
12. (run right after phase 11, on phase 4's tensors) fp8 KV pools at full
    width (:func:`fp8_phase`): one decode step's logits from identical
    prefills, each fp8 pool against a bf16 one (cosine >= 0.98); phase 4's
    four requests over 5 runs on engines with ``kv_cache_dtype="fp8"``
    (dequant, then ``attn_fp8``) and ``"fp8_e5m2"``: pool bytes half phase
    4's, 32 paged launches a decode step all on the pool's fp8 read, TTFT
    and tok/s and the decode breakdown beside phase 4's; a spec engine on an
    fp8 pool (tree launches on the fp8 read);
13. (run right after phase 12, on phase 4's tensors) the legacy contiguous
    KV layout at full width (:func:`legacy_phase`): a paged and a
    ``kv_layout="legacy"`` engine (``decode_kv_chunk`` 512, a 4.3 GB slot
    cache; its chunks and suffixes on the paged prefill kernel's
    contiguous form) cranked through one trace, greedy ids equal, a shared-prefix
    pair hitting the pinned-prefix LRU; phase 4's four requests over
    /dialog/ through the registry on the legacy spec twice:
    ``chunked_decode`` launches = 32 x decode steps, TTFT, tok/s,
    ``kv_read_frac`` and the replayed step beside phase 4's; an fp8
    ``attn_fp8`` legacy engine for one run;
14. the phases' wall seconds, the ``kernels:`` launch-count line, the card
    line, the per-kernel JSON line, and the final ``{"ok": true, ...}``
    line.
"""

from __future__ import annotations

import asyncio
import contextlib
import json
import re
import socket
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
PKG = "django_assistant_bot_tpu_torch"

# published H100 SXM peaks (NVIDIA data sheet, dense): bf16 tensor cores,
# HBM3 bandwidth
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12

# bf16 outputs whose P.V is f32 (flash at head_dim 256) against the f32
# plain twin, per element:
#   |out - ref| <= BF16_REL * |ref| + BF16_ABS
# rounding an f32 result to bf16 moves it by at most half a spacing, 2^-8 of
# its magnitude; BF16_ABS covers the f32 summation order.  The tensor-core
# flash kernel (bf16 at FLASH_MMA_HEAD_DIMS) and every bf16 paged decode
# output round P to bf16 before P.V, as the JAX functions do, and are held to
# ``flash_bf16_bound`` / ``paged_bf16_bound``: 2^-8 |ref| + 2^-8 A + 1e-4, A
# the same attention over |v|, the worst case of rounding P and rounding the
# output, 1e-4 for the summation order.  f32 outputs are held to F32_TOL
# absolute (summation order only).
BF16_REL = 2.0 ** -8
BF16_ABS = 1e-4
F32_TOL = 1e-4
BF16_P_TEXT = "bound 2^-8*(|ref| + A) + 1e-4"


def compare(out, ref, bound=None) -> tuple:
    """(max abs error, max relative error, worst error over its bound) of
    ``out`` against the f32 ``ref``; the check passes iff the last is <= 1.
    ``bound`` replaces the bf16 bound where it is given."""
    import torch

    diff = (out.float() - ref).abs()
    if out.dtype != torch.bfloat16:
        bound = torch.full_like(ref, F32_TOL)
    elif bound is None:
        bound = BF16_REL * ref.abs() + BF16_ABS
    rel = (diff / ref.abs().clamp_min(BF16_ABS)).max().item()
    return diff.max().item(), rel, (diff / bound).max().item()


def tol_text(dtype) -> str:
    import torch

    if dtype == torch.bfloat16:
        return f"bound 2^-8*|ref| + {BF16_ABS:.0e}"
    return f"bound {F32_TOL:.0e}"


def log(*args):
    print(*args, flush=True)


def fail(msg: str) -> None:
    print(f"FAILED: {msg}", file=sys.stderr, flush=True)
    raise SystemExit(1)


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int) -> float:
    """Mean milliseconds per call over ``iters`` calls, CUDA events, after a
    warm-up call."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_device_ms(fn, iters: int) -> float:
    """Device milliseconds per call of ``fn`` from ``iters`` back-to-back
    replays of a CUDA graph that captured one call (CUDA events around the
    replays): the host's work between launches leaves the timing, and no
    profiler is needed.  ``fn``'s kernels count their launches into the
    graph's record, not ``LAUNCHES``; it warms up twice on the capture
    stream first (so per-stream scratch exists before the capture)."""
    import torch

    from django_assistant_bot_tpu_torch import kernels

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with kernels.record_graph_launches(), torch.cuda.graph(g, stream=side):
        fn()
    ms = time_ms(g.replay, iters)
    del g
    return ms


def _device_us(event) -> float:
    """Self device time of a ``key_averages()`` entry, in microseconds."""
    dev_us = getattr(event, "self_device_time_total", None)
    return dev_us if dev_us is not None else getattr(event, "self_cuda_time_total", 0)


EVENT_SPAN = "event span (torch.profiler saw no kernel records)"
# the profiles (each of up to eight attempts) a T 8 routing call gets to show
# its one kernel before phase 2 fails
MOE_ONE_LAUNCH_PROFILES = 4
PROFILER_LOST = [0]  # calls whose device time was taken with CUDA events instead


def device_ms_by_kernel(fn, iters: int, warm: int = 1) -> dict:
    """Device milliseconds per call of each CUDA kernel that ``iters`` calls
    of ``fn`` launch, by the profiler's kernel name (torch.profiler; summed
    durations over ``iters``), after ``warm`` warm-up calls.  Host time
    between launches is left out.  Now and then a profile comes back without
    its kernel records, sometimes several in a row; it is taken again after
    a pause that grows each time, up to eight profiles (two once a call has
    used up its eight).  Where every profile came back empty the device
    time is taken with CUDA events instead, a call at a time (first launch
    to last end, so gaps between its launches count), as
    ``{EVENT_SPAN: ms}``; the call is logged and counted in
    :data:`PROFILER_LOST`."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    attempts = 2 if PROFILER_LOST[0] else 8
    for attempt in range(attempts):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        out = {}
        for e in prof.key_averages():
            us = _device_us(e)
            if us > 0 and e.device_type == torch.autograd.DeviceType.CUDA:
                out[e.key] = out.get(e.key, 0.0) + us / iters / 1e3
        if out:
            return out
        log("  torch.profiler saw no device time; profiling again")
        time.sleep(0.25 * (attempt + 1))
    PROFILER_LOST[0] += 1
    ms = statistics.mean(_event_span_ms(fn, iters))
    log(f"  torch.profiler saw no device time in {attempts} profiles: device time taken "
        f"with CUDA events instead, {ms:.4f} ms per call")
    return {EVENT_SPAN: ms}


def device_ms(fn, iters: int) -> float:
    """Device milliseconds per call (:func:`device_ms_by_kernel`, summed), so
    the kernels' time even where :func:`time_ms` measures the host's launch
    rate."""
    return sum(device_ms_by_kernel(fn, iters).values())


def timed(fn, iters: int) -> tuple:
    """(wall ms per call over back-to-back calls, device ms per call)."""
    return time_ms(fn, iters), device_ms(fn, iters)


# --------------------------------------------------------------------- phase 1
def env_and_build():
    import torch

    from django_assistant_bot_tpu_torch import kernels

    log(f"python {sys.version.split()[0]}  torch {torch.__version__}  cuda {torch.version.cuda}")
    log(f"card: {gpu_line()}  ({torch.cuda.get_device_name(0)}, count {torch.cuda.device_count()})")
    secs = kernels.build()
    log(f"kernel build: {secs:.1f} s")
    for name, text in kernels.BUILD_LOG.items():
        table = ptxas_table(text)
        regs = [r for _, r, _ in table]
        spills = [sp for _, _, sp in table]
        log(f"  ptxas[{name}]: {len(regs)} kernels, at most {max(regs, default=0)} registers "
            f"and {max(spills, default=0)} bytes of spill stores")
        if name in ("paged_decode", "knn_topk", "qgemm", "sample", "ann_adc", "ann_rerank",
                    "moe_route", "moe_gemm", "paged_tree", "paged_prefill"):
            smem = ptxas_smem(text)
            log(f"  ptxas[{name}] per kernel: " + "; ".join(
                f"{label} {r} regs, {sp} B spilled, {smem.get(label, 0)} B static smem"
                for label, r, sp in table))
    # the f32 references below are true f32 products, not TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


# --------------------------------------------------------------------- phase 2
def _flash_case(B, H, KH, S, D, dtype, causal, window, gen):
    import torch

    from django_assistant_bot_tpu_torch.ops.attention import (
        FLASH_MMA_HEAD_DIMS,
        flash_attention,
        flash_attention_plain,
        flash_bf16_bound,
    )

    def mk(heads):
        return torch.randn((B, heads, S, D), generator=gen, device="cuda", dtype=dtype)

    q, k, v = mk(H), mk(KH), mk(KH)
    out = flash_attention(q, k, v, causal=causal, window=window)
    args = (q.float(), k.float(), v.float())
    ref = flash_attention_plain(*args, causal=causal, window=window)
    bound = None
    if dtype == torch.bfloat16 and D in FLASH_MMA_HEAD_DIMS:
        bound = flash_bf16_bound(*args, ref, causal=causal, window=window)
    torch.cuda.synchronize()
    return q, k, v, compare(out, ref, bound)


def _flash_bound_ms(B, H, KH, S, D, causal, window, itemsize) -> tuple:
    """Least time for the same work: operations on the pairs this input
    needs (causal / window band) at the bf16 tensor-core peak, against the
    bytes of q, k, v read once and o written once at the HBM rate."""
    pairs = 0
    for qpos in range(S):
        lo = 0 if window is None else max(0, qpos - window + 1)
        hi = qpos + 1 if causal else S
        pairs += hi - lo
    flops = 4.0 * B * H * D * pairs
    nbytes = itemsize * (2 * B * H * S * D + 2 * B * KH * S * D)
    t_ops = flops / PEAK_BF16_FLOPS * 1e3
    t_bytes = nbytes / PEAK_HBM_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


_KERNEL_RE = re.compile(
    r"(flash_mma_kernel|flash_prefill_kernel|paged_mma_kernel|paged_decode_split_kernel"
    r"|paged_decode_combine_kernel|score_kernel|qgemm_mma_kernel|qgemm_wgmma_kernel"
    r"|qgemm_stream_kernel|qgemm_generic_kernel|adc_kernel|moe_route_kernel"
    r"|moe_combine_kernel|moe_gemm_mma_kernel|moe_gemm_wgmma_kernel|moe_gemm_cc_kernel"
    r"|paged_tree_mma_kernel|paged_tree_cc_kernel|paged_prefill_mma_kernel"
    r"|paged_prefill_cc_kernel)I(\w*?)EEv"
)
_PLAIN_KERNEL_RE = re.compile(
    r"\d+(threshold_kernel|select_kernel|sample_kernel|rerank_kernel"
    r"|moe_gather_kernel)E")


def kernel_label(mangled: str) -> str:
    """``name<type,ints>`` for a mangled kernel name of the three libraries."""
    m = _KERNEL_RE.search(mangled)
    if not m:
        plain = _PLAIN_KERNEL_RE.search(mangled)
        return plain.group(1) if plain else mangled[:60]
    args = m.group(2)
    dtype = "f32," if args.startswith("f") else "bf16," if args.startswith("13__nv_bfloat16") else ""
    ints = ",".join(re.findall(r"L[ib](\d+)E", args))
    return f"{m.group(1)}<{dtype}{ints}>"


def ptxas_table(text: str) -> list:
    """(kernel, registers, bytes of spill stores) per kernel in an
    ``nvcc -Xptxas -v`` log."""
    rows = []
    for chunk in text.split("Compiling entry function '")[1:]:
        regs = re.search(r"Used (\d+) registers", chunk)
        spill = re.search(r"(\d+) bytes spill stores", chunk)
        rows.append((kernel_label(chunk.split("'", 1)[0]), int(regs.group(1)) if regs else 0,
                     int(spill.group(1)) if spill else 0))
    return rows


def ptxas_smem(text: str) -> dict:
    """Static shared memory bytes per kernel in an ``nvcc -Xptxas -v`` log
    (dynamic shared memory, such as the ADC scan's LUT, is not in it)."""
    out = {}
    for chunk in text.split("Compiling entry function '")[1:]:
        smem = re.search(r"(\d+) bytes smem", chunk)
        out[kernel_label(chunk.split("'", 1)[0])] = int(smem.group(1)) if smem else 0
    return out


SASS_OPS = ("HMMA", "LDGSTS", "HGMMA", "UTMALDG", "SYNCS", "LDG.E.128", "STG.E.128")


def sass_table(lib: Path) -> dict:
    """Per kernel in ``lib``'s SASS (``cuobjdump``), the count of each of
    ``SASS_OPS``: HMMA (``mma.sync``), LDGSTS (``cp.async``), HGMMA
    (``wgmma``), UTMALDG (a TMA load), SYNCS (mbarrier operations), and
    LDG.E.128 / STG.E.128 (16-byte global loads and stores).
    Empty if ``cuobjdump`` is missing."""
    import shutil

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(tool).exists():
        return {}
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True, text=True,
                          timeout=120).stdout
    table = {}
    for chunk in sass.split("Function : ")[1:]:
        label = kernel_label(chunk.split(None, 1)[0])
        table[label] = {op: len(re.findall(rf"\b{re.escape(op)}\b", chunk)) for op in SASS_OPS}
    return table


def sass_counts(lib: Path) -> str:
    """``sass_table`` as one line."""
    table = sass_table(lib)
    if not table:
        return "cuobjdump not found or no kernels in the SASS"
    return "; ".join(f"{label}: " + ", ".join(f"{op} {n}" for op, n in counts.items())
                     for label, counts in table.items())


def check_flash(gen) -> dict:
    import torch
    import torch.nn.functional as F

    from django_assistant_bot_tpu_torch import kernels
    from django_assistant_bot_tpu_torch.ops.attention import (
        FLASH_MMA_HEAD_DIMS,
        flash_attention,
        flash_attention_plain,
    )

    cases = [  # (B, H, KH, S, D, dtype, causal, window)
        (1, 32, 8, 256, 128, torch.bfloat16, True, None),
        (4, 32, 8, 256, 128, torch.bfloat16, True, None),
        (1, 32, 8, 512, 128, torch.bfloat16, True, None),
        (4, 32, 8, 512, 128, torch.bfloat16, True, None),
        (1, 32, 8, 2048, 128, torch.bfloat16, True, None),
        (4, 32, 8, 2048, 128, torch.bfloat16, True, None),
        (2, 32, 8, 512, 128, torch.bfloat16, True, 100),
        (2, 32, 8, 512, 128, torch.bfloat16, False, None),
        (2, 32, 8, 512, 64, torch.bfloat16, True, None),
        (2, 32, 8, 512, 64, torch.bfloat16, True, 100),
        (2, 8, 2, 64, 128, torch.bfloat16, True, None),  # a single tile
        (1, 8, 4, 512, 256, torch.bfloat16, True, None),  # Gemma's head_dim
        (2, 8, 2, 256, 128, torch.float32, True, None),
        (1, 8, 4, 256, 256, torch.float32, True, 100),
        (2, 8, 2, 256, 64, torch.float32, False, None),
        (2, 8, 2, 512, 128, torch.float32, True, 200),
    ]
    worst = 0.0
    for B, H, KH, S, D, dtype, causal, window in cases:
        _, _, _, (err, rel, ratio) = _flash_case(B, H, KH, S, D, dtype, causal, window, gen)
        mma = dtype == torch.bfloat16 and D in FLASH_MMA_HEAD_DIMS
        text = BF16_P_TEXT if mma else tol_text(dtype)
        log(f"  flash B={B} H={H} KH={KH} S={S} D={D} {str(dtype)[6:]} causal={causal} "
            f"window={window}: max_abs_err {err:.3e}, max_rel_err {rel:.3e}, "
            f"worst err/bound {ratio:.3f} ({text})")
        if not ratio <= 1.0:
            fail(f"flash_prefill disagrees with its plain twin: err/bound {ratio} > 1")
        if dtype == torch.bfloat16:
            worst = max(worst, err)
    log(f"  flash SASS: {sass_counts(kernels.lib_path('flash_prefill'))}")

    # timings at the main path's buckets (256 and 512 at a batch bucket of
    # 4) and one long bucket; the JSON line takes the 512 bucket.  Wall time
    # per back-to-back call (``ms``) includes what the host spends launching
    # the call; device time per call (torch.profiler, ``device_ms``) is the
    # kernels' time alone.
    B, H, KH, D = 4, 32, 8, 128
    result = {}
    for S, iters in ((256, 100), (512, 50), (2048, 10)):
        q, k, v, _ = _flash_case(B, H, KH, S, D, torch.bfloat16, True, None, gen)
        kr = k.repeat_interleave(H // KH, dim=1)
        vr = v.repeat_interleave(H // KH, dim=1)
        ms, dev = timed(lambda: flash_attention(q, k, v, causal=True), iters)
        library_ms, lib_dev = timed(
            lambda: F.scaled_dot_product_attention(q, kr, vr, is_causal=True), iters
        )
        bound_ms, bound_by = _flash_bound_ms(B, H, KH, S, D, True, None, 2)
        qf, kf, vf = q.float(), k.float(), v.float()
        plain_ms = time_ms(lambda: flash_attention_plain(qf, kf, vf, causal=True),
                           max(3, iters // 5))
        log(f"  flash timing B={B} H={H} KH={KH} S={S} D={D} bf16 causal: kernel wall "
            f"{ms:.4f} ms (device {dev:.4f}), sdpa wall {library_ms:.4f} ms (device "
            f"{lib_dev:.4f}), bound {bound_ms:.4f} ms ({bound_by}); share of the bound, "
            f"wall: kernel {bound_ms / ms:.3f}, sdpa {bound_ms / library_ms:.3f}; device: "
            f"kernel {bound_ms / dev:.3f}, sdpa {bound_ms / lib_dev:.3f}; plain wall "
            f"{plain_ms:.4f} ms")
        if S == 512:
            result = dict(ms=ms, device_ms=dev, plain_ms=plain_ms, bound_ms=bound_ms,
                          bound_by=bound_by, library_ms=library_ms)
    return {
        "name": "flash_prefill",
        "route": "cuda",
        "source": f"{PKG}/csrc/flash_prefill.cu",
        "replaces": "django_assistant_bot_tpu/ops/attention.py:535",
        "max_abs_err": worst,
        **result,
    }


def _paged_case(B, H, KH, D, page, NB, dtype, positions, inactive, window, gen):
    """Random pools and queries for ``positions``; the kernel's output held
    to its bound against the f32 plain twin.  Returns (args, active,
    (max abs err, max rel err, worst err/bound), output)."""
    import torch

    from django_assistant_bot_tpu_torch.ops.attention import (
        paged_bf16_bound,
        paged_gqa_decode_attention,
        paged_gqa_decode_attention_plain,
    )

    P = B * NB
    k_pool = torch.randn((P, KH, page, D), generator=gen, device="cuda", dtype=dtype)
    v_pool = torch.randn((P, KH, page, D), generator=gen, device="cuda", dtype=dtype)
    q = torch.randn((B, H, 1, D), generator=gen, device="cuda", dtype=dtype)
    perm = torch.randperm(P, generator=torch.Generator().manual_seed(1)).reshape(B, NB)
    bt = perm.to(torch.int32).clone()
    for b, pos in enumerate(positions):
        bt[b, pos // page + 1:] = P  # sentinel past each row's allocation
    bt = bt.cuda()
    pos_t = torch.tensor(positions, dtype=torch.int32, device="cuda")
    active = torch.ones(B, dtype=torch.bool)
    for b in inactive:
        active[b] = False
    active = active.cuda()
    args = (q, k_pool, v_pool, bt, pos_t)
    out = paged_gqa_decode_attention(*args, active=active, window=window)
    fargs = (q.float(), k_pool.float(), v_pool.float(), bt, pos_t)
    ref = paged_gqa_decode_attention_plain(*fargs, active=active, window=window)
    bound = None
    if dtype == torch.bfloat16:
        bound = paged_bf16_bound(*fargs, ref, active=active, window=window)
    torch.cuda.synchronize()
    return args, active, compare(out, ref, bound), out


def paged_live_keys(positions, inactive, page, NB, window=None) -> int:
    """Keys the function must read for these rows: the batch's block range
    [lo, hi) of the JAX loop (over active rows), cut by each row's own
    position and window."""
    act = [p for b, p in enumerate(positions) if b not in inactive]
    hi = min(max(act, default=0) // page + 1, NB)
    lo = 0
    if window is not None:
        lo = min(max(min(act, default=NB * page) - window + 1, 0) // page, hi)
    live = 0
    for pos in positions:
        klo = lo * page if window is None else max(lo * page, pos - window + 1)
        live += max(0, min(hi * page - 1, pos) - klo + 1)
    return live


def paged_bound_ms(live, B, H, KH, D, NB, kv_bytes=2, q_bytes=2) -> tuple:
    """Least time for the same work: the live keys' K and V read once (at
    ``kv_bytes`` a value: 1 from an fp8 pool), q read and out written once
    (``q_bytes`` a value), the block tables and positions read, at the HBM
    rate, against 4 H D operations per live key of a KV head at the bf16
    tensor-core peak."""
    nbytes = (live * KH * D * 2 * kv_bytes + 2 * B * H * D * q_bytes + B * NB * 4 + B * 4)
    t_bytes = nbytes / PEAK_HBM_BYTES * 1e3
    t_ops = 4.0 * live * H * D / PEAK_BF16_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def gather_pages(q, kp, vp, bt, nb: int) -> tuple:
    """K and V of each row's first ``nb`` pages gathered dense, [B, KH, nb
    page, D] each, and widened to q's dtype: the library yardsticks'
    gather (the port never calls it)."""
    P, KH, page, D = kp.shape
    phys = bt[:, :nb].long().clamp(0, P - 1)
    return tuple(t[phys].permute(0, 2, 1, 3, 4).reshape(q.shape[0], KH, nb * page, D).to(q.dtype)
                 for t in (kp, vp))


def paged_library_call(args, active, window=None):
    """The library yardstick of a paged decode call (the port never calls
    it): every row's pages up to the batch's last live block gathered dense
    and widened to q's dtype, then one ``scaled_dot_product_attention``
    under each row's mask (keys up to its position, inside the window)."""
    import torch
    import torch.nn.functional as F

    q, kp, vp, bt, pos = args
    page = kp.shape[2]
    nb = min(int(pos[active].max()) // page + 1, bt.shape[1])
    kpos = torch.arange(nb * page, device=q.device)
    keep = kpos[None, :] <= pos[:, None].long()
    if window is not None:
        keep &= kpos[None, :] > pos[:, None].long() - window
    mask = keep[:, None, None, :]

    def call():
        k, v = gather_pages(q, kp, vp, bt, nb)
        return F.scaled_dot_product_attention(q, k, v, attn_mask=mask, enable_gqa=True)

    return call


# fp8 pools (kv_cache_dtype "fp8" / "fp8_e5m2"): the storage formats
FP8_KV = {"e4m3": "float8_e4m3fn", "e5m2": "float8_e5m2"}
FP8_DOT_TEXT = "bound 2^-m*A + u*S + 2^-8*|ref| + 1e-4 (paged_fp8_dot_bound)"
PROBE_TEXT = f"{BF16_P_TEXT} on paged_fp8_dot_probe's inputs"


def _kv_dtype(fmt: str):
    import torch

    return getattr(torch, FP8_KV[fmt]) if fmt in FP8_KV else torch.bfloat16


def narrow_pools(args, fmt, qdtype):
    """A paged decode or tree case with q (and the tree's own K/V) in
    ``qdtype`` and the pools cast to ``fmt`` through the pool writes' cast;
    ``fmt`` None keeps the pools in ``qdtype``."""
    from django_assistant_bot_tpu_torch.ops.quant import to_kv_dtype

    q, kp, vp, *rest = args
    dt = qdtype if fmt is None else _kv_dtype(fmt)
    if len(rest) > 2:  # the tree's: block tables, lengths, tree K, tree V, mask, depths
        rest[2], rest[3] = rest[2].to(qdtype), rest[3].to(qdtype)
    return (q.to(qdtype), to_kv_dtype(kp, dt), to_kv_dtype(vp, dt), *rest)


def _narrow_check(args, active, window, fp8_dot) -> tuple:
    """(output, (max abs err, max rel err, worst err/bound)) of the paged
    kernel on narrow pools against the plain twin on the same pools: the
    dequant read of bf16 q within ``paged_bf16_bound``, of f32 q within
    1e-4, the in-dot read within ``paged_fp8_dot_bound``."""
    import torch

    from django_assistant_bot_tpu_torch.ops.attention import (
        paged_bf16_bound, paged_fp8_dot_bound, paged_gqa_decode_attention,
        paged_gqa_decode_attention_plain)

    q, kp, vp, bt, pos = args
    out = paged_gqa_decode_attention(*args, active=active, window=window, fp8_dot=fp8_dot)
    fargs = (q.float(), kp, vp, bt, pos)
    ref = paged_gqa_decode_attention_plain(*fargs, active=active, window=window,
                                           fp8_dot=fp8_dot)
    if fp8_dot:
        bound = paged_fp8_dot_bound(*fargs, ref, active=active, window=window)
    elif q.dtype == torch.bfloat16:
        bound = paged_bf16_bound(*fargs, ref, active=active, window=window)
    else:
        bound = torch.full_like(ref, F32_TOL)
    torch.cuda.synchronize()
    diff = (out.float() - ref).abs()
    rel = (diff / ref.abs().clamp_min(BF16_ABS)).max().item()
    return out, (diff.max().item(), rel, (diff / bound).max().item())


def check_indot_probe(shapes, B, H, KH, D, page, NB, gen) -> None:
    """K2 on ``paged_fp8_dot_probe``'s inputs at the given shapes, e4m3 and
    e5m2, bf16 and f32 queries: every p rounded at the same scale on both
    sides, so the kernel is held to ``paged_bf16_bound`` of the twin, and
    the control, K1 on the same inputs (the same scores, P not rounded to
    fp8), must miss that bound: else the check could not see a kernel that
    skips the in-dot scheme's rounding of P."""
    import torch

    from django_assistant_bot_tpu_torch.ops.attention import (
        paged_bf16_bound, paged_fp8_dot_probe, paged_gqa_decode_attention,
        paged_gqa_decode_attention_plain)

    for fmt in FP8_KV:
        probe = paged_fp8_dot_probe(B, H, KH, D, B * NB, page, _kv_dtype(fmt), torch.float32,
                                    torch.Generator().manual_seed(0))
        for label, (pos_list, inact) in shapes.items():
            base, active, _, _ = _paged_case(B, H, KH, D, page, NB, torch.bfloat16, pos_list,
                                             inact, None, gen)
            for qdtype in (torch.bfloat16, torch.float32):
                q, kp, vp = (t.cuda() for t in probe)
                args = (q.to(qdtype), kp, vp, *base[3:])
                ref = paged_gqa_decode_attention_plain(q, kp, vp, *base[3:], active=active,
                                                       fp8_dot=True)
                bound = paged_bf16_bound(q, kp, vp, *base[3:], ref, active=active)
                ratios = []
                for fp8_dot in (True, False):
                    out = paged_gqa_decode_attention(*args, active=active, fp8_dot=fp8_dot)
                    torch.cuda.synchronize()
                    ratios.append(((out.float() - ref).abs() / bound).max().item())
                log(f"  paged {fmt} in-dot read on paged_fp8_dot_probe's inputs ({label}) "
                    f"{str(qdtype)[6:]} q: worst err/bound {ratios[0]:.3f} ({PROBE_TEXT}); the "
                    f"control, the dequant read of the same scores: {ratios[1]:.3f}")
                if not ratios[0] <= 1.0:
                    fail(f"paged decode in-dot ({fmt}, {label}, {qdtype}) on the probe's inputs "
                         f"disagrees with its twin: err/bound {ratios[0]} > 1")
                if not ratios[1] > 1.0:
                    fail(f"the in-dot probe ({fmt}, {label}, {qdtype}) cannot tell the in-dot "
                         f"read from the dequant read: control err/bound {ratios[1]} <= 1")


# the paged decode reads timed in phase 2: (entry, pool format, in-dot, the
# JAX function's line)
PAGED_TIMED = (("paged_decode", None, False, "228"), ("paged_decode_fp8", "e4m3", False, "299"),
               ("paged_decode_fp8_dot", "e4m3", True, "293"))


def check_paged(gen, page: int) -> list:
    """Paged decode against its twin.  Its native read (the pool in q's
    dtype): bf16 within ``paged_bf16_bound``, f32 within 1e-4, at the main
    path's shape (B 8, H 32, KH 8, D 128; 10,208 live keys with row 6
    inactive), with windows, small and Gemma's head dims, every group size,
    and rows over many runs.  K1 (the dequant read of an fp8 pool) and K2
    (the fp8 in-dot read) at the main path's shapes (10,208 and phase 4's
    1,868 live keys), e4m3 and e5m2, bf16 and f32 queries, with and without
    a window, each within its bound of the twin on the same pools, on its
    form (``kernels.PAGED_FORMS``) and, for bf16 queries, bitwise
    repeatable; K2 also on :func:`check_indot_probe`'s inputs.  Then each
    read of ``PAGED_TIMED`` at both shapes: wall and device ms, the byte
    bound (at 1 byte a value from an fp8 pool) and its share, the twin's
    time, and the library yardstick (:func:`paged_library_call`).  The cast
    the pool writes take is checked first (:func:`check_kv_cast`)."""
    import torch

    from django_assistant_bot_tpu_torch import kernels
    from django_assistant_bot_tpu_torch.ops.attention import (
        paged_gqa_decode_attention,
        paged_gqa_decode_attention_plain,
    )

    check_kv_cast()
    B, H, KH, D, NB = 8, 32, 8, 128, 8
    # ragged rows over several pages; row 6 inactive (inside the active range)
    positions = [5, page - 1, page, 2 * page + 17, 3 * page + 300, NB * page - 1, 1500, 700]
    inactive = [6]
    cases = [
        (torch.bfloat16, None),
        (torch.bfloat16, 1000),
        (torch.float32, None),
        (torch.float32, 700),
    ]
    worst = {None: 0.0, False: 0.0, True: 0.0}  # native, dequant, in-dot (bf16 q)
    for dtype, window in cases:
        _, _, (err, rel, ratio), _ = _paged_case(
            B, H, KH, D, page, NB, dtype, positions, inactive, window, gen
        )
        text = BF16_P_TEXT if dtype == torch.bfloat16 else tol_text(dtype)
        log(f"  paged B={B} H={H} KH={KH} D={D} page={page} {str(dtype)[6:]} window={window}: "
            f"max_abs_err {err:.3e}, max_rel_err {rel:.3e}, worst err/bound {ratio:.3f} ({text})")
        if not ratio <= 1.0:
            fail(f"paged_decode disagrees with its plain twin: err/bound {ratio} > 1")
        if dtype == torch.bfloat16:
            worst[None] = max(worst[None], err)
    # small head dims (the tiny model's D=16) and Gemma's 256, at G = 2, and
    # the tensor-core kernel at D=64 and every group size
    small = [(4, 2, D2, torch.float32) for D2 in (16, 32, 64, 256)]
    small += [(8 * G2, 8, 64, torch.bfloat16) for G2 in (1, 2, 4, 8)]
    for H2, KH2, D2, dtype in small:
        _, _, (err, rel, ratio), _ = _paged_case(
            4, H2, KH2, D2, 64, 4, dtype, [3, 70, 200, 255], [], None, gen
        )
        text = BF16_P_TEXT if dtype == torch.bfloat16 else tol_text(dtype)
        log(f"  paged H={H2} KH={KH2} D={D2} {str(dtype)[6:]}: max_abs_err {err:.3e}, "
            f"worst err/bound {ratio:.3f} ({text})")
        if not ratio <= 1.0:
            fail(f"paged_decode H={H2} KH={KH2} D={D2} disagrees with its plain twin: {err}")
        if dtype == torch.bfloat16:
            worst[None] = max(worst[None], err)
    # G = 8 (H=64, KH=8) with long rows: a row's runs span more than 16 and
    # more than 32 blocks, so the final merge takes several batches of runs
    for D2, NB2, pos2 in ((64, 8, [4095]), (128, 8, [4095, 3000]), (64, 32, [16383]),
                          (128, 32, [16383, 9000])):
        _, _, (err, rel, ratio), _ = _paged_case(
            len(pos2), 64, 8, D2, page, NB2, torch.bfloat16, pos2, [], None, gen
        )
        log(f"  paged H=64 KH=8 D={D2} page={page} NB={NB2} positions {pos2} bf16: "
            f"max_abs_err {err:.3e}, worst err/bound {ratio:.3f} ({BF16_P_TEXT})")
        if not ratio <= 1.0:
            fail(f"paged_decode H=64 KH=8 D={D2} positions {pos2} disagrees with its plain "
                 f"twin: err/bound {ratio} > 1")
        worst[None] = max(worst[None], err)
    log(f"  paged SASS: {sass_counts(kernels.lib_path('paged_decode'))}")

    # the long ragged timed shape (the JSON line's numbers), then the main
    # path's own: phase 4's four requests in mid-decode, rows 4-7 idle slots
    shapes = {"timed": (positions, inactive),
              "main-path": ([105, 355, 485, 915, 0, 0, 0, 0], [4, 5, 6, 7])}
    for label, (pos_list, inact) in shapes.items():
        base, active, _, _ = _paged_case(B, H, KH, D, page, NB, torch.bfloat16, pos_list, inact,
                                         None, gen)
        for fmt in FP8_KV:
            for qdtype in (torch.bfloat16, torch.float32):
                args = narrow_pools(base, fmt, qdtype)
                for fp8_dot in (False, True):
                    for window in (None, 1000):
                        route = "mma" if qdtype == torch.bfloat16 else "cuda_core"
                        form = f"{route}:{fmt}/{'in_dot' if fp8_dot else 'dequant'}"
                        before = kernels.PAGED_FORMS[form]
                        out, (err, rel, ratio) = _narrow_check(args, active, window, fp8_dot)
                        text = (FP8_DOT_TEXT if fp8_dot else BF16_P_TEXT
                                if qdtype == torch.bfloat16 else tol_text(qdtype))
                        log(f"  paged {fmt} pool, {'in-dot' if fp8_dot else 'dequant'} read "
                            f"({label}) {str(qdtype)[6:]} q window={window}: max_abs_err "
                            f"{err:.3e}, max_rel_err {rel:.3e}, worst err/bound {ratio:.3f} "
                            f"({text}), form {form}")
                        if kernels.PAGED_FORMS[form] != before + 1:
                            fail(f"paged decode ({fmt}, fp8_dot {fp8_dot}) did not take {form}")
                        if not ratio <= 1.0:
                            fail(f"paged decode on an {fmt} pool (fp8_dot {fp8_dot}, {label}, "
                                 f"{qdtype}, window {window}) disagrees with its twin: "
                                 f"err/bound {ratio} > 1")
                        if qdtype == torch.bfloat16:
                            worst[fp8_dot] = max(worst[fp8_dot], err)
                            again = paged_gqa_decode_attention(*args, active=active,
                                                               window=window, fp8_dot=fp8_dot)
                            torch.cuda.synchronize()
                            if not torch.equal(out, again):
                                fail(f"paged decode ({fmt}, fp8_dot {fp8_dot}, {label}): two "
                                     "calls on the same inputs differ")
    check_indot_probe(shapes, B, H, KH, D, page, NB, gen)

    entries = []
    for name, fmt, fp8_dot, line in PAGED_TIMED:
        result = {}
        for label, (pos_list, inact) in shapes.items():
            base, active, (err, _, ratio), out = _paged_case(
                B, H, KH, D, page, NB, torch.bfloat16, pos_list, inact, None, gen)
            if not ratio <= 1.0:
                fail(f"paged_decode ({label} shape) disagrees with its plain twin: {ratio} > 1")
            args = narrow_pools(base, fmt, torch.bfloat16)
            def fn():
                return paged_gqa_decode_attention(*args, active=active, fp8_dot=fp8_dot)

            out, again = fn(), fn()
            torch.cuda.synchronize()
            if not torch.equal(out, again):
                fail(f"{name} ({label} shape): two calls on the same inputs differ")
            ms, dev = timed(fn, 200)
            q, kp, vp, bt, pos_t = args
            pools = (kp, vp) if fmt else (kp.float(), vp.float())  # the twin reads any pool
            plain_ms = time_ms(lambda: paged_gqa_decode_attention_plain(
                q.float(), *pools, bt, pos_t, active=active, fp8_dot=fp8_dot), 10)
            lib = paged_library_call(args, active)
            lib_err = (lib().float() - out.float())[active].abs().max().item()
            lib_ms, lib_dev = timed(lib, 50)
            live = paged_live_keys(pos_list, inact, page, NB)
            bound_ms, bound_by = paged_bound_ms(live, B, H, KH, D, NB,
                                                kv_bytes=kp.element_size())
            scratch = kernels.paged_scratch_floats(
                q.device, (1, kernels._KV_CODE[kp.dtype], B, H, KH, page, NB, D))
            pool = ("bf16 pool" if fmt is None
                    else f"{fmt} pool, {'in-dot' if fp8_dot else 'dequant'} read")
            log(f"  paged timing, {pool} ({label}) B={B} H={H} KH={KH} D={D} page={page} bf16 q, "
                f"{live} live keys: kernel wall {ms:.4f} ms (device {dev:.4f}), plain wall "
                f"{plain_ms:.4f} ms, library (pages gathered, widened to q's dtype + "
                f"scaled_dot_product_attention) wall {lib_ms:.4f} ms (device {lib_dev:.4f}; max "
                f"|library - kernel| over active rows {lib_err:.3e}), bound at "
                f"{kp.element_size()} byte(s) a pool value {bound_ms:.4f} ms ({bound_by}); share "
                f"of the bound: wall {bound_ms / ms:.3f}, device {bound_ms / dev:.3f}; repeat "
                f"bitwise-equal; scratch {scratch} f32")
            if label == "timed":
                result = dict(ms=ms, device_ms=dev, plain_ms=plain_ms, bound_ms=bound_ms,
                              bound_by=bound_by, library_ms=lib_ms)
            else:
                result.update(main_path_ms=ms, main_path_device_ms=dev,
                              main_path_bound_ms=bound_ms, main_path_library_ms=lib_ms)
        entries.append({
            "name": name,
            "route": "cuda",
            "source": f"{PKG}/csrc/paged_decode.cu",
            "replaces": f"django_assistant_bot_tpu/ops/attention.py:{line}",
            "max_abs_err": worst[None if fmt is None else fp8_dot],
            **result,
        })
    return entries


# ----------------------------------------------- chunked decode (the legacy slot cache)
def _chunked_case(B, H, KH, D, chunk, NB, dtype, positions, inactive, gen):
    """Random queries and a slot cache ``[B, KH, NB * chunk, D]`` in
    ``dtype`` for ``positions`` (rows in ``inactive`` off)."""
    import torch

    S = NB * chunk
    q = torch.randn((B, H, 1, D), generator=gen, device="cuda", dtype=dtype)
    k = torch.randn((B, KH, S, D), generator=gen, device="cuda", dtype=dtype)
    v = torch.randn((B, KH, S, D), generator=gen, device="cuda", dtype=dtype)
    pos = torch.tensor(positions, dtype=torch.int32, device="cuda")
    active = torch.ones(B, dtype=torch.bool)
    active[list(inactive)] = False
    return q, k, v, pos, active.cuda()


def _as_pages(cache, chunk) -> tuple:
    """The slot cache's chunks as a page pool (page ``b * NB + j`` is chunk
    j of row b) and its identity block table."""
    import torch

    B, KH, S, D = cache.shape
    NB = S // chunk
    pool = cache.reshape(B, KH, NB, chunk, D).transpose(1, 2).reshape(B * NB, KH, chunk, D)
    bt = torch.arange(B * NB, dtype=torch.int32, device=cache.device).reshape(B, NB)
    return pool.contiguous(), bt


def chunked_library_call(q, k, v, pos, active, chunk):
    """The library yardstick of a chunked decode call (the port never calls
    it): the cache sliced to the batch's live chunks, ``[:, :, :hi *
    chunk]`` (a view: no copy), widened to q's dtype where it is narrower,
    and one ``scaled_dot_product_attention`` under each row's causal mask
    with ``enable_gqa``."""
    import torch
    import torch.nn.functional as F

    hi = int(pos[active].max()) // chunk + 1
    kpos = torch.arange(hi * chunk, device=q.device)
    mask = (kpos[None, :] <= pos[:, None].long())[:, None, None, :]

    def call():
        kk, vv = k[:, :, :hi * chunk], v[:, :, :hi * chunk]
        if kk.dtype != q.dtype:
            kk, vv = kk.to(q.dtype), vv.to(q.dtype)
        return F.scaled_dot_product_attention(q, kk, vv, attn_mask=mask, enable_gqa=True)

    return call


def check_chunked(gen) -> list:
    """The chunked decode read (``kernels.chunked_decode``: the paged
    kernels' contiguous form over the legacy slot cache) against its twin:
    bf16 and f32 queries; the native read, K1 (the dequant read) and K2
    (the in-dot read) of e4m3 and e5m2 caches; ragged rows with one
    inactive, a window whose lower chunk is past 0, a batch whose ``hi`` is
    1; bf16 outputs within ``chunked_bf16_bound``, f32 within 1e-4, in-dot
    within ``chunked_fp8_dot_bound``, each counted on its form
    (``kernels.CHUNKED_FORMS``) and never as ``paged_decode``.  Every case
    is also laid out as pages with an identity block table and read by
    ``paged_decode``: the bytes must be equal (one reduction order).  K2 on
    ``paged_fp8_dot_probe``'s inputs laid out as the cache: within
    ``chunked_bf16_bound``, the dequant control outside it.  Then the
    native bf16 read timed at B 8, H 32, KH 8, D 128, S 4096, chunk 512 at
    10,208 and 1,868 live keys (phase 2's paged shapes): wall and device
    ms, the byte bound and its share, the twin's ms, and
    ``scaled_dot_product_attention`` over the live chunks."""
    import torch

    from django_assistant_bot_tpu_torch import kernels
    from django_assistant_bot_tpu_torch.ops.attention import (
        chunked_bf16_bound, chunked_fp8_dot_bound, chunked_gqa_decode_attention,
        chunked_gqa_decode_attention_plain, paged_fp8_dot_probe, paged_gqa_decode_attention)
    from django_assistant_bot_tpu_torch.ops.quant import to_kv_dtype

    B, H, KH, D, chunk, NB = 8, 32, 8, 128, 512, 8
    shapes = {
        "timed": ([5, 511, 512, 1041, 1836, 4095, 1500, 700], [6], None),
        "main-path": ([105, 355, 485, 915, 0, 0, 0, 0], [4, 5, 6, 7], None),
        "window lo > 0": ([1000, 1500, 2047, 1100, 3000, 2500, 4000, 1200], [3], 700),
        "hi = 1": ([0, 3, 511, 100, 0, 7, 1, 2], [], None),
    }
    worst = 0.0
    for label, (positions, inactive, window) in shapes.items():
        for qdtype in (torch.bfloat16, torch.float32):
            q, k, v, pos, active = _chunked_case(B, H, KH, D, chunk, NB, qdtype, positions,
                                                 inactive, gen)
            for fmt, fp8_dot in ((None, False), ("e4m3", False), ("e5m2", False),
                                 ("e4m3", True), ("e5m2", True)):
                if fmt is None:
                    kc, vc = k, v
                else:
                    kc, vc = (to_kv_dtype(t, _kv_dtype(fmt)) for t in (k, v))
                route = "mma" if qdtype == torch.bfloat16 else "cuda_core"
                form = f"{route}:{kernels.paged_read(qdtype, kc.dtype, fp8_dot)}"
                before, forms = kernels.launch_counts(), dict(kernels.CHUNKED_FORMS)
                kw = dict(chunk=chunk, active=active, window=window)
                out = chunked_gqa_decode_attention(q, kc, vc, pos, fp8_dot=fp8_dot, **kw)
                after = kernels.launch_counts()
                if (after["chunked_decode"] != before["chunked_decode"] + 1
                        or after["paged_decode"] != before["paged_decode"]
                        or kernels.CHUNKED_FORMS[form] != forms[form] + 1):
                    fail(f"chunked decode ({label}, {fmt}, fp8_dot {fp8_dot}) was not counted "
                         f"once on {form}")
                ref = chunked_gqa_decode_attention_plain(q.float(), kc, vc, pos, fp8_dot=fp8_dot,
                                                         **kw)
                if fp8_dot:
                    bound, text = chunked_fp8_dot_bound(q.float(), kc, vc, pos, ref, **kw), \
                        FP8_DOT_TEXT.replace("paged", "chunked")
                elif qdtype == torch.bfloat16:
                    bound, text = chunked_bf16_bound(q.float(), kc, vc, pos, ref, **kw), \
                        BF16_P_TEXT
                else:
                    bound, text = torch.full_like(ref, F32_TOL), tol_text(qdtype)
                kp, bt = _as_pages(kc, chunk)
                vp, _ = _as_pages(vc, chunk)
                paged = paged_gqa_decode_attention(q, kp, vp, bt, pos, active=active,
                                                   window=window, fp8_dot=fp8_dot)
                torch.cuda.synchronize()
                live = active[:, None, None, None].expand_as(ref)
                diff = (out.float() - ref).abs()
                err, ratio = diff[live].max().item(), (diff / bound)[live].max().item()
                same = torch.equal(out.view(torch.uint8), paged.view(torch.uint8))
                log(f"  chunked {label} {str(qdtype)[6:]} q, "
                    f"{'native' if fmt is None else fmt + (' in-dot' if fp8_dot else ' dequant')} "
                    f"read, window={window}: max_abs_err {err:.3e}, worst err/bound "
                    f"{ratio:.3f} ({text}), {form}; bit-equal to paged_decode on the same "
                    f"K/V as pages: {same}")
                if not ratio <= 1.0 or not bool(torch.isfinite(out[live]).all()):
                    fail(f"chunked decode ({label}, {qdtype}, {fmt}, fp8_dot {fp8_dot}) "
                         f"disagrees with its twin: err/bound {ratio} > 1")
                if not same:
                    fail(f"chunked decode ({label}, {qdtype}, {fmt}, fp8_dot {fp8_dot}) differs "
                         "from paged_decode on the same K/V laid out as pages")
                if qdtype == torch.bfloat16 and fmt is None:
                    worst = max(worst, err)
    # K2 on the probe's inputs laid out as the slot cache
    for fmt in FP8_KV:
        q, kp, vp = (t.cuda() for t in paged_fp8_dot_probe(
            B, H, KH, D, B * NB, chunk, _kv_dtype(fmt), torch.float32,
            torch.Generator().manual_seed(0)))
        k, v = (t.view(torch.uint8).reshape(B, NB, KH, chunk, D).transpose(1, 2)
                .reshape(B, KH, NB * chunk, D).contiguous().view(_kv_dtype(fmt)) for t in (kp, vp))
        positions, inactive, _ = shapes["timed"]
        _, _, _, pos, active = _chunked_case(B, H, KH, D, chunk, NB, torch.bfloat16, positions,
                                             inactive, gen)
        kw = dict(chunk=chunk, active=active)
        ref = chunked_gqa_decode_attention_plain(q, k, v, pos, fp8_dot=True, **kw)
        bound = chunked_bf16_bound(q, k, v, pos, ref, **kw)
        for qdtype in (torch.bfloat16, torch.float32):
            ratios = []
            for fp8_dot in (True, False):
                out = chunked_gqa_decode_attention(q.to(qdtype), k, v, pos, fp8_dot=fp8_dot, **kw)
                torch.cuda.synchronize()
                ratios.append(((out.float() - ref).abs() / bound).max().item())
            log(f"  chunked {fmt} in-dot read on paged_fp8_dot_probe's inputs {str(qdtype)[6:]} "
                f"q: worst err/bound {ratios[0]:.3f} ({PROBE_TEXT}); the control, the dequant "
                f"read of the same scores: {ratios[1]:.3f}")
            if not ratios[0] <= 1.0:
                fail(f"chunked in-dot ({fmt}, {qdtype}) on the probe's inputs disagrees with its "
                     f"twin: err/bound {ratios[0]} > 1")
            if not ratios[1] > 1.0:
                fail(f"the chunked in-dot probe ({fmt}, {qdtype}) cannot tell the in-dot read "
                     f"from the dequant read: control err/bound {ratios[1]} <= 1")

    result = {}
    for label in ("timed", "main-path"):
        positions, inactive, _ = shapes[label]
        q, k, v, pos, active = _chunked_case(B, H, KH, D, chunk, NB, torch.bfloat16, positions,
                                             inactive, gen)

        def fn():
            return chunked_gqa_decode_attention(q, k, v, pos, chunk=chunk, active=active)

        out, again = fn(), fn()
        torch.cuda.synchronize()
        if not torch.equal(out, again):
            fail(f"chunked_decode ({label} shape): two calls on the same inputs differ")
        ms, dev = timed(fn, 200)
        plain_ms = time_ms(lambda: chunked_gqa_decode_attention_plain(
            q.float(), k.float(), v.float(), pos, chunk=chunk, active=active), 10)
        lib = chunked_library_call(q, k, v, pos, active, chunk)
        lib_err = (lib().float() - out.float())[active].abs().max().item()
        lib_ms, lib_dev = timed(lib, 50)
        live = paged_live_keys(positions, inactive, chunk, NB)
        # no block table: NB = 0 leaves its bytes out of the bound
        bound_ms, bound_by = paged_bound_ms(live, B, H, KH, D, 0)
        log(f"  chunked timing ({label}) B={B} H={H} KH={KH} D={D} S={NB * chunk} chunk={chunk} "
            f"bf16, {live} live keys: kernel wall {ms:.4f} ms (device {dev:.4f}), plain wall "
            f"{plain_ms:.4f} ms, library (the live chunks' slice + scaled_dot_product_attention "
            f"with enable_gqa) wall {lib_ms:.4f} ms (device {lib_dev:.4f}; max |library - "
            f"kernel| over active rows {lib_err:.3e}), bound {bound_ms:.4f} ms ({bound_by}); "
            f"share of the bound: wall {bound_ms / ms:.3f}, device {bound_ms / dev:.3f}")
        if label == "timed":
            result = dict(ms=ms, device_ms=dev, plain_ms=plain_ms, bound_ms=bound_ms,
                          bound_by=bound_by, library_ms=lib_ms)
        else:
            result.update(main_path_ms=ms, main_path_device_ms=dev,
                          main_path_bound_ms=bound_ms, main_path_library_ms=lib_ms)
    return [{
        "name": "chunked_decode",
        "route": "cuda",
        "source": f"{PKG}/csrc/paged_decode.cu",
        "replaces": "django_assistant_bot_tpu/ops/attention.py:223",
        "max_abs_err": worst,
        **result,
    }]


def check_kv_cast() -> None:
    """``to_kv_dtype`` (every pool write's cast) on the card against the
    CPU's bits (the tier-1 tests hold the CPU's to JAX's ``astype``) on a
    grid over +-500, the e5m2 overflow edge, subnormals, inf and NaN, from
    f32 and bf16 (NaN as NaN); and what torch's own CUDA cast gives past
    e4m3's range (JAX: NaN)."""
    import torch

    from django_assistant_bot_tpu_torch.ops.quant import to_kv_dtype

    extra = [464.0, -464.0, 464.0001, 448.0, 61440.0, -61440.0, 61439.99, 57344.0, 65536.0,
             1e6, float("inf"), float("-inf"), float("nan"), 0.0, -0.0]
    sub = [2.0 ** -e for e in range(6, 20)]
    grid = torch.cat([torch.linspace(-500, 500, 200_001), torch.tensor(extra + sub),
                      -torch.tensor(sub) * 1.37])
    n = 0
    for src in (torch.float32, torch.bfloat16):
        x = grid.to(src)
        for fmt in FP8_KV:
            dt = _kv_dtype(fmt)
            cpu = to_kv_dtype(x, dt)
            card = to_kv_dtype(x.cuda(), dt).cpu()
            nan = torch.isnan(cpu.float())
            same = (torch.equal(torch.isnan(card.float()), nan)
                    and torch.equal(card.view(torch.uint8)[~nan], cpu.view(torch.uint8)[~nan]))
            if not same:
                fail(f"to_kv_dtype on the card ({fmt} from {src}) differs from the CPU's bits")
            n += x.numel()
    probe = torch.tensor([464.1, 1000.0, float("inf")], device="cuda")
    raw = probe.to(torch.float8_e4m3fn).float().tolist()
    log(f"  pool cast on the card: to_kv_dtype bit-equal to the CPU's over {n} values (e4m3 and "
        f"e5m2, from f32 and bf16, NaN as NaN); torch's own CUDA cast of 464.1, 1000, inf to "
        f"e4m3fn gives {raw} (JAX's astype: NaN)")


TREE_WIDTH, TREE_DEPTH = 4, 4  # phase 11's tree: T = 1 + 4 x 4 = 17 nodes


def _tree_case(lengths, dtype, gen, *, B=8, H=32, KH=8, D=128, page=512, NB=8,
               tree=(TREE_WIDTH, TREE_DEPTH)):
    """Random pools, tree queries and tree K/V at Llama-3-8B's heads for
    ``lengths`` (each row's pages a random chain, sentinels past its
    allocation); the mask and depths of the ``tree`` = (N, K) tree (phase
    11's (4, 4) by default)."""
    import torch

    from django_assistant_bot_tpu_torch.ops.speculative import make_tree_spec

    spec = make_tree_spec(*tree)
    T, P = spec.size, B * NB
    mk = lambda *shape: torch.randn(shape, generator=gen, device="cuda", dtype=dtype)  # noqa: E731
    q, kp, vp, tk, tv = mk(B, H, T, D), mk(P, KH, page, D), mk(P, KH, page, D), \
        mk(B, KH, T, D), mk(B, KH, T, D)
    bt = torch.randperm(P, generator=torch.Generator().manual_seed(1)).reshape(B, NB)
    bt = bt.to(torch.int32)
    for b, n in enumerate(lengths):
        bt[b, -(-n // page):] = P
    return (q, kp, vp, bt.cuda(), torch.tensor(lengths, dtype=torch.int32, device="cuda"), tk, tv,
            torch.from_numpy(spec.anc_mask).cuda(), torch.from_numpy(spec.depths).cuda())


def _tree_check(args, window=None) -> tuple:
    """(output, (max abs err, max rel err, worst err/bound)) of the kernel
    against the f32 twin on the same inputs (bf16: ``paged_tree_bf16_bound``)."""
    import torch

    from django_assistant_bot_tpu_torch.ops.attention import (
        paged_tree_attention, paged_tree_attention_plain, paged_tree_bf16_bound)

    q, kp, vp, bt, ln, tk, tv, anc, dep = args
    out = paged_tree_attention(*args, window=window)
    fargs = (q.float(), kp.float(), vp.float(), bt, ln, tk.float(), tv.float(), anc, dep)
    ref = paged_tree_attention_plain(*fargs, window=window)
    bound = None
    if q.dtype == torch.bfloat16:
        bound = paged_tree_bf16_bound(*fargs, ref, window=window)
    torch.cuda.synchronize()
    return out, compare(out, ref, bound)


def tree_bound_ms(args, kv_bytes=None) -> tuple:
    """Least time for the tree read: each live prefix key's K and V (below
    the row's length) read once (at ``kv_bytes`` a value, default q's
    size), the tree's K/V, q, out, the block tables, lengths, mask and
    depths moved once, at the HBM rate, against 4 D H T operations per live
    prefix key and 4 D H per ancestor pair of the tree at the bf16
    tensor-core peak."""
    q, kp, vp, bt, ln, tk, tv, anc, dep = args
    B, H, T, D = q.shape
    KH = kp.shape[1]
    live = int(ln.sum())
    pairs = int(anc.sum()) * B
    kv_bytes = q.element_size() if kv_bytes is None else kv_bytes
    nbytes = (live * KH * D * 2 * kv_bytes
              + (tk.numel() + tv.numel() + 2 * q.numel()) * q.element_size()
              + bt.numel() * 4 + B * 4 + anc.numel() + T * 4)
    t_bytes = nbytes / PEAK_HBM_BYTES * 1e3
    t_ops = (4.0 * D * H * T * live + 4.0 * D * H * pairs) / PEAK_BF16_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def tree_library_call(args):
    """The library yardstick (the port never calls it): every row's pages up
    to the batch's longest prefix gathered dense (:func:`gather_pages`), the
    tree's K/V concatenated, then one ``scaled_dot_product_attention`` under
    the [B, 1, T, S + T] mask (the prefix below each row's length, the
    tree's ancestors)."""
    import torch
    import torch.nn.functional as F

    q, kp, vp, bt, ln, tk, tv, anc, dep = args
    B, H, T, D = q.shape
    page = kp.shape[2]
    nb = -(-int(ln.max()) // page)
    S = nb * page
    kpos = torch.arange(S, device=q.device)
    prefix = (kpos[None, :] < ln[:, None].long())[:, None, None, :].expand(B, 1, T, S)
    mask = torch.cat([prefix, anc[None, None].expand(B, 1, T, T)], dim=3)

    def call():
        k, v = gather_pages(q, kp, vp, bt, nb)
        k = torch.cat([k, tk], dim=2)
        v = torch.cat([v, tv], dim=2)
        return F.scaled_dot_product_attention(q, k, v, attn_mask=mask, enable_gqa=True)

    return call


# the tree reads timed in phase 2: (entry, pool format, the JAX function's line)
TREE_TIMED = (("paged_tree", None, "328"), ("paged_tree_fp8", "e4m3", "377"))
# phase 2's further tree cases: (label, lengths, (N, K) tree, H): one row
# holding most of the keys, and trees of 65 and 129 nodes (two and three
# tree tiles, several row chunks) at G 4 and 8
TREE_MORE = (("lopsided", [4000, 3, 0, 17, 0, 0, 0, 1], (TREE_WIDTH, TREE_DEPTH), 32),
             ("T65 G4", [6, 512, 513, 1042, 1837, 4096, 1501, 701], (8, 8), 32),
             ("T65 G8", [106, 356, 486, 917, 1, 1, 1, 0], (8, 8), 64),
             ("T129 G4", [106, 356, 486, 917, 1, 1, 1, 0], (16, 8), 32),
             ("T129 G8", [4000, 3, 0, 17, 0, 0, 0, 1], (16, 8), 64))


def tree_partition(lengths, T, plan, *, H=32, KH=8, D=128, page=512, NB=8, window=None,
                   sms=132):
    """The tensor-core tree kernel's work on these lengths, as the kernel
    splits it (csrc/paged_tree.cu: items, blocks that take them, their equal
    runs): (items, working blocks, the most items a block, waves of the
    grid over the card, scratch bytes a call: the partials written and read
    back)."""
    from django_assistant_bot_tpu_torch import kernels

    cpp, ntt = -(-page // 64), -(-T // 32)
    rows = []  # items of each row, in order
    for n in lengths:
        klen = min(max(n, 0), NB * page)
        klo = min(max(n - window + 1, 0), klen) if window else 0
        chunk = lambda k: (k // page) * cpp + (k % page) // 64  # noqa: E731
        npre = chunk(klen - 1) - chunk(klo) + 1 if klen > klo else 0
        rows += [npre + ntt] * (KH * plan.row_chunks)
    total = sum(rows)
    nblk = max(1, min(plan.blocks, -(-total // plan.min_items)))
    starts = [k * total // nblk for k in range(nblk + 1)]
    edges, at = set(), 0
    for n in rows:
        edges.add(at)
        at += n
    edges.add(at)
    # a block writes a partial for each end of its range inside a row
    partials = sum((starts[k] not in edges) + (starts[k + 1] not in edges)
                   for k in range(nblk) if starts[k] < starts[k + 1])
    rows_live = min(16 * plan.warps, H // KH * T)
    nbytes = 2 * partials * rows_live * (D + 2) * 4
    waves = plan.blocks / (kernels.PAGED_TREE_BLOCKS_PER_SM * sms)
    return total, nblk, max(b - a for a, b in zip(starts, starts[1:])), waves, nbytes


def check_paged_tree(gen) -> list:
    """``paged_tree`` (the speculative verify read) against its twin at the
    main path's shapes: 8 slots of Llama-3-8B's heads (H 32, KH 8, D 128),
    page 512, the (4, 4) tree (T 17): 10,208 live prefix keys (paged
    decode's timed rows) and 1,868 (phase 4's four requests mid-decode, four
    idle slots, one of them at length 0); over pools in q's dtype and (K3)
    over e4m3 and e5m2 prefix pages (the tree's own K/V in q's dtype; the
    JAX tree read has no in-dot scheme); bf16 (the tensor-core kernel)
    within ``paged_tree_bf16_bound``, also with a window, f32 (the CUDA-core
    kernel) within 1e-4; each call on its form (``kernels.PAGED_TREE_FORMS``),
    two bf16 calls bitwise equal; the same for ``TREE_MORE``'s lengths and
    trees (native and e4m3 pools, with and without a window; f32 at the
    129-node tree).  Then each read of ``TREE_TIMED`` at both shapes: the
    launch's grid and its items a block, waves and scratch bytes
    (:func:`tree_partition`), wall and device ms, the byte bound (at 1 byte
    a pool value from an fp8 pool) and its share, the plain twin's time,
    and the library yardstick (:func:`tree_library_call`)."""
    import torch

    from django_assistant_bot_tpu_torch import kernels
    from django_assistant_bot_tpu_torch.ops.attention import (
        paged_tree_attention, paged_tree_attention_plain)

    shapes = {"timed": [6, 512, 513, 1042, 1837, 4096, 1501, 701],
              "main-path": [106, 356, 486, 917, 1, 1, 1, 0]}
    worst = {None: 0.0, "e4m3": 0.0}
    for label, lengths in shapes.items():
        base = _tree_case(lengths, torch.bfloat16, gen)
        for fmt in (None, *FP8_KV):
            for dtype, window in ((torch.bfloat16, None), (torch.bfloat16, 700),
                                  (torch.float32, None)):
                args = (_tree_case(lengths, dtype, gen) if fmt is None
                        else narrow_pools(base, fmt, dtype))
                route = "mma" if dtype == torch.bfloat16 else "cuda_core"
                form = f"{route}:{'native' if fmt is None else fmt + '/dequant'}"
                before = kernels.PAGED_TREE_FORMS[form]
                out, (err, rel, ratio) = _tree_check(args, window)
                text = BF16_P_TEXT if dtype == torch.bfloat16 else tol_text(dtype)
                log(f"  paged_tree {fmt or 'native'} pool ({label}, {sum(lengths)} live keys) "
                    f"B=8 H=32 KH=8 D=128 T=17 page=512 {str(dtype)[6:]} window={window}: "
                    f"max_abs_err {err:.3e}, max_rel_err {rel:.3e}, worst err/bound {ratio:.3f} "
                    f"({text}), form {form}")
                if kernels.PAGED_TREE_FORMS[form] != before + 1:
                    fail(f"paged_tree ({label}) did not take {form}")
                if not ratio <= 1.0:
                    fail(f"paged_tree ({fmt or 'native'} pool, {label}, {dtype}, window "
                         f"{window}) disagrees with its twin: err/bound {ratio} > 1")
                if dtype == torch.bfloat16:
                    worst[fmt] = max(worst.get(fmt, 0.0), err)
                    again = paged_tree_attention(*args, window=window)
                    torch.cuda.synchronize()
                    if not torch.equal(out, again):
                        fail(f"paged_tree ({fmt or 'native'}, {label}): two calls on the same "
                             "inputs differ")
    # the persistent grid's edges: lopsided lengths, trees past one tile
    for label, lengths, tree, H in TREE_MORE:
        for fmt in (None, "e4m3"):
            for window in (None, 700):
                args = narrow_pools(_tree_case(lengths, torch.bfloat16, gen, H=H, tree=tree),
                                    fmt, torch.bfloat16)
                T = args[0].shape[2]
                form = f"mma:{'native' if fmt is None else fmt + '/dequant'}"
                before = kernels.PAGED_TREE_FORMS[form]
                out, (err, rel, ratio) = _tree_check(args, window)
                again = paged_tree_attention(*args, window=window)
                torch.cuda.synchronize()
                log(f"  paged_tree {fmt or 'native'} pool ({label}, T={T}, H={H}, "
                    f"{sum(lengths)} live keys) window={window}: max_abs_err {err:.3e}, "
                    f"worst err/bound {ratio:.3f} ({BF16_P_TEXT}), form {form}, a second call "
                    f"{'bitwise equal' if torch.equal(out, again) else 'DIFFERENT'}")
                if kernels.PAGED_TREE_FORMS[form] != before + 2:
                    fail(f"paged_tree ({label}) did not take {form}")
                if not ratio <= 1.0:
                    fail(f"paged_tree ({fmt or 'native'} pool, {label}, window {window}) "
                         f"disagrees with its twin: err/bound {ratio} > 1")
                if not torch.equal(out, again):
                    fail(f"paged_tree ({fmt or 'native'}, {label}): two calls on the same "
                         "inputs differ")
                worst[fmt] = max(worst[fmt], err)
    args = _tree_case(TREE_MORE[-1][1], torch.float32, gen, H=64, tree=TREE_MORE[-1][2])
    _, (err, rel, ratio) = _tree_check(args)
    log(f"  paged_tree f32 (cuda_core, T=129 G8): max_abs_err {err:.3e} ({tol_text(torch.float32)})")
    if not ratio <= 1.0:
        fail(f"paged_tree f32 at T=129 disagrees with its twin: err/bound {ratio} > 1")
    log(f"  paged_tree SASS: {sass_counts(kernels.lib_path('paged_tree'))}")
    entries = []
    sms = kernels._sm_count(torch.cuda.current_device())
    for name, fmt, line in TREE_TIMED:
        result = {}
        for label, lengths in shapes.items():
            args = narrow_pools(_tree_case(lengths, torch.bfloat16, gen), fmt, torch.bfloat16)
            out = paged_tree_attention(*args)
            ms, dev = timed(lambda: paged_tree_attention(*args), 200)
            q, kp, vp, bt, ln, tk, tv, anc, dep = args
            fargs = (q.float(), kp.float(), vp.float(), bt, ln, tk.float(), tv.float(), anc, dep)
            plain_ms = time_ms(lambda: paged_tree_attention_plain(*fargs), 5)
            lib = tree_library_call(args)
            lib_err = (lib().float() - out.float()).abs().max().item()
            lib_ms, lib_dev = timed(lib, 50)
            bound_ms, bound_by = tree_bound_ms(args, kv_bytes=kp.element_size())
            T = q.shape[2]
            plan = kernels.paged_tree_plan(8, 32, 8, T, 128, 512, 8, sms)
            items, nblk, most, waves, sbytes = tree_partition(lengths, T, plan, sms=sms)
            log(f"  paged_tree timing, {fmt or 'bf16'} pool ({label}) B=8 H=32 KH=8 D=128 T=17 "
                f"page=512 bf16 q, {sum(lengths)} live keys, grid {plan.blocks} blocks of "
                f"{plan.warps} warps ({plan.row_chunks} row chunk), {items} items on {nblk} "
                f"blocks (at most {most} a block), {waves:.2f} waves, scratch "
                f"{sbytes / 1e6:.3f} MB a call (partials written and read): "
                f"kernel wall {ms:.4f} ms (device {dev:.4f}), plain wall {plain_ms:.4f} "
                f"ms, library (pages gathered, widened to q's dtype + concat + "
                f"scaled_dot_product_attention) wall {lib_ms:.4f} ms (device {lib_dev:.4f}; max "
                f"|library - kernel| {lib_err:.3e}), bound at {kp.element_size()} byte(s) a pool "
                f"value {bound_ms:.4f} ms ({bound_by}); share of the bound: wall "
                f"{bound_ms / ms:.3f}, device {bound_ms / dev:.3f}")
            if label == "timed":
                result = dict(ms=ms, device_ms=dev, plain_ms=plain_ms, bound_ms=bound_ms,
                              bound_by=bound_by, library_ms=lib_ms)
            else:
                result.update(main_path_ms=ms, main_path_device_ms=dev,
                              main_path_bound_ms=bound_ms, main_path_library_ms=lib_ms)
        entries.append({
            "name": name,
            "route": "cuda",
            "source": f"{PKG}/csrc/paged_tree.cu",
            "replaces": f"django_assistant_bot_tpu/ops/attention.py:{line}",
            "max_abs_err": worst[fmt],
            **result,
        })
    return entries


# ---------------------------------------------- paged prefill (a chunk at a query offset)
def _prefill_case(B, H, KH, D, page, NB, C, starts, dtype, fmt, gen, *, pad=False):
    """Random inputs of a paged prefill call on the card: q [B, H, C, D] in
    ``dtype``; the chunk's K/V and the pools ([P + 1, KH, page, D], page P
    the dump page) in ``fmt`` (None: q's dtype, or "bf16" / "e4m3" /
    "e5m2"); each row its own chain of pages up to its write window's end,
    sentinels past it; rows 1 and 2 share their first page where both
    starts pass it (a shared prefix page); with ``pad`` row 0 a pad row of
    sentinels.  Returns (q, k_chunk, v_chunk, k_pool, v_pool, block_tables
    int32, starts int64)."""
    import torch

    from django_assistant_bot_tpu_torch.ops.quant import to_kv_dtype

    kv = dtype if fmt is None else _kv_dtype(fmt)
    S = NB * page
    used = [-(-(min(s, S - C) + C) // page) for s in starts]
    P = sum(used) + 1
    perm = torch.randperm(P, generator=torch.Generator().manual_seed(sum(starts) + C))
    bt = torch.full((B, NB), P, dtype=torch.int32)
    at = 0
    for b, n in enumerate(used):
        bt[b, :n] = perm[at:at + n]
        at += n
    if B > 2 and min(starts[1], starts[2]) >= page:
        bt[2, 0] = bt[1, 0]
    if pad:
        bt[0] = P

    def mk(shape, dt):
        return to_kv_dtype(torch.randn(shape, generator=gen, device="cuda"), dt)

    q = mk((B, H, C, D), dtype)
    kc, vc = mk((B, KH, C, D), kv), mk((B, KH, C, D), kv)
    kp, vp = mk((P + 1, KH, page, D), kv), mk((P + 1, KH, page, D), kv)
    st = torch.tensor(starts, dtype=torch.int64, device="cuda")
    return q, kc, vc, kp, vp, bt.cuda(), st


def _prefill_check(args, window) -> tuple:
    """The kernel's output and (max abs err, max rel err, worst err/bound)
    against the f32 twin on the same inputs: bf16 on the tensor cores
    within ``paged_prefill_bf16_bound``, bf16 at other head dims within
    2^-8 |ref| + 1e-4 (f32 P.V), f32 within 1e-4."""
    import torch

    from django_assistant_bot_tpu_torch import kernels
    from django_assistant_bot_tpu_torch.ops.attention import (
        paged_prefill_attention,
        paged_prefill_attention_plain,
        paged_prefill_bf16_bound,
    )

    q, kc, vc, kp, vp, bt, st = args
    out = paged_prefill_attention(q, kc, vc, kp, vp, bt, st, window=window)
    wide = [t.float() for t in (q, kc, vc, kp, vp)]
    ref = paged_prefill_attention_plain(*wide, bt, st, window=window)
    bound = None
    if q.dtype == torch.bfloat16 and q.shape[3] in kernels.PAGED_MMA_HEAD_DIMS:
        bound = paged_prefill_bf16_bound(*wide, bt, st, ref, window=window)
    torch.cuda.synchronize()
    return out, compare(out, ref, bound)


def whole_block_scatter(pool, chunk, block_tables, starts, valids) -> None:
    """The page write the token write replaced (a reference only): each
    row's logical view gathered, the chunk written into it at ``min(start,
    S - C)``, and every block overlapping ``[start, start + valid)`` written
    back whole, the others to the dump page; in place."""
    import torch

    from django_assistant_bot_tpu_torch.ops.attention import gather_paged_rows

    P, KH, page, D = pool.shape[0] - 1, pool.shape[1], pool.shape[2], pool.shape[3]
    B, NB = block_tables.shape
    C = chunk.shape[2]
    S = NB * page
    rows = gather_paged_rows(pool, block_tables)
    wpos = starts.clamp(max=S - C)[:, None] + torch.arange(C, device=pool.device)[None, :]
    rows[torch.arange(B, device=pool.device)[:, None], :, wpos, :] = chunk.transpose(1, 2)
    blk = torch.arange(NB, device=pool.device)[None, :]
    write = (((blk + 1) * page > starts[:, None])
             & (blk * page < (starts + valids)[:, None]))
    tgt = torch.where(write, block_tables.long().clamp(max=P), P).reshape(-1)
    pool[tgt] = rows.reshape(B, KH, NB, page, D).transpose(1, 2).reshape(B * NB, KH, page, D)


def _token_write_equal(args, valids) -> bool:
    """Whether the token write (``llama._write_chunk_tokens`` at
    ``_chunk_write_targets``) leaves the pages [0, P) bitwise as the whole
    block scatter does, K and V."""
    import torch

    from django_assistant_bot_tpu_torch.models import llama

    q, kc, vc, kp, vp, bt, st = args
    P, page = kp.shape[0] - 1, kp.shape[2]
    pages, offsets = llama._chunk_write_targets(bt, st, valids, kc.shape[2], page, P)
    same = True
    for pool, chunk in ((kp, kc), (vp, vc)):
        got, want = pool.clone(), pool.clone()
        llama._write_chunk_tokens(got, chunk, pages, offsets)
        whole_block_scatter(want, chunk, bt, st, valids)
        same &= torch.equal(got[:P].view(torch.uint8), want[:P].view(torch.uint8))
    return same


def prefill_live(starts, C, S, window=None) -> tuple:
    """(query-key pairs the mask keeps, pool keys read: live positions
    outside the chunk's write window) of a chunk at ``starts``."""
    pairs = pool_keys = 0
    for s in starts:
        lo_all = S
        for i in range(C):
            pos = s + i
            lo = 0 if window is None else max(0, pos - window + 1)
            hi = min(pos, S - 1)
            pairs += max(0, hi - lo + 1)
            lo_all = min(lo_all, lo)
        ws = min(s, S - C)
        top = min(s + C - 1, S - 1)
        live = set(range(lo_all, top + 1)) - set(range(ws, ws + C))
        pool_keys += len(live)
    return pairs, pool_keys


def prefill_bound_ms(args, window=None) -> tuple:
    """Least time for the same work: 4 D operations per kept (query head,
    key) pair at the bf16 tensor-core peak, against q read and out written
    once, the chunk's K/V read once and each row's live pool keys read once
    (at the pool's bytes a value), the block tables and starts, at the HBM
    rate."""
    q, kc, vc, kp, vp, bt, st = args
    B, H, C, D = q.shape
    KH, page = kp.shape[1], kp.shape[2]
    S = bt.shape[1] * page
    pairs, pool_keys = prefill_live(st.tolist(), C, S, window)
    flops = 4.0 * H * D * pairs
    nbytes = (2 * B * H * C * D * q.element_size() + 2 * B * KH * C * D * kc.element_size()
              + 2 * pool_keys * KH * D * kp.element_size() + bt.numel() * 4 + B * 8)
    t_ops = flops / PEAK_BF16_FLOPS * 1e3
    t_bytes = nbytes / PEAK_HBM_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def prefill_library_call(args, window=None):
    """The library yardstick of a paged prefill call (the port never calls
    it): each row's pages gathered dense, the chunk written in, widened to
    q's dtype, then one ``scaled_dot_product_attention`` under the mask."""
    import torch
    import torch.nn.functional as F

    from django_assistant_bot_tpu_torch.ops.attention import _prefill_mask, gather_paged_rows

    q, kc, vc, kp, vp, bt, st = args
    B, C = q.shape[0], q.shape[2]
    S = bt.shape[1] * kp.shape[2]
    mask = _prefill_mask(st, C, S, window)
    wpos = st.clamp(max=S - C)[:, None] + torch.arange(C, device=q.device)[None, :]
    rows = torch.arange(B, device=q.device)[:, None]

    def call():
        k, v = gather_paged_rows(kp, bt), gather_paged_rows(vp, bt)
        k[rows, :, wpos, :] = kc.transpose(1, 2)
        v[rows, :, wpos, :] = vc.transpose(1, 2)
        return F.scaled_dot_product_attention(q, k.to(q.dtype), v.to(q.dtype), attn_mask=mask,
                                              enable_gqa=True)

    return call


def check_chunked_prefill(gen) -> None:
    """The paged prefill kernel's contiguous form over the legacy slot cache
    (``chunked_prefill_attention``: 8 slots of 4,096 keys, Llama-3-8B's
    heads): 4 suffix rows from 40 / 64 / 100 / 3,584 and a pad row aliasing
    slot 2, bf16 within ``paged_prefill_bf16_bound``'s formula (A over the
    slot rows) and f32 over an e4m3 cache within 1e-4, against
    ``chunked_prefill_attention_plain``."""
    import torch

    from django_assistant_bot_tpu_torch.ops.attention import (
        chunked_prefill_attention,
        chunked_prefill_attention_plain,
    )
    from django_assistant_bot_tpu_torch.ops.quant import to_kv_dtype

    slots = torch.tensor([2, 0, 2, 5, 7], device="cuda")
    starts = torch.tensor([0, 40, 64, 100, 3584], device="cuda")
    for qdt, kvdt, window in ((torch.bfloat16, torch.bfloat16, None),
                              (torch.bfloat16, torch.bfloat16, 100),
                              (torch.float32, torch.float8_e4m3fn, None)):
        def mk(shape, dt):
            return to_kv_dtype(torch.randn(shape, generator=gen, device="cuda"), dt)

        q = mk((5, 32, 128, 128), qdt)
        kc, vc = mk((5, 8, 128, 128), kvdt), mk((5, 8, 128, 128), kvdt)
        kcache, vcache = mk((8, 8, 4096, 128), kvdt), mk((8, 8, 4096, 128), kvdt)
        out = chunked_prefill_attention(q, kc, vc, kcache, vcache, slots, starts, window=window)
        wide = [t.float() for t in (q, kc, vc, kcache, vcache)]
        ref = chunked_prefill_attention_plain(*wide, slots, starts, window=window)
        bound = None
        if qdt == torch.bfloat16:  # paged_prefill_bf16_bound's formula over the slot rows
            a = chunked_prefill_attention_plain(wide[0], wide[1], wide[2].abs(), wide[3],
                                                wide[4].abs(), slots, starts, window=window)
            bound = 2.0 ** -8 * (ref.abs() + a) + 1e-4
        torch.cuda.synchronize()
        err, rel, ratio = compare(out, ref, bound)
        log(f"  paged prefill, contiguous form (legacy slot cache 8 x 4,096, rows at 40 / 64 / "
            f"100 / 3,584 and a pad row, C 128, {str(qdt)[6:]} q, {str(kvdt)[6:]} cache, "
            f"window={window}): max_abs_err {err:.3e}, max_rel_err {rel:.3e}, worst err/bound "
            f"{ratio:.3f} ({BF16_P_TEXT if qdt == torch.bfloat16 else tol_text(qdt)})")
        if not ratio <= 1.0:
            fail(f"chunked_prefill_attention disagrees with its plain twin: err/bound {ratio}")


def check_paged_prefill(gen) -> dict:
    """``paged_prefill`` (a prefill chunk's, or a prefix suffix wave's,
    attention over its rows' pages) against its twin at the main path's
    shapes: Llama-3-8B's heads (H 32, KH 8, D 128), page 512, an 8-page
    chain, C 512 at starts 0, 511, 512, 1536 and 3584; a 4-row suffix wave
    at C 32 and 128 with starts 40 / 64 / 100, a COW boundary page, a pad
    row and sentinel blocks, at page 512 and page 16 (tiles across pages);
    window 100; e4m3 and e5m2 pools; D 64; bf16 at D 256 and f32 queries
    over f32, bf16, e4m3 and e5m2 pools (the CUDA-core kernel, f32 also at
    the tiny model's D 16).  bf16 on the tensor cores within
    ``paged_prefill_bf16_bound``, f32 within 1e-4; each call on its form
    (``kernels.PAGED_PREFILL_FORMS``), two bf16 calls bitwise equal, and
    the token write's pages bitwise equal to the whole-block scatter's.
    Then the chunk at starts 0 and 3584: wall and device ms, the bound and
    its share, the plain twin's time and the library yardstick
    (:func:`prefill_library_call`)."""
    import torch

    from django_assistant_bot_tpu_torch import kernels
    from django_assistant_bot_tpu_torch.ops.attention import (
        paged_prefill_attention,
        paged_prefill_attention_plain,
    )

    bf16, f32 = torch.bfloat16, torch.float32
    wave = [0, 40, 64, 100]
    cases = [  # (label, B, H, KH, D, page, NB, C, starts, q dtype, pool format, window, pad)
        *[(f"chunk start {s}", 1, 32, 8, 128, 512, 8, 512, [s], bf16, None, None, False)
          for s in (0, 511, 512, 1536, 3584)],
        *[(f"suffix wave C {c} page {pg}", 4, 32, 8, 128, pg, 4096 // pg, c, wave, bf16, None,
           None, True) for c in (32, 128) for pg in (512, 16)],
        ("chunk start 1536 window 100", 1, 32, 8, 128, 512, 8, 512, [1536], bf16, None, 100,
         False),
        ("e4m3 pool", 1, 32, 8, 128, 512, 8, 512, [1536], bf16, "e4m3", None, False),
        ("e5m2 pool window 100", 1, 32, 8, 128, 512, 8, 512, [1536], bf16, "e5m2", 100, False),
        ("e4m3 suffix wave", 4, 32, 8, 128, 512, 8, 128, wave, bf16, "e4m3", None, True),
        ("D 64", 1, 32, 8, 64, 512, 8, 512, [1536], bf16, None, None, False),
        ("bf16 D 256 (CUDA cores)", 1, 8, 4, 256, 512, 8, 256, [1000], bf16, None, None, False),
        ("f32", 1, 8, 2, 128, 512, 8, 512, [1536], f32, None, None, False),
        ("f32 q, bf16 pool", 1, 8, 2, 128, 512, 8, 512, [1536], f32, "bf16", 100, False),
        ("f32 q, e4m3 pool", 4, 8, 2, 128, 512, 8, 128, wave, f32, "e4m3", None, True),
        ("f32 q, e5m2 pool", 1, 8, 2, 128, 512, 8, 512, [3584], f32, "e5m2", None, False),
        ("f32 D 16 page 16", 4, 4, 2, 16, 16, 16, 32, wave, f32, None, None, True),
        ("f32 D 64 window 100", 1, 8, 2, 64, 512, 8, 512, [1536], f32, None, 100, False),
    ]
    worst = 0.0
    for label, B, H, KH, D, page, NB, C, starts, dtype, fmt, window, pad in cases:
        args = _prefill_case(B, H, KH, D, page, NB, C, starts, dtype, fmt, gen, pad=pad)
        mma = dtype == bf16 and D in kernels.PAGED_MMA_HEAD_DIMS
        form = f"{'mma' if mma else 'cuda_core'}:{kernels.paged_read(dtype, args[3].dtype)}"
        before = kernels.PAGED_PREFILL_FORMS[form]
        out, (err, rel, ratio) = _prefill_check(args, window)
        text = BF16_P_TEXT if mma else tol_text(dtype)
        valids = torch.tensor([0 if pad and b == 0 else C - 3 * b for b in range(B)],
                              device="cuda")
        same = _token_write_equal(args, valids)
        log(f"  paged prefill {label} (B={B} H={H} KH={KH} D={D} page={page} NB={NB} C={C} "
            f"starts {starts} {str(dtype)[6:]} q, {fmt or 'native'} pool, window={window}): "
            f"max_abs_err {err:.3e}, max_rel_err {rel:.3e}, worst err/bound {ratio:.3f} "
            f"({text}), form {form}; token write {'bitwise equal to' if same else 'DIFFERS from'} "
            f"the whole-block scatter")
        if kernels.PAGED_PREFILL_FORMS[form] != before + 1:
            fail(f"paged prefill ({label}) did not take {form}")
        if not ratio <= 1.0:
            fail(f"paged_prefill ({label}) disagrees with its plain twin: err/bound {ratio} > 1")
        if not same:
            fail(f"paged prefill ({label}): the token write's pages differ from the whole-block "
                 "scatter's")
        if mma:
            worst = max(worst, err)
            again = paged_prefill_attention(*args, window=window)
            torch.cuda.synchronize()
            if not torch.equal(out, again):
                fail(f"paged prefill ({label}): two calls on the same inputs differ")
    check_chunked_prefill(gen)
    log(f"  paged prefill SASS: {sass_counts(kernels.lib_path('paged_prefill'))}")

    result = {}
    for start in (0, 3584):
        args = _prefill_case(1, 32, 8, 128, 512, 8, 512, [start], bf16, None, gen)
        ms, dev = timed(lambda: paged_prefill_attention(*args), 50)
        plain_ms = time_ms(lambda: paged_prefill_attention_plain(*args), 5)
        lib = prefill_library_call(args)
        lib_err = (lib().float() - paged_prefill_attention(*args).float()).abs().max().item()
        lib_ms, lib_dev = timed(lib, 20)
        bound_ms, bound_by = prefill_bound_ms(args)
        log(f"  paged prefill timing, C 512 at start {start} (B=1 H=32 KH=8 D=128 page=512 NB=8, "
            f"bf16): kernel wall {ms:.4f} ms (device {dev:.4f}), plain wall {plain_ms:.4f} ms, "
            f"library (pages gathered, the chunk written in + masked "
            f"scaled_dot_product_attention) wall {lib_ms:.4f} ms (device {lib_dev:.4f}; max "
            f"|library - kernel| {lib_err:.3e}), bound {bound_ms:.4f} ms ({bound_by}); share of "
            f"the bound: wall {bound_ms / ms:.3f}, device {bound_ms / dev:.3f}")
        if start == 3584:
            result.update(ms=ms, device_ms=dev, plain_ms=plain_ms, bound_ms=bound_ms,
                          bound_by=bound_by, library_ms=lib_ms)
        else:
            result.update(start0_ms=ms, start0_device_ms=dev, start0_plain_ms=plain_ms,
                          start0_bound_ms=bound_ms, start0_library_ms=lib_ms)
    return {
        "name": "paged_prefill",
        "route": "cuda",
        "source": f"{PKG}/csrc/paged_prefill.cu",
        "replaces": "django_assistant_bot_tpu/models/llama.py:1134",
        "max_abs_err": worst,
        **result,
    }


def knn_bound_ms(Q, live, N, D, k) -> tuple:
    """Least time for the masked score + top-k: the live rows of the index
    (bf16), the validity bytes and the f32 queries read once, the f32 scores
    and int32 ids written once, at the HBM rate, against 2 Q D operations
    per live row at the bf16 tensor-core peak."""
    nbytes = live * D * 2 + N + Q * D * 4 + Q * k * 8
    t_bytes = nbytes / PEAK_HBM_BYTES * 1e3
    t_ops = 2.0 * Q * live * D / PEAK_BF16_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def knn_corpus(N, D, live, gen):
    """N normalised bf16 rows on the card, the first ``live`` valid."""
    import torch

    from django_assistant_bot_tpu_torch.storage.knn import _normalize_rows_dev

    x = torch.empty((N, D), dtype=torch.bfloat16, device="cuda")
    for s0 in range(0, N, 1 << 17):  # in slices: the f32 temporaries stay small
        e = min(N, s0 + (1 << 17))
        x[s0:e] = _normalize_rows_dev(
            torch.randn((e - s0, D), generator=gen, device="cuda").to(torch.bfloat16))
    valid = torch.zeros(N, dtype=torch.bool, device="cuda")
    valid[:live] = True
    return x, valid


def check_knn(gen) -> dict:
    """``knn_topk`` against ``topk_scores_plain`` at the RAG corpus (1,048,576
    rows of 768, the first 1,000,000 valid) for Q in {8, 32, 128}, k in {16,
    1024}, all rows and an allow-list of about 1% of them, at Q = 1, k =
    20,000 (past the shared-memory sort of 16,384 keys: the global-memory
    sort), and at N = 4096, D = 64 (below the hierarchical top-k's 16,384
    rows); then its time at the main path's search (Q bucket 8, k bucket 16,
    all rows), at the other buckets and at k = 20,000."""
    import torch

    from django_assistant_bot_tpu_torch import kernels
    from django_assistant_bot_tpu_torch.storage.knn import topk_scores, topk_scores_plain
    from django_assistant_bot_tpu_torch.storage.knn_check import topk_agreement

    N, D, live = 1 << 20, 768, 1_000_000
    x, valid = knn_corpus(N, D, live, gen)
    allow = valid & (torch.rand(N, generator=gen, device="cuda") < 0.01)
    worst, worst_err = 0.0, 0.0
    cases = [(Q, k, name, m) for Q in (8, 32, 128) for k in (16, 1024)
             for name, m in (("all", valid), ("allow-list", allow))]
    cases.append((1, 20000, "all", valid))
    xs, vs = knn_corpus(4096, 64, 4096, gen)
    cases += [(8, 16, "N=4096 D=64", vs), (8, 1024, "N=4096 D=64", vs)]
    for Q, k, name, m in cases:
        index = xs if name.startswith("N=") else x
        q = torch.randn((Q, index.shape[1]), generator=gen, device="cuda")
        scores, ids = topk_scores(index, q, m, k)
        torch.cuda.synchronize()
        rep = topk_agreement(index, q, m, scores, ids)
        log(f"  knn Q={Q} k={k} {name} ({int(m.sum())} valid of {index.shape[0]}): max_abs_err "
            f"{rep['max_abs_err']:.3e}, worst err/bound {rep['worst']:.4f} (bound D 2^-22 |q| "
            f"max|x|, f32 accumulation), ids compared {rep['ids_compared']}")
        if rep["problems"]:
            fail(f"knn_topk Q={Q} k={k} {name} disagrees with its plain twin: {rep['problems']}")
        worst, worst_err = max(worst, rep["worst"]), max(worst_err, rep["max_abs_err"])
    log(f"  knn SASS: {sass_counts(kernels.lib_path('knn_topk'))}")

    result = {}
    for Q, k, iters in ((8, 16, 30), (32, 16, 30), (128, 1024, 10), (1, 20000, 5)):
        q = torch.randn((Q, D), generator=gen, device="cuda")
        qb = q.to(torch.bfloat16)
        ms, dev = timed(lambda: topk_scores(x, q, valid, k), iters)
        plain_ms = time_ms(lambda: topk_scores_plain(x, q, valid, k), 3)
        library_ms = time_ms(lambda: torch.topk(
            torch.matmul(qb, x.T).masked_fill_(~valid, float("-inf")), k), iters)
        bound_ms, bound_by = knn_bound_ms(Q, live, N, D, k)
        log(f"  knn timing Q={Q} k={k} N={N} ({live} valid) D={D}: kernel wall {ms:.4f} ms "
            f"(device {dev:.4f}), plain wall {plain_ms:.4f} ms, library (matmul bf16 out + "
            f"masked_fill + topk) wall {library_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}); "
            f"share of the bound: wall {bound_ms / ms:.3f}, device {bound_ms / dev:.3f}, "
            f"library {bound_ms / library_ms:.3f}")
        if (Q, k) == (8, 16):
            result = dict(ms=ms, device_ms=dev, plain_ms=plain_ms, bound_ms=bound_ms,
                          bound_by=bound_by, library_ms=library_ms)
    del x, valid, allow
    torch.cuda.empty_cache()
    return {
        "name": "knn_topk",
        "route": "cuda",
        "source": f"{PKG}/csrc/knn_topk.cu",
        "replaces": "django_assistant_bot_tpu/storage/knn.py:71",
        "max_abs_err": worst_err,
        **result,
    }


QGEMM_SHAPES = [  # Llama-3-8B's layer projections (in x out) and their launches a step
    ("wq/wo", 4096, 4096, 2), ("wk/wv", 4096, 1024, 2), ("gate/up", 4096, 14336, 2),
    ("down", 14336, 4096, 1),
]
# the decode step's grouped launches (in, member widths): QKV and gate/up
QGEMM_GROUPS = [("qkv", 4096, (4096, 1024, 1024)), ("gate+up", 4096, (14336, 14336))]
QGEMM_HEAD = (4096, 128256)  # the untied head of an int8 table (quantize_embed)
# a timed call cycles through weight copies of at least this many bytes (5x
# the 50 MB L2), so each call reads its weights from HBM as the decode step
QGEMM_ROTATE_BYTES = 256 << 20


def qgemm_bound_ms(M, K, N, bits, group) -> tuple:
    """Least time for ``[M, K] . W[K, N]``: the integer weights, their f32
    scales and the bf16 x read once and the bf16 y written once at the HBM
    rate, against 2 M K N operations at the bf16 tensor-core peak."""
    return qgemm_group_bound_ms(M, K, (N,), bits, group)


def qgemm_group_bound_ms(M, K, Ns, bits, group) -> tuple:
    """:func:`qgemm_bound_ms` of one launch over members of widths ``Ns``
    that share x (x read once)."""
    scales = sum(N if bits == 8 else (K // group) * N for N in Ns)
    nbytes = sum(K * N * bits / 8 for N in Ns) + 4 * scales + 2 * M * K + 2 * M * sum(Ns)
    t_bytes = nbytes / PEAK_HBM_BYTES * 1e3
    t_ops = 2.0 * M * K * sum(Ns) / PEAK_BF16_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# the f32 CUDA cores' instruction rate: 67 TFLOP/s of FMAs, one lane
# instruction each (132 SMs x 128 lanes x 1.98 GHz)
PEAK_CC_INSTR = 33.5e12
# lane instructions an output and group of int4's flush: the partial's
# round, its unpack from the bf16 pair, the FMA with the rounded scale
FLUSH_INSTR = 3


def qgemm_flush_bound_ms(M, K, N, bits, group) -> tuple:
    """:func:`qgemm_bound_ms` with int4's group flush counted: one round,
    unpack and FMA (``FLUSH_INSTR``) per output and group on the CUDA cores
    (``PEAK_CC_INSTR``), which the JAX numerics need and a product on the
    dequantized weight does not do; the larger of the two."""
    bound = qgemm_bound_ms(M, K, N, bits, group)
    if bits != 4:
        return bound
    t_flush = M * N * (K // group) * FLUSH_INSTR / PEAK_CC_INSTR * 1e3
    return (t_flush, "flush") if t_flush > bound[0] else bound


def _qweight(K, N, fmt, group, gen):
    """Random int8 (per-column scales) or packed int4 (per-group scales)
    weights drawn on the card, the scales spread over two decades."""
    import torch

    from django_assistant_bot_tpu_torch.ops.quant import QTensor, QTensor4

    if fmt == "int8":
        q = torch.randint(-127, 128, (K, N), generator=gen, device="cuda", dtype=torch.int8)
        scale = torch.exp(torch.rand((1, N), generator=gen, device="cuda") * 4.6) * 1e-4
        return QTensor(q, scale)
    q = torch.randint(0, 256, (K // 2, N), generator=gen, device="cuda", dtype=torch.uint8)
    scale = torch.exp(torch.rand((K // group, N), generator=gen, device="cuda") * 4.6) * 1e-3
    return QTensor4(q, scale)


def _qgemm_err(out, x, w, ref, dtype) -> tuple:
    """(max abs err, worst err/bound) of a qgemm output against the f32
    ``ref``: bf16 within ``qgemm_bf16_bound``, f32 within 1e-4 of A = |x| .
    |deq W| (summation order)."""
    import torch

    from django_assistant_bot_tpu_torch.ops.quant import deq, qgemm_bf16_bound

    if dtype == torch.bfloat16:
        bound = qgemm_bf16_bound(x.float(), w, ref)
    else:
        bound = F32_TOL * torch.matmul(x.abs(), deq(w, torch.float32).abs()) + 1e-6
    if not (out.shape == ref.shape and bool(torch.isfinite(out).all())):
        fail(f"qgemm output {tuple(out.shape)} not finite or not {tuple(ref.shape)}")
    diff = (out.float() - ref).abs()
    return diff.max().item(), (diff / bound).max().item()


def _qgemm_case(M, K, N, fmt, group, dtype, gen) -> tuple:
    """The kernel against the f32 plain twin on the same inputs.  Returns
    (max abs err, worst err/bound)."""
    import torch

    from django_assistant_bot_tpu_torch.ops.quant import qeinsum, qeinsum_plain

    w = _qweight(K, N, fmt, group, gen)
    x = torch.randn((M, K), generator=gen, device="cuda").to(dtype)
    out = qeinsum("me,eo->mo", x, w, dtype)
    ref = qeinsum_plain("me,eo->mo", x.float(), w, torch.float32)
    torch.cuda.synchronize()
    return _qgemm_err(out, x, w, ref, dtype)


def _qgemm_group_case(M, K, Ns, fmt, group, gen) -> tuple:
    """One stream launch over members that share x (``qeinsum_group``):
    each output within ``qgemm_bf16_bound`` of its f32 plain twin, as is the
    member's own launch (its K splits fall elsewhere), and equal bit for
    bit to a repeat of the group.  Returns (max abs err, worst
    err/bound)."""
    import torch

    from django_assistant_bot_tpu_torch import kernels
    from django_assistant_bot_tpu_torch.ops.quant import qeinsum, qeinsum_group, qeinsum_plain

    ws = [_qweight(K, N, fmt, group, gen) for N in Ns]
    x = torch.randn((M, K), generator=gen, device="cuda").to(torch.bfloat16)
    before = kernels.QGEMM_ROUTES["stream"]
    ys = qeinsum_group("me,eo->mo", x, ws, torch.bfloat16)
    if kernels.QGEMM_ROUTES["stream"] != before + 1:
        fail(f"qgemm group {fmt} M={M} Ns={Ns} did not take one stream launch")
    again = qeinsum_group("me,eo->mo", x, ws, torch.bfloat16)
    alone = [qeinsum("me,eo->mo", x, w, torch.bfloat16) for w in ws]
    torch.cuda.synchronize()
    err = ratio = 0.0
    for y, y2, y1, w in zip(ys, again, alone, ws):
        ref = qeinsum_plain("me,eo->mo", x.float(), w, torch.float32)
        for out in (y, y1):
            e, r = _qgemm_err(out, x, w, ref, torch.bfloat16)
            err, ratio = max(err, e), max(ratio, r)
        if not torch.equal(y, y2):
            fail(f"qgemm group {fmt} M={M} Ns={Ns}: not bitwise equal to its repeat")
    return err, ratio


def _tied_case(M, V, E, dtype, gen) -> tuple:
    """The tied int8 head (``tied_head``: the table ``[V, E]`` K-contiguous,
    x scaled per E) against the f32 product on the same scaled x: bf16
    within ``tied_head_bf16_bound``, f32 within 1e-4 of |xs| . |q|^T; a
    repeat bitwise equal.  Returns (max abs err, worst err/bound)."""
    import torch

    from django_assistant_bot_tpu_torch.ops.quant import QTensor, tied_head, tied_head_bf16_bound

    w = QTensor(torch.randint(-127, 128, (V, E), generator=gen, device="cuda", dtype=torch.int8),
                torch.exp(torch.rand((1, E), generator=gen, device="cuda") * 4.6) * 1e-3)
    x = torch.randn((M, E), generator=gen, device="cuda").to(dtype)
    out, again = tied_head(x, w, dtype), tied_head(x, w, dtype)
    xs = (x * w.scale.squeeze(-2).to(dtype)).float()
    ref = xs @ w.q.float().T
    torch.cuda.synchronize()
    if dtype == torch.bfloat16:
        bound = tied_head_bf16_bound(xs, w, ref)
    else:
        bound = F32_TOL * (xs.abs() @ w.q.float().abs().T) + 1e-6
    if not (out.shape == (M, V) and bool(torch.isfinite(out).all()) and torch.equal(out, again)):
        fail(f"tied head M={M} V={V} {dtype}: shape, finiteness or repeat wrong")
    diff = (out.float() - ref).abs()
    return diff.max().item(), (diff / bound).max().item()


def _rotated(make, nbytes):
    """Enough copies from ``make()`` of ``nbytes`` each to fill
    ``QGEMM_ROTATE_BYTES`` (at least two)."""
    return [make() for _ in range(max(2, -(-QGEMM_ROTATE_BYTES // nbytes)))]


def _cycler(fn, items):
    """A call of ``fn`` on the next of ``items`` each time."""
    it = [0]

    def call():
        it[0] = (it[0] + 1) % len(items)
        return fn(items[it[0]])

    return call


def stream_read_ms(tensors_of, copies, iters) -> float:
    """The stream-read yardstick: device ms of one trivial read (an int32
    sum, torch.profiler's kernel time) of the same integer bytes as a call,
    rotated through the same copies: the card's reachable read rate at that
    size."""
    import torch

    flat = [torch.cat([t.reshape(-1).view(torch.uint8) for t in tensors_of(c)]).view(torch.int32)
            for c in copies]
    ms = device_ms(_cycler(lambda f: f.sum(dtype=torch.int32), flat), iters)
    del flat
    return ms


def check_qgemm(gen) -> list:
    """``qgemm`` against ``qeinsum_plain`` on the card: int8 and int4 at
    groups 64 and 128, M in {1, 8, 16, 37, 64, 65, 512, 2048}, at the four
    projection shapes and two ragged widths (N = 1040, not a multiple of the
    256-column tile, and 1032, off TMA's multiple of 16, which keeps the
    direct-load kernel), in bf16 (``qgemm_bf16_bound``; the worst err/bound
    printed per format) and f32 (1e-4 relative to A); the int8 head (4096 x
    128,256) at M = 8; the grouped decode launches (QKV, gate/up) at M 1 /
    8 / 16 / 37 / 64, each member (and its own launch) within the bound,
    the group's repeat bit for bit; the tied int8 head (K-contiguous, bf16
    and f32).  Fails unless the prefill kernel's SASS holds wgmma (HGMMA)
    and TMA loads (UTMALDG) and the stream kernel's tensor-core products
    (HMMA), TMA loads and mbarrier operations (SYNCS).  Then its time at
    M = 8 per projection and per grouped launch (the stream kernel; the
    direct-load kernel beside it, forced, as the earlier design; the
    stream-read yardstick over the same bytes) and at M = 512 (and 2048 for
    gate/up and down), the weights rotated over >= 256 MB of copies, so
    every call reads them from HBM, as the decode step does, beside its
    bound, the plain twin and the library (cuBLAS on the pre-dequantized
    bf16 weight, ``torch.matmul``; for a grouped launch one product on the
    concatenated weight; a yardstick only)."""
    import torch

    from django_assistant_bot_tpu_torch import kernels
    from django_assistant_bot_tpu_torch.ops.quant import (
        QGEMM_BF16_BOUND_TEXT, deq, qeinsum, qeinsum_group, qeinsum_plain)

    # max abs err per JSON entry: the stream route ("int8"/"int4") and the
    # wgmma route ("prefill_..."); the direct-load route is logged apart
    worst = {"int8": 0.0, "int4": 0.0, "prefill_int8": 0.0, "prefill_int4": 0.0,
             "mma_int8": 0.0, "mma_int4": 0.0}
    worst_ratio = {"int8": 0.0, "int4": 0.0}
    cases = [(fmt, g, M, K, N, torch.bfloat16)
             for fmt, g in (("int8", 0), ("int4", 64), ("int4", 128))
             for _, K, N, _ in QGEMM_SHAPES + [("ragged", 4096, 1040, 0), ("ragged", 4096, 1032, 0)]
             for M in (1, 8, 16, 37, 64, 65, 512, 2048)]
    cases += [(fmt, g, M, K, N, torch.float32) for fmt, g in (("int8", 0), ("int4", 64))
              for K, N in ((4096, 4096), (4096, 1040)) for M in (1, 8, 37)]
    cases.append(("int8", 0, 8, *QGEMM_HEAD, torch.bfloat16))
    for fmt, g, M, K, N, dtype in cases:
        bits = 8 if fmt == "int8" else 4
        before = dict(kernels.QGEMM_ROUTES)
        err, ratio = _qgemm_case(M, K, N, fmt, g, dtype, gen)
        route = next(r for r, n in kernels.QGEMM_ROUTES.items() if n != before[r])
        text = (f"bound {QGEMM_BF16_BOUND_TEXT[bits]}"
                if dtype == torch.bfloat16 else "bound 1e-4*A + 1e-6")
        log(f"  qgemm {fmt}{f' g={g}' if g else ''} M={M} K={K} N={N} {str(dtype)[6:]} ({route}): "
            f"max_abs_err {err:.3e}, worst err/bound {ratio:.3f} ({text})")
        if not ratio <= 1.0:
            fail(f"qgemm {fmt} M={M} K={K} N={N} disagrees with its plain twin: {ratio} > 1")
        want = ("cuda_core" if dtype == torch.float32 else "mma" if N % 16 else
                "stream" if M <= 64 else "wgmma")
        if route != want:
            fail(f"qgemm {fmt} M={M} K={K} N={N} {dtype} took route {route}, not {want}")
        if dtype == torch.bfloat16:
            key = {"stream": fmt, "wgmma": f"prefill_{fmt}", "mma": f"mma_{fmt}"}[route]
            worst[key] = max(worst[key], err)
            worst_ratio[fmt] = max(worst_ratio[fmt], ratio)
    for fmt, g in (("int8", 0), ("int4", 64), ("int4", 128)):
        for label, K, Ns in QGEMM_GROUPS:
            for M in (1, 8, 16, 37, 64):
                err, ratio = _qgemm_group_case(M, K, Ns, fmt, g, gen)
                log(f"  qgemm group {label} {fmt}{f' g={g}' if g else ''} M={M} K={K} Ns={Ns} bf16 "
                    f"(one stream launch; the members' own launches too): max_abs_err {err:.3e}, "
                    f"worst err/bound {ratio:.3f}, a repeat bitwise equal")
                if not ratio <= 1.0:
                    fail(f"qgemm group {label} {fmt} M={M} disagrees with its plain twins: {ratio}")
                worst[fmt] = max(worst[fmt], err)
                worst_ratio[fmt] = max(worst_ratio[fmt], ratio)
    for M, V, E, dtype in ((8, *QGEMM_HEAD[::-1], torch.bfloat16), (70, 1000, 64, torch.bfloat16),
                           (8, 512, 256, torch.float32)):
        err, ratio = _tied_case(M, V, E, dtype, gen)
        log(f"  qgemm tied head M={M} V={V} E={E} {str(dtype)[6:]}: max_abs_err {err:.3e}, worst "
            f"err/bound {ratio:.3f} (bf16: the int8 bound on A = |xs|.|q|^T; f32: 1e-4*A + 1e-6), "
            f"a repeat bitwise equal")
        if not ratio <= 1.0:
            fail(f"tied head M={M} V={V} {dtype} disagrees with its plain twin: {ratio} > 1")
        if dtype == torch.bfloat16:
            worst["int8"] = max(worst["int8"], err)
            worst_ratio["int8"] = max(worst_ratio["int8"], ratio)
    for fmt in ("int8", "int4"):
        log(f"  qgemm {fmt} bf16: worst err/bound {worst_ratio[fmt]:.3f} over its cases "
            f"(bound {QGEMM_BF16_BOUND_TEXT[8 if fmt == 'int8' else 4]}); direct-load route "
            f"max_abs_err {worst['mma_' + fmt]:.3e}")
    sass = sass_table(kernels.lib_path("qgemm"))
    log(f"  qgemm SASS: {sass_counts(kernels.lib_path('qgemm'))}")
    prefill = {label: c for label, c in sass.items() if label.startswith("qgemm_wgmma_kernel")}
    if not prefill or any(c["HGMMA"] == 0 or c["UTMALDG"] == 0 for c in prefill.values()):
        fail(f"qgemm's prefill kernel shows no wgmma or no TMA load in its SASS: {prefill}")
    stream = {label: c for label, c in sass.items() if label.startswith("qgemm_stream_kernel")}
    if not stream or any(c["HMMA"] == 0 or c["UTMALDG"] == 0 or c["SYNCS"] == 0
                         for c in stream.values()):
        fail(f"qgemm's stream kernel shows no mma, TMA load or mbarrier in its SASS: {stream}")

    entries = {}
    rows = [(fmt, g, label, K, (N,), per, M) for fmt, g in (("int8", 0), ("int4", 64))
            for label, K, N, per in QGEMM_SHAPES
            for M in ((8, 512, 2048) if label in ("gate/up", "down") else (8, 512))]
    rows += [(fmt, g, label, K, Ns, 1, 8) for fmt, g in (("int8", 0), ("int4", 64))
             for label, K, Ns in QGEMM_GROUPS]
    rows.append(("int8", 0, "head", *QGEMM_HEAD[:1], QGEMM_HEAD[1:], 0, 8))
    route0 = kernels.qgemm_route
    for fmt, g, label, K, Ns, per, M in rows:
        bits = 8 if fmt == "int8" else 4
        wbytes = sum(K * N * bits // 8 for N in Ns)
        copies = _rotated(lambda: [_qweight(K, N, fmt, g, gen) for N in Ns], wbytes)
        wds = [torch.cat([deq(w, torch.bfloat16) for w in c], dim=1)
               for c in copies[:max(2, -(-QGEMM_ROTATE_BYTES // (2 * K * sum(Ns))))]]
        x = torch.randn((M, K), generator=gen, device="cuda").to(torch.bfloat16)
        kernel = _cycler(lambda c: qeinsum_group("me,eo->mo", x, c, torch.bfloat16), copies)
        library = _cycler(lambda wd: torch.matmul(x, wd), wds)
        iters = {8: 50, 512: 20}.get(M, 10)
        ms, dev = timed(kernel, iters)
        library_ms = time_ms(library, iters)
        plain_ms = time_ms(lambda: [qeinsum_plain("me,eo->mo", x, w, torch.bfloat16)
                                    for w in copies[0]], 3)
        bound_ms, bound_by = qgemm_group_bound_ms(M, K, Ns, bits, g)
        extra = ""
        read_ms = None
        if M == 8:
            read_ms = stream_read_ms(lambda c: [w.q for w in c], copies, iters)
            # the direct-load kernel on the same calls (the earlier decode route)
            kernels.qgemm_route = lambda *a, **k: (
                "mma" if route0(*a, **k) == "stream" else route0(*a, **k))
            try:
                mma_ms, mma_dev = timed(kernel, iters)
            finally:
                kernels.qgemm_route = route0
            extra = (f"; stream-read yardstick device {read_ms:.4f} ms (share of it, device "
                     f"{read_ms / dev:.3f}); the direct-load kernel ({len(Ns)} launch"
                     f"{'es' if len(Ns) > 1 else ''}) wall {mma_ms:.4f} ms (device {mma_dev:.4f})")
        plan = (kernels.qgemm_stream_plan(M, Ns, K, bits, g)[:2] if M <= 64
                else kernels.qgemm_plan(M, Ns[0], K, bits, g))
        log(f"  qgemm timing {fmt}{f' g={g}' if g else ''} {label} M={M} K={K} N={'+'.join(map(str, Ns))} "
            f"bf16 (plan {plan}, {len(copies)} weight copies): kernel wall {ms:.4f} ms (device "
            f"{dev:.4f}), library (one matmul on the bf16 weight) wall {library_ms:.4f} ms, plain "
            f"wall {plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}); share of the bound: "
            f"wall {bound_ms / ms:.3f}, device {bound_ms / dev:.3f}, library "
            f"{bound_ms / library_ms:.3f}; {per} launches a layer a decode step{extra}")
        if (label, M) in (("gate+up", 8), ("gate/up", 512)):
            entries[fmt if M == 8 else f"prefill_{fmt}"] = dict(
                ms=ms, device_ms=dev, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                library_ms=library_ms, **({"read_ms": read_ms} if read_ms is not None else {}))
        del copies, wds
    torch.cuda.empty_cache()
    # the decode kernel (qgemm_stream_kernel, timed on the grouped gate/up
    # launch at M = 8) and the prefill kernel (qgemm_wgmma_kernel, timed at
    # M = 512 on gate/up)
    return [{
        "name": f"qgemm_{key}",
        "route": "cuda",
        "source": f"{PKG}/csrc/qgemm.cu",
        "replaces": "django_assistant_bot_tpu/ops/quant.py:160",
        "max_abs_err": worst[key],
        **entries[key],
    } for key in ("int8", "int4", "prefill_int8", "prefill_int4")]


# the generic qgemm route's shapes (ROADMAP Queue 3 entry 7): (K, N, fmt,
# group): int4 groups 8 and 4 (a quant_group_size of 6 packs at 4 at in
# 4096, _int4_group), 2, 6, 24 and 40 (K off 64 and off 16 too), int8 with
# K off 16 and N off 8
GENERIC_SHAPES = [(4096, 4096, "int4", 8), (4096, 4096, "int4", 4), (256, 512, "int4", 2),
                  (96, 64, "int4", 6), (48, 40, "int4", 24), (4104, 1024, "int4", 24),
                  (80, 48, "int4", 40), (4000, 4096, "int4", 40), (40, 44, "int8", 0)]
GENERIC_MS = (1, 8, 65, 512)
# Llama-3-8B's four projections at int4 g 8 (wq / wo, wk / wv, gate / up,
# down), at the rows of x phase 8's g8 engine gives them: 1-16 a decode step
# (gate / up and down there take two blocks an SM), 512 a prefill chunk
GENERIC_LLAMA = [(M, K, N, "int4", 8) for M in (1, 8, 16, 512)
                 for K, N in ((4096, 4096), (4096, 1024), (4096, 14336), (14336, 4096))]
# a 300-token prefill's last-token logits against the plain-twin forward:
# the least cosine (the kernel read 0.999998 on an H100 at full width)
QUANT_MIN_COSINE = 0.9999


def _generic_case(M, K, N, fmt, g, dtype, gen) -> tuple:
    """One generic-route call against its plain twin (``_qgemm_err``), its
    launch counted on ``"generic"``, a repeat equal bit for bit.  Returns
    (max abs err, worst err/bound)."""
    import torch

    from django_assistant_bot_tpu_torch import kernels
    from django_assistant_bot_tpu_torch.ops.quant import qeinsum, qeinsum_plain

    w = _qweight(K, N, fmt, g, gen)
    x = torch.randn((M, K), generator=gen, device="cuda").to(dtype)
    before = kernels.QGEMM_ROUTES["generic"]
    out = qeinsum("me,eo->mo", x, w, dtype)
    routed = kernels.QGEMM_ROUTES["generic"] - before
    again = qeinsum("me,eo->mo", x, w, dtype)
    ref = qeinsum_plain("me,eo->mo", x.float(), w, torch.float32)
    torch.cuda.synchronize()
    err, ratio = _qgemm_err(out, x, w, ref, dtype)
    if not ratio <= 1.0 or routed != 1 or not torch.equal(out, again):
        fail(f"qgemm generic {fmt} g={g} M={M} K={K} N={N} {dtype}: err/bound {ratio}, generic "
             f"launches {routed}, repeat equal {torch.equal(out, again)}")
    return err, ratio


def check_qgemm_generic(gen) -> dict:
    """The generic route (``qgemm_generic_kernel``: tensor cores in bf16,
    CUDA cores in f32) against ``qeinsum_plain`` at the shapes no
    tensor-core route takes (``GENERIC_SHAPES`` at ``GENERIC_MS`` rows in
    bf16, ``qgemm_bf16_bound``; M 8 and 65 in f32, 1e-4 of A), every call
    one launch on ``"generic"`` and bitwise equal on a repeat; the tied int8
    head's K-contiguous form at V 1,000, E 40 and V 128,256, E 4,040 in both
    dtypes.  Fails unless the bf16 kernel's SASS holds tensor-core products
    (HMMA) and asynchronous copies (LDGSTS).  Then its time at int4 g = 8,
    4096 x 4096 (Llama-3-8B's wq / wo), M 8 and 512, the weights rotated
    over >= 256 MB of copies so each call reads them from HBM, beside the
    bound, the flush-aware bound (``qgemm_flush_bound_ms``), the plain twin
    and cuBLAS on the dequantized weight (wall and device, rotated alike);
    and the tied int8 head at Llama-3-8B's [128,256, 4096] table, M = 8
    (the stream route's K-contiguous form), beside ``torch.matmul`` on its
    bf16 table and its plain twin.  The entry is the M 8 time."""
    import torch

    from django_assistant_bot_tpu_torch import kernels
    from django_assistant_bot_tpu_torch.ops.quant import (
        QTensor, deq, qeinsum, qeinsum_plain, tied_head, tied_head_plain)

    worst = worst_ratio = 0.0
    cases = [(M, K, N, fmt, g, torch.bfloat16) for K, N, fmt, g in GENERIC_SHAPES
             for M in GENERIC_MS]
    cases += [(M, K, N, fmt, g, torch.bfloat16) for M, K, N, fmt, g in GENERIC_LLAMA
              if M not in GENERIC_MS or (K, N) != (4096, 4096)]
    cases += [(M, K, N, fmt, g, torch.float32) for K, N, fmt, g in GENERIC_SHAPES
              for M in (8, 65)]
    for M, K, N, fmt, g, dtype in cases:
        err, ratio = _generic_case(M, K, N, fmt, g, dtype, gen)
        if dtype == torch.bfloat16:
            worst, worst_ratio = max(worst, err), max(worst_ratio, ratio)
    log(f"  qgemm generic: {len(cases)} cases (int4 g 2 / 4 / 6 / 8 / 24 / 40, int8 off 16 and "
        f"8; M {GENERIC_MS} bf16, 8 and 65 f32; Llama-3-8B's four g8 projections at M 1, 8, "
        f"16, 512 bf16), each one generic launch, a repeat bitwise equal; bf16 max_abs_err "
        f"{worst:.3e}, worst err/bound {worst_ratio:.3f}")
    for V, E in ((1000, 40), (128256, 4040)):
        for dtype in (torch.bfloat16, torch.float32):
            for M in (8, 512):
                before = kernels.QGEMM_ROUTES["generic"]
                err, ratio = _tied_case(M, V, E, dtype, gen)
                routed = kernels.QGEMM_ROUTES["generic"] - before
                log(f"  qgemm generic tied head M={M} V={V} E={E} {str(dtype)[6:]}: max_abs_err "
                    f"{err:.3e}, worst err/bound {ratio:.3f}, generic launches {routed}")
                if not ratio <= 1.0 or routed != 2:
                    fail(f"the generic tied head M={M} V={V} E={E} {dtype} disagrees or left the "
                         f"generic route: {ratio}")
                if dtype == torch.bfloat16:
                    worst = max(worst, err)
    sass = {label: c for label, c in sass_table(kernels.lib_path("qgemm")).items()
            if label.startswith("qgemm_generic_kernel")}
    log(f"  qgemm generic SASS: " + "; ".join(
        f"{k}: HMMA {c['HMMA']}, LDGSTS {c['LDGSTS']}, UTMALDG {c['UTMALDG']}"
        for k, c in sorted(sass.items())))
    # bf16 forms: tensor-core products, fed by cp.async (LDGSTS) or, the
    # TMA forms (last template flag 1), by TMA loads on mbarriers
    bf16 = {label: c for label, c in sass.items() if "bf16" in label}
    if not bf16 or any(c["HMMA"] == 0 or (c["UTMALDG"] == 0 or c["SYNCS"] == 0
                                          if label.endswith(",1>") else c["LDGSTS"] == 0)
                       for label, c in bf16.items()):
        fail(f"the generic kernel's bf16 forms show no mma, or no copy of their kind, in their "
             f"SASS: {bf16}")
    # timing: int4 g = 8 at 4096 x 4096 (the g8 engine's wq / wo), rotated
    K, N, g = 4096, 4096, 8
    copies = _rotated(lambda: _qweight(K, N, "int4", g, gen), K * N // 2 + 4 * (K // g) * N)
    wds = [deq(w, torch.bfloat16) for w in copies[:max(2, -(-QGEMM_ROTATE_BYTES // (2 * K * N)))]]
    entry = None
    for M in (8, 512):
        x = torch.randn((M, K), generator=gen, device="cuda").to(torch.bfloat16)
        ms, dev = timed(_cycler(lambda w: qeinsum("me,eo->mo", x, w, torch.bfloat16), copies),
                        {8: 50, 512: 20}[M])
        lib_ms, lib_dev = timed(_cycler(lambda wd: torch.matmul(x, wd), wds), {8: 50, 512: 20}[M])
        plain_ms = time_ms(lambda: qeinsum_plain("me,eo->mo", x, copies[0], torch.bfloat16), 3)
        bound_ms, bound_by = qgemm_bound_ms(M, K, N, 4, g)
        flush_ms, flush_by = qgemm_flush_bound_ms(M, K, N, 4, g)
        plan = kernels.qgemm_generic_plan(M, N, K, 4, g, kernels._sm_count(0))
        log(f"  qgemm generic timing int4 g=8 M={M} K={K} N={N} bf16 (plan: {plan.ctas} blocks, "
            f"mt {plan.mt}, {plan.total} granules; {len(copies)} weight copies) [{gpu_line()}]: "
            f"kernel wall {ms:.4f} ms (device {dev:.4f}), library (cuBLAS on the bf16 weight) "
            f"wall {lib_ms:.4f} ms (device {lib_dev:.4f}), plain wall {plain_ms:.4f} ms, bound "
            f"{bound_ms:.4f} ms ({bound_by}), flush-aware bound {flush_ms:.4f} ms ({flush_by}); "
            f"share, device: of the bound {bound_ms / dev:.4f}, of the flush-aware bound "
            f"{flush_ms / dev:.4f}; device against cuBLAS's {dev / lib_dev:.3f}x")
        if M == 8:
            entry = dict(name="qgemm_generic", route="cuda", source=f"{PKG}/csrc/qgemm.cu",
                         replaces="django_assistant_bot_tpu/ops/quant.py:160", max_abs_err=worst,
                         ms=ms, device_ms=dev, plain_ms=plain_ms, bound_ms=bound_ms,
                         bound_by=bound_by, library_ms=lib_ms, library_device_ms=lib_dev,
                         flush_bound_ms=flush_ms)
    del copies, wds
    # the tied int8 head at Llama-3-8B's table, M = 8
    V, E, M = 128256, 4096, 8
    tw = QTensor(torch.randint(-127, 128, (V, E), generator=gen, device="cuda", dtype=torch.int8),
                 torch.exp(torch.rand((1, E), generator=gen, device="cuda") * 4.6) * 1e-3)
    table = deq(tw, torch.bfloat16)  # the bf16 table the library reads
    x = torch.randn((M, E), generator=gen, device="cuda").to(torch.bfloat16)
    ms, dev = timed(lambda: tied_head(x, tw, torch.bfloat16), 50)
    lib_ms, lib_dev = timed(lambda: torch.matmul(x, table.T), 50)
    plain_ms = time_ms(lambda: tied_head_plain(x, tw, torch.bfloat16), 5)
    nbytes = V * E + 4 * E + 2 * M * E + 2 * M * V
    bound_ms = max(nbytes / PEAK_HBM_BYTES, 2.0 * M * V * E / PEAK_BF16_FLOPS) * 1e3
    log(f"  qgemm tied int8 head timing V={V} E={E} M={M} bf16 (stream route, K-contiguous; "
        f"the table {V * E / 1e6:.1f} MB, L2 holds 50 MB): kernel wall {ms:.4f} ms (device "
        f"{dev:.4f}), library torch.matmul on the bf16 table wall {lib_ms:.4f} ms (device "
        f"{lib_dev:.4f}), plain wall {plain_ms:.4f} ms, bound {bound_ms:.4f} ms (bytes); share "
        f"of the bound, device {bound_ms / dev:.3f}")
    del tw, table
    torch.cuda.empty_cache()
    return entry


def _sample_inputs(B, V, dtype, json_rows, ties, gen):
    """Logits and the sampler's keywords for one phase-2 case: rows greedy
    and sampled, top_p 0.5 / 0.95 / 1.0 among them, the noise pre-drawn;
    with ``json_rows`` the byte tokenizer's real JSON FSM (padded to V as
    the engine pads it) masks the odd rows, each in another state; ``ties``
    plants a block of equal maxima and rounds the rest (ties everywhere)."""
    import numpy as np
    import torch

    from django_assistant_bot_tpu_torch.ops.sampling import gumbel_noise
    from django_assistant_bot_tpu_torch.serving import ByteTokenizer
    from django_assistant_bot_tpu_torch.serving.engine import token_fsm

    logits = torch.randn((B, V), generator=gen, device="cuda") * 3
    if ties:
        logits = logits.round()
        logits[:, 70_000:70_400] = 12.0
    logits = logits.to(dtype)
    temps = torch.tensor([0.0, 0.7, 1.0, 0.0, 1.3, 0.8, 0.0, 0.5][:B], device="cuda")
    top_ps = torch.tensor([0.5, 0.95, 1.0, 0.95, 0.5, 1.0, 0.95, 0.95][:B], device="cuda")
    kw = dict(temperature=temps, top_k=50, top_p=top_ps,
              gumbel=gumbel_noise(torch.empty((B, 50), device="cuda"), gen))
    if json_rows:
        fsm = token_fsm(ByteTokenizer())
        S, Vt = fsm.allowed.shape
        allowed = np.zeros((S, V), bool)
        allowed[:, :Vt] = fsm.allowed
        nxt = np.full((S, V), fsm.dead, np.int32)
        nxt[:, :Vt] = fsm.next_state
        # states reached by real prefixes: the initial one, inside a string,
        # after a key's colon, after '{'
        states = [fsm.initial]
        for text in ('{"a', '{"a":', "{"):
            st = fsm.initial
            for ch in text.encode():
                st = int(fsm.next_state[st, ch])
            states.append(st)
        kw.update(allowed=torch.from_numpy(allowed).cuda(), next_state=torch.from_numpy(nxt).cuda(),
                  fsm_state=torch.tensor([states[i % 4] for i in range(B)], dtype=torch.int32,
                                         device="cuda"),
                  jmask=torch.tensor([i % 2 == 1 for i in range(B)], device="cuda"))
    return logits, kw


def check_sample(gen) -> dict:
    """The fused sampler (``csrc/sample.cu``) against its plain twin at B =
    8, V = 128,256, k = 50: f32 and bf16 logits, with and without a JSON
    mask from the real FSM at the byte tokenizer, and a planted tie block;
    ids and advanced states must be equal, except rows whose plain-twin
    top-p margin ``|cum - p - top_p|`` is under 1e-6 (counted and printed).
    Then its time (wall, device), bound (the logits read once, plus the mask
    rows in a JSON step), the plain twin's, and ``torch.topk(k=50)`` alone
    over the same logits: a partial yardstick (the top-k of the library
    route, not the whole function)."""
    import torch

    from django_assistant_bot_tpu_torch import kernels
    from django_assistant_bot_tpu_torch.ops.sampling import (
        sample_logits, sample_logits_plain, top_p_margin)

    B, V = 8, 128256
    cases = [(torch.float32, False, False), (torch.bfloat16, False, False),
             (torch.float32, True, False), (torch.bfloat16, True, True),
             (torch.float32, False, True)]
    boundary = 0
    for dtype, json_rows, ties in cases:
        logits, kw = _sample_inputs(B, V, dtype, json_rows, ties, gen)
        before = kernels.LAUNCHES["sample"]
        got = sample_logits(logits, **kw)
        launched = kernels.LAUNCHES["sample"] - before
        want = sample_logits_plain(logits, **kw)
        margin = top_p_margin(logits, **kw)
        torch.cuda.synchronize()
        ids, states = got if json_rows else (got, None)
        wids, wstates = want if json_rows else (want, None)
        near = margin < 1e-6
        differ = (ids != wids) & ~near
        if states is not None:
            differ |= (states != wstates) & ~near
        boundary += int(near.sum())
        log(f"  sample B={B} V={V} k=50 {str(dtype)[6:]} json={json_rows} ties={ties}: ids "
            f"{ids.tolist()} (plain {wids.tolist()}){'' if states is None else f', states {states.tolist()} (plain {wstates.tolist()})'}; "
            f"rows at the top-p boundary (margin < 1e-6): {int(near.sum())}; "
            f"least margin {margin.min().item():.3e}; launches {launched}")
        if bool(differ.any()) or launched != 1:
            fail(f"sample {dtype} json={json_rows} ties={ties} disagrees with its plain twin "
                 f"(rows {differ.nonzero().flatten().tolist()}) or launched {launched}")
        if json_rows:
            ok = kw["allowed"][kw["fsm_state"].long(), ids.long()]
            if not bool((ok | ~kw["jmask"]).all()):
                fail("a JSON row of the sampler took a token its state does not allow")
    log(f"  sample: {boundary} row(s) excepted at the top-p boundary over {len(cases)} cases")
    # timing: the main path's step (f32 logits, no JSON) and a JSON step
    out = {}
    for json_rows in (False, True):
        logits, kw = _sample_inputs(B, V, torch.float32, json_rows, False, gen)
        ms, dev = timed(lambda: sample_logits(logits, **kw), 200)
        plain_ms = time_ms(lambda: sample_logits_plain(logits, **kw), 5)
        topk_ms, topk_dev = timed(lambda: torch.topk(logits, 50, dim=-1), 200)
        nbytes = B * V * 4 + (B * V if json_rows else 0) + B * 50 * 4 + B * 4 * 4
        bound_ms = nbytes / PEAK_HBM_BYTES * 1e3
        log(f"  sample timing B={B} V={V} k=50 f32 json={json_rows}: kernel wall {ms:.4f} ms "
            f"(device {dev:.4f}), bound {bound_ms:.5f} ms (bytes), plain wall {plain_ms:.4f} ms, "
            f"torch.topk(k=50) alone (a partial yardstick) wall {topk_ms:.4f} ms (device "
            f"{topk_dev:.4f}); share of the bound, device {bound_ms / dev:.4f}")
        if not json_rows:
            out = dict(ms=ms, device_ms=dev, plain_ms=plain_ms, bound_ms=bound_ms,
                       bound_by="bytes", library_ms=topk_ms)
    return {"name": "sample", "route": "cuda", "source": f"{PKG}/csrc/sample.cu",
            "replaces": "django_assistant_bot_tpu/ops/sampling.py:73", "max_abs_err": 0.0, **out}


ANN_ROWS = 2_000_000  # the corpus of phases 2 and 9: 2,000,000 x 768
ANN_DIM = 768
ANN_CLUSTERS = 64  # make_clustered's geometry: 64 centres, 0.25 noise
ANN_DUPS = 4096  # phase 2: rows [4096, 8192) repeat rows [0, 4096): exact ties
ANN_PLANTED = 64  # phase 9: near-duplicate queries of 64 corpus rows
ANN_QUERY_NOISE = 0.05  # per-dimension noise of a planted query (probe_recall's)
ANN_DRILL_ROWS = 65_536  # the durability drill's corpus
PEAK_F32_FLOPS = 67e12  # H100 SXM, f32 outside the tensor cores


def ann_build(n: int, dim: int, seed: int, dups: int = 0):
    """An ``ANNIndex`` on the card built the way a user builds one: ``add``
    in batches, then ``train()`` at the auto geometry.  The corpus is drawn
    on the card in chunks from a seeded ``torch.Generator`` with
    ``make_clustered``'s distribution (64 centres, 0.25 noise) and handed to
    ``add`` as host rows; with ``dups``, rows ``[dups, 2 dups)`` repeat rows
    ``[0, dups)``.  Returns (index, wall seconds: add, train and the train's
    stages)."""
    import torch

    from django_assistant_bot_tpu_torch.storage.ann import ANNIndex

    gen = torch.Generator(device="cuda").manual_seed(seed)
    centers = torch.randn((ANN_CLUSTERS, dim), generator=gen, device="cuda")
    index = ANNIndex(dim, seed=seed)
    index.reserve(n)
    t0 = time.perf_counter()
    for s0 in range(0, n, 1 << 17):
        e = min(n, s0 + (1 << 17))
        pick = torch.randint(0, ANN_CLUSTERS, (e - s0,), generator=gen, device="cuda")
        rows = centers[pick] + 0.25 * torch.randn((e - s0, dim), generator=gen, device="cuda")
        if s0 == 0 and dups:
            rows[dups:2 * dups] = rows[:dups]
        index.add(range(s0, e), rows.cpu().numpy())
    add_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    index.train()
    torch.cuda.synchronize()
    return index, {"add_s": add_s, "train_s": time.perf_counter() - t0, **index.last_restage}


def ann_geometry(index) -> str:
    st = index.stats()
    return (f"nlist {st['nlist']}, m {st['m']}, list_cap {st['list_cap']} (fullest list "
            f"{st['list_fill_max']}), nprobe {st['nprobe']}, rerank depth {st['rerank_depth']}; "
            f"codes {index._codes.numel() / 1e9:.3f} GB, rerank tier "
            f"{index._rerank.numel() * 2 / 1e9:.3f} GB on the card")


def _timing_text(t: dict) -> str:
    return ", ".join(f"{k} {v:.2f}" for k, v in t.items())


def adc_inputs(index, q, nprobe: int):
    """The centroid top-``nprobe`` and the LUT of ``_adc_shortlist``."""
    import torch

    from django_assistant_bot_tpu_torch.ops.sampling import top_k_auto

    top_c, top_ci = top_k_auto(q @ index._centroids.T, nprobe)
    lut = torch.einsum("qms,mcs->qmc", q.reshape(q.shape[0], index.m, index.sub_dim),
                       index._codebooks)
    return top_c, top_ci, lut


def adc_bound_ms(index, lvalid, top_ci, S: int, fill=None) -> tuple:
    """Least time for the ADC scan + shortlist.  With ``fill`` (the bound):
    the probed lists (each list once, however many queries probe it) read
    once, their validity bytes up to each list's fill and, for their valid
    slots, the m code bytes; the f32 LUT, the probes, the S outputs' row
    positions and the outputs once.  Without it, the padded figure (the
    bound of the scan over every slot): the validity of all L slots of each
    probed list and, for each valid slot, its code bytes and row position
    beside the same LUT, probes and outputs.  At the HBM rate, against one
    f32 addition per valid code byte and query at the card's f32 rate."""
    Q, P = top_ci.shape
    _, L, m = index._codes.shape
    lists = top_ci.unique().long()
    valid_slots = int(lvalid[lists].sum())
    if fill is None:
        lists_bytes = lists.numel() * L + valid_slots * (m + 4)
    else:
        lists_bytes = int(fill[lists].clamp(0, L).sum()) + valid_slots * m + Q * S * 4
    nbytes = lists_bytes + Q * m * 256 * 4 + Q * P * 8 + Q * S * 8
    ops = float(lvalid[top_ci.long()].sum()) * m
    t_bytes = nbytes / PEAK_HBM_BYTES * 1e3
    t_ops = ops / PEAK_F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def rerank_bound_ms(tier, rvalid, sl_scores, sl_pos, k: int) -> tuple:
    """Least time for the rerank: the distinct rows the shortlist keeps
    (finite score, valid row) read once (bf16), the shortlist, the f32
    queries and the outputs once, at the HBM rate, against 2 D operations a
    kept row at the f32 rate."""
    import torch

    Q, S = sl_pos.shape
    D = tier.shape[1]
    pos = sl_pos.long()
    ok = torch.isfinite(sl_scores) & rvalid[pos]
    rows = int(pos[ok].unique().numel())
    nbytes = rows * D * 2 + Q * S * 9 + Q * D * 4 + Q * k * 8
    t_bytes = nbytes / PEAK_HBM_BYTES * 1e3
    t_ops = 2.0 * float(ok.sum()) * D / PEAK_F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _ties(scores) -> int:
    """Adjacent equal finite scores in each row of a sorted result."""
    import torch

    s = scores[:, 1:]
    return int(((s == scores[:, :-1]) & torch.isfinite(s)).sum())


def check_ann(index) -> list:
    """``ann_adc`` and ``ann_rerank`` against their plain twins on phase 9's
    index (built once, there): 2,000,000 x 768 through ``add`` +
    ``train()`` (nlist 4096, m 96, list_cap as trained), with rows [4096,
    8192) repeating rows [0, 4096), queries near those rows (Q 1, 8, 32),
    nprobe 64 and 256, shortlist 256, k 16, and one probed list made
    all-invalid (tombstones through its fill); then at Q 8, nprobe 64 three
    cases on the same lists: a probed list emptied (its fill 0), random
    tombstones inside the probed lists' fills, and four probes holding
    fewer valid slots than the shortlist of 2,048 (the -inf tail).  The ADC
    kernel gets the index's fill (``ANNIndex._fill``); its scores must
    equal the twin's bit for bit and the positions the twin's (keys are
    unique under (score, lower flat index first)); the rerank is held to
    ``rerank_agreement`` (``topk_score_bound``, ids at separated ranks).
    Then both kernels' time at the main path's search (Q 8, the default
    nprobe 64, shortlist 256, k 16): wall ms and device ms (graph replays,
    :func:`graph_device_ms`: the ADC is one launch, whose scan / merge split
    ``tools/ann_adc_ab.py --probe`` times), the bound (to each probed
    list's fill; the padded figure, every slot, beside it) and its share,
    the plain twins' ms, for the rerank the library yardstick (gather + ``torch.bmm`` + ``torch.topk``); and the ADC
    kernel alone at Q 32, nprobe 64 and at Q 8 / 128, nprobe 1024 (the
    recall sweep's), with its plan and scratch bytes.  The ADC scan has no
    library call that computes it."""
    import numpy as np
    import torch

    from django_assistant_bot_tpu_torch import kernels
    from django_assistant_bot_tpu_torch.storage.ann import (
        adc_shortlist, adc_shortlist_plain, rerank, rerank_plain)
    from django_assistant_bot_tpu_torch.storage.knn import _normalize
    from django_assistant_bot_tpu_torch.storage.knn_check import rerank_agreement

    codes, lvalid, rowpos = index._codes, index._lvalid, index._rowpos
    fill, mean_fill = index._fill, index._mean_fill
    tier, rvalid = index._rerank, index._rvalid
    rng = np.random.default_rng(2)
    plan = kernels.ann_adc_plan(8, index._nprobe_eff(), codes.shape[1], index.m, 256, mean_fill,
                                torch.cuda.get_device_properties(0).multi_processor_count)
    smem = ptxas_smem(kernels.BUILD_LOG.get("ann_adc", "")
                      + kernels.BUILD_LOG.get("ann_rerank", ""))
    log(f"  ann shared memory per block: adc_kernel<16> {plan.smem} B dynamic at Q 8, nprobe "
        f"{index._nprobe_eff()}, S 256 (the LUT of {plan.chunk} subspaces and a {plan.cap}-key "
        f"buffer, or the merge's keys, then the select's) + {smem.get('adc_kernel<16>', 0)} B "
        f"static, rerank_kernel {smem.get('rerank_kernel', 0)} B static + {ANN_DIM * 4} B "
        "dynamic (the query)")

    def queries(Q):
        src = rng.choice(ANN_DUPS, size=Q, replace=False)
        qs = index._mat[src] + ANN_QUERY_NOISE * rng.standard_normal((Q, ANN_DIM))
        return torch.from_numpy(_normalize(qs).astype(np.float32)).cuda()

    def adc_case(label, q, P, S, lv, fl):
        top_c, top_ci, lut = adc_inputs(index, q, P)
        args = (codes, lv, rowpos, top_ci, top_c, lut, S)
        got_s, got_p = adc_shortlist(*args, fl, mean_fill)
        want_s, want_p = adc_shortlist_plain(*args)
        torch.cuda.synchronize()
        same_s, same_p = torch.equal(got_s, want_s), torch.equal(got_p, want_p)
        ties = _ties(want_s)
        log(f"  ann_adc {label} Q={q.shape[0]} nprobe={P} S={S}: scores bit-equal {same_s}, "
            f"positions equal {same_p}, tied neighbours in the twin's shortlist {ties}, finite "
            f"{int(torch.isfinite(want_s).sum())} of {q.shape[0] * S}")
        if not (same_s and same_p):
            diff = (got_s - want_s).abs()
            fin = diff[torch.isfinite(diff)]
            fail(f"ann_adc {label} Q={q.shape[0]} nprobe={P} disagrees with its plain twin: "
                 f"max |diff| {fin.max().item() if fin.numel() else 'inf'}, "
                 f"{int((got_p != want_p).sum())} positions differ")
        return got_s, got_p, ties, top_ci, int(torch.isfinite(want_s).sum())

    S, k = 256, 16
    adc_ties = rr_ties = 0
    worst, worst_err = 0.0, 0.0
    for Q in (1, 8, 32):
        q = queries(Q)
        for P in (64, 256):
            top_ci = adc_inputs(index, q, P)[1]
            lv = lvalid.clone()
            lv[top_ci[0, 1].long()] = False  # a probed list made all-invalid
            got_s, got_p, ties, _, _ = adc_case("dead list", q, P, S, lv, fill)
            adc_ties += ties
            r_s, r_p = rerank(tier, rvalid, q, got_s, got_p, k)
            torch.cuda.synchronize()
            rep = rerank_agreement(tier, rvalid, q, got_s, got_p, r_s, r_p)
            rr_ties += _ties(r_s)
            log(f"  ann_rerank Q={Q} nprobe={P} S={S} k={k}: max_abs_err "
                f"{rep['max_abs_err']:.3e}, worst err/bound {rep['worst']:.4f} (bound D 2^-22 "
                f"|q| max|x|), ids compared {rep['ids_compared']}, tied neighbours {_ties(r_s)}")
            if rep["problems"]:
                fail(f"ann_rerank Q={Q} nprobe={P} disagrees with its plain twin: {rep['problems']}")
            worst, worst_err = max(worst, rep["worst"]), max(worst_err, rep["max_abs_err"])
    log(f"  ann: tied neighbours over the cases: ADC shortlists {adc_ties}, reranked top-k {rr_ties}")
    if not adc_ties or not rr_ties:
        fail("the planted duplicate rows gave no tie: the tie order went unchecked")
    # the fill's cases, at Q 8, nprobe 64, on the same lists
    q = queries(8)
    top_ci = adc_inputs(index, q, 64)[1]
    empty = top_ci[0, 2].long()
    lv, fl = lvalid.clone(), fill.clone()
    lv[empty], fl[empty] = False, 0  # a probed list emptied: fill 0
    adc_case("fill 0", q, 64, S, lv, fl)
    probed = top_ci.unique().long()
    g = torch.Generator(device="cuda").manual_seed(3)
    lv = lvalid.clone()
    lv[probed] &= torch.rand((probed.numel(), lv.shape[1]), generator=g, device="cuda") < 0.7
    adc_case("tombstones", q, 64, S, lv, fill)
    lv = lvalid.clone()
    lv[probed] &= torch.rand((probed.numel(), lv.shape[1]), generator=g, device="cuda") < 0.05
    *_, finite = adc_case("tail", q, 4, 2048, lv, fill)
    if finite >= 8 * 2048:
        fail("the tail case held no -inf slot: the tail went unchecked")

    # timing at the main path's search: Q 8, the default nprobe, S 256, k 16
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    P = index._nprobe_eff()
    q = queries(8)
    top_c, top_ci, lut = adc_inputs(index, q, P)
    args = (codes, lvalid, rowpos, top_ci, top_c, lut, S, fill, mean_fill)
    ms = time_ms(lambda: adc_shortlist(*args), 30)
    dev = graph_device_ms(lambda: adc_shortlist(*args), 30)
    plain_ms = time_ms(lambda: adc_shortlist_plain(*args[:7]), 3)
    bound_ms, bound_by = adc_bound_ms(index, lvalid, top_ci, S, fill)
    padded_ms, padded_by = adc_bound_ms(index, lvalid, top_ci, S)
    plan = kernels.ann_adc_plan(8, P, codes.shape[1], index.m, S, mean_fill, sms)
    log(f"  ann_adc timing Q=8 nprobe={P} S={S} (list_cap {codes.shape[1]}, mean fill "
        f"{mean_fill}): kernel wall {ms:.4f} ms, device {dev:.4f} (graph replays of its one "
        f"launch), plain wall {plain_ms:.4f} ms, bound {bound_ms:.5f} ms ({bound_by}; padded "
        f"{padded_ms:.5f}, {padded_by}); share of the bound, device {bound_ms / dev:.4f} "
        f"(padded {padded_ms / dev:.4f}); plan {plan.blocks} blocks a query, LUT chunk "
        f"{plan.chunk}, {plan.smem} B shared; scratch {plan.cand_keys * 8 + plan.counters * 4} "
        f"B (the parent's [Q, P L] scores {8 * P * codes.shape[1] * 4} B); library: none (no "
        "PyTorch call computes the LUT-sum scan)")
    adc = dict(ms=ms, device_ms=dev, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
               library_ms=None, padded_bound_ms=padded_ms)
    for Qx, Px in ((32, P), (8, 1024), (128, 1024)):
        tcx, tix, lutx = adc_inputs(index, queries(Qx), Px)
        xargs = (codes, lvalid, rowpos, tix, tcx, lutx, S, fill, mean_fill)
        x_ms = time_ms(lambda: adc_shortlist(*xargs), 10)
        x_dev = graph_device_ms(lambda: adc_shortlist(*xargs), 10)
        xb, xby = adc_bound_ms(index, lvalid, tix, S, fill)
        xp_ms, _ = adc_bound_ms(index, lvalid, tix, S)
        xp = kernels.ann_adc_plan(Qx, Px, codes.shape[1], index.m, S, mean_fill, sms)
        log(f"  ann_adc timing Q={Qx} nprobe={Px} S={S}: kernel wall {x_ms:.4f} ms (device "
            f"{x_dev:.4f}), bound {xb:.5f} ms ({xby}; padded {xp_ms:.5f}), share device "
            f"{xb / x_dev:.4f} (padded {xp_ms / x_dev:.4f}); plan {xp.blocks} blocks a query; "
            f"scratch {xp.cand_keys * 8 + xp.counters * 4} B (the parent's [Q, P L] scores "
            f"{Qx * Px * codes.shape[1] * 4} B)")
        adc[f"q{Qx}_p{Px}_ms"], adc[f"q{Qx}_p{Px}_device_ms"] = x_ms, x_dev
    sl_s, sl_p = adc_shortlist(*args)
    rargs = (tier, rvalid, q, sl_s, sl_p, k)
    r_ms = time_ms(lambda: rerank(*rargs), 50)
    r_dev = graph_device_ms(lambda: rerank(*rargs), 50)
    r_plain = time_ms(lambda: rerank_plain(*rargs), 5)
    pos = sl_p.long()
    ok = torch.isfinite(sl_s) & rvalid[pos]
    qb = q.to(torch.bfloat16)
    lib_ms, lib_dev = timed(lambda: torch.topk(torch.bmm(tier[pos], qb[:, :, None]).squeeze(-1)
                                               .float().masked_fill_(~ok, float("-inf")), k), 50)
    r_bound, r_by = rerank_bound_ms(tier, rvalid, sl_s, sl_p, k)
    log(f"  ann_rerank timing Q=8 S={S} k={k} D={ANN_DIM}: kernel wall {r_ms:.4f} ms (device "
        f"{r_dev:.4f}), plain wall {r_plain:.4f} ms, library (gather + bmm + topk) wall "
        f"{lib_ms:.4f} ms (device {lib_dev:.4f}), bound {r_bound:.5f} ms ({r_by}); share of the "
        f"bound, device {r_bound / r_dev:.4f}")
    rr = dict(ms=r_ms, device_ms=r_dev, plain_ms=r_plain, bound_ms=r_bound, bound_by=r_by,
              library_ms=lib_ms)
    del codes, lvalid, rowpos, tier, rvalid, args, rargs, sl_s, sl_p, pos, ok, lv, fl
    return [
        {"name": "ann_adc", "route": "cuda", "source": f"{PKG}/csrc/ann_adc.cu",
         "replaces": "django_assistant_bot_tpu/storage/ann.py:208", "max_abs_err": 0.0, **adc},
        {"name": "ann_rerank", "route": "cuda", "source": f"{PKG}/csrc/ann_rerank.cu",
         "replaces": "django_assistant_bot_tpu/storage/ann.py:251", "max_abs_err": worst_err,
         **rr},
    ]


MOE_E, MOE_F, MOE_X, MOE_K = 4096, 14336, 8, 2  # Mixtral 8x7B's layer (config.py:261-275)
PEAK_F32_FLOPS = 67e12  # the CUDA cores' f32 rate (the router, the combine, the f32 GEMMs)


def moe_layer_weights(dtype, gen) -> dict:
    """One Mixtral-width MoE layer's random weights (``llama.init``'s scales)."""
    import torch

    E, F, X = MOE_E, MOE_F, MOE_X

    def w(shape, scale):
        return (torch.randn(shape, generator=gen, device="cuda") * scale).to(dtype)

    return {"router": w((E, X), E ** -0.5), "w_gate": w((X, E, F), E ** -0.5),
            "w_up": w((X, E, F), E ** -0.5), "w_down": w((X, F, E), F ** -0.5)}


def moe_bounds_ms(x, p, routing) -> dict:
    """Each MoE kernel's bound on this run's routing: (ms, "bytes" or
    "operations"), the larger of the bytes it must move (each input read
    once, each output written once: only the live experts' weights, the
    kept rows) at 3.35 TB/s and its operations at the tensor cores' bf16
    rate (the GEMMs in bf16) or the CUDA cores' f32 rate."""
    import torch

    tok_slot, _, slot_tok, fill = routing
    T, E = x.shape
    X, _, F = p["w_gate"].shape
    K = tok_slot.shape[1]
    C = slot_tok.shape[1]
    es = x.element_size()
    live = int((fill > 0).sum())
    rows = int(fill.sum())
    kept = int((tok_slot >= 0).sum())
    gemm_peak = PEAK_BF16_FLOPS if x.dtype == torch.bfloat16 else PEAK_F32_FLOPS

    def bound(nbytes, ops, peak):
        b, o = nbytes / PEAK_HBM_BYTES * 1e3, ops / peak * 1e3
        return (b, "bytes") if b >= o else (o, "operations")

    return {
        "route": bound(T * E * es + E * X * es + T * K * 8 + X * C * 4 + X * 4, 2 * T * E * X,
                       PEAK_F32_FLOPS),
        "gate_up": bound(live * 2 * E * F * es + rows * E * es + rows * F * es, 4 * rows * E * F,
                         gemm_peak),
        "down": bound(live * F * E * es + rows * F * es + rows * E * es, 2 * rows * F * E,
                      gemm_peak),
        "combine": bound(kept * E * es + T * K * 8 + T * E * es, 2 * kept * E, PEAK_F32_FLOPS),
    }


def check_moe_layer(x, p, C, label: str, *, drops_expected=False) -> dict:
    """The four MoE kernels on ``x [T, E]`` through one layer ``p`` at
    capacity ``C``, each against its plain twin on the card: the routing
    (ids and gates equal outside tokens near a tie, slots and fill equal
    outside the flagged tokens, all equal when none is near), each GEMM
    epilogue within ``moe_gemm_bf16_bound`` (bf16) or ``F32_TOL`` (f32) on
    its live rows, the combine bit-equal given the kernel's ``ye``.
    Returns the errors and the routing."""
    import torch

    from django_assistant_bot_tpu_torch import kernels
    from django_assistant_bot_tpu_torch.ops import moe

    K = MOE_K
    routing = moe.moe_route(x, p["router"], K, C)
    want = moe.moe_route_plain(x, p["router"], K, C)
    near, flagged = moe.route_margin(x, p["router"], K)
    tok_slot, tok_gate, slot_tok, fill = routing
    both = (tok_slot >= 0) & (want[0] >= 0) & ~near[:, None]
    ids_ok = bool(((tok_slot // C) == (want[0] // C))[both].all())
    gate_err = (tok_gate - want[1]).abs()[~near].max().item() if bool((~near).any()) else 0.0
    slots_ok = bool((tok_slot == want[0])[~flagged].all())
    exact = torch.equal(tok_slot, want[0]) and torch.equal(slot_tok, want[2]) and \
        torch.equal(fill, want[3])
    drops = int((tok_slot < 0).sum())
    live_experts = int((fill > 0).sum())
    live = torch.arange(C, device="cuda")[None, :, None] < fill[:, None, None].long()
    before = dict(kernels.MOE_GEMM_FORMS)
    h = moe.moe_expert_gemm(x, slot_tok, fill, p["w_gate"], p["w_up"], epilogue="gate_up")
    ye = moe.moe_expert_gemm(h, slot_tok, fill, p["w_down"], epilogue="down")
    routes = moe_routes(x.dtype, p, C)
    taken = sorted(f for f, n in kernels.MOE_GEMM_FORMS.items() for _ in range(n - before[f]))
    if taken != sorted(f"{r}:{e}" for e, r in zip(("gate_up", "down"), routes)):
        fail(f"{label}: the grouped GEMM took {taken}, its plan (gate/up, down) {routes}")
    errs = {}
    for kind, out, args in (("gate_up", h, (x, slot_tok, p["w_gate"], p["w_up"])),
                            ("down", ye, (h, slot_tok, p["w_down"]))):
        if x.dtype == torch.bfloat16:
            ref, bound = moe.moe_gemm_bf16_bound(*args, epilogue=kind)
        else:
            ref = moe.moe_expert_gemm_plain(*args[:2], fill, *args[2:], epilogue=kind)
            bound = torch.full_like(ref, F32_TOL)
        # rows past fill are never written (nor read), and the down reference
        # over them reads that garbage: only the live rows count, and a NaN
        # there fails the check
        diff = torch.where(live, (out.float() - ref).abs(), 0.0)
        ratio = torch.where(live, diff / bound, 0.0)
        errs[kind] = (diff.max().item(), ratio.max().item() if bool(ratio.isfinite().all())
                      else float("inf"))
    out = moe.moe_combine(tok_slot, tok_gate, ye)
    plain = moe.moe_combine_plain(tok_slot, tok_gate, ye)
    bits = torch.int16 if x.dtype == torch.bfloat16 else torch.int32
    combine_equal = torch.equal(out.view(bits), plain.view(bits))
    torch.cuda.synchronize()
    log(f"  {label}: C {C}, fill {fill.tolist()} ({live_experts} live experts, {drops} dropped "
        f"choices); route: near-tie tokens {int(near.sum())}, flagged {int(flagged.sum())}, ids "
        f"equal outside them {ids_ok}, gates max err {gate_err:.2e}, slots equal outside the "
        f"flagged {slots_ok}, all equal {exact}; gate_up max_abs_err {errs['gate_up'][0]:.3e} "
        f"worst err/bound {errs['gate_up'][1]:.4f}; down max_abs_err {errs['down'][0]:.3e} worst "
        f"err/bound {errs['down'][1]:.4f}; combine bit-equal {combine_equal}; routes gate/up "
        f"{routes[0]}, down {routes[1]}")
    if not (ids_ok and gate_err <= 1e-5 and slots_ok and (exact or bool(near.any()))):
        fail(f"moe_route {label} disagrees with its plain twin outside the flagged tokens")
    if errs["gate_up"][1] > 1 or errs["down"][1] > 1 or not combine_equal:
        fail(f"MoE kernels {label} outside their bounds: {errs}, combine equal {combine_equal}")
    if drops_expected and not drops:
        fail(f"{label}: the forced-drop case dropped nothing")
    return dict(routing=routing, errs=errs, gate_err=gate_err, drops=drops, routes=routes)


def moe_routes(dtype, p, C) -> tuple:
    """The grouped GEMM's (gate/up, down) routes for layer ``p``'s weights
    at capacity ``C``, as ``kernels.moe_gemm_plan`` gives them on this card."""
    import torch

    from django_assistant_bot_tpu_torch import kernels

    X, E, F = p["w_gate"].shape
    sms = kernels._sm_count(torch.cuda.current_device())
    return (kernels.moe_gemm_plan(dtype, "gate_up", X, C, E, F, sms=sms).route,
            kernels.moe_gemm_plan(dtype, "down", X, C, F, E, sms=sms).route)


def check_moe(gen) -> list:
    """The MoE kernels (``csrc/moe_route.cu``, ``csrc/moe_gemm.cu``) against
    their twins at Mixtral 8x7B's widths, one layer of random weights, each
    case's grouped GEMM routes asserted: T 8 (a decode tick, C 8: gate/up on
    ``mma``, down on ``mma_split``), the first T whose C reaches
    ``MOE_WGMMA_MIN_C``, 512 (a chunk, C 160: a ragged second slot tile)
    and 2,048 (``[4, 512]``, C 640) on ``wgmma``, T 512 and 2,048 at
    capacity factor 0.25 (drops), T 512 with every token routed to two
    experts (six empty experts, their tiles skipped); bf16, and f32 at T 8
    and 512 (``cuda_core``).  The wgmma kernels' SASS must hold HGMMA and
    UTMALDG, the mma kernels' HMMA, the routing and combine kernels'
    16-byte loads (LDG.E.128); a routing call at T 8 must show one kernel
    in its timing profile (profiled again where a profile loses its kernel
    records, and failing where ``MOE_ONE_LAUNCH_PROFILES`` all do), and the
    launch floor (one empty kernel's device time) is printed beside the
    routing and combine rows.  Then each kernel's time at T 8, 512 and
    2,048 (wall and device; at 512 and 2,048 the routing and the combine
    on inputs rotated over >= 256 MB), its bound, its twin's time and the
    yardstick: ``torch.bmm`` over the dense ``[X, C, E]`` dispatch (what the
    JAX einsums compute, reading every expert; wall and device), and for
    the combine one ``torch.matmul`` of the dense combine.  Returns six
    entries: the routing, gate/up and down at decode (T 8), gate/up and
    down on ``wgmma`` (T 512), the combine; each entry but the wgmma GEMMs'
    holds every T's reading in ``by_tokens``."""
    import dataclasses

    import torch

    from django_assistant_bot_tpu_torch import kernels
    from django_assistant_bot_tpu_torch.models import DecoderConfig
    from django_assistant_bot_tpu_torch.models.mixtral import expert_capacity
    from django_assistant_bot_tpu_torch.ops import moe

    cfg = DecoderConfig.mixtral_8x7b()
    edge = next(T for T in range(8, 8192, 8)
                if expert_capacity(cfg, T) >= kernels.MOE_WGMMA_MIN_C)
    worst = {"route": 0.0, "gate_up": 0.0, "down": 0.0, "gate_up_wgmma": 0.0,
             "down_wgmma": 0.0, "combine": 0.0}
    for dtype in (torch.bfloat16, torch.float32):
        p = moe_layer_weights(dtype, gen)
        cases = [(8, 1.25, False), (edge, 1.25, False), (512, 1.25, False), (2048, 1.25, False),
                 (512, 0.25, False), (2048, 0.25, False), (512, 1.25, True)]
        if dtype == torch.float32:
            cases = [(8, 1.25, False), (512, 1.25, False)]
        for T, factor, skew in cases:
            x = torch.randn((T, MOE_E), generator=gen, device="cuda")
            pp = p
            if skew:  # a constant feature that sends every token to experts 0 and 1
                x[:, 0] = 10.0
                router = p["router"].float().clone()
                router[0, :] = -5.0
                router[0, 0], router[0, 1] = 5.0, 4.0
                pp = {**p, "router": router.to(dtype)}
            x = x.to(dtype)
            C = expert_capacity(dataclasses.replace(cfg, expert_capacity_factor=factor), T)
            label = (f"moe {str(dtype)[6:]} T={T} factor={factor}"
                     + (" (every token to experts 0 and 1)" if skew else ""))
            r = check_moe_layer(x, pp, C, label, drops_expected=factor < 1)
            if skew and int((r["routing"][3] > 0).sum()) != 2:
                fail(f"{label}: want exactly two live experts")
            if dtype == torch.float32:
                want = ("cuda_core", "cuda_core")
            elif T == 8:
                want = ("mma", "mma_split")
            elif factor > 1 or T == 2048:
                want = ("wgmma", "wgmma")
            else:
                want = r["routes"]
            if r["routes"] != want:
                fail(f"{label}: grouped GEMM routes {r['routes']}, want {want}")
            for kind, route in zip(("gate_up", "down"), r["routes"]):
                key = f"{kind}_wgmma" if route == "wgmma" else kind
                worst[key] = max(worst[key], r["errs"][kind][0])
            worst["route"] = max(worst["route"], r["gate_err"])
        del p
    log(f"  moe: bf16 bounds, gate/up {moe.MOE_GEMM_BF16_BOUND_TEXT['gate_up']}; down "
        f"{moe.MOE_GEMM_BF16_BOUND_TEXT['down']} (on the live rows); f32 {F32_TOL:.0e}; worst "
        f"max_abs_err {worst}; wgmma from C {kernels.MOE_WGMMA_MIN_C} (T {edge})")
    sass = sass_table(kernels.lib_path("moe_gemm"))
    log(f"  moe_gemm SASS: {sass_counts(kernels.lib_path('moe_gemm'))}")
    wg = {label: c for label, c in sass.items() if label.startswith("moe_gemm_wgmma_kernel")}
    if len(wg) != 4 or any(c["HGMMA"] == 0 or c["UTMALDG"] == 0 for c in wg.values()):
        fail(f"moe_gemm's wgmma kernels show no wgmma or no TMA load in their SASS: {wg}")
    mm = {label: c for label, c in sass.items() if label.startswith("moe_gemm_mma_kernel")}
    if len(mm) != 2 or any(c["HMMA"] == 0 for c in mm.values()):
        fail(f"moe_gemm's mma kernels show no mma in their SASS: {mm}")
    sass = sass_table(kernels.lib_path("moe_route"))
    log(f"  moe_route SASS: {sass_counts(kernels.lib_path('moe_route'))}")
    for prefix, n in (("moe_route_kernel", 6), ("moe_combine_kernel", 2)):
        got = {label: c for label, c in sass.items() if label.startswith(prefix)}
        if len(got) != n or any(c["LDG.E.128"] == 0 for c in got.values()):
            fail(f"{prefix}: want {n} kernels with 16-byte loads (LDG.E.128) in the SASS: {got}")
    # the launch floor the T 8 rows are read against: one empty kernel
    floor_ms = device_ms(lambda: torch.cuda._sleep(0), 50)
    log(f"  launch floor: an empty kernel (torch.cuda._sleep(0)) device {floor_ms:.4f} ms")
    # timing at the decode tick's shape (T 8), bf16, and at a chunk and a [4, 512] prefill
    p = moe_layer_weights(torch.bfloat16, gen)
    reading = {}
    for T in (8, 512, 2048):
        x = torch.randn((T, MOE_E), generator=gen, device="cuda").to(torch.bfloat16)
        C = expert_capacity(cfg, T)
        routing = moe.moe_route(x, p["router"], MOE_K, C)
        tok_slot, tok_gate, slot_tok, fill = routing
        h = moe.moe_expert_gemm(x, slot_tok, fill, p["w_gate"], p["w_up"], epilogue="gate_up")
        ye = moe.moe_expert_gemm(h, slot_tok, fill, p["w_down"], epilogue="down")
        xe = moe._gate_up_inputs(x, slot_tok)
        dense_comb = torch.zeros((T, MOE_X * C), device="cuda", dtype=torch.bfloat16)
        kept = tok_slot >= 0
        rows = torch.arange(T, device="cuda")[:, None].expand(T, MOE_K)
        dense_comb[rows[kept], tok_slot[kept].long()] = tok_gate[kept].to(torch.bfloat16)
        bounds = moe_bounds_ms(x, p, routing)
        routes = dict(zip(("gate_up", "down"), moe_routes(torch.bfloat16, p, C)))
        # at T 512 and 2,048 the routing's x and the combine's ye and out
        # rotate over >= 256 MB of copies, so no call finds them in the 50 MB
        # L2 and the HBM bound holds; at T 8 they stay warm, as in a decode tick
        out = torch.empty((T, MOE_E), device="cuda", dtype=torch.bfloat16)
        if T >= 512:
            xs = _rotated(lambda: x.clone(), x.numel() * x.element_size())
            yes = _rotated(lambda: (ye.clone(), torch.empty_like(out)),
                           (ye.numel() + out.numel()) * ye.element_size())
        else:
            xs, yes = [x], [(ye, out)]
        calls = {
            "route": (_cycler(lambda xi: moe.moe_route(xi, p["router"], MOE_K, C), xs),
                      lambda: moe.moe_route_plain(x, p["router"], MOE_K, C), None),
            "gate_up": (lambda: moe.moe_expert_gemm(x, slot_tok, fill, p["w_gate"], p["w_up"],
                                                    epilogue="gate_up"),
                        lambda: moe.moe_expert_gemm_plain(x, slot_tok, fill, p["w_gate"],
                                                          p["w_up"], epilogue="gate_up"),
                        lambda: (torch.bmm(xe, p["w_gate"]), torch.bmm(xe, p["w_up"]))),
            "down": (lambda: moe.moe_expert_gemm(h, slot_tok, fill, p["w_down"], epilogue="down"),
                     lambda: moe.moe_expert_gemm_plain(h, slot_tok, fill, p["w_down"],
                                                       epilogue="down"),
                     lambda: torch.bmm(h, p["w_down"])),
            "combine": (_cycler(lambda c: kernels.moe_combine(tok_slot, tok_gate, *c), yes),
                        lambda: moe.moe_combine_plain(tok_slot, tok_gate, ye),
                        _cycler(lambda c: torch.matmul(dense_comb,
                                                       c[0].reshape(MOE_X * C, MOE_E)), yes)),
        }
        for kind, (fn, plain, lib) in calls.items():
            ms = time_ms(fn, 50)
            per = device_ms_by_kernel(fn, 50)
            if T == 8 and kind == "route":  # the decode tick's routing: one kernel
                for _ in range(MOE_ONE_LAUNCH_PROFILES - 1):
                    if EVENT_SPAN not in per:
                        break
                    log("  moe route T=8: the profile lost its kernel records; profiling again")
                    per = device_ms_by_kernel(fn, 50)
                log(f"  moe route T=8: the kernels of a call {per}")
                if EVENT_SPAN in per:
                    fail(f"moe_route at T 8: {MOE_ONE_LAUNCH_PROFILES} profiles lost their "
                         f"kernel records, so its one launch is not checked")
                if len(per) != 1:
                    fail(f"moe_route at T 8 launched {len(per)} kernels, want one: {per}")
                t8_kernels = len(per)
            dev = sum(per.values())
            plain_ms = time_ms(plain, 5)
            lib_ms = lib_dev = None
            if lib is not None:
                lib_ms, lib_dev = timed(lib, 50)
            bound_ms, bound_by = bounds[kind]
            route = routes.get(kind)
            log(f"  moe {kind} timing T={T} C={C} ({int((fill > 0).sum())} live experts) bf16"
                + (f", route {route}" if kind in routes else "")
                + f": kernel wall {ms:.4f} ms (device {dev:.4f}), plain twin wall "
                f"{plain_ms:.4f} ms, "
                + (f"yardstick wall {lib_ms:.4f} ms (device {lib_dev:.4f}), "
                   if lib is not None else "no library call, ")
                + f"bound {bound_ms:.5f} ms ({bound_by}); share of the bound, device "
                f"{bound_ms / dev:.4f}" + (f"; device against the yardstick's "
                                           f"{dev / lib_dev:.3f}x" if lib is not None else "")
                + (f"; launch floor {floor_ms:.4f}" if kind in ("route", "combine") else ""))
            reading[(T, kind)] = dict(ms=ms, device_ms=dev, plain_ms=plain_ms,
                                      bound_ms=bound_ms, bound_by=bound_by, library_ms=lib_ms,
                                      library_device_ms=lib_dev, C=C,
                                      gemm_route=route, launch_floor_device_ms=floor_ms,
                                      rotated_copies=(len(xs) if kind == "route" else len(yes))
                                      if kind in ("route", "combine") else None)
        del xs, yes
    del p
    gc_collect()
    src = {"route": "moe_route.cu", "gate_up": "moe_gemm.cu", "down": "moe_gemm.cu",
           "combine": "moe_route.cu"}
    replaces = {"route": 46, "gate_up": 65, "down": 70, "combine": 72}
    # entry name -> (kind, the T of its headline numbers)
    names = {"moe_route": ("route", 8), "moe_gemm_gate_up": ("gate_up", 8),
             "moe_gemm_down": ("down", 8), "moe_gemm_gate_up_wgmma": ("gate_up", 512),
             "moe_gemm_down_wgmma": ("down", 512), "moe_combine": ("combine", 8)}
    entries = []
    for name, (kind, T) in names.items():
        err = worst[f"{kind}_wgmma" if name.endswith("_wgmma") else kind]
        entry = {"name": name, "route": "cuda", "source": f"{PKG}/csrc/{src[kind]}",
                 "replaces": f"django_assistant_bot_tpu/models/mixtral.py:{replaces[kind]}",
                 "max_abs_err": err, **reading[(T, kind)]}
        if kind in ("gate_up", "down", "route", "combine"):
            entry["by_tokens"] = {str(t): reading[(t, kind)] for t in (8, 512, 2048)}
        if kind == "route":  # the kernels a T 8 call showed in its profile
            entry["t8_kernels_in_profile"] = t8_kernels
        entries.append(entry)
    return entries


# --------------------------------------------------------------------- phase 3
def small_reference() -> int:
    """A small f32 model (head_dim 64, so both kernels run) on the card
    against the same model on the CPU, where the plain twins run; returns
    the generic qgemm route's launches on the int4 g=8 tiny decoder."""
    import torch

    from django_assistant_bot_tpu_torch import kernels
    from django_assistant_bot_tpu_torch.models import DecoderConfig, llama
    from django_assistant_bot_tpu_torch.serving import ByteTokenizer, GenerationEngine

    cfg = DecoderConfig(
        vocab_size=512, hidden_size=256, intermediate_size=512, num_layers=2,
        num_heads=4, num_kv_heads=2, max_seq_len=1024, rope_theta=10_000.0,
        dtype=torch.float32,
    )
    params_cpu = llama.init(cfg, torch.Generator().manual_seed(3), "cpu")
    params_gpu = {
        k: ({n: w.cuda() for n, w in v.items()} if isinstance(v, dict) else v.cuda())
        for k, v in params_cpu.items()
    }
    ids = torch.randint(1, 255, (2, 512), generator=torch.Generator().manual_seed(4), dtype=torch.int32)
    lengths = torch.tensor([512, 300], dtype=torch.int32)
    lc, kc, _ = llama.prefill(params_cpu, cfg, ids, lengths)
    lg, kg, _ = llama.prefill(params_gpu, cfg, ids.cuda(), lengths.cuda())
    err = (lg.cpu() - lc).abs().max().item()
    log(f"  small model prefill (flash kernel vs plain): logits max_abs_err {err:.3e}")
    if not (torch.isfinite(lg).all() and lg.shape == (2, cfg.vocab_size) and err <= 1e-3):
        fail(f"small-model prefill on the card disagrees with the CPU: {err}")

    prompts = [torch.randint(1, 255, (n,), generator=torch.Generator().manual_seed(n)).tolist()
               for n in (40, 300, 450, 700)]

    prefill = {}  # the last run's paged prefill launches and chunk / suffix forwards

    def run(device, params, **kw):
        # the loop cranked on this thread, so both sides see the same waves
        eng = GenerationEngine(cfg, params, ByteTokenizer(), device=device,
                               max_slots=4, max_seq_len=1024, chunk_size=512, **kw)
        eng._running = True
        kernels.reset_counts()
        with counting_suffix_forwards() as fwd:
            futs = [eng.submit(p, max_tokens=16, temperature=0.0) for p in prompts]
            with torch.no_grad():
                for _ in range(1000):
                    if all(f.done() for f in futs):
                        break
                    eng._loop_iteration()
        eng._running = False
        prefill.update(launches=kernels.LAUNCHES["paged_prefill"],
                       forwards=fwd[0] + eng._prefill_chunks_piggybacked,
                       forms=dict(kernels.PAGED_PREFILL_FORMS))
        return [f.result(timeout=0).token_ids for f in futs], eng.decode_path_stats()

    ids_gpu, dec = run("cuda", params_gpu)  # graph of the fused 8-step tick, piggyback
    check_prefill_launches("phase 3, the small f32 engine at the default loop",
                           prefill["launches"], prefill["forwards"], cfg.num_layers,
                           prefill["forms"], "cuda_core:native")
    ids_cpu, _ = run("cpu", params_cpu)  # the same loop, eager
    ids_one, dec_one = run("cuda", params_gpu, decode_steps=1)
    log(f"  small model engine greedy ids at the default loop, card (CUDA graph, "
        f"{dec['decode_steps']}-step ticks, {dec['prefill_chunks_piggybacked']} piggybacked "
        f"chunk) vs CPU (eager): {'identical' if ids_gpu == ids_cpu else 'DIFFER'}; card at "
        f"decode_steps=1: {'identical' if ids_one == ids_cpu else 'DIFFER'}")
    if not (dec["cuda_graph"] and dec_one["cuda_graph"] and dec["decode_steps"] == 8
            and dec["prefill_chunks_piggybacked"] > 0):
        fail(f"the card engine did not run the graph / fused ticks / piggyback: {dec}, {dec_one}")
    if ids_gpu != ids_cpu:
        fail(f"greedy ids differ: card {ids_gpu} vs CPU {ids_cpu}")
    if ids_one != ids_cpu:
        fail(f"greedy ids differ at decode_steps=1: card {ids_one} vs CPU {ids_cpu}")
    small_prefix_wave(cfg, params_cpu, params_gpu)
    small_fault_restart(cfg, params_gpu, prompts[0])
    for fmt in ("int8", "int4"):
        small_quantized(cfg, params_cpu, fmt, ids, lengths, prompts, run)
    small_tied(cfg, params_cpu, prompts)
    generic = small_int4_g8()
    small_json(cfg, params_cpu, params_gpu, prompts)
    small_spec(cfg, params_cpu)
    small_fp8(cfg, params_cpu, params_gpu, prompts)
    return generic


def small_spec(cfg, params_cpu) -> None:
    """Speculative engines (``speculative=4, spec_width=4``, the
    controller re-probing every tick) on the small f32 model, dense and
    int8 (``quantize_decoder_params``): greedy ids on the card (each rung's
    tick a CUDA graph, the paged tree kernel's CUDA-core route at f32) equal
    to the CPU spec engine's (the twins) and to the card's plain engine's;
    drafts accepted; ``paged_tree`` launches = layers x verify steps."""
    import torch

    from django_assistant_bot_tpu_torch import kernels
    from django_assistant_bot_tpu_torch.ops.quant import quantize_decoder_params
    from django_assistant_bot_tpu_torch.serving import ByteTokenizer, GenerationEngine

    gen = torch.Generator().manual_seed(12)
    motif = torch.randint(1, 255, (11,), generator=gen).tolist()
    prompts = [motif * 8, torch.randint(1, 255, (300,), generator=gen).tolist(),
               motif * 30 + [3, 4], torch.randint(1, 255, (40,), generator=gen).tolist() * 3]

    def run(device, params, **kw):
        eng = GenerationEngine(cfg, params, ByteTokenizer(), device=device, max_slots=4,
                               max_seq_len=1024, chunk_size=512, **kw)
        eng._running = True
        kernels.reset_counts()
        futs = [eng.submit(p, max_tokens=32, temperature=0.0) for p in prompts]
        _crank(eng, futs)
        eng._running = False
        counts = {**kernels.launch_counts(),
                  "tree_routes": kernels.by_route(kernels.PAGED_TREE_FORMS)}
        return [f.result(timeout=0).token_ids for f in futs], eng, counts

    spec_kw = dict(speculative=4, spec_width=4, spec_probe_every=1)
    for fmt in ("dense", "int8"):
        pc = params_cpu if fmt == "dense" else quantize_decoder_params(params_cpu, "int8")
        pg = {k: ({n: w.to("cuda") for n, w in v.items()} if isinstance(v, dict) else v.to("cuda"))
              for k, v in pc.items()}
        card, eng, counts = run("cuda", pg, **spec_kw)
        cpu, _, _ = run("cpu", pc, **spec_kw)
        plain, _, _ = run("cuda", pg)
        st = eng.spec_stats()
        verify_steps = eng.spec_ticks_issued * eng.decode_steps
        log(f"  small model {fmt} spec engine (K 4, N 4; {len(eng._spec_graphs)} rung graphs): "
            f"greedy ids card vs CPU {'identical' if card == cpu else 'DIFFER'}, vs the card's "
            f"plain engine {'identical' if card == plain else 'DIFFER'}; drafted "
            f"{st['spec_drafted']}, accepted {st['spec_accepted']}, {eng.spec_ticks_issued} spec "
            f"ticks; paged_tree launches {counts['paged_tree']} (routes {counts['tree_routes']})")
        if card != cpu or card != plain:
            fail(f"small {fmt} spec engine: card {card} vs CPU {cpu} vs plain {plain}")
        if not (st["spec_drafted"] > 0 and st["spec_accepted"] > 0
                and len(eng._spec_graphs) == len(eng._spec_ctl.rungs)):
            fail(f"small {fmt} spec engine did not speculate on its graphs: {st}")
        if counts["paged_tree"] != cfg.num_layers * verify_steps:
            fail(f"small {fmt} spec engine: paged_tree launches {counts['paged_tree']} != "
                 f"{cfg.num_layers} x {verify_steps} verify steps")


def small_fp8(cfg, params_cpu, params_gpu, prompts) -> None:
    """The small f32 model's engine on narrow pools (``kv_cache_dtype``
    "fp8", "fp8_e5m2", "bf16", and "fp8" with ``attn_fp8``) at the default
    loop (graph ticks, a piggybacked chunk): greedy ids on the card equal
    the CPU engine's, every paged launch on the pool's read
    (``kernels.PAGED_FORMS``, the CUDA-core kernels at f32); then a prefix
    wave on an fp8 pool and a spec engine (K 4, N 4) on one, card vs CPU."""
    import torch

    from django_assistant_bot_tpu_torch import kernels
    from django_assistant_bot_tpu_torch.serving import ByteTokenizer, GenerationEngine

    def run(device, params, **kw):
        eng = GenerationEngine(cfg, params, ByteTokenizer(), device=device, max_slots=4,
                               max_seq_len=1024, chunk_size=512, **kw)
        eng._running = True
        kernels.reset_counts()
        futs = [eng.submit(p, max_tokens=16, temperature=0.0) for p in prompts]
        with torch.no_grad():
            _crank(eng, futs)
        eng._running = False
        return ([f.result(timeout=0).token_ids for f in futs], eng,
                kernels.launch_counts()["paged_decode"], dict(kernels.PAGED_FORMS))

    for kv, attn_fp8 in (("fp8", False), ("fp8_e5m2", False), ("bf16", False), ("fp8", True)):
        kw = dict(kv_cache_dtype=kv, attn_fp8=attn_fp8)
        card, eng, paged, forms = run("cuda", params_gpu, **kw)
        cpu, _, _, _ = run("cpu", params_cpu, **kw)
        fmt = {"fp8": "e4m3", "fp8_e5m2": "e5m2", "bf16": "bf16"}[kv]
        form = f"cuda_core:{fmt}/{'in_dot' if attn_fp8 else 'dequant'}"
        dec = eng.decode_path_stats()
        log(f"  small model engine, kv_cache_dtype={kv} attn_fp8={attn_fp8} (pool "
            f"{eng._cache.k.dtype}): greedy ids card vs CPU "
            f"{'identical' if card == cpu else 'DIFFER'}; paged launches {paged}, {form} "
            f"{forms[form]}; {dec['prefill_chunks_piggybacked']} piggybacked chunks")
        if card != cpu:
            fail(f"small fp8 engine ({kv}, attn_fp8 {attn_fp8}): card {card} vs CPU {cpu}")
        if not (paged > 0 and forms[form] == paged and dec["cuda_graph"]
                and dec["prefill_chunks_piggybacked"] > 0 and dec["attn_fp8"] is attn_fp8):
            fail(f"small fp8 engine ({kv}, attn_fp8 {attn_fp8}) left its read: {forms}, {dec}")
    small_prefix_wave(cfg, params_cpu, params_gpu, kv_cache_dtype="fp8")
    gen = torch.Generator().manual_seed(12)
    motif = torch.randint(1, 255, (11,), generator=gen).tolist()
    spec_prompts = [motif * 8, torch.randint(1, 255, (300,), generator=gen).tolist()]
    spec_kw = dict(speculative=4, spec_width=4, spec_probe_every=1, kv_cache_dtype="fp8")
    out = []
    for device, params in (("cuda", params_gpu), ("cpu", params_cpu)):
        eng = GenerationEngine(cfg, params, ByteTokenizer(), device=device, max_slots=4,
                               max_seq_len=1024, chunk_size=512, **spec_kw)
        eng._running = True
        kernels.reset_counts()
        futs = [eng.submit(p, max_tokens=32, temperature=0.0) for p in spec_prompts]
        _crank(eng, futs)
        out.append(([f.result(timeout=0).token_ids for f in futs], eng.spec_stats(),
                    dict(kernels.PAGED_TREE_FORMS)))
    (card, st, forms), (cpu, _, _) = out
    log(f"  small model spec engine (K 4, N 4) on an fp8 pool: greedy ids card vs CPU "
        f"{'identical' if card == cpu else 'DIFFER'}; drafted {st['spec_drafted']}, accepted "
        f"{st['spec_accepted']}; tree launches cuda_core:e4m3/dequant "
        f"{forms['cuda_core:e4m3/dequant']}")
    if card != cpu or not st["spec_drafted"] or not forms["cuda_core:e4m3/dequant"]:
        fail(f"small fp8 spec engine: card {card} vs CPU {cpu}, {st}, {forms}")


def sampling_steps(eng) -> int:
    """Sampling steps the engine has run: a decode step each, and an
    activation (a wave group's or a final chunk's first tokens) each."""
    return eng.steps + eng.activations


def small_int4_g8() -> int:
    """``quantize="int4", quant_group_size=8`` (a group no tensor-core route
    takes) on the tiny decoder: the registry builds and quantizes it on the
    CPU; the same weights on the card behind the registry serve ``/dialog/``
    and give the CPU port's greedy ids (the generic route)."""
    import aiohttp
    import torch
    from aiohttp import web

    from django_assistant_bot_tpu_torch import kernels
    from django_assistant_bot_tpu_torch.serving import ByteTokenizer, GenerationEngine
    from django_assistant_bot_tpu_torch.serving.registry import ModelRegistry, ModelSpec
    from django_assistant_bot_tpu_torch.serving.server import create_app

    prompts = [torch.randint(1, 255, (n,), generator=torch.Generator().manual_seed(n)).tolist()
               for n in (20, 90, 200)]
    name = "tiny-int4-g8"
    knobs = dict(tiny=True, quantize="int4", quant_group_size=8, max_slots=4)
    cpu_registry = ModelRegistry()
    cpu = cpu_registry.load(ModelSpec(name=name, device="cpu", **knobs))
    want = [f.result(timeout=300).token_ids
            for f in [cpu.submit(p, max_tokens=16, temperature=0.0) for p in prompts]]
    cpu_registry.stop()
    spec = ModelSpec(name=name, device="cuda", **knobs)
    params = {k: ({n: w.to("cuda") for n, w in v.items()} if isinstance(v, dict) else v.to("cuda"))
              for k, v in cpu.params.items()}
    registry = ModelRegistry()
    kernels.reset_counts()
    eng = registry.load(spec, engine=GenerationEngine(cpu.cfg, params, ByteTokenizer(),
                                                      device="cuda", **spec.engine_kwargs()))
    got = [f.result(timeout=300).token_ids
           for f in [eng.submit(p, max_tokens=16, temperature=0.0) for p in prompts]]
    generic = kernels.QGEMM_ROUTES["generic"]
    port = _free_port()

    async def one():
        runner = web.AppRunner(create_app(registry))
        await runner.setup()
        await web.TCPSite(runner, "127.0.0.1", port).start()
        try:
            async with aiohttp.ClientSession() as session:
                return await _post(session, port, name, _chat(60, 5))
        finally:
            await runner.cleanup()  # stops the registry's engine

    status, body, _ = asyncio.run(one())
    log(f"  tiny int4 g=8 decoder (group {cpu.params['layers']['wq'].group_size}): greedy ids, "
        f"card ({generic} generic qgemm launches) vs CPU: "
        f"{'identical' if got == want else 'DIFFER'}; /dialog/ on the card {status}")
    if generic <= 0 or eng.weight_bits != 4:
        fail(f"the int4 g=8 tiny decoder ran no generic qgemm launch ({generic})")
    if status != 200 or "result" not in body.get("response", {}):
        fail(f"/dialog/ on the int4 g=8 tiny decoder returned {status}: {body}")
    if got != want:
        fail(f"int4 g=8 greedy ids differ: card {got}, CPU {want}")
    return generic


def small_json(cfg, params_cpu, params_gpu, prompts) -> None:
    """JSON mode on the small f32 model: greedy JSON requests (and a plain
    one beside them) on the card (the JSON tick's graph captured at the
    first JSON request; the fused sampler with the FSM mask) give the CPU
    port's ids; the sampler's launches equal the sampling steps."""
    import torch

    from django_assistant_bot_tpu_torch import kernels
    from django_assistant_bot_tpu_torch.serving import ByteTokenizer, GenerationEngine

    def run(device, params):
        eng = GenerationEngine(cfg, params, ByteTokenizer(), device=device,
                               max_slots=4, max_seq_len=1024, chunk_size=512)
        eng._running = True
        kernels.reset_counts()
        steps0 = sampling_steps(eng)
        futs = [eng.submit(p, max_tokens=40, temperature=0.0, json_format=i < 3)
                for i, p in enumerate(prompts)]
        _crank(eng, futs)
        eng._running = False
        return ([f.result(timeout=0).token_ids for f in futs], eng,
                sampling_steps(eng) - steps0, kernels.launch_counts()["sample"])

    ids_gpu, eng, steps, launches = run("cuda", params_gpu)
    ids_cpu, _, _, _ = run("cpu", params_cpu)
    st = eng.tick_stats()
    log(f"  small model JSON engine greedy ids, card (JSON graph captured at the first JSON "
        f"request: {eng._json_graph is not None}; {st['json_downgraded_ticks']} single-step "
        f"JSON ticks) vs CPU: {'identical' if ids_gpu == ids_cpu else 'DIFFER'}; sampler "
        f"launches {launches} for {steps} sampling steps")
    if eng._json_graph is None or st["json_downgraded_ticks"] <= 0:
        fail(f"the JSON engine on the card did not run its JSON tick graph: {st}")
    if launches != steps:
        fail(f"sampler launches {launches} != sampling steps {steps}")
    if ids_gpu != ids_cpu:
        fail(f"JSON greedy ids differ: card {ids_gpu}, CPU {ids_cpu}")


def small_tied(cfg, params_cpu, prompts) -> None:
    """The small f32 model with a tied int8 embedding table as its head
    (``quantize_tensor`` of the table, per-E scales; int8 projections): the
    engine's greedy ids on the card (the qgemm kernel's K-contiguous form
    for the head, in the graph ticks and the prefills) equal the CPU's (the
    plain twin), and the head's launches ran."""
    import dataclasses

    import torch

    from django_assistant_bot_tpu_torch import kernels
    from django_assistant_bot_tpu_torch.ops.quant import quantize_decoder_params, quantize_tensor
    from django_assistant_bot_tpu_torch.serving import ByteTokenizer, GenerationEngine

    tcfg = dataclasses.replace(cfg, tie_embeddings=True)
    qcpu = quantize_decoder_params({k: v for k, v in params_cpu.items() if k != "lm_head"})
    qcpu["tok_embed"] = quantize_tensor(params_cpu["tok_embed"])
    qgpu = {k: ({n: w.to("cuda") for n, w in v.items()} if isinstance(v, dict) else v.to("cuda"))
            for k, v in qcpu.items()}

    def run(device, params):
        eng = GenerationEngine(tcfg, params, ByteTokenizer(), device=device,
                               max_slots=4, max_seq_len=1024, chunk_size=512)
        eng._running = True
        futs = [eng.submit(p, max_tokens=16, temperature=0.0) for p in prompts]
        with torch.no_grad():
            for _ in range(1000):
                if all(f.done() for f in futs):
                    break
                eng._loop_iteration()
        eng._running = False
        return [f.result(timeout=0).token_ids for f in futs]

    heads = [0]
    qgemm_tied = kernels.qgemm_tied

    def counted(*a, **kw):
        heads[0] += 1
        return qgemm_tied(*a, **kw)

    kernels.reset_counts()
    kernels.qgemm_tied = counted
    try:
        ids_gpu = run("cuda", qgpu)
    finally:
        kernels.qgemm_tied = qgemm_tied
    head = heads[0]
    ids_cpu = run("cpu", qcpu)
    log(f"  small tied int8 model engine greedy ids, card (the head on the qgemm kernel's "
        f"K-contiguous form, {head} head calls; {kernels.launch_counts()['qgemm']} qgemm "
        f"launches, captured ones counted at each replay) vs CPU: "
        f"{'identical' if ids_gpu == ids_cpu else 'DIFFER'}")
    if head <= 0:
        fail("the tied int8 head launched no qgemm kernel on the card")
    if ids_gpu != ids_cpu:
        fail(f"tied int8 greedy ids differ: card {ids_gpu}, CPU {ids_cpu}")


def small_quantized(cfg, params_cpu, fmt, ids, lengths, prompts, run) -> None:
    """The small f32 model quantized by ``quantize_decoder_params`` (int4 at
    the default group of 64): prefill logits on the card (the qgemm kernel)
    against the CPU (the plain twin) within 1e-3, and the engine's greedy
    ids identical, card (graph, 8-step ticks, piggyback) against the CPU and
    at ``decode_steps=1``."""
    import torch

    from django_assistant_bot_tpu_torch import kernels
    from django_assistant_bot_tpu_torch.models import llama
    from django_assistant_bot_tpu_torch.ops.quant import quantize_decoder_params

    qcpu = quantize_decoder_params(params_cpu, fmt)
    qgpu = {k: ({n: w.to("cuda") for n, w in v.items()} if isinstance(v, dict) else v.to("cuda"))
            for k, v in qcpu.items()}
    kernels.reset_counts()
    lc, _, _ = llama.prefill(qcpu, cfg, ids, lengths)
    lg, _, _ = llama.prefill(qgpu, cfg, ids.cuda(), lengths.cuda())
    err = (lg.cpu() - lc).abs().max().item()
    launches = kernels.launch_counts()["qgemm"]
    log(f"  small model {fmt} prefill (qgemm kernel vs plain): logits max_abs_err {err:.3e}; "
        f"{launches} qgemm launches")
    if not (torch.isfinite(lg).all() and err <= 1e-3 and launches == 7 * cfg.num_layers):
        fail(f"small-model {fmt} prefill on the card: err {err}, qgemm launches {launches}")
    ids_gpu, dec = run("cuda", qgpu)
    ids_cpu, _ = run("cpu", qcpu)
    ids_one, dec_one = run("cuda", qgpu, decode_steps=1)
    log(f"  small model {fmt} engine greedy ids, card (CUDA graph, {dec['decode_steps']}-step "
        f"ticks, {dec['prefill_chunks_piggybacked']} piggybacked chunk, weight_bits "
        f"{dec['weight_bits']}) vs CPU: {'identical' if ids_gpu == ids_cpu else 'DIFFER'}; "
        f"card at decode_steps=1: {'identical' if ids_one == ids_cpu else 'DIFFER'}")
    if not (dec["cuda_graph"] and dec["prefill_chunks_piggybacked"] > 0
            and dec["weight_bits"] == (8 if fmt == "int8" else 4)):
        fail(f"the {fmt} card engine did not run the graph / piggyback: {dec}")
    if ids_gpu != ids_cpu or ids_one != ids_cpu:
        fail(f"{fmt} greedy ids differ: card {ids_gpu}, card steps=1 {ids_one}, CPU {ids_cpu}")


def _crank(eng, futs, limit=2000):
    import torch

    with torch.no_grad():
        for _ in range(limit):
            if all(f.done() for f in futs):
                return
            eng._loop_iteration()
    fail("requests did not finish within the crank budget")


def small_prefix_wave(cfg, params_cpu, params_gpu, **pool) -> None:
    """Prefix sharing on the small f32 model: a 200-token head (page 64:
    three full pages and an 8-token boundary page) registered by a first
    chat, then a wave of three hits: two short questions (one suffix prefill
    wave, a copy-on-write boundary page each) and one whose 600-token
    remainder is longer than a chunk, so it continues as chunks from the
    head's length (the first piggybacked on the live batch).  Greedy ids on
    the card (graph ticks) equal the CPU's and the card's with the prefix
    cache off; hit, miss and COW counters exact.  ``pool`` (an engine's
    ``kv_cache_dtype``) runs the wave on a narrow pool, where a hit reads
    the head from fp8 pages and a cold prefill does not, so only card and
    CPU are held equal."""
    import torch

    from django_assistant_bot_tpu_torch.serving import ByteTokenizer, GenerationEngine

    g = torch.Generator().manual_seed(6)
    head = torch.randint(1, 255, (200,), generator=g).tolist()
    first = head + torch.randint(1, 255, (30,), generator=g).tolist()
    wave = [head + torch.randint(1, 255, (n,), generator=g).tolist() for n in (20, 90, 600)]

    def run(device, params, prefix_cache):
        eng = GenerationEngine(cfg, params, ByteTokenizer(), device=device, max_slots=4,
                               max_seq_len=1024, chunk_size=512, kv_page_size=64,
                               prefix_cache_size=prefix_cache, prefix_min_tokens=32, **pool)
        eng._running = True
        f0 = eng.submit(first, max_tokens=16, temperature=0.0, prefix_len=len(head))
        _crank(eng, [f0])
        futs = [eng.submit(p, max_tokens=16, temperature=0.0, prefix_len=len(head)) for p in wave]
        _crank(eng, [f0] + futs)
        return ([f.result(timeout=0).token_ids for f in [f0] + futs], eng.kv_stats(),
                eng.decode_path_stats())

    card, kv, dec = run("cuda", params_gpu, 8)
    cpu, kv_cpu, _ = run("cpu", params_cpu, 8)
    cold, kv_cold, _ = run("cuda", params_gpu, 0)
    counters = {k: kv[k] for k in ("prefix_hits", "prefix_misses", "kv_cow_copies",
                                   "kv_shared_pages", "kv_pages_used")}
    log(f"  small model prefix wave (200-token head, page 64{', ' if pool else ''}"
        f"{', '.join(f'{k}={v}' for k, v in pool.items())}): greedy ids card vs CPU "
        f"{'identical' if card == cpu else 'DIFFER'}, vs the card without the prefix cache "
        f"{'identical' if card == cold else 'DIFFER'}; {counters}; "
        f"{dec['prefill_chunks_piggybacked']} chunk piggybacked from the hit")
    want = {"prefix_hits": 3, "prefix_misses": 1, "kv_cow_copies": 3, "kv_shared_pages": 4,
            "kv_pages_used": 4}
    if counters != want or kv_cpu["prefix_hits"] != 3 or kv_cold["prefix_hits"] != 0:
        fail(f"prefix counters: card {counters} (want {want}), CPU hits {kv_cpu['prefix_hits']}")
    if dec["prefill_chunks_piggybacked"] < 1:
        fail("the chunked hit did not piggyback on the card")
    if card != cpu or (card != cold and not pool):
        fail(f"prefix wave greedy ids differ: card {card}, CPU {cpu}, cache off {cold}")


def small_fault_restart(cfg, params_gpu, prompt) -> None:
    """Crash-only supervision on the card: ``tick_raise`` fires on the first
    tick (host side, before the replay), the engine restarts in place (no
    re-capture) and resubmits the token-less request, which completes with
    the unfaulted run's ids."""
    from django_assistant_bot_tpu_torch.serving import ByteTokenizer, GenerationEngine
    from django_assistant_bot_tpu_torch.serving.faults import FaultInjector

    def run(faults):
        eng = GenerationEngine(cfg, params_gpu, ByteTokenizer(), device="cuda", max_slots=4,
                               max_seq_len=1024, chunk_size=512, faults=faults)
        graph = eng._graph
        eng.start()
        try:
            ids = eng.submit(prompt, max_tokens=16, temperature=0.0).result(timeout=300).token_ids
        finally:
            eng.stop()
        return ids, eng.supervision_stats(), eng._graph is graph

    clean, _, _ = run(None)
    ids, sup, same_graph = run(FaultInjector.from_spec({"tick_raise": {"fire_on": [1]}}))
    log(f"  small model tick_raise on the first tick: ids {'identical to' if ids == clean else 'DIFFER from'} "
        f"the unfaulted run; engine_restarts {sup['engine_restarts']}, resubmitted "
        f"{sup['restarted_requests_resubmitted']}, graph kept {same_graph}")
    if not (ids == clean and sup["engine_restarts"] == 1
            and sup["restarted_requests_resubmitted"] == 1 and same_graph):
        fail(f"restart on the card: ids {ids} vs {clean}, {sup}")


def small_encoder() -> None:
    """The tiny f32 encoder on the card against the same encoder on the CPU:
    ``encode`` on a padded batch within 1e-5 (normalised and not); then an
    ``EmbeddingEngine`` on the card coalescing three concurrent calls into
    one batch, its embeddings within 1e-5 of the CPU engine's."""
    import torch

    from django_assistant_bot_tpu_torch.models import EncoderConfig, encoder
    from django_assistant_bot_tpu_torch.serving import ByteTokenizer, EmbeddingEngine

    cfg = EncoderConfig.tiny()
    params_cpu = encoder.init(cfg, torch.Generator().manual_seed(5), "cpu")
    params_gpu = {k: ({n: w.cuda() for n, w in v.items()} if isinstance(v, dict) else v.cuda())
                  for k, v in params_cpu.items()}
    ids = torch.randint(1, 500, (4, 40), generator=torch.Generator().manual_seed(6))
    mask = torch.zeros((4, 40), dtype=torch.int32)
    for b, n in enumerate((40, 23, 7, 1)):
        mask[b, :n] = 1
    for norm in (False, True):
        ref = encoder.encode(params_cpu, cfg, ids, mask, normalize=norm)
        out = encoder.encode(params_gpu, cfg, ids.cuda(), mask.cuda(), normalize=norm)
        err = (out.cpu() - ref).abs().max().item()
        log(f"  tiny encoder encode normalize={norm}, card vs CPU: max_abs_err {err:.3e} "
            f"(bound 1e-05)")
        if not (torch.isfinite(out).all() and out.shape == (4, cfg.hidden_size) and err <= 1e-5):
            fail(f"tiny encoder on the card disagrees with the CPU: {err}")

    texts = [["alpha", "beta"], ["gamma"], ["delta " * 20, "epsilon", "zeta " * 40]]
    eng = EmbeddingEngine(cfg, params_gpu, ByteTokenizer(), max_batch=8, device="cuda")
    batches = []
    embed_batch = eng._embed_batch
    eng._embed_batch = lambda t: (batches.append(len(t)), embed_batch(t))[1]
    eng._running = True  # no loop thread yet: the three calls queue up together

    async def go():
        futs = [asyncio.ensure_future(eng.embed(t)) for t in texts]
        await asyncio.sleep(0.05)
        eng._running = False
        eng.start()
        return await asyncio.gather(*futs)

    try:
        got = [v for r in asyncio.run(go()) for v in r]
    finally:
        eng.stop()
    cpu = EmbeddingEngine(cfg, params_cpu, ByteTokenizer(), max_batch=8, device="cpu")
    want = cpu.embed_sync([t for ts in texts for t in ts])
    err = max(abs(a - b) for u, v in zip(got, want) for a, b in zip(u, v))
    log(f"  tiny EmbeddingEngine on the card: three concurrent calls in batches {batches}, "
        f"against the CPU engine max_abs_err {err:.3e}")
    if batches != [6] or err > 1e-5:
        fail(f"tiny EmbeddingEngine: batches {batches}, err {err}")


def small_moe() -> dict:
    """``ModelSpec(tiny=True, num_experts=4)`` in f32 (E 64, 4 experts, top
    2) on the card (the MoE kernels, the CUDA graphs) against the same
    weights on the CPU (the twins): prefill logits within 1e-4; greedy ids
    at the default loop (8-step ticks replayed as a graph, a piggybacked
    chunk) equal; then two greedy ``/dialog/`` requests through a
    ``ModelRegistry`` behind ``create_app`` on each side, equal answers.
    Returns the card's MoE launches over the engine run."""
    import torch
    from aiohttp.test_utils import TestClient, TestServer

    from django_assistant_bot_tpu_torch import kernels
    from django_assistant_bot_tpu_torch.models import DecoderConfig, llama
    from django_assistant_bot_tpu_torch.serving import ByteTokenizer, GenerationEngine
    from django_assistant_bot_tpu_torch.serving.registry import ModelRegistry, ModelSpec
    from django_assistant_bot_tpu_torch.serving.server import create_app

    spec = {"kind": "decoder", "tiny": True, "num_experts": 4, "dtype": "float32",
            "max_slots": 4, "max_seq_len": 256, "chunk_size": 64}
    cfg = DecoderConfig.tiny(num_experts=4)
    params_cpu = llama.init(cfg, torch.Generator().manual_seed(8), "cpu")
    params_gpu = {k: ({n: w.cuda() for n, w in v.items()} if isinstance(v, dict) else v.cuda())
                  for k, v in params_cpu.items()}
    ids = torch.randint(1, 255, (2, 64), generator=torch.Generator().manual_seed(9), dtype=torch.int32)
    lengths = torch.tensor([64, 30], dtype=torch.int32)
    lc, _, _ = llama.prefill(params_cpu, cfg, ids, lengths)
    lg, _, _ = llama.prefill(params_gpu, cfg, ids.cuda(), lengths.cuda())
    err = (lg.cpu() - lc).abs().max().item()
    log(f"  tiny MoE (4 experts, top 2) prefill, card vs CPU: logits max_abs_err {err:.3e} "
        f"(bound 1e-04)")
    if not (bool(torch.isfinite(lg).all()) and err <= 1e-4):
        fail(f"tiny MoE prefill on the card disagrees with the CPU: {err}")
    prompts = [torch.randint(1, 255, (n,), generator=torch.Generator().manual_seed(n)).tolist()
               for n in (9, 40, 150, 70)]

    def engine(device, params):
        s = ModelSpec.from_dict("tiny-moe", {**spec, "device": device})
        # FIFO admission on both sides: the waves do not depend on the clock
        return s, GenerationEngine(cfg, params, ByteTokenizer(), device=device,
                                   **{**s.engine_kwargs(), "scheduler": None})

    def crank(eng):
        eng._running = True
        futs = [eng.submit(p, max_tokens=16, temperature=0.0) for p in prompts]
        with torch.no_grad():
            for _ in range(1000):
                if all(f.done() for f in futs):
                    break
                eng._loop_iteration()
        eng._running = False
        return [f.result(timeout=0).token_ids for f in futs], eng.decode_path_stats()

    _, card_eng = engine("cuda", params_gpu)
    kernels.reset_counts()
    ids_gpu, dec = crank(card_eng)
    torch.cuda.synchronize()
    counts = {k: v for k, v in kernels.launch_counts().items() if k.startswith("moe")}
    routes = kernels.by_route(kernels.MOE_GEMM_FORMS)
    ids_cpu, _ = crank(engine("cpu", params_cpu)[1])
    log(f"  tiny MoE engine greedy ids at the default loop, card (CUDA graph, "
        f"{dec['decode_steps']}-step ticks, {dec['prefill_chunks_piggybacked']} piggybacked "
        f"chunks) vs CPU (eager): {'identical' if ids_gpu == ids_cpu else 'DIFFER'}; MoE "
        f"launches {counts}, grouped GEMM routes {routes}")
    if not (dec["cuda_graph"] and dec["decode_steps"] == 8 and dec["prefill_chunks_piggybacked"]):
        fail(f"the tiny MoE card engine did not run the graph / fused ticks / piggyback: {dec}")
    if ids_gpu != ids_cpu:
        fail(f"tiny MoE greedy ids differ: card {ids_gpu} vs CPU {ids_cpu}")
    if not (counts["moe_route"] and counts["moe_gemm"] == 2 * counts["moe_route"]
            == 2 * counts["moe_combine"] and routes["cuda_core"] == counts["moe_gemm"]):
        fail(f"tiny MoE: kernel launches {counts}, routes {routes}")

    chats = [[{"role": "user", "content": "route me " * 3}],
             [{"role": "user", "content": "experts " * 30}]]
    answers = {}
    for device, params in (("cuda", params_gpu), ("cpu", params_cpu)):
        s, eng = engine(device, params)
        registry = ModelRegistry()
        registry.load(s, engine=eng)
        loop = asyncio.new_event_loop()
        client = TestClient(TestServer(create_app(registry)), loop=loop)

        async def go():
            out = []
            for msgs in chats:
                resp = await client.post("/dialog/", json={
                    "model": "tiny-moe", "messages": msgs, "max_tokens": 12, "temperature": 0.0})
                if resp.status != 200:
                    fail(f"tiny MoE /dialog/ on {device} returned {resp.status}")
                out.append((await resp.json())["response"]["result"])
            return out

        try:
            loop.run_until_complete(client.start_server())
            answers[device] = loop.run_until_complete(go())
        finally:
            loop.run_until_complete(client.close())
            registry.stop()
            loop.close()
    log(f"  tiny MoE over /dialog/: card and CPU answers "
        f"{'equal' if answers['cuda'] == answers['cpu'] else 'DIFFER'} "
        f"({[len(a) for a in answers['cuda']]} chars)")
    if answers["cuda"] != answers["cpu"]:
        fail(f"tiny MoE /dialog/ answers differ: {answers}")
    return counts


# --------------------------------------------------------------------- phase 4
def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _chat(n_chars: int, seed: int) -> list:
    import random

    rnd = random.Random(seed)
    words = ["context", "deploy", "scaling", "answer", "question", "document", "summary", "the"]
    text = ""
    while len(text) < n_chars:
        text += rnd.choice(words) + " "
    return [{"role": "user", "content": text[:n_chars]}]


def _rag_chats(tok, head_tokens: int, questions) -> list:
    """Chats that share one two-message head (a system prompt and a packed
    context, ``head_tokens`` tokens as the chat split counts them) and end in
    a question of the given sizes in tokens."""
    from django_assistant_bot_tpu_torch.serving import encode_chat_split

    system = {"role": "system", "content": "You answer from the context below; cite it."}
    probe = [system, {"role": "user", "content": ""}, {"role": "user", "content": "?"}]
    base = encode_chat_split(tok, probe)[1]
    context = {"role": "user", "content": _chat(head_tokens - base, 7)[0]["content"]}
    chats = []
    for i, n in enumerate(questions):
        q = _chat(n, 100 + i)[0]["content"]
        chats.append([system, context, {"role": "user", "content": q}])
    return chats


async def _post(session, port, name, msgs, max_tokens=32):
    t = time.perf_counter()
    async with session.post(
        f"http://127.0.0.1:{port}/dialog/",
        json={"model": name, "messages": msgs, "max_tokens": max_tokens, "temperature": 0.0},
    ) as resp:
        body = await resp.json()
        return resp.status, body, time.perf_counter() - t


def _check_dialogs(tok, key_msgs, results, max_tokens=32) -> tuple:
    """Wire and usage checks of a run's /dialog/ results (each asked for
    ``max_tokens``); returns (TTFTs, per-request decode rates, completion
    tokens)."""
    ttfts, rates, completion = [], [], 0
    for (key, msgs), (status, body, _) in zip(key_msgs, results):
        if status != 200:
            fail(f"/dialog/ ({key}) returned {status}: {body}")
        r = body.get("response", {})
        if set(r) < {"result", "usage", "length_limited"} or "request_id" not in body:
            fail(f"/dialog/ ({key}) wire fields missing: {body}")
        u = r["usage"]
        want_prompt = len(tok.encode_chat(msgs))
        if not (u["prompt_tokens"] == want_prompt and 1 <= u["completion_tokens"] <= max_tokens
                and u["total_tokens"] == u["prompt_tokens"] + u["completion_tokens"]
                and isinstance(r["result"], str)):
            fail(f"/dialog/ ({key}) usage wrong (prompt should be {want_prompt}): {u}")
        completion += u["completion_tokens"]
        ttfts.append(u["ttft_s"])
        if u["completion_tokens"] > 1 and u["latency_s"] > u["ttft_s"]:
            rates.append((u["completion_tokens"] - 1) / (u["latency_s"] - u["ttft_s"]))
        log(f"  /dialog/ {key}: prompt {u['prompt_tokens']} tok, completion "
            f"{u['completion_tokens']} tok, ttft {u['ttft_s']:.4f} s, latency "
            f"{u['latency_s']:.4f} s, length_limited {r['length_limited']}")
    return ttfts, rates, completion


def four_requests(tok) -> dict:
    """Phase 4's four chats, by prompt size in tokens: 2 in the 512 bucket
    (flash kernel), 1 past chunk_size (chunked prefill), 1 short (plain
    attention, 128 bucket)."""
    sizes = {"a": 340, "b": 470, "c": 900, "d": 90}
    overhead = len(tok.encode_chat(_chat(0, 0)))
    return {k: _chat(n - overhead, i) for i, (k, n) in enumerate(sizes.items())}


def _build_engine(cfg, params, spec):
    import torch

    from django_assistant_bot_tpu_torch.serving import ByteTokenizer, GenerationEngine

    t1 = time.perf_counter()
    engine = GenerationEngine(cfg, params, ByteTokenizer(), device="cuda", **spec.engine_kwargs())
    torch.cuda.synchronize()
    dec = engine.decode_path_stats()
    if not (dec["cuda_graph"] and dec["decode_steps"] == 8 and dec["prefill_piggyback"]
            and engine._piggyback_graph is not None):
        fail(f"the main-path engine is not at the default loop: {dec}")
    return engine, time.perf_counter() - t1


def main_path(card: str) -> dict:
    """The four concurrent requests (launch counts reset just before and
    read just after), then the RAG wave on the same engine (its own counts)
    and the decode breakdown; then the four requests again on an engine with
    ``obs`` off; last, the RAG hits on an engine with prefix sharing off,
    held to the hits' own first-step logits."""
    import torch

    from django_assistant_bot_tpu_torch.models import DecoderConfig, llama
    from django_assistant_bot_tpu_torch.serving import ByteTokenizer
    from django_assistant_bot_tpu_torch.serving.registry import ModelSpec

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    cfg = DecoderConfig.llama3_8b()  # all 32 layers, full width, bf16
    params = llama.init(cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    tok = ByteTokenizer()
    name = "llama3-8b-random"
    # the JAX ModelSpec defaults: the default loop, prefix sharing, obs and
    # supervision on
    spec = ModelSpec(name=name, device="cuda", max_slots=8, max_seq_len=4096)
    engine, build_s = _build_engine(cfg, params, spec)
    resident_gib = torch.cuda.memory_allocated() / 2**30  # weights + page pool
    n_params = sum(w.numel() for w in params["layers"].values()) + params["tok_embed"].numel() \
        + params["lm_head"].numel() + params["final_norm"].numel()
    log(f"  Llama-3-8B geometry, {cfg.num_layers} layers, {n_params / 1e9:.2f} B params bf16, "
        f"KV pool {engine._kv_pool.n_pages} pages of {engine.kv_page_size}: built in "
        f"{time.perf_counter() - t0:.1f} s, of which the engine (pool, warm-up tick and "
        f"capture of the {engine.decode_steps}-step tick) {build_s:.2f} s; "
        f"graph pool {engine.graph_pool_bytes / 2**20:.1f} MiB; decode path "
        f"{engine.decode_path_stats()}; scheduler max_queue {engine.scheduler.cfg.max_queue}; "
        f"prefix cache {engine.prefix_cache_size} entries; obs {engine.obs is not None}")
    messages = four_requests(tok)
    # the RAG wave: eight chats share a ~1,500-token two-message head (two
    # full 512-token pages and a boundary page); the first misses and
    # registers it; the second (a question the miss's size) hits alone, on an
    # idle engine; then six hits together: five short questions (suffix
    # prefills, a copy-on-write boundary page each) and one of ~700 tokens,
    # which continues as chunks from the head's length
    head_tokens = 1500
    rag = _rag_chats(tok, head_tokens, [100, 100, 60, 90, 120, 160, 200, 700])
    hit_logits = record_first_logits(engine)

    def serve(eng, groups):
        return _serve(spec, eng, groups)

    # the four requests six times (the first counted, all six read, as in
    # phase 8), then the RAG wave
    runs = serve(engine, [list(messages.values())] * 6 + [rag[:1], rag[1:2], rag[2:]])
    reads, rag_runs = runs[:6], runs[6:]
    main = reads[0]
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    ttfts, rates, completion = _check_dialogs(tok, list(messages.items()), main["results"])
    wall, counts, routes, steps = main["wall"], main["counts"], main["routes"], main["steps"]
    log(f"  main path on {card}: {len(ttfts)} concurrent requests in {wall:.3f} s; "
        f"TTFT mean {sum(ttfts) / len(ttfts):.4f} s max {max(ttfts):.4f} s; "
        f"decode {sum(rates) / max(1, len(rates)):.2f} tok/s per request, "
        f"{completion / wall:.2f} completion tok/s overall; peak memory {peak_gib:.2f} GiB "
        f"({resident_gib:.2f} GiB resident weights and page pool, "
        f"{peak_gib - resident_gib:.2f} GiB above it at the peak)")
    log(f"  launches during the run: {counts}; paged decode by route: {routes}; "
        f"{steps} decode steps in {steps // engine.decode_steps} ticks")
    for k in ("flash_prefill", "paged_decode"):  # the KNN runs on phase 6's path
        if counts[k] <= 0:
            fail(f"kernel {k} was not launched on the main path")
    if routes != {"mma": counts["paged_decode"], "cuda_core": 0}:
        fail(f"paged decode on the main path left the tensor-core kernel: {routes}")
    if counts["paged_decode"] != cfg.num_layers * steps:
        fail(f"replay-counted paged launches {counts['paged_decode']} != {cfg.num_layers} x "
             f"{steps} decode steps")
    log(f"  sampler launches {counts['sample']} for {main['samples']} sampling steps "
        f"({steps} decode steps and {main['samples'] - steps} activations)")
    if counts["sample"] != main["samples"]:
        fail(f"sampler launches {counts['sample']} != {main['samples']} sampling steps")
    check_prefill_launches("phase 4, the four requests", counts["paged_prefill"],
                           main["suffix_forwards"] + main["piggybacked"], cfg.num_layers,
                           main["prefill_forms"], "mma:native")
    all_ttfts, all_rates = [], []
    for run in reads:
        t, r, _ = _check_dialogs(tok, list(messages.items()), run["results"])
        all_ttfts += t
        all_rates += r
    log(f"  bf16 readings over {len(reads)} runs of the four requests [{card}]: TTFT "
        f"{_stat(all_ttfts)}; decode {_stat(all_rates, 'tok/s')} per request; run wall "
        f"{_stat([r['wall'] for r in reads])}")
    rag_wave_report(cfg, engine, tok, rag, *rag_runs)
    log(f"  tick_stats: {json.dumps(engine.tick_stats())}")
    obs_on = _tick_reading(main, rates)
    PHASE4.update(ttfts=all_ttfts, rates=all_rates, pool_bytes=pool_bytes(engine),
                  breakdown=decode_breakdown(cfg, params, engine, chunk_starts=(0, 3584)))
    PHASE4["chunk_split"] = engine_chunk_split(cfg, engine, (0, 3584))

    # the obs A/B: the same four requests on an engine with the obs plane off
    spec_off = ModelSpec(name=name, device="cuda", max_slots=8, max_seq_len=4096, obs=False)
    other, _ = _build_engine(cfg, params, spec_off)
    (off,) = serve(other, [list(messages.values())])
    _, rates_off, _ = _check_dialogs(tok, list(messages.items()), off["results"])
    obs_off = _tick_reading(off, rates_off)
    log(f"  obs on vs off, the four requests (each after its engine's warm-up request): "
        f"on {obs_on}, off {obs_off}")
    del other
    torch.cuda.empty_cache()

    # the hits again, each alone, on an engine with prefix sharing off: cold
    # chunked prefills of the same prompts
    spec_cold = ModelSpec(name=name, device="cuda", max_slots=8, max_seq_len=4096,
                          prefix_cache=0)
    other, _ = _build_engine(cfg, params, spec_cold)
    cold_logits = record_first_logits(other)
    cold_runs = serve(other, [[m] for m in rag[1:]])
    if other.kv_stats()["prefix_hits"] != 0:
        fail(f"the cold engine hit its prefix cache: {other.kv_stats()}")
    hit_vs_cold(cfg, tok, rag[1:], hit_logits, cold_logits, rag_runs[1:], cold_runs)
    del other
    torch.cuda.empty_cache()
    # the first engine serves phase 6: its own admission path again (the
    # logit recorder taken off), and rebuilt in place after the decode
    # breakdown wrote its buffers (the rebuild of a crash-only restart)
    del engine._activate_batch
    engine.reset()
    return counts, spec, engine


def _serve(spec, eng, groups) -> list:
    """Serve ``groups`` of chats over /dialog/ on ``eng`` behind a registry
    of ``spec`` (each group concurrently, after the previous one finished,
    after one warm-up request), launch counts reset before each group and
    read after it; the server stops the engine at the end."""
    import aiohttp
    import torch
    from aiohttp import web

    from django_assistant_bot_tpu_torch import kernels
    from django_assistant_bot_tpu_torch.serving.registry import ModelRegistry
    from django_assistant_bot_tpu_torch.serving.server import create_app

    name = spec.name
    registry = ModelRegistry()
    registry.load(spec, engine=eng)
    port = _free_port()

    async def drive():
        runner = web.AppRunner(create_app(registry))
        await runner.setup()
        await web.TCPSite(runner, "127.0.0.1", port).start()
        try:
            async with aiohttp.ClientSession() as session:
                # warm-up: first CUDA/cuBLAS use, outside the counted runs
                st, body, _ = await _post(session, port, name, _chat(300, 99))
                if st != 200:
                    fail(f"warm-up /dialog/ returned {st}: {body}")
                out = []
                for group in groups:
                    torch.cuda.synchronize()
                    kernels.reset_counts()
                    steps0, kv0, tick0 = eng.steps, eng.kv_stats(), _tick_counters(eng)
                    samp0 = sampling_steps(eng)
                    fwd0, pig0 = suffix[0], eng._prefill_chunks_piggybacked
                    t = time.perf_counter()
                    res = await asyncio.gather(*(_post(session, port, name, m) for m in group))
                    wall = time.perf_counter() - t
                    out.append(dict(results=res, wall=wall, counts=kernels.launch_counts(),
                                    routes=kernels.by_route(kernels.PAGED_FORMS),
                                    forms=dict(kernels.PAGED_FORMS),
                                    chunked_forms=dict(kernels.CHUNKED_FORMS),
                                    tree_forms=dict(kernels.PAGED_TREE_FORMS),
                                    prefill_forms=dict(kernels.PAGED_PREFILL_FORMS),
                                    suffix_forwards=suffix[0] - fwd0,
                                    piggybacked=eng._prefill_chunks_piggybacked - pig0,
                                    samples=sampling_steps(eng) - samp0,
                                    steps=eng.steps - steps0, kv0=kv0, kv1=eng.kv_stats(),
                                    ticks=[b - a for a, b in zip(tick0, _tick_counters(eng))]))
                return out
        finally:
            await runner.cleanup()  # stops the registry's engines

    with counting_suffix_forwards() as suffix:
        return asyncio.run(drive())


@contextlib.contextmanager
def counting_suffix_forwards():
    """Count the eager ``llama.prefill_suffix_paged`` calls (a wave of
    prefix suffixes, or an eager chunk: ``prefill_chunk_paged`` calls it)
    made while the block runs, on any thread; yields the one-element
    counter.  A chunk replayed in the piggyback graph is not a call: the
    engine counts those (``_prefill_chunks_piggybacked``)."""
    from django_assistant_bot_tpu_torch.models import llama

    calls = [0]
    real = llama.prefill_suffix_paged

    def counted(*a, **kw):
        calls[0] += 1
        return real(*a, **kw)

    llama.prefill_suffix_paged = counted
    try:
        yield calls
    finally:
        llama.prefill_suffix_paged = real


# calls of the paged prefill twin on CUDA tensors once phase 2 is done (the
# served path must launch the kernel; guard_prefill_twin installs the count)
PREFILL_TWIN_ON_CARD = [0]


def guard_prefill_twin() -> None:
    """From here on, count calls of ``paged_prefill_attention_plain`` on
    CUDA tensors in :data:`PREFILL_TWIN_ON_CARD` (phase 2 runs the twin on
    the card as its reference; nothing after it may)."""
    import importlib

    # the module (the package's ``ops.attention`` name is the dispatch function)
    attention = importlib.import_module(f"{PKG}.ops.attention")
    plain = attention.paged_prefill_attention_plain

    def counted(q, *a, **kw):
        if q.device.type == "cuda":
            PREFILL_TWIN_ON_CARD[0] += 1
        return plain(q, *a, **kw)

    attention.paged_prefill_attention_plain = counted


def check_prefill_launches(label: str, launches: int, forwards: int, layers: int,
                           forms=None, read=None) -> None:
    """``paged_prefill`` launches = ``layers`` x the chunk and suffix
    forwards (eager calls and piggybacked chunks), every one on ``read``
    ("<route>:<read>") where it is given, and no twin call on the card."""
    on_read = forms.get(read, 0) if forms is not None else launches
    log(f"  {label}: paged_prefill launches {launches} for {forwards} chunk / suffix forwards "
        f"({layers} layers){f', {read} {on_read}' if read else ''}; paged prefill twin calls on "
        f"the card so far {PREFILL_TWIN_ON_CARD[0]}")
    if forwards <= 0 or launches != layers * forwards:
        fail(f"{label}: paged_prefill launches {launches} != {layers} x {forwards} forwards")
    if read is not None and on_read != launches:
        fail(f"{label}: paged_prefill launches left the {read} form: {forms}")
    if PREFILL_TWIN_ON_CARD[0]:
        fail(f"{label}: the paged prefill twin ran on the card {PREFILL_TWIN_ON_CARD[0]} times")


# phase 4's bf16-pool readings, which phase 12 sets its fp8 pools beside
PHASE4: dict = {}


def pool_bytes(eng) -> int:
    """The bytes of an engine's K and V page pools (the dump page included)."""
    return sum(t.numel() * t.element_size() for t in (eng._cache.k, eng._cache.v))


def _tick_counters(eng) -> tuple:
    """The engine's tick clocks: host seconds issuing ticks, ticks issued,
    seconds waiting for ticks' ids, ticks processed."""
    return eng._tick_issue_s, eng._ticks_issued, eng._tick_block_s, eng._ticks_processed


def _tick_reading(run, rates) -> dict:
    """A run's ``issue_ms`` and ``block_ms`` per tick (the engine's
    ``tick_stats`` quantities over this run alone) and decode rate."""
    issue_s, issued, block_s, processed = run["ticks"]
    return {"issue_ms": round(issue_s / max(1, issued) * 1e3, 3),
            "block_ms": round(block_s / max(1, processed) * 1e3, 3), "ticks": issued,
            "decode_tok_s_per_request": round(sum(rates) / max(1, len(rates)), 2)}


def record_first_logits(eng) -> dict:
    """Keep each request's first-step logits (a device copy, no sync), keyed
    by its prompt ids: every admission path (a prefill wave, a suffix batch
    of prefix hits, a final chunk) samples the first token in
    ``_activate_batch``, so the wrapper reads the logits the engine used."""
    seen = {}
    activate = eng._activate_batch

    def wrapped(slots, reqs, logits, *, pad):
        for j, r in enumerate(reqs):
            seen[tuple(r.prompt_ids)] = logits[pad + j].clone()
        return activate(slots, reqs, logits, pad=pad)

    eng._activate_batch = wrapped
    return seen


def rag_wave_report(cfg, engine, tok, rag, first, alone, rest) -> None:
    """The RAG wave's checks: the first chat misses and registers the head;
    the one sent alone hits; the six that follow all hit; each hit takes a
    copy-on-write boundary page; the paged kernel ran (the wave's own counts)
    on the tensor-core route; the pool returns to the registry's pages; TTFT
    of the hits against the miss."""
    ttft_miss, _, _ = _check_dialogs(tok, [("rag miss", rag[0])], first["results"])
    ttft_alone, _, _ = _check_dialogs(tok, [("rag hit 1, alone", rag[1])], alone["results"])
    keys = [(f"rag hit {i}", m) for i, m in enumerate(rag[2:], 2)]
    ttft_hits, rates, _ = _check_dialogs(tok, keys, rest["results"])

    def delta(run):
        return tuple(run["kv1"][k] - run["kv0"][k]
                     for k in ("prefix_hits", "prefix_misses", "kv_cow_copies"))

    runs = (first, alone, rest)
    kv1 = rest["kv1"]
    counts = {k: sum(r["counts"][k] for r in runs) for k in first["counts"]}
    steps = sum(r["steps"] for r in runs)
    log(f"  RAG wave: head {kv1['kv_shared_pages']} registry pages; (hits, misses, COW copies) "
        f"miss {delta(first)}, alone {delta(alone)}, the six {delta(rest)}; pages used after "
        f"{kv1['kv_pages_used']} of {kv1['kv_pages_total']}; launches {counts} over {steps} "
        f"decode steps; TTFT miss {ttft_miss[0]:.4f} s, the hit sent alone (same question "
        f"size) {ttft_alone[0]:.4f} s; the six sent together: mean "
        f"{sum(ttft_hits) / len(ttft_hits):.4f} s (min {min(ttft_hits):.4f}, max "
        f"{max(ttft_hits):.4f}), the ~700-token question's {ttft_hits[-1]:.4f} s; their decode "
        f"{sum(rates) / max(1, len(rates)):.2f} tok/s per request")
    if (delta(first), delta(alone), delta(rest)) != ((0, 1, 0), (1, 0, 1), (6, 0, 6)):
        fail(f"RAG wave: (hits, misses, COW copies) {delta(first)}, {delta(alone)}, "
             f"{delta(rest)} (want (0, 1, 0), (1, 0, 1), (6, 0, 6))")
    if not (kv1["kv_shared_pages"] == 3 and kv1["kv_pages_used"] == 3
            and kv1["kv_pages_free"] == kv1["kv_pages_total"] - 3):
        fail(f"RAG wave: the pool did not return to the registry's 3 pages: {kv1}")
    if counts["paged_decode"] <= 0 or counts["paged_decode"] != cfg.num_layers * steps:
        fail(f"RAG wave: paged launches {counts['paged_decode']} != {cfg.num_layers} x {steps}")
    if engine.decode_path_stats()["prefill_chunks_piggybacked"] < 1:
        fail("RAG wave: no chunk piggybacked")
    forms = {f: sum(r["prefill_forms"][f] for r in runs) for f in first["prefill_forms"]}
    check_prefill_launches("RAG wave", counts["paged_prefill"],
                           sum(r["suffix_forwards"] + r["piggybacked"] for r in runs),
                           cfg.num_layers, forms, "mma:native")


def hit_vs_cold(cfg, tok, chats, hit_logits, cold_logits, hit_runs, cold_runs) -> None:
    """Each RAG hit's first-step logits, as the serving engine computed them
    (the registered head's full pages shared, its boundary page cloned, a
    suffix prefill or chunks from the head's length), against the same
    prompt served alone by an engine with prefix sharing off (a cold chunked
    prefill from position 0), at the 8B width in bf16.

    Bound, per logit: 4 bf16 ulps at max|cold| (``4 * 2^(e - 7)``, ``2^e <=
    max|cold| < 2^(e + 1)``).  Both paths run the same arithmetic on every
    position: the head's K/V (the miss's chunks, or the cold chunks) and the
    suffix read the same weights through the same plain ops; what differs is
    how the positions are grouped into calls (a batch of suffix rows, chunks
    at other boundaries), which can only change which GEMM kernel runs and so
    the last bit of a bf16 activation.  Readings on an H100 were exactly 0,
    so the bound leaves a few ulps for that and catches a wrong hit (a
    boundary page read at the wrong offset or a stale layer in the clone
    moves logits by a sizeable share of max|cold|).  The greedy completions
    are compared and reported; their identity is not required at bf16."""
    import math

    import torch

    from django_assistant_bot_tpu_torch.serving import encode_chat_split

    hit_results = [r for run in hit_runs for r in run["results"]]
    cold_results = [r for run in cold_runs for r in run["results"]]
    worst, same_text = 0.0, 0
    for i, (msgs, h, c) in enumerate(zip(chats, hit_results, cold_results), 1):
        if c[0] != 200:
            fail(f"cold /dialog/ (rag hit {i}) returned {c[0]}: {c[1]}")
        key = tuple(encode_chat_split(tok, msgs)[0])
        if key not in hit_logits or key not in cold_logits:
            fail(f"hit vs cold: rag hit {i} left no first-step logits")
        hit, cold = hit_logits[key].float(), cold_logits[key].float()
        top = cold.abs().max().item()
        bound = 4 * 2.0 ** (math.floor(math.log2(top)) - 7)
        err = (hit - cold).abs().max().item()
        worst = max(worst, err / bound)
        text = h[1]["response"]["result"] == c[1]["response"]["result"]
        same_text += text
        log(f"  hit vs cold, rag hit {i} ({len(key)}-token prompt): first-step max_abs_err "
            f"{err:.4e}, max|cold| {top:.4e}, bound {bound:.4e} (4 bf16 ulps), argmax "
            f"{'equal' if int(hit.argmax()) == int(cold.argmax()) else 'differs'}, "
            f"32-token completion {'equal' if text else 'differs'}")
        if not (torch.isfinite(hit).all() and hit.shape == (cfg.vocab_size,) and err <= bound):
            fail(f"hit vs cold logits, rag hit {i}: err {err} > bound {bound}")
    log(f"  hit vs cold: worst err/bound {worst:.4f}; completions equal {same_text} of "
        f"{len(chats)}")


def _timed_run(fn, n: int, per: int, label: str, unit: str = "step", batches: int = 1) -> dict:
    """Log the synchronised, host-enqueue and device kernel time of ``fn``
    per ``unit`` (``fn`` runs ``per`` of them; a decode step by default),
    the idle share, and the device time by kernel from torch.profiler, each
    over ``batches`` batches of ``n`` calls (medians and spreads when there
    are several; the kernel table from the batch of median device time).
    Returns the medians: ``wall_ms``, ``device_ms`` and the paged kernels'
    ``paged_ms``, per ``unit``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    timing = [_sync_and_enqueue_ms(fn, n, per) for _ in range(batches)]
    walls, enqueues = [w for w, _ in timing], [e for _, e in timing]
    tables = []
    for _ in range(batches):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        kernels_by_name = []
        for e in prof.key_averages():
            dev_us = _device_us(e)
            if dev_us > 0 and e.device_type == torch.autograd.DeviceType.CUDA:
                kernels_by_name.append((dev_us / (n * per) / 1e3, e.count / (n * per), e.key))
        tables.append(kernels_by_name)

    def part(table, word=None):
        rows = [(ms, c) for ms, c, name in table if word is None or word in name]
        return sum(ms for ms, _ in rows), sum(c for _, c in rows)

    busy = [part(t)[0] for t in tables]
    wall_ms, enqueue_ms = statistics.median(walls), statistics.median(enqueues)
    busy_ms = statistics.median(busy)
    stat = (lambda xs: _stat(xs, "ms")) if batches > 1 else (lambda xs: f"{xs[0]:.3f} ms")
    log(f"  {label}: synchronised per {unit} {stat(walls)}, host enqueue {stat(enqueues)}, "
        f"device kernel time {stat(busy)} "
        f"({'not measured: profiler saw no device time' if busy_ms == 0 else f'idle share {1 - busy_ms / wall_ms:.3f} of the medians'})"
        + (f" over {batches} batches of {n} calls" if batches > 1 else ""))
    table = sorted(tables, key=lambda t: part(t)[0])[(batches - 1) // 2]
    for ms, calls, name in sorted(table, reverse=True)[:6]:
        log(f"    {ms:.4f} ms/{unit} in {calls:g} launches/{unit}: {name[:90]}")
    words = ("paged", "qgemm", "moe")
    for word in words:
        ms = [part(t, word)[0] for t in tables]
        log(f"    {word}: {stat(ms)}/{unit} in {part(table, word)[1]:g} launches/{unit}")
    route_combine = [part(t, "moe_route")[0] + part(t, "moe_combine")[0] for t in tables]
    if any(route_combine):
        log(f"    moe route+combine: {stat(route_combine)}/{unit} in "
            f"{part(table, 'moe_route')[1] + part(table, 'moe_combine')[1]:g} launches/{unit}")
    rest = [part(t)[0] - sum(part(t, w)[0] for w in words) for t in tables]
    log(f"    the rest (neither {', '.join(words)}): {stat(rest)}/{unit}")
    log(f"    all kernels: {part(table)[1]:g} launches/{unit}")
    return {"wall_ms": wall_ms, "device_ms": busy_ms,
            "paged_ms": statistics.median(part(t, "paged")[0] for t in tables)}


def _sync_and_enqueue_ms(fn, n: int, per: int) -> tuple:
    """(synchronised ms, host-enqueue ms) per step of ``n`` back-to-back
    calls of ``fn`` (``per`` steps each), after three warm-up calls."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    enqueue_ms = (time.perf_counter() - t0) / n / per * 1e3
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / n / per * 1e3, enqueue_ms


def _event_span_ms(fn, n: int) -> list:
    """Milliseconds between CUDA events recorded just before and just after
    each of ``n`` calls of ``fn`` (a graph's replay, or eager launches),
    synchronised after each call."""
    import torch

    ev0, ev1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    spans = []
    for _ in range(n):
        ev0.record()
        fn()
        ev1.record()
        torch.cuda.synchronize()
        spans.append(ev0.elapsed_time(ev1))
    return spans


# the parts of a Llama chunk forward's device time: the kernels launched
# inside the named llama functions (before the paged prefill plane's and
# after: a split of either tree), the rest apart
CHUNK_PARTS = {
    "attention": ("gqa_dot_product_attention", "paged_prefill_attention"),
    "gather_write": ("_gather_paged_rows", "_scatter_paged_rows", "_chunk_write_targets",
                     "_write_chunk_tokens"),
    "gemm": ("qeinsum", "qeinsum_group"),
}
# kernels launched through ctypes have no PyTorch op to link them to a
# range; they go to their part by name
CHUNK_KERNEL_PARTS = {"paged_prefill": "attention"}


def llama_chunk_split(run, label: str, profiles: int = 3) -> dict:
    """Device ms of one eager call of ``run`` (a Llama chunk forward): the
    median of ``profiles`` torch.profiler profiles, split into
    ``CHUNK_PARTS`` (each llama function wrapped in a ``record_function``
    range for the profiles; a range's device time is the kernels launched
    inside it), the rest and the total.  A profile that comes back without
    kernel records is taken again (at most twice as many as asked)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from django_assistant_bot_tpu_torch.models import llama

    saved = []
    for part, names in CHUNK_PARTS.items():
        for name in names:
            fn = getattr(llama, name, None)
            if fn is None:
                continue

            def ranged(*a, _fn=fn, _tag=f"chunk_split:{part}", **kw):
                with record_function(_tag):
                    return _fn(*a, **kw)

            saved.append((name, fn))
            setattr(llama, name, ranged)
    parts, tops = [], []
    try:
        with torch.no_grad():
            run()
            torch.cuda.synchronize()
            for _ in range(3 * profiles):
                if len(parts) == profiles:
                    break
                with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                    run()
                    torch.cuda.synchronize()
                # kernels only: the ranges' device-side annotations are spans
                kern = {e.key: _device_us(e) / 1e3 for e in prof.key_averages()
                        if e.device_type == torch.autograd.DeviceType.CUDA
                        and not e.key.startswith("chunk_split:") and _device_us(e) > 0}
                total = sum(kern.values())
                if total <= 0:
                    log("  torch.profiler saw no device time; profiling the chunk again")
                    continue
                part = dict.fromkeys(CHUNK_PARTS, 0.0)
                for e in prof.events():
                    if (e.name.startswith("chunk_split:")
                            and e.device_type == torch.autograd.DeviceType.CPU):
                        part[e.name.split(":", 1)[1]] += e.device_time_total / 1e3
                for word, name in CHUNK_KERNEL_PARTS.items():
                    by_name = sum(ms for k, ms in kern.items() if word in k)
                    if part[name] < by_name:  # not linked to the range: add them
                        part[name] += by_name
                part["rest"] = total - sum(part.values())
                part["total"] = total
                parts.append(part)
                tops.append(sorted(kern.items(), key=lambda kv: -kv[1])[:6])
    finally:
        for name, fn in saved:
            setattr(llama, name, fn)
    if not parts:
        log(f"  {label}: not measured (torch.profiler saw no device time)")
        return {}
    med = {k: statistics.median(p[k] for p in parts) for k in parts[0]}
    log(f"  {label}, device ms (median of {len(parts)} profiles): "
        + ", ".join(f"{k} {v:.4f}" for k, v in med.items()))
    top = tops[sorted(range(len(parts)), key=lambda i: parts[i]["total"])[(len(parts) - 1) // 2]]
    log("    its costliest kernels (the median profile): "
        + "; ".join(f"{ms:.4f} ms {name[:70]}" for name, ms in top))
    return med


# profiled batches of the eager step in a decode breakdown (each a
# torch.profiler trace of ten eager steps), and timed batches of the tick's
# replays and of the chunk with the tick (the costliest part at Mixtral's
# width)
BREAKDOWN_BATCHES = 3
BREAKDOWN_REPLAYS = 4


def decode_breakdown(cfg, params, engine, label: str = "", kv_dtype=None,
                     attn_fp8: bool = False, batches: int = BREAKDOWN_BATCHES,
                     chunk: bool = True, chunk_starts: tuple = ()) -> dict:
    """Where a full-width decode step's time goes: 8 slots at ragged
    positions; the eager step (a fresh pool, ``decode_step_paged`` issued op
    by op; torch.profiler's kernel time), then the engine's captured 8-step
    tick with its noise draws (the engine's own ``_launch_tick``) at the same
    positions, per step.  For a replay torch.profiler loses kernel records,
    so its device time is bounded from above by the span between CUDA
    events around the graph's launch (the span also holds the card's wait
    for the launch), and its idle share is not measured.  Last, a
    512-token chunk with the tick: one replay of the piggyback graph against
    the chunk issued eagerly, then the tick's replay, the chunk on a page
    chain of sentinels at start 0 and, at each of ``chunk_starts``, on slot
    0's real chain (the engine's pages 0-7: a chunk at start 3584 reads
    3,584 live keys).  ``kv_dtype`` and ``attn_fp8`` set the eager step's
    pool and read (the engine's tick has its own); ``batches`` is the eager
    step's profiled batches, ``chunk`` times the chunk with the tick.
    Returns the eager step's medians (``_timed_run``) and the replay's per
    step, ``replay_ms`` (synchronised) and ``span_ms``, and with ``chunk``
    the piggyback replay's synchronised ms by chain, ``chunk_tick_ms``."""
    import torch

    from django_assistant_bot_tpu_torch.models import llama

    B, page, NB = 8, 512, 8
    cache = llama.init_paged_cache(cfg, B, B * NB, page, dtype=kv_dtype, device="cuda")
    start = torch.tensor([5, 511, 512, 1041, 1836, 3000, 1500, 700], dtype=torch.int32, device="cuda")
    bt = torch.arange(B * NB, dtype=torch.int32, device="cuda").reshape(B, NB)
    # random tokens: a MoE model routes them to about as many experts as a
    # live batch does (a Llama-3 step does not depend on them)
    tokens = torch.randint(1, 255, (B,), generator=torch.Generator(device="cuda").manual_seed(7),
                           device="cuda", dtype=torch.int32)

    def step():
        cache.lengths.copy_(start)
        llama.decode_step_paged(params, cfg, tokens, cache, bt, attn_fp8=attn_fp8)

    K = engine.decode_steps
    engine._bt_dev.copy_(bt)
    engine._active_dev.fill_(True)
    engine._temps_dev.zero_()

    def tick(piggyback=False):
        engine._cache.lengths.copy_(start)
        engine._tokens_dev.copy_(tokens)
        engine._launch_tick(piggyback)

    def chunk_then_tick():
        engine._cache.lengths.copy_(start)
        engine._tokens_dev.copy_(tokens)
        engine._chunk_body()
        engine._launch_tick()

    with torch.no_grad():
        eager = _timed_run(step, 10, 1, f"{label}eager decode step, 8 slots, full width",
                           batches=batches)
        timing = [_sync_and_enqueue_ms(tick, 10, K) for _ in range(BREAKDOWN_REPLAYS)]
        spans = [ms / K for ms in _event_span_ms(engine._graph.replay, 10)]
        log(f"  {label}graph replay of the {K}-step tick, 8 slots, full width, per step over "
            f"{BREAKDOWN_REPLAYS} batches of 10 replays: synchronised {_stat([w for w, _ in timing], 'ms')}, host "
            f"enqueue {_stat([e for _, e in timing], 'ms')}; device time at most the graph span "
            f"(CUDA events, launch wait included) {_stat(spans, 'ms')} over 10 replays, idle "
            f"share not measured; {engine._graph_launches.launches['paged_decode'] // K} paged "
            f"launches per step (recorded at capture); graph pool "
            f"{engine.graph_pool_bytes / 2**20:.1f} MiB")
        chunk_tick = {}
        # the sentinel chain writes the dump page and slot 0's length only;
        # a real chain's chunk reads its live keys and writes its own block
        chains = ([("sentinel chain, start 0", None, 0)] if chunk else []) + [
            (f"slot 0's real chain, start {s}", bt[0], s) for s in chunk_starts if chunk]
        for text, chain, s in chains:
            if chain is None:
                engine._chunk_bt_dev.fill_(engine._kv_sentinel)
            else:
                engine._chunk_bt_dev.copy_(chain[:engine._chunk_bt_dev.shape[0]])
            engine._chunk_slot_dev.zero_()
            engine._chunk_start_dev.fill_(s)
            pig = [_sync_and_enqueue_ms(lambda: tick(True), 3, 1)[0]
                   for _ in range(BREAKDOWN_REPLAYS)]
            seq = [_sync_and_enqueue_ms(chunk_then_tick, 3, 1)[0]
                   for _ in range(BREAKDOWN_REPLAYS)]
            pig_span = _event_span_ms(engine._piggyback_graph.replay, BREAKDOWN_REPLAYS)
            log(f"  {label}a {engine.chunk_size}-token chunk ({text}) and the {K}-step tick, "
                f"{BREAKDOWN_REPLAYS} batches of 3: one piggyback replay synchronised "
                f"{_stat(pig, 'ms')} (graph span {_stat(pig_span, 'ms')}), the chunk eager then "
                f"the tick's replay synchronised {_stat(seq, 'ms')}")
            chunk_tick[text] = statistics.median(pig)
    return {**eager, "replay_ms": statistics.median(w for w, _ in timing),
            "span_ms": statistics.median(spans), "chunk_tick_ms": chunk_tick}


def engine_chunk_split(cfg, engine, starts: tuple) -> dict:
    """The Llama-3-8B eager chunk split (:func:`llama_chunk_split`) of the
    engine's own chunk forward, ``_chunk_body``, on slot 0's real chain
    (the engine's pages 0-7) at each of ``starts``: attention, the page
    write, the GEMMs and the rest, by start."""
    import torch

    out = {}
    bt = engine._chunk_bt_dev
    for s in starts:
        bt.copy_(torch.arange(bt.numel(), dtype=bt.dtype, device=bt.device))
        engine._chunk_slot_dev.zero_()
        engine._chunk_start_dev.fill_(s)
        out[s] = llama_chunk_split(engine._chunk_body, f"Llama-3-8B eager {engine.chunk_size}-"
                                   f"token chunk at start {s} ({cfg.num_layers} layers)")
    return out


# --------------------------------------------------------------------- phase 5
def shed_check() -> None:
    """A tiny engine on the card with one slot and a queue bound of 1: a
    burst of ten ``/dialog/`` requests must see at least one 200 and at
    least one 429 carrying ``Retry-After``."""
    import aiohttp
    from aiohttp import web

    from django_assistant_bot_tpu_torch.serving.registry import ModelRegistry
    from django_assistant_bot_tpu_torch.serving.server import create_app

    registry = ModelRegistry.from_config({"shed-chat": {
        "tiny": True, "device": "cuda", "max_slots": 1, "max_seq_len": 256,
        "sched_max_queue": 1, "sched_admit_max_wait_s": None,
    }})
    port = _free_port()

    async def drive():
        runner = web.AppRunner(create_app(registry))
        await runner.setup()
        await web.TCPSite(runner, "127.0.0.1", port).start()
        try:
            async with aiohttp.ClientSession() as session:
                async def one(i):
                    async with session.post(
                        f"http://127.0.0.1:{port}/dialog/",
                        json={"model": "shed-chat", "max_tokens": 64, "priority": "background",
                              "messages": [{"role": "user", "content": f"q{i}"}]},
                    ) as resp:
                        return resp.status, resp.headers.get("Retry-After"), await resp.json()

                return await asyncio.gather(*(one(i) for i in range(10)))
        finally:
            await runner.cleanup()

    results = asyncio.run(drive())
    statuses = [st for st, _, _ in results]
    shed = [(retry, body) for st, retry, body in results if st == 429]
    log(f"  shed check (1 slot, queue bound 1, burst of 10): statuses {statuses}; "
        f"Retry-After {[r for r, _ in shed]}; reasons {sorted({b.get('reason') for _, b in shed})}")
    if statuses.count(200) < 1 or not shed or set(statuses) - {200, 429}:
        fail(f"load shedding: expected 200s and 429s, got {statuses}")
    if any(r is None or int(r) < 1 or b.get("retry_after_s", 0) <= 0 for r, b in shed):
        fail(f"a 429 without a Retry-After: {shed}")


def serve_tiny_subprocess():
    import urllib.request

    port = _free_port()
    cmd = [sys.executable, "-m", f"{PKG}.cli", "serve", "--tiny", "--device", "cuda",
           "--host", "127.0.0.1", "--port", str(port)]
    errlog = tempfile.TemporaryFile(mode="w+")  # a file, not a pipe: the server's log never blocks it
    proc = subprocess.Popen(cmd, cwd=REPO, stdout=subprocess.DEVNULL, stderr=errlog, text=True)
    try:
        deadline = time.time() + 180
        while True:
            if proc.poll() is not None:
                errlog.seek(0)
                fail(f"serve --tiny exited {proc.returncode}: {errlog.read()[-2000:]}")
            try:
                with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz", timeout=2) as r:
                    if r.status == 200:
                        break
            except OSError:
                pass
            if time.time() > deadline:
                fail("serve --tiny did not come up within 180 s")
            time.sleep(0.5)
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/dialog/",
            data=json.dumps({"model": "tiny-chat", "messages": [{"role": "user", "content": "hi"}],
                             "max_tokens": 8}).encode(),
            headers={"Content-Type": "application/json"},
        )
        with urllib.request.urlopen(req, timeout=120) as r:
            body = json.loads(r.read())
            if r.status != 200 or "result" not in body.get("response", {}):
                fail(f"serve --tiny /dialog/ returned {r.status}: {body}")
        log(f"  serve --tiny --device cuda: /dialog/ 200, usage {body['response']['usage']}")
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/embeddings/",
            data=json.dumps({"model": "tiny-emb", "texts": ["hi", "there"]}).encode(),
            headers={"Content-Type": "application/json"},
        )
        with urllib.request.urlopen(req, timeout=120) as r:
            embs = json.loads(r.read()).get("embeddings")
            if r.status != 200 or len(embs or []) != 2 or len(embs[0]) != 64:
                fail(f"serve --tiny /embeddings/ returned {r.status}: {embs}")
        log("  serve --tiny --device cuda: /embeddings/ 200, two 64-wide embeddings")
        from django_assistant_bot_tpu_torch.serving.obs import parse_prometheus_text

        with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics", timeout=30) as r:
            fams = parse_prometheus_text(r.read().decode())
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz", timeout=30) as r:
            health = json.loads(r.read())
        sup = health["generators"]["tiny-chat"]["supervision"]
        ttft_count = [v for n, _, v in fams.get("dabt_ttft_seconds", {}).get("samples", [])
                      if n.endswith("_count")]
        restarts = [v for _, _, v in fams.get("dabt_engine_restarts_total", {}).get("samples", [])]
        log(f"  serve --tiny /metrics: {len(fams)} families, dabt_ttft_seconds_count "
            f"{ttft_count}, dabt_engine_restarts_total {restarts}; /healthz status "
            f"{health['status']}, supervision {sup}")
        if not (ttft_count == [1.0] and restarts == [0.0] and health["status"] == "ok"
                and sup["healthy"] and sup["engine_restarts"] == 0):
            fail(f"serve --tiny /metrics or /healthz wrong: {sorted(fams)}, {health}")
    finally:
        proc.terminate()
        try:
            proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
        errlog.close()


# --------------------------------------------------------------------- phase 6
RAG_ROWS, RAG_CAPACITY = 1_000_000, 1 << 20  # the corpus: 64 planted passages among filler
RAG_FILLER_ID = 1_000_000  # filler rows' ids start here; planted passages are 0..63


def _passages() -> list:
    """64 planted passages of 200-1,500 bytes, each written in its own
    random 10-character alphabet (a random-weight encoder's mean-pooled
    embedding follows the text's byte mix, so passages drawn from one mix
    would embed alike).  The first 8, 200-284 bytes, are the questions."""
    import random
    import string

    out = []
    for i in range(64):
        rnd = random.Random(1000 + i)
        n = 200 + 12 * i if i < 8 else 300 + (1200 * (i - 8)) // 55
        letters = rnd.sample(string.ascii_lowercase + string.digits, 10)
        text = ""
        while len(text) < n:
            text += "".join(rnd.choice(letters) for _ in range(rnd.randint(2, 9))) + " "
        out.append(text[:n])
    return out


def _stat(xs, unit="s") -> str:
    import statistics

    return (f"median {statistics.median(xs):.4f} {unit} (min {min(xs):.4f}, max {max(xs):.4f}, "
            f"n={len(xs)})")


def rag_phase(card: str, dec_spec, dec_engine) -> dict:
    """The RAG request end to end on the card.  A ruBert-base encoder
    (EncoderConfig(): 12 layers, width 768, bf16, random weights from a
    seed) behind ``/embeddings/`` and phase 4's Llama-3-8B engine behind
    ``/dialog/``, in one registry and one server.  64 planted passages are
    embedded over ``/embeddings/`` and placed with ``add_device`` among
    999,936 seeded random rows (1,000,000 rows, capacity 1,048,576).  Each
    planted passage, embedded alone as a question, must come back top-1
    with a score >= 0.99; an allow-listed search must return only allowed
    ids.  Then 8 RAG requests (a passage's own text as the question): embed,
    ``AsyncSearcher.search(k=16)``, and ``/dialog/`` with the top 3
    passages, whole, as the system context and 32 greedy tokens, sent back
    to back and then each after the card drained (the context in the other
    order, so no request hits the prefix cache); launch counts are zeroed
    just before them and read just after.  A prompt of 2,000-3,600 tokens
    is longer than the engine's 512-token chunk, so each prefill runs as
    chunks (attention in plain PyTorch, as the JAX chunk's) and the flash
    kernel, whose path is phase 4's, is not launched here: the KNN and the
    paged decode kernels must be.  Readings, each a median and spread of
    >= 5 runs: embedding docs/s at batch 64, /embeddings/ latency of one
    text, a KNN search of one query and of 32 coalesced, each RAG request's
    embed, search and TTFT at its prompt length; and the encoder's own time
    at the two request shapes."""
    import aiohttp
    import torch
    from aiohttp import web

    from django_assistant_bot_tpu_torch import kernels
    from django_assistant_bot_tpu_torch.models import EncoderConfig, encoder
    from django_assistant_bot_tpu_torch.serving import ByteTokenizer, EmbeddingEngine
    from django_assistant_bot_tpu_torch.serving.registry import ModelRegistry, ModelSpec
    from django_assistant_bot_tpu_torch.serving.server import create_app
    from django_assistant_bot_tpu_torch.storage import AsyncSearcher, VectorIndex

    t0 = time.perf_counter()
    cfg = EncoderConfig()  # ruBert-base geometry, bf16
    params = encoder.init(cfg, torch.Generator(device="cuda").manual_seed(11), "cuda")
    emb_spec = ModelSpec(name="rubert-base-random", kind="encoder", device="cuda", max_batch=64)
    registry = ModelRegistry()
    registry.load(emb_spec, engine=EmbeddingEngine(cfg, params, ByteTokenizer(), max_batch=64,
                                                   device="cuda"))
    registry.load(dec_spec, engine=dec_engine)
    n_params = sum(w.numel() for w in params["layers"].values()) + sum(
        params[k].numel() for k in params if k != "layers")
    log(f"  encoder: {cfg.num_layers} layers, width {cfg.hidden_size}, {n_params / 1e6:.1f} M "
        f"params bf16, built in {time.perf_counter() - t0:.2f} s")
    tok = ByteTokenizer()
    passages = _passages()
    questions = passages[:8]
    index = VectorIndex(cfg.hidden_size, device="cuda")
    searcher = AsyncSearcher(index, window_s=0.002, max_batch=32)
    port = _free_port()
    out = {}

    async def drive():
        runner = web.AppRunner(create_app(registry))
        await runner.setup()
        await web.TCPSite(runner, "127.0.0.1", port).start()
        try:
            async with aiohttp.ClientSession() as session:
                async def embed(texts):
                    async with session.post(f"http://127.0.0.1:{port}/embeddings/",
                                            json={"model": emb_spec.name, "texts": texts}) as r:
                        body = await r.json()
                        if r.status != 200:
                            fail(f"/embeddings/ returned {r.status}: {body}")
                        return body["embeddings"]

                await embed(passages)  # warm-up: the encoder's first GEMMs at these shapes
                await embed(questions[:1])
                docs_s = []
                for _ in range(5):
                    t = time.perf_counter()
                    vecs = await embed(passages)
                    docs_s.append(len(passages) / (time.perf_counter() - t))
                emb = torch.tensor(vecs, dtype=torch.float32)
                if not (emb.shape == (64, cfg.hidden_size) and torch.isfinite(emb).all()):
                    fail(f"/embeddings/ gave {tuple(emb.shape)}, finite {bool(torch.isfinite(emb).all())}")

                # the corpus: 64 chunks of seeded random rows, a planted
                # passage after each, all appended on the card
                t = time.perf_counter()
                gen = torch.Generator(device="cuda").manual_seed(12)
                index.reserve(RAG_ROWS)
                chunk = (RAG_ROWS - 64) // 64
                emb_dev = emb.cuda()
                for i in range(64):
                    rows = torch.randn((chunk, cfg.hidden_size), generator=gen, device="cuda")
                    start = RAG_FILLER_ID + i * chunk
                    index.add_device(range(start, start + chunk), rows.to(torch.bfloat16))
                    index.add_device([i], emb_dev[i : i + 1])
                torch.cuda.synchronize()
                build_s = time.perf_counter() - t
                if len(index) != RAG_ROWS or index._capacity() != RAG_CAPACITY:
                    fail(f"corpus: {len(index)} rows, capacity {index._capacity()}")

                # each planted passage, embedded alone, is top-1 for its own text
                one_s, own = [], []
                for p in passages:
                    t = time.perf_counter()
                    own.append((await embed([p]))[0])
                    one_s.append(time.perf_counter() - t)
                hits = await asyncio.gather(*(searcher.search(v, k=16) for v in own))
                worst_own, best_other = 1.0, -1.0
                for i, h in enumerate(hits):
                    if h[0][0] != i or h[0][1] < 0.99:
                        fail(f"planted passage {i} is not top-1 for its own text: {h[:3]}")
                    worst_own = min(worst_own, h[0][1])
                    best_other = max(best_other, h[1][1])
                drift = (torch.tensor(own[:8]) - emb[:8]).abs().max().item()
                allowed = {3, 5, 7, RAG_FILLER_ID, RAG_FILLER_ID + 100, RAG_FILLER_ID + 30 * chunk}
                allowed_hits = await searcher.search(own[5], k=16, allowed_ids=allowed)
                if {i for i, _ in allowed_hits} - allowed or len(allowed_hits) != 6 \
                        or allowed_hits[0][0] != 5:
                    fail(f"allow-listed search returned {allowed_hits}")

                # KNN latency: one query (search on this thread), 32 coalesced
                knn_one, knn_32 = [], []
                index.search(own[0], k=16)
                for v in own[:8]:
                    t = time.perf_counter()
                    index.search(v, k=16)
                    knn_one.append(time.perf_counter() - t)
                for _ in range(5):
                    t = time.perf_counter()
                    await asyncio.gather(*(searcher.search(v, k=16) for v in own[:32]))
                    knn_32.append(time.perf_counter() - t)

                # the RAG requests: once back to back (each one's embedding
                # queues on the card behind the ticks the engine issued
                # ahead for the previous answer), then each after the card
                # drained
                torch.cuda.synchronize()
                kernels.reset_counts()
                hits0 = dec_engine.kv_stats()["prefix_hits"]
                rag = []
                for i, q in enumerate(questions + questions):
                    if i >= len(questions):
                        torch.cuda.synchronize()
                    t = time.perf_counter()
                    v = (await embed([q]))[0]
                    t1 = time.perf_counter()
                    top = await searcher.search(v, k=16)
                    t2 = time.perf_counter()
                    if top[0][0] != i % len(questions):
                        fail(f"RAG question {i}: top-1 is {top[0]}")
                    # the second round lists the passages the other way
                    # round: a new head, not a hit on the first round's
                    order = top[:3] if i < len(questions) else top[2::-1]
                    context = "\n".join(
                        f"[{pid}] {passages[pid] if pid < 64 else '(filler row)'}"
                        for pid, _ in order)
                    msgs = [{"role": "system", "content": "Answer from these passages:\n" + context},
                            {"role": "user", "content": q}]
                    n_prompt = len(tok.encode_chat(msgs))
                    status, body, wall = await _post(session, port, dec_spec.name, msgs)
                    ttft, _, _ = _check_dialogs(tok, [(f"rag request {i}", msgs)],
                                                [(status, body, wall)])
                    rag.append((t1 - t, t2 - t1, ttft[0], wall, [pid for pid, _ in order],
                                n_prompt))
                torch.cuda.synchronize()
                counts = kernels.launch_counts()
                hits = dec_engine.kv_stats()["prefix_hits"] - hits0
                # the encoder alone on the card, at the two request shapes
                ids = torch.randint(1, 255, (64, 512), generator=gen, device="cuda")
                mask = torch.ones((64, 512), dtype=torch.int32, device="cuda")
                with torch.no_grad():
                    enc64 = timed(lambda: encoder.encode(params, cfg, ids, mask), 5)
                    enc1 = timed(lambda: encoder.encode(params, cfg, ids[:1, :256],
                                                        mask[:1, :256]), 10)
                    _timed_run(lambda: encoder.encode(params, cfg, ids, mask), 3, 1,
                               "encoder.encode, batch 64 x 512", unit="call")
                out.update(counts=counts, hits=hits, docs_s=docs_s, one_s=one_s, enc64=enc64, enc1=enc1,
                           knn_one=knn_one, knn_32=knn_32, rag=rag, build_s=build_s,
                           worst_own=worst_own, best_other=best_other, drift=drift)
        finally:
            await runner.cleanup()  # stops both engines

    asyncio.run(drive())
    counts = out["counts"]
    rag = out["rag"]
    log(f"  corpus: {RAG_ROWS} rows (64 planted) in capacity {RAG_CAPACITY}, appended on the card in "
        f"{out['build_s']:.2f} s; every planted passage top-1 for its own text (worst own "
        f"score {out['worst_own']:.5f}, best other score {out['best_other']:.5f}); the 8 "
        f"questions' embeddings alone vs in the batch of 64: max_abs_err {out['drift']:.3e} "
        f"(bf16, other GEMM shapes); allow-listed search returned only allowed ids")
    log(f"  embedding docs/s at batch 64 (64 passages, sequence bucket 512): "
        f"{_stat(out['docs_s'], 'docs/s')}")
    log(f"  /embeddings/ latency, one text (the 64 passages alone): {_stat(out['one_s'])}")
    log(f"  KNN search at {RAG_ROWS} x {cfg.hidden_size}, k=16: one query {_stat(out['knn_one'])}; 32 "
        f"coalesced {_stat(out['knn_32'])}")
    e64, e1 = out["enc64"], out["enc1"]
    log(f"  encoder.encode alone: batch 64 x 512 {e64[0]:.3f} ms wall (device {e64[1]:.3f}), "
        f"{64e3 / e64[0]:.1f} docs/s; batch 1 x 256 {e1[0]:.3f} ms wall (device {e1[1]:.3f})")
    n, c = len(questions), dec_engine.chunk_size
    for i, (e, sr, ttft, wall, top3, n_prompt) in enumerate(rag):
        # the engine's chunking: full chunks from 0, the last ending at the
        # prompt's end
        chunks = len(range(0, n_prompt - c, c)) + 1 if n_prompt > c else 0
        log(f"  rag request {i % n} ({'back to back' if i < n else 'after a drain'}): prompt "
            f"{n_prompt} tokens ({chunks} chunks of {c}), embed {e:.4f} s, search {sr:.4f} s, "
            f"ttft {ttft:.4f} s, question to first token {e + sr + ttft:.4f} s, full response "
            f"{wall:.4f} s; context passages {top3}")
    for label, part in (("back to back", rag[:n]), ("after a drain", rag[n:])):
        log(f"  RAG question to first token, {label}: "
            f"{_stat([e + sr + t for e, sr, t, *_ in part])}; embed "
            f"{_stat([r[0] for r in part])}; search {_stat([r[1] for r in part])}; TTFT "
            f"{_stat([r[2] for r in part])}; prompt tokens "
            f"{_stat([r[5] for r in part], 'tokens')}  [{card}]")
    log(f"  launches during the RAG requests: {counts}; prefix hits {out['hits']}")
    for name in ("knn_topk", "paged_decode"):
        if counts[name] <= 0:
            fail(f"kernel {name} was not launched by the RAG requests")
    if out["hits"]:  # each TTFT is a cold prefill of the whole prompt
        fail(f"RAG requests hit the prefix cache {out['hits']} times")
    return counts


# --------------------------------------------------------------------- phase 7
async def _post_stream(session, port, name, msgs, *, max_tokens=32, temperature=0.0,
                       close_after_s=0.0):
    """A ``"stream": true`` /dialog/ request: (status, delta events, client
    seconds of each delta event's arrival after the send, terminal event,
    client seconds to the response's headers).  The server sends its
    headers once the first token reached the host, so the last is the
    client's TTFT.  ``close_after_s`` > 0 drops the connection that long
    after the headers."""
    t0 = time.perf_counter()
    events, arrivals, terminal = [], [], None
    async with session.post(
        f"http://127.0.0.1:{port}/dialog/",
        json={"model": name, "messages": msgs, "max_tokens": max_tokens,
              "temperature": temperature, "stream": True},
    ) as resp:
        t_headers = time.perf_counter() - t0
        if resp.status != 200:
            return resp.status, await resp.json(), [], None, t_headers
        if close_after_s:
            await asyncio.sleep(close_after_s)
            resp.close()
            return 200, events, arrivals, None, t_headers
        async for raw in resp.content:
            line = raw.decode("utf-8").strip()
            if not line.startswith("data:"):
                continue
            data = line[len("data:"):].strip()
            if data == "[DONE]":
                break
            ev = json.loads(data)
            if ev.get("done"):
                terminal = ev
            else:
                events.append(ev)
                arrivals.append(time.perf_counter() - t0)
    return 200, events, arrivals, terminal, t_headers


async def _post_json(session, port, name, msgs, *, max_tokens, temperature, json_format):
    async with session.post(
        f"http://127.0.0.1:{port}/dialog/",
        json={"model": name, "messages": msgs, "max_tokens": max_tokens,
              "temperature": temperature, "json_format": json_format},
    ) as resp:
        return resp.status, await resp.json()


def stream_json_phase(card: str, cfg, params) -> dict:
    """The bot's two request shapes at full width: a fresh
    ``GenerationEngine`` over phase 4's bf16 Llama-3-8B tensors (32 layers,
    the byte tokenizer, the default loop; the head's columns past the 256
    byte ids zeroed in place, so the answers are bytes and the streams
    carry text), registered with ``warmup`` and
    ``warmup_json`` so the registry runs ``warmup(json=True)`` before
    ``start()``, behind ``create_app``.  Reads the warmup's wall time and
    ``probe_decode``'s seconds per step beside the replayed tick's per-step
    span; then, launch counts zeroed before each group and read after:

    1. two greedy ``"stream": true`` requests beside two plain ones,
       concurrently: each stream's deltas concatenate to its non-streaming
       twin's text (the same request sent after, alone), byte for byte; TTFT
       and inter-token gaps from the events' arrival times (client side);
    2. a stream dropped after two events: its slot frees, with at most one
       tick issued between the request's cancel and its release;
    3. eight ``json_format`` requests at temperature 0.8 (96 tokens) with two
       plain greedy ones: each JSON answer that is not length-limited
       parses, each length-limited one is a live prefix of the JSON DFA, the
       plain ones equal their solo runs; single-step JSON ticks counted;
    4. the first request after the warmup captured no graph and built no
       library; the sampler's launches equal the sampling steps in every
       group; the JSON tick's replay per step.
    Returns the launch counts of group 1."""
    import aiohttp
    import torch
    from aiohttp import web

    from django_assistant_bot_tpu_torch import kernels
    from django_assistant_bot_tpu_torch.ops.json_fsm import build_char_dfa
    from django_assistant_bot_tpu_torch.serving import ByteTokenizer, GenerationEngine
    from django_assistant_bot_tpu_torch.serving.registry import ModelRegistry, ModelSpec
    from django_assistant_bot_tpu_torch.serving.server import create_app

    name = "llama3-8b-stream-json"
    spec = ModelSpec(name=name, device="cuda", max_slots=8, max_seq_len=4096, warmup=True,
                     warmup_json=True)
    # random weights put ~0.2% of their mass on the byte tokenizer's 256 byte
    # ids, so a stream would carry almost no text: the head's columns past
    # them are zeroed in place (phase 4's tensors, no copy; phase 8 draws
    # its own), so greedy picks bytes, valid UTF-8 or not, and the deltas
    # carry real text through the incremental detokenizer
    params["lm_head"][:, 256:].zero_()
    t0 = time.perf_counter()
    engine = GenerationEngine(cfg, params, ByteTokenizer(), device="cuda", **spec.engine_kwargs())
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    registry = ModelRegistry()
    t0 = time.perf_counter()
    registry.load(spec, engine=engine)  # warmup(json=True), then start()
    warmup_s = time.perf_counter() - t0
    captures, libs = engine.graph_captures, kernels.loaded()
    if engine._json_graph is None or captures != 3:
        fail(f"warmup(json=True) left the JSON graph uncaptured ({captures} captures)")
    probe_s = engine.probe_decode(iters=16)
    with engine._iter_lock:
        K = engine.decode_steps
        replay = [ms / K for ms in _event_span_ms(engine._graph.replay, 10)]
        json_replay = _event_span_ms(engine._json_graph.replay, 10)
        for t in (engine._cache.lengths, engine._tokens_dev, engine._toks_dev):
            t.zero_()
    log(f"  engine built in {build_s:.2f} s; registry load with warmup(json=True) and start "
        f"{warmup_s:.2f} s [{card}]; probe_decode {probe_s * 1e3:.4f} ms per step (16 tick "
        f"replays back to back, slots idle) beside the replayed {K}-step tick's span per step "
        f"{_stat(replay, 'ms')}; the JSON tick's replay (one step) {_stat(json_replay, 'ms')}")
    # prompt sizes: each request of a concurrent group alone in its prefill
    # bucket (256 and 512 for the streams and the JSON wave's plain ones, 64
    # and 128 for the plain ones beside the streams, the JSON prompts ~50
    # tokens), so each prefills as a batch of one, as its solo twin does,
    # and a decode row depends on its own history only: equal text, bitwise
    stream_msgs = [_chat(200, 31), _chat(420, 32)]
    beside_msgs = [_chat(40, 33), _chat(100, 34)]
    plain_msgs = [_chat(200, 41), _chat(420, 42)]
    json_msgs = [[{"role": "user", "content": f"Reply with a JSON object describing item {i}."}]
                 for i in range(8)]
    port = _free_port()
    reads = {}

    def group_counts(fn):
        async def run(session):
            torch.cuda.synchronize()
            kernels.reset_counts()
            samp0, json0 = sampling_steps(engine), engine._json_downgraded_ticks
            out = await fn(session)
            torch.cuda.synchronize()
            return out, kernels.launch_counts(), sampling_steps(engine) - samp0, \
                engine._json_downgraded_ticks - json0
        return run

    async def drive():
        runner = web.AppRunner(create_app(registry))
        await runner.setup()
        await web.TCPSite(runner, "127.0.0.1", port).start()
        try:
            async with aiohttp.ClientSession() as session:
                # plain solo runs first (the JSON wave's plain twins)
                solo = [await _post(session, port, name, m) for m in plain_msgs]
                reads["captures_after_first"] = engine.graph_captures
                reads["libs_after_first"] = kernels.loaded()

                async def streams(session):
                    return await asyncio.gather(
                        *(_post_stream(session, port, name, m) for m in stream_msgs),
                        *(_post(session, port, name, m) for m in beside_msgs))
                reads["streams"] = await group_counts(streams)(session)
                reads["twins"] = [await _post(session, port, name, m) for m in stream_msgs]

                # the disconnect: the request's cancel and its slot's release,
                # in ticks issued
                marks = {}
                submit, release = engine.submit, engine._release

                def submit_marked(*a, **kw):
                    fut = submit(*a, **kw)
                    if kw.get("stream") is not None:
                        fut.add_done_callback(lambda f: marks.setdefault(
                            "cancel", engine._ticks_issued) if f.cancelled() else None)
                    return fut

                def release_marked(slot):
                    s = engine._slots[slot]
                    if s is not None and s.request.future.cancelled():
                        marks.setdefault("release", engine._ticks_issued)
                    return release(slot)

                engine.submit, engine._release = submit_marked, release_marked
                try:
                    before = engine.cancelled_slots
                    await _post_stream(session, port, name, _chat(150, 51), max_tokens=1024,
                                       temperature=0.8, close_after_s=0.3)
                    deadline = time.monotonic() + 30
                    while time.monotonic() < deadline and not (
                            engine.num_active == 0 and engine.cancelled_slots > before):
                        await asyncio.sleep(0.005)
                finally:
                    engine.submit, engine._release = submit, release
                reads["disconnect"] = (marks, engine.cancelled_slots - before, engine.num_active)

                async def json_wave(session):
                    return await asyncio.gather(
                        *(_post_json(session, port, name, m, max_tokens=96, temperature=0.8,
                                     json_format=True) for m in json_msgs),
                        *(_post(session, port, name, m) for m in plain_msgs))
                reads["json"] = await group_counts(json_wave)(session)
                reads["solo"] = solo
                reads["healthz"] = await (await session.get(
                    f"http://127.0.0.1:{port}/healthz")).json()
        finally:
            await runner.cleanup()  # stops the registry's engine

    asyncio.run(drive())
    if reads["captures_after_first"] != captures or reads["libs_after_first"] != libs:
        fail(f"the first request after warmup captured a graph or built a library: captures "
             f"{captures} -> {reads['captures_after_first']}, libraries {sorted(libs)} -> "
             f"{sorted(reads['libs_after_first'])}")
    (results, counts, samples, _) = reads["streams"]
    if any(st != 200 for st, _, _ in results[2:]):
        fail(f"a plain request beside the streams failed: {results[2:]}")
    ttft, engine_ttft, per_token, gaps = [], [], [], []
    for (st, events, arrivals, terminal, t_headers), (pst, body, _) in zip(results[:2],
                                                                           reads["twins"]):
        if st != 200 or terminal is None or pst != 200:
            fail(f"stream request failed: {st} {events} / twin {pst} {body}")
        text = "".join(e["delta"] for e in events)
        twin = body["response"]["result"]
        if text != terminal["result"] or text != twin:
            fail(f"a stream's deltas differ from its non-streaming twin: {text!r} vs {twin!r}")
        u = terminal["usage"]
        ttft.append(t_headers)
        engine_ttft.append(u["ttft_s"])
        if u["completion_tokens"] > 1:
            per_token.append((u["latency_s"] - u["ttft_s"]) / (u["completion_tokens"] - 1))
        gaps += [b - a for a, b in zip(arrivals, arrivals[1:]) if b > a]
    log(f"  two greedy streams beside two plain requests, concurrently: deltas equal the "
        f"non-streaming twins' text (each sent alone after) byte for byte "
        f"({[len(r[1]) for r in results[:2]]} delta events, "
        f"{[r[3]['usage']['completion_tokens'] for r in results[:2]]} tokens); stream TTFT, "
        f"client (headers, sent at the first token) {_stat(ttft)}, engine (terminal event's "
        f"usage) {_stat(engine_ttft)}; inter-token from the terminal event (latency - ttft) / "
        f"(tokens - 1) {_stat(per_token) if per_token else 'none'}; gaps between delta events "
        f"(a fused tick delivers {K} tokens at once) {_stat(gaps) if gaps else 'none'}")
    if counts["sample"] != samples:
        fail(f"streams: sampler launches {counts['sample']} != {samples} sampling steps")
    marks, cancelled, active = reads["disconnect"]
    ticks_between = marks.get("release", 10**9) - marks.get("cancel", 0)
    log(f"  stream dropped 0.3 s after its headers: slot freed (active {active}, cancelled +{cancelled}); "
        f"ticks issued between the cancel and the release: {ticks_between}")
    if active != 0 or cancelled < 1 or "cancel" not in marks or ticks_between > 1:
        fail(f"the dropped stream's slot was not freed within one tick: {marks}, {cancelled}")
    (results, jcounts, jsamples, downgraded) = reads["json"]
    dfa = build_char_dfa(max_depth=4)
    parsed = limited = 0
    for st, body in results[:8]:
        if st != 200:
            fail(f"json_format request returned {st}: {body}")
        r = body["response"]
        if not r["length_limited"]:
            try:
                obj = json.loads(r["result"])
            except ValueError:
                fail(f"a finished JSON answer does not parse: {r['result']!r}")
            if not isinstance(obj, (dict, list)):
                fail(f"a JSON answer is not an object or array: {r['result']!r}")
            parsed += 1
        else:
            state = dfa.initial
            for b in r["result"].encode("utf-8"):
                state = int(dfa.table[state, b])
            if state == dfa.dead:
                fail(f"a length-limited JSON answer is not a live prefix: {r['result']!r}")
            limited += 1
    for (st, body, _), (sst, sbody, _) in zip(results[8:], reads["solo"]):
        if st != 200 or body["response"]["result"] != sbody["response"]["result"]:
            fail(f"a plain request beside JSON ones differs from its solo run: {body} vs {sbody}")
    log(f"  8 json_format requests at temperature 0.8 with 2 plain greedy ones: {parsed} parse, "
        f"{limited} length-limited (live prefixes); the plain ones equal their solo runs; "
        f"{downgraded} single-step JSON ticks; sampler launches {jcounts['sample']} for "
        f"{jsamples} sampling steps; paged launches {jcounts['paged_decode']}")
    if jcounts["sample"] != jsamples or downgraded <= 0:
        fail(f"json wave: sampler launches {jcounts['sample']} != {jsamples} sampling steps, "
             f"or no JSON tick ({downgraded})")
    g = reads["healthz"]["generators"][name]
    log(f"  /healthz stream block {json.dumps(g['stream'])}; json_downgraded_ticks "
        f"{g['json_downgraded_ticks']}")
    del engine, registry
    return counts


# --------------------------------------------------------------------- phase 8
SPEC_K, SPEC_N = 4, 4  # phase 11: speculative = 4, spec_width = 4
SPEC_RUNS = 3
# On one state (a prefix prefilled into pages) the verify path's logits are
# held within this many bf16 ulps of max|logit| of the plain decode step's:
# 3.00-4.12 were read at 8 positions, and the prefill path, another rounding
# of the same forward, lay 3.00-4.19 from it.  A spec / plain greedy
# divergence is flagged, not failed, where the plain path's top-two margin
# is within the verify path's distance read at that position.
VERIFY_DRIFT_ULPS = 5
SPEC_MAX_TOKENS = 256  # phase 11's answers: a RAG answer's length, not a probe's


def _quote_chats(n: int) -> list:
    """RAG-style chats that quote a passage: a system prompt, a ~1,200-
    character passage, and a question asking for a sentence of it."""
    chats = []
    for i in range(n):
        passage = _chat(1200, 500 + i)[0]["content"]
        first = passage[:160]
        chats.append([
            {"role": "system", "content": "Answer by quoting the passage word for word."},
            {"role": "user", "content": f"Passage: {passage}"},
            {"role": "user", "content": f"Quote the sentence that starts with: {first}"},
        ])
    return chats


def _bf16_ulp(x: float) -> float:
    import math

    return 2.0 ** (math.floor(math.log2(max(abs(x), 1e-30))) - 7)


def _by_family(per_kernel: dict) -> dict:
    """Device ms by kernel family: ``tree`` (paged_tree), ``gemm`` (cuBLAS /
    CUTLASS / nvjet products), ``sample`` (the sampler kernel), ``other``;
    and ``total``.  An :data:`EVENT_SPAN` reading has only a total: its
    families are nan (not measured)."""
    if EVENT_SPAN in per_kernel:
        nan = float("nan")
        return {"tree": nan, "gemm": nan, "sample": nan, "other": nan,
                "total": per_kernel[EVENT_SPAN]}
    out = {"tree": 0.0, "gemm": 0.0, "sample": 0.0, "other": 0.0}
    for name, ms in per_kernel.items():
        name = name.lower()
        if "paged_tree" in name:
            key = "tree"
        elif any(w in name for w in ("gemm", "nvjet", "cutlass", "xmma", "sm90_")):
            key = "gemm"
        elif "sample_kernel" in name:
            key = "sample"
        else:
            key = "other"
        out[key] += ms
    out["total"] = sum(out.values())
    return out


def verify_breakdown(cfg, params, label: str) -> None:
    """Where an eager verify step's device time goes at full width: 8 slots
    at paged decode's timed lengths, the longest row cut to leave the tree
    its room (10,198 live keys), each row's history
    repeating a motif, the (4, 4) tree: the drafter (``build_tree_draft`` +
    ``flatten_tree``), the verify forward (its tree attention, its GEMMs and
    the rest), the acceptance (the sampler's position-0 draw and the argmax
    work), the commit and the history / length updates, each by
    torch.profiler; the drafter's CUDA graph pool (one capture of it
    alone)."""
    import torch

    from django_assistant_bot_tpu_torch.models import llama
    from django_assistant_bot_tpu_torch.ops.sampling import gumbel_noise
    from django_assistant_bot_tpu_torch.ops.speculative import (
        accept_tree, build_tree_draft, flatten_tree, make_tree_spec)

    B, page, NB, S = 8, 512, 8, 4096
    spec = make_tree_spec(SPEC_N, SPEC_K)
    cache = llama.init_paged_cache(cfg, B, B * NB, page, device="cuda")
    start = torch.tensor([6, 512, 513, 1042, 1837, 4096 - 2 * (SPEC_K + 1), 1501, 701],
                         dtype=torch.int32, device="cuda")
    cache.lengths.copy_(start)
    bt = torch.arange(B * NB, dtype=torch.int32, device="cuda").reshape(B, NB)
    gen = torch.Generator(device="cuda").manual_seed(5)
    motif = torch.randint(1, 255, (37,), generator=gen, device="cuda", dtype=torch.int32)
    hist = motif.repeat(S // 37 + 1)[:S].repeat(B, 1).contiguous()
    tokens = hist[torch.arange(B, device="cuda"), start.long()].contiguous()
    depths = torch.from_numpy(spec.depths).cuda()
    anc = torch.from_numpy(spec.anc_mask).cuda()
    branch = torch.from_numpy(spec.branch_nodes).long().cuda()
    temps = torch.zeros(B, device="cuda")
    top_ps = torch.ones(B, device="cuda")
    noise = torch.empty((B, 50), device="cuda")
    gumbel_noise(noise, gen)
    active = torch.ones(B, dtype=torch.bool, device="cuda")
    state = {}

    def draft():
        state["tree"] = flatten_tree(tokens, build_tree_draft(hist, cache.lengths, tokens,
                                                              SPEC_N, SPEC_K))

    def verify():
        state["v"] = llama.verify_tree_step_paged(params, cfg, state["tree"], cache, bt, depths,
                                                  anc)

    def accept():
        state["a"] = accept_tree(state["v"][0], state["tree"], spec, temperature=temps,
                                 top_k=50, top_p=top_ps, gumbel=noise, branch=branch)

    def commit():
        out, n_new, bonus, path_idx = state["a"]
        llama.commit_tree_path_paged(cache, state["v"][1], state["v"][2], path_idx, bt, n_new,
                                     active)

    def step():
        cache.lengths.copy_(start)
        draft()
        verify()
        accept()
        commit()

    with torch.no_grad():
        step()
        parts = {"drafter": draft, "verify": verify, "accept": accept, "commit": commit}
        split = {k: _by_family(device_ms_by_kernel(fn, 10, warm=3)) for k, fn in parts.items()}
        whole = _by_family(device_ms_by_kernel(step, 10, warm=3))
        wall = [_sync_and_enqueue_ms(step, 10, 1) for _ in range(3)]
        n_new = state["a"][1]
        # the drafter alone as a CUDA graph: its pool is its intermediates
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            draft()
        torch.cuda.current_stream().wait_stream(side)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        r0 = torch.cuda.memory_reserved()
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            draft()
        pool = torch.cuda.memory_reserved() - r0
        ev = _event_span_ms(g.replay, 10)
        del g
    v = split["verify"]
    log(f"  {label}: eager verify step, 8 slots, (4, 4) tree, {int(start.sum())} live prefix "
        f"keys, full width: device time {whole['total']:.4f} ms; synchronised {_stat([w for w, _ in wall], 'ms')}, "
        f"host enqueue {_stat([e for _, e in wall], 'ms')}; drafts accepted a row on this "
        f"input "
        f"{n_new.float().mean().item() - 1:.2f}")
    log(f"    drafter {split['drafter']['total']:.4f} ms (its graph replay span "
        f"{_stat(ev, 'ms')}; the drafter's graph pool {pool / 2**20:.3f} MiB); verify forward "
        f"{v['total']:.4f} ms: tree attention {v['tree']:.4f} ms ({v['tree'] / cfg.num_layers:.4f} "
        f"a layer), GEMMs {v['gemm']:.4f} ms, the rest {v['other'] + v['sample']:.4f} ms; "
        f"acceptance {split['accept']['total']:.4f} ms (sampler {split['accept']['sample']:.4f} "
        f"ms); commit {split['commit']['total']:.4f} ms")


def _path_drift(cfg, params, prefix: list, tree_spec) -> tuple:
    """The logits for the token after ``prefix`` through three paths on one
    state: ``prefix[:-1]`` prefilled into a one-slot page table, then a
    verify step (the (N, K) tree rooted at ``prefix[-1]``; its root's row)
    and a plain decode step of ``prefix[-1]``; and ``prefill`` of the whole
    prefix.  Returns (the decode row, the verify row's and the prefill
    row's max |difference| from it in bf16 ulps of its max|logit|)."""
    import torch

    from django_assistant_bot_tpu_torch.models import llama

    page, NB = 512, 8
    dev = "cuda"

    def padded(ids):
        out = torch.zeros((1, -(-len(ids) // 64) * 64), dtype=torch.int32, device=dev)
        out[0, :len(ids)] = torch.tensor(ids, dtype=torch.int32)
        return out, torch.tensor([len(ids)], dtype=torch.int32, device=dev)

    with torch.no_grad():
        ids, n = padded(prefix[:-1])
        _, ks, vs = llama.prefill(params, cfg, ids, n)
        cache = llama.init_paged_cache(cfg, 1, NB, page, device=dev)
        bt = torch.arange(NB, dtype=torch.int32, device=dev)[None]
        llama.insert_sequences_paged(cache, ks, vs, n, torch.zeros(1, dtype=torch.int32,
                                                                   device=dev), bt)
        del ks, vs
        last = torch.tensor([prefix[-1]], dtype=torch.int32, device=dev)
        tree = last[:, None].repeat(1, len(tree_spec.depths))
        ver = llama.verify_tree_step_paged(
            params, cfg, tree, cache, bt, torch.from_numpy(tree_spec.depths).to(dev),
            torch.from_numpy(tree_spec.anc_mask).to(dev))[0][0, 0]
        dec = llama.decode_step_paged(params, cfg, last, cache, bt)[0][0]
        del cache
        ids, n = padded(prefix)
        pre = llama.prefill(params, cfg, ids, n)[0][0]
    ulp = _bf16_ulp(float(dec.abs().max()))
    return (dec, float((ver - dec).abs().max()) / ulp, float((pre - dec).abs().max()) / ulp)


def _spec_serve(card, cfg, engine, spec, key_msgs, label) -> tuple:
    """Register ``engine`` for ``spec`` (a spec engine's warmup times each
    rung's tick against the plain tick, then it starts), read
    ``probe_spec`` and each rung's graph span, serve ``key_msgs``
    concurrently over ``/dialog/`` ``SPEC_RUNS`` times (launch counts
    zeroed before each run and read after: ``paged_tree`` = 32 x verify
    steps, sampler = sampling steps), then submit them once more for their
    greedy ids.  A plain engine (``speculative`` 0) serves the same runs
    for its readings.  Returns (first run's launches, drafted in the runs,
    the ids)."""
    import aiohttp
    import torch
    from aiohttp import web

    from django_assistant_bot_tpu_torch import kernels
    from django_assistant_bot_tpu_torch.serving import ByteTokenizer
    from django_assistant_bot_tpu_torch.serving.registry import ModelRegistry
    from django_assistant_bot_tpu_torch.serving.server import create_app

    tok = ByteTokenizer()
    registry = ModelRegistry()
    t0 = time.perf_counter()
    registry.load(spec, engine=engine)  # warmup (the measured cost ratios), then start
    warmup_s = time.perf_counter() - t0
    if engine.speculative:
        rungs = engine._spec_ctl.rungs
        costs = dict(engine._spec_ctl.cost_ratio)
        probe = engine.probe_spec(iters=8)
        with engine._iter_lock:
            plain_span = _event_span_ms(engine._graph.replay, 10)
            spans = {r: _event_span_ms(engine._spec_graphs[r][0].replay, 10) for r in rungs}
            for t in (engine._cache.lengths, engine._tokens_dev, engine._toks_dev):
                t.zero_()
        log(f"  {label}: registry load with warmup and start {warmup_s:.2f} s [{card}]; warmup "
            "cost ratios " + ", ".join(f"{w}x{k} {r:.3f}" for (w, k), r in costs.items()))
        log(f"  {label}: probe_spec (slots idle, 8 ticks back to back): plain tick "
            f"{probe['plain_tick_s'] * 1e3:.4f} ms; " + "; ".join(
                f"{key}: {r['tick_s'] * 1e3:.4f} ms, cost ratio {r['cost_ratio']:.3f}, "
                f"breakeven accept rate {r['breakeven_accept_rate']:.3f}"
                for key, r in probe["rungs"].items()))
        log(f"  {label}: graph spans (CUDA events around one replay, slots idle): plain "
            f"1-step tick {_stat(plain_span, 'ms')}; " + "; ".join(
                f"{w}x{k} verify tick {_stat(sp, 'ms')}" for (w, k), sp in spans.items()))
    port = _free_port()
    name = spec.name

    def spec_counters():
        return (engine.spec_drafted, engine.spec_accepted, engine.spec_ticks_issued,
                engine.spec_row_steps, engine.steps, sampling_steps(engine), engine._ticks_issued)

    async def drive():
        runner = web.AppRunner(create_app(registry))
        await runner.setup()
        await web.TCPSite(runner, "127.0.0.1", port).start()
        try:
            async with aiohttp.ClientSession() as session:
                st, body, _ = await _post(session, port, name, _chat(300, 99))  # warm
                if st != 200:
                    fail(f"warm-up /dialog/ returned {st}: {body}")
                runs = []
                for _ in range(SPEC_RUNS):
                    torch.cuda.synchronize()
                    kernels.reset_counts()
                    c0 = spec_counters()
                    t = time.perf_counter()
                    res = await asyncio.gather(*(_post(session, port, name, m, SPEC_MAX_TOKENS)
                                                 for _, m in key_msgs))
                    wall = time.perf_counter() - t
                    torch.cuda.synchronize()
                    runs.append(dict(results=res, wall=wall, counts=kernels.launch_counts(),
                                     routes=kernels.by_route(kernels.PAGED_TREE_FORMS),
                                     delta=[b - a for a, b in zip(c0, spec_counters())]))
                futs = [engine.submit(tok.encode_chat(m), max_tokens=SPEC_MAX_TOKENS,
                                      temperature=0.0) for _, m in key_msgs]
                return runs, [f.result(timeout=600).token_ids for f in futs]
        finally:
            await runner.cleanup()  # stops the registry's engine

    runs, ids = asyncio.run(drive())
    all_ttfts, all_rates, drafted_all = [], [], 0
    for i, run in enumerate(runs):
        check = _check_dialogs if i == 0 else _quiet_check
        ttfts, rates, _ = check(tok, key_msgs, run["results"], SPEC_MAX_TOKENS)
        all_ttfts += ttfts
        all_rates += rates
        drafted, accepted, ticks, row_steps, steps, samples, all_ticks = run["delta"]
        drafted_all += drafted
        counts = run["counts"]
        verify_steps = ticks * engine.decode_steps
        spec_text = (f"{ticks} spec ticks, drafted {drafted}, accepted {accepted} (accept rate "
                     f"{accepted / max(1, drafted):.4f}), tokens a verify step per greedy row "
                     f"{(accepted + row_steps) / max(1, row_steps):.3f}; " if engine.speculative
                     else "")
        log(f"  {label} run {i + 1}: {len(key_msgs)} concurrent requests in {run['wall']:.3f} s; "
            f"{steps - verify_steps} plain steps in {all_ticks - ticks} plain ticks; {spec_text}"
            f"launches paged_tree {counts['paged_tree']} (routes {run['routes']}), paged_decode "
            f"{counts['paged_decode']}, flash_prefill {counts['flash_prefill']}, sample "
            f"{counts['sample']} for {samples} sampling steps")
        if counts["paged_tree"] != cfg.num_layers * verify_steps:
            fail(f"{label}: paged_tree launches {counts['paged_tree']} != {cfg.num_layers} x "
                 f"{verify_steps} verify steps")
        if run["routes"]["cuda_core"]:
            fail(f"{label}: a bf16 verify step left the tensor-core tree kernel: {run['routes']}")
        if counts["sample"] != samples:
            fail(f"{label}: sampler launches {counts['sample']} != {samples} sampling steps")
    log(f"  {label} readings over {SPEC_RUNS} runs of the eight requests [{card}]: TTFT "
        f"{_stat(all_ttfts)}; decode {_stat(all_rates, 'tok/s')} per request; run wall "
        f"{_stat([r['wall'] for r in runs])}")
    if not engine.speculative:
        return runs[0]["counts"], 0, ids
    st = engine.spec_stats()
    log(f"  {label}: cumulative drafted {st['spec_drafted']}, accepted "
        f"{st['spec_accepted']} (rate {st['spec_accept_rate']}), spec ticks {st['spec_ticks']}, "
        f"plain ticks by the controller {st['spec_skipped_accept']}, by load "
        f"{st['spec_skipped_load']}; controller "
        + json.dumps({k: st[k] for k in ("spec_tree_width", "spec_tree_depth",
                                         "spec_auto_disabled", "spec_expected_speedup",
                                         "spec_rung_accept_emas")}))
    return runs[0]["counts"], drafted_all, ids


def spec_phase(card: str, cfg, params) -> dict:
    """Tree-verified speculative decoding at full width over phase 4's bf16
    Llama-3-8B tensors (phase 7's head, its columns past the byte ids
    zeroed), behind ``create_app``: phase 4's four requests and four
    RAG-style chats that quote a passage, each asking for
    ``SPEC_MAX_TOKENS`` (:func:`_spec_serve`), on

    1. the registry's spec engine, ``ModelSpec(speculative = 4, spec_width =
       4, warmup = True)``: the acceptance-EMA controller as users get it
       (it turns speculation off where acceptance cannot pay for a verify
       forward, and re-probes every 64 ticks);
    2. the same engine with ``spec_probe_every = 1``: a disabled controller
       re-probes every tick, so every tick verifies a tree; its greedy ids
       against a plain engine's (the default loop): equal, but for a
       divergence at a position where the plain path's top two logits
       lie within the verify path's distance from it there, flagged and
       counted; at each request's divergence (or last token) the three
       paths on one state (:func:`_path_drift`), the verify path held
       within ``VERIFY_DRIFT_ULPS`` of the plain decode step;

    then :func:`verify_breakdown`.  Fails unless the first engine drafted.
    Returns engine 1's first run's launches."""
    import torch

    from django_assistant_bot_tpu_torch.ops.speculative import make_tree_spec
    from django_assistant_bot_tpu_torch.serving import ByteTokenizer, GenerationEngine
    from django_assistant_bot_tpu_torch.serving.registry import ModelSpec

    tok = ByteTokenizer()
    key_msgs = list(four_requests(tok).items()) + [
        (f"q{i}", m) for i, m in enumerate(_quote_chats(4))]
    log(f"  card memory at the start: {torch.cuda.memory_allocated() / 2**30:.3f} GiB allocated")
    name = "llama3-8b-spec"
    spec = ModelSpec(name=name, device="cuda", max_slots=8, max_seq_len=4096,
                     speculative=SPEC_K, spec_width=SPEC_N, warmup=True)
    results = {}
    for label, extra in (("spec (registry defaults)", {}),
                         ("spec (probe every tick)", {"spec_probe_every": 1})):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        engine = GenerationEngine(cfg, params, tok, device="cuda", **spec.engine_kwargs(),
                                  **extra)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        rungs = engine._spec_ctl.rungs
        log(f"  {label}: engine (K {SPEC_K}, N {SPEC_N}; rungs {rungs}) built in {build_s:.2f} s "
            f"with {engine.graph_captures} graphs (the plain 1-step tick and a verify tick a "
            f"rung), graph pool {engine.graph_pool_bytes / 2**20:.1f} MiB")
        if not (engine.decode_steps == 1 and not engine.prefill_piggyback
                and set(engine._spec_graphs) == set(rungs)
                and engine.graph_captures == 1 + len(rungs)):
            fail(f"{label}: the spec engine is not at its defaults: decode_steps "
                 f"{engine.decode_steps}, piggyback {engine.prefill_piggyback}, graphs "
                 f"{sorted(engine._spec_graphs)}")
        results[label] = _spec_serve(card, cfg, engine, spec, key_msgs, label)
        del engine
        gc_collect()
    (first, drafted, _), (_, forced_drafted, spec_ids) = results.values()
    if drafted <= 0 or forced_drafted <= 0:
        fail(f"a spec engine drafted nothing on the main path: {drafted}, {forced_drafted}")

    # the plain engine (the default loop) on the same requests: its
    # readings beside the spec engines', and the ids the spec ids are held to
    plain_spec = ModelSpec(name=name, device="cuda", max_slots=8, max_seq_len=4096,
                           warmup=True)
    plain = GenerationEngine(cfg, params, tok, device="cuda", **plain_spec.engine_kwargs())
    _, _, plain_ids = _spec_serve(card, cfg, plain, plain_spec, key_msgs,
                                  "plain (the default loop)")
    del plain
    gc_collect()
    # each request's next token at its first divergence (or its last token)
    # through the three paths on one state: the plain path's top-two margin
    # there, and how far the verify and prefill paths' logits lie from it
    tree_spec = make_tree_spec(SPEC_N, SPEC_K)
    flagged, drifts = 0, []
    for (key, msgs), a, b in zip(key_msgs, spec_ids, plain_ids):
        pos = next((j for j, (x, y) in enumerate(zip(a, b)) if x != y), min(len(a), len(b)))
        if a != b and pos >= min(len(a), len(b)):
            fail(f"spec vs plain ({key}): one stops early without a divergence: {a} vs {b}")
        at = pos if a != b else len(b) - 1
        dec, d_v, d_p = _path_drift(cfg, params, tok.encode_chat(msgs) + b[:at], tree_spec)
        drifts.append((d_v, d_p))
        if a == b:
            continue
        top2 = torch.topk(dec, 2).values
        margin = float(top2[0] - top2[1]) / _bf16_ulp(float(dec.abs().max()))
        log(f"  spec vs plain ({key}): greedy ids diverge at token {pos} of {min(len(a), len(b))} "
            f"(spec {a[pos]}, plain {b[pos]}); the plain path's top-two margin there "
            f"{margin:.2f} bf16 ulps of max|logit|; the verify path's logits {d_v:.2f} from it "
            f"there (the prefill path's {d_p:.2f})")
        if margin > d_v:
            fail(f"spec vs plain ({key}): an unflagged greedy divergence at token {pos} "
                 f"(margin {margin:.2f} ulps, past the verify path's {d_v:.2f})")
        flagged += 1
    log(f"  spec (probe every tick) vs plain greedy ids: {len(key_msgs) - flagged} of "
        f"{len(key_msgs)} identical, {flagged} flagged near-tie divergences")
    v_max, p_max = max(d for d, _ in drifts), max(d for _, d in drifts)
    log(f"  one state, three paths ({len(drifts)} positions): the verify path's logits at most "
        f"{v_max:.2f} bf16 ulps of max|logit| from the plain decode step's (per position "
        + ", ".join(f"{d:.2f}" for d, _ in drifts) + f"), the prefill path's at most {p_max:.2f} "
        "(" + ", ".join(f"{d:.2f}" for _, d in drifts) + f"); held within {VERIFY_DRIFT_ULPS}")
    if v_max > VERIFY_DRIFT_ULPS:
        fail(f"the verify path's logits lie {v_max:.2f} bf16 ulps from the plain decode step's "
             f"on one state (held within {VERIFY_DRIFT_ULPS})")
    verify_breakdown(cfg, params, "spec breakdown")
    gc_collect()
    log(f"  card memory at the end: {torch.cuda.memory_allocated() / 2**30:.3f} GiB allocated")
    return first


# phase 12: the engines on fp8 pools (kv_cache_dtype, attn_fp8) and their runs
FP8_ENGINES = (("fp8", False), ("fp8", True), ("fp8_e5m2", False))
FP8_RUNS = 5


def fp8_logits_cosine(cfg, params) -> None:
    """One decode step's logits from identical prefills (a 480-token prompt
    prefilled once, its K/V written into a bf16 pool and into each fp8
    pool): cosine against the bf16 pool's at least 0.98 for every fp8 pool
    and read (the JAX contract of tests/test_serving.py:903)."""
    import torch

    from django_assistant_bot_tpu_torch.models import llama
    from django_assistant_bot_tpu_torch.ops.quant import KV_CACHE_DTYPES

    ids = torch.randint(1, 255, (1, 512), generator=torch.Generator().manual_seed(21),
                        dtype=torch.int32).cuda()
    lengths = torch.tensor([480], dtype=torch.int32, device="cuda")
    with torch.no_grad():
        _, ks, vs = llama.prefill(params, cfg, ids, lengths)
        out = {}
        for kv, attn in ((None, False),) + FP8_ENGINES:
            cache = llama.init_paged_cache(cfg, 1, 2, 512, dtype=KV_CACHE_DTYPES[kv],
                                           device="cuda")
            bt = torch.tensor([[0, 1]], dtype=torch.int32, device="cuda")
            llama.insert_sequences_paged(cache, ks, vs, lengths,
                                         torch.zeros((1,), dtype=torch.int32, device="cuda"), bt)
            step, _ = llama.decode_step_paged(
                params, cfg, torch.tensor([5], dtype=torch.int32, device="cuda"), cache, bt,
                attn_fp8=attn)
            out[(kv, attn)] = step[0].float()
            del cache
    base = out[(None, False)]
    for kv, attn in FP8_ENGINES:
        a = out[(kv, attn)]
        cos = float(torch.dot(a, base) / (a.norm() * base.norm()))
        log(f"  one decode step's logits from identical prefills, {kv} pool"
            f"{' in-dot' if attn else ''} vs the bf16 pool: cosine {cos:.6f}, max |diff| "
            f"{(a - base).abs().max().item():.4f} (max |logit| {base.abs().max().item():.4f}), "
            f"argmax {'equal' if int(a.argmax()) == int(base.argmax()) else 'differs'}")
        if not cos >= 0.98:
            fail(f"{kv} pool (attn_fp8 {attn}): logits cosine {cos} < 0.98 against the bf16 pool")


def fp8_phase(card: str, cfg, params) -> dict:
    """fp8 KV pools at full width over phase 4's bf16 Llama-3-8B tensors
    (phase 7's head): first :func:`fp8_logits_cosine`; then, for
    ``kv_cache_dtype="fp8"`` (dequant read, then ``attn_fp8``) and
    ``"fp8_e5m2"``, an engine at the JAX ``ModelSpec`` defaults serving
    phase 4's four requests ``FP8_RUNS`` times over /dialog/: the pool's
    bytes half phase 4's, paged launches = 32 x decode steps, every one on
    the pool's read of the tensor-core kernel (``kernels.PAGED_FORMS``),
    TTFT and tok/s per request beside phase 4's, and the decode breakdown
    (the eager step on a pool of the engine's dtype and read, the replayed
    8-step tick) beside phase 4's; last a spec engine (K 4, N 4, every tick
    verifying) on an fp8 pool for one run: tree launches on the fp8 read.
    Returns each kernel form's launches on its engine's first run."""
    import torch

    from django_assistant_bot_tpu_torch.serving import ByteTokenizer, GenerationEngine
    from django_assistant_bot_tpu_torch.serving.registry import ModelSpec

    t0 = time.perf_counter()
    fp8_logits_cosine(cfg, params)
    log(f"  (cosine check {time.perf_counter() - t0:.1f} s)")
    tok = ByteTokenizer()
    messages = four_requests(tok)
    name = "llama3-8b-fp8"
    launches = {}
    b4 = PHASE4["breakdown"]
    for kv, attn in FP8_ENGINES:
        t0 = time.perf_counter()
        fmt = "e4m3" if kv == "fp8" else "e5m2"
        form = f"mma:{fmt}/{'in_dot' if attn else 'dequant'}"
        label = f"{kv}{' attn_fp8' if attn else ''}"
        spec = ModelSpec(name=name, device="cuda", max_slots=8, max_seq_len=4096,
                         kv_cache_dtype=kv, attn_fp8=attn)
        engine, build_s = _build_engine(cfg, params, spec)
        pb = pool_bytes(engine)
        if pb * 2 != PHASE4["pool_bytes"]:
            fail(f"{label}: pool {pb} bytes, not half of phase 4's {PHASE4['pool_bytes']}")
        runs = _serve(spec, engine, [list(messages.values())] * FP8_RUNS)
        first = runs[0]
        counts, forms, steps = first["counts"], first["forms"], first["steps"]
        ttfts, rates = [], []
        for run in runs:
            t, r, _ = _check_dialogs(tok, list(messages.items()), run["results"])
            ttfts += t
            rates += r
        log(f"  {label}: pool {engine._cache.k.dtype}, {pb / 1e9:.3f} GB against phase 4's bf16 "
            f"{PHASE4['pool_bytes'] / 1e9:.3f} GB; engine built in {build_s:.2f} s; first run: "
            f"{counts['paged_decode']} paged launches for {steps} decode steps "
            f"({counts['paged_decode'] / max(1, steps):g} a step), {form} {forms[form]}")
        if counts["paged_decode"] != cfg.num_layers * steps or steps <= 0:
            fail(f"{label}: paged launches {counts['paged_decode']} != {cfg.num_layers} x "
                 f"{steps} decode steps")
        if forms[form] != counts["paged_decode"]:
            fail(f"{label}: paged launches left the {form} read: {forms}")
        check_prefill_launches(f"phase 12, {label}", counts["paged_prefill"],
                               first["suffix_forwards"] + first["piggybacked"], cfg.num_layers,
                               first["prefill_forms"], f"mma:{fmt}/dequant")
        log(f"  {label} readings over {len(runs)} runs of the four requests [{card}]: TTFT "
            f"{_stat(ttfts)} (phase 4's bf16 pool: {_stat(PHASE4['ttfts'])}); decode "
            f"{_stat(rates, 'tok/s')} per request (phase 4: {_stat(PHASE4['rates'], 'tok/s')}); "
            f"run wall {_stat([r['wall'] for r in runs])}")
        br = decode_breakdown(cfg, params, engine, label=f"{label}: ",
                              kv_dtype=engine.kv_cache_dtype, attn_fp8=attn, batches=3,
                              chunk=False)
        log(f"  {label} against phase 4's bf16 pool, per decode step: replayed 8-step tick "
            f"{br['replay_ms']:.4f} ms (bf16 {b4['replay_ms']:.4f}; graph span "
            f"{br['span_ms']:.4f} vs {b4['span_ms']:.4f}); eager step's paged kernels device "
            f"{br['paged_ms']:.4f} ms (bf16 {b4['paged_ms']:.4f}), all kernels "
            f"{br['device_ms']:.4f} ms (bf16 {b4['device_ms']:.4f})")
        launches[form] = counts["paged_decode"]
        del engine
        gc_collect()
        log(f"  ({label}: {time.perf_counter() - t0:.1f} s)")
    t0 = time.perf_counter()
    spec = ModelSpec(name=name, device="cuda", max_slots=8, max_seq_len=4096,
                     kv_cache_dtype="fp8", speculative=SPEC_K, spec_width=SPEC_N)
    engine = GenerationEngine(cfg, params, tok, device="cuda", **spec.engine_kwargs(),
                              spec_probe_every=1)
    (run,) = _serve(spec, engine, [list(messages.values())])
    _check_dialogs(tok, list(messages.items()), run["results"])
    tree, tforms = run["counts"]["paged_tree"], run["tree_forms"]
    log(f"  spec engine (K {SPEC_K}, N {SPEC_N}, every tick verifying) on an fp8 pool, one run "
        f"of the four requests: {tree} paged_tree launches, mma:e4m3/dequant "
        f"{tforms['mma:e4m3/dequant']}; drafted {engine.spec_drafted}, accepted "
        f"{engine.spec_accepted}")
    if tree <= 0 or tforms["mma:e4m3/dequant"] != tree:
        fail(f"the fp8 spec engine's tree reads left the fp8 form: {tforms}")
    launches["tree:mma:e4m3/dequant"] = tree
    del engine
    gc_collect()
    log(f"  (the fp8 spec engine: {time.perf_counter() - t0:.1f} s)")
    return launches


def _quiet_check(tok, key_msgs, results, max_tokens=32) -> tuple:
    """:func:`_check_dialogs` without its per-request lines."""
    import contextlib
    import io

    with contextlib.redirect_stdout(io.StringIO()):
        return _check_dialogs(tok, key_msgs, results, max_tokens)


def _projection_shapes(cfg) -> list:
    """A layer's projections (in, out): wq, wk, wv, wo, gate, up, down."""
    E, F = cfg.hidden_size, cfg.intermediate_size
    HD, KD = cfg.num_heads * cfg.head_dim, cfg.num_kv_heads * cfg.head_dim
    return [(E, HD), (E, KD), (E, KD), (HD, E), (E, F), (E, F), (F, E)]


def projection_bytes(cfg, fmt: str, group: int = 64) -> int:
    """Bytes of the layer projections of ``cfg`` at ``fmt``: bf16 (2 bytes a
    weight), or the integers (1 byte a weight, or 0.5 packed) and their f32
    scales (per output column, or per ``group`` rows and column)."""
    L, shapes = cfg.num_layers, _projection_shapes(cfg)
    if fmt == "bf16":
        return L * sum(2 * K * N for K, N in shapes)
    if fmt == "int8":
        return L * sum(K * N + 4 * N for K, N in shapes)
    return L * sum(K * N // 2 + 4 * (K // group) * N for K, N in shapes)


# phase 8's engines: (label, init's format, int4 group); int4 g8 is the
# generic route's main path.  Each reads the four requests QUANT_RUNS times,
# the first run counted (4, not 6 since the third engine: the smoke's time)
QUANT_ENGINES = [("int8", "int8", 64), ("int4", "int4", 64), ("int4_g8", "int4", 8)]
QUANT_RUNS = 4
QUANT_ARGMAX_TOKENS = 300  # the g8 engine's prefill held to the plain-twin forward


def plain_forward_check(cfg, params, label: str) -> None:
    """One ``QUANT_ARGMAX_TOKENS``-token prefill of the quantized params on the
    card through the qgemm kernel, then the same forward with ``qeinsum_plain``
    (the JAX numerics in plain PyTorch) in place of every kernel call: the
    last-token logits' argmax must agree and their cosine reach
    ``QUANT_MIN_COSINE``; the max abs error is printed."""
    import torch

    from django_assistant_bot_tpu_torch import kernels
    from django_assistant_bot_tpu_torch.models import llama
    from django_assistant_bot_tpu_torch.ops import quant

    gen = torch.Generator(device="cuda").manual_seed(31)
    ids = torch.randint(1, 255, (1, QUANT_ARGMAX_TOKENS), generator=gen, device="cuda",
                        dtype=torch.int32)
    lengths = torch.tensor([QUANT_ARGMAX_TOKENS], dtype=torch.int32, device="cuda")
    with torch.no_grad():
        before = kernels.launch_counts()["qgemm"]
        logits = llama.prefill(params, cfg, ids, lengths)[0].float()
        kernel_calls = kernels.launch_counts()["qgemm"] - before
        orig = (llama.qeinsum, llama.qeinsum_group)
        llama.qeinsum = quant.qeinsum_plain
        llama.qeinsum_group = lambda p, x, ws, dt: [quant.qeinsum_plain(p, x, w, dt) for w in ws]
        try:
            before = kernels.launch_counts()["qgemm"]
            plain = llama.prefill(params, cfg, ids, lengths)[0].float()
            plain_calls = kernels.launch_counts()["qgemm"] - before
        finally:
            llama.qeinsum, llama.qeinsum_group = orig
        torch.cuda.synchronize()
    err = (logits - plain).abs().max().item()
    cos = torch.nn.functional.cosine_similarity(logits, plain, dim=-1).min().item()
    same = bool(torch.equal(logits.argmax(-1), plain.argmax(-1)))
    log(f"  {label} {QUANT_ARGMAX_TOKENS}-token prefill, last-token logits: kernel "
        f"({kernel_calls} qgemm launches) vs qeinsum_plain patched in ({plain_calls} launches): "
        f"max_abs_err {err:.4e}, cosine {cos:.6f}, argmax {'equal' if same else 'DIFFERS'}")
    if not (same and cos >= QUANT_MIN_COSINE and kernel_calls == 7 * cfg.num_layers
            and plain_calls == 0 and bool(torch.isfinite(logits).all())):
        fail(f"{label}: the prefill's argmax, cosine ({cos:.6f} against {QUANT_MIN_COSINE}) or "
             f"launches disagree with the plain-twin forward")


def quant_phase(card: str) -> dict:
    """Llama-3-8B (32 layers, full width) from ``init_int8``, then (freed)
    from ``init_int4`` at group 64 and at group 8 (``QUANT_ENGINES``), each
    behind ``/dialog/`` in a ``ModelRegistry`` / ``create_app`` server with
    ``quantize`` (and ``quant_group_size``) set, at the default loop.
    Phase 4's four requests, 32 greedy tokens each: launch counts zeroed
    just before and read just after; every request completes; qgemm
    launches = 4 x 32 per decode step (the stream kernel: QKV and gate/up
    one launch each) plus 7 x 32 per prefill forward (the wgmma kernel), and
    at group 8 7 x 32 per decode step and per prefill forward, all on the
    generic route (``qgemm_generic_kernel``); ``weight_bits`` 8 / 4 in
    ``/healthz`` and ``/metrics``; the projection bytes on the card as
    computed; at group 8 a prefill's argmax against the plain-twin forward
    (:func:`plain_forward_check`).  Readings over the counted run and the
    runs after it (medians and spreads): TTFT, decode tok/s per request;
    then the decode breakdown (the eager step profiled, the replayed tick
    per step), and the g8 step's ratio to int8's.  Returns the qgemm
    launches of each engine's counted run by kernel: ``decode`` (the
    stream kernel) and ``prefill`` (wgmma), or ``generic``."""
    import aiohttp
    import torch
    from aiohttp import web

    from django_assistant_bot_tpu_torch import kernels
    from django_assistant_bot_tpu_torch.models import DecoderConfig, llama
    from django_assistant_bot_tpu_torch.ops.quant import QuantizedWeight
    from django_assistant_bot_tpu_torch.serving import ByteTokenizer
    from django_assistant_bot_tpu_torch.serving.obs import parse_prometheus_text
    from django_assistant_bot_tpu_torch.serving.registry import ModelRegistry, ModelSpec
    from django_assistant_bot_tpu_torch.serving.server import create_app

    cfg = DecoderConfig.llama3_8b()
    tok = ByteTokenizer()
    messages = four_requests(tok)
    launches, replay = {}, {}
    for label, fmt, group in QUANT_ENGINES:
        init = llama.init_int8 if fmt == "int8" else llama.init_int4
        generic = fmt == "int4" and group % 16 != 0
        gc_collect()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        alloc0 = torch.cuda.memory_allocated()
        kw = {"group_size": group} if fmt == "int4" else {}
        params = init(cfg, torch.Generator(device="cuda").manual_seed(21), "cuda", **kw)
        torch.cuda.synchronize()
        alloc = torch.cuda.memory_allocated() - alloc0
        proj = [w for w in params["layers"].values() if isinstance(w, QuantizedWeight)]
        on_card = sum(w.nbytes for w in proj)
        dense = sum(t.numel() * t.element_size() for t in
                    [params["tok_embed"], params["lm_head"], params["final_norm"],
                     params["layers"]["attn_norm"], params["layers"]["mlp_norm"]])
        want = projection_bytes(cfg, fmt, group)
        weights = cfg.num_layers * sum(K * N for K, N in _projection_shapes(cfg))
        log(f"  {label} Llama-3-8B from init_{fmt}{f' (group {group})' if fmt == 'int4' else ''} "
            f"in {time.perf_counter() - t0:.1f} s: projection bytes on the card {on_card} "
            f"(computed {want}, {want / weights:.4f} bytes a weight; bf16 "
            f"{projection_bytes(cfg, 'bf16')}), dense leaves {dense}, allocated {alloc} "
            f"({alloc - on_card - dense} above the leaves)")
        if on_card != want or not 0 <= alloc - on_card - dense <= 2 << 20:
            fail(f"{label} weight bytes on the card: {on_card} (want {want}), allocated {alloc}")
        if generic:
            plain_forward_check(cfg, params, label)
        name = f"llama3-8b-{label.replace('_', '-')}-random"
        spec = ModelSpec(name=name, device="cuda", max_slots=8, max_seq_len=4096, quantize=fmt,
                         **({"quant_group_size": group} if fmt == "int4" else {}))
        engine, build_s = _build_engine(cfg, params, spec)
        registry = ModelRegistry()
        registry.load(spec, engine=engine)
        port = _free_port()
        forwards = [0]
        wrapped = {}
        for fn_name in ("prefill", "prefill_suffix_paged"):
            orig = getattr(llama, fn_name)

            def counted(*a, _orig=orig, **kw):
                forwards[0] += 1
                return _orig(*a, **kw)

            wrapped[fn_name] = orig
            setattr(llama, fn_name, counted)

        async def drive():
            runner = web.AppRunner(create_app(registry))
            await runner.setup()
            await web.TCPSite(runner, "127.0.0.1", port).start()
            try:
                async with aiohttp.ClientSession() as session:
                    st, body, _ = await _post(session, port, name, _chat(300, 99))
                    if st != 200:
                        fail(f"{label} warm-up /dialog/ returned {st}: {body}")
                    runs = []
                    for _ in range(QUANT_RUNS):  # the first counted, all read
                        torch.cuda.synchronize()
                        kernels.reset_counts()
                        forwards[0] = 0
                        steps0, pig0 = engine.steps, engine._prefill_chunks_piggybacked
                        samp0 = sampling_steps(engine)
                        t = time.perf_counter()
                        res = await asyncio.gather(*(_post(session, port, name, m)
                                                     for m in messages.values()))
                        wall = time.perf_counter() - t
                        runs.append(dict(results=res, wall=wall, counts=kernels.launch_counts(),
                                         formats=dict(kernels.QGEMM_FORMATS),
                                         routes=dict(kernels.QGEMM_ROUTES),
                                         samples=sampling_steps(engine) - samp0,
                                         steps=engine.steps - steps0, forwards=forwards[0]
                                         + engine._prefill_chunks_piggybacked - pig0))
                    health = await (await session.get(f"http://127.0.0.1:{port}/healthz")).json()
                    text = await (await session.get(f"http://127.0.0.1:{port}/metrics")).text()
                    return runs, health, parse_prometheus_text(text)
            finally:
                await runner.cleanup()

        try:
            runs, health, fams = asyncio.run(drive())
        finally:
            for fn_name, orig in wrapped.items():
                setattr(llama, fn_name, orig)
        first = runs[0]
        ttfts, rates = [], []
        for run in runs:
            t, r, _ = _check_dialogs(tok, list(messages.items()), run["results"])
            ttfts += t
            rates += r
        counts, steps, fwd = first["counts"], first["steps"], first["forwards"]
        # a decode step (8 rows) takes 4 stream launches a layer (QKV, wo,
        # gate/up, down) and a prefill forward (past 64 rows) 7 wgmma ones;
        # at group 8 each projection is its own generic launch, 7 a layer
        per_step = 7 if generic else 4
        want_dec, want_pre = per_step * cfg.num_layers * steps, 7 * cfg.num_layers * fwd
        want_q = want_dec + want_pre
        routes = first["routes"]
        log(f"  {label} main path on {card}: launches {counts}, by format {first['formats']}, "
            f"by route {routes}; {steps} decode steps, {fwd} prefill forwards: qgemm "
            f"{counts['qgemm']} ({per_step} x {cfg.num_layers} x {steps} + 7 x {cfg.num_layers} "
            f"x {fwd} = {want_q})")
        if counts["qgemm"] != want_q or first["formats"][fmt] != want_q:
            fail(f"{label}: qgemm launches {counts['qgemm']} != {per_step} x {cfg.num_layers} x "
                 f"{steps} steps + 7 x {cfg.num_layers} x {fwd} prefill forwards")
        if generic:
            if routes["generic"] != want_q or routes["stream"] or routes["wgmma"] or \
                    routes["mma"] or routes["cuda_core"]:
                fail(f"{label}: qgemm routes {routes}: want every launch ({want_q}) on the "
                     f"generic route")
        elif (routes["stream"], routes["wgmma"]) != (want_dec, want_pre) or routes["mma"] or \
                routes["cuda_core"] or routes["generic"]:
            fail(f"{label}: qgemm routes {routes}: want every decode launch on the stream kernel "
                 f"({want_dec}) and every prefill launch on the wgmma kernel ({want_pre})")
        if counts["paged_decode"] != cfg.num_layers * steps or counts["flash_prefill"] <= 0:
            fail(f"{label}: paged or flash launches wrong: {counts}")
        if counts["sample"] != first["samples"]:
            fail(f"{label}: sampler launches {counts['sample']} != {first['samples']} sampling "
                 f"steps")
        bits = {"int8": 8, "int4": 4}[fmt]
        gauge = [v for _, lab, v in fams.get("dabt_weight_bits", {}).get("samples", [])
                 if lab.get("model") == name]
        hz = health["generators"][name]["weight_bits"]
        log(f"  {label} weight_bits: /healthz {hz}, /metrics dabt_weight_bits {gauge}; engine "
            f"built in {build_s:.2f} s, graph pool {engine.graph_pool_bytes / 2**20:.1f} MiB")
        if hz != bits or gauge != [float(bits)]:
            fail(f"{label}: weight_bits /healthz {hz}, /metrics {gauge}, want {bits}")
        log(f"  {label} readings over {len(runs)} runs of the four requests [{card}]: TTFT "
            f"{_stat(ttfts)}; decode {_stat(rates, 'tok/s')} per request; run wall "
            f"{_stat([r['wall'] for r in runs])}")
        replay[label] = decode_breakdown(cfg, params, engine, label=f"{label} ")["replay_ms"]
        launches[label] = ({"generic": routes["generic"]} if generic else
                           {"decode": routes["stream"], "prefill": routes["wgmma"]})
        del engine, registry, params, proj
        gc_collect()
    log(f"  replayed step per token, int4 g8 {replay['int4_g8']:.4f} ms against int8 "
        f"{replay['int8']:.4f} ms on this card: {replay['int4_g8'] / replay['int8']:.3f}x "
        f"(int4 g64 {replay['int4']:.4f} ms)")
    return launches


# --------------------------------------------------------------------- phase 9
def ann_phase(card: str) -> tuple:
    """ANN retrieval at scale: 2,000,000 x 768 built through ``ANNIndex.add``
    and ``train()`` at the auto geometry (wall time of the add, the train and
    its stages; bytes of the codes and the rerank tier on the card; rows
    [4096, 8192) repeat rows [0, 4096), for the kernel checks' ties); phase
    2's ANN kernel checks on it (:func:`check_ann`); 64 planted
    near-duplicate queries of rows past the duplicated ones; search latency over 6 batches at Q 1, 8
    and 32, k 16 (medians and min-max), ANN ``search_batch`` at the default
    nprobe beside the exact tier on the same rows (``_exact_batch``, the KNN
    kernel); fails unless each planted query finds its source row top-1 in
    >= 99% of them, ``ann_adc`` and ``ann_rerank`` each launched once per
    ANN search batch with no call of a plain twin, and ``knn_topk`` ran for
    the exact tier.  Then a recall@10 curve against the exact tier at
    nprobe 16, 64, 256 and 1024 with the ANN search's ms per query and the
    card's peak memory over each point above what the index holds (beside
    the [Q, P L] f32 score scratch the padded scan needed at the recall
    probe's query bucket of 128), and :func:`durability_drill`.  Returns
    (the kernels' JSON entries, their launches)."""
    import numpy as np
    import torch

    from django_assistant_bot_tpu_torch import kernels
    from django_assistant_bot_tpu_torch.storage import ann as ann_mod
    from django_assistant_bot_tpu_torch.storage import knn as knn_mod

    index, t = ann_build(ANN_ROWS, ANN_DIM, seed=21, dups=ANN_DUPS)
    log(f"  corpus {ANN_ROWS} x {ANN_DIM} ({ANN_DUPS} duplicated rows) through add + train(): "
        f"wall s: {_timing_text(t)}")
    log(f"  {ann_geometry(index)}; card memory {torch.cuda.memory_allocated() / 2**30:.2f} "
        "GiB allocated")
    entries = check_ann(index)
    rng = np.random.default_rng(9)
    # planted sources past the duplicated rows: each has one top-1 row
    src = 2 * ANN_DUPS + rng.choice(ANN_ROWS - 2 * ANN_DUPS, size=ANN_PLANTED, replace=False)
    planted = (index._mat[src] + ANN_QUERY_NOISE
               * rng.standard_normal((ANN_PLANTED, ANN_DIM))).astype(np.float32)
    index.search_batch(planted[:8], k=16)  # warm: both paths once before the counted run
    index._exact_batch(planted[:8], 16)

    # the plain twins count their calls: the counted run must make none
    plain_calls = {"adc_shortlist_plain": 0, "rerank_plain": 0, "topk_scores_plain": 0}
    originals = {n: getattr(ann_mod if n != "topk_scores_plain" else knn_mod, n)
                 for n in plain_calls}

    def counting(name):
        def call(*a, **kw):
            plain_calls[name] += 1
            return originals[name](*a, **kw)
        return call

    for name in plain_calls:
        setattr(ann_mod if name != "topk_scores_plain" else knn_mod, name, counting(name))
    try:
        kernels.reset_counts()
        ann_batches = exact_batches = 0
        for Q in (1, 8, 32):
            ann_ms, exact_ms = [], []
            for b in range(6):
                qs = planted[(b * Q) % ANN_PLANTED:][:Q]
                t0 = time.perf_counter()
                index.search_batch(qs, k=16)
                ann_ms.append((time.perf_counter() - t0) * 1e3)
                ann_batches += 1
                t0 = time.perf_counter()
                index._exact_batch(qs, 16)
                exact_ms.append((time.perf_counter() - t0) * 1e3)
                exact_batches += 1
            log(f"  search Q={Q} k=16 (query bucket {max(8, Q)}), a batch: ANN (nprobe "
                f"{index._nprobe_eff()}) {_stat(ann_ms, 'ms')}; exact tier (knn_topk over "
                f"{ANN_ROWS} rows) {_stat(exact_ms, 'ms')}")
        out = index.search_batch(planted, k=16)
        ann_batches += 1
        counts = kernels.launch_counts()
    finally:
        for name, fn in originals.items():
            setattr(ann_mod if name != "topk_scores_plain" else knn_mod, name, fn)
    top1 = sum(1 for row, s in zip(out, src) if row and row[0][0] == int(s))
    log(f"  planted: {top1} of {ANN_PLANTED} source rows top-1 (score of the first "
        f"{out[0][0][1]:.5f}); launches {json.dumps({k: counts[k] for k in ('ann_adc', 'ann_rerank', 'knn_topk')})} "
        f"over {ann_batches} ANN and {exact_batches} exact batches; plain twin calls "
        f"{json.dumps(plain_calls)}")
    if top1 < 0.99 * ANN_PLANTED:
        fail(f"only {top1} of {ANN_PLANTED} planted queries found their source row top-1")
    if counts["ann_adc"] != ann_batches or counts["ann_rerank"] != ann_batches:
        fail(f"ann_adc / ann_rerank launched {counts['ann_adc']} / {counts['ann_rerank']} times "
             f"over {ann_batches} ANN search batches")
    if counts["knn_topk"] != exact_batches:
        fail(f"knn_topk launched {counts['knn_topk']} times over {exact_batches} exact batches")
    if any(plain_calls.values()):
        fail(f"a search ran a plain twin on the card: {plain_calls}")

    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    L = index._codes.shape[1]
    for nprobe in (16, 64, 256, 1024):
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        index.search_batch(planted, k=10, nprobe=nprobe)
        ms_q = (time.perf_counter() - t0) * 1e3 / ANN_PLANTED
        rec = index.probe_recall(n_queries=64, k=10, nprobe=nprobe, seed=0)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - held
        log(f"  recall curve: nprobe {rec['nprobe']:5d}  recall@10 {rec['recall_at_k']:.4f}  "
            f"ANN {ms_q:.4f} ms/query (one batch of {ANN_PLANTED}); peak card memory above the "
            f"index {peak / 2**20:.1f} MiB (the padded scan's [128, P L] f32 scores "
            f"{128 * rec['nprobe'] * L * 4 / 2**30:.2f} GiB)")
    del index, out
    gc_collect()
    durability_drill()
    return entries, {k: counts[k] for k in ("ann_adc", "ann_rerank", "knn_topk")}


def _flip_byte(path: str) -> None:
    import os

    with open(path, "r+b") as f:
        f.seek(os.path.getsize(path) // 2)
        b = f.read(1)
        f.seek(-1, os.SEEK_CUR)
        f.write(bytes([b[0] ^ 0xFF]))


def durability_drill() -> None:
    """``DurableANN`` at 65,536 x 768 in a temp dir (the index on the card):
    ingest 49,152 rows with a ledger key, ``train``, ``snapshot``, then
    16,384 more rows and a ``remove`` of every 97th id (the WAL tail),
    ``close``; reopen (snapshot + WAL-tail replay) and require searches
    identical to those before the close; then ``cli ann verify --dir`` in a
    subprocess: rc 0, and rc 1 naming the artifact after one flipped byte
    in the snapshot's ``vectors.npy``."""
    import os
    import shutil

    import numpy as np

    from django_assistant_bot_tpu_torch.storage.ann import make_clustered
    from django_assistant_bot_tpu_torch.storage.durable import DurableANN

    rows = make_clustered(ANN_DRILL_ROWS, ANN_DIM, seed=5)
    head = ANN_DRILL_ROWS * 3 // 4
    q = rows[:: ANN_DRILL_ROWS // 16][:16] + 0.01
    gone = list(range(0, ANN_DRILL_ROWS, 97))
    d = tempfile.mkdtemp(prefix="dabt-ann-drill-")
    try:
        t0 = time.perf_counter()
        dur = DurableANN(d, dim=ANN_DIM, fsync="always", seed=3)
        dur.ingest(range(head), rows[:head], ledger_key="doc:0:v1")
        dur.train()
        t_train = time.perf_counter()
        dur.snapshot()
        t_snap = time.perf_counter()
        dur.ingest(range(head, ANN_DRILL_ROWS), rows[head:], ledger_key="doc:1:v1")
        dur.remove(gone)
        before = dur.search_batch(q, k=10)
        dur.close()
        t1 = time.perf_counter()
        back = DurableANN(d, dim=ANN_DIM, fsync="always", seed=3)
        after = back.search_batch(q, k=10)
        st = back.durability_stats()
        t2 = time.perf_counter()
        n_live = len(back)
        back.close()
        log(f"  durability drill {ANN_DRILL_ROWS} x {ANN_DIM}: ingest + train "
            f"{t_train - t0:.2f} s, snapshot {t_snap - t_train:.2f} s, tail + close "
            f"{t1 - t_snap:.2f} s; reopen {t2 - t1:.2f} s (recovery_s {st['recovery_s']:.2f}, "
            f"replayed {st['replayed_records']} records, {n_live} rows live); searches equal "
            f"{after == before}")
        want_live = ANN_DRILL_ROWS - len(gone)
        if not (st["recovered"] and st["replayed_records"] == 2 and n_live == want_live):
            fail(f"durability drill: recovery {st} with {n_live} rows (want {want_live})")
        if after != before:
            fail("durability drill: searches after the reopen differ from those before the close")
        cmd = [sys.executable, "-m", f"{PKG}.cli", "ann", "verify", "--dir", d]
        ok = subprocess.run(cmd, capture_output=True, text=True, timeout=600, cwd=str(REPO))
        snaps = os.path.join(d, "snapshots")
        victim = os.path.join(snaps, sorted(os.listdir(snaps))[0], "vectors.npy")
        _flip_byte(victim)
        bad = subprocess.run(cmd, capture_output=True, text=True, timeout=600, cwd=str(REPO))
        problems = json.loads(bad.stdout)["problems"] if bad.stdout.strip() else []
        log(f"  cli ann verify: clean rc {ok.returncode}, after one flipped byte rc "
            f"{bad.returncode}: {problems}")
        if ok.returncode != 0 or not json.loads(ok.stdout)["ok"]:
            fail(f"cli ann verify on the clean drill directory: rc {ok.returncode}\n{ok.stderr[-2000:]}")
        if bad.returncode != 1 or not any("vectors.npy: crc32c mismatch" in p for p in problems):
            fail(f"cli ann verify after a flipped byte: rc {bad.returncode}, {problems}\n"
                 f"{bad.stderr[-2000:]}")
    finally:
        shutil.rmtree(d, ignore_errors=True)


# --------------------------------------------------------------------- phase 10
MIXTRAL_LAYERS = 24  # the deepest cut of Mixtral 8x7B's 32 layers whose bf16 weights fit one card


def _moe_layer_input(params, cfg, ids, layer: int):
    """The MLP input of ``layer`` in a prefill of ``ids`` (the residual
    after its attention, normalised): ``llama._mlp`` is wrapped to keep it,
    and the forward stops there."""
    import torch

    from django_assistant_bot_tpu_torch.models import llama

    seen = []

    class _Stop(Exception):
        pass

    mlp = llama._mlp

    def keep(c, p, h):
        seen.append(h)
        if len(seen) > layer:
            raise _Stop
        return mlp(c, p, h)

    llama._mlp = keep
    try:
        llama.prefill(params, cfg, ids, torch.tensor([ids.shape[1]], dtype=torch.int32,
                                                     device=ids.device))
    except _Stop:
        pass
    finally:
        llama._mlp = mlp
    return seen[layer]


def chunk_split(cfg, params, ids) -> dict:
    """One eager prefill forward of the chunk ``ids [1, S]``: its device
    time (torch.profiler, the median of 3 profiles of one forward) split
    into the grouped GEMM's gate/up (with its row gather) and down
    kernels, the routing and combine kernels, and the rest."""
    import torch

    from django_assistant_bot_tpu_torch.models import llama

    lengths = torch.tensor([ids.shape[1]], dtype=torch.int32, device=ids.device)

    def forward():
        with torch.no_grad():
            llama.prefill(params, cfg, ids, lengths)

    parts = []
    for _ in range(3):
        per = device_ms_by_kernel(forward, 1)
        part = {"gate_up": 0.0, "down": 0.0, "route+combine": 0.0, "rest": 0.0}
        for name, ms in per.items():
            if "moe_gather_kernel" in name:  # gate/up's rows for the wgmma route
                part["gate_up"] += ms
            elif "moe_gemm" in name:
                part["gate_up" if "kernel<true" in name else "down"] += ms
            elif "moe_route" in name or "moe_combine" in name:
                part["route+combine"] += ms
            else:
                part["rest"] += ms
        part["total"] = sum(per.values())
        parts.append(part)
    med = {k: statistics.median(p[k] for p in parts) for k in parts[0]}
    log(f"  Mixtral eager {ids.shape[1]}-token chunk forward ({cfg.num_layers} layers), device "
        f"ms (median of 3 profiles): " + ", ".join(f"{k} {v:.4f}" for k, v in med.items())
        + f" (lost profiles so far: {PROFILER_LOST[0]})")
    return med


def mixtral_phase(card: str) -> dict:
    """Mixtral 8x7B at full width and 24 of its 32 layers (bf16, random
    weights drawn on the card from a seed) behind ``/dialog/`` in a
    ``ModelRegistry`` / ``create_app`` server, the engine at the JAX
    ``ModelSpec`` defaults (8 slots, ``max_seq_len`` 4096, page 512, 8-step
    ticks as a CUDA graph, piggybacked chunks).  Allocated memory must be
    near zero before the weights are drawn.  Phase 4's four requests, 32
    greedy tokens each, over 6 runs (the first counted): launch counts
    zeroed just before and read just after; ``moe_route`` = ``moe_combine``
    = 24 x (decode steps + prefill forwards), the grouped GEMM's gate/up
    and down launches likewise, counted by route and epilogue as the plan
    gives them (prefill on ``wgmma``, decode on ``mma`` + ``mma_split``);
    no plain twin called; paged decode = 24 x decode steps, flash and the sampler
    launched, qgemm not.  Then one layer's ``moe_mlp`` on a real chunk's
    activations held to its twins, the live experts of a decode step, the
    decode breakdown (the eager step's device time split into MoE kernels,
    attention and the rest; the replayed tick per step) and the readings
    (medians and min-max).  Returns the counted run's MoE launches."""
    import dataclasses

    import aiohttp
    import torch
    from aiohttp import web

    from django_assistant_bot_tpu_torch import kernels
    from django_assistant_bot_tpu_torch.models import DecoderConfig, llama, mixtral
    from django_assistant_bot_tpu_torch.models.mixtral import expert_capacity
    from django_assistant_bot_tpu_torch.ops import moe
    from django_assistant_bot_tpu_torch.serving import ByteTokenizer
    from django_assistant_bot_tpu_torch.serving.registry import ModelRegistry, ModelSpec
    from django_assistant_bot_tpu_torch.serving.server import create_app

    stopped = stop_engines()
    gc_collect()
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    log(f"  stopped {stopped} engine(s) that earlier phases left serving")
    log(f"  card memory before the weights: {before / 2**30:.3f} GiB allocated")
    if before > 1 << 30:
        fail(f"phase 10 starts with {before / 2**30:.2f} GiB still allocated")
    cfg = dataclasses.replace(DecoderConfig.mixtral_8x7b(), num_layers=MIXTRAL_LAYERS)
    t0 = time.perf_counter()
    params = llama.init(cfg, torch.Generator(device="cuda").manual_seed(31), "cuda")
    torch.cuda.synchronize()
    layers = params["layers"]
    expert_bytes = sum(layers[k].numel() * 2 for k in ("w_gate", "w_up", "w_down"))
    total = torch.cuda.memory_allocated() - before
    log(f"  Mixtral 8x7B ({cfg.num_layers} of 32 layers, E {cfg.hidden_size}, F "
        f"{cfg.intermediate_size}, {cfg.num_experts} experts, top {cfg.experts_per_token}, V "
        f"{cfg.vocab_size}) drawn on the card in {time.perf_counter() - t0:.1f} s: weights "
        f"{total / 1e9:.3f} GB allocated (experts {expert_bytes / 1e9:.3f} GB, "
        f"{expert_bytes / cfg.num_layers / cfg.num_experts / 1e6:.1f} MB an expert)")
    name = "mixtral-8x7b-24l-random"
    spec = ModelSpec(name=name, device="cuda", max_slots=8, max_seq_len=4096)
    engine, build_s = _build_engine(cfg, params, spec)
    registry = ModelRegistry()
    registry.load(spec, engine=engine)
    log(f"  engine built in {build_s:.2f} s (graphs captured), KV pool "
        f"{engine._kv_pool.n_pages} pages of {engine.kv_page_size}, graph pool "
        f"{engine.graph_pool_bytes / 2**20:.1f} MiB; card memory allocated "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB, peak "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    tok = ByteTokenizer()
    messages = four_requests(tok)
    port = _free_port()
    forwards = [0]
    fwd_tokens = []  # each eager prefill forward's token count (B x S)
    plain_calls = {n: 0 for n in ("moe_route_plain", "moe_expert_gemm_plain",
                                  "moe_combine_plain", "moe_mlp_plain")}
    patched = []

    def count(module, fn_name, counter, key, tokens=None):
        orig = getattr(module, fn_name)

        def counted(*a, _orig=orig, **kw):
            counter[key] += 1
            if tokens is not None:
                tokens.append(int(a[2].numel()))
            return _orig(*a, **kw)

        patched.append((module, fn_name, orig))
        setattr(module, fn_name, counted)

    for fn_name in ("prefill", "prefill_suffix_paged"):
        count(llama, fn_name, forwards, 0, fwd_tokens)
    suffix = [0]  # the eager chunk / suffix forwards alone (the paged prefill kernel's)
    count(llama, "prefill_suffix_paged", suffix, 0)
    for fn_name in ("moe_route_plain", "moe_expert_gemm_plain", "moe_combine_plain"):
        count(moe, fn_name, plain_calls, fn_name)
    count(mixtral, "moe_mlp_plain", plain_calls, "moe_mlp_plain")

    async def drive():
        runner = web.AppRunner(create_app(registry))
        await runner.setup()
        await web.TCPSite(runner, "127.0.0.1", port).start()
        try:
            async with aiohttp.ClientSession() as session:
                st, body, _ = await _post(session, port, name, _chat(300, 99))
                if st != 200:
                    fail(f"Mixtral warm-up /dialog/ returned {st}: {body}")
                runs = []
                for _ in range(6):  # the first counted, all six read
                    torch.cuda.synchronize()
                    kernels.reset_counts()
                    forwards[0] = suffix[0] = 0
                    fwd_tokens.clear()
                    steps0, pig0 = engine.steps, engine._prefill_chunks_piggybacked
                    samp0 = sampling_steps(engine)
                    t = time.perf_counter()
                    res = await asyncio.gather(*(_post(session, port, name, m)
                                                 for m in messages.values()))
                    wall = time.perf_counter() - t
                    runs.append(dict(results=res, wall=wall, counts=kernels.launch_counts(),
                                     forms=dict(kernels.MOE_GEMM_FORMS),
                                     prefill_forms=dict(kernels.PAGED_PREFILL_FORMS),
                                     suffix=suffix[0] + engine._prefill_chunks_piggybacked
                                     - pig0,
                                     fwd_tokens=list(fwd_tokens),
                                     piggybacked=engine._prefill_chunks_piggybacked - pig0,
                                     samples=sampling_steps(engine) - samp0,
                                     steps=engine.steps - steps0, forwards=forwards[0]
                                     + engine._prefill_chunks_piggybacked - pig0))
                return runs
        finally:
            await runner.cleanup()

    try:
        runs = asyncio.run(drive())
    finally:
        for module, fn_name, orig in reversed(patched):
            setattr(module, fn_name, orig)
    first = runs[0]
    ttfts, rates = [], []
    for run in runs:
        t, r, _ = _check_dialogs(tok, list(messages.items()), run["results"])
        ttfts += t
        rates += r
    counts, steps, fwd = first["counts"], first["steps"], first["forwards"]
    L = cfg.num_layers
    want = L * (steps + fwd)
    forms = {f: n for f, n in first["forms"].items() if n}
    log(f"  Mixtral main path on {card}: launches {counts}, grouped GEMM by route and epilogue "
        f"{forms}; {steps} decode steps, {fwd} prefill forwards: moe_route {counts['moe_route']} "
        f"({L} x ({steps} + {fwd}) = {want}); plain twin calls {plain_calls}")
    epilogues = {e: sum(n for f, n in forms.items() if f.endswith(":" + e))
                 for e in ("gate_up", "down")}
    if not (counts["moe_route"] == counts["moe_combine"] == want
            and epilogues == {"gate_up": want, "down": want} and counts["moe_gemm"] == 2 * want):
        fail(f"Mixtral: MoE launches {counts}, {forms}: want {want} of each epilogue")
    # the grouped GEMM's forms: each prefill forward (eager, or a chunk in
    # the piggyback graph; C 40 and more) on wgmma, each decode step (C 8)
    # on mma (gate/up) and mma_split (down)
    prefill_T = first["fwd_tokens"] + [engine.chunk_size] * first["piggybacked"]
    wanted = {"wgmma:gate_up": L * len(prefill_T), "wgmma:down": L * len(prefill_T),
              "mma:gate_up": L * steps, "mma_split:down": L * steps}
    log(f"  Mixtral grouped GEMM: prefill forwards of {prefill_T} tokens, {steps} decode steps; "
        f"launches by route and epilogue {forms}")
    if forms != wanted:
        fail(f"Mixtral: grouped GEMM launches {forms}, want {wanted}")
    if any(plain_calls.values()):
        fail(f"Mixtral: a plain twin ran on the main path: {plain_calls}")
    if counts["paged_decode"] != L * steps or counts["flash_prefill"] <= 0 or counts["qgemm"]:
        fail(f"Mixtral: paged / flash / qgemm launches wrong: {counts}")
    if counts["sample"] != first["samples"]:
        fail(f"Mixtral: sampler launches {counts['sample']} != {first['samples']} sampling steps")
    check_prefill_launches("phase 10, Mixtral", counts["paged_prefill"], first["suffix"], L,
                           first["prefill_forms"], "mma:native")
    log(f"  Mixtral readings over {len(runs)} runs of the four requests [{card}]: TTFT "
        f"{_stat(ttfts)}; decode {_stat(rates, 'tok/s')} per request; run wall "
        f"{_stat([r['wall'] for r in runs])}")

    # one layer's moe_mlp on a real chunk's activations, held to its twins
    ids = torch.tensor([tok.encode_chat(messages["c"])[:engine.chunk_size]], dtype=torch.int32,
                       device="cuda")
    with torch.no_grad():
        h = _moe_layer_input(params, cfg, ids, layer=1)
        p1 = llama._layer(params, 1)
        T = h.shape[0] * h.shape[1]
        check_moe_layer(h.reshape(T, -1), p1, expert_capacity(cfg, T),
                        f"Mixtral layer 1 on a real {T}-token chunk")
        # the live experts of a decode step: 8 slots, random tokens
        live = []
        route = mixtral.moe_route

        def record(*a, **kw):
            out = route(*a, **kw)
            live.append((out[3] > 0).sum())
            return out

        tokens = torch.randint(1, 255, (8,), generator=torch.Generator(device="cuda").manual_seed(5),
                               device="cuda", dtype=torch.int32)
        cache = llama.init_paged_cache(cfg, 8, 8, engine.kv_page_size, device="cuda")
        mixtral.moe_route = record
        try:
            llama.decode_step_paged(params, cfg, tokens, cache,
                                    torch.arange(8, dtype=torch.int32, device="cuda")[:, None])
        finally:
            mixtral.moe_route = route
        per_layer = [int(n) for n in live]
        del cache
    mean_live = statistics.mean(per_layer)
    log(f"  live experts a decode step (8 slots, random tokens), per layer: {per_layer}, mean "
        f"{mean_live:.2f} of {cfg.num_experts}: {mean_live * expert_bytes / cfg.num_experts / 1e9:.3f}"
        f" GB of expert weights read a step")
    decode_breakdown(cfg, params, engine, label="Mixtral ")
    chunk_split(cfg, params, ids)
    # each kernel's launches in the counted run ("moe_gemm_down": the mma
    # kernel's down launches, split or not)
    moe_counts = {"moe_route": counts["moe_route"], "moe_combine": counts["moe_combine"],
                  "moe_gemm_gate_up": forms.get("mma:gate_up", 0),
                  "moe_gemm_down": forms.get("mma:down", 0) + forms.get("mma_split:down", 0),
                  "moe_gemm_gate_up_wgmma": forms.get("wgmma:gate_up", 0),
                  "moe_gemm_down_wgmma": forms.get("wgmma:down", 0)}
    registry.stop()
    del engine, registry, params, layers
    gc_collect()
    return moe_counts


# --------------------------------------------------------------------- phase 13
LEGACY_CHUNK = 512  # decode_kv_chunk of phase 13's engines: phase 4's page
LEGACY_PREFIX_HEAD = 1500  # the shared-prefix pair's head, in tokens


def _legacy_spec(name: str, **kw):
    """A spec of the JAX ``ModelSpec`` defaults on the legacy layout, read
    from a config mapping as ``cli serve`` reads one."""
    from django_assistant_bot_tpu_torch.serving.registry import ModelSpec

    conf = {"device": "cuda", "max_slots": 8, "max_seq_len": 4096, **kw}
    return ModelSpec.from_dict(name, conf)


def _crank_ids(eng, tok, waves) -> list:
    """Greedy ids of ``waves`` (lists of chats, each submitted together after
    the previous wave finished) on an engine driven by this thread alone
    (``_loop_iteration``), so two engines see the same admissions and ticks;
    a chat's messages before the last are its declared prefix."""
    from django_assistant_bot_tpu_torch.serving import encode_chat_split

    eng._running = True
    out = []
    for wave in waves:
        futs = []
        for msgs in wave:
            ids, plen = encode_chat_split(tok, msgs)
            futs.append(eng.submit(ids, max_tokens=32, temperature=0.0, prefix_len=plen))
        _crank(eng, futs, limit=20000)
        out += [f.result(timeout=0).token_ids for f in futs]
    eng._running = False
    return out


def legacy_phase(card: str, cfg, params) -> dict:
    """The legacy contiguous KV layout at full width over phase 4's bf16
    Llama-3-8B tensors (the head's columns past the byte ids zeroed by
    phase 7): a paged engine at phase 4's spec and a ``kv_layout="legacy"``
    engine (8 slots, ``max_seq_len`` 4096, ``decode_kv_chunk`` 512: a
    4.3 GB slot cache), both at the default loop, cranked through the same
    trace (phase 4's four requests together, then a shared-prefix pair one
    after the other): greedy ids equal, the pair's second request a hit of
    the paged registry and of the legacy pinned-prefix LRU
    (``prefix_entries``, ``prefix_bytes``).  Then phase 4's four requests
    over /dialog/ through the registry on the legacy spec, twice, launch
    counts zeroed before each run: ``chunked_decode`` = 32 x decode steps on
    the tensor-core form, no ``paged_decode``; TTFT, tok/s per request and
    ``kv_read_frac``; the replayed 8-step tick per step beside phase 4's.
    Last a short ``kv_cache_dtype="fp8"`` + ``attn_fp8`` legacy engine: one
    run, its chunked launches on the e4m3 in-dot form.  Returns the first
    legacy run's launches and the fp8 run's."""
    import torch

    from django_assistant_bot_tpu_torch import kernels
    from django_assistant_bot_tpu_torch.serving import ByteTokenizer

    tok = ByteTokenizer()
    messages = four_requests(tok)
    pair = _rag_chats(tok, LEGACY_PREFIX_HEAD, [100, 120])  # one two-message head
    waves = [list(messages.values()), pair[:1], pair[1:]]
    name = "llama3-8b-legacy"
    ids = {}
    for layout in ("paged", "legacy"):
        t0 = time.perf_counter()
        kw = {"kv_layout": "legacy", "decode_kv_chunk": LEGACY_CHUNK} if layout == "legacy" else {}
        spec = _legacy_spec(name, **kw)
        engine, build_s = _build_engine(cfg, params, spec)
        if layout == "legacy":
            gib = pool_bytes(engine) / 2**30
            log(f"  legacy engine: slot cache {tuple(engine._cache.k.shape)} x2 "
                f"{engine._cache.k.dtype}, {gib:.2f} GiB; built in {build_s:.2f} s; decode path "
                f"{engine.decode_path_stats()}")
            if engine.paged or engine.decode_kv_chunk != LEGACY_CHUNK:
                fail(f"the legacy spec built a {engine.kv_stats()} engine")
        ids[layout] = _crank_ids(engine, tok, waves)
        kv = engine.kv_stats()
        log(f"  {layout}: the trace's ids in {time.perf_counter() - t0:.1f} s (build included); "
            f"kv_stats {json.dumps(kv)}")
        if kv["prefix_hits"] != 1:
            fail(f"{layout}: the shared-prefix pair's second request did not hit: {kv}")
        if layout == "legacy":
            if kv["prefix_entries"] < 1 or kv["prefix_bytes"] <= 0:
                fail(f"the legacy pinned-prefix LRU holds nothing after the pair: {kv}")
            legacy_engine = engine
        else:
            del engine
            gc_collect()
    same = [a == b for a, b in zip(ids["paged"], ids["legacy"])]
    log(f"  greedy ids legacy == paged, request by request: {same}")
    if not all(same):
        fail(f"legacy greedy ids differ from the paged engine's: {same}")

    legacy_engine.reset()
    spec = _legacy_spec(name, kv_layout="legacy", decode_kv_chunk=LEGACY_CHUNK)
    runs = _serve(spec, legacy_engine, [list(messages.values())] * 2)
    first = runs[0]
    counts, steps = first["counts"], first["steps"]
    forms = first.get("chunked_forms", {})
    ttfts, rates = [], []
    for run in runs:
        t, r, _ = _check_dialogs(tok, list(messages.items()), run["results"])
        ttfts += t
        rates += r
    log(f"  legacy /dialog/ through the registry, first run: {counts['chunked_decode']} "
        f"chunked launches for {steps} decode steps ({counts['chunked_decode'] / max(1, steps):g} "
        f"a step), by form {forms}, paged_decode {counts['paged_decode']}, flash "
        f"{counts['flash_prefill']}")
    if steps <= 0 or counts["chunked_decode"] != cfg.num_layers * steps:
        fail(f"legacy: chunked launches {counts['chunked_decode']} != {cfg.num_layers} x {steps} "
             "decode steps")
    if counts["paged_decode"] != 0 or counts["flash_prefill"] <= 0:
        fail(f"legacy: the run left the chunked read or skipped flash prefill: {counts}")
    if forms.get("mma:native") != counts["chunked_decode"]:
        fail(f"legacy: chunked launches left the tensor-core native read: {forms}")
    st = legacy_engine.tick_stats()
    log(f"  legacy readings over {len(runs)} runs of the four requests [{card}]: TTFT "
        f"{_stat(ttfts)} (phase 4's paged engine: {_stat(PHASE4['ttfts'])}); decode "
        f"{_stat(rates, 'tok/s')} per request (phase 4: {_stat(PHASE4['rates'], 'tok/s')}); "
        f"kv_read_frac {st['kv_read_frac']}; ttft_p50_ms {st['ttft_p50_ms']}, itl_p50_ms "
        f"{st['itl_p50_ms']}")
    # the replayed tick per step at phase 4's breakdown positions (the
    # engine was stopped by the server; its graph and buffers stay)
    start = torch.tensor([5, 511, 512, 1041, 1836, 3000, 1500, 700], dtype=torch.int32,
                         device="cuda")
    tokens = torch.randint(1, 255, (8,), generator=torch.Generator(device="cuda").manual_seed(7),
                           device="cuda", dtype=torch.int32)
    K = legacy_engine.decode_steps
    legacy_engine._active_dev.fill_(True)
    legacy_engine._temps_dev.zero_()

    def tick():
        legacy_engine._cache.lengths.copy_(start)
        legacy_engine._tokens_dev.copy_(tokens)
        legacy_engine._launch_tick()

    with torch.no_grad():
        timing = [_sync_and_enqueue_ms(tick, 10, K) for _ in range(6)]
        spans = [ms / K for ms in _event_span_ms(legacy_engine._graph.replay, 10)]
    b4 = PHASE4["breakdown"]
    per_step = legacy_engine._graph_launches.launches["chunked_decode"] // K
    log(f"  legacy graph replay of the {K}-step tick, 8 slots, full width, per step over 6 "
        f"batches of 10 replays: synchronised {_stat([w for w, _ in timing], 'ms')} (phase 4's "
        f"paged tick {b4['replay_ms']:.4f} ms), graph span {_stat(spans, 'ms')} (phase 4 "
        f"{b4['span_ms']:.4f} ms); {per_step} chunked launches per step (recorded at capture)")
    if per_step != cfg.num_layers:
        fail(f"the legacy tick's graph holds {per_step} chunked launches a step")
    launches = {"native": counts["chunked_decode"]}
    del legacy_engine
    gc_collect()

    t0 = time.perf_counter()
    spec = _legacy_spec(name, kv_layout="legacy", decode_kv_chunk=LEGACY_CHUNK,
                        kv_cache_dtype="fp8", attn_fp8=True)
    engine, _ = _build_engine(cfg, params, spec)
    (run,) = _serve(spec, engine, [list(messages.values())])
    _check_dialogs(tok, list(messages.items()), run["results"])
    counts, steps, forms = run["counts"], run["steps"], run.get("chunked_forms", {})
    log(f"  fp8 attn_fp8 legacy engine ({engine._cache.k.dtype} slot cache, "
        f"{pool_bytes(engine) / 2**30:.2f} GiB), one run: {counts['chunked_decode']} chunked "
        f"launches for {steps} decode steps, by form {forms} "
        f"({time.perf_counter() - t0:.1f} s)")
    if steps <= 0 or counts["chunked_decode"] != cfg.num_layers * steps:
        fail(f"fp8 legacy: chunked launches {counts['chunked_decode']} != {cfg.num_layers} x "
             f"{steps}")
    if forms.get("mma:e4m3/in_dot") != counts["chunked_decode"]:
        fail(f"fp8 legacy: chunked launches left the e4m3 in-dot read: {forms}")
    launches["e4m3/in_dot"] = counts["chunked_decode"]
    del engine
    gc_collect()
    return launches


def stop_engines() -> int:
    """Stop every engine an earlier phase left running (its loop thread
    holds it, and so its weights and pools, alive); returns how many."""
    import gc

    from django_assistant_bot_tpu_torch.serving import EmbeddingEngine, GenerationEngine

    live = [o for o in gc.get_objects()
            if isinstance(o, (GenerationEngine, EmbeddingEngine)) and o._running]
    for eng in live:
        eng.stop()
    return len(live)


def gc_collect() -> None:
    """Free what no live object holds: unreachable engines, the caching
    allocator's free blocks, and the cuBLAS workspaces that PyTorch keeps
    per stream (every engine's capture stream leaves one)."""
    import gc

    import torch

    gc.collect()
    clear = getattr(torch._C, "_cuda_clearCublasWorkspaces", None)
    if clear is not None:
        clear()
    torch.cuda.empty_cache()


def main() -> int:
    try:
        import torch
    except ImportError:
        print("torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("no CUDA device: chip_smoke.py runs only on the card", file=sys.stderr)
        return 2
    if not (REPO / PKG / "csrc").is_dir():
        print(f"{PKG}/ not found beside chip_smoke.py: run it from the repository checkout",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    t_start = time.perf_counter()
    phase_s = {}

    def phase(n, title):
        """Log the previous phase's wall seconds on a line of its own and
        open phase ``n``."""
        now = time.perf_counter()
        if phase_s:
            last = list(phase_s)[-1]
            phase_s[last] = now - phase_s[last]
            log(f"phase {last} wall {phase_s[last]:.1f} s")
        if n is not None:
            phase_s[n] = now
            log(f"== phase {n}: {title}")

    phase(1, "environment and build")
    env_and_build()
    card = gpu_line()
    gen = torch.Generator(device="cuda").manual_seed(0)

    phase(2, "kernels vs plain twins (the ANN kernels' checks run on phase 9's corpus)")
    # the engine's page at 4096 for paged decode
    entries = [check_flash(gen), *check_paged(gen, page=512), *check_chunked(gen),
               *check_paged_tree(gen),
               check_knn(gen), *check_qgemm(gen), check_qgemm_generic(gen), check_sample(gen),
               *check_moe(gen)]

    entries.append(check_paged_prefill(gen))
    guard_prefill_twin()

    phase(3, "small f32 models, card vs CPU")
    generic_launches = small_reference()
    small_encoder()
    small_moe()
    if PREFILL_TWIN_ON_CARD[0]:
        fail(f"phase 3: the paged prefill twin ran on the card {PREFILL_TWIN_ON_CARD[0]} times")

    phase(4, "main path, full-width Llama-3-8B over /dialog/")
    counts, dec_spec, dec_engine = main_path(card)

    phase(5, "load shedding, and cli serve --tiny --device cuda")
    shed_check()
    serve_tiny_subprocess()

    phase(6, "the RAG request at full width: /embeddings/ -> KNN -> /dialog/")
    rag_counts = rag_phase(card, dec_spec, dec_engine)
    cfg, params = dec_engine.cfg, dec_engine.params
    del dec_engine
    gc_collect()

    phase(7, "SSE streaming and JSON-constrained /dialog/ at full width, after warmup")
    stream_counts = stream_json_phase(card, cfg, params)
    gc_collect()

    phase(11, f"tree-verified speculative decoding (K {SPEC_K}, N {SPEC_N}) on phase 4's "
              "Llama-3-8B over /dialog/ (the paged tree kernel)")
    spec_counts = spec_phase(card, cfg, params)
    gc_collect()

    phase(12, "fp8 KV pools at full width over /dialog/ (kv_cache_dtype fp8 and fp8_e5m2, "
              "attn_fp8)")
    fp8_counts = fp8_phase(card, cfg, params)
    gc_collect()

    phase(13, "the legacy contiguous KV layout at full width over /dialog/ (the chunked "
              "decode kernel)")
    legacy_counts = legacy_phase(card, cfg, params)
    del params
    gc_collect()

    phase(8, "int8 and int4 Llama-3-8B over /dialog/ (the qgemm kernel)")
    log(f"  card memory before: {torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    q_counts = quant_phase(card)
    gc_collect()

    phase(9, "ANN retrieval at scale (2,000,000 x 768): phase 2's ANN kernel checks, the "
             "searches and the durability drill")
    ann_entries, ann_counts = ann_phase(card)
    entries += ann_entries
    gc_collect()

    phase(10, f"Mixtral 8x7B ({MIXTRAL_LAYERS} of 32 layers, full width, bf16) over "
              "/dialog/ (the MoE kernels)")
    moe_counts = mixtral_phase(card)
    phase(None, "")

    # each kernel's launches on its own slice's main path: flash, paged
    # decode and the sampler on phase 4's requests, the KNN on phase 6's RAG
    # requests, qgemm on phase 8's requests in its format, its generic route
    # on phase 8's int4 g8 engine, the ANN kernels on phase 9's searches,
    # the MoE kernels on phase 10's requests, the paged tree kernel on phase
    # 11's requests, the chunked decode on phase 13's
    for e in entries:
        if e["name"] in moe_counts:
            e["launches"] = moe_counts[e["name"]]
        elif e["name"] in ("ann_adc", "ann_rerank"):
            e["launches"] = ann_counts[e["name"]]
        elif e["name"] == "paged_tree":
            e["launches"] = spec_counts["paged_tree"]
        elif e["name"] == "chunked_decode":
            e["launches"] = legacy_counts["native"]
        elif e["name"] == "paged_decode_fp8":
            e["launches"] = fp8_counts["mma:e4m3/dequant"]
        elif e["name"] == "paged_decode_fp8_dot":
            e["launches"] = fp8_counts["mma:e4m3/in_dot"]
        elif e["name"] == "paged_tree_fp8":
            e["launches"] = fp8_counts["tree:mma:e4m3/dequant"]
        elif e["name"] == "qgemm_generic":
            e["launches"] = q_counts["int4_g8"]["generic"]
        elif e["name"].startswith("qgemm_prefill_"):
            e["launches"] = q_counts[e["name"][len("qgemm_prefill_"):]]["prefill"]
        elif e["name"].startswith("qgemm_"):
            e["launches"] = q_counts[e["name"][len("qgemm_"):]]["decode"]
        else:
            e["launches"] = rag_counts[e["name"]] if e["name"] == "knn_topk" else counts[e["name"]]
    log(f"kernels: {json.dumps(counts)} (phase 4), {json.dumps(rag_counts)} (phase 6), "
        f"{json.dumps(stream_counts)} (phase 7, the streams), {json.dumps(spec_counts)} "
        f"(phase 11, the first spec run), {json.dumps(fp8_counts)} (phase 12, by form), "
        f"chunked_decode {json.dumps(legacy_counts)} (phase 13, by form), "
        f"qgemm {json.dumps(q_counts)} "
        f"(phase 8; generic at phase 3's tiny int4 g8 decoder {generic_launches}), "
        f"{json.dumps(ann_counts)} "
        f"(phase 9), {json.dumps(moe_counts)} (phase 10)")
    log(f"device times taken with CUDA events where torch.profiler saw no kernel records: "
        f"{PROFILER_LOST[0]}")
    log("phase wall s: " + ", ".join(f"{n} {t:.1f}" for n, t in phase_s.items()))
    log(f"total {time.perf_counter() - t_start:.1f} s")
    log(card)
    log(json.dumps({"kernels": entries}))
    log(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                   "count": torch.cuda.device_count()},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
