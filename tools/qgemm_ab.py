#!/usr/bin/env python3
"""Time the port's weight-only GEMM (qgemm) of one checkout on the card.

    python3 tools/qgemm_ab.py --repo DIR [--iters N] [--rows decode,prefill,generic]
                              [--splits 1,2,4,8]

Imports ``django_assistant_bot_tpu_torch`` from ``DIR`` (a checkout of this
repository, e.g. an earlier commit unpacked with ``git archive``), builds its
qgemm kernel there and times ``qeinsum`` in bf16 for int8 and int4 (group
64).  A timed call cycles through weight copies of at least 256 MB
(``chip_smoke.QGEMM_ROTATE_BYTES``), so every call reads its weights from
HBM, as the decode step and ``chip_smoke.py`` phase 2 do.

- ``decode`` rows: M = 1, 8, 16 and 64 rows of x at Llama-3-8B's four
  projection shapes (wq/wo 4096 x 4096, wk/wv 4096 x 1024, gate/up 4096 x
  14336, down 14336 x 4096) and its two grouped decode launches (QKV 4096 x
  (4096 + 1024 + 1024), gate+up 4096 x (14336 + 14336): one
  ``qeinsum_group`` call where the checkout has it, else one ``qeinsum`` a
  member).  Times are device ms per call from a CUDA graph of the rotated
  calls replayed back to back (CUDA events around the replay, over the
  calls), as the decode step replays them; beside each, the stream-read
  yardstick: one int32 sum over the same integer bytes, rotated and timed
  alike, the card's reachable read rate at that size.
- ``prefill`` rows: M = 512 and 2048 at the four projections, wall ms per
  back-to-back call (CUDA events) and device ms (torch.profiler), and
  cuBLAS's wall ms on the dequantized bf16 weight (``torch.matmul``, a
  yardstick the port never calls).

- ``generic`` rows: int4 at groups 8 and 4 (``--groups``; the generic route:
  ``qgemm_generic_kernel``, or in an older checkout the CUDA-core kernel)
  at the four projections, M = 8 and 512 (``--ms``), wall ms per
  back-to-back call and device ms (torch.profiler), beside the flush-aware bound
  (``chip_smoke.qgemm_flush_bound_ms``) and cuBLAS's wall and device ms on
  the dequantized bf16 weight, rotated alike.

Every row carries its bound (``chip_smoke.qgemm_group_bound_ms``) and the
checkout's plan.  Prints one JSON line with the card's name and power
limit.  To compare two checkouts, run it in turns in one chip call (A, B,
B, A).

``--splits`` also times the prefill route at M = 512 with each listed K
split forced in place of the plan's (the wgmma route, ``(2, 8, ksplit,
kchunk)``; a checkout without it fails), the numbers the plan's cost model
(``kernels.QGEMM_ROW_US``, ``QGEMM_PARTIAL_US``) is fitted to.  Needs one
CUDA card; fails without one.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent

SHAPES = [("wq/wo", 4096, (4096,)), ("wk/wv", 4096, (1024,)), ("gate/up", 4096, (14336,)),
          ("down", 14336, (4096,))]
GROUPS = [("qkv", 4096, (4096, 1024, 1024)), ("gate+up", 4096, (14336, 14336))]
FORMATS = [("int8", 0), ("int4", 64)]


def graph_ms(kernels, calls, reps: int = 5) -> float:
    """Device ms per call: ``calls`` captured once, in order, into a CUDA
    graph (warmed up first on the capture stream, with the graph's own
    split-K scratch), the graph replayed ``reps`` times; the median span
    between CUDA events around a replay, over the calls."""
    import statistics

    import torch

    stream, store = torch.cuda.Stream(), {}
    with kernels.private_paged_scratch(store):
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream):
            for call in calls:
                call()
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with kernels.record_graph_launches():
            with torch.cuda.graph(graph, stream=stream):
                for call in calls:
                    call()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    spans = []
    for _ in range(reps):
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        spans.append(start.elapsed_time(end) / len(calls))
    del graph
    return statistics.median(spans)


def generic_rows(smoke, kernels, quant, gen, iters: int, groups, rows_of_x) -> list:
    """The generic route at int4 ``groups``, Llama-3-8B's four projections,
    ``rows_of_x`` rows of x: the kernel and cuBLAS on the dequantized bf16
    weight, each rotated over >= 256 MB of copies."""
    import torch

    out = []
    for g in groups:
        for label, K, (N,) in SHAPES:
            ws = [c[0] for c in smoke._rotated(lambda: [smoke._qweight(K, N, "int4", g, gen)],
                                               K * N // 2 + 4 * (K // g) * N)]
            wds = [quant.deq(w, torch.bfloat16)
                   for w in ws[:max(2, -(-smoke.QGEMM_ROTATE_BYTES // (2 * K * N)))]]
            for M in rows_of_x:
                x = torch.randn((M, K), generator=gen, device="cuda").to(torch.bfloat16)
                kernel = smoke._cycler(
                    lambda w: quant.qeinsum("me,eo->mo", x, w, torch.bfloat16), ws)
                library = smoke._cycler(lambda wd: torch.matmul(x, wd), wds)
                kernels.reset_counts()
                kernel()
                torch.cuda.synchronize()
                route = next(r for r, n in kernels.QGEMM_ROUTES.items() if n)
                ms, dev = smoke.timed(kernel, iters)
                lib_ms, lib_dev = smoke.timed(library, iters)
                bound_ms, bound_by = smoke.qgemm_bound_ms(M, K, N, 4, g)
                flush_ms, flush_by = smoke.qgemm_flush_bound_ms(M, K, N, 4, g)
                out.append(dict(kind="generic", fmt="int4", group=g, shape=label, M=M, K=K, N=N,
                                route=route, ms=ms, device_ms=dev, bound_ms=bound_ms,
                                bound_by=bound_by, flush_bound_ms=flush_ms, flush_bound_by=flush_by,
                                library_ms=lib_ms, library_device_ms=lib_dev))
                print(json.dumps(out[-1]), file=sys.stderr)
            del ws, wds
            torch.cuda.empty_cache()
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--repo", required=True, help="checkout whose package is timed")
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--rows", default="decode,prefill",
                    help="comma-separated: decode, prefill, generic")
    ap.add_argument("--splits", default="", help="K splits to force at M = 512, e.g. 1,2,4,8")
    ap.add_argument("--groups", default="8,4", help="the generic rows' int4 groups")
    ap.add_argument("--ms", default="8,512", help="the generic rows' rows of x")
    opts = ap.parse_args()
    repo = Path(opts.repo).resolve()
    # this checkout's timing helpers (chip_smoke.py's public ones), whichever
    # checkout's package is timed: that one comes first on the path
    sys.path.insert(0, str(HERE))
    import chip_smoke as smoke

    sys.path.insert(0, str(repo))

    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: qgemm_ab.py runs only on the card", file=sys.stderr)
        return 2
    import django_assistant_bot_tpu_torch as pkg
    from django_assistant_bot_tpu_torch import kernels
    from django_assistant_bot_tpu_torch.ops import quant

    if Path(pkg.__file__).resolve().parent.parent != repo:
        print(f"imported {pkg.__file__}, not from {repo}", file=sys.stderr)
        return 2
    kernels.build(["qgemm"])
    torch.backends.cuda.matmul.allow_tf32 = False
    rows = set(opts.rows.split(","))
    splits = [int(s) for s in opts.splits.split(",") if s]
    gen = torch.Generator(device="cuda").manual_seed(0)
    result = {"repo": str(opts.repo), "card": smoke.gpu_line(), "rows": []}
    group_fn = getattr(quant, "qeinsum_group", None)

    def project(x, ws):
        if group_fn is not None:
            return group_fn("me,eo->mo", x, ws, torch.bfloat16)
        return [quant.qeinsum("me,eo->mo", x, w, torch.bfloat16) for w in ws]

    plan_fn = kernels.qgemm_plan
    if "generic" in rows:
        result["rows"] += generic_rows(smoke, kernels, quant, gen, opts.iters,
                                       [int(g) for g in opts.groups.split(",")],
                                       [int(m) for m in opts.ms.split(",")])
    for fmt, g in (FORMATS if rows & {"decode", "prefill"} else []):
        bits = 8 if fmt == "int8" else 4
        shapes = SHAPES + (GROUPS if "decode" in rows else [])
        for label, K, Ns in shapes:
            wbytes = sum(K * N * bits // 8 for N in Ns)
            copies = smoke._rotated(lambda: [smoke._qweight(K, N, fmt, g, gen) for N in Ns], wbytes)
            if "decode" in rows:
                flat = [torch.cat([w.q.reshape(-1).view(torch.uint8) for w in c]).view(torch.int32)
                        for c in copies]
                read_ms = graph_ms(kernels, [lambda f=f: f.sum(dtype=torch.int32) for f in flat])
                del flat
                for M in (1, 8, 16, 64):
                    x = torch.randn((M, K), generator=gen, device="cuda").to(torch.bfloat16)
                    dev = graph_ms(kernels, [lambda c=c: project(x, c) for c in copies])
                    bound_ms, bound_by = smoke.qgemm_group_bound_ms(M, K, Ns, bits, g)
                    result["rows"].append(dict(
                        kind="decode", fmt=fmt, group=g, shape=label, M=M, K=K, N=list(Ns),
                        graph_ms=dev, read_ms=read_ms, bound_ms=bound_ms, bound_by=bound_by,
                        grouped=group_fn is not None and len(Ns) > 1))
            if "prefill" in rows and len(Ns) == 1:
                N = Ns[0]
                ws = [c[0] for c in copies]
                wds = [quant.deq(w, torch.bfloat16)
                       for w in ws[:-(-smoke.QGEMM_ROTATE_BYTES // (2 * K * N))]]
                for M in (512, 2048):
                    x = torch.randn((M, K), generator=gen, device="cuda").to(torch.bfloat16)
                    kernel = smoke._cycler(
                        lambda w: quant.qeinsum("me,eo->mo", x, w, torch.bfloat16), ws)
                    library = smoke._cycler(lambda wd: torch.matmul(x, wd), wds)
                    ms, dev = smoke.timed(kernel, opts.iters)
                    bound_ms, bound_by = smoke.qgemm_bound_ms(M, K, N, bits, g)
                    row = dict(kind="prefill", fmt=fmt, group=g, shape=label, M=M, K=K, N=N,
                               ms=ms, device_ms=dev, bound_ms=bound_ms, bound_by=bound_by,
                               plan=list(plan_fn(M, N, K, bits, g)),
                               library_ms=smoke.time_ms(library, opts.iters))
                    if M == 512 and splits:
                        unit = math.lcm(64, g) if bits == 4 else 64
                        row["splits"] = {}
                        for want in splits:
                            kchunk = -(-K // (want * unit)) * unit
                            forced = (2, 8, -(-K // kchunk), kchunk)
                            kernels.qgemm_plan = lambda *a, _p=forced, **k: _p
                            try:
                                row["splits"][str(forced[2])] = smoke.device_ms(kernel, opts.iters)
                            finally:
                                kernels.qgemm_plan = plan_fn
                    result["rows"].append(row)
                del wds
            del copies
            torch.cuda.empty_cache()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
