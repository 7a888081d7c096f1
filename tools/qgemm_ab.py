#!/usr/bin/env python3
"""Time the port's weight-only GEMM (qgemm) of one checkout on the card.

    python3 tools/qgemm_ab.py --repo DIR [--iters N] [--splits 1,2,4,8]

Imports ``django_assistant_bot_tpu_torch`` from ``DIR`` (a checkout of this
repository, e.g. an earlier commit unpacked with ``git archive``), builds its
qgemm kernel there and times ``qeinsum`` in bf16 at Llama-3-8B's four
projection shapes (wq/wo 4096 x 4096, wk/wv 4096 x 1024, gate/up 4096 x
14336, down 14336 x 4096) for int8 and int4 (group 64), at M = 512 and
2048 rows of x.  A timed call cycles through weight copies of at least 256 MB
(``chip_smoke.QGEMM_ROTATE_BYTES``), so every call reads its weights from
HBM, as ``chip_smoke.py`` phase 2 does.

Prints one JSON line: per format, shape and M, the wall ms per back-to-back
call (CUDA events), the device ms per call (torch.profiler), the bound
(``chip_smoke.qgemm_bound_ms``), the checkout's plan and cuBLAS's wall ms on
the dequantized bf16 weight (``torch.matmul``, a yardstick the port never
calls), with the card's name and power limit.  To compare two checkouts,
run it in turns in one chip call (A, B, B, A).

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

SHAPES = [("wq/wo", 4096, 4096), ("wk/wv", 4096, 1024), ("gate/up", 4096, 14336),
          ("down", 14336, 4096)]
FORMATS = [("int8", 0), ("int4", 64)]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--repo", required=True, help="checkout whose package is timed")
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--splits", default="", help="K splits to force at M = 512, e.g. 1,2,4,8")
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
    from django_assistant_bot_tpu_torch.ops.quant import deq, qeinsum

    if Path(pkg.__file__).resolve().parent.parent != repo:
        print(f"imported {pkg.__file__}, not from {repo}", file=sys.stderr)
        return 2
    kernels.build(["qgemm"])
    torch.backends.cuda.matmul.allow_tf32 = False
    splits = [int(s) for s in opts.splits.split(",") if s]
    gen = torch.Generator(device="cuda").manual_seed(0)
    result = {"repo": str(opts.repo), "card": smoke.gpu_line(), "rows": []}
    plan_fn = kernels.qgemm_plan
    for fmt, g in FORMATS:
        bits = 8 if fmt == "int8" else 4
        for label, K, N in SHAPES:
            wbytes = K * N * bits // 8
            ws = [smoke._qweight(K, N, fmt, g, gen)
                  for _ in range(-(-smoke.QGEMM_ROTATE_BYTES // wbytes))]
            wds = [deq(w, torch.bfloat16)
                   for w in ws[:-(-smoke.QGEMM_ROTATE_BYTES // (2 * K * N))]]
            for M in (512, 2048):
                x = torch.randn((M, K), generator=gen, device="cuda").to(torch.bfloat16)
                it, itd = [0], [0]

                def kernel():
                    it[0] = (it[0] + 1) % len(ws)
                    return qeinsum("me,eo->mo", x, ws[it[0]], torch.bfloat16)

                def library():
                    itd[0] = (itd[0] + 1) % len(wds)
                    return torch.matmul(x, wds[itd[0]])

                ms, dev = smoke.timed(kernel, opts.iters)
                bound_ms, bound_by = smoke.qgemm_bound_ms(M, K, N, bits, g)
                row = dict(fmt=fmt, group=g, shape=label, M=M, K=K, N=N, ms=ms, device_ms=dev,
                           bound_ms=bound_ms, bound_by=bound_by,
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
            del ws, wds
            torch.cuda.empty_cache()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
