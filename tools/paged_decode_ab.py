#!/usr/bin/env python3
"""Time the port's paged decode kernel of one checkout on the card.

    python3 tools/paged_decode_ab.py --repo DIR [--iters N]

Imports ``django_assistant_bot_tpu_torch`` from ``DIR`` (a checkout of this
repository, e.g. an earlier commit unpacked with ``git archive``), builds its
kernels there and times ``paged_gqa_decode_attention`` in bf16 at Llama-3-8B's
decode width (B=8, H=32, KH=8, D=128, page 512, NB=8) on three row layouts:

- ``timed``: ``chip_smoke.py`` phase 2's timed shape (10,208 live keys);
- ``main-path``: phase 4's four requests in mid-decode, rows 4-7 idle;
- ``breakdown``: the decode-breakdown step of phase 4, all 8 rows active.

Prints one JSON line: per layout, the wall ms per back-to-back call (CUDA
events), the device ms per call (torch.profiler, every kernel the call
launches) and the bound, with the card's name and power limit.  To compare
two checkouts, run it in turns in one chip call (A, B, B, A).  Needs one CUDA
card; fails without one.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent

LAYOUTS = {
    "timed": ([5, 511, 512, 1041, 1836, 4095, 1500, 700], [6]),
    "main-path": ([105, 355, 485, 915, 0, 0, 0, 0], [4, 5, 6, 7]),
    "breakdown": ([5, 511, 512, 1041, 1836, 3000, 1500, 700], []),
}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--repo", required=True, help="checkout whose package is timed")
    ap.add_argument("--iters", type=int, default=200)
    opts = ap.parse_args()
    repo = Path(opts.repo).resolve()
    # this checkout's timing helpers (chip_smoke.py's public ones), whichever
    # checkout's package is timed: that one comes first on the path
    sys.path.insert(0, str(HERE))
    import chip_smoke as smoke

    sys.path.insert(0, str(repo))

    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: paged_decode_ab.py runs only on the card", file=sys.stderr)
        return 2
    import django_assistant_bot_tpu_torch as pkg
    from django_assistant_bot_tpu_torch import kernels
    from django_assistant_bot_tpu_torch.ops.attention import paged_gqa_decode_attention

    if Path(pkg.__file__).resolve().parent.parent != repo:
        print(f"imported {pkg.__file__}, not from {repo}", file=sys.stderr)
        return 2
    kernels.build(["paged_decode"])
    B, H, KH, D, page, NB = 8, 32, 8, 128, 512, 8
    P = B * NB
    gen = torch.Generator(device="cuda").manual_seed(0)
    k_pool = torch.randn((P, KH, page, D), generator=gen, device="cuda", dtype=torch.bfloat16)
    v_pool = torch.randn((P, KH, page, D), generator=gen, device="cuda", dtype=torch.bfloat16)
    q = torch.randn((B, H, 1, D), generator=gen, device="cuda", dtype=torch.bfloat16)
    perm = torch.randperm(P, generator=torch.Generator().manual_seed(1)).reshape(B, NB)
    result = {"repo": str(opts.repo), "card": smoke.gpu_line(), "layouts": {}}
    for name, (positions, inactive) in LAYOUTS.items():
        bt = perm.to(torch.int32).clone()
        for b, pos in enumerate(positions):
            bt[b, pos // page + 1:] = P
        bt = bt.cuda()
        pos_t = torch.tensor(positions, dtype=torch.int32, device="cuda")
        active = torch.tensor([b not in inactive for b in range(B)], device="cuda")
        ms, dev = smoke.timed(
            lambda: paged_gqa_decode_attention(q, k_pool, v_pool, bt, pos_t, active=active),
            opts.iters,
        )
        live = smoke.paged_live_keys(positions, inactive, page, NB)
        bound_ms, bound_by = smoke.paged_bound_ms(live, B, H, KH, D, NB)
        result["layouts"][name] = dict(live_keys=live, ms=ms, device_ms=dev,
                                       bound_ms=bound_ms, bound_by=bound_by)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
