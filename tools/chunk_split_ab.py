#!/usr/bin/env python3
"""Split a Llama-3-8B prefill chunk's device time on the card, for one checkout.

    python3 tools/chunk_split_ab.py --repo DIR [--starts 0,3584] [--layers 32]

Imports ``django_assistant_bot_tpu_torch`` from ``DIR`` (a checkout of this
repository, e.g. an earlier commit unpacked with ``git archive``), draws a
full-width bf16 Llama-3-8B with random weights (``--layers`` of its 32) and a
page pool of 8 pages of 512 (one 4,096-token row, the main path's engine
geometry), and runs ``llama.prefill_chunk_paged`` eagerly on a 512-token
chunk at each start: its synchronised wall ms per chunk (CUDA events, after a
warm-up) and its device time split by ``chip_smoke.llama_chunk_split``
(this checkout's helper) into attention, the row gather and page write,
the GEMMs and the rest (median of 3 torch.profiler profiles).  Prints one
JSON line with the card's name and power limit.  To compare two checkouts,
run it in turns in one chip call (A, B, B, A).  Needs one CUDA card; fails
without one.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--repo", required=True, help="checkout whose package is measured")
    ap.add_argument("--starts", default="0,3584", help="chunk starts, comma-separated")
    ap.add_argument("--layers", type=int, default=32)
    opts = ap.parse_args()
    repo = Path(opts.repo).resolve()
    # this checkout's helpers (chip_smoke.py's), whichever checkout's
    # package is measured: that one comes first on the path
    sys.path.insert(0, str(HERE))
    import chip_smoke as smoke

    sys.path.insert(0, str(repo))

    import dataclasses

    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: chunk_split_ab.py runs only on the card", file=sys.stderr)
        return 2
    import django_assistant_bot_tpu_torch as pkg
    from django_assistant_bot_tpu_torch import kernels
    from django_assistant_bot_tpu_torch.models import DecoderConfig, llama

    if Path(pkg.__file__).resolve().parent.parent != repo:
        print(f"imported {pkg.__file__}, not from {repo}", file=sys.stderr)
        return 2
    if "paged_prefill" in kernels.KERNELS:
        kernels.build(["paged_prefill"])
    cfg = dataclasses.replace(DecoderConfig.llama3_8b(), num_layers=opts.layers)
    params = llama.init(cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    page, NB, C = 512, 8, 512
    cache = llama.init_paged_cache(cfg, 1, NB, page, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(1)
    for t in (cache.k, cache.v):
        t.copy_(torch.randn(t.shape, generator=gen, device="cuda", dtype=t.dtype))
    bt = torch.arange(NB, dtype=torch.int32, device="cuda")
    ids = torch.randint(1, 255, (1, C), generator=gen, device="cuda", dtype=torch.int32)
    slot = torch.zeros((1,), dtype=torch.int64, device="cuda")
    result = {"repo": str(opts.repo), "card": smoke.gpu_line(), "layers": cfg.num_layers,
              "starts": {}}
    for start in (int(s) for s in opts.starts.split(",")):
        st = torch.full((1,), start, dtype=torch.int64, device="cuda")

        def run():
            with torch.no_grad():
                llama.prefill_chunk_paged(params, cfg, ids, cache, bt, slot, st, C)

        split = smoke.llama_chunk_split(run, f"Llama-3-8B eager chunk at start {start} "
                                             f"({opts.repo})")
        wall = smoke.time_ms(run, 5)
        result["starts"][start] = {"wall_ms": wall, **split}
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
