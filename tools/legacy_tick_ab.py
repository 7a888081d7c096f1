#!/usr/bin/env python3
"""Time the decode tick of a paged and a legacy engine in turns, on the card.

    python3 tools/legacy_tick_ab.py [--rounds N] [--layers L]

Draws a full-width bf16 Llama-3-8B (``--layers`` of its 32 layers, random
weights from seed 0) once, builds two engines at the JAX ``ModelSpec``
defaults (8 slots, ``max_seq_len`` 4096): one on the page pool (page 512)
and one with ``kv_layout="legacy"`` and ``decode_kv_chunk`` 512, and replays
each engine's captured 8-step tick at ``chip_smoke.py``'s decode-breakdown
positions (8 active rows, 10,208 live keys), in turns paged, legacy,
legacy, paged for each round.  A turn is 10 replays after 3 warm ones,
synchronised at the end (ms per decode step), and the CUDA-event span of
one replay.  Then one eager decode step of each engine's cache under
torch.profiler: the device ms of its decode-attention kernels and of all
kernels.  Prints one JSON line with every turn, the medians and the card's
name and power limit.  Needs one CUDA card; fails without one.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent
START = [5, 511, 512, 1041, 1836, 3000, 1500, 700]  # the decode breakdown's positions


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--layers", type=int, default=32)
    opts = ap.parse_args()
    sys.path.insert(0, str(HERE))
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: legacy_tick_ab.py runs only on the card", file=sys.stderr)
        return 2
    import chip_smoke as smoke
    from django_assistant_bot_tpu_torch import kernels
    from django_assistant_bot_tpu_torch.models import DecoderConfig, llama
    from django_assistant_bot_tpu_torch.serving import ByteTokenizer, GenerationEngine
    from django_assistant_bot_tpu_torch.serving.registry import ModelSpec

    kernels.build()
    cfg = dataclasses.replace(DecoderConfig.llama3_8b(), num_layers=opts.layers)
    params = llama.init(cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    start = torch.tensor(START, dtype=torch.int32, device="cuda")
    tokens = torch.randint(1, 255, (8,), generator=torch.Generator(device="cuda").manual_seed(7),
                           device="cuda", dtype=torch.int32)
    engines = {}
    for layout, kw in (("paged", {}), ("legacy", {"kv_layout": "legacy",
                                                  "decode_kv_chunk": 512})):
        spec = ModelSpec(name=layout, device="cuda", max_slots=8, max_seq_len=4096, **kw)
        eng = GenerationEngine(cfg, params, ByteTokenizer(), device="cuda", **spec.engine_kwargs())
        if eng.paged:
            eng._bt_dev.copy_(torch.arange(64, dtype=torch.int32, device="cuda").reshape(8, 8))
        eng._active_dev.fill_(True)
        eng._temps_dev.zero_()
        engines[layout] = eng

    def tick(eng):
        eng._cache.lengths.copy_(start)
        eng._tokens_dev.copy_(tokens)
        eng._launch_tick()

    turns = {"paged": [], "legacy": []}
    spans = {"paged": [], "legacy": []}
    with torch.no_grad():
        for _ in range(opts.rounds):
            for layout in ("paged", "legacy", "legacy", "paged"):
                eng = engines[layout]
                turns[layout].append(smoke._sync_and_enqueue_ms(lambda: tick(eng), 10,
                                                                eng.decode_steps)[0])
                spans[layout] += [ms / eng.decode_steps
                                  for ms in smoke._event_span_ms(eng._graph.replay, 1)]
        eager = {}
        for layout, eng in engines.items():
            def step(eng=eng):
                eng._cache.lengths.copy_(start)
                if eng.paged:
                    llama.decode_step_paged(params, cfg, tokens, eng._cache, eng._bt_dev)
                else:
                    llama.decode_step(params, cfg, tokens, eng._cache, kv_chunk=512)

            by_kernel = smoke.device_ms_by_kernel(step, 10)
            attn = sum(ms for name, ms in by_kernel.items() if "paged" in name)
            eager[layout] = {"attention_ms": attn, "all_ms": sum(by_kernel.values())}
    out = {
        "card": smoke.gpu_line(),
        "layers": cfg.num_layers,
        "turns_ms_per_step": turns,
        "median_ms_per_step": {k: statistics.median(v) for k, v in turns.items()},
        "span_ms_per_step": {k: statistics.median(v) for k, v in spans.items()},
        "eager_step_device_ms": eager,
    }
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
