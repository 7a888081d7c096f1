#!/usr/bin/env python3
"""Time and check the port's grouped expert GEMM (``csrc/moe_gemm.cu``) on
the card at Mixtral 8x7B's widths (E 4,096, F 14,336, 8 experts, top 2).

    python3 tools/moe_gemm_ab.py [--repo DIR] [--tokens 8,64,128,512,2048]
                                 [--routes plan,mma,wgmma] [--splits 1,2,3,4]
                                 [--iters N] [--no-check]

Imports ``django_assistant_bot_tpu_torch`` from ``DIR`` (default: this
checkout), builds its kernels there and prints the ptxas registers and
spills and the SASS counts of the grouped GEMM's kernels.  For each token
count T (the capacity C as ``models.mixtral.expert_capacity`` gives it, the
routing ``moe_route``'s on random weights and activations from a seed) and
each route of ``--routes`` ("plan": what ``kernels.moe_gemm_plan`` picks;
"mma" / "wgmma": that route forced, down's K unsplit, wgmma's blocks 128
slots x 128 features; "mma_plan": the plan as below its wgmma threshold,
``mma`` with down's K split as the plan splits it (where the threshold
lies); "wgmma_wide": down's wgmma blocks 256 features;
"wgmma192": down's wgmma blocks 192 slots), gate/up and down:

- unless ``--no-check``, the outputs held to ``ops.moe.moe_gemm_bf16_bound``
  on the live rows (the worst err/bound; a NaN fails);
- wall ms per back-to-back call (CUDA events) and device ms
  (torch.profiler), beside the bound (``chip_smoke.moe_bounds_ms``) and,
  once per T, ``torch.bmm`` over the dense ``[X, C, E]`` dispatch (the JAX
  einsums, reading every expert), wall and device.

``--splits`` also times down on the mma kernel at T 8 with each K split
forced, once with the routing's live experts and once with the fill of the
first six experts only (6 x 64 = 384 blocks: one wave at three blocks an
SM), the wave-tail diagnosis.  Prints one JSON line (the card's name and
power limit, every reading).  Needs one CUDA card; fails without one.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--repo", default=str(HERE))
    ap.add_argument("--tokens", default="8,64,128,512,2048")
    ap.add_argument("--routes", default="plan,mma,wgmma")
    ap.add_argument("--splits", default="")
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--no-check", action="store_true")
    args = ap.parse_args()
    sys.path.insert(0, str(HERE))
    sys.path.insert(0, str(Path(args.repo).resolve()))
    import torch

    if not torch.cuda.is_available():
        print("moe_gemm_ab: no CUDA card", file=sys.stderr)
        return 1

    import chip_smoke as cs
    from django_assistant_bot_tpu_torch import kernels
    from django_assistant_bot_tpu_torch.models import DecoderConfig
    from django_assistant_bot_tpu_torch.models.mixtral import expert_capacity
    from django_assistant_bot_tpu_torch.ops import moe

    card = cs.gpu_line()
    kernels.build(["moe_route", "moe_gemm", "moe_combine"])
    log = kernels.BUILD_LOG.get("moe_gemm", "")
    ptxas = [r for r in cs.ptxas_table(log) if "moe_gemm" in r[0]]
    sass = {k: v for k, v in cs.sass_table(kernels.lib_path("moe_gemm")).items()}
    print(f"card: {card}")
    print(f"ptxas (kernel, registers, spill bytes): {ptxas}")
    print(f"SASS: {sass}")
    for line in log.splitlines():
        if "warning" in line.lower() or "serializ" in line.lower():
            print(f"nvcc: {line}")
    cfg = DecoderConfig.mixtral_8x7b()
    gen = torch.Generator(device="cuda").manual_seed(17)
    p = cs.moe_layer_weights(torch.bfloat16, gen)
    plan_fn = kernels.moe_gemm_plan
    rows = []

    def forced(route, split=None):
        if route == "plan":
            return plan_fn

        def fn(dtype, epilogue, X, C, K, N, **kw):
            if route == "mma_plan":
                saved = kernels.MOE_WGMMA_MIN_C
                kernels.MOE_WGMMA_MIN_C = 1 << 30
                try:
                    return plan_fn.__wrapped__(dtype, epilogue, X, C, K, N, **kw)
                finally:
                    kernels.MOE_WGMMA_MIN_C = saved
            if split is not None:
                kchunk = -(-K // (split * 64)) * 64
                ks = -(-K // kchunk)
                return kernels.MoePlan("mma_split" if ks > 1 else "mma", ks, kchunk, 64, 64)
            if route == "wgmma_wide":  # down's 256-feature blocks (gate/up: 128)
                return kernels.MoePlan("wgmma", 1, K, 256 if epilogue == "down" else 128, 128)
            if route == "wgmma192":  # down: three consumer warpgroups, 192 slots a block
                return kernels.MoePlan("wgmma", 1, K, 128, 192 if epilogue == "down" else 128)
            if route == "wgmma":
                return kernels.MoePlan("wgmma", 1, K, 128, 128)
            return kernels.MoePlan(route, 1, K, 64, 64)

        return fn

    def run(route, x, slot_tok, fill, h=None, split=None):
        kernels.moe_gemm_plan = forced(route, split)
        try:
            if h is None:
                return moe.moe_expert_gemm(x, slot_tok, fill, p["w_gate"], p["w_up"],
                                           epilogue="gate_up")
            return moe.moe_expert_gemm(h, slot_tok, fill, p["w_down"], epilogue="down")
        finally:
            kernels.moe_gemm_plan = plan_fn

    for T in [int(t) for t in args.tokens.split(",") if t]:
        C = expert_capacity(cfg, T)
        x = torch.randn((T, cs.MOE_E), generator=gen, device="cuda").to(torch.bfloat16)
        routing = moe.moe_route(x, p["router"], cs.MOE_K, C)
        tok_slot, _, slot_tok, fill = routing
        live = torch.arange(C, device="cuda")[None, :, None] < fill[:, None, None].long()
        bounds = cs.moe_bounds_ms(x, p, routing)
        xe = moe._gate_up_inputs(x, slot_tok)
        h_ref = run("plan", x, slot_tok, fill)
        lib = {"gate_up": lambda: (torch.bmm(xe, p["w_gate"]), torch.bmm(xe, p["w_up"])),
               "down": lambda: torch.bmm(h_ref, p["w_down"])}
        for kind in ("gate_up", "down"):
            lib_ms, lib_dev = cs.timed(lib[kind], args.iters)
            for route in [r for r in args.routes.split(",") if r]:
                h_in = None if kind == "gate_up" else h_ref
                plan = (plan_fn if route == "plan" else forced(route))(
                    torch.bfloat16, kind, cs.MOE_X, C, *(p["w_gate"].shape[1:] if kind == "gate_up"
                                                         else p["w_down"].shape[1:]))
                ratio = None
                if not args.no_check:
                    out = run(route, x, slot_tok, fill, h_in)
                    a = (x, slot_tok, p["w_gate"], p["w_up"]) if kind == "gate_up" else \
                        (h_ref, slot_tok, p["w_down"])
                    ref, bound = moe.moe_gemm_bf16_bound(*a, epilogue=kind)
                    r = torch.where(live, (out.float() - ref).abs() / bound, 0.0)
                    ratio = r.max().item() if bool(r.isfinite().all()) else float("inf")
                    del out, ref, bound, r
                ms, dev = cs.timed(lambda: run(route, x, slot_tok, fill, h_in), args.iters)
                b, by = bounds[kind]
                row = dict(T=T, C=C, kind=kind, route=route, plan=list(plan), live_experts=int(
                    (fill > 0).sum()), rows=int(fill.sum()), ms=ms, device_ms=dev, bound_ms=b,
                    bound_by=by, share=b / dev, bmm_ms=lib_ms, bmm_device_ms=lib_dev,
                    err_over_bound=ratio)
                rows.append(row)
                print(f"T {T} C {C} {kind} {route} {tuple(plan)}: wall {ms:.4f} device {dev:.4f} "
                      f"ms, bound {b:.4f} ({by}) share {b / dev:.3f}; bmm wall {lib_ms:.4f} "
                      f"device {lib_dev:.4f}; err/bound {ratio}", flush=True)
        del h_ref, xe
    splits = [int(s) for s in args.splits.split(",") if s]
    if splits:
        T, C = 8, expert_capacity(cfg, 8)
        x = torch.randn((T, cs.MOE_E), generator=gen, device="cuda").to(torch.bfloat16)
        _, _, slot_tok, fill = moe.moe_route(x, p["router"], cs.MOE_K, C)
        h = run("plan", x, slot_tok, fill)
        six = fill.clone()
        six[6:] = 0
        for name, f in (("routed", fill), ("first six", six)):
            for s in splits:
                ms, dev = cs.timed(lambda: run(None, x, slot_tok, f, h, split=s), args.iters * 5)
                row = dict(T=T, C=C, kind="down", route="mma_split", split=s, fill=name,
                           live_experts=int((f > 0).sum()), ms=ms, device_ms=dev)
                rows.append(row)
                print(f"down T 8 fill {name} ({row['live_experts']} live) split {s}: wall "
                      f"{ms:.4f} device {dev:.4f} ms", flush=True)
    print(json.dumps({"card": card, "ptxas": ptxas, "rows": rows}))
    bad = [r for r in rows if r.get("err_over_bound") is not None and not r["err_over_bound"] <= 1]
    if bad:
        print(f"moe_gemm_ab: {len(bad)} readings outside moe_gemm_bf16_bound", file=sys.stderr)
        return 2
    return 0


if __name__ == "__main__":
    sys.exit(main())
