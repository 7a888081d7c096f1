#!/usr/bin/env python3
"""Time and check the port's MoE routing and combine (``csrc/moe_route.cu``)
on the card at Mixtral 8x7B's widths (E 4,096, 8 experts, top 2, bf16).

    python3 tools/moe_route_ab.py [--repo DIR] [--tokens 8,512,2048]
                                  [--splits 1,2,4,8,16] [--iters N]

With ``--repo DIR`` (another checkout of this repository, e.g. the parent
commit unpacked with ``git archive``) it runs four turns, DIR, this checkout,
this checkout, DIR (A/B/B/A), each a process of its own, and prints each
turn's readings side by side; without it, one turn of this checkout.

A turn imports ``django_assistant_bot_tpu_torch`` from its checkout, builds
the routing library there and prints its ptxas registers and spills and the
SASS counts of its kernels (LDG.E.128: 16-byte loads).  For each token count
T (the capacity C as ``models.mixtral.expert_capacity`` gives it; x and the
router random from a seed, the router at ``llama.init``'s scale):

- the routing held to its twin (``ops.moe.moe_route_plain``: ids and gates
  equal outside the tokens ``route_margin`` marks near a tie, slots outside
  the flagged ones, all equal when none is near) and the combine, on random
  expert outputs, bit-equal to ``moe_combine_plain``;
- wall ms per back-to-back call (CUDA events) and device ms (torch.profiler,
  summed over the call's kernels, with the kernels of one call by name),
  beside the bound (``chip_smoke.moe_bounds_ms``); at T >= 512 the routing's
  x and the combine's ye and out rotate over >= 256 MB of copies
  (``chip_smoke._rotated``), so no call finds them in the 50 MB L2;
- the launch floor: the device time of one empty kernel
  (``torch.cuda._sleep(0)``, a spin of zero cycles), timed alike.

``--splits`` also times the routing at T 8 with ``kernels.MOE_ROUTE_SPLITS``
set to each split in turn (1: one block), where the checkout has it.  ``--probe`` builds, into a temporary directory, copies of this
checkout's ``csrc/moe_route.cu`` cut at the points ``PROBES`` names (each
keeps a store the compiler cannot drop) and times each copy's routing at T 8
(one block, and E split over four blocks) and T 2,048 (token tiles), device
ms, beside the uncut source built alike: where a call's time goes.

Prints one JSON line (the card's name and power limit, every reading); a
disagreement with a twin exits 2.  Needs one CUDA card; fails without one.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent

# --probe: name -> the cuts made to csrc/moe_route.cu ((old, new), each old
# found once); every cut copy still stores what it computed where E < 0 (never)
_STORE = "if (E < 0 && tid < ROUTE_VALUES) tok_gate[tid] = {};\n  if (E > 0) return;\n"
_TOPK = "  // ---- top-k: a warp a token"
_RANKS = "  // ---- warp 0: each choice's rank"
_AT_TOPK = (_TOPK, "  " + _STORE.format("logit[tid]") + _TOPK)  # return with the logits
PROBES = {
    "full": [],
    # the logits only: no top-k, no slots
    "logits": [_AT_TOPK],
    # the logits with one expert column's FMAs (the loads as they are)
    "one_column": [("for (int j = 0; j < XMAX; ++j) acc[t * XMAX + j] = fmaf",
                    "for (int j = 0; j < 1; ++j) acc[t * XMAX + j] = fmaf"), _AT_TOPK],
    # the logits with no router copies (the stage as it was left)
    "no_stage": [("    stage_rows(stage, router + (size_t)e_lo * X, (e_hi - e_lo) * X, vec_r);\n",
                  ""), _AT_TOPK],
    # up to the top-k: no ranks, no slots
    "topk": [(_RANKS, "  " + _STORE.format("0.0f") + _RANKS)],
}


def turn(args) -> dict:
    """One checkout's readings (the worker of a turn)."""
    sys.path.insert(0, str(HERE))
    sys.path.insert(0, str(Path(args.one).resolve()))
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("moe_route_ab: no CUDA card")

    import chip_smoke as cs
    from django_assistant_bot_tpu_torch import kernels
    from django_assistant_bot_tpu_torch.models import DecoderConfig
    from django_assistant_bot_tpu_torch.models.mixtral import expert_capacity
    from django_assistant_bot_tpu_torch.ops import moe

    kernels.build(["moe_route", "moe_combine"])
    log = kernels.BUILD_LOG.get("moe_route", "")
    ptxas = cs.ptxas_table(log)
    sass = cs.sass_table(kernels.lib_path("moe_route"))
    cfg = DecoderConfig.mixtral_8x7b()
    gen = torch.Generator(device="cuda").manual_seed(29)
    E, X, K = cs.MOE_E, cs.MOE_X, cs.MOE_K
    router = (torch.randn((E, X), generator=gen, device="cuda") * E ** -0.5).to(torch.bfloat16)
    floor_wall, floor_dev = cs.timed(lambda: torch.cuda._sleep(0), args.iters)
    rows, bad = [], []
    for T in [int(t) for t in args.tokens.split(",") if t]:
        C = expert_capacity(cfg, T)
        x = torch.randn((T, E), generator=gen, device="cuda").to(torch.bfloat16)
        routing = moe.moe_route(x, router, K, C)
        want = moe.moe_route_plain(x, router, K, C)
        near, flagged = moe.route_margin(x, router, K)
        tok_slot, tok_gate, slot_tok, fill = routing
        route_ok = bool(((tok_gate - want[1]).abs()[~near] <= 1e-5).all()) and bool(
            (tok_slot == want[0])[~flagged].all())
        if not bool(near.any()):
            route_ok = route_ok and torch.equal(tok_slot, want[0]) and torch.equal(
                slot_tok, want[2]) and torch.equal(fill, want[3])
        ye = torch.randn((X, C, E), generator=gen, device="cuda").to(torch.bfloat16)
        comb = moe.moe_combine(tok_slot, tok_gate, ye)
        comb_ok = torch.equal(comb.view(torch.int16),
                              moe.moe_combine_plain(tok_slot, tok_gate, ye).view(torch.int16))
        torch.cuda.synchronize()
        if not (route_ok and comb_ok):
            bad.append(dict(T=T, route=route_ok, combine=comb_ok))
        # the bounds read the GEMM weights' shape only
        bounds = cs.moe_bounds_ms(x, {"w_gate": torch.empty((X, E, cs.MOE_F), device="meta")},
                                  routing)
        out = torch.empty((T, E), device="cuda", dtype=torch.bfloat16)
        if T >= 512:
            xs = cs._rotated(lambda: x.clone(), x.numel() * x.element_size())
            yes = cs._rotated(lambda: (ye.clone(), torch.empty_like(out)),
                              (ye.numel() + out.numel()) * ye.element_size())
        else:
            xs, yes = [x], [(ye, out)]
        calls = {"route": cs._cycler(lambda xi: moe.moe_route(xi, router, K, C), xs),
                 "combine": cs._cycler(lambda c: kernels.moe_combine(tok_slot, tok_gate, *c),
                                       yes)}
        for kind, fn in calls.items():
            ms = cs.time_ms(fn, args.iters)
            per = cs.device_ms_by_kernel(fn, args.iters)
            dev = sum(per.values())
            b, by = bounds[kind]
            rows.append(dict(T=T, C=C, kind=kind, ms=ms, device_ms=dev, kernels=len(per),
                             by_kernel=per, bound_ms=b, bound_by=by, share=b / dev,
                             near=int(near.sum()), copies=len(xs if kind == "route" else yes)))
            print(f"[{args.one}] T {T} C {C} {kind}: wall {ms:.4f} device {dev:.4f} ms in "
                  f"{len(per)} kernel(s), bound {b:.5f} ({by}) share {b / dev:.4f}; floor "
                  f"{floor_dev:.4f}; {len(xs if kind == 'route' else yes)} rotated copies",
                  flush=True)
        del xs, yes
    default_splits = getattr(kernels, "MOE_ROUTE_SPLITS", None)
    for s in [int(s) for s in args.splits.split(",") if s]:
        if default_splits is None:  # a checkout without the one-tile split
            break
        kernels.MOE_ROUTE_SPLITS = s
        kernels.moe_route_plan.cache_clear()
        T, C = 8, expert_capacity(cfg, 8)
        x = torch.randn((T, E), generator=gen, device="cuda").to(torch.bfloat16)
        outs = (torch.empty((T, K), dtype=torch.int32, device="cuda"),
                torch.empty((T, K), dtype=torch.float32, device="cuda"),
                torch.empty((X, C), dtype=torch.int32, device="cuda"),
                torch.empty((X,), dtype=torch.int32, device="cuda"))
        kernels.moe_route(x, router, *outs)
        want = moe.moe_route_plain(x, router, K, C)
        near, _ = moe.route_margin(x, router, K)
        ok = bool(near.any()) or all(torch.equal(a, b) for a, b in
                                     zip((outs[0], outs[2], outs[3]), (want[0], want[2], want[3])))
        if not ok:
            bad.append(dict(T=T, splits=s))
        fn = lambda: kernels.moe_route(x, router, *outs)  # noqa: E731
        ms = cs.time_ms(fn, args.iters)
        per = cs.device_ms_by_kernel(fn, args.iters)
        plan = kernels.moe_route_plan(torch.bfloat16, T, E, X, K)
        rows.append(dict(T=T, C=C, kind="route", splits=s, plan=list(plan), ms=ms,
                         device_ms=sum(per.values()), kernels=len(per)))
        print(f"[{args.one}] T 8 route splits {s} {tuple(plan)}: wall {ms:.4f} device "
              f"{sum(per.values()):.4f} ms; floor {floor_dev:.4f}", flush=True)
    if default_splits is not None:
        kernels.MOE_ROUTE_SPLITS = default_splits
        kernels.moe_route_plan.cache_clear()
    return dict(repo=args.one, card=cs.gpu_line(), ptxas=ptxas, sass=sass,
                floor_ms=floor_wall, floor_device_ms=floor_dev, rows=rows, bad=bad)


def probe(args) -> dict:
    """Device ms of the routing of each ``PROBES`` copy (see the module
    docstring)."""
    import ctypes
    import os
    import tempfile

    sys.path.insert(0, str(HERE))
    import torch

    import chip_smoke as cs
    from django_assistant_bot_tpu_torch import kernels

    src = (kernels.CSRC / "moe_route.cu").read_text()
    tmp = tempfile.mkdtemp(prefix="moe_route_probe_")
    procs = {}
    for name, cuts in PROBES.items():
        text = src
        for old, new in cuts:
            if text.count(old) != 1:
                raise SystemExit(f"moe_route.cu no longer holds {old!r} once")
            text = text.replace(old, new)
        cu = os.path.join(tmp, f"{name}.cu")
        Path(cu).write_text(text)
        procs[name] = subprocess.Popen([kernels._nvcc(), *kernels.NVCC_FLAGS, "-o",
                                        cu[:-3] + ".so", cu], stdout=subprocess.PIPE,
                                       stderr=subprocess.PIPE, text=True)
    libs = {}
    for name, proc in procs.items():
        _, err = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"probe {name}: nvcc failed\n{err[-3000:]}")
        fn = ctypes.CDLL(os.path.join(tmp, f"{name}.so")).dabt_moe_route
        fn.argtypes, fn.restype = kernels._ARGTYPES["moe_route"], ctypes.c_int
        libs[name] = fn
    gen = torch.Generator(device="cuda").manual_seed(37)
    E, X, K = cs.MOE_E, cs.MOE_X, cs.MOE_K
    router = (torch.randn((E, X), generator=gen, device="cuda") * E ** -0.5).to(torch.bfloat16)
    rows = []
    for T, splits in ((8, 1), (8, 4), (2048, 1)):
        x = torch.randn((T, E), generator=gen, device="cuda").to(torch.bfloat16)
        kernels.MOE_ROUTE_SPLITS = splits
        kernels.moe_route_plan.cache_clear()
        plan = kernels.moe_route_plan(torch.bfloat16, T, E, X, K)
        C = max(8, -(-5 * T * K // (4 * X)))
        outs = [torch.empty((T, K), dtype=torch.int32, device="cuda"),
                torch.empty((T, K), dtype=torch.float32, device="cuda"),
                torch.empty((X, C), dtype=torch.int32, device="cuda"),
                torch.empty((X,), dtype=torch.int32, device="cuda"),
                torch.empty(max(plan.scratch, 1), dtype=torch.float32, device="cuda"),
                torch.zeros(1, dtype=torch.int32, device="cuda")]
        stream = torch.cuda.current_stream().cuda_stream
        for name, fn in libs.items():
            def call(fn=fn):
                err = fn(x.data_ptr(), router.data_ptr(), *[t.data_ptr() for t in outs], 1, T,
                         E, X, K, C, plan.xmax, plan.splits, 1, 1, stream)
                if err:
                    raise RuntimeError(f"probe {name}: cudaError {err}")

            dev = sum(cs.device_ms_by_kernel(call, args.iters).values())
            rows.append(dict(T=T, splits=splits, form=plan.form, probe=name, device_ms=dev))
            print(f"probe T {T} {plan.form} splits {splits} {name}: device {dev:.4f} ms",
                  flush=True)
    return dict(card=cs.gpu_line(), probes=rows)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--repo", default="")
    ap.add_argument("--tokens", default="8,512,2048")
    ap.add_argument("--splits", default="")
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--probe", action="store_true")
    ap.add_argument("--one", default="", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.probe:
        print(json.dumps(probe(args)))
        return 0
    if args.one:
        out = turn(args)
        print("TURN " + json.dumps(out))
        return 2 if out["bad"] else 0
    order = [args.repo, str(HERE), str(HERE), args.repo] if args.repo else [str(HERE)]
    turns = []
    for repo in order:
        cmd = [sys.executable, __file__, "--one", repo, "--tokens", args.tokens, "--splits",
               args.splits, "--iters", str(args.iters)]
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=900)
        print(proc.stdout.rsplit("TURN ", 1)[0], end="")
        if proc.returncode not in (0, 2) or "TURN " not in proc.stdout:
            print(proc.stderr[-4000:], file=sys.stderr)
            return 1
        turns.append(json.loads(proc.stdout.rsplit("TURN ", 1)[1]))
    print(f"card: {turns[0]['card']}")
    for t in turns:
        print(f"{t['repo']}: ptxas {t['ptxas']}; SASS {t['sass']}; floor device "
              f"{t['floor_device_ms']:.4f} ms")
    keys = list(dict.fromkeys((r["T"], r["kind"], r.get("splits")) for t in turns
                              for r in t["rows"]))
    for key in keys:
        cells = []
        for t in turns:
            r = next((r for r in t["rows"] if (r["T"], r["kind"], r.get("splits")) == key), None)
            cells.append("-" if r is None else f"{r['device_ms']:.4f} ({r['kernels']})")
        print(f"T {key[0]} {key[1]}" + (f" splits {key[2]}" if key[2] else "")
              + ": device ms (kernels) by turn " + " / ".join(cells))
    print(json.dumps({"card": turns[0]["card"], "turns": turns}))
    return 2 if any(t["bad"] for t in turns) else 0


if __name__ == "__main__":
    sys.exit(main())
