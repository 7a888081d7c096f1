#!/usr/bin/env python3
"""Time the port's paged tree attention kernel of one checkout on the card.

    python3 tools/paged_tree_ab.py --repo DIR [--iters N] [--min-items 2,4,8]

Imports ``django_assistant_bot_tpu_torch`` from ``DIR`` (a checkout of this
repository, e.g. an earlier commit unpacked with ``git archive``), builds its
tree kernel there and times ``paged_tree_attention`` in bf16 at Llama-3-8B's
verify width (B=8, H=32, KH=8, D=128, page 512, NB=8) over bf16 and e4m3
pools, on ``chip_smoke.py`` phase 2's rows:

- ``timed``: 10,208 live keys, the (4, 4) tree (T 17);
- ``main-path``: 1,868 live keys, T 17;
- ``T65``: the timed rows under an (8, 8) tree (a checkout whose kernel
  refuses it reports the refusal).

Prints one JSON line: per case, the wall ms per back-to-back call (CUDA
events), the device ms per call (torch.profiler), the bound, and the worst
error over ``paged_tree_bf16_bound`` against the twin, with the card's name
and power limit.  ``--min-items`` times the checkout's kernel at
each least number of items a block (``kernels.PAGED_TREE_MIN_ITEMS``; a
checkout without it is timed once).  ``--variants`` also times probes of
this checkout's source built beside it (their outputs are not right, only
their times mean something): ``no_products`` skips both products and the
softmax, ``no_loads`` issues no TMA copy and waits for none, ``item_fence``
adds a proxy fence after each item, ``no_merge`` skips the rows'
merges, ``s_only`` skips P.V, ``no_s`` Q.K^T, ``no_mask`` the score
masks, ``one_wg`` the second warpgroup's products, ``shallow`` and ``deep``
change the ring's depth; a "+" joins probes.  To compare two
checkouts, run it in turns in one chip call (A, B, B, A).  Needs one CUDA
card; fails without one.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent

CASES = {
    "timed": ([6, 512, 513, 1042, 1837, 4096, 1501, 701], (4, 4)),
    "main-path": ([106, 356, 486, 917, 1, 1, 1, 0], (4, 4)),
    "T65": ([6, 512, 513, 1042, 1837, 4096, 1501, 701], (8, 8)),
}


# probe variants of csrc/paged_tree.cu: (text, replacement) pairs
VARIANTS = {
    "no_products": [("    if (wglive) {  // warpgroup-uniform",
                     "    if (wglive && a.min_items < 0) {  // warpgroup-uniform")],
    "no_loads": [("  auto issue = [&](int i, int stage) {\n",
                  "  auto issue = [&](int i, int stage) {\n    return;\n"),
                 ("    mbar_wait(full + st, (phase >> st) & 1u);", "")],
    "item_fence": [("    // generic write into a stage, were fenced for the async proxy when made)\n"
                    "    __syncthreads();",
                    "    // generic write into a stage, were fenced for the async proxy when made)\n"
                    "    fence_proxy_async();\n    __syncthreads();")],
    "no_merge": [("  for (int pm = 0; pm < npend; ++pm) {", "  for (int pm = 0; pm < 0; ++pm) {")],
    "s_only": [("        if (kk * 16 < nk) {", "        if (kk * 16 < nk && a.min_items < 0) {")],
    "no_mask": [("          s[4 * j + e] = keep ? s[4 * j + e] * a.scale_log2 : -INFINITY;",
                 "          s[4 * j + e] = s[4 * j + e] * a.scale_log2;")],
    "no_s": [("          wgmma_qk64(s, qf[ks],", "          if (a.min_items < 0) wgmma_qk64(s, qf[ks],"),
             ("          wgmma_qk32(s16, qf[ks],", "          if (a.min_items < 0) wgmma_qk32(s16, qf[ks],")],
    "one_wg": [("    wglive = r0 + (warp >> 2) * 64 < R;",
                "    wglive = r0 + (warp >> 2) * 64 < R && warp < 4;")],
    "shallow": [("return fp8 ? 6 : 4;", "return fp8 ? 4 : 3;")],
    "deep": [("return fp8 ? 6 : 4;", "return fp8 ? 8 : 6;")],
}


def build_variant(kernels, name: str):
    """Build the probe ``name`` (variants joined by "+") of this checkout's
    tree source and put it in place of the loaded library."""
    import ctypes
    import subprocess
    import tempfile

    src = (kernels.CSRC / "paged_tree.cu").read_text()
    for old, new in (pair for part in name.split("+") for pair in VARIANTS[part]):
        if old not in src:
            raise SystemExit(f"variant {name}: {old!r} not in the source")
        src = src.replace(old, new)
    tmp = Path(tempfile.mkdtemp(dir=kernels.BUILD_DIR))
    (tmp / "paged_tree.cu").write_text(src)
    lib = tmp / "libvariant.so"
    done = subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, f"-I{kernels.CSRC}", "-o",
                           str(lib), str(tmp / "paged_tree.cu")], check=True, capture_output=True,
                          text=True)
    lines = (done.stdout + done.stderr).splitlines()
    for at, line in enumerate(lines):  # ptxas on the tensor-core kernels
        if "Function properties for" in line and "mma_kernel" in line and at + 2 < len(lines):
            print(f"{name}: {line.split('mma_kernel')[1][:14]} {lines[at + 1].strip()}; "
                  f"{lines[at + 2].split(':', 1)[1].strip()}", file=sys.stderr)
    cdll = ctypes.CDLL(str(lib))
    fn = getattr(cdll, kernels.KERNELS["paged_tree"][1])
    fn.argtypes = kernels._ARGTYPES["paged_tree"]
    fn.restype = ctypes.c_int
    kernels._libs["paged_tree"] = cdll


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--repo", required=True, help="checkout whose package is timed")
    ap.add_argument("--iters", type=int, default=200)
    ap.add_argument("--min-items", default="", help="comma-separated values to sweep")
    ap.add_argument("--variants", default="", help="comma-separated probes (see above)")
    opts = ap.parse_args()
    repo = Path(opts.repo).resolve()
    # this checkout's timing helpers (chip_smoke.py's public ones), whichever
    # checkout's package is timed: that one comes first on the path
    sys.path.insert(0, str(HERE))
    import chip_smoke as smoke

    sys.path.insert(0, str(repo))

    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: paged_tree_ab.py runs only on the card", file=sys.stderr)
        return 2
    import django_assistant_bot_tpu_torch as pkg
    from django_assistant_bot_tpu_torch import kernels
    from django_assistant_bot_tpu_torch.ops.attention import paged_tree_attention

    if Path(pkg.__file__).resolve().parent.parent != repo:
        print(f"imported {pkg.__file__}, not from {repo}", file=sys.stderr)
        return 2
    kernels.build(["paged_tree"])
    sweep = [int(v) for v in opts.min_items.split(",") if v]
    if not sweep or not hasattr(kernels, "PAGED_TREE_MIN_ITEMS"):
        sweep = [getattr(kernels, "PAGED_TREE_MIN_ITEMS", None)]
    runs = [(None, m) for m in sweep]
    runs += [(v, sweep[0]) for v in opts.variants.split(",") if v]
    gen = torch.Generator(device="cuda").manual_seed(0)
    result = {"repo": str(opts.repo), "card": smoke.gpu_line(), "runs": []}
    cases = {name: smoke._tree_case(lengths, torch.bfloat16, gen, tree=tree)
             for name, (lengths, tree) in CASES.items()}
    for variant, min_items in runs:
        if variant is not None:
            build_variant(kernels, variant)
        if min_items is not None:
            kernels.PAGED_TREE_MIN_ITEMS = min_items
        run = {"variant": variant or "as built", "min_items": min_items, "cases": {}}
        for name, base in cases.items():
            for fmt in (None, "e4m3"):
                args = smoke.narrow_pools(base, fmt, torch.bfloat16)
                key = f"{name} {fmt or 'bf16'}"
                try:
                    paged_tree_attention(*args)
                except ValueError as e:  # a tree past what the checkout's kernel takes
                    run["cases"][key] = {"refused": str(e)}
                    continue
                ms, dev = smoke.timed(lambda: paged_tree_attention(*args), opts.iters)
                bound_ms, bound_by = smoke.tree_bound_ms(args, kv_bytes=args[1].element_size())
                _, (_, _, ratio) = smoke._tree_check(args)  # within paged_tree_bf16_bound: <= 1
                run["cases"][key] = dict(live_keys=sum(CASES[name][0]), ms=ms, device_ms=dev,
                                         bound_ms=bound_ms, bound_by=bound_by, err_bound=ratio)
        result["runs"].append(run)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
