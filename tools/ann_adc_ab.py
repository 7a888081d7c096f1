#!/usr/bin/env python3
"""Time and check the port's ADC scan + shortlist (``csrc/ann_adc.cu``) on
the card, on ``chip_smoke.py`` phase 9's corpus (2,000,000 x 768 through
``ANNIndex.add`` + ``train()``, built once with ``chip_smoke.ann_build``).

    python3 tools/ann_adc_ab.py [--repo DIR] [--cases 8:64,32:64,1:64,8:1024,128:1024]
                                [--shortlist 256] [--iters N]

With ``--repo DIR`` (another checkout of this repository, e.g. the parent
commit unpacked with ``git archive``) it runs four turns, DIR, this checkout,
this checkout, DIR (A/B/B/A), in one process on the one corpus: DIR's
package is imported under another name (its modules import one another
relatively), so each turn calls its checkout's own
``storage.ann.adc_shortlist``, which builds and launches that checkout's
kernel (the lists' fill is passed where the function takes one).  Without
it, two turns of this checkout.

For each case Q:nprobe (queries near corpus rows, the centroid top-nprobe
and LUT as ``_adc_shortlist`` makes them, shortlist S): every turn's scores
and positions must equal the first turn's bit for bit, and at nprobe 64 the
plain twin's (``adc_shortlist_plain``; past it the twin's gather would not
fit the card); wall ms per back-to-back call (CUDA events) and device ms
(torch.profiler, summed over the call's kernels, with the kernels by name),
beside the bound (``chip_smoke.adc_bound_ms``: to each list's fill, and
the padded figure over every slot) and
the scratch the call allocated (the card's peak memory over one call above
what it held before).

``--probe`` builds, into a temporary directory, copies of this checkout's
``csrc/ann_adc.cu`` cut at the points ``PROBES`` names (each still stores
what it computed) and times each copy's launch, device ms, on the same
cases beside the uncut source built alike: where a call's time goes (the
scan and the blocks' selects, the candidates' publication and ticket, the
last block's merge), with an empty kernel's launch floor.

Prints the card's name and power limit and one JSON line with every
reading; a disagreement exits 2.  Needs one CUDA card; fails without one.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import inspect
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent
PKG = "django_assistant_bot_tpu_torch"

# --probe: name -> the cuts made to csrc/ann_adc.cu ((old, new), each old
# found once); a cut copy returns where the cut is, its block's candidate
# count stored, and leaves the counters at zero
_PUBLISH = "  // ---- the block's top S, sorted, into its query's candidate lists; the ticket\n"
_LAST = "  if (!sm.last) return;\n"
PROBES = {
    "full": [],
    # the scan and its compactions only
    "scan": [(_PUBLISH, "  __syncthreads();\n  if (tid == 0) a.out_pos[q] = sm.count;\n"
              "  if (a.B > 0) return;\n" + _PUBLISH)],
    # up to the ticket: the blocks' last selects and sorts, their lists written
    "publish": [(_LAST, _LAST + "  if (a.B > 0) {\n    if (tid == 0) atomicExch(a.counters + q, 0);\n"
                 "    return;\n  }\n")],
}


def load_ann(repo: Path, alias: str):
    """``storage.ann`` of the checkout at ``repo``, its package imported as
    ``alias`` (this checkout's under its own name)."""
    if repo.resolve() == HERE:
        return importlib.import_module(f"{PKG}.storage.ann")
    init = repo / PKG / "__init__.py"
    spec = importlib.util.spec_from_file_location(alias, init,
                                                  submodule_search_locations=[str(init.parent)])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[alias] = mod
    spec.loader.exec_module(mod)
    return importlib.import_module(f"{alias}.storage.ann")


def probe(args, index, cases, S) -> list:
    """Device ms of each ``PROBES`` copy's launch on each case."""
    import ctypes
    import os
    import subprocess
    import tempfile

    import torch

    import chip_smoke as cs
    from django_assistant_bot_tpu_torch import kernels

    src = (kernels.CSRC / "ann_adc.cu").read_text()
    tmp = tempfile.mkdtemp(prefix="ann_adc_probe_")
    procs = {}
    for name, cuts in PROBES.items():
        text = src
        for old, new in cuts:
            if text.count(old) != 1:
                raise SystemExit(f"ann_adc.cu no longer holds {old!r} once")
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
        fn = ctypes.CDLL(os.path.join(tmp, f"{name}.so")).dabt_ann_adc
        fn.argtypes, fn.restype = kernels._ARGTYPES["ann_adc"], ctypes.c_int
        libs[name] = fn
    floor = cs.device_ms(lambda: torch.cuda._sleep(0), args.iters)
    codes, lvalid, rowpos, fill = index._codes, index._lvalid, index._rowpos, index._fill
    nlist, L, m = codes.shape
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    stream = torch.cuda.current_stream().cuda_stream
    rows = []
    for c in cases:
        Q, P = c["Q"], c["P"]
        plan = kernels.ann_adc_plan(Q, P, L, m, S, index._mean_fill, sms)
        cand = torch.empty(plan.cand_keys, dtype=torch.int64, device="cuda")
        counters = torch.zeros(plan.counters, dtype=torch.int32, device="cuda")
        out_s = torch.empty((Q, S), dtype=torch.float32, device="cuda")
        out_p = torch.empty((Q, S), dtype=torch.int32, device="cuda")
        top_ci, top_c, lut = c["top_ci"].contiguous(), c["top_c"].contiguous(), c["lut"]
        for name, fn in libs.items():
            def call(fn=fn):
                err = fn(codes.data_ptr(), lvalid.data_ptr(), rowpos.data_ptr(), fill.data_ptr(),
                         top_ci.data_ptr(), top_c.data_ptr(), lut.data_ptr(), cand.data_ptr(),
                         counters.data_ptr(), out_s.data_ptr(), out_p.data_ptr(), nlist, L, m, Q,
                         P, S, plan.blocks, plan.chunk, plan.cap, top_ci.stride(0),
                         top_c.stride(0), lut.stride(0), lut.stride(1), stream)
                if err:
                    raise RuntimeError(f"probe {name}: cudaError {err}")

            dev = sum(cs.device_ms_by_kernel(call, args.iters).values())
            rows.append(dict(Q=Q, P=P, probe=name, blocks=plan.blocks, device_ms=dev,
                             floor_ms=floor))
            print(f"probe Q {Q} nprobe {P} ({plan.blocks} blocks a query) {name}: device "
                  f"{dev:.4f} ms (floor {floor:.4f})", flush=True)
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--repo", default="")
    ap.add_argument("--cases", default="8:64,32:64,1:64,8:1024,128:1024")
    ap.add_argument("--shortlist", type=int, default=256)
    ap.add_argument("--iters", type=int, default=30)
    ap.add_argument("--probe", action="store_true")
    args = ap.parse_args()
    sys.path.insert(0, str(HERE))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("ann_adc_ab: no CUDA card")

    import chip_smoke as cs
    from django_assistant_bot_tpu_torch.storage.knn import _normalize

    card = cs.gpu_line()
    print(f"card: {card}", flush=True)
    index, t = cs.ann_build(cs.ANN_ROWS, cs.ANN_DIM, seed=21, dups=cs.ANN_DUPS)
    print(f"corpus {cs.ANN_ROWS} x {cs.ANN_DIM}: {cs._timing_text(t)}; {cs.ann_geometry(index)}; "
          f"mean fill {index._mean_fill}", flush=True)
    repos = [Path(args.repo), HERE, HERE, Path(args.repo)] if args.repo else [HERE, HERE]
    names = {r: ("parent" if args.repo and r != HERE else "change") for r in repos}
    mods = {r: load_ann(r, "dabt_ab_parent") for r in dict.fromkeys(repos)}
    rng = np.random.default_rng(4)
    S = args.shortlist
    cases = []
    for c in args.cases.split(","):
        Q, P = (int(x) for x in c.split(":"))
        src = rng.choice(cs.ANN_ROWS, size=Q, replace=False)
        qs = index._mat[src] + cs.ANN_QUERY_NOISE * rng.standard_normal((Q, cs.ANN_DIM))
        q = torch.from_numpy(_normalize(qs).astype(np.float32)).cuda()
        top_c, top_ci, lut = cs.adc_inputs(index, q, P)
        bound = cs.adc_bound_ms(index, index._lvalid, top_ci, S, index._fill)
        padded = cs.adc_bound_ms(index, index._lvalid, top_ci, S)
        cases.append(dict(Q=Q, P=P, top_c=top_c, top_ci=top_ci, lut=lut, bound=bound,
                          padded=padded))
    if args.probe:
        print(json.dumps({"card": card, "probes": probe(args, index, cases, S)}))
        return 0
    base = (index._codes, index._lvalid, index._rowpos)
    rows, bad, first = [], [], {}
    for turn, repo in enumerate(repos):
        ann = mods[repo]
        takes_fill = "fill" in inspect.signature(ann.adc_shortlist).parameters
        for c in cases:
            call_args = (*base, c["top_ci"], c["top_c"], c["lut"], S)
            extra = (index._fill, index._mean_fill) if takes_fill else ()

            def fn(ann=ann, call_args=call_args, extra=extra):
                return ann.adc_shortlist(*call_args, *extra)

            got = fn()
            torch.cuda.synchronize()
            key = (c["Q"], c["P"])
            ok = True
            if key not in first:
                first[key] = got
                if c["P"] <= 64:
                    want = ann.adc_shortlist_plain(*call_args)
                    ok = torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
            else:
                ok = all(torch.equal(a, b) for a, b in zip(got, first[key]))
            del got
            torch.cuda.synchronize()
            held = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            fn()
            torch.cuda.synchronize()
            scratch = torch.cuda.max_memory_allocated() - held
            ms = cs.time_ms(fn, args.iters)
            per = cs.device_ms_by_kernel(fn, args.iters)
            dev = sum(per.values())
            (b, by), (pb, _) = c["bound"], c["padded"]
            row = dict(turn=turn, repo=names[repo], Q=c["Q"], P=c["P"], S=S, ms=ms, device_ms=dev,
                       by_kernel={cs.kernel_label(k): v for k, v in per.items()}, bound_ms=b,
                       bound_by=by, padded_bound_ms=pb, share=b / dev, padded_share=pb / dev,
                       scratch_bytes=scratch, ok=ok)
            rows.append(row)
            if not ok:
                bad.append(dict(turn=turn, Q=c["Q"], P=c["P"]))
            print(f"[{turn} {names[repo]}] Q {c['Q']} nprobe {c['P']} S {S}: wall {ms:.4f} "
                  f"device {dev:.4f} ms ({', '.join(f'{k} {v:.4f}' for k, v in row['by_kernel'].items())}); "
                  f"bound {b:.5f} ({by}) share {b / dev:.4f}, padded {pb:.5f} share "
                  f"{pb / dev:.4f}; scratch {scratch / 2**20:.1f} MiB; agrees {ok}", flush=True)
    for key in dict.fromkeys((r["Q"], r["P"]) for r in rows):
        cells = [f"{r['repo']} {r['device_ms']:.4f}" for r in rows if (r["Q"], r["P"]) == key]
        print(f"Q {key[0]} nprobe {key[1]}: device ms by turn " + " / ".join(cells))
    print(json.dumps({"card": card, "mean_fill": index._mean_fill, "rows": rows, "bad": bad}))
    return 2 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
