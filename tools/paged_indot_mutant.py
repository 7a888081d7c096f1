#!/usr/bin/env python3
"""Show that phase 2's in-dot probe can fail a kernel that the loose bound passes.

    python3 tools/paged_indot_mutant.py

Builds, into a temporary directory, a copy of ``csrc/paged_decode.cu`` whose
in-dot read (``fp8_dot=True``) skips the scheme's rounding of P to the pool's
fp8 format (the tensor-core kernel takes P in bf16, the CUDA-core kernels P
in q's dtype), and loads it in place of the built library.  At ``chip_smoke.py``
phase 2's two paged shapes (10,208 and 1,868 live keys; B=8, H=32, KH=8, D=128,
page 512), e4m3 and e5m2 pools, bf16 and f32 queries, it prints the copy's
worst err/bound against the plain twin:

- on ``paged_fp8_dot_probe``'s inputs to ``paged_bf16_bound``: must exceed 1,
  as ``chip_smoke.check_indot_probe`` requires of its control;
- on random inputs to ``paged_fp8_dot_bound``, the bound random inputs allow.

Prints one JSON line with both per case and the card's name and power limit;
exits 1 if the copy meets the probe's bound anywhere.  Needs one CUDA card.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
import tempfile
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent

# the in-dot scheme's P rounding in both kernels, and what the copy has instead
CUTS = [
    ("pa[0] = pack_fp8_bf16(p[0][0], p[0][1], kind);", ""),
    ("pa[2] = pack_fp8_bf16(p[1][0], p[1][1], kind);", ""),
    ("const int pfmt = indot ? kfmt : (sizeof(T) == 4 ? KV_F32 : KV_BF16);",
     "const int pfmt = sizeof(T) == 4 ? KV_F32 : KV_BF16;"),
]


def main() -> int:
    sys.path.insert(0, str(HERE))
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: paged_indot_mutant.py runs only on the card", file=sys.stderr)
        return 2
    import chip_smoke as smoke
    from django_assistant_bot_tpu_torch import kernels
    from django_assistant_bot_tpu_torch.ops.attention import (
        paged_bf16_bound, paged_fp8_dot_probe, paged_gqa_decode_attention,
        paged_gqa_decode_attention_plain)

    torch.backends.cuda.matmul.allow_tf32 = False
    src = (kernels.CSRC / "paged_decode.cu").read_text()
    for old, new in CUTS:
        if src.count(old) != 1:
            print(f"paged_decode.cu no longer holds {old!r}", file=sys.stderr)
            return 2
        src = src.replace(old, new)
    tmp = Path(tempfile.mkdtemp())
    (tmp / "paged_decode.cu").write_text(src)
    subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, "-o", str(tmp / "mutant.so"),
                    str(tmp / "paged_decode.cu")], check=True, capture_output=True)
    lib = ctypes.CDLL(str(tmp / "mutant.so"))
    fn = getattr(lib, kernels.KERNELS["paged_decode"][1])
    fn.argtypes, fn.restype = kernels._ARGTYPES["paged_decode"], ctypes.c_int
    for extra, (argtypes, restype) in kernels._EXTRA_SYMBOLS["paged_decode"].items():
        getattr(lib, extra).argtypes, getattr(lib, extra).restype = argtypes, restype
    kernels._libs["paged_decode"] = lib
    kernels._paged_need.clear()

    B, H, KH, D, NB, page = 8, 32, 8, 128, 8, 512
    shapes = {"timed": ([5, 511, 512, 1041, 1836, 4095, 1500, 700], [6]),
              "main-path": ([105, 355, 485, 915, 0, 0, 0, 0], [4, 5, 6, 7])}
    gen = torch.Generator(device="cuda").manual_seed(0)
    cases, caught = [], True
    for fmt in smoke.FP8_KV:
        q, kp, vp = (t.cuda() for t in paged_fp8_dot_probe(
            B, H, KH, D, B * NB, page, smoke._kv_dtype(fmt), torch.float32,
            torch.Generator().manual_seed(0)))
        for label, (pos_list, inact) in shapes.items():
            base, active, _, _ = smoke._paged_case(B, H, KH, D, page, NB, torch.bfloat16,
                                                   pos_list, inact, None, gen)
            for qdtype in (torch.bfloat16, torch.float32):
                ref = paged_gqa_decode_attention_plain(q, kp, vp, *base[3:], active=active,
                                                       fp8_dot=True)
                bound = paged_bf16_bound(q, kp, vp, *base[3:], ref, active=active)
                out = paged_gqa_decode_attention(q.to(qdtype), kp, vp, *base[3:], active=active,
                                                 fp8_dot=True)
                torch.cuda.synchronize()
                probe = ((out.float() - ref).abs() / bound).max().item()
                _, (_, _, loose) = smoke._narrow_check(smoke.narrow_pools(base, fmt, qdtype),
                                                       active, None, True)
                caught &= probe > 1.0
                cases.append(dict(fmt=fmt, shape=label, q=str(qdtype)[6:], probe=probe,
                                  loose=loose))
    print(json.dumps({"card": smoke.gpu_line(), "mutant_caught": caught, "cases": cases}))
    return 0 if caught else 1


if __name__ == "__main__":
    sys.exit(main())
