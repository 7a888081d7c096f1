#!/usr/bin/env python3
"""Build kernel sources of two checkouts with the port's nvcc flags and
compare their machine code: each function's SASS and ptxas's registers and
spills.

    python3 tools/sass_compare.py --old DIR [--stem qgemm] [--stem ...]
                                  [--function NAME] [--function ...]

``DIR`` is another checkout of this repository (for example a ``git
archive`` of the parent commit).  For each stem, ``csrc/<stem>.cu`` of both
checkouts is built as ``kernels.build`` builds it (``kernels.NVCC_FLAGS``,
all builds started together); ``cuobjdump -sass`` splits each library into
functions, and a function's SASS is its instruction text without the lines
that name a symbol (anonymous-namespace names differ between two files).
Prints, per stem, whether the multisets of function SASS and of ptxas
"Used N registers" / spill lines are equal, and exits 1 if any stem
differs.  ``--function`` keeps only the functions whose mangled name holds
one of the given names (e.g. ``qgemm_stream_kernel``), so kernels that one
side adds or removes can be left out.  Needs ``nvcc`` and ``cuobjdump`` (the CUDA toolkit), no card.
"""

from __future__ import annotations

import argparse
import hashlib
import re
import shutil
import subprocess
import sys
import tempfile
from collections import Counter
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent
CSRC = Path("django_assistant_bot_tpu_torch") / "csrc"


def _tool(name: str) -> str:
    found = shutil.which(name) or f"/usr/local/cuda/bin/{name}"
    if not Path(found).exists():
        raise SystemExit(f"sass_compare: {name} not found")
    return found


def _wanted(name: str, names) -> bool:
    return not names or any(n in name for n in names)


def _functions(lib: Path, names=()) -> Counter:
    """The library's functions (those ``names`` select), as a multiset of
    SASS digests."""
    dump = subprocess.run([_tool("cuobjdump"), "-sass", str(lib)], capture_output=True, text=True,
                          check=True).stdout
    out: Counter = Counter()
    parts = re.split(r"^\s*Function : (.*)$", dump, flags=re.M)
    for name, body in zip(parts[1::2], parts[2::2]):
        if not _wanted(name, names):
            continue
        code = [ln.strip() for ln in body.splitlines() if ln.strip() and "_GLOBAL__N_" not in ln]
        out[hashlib.sha256("\n".join(code).encode()).hexdigest()[:16]] += 1
    return out


def _ptxas(log: str, names=()) -> Counter:
    """ptxas's register and spill lines (of the functions ``names``
    selects), function names left out."""
    keep, current = [], ""
    for ln in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) '?([^' ]+)", ln)
        if m:
            current = m.group(1)
        if ("Used" in ln or "spill" in ln) and _wanted(current, names):
            keep.append(re.sub(r"^.*?(Used|\d+ bytes)", r"\1", ln).strip())
    return Counter(keep)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--old", required=True)
    ap.add_argument("--stem", action="append", default=[])
    ap.add_argument("--function", action="append", default=[],
                    help="compare only functions whose mangled name holds NAME")
    args = ap.parse_args()
    sys.path.insert(0, str(HERE))
    from django_assistant_bot_tpu_torch import kernels

    stems = args.stem or ["qgemm"]
    roots = {"old": Path(args.old).resolve(), "new": HERE}
    tmp = Path(tempfile.mkdtemp(prefix="sass_compare_"))
    procs = {}
    for stem in stems:
        for side, root in roots.items():
            lib = tmp / f"{side}_{stem}.so"
            cmd = [_tool("nvcc"), *kernels.NVCC_FLAGS, "-o", str(lib), str(root / CSRC / f"{stem}.cu")]
            procs[(stem, side)] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                    stderr=subprocess.STDOUT, text=True), lib)
    logs = {}
    for key, (proc, lib) in procs.items():
        logs[key] = proc.communicate()[0]
        if proc.returncode != 0:
            print(f"{key}: nvcc exited {proc.returncode}\n{logs[key]}")
            return 1
    differ = False
    for stem in stems:
        sass = {side: _functions(procs[(stem, side)][1], args.function) for side in roots}
        regs = {side: _ptxas(logs[(stem, side)], args.function) for side in roots}
        same_sass, same_regs = sass["old"] == sass["new"], regs["old"] == regs["new"]
        differ |= not (same_sass and same_regs)
        print(f"{stem}: {sum(sass['new'].values())} functions (old {sum(sass['old'].values())}); "
              f"SASS {'equal' if same_sass else 'DIFFERS'}; ptxas registers and spills "
              f"{'equal' if same_regs else 'DIFFER'}")
        for side in roots:
            print(f"  {side} ptxas: {sorted(regs[side].items())}")
    shutil.rmtree(tmp, ignore_errors=True)
    return 1 if differ else 0


if __name__ == "__main__":
    sys.exit(main())
