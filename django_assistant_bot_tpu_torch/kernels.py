"""Build, bind and launch the hand-written Hopper kernels in ``csrc/``.

Each ``csrc/<name>.cu`` exports one C entry point and is compiled on first
use by its own ``nvcc`` process (all sources in parallel) into a shared
library under ``build/`` beside this file, named by a hash of the source and
the flags, so an edited source rebuilds and an unchanged one is reused.  The
libraries are loaded with ``ctypes``; every pointer (and the stream) is
passed as ``c_void_p``.  A kernel launches on ``torch.cuda.current_stream()``,
allocates nothing (the launch functions allocate outputs and scratch with
``torch.empty``) and
returns ``cudaGetLastError()``, which :func:`_check` turns into an exception.

``LAUNCHES`` counts launches per kernel: the launch functions below add one
each time they launch, and nowhere else, so a run can show that its main
path went through the kernels (:func:`reset_counts`, :func:`launch_counts`).

Nothing here touches CUDA, ``nvcc`` or the build directory at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import Dict, Optional, Sequence

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# kernel name -> (source file stem, C symbol)
KERNELS = {
    "flash_prefill": ("flash_prefill", "dabt_flash_prefill"),
    "paged_decode": ("paged_decode", "dabt_paged_decode"),
}

LAUNCHES: Dict[str, int] = {name: 0 for name in KERNELS}

# nvcc's stderr per kernel from the last build in this process (ptxas
# register / shared-memory report); empty for a library reused from disk
BUILD_LOG: Dict[str, str] = {}

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = {
    # q, k, v, o, dtype, B, H, KH, Sq, Sk, D, causal, window, stream
    "flash_prefill": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    # q, k_pool, v_pool, out, block_tables, positions, active, part_m, part_l,
    # part_acc, dtype, B, H, KH, P, page, NB, D, window, stream
    "paged_decode": [_P] * 10 + [_I] * 9 + [_P],
}


def reset_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def launch_counts() -> Dict[str, int]:
    return dict(LAUNCHES)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the Hopper kernels are built with the CUDA toolkit")


def _lib_path(stem: str) -> Path:
    src = (CSRC / f"{stem}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{stem}-{digest}.so"


def lib_path(name: str) -> Path:
    """The shared library that :func:`build` makes for kernel ``name``."""
    return _lib_path(KERNELS[name][0])


def build(names: Optional[Sequence[str]] = None) -> float:
    """Compile (if needed) and load the named kernels (default: all), one
    ``nvcc`` per source, all started together.  Returns the seconds spent."""
    t0 = time.perf_counter()
    names = list(names or KERNELS)
    with _lock:
        todo = [n for n in names if n not in _libs]
        procs = {}
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        for name in todo:
            stem = KERNELS[name][0]
            out = _lib_path(stem)
            if out.exists():
                continue
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{stem}.cu")]
            procs[name] = (
                subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True),
                tmp,
                out,
            )
        failed = []
        for name, (proc, tmp, out) in procs.items():
            stdout, stderr = proc.communicate()
            BUILD_LOG[name] = stdout + stderr
            if proc.returncode != 0:
                failed.append(f"{name}: nvcc exited {proc.returncode}\n{stderr}")
                os.unlink(tmp)
            else:
                os.replace(tmp, out)  # atomic: a concurrent build sees all or nothing
        if failed:
            raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
        for name in todo:
            stem, symbol = KERNELS[name]
            lib = ctypes.CDLL(str(_lib_path(stem)))
            fn = getattr(lib, symbol)
            fn.argtypes = _ARGTYPES[name]
            fn.restype = ctypes.c_int
            _libs[name] = lib
    return time.perf_counter() - t0


def _fn(name: str):
    if name not in _libs:
        build([name])
    return getattr(_libs[name], KERNELS[name][1])


def _check(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed with cudaError {err}")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def dtype_code(dtype: torch.dtype) -> int:
    if dtype not in _DTYPE_CODE:
        raise TypeError(f"kernels take float32 or bfloat16 tensors, got {dtype}")
    return _DTYPE_CODE[dtype]


def flash_prefill(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor,
    *, causal: bool, window: Optional[int],
) -> None:
    """Launch the flash prefill kernel; the caller validated the arguments."""
    B, H, Sq, D = q.shape
    KH, Sk = k.shape[1], k.shape[2]
    fn = _fn("flash_prefill")
    with torch.cuda.device(q.device):
        err = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            dtype_code(q.dtype), B, H, KH, Sq, Sk, D, int(causal),
            int(window) if window is not None else 0, _stream(q),
        )
    LAUNCHES["flash_prefill"] += 1
    _check("flash_prefill", err)


def paged_decode(
    q: torch.Tensor, k_pool: torch.Tensor, v_pool: torch.Tensor, out: torch.Tensor,
    block_tables: torch.Tensor, positions: torch.Tensor, active: Optional[torch.Tensor],
    *, window: Optional[int],
) -> None:
    """Launch the paged decode kernels (a split per logical page, then the
    merge of the splits); the caller validated the arguments.  One f32
    scratch allocation holds the [B, H, NB] partial maxima and sums and the
    [B, H, NB, D] partial accumulators."""
    B, H, _, D = q.shape
    P, KH, page, _ = k_pool.shape
    NB = block_tables.shape[1]
    n = B * H * NB
    scratch = torch.empty(n * (D + 2), dtype=torch.float32, device=q.device)
    fn = _fn("paged_decode")
    with torch.cuda.device(q.device):
        err = fn(
            q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), out.data_ptr(),
            block_tables.data_ptr(), positions.data_ptr(),
            active.data_ptr() if active is not None else None,
            scratch[:n].data_ptr(), scratch[n:2 * n].data_ptr(), scratch[2 * n:].data_ptr(),
            dtype_code(q.dtype), B, H, KH, P, page, NB, D,
            int(window) if window is not None else 0, _stream(q),
        )
    LAUNCHES["paged_decode"] += 1
    _check("paged_decode", err)
