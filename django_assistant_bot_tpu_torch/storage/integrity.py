"""CRC-32C (Castagnoli): the port's copy of the JAX package's
``storage/integrity.py`` (the port imports nothing of that package).  The
durable retrieval plane (:mod:`.durable`) stamps and verifies it over WAL
records and snapshot artifacts, so a directory either package wrote
verifies in the other.

The software path is slicing-by-8 (Intel's algorithm, reflected polynomial
``0x82F63B78``); a hardware/C ``crc32c`` module is picked up automatically when
the host has one — both produce identical values (same polynomial), which
``tests/test_torch_durable.py`` pins with known vectors.  The port adds one
path: a buffer of ``_LANES_MIN_BYTES`` or more is cut into 1,024 lanes whose
slicing-by-8 steps run side by side as numpy array operations, and the lanes'
CRC registers are folded together by the linear map that appending zero bytes
is (a 32 x 32 matrix over GF(2)).  The value is the table loop's, bit for bit,
and the table loop, a Python statement per 8 bytes, is what it saves on the
snapshot and WAL digests of a large corpus.
"""

from __future__ import annotations

import functools
import struct
from typing import Optional

import numpy as np


def _crc32c_tables() -> tuple:
    # slicing-by-8 tables (Intel's algorithm, reflected): T[0] is the classic
    # byte-at-a-time table, T[j][b] the CRC of byte b followed by j zero bytes
    poly = 0x82F63B78  # Castagnoli, reflected
    base = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ poly if (c & 1) else (c >> 1)
        base.append(c)
    tables = [tuple(base)]
    for _ in range(7):
        prev = tables[-1]
        tables.append(tuple((p >> 8) ^ base[p & 0xFF] for p in prev))
    return tuple(tables)


_CRC32C_TABLES = _crc32c_tables()

try:  # hardware/C implementation when the host has one (same polynomial)
    from crc32c import crc32c as _crc32c_hw  # type: ignore
except ImportError:
    _crc32c_hw = None


def _crc_raw(c: int, data) -> int:
    """The CRC register ``c`` after ``data`` (no pre- or post-inversion)."""
    t0, t1, t2, t3, t4, t5, t6, t7 = _CRC32C_TABLES
    n8 = len(data) - (len(data) % 8)
    for w0, w1 in struct.iter_unpack("<II", memoryview(data)[:n8]):
        c ^= w0
        c = (
            t7[c & 0xFF] ^ t6[(c >> 8) & 0xFF]
            ^ t5[(c >> 16) & 0xFF] ^ t4[(c >> 24) & 0xFF]
            ^ t3[w1 & 0xFF] ^ t2[(w1 >> 8) & 0xFF]
            ^ t1[(w1 >> 16) & 0xFF] ^ t0[(w1 >> 24) & 0xFF]
        )
    for b in memoryview(data)[n8:]:
        c = t0[(c ^ b) & 0xFF] ^ (c >> 8)
    return c


# ---- the lane-parallel path: registers as GF(2)-linear maps
_LANES_MIN = 1024  # lanes of a buffer: a power of two, about one per 8 KB
_LANES_MIN_BYTES = 1 << 16


def _op_apply(op, v: int) -> int:
    """A 32 x 32 GF(2) matrix (its 32 columns, the images of bits 0-31)
    applied to the register ``v``."""
    x = 0
    for i in range(32):
        if (v >> i) & 1:
            x ^= op[i]
    return x


def _op_after(a, b):
    """The map ``a`` after ``b``."""
    return tuple(_op_apply(a, b[i]) for i in range(32))


@functools.lru_cache(maxsize=1)
def _zero_byte_op():
    """The register map of one zero byte: ``c -> t0[c & 0xFF] ^ (c >> 8)``."""
    return tuple(_crc_raw(1 << i, b"\0") for i in range(32))


@functools.lru_cache(maxsize=64)
def _zeros_op(nbytes: int):
    """The register map of ``nbytes`` zero bytes (square and multiply)."""
    result, power = None, _zero_byte_op()
    while nbytes:
        if nbytes & 1:
            result = power if result is None else _op_after(power, result)
        nbytes >>= 1
        if nbytes:
            power = _op_after(power, power)
    return result


def _op_apply_array(op, x: np.ndarray) -> np.ndarray:
    out = np.zeros_like(x)
    for i in range(32):
        out ^= ((x >> np.uint32(i)) & np.uint32(1)) * np.uint32(op[i])
    return out


def _crc_lanes(c: int, data) -> tuple:
    """(register after the first ``done`` bytes of ``data``, ``done``): the
    bytes cut into a power-of-two count of lanes of ``lane`` bytes (a
    multiple of 8), each lane's register from 0 stepped with the
    slicing-by-8 tables as array operations (the first lane's from ``c``),
    then the lanes folded in pairs, ``A, B -> Z(A) ^ B`` with ``Z`` the map
    of B's length in zero bytes."""
    lanes = max(_LANES_MIN, 1 << max(0, (len(data) // 8192).bit_length() - 1))
    lane = (len(data) // lanes) // 8 * 8
    done = lane * lanes
    w = np.frombuffer(data, dtype="<u4", count=done // 4).reshape(lanes, lane // 4)
    t = [np.asarray(tab, np.uint32) for tab in _CRC32C_TABLES]
    reg = np.zeros(lanes, np.uint32)
    reg[0] = c
    m8 = np.uint32(0xFF)
    for i in range(0, lane // 4, 2):
        r = reg ^ w[:, i]
        w1 = w[:, i + 1]
        reg = (t[7][r & m8] ^ t[6][(r >> np.uint32(8)) & m8] ^ t[5][(r >> np.uint32(16)) & m8]
               ^ t[4][r >> np.uint32(24)] ^ t[3][w1 & m8] ^ t[2][(w1 >> np.uint32(8)) & m8]
               ^ t[1][(w1 >> np.uint32(16)) & m8] ^ t[0][w1 >> np.uint32(24)])
    op = _zeros_op(lane)
    while reg.shape[0] > 1:
        pairs = reg.reshape(-1, 2)
        reg = _op_apply_array(op, pairs[:, 0]) ^ pairs[:, 1]
        op = _op_after(op, op)
    return int(reg[0]), done


def crc32c(data, crc: int = 0) -> int:
    """CRC-32C (Castagnoli) of bytes-like ``data``; ``crc`` chains a
    running checksum across buffers (k bytes then v bytes, no concat copy).
    The C path when a ``crc32c`` module exists; else the lane-parallel path
    for the bulk of a large buffer and slicing-by-8 for the rest."""
    if _crc32c_hw is not None:
        return _crc32c_hw(bytes(data), crc)
    if not isinstance(data, (bytes, bytearray)):
        data = bytes(data)
    c = ~crc & 0xFFFFFFFF
    if len(data) >= _LANES_MIN_BYTES:
        c, done = _crc_lanes(c, data)
        data = memoryview(data)[done:]
    return ~_crc_raw(c, data) & 0xFFFFFFFF


def entry_crc32c(k, v) -> int:
    """The checksum stamped on a KV wire/disk entry: CRC-32C over the K page
    bytes chained into the V page bytes, exactly the byte order the wire
    envelope and the spill file store them in."""
    c = crc32c(np.ascontiguousarray(k).view(np.uint8).reshape(-1).tobytes())
    return crc32c(np.ascontiguousarray(v).view(np.uint8).reshape(-1).tobytes(), c)


def file_crc32c(path: str, chunk_bytes: int = 16 << 20) -> Optional[int]:
    """CRC-32C of a whole file, streamed (snapshot-manifest artifact digests).
    Returns None when the file cannot be read — the caller decides whether a
    missing artifact is corruption (manifest says it should exist) or not."""
    try:
        c = 0
        with open(path, "rb") as f:
            while True:
                block = f.read(chunk_bytes)
                if not block:
                    break
                c = crc32c(block, c)
        return c
    except OSError:
        return None
