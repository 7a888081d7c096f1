"""Durable retrieval plane: WAL + atomic snapshots for ANN corpora (port of
``storage/durable.py``).

The port's copy of the JAX package's durability plane, with the same record
and manifest byte formats, so a directory either package wrote opens (and
verifies) in the other.  The IVF-PQ index (:mod:`.ann`) is mutated live —
appends, tombstones, retrains; this module logs every mutation before it is
applied and recovers the index after a crash:

- **Write-ahead log** (:class:`WriteAheadLog`): APPEND (ids + f32 rows +
  ledger key), TOMBSTONE (ids), INSTALL (learned centroids + codebooks, so
  recovery re-installs the exact quantizers instead of re-learning them).
  Records carry a CRC-32C (:mod:`.integrity`) over ``seq | type |
  payload``; segments rotate at a byte budget; the fsync knob picks the
  durability/throughput point (``always`` / ``interval`` / ``never``).
- **Atomic snapshots** (:class:`SnapshotStore`): the index's host state is
  written to a temp directory, every artifact digested with CRC-32C into a
  manifest written last, and the directory renamed into place (the commit
  point).  Recovery walks snapshots newest to oldest and verifies digests
  before trusting: a corrupt snapshot is a fallback, not a crash.
- **Recovery** (:meth:`DurableANN.recover`): the latest valid snapshot,
  then the WAL tail replayed through the index's normal mutation paths.  A
  torn tail is truncated at the last valid record, never parsed on faith.
- **Idempotency ledger**: an APPEND can carry a ``doc_id:version`` key;
  re-ingesting one is a no-op, across restarts.
- **Disk row tier** (:class:`MmapRowStore`): an mmap-backed allocator for
  the index's host f32 rows (``ANNIndex(mat_alloc=...)``); the bf16 rerank
  tier stays on the card.

Fault sites ``disk_write_fail`` / ``disk_torn_write`` / ``snapshot_corrupt``
(:mod:`..serving.faults`) are consulted through the global injector.  No
fsync runs on the search path: searches delegate straight to the index.
The bytes here are host files; the index they rebuild lives on ``device``.
"""

from __future__ import annotations

import io
import json
import logging
import os
import struct
import threading
import time
from typing import Iterator, Optional, Sequence

import numpy as np

from .integrity import crc32c, file_crc32c

logger = logging.getLogger(__name__)

# WAL record types
REC_APPEND = 1
REC_TOMBSTONE = 2
REC_INSTALL = 3

_REC_NAMES = {REC_APPEND: "append", REC_TOMBSTONE: "tombstone", REC_INSTALL: "install"}

_WAL_MAGIC = 0x4C415744  # "DWAL" little-endian
# magic u32 | seq u64 | type u8 | payload_len u32 | crc32c u32 (over seq|type|payload)
_HDR = struct.Struct("<IQBII")
_SEQ_TYPE = struct.Struct("<QB")
_MAX_PAYLOAD = 1 << 31  # sanity bound: a plen past this is corruption, not data

_DEF_SEGMENT_BYTES = 64 << 20
_DEF_SYNC_EVERY = 64
_DEF_SYNC_INTERVAL_S = 1.0


def _fault_injector():
    """The chaos plane's global injector, when the faults module is loaded
    or ``DABT_FAULTS`` arms it; None otherwise."""
    import sys

    mod = sys.modules.get("django_assistant_bot_tpu_torch.serving.faults")
    if mod is not None:
        return mod.global_injector()
    if os.environ.get("DABT_FAULTS", "").strip():
        from ..serving.faults import global_injector

        return global_injector()
    return None


def _fsync_dir(path: str) -> None:
    """fsync a directory so a rename/create inside it is durable — without
    this the commit-point rename itself can be lost to a power cut."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:  # platform without directory fds
        return
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


# ------------------------------------------------------------------ WAL codec
def _encode_record(seq: int, rtype: int, payload: bytes) -> bytes:
    crc = crc32c(payload, crc32c(_SEQ_TYPE.pack(seq, rtype)))
    return _HDR.pack(_WAL_MAGIC, seq, rtype, len(payload), crc) + payload


def _read_records(path: str, expect_seq: Optional[int] = None):
    """Sequentially decode one segment file.

    Yields ``(offset, seq, rtype, payload)`` for every valid record, then
    returns via StopIteration — callers use :func:`_scan_segment` for the
    (good_bytes, problem) summary.  Decoding stops at the FIRST bad byte:
    everything after a torn/corrupt record is unreachable by design (the log
    is a prefix code, there is no resynchronization — trusting post-gap
    records would reorder history).
    """
    with open(path, "rb") as f:
        data = f.read()
    off = 0
    while off < len(data):
        if off + _HDR.size > len(data):
            return off, "torn header"
        magic, seq, rtype, plen, crc = _HDR.unpack_from(data, off)
        if magic != _WAL_MAGIC:
            return off, "bad magic"
        if plen > _MAX_PAYLOAD:
            return off, "implausible payload length"
        if off + _HDR.size + plen > len(data):
            return off, "torn payload"
        payload = data[off + _HDR.size : off + _HDR.size + plen]
        if crc32c(payload, crc32c(_SEQ_TYPE.pack(seq, rtype))) != crc:
            return off, "crc mismatch"
        if expect_seq is not None and seq != expect_seq:
            return off, f"sequence discontinuity (want {expect_seq}, got {seq})"
        yield off, seq, rtype, payload
        if expect_seq is not None:
            expect_seq += 1
        off += _HDR.size + plen
    return off, None


def _scan_segment(path: str, expect_seq: Optional[int]):
    """Validate one segment: returns ``(first_seq, last_seq, records,
    good_bytes, problem)`` where ``problem`` is None for a clean file and
    ``good_bytes`` is the offset of the first bad byte otherwise."""
    first = last = None
    count = 0
    gen = _read_records(path, expect_seq)
    while True:
        try:
            _, seq, _, _ = next(gen)
        except StopIteration as stop:
            good, problem = stop.value
            return first, last, count, good, problem
        if first is None:
            first = seq
        last = seq
        count += 1


class WriteAheadLog:
    """Append-only segmented log with per-record CRC-32C and torn-tail heal.

    Opening the log scans existing segments, truncates any torn tail at the
    last valid record, and deletes segments past a torn point (records after
    a gap cannot be ordered against the lost ones).  Appends then continue
    from the healed sequence number.  Thread-safe; every append is
    write-then-(policy-)fsync.

    **Single-writer**: the first opener takes an ``flock`` on ``<dir>/.lock``
    and owns the log; later openers in OTHER processes come up read-only
    (``writable`` False) — they scan without healing (truncating a live
    writer's in-flight tail would corrupt it) and their ``replay`` simply
    stops at the first incomplete record, which by definition is the writer's
    uncommitted edge.  A SIGKILLed writer's lock dies with it, so the next
    opener heals and takes over.
    """

    def __init__(
        self,
        directory: str,
        *,
        segment_bytes: int = _DEF_SEGMENT_BYTES,
        fsync: str = "always",
        sync_every: int = _DEF_SYNC_EVERY,
        sync_interval_s: float = _DEF_SYNC_INTERVAL_S,
        clock=time.monotonic,
    ):
        if fsync not in ("always", "interval", "never"):
            raise ValueError(f"fsync policy {fsync!r} not in always/interval/never")
        self.dir = directory
        self.segment_bytes = int(segment_bytes)
        self.fsync_policy = fsync
        self.sync_every = max(1, int(sync_every))
        self.sync_interval_s = float(sync_interval_s)
        self._clock = clock
        self._lock = threading.Lock()
        self._file: Optional[io.BufferedWriter] = None
        self._file_bytes = 0
        self._unsynced = 0
        self._last_sync = clock()
        self._poisoned = False
        # healing / accounting
        self.torn_tail_truncations = 0
        self.torn_tail_bytes = 0
        self.dropped_segments = 0
        os.makedirs(self.dir, exist_ok=True)
        self.writable = True
        self._lock_fd: Optional[int] = None
        try:
            import fcntl

            self._lock_fd = os.open(os.path.join(self.dir, ".lock"), os.O_CREAT | os.O_RDWR)
            try:
                fcntl.flock(self._lock_fd, fcntl.LOCK_EX | fcntl.LOCK_NB)
            except OSError:
                self.writable = False
        except (ImportError, OSError):  # no flock: trust the deployment
            pass
        # segments: list of dicts {seg, path, first, last, records, bytes}
        self._segments: list[dict] = []
        self._heal()
        self._last_seq = self._segments[-1]["last"] if self._segments else 0
        if self._last_seq is None:  # empty trailing segment
            prior = [s["last"] for s in self._segments if s["last"] is not None]
            self._last_seq = prior[-1] if prior else 0

    # ------------------------------------------------------------------ open
    @staticmethod
    def _seg_no(name: str) -> int:
        return int(name[len("wal-") : -len(".log")])

    def _seg_path(self, seg: int) -> str:
        return os.path.join(self.dir, f"wal-{seg:08d}.log")

    def _list_segment_files(self) -> list[str]:
        names = [
            n
            for n in os.listdir(self.dir)
            if n.startswith("wal-") and n.endswith(".log")
        ]
        return sorted(names, key=self._seg_no)

    def _heal(self) -> None:
        expect: Optional[int] = None
        torn = False
        for name in self._list_segment_files():
            path = os.path.join(self.dir, name)
            if torn:
                # segments past a torn point are unreachable history: the
                # records before them are gone, so replaying these would
                # apply mutations out of order
                self.dropped_segments += 1
                if self.writable:
                    os.remove(path)
                continue
            first, last, count, good, problem = _scan_segment(path, expect)
            if problem is not None:
                size = os.path.getsize(path)
                if self.writable:
                    logger.warning(
                        "WAL %s: %s at offset %d — truncating %d torn byte(s)",
                        name, problem, good, size - good,
                    )
                    with open(path, "r+b") as f:
                        f.truncate(good)
                    self.torn_tail_truncations += 1
                    self.torn_tail_bytes += size - good
                torn = True
            self._segments.append(
                {
                    "seg": self._seg_no(name),
                    "path": path,
                    "first": first,
                    "last": last,
                    "records": count,
                    "bytes": good,
                }
            )
            if last is not None:
                expect = last + 1

    # ---------------------------------------------------------------- append
    def append(self, rtype: int, payload: bytes) -> int:
        """Log one record; returns its sequence number.  The record is on its
        way to disk when this returns (durable when policy is ``always``)."""
        with self._lock:
            if not self.writable:
                raise OSError("WAL is owned by another process (single-writer flock)")
            if self._poisoned:
                raise OSError("WAL poisoned by a torn write; reopen to recover")
            inj = _fault_injector()
            if inj is not None and inj.should_fire("disk_write_fail"):
                raise OSError("injected fault: disk_write_fail (WAL append)")
            seq = self._last_seq + 1
            rec = _encode_record(seq, rtype, payload)
            f = self._ensure_segment(len(rec))
            if inj is not None and inj.should_fire("disk_torn_write"):
                # simulate power loss mid-record: half the bytes reach disk,
                # then the "process" dies — this log object refuses further
                # appends; the reopened log truncates the torn tail
                f.write(rec[: max(1, len(rec) // 2)])
                f.flush()
                os.fsync(f.fileno())
                self._poisoned = True
                from ..serving.faults import FaultInjected

                raise FaultInjected("disk_torn_write", f"record seq={seq}")
            f.write(rec)
            self._last_seq = seq
            self._file_bytes += len(rec)
            cur = self._segments[-1]
            cur["last"] = seq
            if cur["first"] is None:
                cur["first"] = seq
            cur["records"] += 1
            cur["bytes"] = self._file_bytes
            self._after_write(f)
            return seq

    def _ensure_segment(self, need_bytes: int) -> io.BufferedWriter:
        if self._file is None:
            if self._segments:
                cur = self._segments[-1]
                self._file = open(cur["path"], "ab")
                self._file_bytes = cur["bytes"]
            else:
                self._open_fresh(1)
        if (
            self._file_bytes
            and self._file_bytes + need_bytes > self.segment_bytes
        ):
            self._rotate()
        return self._file

    def _open_fresh(self, seg: int) -> None:
        path = self._seg_path(seg)
        self._file = open(path, "ab")
        self._file_bytes = 0
        self._segments.append(
            {"seg": seg, "path": path, "first": None, "last": None, "records": 0, "bytes": 0}
        )
        _fsync_dir(self.dir)

    def _rotate(self) -> None:
        f, self._file = self._file, None
        f.flush()
        os.fsync(f.fileno())
        f.close()
        self._open_fresh(self._segments[-1]["seg"] + 1)

    def _after_write(self, f) -> None:
        self._unsynced += 1
        if self.fsync_policy == "always":
            f.flush()
            os.fsync(f.fileno())
            self._unsynced = 0
            self._last_sync = self._clock()
        elif self.fsync_policy == "interval":
            f.flush()
            now = self._clock()
            if (
                self._unsynced >= self.sync_every
                or now - self._last_sync >= self.sync_interval_s
            ):
                os.fsync(f.fileno())
                self._unsynced = 0
                self._last_sync = now
        else:  # never: OS page cache decides (bench/bulk-load mode)
            f.flush()

    def sync(self) -> None:
        """Force an fsync regardless of policy (snapshot barrier)."""
        with self._lock:
            if self._file is not None:
                self._file.flush()
                os.fsync(self._file.fileno())
                self._unsynced = 0
                self._last_sync = self._clock()

    # ---------------------------------------------------------------- replay
    def replay(self, after_seq: int = 0) -> Iterator[tuple[int, int, bytes]]:
        """Yield ``(seq, rtype, payload)`` for every record past
        ``after_seq``, in order.  Files were healed at open, so a decode
        problem here is new corruption — surfaced, not skipped."""
        for seg in list(self._segments):
            if seg["last"] is not None and seg["last"] <= after_seq:
                continue
            gen = _read_records(seg["path"])
            while True:
                try:
                    _, seq, rtype, payload = next(gen)
                except StopIteration as stop:
                    _, problem = stop.value
                    if problem is not None:
                        if self.writable:
                            raise OSError(
                                f"WAL {seg['path']}: {problem} during replay"
                            ) from None
                        # read-only opener: the incomplete tail is the live
                        # writer's uncommitted edge — stop, don't heal
                        return
                    break
                if seq > after_seq:
                    yield seq, rtype, payload

    def prune_through(self, seq: int) -> int:
        """Drop whole segments whose every record is covered by a snapshot at
        ``seq``.  The active segment survives (cheap, and keeps the append
        path open); returns the number of segments removed."""
        removed = 0
        with self._lock:
            if not self.writable:
                return 0
            keep = []
            for s in self._segments:
                is_active = s is self._segments[-1]
                if not is_active and s["last"] is not None and s["last"] <= seq:
                    try:
                        os.remove(s["path"])
                        removed += 1
                        continue
                    except OSError:
                        pass
                keep.append(s)
            self._segments = keep
        return removed

    # ----------------------------------------------------------------- stats
    @property
    def last_seq(self) -> int:
        return self._last_seq

    @property
    def records_on_disk(self) -> int:
        return sum(s["records"] for s in self._segments)

    @property
    def bytes_on_disk(self) -> int:
        return sum(s["bytes"] for s in self._segments)

    @property
    def segment_count(self) -> int:
        return len(self._segments)

    def close(self) -> None:
        with self._lock:
            if self._file is not None:
                self._file.flush()
                os.fsync(self._file.fileno())
                self._file.close()
                self._file = None
            if self._lock_fd is not None:
                try:
                    os.close(self._lock_fd)  # releases the flock with the fd
                except OSError:
                    pass
                self._lock_fd = None


# ---------------------------------------------------------------- snapshots
class SnapshotStore:
    """Atomic snapshot directories with digest-verified manifests.

    Layout: ``<dir>/snap-<wal_seq:012d>/`` holding one ``.npy`` per artifact
    plus ``manifest.json`` (written LAST inside the temp dir, so a manifest's
    existence implies every artifact it names was already on disk).  The
    ``os.rename`` of the temp dir to its final name is the commit point.
    """

    def __init__(self, directory: str, *, wall=time.time):
        self.dir = directory
        self._wall = wall
        os.makedirs(self.dir, exist_ok=True)

    def _snap_path(self, wal_seq: int) -> str:
        return os.path.join(self.dir, f"snap-{wal_seq:012d}")

    def list_snapshots(self) -> list[str]:
        """Snapshot dir names, newest first."""
        names = [
            n
            for n in os.listdir(self.dir)
            if n.startswith("snap-") and not n.endswith(".corrupt")
        ]
        return sorted(names, reverse=True)

    def write(self, arrays: dict, meta: dict) -> str:
        """Write one snapshot; returns its directory path.

        ``meta['wal_seq']`` names the snapshot (recovery replays records past
        it).  Crash at ANY point before the final rename leaves only a
        ``.tmp-`` dir that recovery ignores and the next write cleans up.
        """
        inj = _fault_injector()
        if inj is not None and inj.should_fire("disk_write_fail"):
            raise OSError("injected fault: disk_write_fail (snapshot write)")
        wal_seq = int(meta["wal_seq"])
        final = self._snap_path(wal_seq)
        tmp = os.path.join(self.dir, f".tmp-snap-{wal_seq:012d}-{os.getpid()}")
        if os.path.exists(tmp):
            _rmtree(tmp)
        os.makedirs(tmp)
        artifacts = {}
        for name in sorted(arrays):
            fname = f"{name}.npy"
            path = os.path.join(tmp, fname)
            with open(path, "wb") as f:
                np.save(f, np.ascontiguousarray(arrays[name]))
                f.flush()
                os.fsync(f.fileno())
            artifacts[fname] = {
                "crc32c": file_crc32c(path),
                "bytes": os.path.getsize(path),
            }
        manifest = {
            "format": 1,
            "wal_seq": wal_seq,
            "created_unix": float(self._wall()),
            "meta": {k: v for k, v in meta.items() if k != "wal_seq"},
            "artifacts": artifacts,
        }
        mpath = os.path.join(tmp, "manifest.json")
        with open(mpath, "w") as f:
            json.dump(manifest, f, indent=1, sort_keys=True)
            f.flush()
            os.fsync(f.fileno())
        _fsync_dir(tmp)
        if os.path.exists(final):  # re-snapshot at an unchanged seq: replace
            _rmtree(final)
        os.rename(tmp, final)
        _fsync_dir(self.dir)
        if inj is not None and inj.should_fire("snapshot_corrupt"):
            # bit rot lands AFTER the commit point: flip one byte in the
            # first artifact so the digest walk must catch it
            victim = os.path.join(final, sorted(artifacts)[0])
            with open(victim, "r+b") as f:
                f.seek(os.path.getsize(victim) // 2)
                b = f.read(1)
                f.seek(-1, os.SEEK_CUR)
                f.write(bytes([b[0] ^ 0xFF]))
        return final

    def verify(self, snap_dir: str) -> list[str]:
        """Digest-walk one snapshot; returns problems ([] = valid)."""
        problems: list[str] = []
        mpath = os.path.join(snap_dir, "manifest.json")
        try:
            with open(mpath) as f:
                manifest = json.load(f)
        except (OSError, ValueError) as e:
            return [f"manifest unreadable: {e}"]
        for fname, want in sorted(manifest.get("artifacts", {}).items()):
            got = file_crc32c(os.path.join(snap_dir, fname))
            if got is None:
                problems.append(f"{fname}: missing/unreadable")
            elif got != want.get("crc32c"):
                problems.append(
                    f"{fname}: crc32c mismatch (manifest {want.get('crc32c')}, file {got})"
                )
        return problems

    def load(self, snap_dir: str) -> tuple[dict, dict]:
        """Read a VERIFIED snapshot's ``(arrays, manifest)``."""
        with open(os.path.join(snap_dir, "manifest.json")) as f:
            manifest = json.load(f)
        arrays = {}
        for fname in manifest.get("artifacts", {}):
            arrays[fname[: -len(".npy")]] = np.load(
                os.path.join(snap_dir, fname), allow_pickle=False
            )
        return arrays, manifest

    def latest_valid(self) -> tuple[Optional[str], int]:
        """Newest snapshot that passes its digest walk, plus the number of
        corrupt snapshots skipped on the way (each is renamed ``.corrupt`` so
        the next recovery doesn't pay to re-verify it)."""
        fallbacks = 0
        for name in self.list_snapshots():
            snap = os.path.join(self.dir, name)
            problems = self.verify(snap)
            if not problems:
                return snap, fallbacks
            fallbacks += 1
            logger.warning(
                "snapshot %s failed verification (%s) — falling back", name, problems
            )
            try:
                os.rename(snap, snap + ".corrupt")
            except OSError:
                pass
        return None, fallbacks

    def prune(self, keep: int = 2) -> int:
        """Drop all but the newest ``keep`` valid-named snapshots."""
        removed = 0
        for name in self.list_snapshots()[max(1, keep):]:
            _rmtree(os.path.join(self.dir, name))
            removed += 1
        # temp dirs from crashed writers
        for name in os.listdir(self.dir):
            if name.startswith(".tmp-snap-"):
                _rmtree(os.path.join(self.dir, name))
        return removed


def _rmtree(path: str) -> None:
    for root, dirs, files in os.walk(path, topdown=False):
        for f in files:
            try:
                os.remove(os.path.join(root, f))
            except OSError:
                pass
        for d in dirs:
            try:
                os.rmdir(os.path.join(root, d))
            except OSError:
                pass
    try:
        os.rmdir(path)
    except OSError:
        pass


# ----------------------------------------------------------- mmap row store
class MmapRowStore:
    """Growable mmap-backed f32 row matrix — the ANN host tier's disk tier.

    ``alloc(shape)`` is shaped for ``ANNIndex(mat_alloc=...)``: it extends a
    single backing file (never shrinks — old views stay valid) and returns a
    fresh memmap over rows ``[0, cap)``.  The index's copy-on-grow then
    writes through the mapping, so corpora past host RAM page from disk under
    OS memory pressure instead of OOMing the process; the bf16 rerank copies
    the device tier serves from are unaffected.
    """

    def __init__(self, path: str, dtype=np.float32):
        self.path = path
        self.dtype = np.dtype(dtype)
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)

    def alloc(self, shape: tuple) -> np.ndarray:
        rows, dim = int(shape[0]), int(shape[1])
        if rows == 0:
            return np.empty((0, dim), self.dtype)
        need = rows * dim * self.dtype.itemsize
        with open(self.path, "ab") as f:
            f.truncate(max(need, os.path.getsize(self.path)))
        return np.memmap(self.path, dtype=self.dtype, mode="r+", shape=(rows, dim))


# -------------------------------------------------------------- durable ANN
class DurableANN:
    """ANNIndex with a WAL, atomic snapshots, and an idempotency ledger.

    Composition, not inheritance: searches delegate straight to the wrapped
    :class:`~storage.ann.ANNIndex` (no durability cost on the query path);
    mutations take this wrapper's lock, hit the WAL first, then apply.  The
    single WAL-then-apply order under one lock is the whole correctness
    story: a crash after the WAL write replays the mutation, a crash before
    it never half-applied anything.
    """

    def __init__(
        self,
        directory: str,
        *,
        dim: int,
        mesh=None,
        nlist: int = 0,
        m: int = 0,
        nprobe: int = 0,
        rerank_depth: int = 256,
        seed: int = 0,
        fsync: str = "always",
        segment_bytes: int = _DEF_SEGMENT_BYTES,
        snapshot_every_records: int = 0,
        snapshot_keep: int = 2,
        mmap_rows: bool = False,
        clock=time.monotonic,
        wall=time.time,
        index=None,
        device="cuda",
    ):
        from .ann import ANNIndex

        self.dir = directory
        os.makedirs(directory, exist_ok=True)
        self._clock = clock
        self._wall = wall
        self.snapshot_every_records = int(snapshot_every_records)
        self.snapshot_keep = int(snapshot_keep)
        self._lock = threading.RLock()
        mat_alloc = None
        if mmap_rows:
            self._row_store = MmapRowStore(os.path.join(directory, "rows-f32.mmap"))
            mat_alloc = self._row_store.alloc
        else:
            self._row_store = None
        self.index = index if index is not None else ANNIndex(
            dim,
            mesh=mesh,
            nlist=nlist,
            m=m,
            nprobe=nprobe,
            rerank_depth=rerank_depth,
            seed=seed,
            mat_alloc=mat_alloc,
            device=device,
        )
        self.wal = WriteAheadLog(
            os.path.join(directory, "wal"),
            segment_bytes=segment_bytes,
            fsync=fsync,
            clock=clock,
        )
        self.snapshots = SnapshotStore(os.path.join(directory, "snapshots"), wall=wall)
        self._ledger: dict[str, int] = {}  # ledger_key -> seq that applied it
        self.ledger_dedup_hits = 0
        self._records_since_snapshot = 0
        self._last_snapshot_seq = 0
        self._last_snapshot_unix: Optional[float] = None
        # recovery accounting (filled by recover())
        self.recovered = False
        self.recovery_s = 0.0
        self.replayed_records = 0
        self.snapshot_fallbacks = 0
        self.recover()

    # ---------------------------------------------------------------- encode
    @staticmethod
    def _append_payload(ids: Sequence[int], vectors: np.ndarray, ledger_key: str) -> bytes:
        buf = io.BytesIO()
        np.savez(
            buf,
            ids=np.asarray(list(ids), np.int64),
            vectors=np.ascontiguousarray(vectors, dtype=np.float32),
            ledger_key=np.asarray(ledger_key or ""),
        )
        return buf.getvalue()

    @staticmethod
    def _decode_append(payload: bytes):
        with np.load(io.BytesIO(payload), allow_pickle=False) as z:
            return (
                z["ids"].astype(np.int64),
                z["vectors"].astype(np.float32),
                str(z["ledger_key"]),
            )

    @staticmethod
    def _install_payload(centroids: np.ndarray, codebooks: np.ndarray, nlist: int) -> bytes:
        buf = io.BytesIO()
        np.savez(
            buf,
            centroids=np.ascontiguousarray(centroids, np.float32),
            codebooks=np.ascontiguousarray(codebooks, np.float32),
            nlist=np.asarray(int(nlist), np.int64),
        )
        return buf.getvalue()

    # -------------------------------------------------------------- mutation
    def ingest(
        self,
        ids: Sequence[int],
        vectors: np.ndarray,
        ledger_key: Optional[str] = None,
    ) -> int:
        """WAL-logged append; returns rows applied (0 = ledger dedup).

        With a ``doc_id:version`` ledger key this is exactly-once per
        document: the key rides in the APPEND record and in snapshots, so a
        worker killed mid-ingest re-runs its whole batch after recovery and
        every already-applied document no-ops.
        """
        ids = [int(i) for i in ids]
        vectors = np.asarray(vectors, np.float32).reshape(-1, self.index.dim)
        if len(ids) != vectors.shape[0]:
            raise ValueError("ids/vectors length mismatch")
        if not ids:
            return 0
        with self._lock:
            if not self.writable:
                raise OSError("durable index is read-only (another process holds the WAL)")
            if ledger_key and ledger_key in self._ledger:
                self.ledger_dedup_hits += 1
                return 0
            seq = self.wal.append(
                REC_APPEND, self._append_payload(ids, vectors, ledger_key or "")
            )
            self.index.add(ids, vectors)
            if ledger_key:
                self._ledger[ledger_key] = seq
            self._records_since_snapshot += 1
        self._maybe_snapshot()
        return len(ids)

    # ANNIndex API compat: a durable index in the registry still gets add()
    # from generic code paths — logged, without a ledger key
    def add(self, ids: Sequence[int], vectors: np.ndarray) -> None:
        self.ingest(ids, vectors)

    def add_device(self, ids: Sequence[int], rows) -> None:
        import torch

        self.ingest(ids, torch.as_tensor(rows).float().cpu().numpy())

    def remove(self, ids: Sequence[int]) -> None:
        ids = [int(i) for i in ids]
        if not ids:
            return
        with self._lock:
            self.wal.append(
                REC_TOMBSTONE, json.dumps({"ids": ids}).encode("utf-8")
            )
            self.index.remove(ids)
            self._records_since_snapshot += 1
        self._maybe_snapshot()

    def train(self, **kw) -> "DurableANN":
        """Train, then log the LEARNED quantizers as an install record.

        A crash between the train and the install log loses the retrain (not
        the data): recovery replays to the pre-train quantizers, consistent
        and re-trainable.  Replaying the install record re-stages with the
        exact logged arrays — deterministic, unlike re-learning.
        """
        with self._lock:
            self.index.train(**kw)
            arrays = self.index.trained_arrays()
            if arrays is not None:
                centroids, codebooks, nlist = arrays
                self.wal.append(
                    REC_INSTALL, self._install_payload(centroids, codebooks, nlist)
                )
                self._records_since_snapshot += 1
        self._maybe_snapshot()
        return self

    def clear(self) -> None:
        """Drop everything — index, WAL, snapshots, ledger (test/ops helper)."""
        with self._lock:
            self.index.clear()
            self.wal.close()
            for s in list(self.wal._segments):
                try:
                    os.remove(s["path"])
                except OSError:
                    pass
            self.wal._segments = []
            self.wal._last_seq = 0
            self.wal._file = None
            for name in self.snapshots.list_snapshots():
                _rmtree(os.path.join(self.snapshots.dir, name))
            self._ledger.clear()
            self._records_since_snapshot = 0
            self._last_snapshot_seq = 0
            self._last_snapshot_unix = None

    # -------------------------------------------------------------- snapshot
    def snapshot(self) -> Optional[str]:
        """Atomic snapshot of the current state; prunes covered WAL segments.

        Quiesces mutations (this wrapper's lock) only for the host-side state
        capture + file writes — searches keep running against the index the
        whole time.
        """
        with self._lock:
            if not self.writable:
                raise OSError("durable index is read-only (another process holds the WAL)")
            state = self.index.snapshot_state()
            seq = self.wal.last_seq
            self.wal.sync()  # snapshot barrier: everything <= seq is on disk
            arrays = {
                "ids": state["ids"],
                "vectors": state["vectors"],
            }
            for k in ("centroids", "codebooks", "row_list"):
                if k in state:
                    arrays[k] = state[k]
            if self._ledger:
                arrays["ledger_keys"] = np.asarray(sorted(self._ledger), dtype=np.str_)
                arrays["ledger_seqs"] = np.asarray(
                    [self._ledger[k] for k in sorted(self._ledger)], np.int64
                )
            meta = {
                "wal_seq": seq,
                "trained": bool(state["trained"]),
                "nlist": int(state["nlist"]),
                "m": int(state["m"]),
                "dim": int(state["dim"]),
                "seed": int(state["seed"]),
                "rows": int(state["ids"].shape[0]),
            }
            path = self.snapshots.write(arrays, meta)
            self._last_snapshot_seq = seq
            self._last_snapshot_unix = float(self._wall())
            self._records_since_snapshot = 0
            self.wal.prune_through(seq)
            self.snapshots.prune(self.snapshot_keep)
            return path

    def _maybe_snapshot(self) -> None:
        if (
            self.snapshot_every_records > 0
            and self._records_since_snapshot >= self.snapshot_every_records
        ):
            try:
                self.snapshot()
            except OSError as e:
                # auto-snapshot failure must not fail the ingest that
                # triggered it — the WAL already holds the mutation
                logger.warning("auto-snapshot failed (WAL retains tail): %s", e)

    # -------------------------------------------------------------- recovery
    def recover(self) -> dict:
        """Load the latest valid snapshot, replay the WAL tail, report.

        Corrupt snapshots are *detected* (digest walk) and skipped; a torn
        WAL tail was truncated when the log opened.  Replay drives the
        index's normal mutation paths, so everything downstream — spill
        balancing, encoding, packing — reproduces the pre-crash placement.
        """
        t0 = self._clock()
        snap, fallbacks = self.snapshots.latest_valid()
        self.snapshot_fallbacks = fallbacks
        after_seq = 0
        if snap is not None:
            arrays, manifest = self.snapshots.load(snap)
            state = {
                "ids": arrays.get("ids", np.zeros((0,), np.int64)),
                "vectors": arrays.get(
                    "vectors", np.zeros((0, self.index.dim), np.float32)
                ),
                "trained": bool(manifest["meta"].get("trained")),
                "nlist": int(manifest["meta"].get("nlist", 0)),
            }
            for k in ("centroids", "codebooks", "row_list"):
                if k in arrays:
                    state[k] = arrays[k]
            self.index.restore_state(state)
            self._ledger = {}
            if "ledger_keys" in arrays:
                for k, s in zip(
                    arrays["ledger_keys"].tolist(), arrays["ledger_seqs"].tolist()
                ):
                    self._ledger[str(k)] = int(s)
            after_seq = int(manifest["wal_seq"])
            self._last_snapshot_seq = after_seq
            self._last_snapshot_unix = float(manifest.get("created_unix", 0.0)) or None
        replayed = 0
        for seq, rtype, payload in self.wal.replay(after_seq):
            if rtype == REC_APPEND:
                ids, vectors, key = self._decode_append(payload)
                self.index.add([int(i) for i in ids.tolist()], vectors)
                if key:
                    self._ledger[key] = seq
            elif rtype == REC_TOMBSTONE:
                self.index.remove(json.loads(payload.decode("utf-8"))["ids"])
            elif rtype == REC_INSTALL:
                with np.load(io.BytesIO(payload), allow_pickle=False) as z:
                    self.index.install_trained(
                        z["centroids"], z["codebooks"], int(z["nlist"])
                    )
            else:
                raise OSError(f"WAL record seq={seq}: unknown type {rtype}")
            replayed += 1
        self.recovered = snap is not None or replayed > 0
        self.replayed_records = replayed
        self.recovery_s = self._clock() - t0
        self._records_since_snapshot = 0
        return {
            "snapshot": snap,
            "snapshot_fallbacks": fallbacks,
            "replayed_records": replayed,
            "recovery_s": self.recovery_s,
            "rows": len(self.index),
        }

    # ------------------------------------------------------------ delegation
    @property
    def writable(self) -> bool:
        return self.wal.writable

    def search(self, *a, **kw):
        return self.index.search(*a, **kw)

    def search_batch(self, *a, **kw):
        return self.index.search_batch(*a, **kw)

    def probe_recall(self, *a, **kw):
        return self.index.probe_recall(*a, **kw)

    def warmup(self, *a, **kw):
        self.index.warmup(*a, **kw)
        return self

    def reserve(self, n: int) -> None:
        self.index.reserve(n)

    def __len__(self) -> int:
        return len(self.index)

    @property
    def dim(self) -> int:
        return self.index.dim

    def ledger_has(self, key: str) -> bool:
        with self._lock:
            return key in self._ledger

    # ----------------------------------------------------------------- stats
    def durability_stats(self) -> dict:
        with self._lock:
            age = None
            if self._last_snapshot_unix is not None:
                age = max(0.0, float(self._wall()) - self._last_snapshot_unix)
            return {
                "dir": self.dir,
                "fsync": self.wal.fsync_policy,
                "wal_records": self.wal.last_seq,
                "wal_records_on_disk": self.wal.records_on_disk,
                "wal_bytes": self.wal.bytes_on_disk,
                "wal_segments": self.wal.segment_count,
                "torn_tail_truncations": self.wal.torn_tail_truncations,
                "snapshot_count": len(self.snapshots.list_snapshots()),
                "last_snapshot_seq": self._last_snapshot_seq,
                "snapshot_age_s": age,
                "snapshot_fallbacks": self.snapshot_fallbacks,
                "recovered": self.recovered,
                "recovery_s": self.recovery_s,
                "replayed_records": self.replayed_records,
                "ledger_entries": len(self._ledger),
                "ledger_dedup_hits": self.ledger_dedup_hits,
                "mmap_rows": self._row_store is not None,
                "writable": self.writable,
            }

    def stats(self) -> dict:
        out = self.index.stats()
        out["durability"] = self.durability_stats()
        return out

    def close(self) -> None:
        self.wal.close()


# ------------------------------------------------------------ offline verify
def verify_dir(directory: str) -> dict:
    """Offline integrity walk for ``ann verify`` — every snapshot's manifest
    digests plus every WAL record's CRC, WITHOUT healing anything (a verify
    must never mutate the evidence).  ``ok`` is True iff zero problems."""
    problems: list[str] = []
    snap_dir = os.path.join(directory, "snapshots")
    snapshots = []
    if os.path.isdir(snap_dir):
        store = SnapshotStore(snap_dir)
        for name in store.list_snapshots():
            p = store.verify(os.path.join(snap_dir, name))
            snapshots.append({"name": name, "problems": p})
            problems.extend(f"{name}: {x}" for x in p)
    wal_dir = os.path.join(directory, "wal")
    wal_records = 0
    wal_segments = 0
    if os.path.isdir(wal_dir):
        expect: Optional[int] = None
        names = sorted(
            (n for n in os.listdir(wal_dir) if n.startswith("wal-") and n.endswith(".log")),
            key=lambda n: int(n[4:-4]),
        )
        for name in names:
            wal_segments += 1
            first, last, count, good, problem = _scan_segment(
                os.path.join(wal_dir, name), expect
            )
            wal_records += count
            if problem is not None:
                problems.append(f"{name}: {problem} at offset {good}")
                break  # records past a bad byte are unreachable anyway
            if last is not None:
                expect = last + 1
    return {
        "ok": not problems,
        "problems": problems,
        "snapshots": snapshots,
        "wal_segments": wal_segments,
        "wal_records": wal_records,
    }
