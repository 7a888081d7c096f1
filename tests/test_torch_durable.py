"""The port's durability plane (``storage/durable.py``, ``storage/integrity.py``)
on the JAX tests' contracts (``tests/test_durable.py``), on the CPU:

CRC vectors; the WAL's round trip, torn tails and mid-stream corruption,
the flock, the fsync policy and pruning; the storage fault sites; snapshot
atomicity and digests; crash reopen, snapshot restore and tombstones across
a snapshot; the corrupt-snapshot fallback; ledger dedup; the untrained round
trip; the read-only opener; ``MmapRowStore``; ``verify_dir``; the ``cli
ann`` round trip; the durability gauges.  Then both directions across the
packages: a directory the JAX ``DurableANN`` wrote (trained, with a WAL
tail) opens in the port with equal searches, and one the port wrote passes
the JAX ``verify_dir`` and opens in the JAX package with equal searches.
A restore re-encodes the rows under the stored quantizers in each
package's own f32 arithmetic, so a PQ code whose two best distances lie
within the f32 rounding of each other may differ; those near ties are
counted and reported, and no other code may differ.
"""

import argparse
import json
import os
import struct

import numpy as np
import pytest

from django_assistant_bot_tpu_torch.serving.faults import (
    ALL_SITES,
    FaultInjected,
    FaultInjector,
    reset_global_injector,
    set_global_injector,
)
from django_assistant_bot_tpu_torch.storage.ann import make_clustered
from django_assistant_bot_tpu_torch.storage.durable import (
    _HDR,
    REC_APPEND,
    REC_INSTALL,
    REC_TOMBSTONE,
    DurableANN,
    MmapRowStore,
    SnapshotStore,
    WriteAheadLog,
    verify_dir,
)
from django_assistant_bot_tpu_torch.storage.integrity import crc32c, entry_crc32c, file_crc32c

DIM = 32


@pytest.fixture(autouse=True)
def _clean_injector():
    reset_global_injector()
    yield
    reset_global_injector()


def _corpus(n, seed=7):
    return make_clustered(n, DIM, seed=seed)


def _topk(index, queries, k=10):
    return [[int(i) for i, _ in index.search(q, k=k)] for q in queries]


# ------------------------------------------------------------------ CRC-32C
def test_crc32c_known_vector_and_chaining():
    # RFC 3720 check value for "123456789"
    assert crc32c(b"123456789") == 0xE3069283
    assert crc32c(b"") == 0
    whole = crc32c(b"hello world")
    assert crc32c(b" world", crc32c(b"hello")) == whole
    assert entry_crc32c(b"k", b"v") == crc32c(b"v", crc32c(b"k"))


@pytest.mark.parametrize("n", [65535, 65536, 65543, 1 << 20, (9 << 20) + 5])
def test_crc32c_lane_path_equals_table_loop(n):
    """The lane-parallel path (buffers of 64 KiB and more) gives the table
    loop's value, chained from a running checksum or not, at lengths off
    the lanes' multiple (the tail runs through the table loop)."""
    from django_assistant_bot_tpu_torch.storage import integrity

    data = np.random.default_rng(n).integers(0, 256, size=n, dtype=np.uint8).tobytes()
    for crc in (0, 0xDEADBEEF):
        c = ~crc & 0xFFFFFFFF
        assert crc32c(data, crc) == ~integrity._crc_raw(c, data) & 0xFFFFFFFF


def test_crc32c_is_the_integrity_module_s():
    """One implementation: the durability plane stamps with
    ``storage.integrity``'s checksum, not a copy that could drift."""
    from django_assistant_bot_tpu_torch.storage import durable, integrity

    assert durable.crc32c is integrity.crc32c and durable.file_crc32c is integrity.file_crc32c


def test_file_crc32c_matches_buffer(tmp_path):
    p = tmp_path / "blob"
    data = bytes(range(256)) * 77
    p.write_bytes(data)
    assert file_crc32c(str(p), chunk_bytes=1000) == crc32c(data)
    assert file_crc32c(str(tmp_path / "missing")) is None


# ---------------------------------------------------------------------- WAL
def test_wal_roundtrip_property_fuzz(tmp_path):
    """Pinned-seed property test: random record types/sizes through tiny
    segments (forced rotation), reopened, must replay byte-identically."""
    rng = np.random.default_rng(int(os.environ.get("DABT_FAULT_SEED", "0")))
    wal = WriteAheadLog(str(tmp_path / "wal"), segment_bytes=256, fsync="never")
    written = []
    for _ in range(120):
        rtype = int(rng.integers(1, 4))
        payload = rng.bytes(int(rng.integers(0, 200)))
        seq = wal.append(rtype, payload)
        written.append((seq, rtype, payload))
    assert wal.segment_count > 1  # rotation actually exercised
    assert wal.last_seq == 120
    wal.close()

    back = WriteAheadLog(str(tmp_path / "wal"), segment_bytes=256, fsync="never")
    assert back.torn_tail_truncations == 0
    assert list(back.replay()) == written
    # replay(after_seq) resumes mid-stream
    assert list(back.replay(after_seq=100)) == written[100:]
    assert back.append(REC_APPEND, b"after-reopen") == 121
    back.close()


@pytest.mark.parametrize("cut", ["mid_header", "mid_payload", "garbage_tail"])
def test_wal_torn_tail_truncated_on_open(tmp_path, cut):
    wal = WriteAheadLog(str(tmp_path / "wal"), fsync="always")
    for i in range(5):
        wal.append(REC_APPEND, f"rec-{i}".encode() * 10)
    path = wal._segments[-1]["path"]
    size = os.path.getsize(path)
    wal.close()
    with open(path, "r+b") as f:
        if cut == "mid_header":
            f.seek(0, os.SEEK_END)
            f.write(_HDR.pack(0x4C415744, 6, REC_APPEND, 50, 0)[:7])
        elif cut == "mid_payload":
            f.seek(0, os.SEEK_END)
            f.write(_HDR.pack(0x4C415744, 6, REC_APPEND, 50, 0) + b"x" * 20)
        else:
            f.seek(0, os.SEEK_END)
            f.write(b"\xde\xad\xbe\xef" * 8)

    healed = WriteAheadLog(str(tmp_path / "wal"), fsync="always")
    assert healed.torn_tail_truncations == 1
    assert os.path.getsize(path) == size  # truncated back to the good bytes
    assert [seq for seq, _, _ in healed.replay()] == [1, 2, 3, 4, 5]
    assert healed.append(REC_APPEND, b"resumes") == 6  # seq continues, no gap
    healed.close()


def test_wal_mid_stream_corruption_fails_replay_loudly(tmp_path):
    """Corruption BEFORE the tail is new damage, not a torn write — replay
    must surface it, never silently skip records."""
    wal = WriteAheadLog(str(tmp_path / "wal"), fsync="always")
    for i in range(10):
        wal.append(REC_APPEND, f"payload-{i}".encode() * 5)
    path = wal._segments[-1]["path"]
    wal.close()
    with open(path, "r+b") as f:
        f.seek(os.path.getsize(path) // 3)
        b = f.read(1)
        f.seek(-1, os.SEEK_CUR)
        f.write(bytes([b[0] ^ 0xFF]))
    # the healing open truncates at the first bad record; everything after
    # the flipped byte is unreachable, so the heal drops it
    healed = WriteAheadLog(str(tmp_path / "wal"), fsync="always")
    assert healed.torn_tail_truncations == 1
    seqs = [seq for seq, _, _ in healed.replay()]
    assert seqs == list(range(1, len(seqs) + 1)) and len(seqs) < 10
    healed.close()


def test_wal_single_writer_flock_reader_semantics(tmp_path):
    writer = WriteAheadLog(str(tmp_path / "wal"), fsync="always")
    writer.append(REC_APPEND, b"one")
    writer.append(REC_TOMBSTONE, b"two")
    reader = WriteAheadLog(str(tmp_path / "wal"), fsync="always")
    assert writer.writable and not reader.writable
    # readers replay the committed records but may not mutate anything
    assert [p for _, _, p in reader.replay()] == [b"one", b"two"]
    with pytest.raises(OSError):
        reader.append(REC_APPEND, b"nope")
    assert reader.prune_through(2) == 0
    reader.close()
    writer.close()
    # the writer's close released the flock: next opener owns the log
    heir = WriteAheadLog(str(tmp_path / "wal"), fsync="always")
    assert heir.writable
    heir.close()


def test_wal_fsync_interval_policy_uses_injected_clock(tmp_path, monkeypatch):
    """DABT104 discipline: the interval policy reads the injected clock, so a
    fake clock drives the sync schedule deterministically."""
    now = [0.0]
    real_fsync, calls = os.fsync, []
    monkeypatch.setattr(os, "fsync", lambda fd: (calls.append(fd), real_fsync(fd)))
    wal = WriteAheadLog(
        str(tmp_path / "wal"),
        fsync="interval",
        sync_every=1000,
        sync_interval_s=5.0,
        clock=lambda: now[0],
    )
    wal.append(REC_APPEND, b"a")  # first append opens the segment (dir fsync)
    base = len(calls)
    wal.append(REC_APPEND, b"b")
    wal.append(REC_APPEND, b"c")
    assert len(calls) == base  # clock never moved: no fsync yet
    now[0] = 6.0
    wal.append(REC_APPEND, b"d")
    assert len(calls) == base + 1  # interval elapsed on the fake clock
    wal.close()


def test_wal_prune_keeps_active_segment(tmp_path):
    wal = WriteAheadLog(str(tmp_path / "wal"), segment_bytes=200, fsync="never")
    for i in range(30):
        wal.append(REC_APPEND, b"x" * 64)
    segs = wal.segment_count
    assert segs > 2
    removed = wal.prune_through(wal.last_seq)
    assert removed == segs - 1 and wal.segment_count == 1
    assert wal.append(REC_APPEND, b"still-appendable") == 31
    wal.close()


# -------------------------------------------------------------- fault sites
def test_storage_fault_sites_registered():
    for site in ("disk_write_fail", "disk_torn_write", "snapshot_corrupt"):
        assert site in ALL_SITES


def test_disk_write_fail_fault(tmp_path):
    wal = WriteAheadLog(str(tmp_path / "wal"), fsync="always")
    set_global_injector(FaultInjector({"disk_write_fail": {"fire_on": [1]}}))
    with pytest.raises(OSError):
        wal.append(REC_APPEND, b"doomed")
    # the failed append logged NOTHING; the next one lands at seq 1
    assert wal.append(REC_APPEND, b"fine") == 1
    assert [p for _, _, p in wal.replay()] == [b"fine"]
    wal.close()


def test_disk_torn_write_fault_poisons_then_heals(tmp_path):
    wal = WriteAheadLog(str(tmp_path / "wal"), fsync="always")
    wal.append(REC_APPEND, b"committed")
    set_global_injector(FaultInjector({"disk_torn_write": {"fire_on": [1]}}))
    with pytest.raises(FaultInjected):
        wal.append(REC_APPEND, b"torn-in-half" * 10)
    reset_global_injector()
    with pytest.raises(OSError):  # poisoned: this writer is "dead"
        wal.append(REC_APPEND, b"refused")
    wal.close()
    healed = WriteAheadLog(str(tmp_path / "wal"), fsync="always")
    assert healed.torn_tail_truncations == 1
    assert [p for _, _, p in healed.replay()] == [b"committed"]
    assert healed.append(REC_APPEND, b"recovered") == 2
    healed.close()


def test_snapshot_corrupt_fault_detected_not_trusted(tmp_path):
    store = SnapshotStore(str(tmp_path / "snaps"))
    arrays = {"ids": np.arange(10, dtype=np.int64)}
    store.write(arrays, {"wal_seq": 1})
    set_global_injector(FaultInjector({"snapshot_corrupt": {"fire_on": [1]}}))
    store.write(arrays, {"wal_seq": 2})
    reset_global_injector()
    assert store.verify(os.path.join(store.dir, store.list_snapshots()[0])) != []
    best, fallbacks = store.latest_valid()
    assert fallbacks == 1 and best is not None and best.endswith("snap-000000000001")
    # the corrupt dir was quarantined, not deleted: evidence survives
    assert any(n.endswith(".corrupt") for n in os.listdir(store.dir))


# ---------------------------------------------------------------- snapshots
def test_snapshot_atomicity_tmp_dir_ignored(tmp_path):
    store = SnapshotStore(str(tmp_path / "snaps"))
    store.write({"ids": np.arange(4, dtype=np.int64)}, {"wal_seq": 3})
    # a crashed writer's leftover tmp dir must be invisible to recovery
    os.makedirs(os.path.join(store.dir, ".tmp-snap-000000000009-1234"))
    assert store.list_snapshots() == ["snap-000000000003"]
    best, fallbacks = store.latest_valid()
    assert best is not None and fallbacks == 0


def test_snapshot_manifest_digests_cover_every_artifact(tmp_path):
    store = SnapshotStore(str(tmp_path / "snaps"))
    arrays = {
        "ids": np.arange(6, dtype=np.int64),
        "vectors": np.ones((6, DIM), np.float32),
    }
    path = store.write(arrays, {"wal_seq": 5})
    manifest = json.load(open(os.path.join(path, "manifest.json")))
    assert set(manifest["artifacts"]) == {"ids.npy", "vectors.npy"}
    for fname, spec in manifest["artifacts"].items():
        assert spec["crc32c"] == file_crc32c(os.path.join(path, fname))
    assert store.verify(path) == []


# --------------------------------------------------------------- DurableANN
def test_durable_crash_reopen_search_identity(tmp_path):
    rows = _corpus(300)
    q = rows[::40][:6]
    dur = DurableANN(str(tmp_path / "d"), dim=DIM, device="cpu", fsync="always", seed=7)
    dur.ingest(range(200), rows[:200], ledger_key="doc0")
    dur.train(nlist=8, seed=7)
    dur.ingest(range(200, 300), rows[200:], ledger_key="doc1")
    before = _topk(dur, q)
    dur.close()  # close WITHOUT snapshot: recovery is pure WAL replay

    back = DurableANN(str(tmp_path / "d"), dim=DIM, device="cpu", fsync="always", seed=7)
    st = back.durability_stats()
    assert back.recovered and st["replayed_records"] == 3
    assert len(back) == 300 and back.ledger_has("doc0") and back.ledger_has("doc1")
    assert _topk(back, q) == before
    back.close()


def test_durable_snapshot_restore_identity_and_drift_reset(tmp_path):
    """Satellite 3: a restore resets the drift gauge — advisory retrain
    starts from a clean slate on the recovered placement."""
    rows = _corpus(300)
    q = rows[::40][:6]
    dur = DurableANN(str(tmp_path / "d"), dim=DIM, device="cpu", fsync="always", seed=7)
    dur.ingest(range(300), rows, ledger_key="doc0")
    dur.train(nlist=8, seed=7)
    before = _topk(dur, q)
    assert dur.snapshot() is not None
    dur.close()

    back = DurableANN(str(tmp_path / "d"), dim=DIM, device="cpu", fsync="always", seed=7)
    st = back.durability_stats()
    assert back.recovered and st["replayed_records"] == 0  # all from snapshot
    assert st["snapshot_count"] == 1 and st["snapshot_age_s"] is not None
    assert _topk(back, q) == before
    ist = back.index.stats()
    assert ist["trained"] and not ist["retrain_advised"]
    assert float(ist["drift_frac"] or 0.0) == 0.0
    back.close()


def test_durable_tombstone_no_resurrection_across_snapshot(tmp_path):
    """Satellite 4: removed rows stay removed when the remove preceded the
    snapshot (compaction point: only live rows are written) AND when it
    landed after it (tombstone replayed from the WAL tail)."""
    rows = _corpus(300)
    dur = DurableANN(str(tmp_path / "d"), dim=DIM, device="cpu", fsync="always", seed=7)
    dur.ingest(range(300), rows, ledger_key="doc0")
    dur.train(nlist=8, seed=7)
    dur.remove(list(range(0, 40)))  # before the snapshot boundary
    dur.snapshot()
    dur.remove(list(range(40, 60)))  # after it, lives only in the WAL tail
    dur.close()

    back = DurableANN(str(tmp_path / "d"), dim=DIM, device="cpu", fsync="always", seed=7)
    live = set(back.index.live_ids())
    assert live == set(range(60, 300))
    assert len(back) == 240
    # a broad search never returns a resurrected id
    for q in rows[:60:7]:
        assert not {int(i) for i, _ in back.search(q, k=50)} & set(range(60))
    # the snapshot itself holds only live rows: compaction, not tombstone-list
    snaps = back.snapshots.list_snapshots()
    arrays, _ = back.snapshots.load(os.path.join(back.snapshots.dir, snaps[0]))
    assert set(arrays["ids"].tolist()) == set(range(40, 300))
    back.close()


def test_durable_corrupt_snapshot_falls_back_to_previous(tmp_path):
    rows = _corpus(300)
    q = rows[::40][:6]
    dur = DurableANN(str(tmp_path / "d"), dim=DIM, device="cpu", fsync="always", seed=7, snapshot_keep=4)
    dur.ingest(range(200), rows[:200], ledger_key="doc0")
    dur.train(nlist=8, seed=7)
    dur.snapshot()  # good snapshot
    dur.ingest(range(200, 300), rows[200:], ledger_key="doc1")
    set_global_injector(FaultInjector({"snapshot_corrupt": {"fire_on": [1]}}))
    dur.snapshot()  # newest snapshot is silently rotten
    reset_global_injector()
    before = _topk(dur, q)
    dur.close()

    back = DurableANN(str(tmp_path / "d"), dim=DIM, device="cpu", fsync="always", seed=7, snapshot_keep=4)
    st = back.durability_stats()
    assert st["snapshot_fallbacks"] == 1  # detected by digest walk, skipped
    assert len(back) == 300 and _topk(back, q) == before
    back.close()


def test_durable_ledger_dedup_survives_restart(tmp_path):
    rows = _corpus(120)
    dur = DurableANN(str(tmp_path / "d"), dim=DIM, device="cpu", fsync="always", seed=7)
    assert dur.ingest(range(60), rows[:60], ledger_key="doc:1:v1") == 60
    assert dur.ingest(range(60), rows[:60], ledger_key="doc:1:v1") == 0
    dur.snapshot()
    dur.close()
    back = DurableANN(str(tmp_path / "d"), dim=DIM, device="cpu", fsync="always", seed=7)
    assert back.ingest(range(60), rows[:60], ledger_key="doc:1:v1") == 0
    assert back.durability_stats()["ledger_dedup_hits"] == 1
    assert back.ingest(range(60, 120), rows[60:], ledger_key="doc:1:v2") == 60
    live = back.index.live_ids()
    assert len(live) == len(set(live)) == 120  # zero duplicate vectors
    back.close()


def test_durable_untrained_roundtrip_exact_tier(tmp_path):
    rows = _corpus(50)
    q = rows[::9][:4]
    dur = DurableANN(str(tmp_path / "d"), dim=DIM, device="cpu", fsync="always", seed=7)
    dur.ingest(range(50), rows)
    before = _topk(dur, q, k=5)
    dur.snapshot()
    dur.close()
    back = DurableANN(str(tmp_path / "d"), dim=DIM, device="cpu", fsync="always", seed=7)
    assert not back.index.stats()["trained"]
    assert _topk(back, q, k=5) == before
    back.close()


def test_durable_read_only_opener_serves_without_mutating(tmp_path):
    rows = _corpus(80)
    writer = DurableANN(str(tmp_path / "d"), dim=DIM, device="cpu", fsync="always", seed=7)
    writer.ingest(range(80), rows, ledger_key="doc0")
    reader = DurableANN(str(tmp_path / "d"), dim=DIM, device="cpu", fsync="always", seed=7)
    assert writer.writable and not reader.writable
    assert len(reader) == 80  # recovered the committed state
    with pytest.raises(OSError):
        reader.ingest(range(80, 90), rows[:10])
    with pytest.raises(OSError):
        reader.snapshot()
    reader.close()
    writer.close()


# -------------------------------------------------------------- mmap tier
def test_mmap_row_store_grow_preserves_rows(tmp_path):
    store = MmapRowStore(str(tmp_path / "rows.mmap"))
    a = store.alloc((4, 8))
    a[:] = np.arange(32, dtype=np.float32).reshape(4, 8)
    a.flush()
    b = store.alloc((16, 8))
    assert isinstance(b, np.memmap)
    np.testing.assert_array_equal(b[:4], np.arange(32, dtype=np.float32).reshape(4, 8))


def test_durable_mmap_rows_roundtrip_and_restage(tmp_path):
    rows = _corpus(200)
    q = rows[::40][:4]
    dur = DurableANN(str(tmp_path / "d"), dim=DIM, device="cpu", fsync="always", seed=7, mmap_rows=True)
    dur.ingest(range(200), rows, ledger_key="doc0")
    dur.train(nlist=8, seed=7)
    # the disk tier must survive the retrain's restage, not revert to RAM
    assert isinstance(dur.index._mat, np.memmap)
    before = _topk(dur, q)
    dur.snapshot()
    dur.close()
    back = DurableANN(str(tmp_path / "d"), dim=DIM, device="cpu", fsync="always", seed=7, mmap_rows=True)
    assert isinstance(back.index._mat, np.memmap)
    assert _topk(back, q) == before
    back.close()


# ------------------------------------------------------------------ verify
def test_verify_dir_clean_and_corrupt(tmp_path):
    rows = _corpus(100)
    dur = DurableANN(str(tmp_path / "d"), dim=DIM, device="cpu", fsync="always", seed=7)
    dur.ingest(range(100), rows, ledger_key="doc0")
    dur.snapshot()
    dur.ingest(range(100, 110), _corpus(10, seed=9), ledger_key="doc1")
    dur.close()
    report = verify_dir(str(tmp_path / "d"))
    assert report["ok"] and report["wal_records"] >= 1 and report["snapshots"]

    # flip one byte inside a snapshot artifact: the digest walk must object
    snap = os.path.join(str(tmp_path / "d"), "snapshots", report["snapshots"][0]["name"])
    victim = next(
        os.path.join(snap, n) for n in sorted(os.listdir(snap)) if n.endswith(".npy")
    )
    with open(victim, "r+b") as f:
        f.seek(os.path.getsize(victim) // 2)
        b = f.read(1)
        f.seek(-1, os.SEEK_CUR)
        f.write(bytes([b[0] ^ 0xFF]))
    report = verify_dir(str(tmp_path / "d"))
    assert not report["ok"] and report["problems"]


def test_verify_dir_flags_wal_crc_damage(tmp_path):
    wal = WriteAheadLog(str(tmp_path / "d" / "wal"), fsync="always")
    for i in range(6):
        wal.append(REC_APPEND, f"record-{i}".encode() * 8)
    path = wal._segments[-1]["path"]
    wal.close()
    with open(path, "r+b") as f:
        f.seek(os.path.getsize(path) // 2)
        b = f.read(1)
        f.seek(-1, os.SEEK_CUR)
        f.write(bytes([b[0] ^ 0xFF]))
    report = verify_dir(str(tmp_path / "d"))
    assert not report["ok"] and any("wal-" in p for p in report["problems"])


# --------------------------------------------------------------------- CLI
def _cli_args(argv):
    from django_assistant_bot_tpu_torch.cli import ann as ann_cli

    p = argparse.ArgumentParser()
    ann_cli.add_parser(p.add_subparsers(dest="command"))
    return p.parse_args(["ann", *argv])


def test_cli_snapshot_restore_verify_roundtrip(tmp_path, capsys):
    from django_assistant_bot_tpu_torch.cli import ann as ann_cli

    rows = _corpus(150)
    d = str(tmp_path / "d")
    dur = DurableANN(d, dim=DIM, device="cpu", fsync="always", seed=7)
    dur.ingest(range(150), rows, ledger_key="doc0")
    dur.train(nlist=8, seed=7)
    dur.close()

    assert ann_cli.run(_cli_args(["verify", "--dir", d])) == 0
    assert json.loads(capsys.readouterr().out)["ok"] is True

    assert ann_cli.run(_cli_args(["snapshot", "--dir", d, "--dim", str(DIM), "--device", "cpu"])) == 0
    st = json.loads(capsys.readouterr().out)
    assert st["snapshot_count"] == 1 and st["rows"] == 150

    assert ann_cli.run(_cli_args(["restore", "--dir", d, "--dim", str(DIM), "--device", "cpu"])) == 0
    st = json.loads(capsys.readouterr().out)
    assert st["recovered"] and st["rows"] == 150 and st["retrain_advised"] is False

    # corrupt an artifact: verify must exit non-zero (satellite 2's contract)
    snaps = os.listdir(os.path.join(d, "snapshots"))
    snap = os.path.join(d, "snapshots", sorted(snaps)[0])
    victim = next(
        os.path.join(snap, n) for n in sorted(os.listdir(snap)) if n.endswith(".npy")
    )
    with open(victim, "r+b") as f:
        f.seek(os.path.getsize(victim) // 2)
        b = f.read(1)
        f.seek(-1, os.SEEK_CUR)
        f.write(bytes([b[0] ^ 0xFF]))
    assert ann_cli.run(_cli_args(["verify", "--dir", d])) == 1
    assert json.loads(capsys.readouterr().out)["ok"] is False


def test_wal_record_header_layout_pinned():
    """The on-disk header is a contract (docs/DURABILITY.md): magic u32, seq
    u64, type u8, payload-len u32, crc u32 — little-endian, 21 bytes."""
    assert _HDR.size == struct.calcsize("<IQBII") == 21
    assert (REC_APPEND, REC_TOMBSTONE, REC_INSTALL) == (1, 2, 3)


# ----------------------------------------------------------------- gauges
def test_durability_gauges(tmp_path):
    """The durability block ``stats()`` carries (what the JAX package's
    ``/metrics`` renders as ``dabt_ann_*`` gauges)."""
    rows = _corpus(150)
    dur = DurableANN(str(tmp_path / "d"), dim=DIM, device="cpu", fsync="always", seed=7)
    dur.ingest(range(150), rows, ledger_key="doc0")
    dur.train(nlist=8, seed=7)
    dur.snapshot()
    st = dur.stats()["durability"]
    assert st["wal_records"] == 2 and st["snapshot_count"] == 1
    assert st["snapshot_age_s"] is not None and st["writable"] is True
    assert st["snapshot_fallbacks"] == 0 and st["ledger_entries"] == 1
    assert st["fsync"] == "always" and st["mmap_rows"] is False
    dur.close()


# ------------------------------------------------------------ the ANN CLI
def test_cli_train_and_probe_recall_synthetic(capsys):
    from django_assistant_bot_tpu_torch.cli import main

    assert main(["ann", "train", "--synthetic", "3000", "--dim", "32", "--device", "cpu"]) == 0
    st = json.loads(capsys.readouterr().out)
    assert st["trained"] and st["rows"] == 3000 and st["build_s"] > 0
    assert set(st["restage_s"]) >= {"learn_s", "assign_s", "encode_s", "total_s"}
    assert main(["ann", "probe-recall", "--synthetic", "3000", "--dim", "32", "--curve",
                 "--device", "cpu", "--queries", "16"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0].startswith("nprobe=    1") and "recall@10=1.0000" in lines[-1]
    with pytest.raises(SystemExit, match="item 16"):
        main(["ann", "stats", "--model", "sentences", "--device", "cpu"])


# ------------------------------------------------------ across the packages
def _queries(rows, n=6):
    return rows[:: max(1, rows.shape[0] // n)][:n] + 0.01


def _codes_by_row(index):
    """Each live position's (list, code row), from either package's index."""
    n = index._n
    live = np.array([p for p in range(n) if p not in index._dead], np.int64)
    lists, slots = index._row_list[live], index._row_slot[live]
    codes = np.asarray(index._codes.cpu() if hasattr(index._codes, "cpu") else index._codes)
    return live, lists, codes[lists, slots]


def _near_ties(index, live, lists, codes_a, codes_b):
    """(codes that differ, of which near ties): a code differs only where
    its two candidate distances ``|c|^2 - 2 r.c`` lie within twice the f32
    rounding bound of computing them, ``(sub + 2) 2^-24 (|c|^2 + 2 sum |r_i
    c_i|)`` each."""
    cent = np.asarray(index._centroids.cpu() if hasattr(index._centroids, "cpu")
                      else index._centroids, np.float64)
    cb = np.asarray(index._codebooks.cpu() if hasattr(index._codebooks, "cpu")
                    else index._codebooks, np.float64)
    m, _, sub = cb.shape
    rows = make_rows_norm(index, live)
    resid = (rows - cent[lists].astype(np.float32)).astype(np.float64).reshape(-1, m, sub)
    differ = np.argwhere(codes_a != codes_b)
    ties = 0
    for r, j in differ:
        a, b = int(codes_a[r, j]), int(codes_b[r, j])
        da = (cb[j, a] ** 2).sum() - 2 * resid[r, j] @ cb[j, a]
        db = (cb[j, b] ** 2).sum() - 2 * resid[r, j] @ cb[j, b]
        err = lambda c: (sub + 2) * 2.0 ** -24 * ((c ** 2).sum() + 2 * np.abs(resid[r, j] * c).sum())
        if abs(da - db) <= 2 * (err(cb[j, a]) + err(cb[j, b])):
            ties += 1
    return len(differ), ties


def make_rows_norm(index, live):
    x = np.asarray(index._mat[live], np.float32)
    return (x / np.maximum(np.linalg.norm(x, axis=-1, keepdims=True), 1e-12)).astype(np.float32)


def test_jax_directory_opens_in_the_port(tmp_path, record_property):
    from django_assistant_bot_tpu.storage.durable import DurableANN as JaxDurableANN
    from django_assistant_bot_tpu.storage.durable import verify_dir as jax_verify_dir

    rows = _corpus(400)
    q = _queries(rows)
    d = str(tmp_path / "d")
    jd = JaxDurableANN(d, dim=DIM, fsync="always", seed=7)
    jd.ingest(range(300), rows[:300], ledger_key="doc0")
    jd.train(nlist=8, seed=7)
    jd.snapshot()
    jd.ingest(range(300, 400), rows[300:], ledger_key="doc1")  # the WAL tail
    jd.remove([5, 6, 7, 350])
    before = _topk(jd, q)
    j_live, j_lists, j_codes = _codes_by_row(jd.index)
    jd.close()
    assert verify_dir(d) == jax_verify_dir(d)

    pd = DurableANN(d, dim=DIM, device="cpu", fsync="always", seed=7)
    st = pd.durability_stats()
    assert pd.recovered and st["replayed_records"] == 2 and st["snapshot_fallbacks"] == 0
    assert len(pd) == 396 and pd.ledger_has("doc0") and pd.ledger_has("doc1")
    assert _topk(pd, q) == before
    p_live, p_lists, p_codes = _codes_by_row(pd.index)
    np.testing.assert_array_equal(p_live, j_live)
    np.testing.assert_array_equal(p_lists, j_lists)
    differ, ties = _near_ties(pd.index, p_live, p_lists, p_codes, j_codes)
    record_property("codes_differing", differ)
    record_property("near_tie_codes", ties)
    assert differ == ties, f"{differ - ties} of {differ} differing codes are not near ties"
    pd.close()


def test_port_directory_passes_jax_verify_and_opens_in_jax(tmp_path, record_property):
    from django_assistant_bot_tpu.storage.durable import DurableANN as JaxDurableANN
    from django_assistant_bot_tpu.storage.durable import verify_dir as jax_verify_dir

    rows = _corpus(400)
    q = _queries(rows)
    d = str(tmp_path / "d")
    pd = DurableANN(d, dim=DIM, device="cpu", fsync="always", seed=7)
    pd.ingest(range(300), rows[:300], ledger_key="doc0")
    pd.train(nlist=8, seed=7)
    pd.snapshot()
    pd.ingest(range(300, 400), rows[300:], ledger_key="doc1")
    pd.remove([5, 6, 7, 350])
    before = _topk(pd, q)
    p_live, p_lists, p_codes = _codes_by_row(pd.index)
    pd.close()
    report = jax_verify_dir(d)
    assert report["ok"] and report == verify_dir(d)

    jd = JaxDurableANN(d, dim=DIM, fsync="always", seed=7)
    assert jd.durability_stats()["replayed_records"] == 2 and len(jd) == 396
    assert _topk(jd, q) == before
    j_live, j_lists, j_codes = _codes_by_row(jd.index)
    np.testing.assert_array_equal(j_live, p_live)
    np.testing.assert_array_equal(j_lists, p_lists)
    differ, ties = _near_ties(pd.index, p_live, p_lists, p_codes, j_codes)
    record_property("codes_differing", differ)
    record_property("near_tie_codes", ties)
    assert differ == ties
    jd.close()

    # one flipped byte in a snapshot artifact: both packages' verify object alike
    snap = os.path.join(d, "snapshots", report["snapshots"][0]["name"])
    victim = os.path.join(snap, "vectors.npy")
    with open(victim, "r+b") as f:
        f.seek(os.path.getsize(victim) // 2)
        b = f.read(1)
        f.seek(-1, os.SEEK_CUR)
        f.write(bytes([b[0] ^ 0xFF]))
    bad = verify_dir(d)
    assert not bad["ok"] and bad == jax_verify_dir(d)
    assert any("vectors.npy: crc32c mismatch" in p for p in bad["problems"])
