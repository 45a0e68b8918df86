"""WALStore — crash-consistent, file-backed ObjectStore.

The durability tier between MemStore (tests) and the reference's
BlueStore (src/os/bluestore/BlueStore.cc, out of scope per SURVEY.md
§2.9 item 9): every committed Transaction is framed, checksummed and
appended to a write-ahead log before it is applied in memory, exactly
the journal-then-apply contract FileStore keeps with its journal
(src/os/filestore/FileJournal.{h,cc}: entry = header + payload + crc,
replay stops at the first torn record).  Mounting replays the newest
checkpoint plus the WAL suffix, so an OSD process killed with -9
resumes from its own data directory and recovers by PG-log delta
instead of full backfill (src/osd/OSD.cc:2469 init: mount store, read
superblock, load PGs).

Layout of a store directory:

    superblock.json   store identity + format version (OSDSuperblock)
    checkpoint.bin    full-store snapshot (MemStore.save format); its
                      committed_txns field is the WAL sequence fence
    wal.bin           append-only records: seq-stamped, crc32c-framed
                      encoded Transactions

Crash consistency: records are applied only if the length and crc
check out AND the sequence is the expected successor; the first torn
or corrupt record ends replay (everything before it is intact because
appends are ordered).  Checkpointing writes the snapshot via
tmp+rename first, then truncates the WAL — a crash between the two
leaves stale WAL records whose seq <= the checkpoint fence; replay
skips them.

fsync policy: records are always flushed to the OS (surviving process
kill -9, the thrash-suite case, ceph_manager.py:195).  ``fsync=True``
additionally fdatasyncs per commit for power-loss durability, the
journal's J_SYNC mode — off by default because every test harness here
only ever kills processes, not the host.

The port's own copy of ``ceph_tpu/os_store/walstore.py``.  Record crcs
go through the port's ``utils/crc32c`` (the native library).  The op
code table has no code for ``write_shard``, as in the JAX package: a
mounted store refuses a transaction that carries one (``KeyError``
before anything is journaled or applied).
"""
from __future__ import annotations

import json
import os
import struct
from typing import Dict, List, Optional, Tuple

from ..utils.crc32c import crc32c
from .memstore import (MemStore, Transaction, hobject_t, OP_TOUCH, OP_WRITE,
                       OP_ZERO, OP_TRUNCATE, OP_REMOVE, OP_SETATTR,
                       OP_RMATTR, OP_OMAP_SETKEYS, OP_OMAP_RMKEYS,
                       OP_MKCOLL, OP_RMCOLL)

_REC_MAGIC = 0x57414C52          # "WALR"
_SB_VERSION = 1
_HDR = struct.Struct("<IQII")    # magic, seq, payload len, payload crc32c

# stable one-byte codes for the op vocabulary (the string names stay the
# in-memory representation; the WAL is a binary format)
_OP_CODES = {
    OP_TOUCH: 1, OP_WRITE: 2, OP_ZERO: 3, OP_TRUNCATE: 4, OP_REMOVE: 5,
    OP_SETATTR: 6, OP_RMATTR: 7, OP_OMAP_SETKEYS: 8, OP_OMAP_RMKEYS: 9,
    OP_MKCOLL: 10, OP_RMCOLL: 11,
}
_OP_NAMES = {v: k for k, v in _OP_CODES.items()}


def _pstr(b: bytes) -> bytes:
    return struct.pack("<I", len(b)) + b


class _Reader:
    def __init__(self, buf: bytes):
        self.buf = buf
        self.pos = 0

    def u8(self) -> int:
        v = self.buf[self.pos]
        self.pos += 1
        return v

    def u32(self) -> int:
        (v,) = struct.unpack_from("<I", self.buf, self.pos)
        self.pos += 4
        return v

    def i32(self) -> int:
        (v,) = struct.unpack_from("<i", self.buf, self.pos)
        self.pos += 4
        return v

    def u64(self) -> int:
        (v,) = struct.unpack_from("<Q", self.buf, self.pos)
        self.pos += 8
        return v

    def pstr(self) -> bytes:
        n = self.u32()
        b = self.buf[self.pos:self.pos + n]
        if len(b) != n:
            raise ValueError("truncated string")
        self.pos += n
        return b


def encode_txn(t: Transaction) -> bytes:
    """Binary Transaction encoding (ObjectStore::Transaction::encode
    analog, os/Transaction.cc): op count then per-op tagged fields."""
    out = [struct.pack("<I", len(t.ops))]
    for op in t.ops:
        code = _OP_CODES[op[0]]
        out.append(struct.pack("<B", code))
        if code in (10, 11):                       # mkcoll / rmcoll
            out.append(_pstr(op[1].encode()))
            continue
        _, cid, oid = op[0], op[1], op[2]
        out.append(_pstr(cid.encode()))
        out.append(_pstr(oid.oid.encode()))
        out.append(struct.pack("<i", oid.shard))
        if code == 2:                              # write
            out.append(struct.pack("<Q", op[3]))
            out.append(_pstr(op[4]))
        elif code == 3:                            # zero
            out.append(struct.pack("<QQ", op[3], op[4]))
        elif code == 4:                            # truncate
            out.append(struct.pack("<Q", op[3]))
        elif code == 6:                            # setattr
            out.append(_pstr(op[3].encode()))
            out.append(_pstr(op[4]))
        elif code == 7:                            # rmattr
            out.append(_pstr(op[3].encode()))
        elif code == 8:                            # omap_setkeys
            out.append(struct.pack("<I", len(op[3])))
            for k in sorted(op[3]):
                out.append(_pstr(k.encode()))
                out.append(_pstr(op[3][k]))
        elif code == 9:                            # omap_rmkeys
            out.append(struct.pack("<I", len(op[3])))
            for k in op[3]:
                out.append(_pstr(k.encode()))
    return b"".join(out)


def decode_txn(buf: bytes) -> Transaction:
    r = _Reader(buf)
    n = r.u32()
    t = Transaction()
    for _ in range(n):
        code = r.u8()
        name = _OP_NAMES.get(code)
        if name is None:
            raise ValueError(f"unknown wal op code {code}")
        if code in (10, 11):
            t.ops.append((name, r.pstr().decode()))
            continue
        cid = r.pstr().decode()
        oid = hobject_t(r.pstr().decode(), r.i32())
        if code == 2:
            off = r.u64()
            t.ops.append((name, cid, oid, off, r.pstr()))
        elif code == 3:
            off = r.u64()
            t.ops.append((name, cid, oid, off, r.u64()))
        elif code == 4:
            t.ops.append((name, cid, oid, r.u64()))
        elif code == 6:
            k = r.pstr().decode()
            t.ops.append((name, cid, oid, k, r.pstr()))
        elif code == 7:
            t.ops.append((name, cid, oid, r.pstr().decode()))
        elif code == 8:
            cnt = r.u32()
            kv = {}
            for _k in range(cnt):
                k = r.pstr().decode()
                kv[k] = r.pstr()
            t.ops.append((name, cid, oid, kv))
        elif code == 9:
            cnt = r.u32()
            t.ops.append((name, cid, oid,
                          [r.pstr().decode() for _k in range(cnt)]))
        else:                                      # touch / remove
            t.ops.append((name, cid, oid))
    return t


class WALStore(MemStore):
    """File-backed MemStore: journal first, apply second."""

    WAL_MAX_BYTES = 8 << 20       # checkpoint + truncate past this

    def __init__(self, directory: str, fsync: bool = False,
                 wal_max_bytes: Optional[int] = None):
        super().__init__()
        self.dir = directory
        self.fsync = fsync
        self.wal_max_bytes = (wal_max_bytes if wal_max_bytes is not None
                              else self.WAL_MAX_BYTES)
        self._wal_f = None
        self._wal_size = 0

    # ---- paths -------------------------------------------------------------
    @property
    def _sb_path(self) -> str:
        return os.path.join(self.dir, "superblock.json")

    @property
    def _ckpt_path(self) -> str:
        return os.path.join(self.dir, "checkpoint.bin")

    @property
    def _wal_path(self) -> str:
        return os.path.join(self.dir, "wal.bin")

    # ---- lifecycle ---------------------------------------------------------
    def mount(self) -> None:
        """Create-or-recover: load the checkpoint, replay the WAL suffix,
        open the log for appending (OSD::init's store->mount)."""
        os.makedirs(self.dir, exist_ok=True)
        if os.path.exists(self._sb_path):
            with open(self._sb_path) as f:
                sb = json.load(f)
            if sb.get("version") != _SB_VERSION:
                raise ValueError(
                    f"{self.dir}: superblock version {sb.get('version')}")
        else:
            with open(self._sb_path, "w") as f:
                json.dump({"version": _SB_VERSION, "type": "walstore"}, f)
        fence = 0
        if os.path.exists(self._ckpt_path):
            snap = MemStore.load(self._ckpt_path)
            self.colls = snap.colls
            self.committed_txns = snap.committed_txns
            fence = snap.committed_txns
        replayed, frontier = self._replay_wal(fence)
        self.committed_txns = max(self.committed_txns, replayed)
        # cut the log AT the recovery frontier: appending after torn
        # garbage would strand every post-recovery record behind bytes
        # the next replay refuses to cross (FileJournal does the same —
        # committed_up_to defines where the journal restarts)
        if os.path.exists(self._wal_path) and \
                frontier != os.path.getsize(self._wal_path):
            with open(self._wal_path, "r+b") as f:
                f.truncate(frontier)
        self._wal_f = open(self._wal_path, "ab")
        self._wal_size = self._wal_f.tell()

    def umount(self) -> None:
        """Checkpoint and close (clean shutdown; reopening replays
        nothing)."""
        if self._wal_f is None:
            return
        self._checkpoint()
        self._wal_f.close()
        self._wal_f = None

    def _replay_wal(self, fence: int) -> Tuple[int, int]:
        """Apply WAL records with seq > fence, in order.  Returns
        (last seq applied-or-skipped, byte offset of the recovery
        frontier).  Replay ends at the first torn, corrupt, gapped or
        unappliable record — everything past that offset is garbage the
        caller truncates away."""
        if not os.path.exists(self._wal_path):
            return fence, 0
        with open(self._wal_path, "rb") as f:
            buf = f.read()
        pos, seq = 0, fence
        while pos + _HDR.size <= len(buf):
            magic, rseq, ln, crc = _HDR.unpack_from(buf, pos)
            if magic != _REC_MAGIC:
                return seq, pos
            payload = buf[pos + _HDR.size:pos + _HDR.size + ln]
            if len(payload) != ln or crc32c(payload) != crc:
                return seq, pos                    # torn tail
            if rseq <= fence:
                pos += _HDR.size + ln
                continue                           # pre-checkpoint record
            if rseq != seq + 1:
                return seq, pos                    # sequence gap
            try:
                t = decode_txn(payload)
                MemStore.queue_transaction(self, t)
            except Exception:
                # undecodable or unappliable (a record the writer
                # itself rolled back but crashed before truncating):
                # recovery stops here, never raises out of mount
                return seq, pos
            pos += _HDR.size + ln
            self.committed_txns = seq = rseq
        return seq, pos

    # ---- commits -----------------------------------------------------------
    def queue_transaction(self, t: Transaction) -> None:
        if self._wal_f is None:
            # unmounted use degrades to MemStore semantics (tests build
            # stores before wiring directories)
            MemStore.queue_transaction(self, t)
            return
        with self._write_lock:
            payload = encode_txn(t)
            seq = self.committed_txns + 1
            rec = _HDR.pack(_REC_MAGIC, seq, len(payload),
                            crc32c(payload)) + payload
            pos0 = self._wal_size
            self._wal_f.write(rec)
            self._wal_f.flush()
            try:
                MemStore.queue_transaction(self, t)  # may raise pre-apply
            except Exception:
                # invalid transaction: rewind the journal so the failed
                # record can't poison replay (its seq will be reused by
                # the next good commit)
                self._wal_f.truncate(pos0)
                self._wal_f.seek(pos0)
                self._wal_f.flush()
                raise
            if self.fsync:
                os.fsync(self._wal_f.fileno())
            self._wal_size = pos0 + len(rec)
            assert self.committed_txns == seq
            if self._wal_size >= self.wal_max_bytes:
                self._checkpoint()

    def _checkpoint(self) -> None:
        """Snapshot-then-truncate: MemStore.save is already atomic via
        tmp+rename; only after the rename lands is the WAL cut.  In
        fsync mode the snapshot (file + directory entry) must be ON
        DISK before the cut, or power loss right after the truncate
        could lose everything up to the fence."""
        self.save(self._ckpt_path)
        if self.fsync:
            fd = os.open(self._ckpt_path, os.O_RDONLY)
            try:
                os.fsync(fd)
            finally:
                os.close(fd)
            dfd = os.open(self.dir, os.O_RDONLY)
            try:
                os.fsync(dfd)
            finally:
                os.close(dfd)
        self._wal_f.close()
        self._wal_f = open(self._wal_path, "wb")
        if self.fsync:
            os.fsync(self._wal_f.fileno())
        self._wal_size = 0

    # ---- fsck --------------------------------------------------------------
    def fsck(self) -> Dict:
        """Offline consistency report (BlueStore::fsck analog): walk the
        checkpoint and every WAL record, verify framing + crc + sequence
        continuity.  Safe on a mounted or unmounted directory."""
        report: Dict = {"checkpoint": None, "wal_records": 0,
                        "wal_torn_tail": False, "wal_errors": [],
                        "ok": True}
        fence = 0
        if os.path.exists(self._ckpt_path):
            try:
                snap = MemStore.load(self._ckpt_path)
                fence = snap.committed_txns
                report["checkpoint"] = {
                    "seq": fence,
                    "collections": len(snap.colls),
                    "objects": sum(len(c) for c in snap.colls.values()),
                }
            except Exception as e:
                report["checkpoint"] = {"error": repr(e)}
                report["ok"] = False
        if os.path.exists(self._wal_path):
            with open(self._wal_path, "rb") as f:
                buf = f.read()
            pos, seq = 0, None
            while pos < len(buf):
                if pos + _HDR.size > len(buf):
                    report["wal_torn_tail"] = True
                    break
                magic, rseq, ln, crc = _HDR.unpack_from(buf, pos)
                payload = buf[pos + _HDR.size:pos + _HDR.size + ln]
                if magic != _REC_MAGIC or len(payload) != ln \
                        or crc32c(payload) != crc:
                    report["wal_torn_tail"] = True
                    break
                if seq is not None and rseq != seq + 1:
                    report["wal_errors"].append(
                        f"seq gap {seq} -> {rseq}")
                    report["ok"] = False
                try:
                    decode_txn(payload)
                except Exception as e:
                    report["wal_errors"].append(
                        f"seq {rseq}: undecodable ({e!r})")
                    report["ok"] = False
                seq = rseq
                report["wal_records"] += 1
                pos += _HDR.size + ln
        return report


def mount_store(directory: str, fsync: bool = False) -> WALStore:
    s = WALStore(directory, fsync=fsync)
    s.mount()
    return s
