"""PGLog — per-PG operation log enabling log-bounded (delta) recovery.

Mirrors the reference's src/osd/PGLog.{h,cc} role: every mutation appends
a (version, oid, op) entry on every shard in the same transaction as the
data write; after a flap, the primary computes each peer's missing set by
replaying only the log suffix past the peer's last_update instead of
rescanning stores.  A peer whose last_update fell behind the log tail is
beyond log-bounded repair and goes through backfill (full listing diff),
like the reference's backfill path.

Entries persist in the shard store: a per-PG meta object holds the log in
omap (key = zero-padded version) and last_update/tail as attrs, so a
restarted OSD resumes from its on-disk state (OSD.cc:2469+ resume model).

The port's own copy of ``ceph_tpu/osd/pg_log.py``.
"""
from __future__ import annotations

import struct
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from ..os_store import MemStore, Transaction, hobject_t

OP_MODIFY = "m"
OP_DELETE = "d"

PG_META_OID = "_pgmeta"          # per-shard-collection meta object
SNAPSET_KEY_PREFIX = "ss\x00"    # meta omap namespace for per-oid snapsets

# snapset entry kinds (SnapSet clone bookkeeping, osd_types.h SnapSet)
SNAP_CLONE = 1       # a clone object exists for this seq
SNAP_WHITEOUT = 0    # object did not exist when this seq was crossed
SNAP_TRIMMED = 2     # tombstone: entries up to this seq were trimmed —
                     # keeps stale peers from resurrecting dead clones
LAST_UPDATE_ATTR = "_last_update"
LOG_TAIL_ATTR = "_log_tail"
VERSION_ATTR = "_version"        # per-object: pg_log version of its data

DEFAULT_LOG_ENTRIES = 500        # osd_min_pg_log_entries-style bound


@dataclass(frozen=True)
class LogEntry:
    version: int
    oid: str
    op: str        # OP_MODIFY | OP_DELETE

    def encode(self) -> bytes:
        o = self.oid.encode()
        return struct.pack("<QB", self.version,
                           1 if self.op == OP_DELETE else 0) + o

    @classmethod
    def decode(cls, b: bytes) -> "LogEntry":
        version, d = struct.unpack_from("<QB", b)
        return cls(version=version, oid=b[9:].decode(),
                   op=OP_DELETE if d else OP_MODIFY)


class PGLog:
    """In-memory log mirror with store-backed persistence."""

    def __init__(self, max_entries: int = DEFAULT_LOG_ENTRIES):
        self.entries: List[LogEntry] = []
        self.tail = 0          # every version <= tail has been trimmed
        self.head = 0          # last_update
        self.max_entries = max_entries

    # ---- mutation ----------------------------------------------------------
    def append(self, entry: LogEntry, t: Transaction, cid: str) -> None:
        """Record the entry and stage its persistence into *t* (same
        transaction as the data mutation, the reference's atomicity)."""
        assert entry.version > self.head, (entry.version, self.head)
        self.entries.append(entry)
        self.head = entry.version
        meta = hobject_t(PG_META_OID)
        t.touch(cid, meta)
        t.omap_setkeys(cid, meta, {self._key(entry.version): entry.encode()})
        t.setattr(cid, meta, LAST_UPDATE_ATTR, struct.pack("<Q", self.head))
        if len(self.entries) > self.max_entries:
            self._trim(t, cid)

    def _trim(self, t: Transaction, cid: str) -> None:
        drop = self.entries[:-self.max_entries]
        self.entries = self.entries[-self.max_entries:]
        self.tail = self.entries[0].version - 1 if self.entries else self.head
        meta = hobject_t(PG_META_OID)
        t.omap_rmkeys(cid, meta, [self._key(e.version) for e in drop])
        # rollback stashes are only consumable while their entry can
        # still be divergent-rewound, i.e. while the oid has an in-log
        # entry; once its last entry trims, drop the stash (the
        # reference similarly trims rollback info past can_rollback_to)
        live = {e.oid for e in self.entries}
        dead = sorted({ROLLBACK_KEY_PREFIX + e.oid for e in drop
                       if e.oid not in live})
        if dead:
            t.omap_rmkeys(cid, meta, dead)
        t.setattr(cid, meta, LOG_TAIL_ATTR, struct.pack("<Q", self.tail))

    @staticmethod
    def _key(version: int) -> str:
        return f"{version:020d}"

    # ---- queries -----------------------------------------------------------
    def entries_after(self, version: int) -> Optional[List[LogEntry]]:
        """Log suffix past *version*, or None when the log was trimmed
        beyond it (-> backfill)."""
        if version < self.tail:
            return None
        return [e for e in self.entries if e.version > version]

    def missing_after(self, version: int
                      ) -> Optional[Dict[str, Tuple[int, str]]]:
        """oid -> (latest version, op) for everything changed past
        *version*; None = out of log bounds."""
        suffix = self.entries_after(version)
        if suffix is None:
            return None
        out: Dict[str, Tuple[int, str]] = {}
        for e in suffix:
            out[e.oid] = (e.version, e.op)
        return out

    def merge_authoritative(self, entries: List[LogEntry], t: Transaction,
                            cid: str) -> None:
        """Adopt an authoritative log suffix (primary catching up to a
        peer that saw newer writes — the GetLog step)."""
        for e in entries:
            if e.version > self.head:
                self.append(e, t, cid)

    def rewind_to(self, version: int, t: Transaction,
                  cid: str) -> List[LogEntry]:
        """Drop every entry past *version* and move the head back
        (rewind_divergent_log, src/osd/PGLog.cc): the divergent suffix
        is returned (ascending) so the caller can roll the touched
        objects back.  Persistence rides *t* like append's."""
        dropped = [e for e in self.entries if e.version > version]
        if not dropped:
            return []
        self.entries = [e for e in self.entries if e.version <= version]
        self.head = max(version, self.tail)
        meta = hobject_t(PG_META_OID)
        t.touch(cid, meta)
        t.omap_rmkeys(cid, meta, [self._key(e.version) for e in dropped])
        t.setattr(cid, meta, LAST_UPDATE_ATTR, struct.pack("<Q", self.head))
        return dropped

    def split_into(self, child: "PGLog", child_oids,
                   t_parent: Transaction, parent_cid: str,
                   t_child: Transaction, child_cid: str) -> None:
        """Move entries for *child_oids* out of this log into *child*
        (PGLog::split_into role).  Both logs keep the parent's
        head/tail so peering version comparisons stay consistent
        across the identically-split replicas; persistence rides the
        two transactions."""
        meta = hobject_t(PG_META_OID)
        child_entries = [e for e in self.entries if e.oid in child_oids]
        self.entries = [e for e in self.entries
                        if e.oid not in child_oids]
        child.head = self.head
        child.tail = self.tail
        child.entries = child_entries
        t_parent.touch(parent_cid, meta)
        t_parent.omap_rmkeys(parent_cid, meta,
                             [self._key(e.version)
                              for e in child_entries])
        t_child.touch(child_cid, meta)
        t_child.omap_setkeys(child_cid, meta,
                             {self._key(e.version): e.encode()
                              for e in child_entries})
        for t, cid in ((t_parent, parent_cid), (t_child, child_cid)):
            t.setattr(cid, meta, LAST_UPDATE_ATTR,
                      struct.pack("<Q", self.head))
            t.setattr(cid, meta, LOG_TAIL_ATTR,
                      struct.pack("<Q", self.tail))

    # ---- persistence -------------------------------------------------------
    def load(self, store: MemStore, cid: str) -> None:
        meta = hobject_t(PG_META_OID)
        if not store.collection_exists(cid) or not store.exists(cid, meta):
            return
        attrs = store.getattrs(cid, meta)
        if LAST_UPDATE_ATTR in attrs:
            self.head = struct.unpack("<Q", attrs[LAST_UPDATE_ATTR])[0]
        if LOG_TAIL_ATTR in attrs:
            self.tail = struct.unpack("<Q", attrs[LOG_TAIL_ATTR])[0]
        omap = store.omap_get(cid, meta)
        self.entries = sorted(
            (LogEntry.decode(v) for k, v in omap.items()
             if k.isdigit()),       # skip snapset/rollback namespaces
            key=lambda e: e.version)
        if self.entries:
            self.head = max(self.head, self.entries[-1].version)


# ---- rollback stashes (EC interrupted-write consistency) -------------------
#
# The reference makes EC writes atomic-per-stripe by writing append-only
# and recording roll-back info in the PG log (ECTransaction.h rollback
# extents; doc/dev/osd_internals/erasure_coding/ecbackend.rst:1-27).  The
# equivalent here: every versioned shard apply stashes the object's
# pre-write state (body + attrs) in the meta object's omap first, in the
# SAME transaction, so peering can restore it if the write proves
# divergent (reached fewer than k shards before the primary died).  One
# stash per object — writes on one object serialize through the backend's
# per-object queue, so at most one write per object is ever in flight.

ROLLBACK_KEY_PREFIX = "rb\x00"   # meta omap namespace for the stashes


def encode_rollback(replaced_version: int, prev_exists: bool,
                    prev_data: bytes,
                    prev_attrs: Dict[str, bytes]) -> bytes:
    parts = [struct.pack("<QBI", replaced_version,
                         1 if prev_exists else 0, len(prev_data)),
             prev_data, struct.pack("<I", len(prev_attrs))]
    for k, v in prev_attrs.items():
        kb = k.encode()
        parts.append(struct.pack("<II", len(kb), len(v)))
        parts.append(kb)
        parts.append(v)
    return b"".join(parts)


def decode_rollback(blob: bytes
                    ) -> Tuple[int, bool, bytes, Dict[str, bytes]]:
    version, exists, dlen = struct.unpack_from("<QBI", blob)
    off = 13
    data = blob[off:off + dlen]
    off += dlen
    (n,) = struct.unpack_from("<I", blob, off)
    off += 4
    attrs: Dict[str, bytes] = {}
    for _ in range(n):
        klen, vlen = struct.unpack_from("<II", blob, off)
        off += 8
        attrs[blob[off:off + klen].decode()] = blob[off + klen:
                                                    off + klen + vlen]
        off += klen + vlen
    return version, bool(exists), data, attrs


def stage_rollback(t: Transaction, cid: str, oid: str,
                   blob: bytes) -> None:
    meta = hobject_t(PG_META_OID)
    t.touch(cid, meta)
    t.omap_setkeys(cid, meta, {ROLLBACK_KEY_PREFIX + oid: blob})


def clear_rollback(t: Transaction, cid: str, oid: str) -> None:
    meta = hobject_t(PG_META_OID)
    t.omap_rmkeys(cid, meta, [ROLLBACK_KEY_PREFIX + oid])


def load_rollback(store: MemStore, cid: str, oid: str
                  ) -> Optional[Tuple[int, bool, bytes, Dict[str, bytes]]]:
    meta = hobject_t(PG_META_OID)
    if not store.collection_exists(cid) or not store.exists(cid, meta):
        return None
    blob = store.omap_get(cid, meta).get(ROLLBACK_KEY_PREFIX + oid)
    return decode_rollback(blob) if blob else None


# ---- snapsets (per-head clone bookkeeping in the same meta object) ---------

def encode_snapset(entries: List[Tuple[int, int]]) -> bytes:
    """[(seq, kind)] sorted ascending -> packed bytes."""
    return b"".join(struct.pack("<QB", s, k) for s, k in entries)


def decode_snapset(blob: bytes) -> List[Tuple[int, int]]:
    out = []
    for off in range(0, len(blob), 9):
        s, k = struct.unpack_from("<QB", blob, off)
        out.append((s, k))
    return out


def stage_snapset(t: Transaction, cid: str, oid: str, blob: bytes) -> None:
    """Stage a snapset write/removal into the meta object (same
    transaction as the data mutation it accompanies)."""
    meta = hobject_t(PG_META_OID)
    t.touch(cid, meta)
    key = SNAPSET_KEY_PREFIX + oid
    if blob:
        t.omap_setkeys(cid, meta, {key: blob})
    else:
        t.omap_rmkeys(cid, meta, [key])


def load_snapsets(store: MemStore, cid: str) -> Dict[str, List[Tuple[int, int]]]:
    meta = hobject_t(PG_META_OID)
    if not store.collection_exists(cid) or not store.exists(cid, meta):
        return {}
    out = {}
    for k, v in store.omap_get(cid, meta).items():
        if k.startswith(SNAPSET_KEY_PREFIX):
            out[k[len(SNAPSET_KEY_PREFIX):]] = decode_snapset(v)
    return out
