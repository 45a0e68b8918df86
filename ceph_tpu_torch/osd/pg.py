"""PG — placement group with log-based peering and recovery.

The reference drives each PG through a boost::statechart RecoveryMachine
(src/osd/PG.h:1879: Initial/Peering(GetInfo/GetLog/GetMissing)/Active
(Activating/Recovering/Backfilling)); here the same lifecycle is an
explicit state machine driven entirely by messages over the fabric:

- AdvMap: on every epoch the PG recomputes up/acting; a changed acting set
  puts the primary into PEERING and fans MOSDPGQuery to every acting
  shard (GetInfo).
- GetLog: if a peer reports a newer last_update, the primary fetches the
  authoritative log suffix and merges it (PGLog.merge_authoritative).
- GetMissing: each peer's missing set is computed from the log suffix
  past its reported last_update (log-bounded delta recovery, PGLog.h
  role); peers beyond the log tail go through backfill (MOSDPGScan
  listing diff).
- Activation: the primary ships each peer the log suffix it lacks
  (MOSDPGInfo activate=True) and goes ACTIVE; ops flow while recovery
  pushes reconstructed chunks in the background (ECBackend.cc:535-743).

Client ops on degraded objects are gated: reads exclude shards missing
the object; rmw writes recover the object first (PrimaryLogPG's
wait_for_missing_object semantics).

The port's own copy of ``ceph_tpu/osd/pg.py``.
"""
from __future__ import annotations

import copy
import struct
from typing import Callable, Dict, List, Optional, Set, Tuple

from ..crush.constants import CRUSH_ITEM_NONE
from ..msg import (
    CEPH_OSD_OP_APPEND, CEPH_OSD_OP_DELETE, CEPH_OSD_OP_READ,
    CEPH_OSD_OP_STAT, CEPH_OSD_OP_WRITE, CEPH_OSD_OP_WRITEFULL,
    MOSDOp, MOSDOpReply, MOSDPGInfo, MOSDPGQuery, MOSDPGScan,
    MOSDPGScanReply, MOSDRepScrub, MOSDRepScrubMap, Message,
)
from ..msg.messages import (
    CEPH_OSD_CMPXATTR_OP_EQ, CEPH_OSD_CMPXATTR_OP_GT,
    CEPH_OSD_CMPXATTR_OP_GTE, CEPH_OSD_CMPXATTR_OP_LT,
    CEPH_OSD_CMPXATTR_OP_LTE, CEPH_OSD_CMPXATTR_OP_NE,
    CEPH_OSD_OP_ASSERT_VER, CEPH_OSD_OP_CALL,
    CEPH_OSD_OP_CMPXATTR, CEPH_OSD_OP_COPY_FROM, CEPH_OSD_OP_CREATE,
    CEPH_OSD_OP_FLAG_EXCL,
    CEPH_OSD_OP_GETXATTR, CEPH_OSD_OP_GETXATTRS, CEPH_OSD_OP_OMAPGETVALS,
    CEPH_OSD_OP_OMAPRMKEYS, CEPH_OSD_OP_OMAPSETKEYS, CEPH_OSD_OP_RMXATTR,
    CEPH_OSD_OP_SETXATTR, CEPH_OSD_OP_TRUNCATE, CEPH_OSD_OP_ZERO, OSDOp,
)
from ..msg.kv import pack_kv, unpack_keys, unpack_kv
from ..common.dout import dlog
from ..trace import g_oplat
from ..os_store import Transaction, hobject_t
from .ec_backend import ECBackend, SIZE_ATTR
from .pg_log import (
    LogEntry, OP_DELETE, OP_MODIFY, PGLog, PG_META_OID, SNAP_CLONE,
    SNAP_TRIMMED, SNAP_WHITEOUT, VERSION_ATTR, encode_snapset,
    load_snapsets, stage_snapset,
)

PG_NUM_ATTR = "_pg_num"          # pg_num this PG's store layout reflects


def stored_pg_num_of(store, pg_id: Tuple[int, int]) -> int:
    """Read a PG layout's recorded pg_num straight from the store (0 =
    never recorded) — usable before any PG object exists."""
    cid = f"{pg_id[0]}.{pg_id[1]}_meta"
    meta = hobject_t(PG_META_OID)
    if store.collection_exists(cid) and store.exists(cid, meta):
        b = store.getattrs(cid, meta).get(PG_NUM_ATTR)
        if b:
            return struct.unpack("<I", b)[0]
    return 0

STATE_INITIAL = "initial"
STATE_PEERING = "peering"
STATE_ACTIVE = "active"
STATE_ACTIVE_RECOVERING = "active+recovering"


class ReplicatedBackend:
    """Full-copy backend for replicated pools (osd/ReplicatedBackend —
    replication is host-side fan-out, not device compute)."""

    def __init__(self, pg):
        self.pg = pg

    def cid(self) -> str:
        return f"{self.pg.pgid[0]}.{self.pg.pgid[1]}"

    def write(self, oid: str, data: bytes, offset: Optional[int] = None,
              full: bool = False, version: int = 0,
              xattrs: Optional[Dict[str, bytes]] = None,
              omap: Optional[Dict[str, bytes]] = None,
              attr_only: bool = False,
              snapset_update: Optional[Tuple[str, bytes]] = None) -> None:
        from ..msg.messages import MOSDECSubOpWrite
        if attr_only:
            off, partial, new_size = 0, True, 0
        elif full:
            off, partial = 0, False
            new_size = len(data)
        else:
            old = self.read(oid)
            old_size = len(old) if old is not None else 0
            off = old_size if offset is None else offset
            partial = True
            new_size = max(old_size, off + len(data))
        for osd in self.pg.acting:
            if osd == CRUSH_ITEM_NONE:
                continue
            msg = MOSDECSubOpWrite(tid=0, pgid=self.pg.pgid, shard=-1,
                                   oid=oid, chunk=data, offset=off,
                                   partial=partial, at_version=new_size,
                                   version=version, xattrs=xattrs,
                                   omap=omap, attr_only=attr_only,
                                   snapset_update=snapset_update)
            self.pg.send_to_osd(osd, msg)
        # stage ledger: replicated fans are fire-and-forget, so the
        # fan_out boundary (covering interpret + message build here)
        # is the last stage before the reply mark (trace/oplat.py)
        g_oplat.checkpoint("fan_out")

    def apply_write(self, msg, store) -> None:
        from .ec_backend import ECBackend, USER_ATTR_PREFIX
        cid = self.cid()
        t = Transaction()
        if not store.collection_exists(cid):
            t.create_collection(cid)
        ho = hobject_t(msg.oid)
        if msg.attr_only:
            t.touch(cid, ho)
            if not (store.collection_exists(cid)
                    and store.exists(cid, ho)):
                t.setattr(cid, ho, SIZE_ATTR, struct.pack("<Q", 0))
        else:
            from .ec_backend import DIGEST_ATTR
            if not msg.partial:
                t.truncate(cid, ho, 0)
            t.write(cid, ho, msg.offset, msg.chunk)
            if not msg.partial:
                from ..utils.crc32c import crc32c
                t.setattr(cid, ho, DIGEST_ATTR,
                          struct.pack("<I", crc32c(bytes(msg.chunk))))
            else:
                # unaligned overwrite: the whole-object digest no
                # longer describes the bytes — invalidate, don't lie
                # (after t.write, so the object exists to rmattr on)
                t.rmattr(cid, ho, DIGEST_ATTR)
            t.setattr(cid, ho, SIZE_ATTR, struct.pack("<Q", msg.at_version))
        ECBackend._apply_user_attrs(t, store, cid, ho, msg.xattrs)
        if msg.omap is not None:
            existing = store.omap_get(cid, ho) \
                if store.collection_exists(cid) and store.exists(cid, ho) \
                else {}
            if existing:
                t.omap_rmkeys(cid, ho, list(existing))
            if msg.omap:
                t.omap_setkeys(cid, ho, msg.omap)
        if msg.version:
            from .pg_log import VERSION_ATTR
            t.setattr(cid, ho, VERSION_ATTR, struct.pack("<Q", msg.version))
            if not msg.is_push:
                self.pg.append_log(
                    LogEntry(msg.version, msg.oid, OP_MODIFY), t)
        if msg.snapset_update is not None:
            self.pg.apply_snapset_update(tuple(msg.snapset_update), t)
        store.queue_transaction(t)
        if not msg.partial:
            self.pg.data_received(msg.oid)

    def read(self, oid: str) -> Optional[bytes]:
        store = self.pg.osd.store
        cid = self.cid()
        ho = hobject_t(oid)
        if not store.collection_exists(cid) or not store.exists(cid, ho):
            return None
        return store.read(cid, ho)

    def object_state(self, oid: str):
        """(exists, data, user_attrs, omap) from the local replica."""
        from .ec_backend import user_attrs_of
        store = self.pg.osd.store
        cid = self.cid()
        ho = hobject_t(oid)
        if not store.collection_exists(cid) or not store.exists(cid, ho):
            return False, b"", {}, {}
        return (True, store.read(cid, ho),
                user_attrs_of(store.getattrs(cid, ho)),
                dict(store.omap_get(cid, ho)))


class PG:
    def __init__(self, osd, pgid: Tuple[int, int], pool):
        self.osd = osd
        self.pgid = pgid
        self.pool = pool
        self.up: List[int] = []
        self.acting: List[int] = []
        self.up_primary = -1
        self.acting_primary = -1
        self.state = STATE_INITIAL
        self.last_epoch_started = 0
        self.last_scrub_stamp = 0.0
        self.last_deep_scrub_stamp = 0.0
        self.backend: Optional[ECBackend] = None
        self.rep_backend: Optional[ReplicatedBackend] = None
        if pool.is_erasure():
            ec_impl = osd.get_ec_impl(pool)
            self.backend = ECBackend(self, ec_impl, pool.stripe_width)
        else:
            self.rep_backend = ReplicatedBackend(self)
        # per-PG op lock (PG::lock; taken by threaded dequeue_op and
        # visible to lockdep)
        from ..common.lockdep import DebugLock
        self.op_lock = DebugLock(f"pg-{pgid[0]}.{pgid[1]}")
        # cache-tier machinery (replicated cache pools only)
        self.tier = None
        if pool.tier_of >= 0 and pool.cache_mode and \
                self.rep_backend is not None:
            from .tier import TierState
            self.tier = TierState(self)
        # log + versions (one per PG replica; persists in the meta coll)
        self.pg_log = PGLog()
        self.pg_log.load(osd.store, self.meta_cid())
        # pg_num this replica's layout reflects: from disk if recorded
        # (restart case — may lag the map, triggering a catch-up
        # split), else the pool's current value, persisted now so a
        # restart straddling a future split epoch can't miss it
        stored = self.stored_pg_num()
        if stored:
            self.known_pg_num = stored
        else:
            self.record_pg_num(pool.pg_num)
        self._version_alloc = self.pg_log.head
        # replica-side: objects whose log entries arrived (activation)
        # but whose data has not (pg_missing_t role) — rebuilt from
        # log-vs-store on mount so restarts don't forget
        self.local_missing: Dict[str, Tuple[int, str]] = {}
        # per-head snapset (clone bookkeeping) mirrored from the meta
        # object on this shard — every replica has it (SnapSet role)
        self.snapsets: Dict[str, List[Tuple[int, int]]] = \
            load_snapsets(osd.store, self.meta_cid())
        # snap -> heads index (SnapMapper role) + what was already
        # trimmed (pg_info_t.purged_snaps role, persisted so a primary
        # dying mid-trim is finished by its successor)
        from .snap_mapper import SnapMapper, load_purged
        self.purged_snaps: Set[int] = load_purged(osd.store,
                                                  self.meta_cid())
        self.snap_mapper = SnapMapper()
        self.snap_mapper.rebuild(self.snapsets, self._interesting_snaps())
        # watch/notify: primary-side in-memory state (Watch.cc role;
        # watchers re-register after a primary change, like clients do
        # on watch timeout in the reference)
        self.watchers: Dict[str, Dict[Tuple[str, int], float]] = {}
        self._notifies: Dict[int, Dict] = {}
        self._notify_seq = 0
        self._rebuild_local_missing()
        # primary-side peering/recovery state
        self.peer_last_update: Dict[int, int] = {}
        self.missing: Dict[int, Dict[str, Tuple[int, str]]] = {}
        self._peer_pending: Set[int] = set()
        self._peer_infos: Dict[int, MOSDPGInfo] = {}
        self._getlog_pending: Optional[int] = None
        self._rewind_requested = False
        self._rewind_horizon: Optional[int] = None
        # peering-round query retry state (retry_peering): the exact
        # queries sent this round, and the last (re)send stamp
        self._peering_queries: Dict[int, MOSDPGQuery] = {}
        self._peering_sent_at = -1e9
        self._backfill_pending: Set[int] = set()
        self._self_backfill_from: Optional[int] = None
        self._recovering: Set[str] = set()
        self._recovering_since: Dict[str, float] = {}
        self._waiting_for_recovery: Dict[str, List[Callable[[], None]]] = {}

    # ---- pg splitting (OSD::split_pgs / PG::split_into) -------------------
    def stored_pg_num(self) -> int:
        """pg_num this replica's on-disk layout reflects (0 = never
        recorded); lets a restarted OSD catch up on splits it missed."""
        return stored_pg_num_of(self.osd.store, self.pgid)

    def record_pg_num(self, n: int,
                      t: Optional[Transaction] = None) -> None:
        self.known_pg_num = n
        own = t is None
        if own:
            t = Transaction()
        cid = self.ensure_meta_collection(t)
        meta = hobject_t(PG_META_OID)
        t.touch(cid, meta)
        t.setattr(cid, meta, PG_NUM_ATTR, struct.pack("<I", n))
        if own:
            self.osd.store.queue_transaction(t)

    @staticmethod
    def _head_of(oid: str) -> str:
        """Snap clones hash (and therefore split) with their head."""
        return oid.split("\x00snap\x00", 1)[0]

    def split_children(self) -> None:
        """Split this PG's local shard data into its children after a
        pg_num increase (ceph_stable_mod keeps parent ps stable, so
        only objects whose hash lands in a child ps move).  Runs
        identically on every replica; with pgp_num unchanged the
        children map to the SAME acting set as the parent
        (raw_pg_to_pps uses pgp_num), so the split is purely local —
        a later pgp_num increase migrates children through the normal
        peering/backfill machinery.  Mirrors OSD::split_pgs +
        PG::split_into + PGLog::split_into.
        """
        pool_id, ps = self.pgid
        pool = self.osd.osdmap.pools.get(pool_id)
        if pool is None or pool.pg_num <= self.known_pg_num:
            return
        # serialize against in-flight client writes: worker threads run
        # do_op under this lock, and a write landing between our read
        # and the parent-side delete would be lost
        self.op_lock.acquire()
        try:
            self._split_children_locked(pool)
        finally:
            self.op_lock.release()

    def _split_children_locked(self, pool) -> None:
        pool_id, ps = self.pgid
        store = self.osd.store
        new_num, new_mask = pool.pg_num, pool.pg_num_mask
        from ..osdmap import ceph_stable_mod

        def target_ps(oid: str) -> int:
            return ceph_stable_mod(pool.hash_key(self._head_of(oid)),
                                   new_num, new_mask)

        # data collections: replicated "{pool}.{ps}", EC shards
        # "{pool}.{ps}s{shard}" — children keep the shard suffix
        suffixes: List[str] = []
        base = f"{pool_id}.{ps}"
        if self.backend is not None:
            prefix = base + "s"
            suffixes = [cid[len(base):] for cid in
                        store.list_collections()
                        if cid.startswith(prefix)]
        elif store.collection_exists(base):
            suffixes = [""]
        t_parent = Transaction()
        child_ts: Dict[int, Transaction] = {}
        moved_oids: Dict[int, set] = {}

        def child_t(cps: int) -> Transaction:
            if cps not in child_ts:
                child_ts[cps] = Transaction()
                moved_oids[cps] = set()
            return child_ts[cps]

        for sfx in suffixes:
            pcid = base + sfx
            if not store.collection_exists(pcid):
                continue
            for ho in store.list_objects(pcid):
                if ho.oid == PG_META_OID:
                    continue
                tps = target_ps(ho.oid)
                if tps == ps:
                    continue
                tc = child_t(tps)
                ccid = f"{pool_id}.{tps}{sfx}"
                if not store.collection_exists(ccid):
                    tc.create_collection(ccid)   # MKCOLL is idempotent
                data = store.read(pcid, ho)
                tc.touch(ccid, ho)
                if data:
                    tc.write(ccid, ho, 0, data)
                for name, val in store.getattrs(pcid, ho).items():
                    tc.setattr(ccid, ho, name, val)
                omap = store.omap_get(pcid, ho)
                if omap:
                    tc.omap_setkeys(ccid, ho, dict(omap))
                t_parent.remove(pcid, ho)
                moved_oids[tps].add(ho.oid)
        # meta: pg_log entries, snapsets, rollback stashes — split by
        # oid ownership under the NEW pg_num (log entries can name
        # deleted objects, so ownership comes from the hash, not the
        # moved set)
        pcid_meta = self.ensure_meta_collection(t_parent)
        meta = hobject_t(PG_META_OID)
        meta_omap = store.omap_get(pcid_meta, meta) \
            if store.collection_exists(pcid_meta) and \
            store.exists(pcid_meta, meta) else {}
        children: List["PG"] = []
        all_child_oids: Dict[int, set] = {}
        for e in self.pg_log.entries:
            tps = target_ps(e.oid)
            if tps != ps:
                all_child_oids.setdefault(tps, set()).add(e.oid)
        for oid in list(self.snapsets):
            tps = target_ps(oid)
            if tps != ps:
                all_child_oids.setdefault(tps, set()).add(oid)
        for tps in set(all_child_oids) | set(moved_oids):
            child = self.osd.get_or_create_pg((pool_id, tps))
            children.append(child)
            tc = child_t(tps)
            ccid_meta = child.ensure_meta_collection(tc)
            oids = all_child_oids.get(tps, set()) | moved_oids[tps]
            self.pg_log.split_into(child.pg_log, oids, t_parent,
                                   pcid_meta, tc, ccid_meta)
            # snapset + rollback omap keys follow their oid
            from .pg_log import ROLLBACK_KEY_PREFIX, SNAPSET_KEY_PREFIX
            move_keys = {}
            for k, v in meta_omap.items():
                for pfx in (SNAPSET_KEY_PREFIX, ROLLBACK_KEY_PREFIX):
                    if k.startswith(pfx) and \
                            target_ps(k[len(pfx):]) == tps:
                        move_keys[k] = v
            if move_keys:
                tc.touch(ccid_meta, meta)
                tc.omap_setkeys(ccid_meta, meta, move_keys)
                t_parent.omap_rmkeys(pcid_meta, meta,
                                     list(move_keys))
            # the child inherits the parent's trim history FIRST (its
            # objects were governed by it until this instant) so the
            # index entries built below exclude already-purged snaps
            child._adopt_purged(sorted(self.purged_snaps))
            # in-memory state follows
            child_interesting = child._interesting_snaps()
            for oid in list(self.snapsets):
                if target_ps(oid) == tps:
                    child.snapsets[oid] = self.snapsets.pop(oid)
                    self.snap_mapper.update_oid(
                        oid, [], ())
                    child.snap_mapper.update_oid(
                        oid, child.snapsets[oid], child_interesting)
            for oid in list(self.local_missing):
                if target_ps(oid) == tps:
                    child.local_missing[oid] = \
                        self.local_missing.pop(oid)
            for oid in list(self.watchers):
                if target_ps(oid) == tps:
                    child.watchers[oid] = self.watchers.pop(oid)
            child._version_alloc = max(child._version_alloc,
                                       child.pg_log.head)
            child.record_pg_num(new_num, tc)
            child.state = STATE_INITIAL
        self.record_pg_num(new_num, t_parent)
        self._version_alloc = max(self._version_alloc,
                                  self.pg_log.head)
        # children first: if we crash between transactions, objects
        # exist in both collections and the recorded parent pg_num
        # triggers a re-split that converges (moves are idempotent)
        for tps, tc in child_ts.items():
            store.queue_transaction(tc)
        store.queue_transaction(t_parent)
        self.state = STATE_INITIAL
        dlog("pg", 3,
             f"pg {self.pgid} split into "
             f"{sorted(c.pgid for c in children)} at pg_num {new_num}",
             f"osd.{self.osd.osd_id}")

    def data_high_water(self) -> int:
        """Highest object version this replica can actually SERVE —
        max of the log head and stored VERSION_ATTRs (pushed data can
        be newer than the local log after a realign/backfill).

        Cached against the store's commit counter: a refused stray
        notify retries every few seconds forever, and an O(objects)
        attr walk per retry on an idle cluster is pure waste."""
        store = self.osd.store
        cache = getattr(self, "_dhw_cache", None)
        key = (store.committed_txns, self.pg_log.head)
        if cache is not None and cache[0] == key:
            return cache[1]
        hi = self.pg_log.head
        if self.backend is not None:
            prefix = f"{self.pgid[0]}.{self.pgid[1]}s"
            cids = [c for c in store.list_collections()
                    if c.startswith(prefix)]
        else:
            cids = [f"{self.pgid[0]}.{self.pgid[1]}"]
        for cid in cids:
            if not store.collection_exists(cid):
                continue
            for ho in store.list_objects(cid):
                vb = store.getattrs(cid, ho).get(VERSION_ATTR)
                if vb:
                    hi = max(hi, struct.unpack("<Q", vb)[0])
        self._dhw_cache = (key, hi)
        return hi

    # ---- identity ---------------------------------------------------------
    def meta_cid(self) -> str:
        """Per-PG-replica meta collection (log + superblock attrs); named
        independently of the acting shard position, which changes on
        remap."""
        return f"{self.pgid[0]}.{self.pgid[1]}_meta"

    def is_primary(self) -> bool:
        return self.acting_primary == self.osd.osd_id

    def my_shard(self) -> int:
        for i, o in enumerate(self.acting):
            if o == self.osd.osd_id:
                return i
        return -1

    def acting_shards(self) -> Dict[int, int]:
        """shard index -> osd id, skipping NONE holes."""
        return {i: o for i, o in enumerate(self.acting)
                if o != CRUSH_ITEM_NONE}

    def send_to_osd(self, osd_id: int, msg: Message) -> None:
        self.osd.messenger.send_message(msg, f"osd.{osd_id}")

    def next_version(self) -> int:
        self._version_alloc = max(self._version_alloc,
                                  self.pg_log.head) + 1
        return self._version_alloc

    def ensure_meta_collection(self, t: Transaction) -> str:
        """Make sure *t* creates the meta collection if absent (spliced
        at the front so later ops in *t* can target it); returns its
        cid."""
        cid = self.meta_cid()
        if not self.osd.store.collection_exists(cid):
            pre = Transaction()
            pre.create_collection(cid)
            t.ops[0:0] = pre.ops      # mkcoll is idempotent in the store
        return cid

    def append_log(self, entry: LogEntry, t: Transaction) -> None:
        """Stage a log append into *t* (the data-write transaction)."""
        cid = self.ensure_meta_collection(t)
        if entry.version > self.pg_log.head:
            self.pg_log.append(entry, t, cid)

    def _rebuild_local_missing(self) -> None:
        """Mount-time: any logged modify whose object is absent — or
        present at an older version — is data this replica never
        received."""
        latest: Dict[str, Tuple[int, str]] = {}
        for e in self.pg_log.entries:
            latest[e.oid] = (e.version, e.op)
        if not latest:
            return
        snap = self._object_versions_snapshot()
        for oid, (v, op) in latest.items():
            if op == OP_DELETE:
                continue
            if snap.get(oid, -1) < v:
                self.local_missing[oid] = (v, op)

    def _object_versions_snapshot(self) -> Dict[str, int]:
        """One pass over this replica's collections: oid -> stored
        version (0 = pre-log object).  Batch form of _object_version so
        mount/activation stay linear, not quadratic."""
        from .pg_log import VERSION_ATTR
        store = self.osd.store
        if self.backend is not None:
            prefix = f"{self.pgid[0]}.{self.pgid[1]}s"
            cids = [cid for cid in store.list_collections()
                    if cid.startswith(prefix)]
        else:
            cids = [f"{self.pgid[0]}.{self.pgid[1]}"]
        out: Dict[str, int] = {}
        for cid in cids:
            if not store.collection_exists(cid):
                continue
            for ho in store.list_objects(cid):
                if ho.oid == PG_META_OID:
                    continue
                try:
                    v = struct.unpack(
                        "<Q", store.getattr(cid, ho, VERSION_ATTR))[0]
                except KeyError:
                    v = 0
                out[ho.oid] = max(out.get(ho.oid, -1), v)
        return out

    def _object_version(self, oid: str) -> int:
        """Stored pg_log version of this replica's copy (-1 = absent,
        0 = pre-log object)."""
        return self._object_versions_snapshot().get(oid, -1)

    def _have_version(self, oid: str, version: int) -> bool:
        return self._object_version(oid) >= version

    def _have_object(self, oid: str) -> bool:
        return self._object_version(oid) >= 0

    def data_received(self, oid: str) -> None:
        """A full copy/chunk of *oid* landed on this replica."""
        self.local_missing.pop(oid, None)

    # ---- peering (GetInfo / GetLog / GetMissing / Activate) ----------------
    def advance_map(self, osdmap) -> None:
        newpool = osdmap.get_pg_pool(self.pgid[0])
        snaps_changed = False
        if newpool is not None:
            snaps_changed = (newpool.snap_seq != self.pool.snap_seq or
                             newpool.removed_snaps !=
                             self.pool.removed_snaps)
            self.pool = newpool
            if self.tier is None and newpool.tier_of >= 0 and \
                    newpool.cache_mode and self.rep_backend is not None:
                from .tier import TierState
                self.tier = TierState(self)
            elif self.tier is not None and newpool.tier_of < 0:
                # overlay removed: stop intercepting, drain every
                # dirty object down, then drop the state (the agent
                # clears self.tier once nothing is owed; replicas owe
                # nothing and drop immediately)
                if self.tier.dirty or self.tier._flushing:
                    self.tier.shutting_down = True
                else:
                    self.tier = None
        # ``osdmap`` is the OSD's own: its memo of this epoch's mapping
        up, upp, acting, actp = self.osd.pg_mapping(self.pgid)
        changed = (acting != self.acting or actp != self.acting_primary)
        self.up, self.up_primary = up, upp
        self.acting, self.acting_primary = acting, actp
        if snaps_changed and not changed:
            # AFTER the acting update: trim must fan from the new
            # epoch's primary to the new acting set.  If the acting set
            # itself changed in this epoch, defer to the peering we are
            # about to start — _activate re-drives the trim once peer
            # snapsets/purged knowledge has been merged (a freshly
            # promoted primary trimming now could record purged off
            # near-empty knowledge)
            self._maybe_trim_snaps()
        if not (changed or self.state == STATE_INITIAL):
            return
        self.last_epoch_started = osdmap.epoch
        if not self.is_primary():
            # replicas serve sub-ops; the primary drives consistency
            self.state = STATE_ACTIVE
            return
        self.start_peering(osdmap.epoch)

    def start_peering(self, epoch: int) -> None:
        self.state = STATE_PEERING
        dlog("pg", 5, f"pg {self.pgid} -> peering, acting {self.acting}",
             f"osd.{self.osd.osd_id}")
        self.peering_epoch = epoch
        self._peer_infos.clear()
        self._getlog_pending = None
        self._rewind_requested = False
        self._backfill_pending.clear()
        self._self_backfill_from = None
        self.missing = {}
        self._recovering.clear()
        self._recovering_since.clear()
        self._waiting_for_recovery.clear()
        if self.backend is not None:
            self.backend.on_change()
        self._peer_pending = set(self.acting_shards())
        self._peering_queries = {}
        self._peering_sent_at = getattr(self.osd, "now", 0.0)
        self._rewind_horizon = None
        for shard, osd in self.acting_shards().items():
            self._send_peering_query(shard, MOSDPGQuery(
                pgid=self.pgid, shard=shard, epoch=epoch))

    def _send_peering_query(self, shard: int, msg: MOSDPGQuery) -> None:
        """Send one peering-round query, remembering it so the tick can
        resend the EXACT message (rewind_to/log_since included) while
        the shard stays pending — peering rides the same droppable
        fabric as data, and a lost query must not wedge the round."""
        self._peering_queries[shard] = msg
        osd = self.acting_shards().get(shard)
        if osd is not None:
            self.send_to_osd(osd, msg)

    def retry_peering(self) -> None:
        """Tick-driven resend of this peering round's outstanding
        queries (rate-limited).  Replies are idempotent: a replica
        re-answers info, an already-rewound shard's rewind is a no-op
        (pg_log.head <= to), a duplicate GetLog reply is dropped by
        the _getlog_pending check in handle_pg_info, and a late
        pre-rewind duplicate is rejected by the horizon gate there."""
        if not self.is_primary() or self.state != STATE_PEERING:
            return
        pending = set(self._peer_pending) \
            | ({self._getlog_pending}
               if self._getlog_pending is not None else set())
        if not pending:
            return
        now = self.osd.now
        if now - self._peering_sent_at < 2.0:
            return
        self._peering_sent_at = now
        acting = self.acting_shards()
        for shard in sorted(pending):
            msg = self._peering_queries.get(shard)
            if msg is not None and shard in acting:
                self.send_to_osd(acting[shard], msg)

    def handle_pg_query(self, msg: MOSDPGQuery) -> None:
        """Any replica (incl. the primary itself): report state; attach
        the log suffix when asked (GetLog)."""
        if msg.rewind_to >= 0 and msg.shard >= 0 and \
                msg.epoch >= self.last_epoch_started:
            # the epoch gate drops destructive rewinds from a superseded
            # primary (handle_pg_info filters its replies the same way)
            self._rewind_divergent(msg.rewind_to, msg.shard)
        entries: List[bytes] = []
        if msg.log_since >= 0:
            suffix = self.pg_log.entries_after(msg.log_since)
            if suffix:
                entries = [e.encode() for e in suffix]
        self.osd.messenger.send_message(MOSDPGInfo(
            pgid=self.pgid, shard=msg.shard, epoch=msg.epoch,
            last_update=self.pg_log.head, log_tail=self.pg_log.tail,
            log_entries=entries,
            missing_oids=[(o, v) for o, (v, _op)
                          in self.local_missing.items()],
            snapsets=self._encoded_snapsets(),
            purged_snaps=sorted(self.purged_snaps),
            held_shards=self.held_shards()), msg.src)

    def held_shards(self) -> List[int]:
        """EC shard positions whose collection holds data on THIS osd
        (spg_t identity stand-in: the data, not the log, names the
        shard)."""
        if self.backend is None:
            return []
        store = self.osd.store
        out = []
        for shard in range(self.pool.size):
            cid = f"{self.pgid[0]}.{self.pgid[1]}s{shard}"
            if store.collection_exists(cid) and store.list_objects(cid):
                out.append(shard)
        return out

    def _choose_acting(self) -> bool:
        """EC choose_acting (PG::choose_acting + queue_want_pg_temp):
        when CRUSH's remap put surviving shard data at the wrong
        positions, ask the mon to pin pg_temp so every data-bearing OSD
        serves the shard it actually holds; freed positions go to the
        remaining acting members, which then backfill.  Returns True if
        a pin was requested (activation waits for the new epoch)."""
        if self.backend is None:
            return False
        # shard -> ALL acting osds holding a copy (stale realign/split
        # leftovers mean several members can hold the same shard; a
        # first-writer-wins map here oscillated pg_temp forever)
        holders: Dict[int, Set[int]] = {}
        for slot, info in sorted(self._peer_infos.items()):
            osd = self.acting_shards().get(slot)
            if osd is None:
                continue
            for h in info.held_shards:
                holders.setdefault(h, set()).add(osd)
        acting_osds = [o for o in self.acting if o != CRUSH_ITEM_NONE]

        def placed(assignment: List[int]) -> int:
            return sum(1 for s, o in enumerate(assignment)
                       if o != CRUSH_ITEM_NONE
                       and o in holders.get(s, ()))

        current_good = placed(self.acting)
        # deterministic proposal: keep correctly-placed members, then
        # give each uncovered slot the lowest-id unused holder
        used: Set[int] = set()
        temp: List[int] = [CRUSH_ITEM_NONE] * len(self.acting)
        for s, o in enumerate(self.acting):
            if o != CRUSH_ITEM_NONE and o in holders.get(s, ()):
                temp[s] = o
                used.add(o)
        for s in range(len(temp)):
            if temp[s] != CRUSH_ITEM_NONE:
                continue
            cands = sorted(o for o in holders.get(s, ())
                           if o in acting_osds and o not in used)
            if cands:
                temp[s] = cands[0]
                used.add(cands[0])
        spare = [o for o in acting_osds if o not in used]
        spare += [o for o in self.up
                  if o != CRUSH_ITEM_NONE and o not in used
                  and o not in spare and o not in acting_osds]
        for s in range(len(temp)):
            if temp[s] == CRUSH_ITEM_NONE and spare:
                temp[s] = spare.pop(0)
        # pin only when the permutation STRICTLY beats the current
        # placement — equal-coverage alternatives would flip-flop, and
        # slots no permutation can cover belong to recovery/backfill
        if temp == self.acting or placed(temp) <= current_good:
            return False
        dlog("pg", 3, f"pg {self.pgid} choose_acting: data holders "
             f"{holders} vs acting {self.acting} -> pg_temp {temp}",
             f"osd.{self.osd.osd_id}")
        self._request_pg_temp(temp)
        return True

    def _request_pg_temp(self, temp: List[int]) -> None:
        """Send (and keep re-sending from the tick until an epoch
        carrying it arrives — the request can be dropped or hit a mon
        mid-election) the pg_temp pin/clear."""
        from ..msg.messages import MOSDPGTemp
        self._pending_pg_temp = list(temp)
        for mon in self.osd.mon_names:
            self.osd.messenger.send_message(MOSDPGTemp(
                pgid=self.pgid, epoch=self.last_epoch_started,
                temp=list(temp)), mon)

    def retry_pending_pg_temp(self) -> None:
        want = getattr(self, "_pending_pg_temp", None)
        if want is None:
            return
        if not self.is_primary():
            # demoted: a pin chosen under our old map must not override
            # the new primary's placement
            self._pending_pg_temp = None
            return
        from ..osdmap import pg_t
        cur = self.osd.osdmap.pg_temp.get(
            pg_t(self.pgid[0], self.pgid[1]), [])
        if list(cur) == want or (not want and not cur):
            self._pending_pg_temp = None
            return
        self._request_pg_temp(want)

    def maybe_realign(self) -> None:
        """Clean + pinned: move each shard to its CRUSH-up position
        (decode + push to the up member), then clear the pin — the
        reference's backfill-to-up that lets pg_temp be temporary."""
        if not self.is_primary():
            return
        if self.state != STATE_ACTIVE or self._has_missing() \
                or self._backfill_pending:
            return
        from ..osdmap import pg_t
        if pg_t(self.pgid[0], self.pgid[1]) not in self.osd.osdmap.pg_temp:
            return
        if getattr(self, "_realigning", False):
            # an ack/reply chain lost mid-flight must not wedge the
            # pin forever: reset after a grace and retry
            if self.osd.now - getattr(self, "_realign_started",
                                      self.osd.now) > 15.0:
                self._realigning = False
                self._rep_realign_ack = None
            return
        if self.backend is None:
            self._realign_replicated()
            return
        # quiesce: no in-flight writes may interleave with the shard
        # copies (clients see EAGAIN while realigning and resend) —
        # including pipelined encodes still queued in the dispatcher
        if self.backend._oid_queues or self.backend.inflight_writes \
                or self.backend.pipeline_inflight:
            return
        moves = [s for s in range(len(self.up))
                 if s < len(self.acting)
                 and self.up[s] != CRUSH_ITEM_NONE
                 and self.up[s] != self.acting[s]]
        objects = sorted(self._authoritative_objects())
        if not moves or not objects:
            self._request_pg_temp([])
            return
        self._realigning = True
        self._realign_started = self.osd.now
        start_head = self.pg_log.head
        dlog("pg", 3, f"pg {self.pgid} realign to up {self.up} "
             f"(moves {moves}, {len(objects)} objects)",
             f"osd.{self.osd.osd_id}")
        state = {"left": len(objects), "failed": False}

        def done_obj(ok: bool) -> None:
            state["left"] -= 1
            state["failed"] |= not ok
            if state["left"] == 0:
                self._realigning = False
                if not state["failed"] and \
                        self.pg_log.head == start_head:
                    # nothing wrote while the copies were in flight:
                    # the pushed shards are current -> drop the pin
                    self._request_pg_temp([])   # next epoch: acting = up

        from ..msg.messages import MOSDECSubOpWrite
        be = self.backend

        def start_obj(oid: str) -> None:
            def on_chunks(res, chunks, size, attrs):
                if res != 0:
                    done_obj(False)
                    return
                rec = be.recover_object(oid, set(moves), chunks, size)
                # stamp the object's version on the pushed shards —
                # receivers compare store VERSION_ATTR against their
                # log to build local_missing, and a mismatch leaves
                # the object "missing" forever on the new members
                ver = 0
                mine = self.my_shard()
                if mine >= 0:
                    scid = be.shard_cid(mine)
                    sho = be.shard_oid(oid, mine)
                    store = self.osd.store
                    if store.collection_exists(scid) and \
                            store.exists(scid, sho):
                        vb = store.getattrs(scid, sho).get(VERSION_ATTR)
                        if vb:
                            ver = struct.unpack("<Q", vb)[0]
                # acked pushes: done_obj only fires once every target
                # APPLIED its shard — clearing the pin earlier lets the
                # next peering round see the new members as missing and
                # wedge recovery on a stale missing-map
                be.push_chunks(
                    oid, {s_: rec[s_] for s_ in moves}, size,
                    lambda: done_obj(True), version=ver, xattrs=attrs,
                    targets={s_: self.up[s_] for s_ in moves})
            be.read_chunks(oid, on_chunks)

        for oid in objects:
            start_obj(oid)

    def _realign_replicated(self) -> None:
        """Full-copy analog of the EC realign for replicated pools:
        push every object (data + user attrs + omap + snapset +
        version) to the up members that are not yet acting, then clear
        the pin (backfill-to-up).  Needed when a placement change
        (pgp_num growth, crush edit) moves a PG to OSDs that never
        held its data — the mon primes pg_temp to the old acting and
        this migrates the copies before the flip.

        Same invariants as the EC realign: concurrent client writes
        are excluded (op_lock — tick runs without it), every push is
        ACKED before the pin clears, and a log-head change while the
        copies were in flight aborts the clear so the next tick
        re-runs with current data."""
        to_add = [o for o in self.up
                  if o != CRUSH_ITEM_NONE and o not in self.acting]
        store = self.osd.store
        be = self.rep_backend
        cid = be.cid()
        oids = [ho.oid for ho in store.list_objects(cid)] \
            if store.collection_exists(cid) else []
        if not to_add or not oids:
            self._request_pg_temp([])
            return
        if not self.op_lock.acquire(blocking=False):
            return                       # a write holds the PG; retry
        try:
            self._realigning = True
            self._realign_started = self.osd.now
            start_head = self.pg_log.head
            pending: Set[int] = set()
            state = {"armed": False}

            def on_ack(tid: int) -> None:
                pending.discard(tid)
                if state["armed"] and not pending:
                    self._realigning = False
                    self._rep_realign_ack = None
                    if self.pg_log.head == start_head:
                        self._request_pg_temp([])
            self._rep_realign_ack = on_ack
            from ..msg.messages import MOSDECSubOpWrite
            for oid in sorted(oids):
                exists, data, uattrs, omap = be.object_state(oid)
                ho = hobject_t(oid)
                vb = store.getattrs(cid, ho).get(VERSION_ATTR)
                ver = struct.unpack("<Q", vb)[0] if vb else 0
                ss = self.snapsets.get(oid)
                ssu = (oid, encode_snapset(ss)) if ss else None
                for tgt in to_add:
                    tid = self.osd.next_pull_tid()
                    pending.add(tid)
                    self.send_to_osd(tgt, MOSDECSubOpWrite(
                        tid=tid, pgid=self.pgid, shard=-1, oid=oid,
                        chunk=data, offset=0, partial=False,
                        at_version=len(data), version=ver,
                        is_push=True, xattrs=uattrs or None,
                        omap=omap or None, snapset_update=ssu))
            dlog("pg", 3, f"pg {self.pgid} replicated realign: pushed "
                 f"{len(oids)} objects to {to_add}",
                 f"osd.{self.osd.osd_id}")
            state["armed"] = True
            if not pending:              # acks raced the sends
                on_ack(-1)
        finally:
            self.op_lock.release()

    def handle_pg_info(self, msg: MOSDPGInfo) -> None:
        if not self.is_primary():
            self._apply_activation(msg)
            return
        if msg.epoch != getattr(self, "peering_epoch", msg.epoch):
            return  # reply from a superseded peering round
        if self._getlog_pending is not None and \
                msg.shard == self._getlog_pending:
            if msg.log_entries:
                self._merge_auth_log(msg)
            else:
                # authority's log is trimmed past our head: our log can't
                # catch up — adopt the authoritative head and backfill
                # ourselves from the authority's listing
                self._adopt_head_and_self_backfill(msg)
            return
        if self.state != STATE_PEERING:
            return
        if msg.shard not in self._peer_pending:
            # duplicate info (the tick's query resend raced the
            # original reply): refresh the record but never re-enter
            # _peering_all_infos — the round already advanced past
            # this shard (a GetLog may be outstanding)
            self._peer_infos[msg.shard] = msg
            return
        if self._rewind_horizon is not None and \
                msg.last_update > self._rewind_horizon:
            # the shard is being asked to rewind to the horizon, so the
            # reply that settles it must show last_update <= horizon; a
            # head beyond it is a late duplicate of the PRE-rewind info
            # (the retry resend raced the original reply) — consuming
            # it would activate on entries the shard just rolled back
            return
        self._peer_infos[msg.shard] = msg
        self._peer_pending.discard(msg.shard)
        if not self._peer_pending:
            self._peering_all_infos()

    def _rewind_divergent(self, to: int, shard: int) -> None:
        """Rewind this replica's log past *to* and roll every touched
        object back to its stashed pre-write state (the
        rewind_divergent_log + rollback step of src/osd/PGLog.cc
        merge_log, using the append-only/rollback design of
        doc/dev/osd_internals/erasure_coding/ecbackend.rst:1-27).
        *shard* is the acting position the requesting primary holds us
        at.  Objects whose stash can't reach *to* are only destroyed if
        their on-disk version actually sits past the horizon; otherwise
        the (valid, old) local chunk is kept and at most re-reported
        missing so recovery can top it up."""
        if self.backend is None or self.pg_log.head <= to:
            return
        from .pg_log import clear_rollback, load_rollback
        store = self.osd.store
        t = Transaction()
        cid = self.meta_cid()
        if not store.collection_exists(cid):
            t.create_collection(cid)
        dropped = self.pg_log.rewind_to(to, t, cid)
        dlog("pg", 3,
             f"pg {self.pgid} rewinding {len(dropped)} divergent "
             f"entries to v{to}", f"osd.{self.osd.osd_id}")
        scid = self.backend.shard_cid(shard)
        handled: Set[str] = set()
        for e in sorted(dropped, key=lambda e: e.version, reverse=True):
            if e.oid in handled:
                continue
            handled.add(e.oid)
            ho = hobject_t(e.oid, shard)
            have = (store.collection_exists(scid)
                    and store.exists(scid, ho))
            cur_v = 0
            if have:
                try:
                    cur_v = struct.unpack(
                        "<Q", store.getattr(scid, ho, VERSION_ATTR))[0]
                except KeyError:
                    pass
            stash = load_rollback(store, cid, e.oid)
            restorable = (stash is not None and stash[0] == e.version)
            if restorable and stash[1]:
                # the stash's own version must sit at/below the horizon,
                # else it is the residue of an EARLIER divergent write
                # and restoring it would still leave torn state
                pv = stash[3].get(VERSION_ATTR)
                if pv is not None and \
                        struct.unpack("<Q", pv)[0] > to:
                    restorable = False
            if restorable:
                _v, prev_exists, data, attrs = stash
                if prev_exists:
                    if not store.collection_exists(scid):
                        t.create_collection(scid)
                    t.touch(scid, ho)
                    t.truncate(scid, ho, 0)
                    if data:
                        t.write(scid, ho, 0, data)
                    cur = store.getattrs(scid, ho) if have else {}
                    for k in cur:
                        if k not in attrs:
                            t.rmattr(scid, ho, k)
                    for k, v in attrs.items():
                        t.setattr(scid, ho, k, v)
                elif have:
                    t.remove(scid, ho)
                clear_rollback(t, cid, e.oid)
                self.local_missing.pop(e.oid, None)
            elif have and cur_v <= to:
                # the divergent entry was merged into our log without
                # its data ever landing here (activation): the local
                # chunk predates the horizon and stays valid — keep it
                if stash is not None:
                    clear_rollback(t, cid, e.oid)
                if cur_v < to:
                    self.local_missing[e.oid] = (to, OP_MODIFY)
                else:
                    self.local_missing.pop(e.oid, None)
            else:
                # torn local write with no usable stash: drop the copy
                # and report it missing so recovery rebuilds by decode
                dlog("pg", 1,
                     f"pg {self.pgid} no rollback stash for {e.oid}"
                     f"@v{e.version}; marking missing",
                     f"osd.{self.osd.osd_id}")
                if have:
                    t.remove(scid, ho)
                if stash is not None:
                    clear_rollback(t, cid, e.oid)
                self.local_missing[e.oid] = (to, OP_MODIFY)
        store.queue_transaction(t)

    def _maybe_rewind_divergent(self) -> bool:
        """EC interrupted-write consistency: a log entry is recoverable
        only if at least k shards hold its data, so the roll-forward
        horizon is the k-th highest last_update among data-bearing
        acting shards.  Entries past the horizon were partial fan-outs
        the client never saw acked — tell every shard carrying them to
        roll back before the logs merge.  Returns True when rewind
        queries went out (peering resumes on their fresh infos)."""
        if self.backend is None or self._rewind_requested:
            return False
        # only LOG-bearing data shards vote: a backfilled/pushed shard
        # holds chunks but no history (last_update 0, like a reference
        # backfill target) — counting it would drag the horizon to 0
        # and destroy healthy peers' state
        lus = sorted((info.last_update
                      for shard, info in self._peer_infos.items()
                      if shard in info.held_shards
                      and info.last_update > 0),
                     reverse=True)
        k = self.backend.k
        if len(lus) < k:
            # fewer than k data-bearing shards: nothing is decodable
            # at ANY version — rolling back could only destroy state
            return False
        horizon = lus[k - 1]
        divergent = [shard for shard, info in self._peer_infos.items()
                     if info.last_update > horizon]
        if not divergent:
            return False
        self._rewind_requested = True
        self._rewind_horizon = horizon
        for shard in divergent:
            self._peer_pending.add(shard)
            self._send_peering_query(shard, MOSDPGQuery(
                pgid=self.pgid, shard=shard, epoch=self.peering_epoch,
                rewind_to=horizon))
        return True

    def _peering_all_infos(self) -> None:
        if self._choose_acting():
            # a pg_temp pin is on its way; the next epoch re-peers with
            # the data-aligned acting set
            return
        if self._maybe_rewind_divergent():
            # divergent shards report fresh infos after rewinding
            return
        infos = self._peer_infos
        auth_shard, auth_lu = None, self.pg_log.head
        for shard, info in infos.items():
            if info.last_update > auth_lu:
                auth_shard, auth_lu = shard, info.last_update
        if auth_shard is not None:
            # GetLog: pull the authoritative suffix before activating
            self._getlog_pending = auth_shard
            self._send_peering_query(auth_shard, MOSDPGQuery(
                pgid=self.pgid, shard=auth_shard,
                epoch=self.last_epoch_started,
                log_since=self.pg_log.head))
            return
        self._activate()

    def _merge_auth_log(self, msg: MOSDPGInfo) -> None:
        entries = [LogEntry.decode(b) for b in msg.log_entries]
        my_old_head = self.pg_log.head
        t = Transaction()
        cid = self.meta_cid()
        if not self.osd.store.collection_exists(cid):
            t.create_collection(cid)
        self.pg_log.merge_authoritative(entries, t, cid)
        self.osd.store.queue_transaction(t)
        self._version_alloc = max(self._version_alloc, self.pg_log.head)
        # everything merged is missing on our own shard
        mine = self.missing.setdefault(self.my_shard(), {})
        for e in entries:
            if e.version > my_old_head:
                mine[e.oid] = (e.version, e.op)
                if e.op != OP_DELETE:
                    self.local_missing[e.oid] = (e.version, e.op)
        self._getlog_pending = None
        self._activate()

    def _adopt_head_and_self_backfill(self, msg: MOSDPGInfo) -> None:
        """Primary beyond the authority's log tail: no entry replay is
        possible.  Adopt the authoritative head (so versions stay
        monotonic) and diff our store against the authority's listing."""
        import struct as _s
        from .pg_log import LAST_UPDATE_ATTR, LOG_TAIL_ATTR, PG_META_OID
        self.pg_log.head = max(self.pg_log.head, msg.last_update)
        self.pg_log.tail = self.pg_log.head
        self.pg_log.entries = []
        t = Transaction()
        cid = self.meta_cid()
        if not self.osd.store.collection_exists(cid):
            t.create_collection(cid)
        meta = hobject_t(PG_META_OID)
        t.touch(cid, meta)
        t.setattr(cid, meta, LAST_UPDATE_ATTR,
                  _s.pack("<Q", self.pg_log.head))
        t.setattr(cid, meta, LOG_TAIL_ATTR, _s.pack("<Q", self.pg_log.tail))
        self.osd.store.queue_transaction(t)
        self._version_alloc = max(self._version_alloc, self.pg_log.head)
        auth = self._getlog_pending
        self._getlog_pending = None
        self._self_backfill_from = auth
        self.send_to_osd(self.acting_shards()[auth], MOSDPGScan(
            pgid=self.pgid, shard=auth, epoch=self.peering_epoch))
        self._activate()

    def _activate(self) -> None:
        """GetMissing + Activate: compute per-shard deltas from the
        (now authoritative) log plus each replica's own reported missing
        set; ship peers the suffix they lack."""
        my_shard = self.my_shard()
        for info in self._peer_infos.values():
            self.merge_snapsets(info.snapsets)
            self._adopt_purged(info.purged_snaps)
        for oid, (v, op) in self.local_missing.items():
            self.missing.setdefault(my_shard, {}).setdefault(oid, (v, op))
        for shard, info in self._peer_infos.items():
            self.peer_last_update[shard] = info.last_update
            if shard == my_shard:
                continue
            if self.backend is not None and \
                    shard not in info.held_shards and \
                    self.pg_log.head > 0:
                # the osd's log may be current (it held ANOTHER shard of
                # this pg before the remap) but it has no data for THIS
                # position: only a listing diff finds the debt
                self._backfill_pending.add(shard)
                self.send_to_osd(self.acting_shards()[shard], MOSDPGScan(
                    pgid=self.pgid, shard=shard,
                    epoch=self.peering_epoch))
                continue
            delta = self.pg_log.missing_after(info.last_update)
            if delta is None:
                # peer is beyond the log tail: backfill via listing diff
                self._backfill_pending.add(shard)
                self.send_to_osd(self.acting_shards()[shard], MOSDPGScan(
                    pgid=self.pgid, shard=shard,
                    epoch=self.peering_epoch))
            elif delta:
                self.missing[shard] = dict(delta)
            # plus whatever the replica itself knows it never received
            for oid, v in info.missing_oids:
                self.missing.setdefault(shard, {}).setdefault(
                    oid, (v, OP_MODIFY))
            # activation: ship the log suffix the peer lacks
            suffix = self.pg_log.entries_after(info.last_update) or []
            self.send_to_osd(self.acting_shards()[shard], MOSDPGInfo(
                pgid=self.pgid, shard=shard,
                epoch=self.peering_epoch,
                last_update=self.pg_log.head,
                log_tail=self.pg_log.tail,
                log_entries=[e.encode() for e in suffix],
                snapsets=self._encoded_snapsets(),
                purged_snaps=sorted(self.purged_snaps)))
        self.state = STATE_ACTIVE_RECOVERING if self._has_missing() \
            else STATE_ACTIVE
        if self.state == STATE_ACTIVE_RECOVERING or self._backfill_pending:
            self.osd.request_recovery(self)
        # a predecessor may have died between the snap-removal epoch and
        # its trim pass: removed_snaps - (unioned) purged_snaps is the
        # outstanding debt, and we are now the one who owes it
        self._maybe_trim_snaps()

    def send_backfill_complete(self, shard: int) -> None:
        """Primary: this shard now holds every object we tracked —
        ship our log wholesale so its info stops reading as
        missing-everything (the reference's last_backfill == MAX info
        update at backfill completion)."""
        osd = self.acting_shards().get(shard)
        if osd is None or osd == self.osd.osd_id:
            return
        self.send_to_osd(osd, MOSDPGInfo(
            pgid=self.pgid, shard=shard,
            epoch=self.last_epoch_started,
            last_update=self.pg_log.head, log_tail=self.pg_log.tail,
            log_entries=[e.encode() for e in self.pg_log.entries],
            snapsets=self._encoded_snapsets(),
            purged_snaps=sorted(self.purged_snaps), adopt_log=True))

    def _adopt_full_log(self, msg: MOSDPGInfo) -> None:
        """Backfill target: adopt the primary's log window (entries +
        head + tail) — our data is complete, our history was not."""
        from .pg_log import LAST_UPDATE_ATTR, LOG_TAIL_ATTR
        self.merge_snapsets(msg.snapsets)
        t = Transaction()
        cid = self.ensure_meta_collection(t)
        meta = hobject_t(PG_META_OID)
        t.touch(cid, meta)
        entries = sorted((LogEntry.decode(b) for b in msg.log_entries),
                         key=lambda e: e.version)
        for e in entries:
            t.omap_setkeys(cid, meta,
                           {PGLog._key(e.version): e.encode()})
        t.setattr(cid, meta, LAST_UPDATE_ATTR,
                  struct.pack("<Q", msg.last_update))
        t.setattr(cid, meta, LOG_TAIL_ATTR,
                  struct.pack("<Q", msg.log_tail))
        self.osd.store.queue_transaction(t)
        self.pg_log.entries = entries
        self.pg_log.head = max(self.pg_log.head, msg.last_update)
        self.pg_log.tail = max(self.pg_log.tail, msg.log_tail)
        self._version_alloc = max(self._version_alloc, self.pg_log.head)
        dlog("pg", 4, f"pg {self.pgid} adopted log to "
             f"v{self.pg_log.head} (backfill complete)",
             f"osd.{self.osd.osd_id}")

    def _apply_activation(self, msg: MOSDPGInfo) -> None:
        """Replica side: adopt the authoritative log suffix.  Modify
        entries whose data has not arrived are recorded in local_missing
        (the head advances, the data debt does not vanish — pg_missing_t);
        delete entries apply immediately (reference merge_log)."""
        self._adopt_purged(msg.purged_snaps)
        if msg.adopt_log:
            self._adopt_full_log(msg)
            return
        self.merge_snapsets(msg.snapsets)
        entries = [LogEntry.decode(b) for b in msg.log_entries]
        if not entries:
            return
        my_old_head = self.pg_log.head
        t = Transaction()
        cid = self.meta_cid()
        if not self.osd.store.collection_exists(cid):
            t.create_collection(cid)
        self.pg_log.merge_authoritative(entries, t, cid)
        latest: Dict[str, Tuple[int, str]] = {}
        for e in entries:
            if e.version > my_old_head:
                latest[e.oid] = (e.version, e.op)
        snap = self._object_versions_snapshot() if latest else {}
        for oid, (v, op) in latest.items():
            if op == OP_DELETE:
                self.local_missing.pop(oid, None)
                self._stage_local_delete(oid, t)
            elif snap.get(oid, -1) < v:
                # absent OR present at an older version: data debt
                self.local_missing[oid] = (v, op)
        self.osd.store.queue_transaction(t)

    def _stage_local_delete(self, oid: str, t: Transaction) -> None:
        store = self.osd.store
        if self.backend is not None:
            prefix = f"{self.pgid[0]}.{self.pgid[1]}s"
            for cid in store.list_collections():
                if cid.startswith(prefix):
                    for ho in store.list_objects(cid):
                        if ho.oid == oid:
                            t.remove(cid, ho)
        else:
            cid = f"{self.pgid[0]}.{self.pgid[1]}"
            if store.collection_exists(cid) and \
                    store.exists(cid, hobject_t(oid)):
                t.remove(cid, hobject_t(oid))

    def handle_pg_scan(self, msg: MOSDPGScan) -> None:
        """Backfill scan: list (oid, version) on this replica's shard —
        the version attr lets the primary spot present-but-stale copies."""
        from .pg_log import VERSION_ATTR
        store = self.osd.store
        objects: List[Tuple[str, int]] = []
        cid = self._data_cid()
        if cid and store.collection_exists(cid):
            for ho in store.list_objects(cid):
                if ho.oid == PG_META_OID:
                    continue
                try:
                    v = struct.unpack(
                        "<Q", store.getattr(cid, ho, VERSION_ATTR))[0]
                except KeyError:
                    v = 0
                objects.append((ho.oid, v))
        self.osd.messenger.send_message(MOSDPGScanReply(
            pgid=self.pgid, shard=msg.shard, epoch=msg.epoch,
            objects=objects), msg.src)

    def _data_cid(self) -> Optional[str]:
        if self.backend is not None:
            s = self.my_shard()
            return self.backend.shard_cid(s) if s >= 0 else None
        return self.rep_backend.cid()

    def handle_pg_scan_reply(self, msg: MOSDPGScanReply) -> None:
        if not self.is_primary():
            return
        if msg.epoch != getattr(self, "peering_epoch", msg.epoch):
            return  # stale round
        if msg.shard == self._self_backfill_from:
            # our own backfill: whatever the authority lists at a newer
            # version than our copy is missing on us; our extras were
            # deleted while we were out
            self._self_backfill_from = None
            my = self.my_shard()
            auth_objects = {o: v for o, v in msg.objects}
            for oid, v in auth_objects.items():
                if not self._have_version(oid, v):
                    vv = max(v, 1)
                    self.local_missing[oid] = (vv, OP_MODIFY)
                    self.missing.setdefault(my, {}).setdefault(
                        oid, (vv, OP_MODIFY))
            mine = self._authoritative_objects()
            t = Transaction()
            for oid in set(mine) - set(auth_objects):
                self._stage_local_delete(oid, t)
            if not t.empty():
                self.osd.store.queue_transaction(t)
            if self._has_missing():
                self.state = STATE_ACTIVE_RECOVERING
                self.osd.request_recovery(self)
            return
        self._backfill_pending.discard(msg.shard)
        peer_objects = {o: v for o, v in msg.objects}
        auth = self._authoritative_objects()
        delta: Dict[str, Tuple[int, str]] = {}
        for oid, version in auth.items():
            # absent OR present at an older version than the authority
            if peer_objects.get(oid, -1) < version:
                delta[oid] = (max(version, 1), OP_MODIFY)
        for oid in set(peer_objects) - set(auth):
            delta[oid] = (self.pg_log.head, OP_DELETE)
        if delta:
            self.missing.setdefault(msg.shard, {}).update(delta)
            self.state = STATE_ACTIVE_RECOVERING
            self.osd.request_recovery(self)
        elif not self._has_missing() and not self._backfill_pending:
            self.state = STATE_ACTIVE

    def _authoritative_objects(self) -> Dict[str, int]:
        """oid -> version for every live object (primary's own store is
        authoritative once self-recovery has drained)."""
        from .pg_log import VERSION_ATTR
        store = self.osd.store
        out: Dict[str, int] = {}
        cid = self._data_cid()
        if cid and store.collection_exists(cid):
            for ho in store.list_objects(cid):
                if ho.oid == PG_META_OID:
                    continue
                try:
                    v = struct.unpack(
                        "<Q", store.getattr(cid, ho, VERSION_ATTR))[0]
                except KeyError:
                    v = 0
                out[ho.oid] = v
        # objects newer than the store view (log wins)
        for e in self.pg_log.entries:
            if e.op == OP_DELETE:
                out.pop(e.oid, None)
            else:
                out[e.oid] = max(out.get(e.oid, 0), e.version)
        return out

    # ---- scrub (PG.cc scrub path + ECUtil HashInfo, scrub-lite) ------------
    def start_scrub(self, deep: bool = False) -> bool:
        """Primary: collect scrub maps from every acting shard; compare
        when all arrive.  Background consistency checking — no client
        read involved (ScrubStore/PG scrub role).  Shallow scrubs
        compare metadata only (sizes + attr/omap digests, no object
        data is read); deep scrubs additionally checksum every byte —
        the reference's scrub vs deep-scrub split (PG::Scrubber::deep,
        src/osd/PG.cc chunky_scrub).  Returns whether a scrub round
        actually started (a peering/non-primary PG declines)."""
        if not self.is_primary() or self.state not in (
                STATE_ACTIVE, STATE_ACTIVE_RECOVERING):
            return False
        self.last_scrub_stamp = self.osd.now
        if deep:
            self.last_deep_scrub_stamp = self.osd.now
        dlog("scrub", 5,
             f"pg {self.pgid} {'deep-' if deep else ''}scrub start",
             f"osd.{self.osd.osd_id}")
        self._scrub_maps: Dict[int, MOSDRepScrubMap] = {}
        self._scrub_pending = set(self.acting_shards())
        self._scrub_deep = deep
        for shard, osd in self.acting_shards().items():
            self.send_to_osd(osd, MOSDRepScrub(
                pgid=self.pgid, shard=shard,
                epoch=self.last_epoch_started, deep=deep))
        return True

    def handle_rep_scrub(self, msg: MOSDRepScrub) -> None:
        """Replica: build this shard's scrub map.  Always: stored size
        plus attr/omap digests (metadata is cheap).  Deep only: read
        the data and checksum it, verifying against HashInfo
        (handle_sub_read's check, proactively).  Shallow still catches
        a shard whose stored size disagrees with its HashInfo total."""
        from ..utils.crc32c import crc32c
        from .ec_backend import DIGEST_ATTR, HINFO_ATTR
        store = self.osd.store
        objects: List[tuple] = []
        if self.backend is not None:
            s = self.my_shard()
            cids = [self.backend.shard_cid(s)] if s >= 0 else []
        else:
            cids = [f"{self.pgid[0]}.{self.pgid[1]}"]
        for cid in cids:
            if not store.collection_exists(cid):
                continue
            for ho in store.list_objects(cid):
                if ho.oid == PG_META_OID:
                    continue
                attrs = store.getattrs(cid, ho)
                # pack_kv's length-prefixed framing (values are
                # struct-packed binary, so separator framing would let
                # different k/v sets hash identically).  Integrity
                # metadata is excluded: per-shard hinfo differs by
                # construction, and the recorded data digest can
                # legitimately exist on a recovery-pushed copy while
                # its peers (post-partial-write) have none
                attrs_dg = crc32c(pack_kv(dict(
                    (k, v) for k, v in sorted(attrs.items())
                    if k not in (HINFO_ATTR, DIGEST_ATTR))))
                omap_dg = crc32c(pack_kv(dict(
                    sorted(store.omap_get(cid, ho).items()))))
                hv = attrs.get(HINFO_ATTR) \
                    if self.backend is not None else None
                validated = False
                if msg.deep:
                    data = store.read(cid, ho)
                    size = len(data)
                    digest = crc32c(data)
                    ok = True
                    if hv is not None:
                        total, expect = struct.unpack("<QI", hv)
                        ok = not (total == size and digest != expect)
                        validated = ok and total == size
                    elif self.backend is None:
                        # replicated: verify against the write-time
                        # recorded digest (object_info data_digest) —
                        # a self-inconsistent copy is known-bad on its
                        # own and gets no vote in _scrub_compare, even
                        # if identical rot hit a majority of copies
                        rec = attrs.get(DIGEST_ATTR)
                        if rec is not None and len(rec) == 4:
                            ok = struct.unpack("<I", rec)[0] == digest
                            validated = ok
                else:
                    size = store.stat(cid, ho)
                    digest = -1
                    ok = True
                    if hv is not None:
                        total, _expect = struct.unpack("<QI", hv)
                        ok = (total == size)
                objects.append((ho.oid, size, ok, digest,
                                attrs_dg, omap_dg, validated))
        self.osd.messenger.send_message(MOSDRepScrubMap(
            pgid=self.pgid, shard=msg.shard, epoch=msg.epoch,
            objects=objects, deep=msg.deep), msg.src)

    def handle_rep_scrub_map(self, msg: MOSDRepScrubMap) -> None:
        if not self.is_primary() or \
                not hasattr(self, "_scrub_pending"):
            return
        if msg.deep != getattr(self, "_scrub_deep", False) or \
                msg.epoch != self.last_epoch_started:
            # stale reply from a superseded scrub round (e.g. a shallow
            # map resent over a healed link after a deep round started):
            # its digests don't mean what this round's comparison needs
            return
        self._scrub_maps[msg.shard] = msg
        self._scrub_pending.discard(msg.shard)
        if self._scrub_pending:
            return
        self._scrub_compare()

    def _scrub_compare(self) -> None:
        """Compare shard scrub maps; inconsistent/absent copies become
        missing entries and the recovery machinery repairs them by
        decode/push (repair = recovery, like the reference).

        What compares depends on depth: metadata (replicated size,
        attr/omap digests) on every scrub; data digests only when the
        maps were built deep (shallow maps carry no data digest)."""
        maps = self._scrub_maps
        deep = getattr(self, "_scrub_deep", False)
        del self._scrub_maps, self._scrub_pending
        my_shard = self.my_shard()
        auth = self._authoritative_objects()
        by_shard: Dict[int, Dict[str, tuple]] = {
            s: {o: (sz, ok, dg, adg, odg, val)
                for o, sz, ok, dg, adg, odg, val in m.objects}
            for s, m in maps.items()}
        from collections import Counter
        found = 0
        shard_order = sorted(self.acting_shards(),
                             key=lambda s: (s != my_shard, s))

        def data_identity(e):
            return (e[0], e[2] if deep else None)

        def meta_identity(e):
            return (e[3], e[4])

        for oid, version in auth.items():
            ents = {s: by_shard.get(s, {}).get(oid)
                    for s in self.acting_shards()}
            # Authority selection (be_select_auth_object role), split
            # by what the write-time digest actually protects:
            #
            # DATA (size + data digest), precedence order: (1) majority
            # among DIGEST-VALIDATED copies — their bytes provably
            # match their recorded digest, so even identical rot on a
            # majority can't outvote them; (2) no validated copy
            # (partial-write history wiped the digests): the primary's
            # self-consistent copy — plain majority there would let
            # identical rot on two replicas overwrite a healthy
            # primary; (3) majority among self-consistent copies
            # (primary absent/bad).  Ties break toward the primary
            # (my_shard votes first in shard_order).
            #
            # METADATA (attr/omap digests): no recorded digest guards
            # it, so data-validation must not lend false authority —
            # the primary's self-consistent copy rules (the pre-digest
            # semantics), majority only when the primary can't vote.
            mine = ents.get(my_shard)
            if self.rep_backend is not None:
                val = [data_identity(ents[s]) for s in shard_order
                       if ents[s] is not None and ents[s][1]
                       and ents[s][5]]
                if val:
                    data_win = Counter(val).most_common(1)[0][0]
                elif mine is not None and mine[1]:
                    data_win = data_identity(mine)
                else:
                    votes = [data_identity(ents[s]) for s in shard_order
                             if ents[s] is not None and ents[s][1]]
                    data_win = Counter(votes).most_common(1)[0][0] \
                        if votes else None
            else:
                data_win = None     # EC chunks differ by construction
            if mine is not None and mine[1]:
                meta_win = meta_identity(mine) \
                    if self.rep_backend is not None else mine[3]
            else:
                if self.rep_backend is not None:
                    mvotes = [meta_identity(ents[s]) for s in shard_order
                              if ents[s] is not None and ents[s][1]]
                else:
                    mvotes = [ents[s][3] for s in shard_order
                              if ents[s] is not None and ents[s][1]]
                meta_win = Counter(mvotes).most_common(1)[0][0] \
                    if mvotes else None
            for shard in self.acting_shards():
                ent = ents[shard]
                bad = ent is None or not ent[1]
                if not bad and data_win is not None:
                    bad = data_identity(ent) != data_win
                if not bad and meta_win is not None:
                    if self.rep_backend is not None:
                        bad = meta_identity(ent) != meta_win
                    else:
                        bad = ent[3] != meta_win
                if bad:
                    v = version or self.pg_log.head
                    self.missing.setdefault(shard, {})[oid] = \
                        (v, OP_MODIFY)
                    if shard == my_shard:
                        self.local_missing[oid] = (v, OP_MODIFY)
                    found += 1       # this scrub's findings only —
                    # pre-existing missing entries are recovery debt,
                    # not scrub results
        if found:
            noun = "copy" if found == 1 else "copies"
            self.osd.clog(
                "ERR", f"pg {self.pgid[0]}.{self.pgid[1]} "
                f"{'deep-' if deep else ''}scrub: {found} inconsistent "
                f"object {noun}, repairing")
            self.state = STATE_ACTIVE_RECOVERING
            self.osd.request_recovery(self)

    # ---- degraded-object tracking -----------------------------------------
    def _has_missing(self) -> bool:
        return any(self.missing.values())

    def missing_shards_for(self, oid: str) -> Set[int]:
        return {s for s, mm in self.missing.items() if oid in mm}

    def clear_missing_for(self, oid: str) -> None:
        """A full-object write/delete rewrote every acting shard."""
        for mm in self.missing.values():
            mm.pop(oid, None)
        self._maybe_clean()

    def _maybe_clean(self) -> None:
        if self.state == STATE_ACTIVE_RECOVERING and \
                not self._has_missing() and not self._backfill_pending:
            self.state = STATE_ACTIVE

    # ---- op execution (PrimaryLogPG::do_op analog) ------------------------
    def do_op(self, msg: MOSDOp) -> None:
        if getattr(self, "_realigning", False):
            # shard copies are in flight; EAGAIN makes the client
            # resend after the realign epoch lands
            self.osd.send_op_reply(msg.src, MOSDOpReply(
                tid=msg.tid, result=-11, epoch=self.osd.osdmap.epoch))
            return
        if not self.is_primary() or self.state not in (
                STATE_ACTIVE, STATE_ACTIVE_RECOVERING):
            self.osd.send_op_reply(msg.src, MOSDOpReply(
                tid=msg.tid, result=-11,  # EAGAIN: wrong primary / not ready
                epoch=self.osd.osdmap.epoch))
            return
        from ..msg.messages import CEPH_OSD_OP_PGLS as _PGLS
        if msg.op == _PGLS and not msg.ops:
            # pg-targeted op: no object to misdirect-check
            self._do_pgls(msg)
            return
        cur_pool = self.osd.osdmap.pools.get(self.pgid[0])
        if cur_pool is not None:
            actual = cur_pool.raw_pg_to_pg(
                self.osd.osdmap.map_to_pg(self.pgid[0], msg.oid))
            if actual.ps != self.pgid[1]:
                # misdirected: the client targeted us from a pre-split
                # map (PrimaryLogPG::do_op "wrong node" handling) —
                # EAGAIN makes it refresh the map and resend to the
                # child PG
                self.osd.send_op_reply(msg.src, MOSDOpReply(
                    tid=msg.tid, result=-11,
                    epoch=self.osd.osdmap.epoch))
                return
        from ..msg.messages import (
            CEPH_OSD_OP_NOTIFY, CEPH_OSD_OP_UNWATCH, CEPH_OSD_OP_WATCH,
        )
        # min_size gate (PG::get_min_peer_features / is_degraded_below):
        # mutations need at least min_size live acting members, or a
        # single further failure could lose acked data — clients retry
        # until recovery/remap restores enough copies
        is_write = (any(self._op_mutates(o) for o in msg.ops)
                    if msg.ops else
                    msg.op in (CEPH_OSD_OP_WRITE, CEPH_OSD_OP_WRITEFULL,
                               CEPH_OSD_OP_APPEND, CEPH_OSD_OP_DELETE))
        if is_write:
            alive = sum(1 for o in self.acting if o != CRUSH_ITEM_NONE)
            if alive < self.pool.min_size:
                dlog("pg", 5, f"pg {self.pgid} write blocked: "
                     f"{alive} acting < min_size {self.pool.min_size}",
                     f"osd.{self.osd.osd_id}")
                self.osd.send_op_reply(msg.src, MOSDOpReply(
                    tid=msg.tid, result=-11,
                    epoch=self.osd.osdmap.epoch))
                return
            # full gate (PrimaryLogPG.cc:7832-7842 check_full /
            # osd_is_full): a FULL pool or cluster refuses mutations —
            # EDQUOT when quota-driven, ENOSPC otherwise.  Deletes pass
            # so users can free space (the reference's may-free-space
            # carve-out).
            deletes_only = (
                all(o.op == CEPH_OSD_OP_DELETE for o in msg.ops)
                if msg.ops else msg.op == CEPH_OSD_OP_DELETE)
            if not deletes_only:
                from ..osdmap.osdmap import CEPH_OSDMAP_FULL
                from ..osdmap.types import FLAG_FULL, FLAG_FULL_QUOTA
                if self.pool.has_flag(FLAG_FULL) or \
                        (self.osd.osdmap.flags & CEPH_OSDMAP_FULL):
                    res = -122 if self.pool.has_flag(FLAG_FULL_QUOTA) \
                        else -28
                    self.osd.send_op_reply(msg.src, MOSDOpReply(
                        tid=msg.tid, result=res,
                        epoch=self.osd.osdmap.epoch))
                    return
        if msg.op == CEPH_OSD_OP_WATCH and not msg.ops:
            self._do_watch(msg)
            return
        elif msg.op == CEPH_OSD_OP_UNWATCH and not msg.ops:
            self._do_unwatch(msg)
            return
        elif msg.op == CEPH_OSD_OP_NOTIFY and not msg.ops:
            self._do_notify(msg)
            return
        # a client SnapContext is only meaningful on selfmanaged-snap
        # pools; honoring one on a pool-snapshot pool would replace the
        # pool snapc and corrupt its snapshots (the reference rejects
        # this with EINVAL, PrimaryLogPG do_op snapc checks)
        if getattr(msg, "snapc_seq", 0) > 0 and not self.pool.selfmanaged:
            self.osd.send_op_reply(msg.src, MOSDOpReply(
                tid=msg.tid, result=-22, epoch=self.osd.osdmap.epoch))
            return
        # FLAG_EC_OVERWRITES gate — BEFORE any clone/side effect, and
        # covering both message shapes (a partial update is a partial
        # update whether it rides a single op or a vector)
        if self.backend is not None and \
                not self.pool.allows_ecoverwrites() and \
                self._is_partial_update(msg):
            self.osd.send_op_reply(msg.src, MOSDOpReply(
                tid=msg.tid, result=-95, epoch=self.osd.osdmap.epoch))
            return
        if self.tier is not None and self.tier.intercept(msg):
            return      # parked behind a promote; re-dispatched after
        if msg.ops and any(o.op == CEPH_OSD_OP_COPY_FROM
                           for o in msg.ops):
            # async source fetch: cannot run inside the synchronous
            # vector interpreter (PrimaryLogPG starts a CopyOp the
            # same way, do_copy_from)
            if len(msg.ops) != 1:
                self.osd.send_op_reply(msg.src, MOSDOpReply(
                    tid=msg.tid, result=-95,
                    epoch=self.osd.osdmap.epoch))
                return
            self.with_clone(msg.oid, lambda: self._do_copy_from(msg),
                            snapc=self._msg_snapc(msg))
            return
        if msg.ops:
            self._do_op_vector(msg)
        elif msg.op == CEPH_OSD_OP_WRITEFULL:
            self.with_clone(msg.oid, lambda: self._do_write(msg),
                            snapc=self._msg_snapc(msg))
        elif msg.op in (CEPH_OSD_OP_WRITE, CEPH_OSD_OP_APPEND):
            self.with_clone(msg.oid,
                            lambda: self._do_partial_write(msg),
                            snapc=self._msg_snapc(msg))
        elif msg.op == CEPH_OSD_OP_READ:
            self._do_read(msg)
        elif msg.op == CEPH_OSD_OP_STAT:
            self._do_stat(msg)
        elif msg.op == CEPH_OSD_OP_DELETE:
            self.with_clone(msg.oid, lambda: self._do_delete(msg),
                            snapc=self._msg_snapc(msg))
        else:
            self.osd.send_op_reply(msg.src,
                                   MOSDOpReply(tid=msg.tid, result=-95))

    # ---- watch / notify (Watch.cc + do_osd_op_effects, scoped) -------------
    def _do_watch(self, msg: MOSDOp) -> None:
        """Register (client, cookie) as a watcher of the object; the
        cookie rides msg.offset (librados rados_watch)."""
        self.watchers.setdefault(msg.oid, {})[(msg.src, msg.offset)] = \
            self.osd.now
        dlog("osd", 10, f"watch {msg.oid} by {msg.src} "
             f"cookie {msg.offset}", f"osd.{self.osd.osd_id}")
        self.osd.send_op_reply(msg.src, MOSDOpReply(
            tid=msg.tid, result=0, epoch=self.osd.osdmap.epoch))

    def _do_unwatch(self, msg: MOSDOp) -> None:
        ws = self.watchers.get(msg.oid, {})
        ws.pop((msg.src, msg.offset), None)
        self.osd.send_op_reply(msg.src, MOSDOpReply(
            tid=msg.tid, result=0, epoch=self.osd.osdmap.epoch))

    def _do_notify(self, msg: MOSDOp) -> None:
        """Broadcast to every live watcher; complete the notifier when
        all acks arrive (or the timeout sweep gives up on the dead)."""
        from ..msg.messages import MWatchNotify
        self._notify_seq += 1
        nid = self._notify_seq
        live = {}
        down = self.osd.network.down
        for (client, cookie), since in self.watchers.get(msg.oid,
                                                         {}).items():
            if client not in down and client != msg.src:
                live[(client, cookie)] = since
            elif client == msg.src:
                # the notifier's own watch acks implicitly (librados
                # does not deliver a notify to its own handle)
                pass
        st = {"src": msg.src, "tid": msg.tid, "oid": msg.oid,
              "pending": set(live), "replies": {},
              "deadline": self.osd.now + (msg.length or 30)}
        if not live:
            self._notify_complete(nid, st)
            return
        self._notifies[nid] = st
        for (client, cookie) in live:
            self.osd.messenger.send_message(MWatchNotify(
                op=MWatchNotify.NOTIFY, pgid=self.pgid, oid=msg.oid,
                cookie=cookie, notify_id=nid, payload=msg.data), client)

    def handle_notify_ack(self, msg) -> None:
        st = self._notifies.get(msg.notify_id)
        if st is None:
            return
        st["pending"].discard((msg.src, msg.cookie))
        st["replies"][f"{msg.src}:{msg.cookie}"] = msg.payload
        if not st["pending"]:
            self._notify_complete(msg.notify_id, st)

    def _notify_complete(self, nid: int, st: Dict,
                         result: int = 0) -> None:
        self._notifies.pop(nid, None)
        self.osd.send_op_reply(st["src"], MOSDOpReply(
            tid=st["tid"], result=result, data=pack_kv(st["replies"]),
            epoch=self.osd.osdmap.epoch))

    def sweep_notifies(self) -> None:
        """Tick-driven timeout: notifies whose remaining watchers went
        silent complete with ETIMEDOUT + the partial replies (the
        reference reports the timed-out watchers, never fake success)."""
        for nid, st in list(self._notifies.items()):
            if self.osd.now >= st["deadline"]:
                dlog("osd", 5, f"notify {nid} timed out waiting for "
                     f"{st['pending']}", f"osd.{self.osd.osd_id}")
                self._notify_complete(nid, st, result=-110)

    # ---- snapshots (PrimaryLogPG snapset/clone model, pool snaps) ----------
    #
    # Pool snaps only (rados mksnap).  On the first write after the
    # pool's snap_seq advances, the primary clones the head's current
    # state into an ordinary PG object named _clone_oid(oid, seq) (so
    # recovery/scrub/backfill/durability cover clones for free) — or
    # records a whiteout when the head did not exist.  The per-head
    # snapset (sorted [(seq, kind)]) rides the shard write transactions
    # into every replica's PG meta object.  A read at snap s resolves to
    # the earliest entry with seq >= s (whiteout -> ENOENT; none -> head).

    def _adopt_purged(self, snaps: List[int]) -> None:
        """Union a peer's purged_snaps into ours (peering exchange —
        trim-is-done knowledge must survive any single death)."""
        extra = set(snaps) - self.purged_snaps
        if not extra:
            return
        from .snap_mapper import stage_purged
        self.purged_snaps |= extra
        t = Transaction()
        self.ensure_meta_collection(t)
        stage_purged(t, self.meta_cid(), self.purged_snaps)
        self.osd.store.queue_transaction(t)

    def _interesting_snaps(self) -> Set[int]:
        """Snap ids the SnapMapper indexes: live plus removed ones —
        deliberately NOT minus purged_snaps.  The index must stay a
        truthful "who still references this snap" so the trimmer can
        detect a purged marker whose trim never actually landed (a
        primary killed between staging purged and the fan-out being
        delivered) and redo it; purged_snaps is a fast-path hint, not
        ground truth."""
        return self.pool.live_snaps() | set(self.pool.removed_snaps)

    @staticmethod
    def _clone_oid(oid: str, seq: int) -> str:
        return f"{oid}\x00snap\x00{seq}"

    @staticmethod
    def is_clone_oid(oid: str) -> bool:
        return "\x00snap\x00" in oid

    def _snapset_max(self, oid: str) -> int:
        ents = self.snapsets.get(oid)
        return ents[-1][0] if ents else 0

    def _msg_snapc(self, msg) -> Optional[Tuple[int, Tuple[int, ...]]]:
        """Client-supplied write SnapContext (selfmanaged-snap pools);
        None means clone against the pool snapc as before."""
        if getattr(msg, "snapc_seq", 0) > 0:
            return (msg.snapc_seq, tuple(msg.snapc_snaps))
        return None

    def _clone_needed(self, oid: str, snapc=None) -> bool:
        if snapc is None:
            seq, snaps = self.pool.snap_seq, self.pool.snaps
        else:
            seq, snaps = snapc
        if seq == 0 or self.is_clone_oid(oid):
            return False
        m = self._snapset_max(oid)
        if m >= seq:
            return False
        # a clone is only worth taking if a LIVE snap falls in the
        # window it would cover — after every snap is removed, writes
        # must not keep manufacturing instant garbage.  A client snapc
        # may lag the mon's removals, so filter those out too.
        removed = set(self.pool.removed_snaps)
        return any(m < sid <= seq and sid not in removed for sid in snaps)

    def with_clone(self, oid: str, proceed: Callable[[], None],
                   snapc=None) -> None:
        """Run *proceed* after ensuring the pre-write state is cloned
        (make_writeable's clone step, PrimaryLogPG.cc)."""
        if not self._clone_needed(oid, snapc):
            proceed()
            return
        if self.backend is not None:
            self.backend.object_state(
                oid, lambda res, data, _size, attrs:
                self._clone_have_state(oid, res, data, attrs, {}, proceed,
                                       snapc))
        else:
            exists, data, attrs, omap = self.rep_backend.object_state(oid)
            self._clone_have_state(oid, 0 if exists else -2, data, attrs,
                                   omap, proceed, snapc)

    def _clone_have_state(self, oid: str, res: int, data: bytes,
                          attrs: Dict[str, bytes],
                          omap: Dict[str, bytes],
                          proceed: Callable[[], None],
                          snapc=None) -> None:
        if res not in (0, -2):
            # can't read the head (EIO): write anyway, skip the clone —
            # losing a snapshot beats failing every write
            dlog("pg", 1, f"snap clone of {oid} failed: {res}",
                 f"osd.{self.osd.osd_id}")
            proceed()
            return
        seq = snapc[0] if snapc is not None else self.pool.snap_seq
        if self._snapset_max(oid) >= seq:   # raced with ourselves
            proceed()
            return
        entries = list(self.snapsets.get(oid, []))
        kind = SNAP_CLONE if res == 0 else SNAP_WHITEOUT
        entries.append((seq, kind))
        blob = encode_snapset(entries)
        self.snapsets[oid] = entries
        self.snap_mapper.update_oid(oid, entries,
                                    self._interesting_snaps())
        dlog("pg", 5, f"cloning {oid} @ seq {seq} "
             f"({'clone' if kind else 'whiteout'})",
             f"osd.{self.osd.osd_id}")
        if kind == SNAP_CLONE:
            cl = self._clone_oid(oid, seq)
            if self.backend is not None:
                self.backend.submit_transaction(
                    cl, data, lambda _r: None, xattrs=attrs,
                    snapset_update=(oid, blob))
            else:
                self.rep_backend.write(cl, data, full=True,
                                       version=self.next_version(),
                                       xattrs=attrs, omap=omap,
                                       snapset_update=(oid, blob))
        else:
            self._fan_snapset(oid, blob)
        proceed()

    def _fan_snapset(self, oid: str, blob: bytes) -> None:
        """Pure snapset-metadata fan-out (no object touched).  On EC
        pools the fan is acked and retried like sub-op writes (an
        InflightWrite swept by the OSD tick / idle kick); replicated
        pools keep the rep backend's fire-and-forget shape."""
        from ..msg.messages import MOSDECSubOpWrite
        if self.backend is not None:
            self._fan_acked(
                oid, lambda shard, tid: MOSDECSubOpWrite(
                    tid=tid, pgid=self.pgid, shard=shard, oid=oid,
                    snapset_only=True, snapset_update=(oid, blob)))
            return
        for shard, osd in self.acting_shards().items():
            self.send_to_osd(osd, MOSDECSubOpWrite(
                tid=0, pgid=self.pgid, shard=-1,
                oid=oid, snapset_only=True, snapset_update=(oid, blob)))

    def _fan_acked(self, oid: str, make_msg) -> int:
        """Fan ``make_msg(shard, tid)`` to every acting shard through
        the EC backend's InflightWrite machinery: acked per shard,
        unacked sends resent by sweep_inflight (tick + idle kick) —
        the retry contract sub-op writes already have
        (docs/ROBUSTNESS.md).  Returns the fan's tid."""
        from .ec_backend import InflightWrite
        be = self.backend
        tid = be.next_tid()
        wr = InflightWrite(tid=tid, oid=oid,
                           client_reply=lambda _r: None)
        for shard, osd in self.acting_shards().items():
            msg = make_msg(shard, tid)
            wr.pending_shards.add(shard)
            wr.sent_msgs[shard] = (osd, msg)
            self.send_to_osd(osd, msg)
        if wr.pending_shards:
            wr.last_send = self.osd.now
            be.inflight_writes[tid] = wr
        return tid

    def _encoded_snapsets(self) -> List[Tuple[str, bytes]]:
        return [(oid, encode_snapset(ents))
                for oid, ents in self.snapsets.items()]

    def merge_snapsets(self, pairs: List[Tuple[str, bytes]]) -> None:
        """Adopt peer snapsets that are ahead of ours (higher max clone
        seq wins — seqs only grow, so the longer history is newer)."""
        from .pg_log import decode_snapset
        if not pairs:
            return
        t = Transaction()
        changed = False
        interesting = self._interesting_snaps()

        def rank(entries):
            # trimmed beats clone/whiteout at the same seq, so a trim
            # tombstone always propagates over the entries it killed;
            # ties on max seq break on the highest trimmed seq anywhere
            # in the history (a tombstone below a surviving live clone
            # must still dominate the pre-trim history it replaced)
            return (entries[-1][0],
                    1 if entries[-1][1] == SNAP_TRIMMED else 0,
                    max((s for s, k in entries if k == SNAP_TRIMMED),
                        default=0))

        for oid, blob in pairs:
            ents = decode_snapset(blob)
            if not ents:
                continue
            mine = self.snapsets.get(oid, [])
            if not mine or rank(ents) > rank(mine):
                if not self.osd.store.collection_exists(self.meta_cid()):
                    t.create_collection(self.meta_cid())
                stage_snapset(t, self.meta_cid(), oid, blob)
                self.snapsets[oid] = ents
                self.snap_mapper.update_oid(oid, ents, interesting)
                changed = True
        if changed:
            self.osd.store.queue_transaction(t)

    def apply_snapset_update(self, upd: Tuple[str, bytes],
                             t: Transaction) -> None:
        """Shard-side: stage the snapset into the meta object and
        mirror it in memory (every replica tracks snapsets)."""
        from .pg_log import decode_snapset
        oid, blob = upd
        if not self.osd.store.collection_exists(self.meta_cid()):
            t.create_collection(self.meta_cid())
        stage_snapset(t, self.meta_cid(), oid, blob)
        if blob:
            self.snapsets[oid] = decode_snapset(blob)
        else:
            self.snapsets.pop(oid, None)
        self.snap_mapper.update_oid(oid, self.snapsets.get(oid, []),
                                    self._interesting_snaps())

    def resolve_snap(self, oid: str, snapid: int):
        """-> (target_oid | None for ENOENT).  Earliest snapset entry
        with seq >= snapid wins; none means the head is unchanged since
        the snap and serves it."""
        for seq, kind in self.snapsets.get(oid, []):
            if seq >= snapid:
                if kind == SNAP_TRIMMED:
                    continue        # the covering state is gone
                if kind == SNAP_WHITEOUT:
                    return None
                return self._clone_oid(oid, seq)
        return oid

    def _maybe_trim_snaps(self) -> None:
        """Drop clones covering only removed snaps (snap trimmer role).
        Entry (S, kind) covers pool snaps s with prev_S < s <= S; when no
        live snap falls in that window the clone is garbage.

        The candidates come from the SnapMapper index (snap -> heads),
        not a scan of every snapset, and the snaps to handle come from
        ``removed_snaps - purged_snaps`` rather than "did this epoch
        change them" — so a primary that died before trimming is
        finished by its successor at the next activation (the
        reference's purged_snaps catch-up, src/osd/PrimaryLogPG.cc
        AwaitAsyncWork + pg_info_t.purged_snaps)."""
        if not self.is_primary():
            return
        if self.state not in (STATE_ACTIVE, STATE_ACTIVE_RECOVERING):
            # mid-peering our snapsets/purged knowledge is incomplete —
            # recording purged now would mark debt paid that was never
            # collected; _activate re-calls us once the merge is done
            return
        # unpurged removed snaps, PLUS purged ones the index says are
        # still referenced — a purged marker can outlive a crash that
        # swallowed the trim's fan-out, and only the index knows
        to_purge = {s for s in self.pool.removed_snaps
                    if s not in self.purged_snaps
                    or self.snap_mapper.lookup(s)}
        if not to_purge:
            return
        candidates: Set[str] = set()
        for sid in to_purge:
            candidates |= self.snap_mapper.lookup(sid)
        live = self.pool.live_snaps()
        interesting = self._interesting_snaps()
        for oid in sorted(candidates):
            entries = self.snapsets.get(oid)
            if not entries:
                continue
            keep = []
            prev = 0
            changed = False
            trimmed_max = 0
            for seq, kind in entries:
                if kind == SNAP_TRIMMED:
                    trimmed_max = max(trimmed_max, seq)
                    changed = True      # re-emitted (possibly merged) below
                elif any(prev < sid <= seq for sid in live):
                    keep.append((seq, kind))
                else:
                    changed = True
                    trimmed_max = max(trimmed_max, seq)
                    if kind == SNAP_CLONE:
                        dlog("pg", 5, f"trimming clone {oid}@{seq}",
                             f"osd.{self.osd.osd_id}")
                        self._fan_delete(self._clone_oid(oid, seq))
                prev = seq
            if changed:
                # one tombstone at the max trimmed seq keeps a stale
                # rejoining peer from resurrecting the dead entries
                if trimmed_max:
                    keep = sorted(keep + [(trimmed_max, SNAP_TRIMMED)])
                self.snapsets[oid] = keep
                self.snap_mapper.update_oid(oid, keep, interesting)
                self._fan_snapset(oid, encode_snapset(keep))
        # record completion so no successor (or later epoch) redoes it
        self._adopt_purged(sorted(to_purge))

    # ---- multi-op vector interpreter (do_osd_ops) --------------------------

    # ops whose execution needs the object's current bytes; vectors with
    # none of these run off a one-shard attrs-only probe on EC pools
    _BODY_OPS = frozenset([
        CEPH_OSD_OP_READ, CEPH_OSD_OP_WRITE, CEPH_OSD_OP_APPEND,
        CEPH_OSD_OP_TRUNCATE, CEPH_OSD_OP_ZERO, CEPH_OSD_OP_STAT,
        CEPH_OSD_OP_WRITEFULL,
        CEPH_OSD_OP_CALL,       # class methods may read/write the body
    ])

    _READONLY_OPS = frozenset([
        CEPH_OSD_OP_READ, CEPH_OSD_OP_STAT, CEPH_OSD_OP_GETXATTR,
        CEPH_OSD_OP_GETXATTRS, CEPH_OSD_OP_OMAPGETVALS,
        CEPH_OSD_OP_CMPXATTR, CEPH_OSD_OP_ASSERT_VER,
    ])

    def _op_mutates(self, o: OSDOp) -> bool:
        """Write-ness of one vector op; class calls consult their
        registered RD/WR flags (the reference's cls method flags) so a
        pure-read exec is not gated or cloned like a write."""
        if o.op in self._READONLY_OPS:
            return False
        if o.op == CEPH_OSD_OP_CALL:
            from .cls import CLS_METHOD_WR, lookup
            cls_name, _, method = o.name.partition(".")
            ent = lookup(cls_name, method)
            return bool(ent and (ent[1] & CLS_METHOD_WR))
        return True

    def _stored_user_version(self, oid: str) -> int:
        """Current pg_log version stamped on the object's VERSION_ATTR
        (0 when absent) — the reply user_version analog that assert_ver
        guards compare against.  Distinct from _object_version, the
        recovery-path helper whose absent sentinel is -1."""
        store = self.osd.store
        if self.backend is not None:
            shard = self.my_shard()
            cid = self.backend.shard_cid(shard)
            ho = hobject_t(oid, shard)
        else:
            cid = self.rep_backend.cid()
            ho = hobject_t(oid)
        if not store.collection_exists(cid) or not store.exists(cid, ho):
            return 0
        try:
            return struct.unpack("<Q",
                                 store.getattr(cid, ho, VERSION_ATTR))[0]
        except KeyError:
            return 0

    def _do_op_vector(self, msg: MOSDOp) -> None:
        """Atomic multi-op execution (PrimaryLogPG::do_osd_ops,
        PrimaryLogPG.cc:7796 via prepare_transaction): fetch the object's
        state once, run every op of the vector in order against it, and
        commit all mutations as ONE backend transaction — which on EC
        pools means one batched device encode for the whole vector.  The
        first failing op aborts the vector with nothing committed (the
        reference aborts the ctx on the first negative rval).  Vectors
        ride the backend's per-object queue, so concurrent vectors and
        single-op writes on one object serialize (start_rmw's
        guarantee)."""
        oid = msg.oid
        if msg.snapid:
            # snap-targeted vectors are read-only views of the clone
            if any(self._op_mutates(o) for o in msg.ops):
                self.osd.send_op_reply(msg.src, MOSDOpReply(
                    tid=msg.tid, result=-30,     # EROFS
                    epoch=self.osd.osdmap.epoch))
                return
            target = self.resolve_snap(oid, msg.snapid)
            if target is None:
                self.osd.send_op_reply(msg.src, MOSDOpReply(
                    tid=msg.tid, result=-2,
                    epoch=self.osd.osdmap.epoch))
                return
            oid = target

        def start() -> None:
            if self.backend is not None:
                meta_only = all(o.op not in self._BODY_OPS
                                for o in msg.ops)
                self.backend.submit_vector(
                    oid,
                    lambda res, body, _size, attrs:
                    self._run_op_vector(msg, res, body, attrs, {}),
                    meta_only=meta_only)
            else:
                exists, data, attrs, omap = \
                    self.rep_backend.object_state(oid)
                spec = self._run_op_vector(
                    msg, 0 if exists else -2, data, attrs, omap)
                self._commit_rep_vector(msg.oid, spec)

        def gated() -> None:
            mutates = any(self._op_mutates(o) for o in msg.ops)
            if mutates:
                self.with_clone(oid, start,
                                snapc=self._msg_snapc(msg))
            else:
                start()

        degraded = (self.missing_shards_for(oid) if self.backend is not None
                    else (oid in self.local_missing))
        if degraded:
            self.wait_for_recovery(oid, gated)
        else:
            gated()

    def _run_op_vector(self, msg: MOSDOp, res: int, data: bytes,
                       attrs: Dict[str, bytes], omap: Dict[str, bytes]):
        """Execute the ops; send the reply for no-commit outcomes; return
        the commit spec (see ec_backend.VectorOp) otherwise."""
        if res not in (0, -2):
            self.osd.send_op_reply(msg.src, MOSDOpReply(
                tid=msg.tid, result=res, epoch=self.osd.osdmap.epoch))
            return None
        st = {"exists": res == 0, "body": bytearray(data),
              "attrs": dict(attrs), "omap": dict(omap),
              # EC stores have no omap; class methods touching it must
              # fail loudly (EOPNOTSUPP) instead of staging silently
              # dropped keys (reference: cls_cxx_map_* on EC pools)
              "omap_ok": self.backend is None,
              # cls_lock needs wall time (expirations) and the caller
              # identity (cls_cxx_get_origin / ceph_cls_current_*)
              "now": self.osd.now, "entity": msg.src}
        if any(o.op == CEPH_OSD_OP_ASSERT_VER for o in msg.ops):
            st["cur_version"] = self._stored_user_version(msg.oid)
        existed = st["exists"]
        mutated = meta_mutated = False
        results: List[Tuple[int, bytes]] = []
        error = 0
        for op in msg.ops:
            r, out = self._exec_one_op(op, st)
            mutated |= st.pop("_mutated", False)
            meta_mutated |= st.pop("_meta", False)
            results.append((r, out))
            if r < 0:
                error = r
                break
        reply = MOSDOpReply(tid=msg.tid, result=error,
                            epoch=self.osd.osdmap.epoch,
                            op_results=results)
        if error or not (mutated or meta_mutated):
            # read-only vector or aborted mutation: nothing to commit
            if results and not error:
                reply.data = next((d for r, d in reversed(results) if d),
                                  b"")
            self.osd.send_op_reply(msg.src, reply)
            return None
        src = msg.src

        def on_commit(result: int) -> None:
            reply.result = result
            self.osd.send_op_reply(src, reply)

        if not st["exists"]:
            # the vector's NET effect is removal (a later create/write
            # in the same vector would have set exists back — the final
            # state decides, like the reference's ctx->delta_stats)
            if not existed:
                # never existed and still doesn't: nothing to fan
                self.osd.send_op_reply(src, reply)
                return None
            self.clear_missing_for(msg.oid)
            return ("delete", lambda: self._fan_delete(msg.oid), on_commit)
        if mutated:
            def committed(result: int) -> None:
                if result == 0:
                    self.clear_missing_for(msg.oid)
                on_commit(result)
            return ("write", bytes(st["body"]), dict(st["attrs"]),
                    committed, dict(st["omap"]))
        return ("attrs", dict(st["attrs"]), on_commit, dict(st["omap"]))

    def _commit_rep_vector(self, oid: str, spec) -> None:
        """Apply a commit spec synchronously on the replicated backend
        (the in-process fabric serializes rep ops; no queue needed)."""
        if spec is None:
            return
        kind = spec[0]
        if kind == "delete":
            _, fan_fn, on_commit = spec
            fan_fn()
            on_commit(0)
            return
        if kind == "write":
            _, body, attrs, on_commit, omap = spec
            self.rep_backend.write(oid, body, full=True,
                                   version=self.next_version(),
                                   xattrs=attrs, omap=omap)
            on_commit(0)
            return
        _, attrs, on_commit, omap = spec
        self.rep_backend.write(oid, b"", version=self.next_version(),
                               xattrs=attrs, omap=omap, attr_only=True)
        on_commit(0)

    def _exec_one_op(self, op: OSDOp, st: Dict) -> Tuple[int, bytes]:
        """Run one op against the in-memory object state; mutations are
        recorded in st via _mutated/_meta/_deleted flags."""
        exists, body = st["exists"], st["body"]
        attrs, omap = st["attrs"], st["omap"]
        o = op.op
        if o == CEPH_OSD_OP_CREATE:
            if exists and (op.flags & CEPH_OSD_OP_FLAG_EXCL):
                return -17, b""                     # EEXIST
            if not exists:
                st["exists"], st["_mutated"] = True, True
            return 0, b""
        if o == CEPH_OSD_OP_WRITEFULL:
            st["body"] = bytearray(op.data)
            st["exists"], st["_mutated"] = True, True
            return 0, b""
        if o == CEPH_OSD_OP_WRITE:
            end = op.offset + len(op.data)
            if end > len(body):
                body.extend(b"\0" * (end - len(body)))
            body[op.offset:end] = op.data
            st["exists"], st["_mutated"] = True, True
            return 0, b""
        if o == CEPH_OSD_OP_APPEND:
            body.extend(op.data)
            st["exists"], st["_mutated"] = True, True
            return 0, b""
        if o == CEPH_OSD_OP_TRUNCATE:
            if not exists:
                return -2, b""                      # ENOENT
            if op.offset <= len(body):
                del body[op.offset:]
            else:
                body.extend(b"\0" * (op.offset - len(body)))
            st["_mutated"] = True
            return 0, b""
        if o == CEPH_OSD_OP_ZERO:
            if not exists:
                return -2, b""
            end = min(op.offset + op.length, len(body))
            if end > op.offset:
                body[op.offset:end] = b"\0" * (end - op.offset)
                st["_mutated"] = True
            return 0, b""
        if o == CEPH_OSD_OP_DELETE:
            if not exists:
                return -2, b""
            st["exists"], st["_mutated"] = False, True
            st["body"] = bytearray()
            attrs.clear()
            omap.clear()
            return 0, b""
        if o == CEPH_OSD_OP_READ:
            if not exists:
                return -2, b""
            end = op.offset + op.length if op.length else len(body)
            return 0, bytes(body[op.offset:end])
        if o == CEPH_OSD_OP_STAT:
            if not exists:
                return -2, b""
            return 0, struct.pack("<Q", len(body))
        if o == CEPH_OSD_OP_SETXATTR:
            attrs[op.name] = bytes(op.data)
            st["exists"], st["_meta"] = True, True
            return 0, b""
        if o == CEPH_OSD_OP_RMXATTR:
            if op.name not in attrs:
                return -61, b""                     # ENODATA
            del attrs[op.name]
            st["_meta"] = True
            return 0, b""
        if o == CEPH_OSD_OP_GETXATTR:
            if not exists:
                return -2, b""                      # ENOENT
            v = attrs.get(op.name)
            if v is None:
                return -61, b""
            return 0, v
        if o == CEPH_OSD_OP_GETXATTRS:
            if not exists:
                return -2, b""
            return 0, pack_kv({k: attrs[k] for k in sorted(attrs)})
        if o == CEPH_OSD_OP_CMPXATTR:
            v = attrs.get(op.name)
            if v is None:
                return -61, b""
            cmp = (v > op.data) - (v < op.data)
            ok = {CEPH_OSD_CMPXATTR_OP_EQ: cmp == 0,
                  CEPH_OSD_CMPXATTR_OP_NE: cmp != 0,
                  CEPH_OSD_CMPXATTR_OP_GT: cmp > 0,
                  CEPH_OSD_CMPXATTR_OP_GTE: cmp >= 0,
                  CEPH_OSD_CMPXATTR_OP_LT: cmp < 0,
                  CEPH_OSD_CMPXATTR_OP_LTE: cmp <= 0}.get(op.flags)
            if ok is None:
                return -22, b""                     # EINVAL
            return (1, b"") if ok else (-125, b"")  # ECANCELED on mismatch
        if o == CEPH_OSD_OP_ASSERT_VER:
            # expected version rides op.offset; mismatch aborts the
            # vector with ERANGE (PrimaryLogPG.cc do_osd_ops)
            return (0, b"") if op.offset == st["cur_version"] \
                else (-34, b"")
        if o == CEPH_OSD_OP_CALL:
            # object-class method (do_osd_ops CEPH_OSD_OP_CALL ->
            # ClassHandler): runs against the staged state so its
            # mutations commit with the rest of the vector
            from .cls import ClsContext, ClsError, lookup
            cls_name, _, method = op.name.partition(".")
            ent = lookup(cls_name, method)
            if ent is None:
                return -95, b""             # EOPNOTSUPP: no such method
            fn, _flags = ent
            try:
                ret, out = fn(ClsContext(st), bytes(op.data))
            except ClsError as e:
                return e.ret, b""
            except Exception:
                return -22, b""
            return ret, out
        if o in (CEPH_OSD_OP_OMAPSETKEYS, CEPH_OSD_OP_OMAPRMKEYS,
                 CEPH_OSD_OP_OMAPGETVALS):
            if self.backend is not None:
                return -95, b""   # EOPNOTSUPP: no omap on EC pools
            if o == CEPH_OSD_OP_OMAPSETKEYS:
                omap.update(unpack_kv(op.data))
                st["exists"], st["_meta"] = True, True
                return 0, b""
            if o == CEPH_OSD_OP_OMAPRMKEYS:
                for k in unpack_keys(op.data):
                    omap.pop(k, None)
                st["_meta"] = True
                return 0, b""
            if not exists:
                return -2, b""
            return 0, pack_kv({k: omap[k] for k in sorted(omap)})
        return -95, b""                             # EOPNOTSUPP

    def _fan_delete(self, oid: str) -> None:
        """Fan a versioned delete to every acting shard/replica.  EC
        deletes are acked + retried like sub-op writes (tid assigned,
        resent from the OSD tick/idle kick, shard replay deduped
        against the pg log) — the last unacked write-path class
        (docs/ROBUSTNESS.md); replicated deletes stay fire-and-forget
        like every other rep-backend fan."""
        from ..msg.messages import MOSDECSubOpWrite
        version = self.next_version()
        if self.backend is not None:
            self._fan_acked(
                oid, lambda shard, tid: MOSDECSubOpWrite(
                    tid=tid, pgid=self.pgid, shard=shard, oid=oid,
                    chunk=b"", at_version=-1, version=version))
        else:
            for osd in self.acting:
                if osd == CRUSH_ITEM_NONE:
                    continue
                self.send_to_osd(osd, MOSDECSubOpWrite(
                    tid=0, pgid=self.pgid, shard=-1, oid=oid,
                    chunk=b"", at_version=-1, version=version))

    _PARTIAL_OPS = frozenset([
        CEPH_OSD_OP_WRITE, CEPH_OSD_OP_APPEND, CEPH_OSD_OP_TRUNCATE,
        CEPH_OSD_OP_ZERO,
    ])

    def _is_partial_update(self, msg: MOSDOp) -> bool:
        if msg.ops:
            return any(o.op in self._PARTIAL_OPS for o in msg.ops)
        return msg.op in (CEPH_OSD_OP_WRITE, CEPH_OSD_OP_APPEND)

    def _do_write(self, msg: MOSDOp) -> None:
        if self.backend is not None:
            src = msg.src
            oid = msg.oid

            def on_commit(result: int) -> None:
                if result == 0:
                    self.clear_missing_for(oid)
                self.osd.send_op_reply(src, MOSDOpReply(
                    tid=msg.tid, result=result,
                    epoch=self.osd.osdmap.epoch))

            self.backend.submit_transaction(msg.oid, msg.data, on_commit)
        else:
            self.rep_backend.write(msg.oid, msg.data, full=True,
                                   version=self.next_version())
            self.osd.send_op_reply(msg.src, MOSDOpReply(
                tid=msg.tid, result=0, epoch=self.osd.osdmap.epoch))

    def _do_partial_write(self, msg: MOSDOp) -> None:
        """Offset write / append: rmw on EC pools, splice on replicated
        (PrimaryLogPG do_osd_ops CEPH_OSD_OP_WRITE/APPEND).  Degraded
        objects are recovered before the rmw touches shard state."""
        offset = None if msg.op == CEPH_OSD_OP_APPEND else msg.offset
        if self.backend is not None:
            src = msg.src

            def on_commit(result: int) -> None:
                self.osd.send_op_reply(src, MOSDOpReply(
                    tid=msg.tid, result=result,
                    epoch=self.osd.osdmap.epoch))

            def submit() -> None:
                self.backend.submit_write(msg.oid, msg.data, offset,
                                          on_commit)

            if self.missing_shards_for(msg.oid):
                self.wait_for_recovery(msg.oid, submit)
            else:
                submit()
        else:
            def rep_submit() -> None:
                self.rep_backend.write(msg.oid, msg.data, offset=offset,
                                       version=self.next_version())
                self.osd.send_op_reply(msg.src, MOSDOpReply(
                    tid=msg.tid, result=0, epoch=self.osd.osdmap.epoch))

            if msg.oid in self.local_missing:
                # our own copy is stale/absent: the splice offset would
                # be wrong — recover first (wait_for_missing_object)
                self.wait_for_recovery(msg.oid, rep_submit)
            else:
                rep_submit()

    def wait_for_recovery(self, oid: str, then: Callable[[], None]) -> None:
        """Queue *then* until the object is fully recovered
        (wait_for_missing_object semantics)."""
        self._waiting_for_recovery.setdefault(oid, []).append(then)
        self.osd.recover_oid(self, oid)

    def recovery_done_for(self, oid: str) -> None:
        self._recovering.discard(oid)
        self._recovering_since.pop(oid, None)
        self._maybe_clean()
        for cb in self._waiting_for_recovery.pop(oid, []):
            cb()

    def _snap_redirect(self, msg: MOSDOp) -> Optional[MOSDOp]:
        """Resolve msg.snapid to the object serving that snap view;
        returns the (possibly cloned-and-redirected) msg, or None after
        replying ENOENT for whiteouts/absent-at-snap."""
        if not msg.snapid:
            return msg
        target = self.resolve_snap(msg.oid, msg.snapid)
        if target is None:
            self.osd.send_op_reply(msg.src, MOSDOpReply(
                tid=msg.tid, result=-2,
                epoch=self.osd.osdmap.epoch))
            return None
        if target != msg.oid:
            msg = copy.copy(msg)
            msg.oid = target
        return msg

    def data_cids(self) -> List[str]:
        """The store collections holding this PG's objects on THIS OSD
        (one shard cid on EC pools, the replica cid otherwise) — shared
        by listing and stats reporting."""
        if self.backend is not None:
            shard = self.my_shard()
            return [self.backend.shard_cid(shard)] if shard >= 0 else []
        return [self.rep_backend.cid()]

    def _do_pgls(self, msg: MOSDOp) -> None:
        """List this PG's head objects (PrimaryLogPG do_pg_op
        CEPH_OSD_OP_PGNLS): cursor = last name already returned
        (msg.data), page size = msg.length (0 = everything).  Clones
        and PG-internal metadata never appear; objects the primary
        knows about but has not recovered yet DO (the reference merges
        the missing set the same way, so a listing taken mid-recovery
        is complete).  The page ships as JSON (names may contain any
        byte); result carries 1 when more remain."""
        import heapq
        import json as _json
        store = self.osd.store
        cursor = msg.data.decode() if msg.data else ""
        names = set()
        for cid in self.data_cids():
            if not store.collection_exists(cid):
                continue
            for ho in store.list_objects(cid):
                if ho.oid == PG_META_OID or self.is_clone_oid(ho.oid) \
                        or ho.oid <= cursor:
                    continue
                names.add(ho.oid)
        # merge known-but-unrecovered objects (do_pgnls missing merge)
        if self.backend is not None:
            for per_shard in self.missing.values():
                for oid in per_shard:
                    if not self.is_clone_oid(oid) and oid > cursor:
                        names.add(oid)
        else:
            for oid in self.local_missing:
                if not self.is_clone_oid(oid) and oid > cursor:
                    names.add(oid)
        if msg.length:
            page = heapq.nsmallest(msg.length + 1, names)
            more = 1 if len(page) > msg.length else 0
            page = page[:msg.length]
        else:
            page, more = sorted(names), 0
        self.osd.send_op_reply(msg.src, MOSDOpReply(
            tid=msg.tid, result=more, epoch=self.osd.osdmap.epoch,
            data=_json.dumps(page).encode()))

    def _do_read(self, msg: MOSDOp) -> None:
        msg = self._snap_redirect(msg)
        if msg is None:
            return
        if self.backend is not None:
            src = msg.src

            def on_complete(result: int, data: bytes) -> None:
                self.osd.send_op_reply(src, MOSDOpReply(
                    tid=msg.tid, result=result, data=data,
                    epoch=self.osd.osdmap.epoch))

            self.backend.objects_read_and_reconstruct(
                msg.oid, on_complete, offset=msg.offset, length=msg.length)
        else:
            def rep_read() -> None:
                data = self.rep_backend.read(msg.oid)
                if data is None:
                    self.osd.send_op_reply(
                        msg.src, MOSDOpReply(tid=msg.tid, result=-2))
                else:
                    body = data
                    if msg.length:
                        body = data[msg.offset:msg.offset + msg.length]
                    elif msg.offset:
                        body = data[msg.offset:]
                    self.osd.send_op_reply(msg.src, MOSDOpReply(
                        tid=msg.tid, result=0, data=body,
                        epoch=self.osd.osdmap.epoch))

            if msg.oid in self.local_missing:
                # serving the stale local copy would return old bytes
                self.wait_for_recovery(msg.oid, rep_read)
            else:
                rep_read()

    def _do_stat(self, msg: MOSDOp) -> None:
        msg = self._snap_redirect(msg)
        if msg is None:
            return
        store = self.osd.store
        if self.backend is not None:
            shard = self.my_shard()
            cid = self.backend.shard_cid(shard)
            ho = hobject_t(msg.oid, shard)
        else:
            cid = self.rep_backend.cid()
            ho = hobject_t(msg.oid)
        if not store.collection_exists(cid) or not store.exists(cid, ho):
            self.osd.send_op_reply(msg.src,
                                   MOSDOpReply(tid=msg.tid, result=-2))
            return
        try:
            size = struct.unpack("<Q", store.getattr(cid, ho, SIZE_ATTR))[0]
        except KeyError:
            size = store.stat(cid, ho)
        self.osd.send_op_reply(msg.src, MOSDOpReply(
            tid=msg.tid, result=0, data=struct.pack("<Q", size),
            epoch=self.osd.osdmap.epoch,
            version=self._stored_user_version(msg.oid)))

    def _do_copy_from(self, msg: MOSDOp) -> None:
        """Server-side object copy (PrimaryLogPG do_copy_from /
        process_copy_chunk): the primary fetches the SOURCE — possibly
        from another pool — through its own client path, then commits
        the bytes + user attrs locally as one full write."""
        from ..msg.messages import (
            CEPH_OSD_OP_GETXATTRS as _GX, CEPH_OSD_OP_OMAPGETVALS as _OG,
            CEPH_OSD_OP_READ as _RD,
        )
        op = msg.ops[0]
        src_oid = op.name
        # pool ids start at 0: -1 is the same-pool sentinel
        src_pool = op.offset if op.offset >= 0 else msg.pool
        src = msg.src
        # omap rides along only when the SOURCE pool can hold it (an
        # OMAPGETVALS in the fetch vector would abort on an EC source)
        spool = self.osd.osdmap.get_pg_pool(src_pool)
        fetch = [OSDOp(op=_RD), OSDOp(op=_GX)]
        src_has_omap = spool is not None and not spool.is_erasure()
        if src_has_omap:
            fetch.append(OSDOp(op=_OG))

        def on_fetch(reply) -> None:
            if reply.result != 0 or not reply.op_results:
                self.osd.send_op_reply(src, MOSDOpReply(
                    tid=msg.tid, result=reply.result or -5,
                    epoch=self.osd.osdmap.epoch))
                return
            data = reply.op_results[0][1]
            attrs = {}
            if len(reply.op_results) > 1 and reply.op_results[1][0] >= 0:
                attrs = unpack_kv(reply.op_results[1][1])
            omap = {}
            if src_has_omap and len(reply.op_results) > 2 and \
                    reply.op_results[2][0] >= 0:
                omap = unpack_kv(reply.op_results[2][1])

            def on_commit(result: int) -> None:
                if result == 0:
                    self.clear_missing_for(msg.oid)
                self.osd.send_op_reply(src, MOSDOpReply(
                    tid=msg.tid, result=result,
                    epoch=self.osd.osdmap.epoch))

            if self.backend is not None:
                # EC destinations cannot hold omap; body + attrs copy
                self.backend.submit_transaction(msg.oid, data, on_commit,
                                                xattrs=attrs)
            else:
                # full replacement INCLUDING omap (reference copy-from
                # replaces the whole object; {} clears stale dst keys)
                self.rep_backend.write(msg.oid, data, full=True,
                                       version=self.next_version(),
                                       xattrs=attrs, omap=omap)
                on_commit(0)

        self.osd.tier_submit(src_pool, src_oid, fetch, on_fetch)

    def _do_delete(self, msg: MOSDOp) -> None:
        self._fan_delete(msg.oid)
        self.clear_missing_for(msg.oid)
        self.osd.send_op_reply(msg.src, MOSDOpReply(
            tid=msg.tid, result=0, epoch=self.osd.osdmap.epoch))
