"""OSD daemon — dispatch, map handling, heartbeats, recovery driver.

Mirrors the reference OSD's control surface (src/osd/OSD.{h,cc}): messages
enter via ms_fast_dispatch (OSD.cc:6594) and route to PGs; MOSDMap applies
incrementals and advances every PG (handle_osd_map → consume_map); OSD↔OSD
heartbeats detect silent peers and report them to the mon
(OSD::heartbeat, OSD.cc:4888; failure reports :7787).

Recovery runs entirely over the message fabric (no peer-heap shortcuts):
the primary's per-PG missing sets come from pg_log deltas computed during
peering (PGLog role) or backfill scans; each missing object is recovered
by reading k healthy chunks (MOSDECSubOpRead), decoding the lost shards'
chunks on the codec, and pushing them (MOSDECSubOpWrite) — the
continue_recovery_op flow, ECBackend.cc:535-743.

Port of ``ceph_tpu/osd/osd.py``: EC profiles default to the ``cuda``
plugin, ``tick`` has no mesh chip-health kick (the port has no mesh
yet), and each PG's CRUSH mapping is computed once per map epoch
(``pg_mapping``) where the JAX package computes it on every call.
"""
from __future__ import annotations

import struct
import time
from typing import Callable, Dict, List, Optional, Set, Tuple

from ..common import Dout, OpTracker, PerfCountersBuilder
from ..common.work_queue import (
    CLASS_CLIENT, CLASS_SCRUB, ShardedOpWQ, l_qos_admission_rejections,
    l_qos_queue_depth, l_qos_throttle_events, qos_perf_counters,
)
from ..trace import (g_oplat, g_perf_histograms, g_tracer, latency_axes,
                     latency_in_bytes_axes)
from ..trace.oplat import intake_ledger
from ..crush.constants import CRUSH_ITEM_NONE
from ..msg import (
    Dispatcher, MOSDECSubOpRead, MOSDECSubOpReadReply, MOSDECSubOpWrite,
    MOSDECSubOpWriteReply, MOSDFailure, MOSDMap, MOSDOp, MOSDOpReply,
    MOSDPGInfo, MOSDPGNotify, MOSDPGQuery, MOSDPGRemove, MOSDPGScan,
    MOSDPGScanReply, MOSDPing,
    MOSDRepScrub, MOSDRepScrubMap, Message, Network,
)
from ..os_store import MemStore, Transaction, hobject_t
from ..osdmap import OSDMap, pg_t
from .ec_backend import HINFO_ATTR, SIZE_ATTR
from .pg import PG
from .pg_log import LogEntry, OP_DELETE
from ..common.lockdep import DebugLock

HEARTBEAT_GRACE = 20.0     # osd_heartbeat_grace default (options.cc:2461)
HEARTBEAT_INTERVAL = 6.0   # osd_heartbeat_interval (options.cc:2456)
RECOVERY_RETRY = 10.0      # re-kick a recovery whose reply chain went
                           # silent (a push can race a peer's map epoch
                           # and be dropped pg-less on arrival)

# perf counter indices (l_osd_* analog, osd/OSD.cc:3099)
L_OSD_FIRST = 1000
L_OSD_OP_W = 1001
L_OSD_OP_R = 1002
L_OSD_SUBOP_W = 1003
L_OSD_SUBOP_R = 1004
L_OSD_RECOVERY_PUSH = 1005
L_OSD_MAP = 1006
L_OSD_OP_LAT = 1007
L_OSD_LAST = 1008


def _unpack_pull_meta(attrs: Dict[str, bytes]):
    """Split a replicated pull reply's attr dict into (user_xattrs, omap)."""
    from ..msg.kv import unpack_kv
    from .ec_backend import user_attrs_of
    uattrs = user_attrs_of(attrs)
    omap_blob = attrs.get("_omap_kv")
    omap = unpack_kv(omap_blob) if omap_blob else {}
    return uattrs, omap


def _build_osd_perf(name: str):
    b = PerfCountersBuilder(name, L_OSD_FIRST, L_OSD_LAST)
    b.add_u64_counter(L_OSD_OP_W, "op_w", "client writes")
    b.add_u64_counter(L_OSD_OP_R, "op_r", "client reads")
    b.add_u64_counter(L_OSD_SUBOP_W, "subop_w", "shard writes")
    b.add_u64_counter(L_OSD_SUBOP_R, "subop_r", "shard reads")
    b.add_u64_counter(L_OSD_RECOVERY_PUSH, "recovery_push",
                      "recovered shard pushes")
    b.add_u64_counter(L_OSD_MAP, "maps", "osdmap epochs consumed")
    b.add_time_avg(L_OSD_OP_LAT, "op_latency", "client op latency")
    return b.create_perf_counters()


class OSD(Dispatcher):
    def __init__(self, network: Network, osd_id: int,
                 mon_name: str = "mon", store: Optional[MemStore] = None,
                 mon_names: Optional[List[str]] = None):
        self.osd_id = osd_id
        self.name = f"osd.{osd_id}"
        self.network = network
        self.mon_name = mon_name
        # failure reports go to every monitor (peons forward to the
        # leader), so a dead leader doesn't blind failure detection
        self.mon_names = list(mon_names) if mon_names else [mon_name]
        self.messenger = network.create_messenger(self.name)
        self.messenger.add_dispatcher_head(self)
        self.store = store if store is not None else MemStore()
        from .cls import load_builtin_classes
        load_builtin_classes()      # osd_class_load_list='*'

        self.osdmap = OSDMap()
        # (epoch, {pg_id: pg_to_up_acting_osds}) of ``pg_mapping``
        self._mapping: Tuple[int, Dict] = (-1, {})
        self.pgs: Dict[Tuple[int, int], PG] = {}
        self._ec_impls: Dict[str, object] = {}
        self.last_ping_reply: Dict[int, float] = {}
        self.now = 0.0
        self.perf_counters = _build_osd_perf(self.name)
        # 2D latency x bytes distributions (the reference's
        # op_w_latency_in_bytes_histogram surface, perf_histogram.h):
        # always-on host-side math, dumped via `perf histogram dump`
        self.hist_op_w = g_perf_histograms.get(
            self.name, "op_w_latency_in_bytes_histogram",
            latency_in_bytes_axes)
        self.hist_op_r = g_perf_histograms.get(
            self.name, "op_r_latency_in_bytes_histogram",
            latency_in_bytes_axes)
        self.dout = Dout("osd", self.name)
        self.op_tracker = OpTracker(name=self.name)
        self._tracked: Dict[Tuple[str, int], object] = {}
        self._recovery_queue: List[PG] = []
        # recovery orchestration (recovery/): paced sub-chunk
        # repair rounds, QoS-classed through the recovery dmClock
        # class, per-codec-family bytes-moved accounting
        from ..recovery import RecoveryScheduler
        self.recovery_sched = RecoveryScheduler(self)
        from ..common.config import g_conf
        self.op_wq = ShardedOpWQ(
            wall=bool(g_conf.get_val("osd_op_queue_mclock_wall")))
        # threaded drain (osd_op_tp, OSD.cc:2008): workers take the
        # target PG's lock around each op, like dequeue_op does — real
        # concurrency across shards, lockdep live on the hot path
        self.op_tp = None
        n_threads = int(g_conf.get_val("osd_op_num_threads") or 0)
        if n_threads > 0:
            from ..common.work_queue import ShardedThreadPool
            self.op_tp = ShardedThreadPool(self.op_wq,
                                           self._wq_handle_locked,
                                           n_threads)
        # admission-control throttle windows: client entity ->
        # monotonic expiry.  A client stays listed (and keeps getting
        # EAGAIN+retry_after) until the queue drains below half of
        # osd_op_queue_admission_max AND its window lapsed (docs/QOS.md)
        self._throttled_clients: Dict[str, float] = {}
        # entities granted their own wait-time histogram lane; past the
        # cap newcomers share one overflow lane (bounds the process-
        # global registry under client churn, like ClientDmClock's
        # 64-lane eviction one layer below)
        self._client_hist_lanes: Set[str] = set()
        self._rep_pulls: Dict[int, Callable] = {}
        # OSD-level tids (_rep_pulls, recovery probes, realign pushes)
        # live in a range disjoint from every per-PG backend counter
        # (which starts at 1): a probe reply must never be claimable
        # by — or hijack — a PG's own inflight read with the same tid
        self._pull_tid = 1 << 32
        self._rep_pull_stamps: Dict[int, float] = {}
        # tier ops this OSD issued as a client of the base pool
        # (promote reads / flush writes): tid -> reply callback.
        # Allocated/consumed from worker threads holding only a PG
        # lock, so OSD-level state needs its own mutex
        self._tier_ops: Dict[int, Callable] = {}
        self._tier_tid = 1 << 40     # clear of client tid spaces
        self._tier_lock = DebugLock("OSD::tier_lock")

    def shutdown(self) -> None:
        """Stop background machinery (the threaded op pool's workers
        would otherwise outlive a restarted/replaced daemon and keep
        polling — or executing stale ops against — its old store)."""
        if self.op_tp is not None:
            self.op_tp.stop()
            self.op_tp = None

    # legacy-style dict view used by tests / admin socket
    @property
    def perf(self) -> Dict[str, int]:
        d = self.perf_counters.dump()
        return {k: v for k, v in d.items() if isinstance(v, int)}

    # ---- EC profile plumbing ----------------------------------------------
    def get_ec_impl(self, pool):
        key = pool.erasure_code_profile or "default"
        impl = self._ec_impls.get(key)
        if impl is None:
            from ..ec import create_erasure_code
            profile = dict(self.osdmap.erasure_code_profiles.get(
                key, {"plugin": "cuda", "k": "2", "m": "1"}))
            profile.setdefault("plugin", "cuda")
            impl = create_erasure_code(profile)
            self._ec_impls[key] = impl
        return impl

    # ---- dispatch ---------------------------------------------------------
    def ms_fast_dispatch(self, msg: Message) -> None:
        if isinstance(msg, MOSDMap):
            self._handle_osd_map(msg)
        elif isinstance(msg, MOSDOpReply):
            # replies to this OSD's own tier ops (promote/flush)
            with self._tier_lock:
                ent = self._tier_ops.pop(msg.tid, None)
            if ent is not None:
                ent[0](msg)
        elif isinstance(msg, MOSDOp):
            self._handle_op(msg)
        elif isinstance(msg, MOSDECSubOpWrite):
            self._handle_sub_write(msg)
        elif isinstance(msg, MOSDECSubOpWriteReply):
            pg = self.pgs.get(msg.pgid)
            if pg is not None and pg.backend is not None:
                pg.backend.handle_sub_write_reply(msg)
            elif pg is not None:
                ack = getattr(pg, "_rep_realign_ack", None)
                if ack is not None:
                    ack(msg.tid)
        elif isinstance(msg, MOSDECSubOpRead):
            self._handle_sub_read(msg)
        elif isinstance(msg, MOSDECSubOpReadReply):
            if msg.tid in self._rep_pulls:
                self._rep_pull_stamps.pop(msg.tid, None)
                self._rep_pulls.pop(msg.tid)(msg)
                return
            pg = self.pgs.get(msg.pgid)
            if pg is not None and pg.backend is not None:
                pg.backend.handle_sub_read_reply(msg)
        elif isinstance(msg, MOSDPGNotify):
            self._handle_pg_notify(msg)
        elif isinstance(msg, MOSDPGRemove):
            self._handle_pg_remove(msg)
        elif isinstance(msg, MOSDPGQuery):
            pg = self.pgs.get(msg.pgid)
            if pg is not None:
                pg.handle_pg_query(msg)
        elif isinstance(msg, MOSDPGInfo):
            pg = self.pgs.get(msg.pgid)
            if pg is not None:
                pg.handle_pg_info(msg)
        elif isinstance(msg, MOSDPGScan):
            pg = self.pgs.get(msg.pgid)
            if pg is not None:
                pg.handle_pg_scan(msg)
        elif isinstance(msg, MOSDPGScanReply):
            pg = self.pgs.get(msg.pgid)
            if pg is not None:
                pg.handle_pg_scan_reply(msg)
        elif isinstance(msg, MOSDRepScrub):
            pg = self.pgs.get(msg.pgid)
            if pg is not None:
                pg.handle_rep_scrub(msg)
        elif isinstance(msg, MOSDRepScrubMap):
            pg = self.pgs.get(msg.pgid)
            if pg is not None:
                pg.handle_rep_scrub_map(msg)
        elif isinstance(msg, MOSDPing):
            self._handle_ping(msg)
        else:
            from ..msg.messages import MCommand, MWatchNotify
            if isinstance(msg, MWatchNotify) and \
                    msg.op == MWatchNotify.ACK:
                pg = self.pgs.get(msg.pgid)
                if pg is not None:
                    pg.handle_notify_ack(msg)
            elif isinstance(msg, MCommand):
                self._handle_command(msg)

    def reply_to(self, msg: Message, reply: Message) -> None:
        self.messenger.send_message(reply, msg.src)

    # ---- daemon commands ('ceph tell osd.N', MCommand.h) ------------------
    def _handle_command(self, msg) -> None:
        """Runtime introspection/reconfiguration of THIS live daemon
        over the wire: injectargs (config mutation with observer
        notification), config show/get, perf dump."""
        from ..common.config import g_conf
        from ..msg.messages import MCommandReply
        result, data = g_conf.run_daemon_command(msg.cmd, msg.args, {
            "perf dump": self.perf_counters.dump,
            "dump_ops_in_flight": self.op_tracker.dump_ops_in_flight,
        })
        self.reply_to(msg, MCommandReply(tid=msg.tid, result=result,
                                         data=data))

    # ---- map handling (OSD::handle_osd_map) --------------------------------
    def _handle_osd_map(self, msg: MOSDMap) -> None:
        """Apply and consume epoch by epoch: an interval change inside a
        batch of incrementals (e.g. this osd flapped and the net acting
        set looks unchanged) must still trigger re-peering — the
        reference's same_interval_since check walks every epoch too
        (PG::start_peering_interval)."""
        self.perf_counters.inc(L_OSD_MAP)
        self.dout(7, f"handle_osd_map epochs "
                  f"[{msg.incrementals[0].epoch if msg.incrementals else 0}"
                  f"..{msg.incrementals[-1].epoch if msg.incrementals else 0}]")
        for inc in msg.incrementals:
            if inc.epoch == self.osdmap.epoch + 1:
                was_up = {o for o in range(self.osdmap.max_osd)
                          if self.osdmap.is_up(o)}
                self._persist_incremental(inc)
                self.osdmap.apply_incremental(inc)
                if inc.old_pools:
                    self._purge_deleted_pools(inc.old_pools)
                # a peer newly marked up gets a fresh heartbeat grace and
                # its standing failure report is withdrawn (the
                # reference's send_still_alive cancellation role) —
                # otherwise stale ping state re-reports it instantly
                for o in range(self.osdmap.max_osd):
                    if self.osdmap.is_up(o) and o not in was_up:
                        self.last_ping_reply[o] = self.now
                if self.osd_id < self.osdmap.max_osd and \
                        not self.osdmap.is_up(self.osd_id):
                    # the map says we are down but we are demonstrably
                    # alive: ask to be marked back up, once per epoch
                    # (OSD::_committed_osd_maps "marked down" reboot +
                    # MOSDBoot to the mon)
                    if getattr(self, "_boot_sent_epoch", -1) != \
                            self.osdmap.epoch:
                        self._boot_sent_epoch = self.osdmap.epoch
                        from ..msg.messages import MOSDBoot
                        for mon in self.mon_names:
                            self.messenger.send_message(
                                MOSDBoot(osd=self.osd_id,
                                         epoch=self.osdmap.epoch), mon)
                self._consume_map()

    def _persist_incremental(self, inc) -> None:
        """Store every applied map epoch in the meta collection
        (OSD::handle_osd_map writing inc_osdmap.<e> into coll::meta):
        the on-disk history that lets rebuild-mondb reconstruct a
        LOST mon store from surviving OSDs."""
        from ..msg.wire import encode_blob
        from ..osdmap.encoding import incremental_to_dict
        t = Transaction()
        cid = "meta"
        if not self.store.collection_exists(cid):
            t.create_collection(cid)
        oid = hobject_t(f"inc_osdmap.{inc.epoch}")
        t.touch(cid, oid)
        t.write(cid, oid, 0, encode_blob(incremental_to_dict(inc)))
        self.store.queue_transaction(t)

    def pg_mapping(self, pg_id: Tuple[int, int]
                   ) -> Tuple[List[int], int, List[int], int]:
        """``self.osdmap.pg_to_up_acting_osds`` of ``pg_id``, through
        CRUSH once per PG and epoch.  The map changes only by whole
        epochs (``apply_incremental``), and each epoch asks for every PG
        from ``_consume_map``, each PG's ``advance_map`` and every
        tick's stray scan.  Each call gets lists of its own (the same
        one for up and acting where the map returns one for both)."""
        epoch, memo = self._mapping
        if epoch != self.osdmap.epoch:
            epoch, memo = self._mapping = (self.osdmap.epoch, {})
        got = memo.get(pg_id)
        if got is None:
            got = memo[pg_id] = self.osdmap.pg_to_up_acting_osds(
                pg_t(*pg_id))
        up, upp, acting, actp = got
        u = list(up)
        return u, upp, (u if acting is up else list(acting)), actp

    # ---- stray PG removal (PG RecoveryState::Stray + OSD::_remove_pg) -----
    def _local_pg_collections(self) -> Dict[Tuple[int, int], List[str]]:
        """(pool, ps) -> local collection names, parsed from the store
        (strays can exist with no PG object after a restart)."""
        from ..os_store import parse_pg_from_cid
        out: Dict[Tuple[int, int], List[str]] = {}
        for cid in self.store.list_collections():
            key = parse_pg_from_cid(cid)
            if key is None:
                continue
            out.setdefault(key, []).append(cid)
        return out

    def _report_strays(self) -> None:
        """Notify the current primary about PGs we hold data for but
        no longer serve; it answers MOSDPGRemove once the PG is clean
        (the reference's stray-notify / purged_strays flow)."""
        interval = 5.0
        # gate the whole scan: listing every collection and running a
        # CRUSH mapping per held PG is too much work for every tick
        if self.now - getattr(self, "_stray_scan_at", -1e9) < interval:
            return
        self._stray_scan_at = self.now
        sent = getattr(self, "_stray_notified", None)
        if sent is None:
            sent = self._stray_notified = {}
        for pg_id, cids in self._local_pg_collections().items():
            pool = self.osdmap.pools.get(pg_id[0])
            if pool is None or pg_id[1] >= pool.pg_num:
                continue          # pool gone / unknown: stay conservative
            up, _upp, acting, actp = self.pg_mapping(pg_id)
            members = {o for o in list(up) + list(acting)
                       if o != CRUSH_ITEM_NONE}
            if self.osd_id in members or actp < 0 or \
                    actp == self.osd_id:
                sent.pop(pg_id, None)
                continue
            if self.now - sent.get(pg_id, -1e9) < interval:
                continue
            sent[pg_id] = self.now
            held = sorted({int(cid[cid.rindex("s") + 1:])
                           for cid in cids
                           if not cid.endswith("_meta")
                           and "s" in cid.split(".")[-1]})
            lu = self._stray_high_water(pg_id, cids)
            self.messenger.send_message(MOSDPGNotify(
                pgid=pg_id, epoch=self.osdmap.epoch,
                from_osd=self.osd_id, held_shards=held,
                last_update=lu),
                f"osd.{actp}")

    def _stray_high_water(self, pg_id: Tuple[int, int],
                          cids: List[str]) -> int:
        """Highest version this stray can actually serve: log head attr
        plus stored VERSION_ATTRs.  Pushed objects can be newer than the
        stray's own log (realign/backfill), and the primary's
        keep-or-delete decision compares against what the stray can
        serve — under-reporting could authorize deleting the only newer
        copy (mirror of PG.data_high_water, with the same
        committed_txns-keyed cache: this rescans every notify retry)."""
        cache = getattr(self, "_stray_hw_cache", None)
        if cache is None:
            cache = self._stray_hw_cache = {}
        key = self.store.committed_txns
        hit = cache.get(pg_id)
        if hit is not None and hit[0] == key:
            return hit[1]
        from .pg_log import LAST_UPDATE_ATTR, PG_META_OID, VERSION_ATTR
        lu = 0
        mcid = f"{pg_id[0]}.{pg_id[1]}_meta"
        meta = hobject_t(PG_META_OID)
        if self.store.collection_exists(mcid) and \
                self.store.exists(mcid, meta):
            b = self.store.getattrs(mcid, meta).get(LAST_UPDATE_ATTR)
            if b:
                lu = struct.unpack("<Q", b)[0]
        for cid in cids:
            if cid.endswith("_meta"):
                continue
            for ho in self.store.list_objects(cid):
                vb = self.store.getattrs(cid, ho).get(VERSION_ATTR)
                if vb:
                    lu = max(lu, struct.unpack("<Q", vb)[0])
        cache[pg_id] = (key, lu)
        return lu

    def _handle_pg_notify(self, msg: MOSDPGNotify) -> None:
        """Primary: a stray holds our data; authorize removal only when
        this PG is clean and unpinned — while degraded, the stray may
        yet become a recovery source via choose_acting."""
        pg = self.pgs.get(msg.pgid)
        if pg is None or not pg.is_primary():
            return
        from .pg import STATE_ACTIVE
        if pg.state != STATE_ACTIVE or pg._has_missing() or \
                pg._backfill_pending or \
                getattr(pg, "_realigning", False):
            return
        if pg_t(*msg.pgid) in self.osdmap.pg_temp:
            return
        members = {o for o in list(pg.up) + list(pg.acting)
                   if o != CRUSH_ITEM_NONE}
        if msg.from_osd in members:
            return
        high = pg.data_high_water()
        if msg.last_update > high:
            # the stray holds writes we cannot serve: deleting it would
            # destroy the only newer copy — leave it until this PG
            # catches up (or an operator intervenes)
            self.dout(1, f"pg {tuple(msg.pgid)}: stray osd."
                      f"{msg.from_osd} is NEWER than us "
                      f"({msg.last_update} > {high}); "
                      "refusing removal")
            return
        self.messenger.send_message(MOSDPGRemove(
            pgid=msg.pgid, epoch=self.osdmap.epoch),
            f"osd.{msg.from_osd}")

    def _handle_pg_remove(self, msg: MOSDPGRemove) -> None:
        """Stray: delete the local PG copy — re-checked against OUR
        current map (a newer epoch may have made us a member again)."""
        if msg.epoch > self.osdmap.epoch:
            return                # catch up first; primary will re-ack
        pg_id = tuple(msg.pgid)
        pool = self.osdmap.pools.get(pg_id[0])
        if pool is None or pg_id[1] >= pool.pg_num:
            return
        up, _upp, acting, _actp = self.pg_mapping(pg_id)
        if self.osd_id in {o for o in list(up) + list(acting)
                           if o != CRUSH_ITEM_NONE}:
            return
        n = self._remove_pg_local(pg_id)
        self.dout(3, f"removed stray pg {pg_id} ({n} collections)")

    def next_pull_tid(self) -> int:
        """OSD-level tid (disjoint from per-PG backend counters)."""
        self._pull_tid += 1
        return self._pull_tid

    def get_or_create_pg(self, pg_id: Tuple[int, int]) -> PG:
        if pg_id not in self.pgs:
            self.pgs[pg_id] = PG(self, pg_id,
                                 self.osdmap.pools[pg_id[0]])
        return self.pgs[pg_id]

    def _remove_pg_local(self, pg_id) -> int:
        """Drop one local PG: collections, in-memory object, stray
        bookkeeping (the shared tail of stray removal and pool
        deletion).  Returns collections removed."""
        cids = self._local_pg_collections().get(pg_id, [])
        t = Transaction()
        for cid in cids:
            t.remove_collection(cid)
        if not t.empty():
            self.store.queue_transaction(t)
        self.pgs.pop(pg_id, None)
        getattr(self, "_stray_notified", {}).pop(pg_id, None)
        return len(cids)

    def _purge_deleted_pools(self, pool_ids) -> None:
        """Drop PGs + store collections of explicitly deleted pools
        (PG::on_removal on the pool-deletion epoch).  Driven ONLY by
        incrementals' old_pools — absence from the map is not evidence
        of deletion (a booting OSD briefly holds an empty map while
        its store is full of live data)."""
        gone = set(pool_ids)
        if not gone:
            return
        doomed_ids = set(p for p in self.pgs if p[0] in gone) | \
            set(p for p in self._local_pg_collections() if p[0] in gone)
        for pg_id in doomed_ids:
            self._remove_pg_local(pg_id)

    def _consume_map(self) -> None:
        # instantiate PGs this osd serves
        for pool_id, pool in self.osdmap.pools.items():
            for ps in range(pool.pg_num):
                pg_id = (pool_id, ps)
                up, upp, acting, actp = self.pg_mapping(pg_id)
                # up-but-not-acting members (pg_temp pinned elsewhere)
                # must exist too: they receive the realign/backfill
                # pushes that let the pin clear
                member = self.osd_id in [o for o in list(acting) +
                                         list(up)
                                         if o != CRUSH_ITEM_NONE]
                if member:
                    self.get_or_create_pg(pg_id)
        # pg_num grew past a local layout's record: split before any PG
        # advances (OSD::split_pgs) — including layouts held WITHOUT
        # membership: an OSD down through the split epoch can be
        # remapped off the parent yet still serve a child, and its
        # stranded objects must reach the child collections (stray
        # removal would otherwise delete them with the parent)
        from .pg import stored_pg_num_of
        for pg_id in set(self._local_pg_collections()) | set(self.pgs):
            pool = self.osdmap.pools.get(pg_id[0])
            if pool is None or pg_id[1] >= pool.pg_num:
                continue
            pg = self.pgs.get(pg_id)
            known = pg.known_pg_num if pg is not None else \
                (stored_pg_num_of(self.store, pg_id) or pool.pg_num)
            if known < pool.pg_num:
                self.get_or_create_pg(pg_id).split_children()
        # advance all (children included)
        for pg_id in list(self.pgs):
            self.pgs[pg_id].advance_map(self.osdmap)

    # ---- client ops -------------------------------------------------------
    def _admit_op(self, msg: MOSDOp) -> bool:
        """Overload admission control (docs/QOS.md): once the op-queue
        depth crosses ``osd_op_queue_admission_max``, new CLIENT ops
        are shed with an EAGAIN + retry_after reply instead of growing
        the queue unboundedly.  A shed client stays throttled — a
        depth-hysteresis window (plus an optional wall-clock window) —
        until the queue drains below half the cap, so one abusive
        client's replays cannot re-fill the queue the instant a slot
        opens.  Internal clients (tier ops from other OSDs, daemons)
        are exempt: an EAGAIN loop inside the cluster would be a
        livelock, not backpressure."""
        from ..common.config import g_conf
        admission_max = int(
            g_conf.get_val("osd_op_queue_admission_max") or 0)
        if admission_max <= 0 or not msg.src.startswith("client"):
            return True
        qos = qos_perf_counters()
        depth = len(self.op_wq)
        qos.set(l_qos_queue_depth, depth)
        low_water = max(1, admission_max // 2)
        if len(self._throttled_clients) > 64 and depth < low_water:
            # opportunistic prune under entity churn — same condition
            # as the per-client clear below, applied to clients that
            # never came back (their windows would otherwise pin map
            # entries forever)
            # throttle windows are wall seconds BY CONTRACT:
            # retry_after is handed to real clients on real
            # sockets (QoS wall mode)
            now = time.monotonic()  # lint: allow[no-wall-clock]
            self._throttled_clients = {
                c: u for c, u in self._throttled_clients.items()
                if u > now}
        until = self._throttled_clients.get(msg.src)
        shed = depth >= admission_max or (
            until is not None and
            (depth >= low_water  # lint: allow[no-wall-clock]
             or time.monotonic() < until))
        if not shed:
            if until is not None:
                del self._throttled_clients[msg.src]
            return True
        window = float(g_conf.get_val("osd_op_queue_throttle_window"))
        if until is None:
            # first shed for this client: open its throttle window
            # (never re-extended on replays, or a retrying client
            # could be starved forever in wall mode)
            qos.inc(l_qos_throttle_events)
            self._throttled_clients[msg.src] = \
                time.monotonic() + window  # lint: allow[no-wall-clock]
        qos.inc(l_qos_admission_rejections)
        self.messenger.send_message(MOSDOpReply(
            tid=msg.tid, result=-11, epoch=self.osdmap.epoch,
            retry_after=max(window, 1e-3)), msg.src)
        return False

    def _handle_op(self, msg: MOSDOp) -> None:
        """Client op intake: lands in the sharded op queue (one PG's
        ops stay FIFO in their shard, OSD.cc ShardedOpWQ) and drains
        through the mClock arbiter — under bursts, QoS decides order.
        The client-tier dmClock lane is keyed by the sending entity
        (msg.src), so one abusive client cannot starve the rest."""
        # stage ledger: adopt the client's submit stamp (client_flight)
        # or open one here; the admission verdict is the next boundary
        led = intake_ledger(msg, self.name)
        if not self._admit_op(msg):
            return
        led.mark("admission")
        is_write = msg.op in ("write", "writefull", "append", "delete") \
            or any(o.op in ("write", "writefull", "append", "delete")
                   for o in msg.ops)
        self.perf_counters.inc(L_OSD_OP_W if is_write else L_OSD_OP_R)
        op = self.op_tracker.create_request(
            msg.trace_id, f"osd_op({msg.op} {msg.pool}/{msg.oid})")
        op.mark_event("queued_for_pg")
        # latency x bytes accounting resolved at reply time
        op.is_write = is_write
        op.num_bytes = len(msg.data) + sum(len(o.data) for o in msg.ops)
        op.queued_at = time.perf_counter()
        if g_tracer.enabled:
            # child of the client's root span; activated around do_op so
            # EC encode / kernel spans attach below it
            op.span = g_tracer.begin(
                f"osd_op:{msg.op or 'vector'}:{msg.oid}",
                daemon=self.name, trace_id=msg.trace_id,
                parent_id=msg.parent_span_id)
            if led.span is None:
                # no client-side root (tracing enabled after submit /
                # TCP arrival): the stage ledger rides the OSD's span
                led.span = op.span
        op.oplat = led
        self._tracked[(msg.src, msg.tid)] = op
        self.op_wq.enqueue(msg.pgid, CLASS_CLIENT, ("op", msg),
                           client=msg.src)
        from ..common.config import g_conf
        if bool(g_conf.get_val("osd_op_queue_batch_intake")):
            # burst intake (the traffic harness's mode): leave the op
            # queued so one fabric pump's worth of concurrent client
            # traffic accumulates and the mClock tiers arbitrate a REAL
            # burst; workers (threaded) or the cluster idle kick
            # (synchronous) drain at quiescence
            if self.op_tp is not None:
                self.op_tp.kick()
            return
        self.drain_ops()

    def drain_ops(self, max_ops: int = 0) -> int:
        if self.op_tp is not None:
            # workers drain concurrently; block until handled so the
            # in-process fabric's pump loops keep their semantics
            self.op_tp.flush()
            return 0
        return self.op_wq.drain(self._wq_handle, max_ops)

    def _wq_handle_locked(self, item) -> None:
        """Thread-pool handler: serialize per PG via its DebugLock (the
        reference's pg->lock() in dequeue_op, OSD.cc:9262)."""
        kind = item[0]
        if kind == "op":
            pg = self.pgs.get(item[1].pgid)
        else:
            pg = item[1]
        if pg is not None:
            with pg.op_lock:
                self._wq_handle(item)
        else:
            self._wq_handle(item)

    def _wq_handle(self, item) -> None:
        kind = item[0]
        if kind == "op":
            msg = item[1]
            pg = self.pgs.get(msg.pgid)
            if pg is None:
                self.send_op_reply(msg.src, MOSDOpReply(
                    tid=msg.tid, result=-11, epoch=self.osdmap.epoch))
                return
            tracked = self._tracked.get((msg.src, msg.tid))
            if tracked is not None:
                tracked.mark_event("reached_pg")
                t0 = getattr(tracked, "queued_at", None)
                if t0 is not None and msg.src:
                    # per-client queue-wait distribution (intake ->
                    # dequeue): the dmClock tier's effect made visible
                    # per entity on perf dump + mgr Prometheus
                    g_perf_histograms.get(
                        self._client_hist_lane(msg.src),
                        "client_queue_wait_latency_histogram",
                        latency_axes).inc(
                            (time.perf_counter() - t0) * 1e6)
            led = getattr(msg, "_oplat", None)
            if led is not None:
                # op-thread start: the interval since the lane pop is
                # the dequeue handoff (thread wakeup / shard transit)
                led.mark("dequeue_handoff")
            if tracked is not None and tracked.span is not None:
                with g_tracer.activate(tracked.span), \
                        g_oplat.activate(led):
                    pg.do_op(msg)
            else:
                with g_oplat.activate(led):
                    pg.do_op(msg)
        elif kind == "scrub":
            item[1].start_scrub(deep=item[2] if len(item) > 2 else False)
        elif kind == "pipeline":
            # deferred EC write-pipeline continuation (fan-out under
            # the PG lock — _wq_handle_locked took it via item[1])
            item[2]()
        elif kind == "recovery":
            # a repair round admitted by the recovery scheduler: it
            # reached here through the CLASS_RECOVERY dmClock lane, so
            # client vs repair ordering was the arbiter's call
            item[2]()

    def _client_hist_lane(self, src: str) -> str:
        if src in self._client_hist_lanes:
            return src
        if len(self._client_hist_lanes) >= 64:
            return "client.other"
        self._client_hist_lanes.add(src)
        return src

    def send_op_reply(self, dst: str, reply: MOSDOpReply) -> None:
        """All client replies funnel here so op tracking/latency see them."""
        op = self._tracked.pop((dst, reply.tid), None)
        if op is not None:
            op.mark_event("commit_sent" if reply.result == 0 else "error")
            led = getattr(op, "oplat", None)
            if led is not None:
                # the ledger's final boundary: everything since the
                # last mark (ack gathering's tail, reply build) is the
                # reply stage, and the op counts as fully accounted
                led.mark("reply")
                g_oplat.note_op()
            if op.span is not None:
                g_tracer.finish(op.span)
            op.finish()
            self.perf_counters.tinc(L_OSD_OP_LAT, op.duration)
            if getattr(op, "is_write", False):
                # write axis: payload bytes captured at intake
                self.hist_op_w.inc(op.duration * 1e6,
                                   getattr(op, "num_bytes", 0))
            else:
                # read axis: OUT bytes (reads carry no payload in; the
                # reference's op_r histogram also sizes by outdata).
                # Vector replies duplicate the last per-op payload into
                # reply.data, so count op_results OR data, never both
                out_bytes = sum(len(d) for _r, d in reply.op_results) \
                    if reply.op_results else len(reply.data)
                self.hist_op_r.inc(op.duration * 1e6, out_bytes)
        self.messenger.send_message(reply, dst)

    # ---- shard sub-ops ----------------------------------------------------
    def _handle_sub_write(self, msg: MOSDECSubOpWrite) -> None:
        self.perf_counters.inc(L_OSD_SUBOP_W)
        if g_tracer.enabled and msg.parent_span_id:
            with g_tracer.span(f"sub_write:s{msg.shard}",
                               daemon=self.name, trace_id=msg.trace_id,
                               parent_id=msg.parent_span_id):
                self._do_handle_sub_write(msg)
        else:
            self._do_handle_sub_write(msg)

    def _do_handle_sub_write(self, msg: MOSDECSubOpWrite) -> None:
        if msg.snapset_only:
            pg = self.pgs.get(msg.pgid)
            if pg is not None and msg.snapset_update is not None:
                t = Transaction()
                pg.apply_snapset_update(tuple(msg.snapset_update), t)
                self.store.queue_transaction(t)
                if msg.tid:
                    # acked fan-out (docs/ROBUSTNESS.md "unacked
                    # write-path classes"): a replayed snapset update
                    # is a full-blob replacement, so re-applying is
                    # idempotent — ack unconditionally
                    self.reply_to(msg, MOSDECSubOpWriteReply(
                        tid=msg.tid, pgid=msg.pgid, shard=msg.shard))
            return
        if msg.at_version < 0:  # delete marker
            self._apply_delete(msg)
            return
        pg = self.pgs.get(msg.pgid)
        if msg.shard < 0:
            # replicated full-copy write
            if pg is not None and pg.rep_backend is not None:
                pg.rep_backend.apply_write(msg, self.store)
                if msg.is_push and msg.tid:
                    # realign pushes are acked so the sender clears
                    # the pg_temp pin only once the copy is durable
                    self.messenger.send_message(MOSDECSubOpWriteReply(
                        tid=msg.tid, pgid=msg.pgid, shard=-1), msg.src)
            return
        if pg is not None and pg.backend is not None:
            reply = pg.backend.handle_sub_write(msg, self.store, pg=pg)
            self.reply_to(msg, reply)

    def _apply_delete(self, msg: MOSDECSubOpWrite) -> None:
        if msg.shard < 0:
            cid = f"{msg.pgid[0]}.{msg.pgid[1]}"
            ho = hobject_t(msg.oid)
        else:
            cid = f"{msg.pgid[0]}.{msg.pgid[1]}s{msg.shard}"
            ho = hobject_t(msg.oid, msg.shard)
        pg = self.pgs.get(msg.pgid)
        if msg.tid and pg is not None and msg.version:
            # resend dedup (tid-carrying client-delete fan-outs only —
            # recovery delete fans keep tid 0 and may legitimately
            # arrive with the log entry already merged): our log holds
            # this delete, so the original apply landed and only the
            # ack was lost.  Re-applying would overwrite the rollback
            # stash with post-delete state; just re-ack.  Versions
            # append monotonically, so scan from the tail and stop at
            # the first older entry — first arrivals pay O(1).
            for e in reversed(pg.pg_log.entries):
                if e.version < msg.version:
                    break
                if e.version == msg.version and e.oid == msg.oid:
                    self.reply_to(msg, MOSDECSubOpWriteReply(
                        tid=msg.tid, pgid=msg.pgid, shard=msg.shard))
                    return
        t = Transaction()
        if pg is not None and pg.backend is not None and msg.version:
            # EC shards stash the pre-delete state like writes do, so a
            # delete that reached too few shards can be rolled back
            from .ec_backend import stash_pre_write_state
            stash_pre_write_state(t, self.store, pg, msg.oid, cid, ho,
                                  msg.version)
        if self.store.collection_exists(cid):
            t.remove(cid, ho)
        if pg is not None and msg.version:
            pg.append_log(LogEntry(msg.version, msg.oid, OP_DELETE), t)
        if not t.empty():
            self.store.queue_transaction(t)
        if pg is not None:
            pg.data_received(msg.oid)  # debt settled: object is gone
        if msg.tid:
            self.reply_to(msg, MOSDECSubOpWriteReply(
                tid=msg.tid, pgid=msg.pgid, shard=msg.shard))

    def _handle_sub_read(self, msg: MOSDECSubOpRead) -> None:
        self.perf_counters.inc(L_OSD_SUBOP_R)
        if g_tracer.enabled and msg.parent_span_id:
            with g_tracer.span(f"sub_read:s{msg.shard}",
                               daemon=self.name, trace_id=msg.trace_id,
                               parent_id=msg.parent_span_id):
                self._do_handle_sub_read(msg)
        else:
            self._do_handle_sub_read(msg)

    def _do_handle_sub_read(self, msg: MOSDECSubOpRead) -> None:
        pg = self.pgs.get(msg.pgid)
        if pg is None:
            self.reply_to(msg, MOSDECSubOpReadReply(
                tid=msg.tid, pgid=msg.pgid, shard=msg.shard, oid=msg.oid,
                result=-11))
            return
        if msg.shard < 0:
            # replicated full-object read (recovery pulls)
            if pg.rep_backend is not None:
                exists, data, uattrs, omap = \
                    pg.rep_backend.object_state(msg.oid)
            else:
                exists = False
            if not exists:
                self.reply_to(msg, MOSDECSubOpReadReply(
                    tid=msg.tid, pgid=msg.pgid, shard=-1, oid=msg.oid,
                    result=-2))
            else:
                from .ec_backend import USER_ATTR_PREFIX
                attrs = {SIZE_ATTR: struct.pack("<Q", len(data))}
                for k, v in uattrs.items():
                    attrs[USER_ATTR_PREFIX + k] = v
                # omap rides the attr dict under a reserved key (the
                # reference pushes omap in its own push payload section)
                if omap:
                    from ..msg.kv import pack_kv
                    attrs["_omap_kv"] = pack_kv(omap)
                self.reply_to(msg, MOSDECSubOpReadReply(
                    tid=msg.tid, pgid=msg.pgid, shard=-1, oid=msg.oid,
                    data=data, result=0, attrs=attrs))
            return
        if pg.backend is not None:
            reply = pg.backend.handle_sub_read(msg, self.store)
            self.reply_to(msg, reply)

    # ---- heartbeats / failure detection -----------------------------------
    def tick(self, now: float) -> None:
        """Heartbeat tick: ping peers, report silent ones to the mon."""
        self.now = now
        # flush EC dispatch batches whose collection window expired
        # (async submitters without a result() demand rely on this)
        from ..dispatch import g_dispatcher
        g_dispatcher.poll()
        # the JAX package kicks its mesh's chip-health probe here; the
        # port has no mesh until ROADMAP Queue 1 item 7
        peers = [o for o in range(self.osdmap.max_osd)
                 if o != self.osd_id and self.osdmap.is_up(o)]
        for peer in peers:
            self.messenger.send_message(
                MOSDPing(op=MOSDPing.PING, stamp=now,
                         epoch=self.osdmap.epoch), f"osd.{peer}")
        self.maybe_schedule_scrubs()
        self._report_strays()
        self.report_pg_stats()
        # drain repair rounds parked by pacing (slots may have freed
        # outside the completion path, e.g. a fallback round)
        self.recovery_sched.kick()
        # map says down but we are alive: keep asking back in every tick
        # (the reference's OSD::start_boot retries; a single send can be
        # lost while connections re-establish after a daemon reboot)
        if 0 <= self.osd_id < self.osdmap.max_osd and \
                self.osdmap.epoch > 0 and \
                not self.osdmap.is_up(self.osd_id):
            from ..msg.messages import MOSDBoot
            for mon in self.mon_names:
                self.messenger.send_message(
                    MOSDBoot(osd=self.osd_id, epoch=self.osdmap.epoch),
                    mon)
        # sweep probe callbacks whose replies died with their peer
        for tid in [t for t, t0 in self._rep_pull_stamps.items()
                    if now - t0 > 60.0]:
            self._rep_pull_stamps.pop(tid, None)
            self._rep_pulls.pop(tid, None)
        if self.op_tp is None and self.op_wq.wall and len(self.op_wq):
            # synchronous wall-clock mode: rate-blocked ops queued with
            # no worker threads must be re-driven from the tick, or a
            # pause in client traffic strands them forever
            self.drain_ops()
        for pg in self.pgs.values():
            if pg._notifies:
                pg.sweep_notifies()
            pg.retry_pending_pg_temp()
            pg.retry_peering()
            if pg.backend is not None and pg.backend.inflight_writes:
                # in-flight sweep: resend unacked EC sub-op writes so a
                # messenger-level drop cannot wedge the per-oid write
                # pipeline until peering (docs/ROBUSTNESS.md)
                pg.backend.sweep_inflight(now)
            pg.maybe_realign()
            if pg.tier is not None and pg.is_primary():
                pg.tier.agent_work(now)
            # stuck recoveries (reply chain lost to a map race or a
            # mid-flight death): forget and re-drive them
            stale = [oid for oid, t0 in pg._recovering_since.items()
                     if now - t0 > RECOVERY_RETRY]
            for oid in stale:
                pg._recovering_since.pop(oid, None)
                if oid in pg._recovering:
                    self.dout(3, f"recovery of {oid} pg {pg.pgid} "
                              "stalled; re-kicking")
                    pg._recovering.discard(oid)
                    self.request_recovery(pg)
        # tier ops whose reply never came (base primary died, message
        # lost): fail them so promotes/flushes unwind and retry
        with self._tier_lock:
            expired = [(tid, ent) for tid, ent in self._tier_ops.items()
                       if now - ent[1] > RECOVERY_RETRY]
            for tid, _ent in expired:
                del self._tier_ops[tid]
        for tid, (cb, _t0) in expired:
            cb(MOSDOpReply(tid=tid, result=-110))
        for peer in peers:
            last = self.last_ping_reply.get(peer, now)
            self.last_ping_reply.setdefault(peer, now)
            if now - last > HEARTBEAT_GRACE:
                self.dout(1, f"heartbeat: no reply from osd.{peer} "
                          f"since {last:.1f}, reporting failure")
                # keep re-sending while the peer stays silent: the mon
                # leadership may change mid-outage and a one-shot report
                # to a dead leader would blind failure detection (the
                # reference OSD also re-reports until the mark)
                for mon in self.mon_names:
                    self.messenger.send_message(
                        MOSDFailure(target_osd=peer, failed_since=last,
                                    epoch=self.osdmap.epoch,
                                    reporter=self.name), mon)

    def report_pg_stats(self, mgr_name: str = "mgr",
                        every: int = 5) -> None:
        """Primary PGs report object counts + logical bytes to the mgr
        (MPGStats / MgrClient role); the network drops the send when no
        mgr exists.  Logical size comes from SIZE_ATTR (un-padded), so
        replicated and EC pools account the same bytes.  The store scan
        is O(objects), so it runs every ``every``-th tick (the
        reference's mgr_stats_period), starting with the first."""
        self._stats_tick = getattr(self, "_stats_tick", -1) + 1
        if every > 1 and self._stats_tick % every:
            return
        from ..msg.messages import MPGStats
        from .ec_backend import SIZE_ATTR
        from .pg_log import PG_META_OID
        stats = []
        for pgid, pg in self.pgs.items():
            if not pg.is_primary():
                continue
            cids = pg.data_cids()
            n_obj = n_bytes = 0
            for cid in cids:
                if not self.store.collection_exists(cid):
                    continue
                for ho in self.store.list_objects(cid):
                    if ho.oid == PG_META_OID:
                        continue
                    n_obj += 1
                    sz = self.store.getattrs(cid, ho).get(SIZE_ATTR)
                    if sz is not None:
                        n_bytes += struct.unpack("<Q", sz)[0]
                    else:
                        n_bytes += self.store.stat(cid, ho)
            stats.append((pgid[0], pgid[1], n_obj, n_bytes))
        # osd_stat_t role: total logical bytes on this OSD's primary
        # PGs against the configured capacity.  Sent even when the
        # stats list is empty — an OSD whose primaries all moved away
        # must not leave its last (possibly full) usage pinned at the
        # mgr.  Replica-only bytes are invisible to this logical
        # accounting — a known lite-ism.
        from ..common.config import g_conf
        capacity = int(g_conf.get_val("osd_capacity_bytes") or 0)
        total = sum(b for (_p, _s, _o, b) in stats)
        self.messenger.send_message(MPGStats(
            osd=self.osd_id, epoch=self.osdmap.epoch,
            pg_stats=stats, store_bytes=total,
            store_capacity=capacity), mgr_name)

    def clog(self, level: str, message: str) -> None:
        """Send a cluster-log entry to the mons (clog->error()/info()
        role).  Every mon gets a copy, like the failure-report loop
        above — a single-target send dies with that mon.  Peons forward
        to the leader, which dedups identical (stamp, who, message)
        arrivals so the fan-out still commits exactly once."""
        from ..msg.messages import MLog
        for mon in self.mon_names:
            self.messenger.send_message(MLog(
                who=self.name, level=level, message=message,
                stamp=self.now), mon)

    def maybe_schedule_scrubs(self) -> None:
        """Periodic background scrub scheduling (the OSD's scrub
        scheduler role, OSD.cc sched_scrub): each primary PG scrubs
        every osd_scrub_min_interval seconds, staggered per PG so a
        whole cluster never scrubs at one instant (the reference
        randomizes with osd_scrub_interval_randomize_ratio)."""
        from ..common.config import g_conf
        if not g_conf.get_val("osd_scrub_auto"):
            return
        interval = float(g_conf.get_val("osd_scrub_min_interval"))
        deep_interval = float(g_conf.get_val("osd_deep_scrub_interval"))
        for pg in self.pgs.values():
            if not pg.is_primary():
                continue
            frac = (hash(pg.pgid) % 997) / 997.0
            stagger = frac * interval * 0.1
            # a due shallow scrub is upgraded to deep when the (longer)
            # deep interval has also lapsed — the reference's
            # sched_scrub deep-upgrade decision.  The deep stagger
            # scales with ITS interval: data-reading scrubs are the
            # ones that must not all fire in one tick
            deep = (self.now - pg.last_deep_scrub_stamp
                    >= deep_interval + frac * deep_interval * 0.1)
            if deep or self.now - pg.last_scrub_stamp >= \
                    interval + stagger:
                self.dout(5, f"sched_scrub pg {pg.pgid}"
                             f"{' (deep)' if deep else ''}")
                # start_scrub stamps on an ACTUAL start; a PG that is
                # peering right now simply retries next tick
                self.op_wq.enqueue(pg.pgid, CLASS_SCRUB,
                                   ("scrub", pg, deep))
        self.drain_ops()

    def _handle_ping(self, msg: MOSDPing) -> None:
        if msg.op == MOSDPing.PING:
            self.messenger.send_message(
                MOSDPing(op=MOSDPing.PING_REPLY, stamp=msg.stamp,
                         epoch=self.osdmap.epoch), msg.src)
        else:
            peer = int(msg.src.split(".")[1])
            self.last_ping_reply[peer] = self.now
        if msg.epoch > self.osdmap.epoch:
            # a peer runs a newer map than ours — our MOSDMap delivery
            # was lost (droppable fabric): re-subscribe for the full
            # history (OSD::osdmap_subscribe on a detected gap).
            # Rate-limited by time, not epoch, so a lost subscribe or
            # reply just retries on the next heartbeat round.
            if self.now - getattr(self, "_map_catchup_at", -1e9) > 2.0:
                self._map_catchup_at = self.now
                from ..msg.messages import MMonSubscribe
                for mon in self.mon_names:
                    self.messenger.send_message(MMonSubscribe(), mon)

    # ---- tier client (Objecter-lite for promote/flush) ---------------------
    def tier_submit(self, pool_id: int, oid: str, ops,
                    on_reply: Callable) -> None:
        """Send an op vector to *pool_id*'s primary on this OSD's own
        behalf (the cache PG acting as a client of its base pool —
        PrimaryLogPG's copy-from/flush ops role).  An unreachable or
        unanswering target fails the op via the tick timeout sweep so
        callers never park forever."""
        from ..osdmap.types import ceph_stable_mod
        pool = self.osdmap.get_pg_pool(pool_id)
        primary = -1
        ps = 0
        if pool is not None:
            raw = self.osdmap.map_to_pg(pool_id, oid)
            ps = ceph_stable_mod(raw.ps, pool.pg_num, pool.pg_num_mask)
            *_, _acting, primary = self.osdmap.pg_to_up_acting_osds(
                pg_t(pool_id, ps))
        if pool is None or primary < 0:
            # park the failure for the next tick sweep: failing INLINE
            # would recurse promote -> tier_submit -> promote with no
            # base case while the target stays unreachable
            with self._tier_lock:
                self._tier_tid += 1
                self._tier_ops[self._tier_tid] = (
                    on_reply, self.now - RECOVERY_RETRY - 1.0)
            return
        with self._tier_lock:
            self._tier_tid += 1
            tid = self._tier_tid
            self._tier_ops[tid] = (on_reply, self.now)
        self.messenger.send_message(
            MOSDOp(tid=tid, pool=pool_id, oid=oid, pgid=(pool_id, ps),
                   epoch=self.osdmap.epoch, ops=list(ops)),
            f"osd.{primary}")

    # ---- recovery (message-driven; ECBackend.cc:535-743) -------------------
    def request_recovery(self, pg: PG) -> None:
        if pg not in self._recovery_queue:
            self._recovery_queue.append(pg)

    def run_recovery(self) -> int:
        """Drive queued PG recovery; returns recoveries initiated.  All
        data movement is messages; completions chain through the fabric."""
        started = 0
        queue, self._recovery_queue = self._recovery_queue, []
        for pg in queue:
            started += self._continue_pg_recovery(pg)
        return started

    def _continue_pg_recovery(self, pg: PG) -> int:
        if not pg.is_primary():
            return 0
        started = 0
        # own shard first: the primary's store must become authoritative
        # before backfill diffs use it
        my = pg.my_shard()
        shards = sorted(pg.missing, key=lambda s: (s != my, s))
        for shard in shards:
            for oid in list(pg.missing.get(shard, {})):
                if oid not in pg._recovering:
                    self.recover_oid(pg, oid)
                    started += 1
        return started

    def recover_oid(self, pg: PG, oid: str) -> None:
        """Recover one object on every shard missing it."""
        if oid in pg._recovering:
            return
        targets = {s: pg.missing[s][oid]
                   for s in pg.missing if oid in pg.missing[s]}
        if not targets:
            pg.recovery_done_for(oid)
            return
        pg._recovering.add(oid)
        pg._recovering_since[oid] = self.now
        self.dout(5, f"recover_oid {oid} pg {pg.pgid} "
                  f"targets {sorted(targets)}", )
        if all(op == OP_DELETE for (_v, op) in targets.values()):
            for s, (v, _op) in targets.items():
                osd = pg.acting_shards().get(s)
                if osd is not None:
                    pg.send_to_osd(osd, MOSDECSubOpWrite(
                        tid=0, pgid=pg.pgid,
                        shard=s if pg.backend is not None else -1,
                        oid=oid, chunk=b"", at_version=-1, version=v))
                pg.missing[s].pop(oid, None)
            pg.recovery_done_for(oid)
            return
        if pg.backend is not None:
            self._recover_ec_oid(pg, oid, targets)
        else:
            self._recover_rep_oid(pg, oid, targets)

    def _recover_ec_oid(self, pg: PG, oid: str,
                        targets: Dict[int, Tuple[int, str]]) -> None:
        needed = sorted(s for s, (_v, op) in targets.items()
                        if op != OP_DELETE)
        # probe phase: a "missing" peer may already hold the object at
        # the target version — the primary's log-delta cannot see data
        # that landed ahead of the log entries (realign pushes,
        # interrupted prior recoveries).  A version-matching reply
        # settles the debt without moving bytes; mismatches fall
        # through to the decode+push path.
        from .pg_log import VERSION_ATTR
        acting = pg.acting_shards()
        probes = [s for s in needed
                  if s in acting and self.osdmap.is_up(acting[s])]
        state = {"left": len(probes)}
        # generation guard: replies from a SUPERSEDED probe round (the
        # recovery was re-kicked after RECOVERY_RETRY) must not run
        # after_probes a second time concurrently with the new round
        generation = pg._recovering_since.get(oid)

        def current() -> bool:
            return pg._recovering_since.get(oid) == generation

        def after_probes() -> None:
            remaining = sorted(s for s in needed
                               if oid in pg.missing.get(s, {}))
            if not remaining:
                for s in needed:
                    if not pg.missing.get(s):
                        pg.send_backfill_complete(s)
                pg.recovery_done_for(oid)
                pg._maybe_clean()
                return
            self._recover_ec_oid_push(pg, oid, targets, remaining)

        if not probes:
            self._recover_ec_oid_push(pg, oid, targets, needed)
            return
        for s in probes:
            v_expect = targets[s][0]
            tid = self.next_pull_tid()

            def on_probe(reply, s=s, v_expect=v_expect) -> None:
                if not current():
                    return              # superseded round's late reply
                vb = reply.attrs.get(VERSION_ATTR) \
                    if reply.result == 0 and reply.oid == oid \
                    and reply.shard == s else None
                if vb is not None and \
                        struct.unpack("<Q", vb)[0] >= v_expect:
                    pg.missing.get(s, {}).pop(oid, None)
                state["left"] -= 1
                if state["left"] == 0:
                    after_probes()
            self._rep_pulls[tid] = on_probe
            self._rep_pull_stamps[tid] = self.now
            pg.send_to_osd(acting[s], MOSDECSubOpRead(
                tid=tid, pgid=pg.pgid, shard=s, oid=oid,
                attrs_only=True))

    def _recover_ec_oid_push(self, pg: PG, oid: str,
                             targets: Dict[int, Tuple[int, str]],
                             needed) -> None:
        # repair-optimal path first (recovery/): a single lost
        # shard of a regenerating-code pool rebuilds from d sub-chunk
        # helper contributions instead of k whole chunks; the scheduler
        # owns pacing/QoS/accounting and falls back here on any failure
        if self.recovery_sched.try_repair(pg, oid, targets,
                                          list(needed)):
            return
        self._recover_ec_oid_fullstripe(pg, oid, targets, needed)

    def _recover_ec_oid_fullstripe(self, pg: PG, oid: str,
                                   targets: Dict[int, Tuple[int, str]],
                                   needed) -> None:
        be = pg.backend

        def on_chunks(result: int, chunks: Dict[int, bytes],
                      size: int, attrs: Dict[str, bytes]) -> None:
            if result != 0:
                # sources unavailable right now; retry on the next kick
                pg._recovering.discard(oid)
                self.request_recovery(pg)
                return
            self.recovery_sched.note_fullstripe(
                be.ec_impl, sum(len(b) for b in chunks.values()),
                len(needed))
            rec = be.recover_object(oid, set(needed), chunks, size)
            version = max(v for (v, _op) in targets.values())

            def pushed() -> None:
                self.dout(5, f"recovery push of {oid} acked by "
                          f"{sorted(needed)}")
                for s in needed:
                    pg.missing.get(s, {}).pop(oid, None)
                    if not pg.missing.get(s):
                        pg.send_backfill_complete(s)
                self.perf_counters.inc(L_OSD_RECOVERY_PUSH, len(needed))
                pg.recovery_done_for(oid)

            self.dout(5, f"recovery pushing {oid} -> shards "
                      f"{sorted(needed)} acting {pg.acting}")
            self.recovery_sched.note_push(
                sum(len(rec[s]) for s in needed))
            be.push_chunks(oid, {s: rec[s] for s in needed}, size, pushed,
                           version=version, xattrs=attrs)

        be.read_chunks(oid, on_chunks)

    def _recover_rep_oid(self, pg: PG, oid: str,
                         targets: Dict[int, Tuple[int, str]]) -> None:
        data = pg.rep_backend.read(oid)
        my = pg.my_shard()
        if data is not None and my not in targets:
            # our copy is current (we are not in the missing set)
            self._push_rep(pg, oid, data, targets)
            return
        # primary lacks its own copy — or holds a STALE one (it is in
        # targets): pushing local bytes would resurrect pre-flap data,
        # so pull the authoritative copy from a healthy peer first
        srcs = [s for s, osd in pg.acting_shards().items()
                if s not in targets and osd != self.osd_id]
        if not srcs:
            pg._recovering.discard(oid)
            return
        self._pull_tid += 1
        tid = self._pull_tid

        def on_pull(msg: MOSDECSubOpReadReply) -> None:
            if msg.result != 0:
                pg._recovering.discard(oid)
                self.request_recovery(pg)
                return
            # apply locally, then fan to the other missing shards
            my = pg.my_shard()
            v = targets.get(my, (0, ""))[0]
            uattrs, omap = _unpack_pull_meta(msg.attrs)
            wr = MOSDECSubOpWrite(tid=0, pgid=pg.pgid, shard=-1, oid=oid,
                                  chunk=msg.data, offset=0, partial=False,
                                  at_version=len(msg.data), version=v,
                                  is_push=True, xattrs=uattrs, omap=omap)
            pg.rep_backend.apply_write(wr, self.store)
            pg.missing.get(my, {}).pop(oid, None)
            rest = {s: t for s, t in targets.items() if s != my}
            self._push_rep(pg, oid, msg.data, rest,
                           xattrs=uattrs, omap=omap)

        self._rep_pulls[tid] = on_pull
        # stamped like the probe path: the sweep in tick() reaps this
        # closure if the source dies before replying
        self._rep_pull_stamps[tid] = self.now
        pg.send_to_osd(pg.acting_shards()[srcs[0]], MOSDECSubOpRead(
            tid=tid, pgid=pg.pgid, shard=-1, oid=oid))

    def _push_rep(self, pg: PG, oid: str, data: bytes,
                  targets: Dict[int, Tuple[int, str]],
                  xattrs: Optional[Dict[str, bytes]] = None,
                  omap: Optional[Dict[str, bytes]] = None) -> None:
        if xattrs is None and pg.rep_backend is not None:
            # pushing our own authoritative copy: include its metadata
            _ex, _d, xattrs, omap = pg.rep_backend.object_state(oid)
        acting = pg.acting_shards()
        for s, (v, _op) in targets.items():
            osd = acting.get(s)
            if osd is None or osd == self.osd_id:
                continue
            pg.send_to_osd(osd, MOSDECSubOpWrite(
                tid=0, pgid=pg.pgid, shard=-1, oid=oid, chunk=data,
                offset=0, partial=False, at_version=len(data),
                version=v, is_push=True, xattrs=xattrs, omap=omap))
            self.perf_counters.inc(L_OSD_RECOVERY_PUSH)
        for s in list(targets):
            pg.missing.get(s, {}).pop(oid, None)
        # NOTE: no send_backfill_complete here — rep pushes are
        # fire-and-forget (no ack path), so adopting the log now could
        # mask a lost push as a complete replica.  A log-less rep
        # target is merely re-pushed on the next peering round (any
        # single copy serves reads, unlike EC's k-source requirement).
        pg.recovery_done_for(oid)
