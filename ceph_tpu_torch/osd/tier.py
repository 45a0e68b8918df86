"""Cache tiering — writeback promote/flush/evict over a 2-pool tier.

The reference layers a replicated CACHE pool over a BASE pool
(osd_types.h pg_pool_t tier fields; PrimaryLogPG.cc hit_set_setup,
promote_object, agent_work; HitSet.h): clients are redirected to the
cache by read_tier/write_tier, a miss promotes the object from the
base, writes dirty the cache copy, and a background agent flushes
cold dirty objects down and evicts cold clean ones.  This module is
that machinery for the cache PG's primary:

- ``intercept(msg)``: record the access in the PG's hit sets; on a
  miss that needs the object's bytes, start a promote (an OSD-side
  Objecter-lite op to the base pool) and requeue the op behind it.
- ``agent_work(now)``: rotate hit sets each hit_set_period; flush
  dirty objects that fell out of every hit set (write_full to the
  base); evict cold clean objects while the cache sits over
  target_max_objects.

Dirty markers persist in the PG meta omap (``dt\\x00<oid>``) so a
restarted cache OSD still knows what it owes the base pool.

The port's own copy of ``ceph_tpu/osd/tier.py``.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Set

from ..common.dout import dlog
from ..msg.messages import (
    CEPH_OSD_OP_APPEND, CEPH_OSD_OP_CMPXATTR, CEPH_OSD_OP_DELETE,
    CEPH_OSD_OP_GETXATTR, CEPH_OSD_OP_GETXATTRS,
    CEPH_OSD_OP_OMAPGETVALS, CEPH_OSD_OP_OMAPRMKEYS,
    CEPH_OSD_OP_OMAPSETKEYS, CEPH_OSD_OP_READ, CEPH_OSD_OP_RMXATTR,
    CEPH_OSD_OP_SETXATTR, CEPH_OSD_OP_STAT, CEPH_OSD_OP_TRUNCATE,
    CEPH_OSD_OP_WRITE, CEPH_OSD_OP_WRITEFULL, CEPH_OSD_OP_ZERO,
    MOSDOp, OSDOp,
)
from ..msg.kv import unpack_kv
from ..os_store import Transaction, hobject_t
from .hit_set import HitSetHistory
from .pg_log import PG_META_OID

DIRTY_KEY_PREFIX = "dt\x00"      # meta omap namespace for dirty markers

# ops that need the object's existing state: a cache miss on these
# must promote before executing (WRITEFULL replaces wholesale; xattr
# and omap ops read-modify the promoted copy's metadata)
_NEED_BODY = frozenset([
    CEPH_OSD_OP_READ, CEPH_OSD_OP_STAT, CEPH_OSD_OP_WRITE,
    CEPH_OSD_OP_APPEND, CEPH_OSD_OP_TRUNCATE, CEPH_OSD_OP_ZERO,
    CEPH_OSD_OP_GETXATTR, CEPH_OSD_OP_GETXATTRS, CEPH_OSD_OP_CMPXATTR,
    CEPH_OSD_OP_SETXATTR, CEPH_OSD_OP_RMXATTR,
    CEPH_OSD_OP_OMAPGETVALS, CEPH_OSD_OP_OMAPSETKEYS,
    CEPH_OSD_OP_OMAPRMKEYS,
])
_MUTATES = frozenset([
    CEPH_OSD_OP_WRITE, CEPH_OSD_OP_WRITEFULL, CEPH_OSD_OP_APPEND,
    CEPH_OSD_OP_TRUNCATE, CEPH_OSD_OP_ZERO, CEPH_OSD_OP_DELETE,
    CEPH_OSD_OP_SETXATTR, CEPH_OSD_OP_RMXATTR,
    CEPH_OSD_OP_OMAPSETKEYS, CEPH_OSD_OP_OMAPRMKEYS,
])


class TierState:
    """Per-cache-PG tiering state, owned by the PG (primary-driven)."""

    def __init__(self, pg):
        self.pg = pg
        self.base_pool = pg.pool.tier_of     # survives tier removal
        self.hit_sets = HitSetHistory(pg.pool.hit_set_count)
        # oid -> mutation seq: a flush only clears the marker if no
        # NEWER write landed while it was in flight
        self.dirty: Dict[str, int] = {}
        self._promoting: Dict[str, List[Callable[[], None]]] = {}
        self._promote_miss: Set[str] = set()
        self._flushing: Set[str] = set()
        # tier removed: drain every dirty object to the base, then the
        # PG drops this state (reference: flush/evict-all before
        # tearing the overlay down)
        self.shutting_down = False
        self._load_dirty()

    # ---- persistence -------------------------------------------------------
    def _meta(self):
        return self.pg.meta_cid(), hobject_t(PG_META_OID)

    def _load_dirty(self) -> None:
        store = self.pg.osd.store
        cid, meta = self._meta()
        if not store.collection_exists(cid) or \
                not store.exists(cid, meta):
            return
        for k in store.omap_get(cid, meta):
            if k.startswith(DIRTY_KEY_PREFIX):
                self.dirty[k[len(DIRTY_KEY_PREFIX):]] = 1

    def _mark_dirty(self, oid: str, dirty: bool) -> None:
        if dirty:
            was = oid in self.dirty
            # ALWAYS bump the seq: an in-flight flush must not clear a
            # marker that a newer write re-dirtied
            self.dirty[oid] = self.dirty.get(oid, 0) + 1
            if was:
                return          # marker already persisted
        else:
            if oid not in self.dirty:
                return
            del self.dirty[oid]
        t = Transaction()
        cid = self.pg.ensure_meta_collection(t)
        meta = hobject_t(PG_META_OID)
        t.touch(cid, meta)
        if dirty:
            t.omap_setkeys(cid, meta, {DIRTY_KEY_PREFIX + oid: b"1"})
        else:
            t.omap_rmkeys(cid, meta, [DIRTY_KEY_PREFIX + oid])
        self.pg.osd.store.queue_transaction(t)

    # ---- op interception ---------------------------------------------------
    def _have(self, oid: str) -> bool:
        exists, *_ = self.pg.rep_backend.object_state(oid)
        return exists

    def intercept(self, msg: MOSDOp) -> bool:
        """Returns True when the op was parked behind a promote; the
        op re-dispatches once the base copy lands."""
        pg = self.pg
        oid = msg.oid
        self.hit_sets.record(oid)
        ops = msg.ops or [OSDOp(op=msg.op)]
        mutates = any(o.op in _MUTATES for o in ops)
        needs_body = any(o.op in _NEED_BODY for o in ops)
        if any(o.op == CEPH_OSD_OP_DELETE for o in ops):
            # deletes write through: a promote must never resurrect a
            # deleted object from the base (the reference's whiteout
            # role, collapsed to synchronous base deletion)
            pg.osd.tier_submit(self.base_pool, oid,
                               [OSDOp(op=CEPH_OSD_OP_DELETE)],
                               lambda _r: None)
            self._mark_dirty(oid, False)
        elif mutates:
            self._mark_dirty(oid, True)
        # NOTE: intercept stays FULLY active while a removed tier
        # drains (shutting_down): skipping the promote for a needs-body
        # mutation would execute it against a missing cache copy and
        # the drain would then flush that partial body over the intact
        # base object — the promote path is still safe (the base pool
        # is still there to read from).
        if oid in self._promoting:
            self._promoting[oid].append(lambda: pg.do_op(msg))
            return True
        if needs_body and not self._have(oid) and \
                oid not in self._promote_miss:
            self._promote(oid, lambda: pg.do_op(msg))
            return True
        return False

    def _promote(self, oid: str, then: Callable[[], None]) -> None:
        """Fetch body + user xattrs from the base pool, materialize the
        object in the cache CLEAN, then run the parked ops
        (PrimaryLogPG::promote_object)."""
        pg = self.pg
        self._promoting[oid] = [then]
        dlog("pg", 5, f"tier promote {oid} from pool {pg.pool.tier_of}",
             f"osd.{pg.osd.osd_id}")

        def on_reply(reply) -> None:
            if reply.result == 0 and reply.op_results:
                data = reply.op_results[0][1]
                attrs = {}
                if len(reply.op_results) > 1 and \
                        reply.op_results[1][0] >= 0:
                    attrs = unpack_kv(reply.op_results[1][1])
                pg.rep_backend.write(oid, data, full=True,
                                     version=pg.next_version(),
                                     xattrs=attrs)
            elif reply.result == -2:
                # base ENOENT: remember the miss while the parked ops
                # re-dispatch, or they would re-promote forever; the
                # ops then answer for the absent object themselves
                self._promote_miss.add(oid)
            # any other result is transient (timeout, primary down):
            # neither materialize nor mark — the re-dispatch below
            # starts a fresh promote
            cbs = self._promoting.pop(oid, [])
            try:
                for cb in cbs:
                    cb()
            finally:
                self._promote_miss.discard(oid)

        pg.osd.tier_submit(
            self.base_pool, oid,
            [OSDOp(op=CEPH_OSD_OP_READ),
             OSDOp(op=CEPH_OSD_OP_GETXATTRS)], on_reply)

    # ---- the agent ---------------------------------------------------------
    def agent_work(self, now: float) -> None:
        """Flush cold dirty objects; evict cold clean ones over target
        (PrimaryLogPG::agent_work).  In shutdown (tier removed) every
        dirty object flushes regardless of temperature, and the PG
        drops the tier state once drained."""
        pg = self.pg
        self.hit_sets.maybe_rotate(now, pg.pool.hit_set_period)
        for oid in sorted(self.dirty):
            if oid in self._flushing or \
                    (not self.shutting_down
                     and self.hit_sets.contains(oid)):
                continue
            self._flush(oid)
        if self.shutting_down:
            if not self.dirty and not self._flushing:
                pg.tier = None      # drained: the overlay is gone
            return
        target = pg.pool.target_max_objects
        if not target:
            return
        # pool-wide target split across PGs (agent_choose_mode's
        # per-PG divide of target_max_objects)
        target = max(1, target // max(pg.pool.pg_num, 1))
        objs = sorted(o.oid for o in pg.osd.store.list_objects(
            pg.rep_backend.cid())
            if not o.oid.startswith("_"))
        over = len(objs) - target
        for oid in objs:
            if over <= 0:
                break
            if oid in self.dirty or oid in self._flushing or \
                    self.hit_sets.contains(oid):
                continue
            dlog("pg", 5, f"tier evict {oid}", f"osd.{pg.osd.osd_id}")
            pg._fan_delete(oid)
            over -= 1

    def _flush(self, oid: str) -> None:
        pg = self.pg
        exists, data, xattrs, _omap = pg.rep_backend.object_state(oid)
        if not exists:
            self._mark_dirty(oid, False)
            return
        self._flushing.add(oid)
        dlog("pg", 5, f"tier flush {oid} -> pool {pg.pool.tier_of}",
             f"osd.{pg.osd.osd_id}")
        ops = [OSDOp(op=CEPH_OSD_OP_WRITEFULL, data=bytes(data))]
        for k, v in xattrs.items():
            ops.append(OSDOp(op=CEPH_OSD_OP_SETXATTR, name=k,
                             data=bytes(v)))
        if _omap:
            # EC base pools reject omap (-95): the flush then fails loud
            # and the object stays dirty, rather than dropping the keys
            from ..msg.kv import pack_kv
            ops.append(OSDOp(op=CEPH_OSD_OP_OMAPSETKEYS,
                             data=pack_kv(_omap)))
        seq = self.dirty.get(oid, 0)

        def on_reply(reply) -> None:
            self._flushing.discard(oid)
            if reply.result == 0 and self.dirty.get(oid) == seq:
                # only clear if no NEWER write landed mid-flight
                self._mark_dirty(oid, False)
            # otherwise stay dirty and retry on the next agent pass

        pg.osd.tier_submit(self.base_pool, oid, ops, on_reply)
