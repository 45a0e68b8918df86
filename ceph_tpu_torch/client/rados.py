"""RadosClient — librados-lite over an Objecter-style op state machine.

Mirrors the client stack's shape (src/librados/IoCtxImpl.cc:642,692 →
osdc/Objecter.cc op_submit/_calc_target): every op computes its target PG
from the client's OSDMap copy (object_locator_to_pg → raw_pg_to_pg →
acting primary), sends an MOSDOp to that OSD, and resends after a map
refresh when the target was wrong or silent — the Objecter's
recalc-on-every-epoch behavior.

The port's own copy of ``ceph_tpu/client/rados.py``, except that an op's
CRUSH answer comes through ``crush_memo`` (the map's answers by its
content), where the JAX client runs CRUSH on every op.
"""
from __future__ import annotations

import struct
from typing import Dict, Optional, Tuple

from ..msg import (
    CEPH_OSD_OP_APPEND, CEPH_OSD_OP_DELETE, CEPH_OSD_OP_READ,
    CEPH_OSD_OP_STAT, CEPH_OSD_OP_WRITE, CEPH_OSD_OP_WRITEFULL,
    Dispatcher, MOSDMap, MOSDOp, MOSDOpReply, Message, Network,
)
from ..msg.messages import (
    CEPH_OSD_CMPXATTR_OP_EQ, CEPH_OSD_OP_ASSERT_VER,
    CEPH_OSD_OP_CALL, CEPH_OSD_OP_CMPXATTR, CEPH_OSD_OP_COPY_FROM,
    CEPH_OSD_OP_CREATE,
    CEPH_OSD_OP_FLAG_EXCL, CEPH_OSD_OP_GETXATTR, CEPH_OSD_OP_GETXATTRS,
    CEPH_OSD_OP_OMAPGETVALS, CEPH_OSD_OP_OMAPRMKEYS,
    CEPH_OSD_OP_OMAPSETKEYS, CEPH_OSD_OP_RMXATTR, CEPH_OSD_OP_SETXATTR,
    CEPH_OSD_OP_TRUNCATE, CEPH_OSD_OP_ZERO, OSDOp, new_trace_id,
)
from ..msg.kv import pack_kv as _pack_kv, pack_keys as _pack_keys, \
    unpack_kv as _unpack_kv
from ..osdmap import OSDMap, ceph_stable_mod, crush_memo, pg_t
from ..trace.oplat import stamp_client

MAX_ATTEMPTS = 8


def _ioerror(api: str, oid: str, result: int) -> IOError:
    """IOError with the errno attached so callers can branch on the
    CODE (ENOENT vs transient) instead of parsing the message."""
    e = IOError(f"{api} {oid}: {result}")
    e.errno = -result        # positive errno convention
    return e


class NotifyTimeout(IOError):
    """notify() timed out on silent watchers; .replies carries the
    acks that DID arrive (rados_notify2: error + reply buffer)."""

    def __init__(self, msg: str, replies):
        super().__init__(msg)
        self.replies = replies




class ObjectOperation:
    """Builder for an atomic multi-op vector (librados
    ObjectWriteOperation/ObjectReadOperation, executed by the OSD's
    do_osd_ops interpreter in order, all-or-nothing)."""

    def __init__(self):
        self.ops: list = []

    # -- data ops --
    def create(self, exclusive: bool = True) -> "ObjectOperation":
        self.ops.append(OSDOp(op=CEPH_OSD_OP_CREATE,
                              flags=CEPH_OSD_OP_FLAG_EXCL
                              if exclusive else 0))
        return self

    def write(self, data: bytes, offset: int) -> "ObjectOperation":
        self.ops.append(OSDOp(op=CEPH_OSD_OP_WRITE, data=bytes(data),
                              offset=offset))
        return self

    def write_full(self, data: bytes) -> "ObjectOperation":
        self.ops.append(OSDOp(op=CEPH_OSD_OP_WRITEFULL, data=bytes(data)))
        return self

    def append(self, data: bytes) -> "ObjectOperation":
        self.ops.append(OSDOp(op=CEPH_OSD_OP_APPEND, data=bytes(data)))
        return self

    def truncate(self, size: int) -> "ObjectOperation":
        self.ops.append(OSDOp(op=CEPH_OSD_OP_TRUNCATE, offset=size))
        return self

    def zero(self, offset: int, length: int) -> "ObjectOperation":
        self.ops.append(OSDOp(op=CEPH_OSD_OP_ZERO, offset=offset,
                              length=length))
        return self

    def remove(self) -> "ObjectOperation":
        self.ops.append(OSDOp(op=CEPH_OSD_OP_DELETE))
        return self

    def read(self, offset: int = 0, length: int = 0) -> "ObjectOperation":
        self.ops.append(OSDOp(op=CEPH_OSD_OP_READ, offset=offset,
                              length=length))
        return self

    def stat(self) -> "ObjectOperation":
        self.ops.append(OSDOp(op=CEPH_OSD_OP_STAT))
        return self

    # -- xattrs --
    def set_xattr(self, name: str, value: bytes) -> "ObjectOperation":
        self.ops.append(OSDOp(op=CEPH_OSD_OP_SETXATTR, name=name,
                              data=bytes(value)))
        return self

    def get_xattr(self, name: str) -> "ObjectOperation":
        self.ops.append(OSDOp(op=CEPH_OSD_OP_GETXATTR, name=name))
        return self

    def get_xattrs(self) -> "ObjectOperation":
        self.ops.append(OSDOp(op=CEPH_OSD_OP_GETXATTRS))
        return self

    def rm_xattr(self, name: str) -> "ObjectOperation":
        self.ops.append(OSDOp(op=CEPH_OSD_OP_RMXATTR, name=name))
        return self

    def assert_version(self, version: int) -> "ObjectOperation":
        """Abort the vector with -ERANGE unless the object's version
        still equals *version* (rados assert_version guard)."""
        self.ops.append(OSDOp(op=CEPH_OSD_OP_ASSERT_VER, offset=version))
        return self

    def call(self, cls: str, method: str,
             inp: bytes = b"") -> "ObjectOperation":
        """Invoke an object-class method on the OSD
        (ObjectOperation::exec / rados_exec; src/cls)."""
        self.ops.append(OSDOp(op=CEPH_OSD_OP_CALL,
                              name=f"{cls}.{method}", data=bytes(inp)))
        return self

    def copy_from(self, src_oid: str,
                  src_pool: int = -1) -> "ObjectOperation":
        """Replace this object with a server-side copy of *src_oid*
        (ObjectWriteOperation::copy_from; -1 = same pool — pool ids
        start at 0, so 0 is a real pool)."""
        self.ops.append(OSDOp(op=CEPH_OSD_OP_COPY_FROM, name=src_oid,
                              offset=src_pool))
        return self

    def cmp_xattr(self, name: str, value: bytes,
                  comparison: int = CEPH_OSD_CMPXATTR_OP_EQ
                  ) -> "ObjectOperation":
        """Guard: abort the whole vector with ECANCELED on mismatch."""
        self.ops.append(OSDOp(op=CEPH_OSD_OP_CMPXATTR, name=name,
                              data=bytes(value), flags=comparison))
        return self

    # -- omap (replicated pools only) --
    def omap_set(self, kv) -> "ObjectOperation":
        self.ops.append(OSDOp(op=CEPH_OSD_OP_OMAPSETKEYS,
                              data=_pack_kv(kv)))
        return self

    def omap_rm_keys(self, keys) -> "ObjectOperation":
        self.ops.append(OSDOp(op=CEPH_OSD_OP_OMAPRMKEYS,
                              data=_pack_keys(keys)))
        return self

    def omap_get(self) -> "ObjectOperation":
        self.ops.append(OSDOp(op=CEPH_OSD_OP_OMAPGETVALS))
        return self


class RadosClient(Dispatcher):
    def __init__(self, network: Network, mon, name: str = "client.0"):
        self.network = network
        self.mon = mon
        self.name = name
        self.messenger = network.create_messenger(name)
        self.messenger.add_dispatcher_head(self)
        self.osdmap = OSDMap()
        # per-instance random base (the reference scopes tids to the
        # mon session/connection): a restarted client with the same
        # entity name must not replay-match another instance's cached
        # command acks
        import secrets as _secrets
        self._tid = _secrets.randbits(44) << 16
        self._replies: Dict[int, MOSDOpReply] = {}
        # cookie -> (callback, pool_id, oid, last_known_primary)
        self._watches: Dict[int, list] = {}
        self._next_cookie = 1
        self._linger_tids: Dict[int, int] = {}   # in-flight re-register
        self._linger_retries: Dict[int, int] = {}
        # pool id -> (snapc_seq, [snap ids, newest first]): the write
        # SnapContext for selfmanaged-snap pools (librados
        # selfmanaged_snap_set_write_ctx; rides every mutating MOSDOp)
        self._write_snapc: Dict[int, Tuple[int, list]] = {}
        self._mon_acks: Dict[int, object] = {}
        mon.subscribe(name)
        mon.send_full_map(name)
        network.pump()

    # ---- dispatch ---------------------------------------------------------
    def ms_fast_dispatch(self, msg: Message) -> None:
        from ..msg.messages import MCommandReply, MMonCommandAck, \
            MWatchNotify
        if isinstance(msg, (MMonCommandAck, MCommandReply)):
            # _mon_acks doubles as the reply slot for daemon commands
            self._mon_acks[msg.tid] = msg
            return
        if isinstance(msg, MOSDMap):
            applied = False
            for inc in msg.incrementals:
                if inc.epoch == self.osdmap.epoch + 1:
                    self.osdmap.apply_incremental(inc)
                    applied = True
            if applied:
                self._reregister_watches()
        elif isinstance(msg, MOSDOpReply):
            cookie = self._linger_tids.pop(msg.tid, None)
            if cookie is not None:
                if msg.result == -11 and cookie in self._watches and \
                        self._linger_retries.get(cookie, 0) < 50:
                    # target PG still peering: keep lingering (the
                    # Objecter retries linger ops until they land)
                    self._linger_retries[cookie] = \
                        self._linger_retries.get(cookie, 0) + 1
                    self._send_watch_register(cookie)
                else:
                    self._linger_retries.pop(cookie, None)
                return
            self._replies[msg.tid] = msg
        elif isinstance(msg, MWatchNotify) and \
                msg.op == MWatchNotify.NOTIFY:
            w = self._watches.get(msg.cookie)
            reply = b""
            if w is not None:
                try:
                    reply = w[0](msg.notify_id, msg.payload) or b""
                except Exception:
                    reply = b""
            self.messenger.send_message(MWatchNotify(
                op=MWatchNotify.ACK, pgid=msg.pgid, oid=msg.oid,
                cookie=msg.cookie, notify_id=msg.notify_id,
                payload=bytes(reply)), msg.src)

    # ---- Objecter-lite ----------------------------------------------------
    def _calc_target(self, pool_id: int, oid: str):
        pool = self.osdmap.get_pg_pool(pool_id)
        if pool is None:
            # the pool vanished between resolution and submit (pool
            # deletion): surface librados's clean ENOENT, not KeyError
            raise _ioerror("op", f"pool {pool_id}", -2)
        if pool.read_tier >= 0:
            # cache tier overlay: ops retarget to the cache pool
            # (Objecter op_target read_tier/write_tier resolution)
            tier = self.osdmap.get_pg_pool(pool.read_tier)
            if tier is not None:
                pool_id, pool = pool.read_tier, tier
        raw = self.osdmap.map_to_pg(pool_id, oid)
        ps = ceph_stable_mod(raw.ps, pool.pg_num, pool.pg_num_mask)
        pg = pg_t(pool_id, ps)
        *_, acting, primary = self.osdmap.pg_to_up_acting_osds(
            pg, crush_memo(self.osdmap.crush))
        return (pool_id, ps), primary

    def _submit(self, pool_id: int, oid: str, op: str = "",
                data: bytes = b"", offset: int = 0, length: int = 0,
                ops: Optional[list] = None,
                snapid: int = 0) -> MOSDOpReply:
        # ONE trace id for the logical op: resend attempts are the same
        # op (the reference's ZTracer trace survives Objecter retries),
        # and the client's root span parents every daemon-side child
        from ..trace import g_tracer
        trace_id = new_trace_id()
        span = g_tracer.begin(f"client_op:{op or 'vector'}:{oid}",
                              daemon=self.name, trace_id=trace_id)
        try:
            with g_tracer.activate(span):
                return self._submit_attempts(
                    pool_id, oid, op, data, offset, length, ops, snapid,
                    trace_id, span.span_id if span is not None else 0)
        finally:
            g_tracer.finish(span)

    def _submit_attempts(self, pool_id: int, oid: str, op: str,
                         data: bytes, offset: int, length: int,
                         ops: Optional[list], snapid: int,
                         trace_id: int, span_id: int) -> MOSDOpReply:
        import time as _time
        reply = None
        tid = self._tid
        attempt = throttle_waits = 0
        while attempt < MAX_ATTEMPTS:
            pgid, primary = self._calc_target(pool_id, oid)
            self._tid += 1
            tid = self._tid
            if primary >= 0:
                sc_seq, sc_snaps = self._write_snapc.get(pool_id, (0, []))
                msg = MOSDOp(tid=tid, pool=pgid[0], oid=oid, pgid=pgid,
                             op=op, data=data, offset=offset,
                             length=length, epoch=self.osdmap.epoch,
                             ops=list(ops) if ops else [],
                             snapid=snapid,
                             snapc_seq=sc_seq, snapc_snaps=list(sc_snaps),
                             trace_id=trace_id,
                             parent_span_id=span_id)
                # stage-latency ledger: the submit stamp opens the
                # op's time ledger; the OSD's intake mark turns it
                # into the client_flight stage (trace/oplat.py).  A
                # resend is a fresh arrival and gets a fresh ledger.
                stamp_client(msg, self.name)
                self.messenger.send_message(msg, f"osd.{primary}")
                self.network.pump()
            reply = self._replies.pop(tid, None)
            if reply is not None and reply.result == -11 and \
                    getattr(reply, "retry_after", 0.0) > 0:
                # admission-control throttle (docs/QOS.md): the op was
                # SHED at intake, not misrouted — back off and resend
                # without burning a map-refresh attempt.  Bounded so a
                # permanently saturated OSD still surfaces EAGAIN; the
                # pump between resends is what drains the queue on the
                # deterministic fabric.
                throttle_waits += 1
                if throttle_waits <= 256:
                    if not self.network.pump():
                        # nothing moved (remote daemons still working):
                        # honor the hint briefly before resending — on
                        # the in-process fabric the pump IS the drain,
                        # so a wall-sleep there is pure dead time
                        _time.sleep(min(reply.retry_after, 0.02))
                    continue
            if reply is not None and reply.result != -11:
                return reply
            attempt += 1
            # wrong/silent primary: refresh the map and retry
            self.mon.send_full_map(self.name)
            self.network.pump()
        return reply if reply is not None else MOSDOpReply(tid=tid,
                                                           result=-110)

    def operate(self, pool: str, oid: str, op: ObjectOperation,
                snap=None) -> Tuple[int, list]:
        """Execute an atomic multi-op vector; returns (result,
        [(per-op result, per-op data), ...]) — rados_*_op_operate.
        With ``snap`` the vector runs read-only against that pool
        snapshot's view."""
        snapid = self._resolve_snapid(pool, snap) if snap else 0
        r = self._submit(self.lookup_pool(pool), oid, ops=op.ops,
                         snapid=snapid)
        return r.result, list(r.op_results)

    def _submit_to_pg(self, pgid, op: str, data: bytes = b"",
                      length: int = 0) -> MOSDOpReply:
        """Send a PG-targeted op (no object) to the PG's primary with
        the same refresh-and-resend loop as _submit."""
        for attempt in range(MAX_ATTEMPTS):
            if self.osdmap.get_pg_pool(pgid[0]) is None:
                raise _ioerror("op", f"pool {pgid[0]}", -2)
            *_, acting, primary = self.osdmap.pg_to_up_acting_osds(
                pg_t(*pgid), crush_memo(self.osdmap.crush))
            self._tid += 1
            tid = self._tid
            if primary >= 0:
                self.messenger.send_message(MOSDOp(
                    tid=tid, pool=pgid[0], pgid=tuple(pgid), op=op,
                    data=data, length=length, epoch=self.osdmap.epoch,
                    trace_id=new_trace_id()), f"osd.{primary}")
                self.network.pump()
            reply = self._replies.pop(tid, None)
            if reply is not None and reply.result != -11:
                return reply
            self.mon.send_full_map(self.name)
            self.network.pump()
        return reply if reply is not None else \
            MOSDOpReply(tid=tid, result=-110)

    def list_objects(self, pool: str, page: int = 512):
        """Iterate every head object in the pool (rados_nobjects_list):
        a PGLS op per PG with cursor pagination, like the Objecter's
        pg-targeted listing ops (PrimaryLogPG do_pg_op PGNLS)."""
        from ..msg.messages import CEPH_OSD_OP_PGLS
        pid = self.lookup_pool(pool)
        p = self.osdmap.get_pg_pool(pid)
        for ps in range(p.pg_num):
            cursor = b""
            while True:
                reply = self._submit_to_pg((pid, ps), CEPH_OSD_OP_PGLS,
                                           data=cursor, length=page)
                if reply.result < 0:
                    raise _ioerror("pgls", f"{pid}.{ps}", reply.result)
                import json as _json
                names = _json.loads(reply.data) if reply.data else []
                yield from names
                if reply.result != 1:       # no more pages in this PG
                    break
                cursor = names[-1].encode()

    def lookup_pool(self, name: str) -> int:
        pid = self.osdmap.lookup_pg_pool_name(name)
        if pid < 0:
            raise KeyError(f"no pool {name!r}")
        return pid

    # ---- public API (librados verbs) --------------------------------------
    def write_full(self, pool: str, oid: str, data: bytes) -> int:
        r = self._submit(self.lookup_pool(pool), oid,
                         CEPH_OSD_OP_WRITEFULL, bytes(data))
        return r.result

    def write(self, pool: str, oid: str, data: bytes, offset: int) -> int:
        """Offset write (librados rados_write): rmw on EC pools."""
        r = self._submit(self.lookup_pool(pool), oid, CEPH_OSD_OP_WRITE,
                         bytes(data), offset=offset)
        return r.result

    def append(self, pool: str, oid: str, data: bytes) -> int:
        """Append at the current object size (rados_append)."""
        r = self._submit(self.lookup_pool(pool), oid, CEPH_OSD_OP_APPEND,
                         bytes(data))
        return r.result

    def read(self, pool: str, oid: str, offset: int = 0,
             length: int = 0, snap=None) -> bytes:
        """Read the head, or — with ``snap`` (name or id) — the object's
        state as of that pool snapshot (rados snap read)."""
        snapid = self._resolve_snapid(pool, snap) if snap else 0
        r = self._submit(self.lookup_pool(pool), oid, CEPH_OSD_OP_READ,
                         offset=offset, length=length, snapid=snapid)
        if r.result < 0:
            raise _ioerror("read", oid, r.result)
        return r.data

    def mon_command(self, cmd: str, **args):
        """Run a mon administrative command by name (librados
        mon_command / 'ceph tell mon').  In-process Monitors execute
        directly; over TCP this sends MMonCommand and waits for the
        ack.  Both paths take the Monitor method's own kwargs and
        return its return value."""
        if hasattr(self.mon, cmd):
            value = getattr(self.mon, cmd)(**args)
            self.mon.publish()
            self.network.pump()
            return value
        from ..msg.messages import MMonCommand
        self._tid += 1
        tid = self._tid
        for attempt in range(MAX_ATTEMPTS):
            # re-read each attempt: a silent mon triggers hunting
            mon_name = getattr(self.mon, "mon_name", "mon")
            self.messenger.send_message(MMonCommand(
                tid=tid, cmd=cmd, args=dict(args)), mon_name)
            self.network.pump()
            ack = self._mon_acks.pop(tid, None)
            if ack is None and attempt and attempt % 3 == 0 \
                    and hasattr(self.mon, "hunt"):
                # only a SILENT mon triggers hunting; an answering
                # one (even with EAGAIN mid-election) keeps the bind
                self.mon.hunt()
            if ack is not None:
                if ack.result == -11:
                    continue    # EAGAIN: mon electing / leadership moved
                if ack.result < 0:
                    raise ValueError(ack.data.get("error",
                                                  f"mon {ack.result}"))
                return ack.data.get("value")
        raise _ioerror("mon_command", cmd, -110)

    def _daemon_command(self, target: str, cmd: str, args: dict):
        from ..msg.messages import MCommand
        self._tid += 1
        tid = self._tid
        for _attempt in range(MAX_ATTEMPTS):
            self.messenger.send_message(
                MCommand(tid=tid, cmd=cmd, args=dict(args)), target)
            self.network.pump()
            rep = self._mon_acks.pop(tid, None)
            if rep is not None:
                if rep.result < 0:
                    raise ValueError(rep.data.get(
                        "error", f"{target} {rep.result}"))
                return rep.data
        raise _ioerror("daemon_command", cmd, -110)

    def osd_command(self, osd_id: int, cmd: str, **args):
        """Run a command on a LIVE osd daemon over the wire
        ('ceph tell osd.N', MCommand.h): injectargs / config show /
        config get / perf dump / dump_ops_in_flight."""
        return self._daemon_command(f"osd.{osd_id}", cmd, args)

    def mds_command(self, mds_name: str, cmd: str, **args):
        """'ceph tell mds.<name>': the same wire command pair against
        a live metadata server (injectargs / config show / config get
        / session ls / status)."""
        return self._daemon_command(mds_name, cmd, args)

    # ---- pool snapshots (rados_ioctx_snap_*) -------------------------------
    def _resolve_snapid(self, pool: str, snap) -> int:
        if isinstance(snap, int):
            return snap
        p = self.osdmap.get_pg_pool(self.lookup_pool(pool))
        for sid, name in p.snaps.items():
            if name == snap:
                return sid
        raise KeyError(f"no snap {snap!r} on pool {pool!r}")

    def snap_create(self, pool: str, name: str) -> int:
        return self.mon_command("pool_snap_create", pool_name=pool,
                                snap_name=name)

    def snap_remove(self, pool: str, name: str) -> int:
        return self.mon_command("pool_snap_rm", pool_name=pool,
                                snap_name=name)

    def snap_list(self, pool: str) -> Dict[int, str]:
        p = self.osdmap.get_pg_pool(self.lookup_pool(pool))
        return dict(p.snaps)

    # ---- advisory locks (rados_lock_exclusive/shared -> cls_lock,
    # src/cls/lock/cls_lock_client.cc) ---------------------------------
    def _lock_exec(self, pool: str, oid: str, method: str,
                   payload: dict) -> int:
        import json as _json
        ret, _ = self.exec(pool, oid, "lock", method,
                           _json.dumps(payload).encode())
        return ret

    def lock_exclusive(self, pool: str, oid: str, name: str,
                       cookie: str = "", description: str = "",
                       duration: float = 0) -> int:
        from ..osd.cls_lock import LOCK_EXCLUSIVE
        return self._lock_exec(pool, oid, "lock", {
            "name": name, "type": LOCK_EXCLUSIVE, "cookie": cookie,
            "description": description, "duration": duration})

    def lock_shared(self, pool: str, oid: str, name: str,
                    cookie: str = "", tag: str = "",
                    description: str = "", duration: float = 0) -> int:
        from ..osd.cls_lock import LOCK_SHARED
        return self._lock_exec(pool, oid, "lock", {
            "name": name, "type": LOCK_SHARED, "cookie": cookie,
            "tag": tag, "description": description,
            "duration": duration})

    def unlock(self, pool: str, oid: str, name: str,
               cookie: str = "") -> int:
        return self._lock_exec(pool, oid, "unlock",
                               {"name": name, "cookie": cookie})

    def break_lock(self, pool: str, oid: str, name: str, entity: str,
                   cookie: str = "") -> int:
        return self._lock_exec(pool, oid, "break_lock",
                               {"name": name, "entity": entity,
                                "cookie": cookie})

    def list_lockers(self, pool: str, oid: str, name: str) -> dict:
        import json as _json
        ret, out = self.exec(pool, oid, "lock", "get_info",
                             _json.dumps({"name": name}).encode())
        if ret < 0:
            raise _ioerror("list_lockers", oid, ret)
        return _json.loads(out)

    # ---- selfmanaged snaps (librados rados_ioctx_selfmanaged_snap_*):
    # the mon only allocates/retires ids; snapshot membership lives in
    # the write SnapContext this client attaches to mutations ----------
    def selfmanaged_snap_create(self, pool: str) -> int:
        return self.mon_command("selfmanaged_snap_create",
                                pool_name=pool)

    def selfmanaged_snap_remove(self, pool: str, snapid: int) -> None:
        self.mon_command("selfmanaged_snap_remove", pool_name=pool,
                         snapid=snapid)
        pid = self.lookup_pool(pool)
        seq, snaps = self._write_snapc.get(pid, (0, []))
        if snapid in snaps:
            self.set_write_ctx(pool, seq,
                               [s for s in snaps if s != snapid])

    def set_write_ctx(self, pool: str, seq: int, snaps) -> None:
        """Set the SnapContext attached to this pool's writes: ``seq``
        the newest snap id, ``snaps`` every live snap (any order; sent
        newest-first like the reference sorts it)."""
        snaps = sorted(snaps, reverse=True)
        if snaps and (seq < snaps[0] or len(set(snaps)) != len(snaps)):
            raise ValueError("invalid snap context")
        pid = self.lookup_pool(pool)
        if seq > 0 and not self.osdmap.get_pg_pool(pid).selfmanaged:
            # a snapc on a pool-snapshot pool would shadow the pool
            # snapc and corrupt its snapshots (reference: EINVAL)
            raise ValueError(
                f"pool {pool!r} is not in selfmanaged snap mode")
        self._write_snapc[pid] = (seq, snaps)

    def rollback(self, pool: str, oid: str, snap) -> int:
        """Restore the head — data AND xattrs — to its state at the
        snap (rados_ioctx_snap_rollback; composed client-side from
        snap-view reads + one atomic head vector).  The final vector is
        guarded with assert_version on the head version observed before
        the reads, so a write landing mid-compose aborts the vector
        (-ERANGE) and the rollback recomposes instead of silently
        overwriting it."""
        pid = self.lookup_pool(pool)
        snapid = self._resolve_snapid(pool, snap)
        for _ in range(MAX_ATTEMPTS):
            rv = self._submit(pid, oid, CEPH_OSD_OP_STAT)
            if rv.result == -2:
                head_ver = 0
            elif rv.result < 0:
                raise IOError(f"rollback stat {oid}: {rv.result}")
            else:
                head_ver = rv.version
            r = self._submit(pid, oid, CEPH_OSD_OP_READ, snapid=snapid)
            if r.result == -2:
                # object did not exist at the snap: remove the head
                r2, _ = self.operate(pool, oid, ObjectOperation()
                                     .assert_version(head_ver).remove())
                if r2 == -34:
                    continue        # head moved under us: recompose
                return 0 if r2 == -2 else r2    # no head either: no-op
            if r.result < 0:
                # transient failure (EIO/degraded): never touch the head
                raise IOError(f"rollback read {oid}@{snap}: {r.result}")
            rs, res = self.operate(pool, oid,
                                   ObjectOperation().get_xattrs(),
                                   snap=snap)
            if rs < 0 and rs != -2:
                # transient xattr-read failure would silently strip the
                # snap-time xattrs while the data restore succeeds —
                # same contract as the data read: never touch the head
                raise IOError(f"rollback xattrs {oid}@{snap}: {rs}")
            snap_attrs = _unpack_kv(res[0][1]) if rs == 0 else {}
            try:
                head_attrs = self.getxattrs(pool, oid)
            except IOError as e:
                if e.errno != 2:            # ENOENT = no head attrs
                    raise
                head_attrs = {}
            op = ObjectOperation().assert_version(head_ver) \
                                  .write_full(r.data)
            for k in head_attrs:
                if k not in snap_attrs:
                    op.rm_xattr(k)
            for k, v in snap_attrs.items():
                op.set_xattr(k, v)
            r2, _ = self.operate(pool, oid, op)
            if r2 != -34:
                return r2
        return -34

    def stat(self, pool: str, oid: str, snap=None) -> int:
        snapid = self._resolve_snapid(pool, snap) if snap else 0
        r = self._submit(self.lookup_pool(pool), oid, CEPH_OSD_OP_STAT,
                         snapid=snapid)
        if r.result < 0:
            raise _ioerror("stat", oid, r.result)
        return struct.unpack("<Q", r.data)[0]

    def exec(self, pool: str, oid: str, cls: str, method: str,
             inp: bytes = b"", snap=None) -> "tuple[int, bytes]":
        """Run an object-class method (rados_exec): returns
        (method ret, output bytes).  With ``snap`` a READ-ONLY method
        runs against the object's state at that snapshot (the vector
        interpreter resolves the clone like any snap read)."""
        r, res = self.operate(pool, oid,
                              ObjectOperation().call(cls, method, inp),
                              snap=snap)
        if r < 0:
            return r, b""
        return res[0][0], res[0][1]

    def copy(self, pool: str, dst: str, src: str,
             src_pool: Optional[str] = None) -> int:
        """Server-side copy (rados_copy role): dst <= src."""
        spid = self.lookup_pool(src_pool) if src_pool \
            else self.lookup_pool(pool)
        r, _ = self.operate(pool, dst,
                            ObjectOperation().copy_from(src, spid))
        return r

    def get_version(self, pool: str, oid: str) -> int:
        """Current object version (the stat reply's user_version) —
        pairs with ObjectOperation.assert_version guards."""
        r = self._submit(self.lookup_pool(pool), oid, CEPH_OSD_OP_STAT)
        if r.result < 0:
            raise _ioerror("stat", oid, r.result)
        return r.version

    def remove(self, pool: str, oid: str) -> int:
        return self._submit(self.lookup_pool(pool), oid,
                            CEPH_OSD_OP_DELETE).result

    # -- xattr / omap / extent convenience verbs (librados rados_*) ----------
    def setxattr(self, pool: str, oid: str, name: str,
                 value: bytes) -> int:
        r, _ = self.operate(pool, oid,
                            ObjectOperation().set_xattr(name, value))
        return r

    def getxattr(self, pool: str, oid: str, name: str) -> bytes:
        r, res = self.operate(pool, oid,
                              ObjectOperation().get_xattr(name))
        if r < 0:
            raise _ioerror(f"getxattr .{name}", oid, r)
        return res[0][1]

    def getxattrs(self, pool: str, oid: str) -> Dict[str, bytes]:
        r, res = self.operate(pool, oid, ObjectOperation().get_xattrs())
        if r < 0:
            raise _ioerror("getxattrs", oid, r)
        return _unpack_kv(res[0][1])

    def rmxattr(self, pool: str, oid: str, name: str) -> int:
        r, _ = self.operate(pool, oid, ObjectOperation().rm_xattr(name))
        return r

    def truncate(self, pool: str, oid: str, size: int) -> int:
        r, _ = self.operate(pool, oid, ObjectOperation().truncate(size))
        return r

    def zero(self, pool: str, oid: str, offset: int, length: int) -> int:
        r, _ = self.operate(pool, oid,
                            ObjectOperation().zero(offset, length))
        return r

    def create(self, pool: str, oid: str, exclusive: bool = True) -> int:
        r, _ = self.operate(pool, oid,
                            ObjectOperation().create(exclusive))
        return r

    def omap_set(self, pool: str, oid: str, kv: Dict[str, bytes]) -> int:
        r, _ = self.operate(pool, oid, ObjectOperation().omap_set(kv))
        return r

    def omap_get(self, pool: str, oid: str) -> Dict[str, bytes]:
        r, res = self.operate(pool, oid, ObjectOperation().omap_get())
        if r < 0:
            raise _ioerror("omap_get", oid, r)
        return _unpack_kv(res[0][1])

    def omap_rm_keys(self, pool: str, oid: str, keys) -> int:
        r, _ = self.operate(pool, oid,
                            ObjectOperation().omap_rm_keys(keys))
        return r

    # ---- watch / notify (rados_watch / rados_notify) -----------------------
    def _reregister_watches(self) -> None:
        """After a map change, re-send watch registrations whose PG
        primary moved — the new primary's watcher table starts empty
        (the linger-op resend in Objecter::_linger_submit)."""
        for cookie, w in self._watches.items():
            _cb, pool_id, oid, last_primary = w
            _pgid, primary = self._calc_target(pool_id, oid)
            if primary != last_primary and primary >= 0:
                w[3] = primary
                self._linger_retries[cookie] = 0
                self._send_watch_register(cookie)

    def _send_watch_register(self, cookie: int) -> None:
        from ..msg.messages import CEPH_OSD_OP_WATCH
        w = self._watches.get(cookie)
        if w is None:
            return
        _cb, pool_id, oid, _lp = w
        pgid, primary = self._calc_target(pool_id, oid)
        if primary < 0:
            return
        w[3] = primary
        self._tid += 1
        self._linger_tids[self._tid] = cookie
        self.messenger.send_message(MOSDOp(
            tid=self._tid, pool=pool_id, oid=oid, pgid=pgid,
            op=CEPH_OSD_OP_WATCH, offset=cookie,
            epoch=self.osdmap.epoch,
            trace_id=new_trace_id()), f"osd.{primary}")

    def watch(self, pool: str, oid: str, callback) -> int:
        """Register *callback(notify_id, payload) -> reply_bytes* for
        notifies on the object; returns the watch cookie.  Watches
        re-register automatically when the PG's primary moves."""
        from ..msg.messages import CEPH_OSD_OP_WATCH
        cookie = self._next_cookie
        self._next_cookie += 1
        pool_id = self.lookup_pool(pool)
        _pgid, primary = self._calc_target(pool_id, oid)
        self._watches[cookie] = [callback, pool_id, oid, primary]
        r = self._submit(pool_id, oid, CEPH_OSD_OP_WATCH, offset=cookie)
        if r.result < 0:
            del self._watches[cookie]
            raise IOError(f"watch {oid}: {r.result}")
        return cookie

    def unwatch(self, pool: str, oid: str, cookie: int) -> int:
        from ..msg.messages import CEPH_OSD_OP_UNWATCH
        self._watches.pop(cookie, None)
        return self._submit(self.lookup_pool(pool), oid,
                            CEPH_OSD_OP_UNWATCH, offset=cookie).result

    def notify(self, pool: str, oid: str, payload: bytes = b"",
               timeout: int = 30) -> Dict[str, bytes]:
        """Broadcast to the object's watchers; returns
        {"client:cookie": reply_payload} once every live watcher acked
        (rados_notify2 semantics)."""
        from ..msg.messages import CEPH_OSD_OP_NOTIFY
        r = self._submit(self.lookup_pool(pool), oid, CEPH_OSD_OP_NOTIFY,
                         data=bytes(payload), length=timeout)
        if r.result == -110:
            raise NotifyTimeout(f"notify {oid} timed out",
                                _unpack_kv(r.data))
        if r.result < 0:
            raise IOError(f"notify {oid}: {r.result}")
        return _unpack_kv(r.data)
