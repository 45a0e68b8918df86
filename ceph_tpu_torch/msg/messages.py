"""Message types for the mini-cluster fabric.

Named after the reference wire messages (src/messages/M*.h) so the data
path reads the same: client ops (MOSDOp/MOSDOpReply), EC shard sub-ops
(MOSDECSubOpWrite/..., src/osd/ECMsgTypes.h payloads), heartbeats
(MOSDPing), failure reports, and map publication (MOSDMap).  Every message
carries the op's trace id end to end (the ZTracer::Trace slot on
msg/Message.h:254).

The port's own copy of ``ceph_tpu/msg/messages.py``.
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

_trace_counter = itertools.count(1)


def new_trace_id() -> int:
    return next(_trace_counter)


@dataclass
class Message:
    src: str = ""
    trace_id: int = 0
    # the sender's active span (trace/span.py): receivers open child
    # spans under it, giving cross-daemon span trees — the blkin
    # parent-handle half of the Message.h:254 trace slot.  0 = no
    # parent (tracing off or a root message).
    parent_span_id: int = 0

    def name(self) -> str:
        return type(self).__name__


# client op codes (the do_osd_ops interpreter's vocabulary,
# src/osd/PrimaryLogPG.cc do_osd_ops: CEPH_OSD_OP_{READ,WRITE,WRITEFULL,...})
CEPH_OSD_OP_READ = "read"            # ranged read (offset/length)
CEPH_OSD_OP_WRITE = "write"          # offset write (rmw on EC pools)
CEPH_OSD_OP_WRITEFULL = "writefull"  # whole-object replace
CEPH_OSD_OP_APPEND = "append"        # write at current object size
CEPH_OSD_OP_DELETE = "delete"
CEPH_OSD_OP_STAT = "stat"
CEPH_OSD_OP_CREATE = "create"        # create; flags=EXCL -> EEXIST if present
CEPH_OSD_OP_TRUNCATE = "truncate"    # resize (shrink or zero-extend)
CEPH_OSD_OP_ZERO = "zero"            # zero an extent (never extends)
CEPH_OSD_OP_SETXATTR = "setxattr"
CEPH_OSD_OP_GETXATTR = "getxattr"
CEPH_OSD_OP_GETXATTRS = "getxattrs"
CEPH_OSD_OP_RMXATTR = "rmxattr"
CEPH_OSD_OP_CMPXATTR = "cmpxattr"    # guard; flags = comparison operator
CEPH_OSD_OP_OMAPSETKEYS = "omap_setkeys"   # replicated pools only
CEPH_OSD_OP_OMAPRMKEYS = "omap_rmkeys"
CEPH_OSD_OP_OMAPGETVALS = "omap_getvals"
CEPH_OSD_OP_CALL = "call"            # object-class method (src/cls);
                                     # name = "cls.method", data = input
CEPH_OSD_OP_COPY_FROM = "copy_from"  # copy another object into this one
                                     # (PrimaryLogPG do_copy_from);
                                     # name = src oid, offset = src pool
CEPH_OSD_OP_ASSERT_VER = "assert_ver"  # guard: object version == offset
                                     # (mismatch -> -ERANGE, like
                                     # PrimaryLogPG.cc do_osd_ops
                                     # CEPH_OSD_OP_ASSERT_VER)
CEPH_OSD_OP_WATCH = "watch"          # register interest (cookie in offset)
CEPH_OSD_OP_UNWATCH = "unwatch"
CEPH_OSD_OP_NOTIFY = "notify"        # broadcast to watchers, await acks
CEPH_OSD_OP_PGLS = "pgls"            # list this PG's head objects
                                     # (CEPH_OSD_OP_PGNLS; data = cursor,
                                     # length = max entries)

# cmpxattr comparison operators (include/rados.h CEPH_OSD_CMPXATTR_OP_*)
CEPH_OSD_CMPXATTR_OP_EQ = 1
CEPH_OSD_CMPXATTR_OP_NE = 2
CEPH_OSD_CMPXATTR_OP_GT = 3
CEPH_OSD_CMPXATTR_OP_GTE = 4
CEPH_OSD_CMPXATTR_OP_LT = 5
CEPH_OSD_CMPXATTR_OP_LTE = 6

# create flags
CEPH_OSD_OP_FLAG_EXCL = 1


@dataclass
class OSDOp:
    """One op of an MOSDOp vector (the OSDOp struct in osd_types.h:
    opcode + extent + payload + xattr name, executed in order by the
    do_osd_ops interpreter)."""
    op: str = CEPH_OSD_OP_READ
    offset: int = 0
    length: int = 0
    data: bytes = b""
    name: str = ""           # xattr name
    flags: int = 0           # cmpxattr operator / create EXCL


@dataclass
class MOSDOp(Message):
    """Client -> primary OSD op (src/messages/MOSDOp.h).

    Carries either one legacy single op (``op``/``offset``/``length``/
    ``data``) or a multi-op vector (``ops``, like the reference's
    vector<OSDOp>) executed atomically in order."""
    tid: int = 0
    pool: int = 0
    oid: str = ""
    pgid: Tuple[int, int] = (0, 0)      # (pool, ps)
    op: str = CEPH_OSD_OP_READ
    offset: int = 0
    length: int = 0
    data: bytes = b""
    epoch: int = 0
    ops: List["OSDOp"] = field(default_factory=list)
    snapid: int = 0          # read at this pool snap (0 = head)
    # client-supplied write SnapContext for selfmanaged-snap pools
    # (MOSDOp snapc, src/messages/MOSDOp.h; empty = use the pool snapc)
    snapc_seq: int = 0
    snapc_snaps: List[int] = field(default_factory=list)


@dataclass
class MOSDOpReply(Message):
    tid: int = 0
    result: int = 0
    data: bytes = b""
    epoch: int = 0
    # per-op (result, data) for vector ops, parallel to MOSDOp.ops up to
    # the first failing op (the reference returns per-op rval/outdata)
    op_results: List[Tuple[int, bytes]] = field(default_factory=list)
    # object version at reply time (the reference's reply user_version);
    # stamped on stat replies so clients can build assert_ver guards
    version: int = 0
    # admission-control throttle hint (docs/QOS.md): result=-11 with
    # retry_after > 0 means "op was SHED at intake, back off this many
    # seconds and resend" — distinct from the peering EAGAIN, which the
    # Objecter answers with a map refresh.  Omitted from the wire when
    # 0.0 so the archived encoding corpus stays byte-identical.
    retry_after: float = 0.0


@dataclass
class MOSDECSubOpWrite(Message):
    """Primary -> shard EC write (src/messages/MOSDECSubOpWrite.h,
    payload ECSubWrite in osd/ECMsgTypes.h)."""
    tid: int = 0
    pgid: Tuple[int, int] = (0, 0)
    shard: int = 0
    oid: str = ""
    chunk: bytes = b""
    offset: int = 0          # chunk-granularity offset into the shard
    partial: bool = False    # False = whole-shard replace; True = rmw splice
    hash_epoch: int = 0
    at_version: int = 0      # logical object size after the write
    version: int = 0         # pg_log version of this mutation (0 = none)
    is_push: bool = False    # recovery push: stamp the version attr but
    trim_to: int = 0         # do not re-append the (already merged) log
    # user xattr / omap payload (attrs ride every shard like the
    # reference's ECSubWrite transactions; omap is replicated-only)
    xattrs: Optional[Dict[str, bytes]] = None   # full replacement set
    omap: Optional[Dict[str, bytes]] = None     # full replacement (rep only)
    attr_only: bool = False  # metadata-only mutation: leave the body alone
    # snapshot bookkeeping riding the same shard transaction: update the
    # PG meta snapset for (head_oid, packed_entries); b"" removes it
    snapset_update: Optional[Tuple[str, bytes]] = None
    snapset_only: bool = False  # pure meta message: touch no object


@dataclass
class MOSDECSubOpWriteReply(Message):
    tid: int = 0
    pgid: Tuple[int, int] = (0, 0)
    shard: int = 0
    committed: bool = True


@dataclass
class MOSDECSubOpRead(Message):
    """Primary -> shard EC read (ECSubRead payload)."""
    tid: int = 0
    pgid: Tuple[int, int] = (0, 0)
    shard: int = 0
    oid: str = ""
    offset: int = 0          # chunk-granularity offset into the shard
    length: int = 0          # 0 = to end of shard
    attrs_only: bool = False  # stat/size probe: no payload wanted
    subchunks: List[Tuple[int, int]] = field(default_factory=list)
    # >= 0: sub-chunk repair read — the helper computes and returns its
    # β-sub-chunk contribution toward rebuilding this shard id instead
    # of shipping the chunk (regenerating codes, docs/RECOVERY.md).
    # Omitted from the wire when -1, so pre-repair frames and the
    # pinned encoding corpus stay byte-identical.
    repair_for: int = -1


@dataclass
class MOSDECSubOpReadReply(Message):
    tid: int = 0
    pgid: Tuple[int, int] = (0, 0)
    shard: int = 0
    oid: str = ""
    data: bytes = b""
    result: int = 0
    attrs: Dict[str, bytes] = field(default_factory=dict)


@dataclass
class MOSDPGQuery(Message):
    """Primary -> acting shard: report your PG state (peering GetInfo,
    src/messages/MOSDPGQuery.h).  log_since >= 0 additionally requests the
    log suffix past that version (the GetLog step folded in)."""
    pgid: Tuple[int, int] = (0, 0)
    shard: int = -1
    epoch: int = 0
    log_since: int = -1
    # >= 0: before replying, rewind your divergent log entries past this
    # version and roll the touched objects back (rewind_divergent_log)
    rewind_to: int = -1


@dataclass
class MOSDPGInfo(Message):
    """Shard -> primary peering reply (MOSDPGInfo/MOSDPGLog roles):
    last_update/log_tail, the replica's own missing set (objects whose
    log entry was merged but whose data never arrived — pg_missing_t),
    and an optional serialized log suffix."""
    pgid: Tuple[int, int] = (0, 0)
    shard: int = -1
    epoch: int = 0
    last_update: int = 0
    log_tail: int = 0
    log_entries: List[bytes] = field(default_factory=list)
    missing_oids: List[Tuple[str, int]] = field(default_factory=list)
    # per-head snapset blobs: clone bookkeeping must survive primary
    # failover/backfill, so it rides peering like the log does
    snapsets: List[Tuple[str, bytes]] = field(default_factory=list)
    # snaps this replica knows were fully trimmed
    # (pg_info_t.purged_snaps role) — unioned at peering so a primary
    # that died mid-trim is finished by its successor, never redone
    purged_snaps: List[int] = field(default_factory=list)
    # backfill completion (last_backfill == MAX role): the target holds
    # every object the primary knew, so it adopts the primary's log
    # WHOLESALE (entries + head + tail) — without this a pushed-only
    # shard keeps last_update 0 and every later peering re-treats it as
    # missing everything
    adopt_log: bool = False
    # which EC shard collections this OSD actually HOLDS data for —
    # acting positions can shuffle on remap, and the pg_log alone can't
    # tell a data-bearing replica from a freshly assigned one
    held_shards: List[int] = field(default_factory=list)


@dataclass
class MOSDPGNotify(Message):
    """Stray -> primary: I hold data for a PG I no longer serve
    (MOSDPGNotify stray-notify role).  The primary answers with
    MOSDPGRemove once the PG is clean everywhere it IS served."""
    pgid: Tuple[int, int] = (0, 0)
    epoch: int = 0
    from_osd: int = -1
    held_shards: List[int] = field(default_factory=list)
    # the stray's pg_log head: a primary must never authorize deleting
    # a copy NEWER than what it can serve itself
    last_update: int = 0


@dataclass
class MOSDPGRemove(Message):
    """Primary -> stray: your copy is no longer needed; delete it
    (src/messages/MOSDPGRemove.h; OSD::_remove_pg role)."""
    pgid: Tuple[int, int] = (0, 0)
    epoch: int = 0


@dataclass
class MOSDPGScan(Message):
    """Primary -> shard: list your objects (backfill scan,
    src/messages/MOSDPGScan.h)."""
    pgid: Tuple[int, int] = (0, 0)
    shard: int = -1
    epoch: int = 0


@dataclass
class MOSDPGScanReply(Message):
    pgid: Tuple[int, int] = (0, 0)
    shard: int = -1
    epoch: int = 0
    objects: List[Tuple[str, int]] = field(default_factory=list)
    # (oid, version) per object on the shard


@dataclass
class MWatchNotify(Message):
    """Watch/notify events (src/messages/MWatchNotify.h): the primary
    fans NOTIFY to every watcher's client; watchers reply NOTIFY_ACK;
    the primary completes the notifier once every live watcher acked
    (Watch.cc / PrimaryLogPG::do_osd_op_effects roles)."""
    NOTIFY = "notify"
    ACK = "notify_ack"
    op: str = NOTIFY
    pgid: Tuple[int, int] = (0, 0)
    oid: str = ""
    cookie: int = 0
    notify_id: int = 0
    payload: bytes = b""


@dataclass
class MOSDPGTemp(Message):
    """Primary -> mon: pin this PG's acting set to *temp* until the
    data realigns (OSD::send_pg_temp / MOSDPGTemp.h; empty temp clears
    the pin).  The choose_acting answer when CRUSH shuffles surviving
    shards to new positions."""
    pgid: Tuple[int, int] = (0, 0)
    epoch: int = 0
    temp: List[int] = field(default_factory=list)


@dataclass
class MOSDRepScrub(Message):
    """Primary -> shard: build and return a scrub map of your chunks
    (src/messages/MOSDRepScrub.h role).  ``deep`` mirrors the
    reference's shallow/deep split (PG::Scrubber::deep): shallow
    compares metadata only (size/attrs/omap digests, no data read);
    deep additionally reads every object and checksums the bytes."""
    pgid: Tuple[int, int] = (0, 0)
    shard: int = -1
    epoch: int = 0
    deep: bool = False


@dataclass
class MOSDRepScrubMap(Message):
    """Shard -> primary scrub results (ScrubMap role): per object the
    stored size, whether the shard's local integrity check passed
    (HashInfo crc on deep, HashInfo-total-vs-size on shallow), the data
    digest (crc32c; -1 on shallow scrubs, which never read data), and
    the attr/omap digests for cross-replica metadata comparison."""
    pgid: Tuple[int, int] = (0, 0)
    shard: int = -1
    epoch: int = 0
    objects: List[Tuple[str, int, bool, int, int, int, bool]] = \
        field(default_factory=list)
    # (oid, size, local_ok, data_digest, attrs_digest, omap_digest,
    #  digest_validated) — the last flag marks copies whose bytes
    #  provably match a write-time recorded digest (hinfo / data_digest)
    deep: bool = False


@dataclass
class MOSDPing(Message):
    """OSD<->OSD heartbeat (src/messages/MOSDPing.h)."""
    PING = "ping"
    PING_REPLY = "ping_reply"
    op: str = PING
    stamp: float = 0.0
    epoch: int = 0


@dataclass
class MOSDFailure(Message):
    """OSD -> mon failure report (src/messages/MOSDFailure.h).

    ``reporter`` survives peon->leader forwarding (src is stomped by
    every send), keeping the reporter-quorum count honest."""
    target_osd: int = -1
    failed_since: float = 0.0
    epoch: int = 0
    reporter: str = ""


@dataclass
class MMonElection(Message):
    """Mon <-> mon election (src/mon/Elector.cc / MMonElection.h roles):
    propose/ack/victory; lowest reachable rank wins."""
    OP_PROPOSE = "propose"
    OP_ACK = "ack"
    OP_VICTORY = "victory"
    op: str = OP_PROPOSE
    epoch: int = 0              # election epoch (odd = electing, even = won)
    rank: int = -1
    quorum: List[int] = field(default_factory=list)


@dataclass
class MMonPaxos(Message):
    """Mon <-> mon map replication (src/mon/Paxos.cc phases, simplified
    to the leader-driven begin/accept/commit + collect recovery)."""
    OP_COLLECT = "collect"
    OP_LAST = "last"
    OP_BEGIN = "begin"
    OP_ACCEPT = "accept"
    OP_COMMIT = "commit"
    op: str = OP_COLLECT
    rank: int = -1
    pn: int = 0                 # proposal number (election epoch based)
    last_committed: int = 0
    values: List[Any] = field(default_factory=list)
    # values = incremental dicts (osdmap/encoding) being replicated
    # LAST replies also surface any staged-but-uncommitted value so a
    # new leader can finish a possibly-majority-accepted proposal
    # (Paxos.cc handle_last uncommitted_v/uncommitted_pn)
    uncommitted_pn: int = -1
    uncommitted_value: Optional[Any] = None


@dataclass
class MOSDBoot(Message):
    """OSD -> mon: I am alive, mark me up (src/messages/MOSDBoot.h;
    sent at init and when a live osd sees itself marked down)."""
    osd: int = -1
    epoch: int = 0


@dataclass
class MMonSubscribe(Message):
    """Client/daemon -> mon: subscribe to map updates and get the full
    history now (src/messages/MMonSubscribe.h, 'osdmap' what)."""
    what: str = "osdmap"


@dataclass
class MMonCommand(Message):
    """Client -> mon administrative command (src/messages/
    MMonCommand.h; the 'ceph tell mon' / librados mon_command path).
    ``cmd`` names a registered mon command, ``args`` its parameters."""
    tid: int = 0
    cmd: str = ""
    args: Dict[str, Any] = field(default_factory=dict)
    # set when a peon relays the command to the leader (MForward role,
    # src/messages/MForward.h): the original client the ack must reach
    reply_to: str = ""


@dataclass
class MMonCommandAck(Message):
    """Mon -> client command completion (MMonCommandAck.h): result
    errno + a JSON-ish payload dict.  ``reply_to`` mirrors the request's
    relay field: a peon receiving an ack with it set forwards the ack to
    that client (the route_message leg of MForward)."""
    tid: int = 0
    result: int = 0
    data: Dict[str, Any] = field(default_factory=dict)
    reply_to: str = ""


@dataclass
class MPGStats(Message):
    """OSD -> mgr per-PG usage stats (src/messages/MPGStats.h role):
    each primary reports its PGs' object counts and logical bytes, the
    mgr aggregates per pool — the usage feed for pg_autoscaler and
    `ceph df`-style accounting."""
    osd: int = -1
    epoch: int = 0
    # [(pool, ps, num_objects, num_bytes)]
    pg_stats: List[Tuple[int, int, int, int]] = field(default_factory=list)
    # osd_stat_t role: logical bytes stored on this OSD and its
    # configured capacity (0 = unlimited) for full-ratio accounting
    store_bytes: int = 0
    store_capacity: int = 0


@dataclass
class MLog(Message):
    """Daemon -> mon cluster-log entry (src/messages/MLog.h role):
    queued by the leader and paxos-committed with the next epoch, so
    `ceph log last` reads one replicated, failover-proof history."""
    who: str = ""
    level: str = "INF"          # DBG/INF/WRN/ERR (clog levels)
    message: str = ""
    stamp: float = -1.0         # sender clock; -1 = unset (0.0 is a
    # legitimate time-zero stamp and must survive the fan-in dedup)


@dataclass
class MMonPing(Message):
    """Mon <-> mon liveness (the elector's keepalives)."""
    PING = "ping"
    REPLY = "reply"
    op: str = PING
    rank: int = -1
    stamp: float = 0.0


@dataclass
class MOSDMap(Message):
    """Mon -> everyone map publication (src/messages/MOSDMap.h); carries
    incrementals from ``first`` to ``last``."""
    first: int = 0
    last: int = 0
    incrementals: List[Any] = field(default_factory=list)


@dataclass
class MClientRequest(Message):
    """Client -> MDS metadata operation (src/messages/MClientRequest.h
    role): ``op`` names an MDS handler (mkdir/create/open/...), ``args``
    its parameters.  Every metadata mutation crosses the MDS — clients
    never write the metadata pool directly in MDS mode."""
    tid: int = 0
    op: str = ""
    args: Dict[str, Any] = field(default_factory=dict)
    # stable across failover retries: the promoted MDS dedups mutating
    # ops it already replayed from the journal by this id
    reqid: str = ""


@dataclass
class MClientReply(Message):
    """MDS -> client completion (MClientReply.h): errno-style result
    plus a JSON-ish payload (inode attrs, cap grant, snap context)."""
    tid: int = 0
    result: int = 0
    data: Dict[str, Any] = field(default_factory=dict)


@dataclass
class MClientCaps(Message):
    """MDS <-> client capability traffic (MClientCaps.h role).

    op: 'revoke' (MDS asks the holder to drop ``caps``; the holder
    flushes buffered data first), 'flush' (client -> MDS: buffered
    state written back, carries the wrstat payload), 'grant' (MDS ->
    client: caps now held).  ``seq`` orders revoke/flush rounds."""
    OP_REVOKE = "revoke"
    OP_FLUSH = "flush"
    OP_GRANT = "grant"
    op: str = ""
    ino: int = 0
    caps: int = 0
    seq: int = 0
    data: Dict[str, Any] = field(default_factory=dict)


# cephfs capability bits (a lite slice of CEPH_CAP_*)
CEPH_CAP_FILE_CACHE = 1     # may cache reads
CEPH_CAP_FILE_BUFFER = 2    # may buffer writes (write-back)


@dataclass
class MMDSBeacon(Message):
    """MDS -> mon liveness + state beacon (src/messages/MMDSBeacon.h
    role): the MDSMonitor builds the fsmap from these — first beacon
    becomes active, later ones standby, and a stale active is failed
    over to a live standby."""
    name: str = ""
    state: str = "standby"      # what the daemon believes it is
    seq: int = 0


@dataclass
class MCommand(Message):
    """Client -> any daemon administrative command
    (src/messages/MCommand.h; the 'ceph tell osd.N' path): runtime
    introspection/reconfiguration of a LIVE daemon over the wire."""
    tid: int = 0
    cmd: str = ""
    args: Dict[str, Any] = field(default_factory=dict)


@dataclass
class MCommandReply(Message):
    """Daemon -> client command completion (MCommandReply.h)."""
    tid: int = 0
    result: int = 0
    data: Dict[str, Any] = field(default_factory=dict)
