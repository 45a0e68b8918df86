"""MDS-lite — the metadata server daemon for cephfs.

The reference's cephfs is MDS-mediated (src/mds/MDSDaemon.cc): clients
hold CAPABILITIES issued by the Locker (src/mds/Locker.cc) that gate
caching and write-back, every metadata mutation funnels through the MDS
(which persists dentries to the metadata pool and write-ahead-logs each
op in the MDS journal, src/mds/MDLog.cc), and snapshots attach to any
directory via the SnapRealm hierarchy (src/mds/SnapRealm.h).  This is
that architecture at lite scale:

- ONE metadata authority: the daemon owns a CephFS backend (the
  cls_fs-based engine) as the sole metadata-pool writer; clients speak
  MClientRequest/MClientReply and never touch metadata objects.
- Locker-lite capabilities: CEPH_CAP_FILE_BUFFER (exclusive write-back)
  conflicts with everything; CEPH_CAP_FILE_CACHE (shared read-cache)
  conflicts with BUFFER.  Conflicting opens trigger a revoke round —
  the holder flushes its buffered data to the DATA pool directly, then
  sends MClientCaps(flush) carrying the wrstat payload; the blocked
  request resumes once every revoke is acked (Locker::issue_caps +
  file_update_finish shape).  Holders that never ack are evicted after
  ``session_timeout`` (Session::is_stale eviction).
- MDS journal: every mutating op is appended to a Journaler ("mdlog")
  in the metadata pool BEFORE it is applied; a restarted daemon
  replays uncommitted events idempotently (MDLog replay).  This also
  makes cross-directory rename crash-safe: the two dentry updates are
  one journaled event, and only the (single-writer) MDS applies them,
  so no client can observe the intermediate state through the MDS.
- SnapRealm-lite: `snap_create(path, name)` records (md_sid, data_sid)
  in the realm table of that DIRECTORY; a file's write SnapContext is
  the union of the data snaps on its ancestor realm chain, handed to
  clients at open.  Files outside the subtree keep writing with a
  snapc that excludes the new snap, so no clone of them is preserved —
  per-directory snapshots fall out of per-file snap contexts.
"""
from __future__ import annotations

import json
import time
from typing import Dict, List, Optional, Set, Tuple

from ..cephfs.client import CephFS, FsError
from ..cephfs.cls_fs import ROOT_INO, dir_oid, file_oid
from ..client.rados import RadosClient
from ..msg.messages import (
    CEPH_CAP_FILE_BUFFER, CEPH_CAP_FILE_CACHE, MClientCaps,
    MClientReply, MClientRequest, MCommand, MCommandReply, Message,
)

MDLOG_ID = "mdlog"
REALM_PREFIX = "fs_realm."


def realm_oid(ino: int) -> str:
    return f"{REALM_PREFIX}{ino:x}"


def _j(obj) -> bytes:
    return json.dumps(obj, sort_keys=True).encode()


# ops that mutate metadata and therefore ride the MDS journal
_JOURNALED = {"mkdir", "create", "symlink", "hardlink", "unlink",
              "rmdir", "rename", "setattr", "wrstat", "truncate",
              "snap_create", "snap_remove", "set_dir_pin",
              "set_quota", "set_layout"}
# ops answered read-only
_READONLY = {"stat", "listdir", "readlink", "resolve", "exists",
             "lssnap", "open", "release", "walk_snapc", "get_quota"}

# ops that add a dentry — gated by ancestor max_files quotas
# (Client.cc:11502/11636 is_quota_files_exceeded; authority-side here)
_CREATES_DENTRY = {"mkdir", "create", "symlink", "hardlink"}

# the request key that names the op's PRIMARY path — the one whose
# subtree authority decides which rank serves it (Server::
# dispatch_client_request routing by dentry auth)
_PATH_KEY = {"rename": "src", "hardlink": "existing"}

# MClientReply.result for "not my subtree — retry at rank N" (the
# lite form of MClientRequestForward); data carries forward_rank and,
# when known, the serving daemon's name
MDS_FORWARD = -2001


class MDSDaemon:
    """The mds-lite daemon: metadata authority + Locker + MDLog +
    SnapRealms.  Event-driven like Monitor/OSD: register on a network,
    pump delivers requests, ``tick(now)`` drives session timeouts."""

    def __init__(self, network, rados: RadosClient, name: str = "mds.0",
                 metadata_pool: str = "fsmeta", data_pool: str = "fsdata",
                 mkfs: bool = False, session_timeout: float = 20.0,
                 rank: int = 0):
        from ..journal import Journaler
        from ..trace import g_perf_histograms, latency_axes
        self.network = network
        self.name = name
        # per-daemon request-latency histogram, resolved once (same
        # pattern as OSD.hist_op_w — keeps the registry lock off the
        # per-request hot path)
        self._hist_req = g_perf_histograms.get(
            name, "req_latency_histogram", latency_axes)
        # ALL dispatch-visible state must exist before the messenger
        # registration: construction below does rados IO whose pumps
        # can deliver client requests to ms_fast_dispatch mid-__init__
        self._inbox: List[Message] = []
        self.caps = {}
        self.cap_seq = 0
        self.revoking = {}
        self.waiting = {}
        self.now = 0.0
        self.messenger = network.create_messenger(name)
        self.messenger.add_dispatcher_head(self)
        self.rados = rados
        # daemon mode shares ONE entity name between the MDS service
        # and its rados client (vstart "mds.0"): we hold the dispatcher
        # slot, so everything that isn't MDS traffic (MOSDOpReply, map
        # pushes, command acks) must fall through to the rados client
        self._fallthrough = rados if getattr(rados, "name", None) == \
            name else None
        self.mdpool = metadata_pool
        self.dpool = data_pool
        self.fs = CephFS(rados, metadata_pool, data_pool)
        self.session_timeout = session_timeout
        # subtree authority: this daemon serves RANK ``rank`` of the
        # fs (mds_rank_t); ranks partition the namespace by directory
        # pins (ceph.dir.pin vxattr / MDSMonitor fsmap ranks).  Each
        # rank journals to its OWN mdlog (the reference's per-rank
        # 0x200+rank journal inos); rank 0 keeps the legacy name so
        # single-active clusters are unchanged on disk.
        self.rank = rank
        self.mds_map: Dict[int, str] = {rank: name}
        self._cap_paths: Dict[int, str] = {}
        jname = MDLOG_ID if rank == 0 else f"{MDLOG_ID}.{rank}"
        self.journal = Journaler(rados, metadata_pool, jname,
                                 entries_per_object=128)
        from ..journal import JournalError
        if mkfs and rank == 0:
            try:
                self.fs.mkfs()
            except FsError as e:
                # a RETRIED boot (journal/PG settling killed the
                # previous attempt after mkfs landed) must not wedge
                # on its own half-finished init
                if e.result != -17:
                    raise
        # open-or-create: a freshly promoted rank (or first boot)
        # creates its journal; a rebooted one opens and replays
        try:
            self.journal.open()
        except JournalError as e:
            # only a first boot (mkfs) or a freshly promoted rank > 0
            # may create its journal; a plain rank-0 reboot with a
            # MISSING journal is a misconfiguration (wrong pool, lost
            # data) that must fail loudly, never silently skip replay
            if e.result != -2 or not (mkfs or rank > 0):
                raise
            try:
                self.journal.create(order=20, splay_width=2)
            except JournalError as e2:
                if e2.result != -17:
                    raise
                self.journal.open()   # a racing boot already made it
        try:
            self.journal.register_client("mds")
        except JournalError as e:
            if e.result != -17:
                raise
        # caps: ino -> {client: capbits}; revokes: ino -> {client:
        # (seq, issued_at)} with issued_at None until the first tick
        # supplies a clock; _inbox: dispatch only ENQUEUES (handlers do
        # blocking rados IO which cannot run nested inside a pump) —
        # all initialized above, before the messenger registration.
        #
        # completed request ids: mutating ops journal their reqid, so
        # a PROMOTED standby that replayed the journal can answer a
        # client's failover retry instead of re-executing it (the
        # reference persists completed_requests in the session map)
        from collections import OrderedDict
        self._completed: "OrderedDict[str, bool]" = OrderedDict()
        self._replay()

    # ---- journal (MDLog) ---------------------------------------------------
    def _replay(self) -> None:
        """Re-apply uncommitted journal events (MDLog replay after a
        crash).  Events are idempotent: already-applied mutations
        answer EEXIST/ENOENT and are treated as done."""
        committed = -1
        md = self.journal.get_metadata()
        cl = md.get("clients", {}).get("mds")
        if cl is None:
            self.journal.register_client("mds")
        else:
            committed = cl["commit_tid"]
        # ONE read of the retained journal serves both passes.
        # reqids are remembered for EVERY event, even committed ones
        # (a failover retry can reference an op the dead active
        # journaled AND committed) and tolerate gaps; the APPLY pass
        # keeps the strict gap rule FROM THE COMMIT POINT (events past
        # a gap are not safe to apply in order).
        raw = self.journal.scan_entries()
        # annul accounting: an op whose apply FAILED left its frame in
        # the journal plus an __annul__ record; a reqid counts as
        # applied only if it has more op frames than annuls (so a
        # failed attempt can never replay into a phantom success)
        frames: Dict[str, int] = {}
        annuls: Dict[str, int] = {}
        annulled_tids: Dict[int, int] = {}
        docs = []
        for tid_, payload in raw:
            try:
                doc = json.loads(payload)
            except ValueError:
                continue
            docs.append((tid_, doc))
            rid = doc.get("reqid")
            if doc.get("op") == "__annul__":
                if rid:
                    annuls[rid] = annuls.get(rid, 0) + 1
                ft = int(doc.get("for", -1))
                annulled_tids[ft] = annulled_tids.get(ft, 0) + 1
            elif rid:
                frames[rid] = frames.get(rid, 0) + 1
        for rid, n in frames.items():
            if n > annuls.get(rid, 0):
                self._remember(rid)
        entries = {t: d for t, d in docs if d.get("op") != "__annul__"}
        last = committed
        tid = committed + 1
        while tid in entries:
            ev = entries[tid]
            if annulled_tids.get(tid, 0) >= 1:
                # the failed attempt's frame: its effects never
                # happened; replaying could apply them now
                last = tid
                tid += 1
                continue
            try:
                self._apply(ev["op"], ev["args"])
            except FsError as e:
                if e.result not in (-17, -2, -39):
                    raise
            last = tid
            tid += 1
        if last > committed:
            self.journal.commit("mds", last)
        # frames appended after THIS scan belong to racing writers;
        # the duplicate fence only needs to look there
        self._boot_next_tid = getattr(self.journal, "_next_tid", 0)

    def _remember(self, reqid: str) -> None:
        self._completed[reqid] = True
        while len(self._completed) > 4096:
            self._completed.popitem(last=False)

    def _applied_elsewhere(self, reqid: str) -> bool:
        """Duplicate-apply fence: does *reqid* have an APPLIED journal
        frame besides the one the current invocation just wrote?
        Counts op frames minus __annul__ records minus our own
        attempt; scans fresh reads bounded to frames appended after
        our startup scan (only racing writers can live there — older
        applied frames already populated the memo at boot)."""
        boot = getattr(self, "_boot_next_tid", 0)
        needle = reqid.encode()
        frames = annuls = 0
        try:
            for tid_, payload in self.journal.scan_entries():
                if tid_ < boot or needle not in payload:
                    continue
                try:
                    doc = json.loads(payload)
                except ValueError:
                    continue
                if doc.get("reqid") != reqid:
                    continue
                if doc.get("op") == "__annul__":
                    annuls += 1
                else:
                    frames += 1
        except IOError:
            return False
        return frames - annuls - 1 > 0    # minus our own attempt

    def _journal_and_apply(self, op: str, args: Dict,
                           reqid: str = ""):
        ev = {"op": op, "args": args}
        if reqid:
            ev["reqid"] = reqid
        tid = self.journal.append(_j(ev))
        try:
            out = self._apply(op, args)
        except FsError as e:
            # duplicate-apply fence: a deposed incumbent can land a
            # mutation in OUR journal after our startup scan (the
            # dual-writer window before it fences).  An already-
            # exists-class failure is a duplicate iff the reqid has an
            # APPLIED frame besides ours (frames minus annuls minus
            # our own attempt) — answer from effect like the memo path
            if e.result in (-17, -2, -39) and reqid and \
                    self._applied_elsewhere(reqid):
                self.journal.commit("mds", tid)
                self._remember(reqid)
                return self._replayed_reply(op, args)
            # record the failure so no later consumer (startup memo,
            # replay, fence) mistakes this attempt's frame for effect
            self.journal.append(_j({"op": "__annul__", "for": tid,
                                    "reqid": reqid}))
            raise
        self.journal.commit("mds", tid)
        if reqid:
            self._remember(reqid)
        return out

    # ---- dispatch ----------------------------------------------------------
    def ms_fast_dispatch(self, msg: Message) -> None:
        if isinstance(msg, MCommand):
            # SYNCHRONOUS, unlike client traffic: the command handler
            # does no rados IO, so it is safe inside the pump — and a
            # blocked 'ceph tell' client could never drive process()
            self._handle_command(msg)
        elif isinstance(msg, (MClientRequest, MClientCaps)):
            self._inbox.append(msg)
        elif self._fallthrough is not None:
            self._fallthrough.ms_fast_dispatch(msg)

    def ms_dispatch(self, msg: Message) -> None:  # pragma: no cover
        self.ms_fast_dispatch(msg)

    def process(self) -> int:
        """Drain queued client traffic (the dispatch/workqueue split:
        handlers run OUTSIDE the network pump so their own rados round
        trips can pump freely).  Returns messages handled."""
        n = 0
        while self._inbox:
            msg = self._inbox.pop(0)
            n += 1
            if isinstance(msg, MClientRequest):
                self._handle_request(msg)
            else:
                self._handle_caps(msg)
        return n

    def _handle_command(self, msg) -> None:
        """'ceph tell mds.<name>' (MCommand.h): runtime config and
        introspection on a live metadata server.  The config
        vocabulary (incl. atomic injectargs) is
        ConfigProxy.handle_config_command, shared with the OSD."""
        from ..common.config import g_conf
        result, data = g_conf.run_daemon_command(msg.cmd, msg.args, {
            "session ls": lambda: {"sessions": sorted(
                {c for holders in self.caps.values()
                 for c in holders})},
            "status": lambda: {"name": self.name, "rank": self.rank,
                               "mds_map": {str(r): n for r, n
                                           in self.mds_map.items()}},
        })
        self.messenger.send_message(
            MCommandReply(tid=msg.tid, result=result, data=data),
            msg.src)

    # ---- subtree authority (multi-active ranks) ----------------------------
    def set_mds_map(self, ranks: Dict[int, str]) -> None:
        """Current rank->daemon map from the fsmap ('ceph fs status'):
        pins to ranks outside this map are ignored, exactly like the
        reference ignoring export_pin targets beyond max_mds."""
        self.mds_map = {int(r): n for r, n in ranks.items()}
        if self.rank not in self.mds_map:
            self.mds_map[self.rank] = self.name

    def _auth_rank(self, path: str) -> int:
        """The rank authoritative for *path*: the deepest ancestor
        directory pin along the (existing) path, rank 0 otherwise —
        static export pins as the lite MDBalancer (CInode::
        get_export_pin / Migrator policy at lite scale)."""
        auth = 0
        cur = ROOT_INO
        try:
            parts = self.fs._split(path)
        except FsError:
            return auth
        for part in parts:
            try:
                inode = self.fs._lookup(cur, part)
            except FsError:
                break
            pin = inode.get("pin")
            if inode.get("type") != "dir":
                break
            if pin is not None and int(pin) in self.mds_map:
                auth = int(pin)
            cur = inode["ino"]
        return auth

    def _route(self, op: str, args: Dict) -> Optional[int]:
        """None = ours; else the rank to forward to.  Single-rank maps
        short-circuit (no lookups on the hot path)."""
        if len(self.mds_map) <= 1:
            return None
        path = args.get(_PATH_KEY.get(op, "path"))
        if not isinstance(path, str):
            return None              # ino-addressed (release): local
        auth = self._auth_rank(path)
        return None if auth == self.rank else auth

    def _subtree_cap_inos(self, path: str) -> List[int]:
        """Inos with outstanding caps under *path* (handoff drain)."""
        prefix = "/" + "/".join(self.fs._split(path))
        out = []
        for ino, p in self._cap_paths.items():
            if not self.caps.get(ino):
                continue
            q = "/" + "/".join(self.fs._split(p))
            if q == prefix or q.startswith(prefix + "/"):
                out.append(ino)
        return out

    def _op_set_dir_pin(self, msg: MClientRequest,
                        args: Dict) -> Optional[Dict]:
        """Repin a subtree to another rank — the journaled handoff
        (Migrator::export_dir at lite scale).  Outstanding caps under
        the subtree are revoked and flushed FIRST, so the new
        authority never sees a writer it doesn't know about; the pin
        itself is one journaled event."""
        rank = int(args["rank"])
        inode = self.fs._resolve(args["path"], follow_final=True)
        if inode["type"] != "dir":
            raise FsError("set_dir_pin", -20)        # ENOTDIR
        if self._drain_caps(msg, self._subtree_cap_inos(args["path"])):
            return None
        return self._journal_and_apply(
            "set_dir_pin", {"path": args["path"], "rank": rank},
            getattr(msg, "reqid", ""))

    def _drain_caps(self, msg: MClientRequest, held: List[int]) -> bool:
        """Start revoke rounds on every held ino; True = *msg* parked
        (re-dispatched by _kick once the first ino drains; the re-run
        re-checks the remaining holders)."""
        parked_on = None
        for ino in held:
            holders = self.caps.get(ino, {})
            pending = self.revoking.setdefault(ino, {})
            for other in [c for c in holders if c not in pending]:
                self.cap_seq += 1
                pending[other] = (self.cap_seq,
                                  self.now if self.now else None)
                self.messenger.send_message(MClientCaps(
                    op=MClientCaps.OP_REVOKE, ino=ino,
                    caps=holders[other], seq=self.cap_seq), other)
            if pending and parked_on is None:
                parked_on = ino
            elif not pending:
                self.revoking.pop(ino, None)
        if parked_on is not None:
            self.waiting.setdefault(parked_on, []).append(msg)
            return True
        return False

    def beacon(self, mons, state: str = "active") -> None:
        """MMDSBeacon to every mon (MDSDaemon::beacon_send): liveness
        for the MDSMonitor's fsmap — a silent active gets failed over
        to a standby."""
        from ..msg.messages import MMDSBeacon
        self._beacon_seq = getattr(self, "_beacon_seq", 0) + 1
        for m in mons:
            self.messenger.send_message(MMDSBeacon(
                name=self.name, state=state,
                seq=self._beacon_seq), m)

    def tick(self, now: float) -> None:
        """Evict sessions that never acked a revoke (stale session
        eviction): their caps are dropped so the fs cannot wedge on a
        dead client; their buffered data is lost, like the reference
        evicting a stale session."""
        self.now = now
        for ino, m in list(self.revoking.items()):
            for client, (seq, issued) in list(m.items()):
                if issued is None:
                    # revoke predates our first clock reading: the
                    # grace period starts NOW
                    m[client] = (seq, now)
                elif now - issued > self.session_timeout:
                    del m[client]
                    self.caps.get(ino, {}).pop(client, None)
                    if not self.caps.get(ino):
                        self._cap_paths.pop(ino, None)
            if not m:
                del self.revoking[ino]
                self._kick(ino)

    # ---- capabilities (Locker-lite) ---------------------------------------
    def _issue(self, client: str, ino: int, want: int,
               msg: MClientRequest) -> Optional[int]:
        """Grant *want* caps to *client*, revoking conflicts first.
        Returns the granted bits, or None if the request must wait for
        a revoke round (it has been parked)."""
        holders = self.caps.setdefault(ino, {})
        conflicts = []
        for other, bits in holders.items():
            if other == client:
                continue
            if want & CEPH_CAP_FILE_BUFFER:
                conflicts.append(other)          # BUFFER is exclusive
            elif bits & CEPH_CAP_FILE_BUFFER:
                conflicts.append(other)          # CACHE vs their BUFFER
        pending = self.revoking.setdefault(ino, {})
        newly = [c for c in conflicts if c not in pending]
        for other in newly:
            self.cap_seq += 1
            pending[other] = (self.cap_seq,
                              self.now if self.now else None)
            self.messenger.send_message(MClientCaps(
                op=MClientCaps.OP_REVOKE, ino=ino,
                caps=holders[other], seq=self.cap_seq), other)
        if pending:
            self.waiting.setdefault(ino, []).append(msg)
            return None
        if not self.revoking.get(ino):
            self.revoking.pop(ino, None)
        holders[client] = holders.get(client, 0) | want
        return holders[client]

    def _handle_caps(self, msg: MClientCaps) -> None:
        if msg.op != MClientCaps.OP_FLUSH:
            return
        ino = msg.ino
        # only a CURRENT cap holder (or a revoke still outstanding)
        # may flush: an evicted client's delayed flush must not roll
        # metadata back under the new holder's feet
        if msg.src not in self.caps.get(ino, {}) and \
                msg.src not in self.revoking.get(ino, {}):
            return
        # the flush carries the holder's write-back results (wrstat):
        # journal + apply them before anyone else touches the file.
        # The ino's CURRENT path (our cap bookkeeping, kept fresh
        # across renames) outranks the client's open-time path — the
        # reference's cap flushes are ino-addressed for this reason.
        path = self._cap_paths.get(ino) or msg.data.get("path")
        if path is not None and "size" in msg.data:
            try:
                self._journal_and_apply("wrstat", {
                    "path": path,
                    "size": msg.data["size"],
                    "mtime": msg.data.get("mtime", time.time())})
            except FsError:
                pass             # file unlinked while caps were out
        m = self.revoking.get(ino)
        if m is not None:
            m.pop(msg.src, None)
            if not m:
                del self.revoking[ino]
        self.caps.get(ino, {}).pop(msg.src, None)
        if not self.caps.get(ino):
            self.caps.pop(ino, None)
            self._cap_paths.pop(ino, None)
        self._kick(ino)

    def _kick(self, ino: int) -> None:
        for req in self.waiting.pop(ino, []):
            self._handle_request(req)

    # ---- request handling --------------------------------------------------
    def _reply(self, msg: MClientRequest, result: int,
               data: Optional[Dict] = None) -> None:
        self.messenger.send_message(MClientReply(
            tid=msg.tid, result=result, data=data or {}), msg.src)

    def _handle_request(self, msg: MClientRequest) -> None:
        """Instrumented intake: every request lands one sample in the
        per-daemon request-latency histogram, and (tracer on) runs
        under a span parented by the client's (Server.cc
        handle_client_request's mds_server perf counters + blkin
        trace role)."""
        from ..trace import g_tracer
        t0 = time.perf_counter()
        if g_tracer.enabled:
            with g_tracer.span(f"mds_req:{msg.op}", daemon=self.name,
                               trace_id=msg.trace_id,
                               parent_id=msg.parent_span_id):
                self._do_handle_request(msg)
        else:
            self._do_handle_request(msg)
        self._hist_req.inc((time.perf_counter() - t0) * 1e6)

    def _do_handle_request(self, msg: MClientRequest) -> None:
        op, args = msg.op, dict(msg.args)
        try:
            reqid = getattr(msg, "reqid", "")
            if op in _JOURNALED and reqid \
                    and reqid in self._completed:
                # a failover retry of an op WE already journaled (or
                # replayed): answer from effect, never re-execute
                # (mkdir would EEXIST, rename would ENOENT, snap ids
                # would double-allocate).  Checked BEFORE routing —
                # the subtree may have been repinned since the
                # original ran, and forwarding the retry would
                # re-execute it on the new auth rank.
                self._reply(msg, 0, self._replayed_reply(op, args))
                return
            fwd = self._route(op, args)
            if fwd is not None:
                # not our subtree: point the client at the auth rank
                # (MClientRequestForward at lite scale)
                self._reply(msg, MDS_FORWARD, {
                    "forward_rank": fwd,
                    "mds": self.mds_map.get(fwd, "")})
                return
            if op == "set_dir_pin":
                out = self._op_set_dir_pin(msg, args)
                if out is None:
                    return           # parked on the cap drain
            elif op == "open":
                out = self._op_open(msg, args)
                if out is None:
                    return               # parked on a revoke round
            elif op == "release":
                ino = int(args["ino"])
                self.caps.get(ino, {}).pop(msg.src, None)
                if not self.caps.get(ino):
                    self._cap_paths.pop(ino, None)
                out = {}
            elif op == "wrstat" and not self._wrstat_allowed(msg,
                                                             args):
                self._reply(msg, -13, {"error": "stale cap flush"})
                return
            elif op in _JOURNALED:
                if op in _CREATES_DENTRY:
                    self._check_files_quota(
                        args["newpath"] if op == "hardlink"
                        else args["path"])
                if op == "truncate":
                    # setattr-size growth rides byte quotas
                    # (Client.cc:6660-6664)
                    inode = self.fs._resolve(args["path"],
                                             follow_final=True)
                    growth = int(args["size"]) - \
                        int(inode.get("size", 0))
                    if growth > 0:
                        for q in self._quota_chain(args["path"]):
                            if q["max_bytes"] and \
                                    q["used_bytes"] + growth > \
                                    q["max_bytes"]:
                                raise FsError("quota", -122)
                if op == "rename":
                    self._check_rename_quota(args["src"],
                                             args["dst"])
                if op == "rename" and len(self.mds_map) > 1 and \
                        self._auth_rank(args["dst"]) != self.rank:
                    # a rename OUT of our authority moves any open
                    # handle beyond our cap bookkeeping's reach — the
                    # destination auth could never drain it.  Revoke
                    # + flush first, like the set_dir_pin handoff.
                    if self._drain_caps(msg, self._subtree_cap_inos(
                            args["src"])):
                        return       # parked on the drain
                out = self._journal_and_apply(op, args, reqid)
            elif op in _READONLY:
                out = self._apply(op, args)
            else:
                self._reply(msg, -22, {"error": f"unknown op {op!r}"})
                return
        except FsError as e:
            self._reply(msg, e.result, {"error": str(e)})
            return
        except (KeyError, ValueError, TypeError) as e:
            self._reply(msg, -22, {"error": repr(e)})
            return
        self._reply(msg, 0, out)

    def _wrstat_allowed(self, msg, args: Dict) -> bool:
        """The MClientCaps flush path refuses stale writers (evicted
        sessions); the REQUEST-shaped wrstat must enforce the same:
        if anyone currently holds caps on the ino, only a holder may
        write back size/mtime."""
        try:
            _d, _n, inode = self.fs._resolve_dentry(args["path"])
        except FsError:
            return True          # path-level errors surface in _apply
        holders = self.caps.get(inode["ino"])
        return not holders or msg.src in holders

    def _replayed_reply(self, op: str, args: Dict) -> Dict:
        """Reconstruct the reply for an already-applied duplicate:
        ino-returning ops re-resolve; the rest have no payload."""
        if op in ("mkdir", "create", "symlink"):
            try:
                return {"ino": self.fs._resolve(
                    args["path"], follow_final=False)["ino"],
                    "replayed": True}
            except FsError:
                return {"replayed": True}
        if op == "snap_create":
            # the snapshot exists: hand back its recorded ids
            try:
                inode = self.fs._resolve(args["path"],
                                         follow_final=True)
                e = self._realm_snaps(inode["ino"]).get(args["name"])
                if e is not None:
                    return {"ino": inode["ino"], "md": e["md"],
                            "data": e["data"], "replayed": True}
            except FsError:
                pass
            return {"replayed": True}
        return {"replayed": True}

    def _op_open(self, msg: MClientRequest,
                 args: Dict) -> Optional[Dict]:
        """Resolve + cap issue: the client gets the inode, its data
        SnapContext (realm chain), and the granted caps."""
        path = args["path"]
        want = int(args.get("want", CEPH_CAP_FILE_CACHE))
        create = bool(args.get("create"))
        try:
            dino, name, inode = self.fs._resolve_dentry(path)
        except FsError as e:
            if e.result != -2 or not create:
                raise
            # O_CREAT is a dentry creation like any other: same
            # max_files gate as the create op
            self._check_files_quota(path)
            self._journal_and_apply("create", {"path": path},
                                    getattr(msg, "reqid", ""))
            dino, name, inode = self.fs._resolve_dentry(path)
        if inode["type"] == "dir":
            raise FsError("open", -21)           # EISDIR
        granted = self._issue(msg.src, inode["ino"], want, msg)
        if granted is None:
            return None
        self._cap_paths[inode["ino"]] = path
        seq, snaps = self._file_snapc(path)
        return {"inode": inode, "caps": granted,
                "snapc_seq": seq, "snapc_snaps": snaps,
                "path": path,
                # the quota realm chain, cached client-side for the
                # data path's byte-quota checks (Client.cc's in->quota)
                "quotas": self._quota_chain(path)}

    # ---- quotas + layouts (Client.cc quota realms / file layouts) ----------
    def _ancestor_dirs(self, path: str):
        """(path, inode) for every EXISTING directory from root down
        to *path*'s deepest dir component — the quota realm chain."""
        out = []
        cur_ino = ROOT_INO
        cur_path = ""
        parts = self.fs._split(path)
        for part in parts:
            try:
                inode = self.fs._lookup(cur_ino, part)
            except FsError:
                break
            if inode.get("type") != "dir":
                break
            cur_ino = inode["ino"]
            cur_path = cur_path + "/" + part
            out.append((cur_path, inode))
        return out

    def _subtree_usage(self, path: str):
        """(bytes, files) under a directory: the rstat role
        (rbytes / rfiles+rsubdirs) computed on demand at lite scale."""
        used_bytes = 0
        used_files = 0
        stack = [path]
        while stack:
            p = stack.pop()
            for name, inode in self.fs.listdir(p).items():
                used_files += 1
                child = p.rstrip("/") + "/" + name
                if inode.get("type") == "dir":
                    stack.append(child)
                else:
                    used_bytes += int(inode.get("size", 0))
        return used_bytes, used_files

    def _quota_chain(self, path: str):
        """Every quota-bearing ancestor with its limits and current
        usage, outermost first (the realm chain a client enforces
        writes against, Client.cc:4627)."""
        out = []
        for p, inode in self._ancestor_dirs(path):
            mb = int(inode.get("quota_max_bytes", 0) or 0)
            mf = int(inode.get("quota_max_files", 0) or 0)
            if not (mb or mf):
                continue
            ub, uf = self._subtree_usage(p)
            out.append({"path": p, "max_bytes": mb, "max_files": mf,
                        "used_bytes": ub, "used_files": uf})
        return out

    def _check_files_quota(self, path: str) -> None:
        """EDQUOT when adding one dentry at *path* would exceed any
        ancestor max_files (the chain walk stops at the deepest
        existing directory, so the not-yet-created leaf is fine)."""
        for q in self._quota_chain(path):
            if q["max_files"] and q["used_files"] + 1 > \
                    q["max_files"]:
                raise FsError("quota", -122)         # EDQUOT

    def _check_rename_quota(self, src: str, dst: str) -> None:
        """A rename INTO a quota realm absorbs the moved subtree's
        dentries and bytes (Server.cc's rename quota gate): realms
        covering dst but NOT src must fit the increment."""
        src_realms = {q["path"] for q in self._quota_chain(src)}
        dst_chain = [q for q in self._quota_chain(dst)
                     if q["path"] not in src_realms]
        if not dst_chain:
            return
        inode = self.fs._resolve(src, follow_final=False)
        if inode.get("type") == "dir":
            sp = "/" + "/".join(self.fs._split(src))
            add_bytes, add_files = self._subtree_usage(sp)
            add_files += 1                       # the moved dir itself
        else:
            add_bytes, add_files = int(inode.get("size", 0)), 1
        for q in dst_chain:
            if q["max_files"] and \
                    q["used_files"] + add_files > q["max_files"]:
                raise FsError("quota", -122)
            if q["max_bytes"] and add_bytes and \
                    q["used_bytes"] + add_bytes > q["max_bytes"]:
                raise FsError("quota", -122)

    def _inherited_layout(self, path: str):
        """Nearest ancestor dir layout (ceph.dir.layout inheritance:
        fixed into the file inode at create, Client.cc:11645)."""
        layout = None
        for _p, inode in self._ancestor_dirs(path):
            if inode.get("layout"):
                layout = inode["layout"]
        return layout

    def _op_set_quota(self, args: Dict) -> Dict:
        dino, name, inode = self.fs._resolve_dentry(args["path"])
        if inode["type"] != "dir":
            raise FsError("set_quota", -20)          # ENOTDIR
        self.fs._update(dino, name,
                        quota_max_bytes=int(args.get("max_bytes", 0)),
                        quota_max_files=int(args.get("max_files", 0)))
        return {"ino": inode["ino"]}

    def _op_set_layout(self, args: Dict) -> Dict:
        """ceph.dir.layout / ceph.file.layout vxattrs: {order, pool}.
        Fields MERGE into an existing layout (setfattr of one
        ceph.dir.layout.* field keeps the others).  A FILE's layout
        is only settable while it is empty (the reference's
        layout-after-data EINVAL)."""
        dino, name, inode = self.fs._resolve_dentry(args["path"])
        layout = dict(inode.get("layout") or {})
        if args.get("order") is not None:
            layout["order"] = int(args["order"])
        if args.get("pool"):
            layout["pool"] = args["pool"]
        if inode["type"] == "dir":
            self.fs._update(dino, name, layout=layout)
        elif inode["type"] == "file":
            if int(inode.get("size", 0)):
                raise FsError("set_layout", -22)     # EINVAL
            attrs = {}
            if "order" in layout:
                attrs["order"] = layout["order"]
            if "pool" in layout:
                attrs["pool"] = layout["pool"]
            self.fs._update(dino, name, **attrs)
        else:
            raise FsError("set_layout", -22)
        return {"ino": inode["ino"]}

    # ---- snap realms -------------------------------------------------------
    def _realm_snaps(self, ino: int) -> Dict[str, Dict]:
        try:
            return json.loads(self.fs._call(realm_oid(ino), "snap_ls"))
        except FsError as e:
            if e.result in (-2, -116):
                return {}
            raise

    def _ancestor_inos(self, path: str) -> List[int]:
        """Realm chain: every directory ino from root down to the
        file's parent (SnapRealm parent links)."""
        out = [ROOT_INO]
        cur = ROOT_INO
        parts = self.fs._split(path)
        for part in parts[:-1]:
            inode = self.fs._lookup(cur, part)
            if inode["type"] != "dir":
                break
            cur = inode["ino"]
            out.append(cur)
        return out

    def _file_snapc(self, path: str) -> Tuple[int, List[int]]:
        """Write SnapContext for the file at *path*: union of data
        snaps over the ancestor realm chain (newest first, like the
        reference's SnapContext)."""
        snaps: Set[int] = set()
        for ino in self._ancestor_inos(path):
            for e in self._realm_snaps(ino).values():
                snaps.add(int(e["data"]))
        ordered = sorted(snaps, reverse=True)
        return (ordered[0] if ordered else 0), ordered

    def _op_snap_create(self, args: Dict) -> Dict:
        """Per-directory snapshot (mkdir .snap/<name>): ids recorded in
        the DIRECTORY's realm, so only its subtree is covered."""
        path = args["path"]
        name = args["name"]
        inode = self.fs._resolve(path, follow_final=True)
        if inode["type"] != "dir":
            raise FsError("snap_create", -20)
        md_sid = self.rados.selfmanaged_snap_create(self.mdpool)
        data_sid = self.rados.selfmanaged_snap_create(self.dpool)
        try:
            self.fs._call(realm_oid(inode["ino"]), "snap_add",
                          {"name": name, "md_sid": md_sid,
                           "data_sid": data_sid,
                           "stamp": args.get("stamp", 0.0)})
        except FsError:
            self.rados.selfmanaged_snap_remove(self.mdpool, md_sid)
            self.rados.selfmanaged_snap_remove(self.dpool, data_sid)
            raise
        self._install_md_snapc()
        return {"ino": inode["ino"], "md": md_sid, "data": data_sid}

    def _op_snap_remove(self, args: Dict) -> Dict:
        inode = self.fs._resolve(args["path"], follow_final=True)
        gone = json.loads(self.fs._call(
            realm_oid(inode["ino"]), "snap_rm", {"name": args["name"]}))
        self.rados.selfmanaged_snap_remove(self.mdpool, gone["md"])
        self.rados.selfmanaged_snap_remove(self.dpool, gone["data"])
        self._install_md_snapc()
        return gone

    def _all_realm_md_snaps(self) -> List[int]:
        """Union of metadata snap ids over every realm.  The MDS
        writes metadata with ALL realms' md snaps in context — cloning
        a dentry object outside a snapshotted subtree is invisible to
        every view (views resolve only under their realm root), while
        per-FILE data snapc stays strictly per-realm-chain."""
        snaps: Set[int] = set()
        stack = ["/"]
        inos = [ROOT_INO]
        while stack:
            path = stack.pop()
            for name, inode in self.fs.listdir(path).items():
                if inode.get("type") == "dir":
                    inos.append(inode["ino"])
                    stack.append(path.rstrip("/") + "/" + name)
        for ino in inos:
            for e in self._realm_snaps(ino).values():
                snaps.add(int(e["md"]))
        return sorted(snaps)

    def _install_md_snapc(self) -> None:
        md = self._all_realm_md_snaps()
        self.rados.set_write_ctx(self.mdpool, md[-1] if md else 0, md)

    def _op_walk_snapc(self, args: Dict) -> Dict:
        seq, snaps = self._file_snapc(args["path"])
        return {"snapc_seq": seq, "snapc_snaps": snaps}

    def _op_lssnap(self, args: Dict) -> Dict:
        inode = self.fs._resolve(args["path"], follow_final=True)
        return {"snaps": self._realm_snaps(inode["ino"]),
                "ino": inode["ino"]}

    # ---- op table ----------------------------------------------------------
    def _apply(self, op: str, args: Dict):
        fs = self.fs
        if op == "mkdir":
            return {"ino": fs.mkdir(args["path"])}
        if op == "create":
            # layout inheritance: the nearest ancestor dir layout is
            # FIXED into the file inode at create (Client.cc:11645)
            layout = self._inherited_layout(args["path"]) or {}
            order = int(args.get("order") or
                        layout.get("order") or 22)
            ino = fs.create(args["path"], order=order)
            if layout.get("pool"):
                dino, name, _ = fs._resolve_dentry(args["path"])
                fs._update(dino, name, pool=layout["pool"])
            return {"ino": ino}
        if op == "symlink":
            return {"ino": fs.symlink(args["path"], args["target"])}
        if op == "hardlink":
            fs.hardlink(args["existing"], args["newpath"])
            return {}
        if op == "unlink":
            fs.unlink(args["path"])
            return {}
        if op == "rmdir":
            fs.rmdir(args["path"])
            return {}
        if op == "rename":
            fs.rename(args["src"], args["dst"])
            # cap bookkeeping follows the namespace: open handles on
            # renamed files must still be found by a later subtree
            # cap drain (set_dir_pin under the NEW path)
            src = "/" + "/".join(fs._split(args["src"]))
            dst = "/" + "/".join(fs._split(args["dst"]))
            for ino, p in list(self._cap_paths.items()):
                q = "/" + "/".join(fs._split(p))
                if q == src:
                    self._cap_paths[ino] = dst
                elif q.startswith(src + "/"):
                    self._cap_paths[ino] = dst + q[len(src):]
            return {}
        if op == "setattr":
            fs.setattr(args["path"],
                       mode=args.get("mode"), uid=args.get("uid"),
                       gid=args.get("gid"), mtime=args.get("mtime"))
            return {}
        if op == "truncate":
            fs.truncate(args["path"], int(args["size"]))
            return {}
        if op == "wrstat":
            # size/mtime write-back from a cap flush
            # (Locker::file_update_finish role)
            dino, name, inode = fs._resolve_dentry(args["path"])
            attrs = {"size": int(args["size"])}
            if args.get("mtime") is not None:
                attrs["mtime"] = float(args["mtime"])
            tgt_dino, tgt_name, _ = fs._primary_of(dino, name, inode)
            fs._update(tgt_dino, tgt_name, **attrs)
            return {}
        if op == "set_quota":
            return self._op_set_quota(args)
        if op == "set_layout":
            return self._op_set_layout(args)
        if op == "get_quota":
            return {"quotas": self._quota_chain(args["path"])}
        if op == "set_dir_pin":
            # the handoff record: one atomic attr merge on the dir's
            # dentry; authority flips for the whole subtree
            dino, name, inode = fs._resolve_dentry(args["path"])
            fs._update(dino, name, pin=int(args["rank"]))
            return {"ino": inode["ino"], "rank": int(args["rank"])}
        if op == "snap_create":
            return self._op_snap_create(args)
        if op == "snap_remove":
            return self._op_snap_remove(args)
        if op == "lssnap":
            return self._op_lssnap(args)
        if op == "walk_snapc":
            return self._op_walk_snapc(args)
        if op == "stat":
            if args.get("nofollow"):
                # lstat flavor: the client's replayed-symlink ino
                # recovery must see the link itself, not its target
                return {"inode": fs._resolve(args["path"],
                                             follow_final=False)}
            return {"inode": fs.stat(args["path"])}
        if op == "resolve":
            return {"inode": fs._resolve(args["path"],
                                         follow_final=True)}
        if op == "exists":
            return {"exists": fs.exists(args["path"])}
        if op == "listdir":
            return {"entries": fs.listdir(args["path"])}
        if op == "readlink":
            return {"target": fs.readlink(args["path"])}
        raise FsError(op, -22)
