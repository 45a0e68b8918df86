"""RemoteCephFS — the MDS-mediated cephfs client (libcephfs + Client.cc
shape at lite scale).

Metadata operations cross the wire to the MDS (MClientRequest /
MClientReply, mds/server.py); FILE DATA goes straight to the OSDs with
the layout and SnapContext the MDS handed out at open — the cephfs
split exactly (src/client/Client.cc: metadata via MDS sessions, data
via the Objecter).

Capabilities: ``open(path, "w")`` asks for CEPH_CAP_FILE_BUFFER; while
held, FileHandle.write() buffers locally (write-back).  When another
client's open conflicts, the MDS revokes (MClientCaps) — the dispatcher
flushes the buffer to the data pool and acks with the wrstat payload,
exactly the Locker round the reference drives.  Snapshot reads resolve
directly against immutable clones (like data reads, they never need the
MDS's serialization)."""
from __future__ import annotations

import json
import time
from typing import Dict, List, Optional, Tuple

from ..client.rados import RadosClient
from ..msg.messages import (
    CEPH_CAP_FILE_BUFFER, CEPH_CAP_FILE_CACHE, MClientCaps,
    MClientReply, MClientRequest, Message,
)
from .client import CephFS, FsError, _absent
from .cls_fs import ROOT_INO, dir_oid, file_oid

# the wait must outlast the MDS session_timeout (20 s): a request
# parked behind a DEAD cap holder only unblocks once the MDS evicts
# the holder.  In-process (drive set) iterations are fast; across
# processes each late iteration sleeps 0.25 s -> ~30 s worst case.
MAX_ATTEMPTS = 120
DEFAULT_ORDER = 22


class FileHandle:
    """An open file under caps: write-back buffer when BUFFER is held
    (ObjectCacher role, one-file scale)."""

    def __init__(self, fs: "RemoteCephFS", path: str, inode: Dict,
                 caps: int, snapc: Tuple[int, List[int]],
                 mds: str = "", quotas: Optional[List[Dict]] = None):
        self.fs = fs
        self.path = path
        self.inode = inode
        self.caps = caps
        self.snapc = snapc
        self.mds = mds           # the rank daemon that issued the caps
        self.buffer: List[Tuple[int, bytes]] = []
        self.size = inode["size"]
        # the quota realm chain from the open reply (the client-side
        # cache the reference keeps as in->quota/rstat): byte quotas
        # are enforced HERE, on the data path, before bytes move
        self.quotas = list(quotas or [])
        self._max_end = self.size

    def _check_byte_quota(self, end: int) -> None:
        """EDQUOT when this write's growth would push any ancestor
        realm past max_bytes (Client.cc:9137-9141
        is_quota_bytes_exceeded with the cached realm usage)."""
        growth = end - self._max_end
        if growth <= 0:
            return
        for q in self.quotas:
            if q.get("max_bytes") and \
                    q["used_bytes"] + growth > q["max_bytes"]:
                raise FsError("write", -122)         # EDQUOT

    # -- io ------------------------------------------------------------
    def write(self, data: bytes, offset: Optional[int] = None) -> int:
        off = self.size if offset is None else offset
        end = off + len(data)
        self._check_byte_quota(end)
        if end > self._max_end:
            for q in self.quotas:
                q["used_bytes"] = q.get("used_bytes", 0) + \
                    (end - self._max_end)
            self._max_end = end
        if self.caps & CEPH_CAP_FILE_BUFFER:
            self.buffer.append((off, bytes(data)))
            self.size = max(self.size, off + len(data))
            return len(data)
        self.fs._write_through(self.path, self.inode, data, off,
                               self.snapc)
        self.size = max(self.size, off + len(data))
        return len(data)

    def read(self, offset: int = 0,
             length: Optional[int] = None) -> bytes:
        base = self.fs._read_data(self.inode, offset, length, self.size)
        if not self.buffer:
            return base
        # overlay buffered extents (our own dirty data is visible to us)
        end = offset + len(base)
        buf = bytearray(base)
        for boff, bdata in self.buffer:
            lo = max(offset, boff)
            hi = min(end, boff + len(bdata))
            if lo < hi:
                buf[lo - offset:hi - offset] = \
                    bdata[lo - boff:hi - boff]
        return bytes(buf)

    def flush(self) -> None:
        """Write back buffered extents + wrstat SYNCHRONOUSLY (the
        voluntary fsync path; revoke-driven flushes instead ride the
        MClientCaps round in RemoteCephFS.process)."""
        if self.buffer:
            for off, data in self.buffer:
                self.fs._write_data(self.inode, data, off, self.snapc)
            self.buffer = []
        self.fs._request("wrstat", path=self.path, size=self.size,
                         mtime=time.time())

    def close(self) -> None:
        self.flush()
        # release is ino-addressed (no path to route by): it must go
        # to the RANK that issued the caps, not the default target
        self.fs._request("release", ino=self.inode["ino"],
                         _target=self.mds)
        self.fs._handles.pop(self.inode["ino"], None)


class RemoteCephFS:
    """Client-side mount over an MDS session."""

    def __init__(self, client: RadosClient,
                 mds_name: Optional[str] = "mds.0",
                 metadata_pool: str = "fsmeta",
                 data_pool: str = "fsdata", drive=None):
        self.client = client
        # any falsy mds_name means "resolve the active from the fsmap"
        self._auto = not mds_name
        self.mds = mds_name or ""
        self.mdpool = metadata_pool
        self.dpool = data_pool
        # random tid base: reqids must be unique ACROSS MOUNTS of the
        # same client name, or a remount's early tids would collide
        # with a previous incarnation's completed reqids in the MDS
        # journal and be silently skipped as failover duplicates
        import secrets as _secrets
        self._tid = _secrets.randbits(40) << 8
        self._replies: Dict[int, MClientReply] = {}
        self._handles: Dict[int, FileHandle] = {}
        # multi-active routing: rank -> daemon name (from the fsmap
        # or forward replies) and learned per-directory auth hints —
        # misses self-correct via MDS_FORWARD replies
        self._ranks: Dict[int, str] = {}
        self._auth_hint: Dict[str, str] = {}
        # revokes arrive inside a network pump, where the flush's own
        # rados round trips cannot run (nested pumps no-op); they are
        # queued and drained by process() — from our request loops, or
        # the in-process scheduler
        self._pending_revokes: List[MClientCaps] = []
        # cooperative scheduler hook: in-process harnesses pass a
        # callable that runs the MDS (and peers) so a blocked request
        # can make progress; separate-process setups leave it None
        self._drive = drive
        # interpose on the rados client's dispatcher slot: MDS traffic
        # is consumed here, everything else forwards to the client
        # (the messenger holds ONE dispatcher, not a chain)
        self._inner = client
        client.messenger.add_dispatcher_head(self)

    # ---- wire --------------------------------------------------------------
    def ms_fast_dispatch(self, msg: Message) -> None:
        if isinstance(msg, MClientReply):
            self._replies[msg.tid] = msg
            return
        if isinstance(msg, MClientCaps):
            if msg.op == MClientCaps.OP_REVOKE:
                self._pending_revokes.append(msg)
            return
        self._inner.ms_fast_dispatch(msg)

    def ms_dispatch(self, msg: Message) -> None:  # pragma: no cover
        self.ms_fast_dispatch(msg)

    def process(self) -> None:
        """Service pending cap revokes: write back buffered data, then
        ack with the wrstat payload (the Locker flush round).  The
        flush answers the RANK that sent the revoke (msg.src), which
        under multi-active need not be our default target."""
        while self._pending_revokes:
            msg = self._pending_revokes.pop(0)
            revoker = getattr(msg, "src", "") or self.mds
            fh = self._handles.pop(msg.ino, None)
            if fh is not None:
                had_buffer = bool(fh.buffer)
                if fh.buffer:
                    for off, data in fh.buffer:
                        self._write_data(fh.inode, data, off, fh.snapc)
                    fh.buffer = []
                fh.caps = 0
                if had_buffer:
                    # durability first: the wrstat as a REQUEST reaches
                    # whoever is active (it re-resolves across a
                    # failover); clean read handles skip it — nothing
                    # to write back, and a stale size must not be
                    # journaled
                    try:
                        self._request("wrstat", path=fh.path,
                                      size=fh.size, mtime=time.time())
                    except FsError:
                        pass
                self._send_flush(fh, to=revoker)
            else:
                self.client.messenger.send_message(MClientCaps(
                    op=MClientCaps.OP_FLUSH, ino=msg.ino,
                    seq=msg.seq), revoker)

    def _send_flush(self, fh: FileHandle, to: str = "") -> None:
        self.client.messenger.send_message(MClientCaps(
            op=MClientCaps.OP_FLUSH, ino=fh.inode["ino"],
            data={"path": fh.path, "size": fh.size,
                  "mtime": time.time()}), to or fh.mds or self.mds)

    def _resolve_mds(self, timeout: float = 60.0) -> str:
        """The ACTIVE mds from the mon's replicated fsmap ('ceph mds
        stat'): how a client finds — and, after a failover, re-finds —
        its metadata server."""
        import time as _time
        end = _time.monotonic() + timeout
        while _time.monotonic() < end:
            try:
                st = self.client.mon_command("fs_status")
                if st and st.get("active"):
                    return st["active"][0]
            except (IOError, ValueError):
                pass
            self.client.network.pump()
            _time.sleep(0.3)
        raise FsError("resolve_mds", -110)

    def _hint_key(self, op: str, args: Dict) -> Optional[str]:
        path = args.get("src" if op == "rename" else
                        "existing" if op == "hardlink" else "path")
        if not isinstance(path, str):
            return None
        parts = [p for p in path.split("/") if p]
        return "/" + "/".join(parts[:-1]) if len(parts) > 1 else "/"

    def _resolve_rank(self, rank: int, timeout: float = 60.0) -> str:
        """rank -> daemon name from the fsmap (waits through a
        failover window)."""
        import time as _time
        end = _time.monotonic() + timeout
        while _time.monotonic() < end:
            try:
                st = self.client.mon_command("fs_status")
                name = (st or {}).get("ranks", {}).get(str(rank))
                if name:
                    return name
            except (IOError, ValueError):
                pass
            self.client.network.pump()
            _time.sleep(0.3)
        raise FsError("resolve_rank", -110)

    def _request(self, op: str, _refind: bool = True,
                 _reqid: str = "", _target: str = "",
                 _hops: int = 0, _rank: Optional[int] = None,
                 _trace: Optional[tuple] = None,
                 **args):
        if self._auto and not self.mds:
            self.mds = self._resolve_mds()
        self.process()          # our own pending flushes go first
        hint_key = self._hint_key(op, args)
        target = _target or \
            (self._auth_hint.get(hint_key, self.mds)
             if hint_key is not None else self.mds)
        if _rank is None:
            # remember which RANK we are talking to: a failover retry
            # must go back to the same rank (whose new holder replayed
            # that rank's journal and can dedup our reqid), not to
            # whatever rank the path's auth is after a repin
            _rank = next((r for r, n in self._ranks.items()
                          if n == target), 0)
        self._tid += 1
        tid = self._tid
        # the reqid survives a failover retry with its ORIGINAL tid, so
        # a promoted standby that replayed the dead active's journal
        # can recognize an already-applied mutation
        reqid = _reqid or f"{self.client.name}#{tid}"
        from ..msg.messages import new_trace_id
        from ..trace import g_tracer
        # ONE trace per logical request: forward/failover retries reuse
        # the root's (trace_id, span_id) so the hops stitch into one
        # tree, mirroring rados.py's retry contract
        span = None
        if _trace is None:
            span = g_tracer.begin(f"fs_request:{op}",
                                  daemon=self.client.name,
                                  trace_id=new_trace_id())
            _trace = (span.trace_id, span.span_id) \
                if span is not None else (0, 0)
        self.client.messenger.send_message(MClientRequest(
            tid=tid, op=op, args=args, reqid=reqid,
            trace_id=_trace[0], parent_span_id=_trace[1]), target)
        try:
            return self._await_reply(op, args, tid, reqid, target,
                                     hint_key, _refind, _hops, _rank,
                                     _trace)
        finally:
            g_tracer.finish(span)

    def _await_reply(self, op, args, tid, reqid, target, hint_key,
                     _refind, _hops, _rank, _trace):
        import time as _time
        for attempt in range(MAX_ATTEMPTS):
            self.client.network.pump()
            self.process()
            if self._drive is not None:
                self._drive()
                self.client.network.pump()
            rep = self._replies.pop(tid, None)
            if rep is not None:
                from ..mds.server import MDS_FORWARD
                if rep.result == MDS_FORWARD:
                    # not that rank's subtree: chase the auth rank
                    # with the SAME reqid (lite MClientRequestForward)
                    if _hops >= 4:
                        raise FsError(op, -40)       # ELOOP
                    rank = int(rep.data.get("forward_rank", 0))
                    self._ranks.update(
                        {rank: rep.data["mds"]}
                        if rep.data.get("mds") else {})
                    nxt = self._ranks.get(rank) or \
                        self._resolve_rank(rank)
                    if hint_key is not None:
                        self._auth_hint[hint_key] = nxt
                    return self._request(op, _refind=_refind,
                                         _reqid=reqid, _target=nxt,
                                         _hops=_hops + 1, _rank=rank,
                                         _trace=_trace, **args)
                if rep.result < 0:
                    raise FsError(op, rep.result)
                self._last_mds = target
                return rep.data
            if self._drive is None and attempt > 2:
                _time.sleep(0.25)   # cross-process: let the mds run
        if self._auto and _refind:
            # the target may have failed over: re-resolve and retry
            # once, carrying the SAME reqid TO THE SAME RANK — its
            # new holder replayed that rank's journal, so an op the
            # dead incumbent already journaled is answered from
            # effect, not re-executed (even if the subtree was
            # repinned in between).  Learned hints are dropped — the
            # fsmap may have reshuffled every rank.
            self._auth_hint.clear()
            self._ranks.clear()
            self.mds = self._resolve_mds()
            try:
                nxt = self._resolve_rank(_rank) if _rank else ""
            except FsError:
                nxt = ""
            return self._request(op, _refind=False, _reqid=reqid,
                                 _target=nxt, _rank=_rank,
                                 _trace=_trace, **args)
        raise FsError(op, -110)                       # ETIMEDOUT

    def _ino_of(self, op: str, rep: Dict, path: str) -> int:
        """Extract the ino from an ino-returning op's reply.

        A dedup'd duplicate answered "from effect" can arrive as
        {"replayed": true} WITHOUT an ino when the server's re-resolve
        raced a subtree repin (mds/server.py _replayed_reply).  The
        effect exists — recover the id with a read op: stat follows
        the final component, which is identity for the dir/file the
        mutation created (symlinks use the nofollow flavor so the
        link's own ino comes back, not its target's).  A retried
        mutation could NOT recover (its fresh reqid misses the dedup
        memo and the server answers EEXIST forever); a stat that races
        the repin raises a retryable FsError and callers' retry loops
        converge."""
        ino = rep.get("ino")
        if ino is not None:
            return ino
        if rep.get("replayed"):
            nofollow = op == "symlink"
            return self._request("stat", path=path,
                                 nofollow=nofollow)["inode"]["ino"]
        raise FsError(f"{op} (replayed, ino unresolved)", -11)

    # ---- metadata surface (all via the MDS) --------------------------------
    def mkdir(self, path: str) -> int:
        return self._ino_of("mkdir", self._request("mkdir", path=path),
                            path)

    def create(self, path: str, order: Optional[int] = None) -> int:
        # order None lets the MDS apply the inherited dir layout
        # (an explicit order overrides it, like a file vxattr would)
        return self._ino_of("create",
                            self._request("create", path=path,
                                          order=order), path)

    def symlink(self, path: str, target: str) -> int:
        return self._ino_of("symlink",
                            self._request("symlink", path=path,
                                          target=target), path)

    def readlink(self, path: str) -> str:
        return self._request("readlink", path=path)["target"]

    def hardlink(self, existing: str, newpath: str) -> None:
        self._request("hardlink", existing=existing, newpath=newpath)

    def unlink(self, path: str) -> None:
        self._request("unlink", path=path)

    def rmdir(self, path: str) -> None:
        self._request("rmdir", path=path)

    def rename(self, src: str, dst: str) -> None:
        self._request("rename", src=src, dst=dst)

    def setattr(self, path: str, **attrs) -> None:
        self._request("setattr", path=path, **attrs)

    def chmod(self, path: str, mode: int) -> None:
        self.setattr(path, mode=mode)

    def stat(self, path: str) -> Dict:
        return self._request("stat", path=path)["inode"]

    def listdir(self, path: str) -> Dict[str, Dict]:
        return self._request("listdir", path=path)["entries"]

    def exists(self, path: str) -> bool:
        return self._request("exists", path=path)["exists"]

    def truncate(self, path: str, size: int) -> None:
        self._request("truncate", path=path, size=size)

    def set_quota(self, path: str, max_bytes: int = 0,
                  max_files: int = 0) -> Dict:
        """setfattr ceph.quota.max_bytes/max_files on a directory
        (0 clears); enforced against the ancestor realm chain."""
        return self._request("set_quota", path=path,
                             max_bytes=max_bytes,
                             max_files=max_files)

    def get_quota(self, path: str) -> List[Dict]:
        """The quota realm chain covering *path*, with usage."""
        return self._request("get_quota", path=path)["quotas"]

    def set_layout(self, path: str, order: Optional[int] = None,
                   pool: Optional[str] = None) -> Dict:
        """setfattr ceph.dir.layout.* / ceph.file.layout.*: object
        size (order) and data pool.  Dir layouts are inherited by new
        files; a file's layout is only settable while empty."""
        return self._request("set_layout", path=path, order=order,
                             pool=pool)

    def get_layout(self, path: str) -> Dict:
        """The effective layout of a file or dir (getfattr
        ceph.file.layout)."""
        inode = self._request("stat", path=path)["inode"]
        if inode.get("type") == "dir":
            return dict(inode.get("layout") or {})
        return {"order": inode.get("order", DEFAULT_ORDER),
                "pool": inode.get("pool")}

    def set_dir_pin(self, path: str, rank: int) -> Dict:
        """Pin *path*'s subtree to an MDS rank (setfattr -n
        ceph.dir.pin): the journaled subtree handoff.  Served by the
        CURRENT auth rank, which drains caps under the subtree before
        the pin commits."""
        return self._request("set_dir_pin", path=path, rank=rank)

    # ---- caps + file io ----------------------------------------------------
    def open(self, path: str, mode: str = "r") -> FileHandle:
        """'r' wants CACHE, 'w' wants BUFFER (+creates).  The MDS
        serializes conflicting opens by revoking first — this call
        blocks (retrying) until the caps are granted."""
        want = CEPH_CAP_FILE_BUFFER if "w" in mode else \
            CEPH_CAP_FILE_CACHE
        out = self._request("open", path=path, want=want,
                            create="w" in mode)
        fh = FileHandle(self, path, out["inode"], out["caps"],
                        (out["snapc_seq"], out["snapc_snaps"]),
                        mds=getattr(self, "_last_mds", "") or self.mds,
                        quotas=out.get("quotas"))
        self._handles[out["inode"]["ino"]] = fh
        return fh

    def write(self, path: str, data: bytes, offset: int = 0) -> int:
        """Write-through convenience: open-for-write (serializing with
        any buffered writer elsewhere), write the data objects, then
        wrstat through the MDS."""
        fh = self.open(path, "w")
        try:
            fh._check_byte_quota(offset + len(data))
            self._write_data(fh.inode, data, offset, fh.snapc)
            fh.size = max(fh.size, offset + len(data))
            fh.close()
        except BaseException:
            # EDQUOT (or any data-path error) must not strand the
            # caps the open just took
            try:
                fh.close()
            except IOError:
                pass
            raise
        finally:
            self._handles.pop(fh.inode["ino"], None)
        return len(data)

    def read(self, path: str, offset: int = 0,
             length: Optional[int] = None) -> bytes:
        """Read-through: opening for read first forces any conflicting
        buffered writer to flush (the caps round)."""
        fh = self.open(path, "r")
        try:
            inode = self._request("stat", path=path)["inode"]
            return self._read_data(inode, offset, length,
                                   inode["size"])
        finally:
            self._request("release", ino=fh.inode["ino"],
                          _target=fh.mds)
            self._handles.pop(fh.inode["ino"], None)

    # ---- data plumbing (direct to OSDs) ------------------------------------
    def _write_data(self, inode: Dict, data: bytes, offset: int,
                    snapc: Tuple[int, List[int]]) -> None:
        """Object writes with the file's realm SnapContext installed
        (per-file snapc is what makes per-directory snapshots work).
        The file's LAYOUT pool (ceph.file.layout.pool, fixed at
        create) overrides the mount's default data pool."""
        pool = inode.get("pool") or self.dpool
        seq, snaps = snapc
        self.client.set_write_ctx(pool, seq, snaps)
        try:
            osize = 1 << inode.get("order", DEFAULT_ORDER)
            pos = 0
            while pos < len(data):
                objno, ooff = divmod(offset + pos, osize)
                take = min(len(data) - pos, osize - ooff)
                r = self.client.write(pool,
                                      file_oid(inode["ino"], objno),
                                      data[pos:pos + take], ooff)
                if r < 0:
                    raise FsError("write", r)
                pos += take
        finally:
            self.client.set_write_ctx(pool, 0, [])

    def _write_through(self, path: str, inode: Dict, data: bytes,
                       offset: int,
                       snapc: Tuple[int, List[int]]) -> None:
        self._write_data(inode, data, offset, snapc)
        self._request("wrstat", path=path, size=offset + len(data),
                      mtime=time.time())

    def _read_data(self, inode: Dict, offset: int,
                   length: Optional[int], logical_size: int,
                   snap: Optional[int] = None) -> bytes:
        if offset >= logical_size:
            return b""
        pool = inode.get("pool") or self.dpool
        length = logical_size - offset if length is None else \
            min(length, logical_size - offset)
        osize = 1 << inode.get("order", DEFAULT_ORDER)
        chunks = []
        remaining, pos = length, offset
        while remaining > 0:
            objno, ooff = divmod(pos, osize)
            take = min(remaining, osize - ooff)
            try:
                data = self.client.read(pool,
                                        file_oid(inode["ino"], objno),
                                        offset=ooff, length=take,
                                        snap=snap)
            except IOError as e:
                if not _absent(e):
                    raise
                data = b""
            chunks.append(data.ljust(take, b"\x00"))
            pos += take
            remaining -= take
        return b"".join(chunks)

    # ---- per-directory snapshots (SnapRealm surface) -----------------------
    def snap_create(self, path: str, name: str) -> Dict:
        """mkdir <path>/.snap/<name>: snapshot ONLY that subtree."""
        return self._request("snap_create", path=path, name=name,
                             stamp=time.time())

    def snap_remove(self, path: str, name: str) -> Dict:
        return self._request("snap_remove", path=path, name=name)

    def snap_list(self, path: str) -> Dict[str, Dict]:
        return self._request("lssnap", path=path)["snaps"]

    def snapshot(self, path: str, name: str) -> "SubtreeSnapView":
        out = self._request("lssnap", path=path)
        snaps = out["snaps"]
        if name not in snaps:
            raise FsError("snapshot", -2)
        return SubtreeSnapView(self.client, self.mdpool, self.dpool,
                               out["ino"], snaps[name]["md"],
                               snaps[name]["data"])


class SubtreeSnapView:
    """Read-only view of one realm's subtree as of a snapshot (cd
    <dir>/.snap/<name>): metadata resolves at the md snap, file data
    at the data snap — all against immutable clones, no MDS needed."""

    def __init__(self, client: RadosClient, mdpool: str, dpool: str,
                 root_ino: int, md_snap: int, data_snap: int):
        self._fs = CephFS.__new__(CephFS)
        self._fs.client = client
        self._fs.mdpool = mdpool
        self._fs.dpool = dpool
        self._fs._md_snap = md_snap
        self._fs._data_snap = data_snap
        self.root_ino = root_ino

    def _resolve(self, path: str) -> Dict:
        inode = {"ino": self.root_ino, "type": "dir", "size": 0}
        for name in CephFS._split(path):
            if inode["type"] != "dir":
                raise FsError("resolve", -20)
            inode = self._fs._lookup(inode["ino"], name)
            if inode.get("type") == "remote":
                _, _, inode = self._fs._primary_of(0, "", inode)
        return inode

    def listdir(self, path: str = "/") -> Dict[str, Dict]:
        inode = self._resolve(path)
        if inode["type"] != "dir":
            raise FsError("listdir", -20)
        return json.loads(self._fs._call(dir_oid(inode["ino"]),
                                         "readdir"))

    def stat(self, path: str) -> Dict:
        return self._resolve(path)

    def exists(self, path: str) -> bool:
        try:
            self._resolve(path)
            return True
        except FsError:
            return False

    def read(self, path: str, offset: int = 0,
             length: Optional[int] = None) -> bytes:
        inode = self._resolve(path)
        if inode["type"] != "file":
            raise FsError("read", -21)
        size = inode["size"]
        if offset >= size:
            return b""
        length = size - offset if length is None else \
            min(length, size - offset)
        osize = 1 << inode.get("order", DEFAULT_ORDER)
        chunks = []
        remaining, pos = length, offset
        while remaining > 0:
            objno, ooff = divmod(pos, osize)
            take = min(remaining, osize - ooff)
            try:
                data = self._fs.client.read(
                    self._fs.dpool, file_oid(inode["ino"], objno),
                    offset=ooff, length=take,
                    snap=self._fs._data_snap)
            except IOError as e:
                if not _absent(e):
                    raise
                data = b""
            chunks.append(data.ljust(take, b"\x00"))
            pos += take
            remaining -= take
        return b"".join(chunks)
