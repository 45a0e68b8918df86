"""cephfs-lite client: POSIX-shaped file operations over two pools.

The reference cephfs (src/client, 24k LoC + src/mds, 77k) resolves
paths dentry-by-dentry against MDS caches and stripes file data into a
data pool via the file layout (osdc/Striper).  This client keeps that
exact storage shape — metadata-pool dir objects with dentry omaps
(cls_fs), ``%llx.%08llx`` data objects — and performs each metadata
mutation as one atomic server-side class method, so concurrency is
serialized by the directory object's PG instead of MDS locks.

Scope-outs vs the reference (see cls_fs for the rationale): client
capabilities/leases and delegations, the MDS journal + standby-replay,
and multi-MDS subtree partitioning.  Snapshots exist at whole-fs scope
(the SnapRealm hierarchy collapsed to one domain; see snap_create).
Hard links use
remote dentries with a back-pointer list on the primary (promotion on
primary unlink replaces the MDS stray-directory migration).  stat() is lstat-shaped (final-component symlinks
are not followed); intermediate symlinks resolve like the kernel
client's path walk.  Cross-directory rename is dst-link-then-src-unlink —
two PG-atomic steps, briefly observable as a double link, never a loss
(the reference orders the same two events through its journal).
"""
from __future__ import annotations

import json
import time
from typing import Dict, List, Optional, Tuple

from ..client.rados import RadosClient
from .cls_fs import ROOT_INO, INOTABLE_OID, dir_oid, file_oid


class FsError(IOError):
    def __init__(self, api: str, result: int):
        super().__init__(f"cephfs {api}: error {result}")
        self.result = result


def _j(obj) -> bytes:
    return json.dumps(obj, sort_keys=True).encode()


def _absent(e: IOError) -> bool:
    return getattr(e, "errno", None) == 2


DEFAULT_ORDER = 22                # 4 MiB objects (file_layout_t default)


class CephFS:
    """A mounted filesystem (libcephfs ceph_mount shape)."""

    def __init__(self, client: RadosClient, metadata_pool: str,
                 data_pool: str):
        self.client = client
        self.mdpool = metadata_pool
        self.dpool = data_pool
        # set on snapshot VIEWS (CephFS.snapshot()): reads resolve
        # against these snap ids; mutations are refused EROFS
        self._md_snap = None
        self._data_snap = None
        try:
            self._install_snapc()
        except KeyError:
            pass                     # pool not created yet (pre-mkfs)
        except FsError as e:
            if e.result != -2:
                # a transient failure must be LOUD: mounting with no
                # snap context would silently overwrite snapshots
                raise

    # ---- cls plumbing -----------------------------------------------------
    def _call(self, oid: str, method: str, payload=None) -> bytes:
        ret, out = self.client.exec(self.mdpool, oid, "fs", method,
                                    _j(payload or {}),
                                    snap=self._md_snap)
        if ret < 0:
            raise FsError(method, ret)
        return out

    def _rw(self) -> None:
        if self._md_snap is not None:
            raise FsError("readonly snapshot view", -30)   # EROFS

    # ---- lifecycle --------------------------------------------------------
    def mkfs(self) -> None:
        """Initialize inotable + root directory object (ceph fs new)."""
        self._call(INOTABLE_OID, "mkfs")
        # the root dir object springs into existence on first dentry;
        # create it eagerly so readdir("/") works on an empty fs
        self.client.create(self.mdpool, dir_oid(ROOT_INO),
                           exclusive=False)

    def _alloc_ino(self) -> int:
        return json.loads(self._call(INOTABLE_OID, "alloc_ino"))["ino"]

    # ---- path resolution --------------------------------------------------
    @staticmethod
    def _split(path: str) -> List[str]:
        parts = [p for p in path.split("/") if p]
        if any(p in (".", "..") for p in parts):
            raise FsError("path", -22)
        return parts

    def _resolve(self, path: str, depth: int = 0,
                 follow_final: bool = False) -> Dict:
        """Path -> inode dict; root is synthetic (the reference pins the
        root CInode in the MDS cache the same way).  Symlinks in
        intermediate components are always followed; the final
        component follows only with ``follow_final`` (stat keeps
        lstat-like semantics)."""
        if depth > 10:
            raise FsError("resolve", -40)             # ELOOP
        parts = self._split(path)
        inode = {"ino": ROOT_INO, "type": "dir", "size": 0, "mtime": 0}
        for i, name in enumerate(parts):
            if inode["type"] != "dir":
                raise FsError("resolve", -20)         # ENOTDIR
            inode = self._lookup(inode["ino"], name)
            if inode.get("type") == "remote":
                # hard link: a remote dentry IS the file (POSIX link
                # identity), unlike a symlink — always dereference
                _, _, inode = self._primary_of(0, "", inode)
            last = i == len(parts) - 1
            if inode["type"] == "symlink" and (not last or follow_final):
                target = inode["target"]
                if not target.startswith("/"):
                    base = "/".join(parts[:i])
                    target = (f"/{base}/{target}" if base
                              else f"/{target}")
                rest = "/".join(parts[i + 1:])
                full = f"{target}/{rest}" if rest else target
                return self._resolve(full, depth + 1, follow_final)
        return inode

    def _resolve_parent(self, path: str) -> Tuple[int, str]:
        parts = self._split(path)
        if not parts:
            raise FsError("resolve", -22)
        parent = "/".join(parts[:-1])
        return (self._resolve(parent, follow_final=True)["ino"],
                parts[-1])

    def _lookup(self, dir_ino: int, name: str) -> Dict:
        return json.loads(self._call(dir_oid(dir_ino), "lookup",
                                     {"name": name}))

    def _primary_of(self, dino: int, name: str, inode: Dict):
        """Resolve a remote dentry to (primary_dir, primary_name,
        primary_inode); identity for everything else (CDentry remote ->
        primary resolution in the MDS cache)."""
        if inode.get("type") != "remote":
            return dino, name, inode
        pd, pn = inode["primary"]
        return pd, pn, self._lookup(pd, pn)

    # ---- hard links (CDentry remote dentries; inode embedded in the
    # primary, back-pointer list to every remote) ----------------------
    def hardlink(self, existing: str, newpath: str) -> None:
        self._rw()
        """link(2): a new name for an existing FILE.  The new dentry is
        a remote referencing the primary; the primary records it in its
        back-pointer list FIRST, so a crash between the two steps
        leaves a recorded-but-absent link (pruned on promotion) rather
        than an untracked dangling remote."""
        ed, en = self._resolve_parent(existing)
        pd, pn, pinode = self._primary_of(ed, en, self._lookup(ed, en))
        if pinode["type"] == "dir":
            raise FsError("link", -1)            # EPERM, like the MDS
        if pinode["type"] != "file":
            raise FsError("link", -22)
        nd, nn = self._resolve_parent(newpath)
        # only roll back an entry THIS call added — a repeated
        # hardlink to the same name must not strip the original
        # back-pointer on its EEXIST failure
        added = [nd, nn] not in pinode.get("links", [])
        if added:
            self._update_links(pd, pn, add_links=[[nd, nn]])
        try:
            self._call(dir_oid(nd), "link", {"name": nn, "inode": {
                "type": "remote", "ino": pinode["ino"],
                "primary": [pd, pn]}})
        except FsError:
            if added:
                self._update_links(pd, pn, remove_links=[[nd, nn]])
            raise

    # ---- directories ------------------------------------------------------
    def mkdir(self, path: str) -> int:
        self._rw()
        dino, name = self._resolve_parent(path)
        ino = self._alloc_ino()
        # object BEFORE dentry: cls_fs refuses WR calls on a missing
        # dir object (missing == rmdir'd — the anti-resurrection
        # guard), so the object must exist from the instant the dentry
        # makes it reachable.  A crash here leaves an unreachable
        # object (fsck-collectable), never a broken directory.
        self.client.create(self.mdpool, dir_oid(ino), exclusive=False)
        try:
            self._call(dir_oid(dino), "link", {"name": name, "inode": {
                "ino": ino, "type": "dir", "size": 0, "mode": 0o755,
                "uid": 0, "gid": 0, "mtime": time.time()}})
        except FsError:
            self.client.remove(self.mdpool, dir_oid(ino))
            raise
        return ino

    def listdir(self, path: str) -> Dict[str, Dict]:
        inode = self._resolve(path, follow_final=True)
        if inode["type"] != "dir":
            raise FsError("listdir", -20)
        return json.loads(self._call(dir_oid(inode["ino"]), "readdir"))

    def rmdir(self, path: str) -> None:
        self._rw()
        dino, name = self._resolve_parent(path)
        target = self._lookup(dino, name)
        if target["type"] != "dir":
            raise FsError("rmdir", -20)
        # seal the child atomically (empty-check + refuse-new-links in
        # one PG-serialized call) BEFORE touching the parent dentry, so
        # a racing create either beats the seal (rmdir fails ENOTEMPTY)
        # or loses to it (create fails ENOENT) — never gets orphaned
        self._call(dir_oid(target["ino"]), "dir_mark_dead")
        self._call(dir_oid(dino), "unlink", {"name": name})
        self.client.remove(self.mdpool, dir_oid(target["ino"]))

    # ---- files ------------------------------------------------------------
    def create(self, path: str, order: int = DEFAULT_ORDER) -> int:
        self._rw()
        dino, name = self._resolve_parent(path)
        ino = self._alloc_ino()
        self._call(dir_oid(dino), "link", {"name": name, "inode": {
            "ino": ino, "type": "file", "size": 0, "order": order,
            "mode": 0o644, "uid": 0, "gid": 0,
            "mtime": time.time()}})
        return ino

    def symlink(self, path: str, target: str) -> int:
        self._rw()
        dino, name = self._resolve_parent(path)
        ino = self._alloc_ino()
        self._call(dir_oid(dino), "link", {"name": name, "inode": {
            "ino": ino, "type": "symlink", "size": len(target),
            "target": target, "mtime": time.time()}})
        return ino

    def readlink(self, path: str) -> str:
        inode = self._resolve(path)
        if inode["type"] != "symlink":
            raise FsError("readlink", -22)
        return inode["target"]

    def setattr(self, path: str, mode: Optional[int] = None,
                uid: Optional[int] = None, gid: Optional[int] = None,
                mtime: Optional[float] = None) -> Dict:
        """chmod/chown/utimens in one verb (the MDS setattr flow):
        attribute merges happen server-side on the dentry, so two
        concurrent setattrs never lose each other's fields."""
        self._rw()
        if not self._split(path):
            # the root inode is synthetic (no dentry to store attrs
            # on); a clear error beats EINVAL from path resolution
            raise FsError("setattr on the filesystem root is not "
                          "supported (synthetic root inode)", -95)
        # follows final symlinks like chmod(2)/chown(2)
        dino, name, inode = self._resolve_dentry(path)
        attrs = {}
        if mode is not None:
            attrs["mode"] = mode & 0o7777
        if uid is not None:
            attrs["uid"] = uid
        if gid is not None:
            attrs["gid"] = gid
        if mtime is not None:
            attrs["mtime"] = mtime
        if not attrs:
            return inode            # no-op: skip the mutating RPC
        return self._update(dino, name, **attrs)

    def chmod(self, path: str, mode: int) -> None:
        self.setattr(path, mode=mode)

    def chown(self, path: str, uid: int, gid: int) -> None:
        self.setattr(path, uid=uid, gid=gid)

    def stat(self, path: str) -> Dict:
        inode = self._resolve(path)
        if inode.get("type") == "file":
            inode = dict(inode,
                         nlink=1 + len(inode.get("links", [])))
        return inode

    def _resolve_dentry(self, path: str,
                        depth: int = 0) -> Tuple[int, str, Dict]:
        """-> (dir_ino, name, inode) of the PRIMARY dentry serving
        ``path``, following final-component symlinks (like open(2)/
        chmod(2)) and dereferencing remote hard-link dentries — the
        shared resolution under _file_inode and setattr."""
        if depth > 10:
            raise FsError("resolve", -40)             # ELOOP
        dino, name = self._resolve_parent(path)
        inode = self._lookup(dino, name)
        if inode.get("type") == "remote":
            dino, name, inode = self._primary_of(dino, name, inode)
        if inode["type"] == "symlink":
            target = inode["target"]
            if not target.startswith("/"):
                # relative targets resolve against the link's parent
                # directory, like symlink(2)
                parent = "/".join(self._split(path)[:-1])
                target = (f"/{parent}/{target}" if parent
                          else f"/{target}")
            return self._resolve_dentry(target, depth + 1)
        return dino, name, inode

    def _file_inode(self, path: str) -> Tuple[int, str, Dict]:
        dino, name, inode = self._resolve_dentry(path)
        if inode["type"] != "file":
            raise FsError("open", -21)                # EISDIR
        return dino, name, inode

    def _update_links(self, dino: int, name: str, **kind) -> Dict:
        """Server-side back-pointer mutation (add_links/remove_links/
        replace_link) — atomic on the dentry, no client RMW window."""
        return json.loads(self._call(dir_oid(dino), "update_inode",
                                     {"name": name, **kind}))

    def _update(self, dino: int, name: str, **attrs) -> Dict:
        return json.loads(self._call(dir_oid(dino), "update_inode",
                                     {"name": name, "attrs": attrs}))

    def write(self, path: str, data: bytes, offset: int = 0) -> int:
        self._rw()
        dino, name, inode = self._file_inode(path)
        osize = 1 << inode.get("order", DEFAULT_ORDER)
        pos = 0
        while pos < len(data):
            objno, ooff = divmod(offset + pos, osize)
            take = min(len(data) - pos, osize - ooff)
            r = self.client.write(self.dpool,
                                  file_oid(inode["ino"], objno),
                                  data[pos:pos + take], ooff)
            if r < 0:
                raise FsError("write", r)
            pos += take
        # the size maxes server-side (cls update_inode max_attrs), so
        # two concurrent writers can never shrink each other's growth
        self._call(dir_oid(dino), "update_inode",
                   {"name": name, "attrs": {"mtime": time.time()},
                    "max_attrs": {"size": offset + len(data)}})
        return len(data)

    def read(self, path: str, offset: int = 0,
             length: Optional[int] = None) -> bytes:
        _, _, inode = self._file_inode(path)
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
                data = self.client.read(self.dpool,
                                        file_oid(inode["ino"], objno),
                                        offset=ooff, length=take,
                                        snap=self._data_snap)
            except IOError as e:
                if not _absent(e):
                    raise
                data = b""
            chunks.append(data.ljust(take, b"\x00"))   # sparse holes
            pos += take
            remaining -= take
        return b"".join(chunks)

    def truncate(self, path: str, size: int) -> None:
        self._rw()
        dino, name, inode = self._file_inode(path)
        osize = 1 << inode.get("order", DEFAULT_ORDER)
        old = inode["size"]
        if size < old:
            keep = (size + osize - 1) // osize
            for objno in range(keep, (old + osize - 1) // osize):
                self.client.remove(self.dpool,
                                   file_oid(inode["ino"], objno))
            tail = size - (keep - 1) * osize
            if keep and tail < osize:
                self.client.truncate(self.dpool,
                                     file_oid(inode["ino"], keep - 1),
                                     tail)
        self._update(dino, name, size=size, mtime=time.time())

    def unlink(self, path: str) -> None:
        self._rw()
        dino, name = self._resolve_parent(path)
        gone = json.loads(self._call(dir_oid(dino), "unlink",
                                     {"name": name, "deny_dir": True}))
        self._unlinked_cleanup(gone, dino, name)

    def _unlinked_cleanup(self, gone: Dict, dino: int,
                          name: str) -> None:
        """After a dentry disappears: a remote detaches from its
        primary's back-pointer list; a primary with surviving remotes
        promotes one of them to hold the inode (the MDS migrates such
        inodes through the stray directory — here the promotion is
        direct); a sole primary purges its data."""
        if not gone:
            return
        if gone.get("type") == "remote":
            pd, pn = gone["primary"]
            try:
                self._update_links(pd, pn,
                                   remove_links=[[dino, name]])
            except FsError:
                pass                 # primary already gone
            return
        if gone.get("type") != "file":
            return
        # validate EVERY back-pointer up front (recorded-but-absent
        # entries from the documented crash window are pruned here)
        valid = []
        for ld, ln in gone.get("links", []):
            try:
                r = self._lookup(ld, ln)
            except FsError:
                continue
            if r.get("type") == "remote" and r.get("ino") == gone["ino"]:
                valid.append([ld, ln])
        while valid:
            (ld, ln), rest = valid[0], valid[1:]
            promoted = dict(gone, links=rest)
            try:
                # guarded: only replaces the dentry if it is STILL the
                # remote we validated — a concurrent unlink of that
                # name must not be resurrected by our promotion
                self._call(dir_oid(ld), "set_dentry",
                           {"name": ln, "inode": promoted,
                            "expect_remote_ino": gone["ino"]})
            except FsError as e:
                if e.result not in (-2, -125):
                    # ambiguous (timeout): the promotion may have
                    # applied — promoting another candidate or purging
                    # could double-promote or delete live data
                    raise
                valid = rest         # candidate vanished: try the next
                continue
            for od, on in rest:      # repoint surviving remotes
                try:
                    self._update(od, on, primary=[ld, ln])
                except FsError:
                    pass
            return
        self._purge_file(gone)

    def _purge_file(self, inode: Dict) -> None:
        """Delete the data objects of an unlinked file (the reference
        delegates this to the MDS PurgeQueue)."""
        if not inode or inode.get("type") != "file":
            return
        osize = 1 << inode.get("order", DEFAULT_ORDER)
        for objno in range((inode["size"] + osize - 1) // osize):
            self.client.remove(self.dpool,
                               file_oid(inode["ino"], objno))

    def rename(self, src: str, dst: str) -> None:
        self._rw()
        """rename(2): atomic within one directory (single cls call);
        across directories it is dst-link + src-unlink — two atomic
        steps with a transient double-link window, never a loss."""
        sparts, dparts = self._split(src), self._split(dst)
        if sparts == dparts:
            self._resolve(src)               # still ENOENT if absent
            return                           # rename(p, p): no-op
        sdino, sname = self._resolve_parent(src)
        ddino, dname = self._resolve_parent(dst)
        moving = self._lookup(sdino, sname)
        try:
            existing_dst = self._lookup(ddino, dname)
        except FsError:
            existing_dst = None
        if existing_dst is not None and \
                existing_dst.get("ino") == moving.get("ino") and \
                moving.get("type") in ("file", "remote"):
            # rename between two names of the same file is a POSIX
            # no-op (both dentries survive) — proceeding would displace
            # the primary and purge the data
            return
        if moving["type"] == "dir" and \
                self._subtree_contains(moving["ino"], ddino):
            # moving a directory into its own subtree would detach the
            # whole subtree forever (POSIX: EINVAL).  Checked on
            # RESOLVED inodes, not path strings, so a symlink into the
            # source subtree cannot smuggle the cycle past the guard.
            raise FsError("rename", -22)
        if sdino == ddino:
            displaced = json.loads(self._call(
                dir_oid(sdino), "rename_local",
                {"src": sname, "dst": dname, "replace": True}))
            self._unlinked_cleanup(displaced, sdino, dname)
            self._fix_link_pointers(moving, [sdino, sname],
                                    [sdino, dname])
            return
        inode = moving
        try:
            self._call(dir_oid(ddino), "link",
                       {"name": dname, "inode": inode})
        except FsError as e:
            if e.result != -17:
                raise
            # deny_dir makes replacing a directory fail EISDIR at the
            # dentry itself — a subtree can never be silently destroyed
            displaced = json.loads(self._call(
                dir_oid(ddino), "unlink",
                {"name": dname, "deny_dir": True}))
            self._unlinked_cleanup(displaced, ddino, dname)
            self._call(dir_oid(ddino), "link",
                       {"name": dname, "inode": inode})
        # pointers first, THEN the src unlink: a crash in between
        # leaves a stale duplicate NAME at src (harmless, cleaned by a
        # later unlink) instead of dangling remotes whose primary is
        # gone — names are never lost
        self._fix_link_pointers(inode, [sdino, sname], [ddino, dname])
        self._call(dir_oid(sdino), "unlink", {"name": sname})

    def _fix_link_pointers(self, moved: Dict, old_loc, new_loc) -> None:
        """A moved remote must update its primary's back-pointer; a
        moved primary must repoint every remote at its new location."""
        if moved.get("type") == "remote":
            pd, pn = moved["primary"]
            try:
                self._update_links(pd, pn,
                                   replace_link=[old_loc, new_loc])
            except FsError:
                pass
        elif moved.get("type") == "file":
            for od, on in moved.get("links", []):
                try:
                    self._update(od, on, primary=new_loc)
                except FsError:
                    pass

    def _subtree_contains(self, root_ino: int, needle_ino: int,
                          depth: int = 0) -> bool:
        """Is ``needle_ino`` the root or any descendant directory of
        ``root_ino``?  (The MDS answers this from its cache; here it is
        a readdir walk over the moved subtree.)"""
        if root_ino == needle_ino:
            return True
        if depth > 64:
            return True          # fail closed on absurd nesting
        entries = json.loads(self._call(dir_oid(root_ino), "readdir"))
        return any(info["type"] == "dir" and
                   self._subtree_contains(info["ino"], needle_ino,
                                          depth + 1)
                   for info in entries.values())

    def exists(self, path: str) -> bool:
        try:
            self._resolve(path)
            return True
        except FsError as e:
            if e.result in (-2, -20):
                return False
            raise

    # ---- recursive conveniences (libcephfs ceph_walk-ish helpers) ---------
    def walk(self, path: str = "/"):
        """Yield (dirpath, dirnames, filenames) like os.walk."""
        entries = self.listdir(path)
        dirs = sorted(n for n, i in entries.items() if i["type"] == "dir")
        files = sorted(n for n, i in entries.items()
                       if i["type"] != "dir")
        yield path, dirs, files
        for d in dirs:
            sub = path.rstrip("/") + "/" + d
            yield from self.walk(sub)

    # ---- filesystem snapshots (the .snap surface, whole-fs scope;
    # the reference's SnapServer table + SnapRealm propagation is
    # collapsed to one snapshot domain) --------------------------------
    def _snap_table(self) -> Dict:
        import json as _json
        from .cls_fs import FS_SNAPS_OID
        try:
            return _json.loads(self._call(FS_SNAPS_OID, "snap_ls"))
        except FsError as e:
            if e.result == -2:
                return {}
            raise

    def _install_snapc(self) -> None:
        """Install the fs snapshot context on BOTH pools' write paths
        (the client-side SnapContext a cephfs client gets from its MDS
        caps).  Another client's newer snapshot is picked up on its
        next refresh — mount time, snap ops, or refresh_snaps()."""
        table = self._snap_table()
        md = sorted(e["md"] for e in table.values())
        dt = sorted(e["data"] for e in table.values())
        self.client.set_write_ctx(self.mdpool, md[-1] if md else 0, md)
        self.client.set_write_ctx(self.dpool, dt[-1] if dt else 0, dt)

    refresh_snaps = _install_snapc

    def snap_create(self, name: str) -> None:
        """Snapshot the whole filesystem under ``name`` (mkdir .snap/
        name): one selfmanaged snap id per pool, registered atomically
        in the snapshot table, then installed in the write ctx so every
        later mutation clones pre-write state."""
        self._rw()
        import time as _time
        from .cls_fs import FS_SNAPS_OID
        md_sid = self.client.selfmanaged_snap_create(self.mdpool)
        data_sid = self.client.selfmanaged_snap_create(self.dpool)
        try:
            self._call(FS_SNAPS_OID, "snap_add",
                       {"name": name, "md_sid": md_sid,
                        "data_sid": data_sid, "stamp": _time.time()})
        except FsError:
            self.client.selfmanaged_snap_remove(self.mdpool, md_sid)
            self.client.selfmanaged_snap_remove(self.dpool, data_sid)
            raise
        self._install_snapc()

    def snap_remove(self, name: str) -> None:
        self._rw()
        import json as _json
        from .cls_fs import FS_SNAPS_OID
        gone = _json.loads(self._call(FS_SNAPS_OID, "snap_rm",
                                      {"name": name}))
        self.client.selfmanaged_snap_remove(self.mdpool, gone["md"])
        self.client.selfmanaged_snap_remove(self.dpool, gone["data"])
        self._install_snapc()

    def snap_list(self) -> Dict[str, Dict]:
        return self._snap_table()

    def snapshot(self, name: str) -> "CephFS":
        """A read-only view of the filesystem as of ``name`` (cd
        .snap/name): same API, reads resolve against the snapshot's
        clones, mutations fail EROFS."""
        table = self._snap_table()
        if name not in table:
            raise FsError("snapshot", -2)
        view = CephFS.__new__(CephFS)
        view.client = self.client
        view.mdpool = self.mdpool
        view.dpool = self.dpool
        view._md_snap = table[name]["md"]
        view._data_snap = table[name]["data"]
        return view

    # ---- fsck (cephfs-data-scan / scrub_path role) ------------------------
    def fsck(self, repair: bool = False) -> Dict:
        """Consistency scan over the whole tree: dangling remotes
        (primary gone), stale back-pointers (remote gone), and orphan
        data objects in the data pool (no referencing inode).  With
        ``repair`` the findings are fixed: dangling remotes unlinked,
        stale back-pointers pruned, orphan objects deleted — the
        cephfs-data-scan + 'ceph tell mds scrub_path repair' roles.
        Run it quiesced: a file created between the tree walk and the
        data-pool sweep would be misread as orphaned, exactly like
        rgw gc's in-flight-put hazard.  Returns {dangling_remotes,
        stale_backpointers, orphan_objects, missing_dirs}; when any
        directory OBJECT is missing (a lost metadata PG) the orphan
        purge is withheld even under repair — those files' data is
        what a data-scan recovery would rebuild from, never garbage."""
        report = {"dangling_remotes": [], "stale_backpointers": [],
                  "orphan_objects": [], "missing_dirs": []}
        live_inos = set()
        # pass 1: walk every directory object via readdir
        stack = [(ROOT_INO, "/")]
        seen_dirs = set()
        while stack:
            dino, dpath = stack.pop()
            if dino in seen_dirs:
                continue
            seen_dirs.add(dino)
            try:
                entries = json.loads(self._call(dir_oid(dino),
                                                "readdir"))
            except FsError as e:
                if e.result != -2:
                    # transient failure (e.g. PG down): aborting beats
                    # mistaking a whole reachable subtree for garbage
                    raise
                report["missing_dirs"].append(dpath)
                continue
            for name, inode in entries.items():
                path = dpath.rstrip("/") + "/" + name
                t = inode.get("type")
                if t == "dir":
                    stack.append((inode["ino"], path))
                elif t == "file":
                    live_inos.add(inode["ino"])
                    for ld, ln in list(inode.get("links", [])):
                        try:
                            r = self._lookup(ld, ln)
                            ok = (r.get("type") == "remote"
                                  and r.get("ino") == inode["ino"])
                        except FsError as e:
                            if e.result == -116:
                                # the remote's DIR is lost: unknowable,
                                # never repaired away (recovery may
                                # rebuild it)
                                report["missing_dirs"].append(
                                    f"dir#{ld}")
                                continue
                            if e.result != -2:
                                raise
                            ok = False
                        if not ok:
                            report["stale_backpointers"].append(
                                [path, [ld, ln]])
                            if repair:
                                self._update_links(
                                    dino, name,
                                    remove_links=[[ld, ln]])
                elif t == "remote":
                    live_inos.add(inode.get("ino", -1))
                    try:
                        pd, pn = inode["primary"]
                        pr = self._lookup(pd, pn)
                        ok = pr.get("ino") == inode["ino"]
                    except FsError as e:
                        if e.result == -116:
                            # primary's DIR is lost: this remote is
                            # the surviving namespace reference a
                            # recovery would reattach — keep it
                            report["missing_dirs"].append(f"dir#{pd}")
                            continue
                        if e.result != -2:
                            raise
                        ok = False
                    if not ok:
                        report["dangling_remotes"].append(path)
                        if repair:
                            self._call(dir_oid(dino), "unlink",
                                       {"name": name})
        # pass 2: orphan data objects (ino not referenced anywhere).
        # A missing dir object means an unknown set of inos was
        # unreachable in pass 1 — deleting "orphans" then would purge
        # the very data a recovery would rebuild from, so repair is
        # withheld for this pass.
        purge_ok = repair and not report["missing_dirs"]
        for oid in self.client.list_objects(self.dpool):
            try:
                ino = int(oid.split(".")[0], 16)
            except ValueError:
                continue             # not a cephfs data object
            if ino not in live_inos:
                report["orphan_objects"].append(oid)
                if purge_ok:
                    self.client.remove(self.dpool, oid)
        return report
