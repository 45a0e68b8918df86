"""librbd-lite: block images striped over rados objects.

The reference's librbd (src/librbd, 57k LoC) maps a virtual block device
onto 2^order-byte rados objects ``rbd_data.<id>.<objno:%016x>``, with
image metadata in a header object mutated only through cls_rbd methods
and per-pool indexes (``rbd_directory``, ``rbd_children``).  This module
reimplements that core on the framework's own primitives:

- striping: image offset -> (objno, in-object offset); absent objects
  read as zeros (sparse), like ImageCtx::prune_parent_extents + ObjectMap
  absence semantics.
- snapshots: mon-allocated selfmanaged snap ids recorded on the header
  (cls snapshot_add); every data mutation rides the image's SnapContext
  so the OSD clones pre-write state (librbd ImageCtx::snapc).
- clones: child images carry a (pool, image_id, snapid, overlap) parent
  link; reads fall through to the parent below the overlap and writes
  copy-up the parent object first (AbstractObjectWriteRequest copyup).
- flatten/resize/rollback mirror Operations.cc semantics at lite scale.

The write-ahead image journal + mirroring live in ``mirror.py`` /
``journal/``.  The exclusive lock (auto-acquire on first write,
cooperative surrender over the header watch, dead-owner break —
librbd::ExclusiveLock) and the object map / fast-diff existence bitmap
(librbd::ObjectMap) are implemented on cls_lock + watch/notify.
Scope-outs vs the reference: the qemu block driver surface.

Port of ``ceph_tpu/rbd/image.py``, a copy: host code.  Image ids and
lock cookies come from ``uuid.uuid4()`` as in the JAX package.  Where
the JAX module catches ``Exception`` around rados calls (the journal's
roll-back and removal, the lock's release on close, the watch
payload's parse), the port catches what those calls raise (``IOError``,
``ValueError`` for the payload): an error from a device in the OSD's
path reaches the caller.
"""
from __future__ import annotations

import json
import uuid
from typing import Dict, List, Optional, Tuple

from ..client.rados import NotifyTimeout, ObjectOperation, \
    RadosClient
from .cls_rbd import (
    RBD_CHILDREN, RBD_DATA_PREFIX, RBD_DIRECTORY, RBD_HEADER_PREFIX,
)


class RBDError(IOError):
    def __init__(self, api: str, result: int):
        super().__init__(f"rbd {api}: error {result}")
        self.result = result


def _j(obj) -> bytes:
    return json.dumps(obj, sort_keys=True).encode()


def _absent(e: IOError) -> bool:
    return getattr(e, "errno", None) == 2


class RBD:
    """Pool-level image admin (librbd::RBD): create/clone/list/remove."""

    def __init__(self, client: RadosClient):
        self.client = client

    def _exec(self, pool: str, oid: str, method: str, payload=None
              ) -> bytes:
        ret, out = self.client.exec(pool, oid, "rbd", method,
                                    _j(payload or {}))
        if ret < 0:
            raise RBDError(method, ret)
        return out

    def create(self, pool: str, name: str, size: int,
               order: int = 22, data_pool: str = None,
               journaling: bool = False,
               exclusive_lock: bool = False,
               object_map: bool = False) -> str:
        """Create an image; returns its id (librbd::RBD::create).

        ``data_pool`` puts the data objects in a separate — typically
        erasure-coded — pool while the header/directory stay in the
        omap-capable base pool (librbd RBD_FEATURE_DATA_POOL; EC pools
        cannot hold omap, in the reference or here).  ``journaling``
        enables the write-ahead image journal (RBD_FEATURE_JOURNALING)
        that rbd-mirror replays."""
        if size < 0 or not (12 <= order <= 26):
            raise RBDError("create", -22)
        iid = uuid.uuid4().hex[:12]
        self._exec(pool, RBD_DIRECTORY, "dir_add_image",
                   {"name": name, "id": iid})
        try:
            self._exec(pool, RBD_HEADER_PREFIX + iid, "create",
                       {"size": size, "order": order,
                        "object_prefix": RBD_DATA_PREFIX + iid,
                        "data_pool": data_pool,
                        "journaling": journaling,
                        # journaling REQUIRES the exclusive lock in the
                        # reference (mutations must be single-writer or
                        # the journal interleaves) — imply it
                        "exclusive_lock": exclusive_lock or journaling
                        or object_map,
                        "object_map": object_map})
        except RBDError:
            self._exec(pool, RBD_DIRECTORY, "dir_remove_image",
                       {"name": name, "id": iid})
            raise
        if journaling:
            from ..journal import Journaler
            try:
                jr = Journaler(self.client, pool, iid)
                jr.create(order=order, splay_width=4)
                jr.register_client("local")  # the primary's own replay
            except IOError as e:
                # roll the half-created image back out — a registered
                # image whose journal never materialized would fail
                # every mutation with no visible defect in list()
                try:
                    jr.remove()           # any journal objects written
                except IOError:
                    pass
                self.client.remove(pool, RBD_HEADER_PREFIX + iid)
                self._exec(pool, RBD_DIRECTORY, "dir_remove_image",
                           {"name": name, "id": iid})
                raise RBDError("create journal", -5) from e
        return iid

    def list(self, pool: str) -> List[str]:
        try:
            return json.loads(self._exec(pool, RBD_DIRECTORY, "dir_list"))
        except RBDError as e:
            if e.result == -2:
                return []
            raise

    def rename(self, pool: str, src: str, dst: str) -> None:
        iid = self._exec(pool, RBD_DIRECTORY, "dir_get_id",
                         {"name": src}).decode()
        self._exec(pool, RBD_DIRECTORY, "dir_rename_image",
                   {"src": src, "dst": dst, "id": iid})

    def remove(self, pool: str, name: str) -> None:
        """Remove an image: refused while it has snapshots or clone
        children (librbd returns -ENOTEMPTY / -EBUSY)."""
        img = Image(self.client, pool, name)
        if img.snap_list():
            raise RBDError("remove", -39)             # ENOTEMPTY
        if img.parent():
            pool_p, pid, psnap, _ = img.parent()
            self._exec(pool_p, RBD_CHILDREN, "remove_child",
                       {"pool": pool_p, "image_id": pid, "snapid": psnap,
                        "child_id": img.id})
        # a stale pool-wide write ctx from another image must not
        # manufacture whiteout clones for these deletes
        self.client.set_write_ctx(img.data_pool, 0, [])
        for objno in range(img._objects_in(img.size())):
            self.client.remove(img.data_pool, img._obj(objno))
        if img.journaling:
            from ..journal import Journaler
            jr = Journaler(self.client, pool, img.id)
            try:
                jr.open()
                jr.remove()
            except IOError:
                pass                  # journal already gone: fine
        self.client.remove(pool, RBD_HEADER_PREFIX + img.id)
        self._exec(pool, RBD_DIRECTORY, "dir_remove_image",
                   {"name": name, "id": img.id})

    def copy(self, src_pool: str, src_name: str, dst_pool: str,
             dst_name: str, src_snap: Optional[str] = None,
             data_pool: str = None) -> str:
        """Full image copy (rbd cp / deep-copy of one point in time):
        a new independent image with the source's bytes."""
        src = Image(self.client, src_pool, src_name, snapshot=src_snap)
        iid = self.create(dst_pool, dst_name, src.size(),
                          src.order_log2, data_pool)
        dst = Image(self.client, dst_pool, dst_name)
        for objno in range(src._objects_in(src.size())):
            off = objno * src.object_size
            ln = min(src.object_size, src.size() - off)
            data = src.read(off, ln)
            if data.strip(b"\x00"):
                dst.write(off, data)
        return iid

    def clone(self, parent_pool: str, parent_name: str, snap_name: str,
              child_pool: str, child_name: str,
              data_pool: str = None) -> str:
        """COW child of a protected parent snapshot (librbd clone v1
        semantics: protect -> clone -> children index)."""
        parent = Image(self.client, parent_pool, parent_name)
        sid, info = parent._snap_by_name(snap_name)
        if not info["protected"]:
            raise RBDError("clone", -22)
        iid = self.create(child_pool, child_name, info["size"],
                          parent.order_log2, data_pool)
        self._exec(child_pool, RBD_HEADER_PREFIX + iid, "set_parent",
                   {"pool": parent_pool, "image_id": parent.id,
                    "snapid": sid, "overlap": info["size"]})
        self._exec(parent_pool, RBD_CHILDREN, "add_child",
                   {"pool": parent_pool, "image_id": parent.id,
                    "snapid": sid, "child_id": iid})
        return iid


# open handles per (client, header): same-client lock transitions are
# coordinated HERE — the OSD excludes the notifier's own watches from a
# notify fan-out, so a sibling handle can never be reached that way
_LOCAL_HANDLES: Dict[Tuple[int, str], object] = {}


def _register_handle(img: "Image") -> None:
    import weakref
    key = (id(img.client), img._header)
    ws = _LOCAL_HANDLES.get(key)
    if ws is None:
        ws = _LOCAL_HANDLES[key] = weakref.WeakSet()
    ws.add(img)


def _mutating(fn):
    """Every mutating entry point runs under the exclusive lock when
    the feature is on (librbd::ExclusiveLock auto-acquire on first
    write), and is marked in-op so a concurrent surrender request is
    answered 'busy' instead of letting the lock break mid-mutation."""
    import functools

    @functools.wraps(fn)
    def wrapper(self, *a, **kw):
        self._op_depth += 1
        self._in_op = True
        try:
            if self._op_depth == 1:
                self._ensure_exclusive_lock()
            return fn(self, *a, **kw)
        finally:
            # unwound on EVERY exit (a failed lock acquire included):
            # leaked depth would skip future acquisitions and answer
            # every surrender request 'busy' forever
            self._op_depth -= 1
            self._in_op = self._op_depth > 0
    return wrapper


class Image:
    """An open image (librbd::Image): data I/O + snapshot/clone ops.

    ``snapshot=`` opens a read-only view at that snap, like
    rbd_open_read_only with a snap set on the ioctx.
    """

    def __init__(self, client: RadosClient, pool: str, name: str,
                 snapshot: Optional[str] = None):
        self.client = client
        self.pool = pool
        self.name = name
        ret, out = client.exec(pool, RBD_DIRECTORY, "rbd", "dir_get_id",
                               _j({"name": name}))
        if ret < 0:
            raise RBDError("open", ret)
        self._load_header(out.decode())
        if snapshot is not None:
            sid, _ = self._snap_by_name(snapshot)
            self.read_snap = sid

    def _load_header(self, iid: str) -> None:
        """Load the immutable image shape + parent link once at open
        (ImageCtx caches parent_md the same way; librbd invalidates via
        header watch/notify, which this lite layer scopes out — reopen
        after another handle's flatten to observe it)."""
        self.id = iid
        self._header = RBD_HEADER_PREFIX + iid
        meta = self._call("get_image")
        self.order_log2 = meta["order"]
        self.object_size = 1 << meta["order"]
        self.object_prefix = meta["object_prefix"]
        self.data_pool = meta.get("data_pool") or self.pool
        self.journaling = bool(meta.get("journaling"))
        self.exclusive_lock_feature = bool(meta.get("exclusive_lock"))
        self.object_map_feature = bool(meta.get("object_map"))
        self._journal = None
        self.read_snap: Optional[int] = None
        self._parent_link = self._fetch_parent()
        self._parent_handle: Optional["Image"] = None
        # exclusive-lock state (librbd::ExclusiveLock): acquired lazily
        # on the first mutation, surrendered cooperatively on another
        # handle's request (the header watch round)
        self._lock_cookie = f"auto {uuid.uuid4().hex[:8]}"
        self._lock_owned = False
        self._lock_surrendered = False
        self._watch_cookie: Optional[int] = None
        self._in_op = False
        self._op_depth = 0
        self._omap_cache: Optional[bytearray] = None
        _register_handle(self)

    # ---- header helpers ---------------------------------------------------
    def _call(self, method: str, payload=None, parse: bool = True):
        ret, out = self.client.exec(self.pool, self._header, "rbd",
                                    method, _j(payload or {}))
        if ret < 0:
            raise RBDError(method, ret)
        return json.loads(out) if (parse and out) else out

    def _snapcontext(self) -> Tuple[int, Dict[int, Dict]]:
        sc = self._call("get_snapcontext")
        return sc["seq"], {int(k): v for k, v in sc["snaps"].items()}

    def _snap_by_name(self, name: str) -> Tuple[int, Dict]:
        for sid, info in sorted(self._snapcontext()[1].items()):
            if info["name"] == name:
                return sid, info
        raise RBDError("snap lookup", -2)

    def _apply_write_ctx(self) -> None:
        """Install this image's SnapContext on the pool before a data
        mutation (ImageCtx::snapc -> ioctx write ctx)."""
        seq, snaps = self._snapcontext()
        self.client.set_write_ctx(self.data_pool, seq, list(snaps))

    def journal(self):
        """The image's write-ahead journal (librbd::Journal), lazily
        opened; None when the feature is off."""
        if not self.journaling:
            return None
        if self._journal is None:
            from ..journal import Journaler
            self._journal = Journaler(self.client, self.pool, self.id)
            self._journal.open()
        return self._journal

    def _journal_event(self, event: Dict) -> None:
        """Append one mutation event BEFORE applying it (write-ahead,
        librbd::Journal::append_io_event): a crash between append and
        apply is healed by replay_local(), and rbd-mirror replays the
        same stream remotely."""
        jr = self.journal()
        if jr is not None:
            if getattr(self, "_applied_tid", None) is not None:
                # a previous append never reached commit (its apply
                # failed mid-op): heal it first, or committing this
                # op's later tid would bury the unapplied event forever
                # (commit is monotonic) while the mirror still replays
                # it — local/remote divergence
                self.replay_local()
            self._applied_tid = jr.append(_j(event))

    def _journal_commit_applied(self) -> None:
        """Commit exactly the tid of the event this op appended — NOT
        the journal head: if an earlier op failed between append and
        apply, advancing past its tid would stop replay_local() from
        ever healing it (commit never regresses, so re-committing an
        older tid after such a failure is a no-op, which is correct:
        the unapplied event stays below the next replay window only if
        we never skip it)."""
        jr = self.journal()
        tid = getattr(self, "_applied_tid", None)
        if jr is not None and tid is not None:
            jr.commit("local", tid)
            self._applied_tid = None

    def replay_local(self) -> int:
        """Re-apply journal events past the local commit position (the
        primary's crash-recovery replay, librbd::Journal::replay).
        Events are idempotent (absolute offsets/extents), so re-applying
        an already-applied tail is safe.  Returns events replayed."""
        jr = self.journal()
        if jr is None:
            return 0
        md = jr.get_metadata()
        pos = md["clients"].get("local", {}).get("commit_tid", -1)
        n = 0
        for tid, payload in jr.replay(after_tid=pos):
            apply_image_event(self, json.loads(payload))
            jr.commit("local", tid)
            n += 1
        self._applied_tid = None     # nothing outstanding after a heal
        return n

    def parent(self) -> Optional[Tuple[str, str, int, int]]:
        return self._parent_link

    def _fetch_parent(self) -> Optional[Tuple[str, str, int, int]]:
        try:
            p = json.loads(self._call("get_parent", parse=False))
        except RBDError as e:
            if e.result == -2:
                return None
            raise
        return p["pool"], p["image_id"], p["snapid"], p["overlap"]

    def _parent_image(self) -> "Image":
        if self._parent_handle is None:
            ppool, pid = self._parent_link[0], self._parent_link[1]
            self._parent_handle = Image._open_by_id(self.client, ppool,
                                                    pid)
        return self._parent_handle

    # ---- geometry ---------------------------------------------------------
    def size(self) -> int:
        if self.read_snap is not None:
            return self._snapcontext()[1][self.read_snap]["size"]
        return self._call("get_image")["size"]

    def _obj(self, objno: int) -> str:
        return f"{self.object_prefix}.{objno:016x}"

    def _objects_in(self, nbytes: int) -> int:
        return (nbytes + self.object_size - 1) // self.object_size

    def _extents(self, offset: int, length: int
                 ) -> List[Tuple[int, int, int]]:
        """(objno, in-object offset, length) covering [offset, +length)
        (Striper::file_to_extents for the rbd flat layout)."""
        out = []
        while length > 0:
            objno, off = divmod(offset, self.object_size)
            take = min(length, self.object_size - off)
            out.append((objno, off, take))
            offset += take
            length -= take
        return out

    # ---- data path --------------------------------------------------------
    def _read_object(self, objno: int, off: int, ln: int,
                     snapid: Optional[int]) -> bytes:
        try:
            data = self.client.read(self.data_pool, self._obj(objno),
                                    offset=off, length=ln, snap=snapid)
        except IOError as e:
            if not _absent(e):
                raise
            data = b""
        return data.ljust(ln, b"\x00")

    def _parent_read(self, objno: int, off: int, ln: int) -> bytes:
        """Fall through to the parent below the overlap (ImageCtx::
        aio_read parent path)."""
        p = self.parent()
        if p is None:
            return b"\x00" * ln
        ppool, pid, psnap, overlap = p
        pos = objno * self.object_size + off
        if pos >= overlap:
            return b"\x00" * ln
        take = min(ln, overlap - pos)
        data = self._parent_image()._read_at(pos, take, psnap)
        return data.ljust(ln, b"\x00")

    @classmethod
    def _open_by_id(cls, client: RadosClient, pool: str,
                    iid: str) -> "Image":
        img = object.__new__(cls)
        img.client, img.pool, img.name = client, pool, f"#{iid}"
        img._load_header(iid)
        return img

    def _read_at(self, offset: int, length: int,
                 snapid: Optional[int]) -> bytes:
        chunks = []
        has_parent = self.parent() is not None
        for objno, off, ln in self._extents(offset, length):
            data = self._read_object(objno, off, ln, snapid)
            if has_parent and not data.strip(b"\x00"):
                # object may be wholly absent: only then fall through
                try:
                    self.client.stat(self.data_pool, self._obj(objno),
                                     snap=snapid)
                except IOError as e:
                    if _absent(e):
                        data = self._parent_read(objno, off, ln)
                    else:
                        raise
            chunks.append(data)
        return b"".join(chunks)

    def read(self, offset: int, length: int) -> bytes:
        end = self.size()
        if offset >= end:
            return b""
        length = min(length, end - offset)
        return self._read_at(offset, length, self.read_snap)

    @_mutating
    def write(self, offset: int, data: bytes) -> int:
        """Write-through with copy-up for clones; grows never — writes
        past the end are clipped like librbd returns -EINVAL."""
        if self.read_snap is not None:
            raise RBDError("write", -30)              # EROFS
        end = self.size()
        if offset + len(data) > end:
            raise RBDError("write", -22)
        if self.journaling:
            import base64
            self._journal_event({
                "op": "write", "offset": offset,
                "data": base64.b64encode(data).decode()})
        self._om_mark([objno for objno, _, _ in
                       self._extents(offset, len(data))], self.OM_EXISTS)
        self._apply_write_ctx()
        pos = 0
        has_parent = self.parent() is not None
        for objno, off, ln in self._extents(offset, len(data)):
            piece = data[pos:pos + ln]
            pos += ln
            oid = self._obj(objno)
            if has_parent and self._needs_copyup(objno):
                op = self._copyup_op(objno).write(piece, off)
                r, _ = self.client.operate(self.data_pool, oid, op)
                if r == -17:    # lost the copyup race: object exists now
                    r = self.client.write(self.data_pool, oid, piece,
                                          off)
            else:
                r = self.client.write(self.data_pool, oid, piece, off)
            if r < 0:
                raise RBDError("write", r)
        self._journal_commit_applied()
        return len(data)

    def _needs_copyup(self, objno: int) -> bool:
        p = self.parent()
        if p is None or objno * self.object_size >= p[3]:
            return False
        try:
            self.client.stat(self.data_pool, self._obj(objno))
            return False
        except IOError as e:
            if _absent(e):
                return True
            raise

    def _copyup_data(self, objno: int) -> bytes:
        """The parent's bytes for this child object, clipped to the
        overlap (CopyupRequest)."""
        ln = min(self.object_size,
                 self.parent()[3] - objno * self.object_size)
        return self._parent_read(objno, 0, ln).rstrip(b"\x00")

    def _copyup_op(self, objno: int) -> ObjectOperation:
        """Vector prefix materializing the parent bytes in the child
        object, to be extended with the triggering mutation so both
        commit atomically.  The exclusive create guards the
        stat-then-copyup window: if another client copied up (and
        possibly wrote) since our stat, the vector aborts -EEXIST and
        the caller retries as a plain mutation instead of smearing
        parent bytes over committed data (the reference's guarded
        CopyupRequest)."""
        cdata = self._copyup_data(objno)
        op = ObjectOperation().create(exclusive=True)
        if cdata:
            op.write(cdata, 0)
        return op

    @_mutating
    def discard(self, offset: int, length: int) -> None:
        """Punch a hole (rbd_discard): whole objects are removed, edges
        are zeroed.  Inside a clone's parent overlap a hole must STAY a
        hole — removing the child object (or zeroing an absent one)
        would re-expose parent bytes on the next read, so there the
        discard materializes an explicit zero state instead (librbd
        turns such discards into truncate/zero whiteouts)."""
        if self.read_snap is not None:
            raise RBDError("discard", -30)
        if self.journaling:
            self._journal_event({"op": "discard", "offset": offset,
                                 "length": length})
        self._apply_write_ctx()
        p = self.parent()
        overlap = p[3] if p else 0
        for objno, off, ln in self._extents(offset, length):
            oid = self._obj(objno)
            in_overlap = objno * self.object_size < overlap
            if off == 0 and ln == self.object_size:
                if in_overlap:
                    op = ObjectOperation().create(exclusive=False)
                    r, _ = self.client.operate(self.data_pool, oid,
                                               op.truncate(0))
                    self._om_mark([objno], self.OM_EXISTS)
                else:
                    r = self.client.remove(self.data_pool, oid)
                    if r in (0, -2):
                        self._om_mark([objno], self.OM_NONE)
            elif in_overlap and self._needs_copyup(objno):
                self._om_mark([objno], self.OM_EXISTS)
                op = self._copyup_op(objno).zero(off, ln)
                r, _ = self.client.operate(self.data_pool, oid, op)
                if r == -17:
                    r = self.client.zero(self.data_pool, oid, off, ln)
            else:
                r = self.client.zero(self.data_pool, oid, off, ln)
                if r == 0:
                    # zeroing an EXISTING object changed its bytes:
                    # fast-diff must see it dirty (CLEAN would make
                    # export-diff skip the punched hole)
                    self._om_mark([objno], self.OM_EXISTS)
            if r < 0 and r != -2:
                raise RBDError("discard", r)
        self._journal_commit_applied()

    @_mutating
    def resize(self, new_size: int) -> None:
        """Grow adjusts metadata only (sparse); shrink removes/truncates
        objects beyond the new end (Operations::resize)."""
        old = self.size()
        if self.read_snap is not None:
            raise RBDError("resize", -30)
        if self.journaling:
            self._journal_event({"op": "resize", "size": new_size})
        if new_size < old:
            self._apply_write_ctx()
            keep_objs = self._objects_in(new_size)
            for objno in range(keep_objs, self._objects_in(old)):
                r = self.client.remove(self.data_pool, self._obj(objno))
                if r < 0 and r != -2:
                    raise RBDError("resize", r)
            tail = new_size - (keep_objs - 1) * self.object_size
            if keep_objs and tail < self.object_size:
                r = self.client.truncate(self.data_pool,
                                         self._obj(keep_objs - 1), tail)
                if r < 0 and r != -2:
                    raise RBDError("resize", r)
            if self.parent() is not None:
                self._call("set_parent_overlap", {"overlap": new_size},
                           parse=False)
                self._parent_link = self._fetch_parent()
        self._call("set_size", {"size": new_size}, parse=False)
        if self.object_map_feature:
            # shrink truncates the bitmap; grow extends with NONE
            m = self._om_load()
            n = self._objects_in(new_size)
            if len(m) > n:
                m = m[:n]
                # a partially-truncated tail object CHANGED: dirty it
                # or export-diff would skip it as CLEAN
                if n and new_size % self.object_size and \
                        m[n - 1] != self.OM_NONE:
                    m[n - 1] = self.OM_EXISTS
                self._om_save(m)
            elif len(m) < n:
                m.extend(b"\x00" * (n - len(m)))
                self._om_save(m)
        self._journal_commit_applied()

    # ---- snapshots --------------------------------------------------------
    @_mutating
    def snap_create(self, name: str) -> int:
        if self.journaling:
            self._journal_event({"op": "snap_create", "name": name})
        sid = self.client.selfmanaged_snap_create(self.data_pool)
        self._call("snapshot_add",
                   {"snapid": sid, "name": name, "size": self.size()},
                   parse=False)
        if self.object_map_feature:
            # freeze the bitmap as the snap's map, then mark every
            # existing head object CLEAN: fast-diff reads 'dirty since
            # the latest snap' straight off the head map
            m = self._om_load()
            self._om_save(bytearray(m), snapid=sid)
            self._om_save(bytearray(
                self.OM_CLEAN if b != self.OM_NONE else self.OM_NONE
                for b in m))
        self._journal_commit_applied()
        return sid

    @_mutating
    def snap_remove(self, name: str) -> None:
        sid, info = self._snap_by_name(name)
        if self.journaling:
            self._journal_event({"op": "snap_remove", "name": name})
        was_latest = sid == max(self._snapcontext()[1], default=sid)
        self._call("snapshot_remove", {"snapid": sid}, parse=False)
        self.client.selfmanaged_snap_remove(self.data_pool, sid)
        if self.object_map_feature:
            self.client.remove(self.pool, self._om_oid(sid))
            if was_latest:
                # CLEAN meant 'unchanged since sid'; with sid gone the
                # reference point is an OLDER snap we did not track
                # against — over-claim dirtiness (safe) rather than
                # let export-diff skip changed objects
                m = self._om_load()
                self._om_save(bytearray(
                    self.OM_EXISTS if b != self.OM_NONE else
                    self.OM_NONE for b in m))
        self._journal_commit_applied()

    def snap_list(self) -> Dict[str, Dict]:
        return {info["name"]: dict(info, id=sid)
                for sid, info in self._snapcontext()[1].items()}

    def snap_protect(self, name: str) -> None:
        sid, _ = self._snap_by_name(name)
        self._call("snapshot_protect", {"snapid": sid}, parse=False)

    def snap_unprotect(self, name: str) -> None:
        sid, _ = self._snap_by_name(name)
        kids = json.loads(self.client.exec(
            self.pool, RBD_CHILDREN, "rbd", "get_children",
            _j({"pool": self.pool, "image_id": self.id,
                "snapid": sid}))[1] or b"[]")
        if kids:
            raise RBDError("snap unprotect", -16)     # EBUSY
        self._call("snapshot_unprotect", {"snapid": sid}, parse=False)

    @_mutating
    def snap_rollback(self, name: str) -> None:
        """Restore the head to the snapshot's content (Operations::
        snap_rollback): resize to the snap size, then per-object restore
        reads at the snap and rewrites the head under the current ctx.

        Journaled as ONE semantic op event (the reference records an
        OpEvent, librbd/journal/Types.h SnapRollbackEvent) with the
        inner resize/write journaling suppressed: a mirror replays
        "roll back to snap X" against its own replicated snapshot, so
        primary and secondary converge even though the per-object
        restore I/O never crosses the journal."""
        sid, info = self._snap_by_name(name)
        if self.journaling:
            self._journal_event({"op": "snap_rollback", "name": name})
        was = self.journaling
        self.journaling = False
        try:
            self.resize(info["size"])
            self._apply_write_ctx()
            for objno in range(self._objects_in(info["size"])):
                oid = self._obj(objno)
                try:
                    snap_data = self.client.read(self.data_pool, oid,
                                                 snap=sid)
                    at_snap = True
                except IOError as e:
                    if not _absent(e):
                        raise
                    at_snap = False
                if at_snap:
                    r = self.client.write_full(self.data_pool, oid,
                                               snap_data)
                    if r < 0:
                        raise RBDError("snap rollback", r)
                else:
                    r = self.client.remove(self.data_pool, oid)
                    if r < 0 and r != -2:
                        raise RBDError("snap rollback", r)
        finally:
            self.journaling = was
        self.rebuild_object_map()
        self._journal_commit_applied()

    # ---- clone management -------------------------------------------------
    @_mutating
    def flatten(self) -> None:
        """Copy every parent-backed object into the child, then sever
        the parent link (Operations::flatten)."""
        p = self.parent()
        if p is None:
            raise RBDError("flatten", -22)
        ppool, pid, psnap, overlap = p
        self._apply_write_ctx()
        for objno in range(self._objects_in(min(overlap, self.size()))):
            if self._needs_copyup(objno):
                # same exclusive-create guard as write(): losing the
                # copyup race to a concurrent writer must skip, not
                # smear parent bytes over committed data
                r, _ = self.client.operate(
                    self.data_pool, self._obj(objno),
                    self._copyup_op(objno))
                if r < 0 and r != -17:
                    raise RBDError("flatten", r)
                self._om_mark([objno], self.OM_EXISTS)
        self._call("remove_parent", parse=False)
        self._parent_link = None
        self._parent_handle = None
        ret, _ = self.client.exec(
            ppool, RBD_CHILDREN, "rbd", "remove_child",
            _j({"pool": ppool, "image_id": pid, "snapid": psnap,
                "child_id": self.id}))
        if ret < 0 and ret != -2:
            raise RBDError("flatten", ret)

    # ---- diff export/import (rbd export-diff / import-diff; the
    # "rbd diff v1" stream: s=size, w=data extent, z=zero extent) ------
    def export_diff(self, from_snap: Optional[str] = None,
                    to_snap: Optional[str] = None) -> bytes:
        """Serialize the changes between two points in time (snap or
        head) as a record stream: [("s", size), ("w", off, b64data),
        ("z", off, len), ...].  Applying it with import_diff onto a
        copy taken at ``from_snap`` reproduces the ``to_snap`` state —
        the incremental-backup workflow (rbd export-diff)."""
        import base64
        src_from = (Image(self.client, self.pool, self.name,
                          snapshot=from_snap) if from_snap else None)
        src_to = (Image(self.client, self.pool, self.name,
                        snapshot=to_snap) if to_snap else self)
        records: List = [("s", src_to.size())]
        # fast-diff (librbd::ObjectMap): when diffing HEAD against the
        # LATEST snapshot, the head bitmap already says which objects
        # changed since it — CLEAN objects are skipped unread
        skip_clean = None
        if (self.object_map_feature and from_snap and to_snap is None
                and self.read_snap is None):
            snaps = self._snapcontext()[1]
            latest = max(snaps) if snaps else None
            if latest is not None and \
                    snaps[latest]["name"] == from_snap:
                skip_clean = self._om_load()
        # extents beyond the target size need no records: import_diff's
        # leading resize truncates them
        for objno in range(self._objects_in(src_to.size())):
            if skip_clean is not None and objno < len(skip_clean) \
                    and skip_clean[objno] == self.OM_CLEAN:
                continue
            off = objno * self.object_size
            ln = min(self.object_size, src_to.size() - off)
            new = src_to.read(off, ln) if ln > 0 else b""
            old = (src_from.read(off, min(self.object_size,
                                          src_from.size() - off))
                   if src_from and off < src_from.size() else b"")
            if new == old:
                continue
            if not new.strip(b"\x00"):
                if old:              # content became zeros: punch
                    records.append(("z", off, len(old)))
                continue
            records.append(("w", off,
                            base64.b64encode(new).decode()))
        return _j(records)

    def import_diff(self, blob: bytes) -> None:
        """Apply an export_diff stream (rbd import-diff)."""
        import base64
        for rec in json.loads(blob):
            kind = rec[0]
            if kind == "s":
                self.resize(rec[1])
            elif kind == "w":
                data = base64.b64decode(rec[2])
                self.write(rec[1], data)
            elif kind == "z":
                self.discard(rec[1], rec[2])

    # ---- advisory image locks (rbd lock add/ls/rm -> cls_lock on the
    # header object, librbd list_lockers/lock_exclusive) ---------------
    RBD_LOCK_NAME = "rbd_lock"

    def lock_exclusive(self, cookie: str = "") -> int:
        return self.client.lock_exclusive(self.pool, self._header,
                                          self.RBD_LOCK_NAME, cookie)

    def lock_shared(self, cookie: str = "", tag: str = "") -> int:
        return self.client.lock_shared(self.pool, self._header,
                                       self.RBD_LOCK_NAME, cookie, tag)

    def unlock(self, cookie: str = "") -> int:
        return self.client.unlock(self.pool, self._header,
                                  self.RBD_LOCK_NAME, cookie)

    def break_lock(self, entity: str, cookie: str = "") -> int:
        return self.client.break_lock(self.pool, self._header,
                                      self.RBD_LOCK_NAME, entity, cookie)

    def list_lockers(self) -> List[Dict]:
        return self.client.list_lockers(self.pool, self._header,
                                        self.RBD_LOCK_NAME)["lockers"]

    # ---- exclusive lock (librbd::ExclusiveLock) -----------------------
    def _watch_cb(self, _notify_id, payload) -> bytes:
        """Header watch callback — runs INSIDE a network pump, so it
        must not issue rados ops.  A lock request is answered by
        surrendering the lock state locally and letting the REQUESTER
        break the now-promised lock (the cooperative transition of
        ExclusiveLock::handle_peer_notification); 'busy' defers while
        a mutation is mid-flight."""
        try:
            req = json.loads(payload)
        except ValueError:
            return b""
        if req.get("op") == "request_lock":
            if self._in_op and self._lock_owned:
                # only the OWNER mid-mutation defers; a fellow WAITER
                # being in-op must not veto breaking a dead owner's
                # lock (two waiters would deadlock each other)
                return b"busy"
            if self._lock_owned:
                self._lock_owned = False
                self._lock_surrendered = True
                # the next owner will mutate the object map: our
                # cached copy is stale the moment we surrender
                self._omap_cache = None
            return b"released"
        return b""

    def _ensure_exclusive_lock(self) -> None:
        """Auto-acquire on first mutation (ExclusiveLock.cc): try the
        cls lock; if another handle owns it, request a cooperative
        surrender over the header watch, breaking the lock once the
        owner promised (acked 'released') or proved dead (silent past
        the notify timeout)."""
        if not self.exclusive_lock_feature or self.read_snap is not None:
            return
        if self._lock_owned:
            return
        for attempt in range(30):
            r = self.lock_exclusive(self._lock_cookie)
            if r == -16:
                # a sibling handle on THIS client?  notify cannot reach
                # it (the OSD excludes the notifier's own watches), so
                # run the surrender round locally
                handled = False
                for lk in self.list_lockers():
                    if lk["entity"] != self.client.name:
                        continue
                    handled = True
                    import weakref
                    peers = _LOCAL_HANDLES.get(
                        (id(self.client), self._header),
                        weakref.WeakSet())
                    owner = next((img for img in peers
                                  if img is not self and
                                  img._lock_cookie == lk["cookie"]), None)
                    if owner is None or owner._watch_cb(
                            0, _j({"op": "request_lock"})) == b"released":
                        self.break_lock(lk["entity"], lk["cookie"])
                    # else: mid-op -> retry the round
                if handled:
                    continue
            if r == 0:
                self._lock_owned = True
                self._lock_surrendered = False
                if self._watch_cookie is None:
                    self._watch_cookie = self.client.watch(
                        self.pool, self._header, self._watch_cb)
                # another owner may have advanced the journal and the
                # object map while we were away: drop cached state so
                # the next use re-reads (a stale journal position
                # would reuse tids — the corruption this lock exists
                # to prevent)
                self._journal = None
                self._omap_cache = None
                return
            try:
                replies = self.client.notify(
                    self.pool, self._header,
                    _j({"op": "request_lock"}), timeout=5)
                # an EMPTY reply set means nobody is watching the
                # header: the owner's client is gone (the OSD pruned
                # its dead watch) — safe to break
                promised = (not replies) or any(
                    v == b"released" for v in replies.values())
            except NotifyTimeout as e:
                # the owner's client is dead (its watch never acked):
                # safe to break (ExclusiveLock's blacklist-and-break,
                # minus the blacklist)
                promised = True
                del e
            if promised:
                for lk in self.list_lockers():
                    self.break_lock(lk["entity"], lk["cookie"])
            # else: owner answered 'busy' mid-op — retry the round
        raise RBDError("exclusive lock", -110)

    def close(self) -> None:
        """Release the exclusive lock and the header watch (the
        ImageCtx close path).  Handles that acquired the lock pin
        themselves through the client's watch table until closed —
        long-lived clients should close handles they drop."""
        if self._lock_owned:
            try:
                self.unlock(self._lock_cookie)
            except IOError:
                pass
            self._lock_owned = False
        if self._watch_cookie is not None:
            try:
                self.client.unwatch(self.pool, self._header,
                                    self._watch_cookie)
            except IOError:
                pass
            self._watch_cookie = None

    def __enter__(self) -> "Image":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # ---- object map (librbd::ObjectMap; fast-diff substrate) ----------
    OM_NONE = 0          # OBJECT_NONEXISTENT
    OM_EXISTS = 1        # OBJECT_EXISTS (dirty since the last snap)
    OM_CLEAN = 3         # OBJECT_EXISTS_CLEAN (unchanged since it)

    def _om_oid(self, snapid: Optional[int] = None) -> str:
        base = f"rbd_object_map.{self.id}"
        return f"{base}.{snapid}" if snapid is not None else base

    def _om_load(self, snapid: Optional[int] = None) -> bytearray:
        if snapid is None and self._omap_cache is not None:
            return self._omap_cache
        try:
            data = self.client.read(self.pool, self._om_oid(snapid))
        except IOError as e:
            if not _absent(e):
                raise
            data = b""
        m = bytearray(data)
        if snapid is None:
            n = self._objects_in(self.size())
            if len(m) < n:
                m.extend(b"\x00" * (n - len(m)))
            self._omap_cache = m
        return m

    def _om_save(self, m: bytearray,
                 snapid: Optional[int] = None) -> None:
        self.client.write_full(self.pool, self._om_oid(snapid),
                               bytes(m))
        if snapid is None:
            self._omap_cache = m

    def _om_mark(self, objnos, state: int) -> None:
        """Update-before-write discipline: existence flips are
        persisted BEFORE the data mutation they describe, so a crash
        can only ever leave the map OVER-claiming (safe: fast-diff
        then includes an unchanged object, never misses a changed
        one)."""
        if not self.object_map_feature or self.read_snap is not None:
            return
        m = self._om_load()
        changed = False
        for o in objnos:
            if o >= len(m):
                m.extend(b"\x00" * (o + 1 - len(m)))
            if m[o] != state:
                m[o] = state
                changed = True
        if changed:
            self._om_save(m)

    def rebuild_object_map(self) -> None:
        """rbd object-map rebuild: re-derive the bitmap from reality."""
        if not self.object_map_feature:
            return
        n = self._objects_in(self.size())
        m = bytearray(n)
        for objno in range(n):
            try:
                self.client.stat(self.data_pool, self._obj(objno))
                m[objno] = self.OM_EXISTS
            except IOError as e:
                if not _absent(e):
                    raise
        self._om_save(m)

    def object_map(self, snap_name: Optional[str] = None) -> bytes:
        """The existence bitmap (one byte per object)."""
        sid = self._snap_by_name(snap_name)[0] if snap_name else None
        return bytes(self._om_load(sid))

    def du(self) -> Dict:
        """Provisioned vs used bytes (rbd du).  With the object-map
        feature this is O(map): existing objects contribute their full
        object span (the reference's fast-diff accounting); without
        it, each object is stat'ed."""
        provisioned = self.size()
        nobj = self._objects_in(provisioned)
        if self.object_map_feature:
            m = self._om_load(self.read_snap)
            used = 0
            for objno in range(min(nobj, len(m))):
                if m[objno] != self.OM_NONE:
                    used += min(self.object_size,
                                provisioned - objno * self.object_size)
            return {"provisioned": provisioned, "used": used}
        used = 0
        for objno in range(nobj):
            try:
                used += self.client.stat(self.data_pool,
                                         self._obj(objno),
                                         snap=self.read_snap)
            except IOError as e:
                if not _absent(e):
                    raise
        return {"provisioned": provisioned, "used": used}

    def stat(self) -> Dict:
        meta = self._call("get_image")
        return {"size": self.size(), "order": meta["order"],
                "data_pool": self.data_pool,
                "object_prefix": meta["object_prefix"],
                "num_objs": self._objects_in(meta["size"]),
                "parent": self.parent(),
                "snaps": sorted(self.snap_list())}


def apply_image_event(img: "Image", event: Dict) -> None:
    """Apply one journal event to an image (the librbd journal Replay
    handler's op table).  Events carry absolute extents, so re-applying
    is idempotent; journaling is suppressed on the target handle to
    avoid re-journaling replayed ops."""
    import base64
    was = img.journaling
    img.journaling = False          # never re-journal a replay
    try:
        op = event["op"]
        if op == "write":
            data = base64.b64decode(event["data"])
            end = event["offset"] + len(data)
            if end > img.size():
                img.resize(end)
            img.write(event["offset"], data)
        elif op == "discard":
            img.discard(event["offset"], event["length"])
        elif op == "resize":
            img.resize(event["size"])
        elif op == "snap_create":
            if event["name"] not in img.snap_list():
                img.snap_create(event["name"])
        elif op == "snap_remove":
            if event["name"] in img.snap_list():
                img.snap_remove(event["name"])
        elif op == "snap_rollback":
            # the snap replicated earlier in the same stream (its
            # snap_create event precedes this one), so rolling back by
            # name reproduces the primary's semantic rollback exactly
            img.snap_rollback(event["name"])
    finally:
        img.journaling = was
