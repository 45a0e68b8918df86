"""cls_fs: server-side filesystem-metadata methods.

The reference cephfs keeps directories as rados objects in a metadata
pool — a CDir's dentries live in the omap of object ``<ino>.<frag>``
(mds/CDir.cc:1595 get_ondisk_object -> include/object.h:100
``%llx.%08llx``), each primary dentry embedding its inode (CDentry/
CInode encode into the dentry value), and allocates inode numbers from
a replicated InoTable (mds/InoTable.h).  The MDS daemon serializes
metadata mutations in front of that layout.

This lite design keeps the exact on-disk shape but moves the
serialization point INTO the OSD: every dentry/ino mutation is an
object-class method running atomically inside the op transaction on
the directory object's PG — two racing creates of the same name are
ordered by the PG, not by an MDS journal.  What the MDS daemon adds
beyond that — client capabilities/leases, a metadata journal with
replay, multi-MDS subtree balancing — is out of scope and documented
as such in ``ceph_tpu_torch.cephfs``.

Dentry values are JSON inodes: {ino, type(dir|file|symlink), size,
mtime, order, target?}.
"""
from __future__ import annotations

import json
from typing import Dict

from ..osd.cls import (
    CLS_METHOD_RD, CLS_METHOD_WR, ClsContext, register_cls_method,
)

ROOT_INO = 1                      # CEPH_INO_ROOT, include/ceph_fs.h:29
INOTABLE_OID = "mds_inotable"     # InoTable object (mds/InoTable.h)


def dir_oid(ino: int, frag: int = 0) -> str:
    """CDir on-disk object name (include/object.h:100)."""
    return f"{ino:x}.{frag:08x}"


def file_oid(ino: int, objno: int) -> str:
    """File-data object name in the data pool (same %llx.%08llx)."""
    return f"{ino:x}.{objno:08x}"


def _j(obj) -> bytes:
    return json.dumps(obj, sort_keys=True).encode()


def _parse(inp: bytes) -> Dict:
    try:
        return json.loads(inp.decode()) if inp else {}
    except ValueError:
        return {}


@register_cls_method("fs", "mkfs", CLS_METHOD_WR)
def _mkfs(ctx: ClsContext, inp: bytes):
    """Initialize the InoTable: next allocatable ino (root is pinned
    at ROOT_INO and never allocated)."""
    if ctx.exists and ctx.omap_get():
        return -17, b""                               # EEXIST
    ctx.omap_set({"next_ino": str(ROOT_INO + 1)})
    return 0, b""


@register_cls_method("fs", "alloc_ino", CLS_METHOD_WR)
def _alloc_ino(ctx: ClsContext, inp: bytes):
    """Atomically allocate the next inode number (InoTable::
    project_alloc_id)."""
    om = ctx.omap_get()
    if "next_ino" not in om:
        return -2, b""
    ino = int(om["next_ino"])
    ctx.omap_set({"next_ino": str(ino + 1)})
    return 0, _j({"ino": ino})


@register_cls_method("fs", "link", CLS_METHOD_WR)
def _link(ctx: ClsContext, inp: bytes):
    """Insert a dentry (name -> embedded inode) into this directory
    object: -EEXIST if the name is taken.  The atomicity of this check
    replaces the MDS's dentry lock.  A directory marked dead by
    dir_mark_dead refuses new dentries (-ENOENT) so rmdir cannot race
    a create."""
    if not ctx.exists:
        # directory objects are created eagerly, so a missing object
        # means rmdir already deleted it (after sealing).  A WR cls
        # method would implicitly recreate the object here — a
        # resurrected directory holding an orphaned dentry that no
        # root walk (fsck) can ever reach.  The seal must keep holding
        # after the object is gone.
        return -2, b""
    req = _parse(inp)
    name = str(req["name"])
    key = f"dn_{name}"
    om = ctx.omap_get()
    if "_dead" in om:
        return -2, b""
    if key in om:
        return -17, b""
    ctx.omap_set({key: _j(req["inode"])})
    return 0, b""


@register_cls_method("fs", "unlink", CLS_METHOD_WR)
def _unlink(ctx: ClsContext, inp: bytes):
    """Remove a dentry.  With ``deny_dir`` a directory dentry is
    refused (-EISDIR) — the unlink(2) contract, enforced where the
    dentry actually lives so no client-side stat can go stale."""
    if not ctx.exists:
        return -2, b""          # deleted dir: don't resurrect (see link)
    req = _parse(inp)
    key = f"dn_{req['name']}"
    om = ctx.omap_get()
    if key not in om:
        return -2, b""
    if req.get("deny_dir") and json.loads(om[key]).get("type") == "dir":
        return -21, b""                               # EISDIR
    ctx.omap_rm_keys([key])
    return 0, bytes(om[key])      # the unlinked inode, for cleanup


@register_cls_method("fs", "lookup")
def _lookup(ctx: ClsContext, inp: bytes):
    if not ctx.exists:
        # the directory OBJECT itself is gone (lost metadata PG) —
        # report ESTALE, not "no such dentry": callers like fsck must
        # distinguish a deleted name from an unknowable directory
        return -116, b""
    req = _parse(inp)
    v = ctx.omap_get().get(f"dn_{req['name']}")
    if v is None:
        return -2, b""
    return 0, bytes(v)


@register_cls_method("fs", "readdir")
def _readdir(ctx: ClsContext, inp: bytes):
    if not ctx.exists:
        # a LOST dir object must read as ENOENT, not as an empty
        # directory — fsck distinguishes "empty" from "unknowable"
        return -2, b""
    out = {k[3:]: json.loads(v) for k, v in ctx.omap_get().items()
           if k.startswith("dn_")}
    return 0, _j(out)


@register_cls_method("fs", "dir_empty")
def _dir_empty(ctx: ClsContext, inp: bytes):
    empty = not any(k.startswith("dn_") for k in ctx.omap_get())
    return 0, _j({"empty": empty})


@register_cls_method("fs", "dir_mark_dead", CLS_METHOD_WR)
def _dir_mark_dead(ctx: ClsContext, inp: bytes):
    """Atomically check-empty-and-seal this directory object: after it
    succeeds, link() refuses new dentries, so the rmdir sequence
    (seal child -> unlink parent dentry -> delete object) cannot lose a
    concurrently created entry (the MDS holds a dirlock for this)."""
    if not ctx.exists:
        return -2, b""          # deleted dir: don't resurrect (see link)
    if any(k.startswith("dn_") for k in ctx.omap_get()):
        return -39, b""                               # ENOTEMPTY
    ctx.omap_set({"_dead": "1"})
    return 0, b""


@register_cls_method("fs", "update_inode", CLS_METHOD_WR)
def _update_inode(ctx: ClsContext, inp: bytes):
    """Merge attribute updates (size/mtime/...) into the inode embedded
    in a dentry — the wrstat path (MDS Locker file_update_finish)."""
    req = _parse(inp)
    key = f"dn_{req['name']}"
    om = ctx.omap_get()
    if key not in om:
        return -2, b""
    inode = json.loads(om[key])
    inode.update(req.get("attrs", {}))
    # monotonic attributes (size growth from concurrent writers) max
    # against the stored value HERE, so no client read-modify-write
    # window can shrink a committed size
    for k, v in req.get("max_attrs", {}).items():
        inode[k] = max(inode.get(k, 0), v)
    # back-pointer list mutations merge HERE for the same reason: two
    # concurrent hardlink()s must both land their entries
    if req.get("add_links") or req.get("remove_links") \
            or req.get("replace_link"):
        links = list(inode.get("links", []))
        for l in req.get("add_links", []):
            if l not in links:
                links.append(l)
        links = [l for l in links
                 if l not in req.get("remove_links", [])]
        rep = req.get("replace_link")
        if rep:
            links = [rep[1] if l == rep[0] else l for l in links]
        inode["links"] = links
    ctx.omap_set({key: _j(inode)})
    return 0, _j(inode)


FS_SNAPS_OID = "fs_snaps"         # snapshot table (SnapServer role)


@register_cls_method("fs", "snap_add", CLS_METHOD_WR)
def _snap_add(ctx: ClsContext, inp: bytes):
    """Register a filesystem snapshot name -> (md_sid, data_sid)
    atomically (-EEXIST on collision) — the SnapServer's table."""
    req = _parse(inp)
    key = f"snap_{req['name']}"
    if key in ctx.omap_get():
        return -17, b""
    ctx.omap_set({key: _j({"md": int(req["md_sid"]),
                           "data": int(req["data_sid"]),
                           "stamp": float(req.get("stamp", 0))})})
    return 0, b""


@register_cls_method("fs", "snap_rm", CLS_METHOD_WR)
def _snap_rm(ctx: ClsContext, inp: bytes):
    req = _parse(inp)
    key = f"snap_{req['name']}"
    om = ctx.omap_get()
    if key not in om:
        return -2, b""
    ctx.omap_rm_keys([key])
    return 0, bytes(om[key])


@register_cls_method("fs", "snap_ls")
def _snap_ls(ctx: ClsContext, inp: bytes):
    return 0, _j({k[len("snap_"):]: json.loads(v)
                  for k, v in ctx.omap_get().items()
                  if k.startswith("snap_")})


@register_cls_method("fs", "set_dentry", CLS_METHOD_WR)
def _set_dentry(ctx: ClsContext, inp: bytes):
    """Atomically overwrite (or install) a dentry's value — the
    hard-link promotion/repoint primitive: replacing a remote dentry
    with an embedded inode must never pass through a missing-dentry
    window the way unlink+link would."""
    if not ctx.exists:
        return -2, b""          # deleted dir: don't resurrect (see link)
    req = _parse(inp)
    om = ctx.omap_get()
    if "_dead" in om:
        return -2, b""
    key = f"dn_{req['name']}"
    if "expect_remote_ino" in req:
        cur = om.get(key)
        if cur is None:
            return -2, b""
        parsed = json.loads(cur)
        if parsed.get("type") != "remote" or \
                parsed.get("ino") != req["expect_remote_ino"]:
            return -125, b""                          # ECANCELED
    ctx.omap_set({key: _j(req["inode"])})
    return 0, b""


@register_cls_method("fs", "rename_local", CLS_METHOD_WR)
def _rename_local(ctx: ClsContext, inp: bytes):
    """Same-directory rename, fully atomic on the dir object's PG.
    Overwrites dst only when ``replace`` (rename(2) semantics with the
    client checking dst type compatibility first)."""
    req = _parse(inp)
    src, dst = f"dn_{req['src']}", f"dn_{req['dst']}"
    om = ctx.omap_get()
    if src not in om:
        return -2, b""
    if src == dst:
        return 0, b"null"     # rename(p, p) is a no-op, rename(2)
    if dst in om and not req.get("replace"):
        return -17, b""
    if dst in om and json.loads(om[dst]).get("type") == "dir":
        return -21, b""   # EISDIR: never silently destroy a subtree
    displaced = om.get(dst, b"null")
    ctx.omap_set({dst: bytes(om[src])})
    ctx.omap_rm_keys([src])
    return 0, bytes(displaced)    # displaced inode, for cleanup
