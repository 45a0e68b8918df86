"""cls_rbd-lite: server-side image-metadata methods (src/cls/rbd/
cls_rbd.cc in the reference).

librbd never mutates image metadata with raw omap writes — every header
update is a class method executed ON the OSD inside the op transaction,
so concurrent clients get atomic read-modify-write semantics (e.g. two
snapshot_adds can't both claim the same name).  Same shape here: the
image header, the pool's ``rbd_directory`` and the ``rbd_children``
index are all mutated through ``(rbd, <method>)`` calls.

Payloads are JSON (the lite stand-in for the reference's binary
bufferlist encodings) over the header object's omap:
  size / order / object_prefix / snap_seq  — image shape
  snapshot_<id>                            — per-snap {name, size, protected}
  parent                                   — {pool, image_id, snapid, overlap}

Port of ``ceph_tpu/rbd/cls_rbd.py``, a copy.
"""
from __future__ import annotations

import json
from typing import Dict

from ..osd.cls import (
    CLS_METHOD_RD, CLS_METHOD_WR, ClsContext, register_cls_method,
)

RBD_HEADER_PREFIX = "rbd_header."
RBD_DATA_PREFIX = "rbd_data."
RBD_DIRECTORY = "rbd_directory"
RBD_CHILDREN = "rbd_children"


def _j(obj) -> bytes:
    return json.dumps(obj, sort_keys=True).encode()


def _parse(inp: bytes) -> Dict:
    try:
        return json.loads(inp.decode()) if inp else {}
    except ValueError:
        return {}


def _snap_key(snapid: int) -> str:
    return f"snapshot_{snapid:016x}"


# ---- image header ----------------------------------------------------------

@register_cls_method("rbd", "create", CLS_METHOD_WR)
def _create(ctx: ClsContext, inp: bytes):
    """Initialize a header object (cls_rbd create): -EEXIST if this
    header was already created."""
    req = _parse(inp)
    if ctx.exists and ctx.omap_get():
        return -17, b""                               # EEXIST
    kv = {
        "size": str(int(req["size"])),
        "order": str(int(req.get("order", 22))),
        "object_prefix": str(req["object_prefix"]),
        "snap_seq": "0",
    }
    if req.get("data_pool"):
        # image data lives in a separate (typically EC) pool while the
        # header stays omap-capable (librbd RBD_FEATURE_DATA_POOL)
        kv["data_pool"] = str(req["data_pool"])
    if req.get("journaling"):
        kv["journaling"] = "1"     # RBD_FEATURE_JOURNALING
    if req.get("exclusive_lock"):
        kv["exclusive_lock"] = "1"  # RBD_FEATURE_EXCLUSIVE_LOCK
    if req.get("object_map"):
        kv["object_map"] = "1"     # RBD_FEATURE_OBJECT_MAP (fast-diff)
    ctx.omap_set(kv)
    return 0, b""


@register_cls_method("rbd", "get_image")
def _get_image(ctx: ClsContext, inp: bytes):
    om = ctx.omap_get()
    if "size" not in om:
        return -2, b""                                # ENOENT
    out = {
        "size": int(om["size"]),
        "order": int(om["order"]),
        "object_prefix": om["object_prefix"].decode()
        if isinstance(om["object_prefix"], bytes) else om["object_prefix"],
        "snap_seq": int(om["snap_seq"]),
    }
    if "data_pool" in om:
        out["data_pool"] = om["data_pool"].decode()
    if "journaling" in om:
        out["journaling"] = True
    if "exclusive_lock" in om:
        out["exclusive_lock"] = True
    if "object_map" in om:
        out["object_map"] = True
    return 0, _j(out)


@register_cls_method("rbd", "set_size", CLS_METHOD_WR)
def _set_size(ctx: ClsContext, inp: bytes):
    req = _parse(inp)
    if "size" not in ctx.omap_get():
        return -2, b""
    ctx.omap_set({"size": str(int(req["size"]))})
    return 0, b""


# ---- snapshots -------------------------------------------------------------

@register_cls_method("rbd", "snapshot_add", CLS_METHOD_WR)
def _snapshot_add(ctx: ClsContext, inp: bytes):
    """Record a mon-allocated snap id on the image (cls_rbd
    snapshot_add): name collisions and stale ids are refused
    atomically, which is the point of doing this server-side."""
    req = _parse(inp)
    om = ctx.omap_get()
    if "size" not in om:
        return -2, b""
    snapid, name = int(req["snapid"]), str(req["name"])
    if snapid <= int(om["snap_seq"]):
        return -116, b""                              # ESTALE
    for k, v in om.items():
        if k.startswith("snapshot_") and json.loads(v)["name"] == name:
            return -17, b""                           # EEXIST
    ctx.omap_set({
        _snap_key(snapid): _j({"name": name,
                               "size": int(req["size"]),
                               "protected": False}),
        "snap_seq": str(snapid),
    })
    return 0, b""


@register_cls_method("rbd", "snapshot_remove", CLS_METHOD_WR)
def _snapshot_remove(ctx: ClsContext, inp: bytes):
    req = _parse(inp)
    key = _snap_key(int(req["snapid"]))
    om = ctx.omap_get()
    if key not in om:
        return -2, b""
    if json.loads(om[key])["protected"]:
        return -16, b""                               # EBUSY
    ctx.omap_rm_keys([key])
    return 0, b""


@register_cls_method("rbd", "get_snapcontext")
def _get_snapcontext(ctx: ClsContext, inp: bytes):
    om = ctx.omap_get()
    if "size" not in om:
        return -2, b""
    snaps = {}
    for k, v in om.items():
        if k.startswith("snapshot_"):
            snaps[int(k[len("snapshot_"):], 16)] = json.loads(v)
    return 0, _j({"seq": int(om["snap_seq"]),
                  "snaps": {str(k): v for k, v in snaps.items()}})


def _set_protected(ctx: ClsContext, inp: bytes, value: bool):
    req = _parse(inp)
    key = _snap_key(int(req["snapid"]))
    om = ctx.omap_get()
    if key not in om:
        return -2, b""
    info = json.loads(om[key])
    if info["protected"] == value:
        return (-16 if value else -22), b""           # EBUSY / EINVAL
    info["protected"] = value
    ctx.omap_set({key: _j(info)})
    return 0, b""


@register_cls_method("rbd", "snapshot_protect", CLS_METHOD_WR)
def _snapshot_protect(ctx: ClsContext, inp: bytes):
    return _set_protected(ctx, inp, True)


@register_cls_method("rbd", "snapshot_unprotect", CLS_METHOD_WR)
def _snapshot_unprotect(ctx: ClsContext, inp: bytes):
    return _set_protected(ctx, inp, False)


# ---- clone parent link -----------------------------------------------------

@register_cls_method("rbd", "set_parent", CLS_METHOD_WR)
def _set_parent(ctx: ClsContext, inp: bytes):
    req = _parse(inp)
    om = ctx.omap_get()
    if "size" not in om:
        return -2, b""
    if "parent" in om:
        return -17, b""
    ctx.omap_set({"parent": _j({
        "pool": str(req["pool"]), "image_id": str(req["image_id"]),
        "snapid": int(req["snapid"]), "overlap": int(req["overlap"]),
    })})
    return 0, b""


@register_cls_method("rbd", "get_parent")
def _get_parent(ctx: ClsContext, inp: bytes):
    om = ctx.omap_get()
    if "parent" not in om:
        return -2, b""
    return 0, bytes(om["parent"])


@register_cls_method("rbd", "remove_parent", CLS_METHOD_WR)
def _remove_parent(ctx: ClsContext, inp: bytes):
    if "parent" not in ctx.omap_get():
        return -2, b""
    ctx.omap_rm_keys(["parent"])
    return 0, b""


@register_cls_method("rbd", "set_parent_overlap", CLS_METHOD_WR)
def _set_parent_overlap(ctx: ClsContext, inp: bytes):
    """Shrink the parent overlap (resize below overlap keeps the
    smaller value — cls_rbd set_parent on resize)."""
    req = _parse(inp)
    om = ctx.omap_get()
    if "parent" not in om:
        return -2, b""
    p = json.loads(om["parent"])
    p["overlap"] = min(p["overlap"], int(req["overlap"]))
    ctx.omap_set({"parent": _j(p)})
    return 0, b""


# ---- pool image directory (cls_rbd dir_*) ----------------------------------

@register_cls_method("rbd", "dir_add_image", CLS_METHOD_WR)
def _dir_add_image(ctx: ClsContext, inp: bytes):
    req = _parse(inp)
    name, iid = str(req["name"]), str(req["id"])
    om = ctx.omap_get()
    if f"name_{name}" in om:
        return -17, b""
    ctx.omap_set({f"name_{name}": iid.encode(),
                  f"id_{iid}": name.encode()})
    return 0, b""


@register_cls_method("rbd", "dir_remove_image", CLS_METHOD_WR)
def _dir_remove_image(ctx: ClsContext, inp: bytes):
    req = _parse(inp)
    name, iid = str(req["name"]), str(req["id"])
    om = ctx.omap_get()
    if om.get(f"name_{name}", b"").decode() != iid:
        return -2, b""
    ctx.omap_rm_keys([f"name_{name}", f"id_{iid}"])
    return 0, b""


@register_cls_method("rbd", "dir_get_id")
def _dir_get_id(ctx: ClsContext, inp: bytes):
    req = _parse(inp)
    v = ctx.omap_get().get(f"name_{req['name']}")
    if v is None:
        return -2, b""
    return 0, bytes(v)


@register_cls_method("rbd", "dir_list")
def _dir_list(ctx: ClsContext, inp: bytes):
    names = sorted(k[len("name_"):] for k in ctx.omap_get()
                   if k.startswith("name_"))
    return 0, _j(names)


@register_cls_method("rbd", "dir_rename_image", CLS_METHOD_WR)
def _dir_rename_image(ctx: ClsContext, inp: bytes):
    req = _parse(inp)
    src, dst, iid = str(req["src"]), str(req["dst"]), str(req["id"])
    om = ctx.omap_get()
    if om.get(f"name_{src}", b"").decode() != iid:
        return -2, b""
    if f"name_{dst}" in om:
        return -17, b""
    ctx.omap_rm_keys([f"name_{src}"])
    ctx.omap_set({f"name_{dst}": iid.encode(),
                  f"id_{iid}": dst.encode()})
    return 0, b""


# ---- clone children index (cls_rbd add_child/remove_child/get_children) ----

def _child_key(pool: str, image_id: str, snapid: int) -> str:
    return f"{pool}\x00{image_id}\x00{snapid:016x}"


@register_cls_method("rbd", "add_child", CLS_METHOD_WR)
def _add_child(ctx: ClsContext, inp: bytes):
    req = _parse(inp)
    key = _child_key(req["pool"], req["image_id"], int(req["snapid"]))
    kids = json.loads(ctx.omap_get().get(key, b"[]"))
    if req["child_id"] not in kids:
        kids.append(req["child_id"])
    ctx.omap_set({key: _j(sorted(kids))})
    return 0, b""


@register_cls_method("rbd", "remove_child", CLS_METHOD_WR)
def _remove_child(ctx: ClsContext, inp: bytes):
    req = _parse(inp)
    key = _child_key(req["pool"], req["image_id"], int(req["snapid"]))
    om = ctx.omap_get()
    kids = json.loads(om.get(key, b"[]"))
    if req["child_id"] not in kids:
        return -2, b""
    kids.remove(req["child_id"])
    if kids:
        ctx.omap_set({key: _j(kids)})
    else:
        ctx.omap_rm_keys([key])
    return 0, b""


@register_cls_method("rbd", "get_children")
def _get_children(ctx: ClsContext, inp: bytes):
    req = _parse(inp)
    key = _child_key(req["pool"], req["image_id"], int(req["snapid"]))
    return 0, bytes(ctx.omap_get().get(key, b"[]"))
