"""cls_lock: advisory object locks (src/cls/lock/cls_lock.cc).

The reference's generic lock class — librbd exclusive-lock, rgw
coordination, and rados_lock_exclusive/shared all build on it.  Lock
state lives in an object xattr (``lock.<name>`` here, as in the
reference), so it works on EC pools too (no omap needed), and every
operation is a class method running atomically on the object's PG.

Semantics (cls_lock_types.h / cls_lock.cc):
- a lock has a type (EXCLUSIVE or SHARED), a tag, and a set of lockers
  identified by (entity, cookie) with per-locker expiration;
- lock: EXCLUSIVE conflicts with any other locker; SHARED coexists
  with other SHARED holders of the same tag; re-locking your own
  (entity, cookie) renews the expiration; expired lockers are pruned
  on every operation;
- unlock: removes exactly your (entity, cookie); -ENOENT otherwise;
- break_lock: removes a NAMED other locker (operator intervention);
- get_info: lockers + type + tag; assert_locked: vector guard.

The port's own copy of ``ceph_tpu/osd/cls_lock.py``.
"""
from __future__ import annotations

import json

from .cls import CLS_METHOD_WR, ClsContext, register_cls_method

LOCK_EXCLUSIVE = 1
LOCK_SHARED = 2

_PREFIX = "lock."


def _j(obj) -> bytes:
    return json.dumps(obj, sort_keys=True).encode()


def _parse(inp: bytes):
    try:
        return json.loads(inp.decode()) if inp else {}
    except ValueError:
        return {}


def _load(ctx: ClsContext, name: str):
    try:
        st = json.loads(ctx.getxattr(_PREFIX + name))
    except Exception:
        return None
    # prune expired lockers on every access (cls_lock does the same)
    live = [lk for lk in st["lockers"]
            if not lk["expiration"] or lk["expiration"] > ctx.now]
    if len(live) != len(st["lockers"]):
        st["lockers"] = live
    return st


def _store(ctx: ClsContext, name: str, st) -> None:
    if st["lockers"]:
        ctx.setxattr(_PREFIX + name, _j(st))
    else:
        ctx.rmxattr(_PREFIX + name)


@register_cls_method("lock", "lock", CLS_METHOD_WR)
def _lock(ctx: ClsContext, inp: bytes):
    req = _parse(inp)
    name = str(req["name"])
    ltype = int(req["type"])
    cookie = str(req.get("cookie", ""))
    tag = str(req.get("tag", ""))
    duration = float(req.get("duration", 0))
    entity = ctx.entity
    if ltype not in (LOCK_EXCLUSIVE, LOCK_SHARED):
        return -22, b""
    st = _load(ctx, name) or {"type": ltype, "tag": tag, "lockers": []}
    mine = [lk for lk in st["lockers"]
            if lk["entity"] == entity and lk["cookie"] == cookie]
    others = [lk for lk in st["lockers"] if lk not in mine]
    if others:
        if ltype == LOCK_EXCLUSIVE or st["type"] == LOCK_EXCLUSIVE:
            return -16, b""                           # EBUSY
        if st["tag"] != tag:
            return -16, b""       # shared lockers must agree on tag
    else:
        # no OTHER lockers: the caller (re)defines type + tag, incl. a
        # sole holder downgrading exclusive->shared (cls_lock.cc resets
        # lock_type whenever only the caller's own entry remains)
        st["type"], st["tag"] = ltype, tag
    expiration = ctx.now + duration if duration else 0
    st["lockers"] = others + [{
        "entity": entity, "cookie": cookie, "expiration": expiration,
        "description": str(req.get("description", ""))}]
    _store(ctx, name, st)
    return 0, b""


@register_cls_method("lock", "unlock", CLS_METHOD_WR)
def _unlock(ctx: ClsContext, inp: bytes):
    req = _parse(inp)
    st = _load(ctx, str(req["name"]))
    if st is None:
        return -2, b""
    entity, cookie = ctx.entity, str(req.get("cookie", ""))
    keep = [lk for lk in st["lockers"]
            if not (lk["entity"] == entity and lk["cookie"] == cookie)]
    if len(keep) == len(st["lockers"]):
        return -2, b""                                # not a holder
    st["lockers"] = keep
    _store(ctx, str(req["name"]), st)
    return 0, b""


@register_cls_method("lock", "break_lock", CLS_METHOD_WR)
def _break_lock(ctx: ClsContext, inp: bytes):
    """Forcibly remove ANOTHER entity's lock (operator tooling:
    rados lock break / rbd lock rm)."""
    req = _parse(inp)
    st = _load(ctx, str(req["name"]))
    if st is None:
        return -2, b""
    target, cookie = str(req["entity"]), str(req.get("cookie", ""))
    keep = [lk for lk in st["lockers"]
            if not (lk["entity"] == target and lk["cookie"] == cookie)]
    if len(keep) == len(st["lockers"]):
        return -2, b""
    st["lockers"] = keep
    _store(ctx, str(req["name"]), st)
    return 0, b""


@register_cls_method("lock", "get_info")
def _get_info(ctx: ClsContext, inp: bytes):
    req = _parse(inp)
    st = _load(ctx, str(req["name"]))
    if st is None or not st["lockers"]:
        return 0, _j({"type": 0, "tag": "", "lockers": []})
    return 0, _j(st)


@register_cls_method("lock", "list_locks")
def _list_locks(ctx: ClsContext, inp: bytes):
    names = []
    for k in ctx.attr_names():
        if k.startswith(_PREFIX):
            st = _load(ctx, k[len(_PREFIX):])
            if st is not None and st["lockers"]:
                names.append(k[len(_PREFIX):])
    return 0, _j(sorted(names))


@register_cls_method("lock", "assert_locked")
def _assert_locked(ctx: ClsContext, inp: bytes):
    """Vector guard: abort unless the CALLER holds the lock as
    specified (cls_lock assert_locked — librbd uses this to fence
    writes behind the exclusive lock)."""
    req = _parse(inp)
    st = _load(ctx, str(req["name"]))
    if st is None:
        return -16, b""                               # EBUSY
    entity, cookie = ctx.entity, str(req.get("cookie", ""))
    for lk in st["lockers"]:
        if lk["entity"] == entity and lk["cookie"] == cookie:
            if "type" in req and st["type"] != int(req["type"]):
                return -16, b""
            return 0, b""
    return -16, b""
