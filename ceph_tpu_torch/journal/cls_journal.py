"""cls_journal-lite: journal metadata methods (src/cls/journal/
cls_journal.cc in the reference).

A journal's control state lives in one metadata object
(``journal.<id>``): immutable shape (order, splay_width), the active
object-set watermark, and the registered clients with their commit
positions.  Mutations are class methods so concurrent journal users
(e.g. an rbd-mirror daemon and the primary image) get atomic
read-modify-write, exactly like the reference's cls_journal.

Port of ``ceph_tpu/journal/cls_journal.py``, a copy.
"""
from __future__ import annotations

import json

from ..osd.cls import CLS_METHOD_WR, ClsContext, register_cls_method


def _j(obj) -> bytes:
    return json.dumps(obj, sort_keys=True).encode()


def _parse(inp: bytes):
    try:
        return json.loads(inp.decode()) if inp else {}
    except ValueError:
        return {}


@register_cls_method("journal", "create", CLS_METHOD_WR)
def _create(ctx: ClsContext, inp: bytes):
    req = _parse(inp)
    if ctx.exists and ctx.omap_get():
        return -17, b""
    ctx.omap_set({
        "order": str(int(req.get("order", 24))),
        "splay_width": str(int(req.get("splay_width", 4))),
        "minimum_set": "0",
        "active_set": "0",
    })
    return 0, b""


@register_cls_method("journal", "get_metadata")
def _get_metadata(ctx: ClsContext, inp: bytes):
    om = ctx.omap_get()
    if "order" not in om:
        return -2, b""
    clients = {k[len("client_"):]: json.loads(v)
               for k, v in om.items() if k.startswith("client_")}
    return 0, _j({"order": int(om["order"]),
                  "splay_width": int(om["splay_width"]),
                  "minimum_set": int(om["minimum_set"]),
                  "active_set": int(om["active_set"]),
                  "clients": clients})


@register_cls_method("journal", "client_register", CLS_METHOD_WR)
def _client_register(ctx: ClsContext, inp: bytes):
    req = _parse(inp)
    key = f"client_{req['id']}"
    if key in ctx.omap_get():
        return -17, b""
    ctx.omap_set({key: _j({"commit_tid": -1,
                           "data": req.get("data", "")})})
    return 0, b""


@register_cls_method("journal", "client_unregister", CLS_METHOD_WR)
def _client_unregister(ctx: ClsContext, inp: bytes):
    req = _parse(inp)
    key = f"client_{req['id']}"
    if key not in ctx.omap_get():
        return -2, b""
    ctx.omap_rm_keys([key])
    return 0, b""


@register_cls_method("journal", "client_commit", CLS_METHOD_WR)
def _client_commit(ctx: ClsContext, inp: bytes):
    """Advance a client's commit position; never moves backwards
    (cls_journal client_commit semantics)."""
    req = _parse(inp)
    key = f"client_{req['id']}"
    om = ctx.omap_get()
    if key not in om:
        return -2, b""
    cl = json.loads(om[key])
    cl["commit_tid"] = max(cl["commit_tid"], int(req["commit_tid"]))
    ctx.omap_set({key: _j(cl)})
    return 0, b""


@register_cls_method("journal", "set_active_set", CLS_METHOD_WR)
def _set_active_set(ctx: ClsContext, inp: bytes):
    req = _parse(inp)
    om = ctx.omap_get()
    if "active_set" not in om:
        return -2, b""
    if int(req["set"]) < int(om["active_set"]):
        return -22, b""
    ctx.omap_set({"active_set": str(int(req["set"]))})
    return 0, b""


@register_cls_method("journal", "set_minimum_set", CLS_METHOD_WR)
def _set_minimum_set(ctx: ClsContext, inp: bytes):
    req = _parse(inp)
    om = ctx.omap_get()
    if "minimum_set" not in om:
        return -2, b""
    if int(req["set"]) < int(om["minimum_set"]):
        return -22, b""
    ctx.omap_set({"minimum_set": str(int(req["set"]))})
    return 0, b""
