"""cls_rgw-lite: server-side bucket-index methods (src/cls/rgw/
cls_rgw.cc in the reference).

The reference keeps each bucket's object listing in index objects
(``.dir.<bucket_id>``) and mutates them with a two-phase protocol:
``bucket_prepare_op`` marks an in-flight mutation under a unique tag,
the gateway writes the data objects, then ``bucket_complete_op``
commits (or cancels) the entry.  A gateway crash between the phases
leaves only a pending marker — never a listing entry pointing at
missing data.  Same protocol here over the index object's omap:

  entry_<name>    -> JSON object metadata (committed listing entry)
  pending_<tag>   -> JSON {name, op}     (in-flight marker)
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


@register_cls_method("rgw", "bucket_prepare_op", CLS_METHOD_WR)
def _prepare(ctx: ClsContext, inp: bytes):
    req = _parse(inp)
    ctx.omap_set({f"pending_{req['tag']}":
                  _j({"name": req["name"], "op": req["op"]})})
    return 0, b""


@register_cls_method("rgw", "bucket_complete_op", CLS_METHOD_WR)
def _complete(ctx: ClsContext, inp: bytes):
    """Commit the prepared mutation: install/remove the listing entry
    and drop the pending marker.  -ECANCELED if the tag is unknown
    (e.g. a racing suggest-cleanup already cancelled it)."""
    req = _parse(inp)
    tag = f"pending_{req['tag']}"
    om = ctx.omap_get()
    if tag not in om:
        return -125, b""
    if req["op"] == "put":
        ctx.omap_set({f"entry_{req['name']}": _j(req["meta"])})
    elif req["op"] == "del":
        ctx.omap_rm_keys([f"entry_{req['name']}"])
    ctx.omap_rm_keys([tag])
    return 0, b""


@register_cls_method("rgw", "bucket_cancel_op", CLS_METHOD_WR)
def _cancel(ctx: ClsContext, inp: bytes):
    req = _parse(inp)
    ctx.omap_rm_keys([f"pending_{req['tag']}"])
    return 0, b""


@register_cls_method("rgw", "bucket_list")
def _list(ctx: ClsContext, inp: bytes):
    """Listing with prefix/marker/max_keys, server-side like
    cls_rgw_bucket_list so huge buckets never ship their whole omap."""
    if not ctx.exists:
        # a LOST index object must answer ESTALE, never "empty
        # bucket" — gc would purge a live bucket's data otherwise
        return -116, b""
    req = _parse(inp)
    prefix = req.get("prefix", "")
    marker = req.get("marker", "")
    maxk = int(req.get("max_keys", 1000))
    om = ctx.omap_get()
    names = sorted(k[len("entry_"):] for k in om
                   if k.startswith("entry_"))
    out, truncated = [], False
    for n in names:
        if n <= marker or not n.startswith(prefix):
            continue
        if len(out) >= maxk:
            truncated = True
            break
        out.append({"name": n, **json.loads(om[f"entry_{n}"])})
    return 0, _j({"entries": out, "truncated": truncated})


@register_cls_method("rgw", "bucket_get_entry")
def _get_entry(ctx: ClsContext, inp: bytes):
    req = _parse(inp)
    v = ctx.omap_get().get(f"entry_{req['name']}")
    if v is None:
        return -2, b""
    return 0, bytes(v)


@register_cls_method("rgw", "bucket_stats")
def _stats(ctx: ClsContext, inp: bytes):
    if not ctx.exists:
        return -116, b""      # lost index: unknowable, not empty
    om = ctx.omap_get()
    entries = [json.loads(v) for k, v in om.items()
               if k.startswith("entry_")]
    return 0, _j({"num_objects": len(entries),
                  "size_bytes": sum(e.get("size", 0) for e in entries),
                  "pending_ops": sum(1 for k in om
                                     if k.startswith("pending_"))})
