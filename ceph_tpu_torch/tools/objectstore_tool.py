"""objectstore-tool — offline object-store surgery on saved stores.

The ceph-objectstore-tool analog (src/tools/ceph_objectstore_tool.cc):
operate on an unmounted OSD store (here: a ``MemStore.save`` file, the
checkpoint format MiniCluster.checkpoint writes) without a running
cluster.  Supported ops mirror the reference's most-used surface:

  --op list                      list (collection, object) pairs
  --op info                      store summary (collections/objects/txns)
  --op get-bytes  --cid C --oid O [--shard S] [--out FILE]
  --op list-attrs --cid C --oid O [--shard S]
  --op get-omap   --cid C --oid O [--shard S]
  --op remove     --cid C --oid O [--shard S]   (rewrites the store)
  --op export     --cid C --out FILE            (one collection, portable)
  --op import     --in FILE                     (merge an exported coll)
  --op list-pgs                                 distinct pg ids on the store
  --op get-attr   --cid C --oid O --key K       (hex to stdout)
  --op set-bytes  --cid C --oid O --in FILE     (replace payload)
  --op set-attr/rm-attr --key K [--value HEX]
  --op set-omap/rm-omap --key K [--value HEX]

Exit status 0 on success, 1 on usage/lookup errors.

The port's own copy of ``ceph_tpu/tools/objectstore_tool.py``: the same argv
gives the same output, exit code and files.
"""
from __future__ import annotations

import argparse
import json
import struct
import sys

from ..os_store import MemStore, Transaction, hobject_t

_EXPORT_MAGIC = b"CTOSEXP1"


def _find(store: MemStore, cid: str, oid: str, shard: int):
    ho = hobject_t(oid, shard)
    if not store.collection_exists(cid) or not store.exists(cid, ho):
        return None
    return ho


def _op_list(store: MemStore, out) -> int:
    for cid in sorted(store.list_collections()):
        for ho in sorted(store.list_objects(cid)):
            print(json.dumps({"cid": cid, "oid": ho.oid,
                              "shard": ho.shard,
                              "size": store.stat(cid, ho)}), file=out)
    return 0


def _op_info(store: MemStore, out) -> int:
    n_obj = sum(len(store.list_objects(c))
                for c in store.list_collections())
    print(json.dumps({"collections": len(store.list_collections()),
                      "objects": n_obj,
                      "committed_txns": store.committed_txns}), file=out)
    return 0


def _op_export(store: MemStore, cid: str, path: str) -> int:
    if not store.collection_exists(cid):
        print(f"no collection {cid!r}", file=sys.stderr)
        return 1
    sub = MemStore()
    t = Transaction()
    t.create_collection(cid)
    sub.queue_transaction(t)
    for ho in store.list_objects(cid):
        t = Transaction()
        t.touch(cid, ho)
        t.write(cid, ho, 0, store.read(cid, ho))
        for k, v in store.getattrs(cid, ho).items():
            t.setattr(cid, ho, k, v)
        om = store.omap_get(cid, ho)
        if om:
            t.omap_setkeys(cid, ho, om)
        sub.queue_transaction(t)
    sub_path = path + ".body"
    sub.save(sub_path)
    with open(sub_path, "rb") as f:
        body = f.read()
    import os
    os.remove(sub_path)
    with open(path, "wb") as f:
        f.write(_EXPORT_MAGIC + struct.pack("<I", len(body)) + body)
    return 0


def _op_import(store: MemStore, store_path: str, path: str) -> int:
    with open(path, "rb") as f:
        blob = f.read()
    if blob[:8] != _EXPORT_MAGIC:
        print(f"{path}: not an objectstore export", file=sys.stderr)
        return 1
    import os
    body_path = path + ".body"
    try:
        (n,) = struct.unpack_from("<I", blob, 8)
        if len(blob) < 12 + n:
            raise ValueError("truncated export body")
        with open(body_path, "wb") as f:
            f.write(blob[12:12 + n])
        sub = MemStore.load(body_path)
    except (struct.error, ValueError) as e:
        print(f"{path}: corrupt export ({e})", file=sys.stderr)
        return 1
    finally:
        if os.path.exists(body_path):
            os.remove(body_path)
    for cid in sub.list_collections():
        t = Transaction()
        if not store.collection_exists(cid):
            t.create_collection(cid)
        for ho in sub.list_objects(cid):
            t.touch(cid, ho)
            t.truncate(cid, ho, 0)
            t.write(cid, ho, 0, sub.read(cid, ho))
            for k, v in sub.getattrs(cid, ho).items():
                t.setattr(cid, ho, k, v)
            om = sub.omap_get(cid, ho)
            if om:
                t.omap_setkeys(cid, ho, om)
        store.queue_transaction(t)
    store.save(store_path)
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="objectstore-tool")
    p.add_argument("--data-path", required=True,
                   help="MemStore.save file (osd.N.store)")
    p.add_argument("--op", required=True,
                   choices=["list", "info", "get-bytes", "list-attrs",
                            "get-omap", "remove", "export", "import",
                            "set-bytes", "get-attr", "set-attr",
                            "rm-attr", "set-omap", "rm-omap",
                            "list-pgs"])
    p.add_argument("--cid")
    p.add_argument("--oid")
    p.add_argument("--shard", type=int, default=-1)
    p.add_argument("--key", help="attr/omap key (get/set/rm-attr, "
                                 "set/rm-omap)")
    p.add_argument("--value", help="hex value (set-attr/set-omap)")
    p.add_argument("--out", help="output file (get-bytes/export)")
    p.add_argument("--in", dest="infile",
                   help="input file (import/set-bytes)")
    a = p.parse_args(argv)

    store = MemStore.load(a.data_path)
    if a.op == "list":
        return _op_list(store, sys.stdout)
    if a.op == "list-pgs":
        # distinct pg ids parsed from collection names, rendered like
        # pg_t ("pool.ps" with HEX ps, matching ceph pg dump)
        from ..os_store import parse_pg_from_cid
        pgs = {p for p in map(parse_pg_from_cid,
                              store.list_collections())
               if p is not None}
        for pool, ps in sorted(pgs):
            print(f"{pool}.{ps:x}")
        return 0
    if a.op == "info":
        return _op_info(store, sys.stdout)
    if a.op == "export":
        if not a.cid or not a.out:
            p.error("export needs --cid and --out")
        return _op_export(store, a.cid, a.out)
    if a.op == "import":
        if not a.infile:
            p.error("import needs --in")
        return _op_import(store, a.data_path, a.infile)

    if not a.cid or not a.oid:
        p.error(f"{a.op} needs --cid and --oid")
    ho = _find(store, a.cid, a.oid, a.shard)
    if ho is None:
        print(f"object {a.oid!r} (shard {a.shard}) not in {a.cid!r}",
              file=sys.stderr)
        return 1
    if a.op == "get-bytes":
        data = store.read(a.cid, ho)
        if a.out:
            with open(a.out, "wb") as f:
                f.write(data)
        else:
            sys.stdout.buffer.write(data)
        return 0
    if a.op == "list-attrs":
        attrs = store.getattrs(a.cid, ho)
        print(json.dumps({k: v.hex() for k, v in sorted(attrs.items())}))
        return 0
    if a.op == "get-omap":
        om = store.omap_get(a.cid, ho)
        print(json.dumps({k: v.hex() for k, v in sorted(om.items())}))
        return 0
    if a.op == "get-attr":
        if not a.key:
            p.error("get-attr needs --key")
        attrs = store.getattrs(a.cid, ho)
        if a.key not in attrs:
            print(f"no attr {a.key!r}", file=sys.stderr)
            return 1
        sys.stdout.write(attrs[a.key].hex() + "\n")
        return 0
    # write-side surgery: every mutation goes through a transaction
    # and rewrites the store file (the offline-store contract); the
    # else branch is `remove`, so an op missing from this chain can
    # never silently fall through to a delete

    def hexval():
        if not a.key or a.value is None:
            p.error(f"{a.op} needs --key and --value (hex)")
        try:
            return bytes.fromhex(a.value)
        except ValueError:
            print(f"--value {a.value!r} is not hex", file=sys.stderr)
            return None

    t = Transaction()
    if a.op == "set-bytes":
        if not a.infile:
            p.error("set-bytes needs --in")
        try:
            with open(a.infile, "rb") as f:
                data = f.read()
        except OSError as e:
            print(f"cannot read {a.infile}: {e.strerror}",
                  file=sys.stderr)
            return 1
        t.truncate(a.cid, ho, 0)
        t.write(a.cid, ho, 0, data)
    elif a.op == "set-attr":
        v = hexval()
        if v is None:
            return 1
        t.setattr(a.cid, ho, a.key, v)
    elif a.op == "rm-attr":
        if not a.key:
            p.error("rm-attr needs --key")
        if a.key not in store.getattrs(a.cid, ho):
            print(f"no attr {a.key!r}", file=sys.stderr)
            return 1
        t.rmattr(a.cid, ho, a.key)
    elif a.op == "set-omap":
        v = hexval()
        if v is None:
            return 1
        t.omap_setkeys(a.cid, ho, {a.key: v})
    elif a.op == "rm-omap":
        if not a.key:
            p.error("rm-omap needs --key")
        if a.key not in store.omap_get(a.cid, ho):
            print(f"no omap key {a.key!r}", file=sys.stderr)
            return 1
        t.omap_rmkeys(a.cid, ho, [a.key])
    else:
        assert a.op == "remove", a.op
        t.remove(a.cid, ho)
    store.queue_transaction(t)
    store.save(a.data_path)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
