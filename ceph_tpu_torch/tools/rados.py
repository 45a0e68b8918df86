"""rados — the object CLI against a checkpointed mini cluster.

The reference's `rados` tool (src/tools/rados/rados.cc) talks to a live
cluster; this framework's clusters are in-process, so the CLI operates
on a checkpoint directory (MiniCluster.checkpoint): restore, run the
op, checkpoint back for mutations.  Supported verbs mirror the
everyday reference surface:

  ls POOL | put POOL OID FILE | get POOL OID [FILE] | rm POOL OID
  stat POOL OID | setxattr POOL OID NAME VALUE | getxattr POOL OID NAME
  listxattr POOL OID | mksnap POOL SNAP | rmsnap POOL SNAP
  rollback POOL OID SNAP | lssnap POOL | df

Exit 0 on success, 1 on errors.  Port of ``ceph_tpu/tools/rados.py``.
"""
from __future__ import annotations

import argparse
import json
import sys


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="rados")
    p.add_argument("--cluster", required=True,
                   help="checkpoint directory (MiniCluster.checkpoint)")
    p.add_argument("verb", choices=[
        "ls", "put", "get", "rm", "stat", "setxattr", "getxattr",
        "listxattr", "mksnap", "rmsnap", "rollback", "lssnap", "df"])
    p.add_argument("args", nargs="*")
    a = p.parse_args(argv)

    from ..cluster import MiniCluster
    c = MiniCluster.restore(a.cluster)
    cl = c.client("client.rados-cli")
    mutated = False
    try:
        v, rest = a.verb, a.args
        if v == "df":
            for pid, name in sorted(c.mon.osdmap.pool_name.items()):
                pool = c.mon.osdmap.pools[pid]
                kind = "erasure" if pool.is_erasure() else "replicated"
                print(f"{name}\t{kind}\tpg_num={pool.pg_num}"
                      f"\tsnaps={len(pool.snaps)}")
        elif v == "ls":
            (pool,) = rest
            # real client listing (rados_nobjects_list -> PGLS ops per
            # PG), not a store scan — exactly what the reference CLI does
            for o in sorted(cl.list_objects(pool)):
                print(o)
        elif v == "put":
            pool, oid, path = rest
            with open(path, "rb") as f:
                data = f.read()
            r = cl.write_full(pool, oid, data)
            if r < 0:
                print(f"put failed: {r}", file=sys.stderr)
                return 1
            mutated = True
        elif v == "get":
            if len(rest) < 2:
                print("get needs POOL OID [FILE]", file=sys.stderr)
                return 1
            pool, oid = rest[0], rest[1]
            data = cl.read(pool, oid)
            if len(rest) > 2:
                with open(rest[2], "wb") as f:
                    f.write(data)
            else:
                sys.stdout.buffer.write(data)
        elif v == "rm":
            pool, oid = rest
            if cl.remove(pool, oid) < 0:
                return 1
            mutated = True
        elif v == "stat":
            pool, oid = rest
            print(json.dumps({"oid": oid, "size": cl.stat(pool, oid)}))
        elif v == "setxattr":
            pool, oid, name, value = rest
            cl.setxattr(pool, oid, name, value.encode())
            mutated = True
        elif v == "getxattr":
            pool, oid, name = rest
            sys.stdout.buffer.write(cl.getxattr(pool, oid, name))
        elif v == "listxattr":
            pool, oid = rest
            for k in sorted(cl.getxattrs(pool, oid)):
                print(k)
        elif v == "mksnap":
            pool, snap = rest
            print(f"created pool {pool} snap {snap} "
                  f"id {cl.snap_create(pool, snap)}")
            mutated = True
        elif v == "rmsnap":
            pool, snap = rest
            cl.snap_remove(pool, snap)
            mutated = True
        elif v == "rollback":
            pool, oid, snap = rest
            if cl.rollback(pool, oid, snap) < 0:
                return 1
            mutated = True
        elif v == "lssnap":
            (pool,) = rest
            for sid, name in sorted(cl.snap_list(pool).items()):
                print(f"{sid}\t{name}")
    except (IOError, KeyError, ValueError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    if mutated:
        c.checkpoint(a.cluster)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
